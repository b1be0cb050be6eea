"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports no JAX, so it runs on a machine without it::

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_cuda.py

The cases are the CPU parity tests' edge cases (block sizes 1/3/4, GQA,
head-uniform and per-head bias, out-of-range table ids, masked columns
over stale pool blocks, ties at the top-k and top-p boundaries), in f32 and
bf16, and for the paged span kernel the edges of its bf16 tensor-core
layouts (T on both sides of 16 with ragged query tiles, block size 16,
head dims 16/64/128, a query whose every column is masked); for the
speculative verify rows at their own depths, a probe window across a block
edge and done rows with poisoned tables; for flash attention ragged tiles,
GQA, a window, ALiBi and rows that
see no key; for the fused loss IW on and off, a masked row and values on
the clip bounds. ``chip_smoke.py`` makes the same comparison at the
serving and training shapes.
"""

import pytest
import torch

from trlx_tpu_torch.ops.paged_attention import (
    fused_sample,
    fused_sample_reference,
    paged_attention_decode,
    paged_attention_decode_reference,
    paged_verify_attention,
    paged_verify_attention_reference,
)
from trlx_tpu_torch.ops.paged_prefill import (
    paged_prefill_attention,
    paged_prefill_attention_reference,
)

from trlx_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_bwd,
    flash_bwd_reference,
    flash_fwd,
    flash_fwd_reference,
)
from trlx_tpu_torch.ops.fused_loss import (
    LossParams,
    fused_loss_bwd,
    fused_loss_bwd_reference,
    fused_loss_fwd,
    fused_loss_fwd_reference,
)

from torch_kernel_cases import (
    CUDA_GEOMETRIES,
    CUDA_VERIFY_CASES,
    FLASH_CASES,
    GEOMETRIES,
    SAMPLE_SETTINGS,
    flash_case,
    loss_case,
    paged_case,
    t,
    tied_logits,
    verify_case,
)

# f32: summation order only; bf16: the output's rounding (the kernel
# accumulates in f32 and is compared with the plain version run in f32)
_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _attention_args(geometry, per_head_bias, seed, dtype, dev, dead_row=False):
    q, kp, vp, table, bias = paged_case(geometry, per_head_bias, seed, dead_row)
    return ([t(a).to(dev, dtype) for a in (q, kp, vp)]
            + [t(table).to(dev), t(bias).to(dev)])


def _as_f32(args):
    return [a.float() if a.is_floating_point() else a for a in args]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_head_bias", [False, True])
@pytest.mark.parametrize("geometry", CUDA_GEOMETRIES)
def test_cuda_kernels_match_plain_versions(cuda, geometry, per_head_bias, dtype):
    args = _attention_args(geometry, per_head_bias, sum(geometry), dtype, cuda, dead_row=True)
    before = (paged_prefill_attention.launches, paged_attention_decode.launches)
    out = paged_prefill_attention(*args)
    assert out.dtype == dtype and out.is_cuda
    want = paged_prefill_attention_reference(*_as_f32(args))
    torch.testing.assert_close(out.float(), want, atol=_TOL[dtype], rtol=0)
    dargs = [args[0][:, -1].contiguous(), args[1], args[2], args[3],
             args[4][:, :, -1].contiguous()]
    out = paged_attention_decode(*dargs)
    want = paged_attention_decode_reference(*_as_f32(dargs))
    torch.testing.assert_close(out.float(), want, atol=_TOL[dtype], rtol=0)
    assert (paged_prefill_attention.launches, paged_attention_decode.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CUDA_VERIFY_CASES)
def test_cuda_verify_matches_plain_version(cuda, case, dtype):
    q, kp, vp, table, bias = verify_case(case, seed=sum(case))
    args = [t(a).to(cuda, dtype) for a in (q, kp, vp)] + [t(table).to(cuda), t(bias).to(cuda)]
    before = (paged_verify_attention.launches, paged_prefill_attention.launches)
    out = paged_verify_attention(*args)
    assert out.dtype == dtype and out.is_cuda
    want = paged_verify_attention_reference(*_as_f32(args))
    torch.testing.assert_close(out.float(), want, atol=_TOL[dtype], rtol=0)
    # the verify counts its own launches of the prefill kernel
    assert (paged_verify_attention.launches, paged_prefill_attention.launches) == (
        before[0] + 1, before[1])


@pytest.mark.gpu
def test_cuda_bf16_span_rejects_unsupported_head_dim(cuda):
    # the bf16 kernel is templated over D in {16, 32, 64, 128}: any other D
    # raises before a launch, for the prefill and the verify alike
    args = _attention_args((2, 5, 4, 2, 48, 4, 13), False, 1, torch.bfloat16, cuda)
    before = (paged_prefill_attention.launches, paged_verify_attention.launches)
    for fn in (paged_prefill_attention, paged_verify_attention):
        with pytest.raises(ValueError, match="D=48"):
            fn(*args)
    assert (paged_prefill_attention.launches, paged_verify_attention.launches) == before
    # f32 stays on CUDA cores and takes any D
    out = paged_prefill_attention(*[a.float() if a.is_floating_point() else a for a in args])
    want = paged_prefill_attention_reference(*_as_f32(args))
    torch.testing.assert_close(out, want, atol=_TOL[torch.float32], rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("settings", SAMPLE_SETTINGS)
def test_cuda_fused_sample_matches_plain_version(cuda, settings, sample):
    x = t(tied_logits(seed=2)).to(cuda)
    g = None
    if sample:
        u = torch.rand(x.shape, generator=torch.Generator().manual_seed(3)).clamp(1e-7, 1 - 1e-7)
        g = (-torch.log(-torch.log(u))).to(cuda)
    tok, lp = fused_sample(x, g, **settings)
    rtok, rlp = fused_sample_reference(x, g, **settings)
    assert torch.equal(tok, rtok)
    torch.testing.assert_close(lp, rlp, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    args = _attention_args(GEOMETRIES[0], False, 1, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        paged_prefill_attention(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                                *args[1:])
    with pytest.raises(ValueError, match="dtype"):
        paged_prefill_attention(args[0], args[1], args[2], args[3].long(), args[4])
    with pytest.raises(ValueError, match="dtype"):
        fused_sample(torch.zeros(2, 8, device=cuda, dtype=torch.float16), None,
                     temperature=1.0, top_k=0, top_p=1.0)


def _flash_args(case, seed, dtype, dev):
    q, k, v, mask, extra, cot = flash_case(case, seed)
    tq, tk, tv = (t(x).to(dev, dtype) for x in (q, k, v))
    kw = {key: (t(val).to(dev) if hasattr(val, "shape") else val)
          for key, val in extra.items()}
    alibi = [kw.pop(n, None) for n in ("q_positions", "k_positions", "alibi_slopes")]
    kw["sm_scale"] = q.shape[-1] ** -0.5
    return tq, tk, tv, t(mask).to(dev), alibi, kw, t(cot).to(dev, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_matches_plain_versions(cuda, case, dtype):
    q, k, v, mask, alibi, kw, do = _flash_args(case, sum(case[:6]), dtype, cuda)
    before = (flash_fwd.launches, flash_bwd.launches)
    out, lse = flash_fwd(q, k, v, mask, *alibi, **kw)
    f32 = [x.float() for x in (q, k, v)]
    want, want_lse = flash_fwd_reference(*f32, mask, *alibi, **kw)
    torch.testing.assert_close(out.float(), want, atol=_TOL[dtype], rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    grads = flash_bwd(q, k, v, mask, *alibi, lse, delta, do, **kw)
    wants = flash_bwd_reference(*f32, mask, *alibi, lse, delta, do.float(), **kw)
    # bf16: the gradients' own rounding (accumulation is f32 in both)
    for got, w in zip(grads, wants):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), w, atol=_TOL[dtype] * 10, rtol=_TOL[dtype])
    assert (flash_fwd.launches, flash_bwd.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
def test_cuda_flash_autograd_runs_both_kernels(cuda):
    q, k, v, mask, alibi, kw, do = _flash_args(FLASH_CASES[1], 5, torch.float32, cuda)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    before = (flash_fwd.launches, flash_bwd.launches)
    out = flash_attention(q, k, v, mask, causal=kw["causal"], q_offset=kw["q_offset"],
                          k_offset=kw["k_offset"], window=kw["window"])
    (out * do).sum().backward()
    assert (flash_fwd.launches, flash_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


def _loss_params(sketches=True, iw="clip"):
    return LossParams(gamma=0.99, lam=0.95, cliprange=0.2, cliprange_value=0.2,
                      vf_coef=0.5, iw_correction=iw, iw_clip=1.05, dist_sketches=sketches)


@pytest.mark.gpu
@pytest.mark.parametrize("use_iw", [False, True])
@pytest.mark.parametrize("shape", [(16, 40), (13, 77), (3, 1)])
def test_cuda_fused_loss_matches_plain_versions(cuda, shape, use_iw):
    ops = [t(x).to(cuda) for x in loss_case(*shape, seed=shape[1], tie_values=True)]
    ops = ops if use_iw else ops[:6]
    p = _loss_params()
    loss, sc, hist = fused_loss_fwd(p, ops)
    wloss, wsc, whist = fused_loss_fwd_reference(p, ops)
    # f32 in both; reduction order differs
    torch.testing.assert_close(loss, wloss, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(sc, wsc, rtol=1e-4, atol=1e-6)
    assert float((hist - whist).abs().sum()) <= 2.0  # at most one edge value
    g = torch.tensor(0.7, device=cuda)
    dlp, dv = fused_loss_bwd(p, ops, g)
    wlp, wv = fused_loss_bwd_reference(p, ops, g)
    torch.testing.assert_close(dlp, wlp, rtol=1e-4, atol=1e-7)
    torch.testing.assert_close(dv, wv, rtol=1e-4, atol=1e-7)
