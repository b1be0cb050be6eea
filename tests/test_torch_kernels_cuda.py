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
edge and done rows with poisoned tables; for the decode kernel one-column
and 1024-column rows (split and merged) and head groups of 3, 8 and 12; for
flash attention ragged tiles on both sides of the bf16 kernels' 64-row
tiles, T = 1, GQA, a window edge inside a tile, ALiBi and rows that see no
key, bit-equal repeated bf16 forwards and backwards; for every attention
kernel head dims 12, 48, 96 and 256 in both types (and the raise above 256);
for flash attention rows padded on the right (the offline trainers'
batches) at SFT's training shape and ragged ones; for the fused sampler
vocabularies of 97, 50257 and 128256 over B = 1, 8 and 32 in every mode
the paths meet, f32 logits shaped by the ILQL hook under top-k, a row with
one finite logit and bit-equal repeated calls; for the fused loss IW on and
off, a masked row and values on the clip bounds; the paged span kernel at
the serving phases' prefix-cache and chunked-prefill spans (a suffix after
a 48- and a 240-column hit, a 64-query chunk at offset 128); the flash
backward's chunk form (#6 through ``flash_attention_bwd_chunk``) at ring
offsets with the global ``lse`` of a longer sequence, a fully masked row
and a pair wholly in the causal future (exact zeros over NaN-filled memory),
and the in-process ring against the monolithic flash kernels; two
processes on the card in a gloo group carrying FSDP2's collectives on
CUDA tensors (``slice_parallel_rl``'s set-up). ``chip_smoke.py`` makes the same comparison at the serving and training
shapes and at the ring's full width.
"""

import json

import numpy as np
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
    flash_attention_bwd_chunk,
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

from chip_smoke import ILQL_SAMPLE_MODES, PREFIX_SPAN_SHAPES, ilql_shaped_logits, paged_inputs
from torch_kernel_cases import (
    CUDA_GEOMETRIES,
    CUDA_PREFERENCE_FLASH_SHAPES,
    CUDA_RIGHT_PAD_FLASH_SHAPES,
    CUDA_VERIFY_CASES,
    FLASH_CASES,
    GEOMETRIES,
    SAMPLE_SETTINGS,
    flash_case,
    loss_case,
    paged_case,
    right_padded_flash_case,
    right_padded_gqa_flash_case,
    t,
    tied_logits,
    verify_case,
)
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,T,q_start", PREFIX_SPAN_SHAPES)
def test_cuda_prefill_at_the_prefix_and_chunk_spans(cuda, name, T, q_start, dtype):
    """#1 at ``chip_smoke.py``'s serving spans over S = 296 (GPT-2 small's
    heads, blocks of 16): the queries at ``[q_start, q_start + T)``, the
    committed columns below them visible, every column from the span's
    end on masked."""
    inp = paged_inputs(np.random.RandomState(q_start), 8, T, 12, 12, 64, 16, 296, 1, dtype,
                       cuda, True, q_start=q_start)
    args = [inp["q"], inp["k"], inp["v"], inp["table"], inp["bias"]]
    before = paged_prefill_attention.launches
    out = paged_prefill_attention(*args)
    assert out.dtype == dtype and out.is_cuda
    want = paged_prefill_attention_reference(*_as_f32(args))
    torch.testing.assert_close(out.float(), want, atol=_TOL[dtype], rtol=0)
    assert paged_prefill_attention.launches == before + 1


# head dims off the tensor-core kernels' templates (12, 48, 96: padded
# inside the loads), 256 (the CUDA-core kernels in bf16; decode's padded
# 256), and 320 and 512 (split over the head dim in 256-column chunks)
_HEAD_DIMS = [12, 48, 96, 256, 320, 512]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", _HEAD_DIMS)
def test_cuda_bf16_span_rejects_unsupported_head_dim(cuda, D, dtype):
    # every D runs for the prefill (both layouts) and the verify, in both
    # types, against the plain version, GQA; no head dim raises
    for T, seed in ((5, 1), (20, 2)):
        args = _attention_args((2, T, 4, 2, D, 4, 29), True, seed, dtype, cuda, dead_row=True)
        before = paged_prefill_attention.launches
        out = paged_prefill_attention(*args)
        assert paged_prefill_attention.launches == before + 1
        want = paged_prefill_attention_reference(*_as_f32(args))
        torch.testing.assert_close(out.float(), want, atol=_TOL[dtype], rtol=0)
    q, kp, vp, table, bias = verify_case((3, 4, 4, 2, D, 4, 12, 9, 1), seed=D)
    vargs = [t(a).to(cuda, dtype) for a in (q, kp, vp)] + [t(table).to(cuda), t(bias).to(cuda)]
    out = paged_verify_attention(*vargs)
    want = paged_verify_attention_reference(*_as_f32(vargs))
    torch.testing.assert_close(out.float(), want, atol=_TOL[dtype], rtol=0)
    # an operand off a 16-byte boundary takes the element-wise load path
    q_off = torch.empty(args[0].numel() + 1, dtype=dtype, device=cuda)[1:].view_as(args[0])
    q_off.copy_(args[0])
    out = paged_prefill_attention(q_off, *args[1:])
    torch.testing.assert_close(out.float(), paged_prefill_attention_reference(*_as_f32(args)),
                               atol=_TOL[dtype], rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", _HEAD_DIMS)
def test_cuda_decode_rejects_unsupported_head_dim(cuda, D, dtype):
    # every D runs in both types, on one span and on a split row (600
    # columns: three spans and the merge launch) and with a head group of 6
    # (two blocks at D >= 256); no head dim raises
    for geometry in ((2, 1, 4, 2, D, 4, 13), (2, 1, 12, 2, D, 16, 600)):
        args = _attention_args(geometry, True, D, dtype, cuda)
        dargs = [args[0][:, -1].contiguous(), args[1], args[2], args[3],
                 args[4][:, :, -1].contiguous()]
        before = paged_attention_decode.launches
        out = paged_attention_decode(*dargs)
        assert paged_attention_decode.launches == before + 1
        want = paged_attention_decode_reference(*_as_f32(dargs))
        torch.testing.assert_close(out.float(), want, atol=_TOL[dtype], rtol=0)


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


def _gumbel(shape, seed, dev):
    u = torch.rand(shape, generator=torch.Generator().manual_seed(seed)).clamp(1e-7, 1 - 1e-7)
    return (-torch.log(-torch.log(u))).to(dev)


# every mode the main paths meet: greedy, the served setting (top-k 50,
# top-p 0.95), the training collection's (no filter, sampled), and top-k
# and top-p alone
_SAMPLE_MODES = {
    "greedy": (dict(temperature=1.0, top_k=0, top_p=1.0), False),
    "served": (dict(temperature=1.0, top_k=50, top_p=0.95), True),
    "train": (dict(temperature=1.0, top_k=0, top_p=1.0), True),
    "temp_topk": (dict(temperature=0.7, top_k=50, top_p=1.0), True),
    "topp": (dict(temperature=1.0, top_k=0, top_p=0.9), True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(_SAMPLE_MODES))
@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("V", [97, 50257, 128256, 200003])
def test_cuda_fused_sample_rows_over_clusters(cuda, V, B, mode):
    # a row's vocabulary split over the cluster's 8 blocks: V not a multiple
    # of 8 (97, 50257), llama-3's 128256, and a row too wide for the slices
    # to stay in shared memory (200003, re-read from global memory);
    # bf16-rounded logits (exact ties); tokens equal to the plain version's,
    # logprobs within 1e-4
    settings, sample = _SAMPLE_MODES[mode]
    x = torch.randn(B, V, generator=torch.Generator().manual_seed(V + B)) * 3.0
    x = x.to(torch.bfloat16).float().to(cuda)
    g = _gumbel((B, V), V * B, cuda) if sample else None
    before = fused_sample.launches
    tok, lp = fused_sample(x, g, **settings)
    assert fused_sample.launches == before + 1
    rtok, rlp = fused_sample_reference(x, g, **settings)
    assert torch.equal(tok, rtok)
    torch.testing.assert_close(lp, rlp, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(ILQL_SAMPLE_MODES))
@pytest.mark.parametrize("B", [8, 32])
def test_cuda_fused_sample_on_ilql_shaped_f32_logits(cuda, B, mode):
    # the ILQL eval: f32 logits shaped by the hook (not bf16-rounded), top-k
    # 20 at temperature 1 and top-k 10 at 0.1 and 0.05, sampled and greedy
    x = t(ilql_shaped_logits(B, 50257, seed=B)).to(cuda)
    for g in (_gumbel(x.shape, B + 1, cuda), None):
        tok, lp = fused_sample(x, g, **ILQL_SAMPLE_MODES[mode])
        rtok, rlp = fused_sample_reference(x, g, **ILQL_SAMPLE_MODES[mode])
        assert torch.equal(tok, rtok)
        torch.testing.assert_close(lp, rlp, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(_SAMPLE_MODES))
def test_cuda_fused_sample_one_finite_logit(cuda, mode):
    # every other logit -inf (an eos-blocked, transition-masked row): the
    # one finite token is drawn with logprob 0, in every mode
    settings, sample = _SAMPLE_MODES[mode]
    x = torch.full((3, 50257), float("-inf"), device=cuda)
    for b, i in enumerate((0, 31337, 50256)):
        x[b, i] = 1.5 * b - 2.0
    g = _gumbel(x.shape, 4, cuda) if sample else None
    tok, lp = fused_sample(x, g, **settings)
    rtok, rlp = fused_sample_reference(x, g, **settings)
    assert tok.tolist() == [0, 31337, 50256] == rtok.tolist()
    torch.testing.assert_close(lp, rlp, atol=1e-6, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["served", "topp", "temp_topk"])
def test_cuda_fused_sample_flat_rows(cuda, mode):
    # rows of few distinct values (a constant row, bf16-rounded logits of
    # tiny spread): candidate lists overflow, so the thresholds come from
    # the cluster-wide radix select over the whole row
    x = torch.randn(4, 50257, generator=torch.Generator().manual_seed(7)) * 0.02
    x = x.to(torch.bfloat16).float()
    x[0] = 0.5
    x[1, :1000] = 3.0
    x = x.to(cuda)
    settings, _ = _SAMPLE_MODES[mode]
    g = _gumbel(x.shape, 8, cuda)
    tok, lp = fused_sample(x, g, **settings)
    rtok, rlp = fused_sample_reference(x, g, **settings)
    assert torch.equal(tok, rtok)
    torch.testing.assert_close(lp, rlp, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["served", "topp", "greedy"])
def test_cuda_fused_sample_is_deterministic(cuda, mode):
    # no float atomics, merges in fixed rank order: two calls agree on the
    # tokens and on the logprobs' bits
    settings, sample = _SAMPLE_MODES[mode]
    x = (torch.randn(32, 50257, generator=torch.Generator().manual_seed(9)) * 3.0).to(cuda)
    g = _gumbel(x.shape, 10, cuda) if sample else None
    tok, lp = fused_sample(x, g, **settings)
    tok2, lp2 = fused_sample(x, g, **settings)
    assert torch.equal(tok, tok2)
    assert torch.equal(lp.view(torch.int32), lp2.view(torch.int32))


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


def _flash_args(case, seed, dtype, dev, make=flash_case):
    q, k, v, mask, extra, cot = make(case, seed)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CUDA_RIGHT_PAD_FLASH_SHAPES + CUDA_PREFERENCE_FLASH_SHAPES)
def test_cuda_flash_right_padded_matches_plain_versions(cuda, shape, dtype):
    # the offline and preference trainers' rows: keys padded on the right,
    # causal (the preference shapes with their key heads and window)
    make = right_padded_gqa_flash_case if len(shape) == 6 else right_padded_flash_case
    q, k, v, mask, alibi, kw, do = _flash_args(shape, sum(shape), dtype, cuda, make=make)
    # chip_smoke.py's FLASH_TOL (rows up to 1024 keys)
    tol = {torch.float32: dict(out=(1e-4, 0.0), lse=(1e-4, 0.0), grad=(1e-3, 1e-4)),
           torch.bfloat16: dict(out=(2e-2, 0.0), lse=(1e-3, 0.0), grad=(2e-2, 1e-2))}[dtype]
    out, lse = flash_fwd(q, k, v, mask, *alibi, **kw)
    f32 = [x.float() for x in (q, k, v)]
    want, want_lse = flash_fwd_reference(*f32, mask, *alibi, **kw)
    torch.testing.assert_close(out.float(), want, atol=tol["out"][0], rtol=tol["out"][1])
    torch.testing.assert_close(lse, want_lse, atol=tol["lse"][0], rtol=tol["lse"][1])
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    grads = flash_bwd(q, k, v, mask, *alibi, lse, delta, do, **kw)
    wants = flash_bwd_reference(*f32, mask, *alibi, lse, delta, do.float(), **kw)
    for got, w in zip(grads, wants):
        torch.testing.assert_close(got.float(), w, atol=tol["grad"][0], rtol=tol["grad"][1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", [FLASH_CASES[1], FLASH_CASES[9], FLASH_CASES[13]])
def test_cuda_bf16_flash_fwd_is_deterministic(cuda, case):
    # each block owns its rows of out and lse, and sums in a fixed order:
    # two calls on the same inputs agree bit for bit
    q, k, v, mask, alibi, kw, _ = _flash_args(case, 12, torch.bfloat16, cuda)
    out, lse = flash_fwd(q, k, v, mask, *alibi, **kw)
    out2, lse2 = flash_fwd(q, k, v, mask, *alibi, **kw)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [FLASH_CASES[1], FLASH_CASES[9]])
def test_cuda_bf16_flash_bwd_is_deterministic(cuda, case):
    # no atomics: the dk/dv and dq launches each own their outputs, so two
    # calls on the same inputs agree bit for bit
    q, k, v, mask, alibi, kw, do = _flash_args(case, 11, torch.bfloat16, cuda)
    out, lse = flash_fwd(q, k, v, mask, *alibi, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    first = flash_bwd(q, k, v, mask, *alibi, lse, delta, do, **kw)
    second = flash_bwd(q, k, v, mask, *alibi, lse, delta, do, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", _HEAD_DIMS)
def test_cuda_bf16_flash_bwd_rejects_unsupported_head_dim(cuda, D, dtype):
    # every D runs forward and backward in both types (GQA, ALiBi, a window,
    # ragged 64-row tiles) against the plain versions; no head dim raises
    case = (2, 70, 75, 4, 2, D, True, 3, 5, 0, 40, True)
    q, k, v, mask, alibi, kw, do = _flash_args(case, D, dtype, cuda)
    out, lse = flash_fwd(q, k, v, mask, *alibi, **kw)
    f32 = [x.float() for x in (q, k, v)]
    want, want_lse = flash_fwd_reference(*f32, mask, *alibi, **kw)
    # chip_smoke.py's FLASH_TOL: out 1e-4 (f32) and 2e-2 (bf16)
    torch.testing.assert_close(out.float(), want, atol=1e-4 if dtype == torch.float32 else 2e-2,
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4 if dtype == torch.float32 else 1e-3,
                               rtol=0)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    before = flash_bwd.launches
    grads = flash_bwd(q, k, v, mask, *alibi, lse, delta, do, **kw)
    assert flash_bwd.launches == before + 1
    wants = flash_bwd_reference(*f32, mask, *alibi, lse, delta, do.float(), **kw)
    for got, w in zip(grads, wants):
        torch.testing.assert_close(got.float(), w, atol=_TOL[dtype] * 10, rtol=_TOL[dtype])


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


# the three timed shapes (training slice, default_ppo_config, the hh
# example's 125M rung), ragged ones, one row, and past the staged layout's
# shared memory (48 x 160: the kernel reads global memory in every pass)
_LOSS_SHAPES = [(16, 40), (32, 40), (32, 128), (13, 77), (3, 1), (48, 160)]


@pytest.mark.gpu
@pytest.mark.parametrize("use_iw", [False, True])
@pytest.mark.parametrize("shape", _LOSS_SHAPES)
def test_cuda_fused_loss_matches_plain_versions(cuda, shape, use_iw):
    ops = [t(x).to(cuda) for x in loss_case(*shape, seed=shape[1], tie_values=True)]
    ops = ops if use_iw else ops[:6]
    p = _loss_params()
    loss, sc, hist, res = fused_loss_fwd(p, ops)
    wloss, wsc, whist, wres = fused_loss_fwd_reference(p, ops)
    # f32 in both; reduction order differs
    torch.testing.assert_close(loss, wloss, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(sc, wsc, rtol=1e-4, atol=1e-6)
    assert float((hist - whist).abs().sum()) <= 2.0  # at most one edge value
    # the residuals: GAE by a scan, the whitening moments, n
    torch.testing.assert_close(res, wres, rtol=1e-4, atol=1e-6)
    g = torch.tensor(0.7, device=cuda)
    dlp, dv = fused_loss_bwd(p, ops, res, g)
    wlp, wv = fused_loss_bwd_reference(p, ops, wres, g)
    torch.testing.assert_close(dlp, wlp, rtol=1e-4, atol=1e-7)
    torch.testing.assert_close(dv, wv, rtol=1e-4, atol=1e-7)


@pytest.mark.gpu
def test_cuda_fused_loss_bins_fractional_weights(cuda):
    # a mask of 0, 0.5 and 1 takes the forward's weighted sketch path (lane
    # order, not ballot counts); halves sum exactly, so bins stay equal
    ops = [t(x).to(cuda) for x in loss_case(16, 40, seed=3)[:6]]
    ops[5] = ops[5] * torch.where(torch.arange(40, device=cuda) % 3 == 0, 0.5, 1.0)
    p = _loss_params()
    loss, sc, hist, res = fused_loss_fwd(p, ops)
    wloss, wsc, whist, wres = fused_loss_fwd_reference(p, ops)
    torch.testing.assert_close(sc, wsc, rtol=1e-4, atol=1e-6)
    assert float((hist - whist).abs().sum()) <= 2.0  # at most one edge value
    assert float(hist.sum()) == float(whist.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 40), (32, 128)])
def test_cuda_fused_loss_is_deterministic(cuda, shape):
    # no atomics: two calls give equal bits, sketches and residuals included
    ops = [t(x).to(cuda) for x in loss_case(*shape, seed=7, tie_values=True)]
    p = _loss_params()
    first = fused_loss_fwd(p, ops)
    second = fused_loss_fwd(p, ops)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    g = torch.tensor(1.0, device=cuda)
    for a, b in zip(fused_loss_bwd(p, ops, first[3], g), fused_loss_bwd(p, ops, second[3], g)):
        assert torch.equal(a, b)


# (T, S, q_offset, k_offset, alibi, window, H, KV, D): ring chunk pairs; the
# last lies wholly in the causal future of its queries
CHUNK_CASES = [
    (128, 128, 128, 0, False, 0, 4, 4, 64),
    (128, 128, 256, 128, True, 0, 4, 2, 32),
    (96, 160, 256, 0, False, 200, 4, 2, 128),
    (64, 64, 64, 64, False, 0, 8, 8, 64),
    (128, 128, 0, 128, False, 0, 4, 2, 64),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CHUNK_CASES)
def test_cuda_flash_bwd_chunk_matches_plain_version(cuda, case, dtype):
    T, S, q_off, k_off, alibi, window, H, KV, D = case
    rs = np.random.RandomState(sum(case[:4]))
    B = 2
    q, do = (t(rs.randn(B, T, H, D).astype(np.float32)).to(cuda, dtype) for _ in range(2))
    k, v = (t(rs.randn(B, S, KV, D).astype(np.float32)).to(cuda, dtype) for _ in range(2))
    mask = np.ones((B, S), np.float32)
    mask[0, :5] = 0.0
    mask[1] = 0.0  # row 1 sees no key anywhere: its global lse is NEG_INF
    lse = (rs.randn(B, H, T) + 4.0).astype(np.float32)
    lse[1] = -1e30
    mask, lse = t(mask).to(cuda), t(lse).to(cuda)
    delta = t(rs.randn(B, H, T).astype(np.float32)).to(cuda)
    kw = dict(sm_scale=D ** -0.5, causal=True, q_offset=q_off, k_offset=k_off, window=window)
    pos = [None, None, None]
    if alibi:
        pos = [t((np.arange(n)[None].repeat(B, 0) + off).astype(np.int32)).to(cuda)
               for n, off in ((T, q_off), (S, k_off))]
        pos.append(t((2.0 ** (-8.0 * np.arange(1, H + 1) / H)).astype(np.float32)).to(cuda))
    # NaN in the memory the wrapper's outputs will reuse: a tile the kernel
    # did not store would show
    torch.full((4 * B * S * H * D,), float("nan"), device=cuda)
    before = (flash_attention_bwd_chunk.launches, flash_bwd.launches)
    grads = flash_attention_bwd_chunk(q, k, v, mask, lse, delta, do, q_positions=pos[0],
                                      k_positions=pos[1], alibi_slopes=pos[2],
                                      **{k_: v_ for k_, v_ in kw.items() if k_ != "sm_scale"})
    torch.cuda.synchronize()
    assert (flash_attention_bwd_chunk.launches, flash_bwd.launches) == (before[0] + 1,
                                                                       before[1] + 1)
    wants = flash_bwd_reference(q.float(), k.float(), v.float(), mask, *pos, lse, delta,
                                do.float(), **kw)
    for got, w in zip(grads, wants):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        assert not got[1].any()  # the row that sees no key: zeros
        if k_off >= q_off + T:
            assert not got.any()  # wholly future: exact zeros
        torch.testing.assert_close(got.float(), w, atol=_TOL[dtype] * 10, rtol=_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,placement,window,KV", [(2, "zigzag", 0, 2), (4, "zigzag", 96, 4),
                                                   (4, "contiguous", 0, 2)])
def test_cuda_ring_matches_monolithic_flash(cuda, n, placement, window, KV, dtype):
    from trlx_tpu_torch.parallel.ring_attention import ring_flash_attention

    B, T, H, D = 2, 512, 4, 64
    rs = np.random.RandomState(n + KV)
    q, g = (t(rs.randn(B, T, H, D).astype(np.float32)).to(cuda, dtype) for _ in range(2))
    k, v = (t(rs.randn(B, T, KV, D).astype(np.float32)).to(cuda, dtype) for _ in range(2))
    mask = torch.ones(B, T, device=cuda)
    mask[0, :37] = 0.0
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = flash_attention_bwd_chunk.launches
    out = ring_flash_attention(*leaves, mask, n, placement=placement, window=window or None)
    grads = torch.autograd.grad(out, leaves, g)
    mono = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = flash_attention(*mono, mask, window=window or None)
    wgrads = torch.autograd.grad(want, mono, g)
    assert flash_attention_bwd_chunk.launches - before == n * n * (4 if placement == "zigzag"
                                                                   else 1)
    # FLASH_TOL of chip_smoke.py: both sides are the kernels, the ring
    # combining partial softmaxes in f32
    tol = {torch.float32: ((1e-4, 0.0), (1e-3, 1e-4)),
           torch.bfloat16: ((2e-2, 0.0), (2e-2, 1e-2))}[dtype]
    valid = mask > 0
    torch.testing.assert_close(out.float()[valid], want.float()[valid], atol=tol[0][0],
                               rtol=tol[0][1])
    for got, w in zip(grads, wgrads):
        torch.testing.assert_close(got.float(), w.float(), atol=tol[1][0], rtol=tol[1][1])


_GLOO_RANK = """
import json, sys, torch, torch.distributed as dist
import chip_smoke
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
probe = chip_smoke.gloo_cuda_probe(torch.device("cuda", 0))
dist.destroy_process_group()
json.dump(probe, open(f"{out}.{rank}", "w"))
"""


@pytest.mark.gpu
def test_cuda_gloo_carries_fsdp2_collectives(cuda, tmp_path):
    """Two processes on the one card in a gloo group (``slice_parallel_rl``'s
    set-up): each of FSDP2's collectives runs on CUDA tensors and gives
    the right result (``chip_smoke.gloo_cuda_probe``)."""
    import os
    import socket
    import subprocess
    import sys

    from chip_smoke import GLOO_COLLECTIVES, ROOT

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "probe")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_RANK, str(r), str(port), out],
                              cwd=ROOT, env=env) for r in range(2)]
    try:
        assert [p.wait(timeout=300) for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r in range(2):
        with open(f"{out}.{r}") as f:
            assert json.load(f) == {k: "ok" for k in GLOO_COLLECTIVES}
