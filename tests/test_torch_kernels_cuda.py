"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports no JAX, so it runs on a machine without it::

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_cuda.py

The cases are the CPU parity tests' edge cases (block sizes 1/3/4, GQA,
head-uniform and per-head bias, out-of-range table ids, masked columns
over stale pool blocks, ties at the top-k and top-p boundaries), in f32 and
bf16. ``chip_smoke.py`` makes the same comparison at the serving shapes.
"""

import pytest
import torch

from trlx_tpu_torch.ops.paged_attention import (
    fused_sample,
    fused_sample_reference,
    paged_attention_decode,
    paged_attention_decode_reference,
)
from trlx_tpu_torch.ops.paged_prefill import (
    paged_prefill_attention,
    paged_prefill_attention_reference,
)

from torch_kernel_cases import GEOMETRIES, SAMPLE_SETTINGS, paged_case, t, tied_logits

# f32: summation order only; bf16: the output's rounding (the kernel
# accumulates in f32 and is compared with the plain version run in f32)
_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _attention_args(geometry, per_head_bias, seed, dtype, dev):
    q, kp, vp, table, bias = paged_case(geometry, per_head_bias, seed)
    return ([t(a).to(dev, dtype) for a in (q, kp, vp)]
            + [t(table).to(dev), t(bias).to(dev)])


def _as_f32(args):
    return [a.float() if a.is_floating_point() else a for a in args]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_head_bias", [False, True])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_cuda_kernels_match_plain_versions(cuda, geometry, per_head_bias, dtype):
    args = _attention_args(geometry, per_head_bias, sum(geometry), dtype, cuda)
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
