"""The port's paged-attention decode, paged prefill, speculative verify and
fused sampling (``trlx_tpu_torch/ops``) against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
those plain versions against the JAX Pallas kernels run the way
``tests/test_paged_attention.py`` runs them on the CPU (interpreter mode),
and against the JAX ``*_reference`` oracles. Inputs come from numpy with a
seed. Attention is compared in f32 at ``atol=1e-5``; sampling must give
equal tokens and logprobs within ``1e-6`` from the same numpy Gumbel noise.
The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_kernels_cuda.py``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.paged_attention import (
    fused_sample as jax_fused_sample,
    paged_attention_decode as jax_decode,
    paged_attention_decode_reference,
    paged_verify_attention as jax_verify,
)
from trlx_tpu.ops.paged_prefill import (
    paged_prefill_attention as jax_prefill,
    paged_prefill_attention_reference,
)
from trlx_tpu.ops.sampling import process_logits as jax_process_logits
from trlx_tpu_torch.ops import kernel_utils
from trlx_tpu_torch.ops.kernel_utils import (
    check_head_dim,
    clamp_block_table,
    pad_bias_to,
)
from trlx_tpu_torch.ops.paged_attention import (
    DECODE_SPAN_COLS,
    SAMPLE_MAX_VOCAB,
    fused_sample,
    fused_sample_reference,
    paged_attention_decode,
    paged_verify_attention,
    paged_verify_attention_reference,
)
from trlx_tpu_torch.ops.paged_prefill import paged_prefill_attention
from trlx_tpu_torch.ops.sampling import gumbel_noise, process_logits

from torch_kernel_cases import (
    GEOMETRIES,
    SAMPLE_SETTINGS,
    VERIFY_CASES,
    paged_case,
    t,
    tied_logits,
    verify_case,
)

ATOL = 1e-5

# the JAX references under one jit each: eager, every op compiles on its
# own for every shape, which is many times slower here
jax_decode_ref = jax.jit(paged_attention_decode_reference)
jax_prefill_ref = jax.jit(paged_prefill_attention_reference)


@pytest.mark.parametrize("per_head_bias", [False, True])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_prefill_plain_matches_jax(geometry, per_head_bias):
    q, kp, vp, table, bias = paged_case(geometry, per_head_bias, seed=sum(geometry))
    got = paged_prefill_attention(t(q), t(kp), t(vp), t(table), t(bias)).numpy()
    args = tuple(jnp.asarray(a) for a in (q, kp, vp, table, bias))
    np.testing.assert_allclose(got, np.asarray(jax_prefill_ref(*args)), atol=ATOL, rtol=0)
    if per_head_bias:  # the interpreted Pallas kernel (slow to trace: once per geometry)
        np.testing.assert_allclose(got, np.asarray(jax_prefill(*args)), atol=ATOL, rtol=0)


@pytest.mark.parametrize("per_head_bias", [False, True])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_decode_plain_matches_jax(geometry, per_head_bias):
    q, kp, vp, table, bias = paged_case(geometry, per_head_bias, seed=7 + sum(geometry))
    q1, b1 = q[:, -1], bias[:, :, -1]
    got = paged_attention_decode(t(q1), t(kp), t(vp), t(table), t(b1)).numpy()
    args = tuple(jnp.asarray(a) for a in (q1, kp, vp, table, b1))
    np.testing.assert_allclose(got, np.asarray(jax_decode_ref(*args)), atol=ATOL, rtol=0)
    if not per_head_bias:  # the interpreted Pallas kernel, once per geometry
        np.testing.assert_allclose(got, np.asarray(jax_decode(*args)), atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", VERIFY_CASES)
def test_verify_plain_matches_jax_interpreted(case):
    """``paged_verify_attention_reference`` (what the wrapper runs on CPU
    tensors) against JAX ``paged_verify_attention`` — the Pallas prefill
    kernel, interpreted — at per-row probe depths, a window across a block
    edge, zero-block table entries and poisoned done rows."""
    q, kp, vp, table, bias = verify_case(case, seed=3 + sum(case))
    got = paged_verify_attention(t(q), t(kp), t(vp), t(table), t(bias))
    torch.testing.assert_close(
        got, paged_verify_attention_reference(t(q), t(kp), t(vp), t(table), t(bias)),
        atol=0, rtol=0)
    want = jax_verify(*(jnp.asarray(a) for a in (q, kp, vp, table, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="verify window"):
        paged_verify_attention(t(q), t(kp), t(vp), t(table), t(bias)[:, :, :-1])


def test_masked_stale_blocks_contribute_nothing():
    """Overwriting every masked column's pool value changes nothing."""
    q, kp, vp, table, bias = paged_case((2, 3, 4, 2, 16, 4, 11), False, seed=3)
    out = paged_prefill_attention(t(q), t(kp), t(vp), t(table), t(bias))
    NB, bs = kp.shape[:2]
    safe = np.minimum(table, NB - 1)
    visible_any = (bias[:, 0] > -1).any(axis=1)  # [B, S]
    seen = {
        (int(safe[b, s // bs]), s % bs)
        for b in range(table.shape[0]) for s in range(bias.shape[-1]) if visible_any[b, s]
    }
    kp2, vp2 = np.full_like(kp, 1e3), np.full_like(vp, -1e3)
    for blk, off in seen:  # every pool slot no visible column reads is garbage
        kp2[blk, off], vp2[blk, off] = kp[blk, off], vp[blk, off]
    out2 = paged_prefill_attention(t(q), t(kp2), t(vp2), t(table), t(bias))
    torch.testing.assert_close(out, out2, atol=ATOL, rtol=0)


def test_shape_validation_raises():
    q, kp, vp, table, bias = paged_case((2, 3, 4, 2, 16, 4, 11), False, seed=5)
    with pytest.raises(ValueError, match="bias head dim"):
        paged_prefill_attention(t(q), t(kp), t(vp), t(table), t(bias).repeat(1, 3, 1, 1))
    with pytest.raises(ValueError, match="chunk length"):
        paged_prefill_attention(t(q), t(kp), t(vp), t(table), t(bias)[:, :, :2])
    with pytest.raises(ValueError, match="block table covers"):
        paged_attention_decode(t(q[:, 0]), t(kp), t(vp), t(table)[:, :1], t(bias[:, :, 0]))


def test_fully_masked_query_averages_like_jax():
    """A query whose every column carries the ``-1e9`` bias: the plain
    version (and so the CUDA kernels, held to it on the card) averages the
    row's ``S`` columns through the clamped table, as the JAX reference does."""
    q, kp, vp, table, bias = paged_case((2, 4, 4, 2, 16, 3, 10), True, seed=11, dead_row=True)
    assert (bias[0, :, 0] <= -1e9).all()
    got = paged_prefill_attention(t(q), t(kp), t(vp), t(table), t(bias)).numpy()
    args = tuple(jnp.asarray(a) for a in (q, kp, vp, table, bias))
    np.testing.assert_allclose(got, np.asarray(jax_prefill_ref(*args)), atol=ATOL, rtol=0)
    NB, bs, KV = kp.shape[:3]
    S, H = bias.shape[-1], q.shape[2]
    safe = np.minimum(table[0], NB - 1)
    v_row = np.stack([vp[safe[s // bs], s % bs] for s in range(S)])  # [S, KV, D]
    want = v_row.mean(axis=0)[np.arange(H) // (H // KV)]
    np.testing.assert_allclose(got[0, 0], want, atol=ATOL, rtol=0)


def test_bf16_span_kernel_limits():
    """The attention kernels' head-dim check, made before any launch: every
    D >= 1 runs, as in the JAX kernels (the tensor-core kernels' other D
    padded inside their loads, D above 256 split over the head dim by the
    CUDA-core kernels), so neither a head dim outside 16/32/64/128, nor an
    operand off a 16-byte boundary, nor D above 256 raises; D = 0 does."""
    for D in (1, 12, 16, 48, 64, 96, 128, 200, 256, 257, 320, 384, 512):
        check_head_dim("paged span attention", D)
    with pytest.raises(ValueError, match="D=0"):
        check_head_dim("paged span attention", 0)


def test_sample_vocab_limit_matches_the_kernel():
    """The wrapper's widest row is the kernel's cluster size times its
    largest slice."""
    src = (Path(kernel_utils.__file__).parent.parent / "csrc" / "fused_sample.cu").read_text()
    cluster = int(re.findall(r"constexpr int CLUSTER = (\d+);", src)[0])
    max_slice = int(re.findall(r"constexpr int MAX_SLICE = (\d+);", src)[0])
    assert SAMPLE_MAX_VOCAB == cluster * max_slice


def test_decode_span_width_matches_the_kernel():
    """The wrapper sizes the decode's merge scratch by DECODE_SPAN_COLS; the
    kernel splits a row's columns by its own compile-time SPAN_COLS."""
    src = (Path(kernel_utils.__file__).parent.parent / "csrc" / "paged_decode.cu").read_text()
    found = re.findall(r"constexpr int SPAN_COLS = (\d+);", src)
    assert found == [str(DECODE_SPAN_COLS)]


def test_table_helpers():
    tbl = torch.tensor([[0, 5, 9, 12]], dtype=torch.int32)
    assert clamp_block_table(tbl, 10).tolist() == [[0, 5, 9, 9]]
    b = pad_bias_to(torch.zeros(2, 1, 3, dtype=torch.float64), 5)
    assert b.shape == (2, 1, 5) and b.dtype == torch.float32


# ---------------------------------------------------------------------------
# fused sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("settings", SAMPLE_SETTINGS)
def test_fused_sample_plain_matches_jax(settings, sample):
    x = tied_logits(seed=11)
    rs = np.random.RandomState(12)
    g = (-np.log(-np.log(rs.uniform(1e-7, 1 - 1e-7, x.shape)))).astype(np.float32) if sample else None
    tok, lp = fused_sample(t(x), None if g is None else t(g), **settings)
    jtok, jlp = jax_fused_sample(jnp.asarray(x), None if g is None else jnp.asarray(g), **settings)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-6, rtol=0)
    assert tok.dtype == torch.int32 and lp.dtype == torch.float32


@pytest.mark.parametrize("settings", SAMPLE_SETTINGS)
def test_process_logits_matches_jax(settings):
    x = tied_logits(seed=21)
    got = process_logits(t(x), **settings).numpy()
    want = np.asarray(jax_process_logits(jnp.asarray(x), **settings))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)], atol=1e-6)


def test_fused_sample_greedy_first_index_on_ties():
    x = torch.zeros(2, 9)
    x[0, [2, 6]] = 3.0
    x[1, [8, 1]] = 3.0
    tok, _ = fused_sample_reference(x, None, temperature=1.0, top_k=0, top_p=1.0)
    assert tok.tolist() == [2, 1]


def test_gumbel_noise_is_per_row_and_batch_invariant():
    seeds = torch.tensor([5, 9, 5, 123456789012])
    steps = torch.tensor([0, 3, 1, 7])
    g = gumbel_noise(seeds, steps, 50)
    solo = torch.cat([gumbel_noise(seeds[i : i + 1], steps[i : i + 1], 50) for i in range(4)])
    torch.testing.assert_close(g, solo, atol=0, rtol=0)
    assert not torch.equal(g[0], g[2])  # same seed, other step
    again = gumbel_noise(seeds.flip(0), steps.flip(0), 50).flip(0)
    torch.testing.assert_close(g, again, atol=0, rtol=0)
    # roughly standard Gumbel: mean ≈ Euler-Mascheroni constant
    big = gumbel_noise(torch.arange(16), torch.zeros(16, dtype=torch.int64), 4096)
    assert torch.isfinite(big).all()
    assert abs(big.mean().item() - 0.5772) < 0.03


# ---------------------------------------------------------------------------
# the fused sampler's radix select, emulated on the CPU
# ---------------------------------------------------------------------------

MASS_ONE = 2 ** 31  # csrc/fused_sample.cu's fixed point: a mass of 1


def _fkey(x: torch.Tensor) -> torch.Tensor:
    """fused_sample.cu's ``fkey``: the order-preserving uint32 image of an
    f32, as int64."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 2 ** 31, (~u) & 0xFFFFFFFF, u | 2 ** 31)


def _radix_select(keys, weights, need):
    """Four 8-bit rounds, most significant digit first: among keys that
    match the digits chosen so far, the first digit (from 255 down) whose
    inclusive cumulative weight reaches ``need``; ``need`` less the weight
    above it carries to the next round. Returns the selected key."""
    prefix = 0
    for r in range(4):
        shift = 24 - 8 * r
        cand = torch.ones_like(keys, dtype=torch.bool) if r == 0 else (
            (keys >> (shift + 8)) == (prefix >> (shift + 8)))
        digits = (keys[cand] >> shift) & 255
        hist = torch.zeros(256, dtype=torch.int64).index_add_(0, digits, weights[cand])
        desc = hist.flip(0)
        cum = desc.cumsum(0)
        j = int(torch.nonzero(cum >= need)[0])
        need -= int(cum[j] - desc[j])
        prefix |= (255 - j) << shift
    return prefix


def _radix_filter(x: torch.Tensor, temperature, top_k, top_p) -> torch.Tensor:
    """fused_sample.cu's filter in torch, row by row: the top-k key by
    counts, then the top-p key over the top-k survivors by fixed-point
    masses (exp(x - max) in f32, times 2^31, rounded: integer sums, exact in
    any order), the crossing at ceil(p Z); x kept where its key reaches
    both."""
    if temperature != 1.0:
        x = x / max(temperature, 1e-6)
    out = torch.empty_like(x)
    V = x.shape[-1]
    for b in range(x.shape[0]):
        row = x[b]
        keys = _fkey(row)
        thr = 0
        surv = torch.ones(V, dtype=torch.bool)
        if top_k and 0 < top_k < V:
            thr = _radix_select(keys, torch.ones(V, dtype=torch.int64), top_k)
            surv = keys >= thr
        if top_p < 1.0:
            mass = torch.round(torch.exp(row - row.max()).double() * MASS_ONE).to(torch.int64)
            mass = torch.where(surv, mass, torch.zeros_like(mass))
            need = int(np.ceil(np.float64(np.float32(top_p)) * float(int(mass.sum()))))
            thr = max(thr, _radix_select(keys, mass, need))
        out[b] = torch.where(keys >= thr, row, torch.full_like(row, float("-inf")))
    return out


def _bf16_rows(seed, B=3, V=50257):
    """Rows of a bf16 model's logits at GPT-2's vocabulary: many exact ties."""
    rs = np.random.RandomState(seed)
    return (rs.randn(B, V) * 3.0).astype(np.float32).astype(jnp.bfloat16).astype(np.float32)


_RADIX_CASES = {
    # tied rows (ties at the top-k and top-p thresholds, an eos-blocked -inf)
    "tied_topk": ("tied", dict(temperature=0.7, top_k=5, top_p=1.0)),
    "tied_topp": ("tied", dict(temperature=1.0, top_k=0, top_p=0.8)),
    "tied_both": ("tied", dict(temperature=1.3, top_k=7, top_p=0.6)),
    "tied_topk_ge_V": ("tied", dict(temperature=1.0, top_k=97, top_p=0.9)),
    "tied_top_token_only": ("tied", dict(temperature=1.0, top_k=0, top_p=1e-6)),
    # bf16-rounded rows at V = 50257: the served and timed settings
    "bf16_topk": ("bf16", dict(temperature=0.7, top_k=50, top_p=1.0)),
    "bf16_topp": ("bf16", dict(temperature=1.0, top_k=0, top_p=0.9)),
    "bf16_served": ("bf16", dict(temperature=1.0, top_k=50, top_p=0.95)),
    "bf16_topk_ge_V": ("bf16", dict(temperature=1.0, top_k=60000, top_p=0.95)),
    "bf16_top_token_only": ("bf16", dict(temperature=1.0, top_k=0, top_p=1e-7)),
}


@pytest.mark.parametrize("name", sorted(_RADIX_CASES))
def test_fused_sample_radix_select_matches_jax(name):
    """The fused sampler's threshold selection (radix select over 8-bit
    digits of integer keys, fixed-point top-p masses over the top-k
    survivors), emulated in torch, keeps exactly the set JAX's
    ``process_logits`` keeps, ties included."""
    rows, settings = _RADIX_CASES[name]
    x = tied_logits(seed=31) if rows == "tied" else _bf16_rows(seed=32)
    got = _radix_filter(t(x), **settings).numpy()
    want = np.asarray(jax_process_logits(jnp.asarray(x), **settings))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[~np.isinf(got)], want[~np.isinf(want)])
