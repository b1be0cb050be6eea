"""In-place paged-attention decode + fused sampling.

Port of ``trlx_tpu/ops/paged_attention.py``. Each kernel here is a CUDA
kernel written for Hopper (``trlx_tpu_torch/csrc/``) with a plain PyTorch
version beside it:

- :func:`paged_attention_decode` (``csrc/paged_decode.cu``) reads K/V
  through the block table in place — no dense view of the pool is ever
  built. The current step's K/V is committed by the caller first
  (``models/transformer.py::Attention``).
- :func:`paged_verify_attention` is the speculative verify: ``G + 1``
  probe queries per row at per-row depths over the row's committed
  prefix. It is a prefill-shaped pass, so on CUDA tensors it launches the
  paged-prefill kernel (``csrc/paged_prefill.cu``), as the JAX function
  delegates to the Pallas prefill kernel; it counts its own launches.
- :func:`fused_sample` (``csrc/fused_sample.cu``) runs the temperature /
  top-k / top-p filter, the Gumbel-argmax draw and the behaviour logprob
  as one kernel, one thread-block cluster per row, without a sort.

A wrapper runs its plain version only for tensors on the CPU (the CPU
tests); for CUDA tensors it launches the kernel or raises — there is no
fallback. Each wrapper counts its launches in a plain ``launches``
attribute, so a run can show that the main path went through the kernel.

The contract is tolerance parity with the plain versions (and, through
them, with the JAX package), not the TPU kernels' bit parity: the CUDA
attention uses an online softmax and the sampler sums its top-p masses
exactly in fixed point where ``cumsum`` rounds in f32 (see the sources'
notes).
"""

import ctypes
import math
from typing import Optional, Tuple

import torch

from trlx_tpu_torch.ops.kernel_utils import (
    launch_lock,
    attention_flops,
    check_cuda_operand,
    check_head_dim,
    check_launch,
    clamp_block_table,
    current_stream_ptr,
    kernel_fn,
    note_kernel_flops,
    plain_version,
)
from trlx_tpu_torch.ops.sampling import _block_eos, gumbel_noise, process_logits

__all__ = [
    "paged_attention_decode",
    "paged_attention_decode_reference",
    "paged_verify_attention",
    "paged_verify_attention_reference",
    "fused_sample",
    "fused_sample_reference",
    "sample_token_fused",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# key columns per block of the decode kernel: csrc/paged_decode.cu's
# SPAN_COLS, which this sizes the merge scratch for (a test ties the two)
DECODE_SPAN_COLS = 256
# the widest row csrc/fused_sample.cu takes: its CLUSTER blocks' slices of
# at most MAX_SLICE logits each (16-bit halves of the masses cannot overflow)
SAMPLE_MAX_VOCAB = 8 * 65535
# FLOP formula of csrc/fused_sample.cu: elementwise arithmetic per logit
# (temperature, the thresholds' compares, softmax exp and sum, the Gumbel
# add, the logprob)
SAMPLE_FLOPS_PER_LOGIT = 8


def _check_paged_shapes(H, KV, HB, S, TB, bs):
    if H % KV:
        raise ValueError(f"q heads {H} not a multiple of kv heads {KV}")
    if HB not in (1, H):
        raise ValueError(f"bias head dim {HB} must be 1 (head-uniform) or H={H}")
    if TB * bs < S:
        raise ValueError(f"block table covers {TB * bs} columns < bias width {S}")


def _check_paged_operands(q, k_pool, v_pool, block_table, bias):
    dev = q.device
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        check_cuda_operand(t, name, dev, tuple(_DTYPE_CODE))
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError("q and the K/V pools must share one dtype")
    check_cuda_operand(block_table, "block_table", dev, (torch.int32,))
    check_cuda_operand(bias, "bias", dev, (torch.float32,))


# ---------------------------------------------------------------------------
# paged-attention decode
# ---------------------------------------------------------------------------


def paged_attention_decode(
    q: torch.Tensor,  # (B, H, D) single-step queries
    k_pool: torch.Tensor,  # (NB, bs, KV, D) — the persistent block pool
    v_pool: torch.Tensor,  # (NB, bs, KV, D)
    block_table: torch.Tensor,  # (B, TB) int32; out-of-range ids clamp
    bias: torch.Tensor,  # (B, HB, S) additive f32 bias; HB is 1 or H
) -> torch.Tensor:
    """One decode step of attention, reading K/V through the block table.
    Returns ``(B, H, D)`` in ``q.dtype``. The pool is only read. On CUDA
    tensors any D >= 1 runs: the kernel is compiled for padded head dims
    16, 32, 64, 128 and 256 and reads the true D from the pool in place (no
    padded copy), and splits D above 256 into 256-column output chunks;
    rows longer than :data:`DECODE_SPAN_COLS` columns are
    split over that many columns per block and merged by a second launch
    (one call, one count)."""
    B, H, D = q.shape
    NB, bs, KV, _ = k_pool.shape
    TB = block_table.shape[1]
    HB, S = bias.shape[1], bias.shape[2]
    _check_paged_shapes(H, KV, HB, S, TB, bs)
    note_kernel_flops("paged_decode", attention_flops(B, 1, S, H, D))
    if q.device.type == "cpu":
        with plain_version():
            return paged_attention_decode_reference(q, k_pool, v_pool, block_table, bias)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode runs on cuda or cpu, not {q.device}")
    _check_paged_operands(q, k_pool, v_pool, block_table, bias)
    check_head_dim("paged_attention_decode", D)
    out = torch.empty_like(q)
    spans = -(-S // DECODE_SPAN_COLS)
    part = None
    if spans > 1:  # each span's (acc, max, sum), merged by a second launch
        part = torch.empty((B, H, spans, D + 2), dtype=torch.float32, device=q.device)
    fn = kernel_fn("paged_decode", [_P] * 7 + [_I] * 10 + [_P])
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), bias.data_ptr(), out.data_ptr(),
            part.data_ptr() if part is not None else None,
            B, H, KV, D, NB, bs, TB, HB, S, _DTYPE_CODE[q.dtype],
            current_stream_ptr(q.device))
    check_launch("paged_decode", rc)
    with launch_lock:  # actor threads launch beside the learner
        paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0


def _gathered_view(pool, block_table, S, H):
    """Dense ``[B, S, H, D]`` view of the rows' K or V (GQA repeated)."""
    NB, bs, KV, D = pool.shape
    B = block_table.shape[0]
    v = pool[clamp_block_table(block_table, NB)]  # (B, TB, bs, KV, D)
    v = v.reshape(B, -1, KV, D)[:, :S]
    if KV < H:
        v = torch.repeat_interleave(v, H // KV, dim=2)
    return v


def _dense_attention(q, k, v, bias):
    """The dense path op for op: scores in q.dtype, bias added, softmax in
    f32, probabilities cast back, then ``p·v``."""
    scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(q.shape[-1])
    scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def paged_attention_decode_reference(q, k_pool, v_pool, block_table, bias):
    """Gather-then-dense plain version of :func:`paged_attention_decode`."""
    S = bias.shape[2]
    H = q.shape[1]
    k = _gathered_view(k_pool, block_table, S, H)
    v = _gathered_view(v_pool, block_table, S, H)
    return _dense_attention(q[:, None], k, v, bias[:, :, None, :])[:, 0]


# ---------------------------------------------------------------------------
# multi-position speculative verify
# ---------------------------------------------------------------------------


def paged_verify_attention(
    q: torch.Tensor,  # (B, G+1, H, D) probe-column queries
    k_pool: torch.Tensor,  # (NB, bs, KV, D) — the persistent block pool
    v_pool: torch.Tensor,  # (NB, bs, KV, D)
    block_table: torch.Tensor,  # (B, TB) int32; out-of-range ids clamp
    bias: torch.Tensor,  # (B, HB, G+1, S) additive f32 slot-causality bias
) -> torch.Tensor:
    """Speculative verify: the target scoring ``G + 1`` probe columns (the
    re-fed last committed token and ``G`` draft tokens) against the row's
    committed prefix, in place through the block table. The per-row probe
    window's slot-causality is carried by ``bias``; the probes' K/V were
    committed by the caller. Returns ``(B, G+1, H, D)`` in ``q.dtype``.

    Port of ``trlx_tpu/ops/paged_attention.py::paged_verify_attention``,
    which delegates to the prefill kernel ("delegation is the bit-parity
    guarantee"): here the same CUDA kernel as
    :func:`~trlx_tpu_torch.ops.paged_prefill.paged_prefill_attention`
    runs, at ``T = G + 1``. For ``T <= 16`` its bf16 launcher picks the
    skinny layout: one 16-row query tile per (row, head), the row's key
    chunks split over four warps whose partial softmax states merge at
    the end."""
    from trlx_tpu_torch.ops.paged_prefill import (
        SPAN_ARGTYPES,
        check_span_shapes,
        span_launch_args,
    )

    check_span_shapes(q, k_pool, block_table, bias, "verify window")
    B, T, H, D = q.shape
    note_kernel_flops("paged_verify", attention_flops(B, T, bias.shape[-1], H, D))
    if q.device.type == "cpu":
        with plain_version():
            return paged_verify_attention_reference(q, k_pool, v_pool, block_table, bias)
    out, args = span_launch_args(q, k_pool, v_pool, block_table, bias,
                                 "paged_verify_attention")
    check_launch("paged_prefill", kernel_fn("paged_prefill", SPAN_ARGTYPES)(*args))
    with launch_lock:  # actor threads launch beside the learner
        paged_verify_attention.launches += 1
    return out


paged_verify_attention.launches = 0


def paged_verify_attention_reference(q, k_pool, v_pool, block_table, bias):
    """Gather-then-dense plain version of :func:`paged_verify_attention`
    (the prefill's: the verify is a prefill-shaped pass)."""
    from trlx_tpu_torch.ops.paged_prefill import paged_prefill_attention_reference

    return paged_prefill_attention_reference(q, k_pool, v_pool, block_table, bias)


# ---------------------------------------------------------------------------
# fused temperature / top-k / top-p sampling
# ---------------------------------------------------------------------------


def fused_sample(
    logits: torch.Tensor,  # (B, V) f32 raw logits (already adjusted/eos-blocked)
    gumbel: Optional[torch.Tensor],  # (B, V) f32 noise, or None for greedy
    *,
    temperature: float,
    top_k: int,
    top_p: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filter + draw + behaviour logprob in one kernel launch: a cluster of
    8 thread blocks per row, each owning a slice of the vocabulary in its
    shared memory, the top-k and top-p thresholds found by radix select
    over the logits' order-preserving integer keys, merged through the
    cluster's distributed shared memory. Deterministic. Returns
    ``(token [B] int32, logprob [B] f32)``."""
    B, V = logits.shape
    note_kernel_flops("fused_sample", SAMPLE_FLOPS_PER_LOGIT * B * V)
    if logits.device.type == "cpu":
        with plain_version():
            return fused_sample_reference(
                logits, gumbel, temperature=temperature, top_k=top_k, top_p=top_p
            )
    if logits.device.type != "cuda":
        raise ValueError(f"fused_sample runs on cuda or cpu, not {logits.device}")
    check_cuda_operand(logits, "logits", logits.device, (torch.float32,))
    if V > SAMPLE_MAX_VOCAB:
        raise ValueError(f"fused_sample takes rows of at most {SAMPLE_MAX_VOCAB} logits, not {V}")
    if gumbel is not None:
        check_cuda_operand(gumbel, "gumbel", logits.device, (torch.float32,))
        if gumbel.shape != logits.shape:
            raise ValueError(f"gumbel {tuple(gumbel.shape)} != logits {(B, V)}")
    tok = torch.empty((B,), dtype=torch.int32, device=logits.device)
    lp = torch.empty((B,), dtype=torch.float32, device=logits.device)
    fn = kernel_fn("fused_sample", [_P] * 4 + [_I, _I, _F, _I, _F, _P])
    rc = fn(logits.data_ptr(), gumbel.data_ptr() if gumbel is not None else None,
            tok.data_ptr(), lp.data_ptr(), B, V, float(temperature),
            int(top_k or 0), float(top_p), current_stream_ptr(logits.device))
    check_launch("fused_sample", rc)
    with launch_lock:  # actor threads launch beside the learner
        fused_sample.launches += 1
    return tok, lp


fused_sample.launches = 0


def fused_sample_reference(logits, gumbel, *, temperature, top_k, top_p):
    """Plain version: ``process_logits`` → argmax(noise + filtered) (first
    index on ties) → ``log_softmax`` gather of the raw row."""
    filtered = process_logits(logits, temperature, top_k, top_p)
    choice = torch.argmax(filtered if gumbel is None else gumbel + filtered, dim=-1)
    lp = torch.log_softmax(logits, dim=-1).gather(1, choice[:, None])[:, 0]
    return choice.to(torch.int32), lp


def sample_token_fused(
    logits: torch.Tensor,  # [B, V] raw last-position logits
    step_out,
    seeds: torch.Tensor,  # [B] int64 per-row seeds
    config,  # GenerationConfig
    step: torch.Tensor,  # [B] per-slot decode steps
    adjust_logits=None,
    greedy: Optional[torch.Tensor] = None,  # [B] bool rows decoded greedily
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in fused twin of ``ops/sampling.py::sample_token_from_logits``:
    the same adjust-hook / eos-blocking prologue (elementwise torch ops),
    the same per-row noise, then one :func:`fused_sample` call. Rows
    flagged ``greedy`` get zero noise, i.e. the argmax of the filtered row
    (the top value always survives the filters), so one batch can serve
    greedy and sampled requests together."""
    if adjust_logits is not None:
        logits = adjust_logits(step_out, logits)
    logits = _block_eos(logits.float(), config, step).contiguous()
    gumbel = None
    if config.do_sample:
        gumbel = gumbel_noise(seeds, step, logits.shape[-1])
        if greedy is not None:
            gumbel = gumbel.masked_fill(greedy[:, None], 0.0)
    return fused_sample(
        logits, gumbel,
        temperature=config.temperature, top_k=config.top_k, top_p=config.top_p,
    )
