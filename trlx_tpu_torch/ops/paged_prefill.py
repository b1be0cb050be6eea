"""Paged prefill attention: T chunk queries per row over the row's full
S-wide key row, reading K/V in place through the block table.

Port of ``trlx_tpu/ops/paged_prefill.py``. The kernel is
``csrc/paged_prefill.cu`` (one thread block per query tile, head and row;
online softmax in f32). The chunk's own K/V is committed through the table
by the caller (``models/transformer.py::Attention``) before the call, so
no dense view exists on entry and nothing is scattered on exit. Masked
key columns carry the ``-1e9`` additive bias and contribute exactly 0.

The wrapper runs :func:`paged_prefill_attention_reference` only for CPU
tensors; on CUDA tensors it launches the kernel or raises.
"""

import torch

from trlx_tpu_torch.ops.kernel_utils import (
    check_launch,
    current_stream_ptr,
    kernel_fn,
)
from trlx_tpu_torch.ops.paged_attention import (
    _DTYPE_CODE,
    _I,
    _P,
    _check_paged_operands,
    _check_paged_shapes,
    _dense_attention,
    _gathered_view,
)

__all__ = ["paged_prefill_attention", "paged_prefill_attention_reference"]


def paged_prefill_attention(
    q: torch.Tensor,  # (B, T, H, D) chunk queries
    k_pool: torch.Tensor,  # (NB, bs, KV, D)
    v_pool: torch.Tensor,  # (NB, bs, KV, D)
    block_table: torch.Tensor,  # (B, TB) int32; out-of-range ids clamp
    bias: torch.Tensor,  # (B, HB, T, S) additive f32 bias; HB is 1 or H
) -> torch.Tensor:
    """Chunked prompt attention reading K/V through the block table.
    Returns ``(B, T, H, D)`` in ``q.dtype``. The pool is only read."""
    B, T, H, D = q.shape
    NB, bs, KV, _ = k_pool.shape
    TB = block_table.shape[1]
    HB = bias.shape[1]
    if bias.shape[2] != T:
        raise ValueError(f"bias query dim {bias.shape[2]} != chunk length T={T}")
    S = bias.shape[3]
    _check_paged_shapes(H, KV, HB, S, TB, bs)
    if q.device.type == "cpu":
        return paged_prefill_attention_reference(q, k_pool, v_pool, block_table, bias)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention runs on cuda or cpu, not {q.device}")
    _check_paged_operands(q, k_pool, v_pool, block_table, bias)
    out = torch.empty_like(q)
    fn = kernel_fn("paged_prefill", [_P] * 6 + [_I] * 11 + [_P])
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, T, H, KV, D, NB, bs, TB, HB, S, _DTYPE_CODE[q.dtype],
            current_stream_ptr(q.device))
    check_launch("paged_prefill", rc)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0


def paged_prefill_attention_reference(q, k_pool, v_pool, block_table, bias):
    """Gather-then-dense plain version of :func:`paged_prefill_attention`."""
    S = bias.shape[3]
    H = q.shape[2]
    k = _gathered_view(k_pool, block_table, S, H)
    v = _gathered_view(v_pool, block_table, S, H)
    return _dense_attention(q, k, v, bias)
