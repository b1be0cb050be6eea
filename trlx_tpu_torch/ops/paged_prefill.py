"""Paged prefill attention: T chunk queries per row over the row's full
S-wide key row, reading K/V in place through the block table.

Port of ``trlx_tpu/ops/paged_prefill.py``. The kernel is
``csrc/paged_prefill.cu``. In bf16 it runs on tensor cores (``mma.sync``)
over chunks of key columns gathered through the table by ``cp.async``
into a ring of stages, with an online softmax in f32, in one of two
layouts chosen by ``T``: above 16 queries (prefill) a block of two warps
holds 32 queries of one (row, head) over shared 32-column chunks, three
stages deep; at 16 or fewer (the speculative verify's ``G + 1``) a block
of four warps splits the row's 16-column chunks, each warp
double-buffered, and merges the four partial softmax states. The bf16
kernel is compiled for head dims 16, 32, 64 and 128 and takes any D up to
128 padded inside its loads; bf16 above 128 runs the CUDA-core kernel,
chosen by D in the C dispatch, as does f32 (the parity runs); it splits D
above 256 into 256-column output chunks, so any D >= 1 runs. The chunk's
own K/V is committed through the table by the caller
(``models/transformer.py::Attention``) before the call, so no dense view
exists on entry and nothing is scattered on exit. Masked key columns
carry the ``-1e9`` additive bias and contribute exactly 0.

The wrapper runs :func:`paged_prefill_attention_reference` only for CPU
tensors; on CUDA tensors it launches the kernel or raises.
"""

import torch

from trlx_tpu_torch.ops.kernel_utils import (
    attention_flops,
    check_head_dim,
    check_launch,
    current_stream_ptr,
    kernel_fn,
    note_kernel_flops,
    plain_version,
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
    check_span_shapes(q, k_pool, block_table, bias, "chunk length")
    B, T, H, D = q.shape
    note_kernel_flops("paged_prefill", attention_flops(B, T, bias.shape[-1], H, D))
    if q.device.type == "cpu":
        with plain_version():
            return paged_prefill_attention_reference(q, k_pool, v_pool, block_table, bias)
    out, args = span_launch_args(q, k_pool, v_pool, block_table, bias,
                                 "paged_prefill_attention")
    check_launch("paged_prefill", kernel_fn("paged_prefill", SPAN_ARGTYPES)(*args))
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0

# the C entry of csrc/paged_prefill.cu: six pointers, eleven ints, the stream
SPAN_ARGTYPES = [_P] * 6 + [_I] * 11 + [_P]


def check_span_shapes(q, k_pool, block_table, bias, what: str) -> None:
    """Shape checks of a span of ``T`` queries over the ``S``-wide row."""
    if bias.shape[2] != q.shape[1]:
        raise ValueError(f"bias query dim {bias.shape[2]} != {what} T={q.shape[1]}")
    _check_paged_shapes(q.shape[2], k_pool.shape[2], bias.shape[1], bias.shape[3],
                        block_table.shape[1], k_pool.shape[1])


def span_launch_args(q, k_pool, v_pool, block_table, bias, caller: str):
    """``(out, C arguments)`` of one ``csrc/paged_prefill.cu`` launch on
    CUDA operands — shared by the prefill and the speculative-verify
    wrappers, which launch the same kernel and count their own launches."""
    if q.device.type != "cuda":
        raise ValueError(f"{caller} runs on cuda or cpu, not {q.device}")
    _check_paged_operands(q, k_pool, v_pool, block_table, bias)
    B, T, H, D = q.shape
    check_head_dim("paged span attention", D)
    NB, bs, KV, _ = k_pool.shape
    out = torch.empty_like(q)
    args = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
            bias.data_ptr(), out.data_ptr(), B, T, H, KV, D, NB, bs, block_table.shape[1],
            bias.shape[1], bias.shape[3], _DTYPE_CODE[q.dtype], current_stream_ptr(q.device))
    return out, args


def paged_prefill_attention_reference(q, k_pool, v_pool, block_table, bias):
    """Gather-then-dense plain version of :func:`paged_prefill_attention`."""
    S = bias.shape[3]
    H = q.shape[2]
    k = _gathered_view(k_pool, block_table, S, H)
    v = _gathered_view(v_pool, block_table, S, H)
    return _dense_attention(q, k, v, bias)
