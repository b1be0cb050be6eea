"""Flash attention (forward and recomputation backward) for full passes.

Port of ``trlx_tpu/ops/flash_attention.py``. Two CUDA kernels written for
Hopper, each with a plain PyTorch version beside it:

- :func:`flash_fwd` (``csrc/flash_fwd.cu``): online-softmax attention that
  emits the output and the per-row logsumexp ``lse``;
- :func:`flash_bwd` (``csrc/flash_bwd.cu``): dq, dk and dv recomputed from
  ``lse`` and ``delta = rowsum(do * out)`` (two launches, dk/dv then dq).

:func:`flash_attention_bwd_chunk` is the backward's chunk form, one
(q-chunk x kv-chunk) term from the *global* ``lse`` and ``delta`` with
slot offsets (ring attention's backward, ``parallel/ring_attention.py``);
it launches :func:`flash_bwd`'s kernel.

Both run bf16 on tensor cores at head dims up to 128 (compiled for 16, 32,
64 and 128, any other D padded inside the loads), bf16 above 128 and f32
on CUDA cores; the C entries choose by D before the launch. Any D >= 1
runs: above 256 the CUDA-core kernels split the head dim into 256-column
output chunks.

:class:`_FlashAttention` pairs them as a ``torch.autograd.Function``, the
counterpart of the JAX module's ``custom_vjp``; :func:`flash_attention` is
the model-layout entry point and :func:`attention_reference` the naive
oracle with the same masking semantics.

Masking: key slot ``s`` is visible to query slot ``t`` iff
``key_mask[b, s] > 0.5`` and (causal) ``s + k_offset <= t + q_offset`` and
(window) ``(t + q_offset) - (s + k_offset) < window``; ALiBi adds
``slope[h] * (k_positions - q_positions)``. K/V are unrepeated (GQA). A row
that sees no key gives out 0 and lse ``NEG_INF``.

Layout: the model's ``[B, T, H, D]`` queries and ``[B, S, KV, D]`` keys
and values throughout (the kernels read it directly; the TPU kernel's
transposed, block-padded layout is not needed); ``lse`` is ``[B, H, T]``.

A wrapper runs its plain version only for CPU tensors; on CUDA tensors it
launches its kernel or raises. ``launches`` on each wrapper counts kernel
launches.
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
    current_stream_ptr,
    kernel_fn,
    note_kernel_flops,
    plain_version,
)

__all__ = [
    "NEG_INF",
    "flash_attention",
    "attention_reference",
    "flash_fwd",
    "flash_fwd_reference",
    "flash_bwd",
    "flash_bwd_reference",
    "flash_attention_bwd_chunk",
]

NEG_INF = -1e30
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _visible(key_mask, T, S, causal, q_offset, k_offset, window):
    """``[B, 1, T, S]`` bool visibility."""
    dev = key_mask.device
    vis = (key_mask > 0.5)[:, None, None, :]
    q_slots = torch.arange(T, device=dev)[:, None] + int(q_offset)
    k_slots = torch.arange(S, device=dev)[None, :] + int(k_offset)
    if causal:
        vis = vis & (k_slots <= q_slots)
    if window:
        vis = vis & (q_slots - k_slots < window)
    return vis


def _scores(q, k, key_mask, q_positions, k_positions, alibi_slopes, sm_scale,
            causal, q_offset, k_offset, window):
    """f32 scores ``[B, H, T, S]`` (ALiBi added) and their visibility.
    GQA K is repeated to the query heads."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    kf = k.float()
    if KV < H:
        kf = torch.repeat_interleave(kf, H // KV, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float() * sm_scale, kf)
    if alibi_slopes is not None:
        dist = (k_positions[:, None, :] - q_positions[:, :, None]).float()
        s = s + alibi_slopes.float()[None, :, None, None] * dist[:, None]
    vis = _visible(key_mask, T, S, causal, q_offset, k_offset, window)
    return s, vis


def _check_flash_operands(q, k, v, key_mask, q_positions, k_positions, alibi_slopes):
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_cuda_operand(x, name, dev, tuple(_DTYPE_CODE))
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    check_cuda_operand(key_mask, "key_mask", dev, (torch.float32,))
    if alibi_slopes is not None:
        check_cuda_operand(alibi_slopes, "alibi_slopes", dev, (torch.float32,))
        check_cuda_operand(q_positions, "q_positions", dev, (torch.int32,))
        check_cuda_operand(k_positions, "k_positions", dev, (torch.int32,))


def _check_shapes(q, k, v):
    B, T, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"q heads {H} not a multiple of kv heads {k.shape[2]}")


def _alibi_ptrs(q_positions, k_positions, alibi_slopes):
    if alibi_slopes is None:
        return None, None, None
    return q_positions.data_ptr(), k_positions.data_ptr(), alibi_slopes.data_ptr()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def flash_fwd(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
    key_mask: torch.Tensor,  # (B, S) f32, 1 = valid key slot
    q_positions: Optional[torch.Tensor],  # (B, T) int32 (ALiBi only)
    k_positions: Optional[torch.Tensor],  # (B, S) int32 (ALiBi only)
    alibi_slopes: Optional[torch.Tensor],  # (H,) f32, or None
    *,
    sm_scale: float,
    causal: bool,
    q_offset: int = 0,
    k_offset: int = 0,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward. Returns ``(out (B, T, H, D) in q.dtype, lse
    (B, H, T) f32)``."""
    _check_shapes(q, k, v)
    note_kernel_flops("flash_fwd", attention_flops(q.shape[0], q.shape[1], k.shape[1],
                                                   q.shape[2], q.shape[3]))
    if q.device.type == "cpu":
        with plain_version():
            return flash_fwd_reference(
                q, k, v, key_mask, q_positions, k_positions, alibi_slopes,
                sm_scale=sm_scale, causal=causal, q_offset=q_offset,
                k_offset=k_offset, window=window,
            )
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu, not {q.device}")
    _check_flash_operands(q, k, v, key_mask, q_positions, k_positions, alibi_slopes)
    B, T, H, D = q.shape
    check_head_dim("flash_fwd", D)
    S, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    qp, kp, sl = _alibi_ptrs(q_positions, k_positions, alibi_slopes)
    fn = kernel_fn("flash_fwd", [_P] * 9 + [_I] * 10 + [_F, _I, _P])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), qp, kp, sl,
            out.data_ptr(), lse.data_ptr(), B, T, S, H, KV, D, int(q_offset),
            int(k_offset), int(bool(causal)), int(window or 0), float(sm_scale),
            _DTYPE_CODE[q.dtype], current_stream_ptr(q.device))
    check_launch("flash_fwd", rc)
    with launch_lock:  # actor threads launch beside the learner
        flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_fwd_reference(q, k, v, key_mask, q_positions, k_positions, alibi_slopes, *,
                        sm_scale, causal, q_offset=0, k_offset=0, window=0):
    """Plain version of :func:`flash_fwd`: :func:`attention_reference` (dense
    f32 scores, ``visible`` applied after the exponential), out cast to
    q's dtype."""
    out, lse = attention_reference(
        q, k, v, key_mask, causal=causal, sm_scale=sm_scale, q_offset=q_offset,
        k_offset=k_offset, q_positions=q_positions, k_positions=k_positions,
        alibi_slopes=alibi_slopes, window=window)
    return out.to(q.dtype), lse


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def flash_bwd(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
    key_mask: torch.Tensor,  # (B, S) f32
    q_positions: Optional[torch.Tensor],
    k_positions: Optional[torch.Tensor],
    alibi_slopes: Optional[torch.Tensor],
    lse: torch.Tensor,  # (B, H, T) f32 from the forward
    delta: torch.Tensor,  # (B, H, T) f32 rowsum(do * out)
    do: torch.Tensor,  # (B, T, H, D) output cotangent
    *,
    sm_scale: float,
    causal: bool,
    q_offset: int = 0,
    k_offset: int = 0,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention backward by recomputation. Returns ``(dq, dk, dv)``: dq in
    q's dtype, dk/dv in k's (GQA partials summed over each group)."""
    _check_shapes(q, k, v)
    note_kernel_flops("flash_bwd", attention_flops(q.shape[0], q.shape[1], k.shape[1],
                                                   q.shape[2], q.shape[3], backward=True))
    if q.device.type == "cpu":
        with plain_version():
            return flash_bwd_reference(
                q, k, v, key_mask, q_positions, k_positions, alibi_slopes, lse, delta, do,
                sm_scale=sm_scale, causal=causal, q_offset=q_offset, k_offset=k_offset,
                window=window,
            )
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd runs on cuda or cpu, not {q.device}")
    _check_flash_operands(q, k, v, key_mask, q_positions, k_positions, alibi_slopes)
    check_cuda_operand(do, "do", q.device, (q.dtype,))
    check_cuda_operand(lse, "lse", q.device, (torch.float32,))
    check_cuda_operand(delta, "delta", q.device, (torch.float32,))
    B, T, H, D = q.shape
    check_head_dim("flash_bwd", D)
    S, KV = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    qp, kp, sl = _alibi_ptrs(q_positions, k_positions, alibi_slopes)
    fn = kernel_fn("flash_bwd", [_P] * 13 + [_I] * 10 + [_F, _I, _P])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), qp, kp, sl,
            lse.data_ptr(), delta.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, T, S, H, KV, D, int(q_offset),
            int(k_offset), int(bool(causal)), int(window or 0), float(sm_scale),
            _DTYPE_CODE[q.dtype], current_stream_ptr(q.device))
    check_launch("flash_bwd", rc)
    with launch_lock:  # actor threads launch beside the learner
        flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0


def flash_bwd_reference(q, k, v, key_mask, q_positions, k_positions, alibi_slopes,
                        lse, delta, do, *, sm_scale, causal, q_offset=0, k_offset=0,
                        window=0):
    """Plain version of :func:`flash_bwd`: the same recomputation
    (``p = exp(s - lse) * visible``, ``ds = p * (dp - delta)``) on dense
    f32 tensors, GQA partials summed over each group."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    g = H // KV
    s, vis = _scores(q, k, key_mask, q_positions, k_positions, alibi_slopes,
                     sm_scale, causal, q_offset, k_offset, window)
    s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse[..., None]) * vis.float()
    dof = do.float()
    vf, kf = v.float(), k.float()
    if g > 1:
        vf = torch.repeat_interleave(vf, g, dim=2)
        kf = torch.repeat_interleave(kf, g, dim=2)
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float() * sm_scale)
    dq = torch.einsum("bhts,bshd->bthd", ds, kf) * sm_scale
    if g > 1:
        dk = dk.reshape(B, S, KV, g, D).sum(dim=3)
        dv = dv.reshape(B, S, KV, g, D).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _as_kernel_operands(q, k, v, key_mask, q_positions, k_positions, alibi_slopes):
    """Contiguous q, k, v, an f32 key mask and, with ALiBi, int32 positions
    and f32 slopes: the operands :func:`flash_fwd` and :func:`flash_bwd`
    take."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    key_mask = key_mask.to(torch.float32).contiguous()
    if alibi_slopes is not None:
        alibi_slopes = alibi_slopes.to(torch.float32).contiguous()
        q_positions = q_positions.to(torch.int32).contiguous()
        k_positions = k_positions.to(torch.int32).contiguous()
    return q, k, v, key_mask, q_positions, k_positions, alibi_slopes


def flash_attention_bwd_chunk(
    q: torch.Tensor,  # (B, T, H, D) local queries
    k: torch.Tensor,  # (B, S, KV, D) visiting key chunk
    v: torch.Tensor,  # (B, S, KV, D)
    key_mask: torch.Tensor,  # (B, S)
    lse: torch.Tensor,  # (B, H, T) GLOBAL logsumexp of the full (ring) softmax
    delta: torch.Tensor,  # (B, H, T) rowsum(do * out_final)
    do: torch.Tensor,  # (B, T, H, D) cotangent of the final output
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    q_offset=0,
    k_offset=0,
    q_positions: Optional[torch.Tensor] = None,  # (B, T) for ALiBi
    k_positions: Optional[torch.Tensor] = None,  # (B, S) for ALiBi
    alibi_slopes: Optional[torch.Tensor] = None,  # (H,)
    window: Optional[int] = None,  # sliding-window width (None = unbounded)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One (q-chunk x kv-chunk) term of the flash backward, in model layout
    (the JAX ``flash_attention_bwd_chunk``).

    With the *global* ``lse`` / ``delta``, the terms summed over every kv
    chunk of a ring sweep are the monolithic backward. One launch of
    :func:`flash_bwd`'s kernel gives all three gradients, dq in q's dtype
    and dk / dv in k's. A pair wholly in the causal future (or outside the
    window) gives exact zeros: every key tile's block stores its
    accumulators, which start at zero, whether or not a query sees it. A
    row whose global ``lse`` is ``NEG_INF`` sees no key anywhere, so
    ``exp(s - lse)`` is never formed for it. The kernel masks rows and
    columns past T and S itself, so nothing is padded (JAX pads query
    rows with a ``+1e30`` lse sentinel).

    ``launches`` counts the launches made through this entry; they are
    :func:`flash_bwd`'s launches too."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[3])
    q, k, v, key_mask, q_positions, k_positions, alibi_slopes = _as_kernel_operands(
        q, k, v, key_mask, q_positions, k_positions, alibi_slopes)
    grads = flash_bwd(q, k, v, key_mask, q_positions, k_positions, alibi_slopes,
                      lse.to(torch.float32).contiguous(), delta.to(torch.float32).contiguous(),
                      do.to(q.dtype).contiguous(), sm_scale=float(sm_scale),
                      causal=bool(causal), q_offset=int(q_offset), k_offset=int(k_offset),
                      window=int(window or 0))
    if q.device.type == "cuda":
        with launch_lock:
            flash_attention_bwd_chunk.launches += 1
    return grads


flash_attention_bwd_chunk.launches = 0


# ---------------------------------------------------------------------------
# autograd pairing and the model-layout entry point
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Forward kernel #5 paired with backward kernel #6 (the JAX
    ``custom_vjp``). Gradients flow to q, k and v only."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, q_positions, k_positions, alibi_slopes, opts):
        out, lse = flash_fwd(q, k, v, key_mask, q_positions, k_positions,
                             alibi_slopes, **opts)
        ctx.save_for_backward(q, k, v, key_mask, q_positions, k_positions,
                              alibi_slopes, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, q_positions, k_positions, alibi_slopes, out, lse = (
            ctx.saved_tensors
        )
        do = do.contiguous()
        # delta stays a plain reduction outside the kernel, as in JAX
        delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
        dq, dk, dv = flash_bwd(q, k, v, key_mask, q_positions, k_positions,
                               alibi_slopes, lse, delta, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
    key_mask: torch.Tensor,  # (B, S) 1 = valid slot
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    q_offset=0,
    k_offset=0,
    q_positions: Optional[torch.Tensor] = None,  # (B, T) for ALiBi
    k_positions: Optional[torch.Tensor] = None,  # (B, S) for ALiBi
    alibi_slopes: Optional[torch.Tensor] = None,  # (H,)
    return_lse: bool = False,
    window: Optional[int] = None,  # sliding-window width (None = unbounded)
):
    """Flash attention over model-layout tensors, differentiable in q, k
    and v. With ``return_lse`` it returns ``(out, lse (B, H, T))`` and is
    forward-only, as in the JAX package."""
    B, T, H, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    q, k, v, key_mask, q_positions, k_positions, alibi_slopes = _as_kernel_operands(
        q, k, v, key_mask, q_positions, k_positions, alibi_slopes)
    opts = dict(sm_scale=float(sm_scale), causal=bool(causal), q_offset=int(q_offset),
                k_offset=int(k_offset), window=int(window or 0))
    if return_lse:
        return flash_fwd(q, k, v, key_mask, q_positions, k_positions, alibi_slopes, **opts)
    return _FlashAttention.apply(q, k, v, key_mask, q_positions, k_positions,
                                 alibi_slopes, opts)


def attention_reference(
    q, k, v, key_mask, *, causal=True, sm_scale=None, q_offset=0, k_offset=0,
    q_positions=None, k_positions=None, alibi_slopes=None, window=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive attention with the same masking semantics (test oracle,
    differentiable by autograd). Returns ``(out f32 (B, T, H, D), lse)``."""
    B, T, H, D = q.shape
    KV = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    s, vis = _scores(q, k, key_mask, q_positions, k_positions, alibi_slopes,
                     sm_scale, causal, q_offset, k_offset, int(window or 0))
    s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m) * vis.float()
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    vf = v.float()
    if KV < H:
        vf = torch.repeat_interleave(vf, H // KV, dim=2)
    out = torch.einsum("bhts,bshd->bthd", p / safe_l, vf)
    lse = torch.where(l > 0, m + torch.log(safe_l), torch.full_like(l, NEG_INF))[..., 0]
    return out, lse
