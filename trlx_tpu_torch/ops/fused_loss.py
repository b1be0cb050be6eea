"""Fused PPO learner loss: GAE + whitening + clipped loss + stats + sketches.

Port of ``trlx_tpu/ops/fused_loss.py``. Two CUDA kernels written for
Hopper, each with a plain PyTorch version beside it:

- :func:`fused_loss_fwd` (``csrc/fused_loss_fwd.cu``): the reversed GAE,
  masked whitening, the clipped policy and value losses, every scalar stat
  of ``PPOConfig.loss`` and the four ``dist/*`` sketches, in one launch,
  leaving the backward's residuals packed in one tensor (raw advantages
  and returns, whitening mean and inverse std, the mask count;
  :func:`residual_views`);
- :func:`fused_loss_bwd` (``csrc/fused_loss_bwd.cu``): the loss's gradient
  with respect to ``logprobs`` and ``values`` from those residuals, one
  elementwise pass, derived by hand with JAX's tie rules.

:class:`_FusedLoss` pairs them as a ``torch.autograd.Function`` (the JAX
``custom_vjp``): gradients flow to ``logprobs`` and ``values`` only — the
other operands are batch constants in the trainer, and advantages and
returns are detached in the staged path too, so this is exact. The JAX
kernel's backward recomputes GAE and the moments under ``jax.vjp``; the
port keeps the forward's residuals instead.

The plain versions keep the JAX design of calling the port's own
``PPOConfig`` methods (:func:`_loss_core`: ``get_advantages_and_returns``
then ``loss``; the backward ``loss`` alone on the residuals) instead of a
transcription of them. Stats are packed in the
order the JAX package discovers its keys: sorted scalar keys, then sorted
histogram keys (:func:`stat_keys`).

Operands are f32 (the trainer's store is f32); other dtypes raise.
"""

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from trlx_tpu_torch.observability.dynamics import SKETCH_BINS
from trlx_tpu_torch.ops.kernel_utils import (
    check_cuda_operand,
    check_launch,
    current_stream_ptr,
    kernel_fn,
    note_kernel_flops,
    plain_version,
)
from trlx_tpu_torch.utils.stats import masked_mean, masked_var

__all__ = [
    "LossParams",
    "residual_views",
    "loss_params_of",
    "stat_keys",
    "fused_ppo_loss",
    "fused_ppo_loss_reference",
    "fused_loss_fwd",
    "fused_loss_fwd_reference",
    "fused_loss_bwd",
    "fused_loss_bwd_reference",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# the kernel's scalar slots: every scalar stat of PPOConfig.loss with the
# IW correction, in sorted key order (the IW pair sorts first)
_IW_KEYS = ("iw/rho_clipfrac", "iw/rho_mean")
_SCALAR_KEYS = _IW_KEYS + (
    "losses/policy_loss", "losses/total_loss", "losses/value_loss",
    "old_values/max", "old_values/mean", "old_values/min", "old_values/std",
    "padding_percentage",
    "policy/approx_kl", "policy/clipfrac",
    "ratio",
    "returns/max", "returns/mean", "returns/min", "returns/std",
    "values/clipfrac", "values/max", "values/mean", "values/min", "values/std",
    "values/values_error",
)
_HIST_KEYS = (
    "dist/advantages_hist", "dist/kl_hist", "dist/log_ratio_hist",
    "dist/value_error_hist",
)


class LossParams(NamedTuple):
    """The subset of ``PPOConfig`` the fused loss reads."""

    gamma: float
    lam: float
    cliprange: float
    cliprange_value: float
    vf_coef: float
    iw_correction: str
    iw_clip: float
    dist_sketches: bool


def loss_params_of(method) -> LossParams:
    """Extract :class:`LossParams` from a ``PPOConfig``-shaped method."""
    return LossParams(
        gamma=float(method.gamma),
        lam=float(method.lam),
        cliprange=float(method.cliprange),
        cliprange_value=float(method.cliprange_value),
        vf_coef=float(method.vf_coef),
        iw_correction=str(method.iw_correction),
        iw_clip=float(method.iw_clip),
        dist_sketches=bool(method.dist_sketches),
    )


def stat_keys(p: LossParams, use_iw: bool) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """``(scalar_keys, hist_keys)`` in packing order."""
    scalars = _SCALAR_KEYS if use_iw else _SCALAR_KEYS[len(_IW_KEYS):]
    return scalars, (_HIST_KEYS if p.dist_sketches else ())


@functools.lru_cache(maxsize=None)
def _method_of(p: LossParams):
    """A fresh ``PPOConfig`` carrying ``p``: the plain versions call the
    genuine method implementations, never a transcription of them."""
    from trlx_tpu_torch.models.ppo import PPOConfig  # late: models import this module

    return PPOConfig(
        gamma=p.gamma, lam=p.lam, cliprange=p.cliprange,
        cliprange_value=p.cliprange_value, vf_coef=p.vf_coef,
        iw_correction=p.iw_correction, iw_clip=p.iw_clip,
        dist_sketches=p.dist_sketches,
    )


def _loss_core(p: LossParams, logprobs, values, old_logprobs, old_values, rewards,
               mask, behavior_logprobs=None):
    """The staged chain: GAE → whiten → clipped loss + stats."""
    m = _method_of(p)
    advantages, returns = m.get_advantages_and_returns(old_values, rewards, mask)
    return m.loss(
        logprobs=logprobs, values=values, old_logprobs=old_logprobs,
        old_values=old_values, advantages=advantages, returns=returns, mask=mask,
        behavior_logprobs=behavior_logprobs,
    )


def _check_operands(operands):
    B, R = operands[0].shape
    for i, x in enumerate(operands):
        if x.dtype != torch.float32:
            raise ValueError(f"fused loss operand {i} has dtype {x.dtype}; expected float32")
        if tuple(x.shape) != (B, R):
            raise ValueError(f"fused loss operand {i} has shape {tuple(x.shape)} != {(B, R)}")


def _cuda_operands(what: str, operands, device: torch.device):
    """The operands as contiguous tensors on ``device`` (a copy only for
    one that is not contiguous); raises for another device."""
    if device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {device}")
    ops = [x if x.is_contiguous() else x.contiguous() for x in operands]
    for i, x in enumerate(ops):
        if x.device != device:
            raise ValueError(f"fused loss operand {i} is on {x.device}, expected {device}")
    return ops


def _scalar_args(p: LossParams):
    return (float(p.gamma), float(p.gamma * p.lam), float(1.0 - p.cliprange),
            float(1.0 + p.cliprange), float(p.cliprange_value), float(p.vf_coef),
            float(p.iw_clip))


# ctypes signatures of the two C entries
_FWD_ARGS = [_P] * 8 + [_I, _I] + [_F] * 7 + [_I, _P]
_BWD_ARGS = [_P] * 9 + [_I, _I] + [_F] * 5 + [_P]
# the residual moments: whitening mean, 1 / sqrt(var + 1e-8), n
_N_MOMENTS = 3
# the forward's buffer after the residuals: loss, scalar slots, sketches
_TAIL = 1 + len(_SCALAR_KEYS) + len(_HIST_KEYS) * SKETCH_BINS


# FLOP formulas of the two kernels (elementwise arithmetic per (row, token)
# of the plain version): the forward's GAE step (6), whitening (6), clipped
# policy term (8), clipped value term (9), stats (11) and five sketches (3
# each, 15); the backward's whitening and both clipped terms' derivatives
LOSS_FWD_FLOPS_PER_TOKEN = 55
LOSS_BWD_FLOPS_PER_TOKEN = 14


def residual_views(res: torch.Tensor, B: int, R: int):
    """``(advantages, returns, moments)`` of packed residuals: the raw
    (unwhitened) advantages and the returns, (B, R), and the moments
    (whitening mean, 1 / sqrt(var + 1e-8), n = max(sum(mask), 1))."""
    n = B * R
    return res[:n].view(B, R), res[n:2 * n].view(B, R), res[2 * n:]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def fused_loss_fwd(p: LossParams, operands: Tuple[torch.Tensor, ...]):
    """Loss, packed scalar stats and sketches of the 6 operands ``(logprobs,
    values, old_logprobs, old_values, rewards, mask)``, plus
    ``behavior_logprobs`` as a 7th with the IW correction. Returns ``(loss
    [], scalars [NS], hists [NH, 32], res [2 B R + 3])`` in
    :func:`stat_keys` order; ``res`` packs the residuals
    :func:`fused_loss_bwd` takes (:func:`residual_views`)."""
    _check_operands(operands)
    note_kernel_flops("fused_loss_fwd", LOSS_FWD_FLOPS_PER_TOKEN * operands[0].numel())
    device = operands[0].device
    if device.type == "cpu":
        with plain_version():
            return fused_loss_fwd_reference(p, operands)
    ops = _cuda_operands("fused_loss_fwd", operands, device)
    B, R = ops[0].shape
    use_iw = len(ops) == 7
    o = 2 * B * R + _N_MOMENTS  # residuals, then loss, scalars, sketches
    buf = torch.empty(o + _TAIL, dtype=torch.float32, device=device)
    rc = kernel_fn("fused_loss_fwd", _FWD_ARGS)(
        *(x.data_ptr() for x in ops[:6]), ops[6].data_ptr() if use_iw else None,
        buf.data_ptr(), B, R, *_scalar_args(p), int(p.dist_sketches),
        current_stream_ptr(device))
    check_launch("fused_loss_fwd", rc)
    fused_loss_fwd.launches += 1
    ns = len(_SCALAR_KEYS)
    scalars = buf[o + 1 + (0 if use_iw else len(_IW_KEYS)): o + 1 + ns]
    nh = len(_HIST_KEYS) if p.dist_sketches else 0
    hists = buf.as_strided((nh, SKETCH_BINS), (SKETCH_BINS, 1), o + 1 + ns)
    return buf[o], scalars, hists, buf[:o]


fused_loss_fwd.launches = 0


def fused_loss_fwd_reference(p: LossParams, operands):
    """Plain version of :func:`fused_loss_fwd`: :func:`_loss_core`, packed,
    with the residuals from the port's own GAE and whitening pieces."""
    use_iw = len(operands) == 7
    with torch.no_grad():
        loss, stats = _loss_core(p, *operands[:6], operands[6] if use_iw else None)
        ov, rw, mask = operands[3:6]
        adv, ret = _method_of(p).get_advantages_and_returns(ov, rw, mask, use_whitening=False)
        var = masked_var(adv, mask, ddof=1)
        moments = torch.stack([masked_mean(adv, mask), torch.rsqrt(var + 1e-8),
                               torch.clamp(mask.sum(), min=1.0)])
        res = torch.cat([adv.reshape(-1), ret.reshape(-1), moments]).float()
    scalar_keys, hist_keys = stat_keys(p, use_iw)
    scalars = torch.stack([stats[k].float() for k in scalar_keys])
    hists = (torch.stack([stats[k].float() for k in hist_keys]) if hist_keys
             else torch.zeros((0, SKETCH_BINS), dtype=torch.float32, device=loss.device))
    return loss.float(), scalars, hists, res


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def fused_loss_bwd(p: LossParams, operands: Tuple[torch.Tensor, ...], res: torch.Tensor,
                   g_loss: torch.Tensor):
    """Gradient of the loss w.r.t. ``logprobs`` and ``values`` given the
    forward's packed residuals ``res`` and the loss cotangent ``g_loss``
    (one f32). Returns ``(dlogprobs, dvalues)``, (B, R) f32."""
    _check_operands(operands)
    note_kernel_flops("fused_loss_bwd", LOSS_BWD_FLOPS_PER_TOKEN * operands[0].numel())
    device = operands[0].device
    if device.type == "cpu":
        with plain_version():
            return fused_loss_bwd_reference(p, operands, res, g_loss)
    B, R = operands[0].shape
    ops = _cuda_operands("fused_loss_bwd", operands, device)
    check_cuda_operand(res, "residuals", device, (torch.float32,))
    if res.numel() != 2 * B * R + _N_MOMENTS:
        raise ValueError(f"fused loss residuals hold {res.numel()} values, not "
                         f"{2 * B * R + _N_MOMENTS}")
    if g_loss.dtype != torch.float32 or g_loss.device != device:
        g_loss = g_loss.to(device=device, dtype=torch.float32)
    if g_loss.numel() != 1:
        raise ValueError(f"g_loss must hold one value, not {g_loss.numel()}")
    use_iw = len(ops) == 7
    out = torch.empty((2, B, R), dtype=torch.float32, device=device)
    rc = kernel_fn("fused_loss_bwd", _BWD_ARGS)(
        *(x.data_ptr() for x in ops[:4]), ops[5].data_ptr(),
        ops[6].data_ptr() if use_iw else None, res.data_ptr(), g_loss.data_ptr(),
        out.data_ptr(), B, R, *_scalar_args(p)[2:], current_stream_ptr(device))
    check_launch("fused_loss_bwd", rc)
    fused_loss_bwd.launches += 1
    return out.unbind(0)


fused_loss_bwd.launches = 0


def fused_loss_bwd_reference(p: LossParams, operands, res: torch.Tensor, g_loss):
    """Plain version of :func:`fused_loss_bwd`: autograd through
    ``PPOConfig.loss`` w.r.t. the first two operands, the advantages
    whitened from the residuals as ``whiten`` does."""
    use_iw = len(operands) == 7
    lp, v, olp, ov, _, mask = (x.detach() for x in operands[:6])
    adv, ret, moments = residual_views(res, *lp.shape)
    white = (adv - moments[0]) * moments[1]
    with torch.enable_grad():
        lp, v = lp.requires_grad_(True), v.requires_grad_(True)
        loss, _ = _method_of(p).loss(
            logprobs=lp, values=v, old_logprobs=olp, old_values=ov, advantages=white,
            returns=ret, mask=mask, behavior_logprobs=operands[6].detach() if use_iw else None)
        dlp, dv = torch.autograd.grad(loss, (lp, v), grad_outputs=g_loss.to(loss.dtype))
    return dlp, dv


# ---------------------------------------------------------------------------
# autograd pairing and the entry points
# ---------------------------------------------------------------------------


class _FusedLoss(torch.autograd.Function):
    """Forward kernel #7 paired with backward kernel #8 through the
    forward's residuals."""

    @staticmethod
    def forward(ctx, p, *operands):
        loss, scalars, hists, res = fused_loss_fwd(p, operands)
        ctx.p = p
        ctx.save_for_backward(*operands, res)
        ctx.mark_non_differentiable(scalars, hists)
        return loss, scalars, hists

    @staticmethod
    def backward(ctx, g_loss, g_scalars, g_hists):
        *operands, res = ctx.saved_tensors
        dlp, dv = fused_loss_bwd(ctx.p, operands, res, g_loss)
        return (None, dlp, dv) + (None,) * (len(operands) - 2)


def fused_ppo_loss_reference(method, logprobs, values, old_logprobs, old_values,
                             rewards, mask, behavior_logprobs=None):
    """The staged composition — GAE → whiten → loss — exactly as the JAX
    package's ``loss_kernel: xla`` path runs it (test reference)."""
    return _loss_core(loss_params_of(method), logprobs, values, old_logprobs,
                      old_values, rewards, mask, behavior_logprobs)


def fused_ppo_loss(
    method,
    logprobs: torch.Tensor,  # [B, R] new per-token logprobs
    values: torch.Tensor,  # [B, R] new value predictions
    old_logprobs: torch.Tensor,  # [B, R] scoring-forward logprobs
    old_values: torch.Tensor,  # [B, R] rollout values (GAE input + clip anchor)
    rewards: torch.Tensor,  # [B, R] per-token KL-penalty rewards
    mask: torch.Tensor,  # [B, R] 1.0 on real response tokens
    behavior_logprobs: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, dict]:
    """GAE + whitening + clipped PPO loss through the fused kernels.
    Returns ``(loss, stats)``; stats are detached, and gradients flow
    through ``loss`` to ``logprobs`` and ``values`` only."""
    p = loss_params_of(method)
    use_iw = behavior_logprobs is not None and p.iw_correction != "off"
    operands = (logprobs, values, old_logprobs, old_values, rewards, mask)
    if use_iw:
        operands = operands + (behavior_logprobs,)
    loss, scalars, hists = _FusedLoss.apply(p, *operands)
    scalar_keys, hist_keys = stat_keys(p, use_iw)
    stats = {k: scalars[i] for i, k in enumerate(scalar_keys)}
    stats.update({k: hists[i] for i, k in enumerate(hist_keys)})
    return loss, stats
