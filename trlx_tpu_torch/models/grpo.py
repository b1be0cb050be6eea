"""GRPO method: group-relative advantages and the clipped objective with an
in-loss KL penalty, no value head.

Port of ``trlx_tpu/models/grpo.py``: :data:`BASELINES`,
:func:`group_advantages_np` (a numpy copy) and :class:`GRPOConfig`, which
subclasses the port's :class:`~trlx_tpu_torch.models.ppo.PPOConfig`, so the
PPO trainer's rollout machinery serves
:class:`~trlx_tpu_torch.trainer.grpo.GRPOTrainer`.

The loss keeps the JAX op sequence and gradient conventions of the port's
PPO loss (a clip is ``minimum(maximum(x, lo), hi)``; ``torch.maximum``
splits its gradient at a tie as ``jnp.maximum`` does), so autograd through
it equals ``jax.grad`` through the JAX one.
"""

from dataclasses import dataclass
from typing import Any, ClassVar, Dict, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.data.method_configs import register_method
from trlx_tpu_torch.models.ppo import PPOConfig, _clip, iw_weights
from trlx_tpu_torch.utils import flatten_dict
from trlx_tpu_torch.observability.dynamics import loss_sketches
from trlx_tpu_torch.utils.stats import get_tensor_stats

__all__ = ["BASELINES", "GRPOConfig", "group_advantages_np"]

BASELINES = ("group", "rloo")


def group_advantages_np(
    scores: np.ndarray,
    group_size: int,
    scale: bool = True,
    eps: float = 1e-6,
    baseline: str = "group",
) -> np.ndarray:
    """Per-sequence advantages from group-contiguous rewards ``scores``
    [B]: each reward minus its group's mean, over the group's std plus
    ``eps`` with ``scale`` (``scale=False`` is the Dr. GRPO variant); with
    ``baseline="rloo"`` minus the mean of the other members (REINFORCE
    leave-one-out, unscaled; ``group_size >= 2``)."""
    if scores.shape[0] % group_size:
        raise ValueError(f"batch {scores.shape[0]} not divisible by group_size {group_size}")
    g = scores.reshape(-1, group_size)
    if baseline == "rloo":
        if group_size < 2:
            raise ValueError("rloo baseline needs group_size >= 2")
        loo_mean = (g.sum(axis=1, keepdims=True) - g) / (group_size - 1)
        return (g - loo_mean).reshape(-1).astype(np.float32)
    if baseline != "group":
        raise ValueError(f"unknown baseline '{baseline}'; known: {BASELINES}")
    adv = g - g.mean(axis=1, keepdims=True)
    if scale:
        adv = adv / (g.std(axis=1, keepdims=True) + eps)
    return adv.reshape(-1).astype(np.float32)


@dataclass
@register_method("GRPOConfig")
class GRPOConfig(PPOConfig):
    """GRPO hyperparameters (the JAX package's fields and defaults): PPO's
    sampling and rollout knobs, whose value-function fields go unused, and

    :param group_size: responses sampled per prompt; ``chunk_size`` must be
        a multiple of it.
    :param beta: coefficient of the in-loss k3 KL against the frozen
        reference.
    :param scale_advantage: divide group-centred rewards by the group std.
    :param baseline: ``"group"`` (the group mean) or ``"rloo"``
        (leave-one-out mean, no std scaling).
    """

    #: no GAE and no value head: the fused loss kernels have nothing to fuse
    LOSS_KERNELS: ClassVar[Tuple[str, ...]] = ("xla",)

    name: str = "GRPOConfig"
    group_size: int = 8
    beta: float = 0.04
    scale_advantage: bool = True
    baseline: str = "group"

    def loss(
        self,
        logprobs: torch.Tensor,  # [B, R] current policy logprobs of response tokens
        old_logprobs: torch.Tensor,  # [B, R] logprobs at collection time
        ref_logprobs: torch.Tensor,  # [B, R] frozen-reference logprobs
        advantages: torch.Tensor,  # [B] per-sequence group-relative advantages
        mask: torch.Tensor,  # [B, R] response mask
        behavior_logprobs: Optional[torch.Tensor] = None,  # [B, R] sampler logprobs
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Clipped ratio × sequence advantage plus ``beta`` × the k3 KL
        against the reference, token means over the mask; with
        ``behavior_logprobs`` (and ``iw_correction`` on) the truncated
        importance weight scales the policy term."""
        mask = mask.float()
        n = torch.clamp(mask.sum(), min=1.0)
        adv = advantages.float()[:, None]

        log_ratio = (logprobs - old_logprobs) * mask
        ratio = torch.exp(log_ratio)
        pg_loss1 = -adv * ratio
        pg_loss2 = -adv * _clip(ratio, 1.0 - self.cliprange, 1.0 + self.cliprange)
        iw_stats = {}
        if behavior_logprobs is not None and self.iw_correction != "off":
            rho, iw_stats = iw_weights(old_logprobs, behavior_logprobs, mask, self.iw_clip, n)
            pg_loss1 = pg_loss1 * rho
            pg_loss2 = pg_loss2 * rho
        pg_loss = torch.sum(torch.maximum(pg_loss1, pg_loss2) * mask) / n

        # k3 KL against the frozen reference: exp(δ) − δ − 1, δ = ref − current
        delta = (ref_logprobs - logprobs) * mask
        kl = torch.sum((torch.exp(delta) - delta - 1.0) * mask) / n
        loss = pg_loss + self.beta * kl

        d = lambda x: x.detach()  # noqa: E731 — stats carry no gradient
        approx_kl_old = d(0.5 * torch.sum(log_ratio**2) / n)
        clipfrac = torch.sum((pg_loss2 > pg_loss1).float() * mask) / n
        dist = {}
        if self.dist_sketches:
            dist = loss_sketches({
                "log_ratio": (log_ratio, mask),
                "ref_kl": (torch.exp(delta) - delta - 1.0, mask),
                "advantages": (advantages, None),
            })
        stats = dict(
            **iw_stats,
            **dist,
            losses=dict(total_loss=d(loss), policy_loss=d(pg_loss), kl_loss=d(kl)),
            ratio={k: d(v) for k, v in get_tensor_stats(ratio, mask, n).items()},
            advantages_mean=torch.mean(adv),
            policy=dict(approx_kl=approx_kl_old, clipfrac=clipfrac, ref_kl=d(kl)),
            padding_percentage=1.0 - n / mask.numel(),
        )
        return loss, flatten_dict(stats)
