"""PPO method: KL controllers, GAE, and the clipped PPO objective.

Port of ``trlx_tpu/models/ppo.py``: :class:`AdaptiveKLController`,
:class:`FixedKLController`, :class:`PPOConfig` (every field) with
:meth:`PPOConfig.get_advantages_and_returns`, :meth:`PPOConfig.loss` and
:meth:`PPOConfig.loss_fused`, :func:`iw_weights` and
:func:`kl_penalty_rewards_np`.

The loss keeps the JAX op sequence and JAX's gradient conventions: a clip
is ``minimum(maximum(x, lo), hi)`` and the maxima are ``torch.maximum``,
whose gradient splits evenly at a tie as ``jnp.maximum``'s does (ties are
exact wherever the ratio is inside the clip range and at masked
positions), so autograd through this plain loss equals ``jax.grad``
through the JAX one. Advantages and returns are detached (the JAX
``stop_gradient``).
"""

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.data.method_configs import MethodConfig, register_method
from trlx_tpu_torch.utils import flatten_dict
from trlx_tpu_torch.observability.dynamics import loss_sketches
from trlx_tpu_torch.utils.stats import get_tensor_stats, whiten

__all__ = [
    "AdaptiveKLController",
    "FixedKLController",
    "PPOConfig",
    "iw_weights",
    "kl_penalty_rewards_np",
]


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip`` with its gradient: ``minimum(maximum(x, lo), hi)``."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


class AdaptiveKLController:
    """Adaptive KL coefficient (Ziegler et al. 1909.08593 §2.2): β is
    multiplied by ``1 + clip(KL/target - 1, ±0.2) · n/horizon`` after each
    round of rollouts. A non-finite KL is skipped (counted in
    :attr:`skipped`), never folded in."""

    def __init__(self, init_kl_coef: float, target: float, horizon: int):
        self.value = float(init_kl_coef)
        self.target = target
        self.horizon = horizon
        self.skipped = 0

    def update(self, current_kl: float, n_steps: int) -> None:
        if not np.isfinite(current_kl):
            self.skipped += 1
            return
        proportional_error = float(np.clip(current_kl / self.target - 1, -0.2, 0.2))
        self.value *= 1 + proportional_error * n_steps / self.horizon


class FixedKLController:
    """Constant KL coefficient."""

    def __init__(self, kl_coef: float):
        self.value = float(kl_coef)

    def update(self, current_kl: float, n_steps: int) -> None:
        pass


@dataclass
@register_method("PPOConfig")
class PPOConfig(MethodConfig):
    """Hyperparameters of PPO (the JAX package's fields and defaults; see
    ``trlx_tpu/models/ppo.py`` for each one's meaning). ``loss_kernel``
    selects the staged loss (``xla``, the default: :meth:`get_advantages_and_returns`
    then :meth:`loss`, in plain ops) or the fused loss kernels
    (``pallas``: :meth:`loss_fused`, the CUDA kernels of
    ``ops/fused_loss.py``)."""

    name: str = "PPOConfig"
    ppo_epochs: int = 4
    num_rollouts: int = 128
    chunk_size: int = 128
    init_kl_coef: float = 0.05
    target: Optional[float] = 6.0
    horizon: int = 10000
    gamma: float = 1.0
    lam: float = 0.95
    cliprange: float = 0.2
    cliprange_value: float = 0.2
    vf_coef: float = 1.0
    scale_reward: Optional[str] = None
    ref_mean: Optional[float] = None
    ref_std: Optional[float] = None
    cliprange_reward: float = 10.0
    iw_correction: str = "off"
    iw_clip: float = 2.0
    loss_kernel: str = "xla"
    gen_kwargs: Dict[str, Any] = field(default_factory=dict)
    gen_experience_kwargs: Optional[Dict[str, Any]] = None

    def kl_controller(self):
        if self.target is None:
            return FixedKLController(self.init_kl_coef)
        return AdaptiveKLController(self.init_kl_coef, self.target, self.horizon)

    def get_advantages_and_returns(
        self,
        values: torch.Tensor,  # [B, R]
        rewards: torch.Tensor,  # [B, R]
        mask: Optional[torch.Tensor] = None,  # [B, R] response mask
        use_whitening: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """GAE advantages and returns over the response window, by the
        reversed recurrence δ_t = r_t + γ V_{t+1} − V_t,
        A_t = δ_t + γλ A_{t+1}; both are detached (regression targets)."""
        values = values.detach().float()
        rewards = rewards.detach().float()
        next_values = torch.cat([values[:, 1:], torch.zeros_like(values[:, :1])], dim=1)
        deltas = rewards + self.gamma * next_values - values
        gl = self.gamma * self.lam
        lastgaelam = torch.zeros(values.shape[0], dtype=torch.float32, device=values.device)
        adv_rev = []
        for t in range(values.shape[1] - 1, -1, -1):
            lastgaelam = deltas[:, t] + gl * lastgaelam
            adv_rev.append(lastgaelam)
        advantages = torch.stack(adv_rev[::-1], dim=1)
        returns = advantages + values
        if use_whitening:
            advantages = whiten(advantages, mask)
        return advantages.detach(), returns.detach()

    def loss(
        self,
        logprobs: torch.Tensor,  # [B, R] new per-token logprobs
        values: torch.Tensor,  # [B, R] new value predictions
        old_logprobs: torch.Tensor,  # [B, R] behavior-policy logprobs
        old_values: torch.Tensor,  # [B, R]
        advantages: torch.Tensor,  # [B, R]
        returns: torch.Tensor,  # [B, R]
        mask: torch.Tensor,  # [B, R] 1 on real response tokens
        behavior_logprobs: Optional[torch.Tensor] = None,  # [B, R] sampler logprobs
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Clipped-ratio policy loss + clipped value loss; masked sums / n."""
        mask = mask.float()
        logprobs = logprobs.float()
        values = values.float()
        n = torch.clamp(mask.sum(), min=1.0)

        values_clipped = _clip(
            values, old_values - self.cliprange_value, old_values + self.cliprange_value
        )
        vf_loss1 = torch.square(values - returns)
        vf_loss2 = torch.square(values_clipped - returns)
        vf_loss = 0.5 * torch.sum(torch.maximum(vf_loss1, vf_loss2) * mask) / n
        vf_clipfrac = torch.sum((vf_loss2 > vf_loss1).float() * mask) / n

        log_ratio = (logprobs - old_logprobs) * mask
        ratio = torch.exp(log_ratio)
        # k3 KL estimator (Schulman): E[(r - 1) - log r], unmasked mean
        approx_kl = torch.mean((ratio - 1) - log_ratio).detach()

        pg_loss1 = -advantages * ratio
        pg_loss2 = -advantages * _clip(ratio, 1.0 - self.cliprange, 1.0 + self.cliprange)
        iw_stats = {}
        if behavior_logprobs is not None and self.iw_correction != "off":
            rho, iw_stats = iw_weights(old_logprobs, behavior_logprobs, mask, self.iw_clip, n)
            pg_loss1 = pg_loss1 * rho
            pg_loss2 = pg_loss2 * rho
        pg_loss = torch.sum(torch.maximum(pg_loss1, pg_loss2) * mask) / n
        pg_clipfrac = torch.sum((pg_loss2 > pg_loss1).float() * mask) / n

        loss = pg_loss + self.vf_coef * vf_loss

        dist = {}
        if self.dist_sketches:
            dist = loss_sketches(
                {
                    "log_ratio": (log_ratio, mask),
                    "kl": ((ratio - 1) - log_ratio, mask),
                    "advantages": (advantages, mask),
                    "value_error": (values - returns, mask),
                }
            )

        d = lambda x: x.detach()  # noqa: E731 — stats carry no gradient
        stats = dict(
            **iw_stats,
            **dist,
            losses=dict(total_loss=d(loss), policy_loss=d(pg_loss), value_loss=d(vf_loss)),
            values=dict(
                {k: d(v) for k, v in get_tensor_stats(values, mask, n).items()},
                values_error=d(torch.sum(torch.square((values - returns) * mask)) / n),
                clipfrac=vf_clipfrac,
            ),
            old_values=get_tensor_stats(old_values, mask, n),
            returns=get_tensor_stats(returns, mask, n),
            policy=dict(approx_kl=approx_kl, clipfrac=pg_clipfrac),
            ratio=d(torch.sum(ratio * mask) / n),
            padding_percentage=1.0 - n / mask.numel(),
        )
        return loss, flatten_dict(stats)

    def loss_fused(
        self,
        logprobs: torch.Tensor,
        values: torch.Tensor,
        old_logprobs: torch.Tensor,
        old_values: torch.Tensor,
        rewards: torch.Tensor,
        mask: torch.Tensor,
        behavior_logprobs: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The ``loss_kernel: pallas`` program: GAE + whitening +
        :meth:`loss` as the fused loss kernels (``ops/fused_loss.py``).
        Takes raw ``rewards``; callers skip
        :meth:`get_advantages_and_returns`."""
        from trlx_tpu_torch.ops.fused_loss import fused_ppo_loss

        return fused_ppo_loss(
            self, logprobs, values, old_logprobs, old_values, rewards, mask,
            behavior_logprobs,
        )


def iw_weights(
    old_logprobs: torch.Tensor,
    behavior_logprobs: torch.Tensor,
    mask: torch.Tensor,
    clip: float,
    n: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Truncated per-token importance weights ``min(exp(old − behavior),
    clip)`` (detached), with their diagnostics."""
    log_rho = (old_logprobs.float() - behavior_logprobs.float()) * mask
    raw = torch.exp(log_rho)
    rho = torch.minimum(raw, torch.as_tensor(clip, dtype=raw.dtype, device=raw.device)).detach()
    stats = {
        "iw": dict(
            rho_mean=torch.sum(rho * mask) / n,
            rho_clipfrac=torch.sum((raw > clip).float() * mask) / n,
        )
    }
    return rho, stats


def kl_penalty_rewards_np(logprobs, ref_logprobs, response_mask, scores, kl_coef):
    """Per-token rewards −β·(logπ − logπ_ref) with the scalar task score
    added at each row's last response token, on host numpy arrays.
    Returns ``(rewards [B, R], (mean_kl, mean_kl_per_sequence))``; the
    per-token k3 mean over the whole block feeds the KL controller."""
    mask = np.asarray(response_mask, np.float32)
    log_ratio = (np.asarray(logprobs) - np.asarray(ref_logprobs)) * mask
    rewards = -float(kl_coef) * log_ratio
    ends = np.maximum(mask.sum(axis=1).astype(np.int32) - 1, 0)
    rewards[np.arange(rewards.shape[0]), ends] += np.asarray(scores, np.float32)
    k3 = (np.exp(log_ratio) - 1) - log_ratio
    mean_kl = float(k3.mean())
    mean_kl_per_seq = float((k3 * mask).sum(axis=1).mean())
    return rewards * mask, (mean_kl, mean_kl_per_seq)
