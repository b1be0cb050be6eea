"""Reward model: an LM backbone with a scalar head, trained on preference
pairs.

Port of ``trlx_tpu/models/reward.py``:

- :class:`RewardModel`: a :class:`CausalTransformer` backbone and a
  bias-free f32 ``r_head`` scoring every position's final hidden state.
  The backbone runs with ``logits_span=(0, 0)``: the vocabulary
  projection, whose output the JAX module discards, is never computed;
- :func:`end_scores`: the reward at each row's last non-pad position;
- :func:`pairwise_reward_loss`: the reference's per-pair loop
  (``-log σ(r_chosen − r_rejected)`` averaged over the positions from the
  first differing token to the longer sequence's end) as masks over the
  ``[B, T]`` block; identical pairs add nothing;
- :func:`reward_loss_fn`: one forward over chosen ‖ rejected, then the loss;
- :func:`build_reward_model`: a ``builtin:`` spec with seeded weights, or
  a local Hugging Face checkpoint directory whose backbone is imported
  (``models/hf_interop.py``) under a seeded ``r_head``.
"""

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from trlx_tpu_torch.models.transformer import (
    CausalTransformer,
    TransformerConfig,
    seeded_init_,
)

__all__ = ["RewardModel", "end_scores", "pairwise_reward_loss", "reward_loss_fn",
           "build_reward_model"]


class RewardModel(nn.Module):
    """Causal LM backbone + per-position scalar reward head (bias-free, f32)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.config = cfg
        self.backbone = CausalTransformer(cfg)
        self.r_head = nn.Linear(cfg.hidden_size, 1, bias=False, dtype=cfg.param_dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The backbone's JAX initialisers, then normal(0.02) for the head."""
        self.backbone.reset_parameters(generator)
        seeded_init_(self.r_head, generator)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, Any]:
        out = self.backbone(input_ids, attention_mask=attention_mask, logits_span=(0, 0))
        h = out["hidden_states"]
        rewards = F.linear(h.float(), self.r_head.weight.float())[..., 0]
        return {"rewards": rewards, "hidden_states": h}


def end_scores(rewards: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Reward at each row's last non-pad position (``[B, T]`` → ``[B]``)."""
    lengths = torch.clamp(attention_mask.sum(dim=1).to(torch.int64), min=1)
    return rewards.gather(1, (lengths - 1)[:, None])[:, 0]


def pairwise_reward_loss(
    chosen_rewards: torch.Tensor,  # [B, T]
    rejected_rewards: torch.Tensor,  # [B, T]
    chosen_ids: torch.Tensor,  # [B, T] right-padded
    rejected_ids: torch.Tensor,  # [B, T]
    chosen_mask: torch.Tensor,  # [B, T]
    rejected_mask: torch.Tensor,  # [B, T]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean over ``[divergence, end)`` of ``-log σ(r_chosen − r_rejected)``,
    per pair, averaged over the pairs that differ: divergence is the first
    position where the ids or masks differ, end the longer length."""
    T = chosen_ids.shape[1]
    positions = torch.arange(T, device=chosen_ids.device)[None, :]
    differs = (chosen_ids != rejected_ids) | (chosen_mask != rejected_mask)
    any_diff = differs.any(dim=1)
    div_ix = torch.argmax(differs.to(torch.int32), dim=1)  # first True (0 if none)
    end_ix = torch.maximum(chosen_mask.sum(dim=1), rejected_mask.sum(dim=1)).to(torch.int64)
    span = (positions >= div_ix[:, None]) & (positions < end_ix[:, None]) & any_diff[:, None]
    n = torch.clamp(span.sum(dim=1), min=1).float()

    delta = chosen_rewards.float() - rejected_rewards.float()
    per_pair = torch.sum(-F.logsigmoid(delta) * span, dim=1) / n
    diff_f = any_diff.float()
    n_pairs = torch.clamp(diff_f.sum(), min=1.0)
    loss = torch.sum(per_pair * diff_f) / n_pairs

    c_end = end_scores(chosen_rewards, chosen_mask).detach().float()
    r_end = end_scores(rejected_rewards, rejected_mask).detach().float()
    stats = {
        "reward/loss": loss.detach(),
        "reward/accuracy": torch.sum((c_end > r_end).float() * diff_f) / n_pairs,
        "reward/chosen_end_mean": c_end.mean(),
        "reward/rejected_end_mean": r_end.mean(),
        "reward/margin": torch.mean((c_end - r_end) * diff_f),
    }
    return loss, stats


def reward_loss_fn(model: RewardModel, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One forward over the stacked chosen ‖ rejected rows, then
    :func:`pairwise_reward_loss`."""
    ids = torch.cat([batch["chosen_ids"], batch["rejected_ids"]], dim=0)
    mask = torch.cat([batch["chosen_mask"], batch["rejected_mask"]], dim=0)
    rewards = model(ids, attention_mask=mask)["rewards"]
    B = batch["chosen_ids"].shape[0]
    return pairwise_reward_loss(rewards[:B], rewards[B:], batch["chosen_ids"],
                                batch["rejected_ids"], batch["chosen_mask"],
                                batch["rejected_mask"])


def build_reward_model(model_path: str = "builtin:gpt2-small", seed: int = 0,
                       device: Union[None, str, torch.device] = None, **overrides
                       ) -> Tuple[RewardModel, TransformerConfig]:
    """``(model, config)`` for a ``builtin:`` spec with seeded weights (the
    :func:`~trlx_tpu_torch.models.builder.build_causal_lm` way: constructed
    on ``meta``, drawn tensor by tensor), or for a local HF checkpoint
    directory (its backbone imported, ``r_head`` seeded), in eval mode with
    gradients on, on ``device`` (default: the GPU)."""
    from trlx_tpu_torch.models import hf_interop
    from trlx_tpu_torch.models.builder import (
        _checkpoint_dir,
        _materialise,
        resolve_transformer_config,
    )

    model, cfg = _materialise({None: RewardModel}, None,
                              resolve_transformer_config(model_path, **overrides), seed, device,
                              _checkpoint_dir(model_path), hf_interop.load_pretrained)
    return model.requires_grad_(True), cfg
