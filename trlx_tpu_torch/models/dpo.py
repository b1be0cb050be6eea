"""DPO method config and loss.

Port of ``trlx_tpu/models/dpo.py``: :class:`DPOConfig` (registered as
``"DPOConfig"``) and the conservative-DPO logistic loss on the preference
margin ``(log π_c − log π_r) − (log π_ref_c − log π_ref_r)`` of summed
completion logprobs (Rafailov et al. 2023), with the implicit rewards
``β · (log π − log π_ref)`` in its stats.
"""

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from trlx_tpu_torch.data.method_configs import MethodConfig, register_method
from trlx_tpu_torch.utils import flatten_dict
from trlx_tpu_torch.observability.dynamics import loss_sketches

__all__ = ["DPOConfig"]


@dataclass
@register_method("DPOConfig")
class DPOConfig(MethodConfig):
    """DPO hyperparameters.

    :param beta: inverse temperature of the implicit reward (typical 0.1–0.5).
    :param label_smoothing: conservative-DPO smoothing ε: labels are taken
        as flipped with probability ε (0 = standard DPO).
    :param reference_free: drop the reference terms (π_ref uniform).
    :param gen_kwargs: sampling settings of the evaluation.
    :param logit_chunk: stream the vocab projection of the completion
        logprobs in T-chunks of this size (0 = the full ``[B, T, V]``
        logits), as ``SFTConfig.logit_chunk``.
    """

    name: str = "DPOConfig"
    beta: float = 0.1
    label_smoothing: float = 0.0
    reference_free: bool = False
    gen_kwargs: Dict[str, Any] = field(default_factory=dict)
    logit_chunk: int = 0

    def loss(
        self,
        policy_chosen_logps: torch.Tensor,  # [B] summed completion logprobs
        policy_rejected_logps: torch.Tensor,  # [B]
        ref_chosen_logps: torch.Tensor,  # [B] frozen-reference sums
        ref_rejected_logps: torch.Tensor,  # [B]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        pi_ratios = policy_chosen_logps.float() - policy_rejected_logps.float()
        if self.reference_free:
            ref_ratios = torch.zeros_like(pi_ratios)
        else:
            ref_ratios = ref_chosen_logps.float() - ref_rejected_logps.float()
        logits = pi_ratios - ref_ratios  # the preference margin

        eps = self.label_smoothing
        losses = (-(1.0 - eps) * F.logsigmoid(self.beta * logits)
                  - eps * F.logsigmoid(-self.beta * logits))
        loss = losses.mean()

        chosen_rewards = (self.beta * (policy_chosen_logps.float() - ref_chosen_logps.float())
                          ).detach()
        rejected_rewards = (self.beta * (policy_rejected_logps.float()
                                         - ref_rejected_logps.float())).detach()
        margin = chosen_rewards - rejected_rewards
        dist = {}
        if self.dist_sketches:
            # per-pair margins, no mask: the distribution tells "uniformly
            # confident" from "a few saturated pairs"
            dist = loss_sketches({"log_ratio": (logits, None), "reward_margin": (margin, None)})
        stats = dict(
            **dist,
            losses=dict(total_loss=loss.detach()),
            rewards=dict(
                chosen=chosen_rewards.mean(),
                rejected=rejected_rewards.mean(),
                margin=margin.mean(),
                accuracy=(chosen_rewards > rejected_rewards).float().mean(),
            ),
            logps=dict(
                chosen=policy_chosen_logps.detach().float().mean(),
                rejected=policy_rejected_logps.detach().float().mean(),
            ),
        )
        return loss, flatten_dict(stats)
