"""SFT method config and loss.

Port of ``trlx_tpu/models/sft.py``: :class:`SFTConfig` (registered by
name) with the next-token cross-entropy over labels where
``IGNORE_INDEX`` marks positions left out of the loss (the prompt turns
of a dialogue), on full logits (:meth:`SFTConfig.loss`) or streamed
through the vocab projection in T-chunks (:meth:`SFTConfig.chunked_loss`,
``logit_chunk > 0``).
"""

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch

from trlx_tpu_torch.data.method_configs import MethodConfig, register_method

__all__ = ["IGNORE_INDEX", "SFTConfig"]

IGNORE_INDEX = -100


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token NLL (f32) and the 0/1 mask of labels that count — the one
    definition of the cross-entropy body, shared by both loss paths."""
    labels = labels.to(torch.int64)
    mask = (labels != IGNORE_INDEX).float()
    safe = torch.where(labels == IGNORE_INDEX, torch.zeros_like(labels), labels)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return nll, mask


@dataclass
@register_method("SFTConfig")
class SFTConfig(MethodConfig):
    """Supervised fine-tuning: next-token cross-entropy, optionally masked
    to the output turns of a dialogue (labels ``IGNORE_INDEX`` are left
    out). ``logit_chunk > 0`` streams the vocab projection in T-chunks of
    that size instead of materialising ``[B, T, V]`` logits."""

    name: str = "SFTConfig"
    gen_kwargs: Dict[str, Any] = field(default_factory=dict)
    logit_chunk: int = 0

    def loss(
        self,
        logits: torch.Tensor,  # [B, T, V]
        labels: torch.Tensor,  # [B, T]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        # causal shift: logits at t predict the label at t + 1
        token_nll, mask = _token_nll(logits[:, :-1], labels[:, 1:])
        loss = torch.sum(token_nll * mask) / torch.clamp(mask.sum(), min=1.0)
        return loss, {"losses/loss": loss, "losses/ppl": torch.exp(loss)}

    def chunked_loss(
        self,
        model: Any,  # has project_logits
        hidden: torch.Tensor,  # [B, T, E] final-normed hidden states
        labels: torch.Tensor,  # [B, T]
        chunk: int,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """:meth:`loss` without the full logits: hidden chunks stream through
        ``project_logits`` (``ops/chunked.py``)."""
        from trlx_tpu_torch.ops.chunked import stream_projected_reduce

        def body(carry, logits, lab):
            nll, m = _token_nll(logits, lab)
            s, n = carry
            return s + torch.sum(nll * m), n + torch.sum(m)

        zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
        s, n = stream_projected_reduce(
            model, hidden[:, :-1], [(labels[:, 1:], IGNORE_INDEX)], chunk, (zero, zero), body)
        loss = s / torch.clamp(n, min=1.0)
        return loss, {"losses/loss": loss, "losses/ppl": torch.exp(loss)}
