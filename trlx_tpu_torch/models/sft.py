"""SFT method config and loss.

Port of ``trlx_tpu/models/sft.py``: :class:`SFTConfig` (registered by
name) with the next-token cross-entropy over labels where
``IGNORE_INDEX`` marks positions left out of the loss (the prompt turns
of a dialogue), on full logits (:meth:`SFTConfig.loss`) or streamed
through the vocab projection in T-chunks (:meth:`SFTConfig.chunked_loss`,
``logit_chunk > 0``). Both take the next-token labels
(:func:`next_token_labels`, made on the whole rows before a batch is
split over ranks), where JAX's shift the labels inside the loss.
"""

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.data.method_configs import MethodConfig, register_method

__all__ = ["IGNORE_INDEX", "SFTConfig", "next_token_labels"]

IGNORE_INDEX = -100


def next_token_labels(labels: np.ndarray) -> np.ndarray:
    """The causal shift: the label each position predicts, ``labels[:, 1:]``
    with the last position ``IGNORE_INDEX``."""
    out = np.full_like(labels, IGNORE_INDEX)
    out[:, :-1] = labels[:, 1:]
    return out


def _token_nll(logits: torch.Tensor, labels: torch.Tensor,
               logprobs: Optional[Callable] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token NLL (f32) and the 0/1 mask of labels that count — the one
    definition of the cross-entropy body, shared by both loss paths.
    ``logprobs(logits, labels)`` replaces the log-softmax gather (the
    vocab-parallel one on a rank's slice of the vocabulary)."""
    labels = labels.to(torch.int64)
    mask = (labels != IGNORE_INDEX).float()
    safe = torch.where(labels == IGNORE_INDEX, torch.zeros_like(labels), labels)
    if logprobs is not None:
        return -logprobs(logits, safe), mask
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
        reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        logprobs: Optional[Callable] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The token mean of the NLL of ``labels``, the next-token labels
        (:func:`next_token_labels`). ``reduce`` (a batch split over ranks)
        sums a tensor over every rank that holds a part of the batch
        (:func:`_token_mean`); ``logprobs`` as :func:`_token_nll`."""
        token_nll, mask = _token_nll(logits, labels, logprobs)
        return _token_mean(torch.sum(token_nll * mask), mask.sum(), reduce)

    def chunked_loss(
        self,
        model: Any,  # has project_logits
        hidden: torch.Tensor,  # [B, T, E] final-normed hidden states
        labels: torch.Tensor,  # [B, T]
        chunk: int,
        reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        logprobs: Optional[Callable] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """:meth:`loss` without the full logits: hidden chunks stream through
        ``project_logits`` (``ops/chunked.py``)."""
        from trlx_tpu_torch.ops.chunked import stream_projected_reduce

        def body(carry, logits, lab):
            nll, m = _token_nll(logits, lab, logprobs)
            s, n = carry
            return s + torch.sum(nll * m), n + torch.sum(m)

        zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
        s, n = stream_projected_reduce(
            model, hidden, [(labels, IGNORE_INDEX)], chunk, (zero, zero), body)
        return _token_mean(s, n, reduce)


def _token_mean(nll_sum: torch.Tensor, count: torch.Tensor,
                reduce: Optional[Callable[[torch.Tensor], torch.Tensor]]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``nll_sum / max(count, 1)`` with its stats. With ``reduce`` the
    count is the global one and the returned loss is this rank's share:
    the shares sum to the global token mean (a mean of per-rank means
    would weight ranks, not tokens), and so do their gradients; the logged
    loss is the global mean."""
    if reduce is None:
        loss = nll_sum / torch.clamp(count, min=1.0)
        return loss, {"losses/loss": loss, "losses/ppl": torch.exp(loss)}
    loss = nll_sum / torch.clamp(reduce(count.detach()), min=1.0)
    total = reduce(loss.detach())
    return loss, {"losses/loss": total, "losses/ppl": torch.exp(total)}
