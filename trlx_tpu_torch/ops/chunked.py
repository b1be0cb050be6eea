"""Stream hidden states through the vocab projection in T-chunks.

Port of ``trlx_tpu/ops/chunked.py``. The ``[B, T, V]`` logits tensor is
the peak-memory item of large-vocabulary training forwards; a loss that
reduces over tokens never needs it whole. :func:`stream_projected_reduce`
cuts ``[B, T, ...]`` rows into chunks, projects each through the model's
``project_logits`` and folds a caller's reduction over them, each chunk
under ``torch.utils.checkpoint`` (the JAX ``jax.checkpoint``): forward and
backward peak at ``[B, chunk, V]``. Torch ops only — the JAX module has
no Pallas kernel.
"""

from typing import Any, Callable, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["stream_projected_reduce"]


def stream_projected_reduce(
    model: Any,  # has project_logits(hidden) -> logits
    hidden: torch.Tensor,  # [B, T, E]
    arrays: Sequence[Tuple[torch.Tensor, Any]],  # ([B, T] tensor, pad value) ...
    chunk: int,
    init: Any,  # reduction carry
    body_fn: Callable[..., Any],  # (carry, logits, *chunk_arrays) -> carry
) -> Any:
    """Fold ``body_fn`` over T-chunks of projected logits, in order.

    ``arrays`` ride along chunk-aligned, padded with their declared pad
    value (``IGNORE_INDEX`` labels, a zero mask) so padding adds nothing to
    a well-formed reduction. The chunk size holds for any T through
    padding: T is often odd after the causal shift."""
    B, T, _ = hidden.shape
    C = min(chunk, T)
    pad = (-T) % C
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        arrays = [(F.pad(a, (0, pad), value=v), v) for a, v in arrays]

    def body(carry, h, *xs):
        return body_fn(carry, model.project_logits(h), *xs)

    carry = init
    for start in range(0, T + pad, C):
        cols = slice(start, start + C)
        carry = checkpoint(body, carry, hidden[:, cols], *(a[:, cols] for a, _ in arrays),
                           use_reentrant=False)
    return carry
