"""Fixed-bin distribution sketches of training dynamics.

A copy, for the port, of what the PPO path uses from
``trlx_tpu/observability/dynamics.py``: the bin count and per-quantity
ranges, the masked histogram (:func:`sketch`, and its numpy twin
:func:`sketch_np`), :func:`loss_sketches` and :func:`entropy_of_logits`.
Values are detached and clamped into the window's edge bins; a bin index
truncates toward zero, then clips (the JAX ``astype(int32)``).
"""

from typing import Any, Dict, Tuple

import numpy as np
import torch

__all__ = [
    "SKETCH_BINS",
    "SKETCH_RANGES",
    "sketch",
    "sketch_np",
    "loss_sketches",
    "entropy_of_logits",
]

SKETCH_BINS = 32

SKETCH_RANGES: Dict[str, Tuple[float, float]] = {
    "log_ratio": (-1.0, 1.0),  # new − old per-token logprob delta
    "kl": (0.0, 1.0),  # per-token k3 estimator vs the behavior policy
    "ref_kl": (0.0, 1.0),  # per-token k3 vs the frozen reference (rollout)
    "advantages": (-5.0, 5.0),  # whitened GAE advantages
    "value_error": (-5.0, 5.0),  # value prediction − return
    "entropy": (0.0, 12.0),  # per-token policy entropy, nats
    "reward_margin": (-10.0, 10.0),  # DPO chosen − rejected implicit reward
}


def sketch(x, mask=None, *, lo: float, hi: float, bins: int = SKETCH_BINS):
    """Masked fixed-bin histogram of ``x``: f32 counts of shape ``[bins]``."""
    x = x.detach().float()
    weights = torch.ones_like(x) if mask is None else mask.detach().float()
    scale = bins / (hi - lo)
    idx = torch.clamp(((x - lo) * scale).to(torch.int32), 0, bins - 1)
    counts = torch.zeros((bins,), dtype=torch.float32, device=x.device)
    return counts.index_add_(0, idx.reshape(-1).to(torch.int64), weights.reshape(-1))


def sketch_np(x, mask=None, *, lo: float, hi: float, bins: int = SKETCH_BINS):
    """Host (numpy) twin of :func:`sketch`."""
    x = np.asarray(x, np.float32)
    weights = np.ones(x.shape, np.float32) if mask is None else np.asarray(mask, np.float32)
    scale = bins / (hi - lo)
    idx = np.clip(((x - lo) * scale).astype(np.int32), 0, bins - 1)
    counts = np.zeros((bins,), np.float32)
    np.add.at(counts, idx.reshape(-1), weights.reshape(-1))
    return counts


def loss_sketches(named: Dict[str, Tuple[Any, Any]]) -> Dict[str, Any]:
    """Sketch each ``name -> (values, mask)`` pair into the canonical
    ``dist/<name>_hist`` stats keys."""
    out = {}
    for name, (values, mask) in named.items():
        lo, hi = SKETCH_RANGES[name]
        out[f"dist/{name}_hist"] = sketch(values, mask, lo=lo, hi=hi)
    return out


def entropy_of_logits(logits: torch.Tensor) -> torch.Tensor:
    """Per-token policy entropy (nats) from ``[..., V]`` logits, in f32 and
    detached, so sketching it perturbs nothing."""
    logp = torch.log_softmax(logits.detach().float(), dim=-1)
    return -(torch.exp(logp) * logp).sum(dim=-1)
