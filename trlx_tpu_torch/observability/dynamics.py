"""Fixed-bin distribution sketches of training dynamics, and their
host-side summaries.

Port of ``trlx_tpu/observability/dynamics.py``: the bin count and
per-quantity ranges, the masked histogram (:func:`sketch`, and its numpy
twin :func:`sketch_np`), :func:`loss_sketches`, :func:`entropy_of_logits`,
and the host side: :func:`hist_percentile`, :func:`hist_mass_outside` and
:class:`DynamicsSummarizer`. Values are detached and clamped into the
window's edge bins; a bin index truncates toward zero, then clips (the JAX
``astype(int32)``).

The loss functions put ``dist/<name>_hist`` counts into their stats (the
fused loss kernel computes its five in the same pass as the loss). They
ride the train step's one device → host stats copy, where
:meth:`DynamicsSummarizer.summarize` turns each into
``dist/<name>_{p05,p50,p95}`` gauges (and ``dist/ratio_outside_clip_frac``)
before ``filter_non_scalars`` drops the raw arrays; the health detectors
(``observability/health.py``) read those gauges.
"""

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "SKETCH_BINS",
    "SKETCH_RANGES",
    "sketch",
    "sketch_np",
    "loss_sketches",
    "entropy_of_logits",
    "hist_percentile",
    "hist_mass_outside",
    "DynamicsSummarizer",
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

_HIST_KEY_RE = re.compile(r"^dist/(\w+)_hist$")


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


def hist_percentile(counts: np.ndarray, lo: float, hi: float, q: float) -> float:
    """Percentile ``q`` (0-100) from fixed-bin counts, linearly interpolated
    inside the containing bin. The caller guarantees ``counts.sum() > 0``."""
    counts = np.asarray(counts, np.float64)
    bins = counts.shape[0]
    width = (hi - lo) / bins
    cum = np.cumsum(counts)
    target = cum[-1] * (q / 100.0)
    i = min(int(np.searchsorted(cum, target)), bins - 1)
    prev = cum[i - 1] if i > 0 else 0.0
    frac = (target - prev) / max(counts[i], 1e-12)
    return float(lo + (i + min(max(frac, 0.0), 1.0)) * width)


def hist_mass_outside(counts: np.ndarray, lo: float, hi: float, lower: float,
                      upper: float) -> float:
    """Fraction of the mass outside ``[lower, upper]``, each bin's overlap
    interpolated linearly."""
    counts = np.asarray(counts, np.float64)
    total = counts.sum()
    if total <= 0:
        return 0.0
    bins = counts.shape[0]
    width = (hi - lo) / bins
    edges = lo + width * np.arange(bins + 1)
    inside_lo = np.clip(edges[:-1], lower, upper)
    inside_hi = np.clip(edges[1:], lower, upper)
    inside_frac = np.clip((inside_hi - inside_lo) / width, 0.0, 1.0)
    return float(1.0 - float((counts * inside_frac).sum()) / total)


class DynamicsSummarizer:
    """The fetched ``dist/*_hist`` counts as scalar gauges: per sketch
    ``dist/<name>_p05|_p50|_p95``, and ``dist/ratio_outside_clip_frac``, the
    share of per-token ratio mass beyond the PPO clip window ``[1 − ε,
    1 + ε]``. One per trainer (``trainer.obs.dynamics``); the learn loop
    calls :meth:`summarize` on the host stats before ``filter_non_scalars``
    drops the arrays."""

    def __init__(self, cliprange: Optional[float] = None):
        self.cliprange = float(cliprange) if cliprange else None

    def summarize(self, host_stats: Dict[str, Any]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for key, value in host_stats.items():
            m = _HIST_KEY_RE.match(key) if isinstance(key, str) else None
            if m is None:
                continue
            counts = np.asarray(value, np.float64).reshape(-1)
            if counts.sum() <= 0:  # an empty mask: nothing to summarize
                continue
            name = m.group(1)
            lo, hi = SKETCH_RANGES.get(name, (0.0, 1.0))
            out[f"dist/{name}_p05"] = hist_percentile(counts, lo, hi, 5.0)
            out[f"dist/{name}_p50"] = hist_percentile(counts, lo, hi, 50.0)
            out[f"dist/{name}_p95"] = hist_percentile(counts, lo, hi, 95.0)
            if name == "log_ratio" and self.cliprange:
                lo_r = float(np.log(max(1.0 - self.cliprange, 1e-6)))
                hi_r = float(np.log(1.0 + self.cliprange))
                out["dist/ratio_outside_clip_frac"] = hist_mass_outside(
                    counts, lo, hi, lo_r, hi_r)
        return out
