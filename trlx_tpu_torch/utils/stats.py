"""Statistics helpers: masked moments, whitening, running moments, logprobs.

Port of ``trlx_tpu/utils/stats.py``. The op sequence follows the JAX
functions (masked sums over ``max(sum(mask), 1)``, Bessel-corrected
whitening with ``rsqrt(var + 1e-8)``, ±inf outside the mask for min/max)
so that the plain paths agree with the JAX package to rounding.
``RunningMoments`` stays host-side numpy, as there.
"""

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "masked_mean",
    "masked_var",
    "whiten",
    "logprobs_of_labels",
    "get_tensor_stats",
    "RunningMoments",
]


def masked_mean(xs: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is None:
        return xs.mean()
    mask = mask.to(xs.dtype)
    return (xs * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def masked_var(
    xs: torch.Tensor, mask: Optional[torch.Tensor] = None, ddof: int = 0
) -> torch.Tensor:
    mean = masked_mean(xs, mask)
    n = mask.sum() if mask is not None else float(np.prod(xs.shape))
    sq = masked_mean((xs - mean) ** 2, mask)
    if ddof:
        sq = sq * (n / torch.clamp(torch.as_tensor(n - ddof, dtype=xs.dtype), min=1.0))
    return sq


def whiten(
    xs: torch.Tensor, mask: Optional[torch.Tensor] = None, shift_mean: bool = True
) -> torch.Tensor:
    """Zero mean / unit variance over the mask, unbiased (``ddof=1``)
    variance, as the JAX package and the reference's single-process path."""
    mean = masked_mean(xs, mask)
    var = masked_var(xs, mask, ddof=1)
    whitened = (xs - mean) * torch.rsqrt(var + 1e-8)
    if not shift_mean:
        whitened = whitened + mean
    return whitened


def logprobs_of_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Log-probabilities of ``labels`` under ``logits``: [B, T, V], [B, T] →
    [B, T], computed in f32 (the caller shifts logits and labels)."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    return logprobs.gather(-1, labels.to(torch.int64)[..., None])[..., 0]


def get_tensor_stats(xs: torch.Tensor, mask: torch.Tensor, n: torch.Tensor) -> dict:
    """Mean/min/max/std of a masked tensor, as a flat dict of scalars."""
    mean = (xs * mask).sum() / n
    inf = torch.full_like(xs, float("inf"))
    minimum = torch.where(mask > 0, xs, inf).amin()
    maximum = torch.where(mask > 0, xs, -inf).amax()
    std = torch.sqrt(((xs - mean) ** 2 * mask).sum() / torch.clamp(n, min=1.0))
    return dict(mean=mean, min=minimum, max=maximum, std=std)


class RunningMoments:
    """Streaming mean/std over reward batches (Chan et al. parallel
    variance), host-side numpy."""

    def __init__(self):
        self.mean = 0.0
        self.std = 1.0
        self.var = 1.0
        self.count = 1e-24

    def update(self, xs: np.ndarray) -> Tuple[float, float]:
        """Fold a batch in; returns (batch_mean, batch_std-with-Bessel)."""
        xs = np.asarray(xs, dtype=np.float64).reshape(-1)
        xs_count = xs.size
        xs_mean = float(xs.mean())
        xs_var = float(xs.var())

        delta = xs_mean - self.mean
        tot_count = self.count + xs_count

        new_sum = xs_var * xs_count
        old_sum = self.var * self.count + delta**2 * self.count * xs_count / tot_count
        tot_sum = old_sum + new_sum

        self.mean += delta * xs_count / tot_count
        self.var = tot_sum / tot_count
        self.std = float(np.sqrt(self.var * tot_count / max(tot_count - 1, 1)))
        self.count = tot_count

        return xs_mean, float(np.sqrt(xs_var * xs_count / max(xs_count - 1, 1)))
