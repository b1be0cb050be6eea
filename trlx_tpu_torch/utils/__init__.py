"""General utilities of the port: seeding, dict helpers, the LR schedules
and the optimizers.

Port of the parts of ``trlx_tpu/utils/__init__.py`` the PPO path runs. The
JAX package builds optax transforms; here a schedule is a plain function of
the step count and the optimizers are ``torch.optim``.

``optax.adamw`` and ``torch.optim.AdamW`` compute the same update: decoupled
weight decay on every tensor the optimizer holds (``p -= lr * wd * p`` from
the pre-step value), and ``eps`` added outside the square root of the
bias-corrected second moment (``m̂ / (sqrt(v̂) + eps)``, ``eps_root = 0``).
optax's default ``weight_decay`` (1e-4) is kept where a config names none.
Frozen parameters are simply not given to the optimizer: no update and no
decay, the counterpart of optax's ``set_to_zero`` mask.
"""

import math
import random
from numbers import Number
from typing import Any, Callable, Dict, Iterable, Iterator, Mapping

import numpy as np
import torch

__all__ = [
    "significant",
    "set_seed",
    "filter_non_scalars",
    "flatten_dict",
    "infinite_loader",
    "get_scheduler",
    "get_optimizer",
]


def significant(x: Any, ndigits: int = 2) -> Any:
    """Cut the number to its ``ndigits`` most significant figures."""
    if not isinstance(x, Number) or x == 0 or not math.isfinite(x):
        return x
    return round(x, ndigits - 1 - int(math.floor(math.log10(abs(x)))))


def set_seed(seed: int) -> None:
    """Seed the host-side RNGs (``random``, numpy) and torch's."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def filter_non_scalars(xs: Mapping[str, Any]) -> Dict[str, float]:
    """Keep only scalar-convertible entries of a flat stats dict."""
    ys = {}
    for k, v in xs.items():
        try:
            ys[k] = float(v)
        except (TypeError, ValueError, RuntimeError):
            continue
    return ys


def flatten_dict(d: Mapping, parent_key: str = "", sep: str = "/") -> Dict[str, Any]:
    """Flatten a nested mapping into ``a/b/c`` keys."""
    items = []
    for k, v in d.items():
        key = parent_key + sep + str(k) if parent_key else str(k)
        if isinstance(v, Mapping):
            items.extend(flatten_dict(v, key, sep).items())
        else:
            items.append((key, v))
    return dict(items)


def infinite_loader(loader: Iterable) -> Iterator:
    """Cycle a dataloader forever."""
    while True:
        yield from loader


_SCHEDULERS = ("cosine_annealing", "linear", "constant", "warmup_cosine")


def get_scheduler(
    name: str, kwargs: Dict[str, Any], default_lr: float = None
) -> Callable[[int], float]:
    """A learning-rate schedule ``step -> lr`` by config name, with the JAX
    package's semantics: ``cosine_annealing`` is torch's CosineAnnealingLR
    with the step clipped at ``T_max``; ``linear``, ``constant`` and
    ``warmup_cosine`` are optax's schedules of the same names."""
    name = name.lower()
    if name not in _SCHEDULERS:
        raise ValueError(f"Unknown scheduler {name} (one of {_SCHEDULERS})")
    kwargs = dict(kwargs)
    lr = kwargs.pop("lr", None)
    if lr is None:
        lr = default_lr
    if name == "cosine_annealing":
        t_max = float(int(kwargs.pop("T_max", 10_000)))
        eta_min = float(kwargs.pop("eta_min", 0.0))
        if lr is None:
            raise ValueError(
                "cosine_annealing needs a base LR: put `lr` in scheduler kwargs "
                "or pass default_lr (the optimizer's lr)"
            )
        return lambda step: eta_min + (lr - eta_min) * 0.5 * (
            1 + math.cos(math.pi * min(float(step), t_max) / t_max)
        )
    if name == "linear":
        if lr is None:
            lr = kwargs.pop("init_value", None)
        init = lr if lr is not None else kwargs.pop("start", 1e-4)
        end = kwargs.pop("end_value", kwargs.pop("end", 0.0))
        steps = int(kwargs.pop("total_steps", kwargs.pop("transition_steps", 10_000)))

        def linear(step):
            frac = min(max(float(step), 0.0), float(steps)) / steps if steps > 0 else 1.0
            return init + (end - init) * frac

        return linear
    if name == "constant":
        if lr is None:
            lr = kwargs.pop("init_value", None)
        value = lr if lr is not None else 1e-4
        return lambda step: value
    # warmup_cosine: optax.warmup_cosine_decay_schedule
    peak = kwargs.pop("peak_value", lr)
    peak = peak if peak is not None else 1e-4
    init = kwargs.pop("init_value", 0.0)
    warmup = int(kwargs.pop("warmup_steps", 100))
    decay = int(kwargs.pop("decay_steps", 10_000))
    end = kwargs.pop("end_value", 0.0)

    def warmup_cosine(step):
        step = float(step)
        if step < warmup:
            return init + (peak - init) * step / max(warmup, 1)
        span = max(decay - warmup, 1)
        t = min(max(step - warmup, 0.0), float(span)) / span
        return end + (peak - end) * 0.5 * (1 + math.cos(math.pi * t))

    return warmup_cosine


def get_optimizer(name: str, kwargs: Dict[str, Any], params: Iterable[torch.Tensor]):
    """``adamw`` or ``adam`` over ``params`` (the trainable tensors only).
    ``betas`` and the optax names ``b1``/``b2`` are both accepted; the
    learning rate is set per step from the schedule by the trainer."""
    name = name.lower()
    kwargs = dict(kwargs)
    lr = float(kwargs.pop("lr", 1e-4))
    betas = kwargs.pop("betas", None)
    b1 = float(kwargs.pop("b1", betas[0] if betas is not None else 0.9))
    b2 = float(kwargs.pop("b2", betas[1] if betas is not None else 0.999))
    eps = float(kwargs.pop("eps", 1e-8))
    if kwargs.pop("eps_root", 0.0):
        raise ValueError("eps_root is not supported: torch's Adam adds eps outside the root")
    if name == "adamw":
        wd = float(kwargs.pop("weight_decay", 1e-4))  # optax's default
        opt = torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=wd)
    elif name == "adam":
        kwargs.pop("weight_decay", None)  # optax.adam takes none
        opt = torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=0.0)
    else:
        raise ValueError(
            f"optimizer {name!r}: the port has adamw and adam (the PPO slice's)"
        )
    if kwargs:
        raise ValueError(f"unknown optimizer kwargs {sorted(kwargs)} for {name}")
    return opt
