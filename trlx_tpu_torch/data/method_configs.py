"""Method (algorithm) config registry.

Port of ``trlx_tpu/data/method_configs.py``: algorithm hyperparameters live
in a dataclass registered by name (:func:`register_method`), looked up by
:func:`get_method` when a config dict is loaded.
"""

from dataclasses import dataclass, fields
from typing import Any, Callable, Dict

# name (lowercase) -> MethodConfig subclass
_METHODS: Dict[str, type] = {}


def strict_from_dict(cls, config: Dict[str, Any]):
    """Construct a dataclass from a dict, rejecting unknown keys."""
    known = {f.name for f in fields(cls)}
    unknown = set(config) - known
    if unknown:
        raise ValueError(
            f"Unknown keys {sorted(unknown)} for {cls.__name__}; known: {sorted(known)}"
        )
    return cls(**config)


def register_method(name: Any = None) -> Callable:
    """Decorator registering a MethodConfig subclass under ``name``.

    Usable bare (``@register_method``) or with a string name
    (``@register_method("ppo")``).
    """

    def register_cls(cls, registered_name: str):
        _METHODS[registered_name.lower()] = cls
        setattr(cls, "name", registered_name)
        return cls

    if isinstance(name, type):  # bare decorator
        return register_cls(name, name.__name__)

    def wrap(cls):
        return register_cls(cls, name if isinstance(name, str) else cls.__name__)

    return wrap


@dataclass
@register_method
class MethodConfig:
    """Base config for an RL method.

    :param name: registry name of the method (e.g. ``"PPOConfig"``).
    :param dist_sketches: emit on-device distribution sketches of training
        dynamics from the loss (``dist/*_hist`` — observability/dynamics.py).
        Sketches are stop-gradient'd and ride the existing stats fetch, so
        disabling buys nothing but a few histogram scatters per step.
    """

    name: str = "MethodConfig"
    dist_sketches: bool = True

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return strict_from_dict(cls, config)

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in fields(self)}


def get_method(name: str) -> type:
    """Return the MethodConfig class registered under ``name``."""
    name = name.lower()
    if name in _METHODS:
        return _METHODS[name]
    raise ValueError(
        f"Unknown method config '{name}'. Registered: {sorted(_METHODS)}"
    )
