"""Trainer registry + abstract trainer contract.

Port of ``trlx_tpu/trainer/__init__.py``: trainers register by name
(:func:`register_trainer`), the reference's ``Accelerate*``/``NeMo*`` names
are accepted as aliases, and :class:`BaseRLTrainer` holds the user
callbacks.
"""

import sys
from abc import abstractmethod
from typing import Any, Callable, Dict, List, Optional

_TRAINERS: Dict[str, type] = {}

_TRAINER_ALIASES = {
    "accelerateppotrainer": "ppotrainer",
    "accelerateilqltrainer": "ilqltrainer",
    "acceleratesfttrainer": "sfttrainer",
    "nemoilqltrainer": "ilqltrainer",
    "nemosfttrainer": "sfttrainer",
    "nemoppotrainer": "ppotrainer",
}


def register_trainer(name: Any = None) -> Callable:
    """Decorator registering a trainer class by name."""

    def register_cls(cls, registered_name: str):
        _TRAINERS[registered_name.lower()] = cls
        setattr(sys.modules[__name__], registered_name, cls)
        return cls

    if isinstance(name, type):
        return register_cls(name, name.__name__)

    def wrap(cls):
        return register_cls(cls, name if isinstance(name, str) else cls.__name__)

    return wrap


def get_trainer(name: str) -> type:
    resolved = _TRAINER_ALIASES.get(name.lower(), name.lower())
    if resolved in _TRAINERS:
        return _TRAINERS[resolved]
    raise ValueError(f"Unknown trainer '{name}'. Registered: {sorted(_TRAINERS)}")


class BaseRLTrainer:
    """Abstract trainer contract: the config and the user callbacks
    (``reward_fn(samples, prompts, outputs)``, ``metric_fn``, stop
    sequences)."""

    def __init__(
        self,
        config,
        reward_fn: Optional[Callable] = None,
        metric_fn: Optional[Callable] = None,
        stop_sequences: Optional[List[str]] = None,
        **kwargs,
    ):
        if kwargs:  # e.g. logit_mask: transition logit masks are not ported
            raise ValueError(f"unknown or unported trainer arguments {sorted(kwargs)}")
        self.config = config
        self.reward_fn = reward_fn
        self.metric_fn = metric_fn
        self.stop_sequences = stop_sequences or []

    @abstractmethod
    def learn(self):
        """Train the model and return the final stats."""

    @abstractmethod
    def save(self, directory: Optional[str] = None, **kwargs):
        """Checkpoint the training state."""
