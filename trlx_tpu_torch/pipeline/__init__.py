"""Pipeline abstractions + registry.

Port of ``trlx_tpu/pipeline/__init__.py``: the pipeline registry,
:class:`BatchLoader` (numpy batches collated on the host, shuffled by index
with ``random.Random(seed)`` — so a store that holds its rows in the JAX
package's order yields the same minibatches), :class:`BasePipeline` and
:class:`BaseRolloutStore`. The background-thread prefetch loader is not
ported: the port collates at depth 0.
"""

import random
import sys
from abc import abstractmethod
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

_DATAPIPELINE: Dict[str, type] = {}


def register_datapipeline(name: Any = None) -> Callable:
    """Decorator registering a pipeline class by name."""

    def register_cls(cls, registered_name: str):
        _DATAPIPELINE[registered_name.lower()] = cls
        setattr(sys.modules[__name__], registered_name, cls)
        return cls

    if isinstance(name, type):
        return register_cls(name, name.__name__)

    def wrap(cls):
        return register_cls(cls, name if isinstance(name, str) else cls.__name__)

    return wrap


def get_pipeline(name: str) -> type:
    name = name.lower()
    if name in _DATAPIPELINE:
        return _DATAPIPELINE[name]
    raise ValueError(f"Unknown pipeline '{name}'. Registered: {sorted(_DATAPIPELINE)}")


class BatchLoader:
    """Minimal host-side batch iterator over an indexable dataset.

    Supports shuffling, drop_last, and a collate function; re-iterable
    (fresh order per epoch when shuffled).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable[[List[Any]], Any],
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Any]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idxs = order[start : start + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                return
            yield self.collate_fn([self.dataset[i] for i in idxs])


class BasePipeline:
    """An indexable dataset of prompts/samples."""

    def __init__(self, path: str = "dataset"):
        self.path = path

    @abstractmethod
    def __getitem__(self, index: int):
        ...

    @abstractmethod
    def __len__(self) -> int:
        ...

    @abstractmethod
    def create_loader(self, batch_size: int, shuffle: bool = False, **kwargs) -> BatchLoader:
        ...


class BaseRolloutStore:
    """A mutable store of collected experiences."""

    def __init__(self, capacity: int = -1):
        self.history: List[Any] = []
        self.capacity = capacity

    @abstractmethod
    def push(self, exps: Iterable[Any]):
        """Push experiences to the store."""
        ...

    def __getitem__(self, index: int):
        return self.history[index]

    def __len__(self) -> int:
        return len(self.history)

    @abstractmethod
    def create_loader(self, batch_size: int, shuffle: bool = False, **kwargs) -> BatchLoader:
        ...
