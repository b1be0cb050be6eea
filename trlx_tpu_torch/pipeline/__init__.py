"""Pipeline abstractions + registry.

Port of ``trlx_tpu/pipeline/__init__.py``: the pipeline registry,
:class:`BatchLoader` (numpy batches collated on the host, shuffled by index
with ``random.Random(seed)`` — so a store that holds its rows in the JAX
package's order yields the same minibatches), :class:`BasePipeline` and
:class:`BaseRolloutStore` and :class:`PrefetchLoader` (collation on a
background thread, ``train.prefetch_batches`` and
``train.rollout_pipeline_depth`` batches ahead).
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

    def advance_epoch(self) -> None:
        """Draw an epoch's shuffle without collating it (a resumed run's
        skipped epoch)."""
        if self.shuffle:
            self._rng.shuffle(list(range(len(self.dataset))))

    def __iter__(self) -> Iterator[Any]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idxs = order[start : start + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                return
            yield self.collate_fn([self.dataset[i] for i in idxs])


class PrefetchLoader:
    """Background-thread prefetch over any re-iterable batch loader: one
    worker keeps up to ``depth`` collated batches ready while the device
    consumes the current one. One worker keeps batch order and shuffle
    determinism; a worker exception is raised again in the consumer."""

    def __init__(self, loader, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.loader = loader
        self.depth = depth

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[Any]:
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        end, err = object(), object()

        def put(item) -> bool:
            """Enqueue unless the consumer stopped; never blocks forever."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self.loader:
                    if not put(batch):
                        return  # cancelled: drop the rest of the epoch
                put(end)
            except BaseException as e:  # raised again in the consumer
                put((err, e))

        t = threading.Thread(target=worker, daemon=True, name="trlx-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, tuple) and len(item) == 2 and item[0] is err:
                    raise item[1]
                yield item
        finally:
            # the consumer stopped (break, exception or exhaustion): cancel
            # the worker between batches
            stop.set()
            try:
                q.get_nowait()  # unblock a put in flight
            except queue.Empty:
                pass
            try:
                t.join(timeout=5)
            except Exception:
                # interpreter shutdown: an infinite prompt iterator over this
                # loader is collected after threading's teardown, when the
                # daemon worker is already gone and the join cannot say so
                pass


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
