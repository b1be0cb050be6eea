"""The staleness-bounded experience queue: actors produce version-tagged
chunks, the learner consumes them in chunk-index order.

Port of ``trlx_tpu/async_rl/queue.py``; numpy and files only, as there.

Two transports behind one contract:

- :class:`ExperienceQueue` — in-process (thread mode): a bounded deque +
  condition variable. ``put`` blocks while full (``block`` policy) or
  evicts the head (``drop_oldest``); ``get`` blocks until a chunk lands.
- :class:`FileExperienceQueue` — cross-process (process mode): a spool
  directory of atomically-committed ``chunk_<index>.npz`` files. The
  producer back-pressures against the consumer's ``CURSOR.json``; the
  consumer waits for the next index, loads, deletes, and advances the
  cursor. A crash mid-write leaves no partial chunk (tmp + rename), and a
  respawned actor derives "what is already committed" from the directory —
  the requeue-on-actor-death mechanism.

Chunks are opaque payload dicts (host numpy arrays + scalars) tagged with
the producing actor's params ``version`` — the learner computes staleness
as ``learner_version − chunk.version`` at consumption.
"""

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

__all__ = [
    "ExperienceChunk",
    "ExperienceQueue",
    "FileExperienceQueue",
    "QueueClosed",
]


class QueueClosed(RuntimeError):
    """Raised by blocked producers/consumers when the queue shuts down."""


@dataclass
class ExperienceChunk:
    """One produced rollout chunk: ``index`` is the global chunk position
    (the learner finalizes strictly in index order — reward running moments
    are order-sensitive), ``version`` the params version the chunk STARTED
    under (conservative under in-flight mid-chunk updates), ``payload`` the
    trainer-defined host arrays."""

    index: int
    version: int
    payload: Dict[str, Any] = field(default_factory=dict)


class ExperienceQueue:
    """Bounded in-process chunk buffer (thread mode).

    ``policy="block"`` back-pressures producers at ``capacity``;
    ``policy="drop_oldest"`` evicts the head instead (counted on ``metrics``
    as ``async/dropped_chunks``) and reports it through ``on_drop`` — the
    collector REGENERATES the evicted chunk from its spec under fresher
    params (the learner finalizes in strict index order, so an evicted
    index must reappear or the drain would wait forever). Freshness over
    staleness, never over completeness.
    """

    def __init__(
        self,
        capacity: int,
        policy: str = "block",
        metrics: Any = None,
        on_drop: Any = None,
    ):
        if capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        if policy not in ("block", "drop_oldest"):
            raise ValueError(f"unknown queue policy '{policy}' (block | drop_oldest)")
        if policy == "drop_oldest" and on_drop is None:
            raise ValueError(
                "drop_oldest requires an on_drop callback: evicted chunk "
                "indices must be regenerated (the learner drains in strict "
                "index order)"
            )
        self.capacity = capacity
        self.policy = policy
        self.metrics = metrics
        self.on_drop = on_drop
        self._cond = threading.Condition()
        self._chunks: deque = deque()  # guarded-by: _cond
        self._closed = False  # guarded-by: _cond

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._chunks)

    def put(self, chunk: ExperienceChunk) -> None:
        dropped = None
        with self._cond:
            while self.policy == "block" and len(self._chunks) >= self.capacity:
                if self._closed:
                    raise QueueClosed("experience queue closed")
                self._cond.wait(timeout=0.1)
            if self._closed:
                raise QueueClosed("experience queue closed")
            if self.policy == "drop_oldest" and len(self._chunks) >= self.capacity:
                dropped = self._chunks.popleft()
                if self.metrics is not None:
                    self.metrics.inc("async/dropped_chunks")
            self._chunks.append(chunk)
            self._cond.notify_all()
        if dropped is not None and self.on_drop is not None:
            self.on_drop(dropped)  # outside the lock: the callback requeues

    def get(self, timeout: Optional[float] = None) -> ExperienceChunk:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._chunks:
                if self._closed:
                    raise QueueClosed("experience queue closed")
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("experience queue get timed out")
                self._cond.wait(timeout=0.1 if remaining is None else min(remaining, 0.1))
            chunk = self._chunks.popleft()
            self._cond.notify_all()
            return chunk

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


# ---------------------------------------------------------------------------
# cross-process spool
# ---------------------------------------------------------------------------


def _atomic_write_json(path: str, payload: Dict[str, Any]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def flatten_payload(payload: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A (possibly nested) payload dict as flat ``a.b`` → ndarray pairs for
    npz round-tripping. Scalars become 0-d arrays; strings are rejected
    (chunk payloads are numeric by construction). Keys containing ``"."``
    are rejected outright: the dot is the nesting separator, so a dotted
    leaf key would silently round-trip through :func:`unflatten_payload`
    as a *nested dict*, corrupting the chunk structure."""
    out: Dict[str, np.ndarray] = {}
    for key, value in payload.items():
        if "." in key:
            raise ValueError(
                f"payload key {key!r} contains '.', the flatten separator — "
                "it would unflatten into a nested dict and corrupt the "
                "chunk structure; rename the field"
            )
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten_payload(value, prefix=f"{name}."))
            continue
        arr = np.asarray(value)
        if arr.dtype.kind == "V":  # bf16 etc. — widen exactly for npz
            arr = arr.astype(np.float32)
        out[name] = arr
    return out


def unflatten_payload(arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, arr in arrays.items():
        parts = name.split(".")
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr.item() if arr.ndim == 0 else arr
    return out


class FileExperienceQueue:
    """Spool-directory chunk queue (process mode): one producer (actor
    fleet member), one consumer (the learner).

    Commit protocol: the producer writes ``chunk_<index>.npz`` via tmp +
    ``os.replace`` — a crash mid-write leaves nothing visible. The consumer
    deletes a chunk after loading it and advances ``CURSOR.json``; the
    producer back-pressures while ``next_index − cursor ≥ capacity``.
    """

    CURSOR = "CURSOR.json"
    DONE = "DONE"

    def __init__(
        self,
        root: str,
        capacity: int = 8,
        poll_interval_s: float = 0.02,
        metrics: Any = None,
    ):
        self.root = root
        self.capacity = max(1, int(capacity))
        self.poll = float(poll_interval_s)
        self.metrics = metrics
        os.makedirs(root, exist_ok=True)

    def _chunk_path(self, index: int) -> str:
        return os.path.join(self.root, f"chunk_{index:06d}.npz")

    def cursor(self) -> int:
        """The consumer's next expected index (0 before any consumption)."""
        try:
            with open(os.path.join(self.root, self.CURSOR)) as f:
                return int(json.load(f)["next"])
        except (OSError, ValueError, KeyError):
            return 0

    def committed_indices(self) -> set:
        """Produced-but-unconsumed chunk indices currently in the spool —
        a respawned actor skips these (and everything below the cursor).
        The scan is sorted: consumers today are order-free (membership
        tests), but directory order is filesystem-dependent and a future
        ordered consumer must not inherit it silently."""
        out = set()
        for name in sorted(os.listdir(self.root)):
            if name.startswith("chunk_") and name.endswith(".npz"):
                try:
                    out.add(int(name[len("chunk_"):-len(".npz")]))
                except ValueError:
                    continue
        return out

    def mark_done(self) -> None:
        _atomic_write_json(os.path.join(self.root, self.DONE), {"done": True})

    @property
    def done(self) -> bool:
        return os.path.exists(os.path.join(self.root, self.DONE))

    def put(  # acquires: spool-chunk(object)
        self, chunk: ExperienceChunk, stop: Optional[threading.Event] = None
    ) -> None:
        """Commit one chunk, back-pressuring against the consumer cursor.

        The tmp write is the *stage*, ``os.replace`` the *commit*; the chunk
        then exists in the spool until :meth:`get` consumes it — stage →
        commit → consume, owned by the spool directory between the two."""
        while chunk.index - self.cursor() >= self.capacity:
            if self.done or (stop is not None and stop.is_set()):
                raise QueueClosed("spool closed")
            time.sleep(self.poll)
        arrays = flatten_payload(chunk.payload)
        arrays["__version__"] = np.asarray(chunk.version, np.int64)
        path = self._chunk_path(chunk.index)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)

    def get(  # releases: spool-chunk(object)
        self, index: int, timeout: Optional[float] = None
    ) -> ExperienceChunk:
        """Consume chunk ``index``: wait for its file, load, delete, advance
        the cursor. ``timeout`` bounds the wait (actor-liveness guard)."""
        path = self._chunk_path(index)
        deadline = None if timeout is None else time.monotonic() + timeout
        while not os.path.exists(path):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"no chunk {index} after {timeout:.0f}s — actor dead or "
                    f"stalled? (spool: {self.root})"
                )
            time.sleep(self.poll)
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files}
        version = int(arrays.pop("__version__"))
        os.remove(path)
        _atomic_write_json(os.path.join(self.root, self.CURSOR), {"next": index + 1})
        return ExperienceChunk(index=index, version=version, payload=unflatten_payload(arrays))

    @property
    def depth(self) -> int:
        return len(self.committed_indices())

    def close(self) -> None:
        self.mark_done()
