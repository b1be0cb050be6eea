"""Span tracer: nested host wall-time spans with CUDA fences.

Port of ``trlx_tpu/observability/tracing.py``. CUDA launches return before
the card has run them, so a bare host timer reads launch latency. A
:class:`Span` therefore takes an optional **fence**: tensors (or a callable
returning them, or ``torch.cuda.Event`` objects) whose work must be done
before the span closes. Fencing tensors records a ``torch.cuda.Event`` on
the current stream of each fenced CUDA tensor's device (for a callable: at
span exit), and the span synchronizes on those events at exit, so the
recorded duration covers the card's work queued up to the fence: the
counterpart of ``jax.block_until_ready``. A fence on CPU tensors is a
no-op; a span whose work already waited on the card (a host read of its
results) pays only the events' record and an immediate return.

Spans nest (a thread-local stack), carry the process's rank as their
Chrome-trace ``pid`` (``torch.distributed.get_rank()`` when a group is
initialized, else 0), and export two ways:

- :meth:`Tracer.export_jsonl` — one JSON object per span;
- :meth:`Tracer.export_chrome_trace` — a Chrome/Perfetto ``trace.json``
  (complete ``"ph": "X"`` events; containment on one ``tid`` renders as
  nesting).

Usage::

    from trlx_tpu_torch.observability import span

    with span("rollout"):
        with span("generate") as sp:
            out = generate(...)
            sp.fence(out.sequences)   # wait for the card at exit
"""

import json
import os
import threading
import time
import zlib
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import torch

FenceLike = Union[None, Any, Callable[[], Any]]


def process_index() -> int:
    """This process's rank in an initialized ``torch.distributed`` group,
    else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def process_count() -> int:
    """The initialized ``torch.distributed`` group's size, else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, name))


def _events(tree: Any) -> List[Any]:
    """One event recorded now on the current stream of every CUDA device
    among ``tree``'s tensors, plus the events ``tree`` holds itself."""
    if isinstance(tree, torch.cuda.Event):
        return [tree]
    if isinstance(tree, (list, tuple)) and any(isinstance(x, torch.cuda.Event) for x in tree):
        return [e for x in tree for e in _events(x)]
    events = []
    for device in {t.device for t in _tensors(tree) if t.is_cuda}:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        events.append(event)
    return events


class Span:
    """One timed region. ``duration`` is valid after the span closes."""

    __slots__ = ("name", "depth", "args", "t0", "t1", "_fence", "_events")

    def __init__(self, name: str, depth: int, args: Optional[Dict[str, Any]] = None):
        self.name = name
        self.depth = depth
        self.args = args or {}
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self._fence: FenceLike = None
        self._events: List[Any] = []

    def fence(self, tree: FenceLike) -> "Span":
        """Fence on ``tree``: tensors (their device work queued so far is
        waited for at exit), events, or a callable returning either,
        evaluated at exit."""
        if callable(tree):
            self._fence = tree
        elif tree is not None:
            self._events.extend(_events(tree))
        return self

    @property
    def duration(self) -> float:
        """Seconds, device-fenced if a fence was set. 0.0 while open."""
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def close(self) -> float:
        if self._fence is not None:
            self._events.extend(_events(self._fence()))
        for event in self._events:
            event.synchronize()
        self.t1 = time.perf_counter()
        return self.duration


class Tracer:
    """Collects closed spans as Chrome-trace-shaped events.

    Thread-safe for recording; the span stack is thread-local, so spans
    opened on different threads nest independently. The event buffer holds
    at most ``max_events``; past the cap events are dropped and counted
    (``dropped``), while the listeners (the flight recorder) still see
    every one.
    """

    def __init__(self, enabled: bool = True, max_events: int = 200_000):
        self.enabled = enabled
        self.max_events = max_events
        self._lock = threading.Lock()
        self.dropped = 0  # guarded-by: _lock
        self._events: List[Dict[str, Any]] = []  # guarded-by: _lock
        self._local = threading.local()
        self._epoch = time.perf_counter()
        self._last_duration: Dict[str, float] = {}  # guarded-by: _lock
        self._listeners: List[Callable[[Dict[str, Any]], None]] = []  # guarded-by: _lock
        self._aliased: set = set()  # guarded-by: _lock

    # -- recording ------------------------------------------------------

    def _stack(self) -> List[Span]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def _tid(self) -> int:
        return getattr(self._local, "tid", None) or threading.get_ident() % 2**31

    def alias_current_thread(self, alias: str) -> None:
        """Record this thread's events under a stable pseudo-tid derived
        from ``alias``: the workers of one role (a rollout pipeline's, one
        per collection) share one named track in the Perfetto export."""
        self._local.tid = self._track_tid(alias)

    @contextmanager
    def span(self, name: str, fence: FenceLike = None, **args: Any) -> Iterator[Span]:
        """Open a nested span; it closes (and waits on its fence) at exit,
        on an error too."""
        stack = self._stack()
        sp = Span(name, depth=len(stack), args=args)
        if fence is not None:
            sp.fence(fence)
        stack.append(sp)
        try:
            yield sp
        finally:
            # remove this span, not blindly the top: an exception unwinding
            # past a manually entered inner span must not corrupt the depths
            if sp in stack:
                stack.remove(sp)
            dur = sp.close()
            with self._lock:
                self._last_duration[name] = dur
            if self.enabled:
                self._record(sp)

    def instant(self, name: str, **args: Any) -> None:
        """A zero-duration marker event (Chrome-trace ``"ph": "i"``)."""
        if not self.enabled:
            return
        event = {"name": name, "ph": "i", "ts": (time.perf_counter() - self._epoch) * 1e6,
                 "pid": process_index(), "tid": self._tid(), "s": "t"}
        if args:
            event["args"] = args
        self._append(event)

    def _record(self, sp: Span) -> None:
        event = {"name": sp.name, "ph": "X", "ts": (sp.t0 - self._epoch) * 1e6,
                 "dur": (sp.t1 - sp.t0) * 1e6, "pid": process_index(), "tid": self._tid()}
        if sp.args:
            event["args"] = dict(sp.args)
        self._append(event)

    def _append(self, event: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
            else:
                self._events.append(event)
            listeners = list(self._listeners)
        # outside the lock; a listener never breaks recording
        for fn in listeners:
            try:
                fn(event)
            except Exception:  # pragma: no cover - defensive
                pass

    def add_listener(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        """Subscribe to every recorded (or cap-dropped) event."""
        with self._lock:
            self._listeners.append(fn)

    def _track_tid(self, alias: str) -> int:
        """Stable pseudo-tid of a named track; emits the labelling
        ``thread_name`` metadata event once per alias."""
        tid = zlib.crc32(alias.encode()) % 2**31 or 1
        if not self.enabled:
            return tid
        with self._lock:
            if alias in self._aliased:
                return tid
            self._aliased.add(alias)
        self._append({"name": "thread_name", "ph": "M", "pid": process_index(), "tid": tid,
                      "args": {"name": alias}})
        return tid

    def add_complete_event(self, name: str, t0: float, t1: float,
                           track: Optional[str] = None, **args: Any) -> None:
        """Record a complete (``"ph": "X"``) event with explicit
        ``time.perf_counter`` endpoints: spans known only afterwards (an
        engine request's queue wait → prefill → decode, emitted at
        harvest). ``track`` names a stable pseudo-thread row."""
        if not self.enabled:
            return
        event: Dict[str, Any] = {
            "name": name, "ph": "X", "ts": (t0 - self._epoch) * 1e6,
            "dur": max(t1 - t0, 0.0) * 1e6, "pid": process_index(),
            "tid": self._track_tid(track) if track else self._tid(),
        }
        if args:
            event["args"] = dict(args)
        self._append(event)

    # -- reading / export ----------------------------------------------

    def last_duration(self, name: str, default: float = 0.0) -> float:
        """Duration of the most recently closed span named ``name``."""
        with self._lock:
            return self._last_duration.get(name, default)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self.dropped = 0

    def to_chrome_trace(self) -> Dict[str, Any]:
        with self._lock:
            dropped = self.dropped
        meta = {"dropped_events": dropped} if dropped else {}
        return {"traceEvents": self.events(), "displayTimeUnit": "ms", **meta}

    def export_chrome_trace(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path

    def export_jsonl(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            for e in self.events():
                if e.get("ph") == "M":  # track labels: trace-only
                    continue
                record = {"name": e["name"], "start_s": e["ts"] / 1e6,
                          "dur_s": e.get("dur", 0.0) / 1e6, "pid": e["pid"], "tid": e["tid"]}
                if "args" in e:
                    record["args"] = e["args"]
                f.write(json.dumps(record) + "\n")
        return path


# the module-level default tracer (library users without a trainer)
_DEFAULT_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _DEFAULT_TRACER


@contextmanager
def span(name: str, fence: FenceLike = None, **args: Any) -> Iterator[Span]:
    """``with span("rollout"): ...`` on the module-level default tracer."""
    with _DEFAULT_TRACER.span(name, fence=fence, **args) as sp:
        yield sp
