"""Bounded-depth software pipeline for experience collection.

Port of ``trlx_tpu/pipeline/rollout_pipeline.py``. A rollout chunk has a device side (generation and the scoring
forward, dispatched by the main thread) and a host side (waiting for the
landed outputs, string decoding, ``reward_fn``) that needs nothing from
the device beyond those outputs. Serially, the device idles while the host
scores chunk *k*; pipelined, the main thread dispatches chunk *k+1*'s
generation while a background worker drains chunk *k*'s host work. Within
one collection the policy never changes, so the overlap is exactly
equivalent to the serial schedule.

:class:`RolloutPipeline` is the chunk state machine behind that overlap:

- **one** worker thread runs submitted ``work()`` closures FIFO, so
  completion order equals submission order;
- a chunk is *in flight* from ``submit()`` until its ``finalize``
  callback returns; ``submit()`` blocks while ``depth`` chunks are in
  flight (at most ``depth`` chunks of host arrays coexist);
- ``finalize(result)`` runs on the **submitting** thread, in submission
  order — the home of sequential dependencies (PPO's running moments)
  that must see chunks in the serial path's order;
- a worker exception propagates to the submitting thread on the next
  ``submit()``/``drain()`` with its traceback, after which the pipeline
  cancels remaining work and joins the worker;
- overlap accounting: ``host_work_s`` (time inside ``work()``) and
  ``wait_s`` (time the submitting thread blocked on the pipeline) give
  ``throughput/rollout_overlap_frac`` = host work hidden behind device
  work ÷ the collection's wall time;
- with a ``tracer`` (``observability/tracing.py``), the worker's spans go
  to one named track (``<name> pipeline worker``) across collections, and
  the time the submitting thread blocks on the pipeline is recorded as
  ``<name>/device_idle`` spans.
"""

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

__all__ = ["RolloutPipeline", "PipelineStats"]

_END = object()  # worker shutdown sentinel


@dataclass
class PipelineStats:
    """Aggregate timing of one pipeline lifetime (seconds)."""

    depth: int = 0
    chunks: int = 0
    host_work_s: float = 0.0  # time inside work() on the worker
    # time the submitting thread blocked on the worker (submit backpressure
    # and drain): host work NOT hidden behind device work
    wait_s: float = 0.0
    chunk_host_s: List[float] = field(default_factory=list)

    @property
    def overlap_s(self) -> float:
        """Host work hidden behind the submitting thread's device work."""
        return max(0.0, self.host_work_s - self.wait_s)

    def overlap_frac(self, total_s: float) -> float:
        """``overlap_s`` over a caller-supplied wall time."""
        if total_s <= 0.0:
            return 0.0
        return min(1.0, self.overlap_s / total_s)


class _Chunk:
    __slots__ = ("work", "result", "error")

    def __init__(self, work: Callable[[], Any]):
        self.work = work
        self.result: Any = None
        self.error: Optional[BaseException] = None


class _Cancelled(Exception):
    """A chunk retired un-run after an earlier failure."""


class RolloutPipeline:
    """Single-worker, bounded in-flight chunk pipeline with ordered drain::

        with RolloutPipeline(depth=2, finalize=fold_into_store) as pipe:
            while more_chunks:
                dev = dispatch_device_work()               # main thread
                pipe.submit(lambda d=dev: host_work(d))    # worker thread
        # __exit__ drains: every finalize has run, the worker is joined
    """

    def __init__(self, depth: int = 2, finalize: Optional[Callable[[Any], Any]] = None,
                 name: str = "rollout", tracer: Any = None):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.depth = depth
        self.name = name
        # the worker writes host_work_s / chunk_host_s while the submitting
        # thread writes wait_s / chunks: every stats mutation takes the lock
        self._stats_lock = threading.Lock()
        self.stats = PipelineStats(depth=depth)
        self._finalize = finalize
        self._tracer = tracer
        self._todo: "queue.Queue" = queue.Queue()
        self._done: "queue.Queue" = queue.Queue()
        self._cancel = threading.Event()
        self._in_flight = 0
        self._failed: Optional[_Chunk] = None
        self._closed = False
        self._worker = threading.Thread(target=self._worker_loop,
                                        name=f"trlx-{name}-pipeline", daemon=True)
        self._worker.start()

    # -- worker side ----------------------------------------------------

    def _worker_loop(self) -> None:
        if self._tracer is not None:
            # one stable track per role, whichever thread runs it
            self._tracer.alias_current_thread(f"{self.name} pipeline worker")
        while True:
            chunk = self._todo.get()
            if chunk is _END:
                return
            if self._cancel.is_set():
                # an earlier chunk failed: retire without running, so a
                # blocked submit/drain still wakes
                chunk.error = _Cancelled()
                self._done.put(chunk)
                continue
            t0 = time.perf_counter()
            try:
                chunk.result = chunk.work()
            except BaseException as e:  # raised again on the submitting thread
                chunk.error = e
                self._cancel.set()
            finally:
                dt = time.perf_counter() - t0
                with self._stats_lock:
                    self.stats.host_work_s += dt
                    self.stats.chunk_host_s.append(dt)
            self._done.put(chunk)

    # -- submitting-thread side -----------------------------------------

    def _retire_one(self, block: bool) -> bool:
        """Finalize the next completed chunk; False when none was ready."""
        try:
            if block:
                t0 = time.perf_counter()
                if self._tracer is not None:
                    with self._tracer.span(f"{self.name}/device_idle"):
                        chunk = self._done.get()
                else:
                    chunk = self._done.get()
                with self._stats_lock:
                    self.stats.wait_s += time.perf_counter() - t0
            else:
                chunk = self._done.get_nowait()
        except queue.Empty:
            return False
        self._in_flight -= 1
        if chunk.error is not None:
            if not isinstance(chunk.error, _Cancelled):
                self._failed = self._failed or chunk
            return True
        # chunks completed before a failure still finalize, in order
        if self._failed is None:
            try:
                if self._finalize is not None:
                    self._finalize(chunk.result)
                with self._stats_lock:
                    self.stats.chunks += 1
            except BaseException:
                self._cancel.set()
                raise
        return True

    def _raise_failed(self) -> None:
        if self._failed is not None:
            err = self._failed.error
            self._failed = None
            self.close()
            raise err

    def submit(self, work: Callable[[], Any]) -> None:
        """Enqueue one chunk's host work; blocks (finalizing completed
        chunks in order) while ``depth`` chunks are in flight. Raises an
        earlier chunk's exception instead of taking new work."""
        if self._closed:
            raise RuntimeError("submit() on a closed RolloutPipeline")
        while self._retire_one(block=False):
            pass
        while self._in_flight >= self.depth:
            self._retire_one(block=True)
        self._raise_failed()
        self._in_flight += 1
        self._todo.put(_Chunk(work))

    def drain(self) -> None:
        """Block until every submitted chunk is finalized (or a failure is
        raised); ``__exit__`` calls it on success."""
        while self._in_flight > 0:
            self._retire_one(block=True)
        self._raise_failed()

    @property
    def in_flight(self) -> int:
        return self._in_flight

    def close(self) -> None:
        """Cancel outstanding work and join the worker; idempotent, never
        raises. Chunks not yet finalized are dropped."""
        if self._closed:
            return
        self._closed = True
        self._cancel.set()
        self._todo.put(_END)
        self._worker.join(timeout=30)
        while True:
            try:
                self._done.get_nowait()
                self._in_flight -= 1
            except queue.Empty:
                break

    def __enter__(self) -> "RolloutPipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            try:
                self.drain()
            finally:
                self.close()
        else:
            # the submitting thread failed: cancel and join, the original
            # error propagates
            self.close()
