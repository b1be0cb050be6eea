"""The async collection runtime: chunk dispatch, actor supervision, and the
learner-side ordered drain.

Port of ``trlx_tpu/async_rl/runtime.py``. One :class:`AsyncCollector` per
trainer (built lazily at the first async ``make_experience``). Thread mode
spawns ``num_actors`` actor threads that pull :class:`ChunkSpec`\\ s from a
deterministic dispatcher (the prompt batch and the chunk's per-row
sampling seeds, drawn in index order under the dispatch lock from a copy
of the trainer's rollout seed stream taken when the collector is built —
exactly the draws the serial path makes), gate on the weight channel's
staleness bound, produce chunk payloads through the trainer's
``_async_produce_chunk``, and commit them to the experience queue. Process
mode spawns nothing: remote actors (see ``async_rl/actor.py``) feed a
:class:`FileExperienceQueue` and the collector only consumes.

Actor threads launch their kernels on the current stream of the device,
the learner's stream, so the card runs one program at a time, as in JAX;
the overlap is the actors' host work (string decoding, ``reward_fn``,
device → host landings) and whole collections against the learner's
updates.

Determinism and crash containment:

- the learner finalizes chunks strictly in index order (a reorder buffer
  absorbs multi-actor completion races), so order-sensitive learner state
  (PPO's reward running moments) folds chunks exactly as the serial path
  would;
- a dying actor's in-flight spec is REQUEUED at the front of the dispatch
  queue and a replacement actor thread is spawned — the respawned actor
  regenerates the identical chunk (same prompts, same seeds), so with
  ``max_staleness: 0`` a crash is invisible in the store
  (``tests/test_torch_async_rl.py``). The deterministic
  ``actor_crash@collection:N`` fault drives this path on demand; it fires
  at most once per matching collection (the requeue covers the retry).
"""

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from trlx_tpu_torch.async_rl.queue import ExperienceChunk, QueueClosed
from trlx_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = ["AsyncCollector", "ChunkSpec"]


@dataclass
class ChunkSpec:
    """One unit of actor work, fully determined at dispatch: regenerating a
    spec is bit-deterministic given the same params version."""

    index: int  # global chunk position (finalize order)
    collection: int  # 1-based collection this chunk is expected to feed
    prompt_ids: np.ndarray  # [b, p] raw loader batch (pre group fan-out)
    prompt_mask: np.ndarray
    seeds: np.ndarray  # per-row sampling seeds (the serial path's draws)


class _ActorDied(RuntimeError):
    """Internal: an actor loop failed; its spec has been requeued."""


class AsyncCollector:
    """Actor supervision + ordered learner drain over one queue/channel pair.

    ``trainer`` supplies ``_async_produce_chunk(spec, params, version,
    channel)`` (the device+host half of one chunk), ``_async_spec_seeds
    (stream, rows)`` (a chunk's per-row seeds), its rollout seed stream and
    the prompt iterator; everything order- or state-sensitive stays on the
    learner thread.
    """

    def __init__(
        self,
        trainer: Any,
        queue: Any,
        channel: Any,
        num_actors: int = 1,
        max_staleness: int = 0,
        updates_per_phase: int = 1,
        chunks_per_collection: int = 1,
        spawn_actors: bool = True,
        chunk_timeout_s: float = 300.0,
        max_actor_restarts: int = 3,
        metrics: Any = None,
        tracer: Any = None,
        span: Any = None,
        member_factory: Any = None,
        transport: Any = None,
    ):
        self._trainer = trainer
        self.queue = queue
        self.channel = channel
        self.num_actors = max(1, int(num_actors))
        self.max_staleness = max(0, int(max_staleness))
        self.updates_per_phase = max(1, int(updates_per_phase))
        self.chunks_per_collection = max(1, int(chunks_per_collection))
        self._spawn_actors = spawn_actors
        self._chunk_timeout_s = float(chunk_timeout_s)
        self._max_actor_restarts = int(max_actor_restarts)
        self.metrics = metrics
        self._tracer = tracer
        self._span = span
        # collective transport (async_rl.transport: collective): each actor
        # thread joins the fleet as its own member through member_factory;
        # `transport` is the learner-side FleetCoordinator (stats + elastic
        # membership). With the file/in-memory transports both stay None.
        self._member_factory = member_factory
        self._transport = transport
        self._elastic = transport is not None

        # dispatcher state: prompt/RNG draws happen in spec-index order under
        # this lock, so the draw stream is identical to the serial path's
        self._dispatch_lock = threading.Lock()
        self._retry: List[ChunkSpec] = []  # guarded-by: _dispatch_lock
        # every dispatched-but-unfinalized chunk's spec, by index: the
        # regeneration source for drop_oldest evictions and crash requeues
        self._inflight_specs: Dict[int, ChunkSpec] = {}  # guarded-by: _dispatch_lock
        self._next_index = 0  # guarded-by: _dispatch_lock
        # a copy of the trainer's seed stream at build time: the learner's
        # own draws (evaluation) never interleave with the chunks'
        self._seeds = np.random.RandomState()  # guarded-by: _dispatch_lock
        self._seeds.set_state(trainer._rollout_seeds.get_state())
        self._crash_fired: set = set()  # guarded-by: _dispatch_lock
        self._restarts = 0  # guarded-by: _dispatch_lock
        self._active_actors = 0  # guarded-by: _dispatch_lock
        self._fatal: Optional[BaseException] = None  # guarded-by: _dispatch_lock
        # actor busy/idle accounting (actor_idle_frac)
        self._idle_s = 0.0  # guarded-by: _dispatch_lock
        self._busy_s = 0.0  # guarded-by: _dispatch_lock

        self._stop = threading.Event()
        # respawns append from dying actor threads while close() snapshots
        self._threads: List[threading.Thread] = []  # guarded-by: _dispatch_lock
        self._started = False

        # learner-side (single-threaded) state
        self.version = 0  # completed learner updates (the version clock)
        self._next_finalize = 0
        self._reorder: Dict[int, ExperienceChunk] = {}
        self._col_stats = {"chunks": 0, "staleness_sum": 0.0, "staleness_max": 0.0,
                           "wait_s": 0.0}
        self._col_launches: Dict[str, int] = {}
        # actor busy/idle window start: rolls at each collection_stats()
        # call, so a collection's idle frac covers the whole production
        # window — including chunks produced DURING the previous learn phase
        self._win0 = (0.0, 0.0)

    # ------------------------------------------------------------------
    # dispatch (actor threads; index-ordered draws)
    # ------------------------------------------------------------------

    def _next_spec(self) -> ChunkSpec:
        with self._dispatch_lock:
            if self._retry:
                return self._retry.pop(0)
            batch = next(self._trainer.prompt_iterator)
            ids = np.asarray(batch["input_ids"], np.int64)
            mask = np.asarray(batch["attention_mask"], np.int64)
            spec = ChunkSpec(
                index=self._next_index,
                collection=self._next_index // self.chunks_per_collection + 1,
                prompt_ids=ids,
                prompt_mask=mask,
                seeds=self._trainer._async_spec_seeds(self._seeds, ids.shape[0]),
            )
            self._inflight_specs[spec.index] = spec
            self._next_index += 1
            return spec

    def _requeue(self, spec: ChunkSpec) -> None:
        with self._dispatch_lock:
            self._retry.insert(0, spec)
        if self.metrics is not None:
            self.metrics.inc("async/requeued_chunks")

    def requeue_dropped(self, chunk: ExperienceChunk) -> None:
        """A drop_oldest eviction lost this chunk's DATA; its spec is still
        in flight, so the next free actor regenerates the index under
        fresher params — the learner's in-order drain depends on every
        index eventually arriving."""
        with self._dispatch_lock:
            spec = self._inflight_specs.get(chunk.index)
            if spec is not None:
                self._retry.insert(0, spec)
        if spec is not None and self.metrics is not None:
            self.metrics.inc("async/requeued_chunks")

    def _maybe_inject_crash(self, spec: ChunkSpec) -> None:
        plan = getattr(self._trainer.resilience, "plan", None)
        if not plan:
            return
        with self._dispatch_lock:
            if spec.collection in self._crash_fired:
                return
            if not plan.poll("actor_crash", collection=spec.collection):
                return
            self._crash_fired.add(spec.collection)
        from trlx_tpu_torch.resilience.faults import InjectedFault

        raise InjectedFault(
            f"fault plan: actor crash in collection {spec.collection} "
            f"(chunk {spec.index})"
        )

    # ------------------------------------------------------------------
    # actor threads
    # ------------------------------------------------------------------

    def _actor_loop(self, actor_id: int) -> None:
        if self._tracer is not None and hasattr(self._tracer, "alias_current_thread"):
            self._tracer.alias_current_thread(f"async actor {actor_id}")
        # collective transport: this thread joins the fleet as its own
        # member — the in-process fleet exercises the same wire protocol
        # (tree deltas, in-fabric commits) as a pod's actor processes. A
        # failed join is an actor death (supervised: restart/shrink/fatal),
        # not a silently-vanished thread.
        client = None
        try:
            if self._member_factory is not None:
                client = self._member_factory(actor_id)
        except BaseException as e:
            raise _ActorDied(
                f"actor {actor_id} failed to join the fleet"
            ) from e
        channel = client if client is not None else self.channel
        queue = client if client is not None else self.queue
        try:
            while not self._stop.is_set():
                spec = self._next_spec()
                t_gate = time.perf_counter()
                if not channel.wait_ready(
                    self.max_staleness, spec.collection, stop=self._stop,
                    index=spec.index,
                ):
                    self._requeue(spec)  # shutdown: leave the spec for nobody
                    return
                params, version = channel.fetch()
                gate_s = time.perf_counter() - t_gate
                try:
                    self._maybe_inject_crash(spec)
                    t0 = time.perf_counter()
                    if self._span is not None:
                        with self._span(
                            "async/actor_chunk", index=spec.index, version=version
                        ):
                            payload = self._trainer._async_produce_chunk(
                                spec, params, version, channel
                            )
                    else:
                        payload = self._trainer._async_produce_chunk(
                            spec, params, version, channel
                        )
                    busy_s = time.perf_counter() - t0
                except BaseException as e:
                    self._requeue(spec)
                    raise _ActorDied(
                        f"actor {actor_id} died on chunk {spec.index}"
                    ) from e
                t_put = time.perf_counter()
                try:
                    queue.put(ExperienceChunk(spec.index, version, payload))
                except QueueClosed:
                    return
                with self._dispatch_lock:
                    self._idle_s += gate_s + (time.perf_counter() - t_put)
                    self._busy_s += busy_s
                if self.metrics is not None and client is None:
                    # collective transport counts arrivals coordinator-side
                    self.metrics.inc("async/chunks")
        finally:
            if client is not None:
                client.close()

    def _actor_main(self, actor_id: int) -> None:
        died: Optional[_ActorDied] = None
        try:
            self._actor_loop(actor_id)
        except _ActorDied as e:
            died = e
        except QueueClosed:
            pass
        respawn = shrink = False
        with self._dispatch_lock:
            # the live-actor count is maintained under THIS lock (never
            # inferred from thread liveness): two actors dying at once
            # serialize here, so the second one to arrive sees an empty
            # fleet and goes fatal instead of both "shrinking" to zero
            self._active_actors -= 1
            if died is not None and not self._stop.is_set():
                self._restarts += 1
                if self._restarts <= self._max_actor_restarts:
                    respawn = True
                elif self._elastic and self._active_actors > 0:
                    # elastic membership: restarts are exhausted but the
                    # fleet still has live members — SHRINK instead of
                    # killing the run. The dead actor's spec is already
                    # requeued; a survivor regenerates it identically.
                    shrink = True
                else:
                    self._fatal = died.__cause__ or died
        if respawn:
            if self.metrics is not None:
                self.metrics.inc("async/actor_restarts")
            self._spawn(actor_id)
        elif shrink:
            if self.metrics is not None:
                self.metrics.inc("async/fleet_shrinks")
            logger.warning(
                f"async_rl: actor {actor_id} died with restarts "
                "exhausted; fleet shrinks and survivors take over its "
                "chunks"
            )

    def _spawn(self, actor_id: int) -> None:
        thread = threading.Thread(
            target=self._actor_main,
            args=(actor_id,),
            name=f"trlx-async-actor-{actor_id}",
            daemon=True,
        )
        with self._dispatch_lock:
            self._threads.append(thread)
            self._active_actors += 1
        thread.start()

    def _ensure_started(self) -> None:
        if self._started or not self._spawn_actors:
            return
        self._started = True
        for actor_id in range(self.num_actors):
            self._spawn(actor_id)

    # ------------------------------------------------------------------
    # learner side (single thread)
    # ------------------------------------------------------------------

    def on_update(self, params: Any, version: int) -> None:
        """Called by the trainer after every optimizer update: advance the
        version clock and publish a snapshot of the policy (thinned by the
        channel's sync_every)."""
        self.version = int(version)
        self.channel.publish(params, version)

    def _consuming_collection(self) -> int:
        """The collection index the NEXT consumed chunk belongs to — drives
        the gate's collection-scoped announcements."""
        return self._next_finalize // self.chunks_per_collection + 1

    def begin_collection(self) -> None:
        """Drain is about to start: force-publish the CURRENT params at the
        current version and announce that this collection is being consumed
        NOW. This heals dropped publishes and over-estimated phase targets
        (the gate can never deadlock), and in the ``max_staleness: 0`` case
        hands actors exactly the params this collection will be consumed
        under."""
        self.channel.publish(self._trainer.model, self.version, force=True)
        self.channel.announce(self.version, self._consuming_collection())
        self._col_stats = {"chunks": 0, "staleness_sum": 0.0, "staleness_max": 0.0,
                           "wait_s": 0.0}
        self._col_launches = {}
        self._ensure_started()

    def end_collection(self) -> None:
        """Drain finished: announce the NEXT collection's consumption point
        — the end of the upcoming learn phase. Actors may not start that
        collection's chunks any earlier (production never runs more than
        one collection ahead), and its chunks gate on this target."""
        self.channel.announce(
            self.version + self.updates_per_phase, self._consuming_collection()
        )

    def _check_fatal(self) -> None:
        with self._dispatch_lock:
            fatal = self._fatal
        if fatal is not None:
            self.close()
            raise fatal

    def next_chunk(self) -> ExperienceChunk:
        """The next chunk in strict index order (blocks; reorder buffer
        absorbs multi-actor completion races). Records staleness at
        consumption."""
        indexed_get = hasattr(self.queue, "committed_indices")  # file spool
        t0 = time.perf_counter()
        while self._next_finalize not in self._reorder:
            self._check_fatal()
            # top-up: empty-response rows can push a drain past its
            # estimated chunk count into the next collection's index range —
            # grant the one needed chunk, which starts under the weights it
            # is consumed with (a no-op whenever the begin/end announcements
            # already free it). JAX announces the next collection at the
            # current version instead, which frees all of that collection's
            # chunks under stale weights.
            self.channel.grant(self._next_finalize)
            try:
                if indexed_get:
                    chunk = self.queue.get(
                        self._next_finalize, timeout=self._chunk_timeout_s
                    )
                else:
                    chunk = self.queue.get(timeout=1.0)
            except TimeoutError:
                if indexed_get:
                    raise
                continue  # thread mode: loop to re-check actor failures
            self._reorder[chunk.index] = chunk
        self._col_stats["wait_s"] += time.perf_counter() - t0
        chunk = self._reorder.pop(self._next_finalize)
        with self._dispatch_lock:
            self._inflight_specs.pop(self._next_finalize, None)
        self._next_finalize += 1
        if hasattr(self.queue, "note_finalized"):
            # collective transport: the finalize floor widens the fleet's
            # production window and prunes remote spec caches
            self.queue.note_finalized(self._next_finalize)
        staleness = float(max(self.version - chunk.version, 0))
        # a process-mode actor reports the kernel launches its chunk made
        # (its own process's counters: nothing else launches there)
        for name, n in (chunk.payload.pop("actor_launches", None) or {}).items():
            self._col_launches[name] = self._col_launches.get(name, 0) + int(n)
        self._col_stats["chunks"] += 1
        self._col_stats["staleness_sum"] += staleness
        self._col_stats["staleness_max"] = max(
            self._col_stats["staleness_max"], staleness
        )
        if self.metrics is not None:
            self.metrics.observe("async/staleness", staleness)
        return chunk

    def collection_stats(self) -> Dict[str, float]:
        """The async/* gauges of the collection just drained."""
        col = self._col_stats
        n = max(col["chunks"], 1)
        with self._dispatch_lock:
            idle = self._idle_s - self._win0[0]
            busy = self._busy_s - self._win0[1]
            self._win0 = (self._idle_s, self._busy_s)
        stats: Dict[str, float] = {}
        stats["async/chunks"] = float(col["chunks"])
        stats["async/staleness_mean"] = col["staleness_sum"] / n
        stats["async/staleness_max"] = col["staleness_max"]
        stats["async/learner_wait_s"] = col["wait_s"]
        stats["async/queue_depth"] = float(self.queue.depth)
        if idle + busy > 0:
            stats["async/actor_idle_frac"] = idle / (idle + busy)
        for name, n in sorted(self._col_launches.items()):
            stats[f"async/actor_launches/{name}"] = float(n)
        if self._transport is not None:
            # fleet transport gauges: fleet size, learner publish egress,
            # ack-measured tree latency
            stats.update(self._transport.window_stats())
        return stats

    def fleet_size(self) -> Optional[int]:
        """Live collective-fleet member count (``None`` off-fleet) — rides
        the cluster telemetry beat as ``cluster/fleet_size``."""
        if self._transport is None:
            return None
        return self._transport.fleet_size()

    def close(self) -> None:
        """Stop actors, wake anything blocked, join threads. Idempotent."""
        self._stop.set()
        try:
            self.channel.close()
        except Exception:  # pragma: no cover - defensive
            pass
        try:
            self.queue.close()
        except Exception:  # pragma: no cover - defensive
            pass
        with self._dispatch_lock:
            threads = list(self._threads)
        for thread in threads:
            thread.join(timeout=10)
        leaked = [t.name for t in threads if t.is_alive()]
        if leaked:  # pragma: no cover - requires a wedged actor
            # a worker stuck past the join deadline is exactly what the
            # tests' leaked-thread sentinel fails on — name it loudly in
            # production too instead of leaking silently
            logger.warning(
                f"async_rl: actor thread(s) {leaked} did not join within "
                "10s — wedged in generation or a host call; they are daemon "
                "threads and die with the process, but this run leaked them"
            )
