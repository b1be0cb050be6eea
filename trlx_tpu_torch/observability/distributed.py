"""Distributed observability: the cross-rank telemetry beat,
straggler and desync detection, and merged multi-rank Perfetto traces.

Port of ``trlx_tpu/observability/distributed.py``. Every other telemetry
surface is per process; a slow or desynced rank stalls every other rank
without any of them seeing why. Three pieces:

**Cross-rank beat**: :class:`ClusterTelemetry` packs a small vector of
per-rank scalars (the preemption flag, the step counter, step time, host
wait, tokens/s, device memory, a clock stamp, the fleet size) and gathers
it once per step boundary. The default gather is
``torch.distributed.all_gather`` over the initialized group (gloo or
NCCL), and local when no group is initialized; tests inject their own.
``cluster/*`` gauges (min/mean/max/skew) come from the gathered matrix.

**Straggler and desync detection**: a rank whose step time exceeds the
median of its peers (``straggler_factor`` ×, for ``straggler_patience``
beats in a row) is named in ``cluster/straggler_rank`` (−1 when healthy),
with a warning and a flight-recorder event. The per-rank step counters can
diverge only if a rank skipped or replayed a boundary, which raises
:class:`ClusterDesyncError` at once.

**Merged timelines**: each beat estimates the ranks' clock offsets from
the shared barrier stamps (``offset_k = ts_0 − ts_k``, median over beats).
At export, ranks other than 0 write ``trace_rank<k>.json`` into the shared
trace directory and rank 0 merges every rank's events, shifted onto its
clock, into one ``trace.json``.

``TRLX_TPU_CLUSTER_TELEMETRY=0`` turns the analysis off but not the
collective: whether a beat posts the gather depends only on the
rank-uniform ``collective`` argument, never on a per-process variable, so
one mis-launched rank cannot post a mismatched collective.
``TRLX_TPU_TRACE_MERGE_WAIT_S`` bounds rank 0's wait for the peers' trace
files (15 s by default; a missing rank is noted in the merged trace).
"""

import json
import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import torch

from trlx_tpu_torch.observability.tracing import process_count
from trlx_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# the packed per-rank beat vector, one float32 per field (step counters are
# exact to 2**24)
PACK_FIELDS = (
    "preempt",  # 1.0 when this rank requested preemption
    "step",  # completed-update counter (desync check)
    "step_time_s",  # last fenced train-step seconds
    "host_wait_s",  # beat-to-beat wall time minus step time
    "tokens_per_sec",  # last step's throughput
    "device_bytes",  # device bytes in use (host RSS on CPU)
    "clock_s",  # clock fine part: (perf_counter − epoch) mod _CLOCK_COARSE_S
    "clock_hi_s",  # clock coarse part: the subtracted _CLOCK_COARSE_S multiple
    "fleet_size",  # live async actor-fleet members (−1: no fleet on this rank)
)

# The clock stamp is split coarse+fine so float32 packing stays sub-ms for
# arbitrarily long runs: a single f32 seconds-since-epoch loses ~12 ms of
# resolution by day 3 (ulp at 2e5 s), which would mis-shift the merged
# trace by more than the engine stalls it attributes. The coarse part is an
# exact-f32 multiple of 1024 s; the fine part stays < 1024 s (ulp ≤ 61 µs).
_CLOCK_COARSE_S = 1024.0

DEFAULT_STRAGGLER_FACTOR = 1.5
DEFAULT_STRAGGLER_MIN_S = 0.05
DEFAULT_STRAGGLER_PATIENCE = 2
_OFFSET_WINDOW = 64


class ClusterDesyncError(RuntimeError):
    """Per-rank step counters diverged at a shared step boundary — a rank
    skipped or replayed an update. Continuing would turn into a silent
    collective mismatch/hang; failing here names the ranks instead."""


def _default_allgather(vec: np.ndarray) -> np.ndarray:
    """``[K] -> [P, K]`` over the initialized ``torch.distributed`` group
    (CUDA tensors under NCCL, CPU ones otherwise)."""
    import torch.distributed as dist

    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    local = torch.as_tensor(vec, dtype=torch.float32, device=device)
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    return torch.stack(parts).cpu().numpy()


class ClusterTelemetry:
    """Per-trainer cross-rank telemetry beat (see module docstring).

    ``allgather`` is injectable for tests (a callable ``[K] -> [P, K]``);
    the default is ``torch.distributed.all_gather`` when a group is
    initialized, and local (a one-row matrix) when none is.
    """

    def __init__(
        self,
        tracer: Any,
        metrics: Any,
        flightrec: Any = None,
        straggler_factor: float = DEFAULT_STRAGGLER_FACTOR,
        straggler_min_s: float = DEFAULT_STRAGGLER_MIN_S,
        straggler_patience: int = DEFAULT_STRAGGLER_PATIENCE,
        allgather: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        enabled: Optional[bool] = None,
    ):
        if enabled is None:
            enabled = os.environ.get("TRLX_TPU_CLUSTER_TELEMETRY", "1") != "0"
        self.enabled = enabled
        self.tracer = tracer
        self.metrics = metrics
        self.flightrec = flightrec
        self.straggler_factor = float(straggler_factor)
        self.straggler_min_s = float(straggler_min_s)
        self.straggler_patience = int(straggler_patience)
        self._allgather = allgather
        self.beats = 0
        self.straggler_rank = -1
        self._exceed_counts: Dict[int, int] = {}
        self._offsets: Dict[int, deque] = {}
        self._last_step: Dict[str, float] = {
            "step_time_s": 0.0,
            "tokens_per_sec": 0.0,
            "device_bytes": 0.0,
        }
        self._fleet_size = -1.0
        self._last_beat_t: Optional[float] = None

    # -- feeding ---------------------------------------------------------

    def note_step(
        self,
        step_time_s: float,
        tokens_per_sec: float = 0.0,
        device_bytes: float = 0.0,
    ) -> None:
        """Record the just-completed step's scalars; the NEXT beat (the
        boundary before the following update) exchanges them."""
        self._last_step = {
            "step_time_s": float(step_time_s),
            "tokens_per_sec": float(tokens_per_sec),
            "device_bytes": float(device_bytes),
        }

    def note_fleet(self, size: Optional[int]) -> None:
        """Record this rank's live async actor-fleet size (``None`` = no
        collective fleet here). The membership gauge rides the NEXT beat's
        packed vector — the same allgather as everything else, so elastic
        fleet visibility adds zero new sync points."""
        self._fleet_size = -1.0 if size is None else float(size)

    # -- the beat --------------------------------------------------------

    def beat(self, requested: bool, step: int, collective: bool = True) -> bool:
        """One step-boundary exchange. Returns True when any rank has
        requested preemption (slot 0 of the packed vector).

        ``collective=False`` keeps the beat local: gauges publish from this
        rank's own scalars and no collective is posted. Whether the gather
        is posted depends only on ``collective`` (rank-uniform), never on
        ``self.enabled`` (the per-process ``TRLX_TPU_CLUSTER_TELEMETRY``):
        a disabled rank still posts the same gather and skips only the
        analysis, so no rank can post a mismatched collective.
        """
        if not self.enabled and not collective:
            return bool(requested)
        now = time.perf_counter()
        step_time = self._last_step["step_time_s"]
        host_wait = 0.0
        if self._last_beat_t is not None:
            host_wait = max(0.0, (now - self._last_beat_t) - step_time)
        self._last_beat_t = now
        clock = now - getattr(self.tracer, "_epoch", 0.0)
        clock_hi = float(np.floor(clock / _CLOCK_COARSE_S) * _CLOCK_COARSE_S)
        vec = np.asarray(
            [
                float(bool(requested)),
                float(step),
                step_time,
                host_wait,
                self._last_step["tokens_per_sec"],
                self._last_step["device_bytes"],
                clock - clock_hi,
                clock_hi,
                self._fleet_size,
            ],
            np.float32,
        )
        gather = self._allgather
        if gather is None and collective and process_count() > 1:
            gather = _default_allgather
        if gather is not None:
            matrix = np.asarray(gather(vec), np.float32).reshape(
                -1, len(PACK_FIELDS)
            )
        else:
            matrix = vec[None]
        if not self.enabled:
            # coordination-only beat: this rank posted the SAME collective
            # as its enabled peers (payload shapes must match rank-for-rank)
            # but skips the analysis/publishing half entirely
            return bool(matrix[:, 0].any())
        self.beats += 1
        self._check_desync(matrix)
        # clock offsets: every rank stamped its clock immediately before the
        # same barrier — offset_k maps rank k's tracer timeline onto rank
        # 0's (median over beats absorbs per-beat arrival skew). Coarse and
        # fine parts recombine in float64.
        clocks = matrix[:, 6].astype(np.float64) + matrix[:, 7].astype(
            np.float64
        )
        for k in range(matrix.shape[0]):
            self._offsets.setdefault(k, deque(maxlen=_OFFSET_WINDOW)).append(
                float(clocks[0] - clocks[k])
            )
        self._publish(matrix)
        return bool(matrix[:, 0].any())

    # -- analysis --------------------------------------------------------

    def _check_desync(self, matrix: np.ndarray) -> None:
        steps = matrix[:, 1].astype(np.int64)
        if len(set(steps.tolist())) <= 1:
            return
        detail = ", ".join(f"rank {k}: step {int(s)}" for k, s in enumerate(steps))
        if self.flightrec is not None:
            self.flightrec.record(
                "desync", {"steps": steps.tolist(), "beat": self.beats}
            )
        raise ClusterDesyncError(
            f"per-rank step counters diverged at a shared step boundary "
            f"({detail}) — a rank skipped or replayed an update; continuing "
            f"would become a silent collective mismatch. Check for "
            f"per-rank conditionals around train_step / checkpoint restore "
            f"(the JAX package's docs/OBSERVABILITY.md 'Distributed telemetry')."
        )

    def _detect_straggler(self, step_times: np.ndarray) -> int:
        """Flag the lowest rank whose step time exceeded the median of its
        PEERS (excluding itself — with 2 ranks the straggler would halve
        its own threshold otherwise) for ``straggler_patience`` consecutive
        beats. −1 when healthy."""
        n = step_times.shape[0]
        if n < 2:
            return -1
        for k in range(n):
            others = np.delete(step_times, k)
            med = float(np.median(others))
            threshold = max(
                med * self.straggler_factor, med + self.straggler_min_s
            )
            if float(step_times[k]) > threshold:
                self._exceed_counts[k] = self._exceed_counts.get(k, 0) + 1
            else:
                self._exceed_counts[k] = 0
        flagged = [
            k
            for k, c in sorted(self._exceed_counts.items())
            if c >= self.straggler_patience
        ]
        return flagged[0] if flagged else -1

    def _publish(self, matrix: np.ndarray) -> None:
        metrics = self.metrics
        st = matrix[:, 2]
        hw = matrix[:, 3]
        tps = matrix[:, 4]
        mem = matrix[:, 5]
        straggler = self._detect_straggler(st)
        if straggler >= 0 and straggler != self.straggler_rank:
            logger.warning(
                "cluster telemetry: rank %d is a persistent straggler "
                "(step %.3fs vs peer median %.3fs over %d+ boundaries) — "
                "the whole pod steps at its pace",
                straggler,
                float(st[straggler]),
                float(np.median(np.delete(st, straggler))),
                self.straggler_patience,
            )
            if self.flightrec is not None:
                self.flightrec.record(
                    "straggler",
                    {"rank": straggler, "step_times_s": st.tolist()},
                )
        self.straggler_rank = straggler
        if metrics is None:
            return
        # literal keys: visible to scripts/check_metric_names.py
        metrics.set_gauge("cluster/size", float(matrix.shape[0]))
        metrics.set_gauge("cluster/step_time_min_s", float(st.min()))
        metrics.set_gauge("cluster/step_time_mean_s", float(st.mean()))
        metrics.set_gauge("cluster/step_time_max_s", float(st.max()))
        metrics.set_gauge("cluster/step_skew_s", float(st.max() - st.min()))
        metrics.set_gauge("cluster/host_wait_mean_s", float(hw.mean()))
        metrics.set_gauge("cluster/host_wait_max_s", float(hw.max()))
        metrics.set_gauge("cluster/tokens_per_sec_min", float(tps.min()))
        metrics.set_gauge("cluster/tokens_per_sec_sum", float(tps.sum()))
        metrics.set_gauge("cluster/device_bytes_in_use_max", float(mem.max()))
        metrics.set_gauge("cluster/straggler_rank", float(straggler))
        # actor-fleet membership: the learner rank carries the live member
        # count, peers −1; published only when some rank hosts a fleet
        fleet = matrix[:, 8]
        if fleet.max() >= 0:
            metrics.set_gauge("cluster/fleet_size", float(fleet.max()))

    def clock_offsets(self) -> Dict[int, float]:
        """rank → seconds to ADD to that rank's tracer-relative timestamps
        to land them on rank 0's timeline (median over the beat window)."""
        return {
            k: float(np.median(np.asarray(buf)))
            for k, buf in self._offsets.items()
            if len(buf)
        }


# ---------------------------------------------------------------------------
# merged multi-rank Perfetto traces
# ---------------------------------------------------------------------------


def rank_trace_name(rank: int) -> str:
    return f"trace_rank{rank}.json"


def write_rank_trace(tracer: Any, directory: str, rank: int) -> str:
    """Non-zero ranks: write this rank's Chrome-trace doc atomically into
    the shared trace dir for process 0's merge (tmp + rename, so a
    concurrent merge never reads a half-written file)."""
    os.makedirs(os.path.abspath(directory), exist_ok=True)
    path = os.path.join(directory, rank_trace_name(rank))
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(tracer.to_chrome_trace(), f)
    os.replace(tmp, path)
    return path


def _read_rank_trace(
    path: str, min_mtime: float = 0.0
) -> Optional[List[Dict[str, Any]]]:
    try:
        if os.path.getmtime(path) < min_mtime:
            return None  # stale file from a previous run incarnation
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    except (OSError, ValueError):
        return None


def merge_cluster_trace(
    tracer: Any,
    directory: str,
    process_count: int,
    offsets: Optional[Dict[int, float]] = None,
    timeout_s: Optional[float] = None,
    min_mtime: float = 0.0,
) -> str:
    """Process 0: merge every rank's span stream into ONE Perfetto
    ``trace.json`` on rank 0's clock.

    Peer files are written by each rank's own export (same shutdown path),
    so process 0 polls for them up to ``timeout_s`` — bounded, never a
    collective: a rank that died without exporting costs a warning and a
    ``missing_ranks`` note in the merged metadata, not a hung shutdown.
    ``min_mtime`` guards against a relaunched run (same logging dir — the
    documented resume workflow) silently merging the PREVIOUS
    incarnation's peer files: anything written before this run started is
    treated as not-yet-written and polled past.
    """
    if timeout_s is None:
        timeout_s = float(os.environ.get("TRLX_TPU_TRACE_MERGE_WAIT_S", 15.0))
    offsets = offsets or {}
    events: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": "rank 0"}},
    ]
    events.extend(tracer.events())
    missing: List[int] = []
    deadline = time.monotonic() + timeout_s
    for rank in range(1, process_count):
        path = os.path.join(directory, rank_trace_name(rank))
        peer = _read_rank_trace(path, min_mtime)
        while peer is None and time.monotonic() < deadline:
            time.sleep(0.2)
            peer = _read_rank_trace(path, min_mtime)
        if peer is None:
            missing.append(rank)
            logger.warning(
                f"trace merge: no fresh trace from rank {rank} within "
                f"{timeout_s:.0f}s ({path}) — merging without it"
            )
            continue
        shift_us = offsets.get(rank, 0.0) * 1e6
        events.append(
            {"name": "process_name", "ph": "M", "pid": rank, "tid": 0,
             "args": {"name": f"rank {rank}"}}
        )
        for e in peer:
            e = dict(e)
            if "ts" in e:
                e["ts"] = e["ts"] + shift_us
            events.append(e)
    doc: Dict[str, Any] = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "clock_offsets_s": {str(k): v for k, v in offsets.items()},
    }
    if tracer.dropped:
        doc["dropped_events"] = tracer.dropped
    if missing:
        doc["missing_ranks"] = missing
    os.makedirs(os.path.abspath(directory), exist_ok=True)
    out = os.path.join(directory, "trace.json")
    tmp = f"{out}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, out)
    return out
