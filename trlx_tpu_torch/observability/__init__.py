"""Run observability of the port: span tracing, metrics, MFU, watchdogs,
the flight recorder, training-dynamics summaries, health detectors and
cluster telemetry. Port of ``trlx_tpu/observability/``:

- :mod:`.tracing`: nested, rank-aware spans whose fences wait on CUDA
  events, with JSONL and Chrome/Perfetto export;
- :mod:`.metrics`: counters, gauges and histograms merged into every
  step's stats, tokens/s, samples/s and MFU (the train step's FLOPs
  counted once, on its first call);
- :mod:`.watchdogs`: new-signature detection and device-memory gauges;
- :mod:`.profiling`: ``torch.profiler`` windows over chosen steps;
- :mod:`.distributed`: the cross-rank telemetry beat, straggler and
  desync detection, merged multi-rank traces;
- :mod:`.flightrec`: the crash flight recorder (``flightrec.json``);
- :mod:`.dynamics`: the loss's distribution sketches and their
  ``dist/*`` percentile gauges;
- :mod:`.health`: windowed RL health detectors (``health/*``).

:class:`Observability` bundles one of each per trainer.
"""

import os
import time
from typing import Any, Dict, Optional

from trlx_tpu_torch.observability.distributed import ClusterDesyncError, ClusterTelemetry
from trlx_tpu_torch.observability.dynamics import DynamicsSummarizer
from trlx_tpu_torch.observability.flightrec import FlightRecorder
from trlx_tpu_torch.observability.health import HealthMonitor
from trlx_tpu_torch.observability.metrics import (
    DEFAULT_PEAK_FLOPS,
    MetricsRegistry,
    ThroughputMeter,
    device_peak_flops,
    mfu,
    train_step_flops,
)
from trlx_tpu_torch.observability.profiling import ProfileWindow, parse_profile_spec
from trlx_tpu_torch.observability.tracing import (
    Span,
    Tracer,
    get_tracer,
    process_count,
    process_index,
    span,
)
from trlx_tpu_torch.observability.watchdogs import DeviceMemoryGauge, RecompileWatchdog
from trlx_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = [
    "ClusterDesyncError",
    "ClusterTelemetry",
    "DEFAULT_PEAK_FLOPS",
    "DeviceMemoryGauge",
    "DynamicsSummarizer",
    "FlightRecorder",
    "HealthMonitor",
    "MetricsRegistry",
    "Observability",
    "ProfileWindow",
    "RecompileWatchdog",
    "Span",
    "ThroughputMeter",
    "Tracer",
    "device_peak_flops",
    "get_tracer",
    "mfu",
    "parse_profile_spec",
    "span",
    "train_step_flops",
]


class Observability:
    """Per-trainer bundle: tracer, metrics, watchdogs, profile window,
    throughput, flight recorder, cluster telemetry, dynamics and health.

    Each trainer owns its own (no event bleeds between trainers of one
    process). ``device`` is the trainer's device (the memory gauge's and
    the peak FLOP rate's card). :meth:`export` writes the span stream
    beside the tracker's stats (``trace.json`` + ``spans.jsonl``), rank 0
    only: ``TRLX_TPU_TRACE_DIR``, else ``train.logging_dir``, else
    ``<train.checkpoint_dir>/logs``."""

    def __init__(self, config: Any = None, trace_dir: Optional[str] = None, device: Any = None):
        self.tracer = Tracer()
        self.metrics = MetricsRegistry()
        self.recompile = RecompileWatchdog(self.metrics)
        # no registry mirror: the learn loop merges collect() into its
        # stats directly
        self.memory = DeviceMemoryGauge(device=device)
        self.profile = ProfileWindow.from_env(config)
        self.throughput = ThroughputMeter(device=device)
        # taps every span and every metric write, so the last window before
        # a crash survives it
        self.flightrec = FlightRecorder(
            capacity=int(os.environ.get("TRLX_TPU_FLIGHTREC_CAP", "512")))
        self.tracer.add_listener(self.flightrec.span_listener)
        self.metrics.add_listener(self.flightrec.metric_listener)
        # the step-boundary seam drives beat(); one process: local gauges
        self.cluster = ClusterTelemetry(self.tracer, self.metrics, flightrec=self.flightrec)
        method = getattr(config, "method", None)
        self.dynamics = DynamicsSummarizer(cliprange=getattr(method, "cliprange", None))
        self.health = HealthMonitor(metrics=self.metrics, flightrec=self.flightrec,
                                    kl_target=getattr(method, "target", None))
        self._warned_dropped = False
        # the merge's staleness floor: peer trace files older than this run
        # are a previous incarnation's (the same logging dir after a resume)
        self._t_start_wall = time.time()
        self._trace_dir = trace_dir or os.environ.get("TRLX_TPU_TRACE_DIR")
        if self._trace_dir is None and config is not None:
            train = getattr(config, "train", None)
            logging_dir = getattr(train, "logging_dir", None)
            checkpoint_dir = getattr(train, "checkpoint_dir", None)
            if logging_dir:
                self._trace_dir = logging_dir
            elif checkpoint_dir:
                self._trace_dir = os.path.join(checkpoint_dir, "logs")

    def span(self, name: str, fence: Any = None, **args: Any):
        return self.tracer.span(name, fence=fence, **args)

    def note_dropped_spans(self) -> None:
        """The tracer's drop counter as the ``obs/spans_dropped`` gauge
        (warning once when non-zero: a capped trace misses its tail)."""
        dropped = self.tracer.dropped
        self.metrics.set_gauge("obs/spans_dropped", float(dropped))
        if dropped and not self._warned_dropped:
            self._warned_dropped = True
            logger.warning(
                "span tracer dropped %d event(s) past its %d-event cap — the exported trace "
                "is missing its tail; the flight recorder ring keeps rotating regardless",
                dropped, self.tracer.max_events)

    def export(self, directory: Optional[str] = None) -> Dict[str, str]:
        """Write ``trace.json`` (Chrome/Perfetto) and ``spans.jsonl``.

        Several ranks: ranks other than 0 write ``trace_rank<k>.json`` into
        the shared trace directory (and return {}); rank 0 merges every
        rank's events onto its clock into one ``trace.json``. Returns the
        written paths ({} without a directory or events, or off rank 0)."""
        directory = directory or self._trace_dir
        if not directory or not self.tracer.events():
            return {}
        from trlx_tpu_torch.observability.distributed import (
            merge_cluster_trace,
            write_rank_trace,
        )

        count, rank = process_count(), process_index()
        if rank != 0:
            if count > 1:
                write_rank_trace(self.tracer, directory, rank)
            return {}
        if count > 1:
            trace_path = merge_cluster_trace(
                self.tracer, directory, process_count=count,
                offsets=self.cluster.clock_offsets(),
                # slack for wall-vs-filesystem clock skew
                min_mtime=self._t_start_wall - 5.0)
        else:
            trace_path = self.tracer.export_chrome_trace(os.path.join(directory, "trace.json"))
        return {"trace": trace_path,
                "spans": self.tracer.export_jsonl(os.path.join(directory, "spans.jsonl"))}

    def dump_flight_record(self, reason: str, directory: Optional[str] = None) -> Optional[str]:
        """Dump the ring as ``flightrec.json`` (``flightrec_rank<k>.json``
        off rank 0) beside the trace exports. Returns the path, or None
        without a directory; never raises (it runs on crash paths)."""
        directory = directory or self._trace_dir
        if not directory:
            return None
        rank = process_index()
        name = "flightrec.json" if rank == 0 else f"flightrec_rank{rank}.json"
        path = self.flightrec.dump(os.path.join(directory, name), reason=reason)
        if path:
            self.metrics.inc("flightrec/dumps")
            self.metrics.set_gauge("flightrec/records", float(len(self.flightrec.snapshot())))
            logger.warning(f"flight recorder dumped to {path} ({reason})")
        return path
