"""Crash flight recorder: a bounded ring of recent spans, metric writes,
resilience events and engine snapshots, dumped as ``flightrec.json``.

Port of ``trlx_tpu/observability/flightrec.py``, with its ring, its
listeners and its dump format. The tracker stream ends mid-step when a run
dies, and the span trace is capped; the recorder keeps the last seconds:

- a deque of ``capacity`` records (oldest evicted first) that keeps
  rotating after the tracer's own buffer is full: it taps
  :meth:`Tracer.add_listener`, which fires for dropped events too;
- every counter and gauge write, through
  :meth:`MetricsRegistry.add_listener`;
- structured events (:meth:`FlightRecorder.record`) from the learn loop:
  per-step stats, preemption and rollback, health trips, engine stats;
- :meth:`FlightRecorder.dump` writes the ring as one JSON document,
  atomically and never raising, on any exception, NaN-halt or preemption
  (the learn loop's crash path), on a health trip, and at
  ``flightrec_dump@step:N`` of a fault plan.

Thread-safe: span listeners fire from pipeline worker threads while the
learn loop records step stats.
"""

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from trlx_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DEFAULT_CAPACITY = 512
FLIGHTREC_FORMAT = 1


def _jsonable(value: Any) -> Any:
    """JSON coercion that never refuses a payload: scalar arrays and
    tensors → Python numbers, others → a shape summary, unknown objects →
    ``repr``."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    item = getattr(value, "item", None)
    shape = getattr(value, "shape", None)
    if item is not None and shape is not None:
        if tuple(shape) == ():
            try:
                return _jsonable(item())
            except Exception:
                pass
        return f"<array shape={tuple(shape)} dtype={getattr(value, 'dtype', '?')}>"
    return repr(value)


class FlightRecorder:
    """Bounded forensic ring buffer (see the module docstring)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, enabled: bool = True):
        self.enabled = enabled
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)  # guarded-by: _lock
        self.recorded = 0  # total ever recorded  # guarded-by: _lock
        self.dumps = 0  # guarded-by: _lock
        self._t0 = time.time()

    # -- recording -------------------------------------------------------

    def record(self, kind: str, payload: Optional[Dict[str, Any]] = None) -> None:
        """Append one record; ``payload`` is coerced to JSON-safe values."""
        if not self.enabled:
            return
        rec = {"t": time.time(), "kind": kind}
        if payload:
            rec["data"] = _jsonable(payload)
        with self._lock:
            self._ring.append(rec)
            self.recorded += 1

    def span_listener(self, event: Dict[str, Any]) -> None:
        """``Tracer.add_listener`` tap: one record per closed span or
        instant (track labels are trace-only)."""
        if event.get("ph") == "M":
            return
        payload = {"name": event.get("name"), "ts_s": event.get("ts", 0.0) / 1e6,
                   "dur_s": event.get("dur", 0.0) / 1e6, "pid": event.get("pid"),
                   "tid": event.get("tid")}
        args = event.get("args")
        if args:
            payload["args"] = args
        self.record("span", payload)

    def metric_listener(self, op: str, name: str, value: float) -> None:
        """``MetricsRegistry.add_listener`` tap: counter and gauge writes."""
        self.record("metric", {"op": op, "name": name, "value": value})

    # -- reading / dumping ----------------------------------------------

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def dump(self, path: str, reason: str = "unspecified",
             extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write the ring as ``flightrec.json`` (staged file, then rename).
        Returns the path, or None on failure: a crash dump never masks the
        exception that caused it."""
        try:
            with self._lock:
                records = list(self._ring)
                recorded_total = self.recorded
                self.dumps += 1
                n_dumps = self.dumps
            doc = {"format": FLIGHTREC_FORMAT, "reason": reason, "dumped_at": time.time(),
                   "started_at": self._t0, "capacity": self.capacity,
                   "recorded_total": recorded_total, "dump_number": n_dumps,
                   "records": records}
            if extra:
                doc.update(_jsonable(extra))
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)
            return path
        except Exception as e:  # pragma: no cover - defensive
            logger.warning(f"flight recorder dump failed: {e}")
            return None
