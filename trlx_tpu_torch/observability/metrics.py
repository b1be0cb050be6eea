"""Metrics registry: counters and gauges with a flat snapshot.

Port of the registry of ``trlx_tpu/observability/metrics.py``. Every key
follows the ``namespace/name`` convention. The trainer merges
:meth:`MetricsRegistry.snapshot` into each step's stats, so every counter
(the ``resilience/*`` ones among them) reaches the tracker with no backend
of its own. JAX's histograms and write listeners (the flight recorder's
tap) wait for the rest of ``observability/*``; its utilization math is not
ported.
"""

import threading
from typing import Dict


class MetricsRegistry:
    """Thread-safe counters (``inc``: they accumulate) and gauges
    (``set_gauge``: the last write wins). Pipeline workers increment while
    the learn loop takes snapshots, so every access takes the lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}

    def inc(self, name: str, value: float = 1.0) -> float:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value
            return self._counters[name]

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def snapshot(self) -> Dict[str, float]:
        """Flat ``namespace/name`` → value dict for the tracker stream."""
        with self._lock:
            return {**self._counters, **self._gauges}
