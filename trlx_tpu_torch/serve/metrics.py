"""Per-tenant / per-class serving SLO metrics.

Port of ``trlx_tpu/serve/metrics.py`` (host Python, verbatim apart from
this note). Derived from the per-request spans the engine stamps on every
:class:`~trlx_tpu_torch.engine.core.CompletedSequence`
(``t_enqueue → t_prefill0 → t_prefill1 → t_harvest``) plus the frontend's
wall timestamps:

- **queue wait** — enqueue → first prefill work (``t_prefill0 −
  t_enqueue``): the admission SLO's measured counterpart;
- **TTFT** — submit → first streamed token on the wire;
- **TPOT** — (done − first token) / (tokens − 1): steady-state decode
  cadence as the client sees it.

Two output shapes:

- :meth:`metrics` — the flat ``serve/*`` gauge dict (the JAX package's
  ``SERVE_KEYS``): aggregate percentiles over all traffic;
- :meth:`detail` — the nested per-(tenant, class) breakdown the HTTP
  ``/metrics`` endpoint serves.

Lock discipline: handler threads, the pump thread and the owner thread
all report here — every mutable field is ``# guarded-by: _lock``.
"""

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["ServeMetrics"]

# sample lists are clipped to this many most-recent entries per
# (tenant, class) — serving is long-lived, percentile memory must not be
_MAX_SAMPLES = 2048


def _pct(samples: List[float], q: float) -> float:
    if not samples:
        return 0.0
    return float(np.percentile(np.asarray(samples, np.float64), q))


class ServeMetrics:
    def __init__(self):
        self._lock = threading.Lock()
        # (tenant, class) → samples, most recent _MAX_SAMPLES
        self._ttft: Dict[Tuple[str, str], List[float]] = {}  # guarded-by: _lock
        self._tpot: Dict[Tuple[str, str], List[float]] = {}  # guarded-by: _lock
        self._qwait: Dict[Tuple[str, str], List[float]] = {}  # guarded-by: _lock
        self._counts: Dict[Tuple[str, str], int] = {}  # guarded-by: _lock
        self.completed = 0  # guarded-by: _lock
        self.failed = 0  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock
        self.streamed_tokens = 0  # guarded-by: _lock
        self.flood_rejected = 0  # guarded-by: _lock
        self.active = 0  # guarded-by: _lock
        self.params_version = 0  # guarded-by: _lock
        # admission / host-tier snapshots pushed by their owners
        self._admission: Dict[str, float] = {}  # guarded-by: _lock
        self._tier: Dict[str, float] = {}  # guarded-by: _lock

    # -- reporting (pump / handler / trainer threads) --------------------

    def observe_request(
        self,
        tenant: str,
        klass: str,
        ttft_s: float,
        tpot_s: float,
        queue_wait_s: float,
        tokens: int,
    ) -> None:
        key = (tenant, klass)
        with self._lock:
            for store, v in (
                (self._ttft, ttft_s),
                (self._tpot, tpot_s),
                (self._qwait, queue_wait_s),
            ):
                samples = store.setdefault(key, [])
                samples.append(float(v))
                if len(samples) > _MAX_SAMPLES:
                    del samples[: len(samples) - _MAX_SAMPLES]
            self._counts[key] = self._counts.get(key, 0) + 1
            self.completed += 1
            self.streamed_tokens += int(tokens)

    def note_failed(self) -> None:
        with self._lock:
            self.failed += 1

    def note_dropped(self) -> None:
        with self._lock:
            self.dropped += 1

    def note_flood_rejected(self, n: int) -> None:
        with self._lock:
            self.flood_rejected += int(n)

    def adjust_active(self, delta: int) -> None:
        with self._lock:
            self.active += delta

    def set_params_version(self, version: Optional[int]) -> None:
        with self._lock:
            self.params_version = int(version or 0)

    def set_admission(self, snapshot: Dict[str, float]) -> None:
        with self._lock:
            self._admission = dict(snapshot)

    def set_tier(self, snapshot: Dict[str, float]) -> None:
        with self._lock:
            self._tier = dict(snapshot)

    # -- output ----------------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        """Flat ``SERVE_KEYS`` gauges (aggregate over every tenant/class)."""
        with self._lock:
            ttft = [v for s in self._ttft.values() for v in s]
            tpot = [v for s in self._tpot.values() for v in s]
            qwait = [v for s in self._qwait.values() for v in s]
            stats: Dict[str, float] = {}
            stats["serve/ttft_p50"] = _pct(ttft, 50)
            stats["serve/ttft_p95"] = _pct(ttft, 95)
            stats["serve/tpot_p50"] = _pct(tpot, 50)
            stats["serve/tpot_p95"] = _pct(tpot, 95)
            stats["serve/queue_wait_p50"] = _pct(qwait, 50)
            stats["serve/queue_wait_p95"] = _pct(qwait, 95)
            stats["serve/admitted"] = self._admission.get("admitted", 0.0)
            stats["serve/rejected"] = self._admission.get("rejected", 0.0)
            stats["serve/drain_rejected"] = self._admission.get(
                "drain_rejected", 0.0
            )
            stats["serve/flood_rejected"] = float(self.flood_rejected)
            stats["serve/completed"] = float(self.completed)
            stats["serve/failed"] = float(self.failed)
            stats["serve/dropped"] = float(self.dropped)
            stats["serve/active"] = float(self.active)
            stats["serve/streamed_tokens"] = float(self.streamed_tokens)
            stats["serve/host_tier_blocks"] = self._tier.get("blocks", 0.0)
            stats["serve/host_tier_spilled"] = self._tier.get("spilled", 0.0)
            stats["serve/host_tier_relanded"] = self._tier.get("relanded", 0.0)
            stats["serve/params_version"] = float(self.params_version)
            return stats

    def detail(self) -> Dict[str, Dict[str, float]]:
        """Per-(tenant, class) SLO breakdown for the ``/metrics`` endpoint —
        the cardinality that stays out of the flat gauge registry."""
        with self._lock:
            out: Dict[str, Dict[str, float]] = {}
            for key, n in sorted(self._counts.items()):
                tenant, klass = key
                out[f"{tenant}/{klass}"] = {
                    "completed": float(n),
                    "ttft_p50_s": _pct(self._ttft.get(key, []), 50),
                    "ttft_p95_s": _pct(self._ttft.get(key, []), 95),
                    "tpot_p50_s": _pct(self._tpot.get(key, []), 50),
                    "tpot_p95_s": _pct(self._tpot.get(key, []), 95),
                    "queue_wait_p50_s": _pct(self._qwait.get(key, []), 50),
                    "queue_wait_p95_s": _pct(self._qwait.get(key, []), 95),
                }
            return out
