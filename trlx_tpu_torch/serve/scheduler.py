"""SLO-aware admission control for the serving frontend.

Port of ``trlx_tpu/serve/scheduler.py`` (host Python, verbatim apart from
this note and the import of the class table).

Priority *scheduling* lives in the engine (``engine/core.py``: per-class
queue pop order); this module is the gate in
front of it — the decision, made on the HTTP handler thread at submit
time, whether a request should enter the queue at all:

- **503 + draining** once :meth:`set_draining` ran (graceful shutdown): in-flight requests finish, new ones are turned away
  immediately instead of being accepted into a server that will not serve
  them.
- **429 + Retry-After** when the queue-wait SLO for the request's class is
  *provably* blown: the controller keeps an EWMA of observed per-request
  service time; ``predicted wait = queued-at-or-above-rank / slots ×
  EWMA``. Admission is rejected only on evidence — with no completed
  request yet (no EWMA), everything is admitted and the SLO is enforced
  ex post by the metrics. A hard queue-depth cap (``max_queue``) bounds
  memory regardless.

Accounting: a request occupies its class's queue count from admission
until the pump reports it terminal (``release``) — the simple conservative
model: everything admitted-but-unfinished is load ahead of you.

Lock discipline: handler threads admit, the pump
thread releases and feeds service times — every mutable field is
``# guarded-by: _lock``.
"""

import math
import threading
from typing import Dict, Optional, Tuple

from trlx_tpu_torch.engine.core import SERVE_CLASSES, _CLASS_RANK

__all__ = ["AdmissionController", "AdmissionDecision"]


class AdmissionDecision:
    """Outcome of one :meth:`AdmissionController.try_admit`."""

    __slots__ = ("admitted", "status", "retry_after_s", "reason")

    def __init__(
        self,
        admitted: bool,
        status: int = 200,
        retry_after_s: float = 0.0,
        reason: str = "",
    ):
        self.admitted = admitted
        self.status = status  # HTTP status when rejected (429 / 503)
        self.retry_after_s = retry_after_s
        self.reason = reason


class AdmissionController:
    def __init__(
        self,
        slots: int,
        slo_s: Optional[Dict[str, float]] = None,
        max_queue: int = 64,
        ewma_alpha: float = 0.3,
    ):
        if slots < 1:
            raise ValueError(f"admission needs >= 1 engine slot, got {slots}")
        self.slots = int(slots)
        # per-class queue-wait SLO in seconds; absent class = no SLO gate
        self.slo_s = dict(slo_s or {})
        for k in self.slo_s:
            if k not in _CLASS_RANK:
                raise ValueError(
                    f"unknown priority class {k!r} in serve SLOs: expected "
                    f"one of {SERVE_CLASSES}"
                )
        self.max_queue = int(max_queue)
        self.ewma_alpha = float(ewma_alpha)
        self._lock = threading.Lock()
        self._queued: Dict[str, int] = {k: 0 for k in SERVE_CLASSES}  # guarded-by: _lock
        self._ewma_service_s: Optional[float] = None  # guarded-by: _lock
        self._draining = False  # guarded-by: _lock
        self.admitted = 0  # guarded-by: _lock
        self.rejected = 0  # guarded-by: _lock
        self.drain_rejected = 0  # guarded-by: _lock

    # -- handler-thread side ---------------------------------------------

    def try_admit(self, klass: str) -> AdmissionDecision:
        if klass not in _CLASS_RANK:
            return AdmissionDecision(
                False, 400, 0.0, f"unknown class {klass!r}"
            )
        rank = _CLASS_RANK[klass]
        with self._lock:
            if self._draining:
                self.drain_rejected += 1
                return AdmissionDecision(False, 503, 0.0, "draining")
            # load that will be served at-or-before this request: classes
            # of equal or better rank (worse-ranked queued work yields)
            ahead = sum(
                n
                for k, n in self._queued.items()
                if _CLASS_RANK[k] <= rank
            )
            total = sum(self._queued.values())
            if total >= self.max_queue:
                retry = self._predict_locked(ahead) or 1.0
                self.rejected += 1
                return AdmissionDecision(
                    False,
                    429,
                    math.ceil(retry),
                    f"queue full ({total}/{self.max_queue})",
                )
            slo = self.slo_s.get(klass)
            predicted = self._predict_locked(ahead)
            if slo is not None and predicted is not None and predicted > slo:
                self.rejected += 1
                return AdmissionDecision(
                    False,
                    429,
                    math.ceil(predicted - slo) or 1,
                    f"predicted queue wait {predicted:.2f}s exceeds the "
                    f"{klass} SLO of {slo:.2f}s",
                )
            self._queued[klass] += 1
            self.admitted += 1
            return AdmissionDecision(True)

    def _predict_locked(self, ahead: int) -> Optional[float]:
        """Predicted queue wait given ``ahead`` requests at-or-above rank;
        None without service-time evidence (reject needs proof)."""
        if self._ewma_service_s is None:
            return None
        return ahead / self.slots * self._ewma_service_s

    # -- pump-thread side ------------------------------------------------

    def release(self, klass: str) -> None:
        """A previously admitted request reached a terminal state."""
        with self._lock:
            if self._queued.get(klass, 0) > 0:
                self._queued[klass] -= 1

    def note_service(self, seconds: float) -> None:
        """Fold one completed request's submit→done wall time into the EWMA
        the admission predictions run on."""
        if seconds <= 0:
            return
        with self._lock:
            if self._ewma_service_s is None:
                self._ewma_service_s = seconds
            else:
                a = self.ewma_alpha
                self._ewma_service_s = a * seconds + (1 - a) * self._ewma_service_s

    # -- lifecycle -------------------------------------------------------

    def set_draining(self) -> None:
        with self._lock:
            self._draining = True

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = {
                "admitted": float(self.admitted),
                "rejected": float(self.rejected),
                "drain_rejected": float(self.drain_rejected),
                "queued": float(sum(self._queued.values())),
                "ewma_service_s": float(self._ewma_service_s or 0.0),
            }
            for k, n in self._queued.items():
                out[f"queued_{k}"] = float(n)
            return out
