"""Windowed RL health detectors over the metric stream.

Port of ``trlx_tpu/observability/health.py``, with its six detectors and
their constants. The distribution sketches (``observability/dynamics.py``)
put the shape of training dynamics on the tracker stream; this module
watches that stream and turns it into a verdict. Each detector is a small
windowed rule over recent metric values (no model access, no device
work), evaluated once per optimizer step (:meth:`HealthMonitor.update`)
and once per experience collection (:meth:`HealthMonitor.observe_rollout`):

``kl_runaway``
    Rollout-measured KL against the frozen reference (``policy/sqrt_kl``²)
    holds above ``KL_RUNAWAY_FACTOR ×`` the KL controller's target.
``entropy_collapse``
    ``dist/entropy_p50`` below ``ENTROPY_FLOOR`` nats for a full window.
``clipfrac_saturation``
    ``policy/clipfrac``'s windowed mean above ``CLIPFRAC_SATURATION``.
``value_ev_collapse``
    The value head's explained variance ``1 − E[(v−R)²]/Var[R]`` negative
    for a full window.
``reward_flatline``
    The per-collection reward mean stops moving (std below
    ``REWARD_FLATLINE_STD`` over ``REWARD_FLATLINE_WINDOW`` collections).
``gen_canary``
    The repetition canary (``rollout/repetition_frac``) holds above
    ``REPEAT_FRAC_CEIL``.

Each detector publishes a ``health/<name>`` 0/1 gauge; ``health/verdict``
summarizes (0 = ok). A trip logs once per detector, records a ``health``
flight-recorder event and sets :attr:`HealthMonitor.just_tripped` for one
step, the trainer's cue to dump the flight record and the batch
(``triage/step<N>.npz``). The ``health_trip@step:N`` fault-plan kind forces
a trip through :meth:`HealthMonitor.force_trip`. ``TRLX_TPU_HEALTH=0``
turns the detectors off (the gauges still publish 0).
"""

import logging
import os
from collections import deque
from typing import Any, Deque, Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

# Detector evaluation order; the first tripped one names the verdict.
DETECTORS = (
    "kl_runaway",
    "entropy_collapse",
    "clipfrac_saturation",
    "value_ev_collapse",
    "reward_flatline",
    "gen_canary",
)

DEFAULT_WINDOW = 8  # optimizer steps (override: TRLX_TPU_HEALTH_WINDOW)
KL_RUNAWAY_FACTOR = 4.0  # × controller target, sustained over ≥2 collections
ENTROPY_FLOOR = 0.05  # nats; ~0 ⇒ deterministic policy
CLIPFRAC_SATURATION = 0.9  # mean fraction of clipped tokens
EV_FLOOR = 0.0  # explained variance below this ⇒ critic useless
REWARD_FLATLINE_STD = 1e-6
REWARD_FLATLINE_WINDOW = 4  # experience collections
REPEAT_FRAC_CEIL = 0.8  # fraction of adjacent repeated response tokens


def _finite(value: Any) -> Optional[float]:
    try:
        f = float(value)
    except (TypeError, ValueError):
        return None
    return f if np.isfinite(f) else None


class HealthMonitor:
    """Stateful per-trainer monitor; lives on the observability bundle as
    ``trainer.obs.health``.

    ``metrics``/``flightrec`` are the shared :class:`MetricsRegistry` and
    :class:`FlightRecorder` (either may be None in bare unit tests);
    ``kl_target`` is the KL-controller setpoint (None disables
    ``kl_runaway``).
    """

    def __init__(
        self,
        metrics=None,
        flightrec=None,
        kl_target: Optional[float] = None,
        window: Optional[int] = None,
    ):
        self.metrics = metrics
        self.flightrec = flightrec
        self.kl_target = _finite(kl_target)
        if window is None:
            window = int(os.environ.get("TRLX_TPU_HEALTH_WINDOW", DEFAULT_WINDOW))
        self.window = max(int(window), 2)
        self.enabled = os.environ.get("TRLX_TPU_HEALTH", "1") != "0"
        self.verdict: str = "ok"
        #: Detector name for exactly one :meth:`update` call after a trip
        #: transition — the trainer's cue to dump flightrec + triage.
        self.just_tripped: Optional[str] = None
        self.trip_counts: Dict[str, int] = {name: 0 for name in DETECTORS}
        self._tripped: Dict[str, bool] = {name: False for name in DETECTORS}
        self._warned: set = set()
        self._forced: Optional[str] = None
        # Per-step windows (optimizer-step cadence).
        self._entropy: Deque[float] = deque(maxlen=self.window)
        self._clipfrac: Deque[float] = deque(maxlen=self.window)
        self._value_ev: Deque[float] = deque(maxlen=self.window)
        # Per-collection windows (experience-collection cadence).
        self._rollout_kl: Deque[float] = deque(maxlen=self.window)
        self._reward_mean: Deque[float] = deque(maxlen=REWARD_FLATLINE_WINDOW)
        self._repeat_frac: Deque[float] = deque(maxlen=self.window)

    # ------------------------------------------------------------------ feeds

    def observe_rollout(self, stats: Dict[str, Any]) -> None:
        """Fold one experience collection's stats into the rollout windows
        (called from ``make_experience``; all four collection paths funnel
        through it)."""
        sqrt_kl = _finite(stats.get("policy/sqrt_kl"))
        if sqrt_kl is not None:
            self._rollout_kl.append(sqrt_kl * sqrt_kl)
        mean = _finite(stats.get("exp_scores/mean"))
        if mean is not None:
            self._reward_mean.append(mean)
        rep = _finite(stats.get("rollout/repetition_frac"))
        if rep is not None:
            self._repeat_frac.append(rep)

    def force_trip(self, reason: str, step: Optional[int] = None) -> None:
        """Arm an injected trip (``health_trip`` fault kind); consumed by the
        next :meth:`update`, which reports verdict ``injected:<reason>`` and
        fires the same flightrec/triage path as an organic trip."""
        self._forced = f"injected:{reason}"
        logger.warning(
            "health: forced trip %r armed (step %s)", reason, step
        )

    # ------------------------------------------------------------ evaluation

    def _detect(self) -> Dict[str, bool]:
        full = self.window
        out = {name: False for name in DETECTORS}
        if not self.enabled:
            return out
        if self.kl_target and len(self._rollout_kl) >= 2:
            recent = list(self._rollout_kl)[-2:]
            out["kl_runaway"] = all(
                v > KL_RUNAWAY_FACTOR * self.kl_target for v in recent
            )
        if len(self._entropy) >= full:
            out["entropy_collapse"] = (
                float(np.mean(self._entropy)) < ENTROPY_FLOOR
            )
        if len(self._clipfrac) >= full:
            out["clipfrac_saturation"] = (
                float(np.mean(self._clipfrac)) > CLIPFRAC_SATURATION
            )
        if len(self._value_ev) >= full:
            out["value_ev_collapse"] = float(np.mean(self._value_ev)) < EV_FLOOR
        if len(self._reward_mean) >= REWARD_FLATLINE_WINDOW:
            out["reward_flatline"] = (
                float(np.std(self._reward_mean)) < REWARD_FLATLINE_STD
            )
        if len(self._repeat_frac) >= 2:
            recent = list(self._repeat_frac)[-2:]
            out["gen_canary"] = all(v > REPEAT_FRAC_CEIL for v in recent)
        return out

    def update(self, stats: Dict[str, Any], step: int) -> Dict[str, float]:
        """Fold one optimizer step's stats in, evaluate every detector, and
        publish gauges. Returns the ``health/*`` gauge dict so the caller can
        merge it into the same step's tracker line (the registry snapshot for
        this step was already taken)."""
        entropy = _finite(stats.get("dist/entropy_p50"))
        if entropy is not None:
            self._entropy.append(entropy)
        clipfrac = _finite(stats.get("policy/clipfrac"))
        if clipfrac is not None:
            self._clipfrac.append(clipfrac)
        verr = _finite(stats.get("values/values_error"))
        ret_std = _finite(stats.get("returns/std"))
        if verr is not None and ret_std is not None:
            self._value_ev.append(1.0 - verr / max(ret_std * ret_std, 1e-8))

        detections = self._detect()
        self.just_tripped = None
        verdict = "ok"
        for name in DETECTORS:
            hit = detections[name]
            if hit and not self._tripped[name]:
                self.just_tripped = name
                self.trip_counts[name] += 1
                if name not in self._warned:
                    self._warned.add(name)
                    logger.warning(
                        "health: detector %s tripped at step %d "
                        "(see docs/OBSERVABILITY.md 'Training dynamics')",
                        name,
                        step,
                    )
            self._tripped[name] = hit
            if hit and verdict == "ok":
                verdict = name
        if self._forced is not None:
            verdict = self._forced
            self.just_tripped = self._forced
            self._forced = None
        self.verdict = verdict

        gauges = {f"health/{name}": float(detections[name]) for name in DETECTORS}
        gauges["health/verdict"] = 0.0 if verdict == "ok" else 1.0
        if self.metrics is not None:
            for key, value in gauges.items():
                self.metrics.set_gauge(key, value)
        if self.just_tripped is not None and self.flightrec is not None:
            self.flightrec.record(
                "health",
                {
                    "step": step,
                    "verdict": verdict,
                    "tripped": self.just_tripped,
                    "detectors": {k: bool(v) for k, v in detections.items()},
                    "windows": {
                        "rollout_kl": list(self._rollout_kl),
                        "entropy_p50": list(self._entropy),
                        "clipfrac": list(self._clipfrac),
                        "value_ev": list(self._value_ev),
                        "reward_mean": list(self._reward_mean),
                        "repetition_frac": list(self._repeat_frac),
                    },
                },
            )
        return gauges
