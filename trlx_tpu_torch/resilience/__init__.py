"""Resilience of the port: preemption-safe training, the update guard,
host-call hardening and deterministic fault injection.

Port of ``trlx_tpu/resilience/``, bundled per trainer as
``trainer.resilience`` (a :class:`Resilience`):

- :mod:`.preemption` — SIGTERM/SIGINT → emergency checkpoint at the next
  step boundary → :class:`TrainingPreempted`;
- :mod:`.guard` — the finiteness check of every update, with the ``skip``
  / ``rollback`` / ``halt`` policies;
- :mod:`.retry` — retries, timeout and backoff around ``reward_fn`` and
  the tracker's publishes, with fallbacks;
- :mod:`.faults` — the :class:`FaultPlan` that drives each of them on the
  CPU or the card.

- :mod:`.elastic` — the topology manifest of every checkpoint, the
  restore that reshards onto a changed topology, and the preemption flag
  coordinated over the processes of a mesh.

Checkpoints commit atomically (``utils/checkpoint.py``); the guard's
rollback and ``maybe_resume`` trust only committed ones.
"""

from typing import Any, Callable, Optional

from trlx_tpu_torch.resilience.elastic import (
    MANIFEST_FORMAT,
    MANIFEST_NAME,
    ElasticRestoreError,
    build_manifest,
    coordinate_preemption,
    manifest_mismatch,
    read_manifest,
    restore_state_elastic,
)
from trlx_tpu_torch.resilience.faults import (
    UNPORTED_KINDS,
    FaultPlan,
    InjectedFault,
    poll_fault,
    set_active_plan,
)
from trlx_tpu_torch.resilience.guard import UPDATE_OK_KEY, NonFiniteUpdateError, UpdateGuard
from trlx_tpu_torch.resilience.preemption import PreemptionHandler, TrainingPreempted
from trlx_tpu_torch.resilience.retry import HostCallGuard, ResilientTracker, neutral_rewards

__all__ = [
    "MANIFEST_FORMAT",
    "MANIFEST_NAME",
    "ElasticRestoreError",
    "FaultPlan",
    "HostCallGuard",
    "InjectedFault",
    "NonFiniteUpdateError",
    "PreemptionHandler",
    "Resilience",
    "ResilientTracker",
    "TrainingPreempted",
    "UNPORTED_KINDS",
    "UPDATE_OK_KEY",
    "UpdateGuard",
    "build_manifest",
    "coordinate_preemption",
    "manifest_mismatch",
    "neutral_rewards",
    "poll_fault",
    "read_manifest",
    "restore_state_elastic",
    "set_active_plan",
]


class Resilience:
    """Per-trainer bundle built from ``config.resilience``: the fault plan
    (also made the process-wide active plan), the preemption handler, the
    update guard, and the hardening of ``reward_fn`` and the tracker. It
    shares the trainer's metrics registry, so every ``resilience/*``
    counter rides the tracker stream."""

    def __init__(self, config: Any, metrics: Any = None):
        from trlx_tpu_torch.data.configs import ResilienceConfig

        rcfg = getattr(config, "resilience", None)
        if rcfg is None:
            rcfg = ResilienceConfig()
        self.config = rcfg
        self.metrics = metrics
        self.plan = FaultPlan.from_config(rcfg.fault_plan)
        # a plan-less trainer clears the slot, so no fault leaks across runs
        set_active_plan(self.plan)
        self.preemption = PreemptionHandler(
            enabled=rcfg.handle_preemption,
            signals=list(rcfg.preemption_signals),
            metrics=metrics,
        )
        self.guard = UpdateGuard(
            policy=rcfg.update_guard,
            max_consecutive=rcfg.max_consecutive_nonfinite,
            metrics=metrics,
        )

    def harden_reward_fn(self, reward_fn: Optional[Callable], seed: int = 0
                         ) -> Optional[Callable]:
        """``reward_fn`` behind retries, timeout and backoff; the trainer
        installs it once, so every call site (rollouts, evaluation) is
        hardened."""
        if reward_fn is None:
            return None
        rcfg = self.config
        return HostCallGuard(
            reward_fn,
            name="reward",
            retries=rcfg.reward_retries,
            backoff_s=rcfg.reward_backoff_s,
            backoff_max_s=rcfg.reward_backoff_max_s,
            timeout_s=rcfg.reward_timeout_s,
            fallback=rcfg.reward_fallback,
            neutral_fn=neutral_rewards,
            max_consecutive_fallbacks=rcfg.reward_max_consecutive_fallbacks,
            metrics=self.metrics,
            plan=self.plan,
            seed=seed,
        )

    def harden_tracker(self, tracker: Any, seed: int = 0) -> Any:
        """The tracker behind retries: a publish that keeps failing is
        dropped, never killing the run."""
        return ResilientTracker(
            tracker,
            retries=self.config.publish_retries,
            backoff_s=self.config.publish_backoff_s,
            metrics=self.metrics,
            plan=self.plan,
            seed=seed,
        )
