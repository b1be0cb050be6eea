"""Update guard: a finiteness check of every update, with a ``skip`` /
``rollback`` / ``halt`` policy.

Port of ``trlx_tpu/resilience/guard.py``. A NaN loss would otherwise flow
through the gradients into every weight, and the run would go on training
on garbage. The check is JAX's: ``isfinite(gradients/global_norm)``, and
``isfinite(loss)`` when ``train.grad_accum`` is 1; any non-finite loss,
gradient or activation reaches the norm.

- Trainer side (``trainer/base.py::train_step``): the flag is computed on
  the device from the norm the step already computes, and read on the host
  once, before the optimizer steps (one small copy, only when a guard is
  on). Under ``skip`` a failed check leaves the parameters, the optimizer
  state and the step count that drives the LR schedule untouched (the
  optimizer does not step), as JAX's select keeps the old state.
  ``resilience/update_ok`` rides the step's stats.
- Host side (:class:`UpdateGuard`) reads the flag from the landed stats
  and applies the policy:

  ``skip``      count the dropped update and go on with the next batch;
  ``rollback``  restore the newest committed checkpoint (the update has
                landed; without a committed checkpoint this halts);
  ``halt``      raise :class:`NonFiniteUpdateError`.

``max_consecutive`` escalates skip and rollback to a halt after that many
non-finite updates in a row: a diverged run stops instead of spinning.

Counters: ``resilience/skipped_updates``, ``resilience/rollbacks``,
``resilience/nonfinite_updates``; gauge ``resilience/goodput_frac``
(committed ÷ attempted updates).
"""

from typing import Any, Dict, Optional

from trlx_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

POLICIES = ("off", "skip", "rollback", "halt")

# the stats key the device-side check publishes (1.0 = update committed)
UPDATE_OK_KEY = "resilience/update_ok"


class NonFiniteUpdateError(RuntimeError):
    """A non-finite update under the ``halt`` policy (or escalation)."""


class UpdateGuard:
    """Host-side policy half of the update guard (see module docstring)."""

    def __init__(
        self,
        policy: str = "off",
        max_consecutive: int = 25,
        metrics: Any = None,
    ):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown update_guard policy {policy!r} (use one of {POLICIES})"
            )
        self.policy = policy
        self.max_consecutive = int(max_consecutive)
        self.metrics = metrics
        self.consecutive = 0
        self.attempted = 0
        self.committed = 0

    @property
    def enabled(self) -> bool:
        return self.policy != "off"

    def _inc(self, key: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(key)

    def after_step(self, stats: Dict[str, float]) -> Optional[str]:
        """Inspect one step's landed host stats; return the action the learn
        loop must take: ``None`` (continue), ``"rollback"``, or raise
        :class:`NonFiniteUpdateError` for ``halt``/escalation."""
        if not self.enabled:
            return None
        ok = stats.get(UPDATE_OK_KEY, 1.0) >= 0.5
        self.attempted += 1
        if ok:
            self.committed += 1
            self.consecutive = 0
        else:
            self.consecutive += 1
            self._inc("resilience/nonfinite_updates")
        if self.metrics is not None:
            goodput = self.committed / max(self.attempted, 1)
            self.metrics.set_gauge("resilience/goodput_frac", goodput)
        if ok:
            return None
        if self.policy == "halt":
            raise NonFiniteUpdateError(
                "non-finite loss/gradients and update_guard='halt'"
            )
        if self.consecutive >= self.max_consecutive:
            raise NonFiniteUpdateError(
                f"{self.consecutive} consecutive non-finite updates "
                f"(update_guard='{self.policy}', max_consecutive="
                f"{self.max_consecutive}): the run has diverged — halting "
                "instead of spinning"
            )
        if self.policy == "rollback":
            self._inc("resilience/rollbacks")
            logger.warning(
                "non-finite update: rolling back to the newest committed "
                "checkpoint and skipping the poison batch"
            )
            return "rollback"
        self._inc("resilience/skipped_updates")
        logger.warning("non-finite update: skipped (old state kept on device)")
        return None
