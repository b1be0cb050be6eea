"""Preemption handling: SIGTERM/SIGINT → emergency checkpoint at the next
step boundary → clean exit.

Port of ``trlx_tpu/resilience/preemption.py``. The signal callback only
sets a flag; the learn loop checks :attr:`PreemptionHandler.requested`
before each update, stops the pipeline threads, waits for the card, writes
an emergency checkpoint (the train state, the host state and the PPO/GRPO
rollout store), commits it and raises :class:`TrainingPreempted`. A
relaunch with ``train.resume_from_checkpoint`` continues bitwise as the
uninterrupted run would have.

A second signal while the first is honoured restores the previous handler
and re-raises, so a double Ctrl-C still kills the process at once.
"""

import signal
import threading
from typing import Any, Dict, List, Optional

from trlx_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class TrainingPreempted(SystemExit):
    """Raised by the learn loop after the emergency checkpoint commits.

    Subclasses ``SystemExit`` (code 0) so an unhandled preemption exits the
    process cleanly — the scheduler sees a graceful shutdown, and a relaunch
    with ``train.resume_from_checkpoint`` continues the run.
    """

    def __init__(self, message: str, checkpoint_dir: Optional[str] = None):
        super().__init__(0)
        self.message = message
        self.checkpoint_dir = checkpoint_dir

    def __str__(self) -> str:
        return self.message


class PreemptionHandler:
    """Flag-setting signal handler, installed only while training runs.

    Use as a context manager around the learn loop::

        with self.resilience.preemption:
            for step in ...:
                if self.resilience.preemption.requested:
                    <emergency checkpoint, raise TrainingPreempted>

    Handlers install on entry and the *previous* handlers are restored on
    exit, so a trainer never hijacks signals for the rest of the process.
    Installation is skipped (with a warning) off the main thread — Python
    only allows signal handlers there — and when ``enabled`` is False.
    ``request()`` triggers the same path programmatically (tests, fault
    plans, cluster-specific preemption notices).
    """

    def __init__(
        self,
        enabled: bool = True,
        signals: Optional[List[str]] = None,
        metrics: Any = None,
    ):
        self.enabled = enabled
        self.signal_names = list(signals or ("SIGTERM", "SIGINT"))
        self.metrics = metrics
        self.requested = False
        self.signal_received: Optional[str] = None
        self._previous: Dict[int, Any] = {}
        self._installed = False

    # -- signal plumbing ------------------------------------------------

    def _signums(self) -> List[int]:
        nums = []
        for name in self.signal_names:
            num = getattr(signal, name, None)
            if num is None:
                logger.warning(f"unknown preemption signal {name!r}; skipping")
            else:
                nums.append(int(num))
        return nums

    def _on_signal(self, signum, frame) -> None:
        name = signal.Signals(signum).name
        if self.requested:
            # second signal: the operator really means it — restore the old
            # handler and re-deliver so default disposition (kill) applies
            logger.warning(f"second {name} during shutdown; exiting immediately")
            self._uninstall()
            signal.raise_signal(signum)
            return
        self.requested = True
        self.signal_received = name
        if self.metrics is not None:
            self.metrics.inc("resilience/preemptions")
        logger.warning(
            f"{name} received: emergency checkpoint at the next step boundary"
        )

    def request(self, reason: str = "programmatic") -> None:
        """Trigger preemption without a signal (tests, external notices)."""
        if not self.requested:
            self.requested = True
            self.signal_received = reason
            if self.metrics is not None:
                self.metrics.inc("resilience/preemptions")

    # -- context manager ------------------------------------------------

    def __enter__(self) -> "PreemptionHandler":
        self.requested = False
        self.signal_received = None
        if not self.enabled:
            return self
        if threading.current_thread() is not threading.main_thread():
            logger.warning(
                "preemption handlers need the main thread; running without "
                "signal handling (request() still works)"
            )
            return self
        for num in self._signums():
            try:
                self._previous[num] = signal.signal(num, self._on_signal)
            except (ValueError, OSError) as e:  # pragma: no cover - platform
                logger.warning(f"could not install handler for signal {num}: {e}")
        self._installed = True
        return self

    def _uninstall(self) -> None:
        if not self._installed:
            return
        for num, prev in self._previous.items():
            try:
                signal.signal(num, prev)
            except (ValueError, OSError):  # pragma: no cover - defensive
                pass
        self._previous = {}
        self._installed = False

    def __exit__(self, *exc_info) -> None:
        self._uninstall()
