"""Host-call hardening: retries with exponential backoff and deterministic
jitter, an optional per-attempt timeout and a fallback policy around the
host calls that can fail without the device being at fault: ``reward_fn``
(often a remote scoring service) and tracker publishes.

Port of ``trlx_tpu/resilience/retry.py``, with its semantics:

- a failing attempt is retried up to ``retries`` times after
  ``min(max, base * 2**attempt) * U[0.5, 1)`` seconds, the jitter drawn
  from a ``random.Random(seed)`` of the guard (reproducible);
- ``timeout_s`` runs each attempt on a fresh daemon thread; an attempt
  that overruns counts as failed and is abandoned (it may still finish in
  the background: its result is dropped, never written into the batch
  that the fallback returned);
- when every attempt failed, ``fallback="raise"`` re-raises the last error
  and ``"neutral"`` returns the caller's neutral value (zero rewards),
  re-raising after ``max_consecutive_fallbacks`` fallbacks in a row;
- every retry, failure and fallback counts in the metrics registry
  (``resilience/<name>_retries``, ``_failures``, ``_fallbacks``).

With a fault plan, the guard polls ``<name>_raise`` before each attempt:
every attempt advances the plan's call counter, so
``reward_raise@call:3*2`` fails attempts 3 and 4 and attempt 5 succeeds.
A reward function that runs on the card from a timed-out attempt's thread
uses that thread's current CUDA stream.
"""

import random
import threading
import time
from typing import Any, Callable, Dict, Optional

from trlx_tpu_torch.resilience.faults import FaultPlan, InjectedFault
from trlx_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class HostCallGuard:
    """Wrap a host-side callable in retry/timeout/backoff + metric accounting.

    ``name`` keys the metric counters (``resilience/<name>_retries``,
    ``_failures``, ``_fallbacks``) and the fault-plan kind
    (``<name>_raise``). ``neutral_fn(*args, **kwargs)`` supplies the
    fallback value under the ``"neutral"`` policy.
    """

    def __init__(
        self,
        fn: Callable,
        name: str,
        retries: int = 3,
        backoff_s: float = 0.5,
        backoff_max_s: float = 30.0,
        timeout_s: Optional[float] = None,
        fallback: str = "raise",
        neutral_fn: Optional[Callable] = None,
        max_consecutive_fallbacks: int = 0,
        metrics: Any = None,
        plan: Optional[FaultPlan] = None,
        seed: int = 0,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if fallback not in ("raise", "neutral"):
            raise ValueError(
                f"unknown fallback policy {fallback!r} (use 'raise' or 'neutral')"
            )
        if fallback == "neutral" and neutral_fn is None:
            raise ValueError("fallback='neutral' needs a neutral_fn")
        self.fn = fn
        self.name = name
        self.retries = max(0, int(retries))
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.timeout_s = timeout_s
        self.fallback = fallback
        self.neutral_fn = neutral_fn
        # escalation valve for the "neutral" policy: a DETERMINISTIC bug
        # (vs a transient outage) fails every call — without a cap the run
        # silently degrades into neutral-value training to total_steps.
        # After this many consecutive fallbacks the guard re-raises.
        # 0 disables the cap.
        self.max_consecutive_fallbacks = int(max_consecutive_fallbacks)
        self.consecutive_fallbacks = 0
        self.metrics = metrics
        self.plan = plan
        self._rng = random.Random(seed)
        self._sleep = sleep
        # propagate the wrapped fn's face: reward_fn identity matters to
        # callers that introspect (e.g. examples logging the fn name)
        self.__wrapped__ = fn

    # -- internals ------------------------------------------------------

    def _inc(self, key: str, value: float = 1.0) -> None:
        if self.metrics is not None:
            self.metrics.inc(key, value)

    def backoff_delay(self, attempt: int) -> float:
        """Deterministic-jitter exponential backoff for the given attempt
        (0-based): ``min(max, base * 2**attempt) * U[0.5, 1.0)``."""
        base = min(self.backoff_max_s, self.backoff_s * (2.0 ** attempt))
        return base * (0.5 + 0.5 * self._rng.random())

    def _call_with_timeout(self, *args, **kwargs):
        if self.timeout_s is None:
            return self.fn(*args, **kwargs)
        # one fresh daemon thread per timed attempt (an executor's threads
        # are joined at interpreter exit, so a worker stuck in a dead
        # endpoint would hang shutdown); a timed-out worker is abandoned and
        # dies with the process. Its result lands in its own dict only.
        result: Dict[str, Any] = {}
        done = threading.Event()

        def _run():
            try:
                result["value"] = self.fn(*args, **kwargs)
            except BaseException as e:
                result["error"] = e
            finally:
                done.set()

        worker = threading.Thread(
            target=_run, name=f"trlx-tpu-torch-{self.name}-guard", daemon=True
        )
        worker.start()
        if not done.wait(self.timeout_s):
            raise TimeoutError(
                f"{self.name} call exceeded timeout {self.timeout_s}s"
            ) from None
        if "error" in result:
            raise result["error"]
        return result["value"]

    # -- the call -------------------------------------------------------

    def __call__(self, *args, **kwargs):
        last_err: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            try:
                if self.plan is not None and self.plan.poll(f"{self.name}_raise"):
                    raise InjectedFault(
                        f"fault plan: injected {self.name} failure "
                        f"(attempt {attempt + 1})"
                    )
                result = self._call_with_timeout(*args, **kwargs)
                self.consecutive_fallbacks = 0
                return result
            except Exception as e:
                last_err = e
                if attempt < self.retries:
                    delay = self.backoff_delay(attempt)
                    self._inc(f"resilience/{self.name}_retries")
                    logger.warning(
                        f"{self.name} failed (attempt {attempt + 1}/"
                        f"{self.retries + 1}): {e}; retrying in {delay:.2f}s"
                    )
                    self._sleep(delay)
        self._inc(f"resilience/{self.name}_failures")
        if self.fallback == "neutral":
            self.consecutive_fallbacks += 1
            if (
                self.max_consecutive_fallbacks
                and self.consecutive_fallbacks >= self.max_consecutive_fallbacks
            ):
                logger.error(
                    f"{self.name} fell back {self.consecutive_fallbacks} "
                    "calls in a row — this is a deterministic failure, not "
                    "a transient outage; re-raising"
                )
                raise last_err
            self._inc(f"resilience/{self.name}_fallbacks")
            logger.error(
                f"{self.name} failed after {self.retries + 1} attempts "
                f"({last_err}); substituting the neutral fallback"
            )
            return self.neutral_fn(*args, **kwargs)
        raise last_err


def neutral_rewards(*args, **kwargs):
    """Zero reward per sample — the neutral fallback for ``reward_fn``:
    the batch stays (shapes hold) but contributes no learning signal."""
    samples = kwargs.get("samples")
    if samples is None and args:
        samples = args[0]
    return [0.0] * len(samples or [])


class ResilientTracker:
    """Tracker decorator: publishes retry with backoff and NEVER kill the
    run — metrics logging is not worth a training job.

    Wraps any ``Tracker`` (JSONL/TensorBoard/W&B). ``log`` and ``finish``
    retry like :class:`HostCallGuard`; after exhaustion the record is
    dropped with an error log and ``resilience/publish_failures``
    increments — dropped stats are visible in the *surviving* stream.
    Attribute access proxies to the inner tracker so integrations keep
    working (e.g. ``tracker.path`` for JSONL).
    """

    def __init__(
        self,
        tracker: Any,
        retries: int = 2,
        backoff_s: float = 0.2,
        backoff_max_s: float = 5.0,
        metrics: Any = None,
        plan: Optional[FaultPlan] = None,
        seed: int = 0,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self._inner = tracker
        self._guard = HostCallGuard(
            self._publish,
            name="publish",
            retries=retries,
            backoff_s=backoff_s,
            backoff_max_s=backoff_max_s,
            fallback="neutral",
            neutral_fn=lambda *a, **k: None,  # drop the record
            metrics=metrics,
            plan=plan,
            seed=seed,
            sleep=sleep,
        )
        self._lock = threading.Lock()

    def _publish(self, method: str, *args, **kwargs):
        return getattr(self._inner, method)(*args, **kwargs)

    def log(self, stats: Dict[str, Any], step: int) -> None:
        with self._lock:  # pipeline workers and the main loop both log
            self._guard("log", stats, step=step)

    def finish(self) -> None:
        with self._lock:
            self._guard("finish")

    def __enter__(self) -> "ResilientTracker":
        return self

    def __exit__(self, *exc_info) -> None:
        self.finish()

    def __getattr__(self, name: str):
        return getattr(self._inner, name)
