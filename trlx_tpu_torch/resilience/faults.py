"""Deterministic fault injection: a parsed :class:`FaultPlan` that the
trainer, checkpoint and host-call sites consult at well-defined points.

Port of ``trlx_tpu/resilience/faults.py``, with its grammar and every kind,
so a plan string means the same on both packages. The same plan fires the
same faults at the same points of every run, which makes each recovery
path (retries, the update guard, preemption, a crash mid-save) testable on
the CPU.

Plan syntax (``;``-separated entries, whitespace ignored)::

    kind@trigger:N[*count]

    trigger  call  — the Nth invocation of the consulting site (1-based;
                     for reward_raise/publish_raise every attempt counts)
             step  — fires when the trainer's completed-update count == N
             save  — the Nth ``save_state`` call (1-based)
             request — the serve request id (1-based)
             collection — the async collection a chunk feeds (1-based)
             version — the async weight publish's version
             resume — the JAX package's restore counter
    count    consecutive firings (default 1)

The port polls the kinds whose sites it has (:data:`POLLED_KINDS`):

    reward_raise@call:3*2   # reward_fn attempts 3 and 4 raise
    publish_raise@call:1    # the first tracker publish raises
    sigterm@step:5          # SIGTERM delivered before update 6 starts
    sigint@step:5           # the same with SIGINT
    nan_loss@step:7         # the loss of update 8 is poisoned to NaN
    crash_save@save:2       # the 2nd save_state dies before committing
    request_flood@step:3    # a synthetic admission burst sheds load (429s)
                            # before update 4 (serving inside a trainer)
    slow_client@request:2   # the 2nd serve request's streaming consumer stalls
    flightrec_dump@step:2   # the flight recorder dumps before update 3
    health_trip@step:4      # a forced health trip at update 5 (flight record,
                            # triage batch)
    sleep_one_proc@step:2   # the last rank sleeps SLEEP_FAULT_S in update 3
                            # (an injected straggler for cluster telemetry)
    actor_crash@collection:2  # an async actor dies on its first chunk of
                              # collection 2 (requeued, respawned or shrunk)
    weight_sync_drop@version:3  # the async weight publish of version 3 is
                                # dropped (actors keep version 2)

The other kinds parse, and the trainer refuses a plan that names one
(:data:`UNPORTED_KINDS` names the subsystem each waits for).

Plans come from ``config.resilience.fault_plan`` or the
``TRLX_TPU_FAULT_PLAN`` environment variable (it wins, so a relaunched run
drops a fault by clearing the variable). Sites reach the plan through the
process-wide active plan (:func:`set_active_plan` / :func:`poll_fault`), so
low-level code (``utils/checkpoint.py``) needs no trainer handle.
"""

import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_KINDS = frozenset({
    "reward_raise", "publish_raise", "sigterm", "sigint", "sigterm_one_proc",
    "nan_loss", "crash_save", "topology_shrink", "sleep_one_proc",
    "flightrec_dump", "actor_crash", "weight_sync_drop", "health_trip",
    "slow_client", "request_flood",
})

# the kinds the port has sites for
POLLED_KINDS = frozenset({
    "reward_raise", "publish_raise", "sigterm", "sigint", "nan_loss", "crash_save",
    "slow_client", "request_flood", "flightrec_dump", "health_trip", "sleep_one_proc",
    "actor_crash", "weight_sync_drop",
})
# the other kinds, and the subsystem of the port each waits for
UNPORTED_KINDS = {
    "sigterm_one_proc": "slice 21: coordinated preemption over several processes",
    "topology_shrink": "slice 21: elastic restore over several processes",
}
assert POLLED_KINDS | set(UNPORTED_KINDS) == _KINDS
# seconds the injected straggler (sleep_one_proc) stalls the last rank's step
SLEEP_FAULT_S = float(os.environ.get("TRLX_TPU_FAULT_SLEEP_S", "0.5"))
_TRIGGERS = frozenset(
    {"call", "step", "save", "resume", "collection", "version", "request"}
)


class InjectedFault(RuntimeError):
    """Raised by a fault-plan site standing in for a real failure."""


@dataclass(frozen=True)
class FaultSpec:
    """One parsed plan entry: fire ``kind`` for ``count`` consecutive
    trigger values starting at ``n``."""

    kind: str
    trigger: str  # "call" | "step" | "save"
    n: int
    count: int = 1

    def matches(self, value: int) -> bool:
        return self.n <= value < self.n + self.count


@dataclass
class FaultPlan:
    """A set of :class:`FaultSpec` plus per-site call counters.

    ``poll(kind)`` advances the counter for call/save-triggered entries and
    reports whether this invocation should fault; ``poll(kind, step=s)``
    checks step-triggered entries against the caller's step counter without
    advancing anything. Thread-safe: host-call sites poll from pipeline
    worker threads.
    """

    specs: List[FaultSpec] = field(default_factory=list)
    _counters: Dict[str, int] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    fired: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def parse(cls, plan: Optional[str]) -> "FaultPlan":
        specs: List[FaultSpec] = []
        for raw in (plan or "").split(";"):
            entry = raw.strip()
            if not entry:
                continue
            try:
                kind, rest = entry.split("@", 1)
                count = 1
                if "*" in rest:
                    rest, count_s = rest.rsplit("*", 1)
                    count = int(count_s)
                trigger, n_s = rest.split(":", 1)
                spec = FaultSpec(kind.strip(), trigger.strip(), int(n_s), count)
            except (ValueError, TypeError) as e:
                raise ValueError(
                    f"unparseable fault-plan entry {entry!r} (syntax: "
                    f"kind@trigger:N[*count]): {e}"
                ) from e
            if spec.kind not in _KINDS:
                raise ValueError(
                    f"unknown fault kind {spec.kind!r} (known: {sorted(_KINDS)})"
                )
            if spec.trigger not in _TRIGGERS:
                raise ValueError(
                    f"unknown fault trigger {spec.trigger!r} "
                    f"(known: {sorted(_TRIGGERS)})"
                )
            if spec.count < 1 or spec.n < 0:
                raise ValueError(f"fault-plan entry {entry!r}: n/count out of range")
            specs.append(spec)
        return cls(specs=specs)

    @classmethod
    def from_config(cls, plan: Optional[str]) -> "FaultPlan":
        """Parse ``plan``, letting ``TRLX_TPU_FAULT_PLAN`` override it."""
        return cls.parse(os.environ.get("TRLX_TPU_FAULT_PLAN") or plan)

    def __bool__(self) -> bool:
        return bool(self.specs)

    def poll(self, kind: str, step: Optional[int] = None,
             collection: Optional[int] = None, version: Optional[int] = None,
             request: Optional[int] = None) -> bool:
        """Should the consulting site fault now?

        With no caller counter this is an *invocation* poll: the per-kind
        call counter advances by one and call/save/resume-triggered entries
        match against it. With ``step=s`` / ``collection=c`` /
        ``version=v`` / ``request=r`` only the matching trigger's entries
        are checked against the caller's own counter (idempotent — the
        caller polls once per update / collection / publish / serve
        request)."""
        if not self.specs:
            return False
        with self._lock:
            if step is not None:
                value, triggers = step, ("step",)
            elif collection is not None:
                value, triggers = collection, ("collection",)
            elif version is not None:
                value, triggers = version, ("version",)
            elif request is not None:
                value, triggers = request, ("request",)
            else:
                value = self._counters.get(kind, 0) + 1
                self._counters[kind] = value
                triggers = ("call", "save", "resume")
            hit = any(
                s.kind == kind and s.trigger in triggers and s.matches(value)
                for s in self.specs
            )
            if hit:
                self.fired[kind] = self.fired.get(kind, 0) + 1
            return hit


# ---------------------------------------------------------------------------
# process-wide active plan: low-level sites (checkpoint commit) consult this
# without a trainer handle. One training run per process is the norm; the
# last-constructed Resilience bundle owns the slot.
# ---------------------------------------------------------------------------

_ACTIVE_PLAN: Optional[FaultPlan] = None


def set_active_plan(plan: Optional[FaultPlan]) -> None:
    global _ACTIVE_PLAN
    _ACTIVE_PLAN = plan if plan else None


def poll_fault(kind: str, step: Optional[int] = None,
               request: Optional[int] = None) -> bool:
    """A poll of the active plan, for sites without a plan handle; False
    when no plan is active."""
    plan = _ACTIVE_PLAN
    return bool(plan) and plan.poll(kind, step=step, request=request)
