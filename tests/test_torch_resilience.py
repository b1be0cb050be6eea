"""The port's resilience layer (``trlx_tpu_torch/resilience/``, the
retention ring of ``utils/checkpoint.py``) against the JAX package's, on
the CPU, unit by unit:

- ``FaultPlan`` parses the same plans (the same specs) and rejects the same
  strings, and polls the same firings;
- ``HostCallGuard`` makes the same attempt sequence, the same
  deterministic backoff delays for one seed, the same fallbacks and
  escalation, and counts the same ``resilience/*`` metrics;
- ``UpdateGuard`` takes the same actions, raises the same halts and
  counts the same metrics on the same sequences of update flags;
- ``PreemptionHandler`` installs and restores the signal handlers as
  JAX's does;
- ``prune_checkpoints`` prunes the same directories;
- a default configuration's trainer installs the preemption handler and
  retries its reward function; a plan naming a fault kind the port does
  not poll is refused, naming the subsystem it waits for.

Every comparison is exact: the code under test is host logic.
"""

import os
import signal

import numpy as np
import pytest

from trlx_tpu.observability.metrics import MetricsRegistry as JaxMetricsRegistry
from trlx_tpu.resilience import faults as jax_faults
from trlx_tpu.resilience import guard as jax_guard
from trlx_tpu.resilience import preemption as jax_preemption
from trlx_tpu.resilience import retry as jax_retry
from trlx_tpu.utils.checkpoint import prune_checkpoints as jax_prune_checkpoints
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.observability.metrics import MetricsRegistry
from trlx_tpu_torch.resilience import (
    UNPORTED_KINDS,
    FaultPlan,
    HostCallGuard,
    NonFiniteUpdateError,
    PreemptionHandler,
    TrainingPreempted,
    UpdateGuard,
    neutral_rewards,
)
from trlx_tpu_torch.resilience.faults import POLLED_KINDS
from trlx_tpu_torch.trainer.base import reject_unported
from trlx_tpu_torch.utils.checkpoint import prune_checkpoints
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

PLANS = [
    "",
    "   ",
    "reward_raise@call:3*2",
    "sigterm@step:5",
    "sigint@step:0",
    "nan_loss@step:7; crash_save@save:2",
    " publish_raise @ call : 1 * 3 ;",
    "topology_shrink@resume:1",
    "sleep_one_proc@step:2*3; flightrec_dump@step:4",
    "actor_crash@collection:2; weight_sync_drop@version:3",
    "health_trip@step:1; slow_client@request:2; request_flood@step:3",
    "sigterm_one_proc@step:5",
    # rejected: syntax, kind, trigger, range
    "reward_raise",
    "reward_raise@call",
    "reward_raise@call:x",
    "reward_raise@call:1*y",
    "bogus@step:1",
    "sigterm@epoch:1",
    "sigterm@step:-1",
    "sigterm@step:1*0",
]


def _specs(plan):
    return [(s.kind, s.trigger, s.n, s.count) for s in plan.specs]


def _parse(cls, text):
    try:
        return "ok", _specs(cls.parse(text))
    except ValueError:
        return "ValueError", None


@pytest.mark.parametrize("text", PLANS)
def test_fault_plan_parses_as_jax(text):
    assert _parse(FaultPlan, text) == _parse(jax_faults.FaultPlan, text)


def test_fault_kinds_are_jax_kinds():
    assert POLLED_KINDS | set(UNPORTED_KINDS) == jax_faults._KINDS
    assert not POLLED_KINDS & set(UNPORTED_KINDS)


def test_fault_plan_polls_as_jax(monkeypatch):
    text = "reward_raise@call:2*2; nan_loss@step:3; crash_save@save:1; sigterm@step:5*2"
    ours, theirs = FaultPlan.parse(text), jax_faults.FaultPlan.parse(text)
    calls = [("reward_raise", {})] * 5 + [("crash_save", {})] * 2
    calls += [(kind, {"step": s}) for s in range(8) for kind in ("nan_loss", "sigterm")]
    assert [ours.poll(k, **kw) for k, kw in calls] == [theirs.poll(k, **kw) for k, kw in calls]
    assert ours.fired == theirs.fired
    # the environment variable wins over the config in both
    monkeypatch.setenv("TRLX_TPU_FAULT_PLAN", "sigint@step:1")
    assert (_specs(FaultPlan.from_config("sigterm@step:5"))
            == _specs(jax_faults.FaultPlan.from_config("sigterm@step:5")))


def _guard_run(guard_cls, registry_cls, failures, plan=None, **kw):
    """Call a guarded function that fails its first ``failures`` calls;
    the sequence of outcomes, the recorded sleeps and the counters."""
    registry = registry_cls()
    sleeps, calls = [], []

    def fn(samples, prompts=None, outputs=None):
        calls.append(len(calls))
        if len(calls) <= failures:
            raise RuntimeError(f"down {len(calls)}")
        return [1.0] * len(samples)

    guard = guard_cls(fn, name="reward", metrics=registry, sleep=sleeps.append, plan=plan, **kw)
    outcomes = []
    for _ in range(3):
        try:
            outcomes.append(guard(["a", "b"], prompts=["p", "q"], outputs=["x", "y"]))
        except RuntimeError as e:  # InjectedFault is a RuntimeError in both packages
            outcomes.append(type(e).__name__)
    return outcomes, sleeps, len(calls), registry.snapshot()


@pytest.mark.parametrize("failures,kw", [
    (0, {}),
    (2, dict(retries=3, backoff_s=0.5, seed=7)),
    (5, dict(retries=3, backoff_s=0.5, backoff_max_s=1.0, seed=3)),
    (9, dict(retries=2, backoff_s=0.1, fallback="neutral", seed=1)),
    (9, dict(retries=1, backoff_s=0.1, fallback="neutral", max_consecutive_fallbacks=2, seed=2)),
    (1, dict(retries=0, fallback="neutral", seed=0)),
])
def test_host_call_guard_matches_jax(failures, kw):
    if kw.get("fallback") == "neutral":
        kw_p = dict(kw, neutral_fn=neutral_rewards)
        kw_j = dict(kw, neutral_fn=jax_retry.neutral_rewards)
    else:
        kw_p = kw_j = kw
    ours = _guard_run(HostCallGuard, MetricsRegistry, failures, **kw_p)
    theirs = _guard_run(jax_retry.HostCallGuard, JaxMetricsRegistry, failures, **kw_j)
    assert ours == theirs


def test_host_call_guard_fault_plan_matches_jax():
    text = "reward_raise@call:2*3"
    ours = _guard_run(HostCallGuard, MetricsRegistry, 0, plan=FaultPlan.parse(text), seed=5)
    theirs = _guard_run(jax_retry.HostCallGuard, JaxMetricsRegistry, 0,
                        plan=jax_faults.FaultPlan.parse(text), seed=5)
    assert ours == theirs
    assert ours[3]["resilience/reward_retries"] == 3.0


def test_host_call_guard_backoff_delays_match_jax():
    ours = HostCallGuard(lambda: None, name="reward", backoff_s=0.3, backoff_max_s=2.0, seed=11)
    theirs = jax_retry.HostCallGuard(lambda: None, name="reward", backoff_s=0.3,
                                     backoff_max_s=2.0, seed=11)
    assert [ours.backoff_delay(a) for a in range(8)] == [theirs.backoff_delay(a)
                                                        for a in range(8)]


def test_host_call_guard_timeout_drops_the_late_result():
    """An attempt that overruns its timeout fails and is abandoned; its
    late result never reaches the neutral batch the fallback returned."""
    import threading

    release = threading.Event()
    late = []

    def slow(samples, **kw):
        release.wait(5.0)
        out = [9.0] * len(samples)
        late.append(out)
        return out

    registry = MetricsRegistry()
    guard = HostCallGuard(slow, name="reward", retries=0, timeout_s=0.05, fallback="neutral",
                          neutral_fn=neutral_rewards, metrics=registry, sleep=lambda s: None)
    got = guard(["a", "b"])
    release.set()
    assert got == [0.0, 0.0]
    assert registry.counter("resilience/reward_fallbacks") == 1.0
    for t in threading.enumerate():
        if t.name.endswith("-guard"):
            t.join(5.0)
    assert late and got == [0.0, 0.0]


SEQUENCES = [[1, 1, 1], [1, 0, 1, 0, 0, 1], [0, 0, 0, 0], [0], [1, 0]]


def _guard_actions(guard_cls, registry_cls, error_cls, policy, flags, key, max_consecutive=3):
    registry = registry_cls()
    guard = guard_cls(policy=policy, max_consecutive=max_consecutive, metrics=registry)
    actions = []
    for ok in flags:
        try:
            actions.append(guard.after_step({key: float(ok)}))
        except error_cls as e:
            actions.append(f"halt: {e}")
            break
    return actions, registry.snapshot()


@pytest.mark.parametrize("policy", ["off", "skip", "rollback", "halt"])
def test_update_guard_matches_jax(policy):
    from trlx_tpu_torch.resilience import UPDATE_OK_KEY

    assert UPDATE_OK_KEY == jax_guard.UPDATE_OK_KEY
    for flags in SEQUENCES:
        assert (_guard_actions(UpdateGuard, MetricsRegistry, NonFiniteUpdateError, policy, flags,
                               UPDATE_OK_KEY)
                == _guard_actions(jax_guard.UpdateGuard, JaxMetricsRegistry,
                                  jax_guard.NonFiniteUpdateError, policy, flags,
                                  jax_guard.UPDATE_OK_KEY)), flags
    with pytest.raises(ValueError, match="unknown update_guard policy"):
        UpdateGuard(policy="retry")


def test_preemption_handler_installs_and_restores():
    before = signal.getsignal(signal.SIGTERM)
    handler = PreemptionHandler(metrics=MetricsRegistry())
    with handler:
        assert signal.getsignal(signal.SIGTERM) == handler._on_signal
        signal.raise_signal(signal.SIGTERM)
        assert handler.requested and handler.signal_received == "SIGTERM"
    assert signal.getsignal(signal.SIGTERM) == before
    assert handler.metrics.counter("resilience/preemptions") == 1.0
    assert issubclass(TrainingPreempted, SystemExit)
    assert TrainingPreempted("x").code == jax_preemption.TrainingPreempted("x").code == 0
    with PreemptionHandler(enabled=False) as off:
        assert signal.getsignal(signal.SIGTERM) == before
        off.request("test")
        assert off.requested


def _layout(root, dirs):
    """``checkpoint_<n>`` directories both packages read as committed
    (``state.pt`` and ``state/`` with the marker) or as a crash mid-save
    (the staged file and tree only)."""
    for name, committed in dirs.items():
        d = os.path.join(root, name)
        staged = "" if committed else ".staging"
        os.makedirs(os.path.join(d, "state" + staged), exist_ok=True)
        with open(os.path.join(d, "state.pt" + staged), "w") as f:
            f.write("x")
        if committed:
            with open(os.path.join(d, "COMMITTED"), "w") as f:
                f.write("1\n")


@pytest.mark.parametrize("keep", [0, 1, 2, 5])
def test_prune_checkpoints_matches_jax(tmp_path, keep):
    dirs = {"checkpoint_2": True, "checkpoint_10": True, "checkpoint_04": True,
            "checkpoint_6": False, "checkpoint_12": True, "best_checkpoint": True,
            "checkpoint_x": True}
    got = {}
    for pkg, fn in (("port", prune_checkpoints), ("jax", jax_prune_checkpoints)):
        root = str(tmp_path / pkg)
        _layout(root, dirs)
        pruned = fn(root, keep)
        got[pkg] = ([os.path.basename(p) for p in pruned], sorted(os.listdir(root)))
    assert got["port"] == got["jax"]
    assert "best_checkpoint" in got["port"][1] and "checkpoint_6" in got["port"][1]


def _config(tmp_path, **resilience):
    d = default_ppo_config().to_dict()
    d["model"].update(model_path="builtin:gpt2-test")
    d["train"].update(checkpoint_dir=str(tmp_path))
    d["resilience"].update(resilience)
    return TRLConfig.from_dict(d)


def test_default_trainer_hardens_as_jax(tmp_path):
    """``default_ppo_config()`` as it stands: the trainer installs the
    preemption handler for ``learn()`` and retries a reward function that
    fails once, as JAX's ``ResilienceConfig`` defaults do."""
    from trlx_tpu.resilience import Resilience as JaxResilience
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    calls = []

    def flaky(samples, prompts, outputs):
        calls.append(1)
        if len(calls) == 1:
            raise ConnectionError("reward service down")
        return [1.0] * len(samples)

    trainer = PPOTrainer(config=_config(tmp_path, reward_backoff_s=0.0), reward_fn=flaky,
                         device="cpu")
    rcfg = trainer.config.resilience
    assert rcfg.handle_preemption and rcfg.reward_retries == 3
    assert trainer.resilience.preemption.enabled
    assert isinstance(trainer.reward_fn, HostCallGuard)
    assert trainer.reward_fn(samples=["a"], prompts=["a"], outputs=[""]) == [1.0]
    assert trainer.metrics.counter("resilience/reward_retries") == 1.0
    jax = JaxResilience(default_ppo_config())
    assert (trainer.resilience.preemption.signal_names, trainer.reward_fn.retries,
            trainer.reward_fn.fallback) == (jax.preemption.signal_names,
                                             jax.harden_reward_fn(flaky).retries,
                                             jax.harden_reward_fn(flaky).fallback)
    np.testing.assert_equal(trainer.tracker.path,
                            os.path.join(str(tmp_path), "logs", "stats.jsonl"))


@pytest.mark.parametrize("kind", ["sigterm_one_proc", "topology_shrink"])
def test_unported_fault_kind_names_its_subsystem(tmp_path, kind):
    """The last two kinds that waited for a subsystem (coordinated
    preemption and elastic restore, ``resilience/elastic.py``) are polled
    now: no kind is unported, and a plan naming either runs."""
    assert not UNPORTED_KINDS and kind in POLLED_KINDS
    reject_unported(_config(tmp_path, fault_plan=f"sigterm@step:3; {kind}@step:1"), True, True)


def test_polled_fault_kinds_and_env_plan_are_checked(tmp_path, monkeypatch):
    reject_unported(_config(tmp_path, fault_plan="; ".join(f"{k}@step:1"
                                                           for k in sorted(POLLED_KINDS))),
                    True, True)
    monkeypatch.setenv("TRLX_TPU_FAULT_PLAN", "topology_shrink@resume:1; bogus@step:1")
    with pytest.raises(ValueError, match="bogus"):
        reject_unported(_config(tmp_path), True, True)
