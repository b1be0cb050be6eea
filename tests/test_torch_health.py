"""Training-dynamics summaries and health detectors of the port
(``observability/dynamics.py``, ``observability/health.py``) against the
JAX package's, on the CPU, and the whole observability slice on the
presets' serial PPO:

- ``hist_percentile``, ``hist_mass_outside`` and :class:`DynamicsSummarizer`
  on the same seeded histograms: exactly equal;
- :class:`HealthMonitor` on the same stats streams (each detector's trip,
  a forced trip, a noisy healthy stream with non-finite values, the
  detectors turned off): the same gauges at every update, the same
  verdicts, trips and flight-recorder payloads, exactly;
- ``trlx_tpu_torch.train`` against ``trlx_tpu.train`` on
  ``default_ppo_config()`` cut as ``tests/test_torch_serial_rollouts.py``
  cuts it, from the JAX initial weights, under a fault plan with
  ``flightrec_dump``, ``health_trip`` and ``sleep_one_proc``: the same span
  names in the same nesting in ``spans.jsonl``; every ``dist/*`` and
  ``health/*`` stat within ``DIST_ATOL``; the same flight-recorder dumps;
  and the train step's FLOP count within ``FLOPS_RTOL`` of XLA's
  ``cost_analysis`` (measured: the port's count is 0.904 of JAX's at this
  size, as ``FlopCounterMode`` leaves out the elementwise ops and
  reductions XLA counts).
"""

import json
import os
from collections import Counter

import numpy as np
import pytest

import trlx_tpu
import trlx_tpu_torch
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.observability import FlightRecorder as JaxFlightRecorder
from trlx_tpu.observability import MetricsRegistry as JaxMetricsRegistry
from trlx_tpu.observability import dynamics as jax_dynamics
from trlx_tpu.observability import health as jax_health
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.observability import FlightRecorder, MetricsRegistry
from trlx_tpu_torch.observability import dynamics, health
from trlx_tpu_torch.trainer.ppo import PPOTrainer
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

# dist/* and health/* of the two PPO runs (their losses agree to ~1e-6)
DIST_ATOL = 1e-5
# the train step's FLOPs: the port (FlopCounterMode's matmuls and the
# kernels' formulas) against XLA's cost_analysis times the JAX mesh's
# devices (XLA counts elementwise ops and reductions too); measured: the
# port's count is 0.904 of XLA's at this size
FLOPS_RTOL = 0.12


# ---------------------------------------------------------------------------
# the summaries
# ---------------------------------------------------------------------------


def _hists(seed):
    rs = np.random.RandomState(seed)
    out = {}
    for name in dynamics.SKETCH_RANGES:
        counts = rs.poisson(rs.uniform(0.1, 20.0), size=dynamics.SKETCH_BINS).astype(np.float32)
        if seed % 3 == 0:
            counts[rs.randint(0, 4):] = 0.0  # mass piled at the low edge
        out[f"dist/{name}_hist"] = counts
    out["dist/empty_hist"] = np.zeros(dynamics.SKETCH_BINS, np.float32)
    out["dist/custom_hist"] = rs.uniform(0, 3, size=16)  # an unknown name: (0, 1)
    out["losses/total_loss"] = 0.5
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cliprange", [None, 0.2, 0.5])
def test_summarizer_matches_jax(seed, cliprange):
    hists = _hists(seed)
    got = dynamics.DynamicsSummarizer(cliprange).summarize(hists)
    want = jax_dynamics.DynamicsSummarizer(cliprange).summarize(hists)
    assert got == want
    has_ratio = hists["dist/log_ratio_hist"].sum() > 0
    assert ("dist/ratio_outside_clip_frac" in got) == bool(cliprange and has_ratio)
    assert "dist/empty_p50" not in got and "dist/custom_p95" in got


@pytest.mark.parametrize("seed", range(4))
def test_hist_helpers_match_jax(seed):
    rs = np.random.RandomState(seed)
    counts = rs.poisson(5.0, size=32).astype(np.float64)
    lo, hi = sorted(rs.uniform(-5, 5, size=2))
    for q in (0.0, 5.0, 37.5, 50.0, 95.0, 100.0):
        assert dynamics.hist_percentile(counts, lo, hi, q) == jax_dynamics.hist_percentile(
            counts, lo, hi, q)
    for lower, upper in ((lo, hi), (lo - 1, lo + 0.3), (0.1, 0.2), (hi, hi + 1)):
        assert dynamics.hist_mass_outside(counts, lo, hi, lower, upper) == \
            jax_dynamics.hist_mass_outside(counts, lo, hi, lower, upper)
    assert dynamics.hist_mass_outside(np.zeros(8), 0, 1, 0.2, 0.4) == 0.0


def test_detector_constants_are_jax_constants():
    for name in ("DETECTORS", "DEFAULT_WINDOW", "KL_RUNAWAY_FACTOR", "ENTROPY_FLOOR",
                 "CLIPFRAC_SATURATION", "EV_FLOOR", "REWARD_FLATLINE_STD",
                 "REWARD_FLATLINE_WINDOW", "REPEAT_FRAC_CEIL"):
        assert getattr(health, name) == getattr(jax_health, name), name
    assert dynamics.SKETCH_RANGES == jax_dynamics.SKETCH_RANGES
    assert dynamics.SKETCH_BINS == jax_dynamics.SKETCH_BINS


# ---------------------------------------------------------------------------
# the detectors
# ---------------------------------------------------------------------------


def _stream(kind, n=12, seed=0):
    """``[(rollout stats or None, step stats), ...]`` driving one detector
    (or none, for ``healthy``)."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        step = {"dist/entropy_p50": float(rs.uniform(1, 5)),
                "policy/clipfrac": float(rs.uniform(0, 0.3)),
                "values/values_error": float(rs.uniform(0, 0.5)),
                "returns/std": float(rs.uniform(0.8, 1.2))}
        rollout = None
        if i % 3 == 0:
            rollout = {"policy/sqrt_kl": float(rs.uniform(0, 0.1)),
                       "exp_scores/mean": float(rs.randn()),
                       "rollout/repetition_frac": float(rs.uniform(0, 0.3))}
        if kind == "entropy_collapse" and i >= 3:
            step["dist/entropy_p50"] = 0.01
        if kind == "clipfrac_saturation" and i >= 2:
            step["policy/clipfrac"] = 0.97
        if kind == "value_ev_collapse" and i >= 1:
            step["values/values_error"] = 2.0
        if kind == "kl_runaway" and rollout is not None and i >= 3:
            rollout["policy/sqrt_kl"] = 1.5
        if kind == "reward_flatline" and rollout is not None:
            rollout["exp_scores/mean"] = 0.25
        if kind == "gen_canary" and rollout is not None and i >= 3:
            rollout["rollout/repetition_frac"] = 0.95
        if kind == "healthy":
            # non-finite and non-numeric values are ignored alike
            step["policy/clipfrac"] = [float("nan"), "x", None, step["policy/clipfrac"]][i % 4]
            if rollout is not None and i % 2:
                rollout["policy/sqrt_kl"] = float("inf")
        out.append((rollout, step))
    return out


def _run_monitor(mod, reg, rec, stream, force_at=None, **kwargs):
    mon = mod.HealthMonitor(metrics=reg, flightrec=rec, **kwargs)
    trace = []
    for i, (rollout, step) in enumerate(stream):
        if rollout is not None:
            mon.observe_rollout(rollout)
        if force_at == i:
            mon.force_trip("fault_plan", step=i)
        gauges = mon.update(step, step=i)
        trace.append((gauges, mon.verdict, mon.just_tripped))
    return trace, dict(mon.trip_counts), reg.snapshot(), [
        (r["kind"], r.get("data")) for r in rec.snapshot()]


@pytest.mark.parametrize("kind,force_at", [
    ("kl_runaway", None), ("entropy_collapse", None), ("clipfrac_saturation", None),
    ("value_ev_collapse", None), ("reward_flatline", None), ("gen_canary", None),
    ("healthy", None), ("healthy", 5)])
def test_health_monitor_matches_jax(kind, force_at):
    stream = _stream(kind)
    kw = dict(kl_target=0.1, window=4)
    got = _run_monitor(health, MetricsRegistry(), FlightRecorder(), stream, force_at, **kw)
    want = _run_monitor(jax_health, JaxMetricsRegistry(), JaxFlightRecorder(), stream,
                        force_at, **kw)
    assert got == want
    tripped = [t[2] for t in got[0] if t[2] is not None]
    if kind != "healthy":
        assert tripped and tripped[0] == kind
    elif force_at is not None:
        assert tripped == ["injected:fault_plan"] and got[0][force_at][1] == tripped[0]
    else:
        assert not tripped


def test_health_monitor_off_and_window_from_env(monkeypatch):
    monkeypatch.setenv("TRLX_TPU_HEALTH", "0")
    monkeypatch.setenv("TRLX_TPU_HEALTH_WINDOW", "3")
    stream = _stream("clipfrac_saturation")
    got = _run_monitor(health, MetricsRegistry(), FlightRecorder(), stream)
    want = _run_monitor(jax_health, JaxMetricsRegistry(), JaxFlightRecorder(), stream)
    assert got == want
    assert health.HealthMonitor().window == 3
    assert all(t[1] == "ok" for t in got[0])


# ---------------------------------------------------------------------------
# the slice: serial PPO against JAX's train()
# ---------------------------------------------------------------------------

PLAN = "flightrec_dump@step:2; health_trip@step:4; sleep_one_proc@step:3; nan_loss@step:6"


def _config_dict(tmp):
    """``tests/test_torch_serial_rollouts.py``'s cut of the preset
    (gpt2-test, f32, greedy, two collections of 16 updates), with the
    fault plan and the update guard's skip."""
    from trlx_tpu.data.default_configs import default_ppo_config

    d = default_ppo_config().to_dict()
    d["model"].update(model_path="builtin:gpt2-test", num_layers_unfrozen=1)
    d["parallel"].update(compute_dtype="float32")
    d["train"].update(seq_length=24, total_steps=20, checkpoint_dir=str(tmp))
    d["method"]["gen_kwargs"].update(max_new_tokens=8, do_sample=False)
    d["resilience"].update(fault_plan=PLAN, update_guard="skip")
    return d


def _prompts(n=48, seed=0):
    rs = np.random.RandomState(seed)
    return ["".join(chr(c) for c in rs.randint(97, 123, size=rs.randint(3, 17)))
            for _ in range(n)]


def reward_fn(samples, prompts, outputs):
    return [sum(ch in "aeiou" for ch in o) / max(len(o), 1) for o in outputs]


class _Recorder:
    def __init__(self):
        self.history = []

    def log(self, stats, step):
        self.history.append((int(step), dict(stats)))

    def finish(self):
        pass


def _logs(tmp):
    logs = os.path.join(str(tmp), "logs")
    spans = [json.loads(line) for line in open(os.path.join(logs, "spans.jsonl"))]
    flightrec = json.load(open(os.path.join(logs, "flightrec.json")))
    return spans, flightrec, sorted(os.listdir(os.path.join(logs, "triage")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, monkeypatch_module):
    monkeypatch_module.setenv("TRLX_TPU_FAULT_SLEEP_S", "0.05")
    monkeypatch_module.delenv("TRLX_TPU_MFU", raising=False)
    jtmp, ptmp = tmp_path_factory.mktemp("jax_obs"), tmp_path_factory.mktemp("port_obs")
    out = {}

    def jax_hook(trainer):
        out["params0"] = {k: v for k, v in __import__("jax").tree_util.tree_map(
            np.asarray, trainer.state.params).items()}
        trainer.tracker = _Recorder()

    jax_trainer = trlx_tpu.train(reward_fn=reward_fn, prompts=_prompts(),
                                 config=JaxTRLConfig.from_dict(_config_dict(jtmp)),
                                 init_trainer_hook=jax_hook)

    def port_hook(trainer):
        trainer.model.load_state_dict(params_from_jax(out["params0"], trainer.tcfg))
        trainer.ref_params = trainer._ref_snapshot()
        trainer.tracker = _Recorder()

    port_trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_prompts(),
                                        config=TRLConfig.from_dict(_config_dict(ptmp)),
                                        init_trainer_hook=port_hook, device="cpu")
    assert isinstance(port_trainer, PPOTrainer)
    return {"jax": (jax_trainer, _logs(jtmp)), "port": (port_trainer, _logs(ptmp))}


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _structure(spans):
    """(name, parent) pairs by containment on each track, counted."""
    pairs = []
    for e in spans:
        parents = [p for p in spans if p is not e and p["tid"] == e["tid"]
                   and p["start_s"] <= e["start_s"]
                   and e["start_s"] + e["dur_s"] <= p["start_s"] + p["dur_s"]]
        parent = min(parents, key=lambda p: p["dur_s"])["name"] if parents else None
        pairs.append((e["name"], parent))
    return Counter(pairs)


def test_span_names_and_nesting_match_jax(runs):
    (_, (jspans, _, _)), (_, (pspans, _, _)) = runs["jax"], runs["port"]
    assert Counter(s["name"] for s in pspans) == Counter(s["name"] for s in jspans)
    assert _structure(pspans) == _structure(jspans)
    assert Counter(s["name"] for s in pspans)["train_step"] == 20


def _steps(trainer):
    return [(s, st) for s, st in trainer.tracker.history if "gradients/global_norm" in st]


def test_dist_and_health_stats_match_jax(runs):
    jax_trainer, port_trainer = runs["jax"][0], runs["port"][0]
    jsteps, psteps = _steps(jax_trainer), _steps(port_trainer)
    assert len(psteps) == len(jsteps) == 20
    compared = 0
    for (s_p, st_p), (s_j, st_j) in zip(psteps, jsteps):
        assert s_p == s_j
        keys = sorted(k for k in st_j if k.startswith(("dist/", "health/")))
        assert keys == sorted(k for k in st_p if k.startswith(("dist/", "health/"))), s_p
        for k in keys:
            np.testing.assert_allclose(st_p[k], float(st_j[k]), rtol=0, atol=DIST_ATOL,
                                       err_msg=f"step {s_p} {k}")
            compared += 1
    assert compared > 20 * 20
    # the forced trip at update 4 and the guard's triage at the poisoned 6
    assert psteps[4][1]["health/verdict"] == 1.0
    # the collections' rollout-side summaries
    jcol = [st for _, st in jax_trainer.tracker.history if "time/exp" in st]
    pcol = [st for _, st in port_trainer.tracker.history if "time/exp" in st]
    for a, b in zip(pcol, jcol):
        for k in sorted(k for k in b if k.startswith("dist/") or k in (
                "rollout/gen_len_p50", "rollout/gen_len_p95", "rollout/repetition_frac")):
            np.testing.assert_allclose(a[k], float(b[k]), rtol=0, atol=DIST_ATOL, err_msg=k)


def test_flight_records_and_triage_match_jax(runs):
    (_, (_, jrec, jtri)), (_, (_, prec, ptri)) = runs["jax"], runs["port"]
    assert ptri == jtri
    assert {"step4.npz", "step6.npz"} <= set(ptri)  # the forced trip, the guard's
    assert prec["dump_number"] == jrec["dump_number"]
    assert prec["reason"] == jrec["reason"]
    assert set(prec) == set(jrec)
    assert Counter(r["kind"] for r in prec["records"] if r["kind"] != "span") == Counter(
        r["kind"] for r in jrec["records"] if r["kind"] != "span")
    port_trainer = runs["port"][0]
    snap = port_trainer.metrics.snapshot()
    assert snap["flightrec/dumps"] == prec["dump_number"]
    assert snap["health/triage_dumps"] == len(ptri)


def test_train_step_flops_within_tolerance_of_xla(runs):
    """JAX's count is per device of its data-parallel CPU mesh; the port
    runs the whole step on one device."""
    jax_trainer, port_trainer = runs["jax"][0], runs["port"][0]
    want = jax_trainer._train_step_flops * jax_trainer.mesh.devices.size
    got = port_trainer._train_step_flops
    assert want > 0 and got and got > 0
    np.testing.assert_allclose(got, want, rtol=FLOPS_RTOL)
    mfus = [st.get("throughput/mfu") for _, st in _steps(port_trainer)]
    assert mfus[0] is None and all(m is not None and m > 0 for m in mfus[1:])
