"""Elastic restore and coordinated preemption of the port
(``trlx_tpu_torch/resilience/elastic.py``): the counterparts of JAX's
``tests/test_resilience.py::TestElasticRestore`` and of
``tests/test_multihost.py``'s elastic worker, on the CPU.

- every checkpoint commits ``topology.json`` beside its state, which
  describes the topology it was saved from (one process, or two ranks at
  ``data`` 2);
- shrink (a two-rank emergency checkpoint resumed in one process) and grow
  (a one-process emergency checkpoint resumed on two ranks) take the
  reshard path once and continue JAX's uninterrupted ``train()`` within
  1e-5;
- a matching topology takes the fast path; ``resilience.elastic: false``
  raises on a changed topology and names a forced fault; a changed global
  shape raises; a checkpoint without a manifest restores on a matching
  topology; a commit interrupted between its marker and its renames heals;
  ``topology_shrink@resume:N`` forces the reshard, also under a trainer's
  emergency resume;
- ``sigterm_one_proc`` signals process 0 only, and both ranks stop at the
  same step with one committed checkpoint;
- ``push_to_hub`` under a two-rank mesh: rank 0 alone uploads, and the
  files equal a one-process export of the same weights.

The several-process runs use ``tests/torch_parallel_rl_worker.py`` on
``gloo`` (PPO on the cut preset of ``tests/torch_rl_runs.py``).
"""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

from torch_rl_runs import check_params, check_steps, config_dict, jax_run, run_world
from torch_threads import use_one_cpu_thread

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.builder import build_causal_lm
from trlx_tpu_torch.observability.metrics import MetricsRegistry
from trlx_tpu_torch.resilience import (
    MANIFEST_NAME,
    ElasticRestoreError,
    FaultPlan,
    build_manifest,
    coordinate_preemption,
    manifest_mismatch,
    read_manifest,
    restore_state_elastic,
    set_active_plan,
)
from trlx_tpu_torch.utils.checkpoint import (
    COMMIT_MARKER,
    STATE_FILE,
    is_committed,
    load_state,
    save_state,
)

use_one_cpu_thread()

PREEMPT_AT = 3
PPO_KEYS = ("losses/total_loss", "losses/policy_loss", "losses/value_loss",
            "gradients/global_norm")
_RUNS = {}


# ---------------------------------------------------------------------------
# restore_state_elastic on one process
# ---------------------------------------------------------------------------


def _model_and_optimizer(seed=0):
    model, tcfg = build_causal_lm("builtin:gpt2-test", seed=seed, device="cpu", head="value",
                                  param_dtype=torch.float32, dtype=torch.float32)
    model.requires_grad_(True)
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3)
    out = model(torch.arange(12).reshape(2, 6))
    (out["logits"].sum() + out["value"].sum()).backward()
    optimizer.step()
    return model, optimizer


def _saved(tmp_path, manifest=True):
    model, optimizer = _model_and_optimizer()
    d = str(tmp_path / "checkpoint_1")
    save_state(d, {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                   "step": 1}, manifest=build_manifest(model) if manifest else None)
    return d, model, optimizer


def _fresh():
    return _model_and_optimizer(seed=1)


def _equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return sorted(sa) == sorted(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)


def _rewrite_manifest(d, edit):
    path = os.path.join(d, MANIFEST_NAME)
    manifest = json.load(open(path))
    edit(manifest)
    json.dump(manifest, open(path, "w"))


@pytest.fixture(autouse=True)
def _no_plan():
    set_active_plan(None)
    yield
    set_active_plan(None)


@pytest.mark.parametrize("world", [1, 2])
def test_manifest_describes_the_topology(tmp_path, world, preempted_world2):
    if world == 1:
        d, model, _ = _saved(tmp_path)
        assert sorted(os.listdir(d)) == sorted([COMMIT_MARKER, MANIFEST_NAME, STATE_FILE])
    else:
        d = preempted_world2["checkpoint"]
    manifest = read_manifest(d)
    assert manifest["format"] == 1
    mesh = manifest["mesh"]
    assert mesh["axes"] == ["data", "pipe", "fsdp", "model", "sequence", "expert"]
    assert mesh["shape"] == [world, 1, 1, 1, 1, 1]
    assert mesh["process_count"] == mesh["device_count"] == world
    leaves = manifest["leaves"]
    # JAX's paths and dims: a Linear weight is flax's [in, out] kernel
    rec = leaves["backbone/h_0/attn/q_proj/kernel"]
    assert rec["dtype"] == "float32" and rec["shape"] == [64, 64]
    assert "backbone/wte/embedding" in leaves and "v_head/out_proj/bias" in leaves
    sharded = [r["spec"] for r in leaves.values() if "fsdp" in r["spec"]]
    assert bool(sharded) == (world > 1)  # FSDP2's Shard(dim) under the mesh


def test_matching_topology_takes_the_fast_path(tmp_path):
    d, model, optimizer = _saved(tmp_path)
    live, live_opt = _fresh()
    metrics = MetricsRegistry()
    state = restore_state_elastic(d, live, live_opt, metrics=metrics)
    assert state["step"] == 1 and _equal(live, model)
    assert metrics.counter("resilience/elastic_restores") == 0.0
    assert manifest_mismatch(read_manifest(d), None) is None


@pytest.mark.parametrize("cause", ["topology", "fault"])
def test_strict_mode_raises_and_names_a_forced_fault(tmp_path, cause):
    d, _, _ = _saved(tmp_path)
    if cause == "topology":
        _rewrite_manifest(d, lambda m: m["mesh"].update(shape=[2, 1, 1, 1, 1, 1],
                                                        process_count=2, device_count=2))
        match = r"different topology \(shape: saved \[2, 1, 1, 1, 1, 1\]"
    else:
        set_active_plan(FaultPlan.parse("topology_shrink@resume:1"))
        match = "fault plan injected topology_shrink"
    live, live_opt = _fresh()
    with pytest.raises(ElasticRestoreError, match=match):
        restore_state_elastic(d, live, live_opt, elastic=False)


def test_shape_drift_raises(tmp_path):
    d, _, _ = _saved(tmp_path)
    _rewrite_manifest(d, lambda m: m["leaves"]["backbone/wte/embedding"].update(shape=[7, 64]))
    live, live_opt = _fresh()
    with pytest.raises(ElasticRestoreError, match="global shape"):
        restore_state_elastic(d, live, live_opt)


def test_manifestless_checkpoint_restores_on_a_matching_topology(tmp_path):
    d, model, _ = _saved(tmp_path, manifest=False)
    assert read_manifest(d) is None
    live, live_opt = _fresh()
    metrics = MetricsRegistry()
    restore_state_elastic(d, live, live_opt, metrics=metrics)
    assert _equal(live, model) and metrics.counter("resilience/elastic_restores") == 0.0


def test_interrupted_swap_heals(tmp_path):
    """A crash between the marker and the renames leaves the staged files
    and a marker reading ``swap``: the directory counts as committed and
    the first read finishes the renames."""
    d, model, _ = _saved(tmp_path)
    for name in (STATE_FILE, MANIFEST_NAME):
        os.replace(os.path.join(d, name), os.path.join(d, name + ".staging"))
    with open(os.path.join(d, COMMIT_MARKER), "w") as f:
        f.write("swap\n")
    assert is_committed(d)
    live, live_opt = _fresh()
    restore_state_elastic(d, live, live_opt)
    assert _equal(live, model)
    assert sorted(os.listdir(d)) == sorted([COMMIT_MARKER, MANIFEST_NAME, STATE_FILE])
    # a stale staged file beside a committed marker is never promoted
    torch.save({"step": 9}, os.path.join(d, STATE_FILE + ".staging"))
    assert load_state(d)["step"] == 1


def test_topology_shrink_forces_the_reshard(tmp_path):
    d, model, optimizer = _saved(tmp_path)
    set_active_plan(FaultPlan.parse("topology_shrink@resume:2"))
    metrics = MetricsRegistry()
    for n in (1, 2):
        live, live_opt = _fresh()
        restore_state_elastic(d, live, live_opt, metrics=metrics)
        assert _equal(live, model)
        assert metrics.counter("resilience/elastic_restores") == float(n == 2)
    assert metrics.snapshot()["resilience/reshard_s"] >= 0.0
    assert live_opt.state_dict()["state"][0]["exp_avg"].equal(
        optimizer.state_dict()["state"][0]["exp_avg"])


def test_coordinate_preemption_in_one_process():
    assert coordinate_preemption(True) and not coordinate_preemption(False)
    seen = []
    assert coordinate_preemption(False, beat=lambda flag: seen.append(flag) or True)
    assert seen == [False]


# ---------------------------------------------------------------------------
# trainers: emergency checkpoints across topologies
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ppo(tmp_path_factory):
    if "jax" not in _RUNS:
        _RUNS["jax"] = jax_run("ppo", tmp_path_factory.mktemp("jax_elastic"))
    return _RUNS["jax"]


def _preempted(root, jax_ppo, world, plan, **parallel):
    d = config_dict("ppo", root / "ckpt", **parallel)
    d["resilience"].update(fault_plan=plan)
    got = run_world("ppo", root / "run", d, jax_ppo["params0"], world=world)
    committed = sorted(p for p in os.listdir(root / "ckpt") if p.startswith("checkpoint_")
                       and is_committed(str(root / "ckpt" / p)))
    return got, committed, d


@pytest.fixture(scope="module")
def preempted_world2(tmp_path_factory, jax_ppo):
    """PPO at ``data`` 2 with ``sigterm_one_proc@step:3``: rank 0 alone is
    signalled, and the coordinated flag stops both ranks there."""
    if "world2" not in _RUNS:
        root = tmp_path_factory.mktemp("preempted_world2")
        got, committed, d = _preempted(root, jax_ppo, 2, f"sigterm_one_proc@step:{PREEMPT_AT}",
                                       data=2)
        _RUNS["world2"] = {"got": got, "committed": committed, "config": d,
                           "checkpoint": str(root / "ckpt" / committed[-1]), "root": root}
    return _RUNS["world2"]


def _resume(root, run, params0, world, env=None, **parallel):
    """Resume ``run``'s checkpoint on ``world`` ranks; the reference is
    rebuilt from ``params0`` (the run's initial weights) before the resume
    loads the policy, as the uninterrupted run's was."""
    d = copy.deepcopy(run["config"])
    d["parallel"].update({"data": -1, "fsdp": 1, **parallel})
    d["resilience"].update(fault_plan=None)
    d["train"].update(resume_from_checkpoint=True, checkpoint_dir=str(root / "ckpt"))
    shutil.copytree(run["checkpoint"], root / "ckpt" / os.path.basename(run["checkpoint"]))
    return run_world("ppo", root / "resume", d, params0, world=world, env=env)


def test_sigterm_one_proc_stops_every_rank_at_one_checkpoint(preempted_world2):
    got = preempted_world2["got"]
    assert [r["preempted"] for r in got["ranks"]] == [preempted_world2["checkpoint"]] * 2
    assert [r["iter_count"] for r in got["ranks"]] == [PREEMPT_AT, PREEMPT_AT]
    assert preempted_world2["committed"] == [f"checkpoint_{PREEMPT_AT}"]
    assert len({r["weights"] for r in got["ranks"]}) == 1
    assert len({r["store"] for r in got["ranks"]}) == 1


@pytest.mark.parametrize("direction", ["shrink", "grow"])
def test_shrink_and_grow_reshard_and_resume_equal(tmp_path, jax_ppo, preempted_world2,
                                                  direction):
    """An emergency checkpoint of one topology resumed on the other takes
    the reshard path once and continues JAX's uninterrupted run."""
    if direction == "shrink":
        run, world, parallel = preempted_world2, 1, {}
    else:
        got, committed, d = _preempted(tmp_path / "w1", jax_ppo, 1,
                                       f"sigterm@step:{PREEMPT_AT}")
        assert committed == [f"checkpoint_{PREEMPT_AT}"]
        assert read_manifest(str(tmp_path / "w1" / "ckpt" / committed[0]))["mesh"][
            "process_count"] == 1
        run = {"config": d, "checkpoint": str(tmp_path / "w1" / "ckpt" / committed[0])}
        world, parallel = 2, {"data": 2}
    resumed = _resume(tmp_path / direction, run, jax_ppo["params0"], world, **parallel)
    assert resumed["world"] == world
    assert resumed["metrics"]["resilience/elastic_restores"] == 1.0
    check_steps(resumed, jax_ppo, list(range(PREEMPT_AT + 1, 7)), PPO_KEYS)
    check_params(resumed["params"], jax_ppo["params"], "ppo")
    assert len({r["weights"] for r in resumed["ranks"]}) == 1


def test_push_to_hub_under_a_mesh_uploads_from_rank_0(tmp_path, jax_ppo, preempted_world2):
    """The two-rank resume of the world-2 checkpoint pushes at its end:
    rank 0 alone stages and uploads (the hub stubbed by ``uploader=``), and
    the files equal a one-process export of the same weights."""
    from trlx_tpu_torch.models.builder import resolve_transformer_config
    from trlx_tpu_torch.utils.checkpoint import PRETRAINED_FILE, save_pretrained

    hub = tmp_path / "hub"
    resumed = _resume(tmp_path / "push", preempted_world2, jax_ppo["params0"], 2,
                      env={"TRLX_TEST_PUSH_DIR": str(hub)}, data=2)
    assert sorted(os.listdir(hub)) == ["rank0"]  # one upload, from rank 0
    urls = json.loads((hub / "rank0" / "url.json").read_text())
    assert urls == {"repo_id": "org/ppo-mesh", "rank": 0}
    cfg = resolve_transformer_config("builtin:gpt2-test", param_dtype=torch.float32,
                                     dtype=torch.float32)
    ref = tmp_path / "world1_export"
    save_pretrained(str(ref), {k: torch.from_numpy(v) for k, v in resumed["params"].items()},
                    cfg, tokenizer_path="builtin:bytes")
    pushed = hub / "rank0" / "files"
    assert sorted(os.listdir(pushed)) == sorted(os.listdir(ref))
    for name in os.listdir(ref):
        if name.endswith((".pt", ".bin")):
            a = torch.load(pushed / name, weights_only=True)
            b = torch.load(ref / name, weights_only=True)
            assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a), name
        else:
            assert (pushed / name).read_text() == (ref / name).read_text(), name
    assert PRETRAINED_FILE in os.listdir(pushed)


def test_emergency_resume_through_a_forced_reshard(tmp_path, jax_ppo):
    """One process throughout: an emergency checkpoint resumed under
    ``topology_shrink@resume:1`` takes the reshard path and the run goes on
    as the uninterrupted one."""
    got, committed, d = _preempted(tmp_path / "w1", jax_ppo, 1, "sigterm@step:2")
    run = {"config": d, "checkpoint": str(tmp_path / "w1" / "ckpt" / committed[0])}
    resumed = _resume(tmp_path / "forced", run, jax_ppo["params0"], 1,
                      env={"TRLX_TPU_FAULT_PLAN": "topology_shrink@resume:1"})
    assert resumed["metrics"]["resilience/elastic_restores"] == 1.0
    check_steps(resumed, jax_ppo, list(range(3, 7)), PPO_KEYS)
    check_params(resumed["params"], jax_ppo["params"], "ppo")
