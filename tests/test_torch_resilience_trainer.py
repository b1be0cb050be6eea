"""The port's ``train()`` against JAX's ``train()`` under the resilience
layer, on the serial PPO preset (``default_ppo_config()`` cut to
``builtin:gpt2-test``: 32 rollouts a collection, batch 8, 2 PPO epochs,
10 updates over two collections, greedy, f32) on the CPU. The port starts
from JAX's initial weights; a cosine LR schedule over 10 steps makes a
skipped update visible in ``learning_rate``.

- ``nan_loss@step:2`` under ``update_guard: skip``, with the first
  collection's reward function failing every attempt (the ``neutral``
  fallback) and ``remat: minimal``: the stores, each step's stats (the
  learning rate, the guard's flag and the NaN gradient norm included) and
  the final weights agree within 1e-5;
- ``rollback`` (to the committed checkpoint of update 2, ``remat: full``)
  agrees the same way, and ``halt`` raises as JAX's does;
- ``sigterm@step:5`` writes an emergency checkpoint, and the resumed run
  equals the uninterrupted one bitwise and JAX's resumed run within 1e-5.
  The relaunch drops the call-triggered reward fault (its counter starts
  again in a new process, in both packages) and keeps the step-triggered
  ones;
- GRPO preempted mid-batch resumes bitwise too (its store's per-sequence
  advantage is a scalar field of the emergency payload).
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

import trlx_tpu
import trlx_tpu_torch
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.resilience import NonFiniteUpdateError as JaxNonFiniteUpdateError
from trlx_tpu.resilience import TrainingPreempted as JaxTrainingPreempted
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.resilience import NonFiniteUpdateError, TrainingPreempted
from tests.test_torch_serial_rollouts import _Recorder, _prompts, _store, reward_fn
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

ATOL = 1e-5
SKIP_PLAN = "reward_raise@call:1*4; nan_loss@step:2"
STAT_KEYS = ("losses/total_loss", "losses/policy_loss", "losses/value_loss",
             "policy/approx_kl", "learning_rate", "gradients/global_norm",
             "resilience/update_ok")


def _config_dict(tmp, plan=None, **resilience):
    d = jax_default_ppo_dict()
    d["model"].update(model_path="builtin:gpt2-test", num_layers_unfrozen=1)
    d["parallel"].update(compute_dtype="float32")
    d["train"].update(seq_length=24, total_steps=10, batch_size=8, checkpoint_dir=str(tmp),
                      checkpoint_interval=2, resume_from_checkpoint=True)
    d["method"].update(num_rollouts=32, chunk_size=32, ppo_epochs=2)
    d["method"]["gen_kwargs"].update(max_new_tokens=8, do_sample=False)
    d["scheduler"].update(name="cosine_annealing", kwargs=dict(T_max=10, eta_min=1e-6))
    d["resilience"].update(fault_plan=plan, reward_backoff_s=0.0, **resilience)
    return d


def jax_default_ppo_dict():
    from trlx_tpu.data.default_configs import default_ppo_config

    return default_ppo_config().to_dict()


def _jax_train(d):
    out = {}

    def hook(trainer):
        out["params0"] = jax.tree_util.tree_map(np.asarray, trainer.state.params)
        trainer.tracker = _Recorder()
        out["tracker"] = trainer.tracker

    try:
        trainer = trlx_tpu.train(reward_fn=reward_fn, prompts=_prompts(),
                                 config=JaxTRLConfig.from_dict(copy.deepcopy(d)),
                                 init_trainer_hook=hook)
    except JaxTrainingPreempted as e:
        out["preempted"] = e.checkpoint_dir
        return out
    out.update(store=_store(trainer), history=out["tracker"].history,
               params=jax.tree_util.tree_map(np.asarray, trainer.state.params))
    return out


def _port_train(d, params0):
    def hook(trainer):
        trainer.model.load_state_dict(params_from_jax(params0, trainer.tcfg))
        trainer.ref_params = trainer._ref_snapshot()

    try:
        return trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_prompts(),
                                    config=TRLConfig.from_dict(copy.deepcopy(d)),
                                    init_trainer_hook=hook, device="cpu")
    except TrainingPreempted as e:
        return e


def _steps(history):
    return [st for _, st in history if "gradients/global_norm" in st]


def _compare(trainer, jax_run, stores=True):
    if stores:
        got = _store(trainer)
        assert len(got) == len(jax_run["store"])
        for g, w in zip(got, jax_run["store"]):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
            for a, b in zip(g[2:], w[2:]):
                np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
    ours, theirs = _steps(trainer.tracker.history), _steps(jax_run["history"])
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        for key in STAT_KEYS:
            if key in b:
                np.testing.assert_allclose(float(a[key]), float(b[key]), rtol=1e-4,
                                           atol=1e-6, equal_nan=True, err_msg=f"{i} {key}")
    want = params_from_jax(jax_run["params"], trainer.tcfg)
    got = trainer.model.state_dict()
    for name, value in want.items():
        torch.testing.assert_close(got[name], value, rtol=0, atol=ATOL, msg=name)


def test_nan_loss_skip_and_neutral_rewards_match_jax(tmp_path):
    d = _config_dict(tmp_path / "jax", SKIP_PLAN, update_guard="skip",
                     reward_fallback="neutral")
    d["parallel"].update(remat="minimal")
    jax_run = _jax_train(d)
    d["train"]["checkpoint_dir"] = str(tmp_path / "port")
    trainer = _port_train(d, jax_run["params0"])
    _compare(trainer, jax_run)
    steps = _steps(trainer.tracker.history)
    assert [st["resilience/update_ok"] for st in steps].count(0.0) == 1
    assert np.isnan(steps[2]["gradients/global_norm"])
    # the skipped update does not advance the schedule
    assert steps[3]["learning_rate"] == steps[2]["learning_rate"]
    last = steps[-1]
    assert (last["resilience/skipped_updates"], last["resilience/reward_fallbacks"],
            last["resilience/reward_retries"]) == (1.0, 1.0, 3.0)
    assert trainer.tracker.path == str(tmp_path / "port" / "logs" / "stats.jsonl")


def test_rollback_matches_jax_and_halt_raises(tmp_path):
    d = _config_dict(tmp_path / "jax", "nan_loss@step:3", update_guard="rollback")
    d["parallel"].update(remat="full")
    jax_run = _jax_train(d)
    d["train"]["checkpoint_dir"] = str(tmp_path / "port")
    trainer = _port_train(d, jax_run["params0"])
    _compare(trainer, jax_run)
    assert _steps(trainer.tracker.history)[-1]["resilience/rollbacks"] == 1.0
    # halt: the poisoned update raises in both packages
    d = _config_dict(tmp_path / "halt_jax", "nan_loss@step:1", update_guard="halt")
    with pytest.raises(JaxNonFiniteUpdateError):
        _jax_train(d)
    d["train"]["checkpoint_dir"] = str(tmp_path / "halt_port")
    with pytest.raises(NonFiniteUpdateError, match="update_guard='halt'"):
        _port_train(d, jax_run["params0"])
    # rollback with nothing committed to restore halts too
    d = _config_dict(tmp_path / "none_port", "nan_loss@step:0", update_guard="rollback")
    with pytest.raises(NonFiniteUpdateError, match="no committed checkpoint"):
        _port_train(d, jax_run["params0"])


def test_sigterm_resume_is_bitwise_and_matches_jax(tmp_path):
    plan = SKIP_PLAN + "; sigterm@step:5"
    kw = dict(update_guard="skip", reward_fallback="neutral")
    # JAX: preempted, then resumed from its emergency checkpoint
    d = _config_dict(tmp_path / "jax", plan, **kw)
    jax_pre = _jax_train(d)
    assert jax_pre["preempted"].endswith("checkpoint_05")
    relaunch = "nan_loss@step:2"
    jax_run = _jax_train(_config_dict(tmp_path / "jax", relaunch, **kw))
    # the port: uninterrupted, preempted, resumed
    params0 = jax_pre["params0"]
    full = _port_train(_config_dict(tmp_path / "full", SKIP_PLAN, **kw), params0)
    pre = _port_train(_config_dict(tmp_path / "port", plan, **kw), params0)
    assert isinstance(pre, TrainingPreempted) and isinstance(pre, SystemExit)
    assert pre.checkpoint_dir == str(tmp_path / "port" / "checkpoint_05")
    resumed = _port_train(_config_dict(tmp_path / "port", relaunch, **kw), params0)
    a, b = full.model.state_dict(), resumed.model.state_dict()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert [e[1].tolist() for e in _store(full)] == [e[1].tolist() for e in _store(resumed)]
    # the resumed runs continue from update 5, in both packages
    _compare(resumed, jax_run)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        n for n in os.listdir(tmp_path / "jax") if n.startswith("checkpoint_") or n == "logs")


def test_grpo_sigterm_mid_batch_resume_is_bitwise(tmp_path):
    from trlx_tpu_torch.data.default_configs import default_grpo_config

    def config(tag, plan):
        return default_grpo_config().evolve(
            model=dict(model_path="builtin:gpt2-test", num_layers_unfrozen=2),
            train=dict(seq_length=24, total_steps=6, batch_size=8, checkpoint_interval=2,
                       checkpoint_dir=str(tmp_path / tag), resume_from_checkpoint=True),
            method=dict(num_rollouts=16, chunk_size=16, gen_kwargs=dict(max_new_tokens=8)),
            resilience=dict(fault_plan=plan))

    def run(tag, plan=None):
        try:
            return trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_prompts(16),
                                        config=config(tag, plan), device="cpu")
        except TrainingPreempted as e:
            return e

    full = run("full")
    # update 4 is the second of batch 1's two updates: the resume starts mid-batch
    assert isinstance(run("run", "sigterm@step:3"), TrainingPreempted)
    resumed = run("run")
    a, b = full.model.state_dict(), resumed.model.state_dict()
    for name in a:
        assert torch.equal(a[name], b[name]), name
