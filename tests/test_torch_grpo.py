"""The GRPO slice of the port (``trlx_tpu_torch/trainer/grpo.py``,
``models/grpo.py``, ``pipeline/grpo_pipeline.py``) against the JAX package,
on the CPU.

- ``group_advantages_np`` equals JAX's (``group`` and ``rloo``, ``scale`` on
  and off, and its errors);
- ``GRPOConfig.loss`` equals JAX's, with and without the importance
  weights, sketches included: loss, stats and the gradient at 1e-5
  relative in f32;
- the whole slice: ``trlx_tpu.train`` and ``trlx_tpu_torch.train`` on
  ``default_grpo_config()`` cut only in model (``builtin:gpt2-test``, f32,
  which has the preset's ``num_layers_unfrozen`` of 2 layers), lengths,
  steps and greedy rollouts, the port starting from the JAX initial
  weights (``params_from_jax``). Greedy members of a group are identical,
  so the reward draws each call's scores from one seeded
  ``np.random.RandomState`` (the same on both sides). Cases, three JAX
  runs: serial at pipeline depth 0 and 2 (GRPO has no pipelined path, so
  both equal the one JAX run); ``baseline: rloo`` with ``grad_accum`` 2 on
  serial speculative rollouts (a draft of its own weights, tokens and
  acceptance equal); and the continuous path's group-aware harvest with
  ``scale_advantage: false``, whose chunks are cut to 16 rows of 4 groups
  on 16 slots, two chunks a collection, so the second chunk refills slots
  as the first one's rows finish and groups complete out of order (the
  preset's one 128-row chunk on 128 slots never refills). The last store
  matches element by element
  (tokens equal, logprobs and advantages at ``ATOL``), each step's stats at
  ``RTOL`` relative (``STAT_ATOL`` absolute) and the final weights at
  ``ATOL``;
- resume from a checkpoint equals the uninterrupted run (sampled rollouts);
- each construction check raises as JAX's does, ``loss_kernel: pallas``
  included;
- a head-less policy scores no values, and with ``num_layers_unfrozen``
  below the depth its bottom blocks stay frozen (where the JAX mask of a
  head-less tree trains every block: ``ROADMAP.md`` Queue 3).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trlx_tpu
import trlx_tpu_torch
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.data.default_configs import default_grpo_config as jax_default_grpo_config
from trlx_tpu.models.grpo import group_advantages_np as jax_group_advantages_np
from trlx_tpu.trainer.grpo import GRPOTrainer as JaxGRPOTrainer
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_grpo_config
from trlx_tpu_torch.models.grpo import group_advantages_np
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.trainer.grpo import GRPOTrainer
from trlx_tpu_torch.utils.checkpoint import load_state
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

RTOL, ATOL = 1e-5, 1e-5
# an absolute floor for stats that are rounding noise in exact arithmetic
# (the first step's KL at ratio 1, ~1e-7 on both sides)
STAT_ATOL = 1e-6
STAT_PREFIXES = ("losses/", "policy/", "ratio/")
STAT_KEYS = ("advantages_mean", "padding_percentage", "learning_rate",
             "gradients/global_norm")
# one collection is 128 rollouts, batch 32, 2 epochs: 8 steps; the 9th
# step runs on the second collection
TOTAL_STEPS = 9


def _config_dict(tmp, **train):
    d = jax_default_grpo_config().to_dict()
    d["model"].update(model_path="builtin:gpt2-test")
    d["parallel"].update(compute_dtype="float32")
    d["train"].update(seq_length=24, total_steps=TOTAL_STEPS, checkpoint_dir=str(tmp), **train)
    d["method"]["gen_kwargs"].update(max_new_tokens=8, do_sample=False)
    return d


def _prompts(n=48, seed=0):
    rs = np.random.RandomState(seed)
    return ["".join(chr(c) for c in rs.randint(97, 123, size=rs.randint(3, 17)))
            for _ in range(n)]


def drawn_reward(seed=0):
    """A reward that draws each call's scores from one seeded stream: the
    same calls in the same order give the same scores on both sides."""
    rs = np.random.RandomState(seed)

    def reward_fn(samples, prompts, outputs):
        return rs.randn(len(samples)).tolist()

    return reward_fn


def vowel_reward(samples, prompts, outputs):
    return [sum(ch in "aeiou" for ch in o) / max(len(o), 1) for o in outputs]


class _Recorder:
    def __init__(self):
        self.history = []

    def log(self, stats, step):
        self.history.append((int(step), dict(stats)))

    def finish(self):
        pass


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _store(trainer):
    return [(e.query_tensor, e.response_tensor, e.logprobs, e.ref_logprobs, e.advantage)
            for e in trainer.store.history]


def _with(d, overrides):
    d = copy.deepcopy(d)
    for section, values in overrides.items():
        d.setdefault(section, {}).update(values)
    return d


def _jax_run(tmp, overrides):
    out = {}

    def hook(trainer):
        out["params0"] = _np_tree(trainer.state.params)
        out["draft"] = None if trainer.draft_params is None else _np_tree(trainer.draft_params)
        trainer.tracker = _Recorder()

    with pytest.MonkeyPatch.context() as mp:
        # no MFU analysis: its background compile of the train step would
        # double the run's compile time and race the port's run for the CPU
        mp.setenv("TRLX_TPU_MFU", "0")
        trainer = trlx_tpu.train(
            reward_fn=drawn_reward(), prompts=_prompts(),
            config=JaxTRLConfig.from_dict(_with(_config_dict(tmp), overrides)),
            init_trainer_hook=hook)
    out.update(history=trainer.tracker.history, store=_store(trainer),
               params=_np_tree(trainer.state.params))
    return out


def _port_run(tmp, jax_run, overrides):
    def hook(trainer):
        trainer.model.load_state_dict(params_from_jax(jax_run["params0"], trainer.tcfg))
        trainer.ref_params = trainer._ref_snapshot()
        if jax_run["draft"] is not None:
            trainer.draft_model.load_state_dict(params_from_jax(jax_run["draft"],
                                                                trainer.draft_tcfg))

    return trlx_tpu_torch.train(reward_fn=drawn_reward(), prompts=_prompts(),
                                config=TRLConfig.from_dict(_with(_config_dict(tmp), overrides)),
                                init_trainer_hook=hook, device="cpu")


SERIAL = {}
RLOO_SPEC = {"method": {"baseline": "rloo"}, "train": {"grad_accum": 2},
             "model": {"draft_model_path": "builtin:gpt2-test", "draft_gamma": 3}}
CONTINUOUS = {"method": {"scale_advantage": False, "num_rollouts": 32, "chunk_size": 16,
                         "group_size": 4},
              "train": {"continuous_batching": True, "batch_size": 8},
              "engine": {"backend": "paged", "kv_block_size": 4, "decode_kernel": "pallas",
                         "prefill_kernel": "pallas"}}


@pytest.fixture(scope="module")
def jax_serial(tmp_path_factory):
    return _jax_run(tmp_path_factory.mktemp("jax_serial"), SERIAL)


@pytest.fixture(scope="module")
def jax_rloo_spec(tmp_path_factory):
    return _jax_run(tmp_path_factory.mktemp("jax_rloo"), RLOO_SPEC)


@pytest.fixture(scope="module")
def jax_continuous(tmp_path_factory):
    # the JAX engine's gather path: bit-identical to its kernels by its own
    # contract, and much faster in interpret mode
    overrides = _with(CONTINUOUS, {"engine": {"decode_kernel": "xla", "prefill_kernel": "xla"}})
    return _jax_run(tmp_path_factory.mktemp("jax_cb"), overrides)


def _compare(trainer, jax_run):
    ours, theirs = _store(trainer), jax_run["store"]
    assert len(ours) == len(theirs) == trainer.config.method.num_rollouts
    G = trainer.config.method.group_size
    for i, (a, b) in enumerate(zip(ours, theirs)):
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"query {i}")
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"response {i}")
        for j, name in ((2, "logprobs"), (3, "ref_logprobs")):
            np.testing.assert_allclose(np.asarray(a[j], np.float32), np.asarray(b[j], np.float32),
                                       atol=ATOL, rtol=0, err_msg=f"{name} {i}")
        np.testing.assert_allclose(a[4], b[4], atol=ATOL, rtol=0, err_msg=f"advantage {i}")
        # group-contiguous: every member of a group shares its prompt
        np.testing.assert_array_equal(a[0], ours[i - i % G][0])
    steps = [(s, st) for s, st in trainer.tracker.history if "gradients/global_norm" in st]
    jsteps = [(s, st) for s, st in jax_run["history"] if "gradients/global_norm" in st]
    assert len(steps) == len(jsteps) == TOTAL_STEPS
    for (s_o, st_o), (s_t, st_t) in zip(steps, jsteps):
        assert s_o == s_t
        keys = [k for k in st_t if k.startswith(STAT_PREFIXES) or k in STAT_KEYS]
        assert len(keys) >= 14
        for k in keys:
            np.testing.assert_allclose(st_o[k], float(st_t[k]), rtol=RTOL, atol=STAT_ATOL,
                                       err_msg=f"step {s_o} {k}")
    final = params_from_jax(jax_run["params"], trainer.tcfg)
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=ATOL, rtol=0, err_msg=k)
    # the collections log JAX's keys
    collections = [st for _, st in trainer.tracker.history if "time/exp" in st]
    jcollections = [st for _, st in jax_run["history"] if "time/exp" in st]
    assert len(collections) == len(jcollections) == 2
    # (the continuous path adds its engine's gauges, which the JAX engine
    # keeps for its unported options too)
    engine = ("engine/", "rollout/") if trainer.config.train.continuous_batching else ()
    assert {k for k in jcollections[-1] if not k.startswith(engine)} <= set(collections[-1])
    for k in ("policy/sqrt_ref_kl", "exp_scores/mean", "exp_scores/std"):
        np.testing.assert_allclose(collections[-1][k], jcollections[-1][k], rtol=RTOL,
                                   atol=STAT_ATOL, err_msg=k)
    return collections


@pytest.mark.parametrize("depth", [0, 2])
def test_serial_slice_matches_jax_trainer(jax_serial, tmp_path, depth):
    trainer = _port_run(tmp_path, jax_serial, {"train": {"rollout_pipeline_depth": depth}})
    assert not trainer.config.train.continuous_batching
    collections = _compare(trainer, jax_serial)
    assert "throughput/slot_utilization" in collections[-1]


def test_rloo_grad_accum_speculative_matches_jax_trainer(jax_rloo_spec, tmp_path):
    trainer = _port_run(tmp_path, jax_rloo_spec, RLOO_SPEC)
    assert trainer.draft_model is not None
    collections = _compare(trainer, jax_rloo_spec)
    jcollections = [st for _, st in jax_rloo_spec["history"] if "time/exp" in st]
    for ours, theirs in zip(collections, jcollections):
        # JAX's acceptance is an f32 ratio of the same counts
        np.testing.assert_allclose(ours["rollout/spec_acceptance_rate"],
                                   theirs["rollout/spec_acceptance_rate"], rtol=1e-6)
        assert ours["rollout/spec_rounds"] == theirs["rollout/spec_rounds"]
    # rloo: each group's advantages sum to zero
    adv = np.asarray([e.advantage for e in trainer.store.history]).reshape(-1, 8)
    np.testing.assert_allclose(adv.sum(axis=1), 0.0, atol=1e-5)


def test_continuous_slice_matches_jax_trainer(jax_continuous, tmp_path):
    trainer = _port_run(tmp_path, jax_continuous, CONTINUOUS)
    collections = _compare(trainer, jax_continuous)
    # the engine's gauges (its kernel launch counts stay 0 on CPU tensors)
    assert "engine/decode_kernel_launches" in collections[-1]


@pytest.mark.parametrize("baseline,scale", [("group", True), ("group", False),
                                            ("rloo", True), ("rloo", False)])
def test_group_advantages_match_jax(baseline, scale):
    rs = np.random.RandomState(3)
    scores = rs.randn(24).astype(np.float32) * 3
    scores[8:12] = 1.5  # a group of equal rewards: zero advantages under the eps
    for G in (4, 8):
        want = jax_group_advantages_np(scores, G, scale, baseline=baseline)
        got = group_advantages_np(scores, G, scale, baseline=baseline)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(group_advantages_np(scores, 4, scale, eps=0.5),
                               jax_group_advantages_np(scores, 4, scale, eps=0.5), rtol=1e-6)
    for args, kwargs in (((scores[:10], 4), {}), ((scores, 1), {"baseline": "rloo"}),
                         ((scores, 4), {"baseline": "mean"})):
        with pytest.raises(ValueError):
            jax_group_advantages_np(*args, **kwargs)
        with pytest.raises(ValueError):
            group_advantages_np(*args, **kwargs)


def _loss_inputs(B=6, R=9, seed=0):
    rs = np.random.RandomState(seed)
    mask = (np.arange(R)[None] < rs.randint(1, R + 1, size=B)[:, None]).astype(np.float32)
    lp = (rs.randn(B, R) * 0.3 - 1.0).astype(np.float32)
    return dict(
        logprobs=lp,
        old_logprobs=(lp + rs.randn(B, R) * 0.3).astype(np.float32),
        ref_logprobs=(lp + rs.randn(B, R) * 0.2).astype(np.float32),
        advantages=(rs.randn(B) * 2).astype(np.float32),
        mask=mask,
        behavior_logprobs=(lp + rs.randn(B, R) * 0.4).astype(np.float32),
    )


@pytest.mark.parametrize("iw", [False, True])
def test_loss_matches_jax(iw):
    """Loss, every stat (the sketches and the IW diagnostics included) and
    the gradient with respect to the logprobs, at 1e-5 relative in f32."""
    inputs = _loss_inputs(seed=int(iw))
    if not iw:
        inputs.pop("behavior_logprobs")
    jm = dataclasses_replace(jax_default_grpo_config().method, iw_correction="clip",
                             cliprange=0.2, beta=0.04)
    pm = dataclasses_replace(default_grpo_config().method, iw_correction="clip",
                             cliprange=0.2, beta=0.04)

    def jax_loss(lp, rest):
        return jm.loss(logprobs=lp, **rest)

    rest_j = {k: jnp.asarray(v) for k, v in inputs.items() if k != "logprobs"}
    (jl, jstats), jgrad = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jnp.asarray(inputs["logprobs"]), rest_j)
    lp = torch.tensor(inputs["logprobs"], requires_grad=True)
    pl, pstats = pm.loss(logprobs=lp, **{k: torch.tensor(v) for k, v in inputs.items()
                                         if k != "logprobs"})
    pl.backward()
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-5)
    assert set(pstats) == set(jstats)
    assert ("iw/rho_mean" in pstats) == iw and "dist/advantages_hist" in pstats
    for k, v in jstats.items():
        np.testing.assert_allclose(np.asarray(pstats[k].detach()), np.asarray(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(lp.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-8)


def dataclasses_replace(obj, **kw):
    import dataclasses

    return dataclasses.replace(obj, **kw)


def _resume_config(ckpt, **train):
    d = default_grpo_config().to_dict()
    d["model"].update(model_path="builtin:gpt2-test")
    d["parallel"].update(compute_dtype="float32")
    d["train"].update(seq_length=24, batch_size=8, total_steps=8, checkpoint_interval=4,
                      checkpoint_dir=str(ckpt), **train)
    d["method"].update(num_rollouts=16, chunk_size=16, group_size=4)
    d["method"]["gen_kwargs"].update(max_new_tokens=8)  # sampled
    return TRLConfig.from_dict(d)


def test_resume_equals_the_uninterrupted_run(tmp_path):
    import shutil

    full = trlx_tpu_torch.train(reward_fn=vowel_reward, prompts=_prompts(12),
                                config=_resume_config(tmp_path / "full"), device="cpu")
    state = load_state(str(tmp_path / "full" / "checkpoint_4"))
    assert "kl_ctl_value" not in state["extra"] and "running_moments" in state["extra"]
    shutil.copytree(tmp_path / "full" / "checkpoint_4", tmp_path / "resumed" / "checkpoint_4")
    resumed = trlx_tpu_torch.train(
        reward_fn=vowel_reward, prompts=_prompts(12),
        config=_resume_config(tmp_path / "resumed", resume_from_checkpoint=True),
        device="cpu")
    assert resumed.iter_count == full.iter_count == 8
    for a, b in ((resumed, full),):
        for k, v in b.model.state_dict().items():
            assert torch.equal(a.model.state_dict()[k], v), k
        assert _store_equal(_store(a), _store(b))
        assert (a.running_moments.mean, a.running_moments.count, a.mean_kl) == (
            b.running_moments.mean, b.running_moments.count, b.mean_kl)
    # sampled groups differ inside: the advantages are not all zero
    assert np.abs([e.advantage for e in full.store.history]).max() > 0.1


def _store_equal(a, b):
    return len(a) == len(b) and all(
        all(np.array_equal(np.asarray(u), np.asarray(v)) for u, v in zip(x, y))
        for x, y in zip(a, b))


@pytest.mark.parametrize("override,error,match", [
    ({"model": {"model_arch_type": "seq2seq"}}, NotImplementedError, "causal LMs"),
    ({"method": {"chunk_size": 12}}, ValueError, "multiple of group_size"),
    ({"method": {"baseline": "mean"}}, ValueError, "unknown method.baseline"),
    ({"method": {"baseline": "rloo", "group_size": 1, "chunk_size": 8}}, ValueError,
     "group_size >= 2"),
    ({"async_rl": {"enabled": True}, "train": {"continuous_batching": True}},
     NotImplementedError, "async_rl"),
    ({"method": {"loss_kernel": "pallas"}}, ValueError, "loss_kernel: pallas"),
])
def test_construction_checks_raise_as_jax(tmp_path, override, error, match):
    d = _with(_config_dict(tmp_path), override)
    with pytest.raises(error, match=match):
        JaxGRPOTrainer(config=JaxTRLConfig.from_dict(copy.deepcopy(d)),
                       reward_fn=vowel_reward)
    with pytest.raises(error, match=match):
        GRPOTrainer(config=TRLConfig.from_dict(d), reward_fn=vowel_reward, device="cpu")


def test_rloo_with_scale_warns(tmp_path, caplog):
    d = _with(_config_dict(tmp_path), {"method": {"baseline": "rloo"}})
    with caplog.at_level("WARNING", logger="trlx_tpu_torch.trainer.base"):
        GRPOTrainer(config=TRLConfig.from_dict(d), reward_fn=vowel_reward, device="cpu")
    assert any("ignores scale_advantage" in r.getMessage() for r in caplog.records)


def test_headless_policy_scores_no_values_and_freezes_the_bottom(tmp_path):
    d = _with(_config_dict(tmp_path), {"model": {"num_layers_unfrozen": 1}})
    trainer = GRPOTrainer(config=TRLConfig.from_dict(d), reward_fn=vowel_reward, device="cpu")
    assert not hasattr(trainer.model, "v_head") and not hasattr(trainer.model, "backbone")
    ids = torch.randint(0, 200, (2, 6))
    mask = torch.ones_like(ids)
    out = trainer._score(torch.cat([ids, ids], 1), mask, ids, mask)
    assert set(out) == {"logprobs", "ref_logprobs"}
    # the port keeps the documented rule: only the top block trains
    assert not trainer.param_mask["blocks.0.attn.q_proj.weight"]
    assert trainer.param_mask["blocks.1.attn.q_proj.weight"] and trainer.param_mask["wte.weight"]
    assert trainer._extra_checkpoint_state().keys() == {"mean_kl", "running_moments"}
