"""The trainers on the rest of the port's engine against the JAX package,
on the CPU (``builtin:gpt2-test`` in f32, the port starting from JAX's
initial weights through ``params_from_jax``; greedy rollouts):

- PPO through ``train()`` with ``train.continuous_batching: true`` at the
  engine's default settings (the dense backend, JAX's default) equals
  JAX's ``train()`` over 2 updates: the store element by element (tokens
  equal, logprobs, values and rewards at 1e-5), each step's stats at 1e-5
  relative and the final weights at 1e-5 (the key biases, whose exact
  gradient is 0, within the two Adam steps' bound); with the host stage on the
  ``RolloutPipeline`` (``train.rollout_pipeline_depth: 2``) the store and
  weights equal the inline run's (depth 0) exactly, and JAX's depth-2 run
  at the same tolerances;
- GRPO's group-aware harvest under ``engine.speculative`` (a draft of its
  own, the prefix cache on) equals JAX's: the store, every step's stats,
  the final weights and the collections' speculation gauges;
- ILQL with ``model.draft_model_path``: ``generate`` samples through the
  serial speculative sampler with ILQL's advantage hook and equals JAX's
  ILQL trainer with the same draft, greedy, at β 1 and 5 (tokens and masks
  equal, logprobs at 1e-5), and equals the port's plain greedy ILQL
  generation token for token.
"""

import copy

import numpy as np
import pytest

import trlx_tpu
import trlx_tpu_torch
from tests import test_torch_grpo as grpo_cases
from tests.test_torch_ilql import EVAL_PROMPTS
from tests.test_torch_ilql import _config_dict as ilql_config_dict
from tests.test_torch_ppo_trainer import (
    RTOL,
    STAT_KEYS,
    STAT_PREFIXES,
    _compare_stores,
    _config_dict as ppo_config_dict,
    _np_tree,
    _prompts,
    _Recorder,
    _step_stats,
    _store,
    reward_fn,
)
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.data.default_configs import default_ppo_config as jax_default_ppo_config
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPromptPipeline
from trlx_tpu.trainer.ilql import ILQLTrainer as JaxILQLTrainer
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.ilql import ILQLTrainer
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

ATOL = 1e-5
PPO_STEPS = 2


# ---------------------------------------------------------------------------
# PPO on the continuous path at the engine's default settings
# ---------------------------------------------------------------------------

def _ppo_dict(tmp, depth):
    d = ppo_config_dict(tmp)
    # the engine section exactly as the preset has it: the dense backend
    d["engine"] = copy.deepcopy(jax_default_ppo_config().to_dict()["engine"])
    assert d["engine"]["backend"] == "dense" and d["engine"]["decode_kernel"] == "xla"
    d["train"].update(total_steps=PPO_STEPS, rollout_pipeline_depth=depth)
    return d


@pytest.fixture(scope="module")
def jax_ppo(tmp_path_factory):
    out = {}

    def hook(trainer):
        out["params0"] = _np_tree(trainer.state.params)
        trainer.tracker = _Recorder()

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRLX_TPU_MFU", "0")
        trainer = trlx_tpu.train(
            reward_fn=reward_fn, prompts=_prompts(), eval_prompts=_prompts(4, seed=1),
            config=JaxTRLConfig.from_dict(_ppo_dict(tmp_path_factory.mktemp("jax_ppo"), 2)),
            init_trainer_hook=hook)
    out.update(store=_store(trainer), history=trainer.tracker.history,
               params=_np_tree(trainer.state.params))
    return out


@pytest.fixture(scope="module")
def port_ppo(jax_ppo, tmp_path_factory):
    """The port's runs at depth 0 and 2, from JAX's initial weights."""
    runs = {}
    for depth in (0, 2):
        def hook(trainer):
            trainer.model.load_state_dict(params_from_jax(jax_ppo["params0"], trainer.tcfg))
            trainer.ref_params = trainer._ref_snapshot()

        config = TRLConfig.from_dict(_ppo_dict(tmp_path_factory.mktemp(f"port{depth}"), depth))
        runs[depth] = trlx_tpu_torch.train(
            reward_fn=reward_fn, prompts=_prompts(), eval_prompts=_prompts(4, seed=1),
            config=config, init_trainer_hook=hook, device="cpu")
    return runs


@pytest.mark.parametrize("depth", [0, 2])
def test_default_engine_ppo_matches_jax_train(jax_ppo, port_ppo, depth):
    trainer = port_ppo[depth]
    fns = [v for k, v in trainer._generate_fns.items() if k[0] == "slot_refill"]
    assert fns and all(f.paged is None and f.decode_kernel == "xla" for f in fns)
    _compare_stores(_store(trainer), jax_ppo["store"])
    ours = _step_stats(trainer.tracker.history, PPO_STEPS)
    theirs = _step_stats(jax_ppo["history"], PPO_STEPS)
    for (s_o, st_o), (s_t, st_t) in zip(ours, theirs):
        assert s_o == s_t
        keys = [k for k in st_t if k.startswith(STAT_PREFIXES) or k in STAT_KEYS]
        assert len(keys) > 20
        for k in keys:
            np.testing.assert_allclose(st_o[k], float(st_t[k]), rtol=RTOL, atol=1e-6,
                                       err_msg=f"step {s_o} {k}")
    final = params_from_jax(jax_ppo["params"], trainer.tcfg)
    for k, v in trainer.model.state_dict().items():
        # a key bias shifts every score of a query alike: its exact gradient
        # is 0, and Adam scales both sides' rounding noise there up to a
        # step of up to lr (1e-3) each; every other weight at ATOL
        atol = PPO_STEPS * 1e-3 if k.endswith("attn.k_proj.bias") else ATOL
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=atol, rtol=0, err_msg=k)
    collection = [st for _, st in trainer.tracker.history if "time/exp" in st][0]
    assert collection["engine/block_pool_occupancy"] == 0.0  # no pool
    assert 0.0 <= collection["throughput/rollout_overlap_frac"] <= 1.0


def test_pipelined_continuous_store_equals_inline(port_ppo):
    inline, piped = port_ppo[0], port_ppo[2]
    a, b = _store(inline), _store(piped)
    assert len(a) == len(b) > 0
    for i, (x, y) in enumerate(zip(a, b)):
        for j in range(5):
            np.testing.assert_array_equal(np.asarray(x[j]), np.asarray(y[j]),
                                          err_msg=f"element {i} field {j}")
    for (k, v), (k2, v2) in zip(inline.model.state_dict().items(),
                                piped.model.state_dict().items()):
        assert k == k2 and np.array_equal(v.numpy(), v2.numpy()), k


# ---------------------------------------------------------------------------
# GRPO's group-aware harvest under speculation
# ---------------------------------------------------------------------------

GRPO_SPEC = grpo_cases._with(grpo_cases.CONTINUOUS, {
    "engine": {"speculative": 3, "prefix_cache": True},
    "model": {"draft_model_path": "builtin:gpt2-test"}})


@pytest.fixture(scope="module")
def jax_grpo_spec(tmp_path_factory):
    overrides = grpo_cases._with(GRPO_SPEC, {"engine": {"decode_kernel": "xla",
                                                        "prefill_kernel": "xla"}})
    return grpo_cases._jax_run(tmp_path_factory.mktemp("jax_grpo_spec"), overrides)


def test_grpo_speculative_harvest_matches_jax(jax_grpo_spec, tmp_path):
    trainer = grpo_cases._port_run(tmp_path, jax_grpo_spec, GRPO_SPEC)
    assert trainer.draft_model is not None
    collections = grpo_cases._compare(trainer, jax_grpo_spec)
    jcollections = [st for _, st in jax_grpo_spec["history"] if "time/exp" in st]
    for ours, theirs in zip(collections, jcollections):
        assert ours["rollout/spec_rounds"] == theirs["rollout/spec_rounds"]
        np.testing.assert_allclose(ours["engine/spec_tokens_per_round"],
                                   theirs["engine/spec_tokens_per_round"], rtol=1e-6)
        np.testing.assert_allclose(ours["engine/spec_acceptance_rate"],
                                   theirs["engine/spec_acceptance_rate"], rtol=1e-6)
        assert 1.0 <= ours["engine/spec_tokens_per_round"] <= 4.0


# ---------------------------------------------------------------------------
# ILQL's speculative sampling
# ---------------------------------------------------------------------------

def _ilql_dict(tmp):
    d = ilql_config_dict(tmp)
    d["model"].update(draft_model_path="builtin:gpt2-test", draft_gamma=3)
    d["method"]["gen_kwargs"].update(max_new_tokens=8)
    return d


@pytest.fixture(scope="module")
def jax_ilql_spec(tmp_path_factory):
    trainer = JaxILQLTrainer(config=JaxTRLConfig.from_dict(
        _ilql_dict(tmp_path_factory.mktemp("jax_ilql_spec"))))
    batch = next(iter(JaxPromptPipeline(EVAL_PROMPTS, 14, trainer.tokenizer).create_loader(4)))
    answers = {}
    for beta in (1.0, 5.0):
        out = trainer.generate(batch["input_ids"], batch["attention_mask"], eval_mode=True,
                               beta=beta)
        answers[beta] = {f: np.asarray(getattr(out, f"response_{f}"))
                         for f in ("tokens", "mask", "logprobs")}
    assert trainer.last_spec_stats  # JAX sampled speculatively
    return dict(params=_np_tree(trainer.state.params), draft=_np_tree(trainer.draft_params),
                answers=answers)


@pytest.mark.parametrize("beta", [1.0, 5.0])
def test_ilql_speculative_generate_matches_jax(jax_ilql_spec, tmp_path, beta):
    trainer = ILQLTrainer(config=TRLConfig.from_dict(_ilql_dict(tmp_path)), device="cpu")
    trainer.model.load_state_dict(params_from_jax(jax_ilql_spec["params"], trainer.tcfg))
    trainer.draft_model.load_state_dict(params_from_jax(jax_ilql_spec["draft"],
                                                        trainer.draft_tcfg))
    assert trainer._serial_rollouts()
    batch = next(iter(PromptPipeline(EVAL_PROMPTS, 14, trainer.tokenizer).create_loader(4)))
    out = trainer.generate(batch["input_ids"], batch["attention_mask"], eval_mode=True,
                           beta=beta)
    want = jax_ilql_spec["answers"][beta]
    np.testing.assert_array_equal(out["response_mask"], want["mask"])
    np.testing.assert_array_equal(out["response_tokens"] * want["mask"],
                                  want["tokens"] * want["mask"])
    np.testing.assert_allclose(out["response_logprobs"], want["logprobs"], atol=ATOL, rtol=0)
    assert 0.0 < trainer.last_generate_stats["rollout/spec_acceptance_rate"] <= 1.0
    # greedy speculation equals the plain greedy ILQL generation (the paged
    # engine with the same hook, no draft)
    plain_cfg = _ilql_dict(tmp_path / "plain")
    plain_cfg["model"].pop("draft_model_path")
    plain = ILQLTrainer(config=TRLConfig.from_dict(plain_cfg), device="cpu")
    plain.model.load_state_dict(trainer.model.state_dict())
    assert not plain._serial_rollouts()
    ref = plain.generate(batch["input_ids"], batch["attention_mask"], eval_mode=True, beta=beta)
    np.testing.assert_array_equal(out["response_tokens"], ref["response_tokens"])
    np.testing.assert_allclose(out["response_logprobs"], ref["response_logprobs"], atol=ATOL,
                               rtol=0)
