"""PPO and ILQL on the port's T5 (``model.model_arch_type: seq2seq``)
against the JAX package's trainers, on the CPU, in f32.

- PPO: ``trlx_tpu.train`` and ``trlx_tpu_torch.train`` on
  ``default_ppo_config()`` cut in model, lengths, rollouts and steps, with
  greedy rollouts and the example's tokenizer settings, the port starting
  from the JAX initial weights (``seq2seq_params_from_jax``). At
  ``num_layers_unfrozen`` -1 (``builtin:t5-test``, a frozen full copy as the
  reference) and 1 (``builtin:flan_t5-test``, the hydra branch), at
  pipeline depth 0 and 2, with ``loss_kernel`` xla and pallas: the last
  store element for element (tokens equal, logprobs, values and rewards at
  ``ATOL``), each step's stats at ``RTOL`` and the final weights at
  ``ATOL``;
- PPO resumed from its mid-run checkpoint equals the uninterrupted run
  bitwise (sampled rollouts; weights, optimizer, store and host state);
- ILQL at the TL;DR T5 example's method settings
  (``examples/summarize_rlhf/ilql_summarize_t5.py``): the store's integer
  arrays equal JAX's ``make_experience_seq2seq``; its collated batches
  equal; each step's loss and stats at ``RTOL``, the final weights (target
  heads included) at ``ATOL``; the greedy evaluation answers at ``beta`` 1
  and 5 from the initial weights equal JAX's;
- evaluation joins prompt and output with a separator; a draft model is
  ignored with JAX's warning.
"""

import logging
import shutil

import jax
import numpy as np
import pytest
import torch

import trlx_tpu
import trlx_tpu_torch
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.data.default_configs import default_ilql_config as jax_default_ilql_config
from trlx_tpu.data.default_configs import default_ppo_config as jax_default_ppo_config
from trlx_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPromptPipeline
from trlx_tpu.trainer.ilql import ILQLTrainer as JaxILQLTrainer
from trlx_tpu.trainer.ilql import make_experience_seq2seq as jax_make_experience_seq2seq
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.tokenizer import ByteTokenizer
from trlx_tpu_torch.models.weights import seq2seq_params_from_jax
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.ilql import ILQLTrainer, make_experience_seq2seq
from trlx_tpu_torch.trainer.ppo import PPOTrainer
from trlx_tpu_torch.utils.checkpoint import load_state
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

STAT_PREFIXES = ("losses/", "policy/", "values/", "old_values/", "returns/", "qvalues/",
                 "awac_weight/")
STAT_KEYS = ("ratio", "learning_rate", "gradients/global_norm")
RTOL, ATOL = 1e-5, 1e-5
# the stats that vanish in exact arithmetic (a collection's first policy
# loss) are rounding noise of ~1e-7 on both sides
STAT_ATOL = 1e-6

PPO_CASES = {-1: "builtin:t5-test", 1: "builtin:flan_t5-test"}


class _Recorder:
    def __init__(self):
        self.history = []

    def log(self, stats, step):
        self.history.append((int(step), dict(stats)))

    def finish(self):
        pass


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _words(rs, lo, hi):
    return "".join(chr(c) for c in rs.randint(97, 123, size=rs.randint(lo, hi)))


def _prompts(n=24, seed=0):
    rs = np.random.RandomState(seed)
    return [_words(rs, 3, 17) for _ in range(n)]


def reward_fn(samples, prompts, outputs):
    return [sum(ch in "aeiou" for ch in s) / max(len(s), 1) for s in samples]


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------


def _ppo_dict(tmp, nlu, **train):
    """``default_ppo_config()`` with the T5 example's model and tokenizer
    settings, cut in model, lengths and steps, greedy: 32 rollouts in
    chunks of 16, batch 16 and 2 PPO epochs make 4 steps a collection (the
    JAX parity runs one; the resume test two, with a checkpoint between)."""
    d = jax_default_ppo_config().to_dict()
    d["model"].update(model_path=PPO_CASES[nlu], model_arch_type="seq2seq",
                      num_layers_unfrozen=nlu)
    d["tokenizer"].update(padding_side="right")
    d["parallel"].update(compute_dtype="float32")
    d["train"].update({"seq_length": 24, "batch_size": 16, "total_steps": 4,
                       "checkpoint_interval": 4, "checkpoint_dir": str(tmp), **train})
    d["method"].update(num_rollouts=32, chunk_size=16, ppo_epochs=2)
    d["method"]["gen_kwargs"].update(max_new_tokens=8, do_sample=False)
    return d


def _store(trainer):
    return [(e.query_tensor, e.response_tensor, e.logprobs, e.values, e.rewards)
            for e in trainer.store.history]


def _jax_ppo(tmp, nlu):
    out = {}

    def hook(trainer):
        out["params0"] = _np_tree(trainer.state.params)
        trainer.tracker = _Recorder()

    trainer = trlx_tpu.train(reward_fn=reward_fn, prompts=_prompts(),
                             config=JaxTRLConfig.from_dict(_ppo_dict(tmp, nlu)),
                             init_trainer_hook=hook)
    out.update(history=trainer.tracker.history, store=_store(trainer),
               params=_np_tree(trainer.state.params))
    return out


@pytest.fixture(scope="module")
def jax_ppo(tmp_path_factory):
    """``nlu`` → the JAX run, each run made at its first use (a worker
    given only one case's tests makes only that run)."""
    runs = {}

    def run(nlu):
        if nlu not in runs:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("TRLX_TPU_MFU", "0")  # no background FLOP-count compile
                runs[nlu] = _jax_ppo(tmp_path_factory.mktemp(f"jax_ppo_{nlu}"), nlu)
        return runs[nlu]

    return run


def _compare_steps(history, jax_history, n_steps, min_keys):
    steps = [(s, st) for s, st in history if "gradients/global_norm" in st]
    jsteps = [(s, st) for s, st in jax_history if "gradients/global_norm" in st]
    assert len(steps) == len(jsteps) == n_steps
    for (s_o, st_o), (s_t, st_t) in zip(steps, jsteps):
        assert s_o == s_t
        keys = [k for k in st_t if k.startswith(STAT_PREFIXES) or k in STAT_KEYS]
        assert len(keys) >= min_keys
        for k in keys:
            np.testing.assert_allclose(st_o[k], float(st_t[k]), rtol=RTOL, atol=STAT_ATOL,
                                       err_msg=f"step {s_o} {k}")


def _compare_weights(model, want):
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("nlu,depth,loss_kernel", [
    (-1, 0, "xla"), (-1, 2, "pallas"), (1, 2, "xla"), (1, 0, "pallas")])
def test_seq2seq_ppo_matches_jax_trainer(jax_ppo, tmp_path, nlu, depth, loss_kernel):
    run = jax_ppo(nlu)
    d = _ppo_dict(tmp_path, nlu, rollout_pipeline_depth=depth)
    d["method"]["loss_kernel"] = loss_kernel

    def hook(trainer):
        trainer.model.load_state_dict(seq2seq_params_from_jax(run["params0"], trainer.tcfg))
        trainer.ref_params = trainer._ref_snapshot()

    trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_prompts(),
                                   config=TRLConfig.from_dict(d), init_trainer_hook=hook,
                                   device="cpu")
    assert trainer.is_seq2seq and type(trainer.ref_params).__name__ == (
        "Seq2SeqHydraBranch" if nlu > 0 else "T5Transformer")
    ours, theirs = _store(trainer), run["store"]
    assert len(ours) == len(theirs) == 32
    for i, (a, b) in enumerate(zip(ours, theirs)):
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"query {i}")
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"response {i}")
        for j, name in ((2, "logprobs"), (3, "values"), (4, "rewards")):
            np.testing.assert_allclose(np.asarray(a[j], np.float32), np.asarray(b[j], np.float32),
                                       atol=ATOL, rtol=0, err_msg=f"{name} {i}")
    _compare_steps(trainer.tracker.history, run["history"], 4, min_keys=20)
    _compare_weights(trainer.model, seq2seq_params_from_jax(run["params"], trainer.tcfg))
    collections = [st for _, st in trainer.tracker.history if "time/exp" in st]
    assert len(collections) == 1 and "memory/kv_cache_bytes" not in collections[0]


def _snapshot(trainer):
    return {"model": {k: v.clone() for k, v in trainer.model.state_dict().items()},
            "optimizer": trainer.optimizer.state_dict(), "store": _store(trainer),
            "scalars": (trainer.iter_count, trainer.step, trainer.kl_ctl.value, trainer.mean_kl,
                        trainer.running_moments.mean, trainer.running_moments.var,
                        trainer._prompt_chunks_drawn)}


def test_seq2seq_ppo_resume_equals_the_uninterrupted_run(tmp_path):
    full_dir, resumed_dir = tmp_path / "full", tmp_path / "resumed"

    def config(directory, **train):
        d = _ppo_dict(directory, -1, total_steps=8, **train)
        d["method"]["gen_kwargs"].update(do_sample=True)
        return TRLConfig.from_dict(d)

    full = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_prompts(), config=config(full_dir),
                                device="cpu")
    want = _snapshot(full)
    shutil.copytree(full_dir / "checkpoint_4", resumed_dir / "checkpoint_4")
    resumed = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_prompts(),
                                   config=config(resumed_dir, resume_from_checkpoint=True),
                                   device="cpu")
    got = _snapshot(resumed)
    assert got["scalars"] == want["scalars"] and want["scalars"][0] == 8
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for a, b in zip(got["optimizer"]["state"].values(), want["optimizer"]["state"].values()):
        for k in b:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k
    assert len(got["store"]) == len(want["store"]) == 32
    for x, y in zip(got["store"], want["store"]):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    assert load_state(str(resumed_dir / "checkpoint_8"))["step"] == 8


def test_seq2seq_evaluate_joins_prompt_and_output(tmp_path, caplog):
    d = _ppo_dict(tmp_path, -1)
    d["model"]["draft_model_path"] = "builtin:gpt2-test"
    seen = {}

    def record(samples, prompts, outputs):
        seen.update(samples=samples, prompts=prompts, outputs=outputs)
        return [1.0] * len(samples)

    with caplog.at_level(logging.WARNING, logger="trlx_tpu_torch.trainer.base"):
        trainer = PPOTrainer(config=TRLConfig.from_dict(d), reward_fn=record, device="cpu")
    assert trainer.draft_model is None
    assert any("draft_model_path is ignored for seq2seq" in r.getMessage()
               for r in caplog.records)
    prompts = ["alpha beta", "gamma delta", "epsilon zeta", "eta theta"]
    trainer.add_eval_pipeline(PromptPipeline(prompts, 16, trainer.tokenizer))
    trainer.evaluate()
    assert sorted(seen["prompts"]) == sorted(prompts)
    for s, p, o in zip(seen["samples"], seen["prompts"], seen["outputs"]):
        assert s == p + " " + o


# ---------------------------------------------------------------------------
# ILQL
# ---------------------------------------------------------------------------


def _ilql_samples(n=20, seed=0):
    """(prompt, output) pairs of varied lengths, one output a single token
    and one prompt cut from the left by ``seq_length``, rewards ±1 as the
    TL;DR recipe labels chosen and rejected summaries. Every batch of four
    pads to one shape (prompts and outputs to 16, actions to 16), so the
    JAX train step compiles once."""
    rs = np.random.RandomState(seed)
    samples = [[_words(rs, 9, 17), _words(rs, 10, 17)] for _ in range(n - 2)]
    samples += [[_words(rs, 9, 12), "z"], [_words(rs, 20, 24), _words(rs, 14, 17)]]
    return samples, [1.0 if i % 2 == 0 else -1.0 for i in range(n)]


def _ilql_dict(tmp):
    """The TL;DR T5 example's method and optimizer settings at
    ``builtin:flan_t5-test``, cut in lengths and steps."""
    d = jax_default_ilql_config().to_dict()
    d["model"].update(model_path="builtin:flan_t5-test", model_arch_type="seq2seq",
                      num_layers_unfrozen=-1)
    d["tokenizer"].update(truncation_side="left")
    d["parallel"].update(compute_dtype="float32")
    d["train"].update(seq_length=32, batch_size=4, total_steps=6, epochs=10, save_best=False,
                      checkpoint_interval=1000, eval_interval=1000, checkpoint_dir=str(tmp),
                      tracker=None)
    d["optimizer"].update(name="adamw", kwargs=dict(lr=1e-6, betas=(0.9, 0.95), eps=1e-8,
                                                    weight_decay=1e-6))
    d["scheduler"].update(name="cosine_annealing", kwargs=dict(T_max=5000, eta_min=1e-6,
                                                               lr=1e-6))
    d["method"].update(tau=0.6, gamma=0.99, cql_scale=0.1, awac_scale=1, alpha=0.0001, beta=0,
                       steps_for_target_q_sync=1, two_qs=True,
                       gen_kwargs=dict(max_new_tokens=6, top_k=50, beta=1.0, temperature=1.0,
                                       do_sample=False))
    return d


EVAL_PROMPTS = ["ab cd", "efghi", "j", "klmn op"]
BETAS = (1.0, 5.0)


@pytest.fixture(scope="module")
def jax_ilql(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRLX_TPU_MFU", "0")  # no background FLOP-count compile
        return _jax_ilql(tmp_path_factory.mktemp("jax_ilql"))


def _jax_ilql(tmp):
    config = JaxTRLConfig.from_dict(_ilql_dict(tmp))
    trainer = JaxILQLTrainer(config=config)
    params0 = _np_tree(trainer.state.params)
    trainer.tracker = _Recorder()
    batch = next(iter(JaxPromptPipeline(EVAL_PROMPTS, 16, trainer.tokenizer).create_loader(4)))
    greedy = {}
    for beta in BETAS:
        out = trainer.generate(batch["input_ids"], batch["attention_mask"], eval_mode=True,
                               beta=beta)
        greedy[beta] = (np.asarray(out.response_tokens), np.asarray(out.response_mask))
    samples, rewards = _ilql_samples()
    trainer.make_experience(samples, rewards, config.train.seq_length)
    store = trainer.store
    trainer.add_eval_pipeline(JaxPromptPipeline(EVAL_PROMPTS, 16, trainer.tokenizer))
    trainer.learn()
    return dict(params0=params0, history=trainer.tracker.history, store=store,
                params=_np_tree(trainer.state.params), greedy=greedy)


ILQL_FIELDS = ("input_ids", "attention_mask", "decoder_input_ids", "states_ixs", "actions_ixs",
               "dones")


def test_make_experience_seq2seq_matches_jax():
    samples, rewards = _ilql_samples(23, seed=3)
    samples.append("a bare string, no output turn")
    rewards.append(0.5)
    for depth in (0, 2):
        ours = make_experience_seq2seq(samples, rewards, ByteTokenizer(), max_length=16,
                                       pipeline_depth=depth)
        theirs = jax_make_experience_seq2seq(samples, rewards, JaxByteTokenizer(),
                                             max_length=16, verbose=False)
        assert len(ours) == len(theirs) == 24
        for i, (a, b) in enumerate(zip(ours.history, theirs.history)):
            for f in ILQL_FIELDS:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{f} {i}")
                assert getattr(a, f).dtype == getattr(b, f).dtype, f
            np.testing.assert_array_equal(a.rewards, b.rewards, err_msg=f"rewards {i}")
        ours_b = list(ours.create_loader(5, shuffle=True, seed=1))
        theirs_b = list(theirs.create_loader(5, shuffle=True, seed=1))
        assert len(ours_b) == len(theirs_b) == 4
        for x, y in zip(ours_b, theirs_b):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)


def test_seq2seq_ilql_matches_jax_trainer(jax_ilql, tmp_path):
    config = TRLConfig.from_dict(_ilql_dict(tmp_path))
    trainer = ILQLTrainer(config=config, device="cpu")
    trainer.model.load_state_dict(seq2seq_params_from_jax(jax_ilql["params0"], trainer.tcfg))
    samples, rewards = _ilql_samples()
    trainer.make_experience(samples, rewards, config.train.seq_length)
    for a, b in zip(trainer.store.history, jax_ilql["store"].history):
        for f in ILQL_FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    trainer.add_eval_pipeline(PromptPipeline(EVAL_PROMPTS, 16, trainer.tokenizer))
    targets0 = {k: v.clone() for k, v in trainer.model.state_dict().items()
                if ".target_q_head_" in k}
    trainer.learn()
    _compare_steps(trainer.tracker.history, jax_ilql["history"], 6, min_keys=19)
    final = trainer.model.state_dict()
    assert any(not torch.equal(final[k], v) for k, v in targets0.items())  # synced each step
    _compare_weights(trainer.model, seq2seq_params_from_jax(jax_ilql["params"], trainer.tcfg))


@pytest.mark.parametrize("beta", BETAS)
def test_seq2seq_ilql_greedy_eval_matches_jax(jax_ilql, tmp_path, beta):
    trainer = ILQLTrainer(config=TRLConfig.from_dict(_ilql_dict(tmp_path)), device="cpu")
    trainer.model.load_state_dict(seq2seq_params_from_jax(jax_ilql["params0"], trainer.tcfg))
    batch = next(iter(PromptPipeline(EVAL_PROMPTS, 16, trainer.tokenizer).create_loader(4)))
    out = trainer.generate(batch["input_ids"], batch["attention_mask"], eval_mode=True,
                           beta=beta)
    tokens, mask = jax_ilql["greedy"][beta]
    np.testing.assert_array_equal(out["response_mask"], mask)
    np.testing.assert_array_equal(out["response_tokens"] * mask, tokens * mask)
    if beta == BETAS[-1]:  # the hook moves the answers
        plain = trainer.generate(batch["input_ids"], batch["attention_mask"], eval_mode=True,
                                 beta=0.0)
        assert not np.array_equal(plain["response_tokens"], out["response_tokens"])
