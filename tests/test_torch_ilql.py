"""The ILQL path of the port (``trlx_tpu_torch/trainer/ilql.py``,
``models/ilql.py``, the ILQL heads, ``ILQLRolloutStorage``) against the
JAX package, on the CPU.

Inputs are made by numpy from a seed. Held:

- ``topk_mask`` and ``batched_index_select`` equal; ``ILQLConfig.loss``
  and every stat at 1e-5 relative in f32, and its gradients with respect
  to the logits, Q heads and values against ``jax.grad``;
- ``make_experience``'s store element for element, and its collated
  batches (shuffled, ``drop_last``) equal;
- ``params_from_jax`` on an ILQL policy: the port's forward gives JAX's
  logits, Q, target-Q and V heads;
- ``ILQLTrainer`` against the JAX ``ILQLTrainer`` from the same initial
  weights, with target syncs every 2 steps at alpha 0.1: each step's
  losses, value, Q and AWAC-weight stats, learning rate and gradient norm
  at ``rtol=1e-4`` and the final weights, target heads included, at
  ``atol=1e-4``; the target heads change at the sync steps and only
  there; with ``attention_impl`` ``xla`` and ``pallas``;
- the greedy eval answers on the paged engine, through the
  advantage-shaped sampling hook, equal JAX's serial ``generate`` with
  the same hook, token for token;
- ``trlx_tpu_torch.train(samples=..., rewards=...)`` end to end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelConfig as JaxModelConfig
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.data.default_configs import default_ilql_config as jax_default_ilql_config
from trlx_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from trlx_tpu.models.builder import build_causal_lm as jax_build_causal_lm
from trlx_tpu.models.ilql import ILQLConfig as JaxILQLConfig
from trlx_tpu.models.ilql import batched_index_select as jax_batched_index_select
from trlx_tpu.models.ilql import topk_mask as jax_topk_mask
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPromptPipeline
from trlx_tpu.trainer.ilql import ILQLTrainer as JaxILQLTrainer
from trlx_tpu.trainer.ilql import make_experience as jax_make_experience
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_ilql_config
from trlx_tpu_torch.data.tokenizer import ByteTokenizer
from trlx_tpu_torch.models.builder import build_causal_lm, trainable_mask
from trlx_tpu_torch.models.ilql import ILQLConfig, batched_index_select, topk_mask
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.ilql import ILQLTrainer, make_experience
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

RTOL, ATOL = 1e-4, 1e-4
LOSS_RTOL = 1e-5
STAT_PREFIXES = ("losses/", "values/", "qvalues/", "awac_weight/")
STAT_KEYS = ("learning_rate", "gradients/global_norm")
SYNC_EVERY = 2


def _words(rs, lo, hi):
    return "".join(chr(c) for c in rs.randint(97, 123, size=rs.randint(lo, hi)))


def _samples(n=16, seed=0):
    """Reward-labeled dialogues of varied lengths (some truncated), a
    two-exchange one and bare strings, with rewards from the same seed."""
    rs = np.random.RandomState(seed)
    out = [[_words(rs, 2, 9), _words(rs, 3, 16)] for _ in range(n - 3)]
    out.append([_words(rs, 2, 5), _words(rs, 2, 5), _words(rs, 2, 5), _words(rs, 2, 6)])
    out += [_words(rs, 4, 12), _words(rs, 4, 30)]
    return out, list(rs.rand(n) * 2 - 0.5)


def test_topk_mask_and_index_select_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5, 11).astype(np.float32)
    for k in (1, 4, 11, 20):
        np.testing.assert_array_equal(topk_mask(torch.tensor(x), k).numpy(),
                                      np.asarray(jax_topk_mask(jnp.asarray(x), k)))
    idx = rs.randint(0, 5, size=(3, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        batched_index_select(torch.tensor(x), torch.tensor(idx)).numpy(),
        np.asarray(jax_batched_index_select(jnp.asarray(x), jnp.asarray(idx))))


def _loss_inputs(seed, B=3, A=6, V=13, n_qs=2):
    rs = np.random.RandomState(seed)
    f = lambda *shape, scale=1.0: (rs.randn(*shape) * scale).astype(np.float32)  # noqa: E731
    dones = np.zeros((B, A + 1), np.float32)
    for b, n in enumerate(rs.randint(1, A + 1, size=B)):
        dones[b, :n] = 1.0
    return dict(
        logits=f(B, A, V, scale=2.0), qs=[f(B, A, V) for _ in range(n_qs)],
        target_qs=[f(B, A, V) for _ in range(n_qs)], vs=f(B, A + 1, 1),
        actions=rs.randint(0, V, size=(B, A)).astype(np.int32), rewards=f(B, A, scale=0.5),
        dones=dones,
    )


@pytest.mark.parametrize("two_qs,beta,dist_sketches", [(True, 0.5, True), (False, 0.0, False)])
def test_ilql_loss_and_grads_match_jax(two_qs, beta, dist_sketches):
    inp = _loss_inputs(7 + two_qs, n_qs=2 if two_qs else 1)
    kw = dict(tau=0.7, gamma=0.99, cql_scale=0.1, awac_scale=1.0, alpha=0.005, beta=beta,
              steps_for_target_q_sync=5, two_qs=two_qs, gen_kwargs={},
              dist_sketches=dist_sketches)

    def jax_loss(logits, qs, vs):
        return JaxILQLConfig(**kw).loss(
            logits, tuple(qs), tuple(jnp.asarray(t) for t in inp["target_qs"]), vs,
            jnp.asarray(inp["actions"]), jnp.asarray(inp["rewards"]), jnp.asarray(inp["dones"]))

    jargs = (jnp.asarray(inp["logits"]), [jnp.asarray(q) for q in inp["qs"]],
             jnp.asarray(inp["vs"]))
    (wloss, wstats), wgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(*jargs)

    logits = torch.tensor(inp["logits"], requires_grad=True)
    qs = [torch.tensor(q, requires_grad=True) for q in inp["qs"]]
    vs = torch.tensor(inp["vs"], requires_grad=True)
    loss, stats = ILQLConfig(**kw).loss(
        logits, tuple(qs), tuple(torch.tensor(t) for t in inp["target_qs"]), vs,
        torch.tensor(inp["actions"]), torch.tensor(inp["rewards"]), torch.tensor(inp["dones"]))
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(wloss), rtol=LOSS_RTOL)
    assert sorted(stats) == sorted(wstats)
    for k, want in wstats.items():
        np.testing.assert_allclose(stats[k].detach().numpy(), np.asarray(want),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    for got, want in zip([logits.grad] + [q.grad for q in qs] + [vs.grad],
                         [wgrads[0]] + list(wgrads[1]) + [wgrads[2]]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_RTOL, atol=1e-7)


def test_make_experience_matches_jax():
    samples, rewards = _samples(21, seed=5)
    ours = make_experience(samples, rewards, ByteTokenizer(), max_length=20)
    theirs = jax_make_experience(samples, rewards, JaxByteTokenizer(), max_length=20,
                                 verbose=False)
    assert len(ours) == len(theirs) == 21
    fields = ("input_ids", "attention_mask", "rewards", "states_ixs", "actions_ixs", "dones")
    for i, (a, b) in enumerate(zip(ours.history, theirs.history)):
        for f in fields:
            np.testing.assert_array_equal(getattr(a, f), np.asarray(getattr(b, f)),
                                          err_msg=f"{f} {i}")
    # the return normalisation runs in float64, so the last-action returns
    # agree to f32 rounding exactly
    assert any(np.any(e.rewards != 0) for e in ours.history)
    for kw in (dict(seed=0), dict(seed=3, fixed_length=24), dict(shuffle=False)):
        batches = list(ours.create_loader(4, **kw))
        jbatches = list(theirs.create_loader(4, **kw))
        assert len(batches) == len(jbatches) == 5  # drop_last
        for b, jb in zip(batches, jbatches):
            for f in b._fields:
                np.testing.assert_array_equal(getattr(b, f), np.asarray(getattr(jb, f)),
                                              err_msg=f)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


@pytest.mark.parametrize("two_qs", [True, False])
def test_params_from_jax_ilql_heads(two_qs):
    cfg = JaxModelConfig(model_path="builtin:gpt2-test",
                         model_extra_kwargs=dict(dtype=jnp.float32))
    module, params, _ = jax_build_causal_lm(cfg, head="ilql", two_qs=two_qs, seed=3)
    model, tcfg = build_causal_lm("builtin:gpt2-test", device="cpu", head="ilql",
                                  two_qs=two_qs, dtype=torch.float32)
    sd = params_from_jax(_np_tree(params), tcfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 256, size=(2, 9)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 6:] = 0  # right padding
    want = module.apply({"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    got = model(torch.tensor(ids), attention_mask=torch.tensor(mask))
    for name in ("logits", "vs"):
        np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(want[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    for name in ("qs", "target_qs"):
        assert len(got[name]) == len(want[name]) == (2 if two_qs else 1)
        for a, b in zip(got[name], want[name]):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5,
                                       rtol=1e-5, err_msg=name)
    # a fresh port model starts its target heads as copies of the Q heads,
    # and the optimizer mask leaves them out
    fresh, _ = build_causal_lm("builtin:gpt2-test", device="cpu", head="ilql", two_qs=two_qs)
    fsd = fresh.state_dict()
    targets = [k for k in fsd if ".target_q_head_" in k]
    assert len(targets) == 4 * (2 if two_qs else 1)
    for k in targets:
        assert torch.equal(fsd[k], fsd[k.replace("target_q_head", "q_head")]), k
    mask = trainable_mask(fresh, tcfg, -1)
    assert [k for k, v in mask.items() if not v] == targets


class _Recorder:
    def __init__(self):
        self.history = []

    def log(self, stats, step):
        self.history.append((int(step), dict(stats)))

    def finish(self):
        pass


def _config_dict(tmp):
    d = jax_default_ilql_config().to_dict()
    d["model"].update(model_path="builtin:gpt2-test")
    d["parallel"].update(compute_dtype="float32")
    d["train"].update(seq_length=20, batch_size=4, total_steps=7, epochs=10,
                      save_best=False, checkpoint_interval=1000, eval_interval=1000,
                      checkpoint_dir=str(tmp), tracker=None)
    d["method"].update(alpha=0.1, beta=0.5, steps_for_target_q_sync=SYNC_EVERY,
                       gen_kwargs=dict(max_new_tokens=6, top_k=20, beta=1.0, do_sample=False))
    # the PPO parity test's rates: Adam scales an element whose gradient is
    # f32 rounding noise near eps up to a sizeable fraction of lr, so the
    # final weights are held at atol 1e-4 after steps of lr <= 1e-3
    d["optimizer"]["kwargs"].update(lr=1e-3)
    d["scheduler"].update(name="cosine_annealing", kwargs=dict(T_max=10, eta_min=1e-4, lr=1e-3))
    return d


EVAL_PROMPTS = ["ab", "cdefg", "h", "ijkl"]
# greedy eval stages: (weights, generate overrides). At the random
# initialisation β = 1 leaves every argmax where log π puts it; β = 5 moves
# them, so that stage holds the hook's arithmetic
GREEDY_STAGES = {"init": ("params0", {}), "init_beta5": ("params0", {"beta": 5.0}),
                 "trained": ("params", {})}


def _target_heads(model_sd):
    return {k: v.clone() for k, v in model_sd.items() if ".target_q_head_" in k}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    config = JaxTRLConfig.from_dict(_config_dict(tmp_path_factory.mktemp("jax_ilql")))
    trainer = JaxILQLTrainer(config=config)
    params0 = _np_tree(trainer.state.params)
    trainer.tracker = _Recorder()
    batch = next(iter(JaxPromptPipeline(EVAL_PROMPTS, 14, trainer.tokenizer).create_loader(4)))
    greedy = {}

    def answer(stage):
        out = trainer.generate(batch["input_ids"], batch["attention_mask"], eval_mode=True,
                               **GREEDY_STAGES[stage][1])
        greedy[stage] = (np.asarray(out.response_tokens), np.asarray(out.response_mask))

    answer("init")
    answer("init_beta5")
    samples, rewards = _samples()
    trainer.make_experience(samples, rewards, config.train.seq_length)
    trainer.add_eval_pipeline(JaxPromptPipeline(EVAL_PROMPTS, 14, trainer.tokenizer))
    trainer.learn()
    answer("trained")
    return dict(params0=params0, history=trainer.tracker.history,
                params=_np_tree(trainer.state.params), greedy=greedy)


def _step_stats(history):
    return [(s, st) for s, st in history if "gradients/global_norm" in st]


@pytest.mark.parametrize("attention_impl", ["xla", "pallas"])
def test_ilql_trainer_matches_jax(jax_run, tmp_path, attention_impl):
    d = _config_dict(tmp_path)
    d["model"]["model_extra_kwargs"] = {"attention_impl": attention_impl}
    config = TRLConfig.from_dict(d)
    trainer = ILQLTrainer(config=config, device="cpu")
    trainer.model.load_state_dict(params_from_jax(jax_run["params0"], trainer.tcfg))
    samples, rewards = _samples()
    trainer.make_experience(samples, rewards, config.train.seq_length)
    trainer.add_eval_pipeline(PromptPipeline(EVAL_PROMPTS, 14, trainer.tokenizer))

    # the target heads after each batch's callback, by iteration
    synced = {0: _target_heads(trainer.model.state_dict())}
    callback = trainer.post_backward_callback

    def recording_callback():
        callback()
        synced[trainer.iter_count] = _target_heads(trainer.model.state_dict())

    trainer.post_backward_callback = recording_callback
    trainer.learn()

    steps = config.train.total_steps
    assert sorted(synced) == list(range(steps))  # the last step returns first
    for it in range(1, steps):
        changed = any(not torch.equal(synced[it][k], synced[it - 1][k]) for k in synced[it])
        assert changed == (it % SYNC_EVERY == 0), f"target heads at iteration {it}"

    ours, theirs = _step_stats(trainer.tracker.history), _step_stats(jax_run["history"])
    assert len(ours) == len(theirs) == steps
    for (s_o, st_o), (s_t, st_t) in zip(ours, theirs):
        assert s_o == s_t
        keys = [k for k in st_t if k.startswith(STAT_PREFIXES) or k in STAT_KEYS]
        assert len(keys) >= 19
        for k in keys:
            np.testing.assert_allclose(st_o[k], float(st_t[k]), rtol=RTOL, atol=1e-6,
                                       err_msg=f"step {s_o} {k}")
    final = params_from_jax(jax_run["params"], trainer.tcfg)
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("stage", list(GREEDY_STAGES))
@pytest.mark.parametrize("attention_impl", ["xla", "pallas"])
def test_greedy_eval_matches_jax_generate(jax_run, tmp_path, attention_impl, stage):
    """The paged engine with the ILQL hook (top-k 20) answers as JAX's
    serial ``generate`` does, greedy, from JAX's initial and trained
    weights."""
    d = _config_dict(tmp_path)
    d["model"]["model_extra_kwargs"] = {"attention_impl": attention_impl}
    trainer = ILQLTrainer(config=TRLConfig.from_dict(d), device="cpu")
    params, overrides = GREEDY_STAGES[stage]
    trainer.model.load_state_dict(params_from_jax(jax_run[params], trainer.tcfg))
    batch = next(iter(PromptPipeline(EVAL_PROMPTS, 14, trainer.tokenizer).create_loader(4)))
    out = trainer.generate(batch["input_ids"], batch["attention_mask"], eval_mode=True,
                           **overrides)
    tokens, mask = jax_run["greedy"][stage]
    np.testing.assert_array_equal(out["response_mask"], mask)
    np.testing.assert_array_equal(out["response_tokens"] * mask, tokens * mask)
    assert np.all(out["response_values"] == 0)  # the hook reads vs; values are PPO's
    if params == "params0":
        assert mask.sum() > 2 * len(EVAL_PROMPTS)  # answers longer than an eos
    if "beta" in overrides:
        plain = trainer.generate(batch["input_ids"], batch["attention_mask"], eval_mode=True,
                                 beta=0.0)
        assert not np.array_equal(plain["response_tokens"] * mask, tokens * mask)


def test_train_entry_point_ilql(tmp_path):
    import trlx_tpu_torch

    d = _config_dict(tmp_path)
    d["model"]["model_extra_kwargs"] = {"attention_impl": "pallas"}
    d["method"]["gen_kwargs"] = dict(max_new_tokens=6, top_k=10, beta=1.0, temperature=0.5)
    d["train"].update(total_steps=3, checkpoint_interval=2, eval_interval=2)
    config = TRLConfig.from_dict(d)
    samples, rewards = _samples()
    trainer = trlx_tpu_torch.train(samples=samples, rewards=rewards, config=config,
                                   device="cpu")
    assert trainer.iter_count == 3 and trainer.step == 3
    losses = [st["losses/loss"] for _, st in trainer.tracker.history if "losses/loss" in st]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert (tmp_path / "checkpoint_2" / "state.pt").exists()
    # the deprecated dataset argument is (samples, rewards)
    d["train"].update(total_steps=1, checkpoint_dir=str(tmp_path / "ds"))
    with pytest.warns(UserWarning, match="deprecated"):
        trainer = trlx_tpu_torch.train(dataset=(samples, rewards),
                                       config=TRLConfig.from_dict(d), device="cpu")
    assert trainer.iter_count == 1


def test_default_ilql_config_matches_jax():
    assert default_ilql_config().to_dict() == jax_default_ilql_config().to_dict()
