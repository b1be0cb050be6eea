"""The reward model of the port (``trlx_tpu_torch/models/reward.py``) and
its TL;DR task (``tasks/summarize_rlhf.py``) against the JAX package, on
the CPU.

Inputs are made by numpy from a seed; weights go through
``params_from_jax``. Held at 1e-5 in f32:

- ``pairwise_reward_loss`` and ``end_scores``: loss, stats and the
  gradients with respect to both reward maps, on pairs that diverge at
  different positions, pairs of unequal lengths, a pair differing in its
  mask alone and an identical pair (which adds nothing);
- ``reward_loss_fn`` through ``RewardModel`` (``builtin:gpt2-test``, and
  ``mistral-test``'s untied head and GQA): loss, stats and every
  parameter's gradient;
- stage 2 of ``tasks/summarize_rlhf.py`` for a few steps against the same
  loop written with ``optax.adamw`` on the JAX model (the batches drawn by
  ``RandomState(0).randint``, weight decay 1e-4): per-step stats and the
  final weights;
- stage 3's reward function: the port's checkpoint scores against JAX's
  ``load_reward_fn`` on the same weights, and the baseline subtraction;
- ``build_reward_model`` refuses a checkpoint path, naming
  ``models/hf_interop.py``.
"""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from trlx_tpu.data.configs import ModelConfig as JaxModelConfig
from trlx_tpu.models.reward import build_reward_model as jax_build_reward_model
from trlx_tpu.models.reward import end_scores as jax_end_scores
from trlx_tpu.models.reward import pairwise_reward_loss as jax_pairwise_reward_loss
from trlx_tpu.models.reward import reward_loss_fn as jax_reward_loss_fn
from trlx_tpu_torch.data.configs import TokenizerConfig
from trlx_tpu_torch.data.tokenizer import from_config as tokenizer_from_config
from trlx_tpu_torch.models.reward import (
    build_reward_model,
    end_scores,
    pairwise_reward_loss,
    reward_loss_fn,
)
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.tasks import summarize_rlhf
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

RTOL = 1e-5
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "summarize_rlhf")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pairs(B=7, T=12, seed=0):
    """Right-padded pairs: diverging at random positions with unequal
    lengths, pair 4 identical, pair 5 differing in its mask alone."""
    rs = np.random.RandomState(seed)
    c_ids = rs.randint(1, 50, (B, T)).astype(np.int32)
    r_ids = c_ids.copy()
    c_mask = np.ones((B, T), np.int32)
    r_mask = np.ones((B, T), np.int32)
    for i in range(B):
        div = rs.randint(2, 8)
        r_ids[i, div:] = rs.randint(1, 50, T - div)
        c_end, r_end = rs.randint(div + 1, T + 1), rs.randint(div + 1, T + 1)
        c_mask[i, c_end:] = r_mask[i, r_end:] = 0
        c_ids[i, c_end:] = r_ids[i, r_end:] = 0
    r_ids[4], r_mask[4] = c_ids[4], c_mask[4]
    r_ids[5], r_mask[5] = c_ids[5], c_mask[5].copy()
    n5 = int(c_mask[5].sum())
    r_mask[5, n5 - 1] = 0  # one token shorter, ids equal
    r_ids[5, n5 - 1] = 0
    return c_ids, r_ids, c_mask, r_mask


def test_pairwise_loss_and_end_scores_match_jax():
    c_ids, r_ids, c_mask, r_mask = _pairs()
    rs = np.random.RandomState(1)
    c_rew = rs.randn(*c_ids.shape).astype(np.float32)
    r_rew = rs.randn(*c_ids.shape).astype(np.float32)

    def jax_loss(c, r):
        return jax_pairwise_reward_loss(c, r, *map(jnp.asarray, (c_ids, r_ids, c_mask, r_mask)))

    (jl, jstats), (jgc, jgr) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(c_rew), jnp.asarray(r_rew))
    c, r = (torch.tensor(x, requires_grad=True) for x in (c_rew, r_rew))
    loss, stats = pairwise_reward_loss(c, r, *map(torch.as_tensor,
                                                  (c_ids, r_ids, c_mask, r_mask)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL)
    assert set(stats) == set(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), rtol=RTOL, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jgc), rtol=RTOL, atol=1e-8)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(jgr), rtol=RTOL, atol=1e-8)
    # the identical pair takes no gradient; the mask-only pair does
    assert not c.grad[4].any() and not r.grad[4].any() and c.grad[5].any()
    for rew, mask in ((c_rew, c_mask), (r_rew, np.zeros_like(c_mask))):  # an empty row too
        np.testing.assert_array_equal(
            end_scores(torch.as_tensor(rew), torch.as_tensor(mask)).numpy(),
            np.asarray(jax_end_scores(jnp.asarray(rew), jnp.asarray(mask))))


def _models(spec):
    jmodule, jparams, _ = jax_build_reward_model(JaxModelConfig(
        spec, model_extra_kwargs=dict(dtype=jnp.float32, param_dtype=jnp.float32)))
    model, cfg = build_reward_model(spec, device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(_np_tree(jparams), cfg))
    return jmodule, jparams, model, cfg


@pytest.mark.parametrize("spec", ["builtin:gpt2-test", "builtin:mistral-test"])
def test_reward_loss_fn_and_gradients_match_jax(spec):
    jmodule, jparams, model, cfg = _models(spec)
    c_ids, r_ids, c_mask, r_mask = _pairs(B=7, T=16, seed=2)
    batch = {"chosen_ids": c_ids, "rejected_ids": r_ids, "chosen_mask": c_mask,
             "rejected_mask": r_mask}
    (jl, jstats), jgrads = jax.value_and_grad(
        lambda p: jax_reward_loss_fn(jmodule, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    model.requires_grad_(True)
    loss, stats = reward_loss_fn(model, {k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL)
    for k, v in jstats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), rtol=RTOL, atol=1e-6, err_msg=k)
    want = params_from_jax(_np_tree(jgrads), cfg)
    assert set(want) == {n for n, _ in model.named_parameters()}
    # at 1e-5 of the largest gradient: some are zero in exact arithmetic
    # (a bias ahead of the head shifts both halves of a pair alike)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad  # the unused LM head
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0, atol=RTOL * scale,
                                   err_msg=name)


def test_build_reward_model_refuses_a_checkpoint_path():
    with pytest.raises(ValueError, match="models/hf_interop.py"):
        build_reward_model("EleutherAI/gpt-j-6B", device="cpu")


STAGE2 = dict(max_length=96, batch_size=8, total_steps=4, lr=1e-4, n_pairs=32)


@pytest.fixture(scope="module")
def jax_stage2():
    """The stage-2 loop of ``examples/summarize_rlhf/train_reward_model.py``
    on the JAX model (``optax.adamw(lr)``), from seed-0 weights."""
    from trlx_tpu.data.configs import TokenizerConfig as JaxTokenizerConfig
    from trlx_tpu.data.tokenizer import from_config as jax_tokenizer_from_config

    sys.path.insert(0, EXAMPLES)
    try:
        import summarize_util
        import train_reward_model
    finally:
        sys.path.remove(EXAMPLES)
    tok = jax_tokenizer_from_config(JaxTokenizerConfig(tokenizer_path="builtin:bytes"))
    module, params, tcfg = jax_build_reward_model(JaxModelConfig(
        "builtin:gpt2-test", model_extra_kwargs=dict(dtype=jnp.float32)))
    params0 = _np_tree(params)
    pairs = train_reward_model.tokenize_pairs(
        summarize_util.load_comparisons(STAGE2["n_pairs"], seed=0), tok, STAGE2["max_length"])
    opt = optax.adamw(STAGE2["lr"])
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, batch):
        (loss, stats), grads = jax.value_and_grad(
            lambda p: jax_reward_loss_fn(module, p, batch), has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, stats

    rng = np.random.RandomState(0)
    history = []
    for _ in range(STAGE2["total_steps"]):
        ix = rng.randint(0, pairs["chosen_ids"].shape[0], STAGE2["batch_size"])
        params, opt_state, stats = step(params, opt_state,
                                        {k: jnp.asarray(v[ix]) for k, v in pairs.items()})
        history.append({k: float(v) for k, v in stats.items()})
    return {"params0": params0, "params": _np_tree(params), "history": history,
            "pairs": pairs, "module": module, "tcfg": tcfg, "save": train_reward_model}


def test_stage2_matches_the_optax_loop(jax_stage2, tmp_path):
    def load(model):
        model.load_state_dict(params_from_jax(jax_stage2["params0"], model.config))

    model, cfg, history = summarize_rlhf.train_reward_model(
        "builtin:gpt2-test", device="cpu", model_extra_kwargs={"dtype": torch.float32},
        checkpoint_dir=str(tmp_path / "rm"), init_hook=load, **STAGE2)
    # the decay is optax.adamw's default, not torch's 1e-2
    tok = tokenizer_from_config(TokenizerConfig(tokenizer_path="builtin:bytes"))
    pairs = summarize_rlhf.tokenize_pairs(summarize_rlhf.load_comparisons(STAGE2["n_pairs"]),
                                          tok, STAGE2["max_length"])
    for k, v in jax_stage2["pairs"].items():
        np.testing.assert_array_equal(pairs[k], v, err_msg=k)
    assert len(history) == len(jax_stage2["history"]) == STAGE2["total_steps"]
    for i, (ours, theirs) in enumerate(zip(history, jax_stage2["history"])):
        for k, v in theirs.items():
            # the end means move with ln_f's bias, whose exact gradient is 0
            # (it shifts both halves of a pair alike): Adam turns each
            # side's rounding noise there into steps of up to ~1e-5
            atol = 1e-5 if k.endswith("_end_mean") else 1e-6
            np.testing.assert_allclose(ours[k], v, rtol=RTOL, atol=atol, err_msg=f"{i} {k}")
    final = params_from_jax(jax_stage2["params"], cfg)
    start = params_from_jax(jax_stage2["params0"], cfg)
    moved = 0.0
    for k, v in model.state_dict().items():
        # ln_f's bias has an exact gradient of 0: Adam turns the port's
        # rounding noise there into steps (JAX's sum cancels exactly), so
        # it is held to the 4 steps' bound of lr each
        atol = STAGE2["lr"] * STAGE2["total_steps"] if k == "backbone.ln_f.bias" else 1e-5
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=atol, rtol=0, err_msg=k)
        moved = max(moved, float((v - start[k]).abs().max()))
    assert moved > 1e-4
    # the unit-initialised norm scales move by the decay as well: a weight
    # decay of 1e-2 would put them 4 steps × 1e-4 × 1e-2 further off
    ln = "backbone.ln_f.weight"
    np.testing.assert_allclose(model.state_dict()[ln].numpy(), final[ln].numpy(), atol=5e-7,
                               rtol=0)


def test_stage3_reward_fn_matches_jax(jax_stage2, tmp_path):
    """The port's checkpoint and the JAX example's pickle of the same
    trained weights score the same texts alike; the stage-3 reward is the
    score minus the reference summary's."""
    sys.path.insert(0, EXAMPLES)
    try:
        import ppo_summarize
    finally:
        sys.path.remove(EXAMPLES)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jax_stage2["save"].save_reward_checkpoint(str(jdir), jax_stage2["params"],
                                              jax_stage2["tcfg"], "builtin:bytes")
    model, cfg = build_reward_model("builtin:gpt2-test", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax_stage2["params"], cfg))
    summarize_rlhf.save_reward_checkpoint(str(pdir), model, cfg, "builtin:bytes")
    jscore = ppo_summarize.load_reward_fn(str(jdir))
    score = summarize_rlhf.load_reward_fn(str(pdir), device="cpu")
    data = summarize_rlhf.load_tldr(6, seed=3)
    texts = [d["prompt"] + d["label"] for d in data] + ["short", "x" * 300]
    L = STAGE2["max_length"]  # within the test model's 128 positions
    np.testing.assert_allclose(score(texts, L), np.asarray(jscore(texts, L)), rtol=RTOL,
                               atol=1e-6)
    labels = {d["prompt"]: d["label"] for d in data[:3]}
    reward_fn = summarize_rlhf.make_reward_fn(lambda t: score(t, L), labels)
    prompts = [d["prompt"] for d in data]
    outputs = [" cat", " the gym closed", "", " music", " a", " b"]
    got = reward_fn(samples=None, prompts=prompts, outputs=outputs)
    base = np.asarray(jscore([p + labels.get(p, "") for p in prompts], L))
    want = np.asarray(jscore([p + o for p, o in zip(prompts, outputs)], L)) - base
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    with open(jdir / "reward_model.pkl", "rb") as f:
        assert "params" in pickle.load(f)
