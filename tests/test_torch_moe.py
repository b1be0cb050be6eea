"""The mixture-of-experts MLP of the port (``trlx_tpu_torch/models/
transformer.py``: ``MoEMLP``, the mixtral presets, ``router_aux_loss``) and
its trainers' router losses, against the JAX package on the CPU, in f32.

- ``MoEMLP`` against the JAX ``MoEMLP`` on one numpy tree: the output, the
  aux statistics and ``jax.grad`` of a loss over both (input and every
  weight), at 1e-5 of each tensor's largest value. Cases: plain, padding
  (a token mask), forced drops (``moe_capacity_factor`` 0.5), a
  ``moe_group_size`` that divides ``T`` (and one that makes the group the
  largest divisor below it) and ``moe_renormalize`` off;
- ``builtin:mixtral-test``: the full pass over left-padded rows with its
  ``router_aux_loss``, a dense-cache prefill and single-token decode steps
  (the same calls on both sides: the MoE groups follow ``T``), the hydra
  branch, and greedy tokens through the serial ``generate`` and the paged
  ``ContinuousEngine`` against JAX ``generate``, at ``ATOL`` 1e-5;
- the router losses fold into the PPO (both loss kernels), SFT, ILQL and
  GRPO losses under JAX's stat names, weighted by ``router_aux_coef`` and
  ``router_z_coef`` from ``model.model_extra_kwargs``;
- GRPO through ``train()`` on mixtral-test against JAX's (the serial
  path at the preset's sizes, as ``tests/test_torch_grpo.py`` runs
  gpt2-test): the store element by element, each step's stats, the router
  losses among them, and the final weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_grpo import _compare, _jax_run, _port_run
from tests.test_torch_transformer import _Jitted, _numpy_params
from trlx_tpu.models.builder import hydra_ref_params as jax_hydra_ref_params
from trlx_tpu.models.transformer import CausalTransformer as JaxCausalTransformer
from trlx_tpu.models.transformer import MoEMLP as JaxMoEMLP
from trlx_tpu.models.transformer import TransformerConfig as JaxConfig
from trlx_tpu.models.transformer import make_kv_cache as jax_make_kv_cache
from trlx_tpu.ops.sampling import GenerationConfig as JaxGenerationConfig
from trlx_tpu.ops.sampling import generate as jax_generate
from trlx_tpu_torch.data.default_configs import (
    default_grpo_config,
    default_ilql_config,
    default_ppo_config,
    default_sft_config,
)
from trlx_tpu_torch.engine.core import ContinuousEngine
from trlx_tpu_torch.models.builder import hydra_ref_params
from trlx_tpu_torch.models.transformer import (
    CausalTransformer,
    MoEMLP,
    TransformerConfig,
    config_from_spec,
    make_kv_cache,
)
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.ops.paged_kv import PagedSpec, num_table_blocks
from trlx_tpu_torch.ops.sampling import GenerationConfig, generate
from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.grpo import GRPOTrainer
from trlx_tpu_torch.trainer.ilql import ILQLTrainer
from trlx_tpu_torch.trainer.ppo import PPOTrainer
from trlx_tpu_torch.trainer.sft import SFTTrainer
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

ATOL = 1e-5
P, N = 12, 6


def _mixtral(**overrides):
    jcfg = dataclasses.replace(JaxConfig.mixtral("test", **overrides), dtype=jnp.float32)
    tcfg = TransformerConfig.mixtral("test", dtype=torch.float32, **overrides)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def mixtral():
    jcfg, tcfg = _mixtral()
    params = jax.tree_util.tree_map(np.asarray, _numpy_params(jcfg, seed=11))
    model = CausalTransformer(tcfg).eval()
    model.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, model=model,
                jm=_Jitted(JaxCausalTransformer(jcfg)))


def _prompts(V, B=3, width=P, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, V, (B, width)).astype(np.int32)
    mask = np.ones_like(ids)
    for b in range(B):  # left padding of 0, 3, 1 columns
        mask[b, : (0, 3, 1)[b % 3]] = 0
    return ids, mask


MOE_CASES = {
    "plain": ({}, 12, False),
    "padding": ({}, 12, True),
    "drops": ({"moe_capacity_factor": 0.5}, 12, True),
    "group_divides": ({"moe_group_size": 4}, 12, True),
    "group_largest_divisor": ({"moe_group_size": 4}, 10, False),
    "no_renormalize": ({"moe_renormalize": False}, 12, True),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_mlp_matches_jax(case):
    overrides, T, padded = MOE_CASES[case]
    jcfg, tcfg = _mixtral(**overrides)
    B, d = 3, jcfg.hidden_size
    rs = np.random.RandomState(len(case))
    x = rs.randn(B, T, d).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    if padded:
        mask[1, :4] = 0
        mask[2, :1] = 0
    module = JaxMoEMLP(jcfg)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, d))))
    params = jax.tree_util.tree_map(
        lambda s: (rs.randn(*s.shape) * 0.3).astype(np.float32), shapes["params"])
    cy = rs.randn(B, T, d).astype(np.float32)

    def jax_fn(p, xx):
        y, aux = module.apply({"params": p}, xx, jnp.asarray(mask) if padded else None)
        return jnp.sum(y * cy) + 0.7 * aux[0] / aux[2] + 0.3 * aux[1] / aux[2], (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    moe = MoEMLP(tcfg)
    sd = {"router.weight": torch.tensor(np.asarray(params["router"]["kernel"]).T)}
    sd.update({k: torch.tensor(np.asarray(params[k])) for k in ("w_gate", "w_up", "w_down")})
    moe.load_state_dict(sd, strict=True)
    xt = torch.tensor(x, requires_grad=True)
    y, aux = moe(xt, torch.tensor(mask) if padded else None)
    (torch.sum(y * torch.tensor(cy)) + 0.7 * aux[0] / aux[2] + 0.3 * aux[1] / aux[2]).backward()

    def close(got, want, name):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=ATOL * max(float(np.abs(want).max()), 1.0), err_msg=name)

    close(y, jy, "y")
    close(aux, jaux, "aux")
    close(xt.grad, jgx, "dx")
    close(moe.router.weight.grad.t(), jgp["router"]["kernel"], "d router")
    for k in ("w_gate", "w_up", "w_down"):
        close(getattr(moe, k).grad, jgp[k], f"d {k}")
    zero_rows = (np.abs(np.asarray(jy)).max(axis=-1) == 0) & (mask > 0)
    # the drop case drops real tokens; the others drop none here
    assert zero_rows.any() == (case == "drops")
    if padded:  # padding gets a zero output and claims no slot
        assert float(y.detach()[mask == 0].abs().max()) == 0.0
        assert float(aux[2].detach()) == mask.sum()


def test_moe_group_and_capacity():
    _, tcfg = _mixtral(moe_group_size=512)
    with torch.device("meta"):  # full width: shapes only
        moe = MoEMLP(TransformerConfig.mixtral("8x7b", num_layers=1))
    assert moe.group_size(1024) == 512 and moe.capacity(512) == 160
    assert moe.group_size(1000) == 500 and moe.group_size(1) == 1 and moe.capacity(1) == 1
    assert config_from_spec("builtin:mixtral-8x7b").num_experts == 8
    assert MoEMLP(tcfg).group_size(12) == 12


def test_mixtral_full_pass_and_aux_match_jax(mixtral):
    ids, mask = _prompts(mixtral["tcfg"].vocab_size)
    want = mixtral["jm"].apply({"params": mixtral["params"]}, jnp.asarray(ids),
                               attention_mask=jnp.asarray(mask))
    for impl in ("xla", "pallas"):
        model = mixtral["model"]
        if impl == "pallas":
            model = CausalTransformer(dataclasses.replace(model.config, attention_impl="pallas"))
            model.load_state_dict(mixtral["model"].state_dict())
        with torch.no_grad():
            got = model(torch.tensor(ids), attention_mask=torch.tensor(mask))
        real = mask.astype(bool)
        np.testing.assert_allclose(got["logits"].numpy()[real], np.asarray(want["logits"])[real],
                                   atol=ATOL, rtol=0, err_msg=impl)
        np.testing.assert_allclose(got["router_aux_loss"].numpy(),
                                   np.asarray(want["router_aux_loss"]), rtol=1e-5, err_msg=impl)


def test_mixtral_incremental_decode_matches_jax(mixtral):
    """The same calls on both sides (a prefill of T = P, then T = 1 steps):
    the MoE's groups and capacity follow each call's T."""
    jm, params, model, tcfg = mixtral["jm"], mixtral["params"], mixtral["model"], mixtral["tcfg"]
    ids, mask = _prompts(tcfg.vocab_size, seed=1)
    B = ids.shape[0]
    slot_mask = np.concatenate([mask, np.zeros((B, N), np.int32)], axis=1)
    jcache = jax_make_kv_cache(mixtral["jcfg"], B, P + N)
    tcache = make_kv_cache(tcfg, B, P + N)
    jo = jm.apply({"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(slot_mask),
                  cache=jcache, cache_index=jnp.asarray(0))
    with torch.no_grad():
        to = model(torch.tensor(ids), attention_mask=torch.tensor(slot_mask), cache=tcache,
                   cache_index=0)
    real = mask.astype(bool)
    np.testing.assert_allclose(to["logits"].numpy()[real], np.asarray(jo["logits"])[real],
                               atol=ATOL, rtol=0, err_msg="prefill")
    # padding slots claimed no capacity: the aux counts the real tokens only
    np.testing.assert_allclose(to["router_aux_loss"].numpy(), np.asarray(jo["router_aux_loss"]),
                               rtol=1e-5)
    jcache = jo["cache"]
    rs = np.random.RandomState(2)
    for step in range(N):
        tok = rs.randint(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
        slot_mask[:, P + step] = 1
        jo = jm.apply({"params": params}, jnp.asarray(tok), attention_mask=jnp.asarray(slot_mask),
                      cache=jcache, cache_index=jnp.asarray(P + step))
        jcache = jo["cache"]
        with torch.no_grad():
            to = model(torch.tensor(tok), attention_mask=torch.tensor(slot_mask), cache=tcache,
                       cache_index=P + step)
        np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]), atol=ATOL,
                                   rtol=0, err_msg=f"decode step {step}")


def test_mixtral_hydra_branch_matches_jax(mixtral):
    """``branch_input`` and the frozen ``HydraBranch`` replay of the top MoE
    block against JAX ``forward_branch`` on its ``hydra_ref_params`` tree."""
    params, model, tcfg = mixtral["params"], mixtral["model"], mixtral["tcfg"]
    module = JaxCausalTransformer(mixtral["jcfg"])
    ids, mask = _prompts(tcfg.vocab_size, seed=7)
    span = (2, P - 1)
    want = jax.jit(lambda p, i, m: module.apply({"params": p}, i, attention_mask=m,
                                                branch_layer=1, logits_span=span))(
        params, jnp.asarray(ids), jnp.asarray(mask))
    ref_tree = jax_hydra_ref_params(params, mixtral["jcfg"], 1)
    want_ref = jax.jit(lambda p, h, m: module.apply(
        {"params": p}, h, 1, attention_mask=m, logits_span=span,
        method=JaxCausalTransformer.forward_branch))(ref_tree, want["branch_input"],
                                                     jnp.asarray(mask))
    ref = hydra_ref_params(model, tcfg, 1)
    with torch.no_grad():
        got = model(torch.tensor(ids), attention_mask=torch.tensor(mask), branch_layer=1,
                    logits_span=span)
        got_ref = ref(got["branch_input"], torch.tensor(mask), None, span)
    for key in ("logits", "branch_input", "router_aux_loss"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, rtol=0,
                                   err_msg=key)
    np.testing.assert_allclose(got_ref["logits"].numpy(), np.asarray(want_ref["logits"]),
                               atol=ATOL, rtol=0)
    assert "router_aux_loss" not in got_ref and "router_aux_loss" not in want_ref


def test_mixtral_greedy_generate_and_engine_match_jax(mixtral):
    """Greedy tokens through the serial ``generate`` (dense cache) and the
    paged engine (more prompts than slots, refills in power-of-two
    buckets, 4-slot blocks) against JAX ``generate``."""
    jcfg, params, model, tcfg = mixtral["jcfg"], mixtral["params"], mixtral["model"], \
        mixtral["tcfg"]
    eos, pad = 3, tcfg.vocab_size - 1
    prompts, masks = _prompts(200, B=5, seed=4)
    prompts[~masks.astype(bool)] = pad
    module = JaxCausalTransformer(jcfg)
    jconfig = JaxGenerationConfig(max_new_tokens=N, eos_token_id=eos, pad_token_id=pad,
                                  do_sample=False)
    run = jax.jit(lambda p, i, m: jax_generate(
        lambda pp, x, **kw: module.apply({"params": pp}, x, **kw), p,
        lambda b, s: jax_make_kv_cache(jcfg, b, s), i, m, jax.random.PRNGKey(0), jconfig))
    tokens = np.asarray(run(params, jnp.asarray(prompts), jnp.asarray(masks)).response_tokens)

    config = GenerationConfig(max_new_tokens=N, eos_token_id=eos, pad_token_id=pad,
                              do_sample=False)
    with torch.no_grad():
        serial = generate(model, torch.tensor(prompts), torch.tensor(masks),
                          torch.arange(len(prompts)), config)
    np.testing.assert_array_equal(serial.response_tokens.numpy(), tokens)

    bs, slots = 4, 2
    paged = PagedSpec(bs, 1 + 2 * slots * num_table_blocks(P + N, bs) + 4)
    fns = make_slot_refill_fns(tcfg, slots, P, config, segment_len=3, paged=paged, device="cpu")
    engine = ContinuousEngine(fns, model, pad)
    engine.enqueue_prompts(prompts, masks, np.arange(len(prompts)))
    got = {c.index: c for c in engine.run()}
    assert sorted(got) == list(range(len(prompts)))
    for i, c in got.items():
        np.testing.assert_array_equal(c.tokens, tokens[i], err_msg=f"prompt {i}")


def _texts(n, seed):
    rs = np.random.RandomState(seed)
    return ["".join(chr(c) for c in rs.randint(97, 123, size=rs.randint(4, 12)))
            for _ in range(n)]


def _reward(samples, prompts, outputs):
    return [sum(ch in "aeiou" for ch in o) / max(len(o), 1) for o in outputs]


def _moe_model(**extra):
    return dict(model_path="builtin:mixtral-test", num_layers_unfrozen=-1,
                model_extra_kwargs={"router_aux_coef": 0.02, "router_z_coef": 0.003,
                                    "moe_capacity_factor": 2.0, **extra})


def _rollout_batch(trainer, n):
    trainer.add_prompt_pipeline(PromptPipeline(_texts(n, 1), 16, trainer.tokenizer))
    trainer.make_experience(n)
    trainer._close_prompt_iterator()
    return next(iter(trainer.store.create_loader(n)))


def _trainer_and_batch(kind, tmp_path):
    train = dict(seq_length=24, batch_size=8, checkpoint_dir=str(tmp_path), tracker=None)
    gen = dict(max_new_tokens=8, do_sample=False)
    if kind in ("ppo_xla", "ppo_pallas"):
        config = default_ppo_config().evolve(
            model=_moe_model(), train=train,
            method=dict(num_rollouts=8, chunk_size=8, gen_kwargs=gen,
                        loss_kernel=kind.split("_")[1]))
        trainer = PPOTrainer(config=config, reward_fn=_reward, device="cpu")
        return trainer, _rollout_batch(trainer, 8)
    if kind == "grpo":
        config = default_grpo_config().evolve(
            model=_moe_model(), train=train,
            method=dict(num_rollouts=8, chunk_size=8, group_size=4, gen_kwargs=gen))
        trainer = GRPOTrainer(config=config, reward_fn=_reward, device="cpu")
        return trainer, _rollout_batch(trainer, 8)
    if kind == "sft":
        config = default_sft_config().evolve(model=_moe_model(), train=train)
        trainer = SFTTrainer(config=config, device="cpu")
        trainer.make_experience(_texts(8, 2), 24)
    else:
        config = default_ilql_config().evolve(model=_moe_model(), train=train)
        trainer = ILQLTrainer(config=config, device="cpu")
        trainer.make_experience(_texts(8, 2), list(np.linspace(-1, 1, 8)), 24)
    return trainer, next(iter(trainer.store.create_loader(8)))


@pytest.mark.parametrize("kind", ["ppo_xla", "ppo_pallas", "sft", "ilql", "grpo"])
def test_router_losses_fold_into_every_loss(kind, tmp_path):
    """``with_router_aux``: the logged total is the optimised loss, the
    method's loss plus ``router_aux_coef`` · load balance + ``router_z_coef``
    · z, under JAX's stat names; the coefficients and the capacity factor
    come from ``model.model_extra_kwargs``."""
    trainer, batch = _trainer_and_batch(kind, tmp_path)
    assert (trainer.tcfg.router_aux_coef, trainer.tcfg.router_z_coef,
            trainer.tcfg.moe_capacity_factor) == (0.02, 0.003, 2.0)
    arrays = trainer._device_batch(batch)
    with torch.no_grad():
        loss, stats = trainer.loss_fn(arrays)
        coefs = trainer.tcfg
        trainer.tcfg = dataclasses.replace(coefs, router_aux_coef=0.0, router_z_coef=0.0)
        base, base_stats = trainer.loss_fn(arrays)
        trainer.tcfg = coefs
    total = "losses/total_loss" if "losses/total_loss" in stats else "losses/loss"
    lb, z = stats["losses/router_load_balance"], stats["losses/router_z"]
    assert 0.5 < float(lb) < 4.0 and float(z) > 0
    torch.testing.assert_close(loss, base + 0.02 * lb + 0.003 * z, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(stats[total], loss)
    torch.testing.assert_close(base_stats[total], base)
    assert torch.equal(base_stats["losses/router_z"], z)


MOE_GRPO = {"model": {"model_path": "builtin:mixtral-test"}}


@pytest.fixture(scope="module")
def jax_moe_grpo(tmp_path_factory):
    return _jax_run(tmp_path_factory.mktemp("jax_moe_grpo"), MOE_GRPO)


def test_moe_grpo_matches_jax_trainer(jax_moe_grpo, tmp_path):
    """``tests/test_torch_grpo.py``'s whole slice (the serial path, the
    group baseline scaled) on mixtral-test: the scoring forward, the hydra
    branch replaying both MoE blocks, and the train step's router losses."""
    trainer = _port_run(tmp_path, jax_moe_grpo, MOE_GRPO)
    assert trainer.tcfg.num_experts == 4
    _compare(trainer, jax_moe_grpo)
    steps = [st for _, st in trainer.tracker.history if "gradients/global_norm" in st]
    jsteps = [st for _, st in jax_moe_grpo["history"] if "gradients/global_norm" in st]
    for ours, theirs in zip(steps, jsteps):
        for k in ("losses/router_load_balance", "losses/router_z"):
            np.testing.assert_allclose(ours[k], float(theirs[k]), rtol=1e-5, err_msg=k)


def test_grpo_sentiments_task_runs_the_example(tmp_path, monkeypatch):
    """``tasks/grpo_sentiments.py``: the example's settings, its copies of
    the lexicon scorer and templated prompts (the example's offline
    fallbacks: ``datasets`` made unimportable), and two steps of GRPO on
    mixtral-test through ``main`` at cut sizes."""
    import sys

    monkeypatch.setitem(sys.modules, "datasets", None)
    sys.path.insert(0, "examples")
    try:
        import sentiment_util
    finally:
        sys.path.remove("examples")
    from trlx_tpu_torch.tasks import grpo_sentiments as task

    assert task.review_prompts(64, seed=1) == sentiment_util.review_prompts(64, seed=1)
    texts = task.review_prompts(32, seed=3) + ["great but boring", "nothing"]
    assert task.lexicon_sentiment(texts) == sentiment_util.lexicon_sentiment(texts)
    cfg = task.config()
    assert (cfg.train.seq_length, cfg.train.batch_size, cfg.train.trainer) == (
        128, 32, "GRPOTrainer")
    assert cfg.method.gen_kwargs["max_new_tokens"] == 40 and cfg.method.gen_kwargs["do_sample"]
    assert cfg.model.model_extra_kwargs == {"router_aux_coef": 0.01, "router_z_coef": 0.001}
    trainer = task.main(hparams={"train.total_steps": 2, "train.batch_size": 8,
                                 "train.seq_length": 24, "train.checkpoint_dir": str(tmp_path),
                                 "method.num_rollouts": 16, "method.chunk_size": 16,
                                 "method.gen_kwargs.max_new_tokens": 8}, device="cpu")
    steps = [st for _, st in trainer.tracker.history if "gradients/global_norm" in st]
    assert len(steps) == 2 and all(np.isfinite(st["losses/total_loss"]) for st in steps)
    assert trainer.tcfg.router_z_coef == 0.001 and "losses/router_z" in steps[0]
