"""LoRA in the port (``models/transformer.py::LoRALinear``,
``models/builder.py``'s ``parse_peft_overrides``, ``merge_lora_params`` and
``trainable_mask``, ``model.peft_kwargs`` in the trainers) against the JAX
package, on the CPU.

Inputs are made by numpy from a seed; weights go through
``params_from_jax``, adapters included. Held:

- the projection against JAX's ``LoRADense`` (bias on and off, a non-zero
  ``lora_b``) at 1e-5, and a LoRA model's logits against JAX's
  (``mistral-test``: GQA, gated MLP, untied head);
- ``parse_peft_overrides`` against JAX's, its errors included;
  ``merge_lora_params`` against JAX's (the folded model computes the LoRA
  model's logits);
- the trainable mask against JAX's on a value-head tree (a ``backbone``
  key) at ``num_layers_unfrozen`` −1, 0 and 1; on a bare LM the port
  trains the adapters only (JAX trains every leaf: ``ROADMAP.md`` Queue 3);
- PPO with ``peft_kwargs`` through ``train()`` against JAX's: the last
  store, each step's stats at 1e-5 relative and the weights at 1e-5, the
  base unmoved and the optimizer holding the adapters and the value head
  only;
- DPO with ``peft_kwargs``: only adapters move, the checkpoint carries
  them and a resumed run equals the uninterrupted one.
"""

import dataclasses
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trlx_tpu
import trlx_tpu_torch
from trlx_tpu.data.configs import ModelConfig as JaxModelConfig
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.data.default_configs import default_ppo_config as jax_default_ppo_config
from trlx_tpu.models import builder as jax_builder
from trlx_tpu.models.transformer import LoRADense
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_dpo_config
from trlx_tpu_torch.models import builder
from trlx_tpu_torch.models.builder import build_causal_lm
from trlx_tpu_torch.models.transformer import LoRALinear, _linear
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.utils.checkpoint import load_state

RTOL, ATOL = 1e-5, 1e-5
STAT_ATOL = 1e-6
PEFT = {"peft_type": "lora", "r": 4, "lora_alpha": 8, "modified_modules": "all"}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("bias", [True, False])
def test_lora_linear_matches_lora_dense(bias):
    rs = np.random.RandomState(int(bias))
    x = rs.randn(3, 5, 12).astype(np.float32)
    dense = LoRADense(20, bias, jnp.float32, jnp.float32, fnn.initializers.normal(0.02),
                      fnn.initializers.zeros, 4, 8.0)
    params = dense.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = dict(params, lora_b=jnp.asarray(rs.randn(4, 20).astype(np.float32) * 0.1))
    if bias:
        params["bias"] = jnp.asarray(rs.randn(20).astype(np.float32))
    want = np.asarray(dense.apply({"params": params}, jnp.asarray(x)))
    layer = LoRALinear(12, 20, bias, 4, 8.0, torch.float32)
    sd = {"weight": torch.tensor(np.asarray(params["kernel"]).T),
          "lora_a": torch.tensor(np.asarray(params["lora_a"])),
          "lora_b": torch.tensor(np.asarray(params["lora_b"]))}
    if bias:
        sd["bias"] = torch.tensor(np.asarray(params["bias"]))
    layer.load_state_dict(sd)
    got = _linear(layer, torch.tensor(x), torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=1e-6)


def _lora_models(spec="builtin:mistral-test", targets="all", b_scale=0.05):
    """The JAX and the port's LM with adapters, the port's weights from the
    JAX tree with every ``lora_b`` drawn non-zero."""
    peft = dict(PEFT, modified_modules=targets)
    mc = JaxModelConfig(spec, peft_kwargs=peft,
                        model_extra_kwargs=dict(dtype=jnp.float32, param_dtype=jnp.float32))
    module, params, tcfg = jax_builder.build_causal_lm(mc)
    rs = np.random.RandomState(7)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (rs.randn(*x.shape).astype(np.float32) * b_scale
                         if str(getattr(path[-1], "key", "")) == "lora_b" else np.asarray(x)),
        params)
    model, cfg = build_causal_lm(spec, device="cpu", dtype=torch.float32,
                                 **builder.parse_peft_overrides(peft))
    model.load_state_dict(params_from_jax(params, cfg))
    return module, params, tcfg, model, cfg


def test_lora_model_logits_match_jax_and_merge_matches_jax():
    module, params, tcfg, model, cfg = _lora_models()
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 250, (3, 11)).astype(np.int32)
    mask = np.ones((3, 11), np.int32)
    mask[1, :4] = 0
    want = np.asarray(module.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                                   jnp.asarray(ids), attention_mask=jnp.asarray(mask))["logits"])
    with torch.no_grad():
        got = model(torch.as_tensor(ids), attention_mask=torch.as_tensor(mask))["logits"]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-5)
    assert sum(isinstance(m, LoRALinear) for m in model.modules()) == 7 * cfg.num_layers
    # merged: JAX's fold of the same tree, and the folded model's logits
    merged_cfg = dataclasses.replace(cfg, lora_r=0)
    jmerged = params_from_jax(_np_tree(jax_builder.merge_lora_params(params, tcfg)),
                              merged_cfg)
    merged = builder.merge_lora_params(model.state_dict(), cfg)
    assert set(merged) == set(jmerged) and not any("lora" in k for k in merged)
    for k, v in jmerged.items():
        np.testing.assert_allclose(merged[k].numpy(), v.numpy(), rtol=RTOL, atol=1e-6,
                                   err_msg=k)
    plain, _ = build_causal_lm("builtin:mistral-test", device="cpu", dtype=torch.float32)
    plain.load_state_dict(merged)
    with torch.no_grad():
        folded = plain(torch.as_tensor(ids), attention_mask=torch.as_tensor(mask))["logits"]
    np.testing.assert_allclose(folded.numpy(), got.numpy(), rtol=RTOL, atol=1e-5)
    assert builder.merge_lora_params(merged, merged_cfg) is merged


@pytest.mark.parametrize("kw", [
    {},
    {"peft_type": "lora", "r": 4, "lora_alpha": 8, "modified_modules": "attention"},
    {"delta_type": "LoRA", "modified_modules": ["q_proj", "v_proj"]},
    {"lora_r": 2, "modified_modules": "mlp"},
    {"peft_type": "prefix"},
    {"modified_modules": "qkv"},
    {"r": 8, "lora_dropout": 0.1},
])
def test_parse_peft_overrides_matches_jax(kw):
    try:
        want = jax_builder.parse_peft_overrides(kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            builder.parse_peft_overrides(kw)
        assert str(got.value) == str(e)
        return
    assert builder.parse_peft_overrides(kw) == want


def _mask_names(jax_mask, cfg):
    """JAX's mask tree on the port's parameter names (1.0 = trains)."""
    return {k: bool(v) for k, v in params_from_jax(jax_mask, cfg).items()}


@pytest.mark.parametrize("unfrozen", [-1, 0, 1])
def test_trainable_mask_matches_jax_on_a_value_head_tree(unfrozen):
    mc = JaxModelConfig("builtin:gpt2-test", peft_kwargs=PEFT)
    _, params, tcfg = jax_builder.build_causal_lm(mc, head="value")
    want = _mask_names(jax_builder.trainable_mask(params, tcfg, unfrozen), _cfg(PEFT))
    model, cfg = build_causal_lm("builtin:gpt2-test", device="cpu", head="value",
                                 **builder.parse_peft_overrides(PEFT))
    got = builder.trainable_mask(model, cfg, unfrozen)
    assert got == want
    trains = {k for k, v in got.items() if v}
    assert all(".lora_" in k or k.startswith("v_head.") for k in trains)
    assert any(".lora_" in k for k in trains) == (unfrozen != 0)


def _cfg(peft):
    from trlx_tpu_torch.models.transformer import config_from_spec

    return config_from_spec("builtin:gpt2-test", **builder.parse_peft_overrides(peft))


def test_headless_mask_trains_the_adapters_only():
    _, params, tcfg = jax_builder.build_causal_lm(
        JaxModelConfig("builtin:gpt2-test", peft_kwargs=PEFT))
    jmask = jax_builder.trainable_mask(params, tcfg, -1)
    # JAX: no backbone key, so every leaf trains (ROADMAP.md Queue 3)
    assert all(jax.tree_util.tree_leaves(jmask))
    model, cfg = build_causal_lm("builtin:gpt2-test", device="cpu",
                                 **builder.parse_peft_overrides(PEFT))
    got = builder.trainable_mask(model, cfg, -1)
    assert {k for k, v in got.items() if v} == {k for k in got if ".lora_" in k}


# ---------------------------------------------------------------------------
# PPO with LoRA through train()
# ---------------------------------------------------------------------------

PPO_STEPS = 3  # 16 rollouts, batch 8, 1 PPO epoch: 2 steps a collection


def _ppo_config_dict(tmp):
    d = jax_default_ppo_config().to_dict()
    d["model"].update(model_path="builtin:gpt2-test", num_layers_unfrozen=1, peft_kwargs=PEFT)
    d["parallel"].update(compute_dtype="float32")
    d["optimizer"]["kwargs"].update(lr=1e-3)
    d["scheduler"]["kwargs"].update(lr=1e-3, eta_min=1e-3)
    d["train"].update(seq_length=24, batch_size=8, total_steps=PPO_STEPS,
                      checkpoint_dir=str(tmp))
    d["method"].update(num_rollouts=16, chunk_size=16, ppo_epochs=1)
    d["method"]["gen_kwargs"].update(max_new_tokens=8, do_sample=False)
    return d


def _prompts(n=40, seed=0):
    rs = np.random.RandomState(seed)
    return ["".join(chr(c) for c in rs.randint(97, 123, size=rs.randint(3, 15)))
            for _ in range(n)]


def vowel_reward(samples, prompts, outputs):
    return [sum(ch in "aeiou" for ch in o) / max(len(o), 1) for o in outputs]


class _Recorder:
    def __init__(self):
        self.history = []

    def log(self, stats, step):
        self.history.append((int(step), dict(stats)))

    def finish(self):
        pass


def _store(trainer):
    return [(e.query_tensor, e.response_tensor, e.logprobs, e.values, e.rewards)
            for e in trainer.store.history]


@pytest.fixture(scope="module")
def jax_ppo_lora(tmp_path_factory):
    out = {}

    def hook(trainer):
        out["params0"] = _np_tree(trainer.state.params)
        trainer.tracker = _Recorder()

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRLX_TPU_MFU", "0")
        trainer = trlx_tpu.train(reward_fn=vowel_reward, prompts=_prompts(),
                                 config=JaxTRLConfig.from_dict(
                                     _ppo_config_dict(tmp_path_factory.mktemp("jax_lora"))),
                                 init_trainer_hook=hook)
    out.update(history=trainer.tracker.history, store=_store(trainer),
               params=_np_tree(trainer.state.params))
    return out


def test_ppo_with_lora_matches_jax_trainer(jax_ppo_lora, tmp_path):
    def hook(trainer):
        trainer.model.load_state_dict(params_from_jax(jax_ppo_lora["params0"], trainer.tcfg))
        trainer.ref_params = trainer._ref_snapshot()

    trainer = trlx_tpu_torch.train(reward_fn=vowel_reward, prompts=_prompts(),
                                   config=TRLConfig.from_dict(_ppo_config_dict(tmp_path)),
                                   init_trainer_hook=hook, device="cpu")
    assert trainer.tcfg.lora_r == 4
    # the optimizer holds the adapters of the top block and the value head
    held = {id(p) for g in trainer.optimizer.param_groups for p in g["params"]}
    names = {n for n, p in trainer.model.named_parameters() if id(p) in held}
    assert names == {n for n in trainer.param_mask if trainer.param_mask[n]}
    assert all(n.startswith("backbone.blocks.1.") and ".lora_" in n or n.startswith("v_head.")
               for n in names)
    ours, theirs = _store(trainer), jax_ppo_lora["store"]
    assert len(ours) == len(theirs) == 16
    for i, (a, b) in enumerate(zip(ours, theirs)):
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"query {i}")
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"response {i}")
        for j in (2, 3, 4):
            np.testing.assert_allclose(np.asarray(a[j], np.float32), np.asarray(b[j], np.float32),
                                       atol=ATOL, rtol=0, err_msg=f"{i} {j}")
    steps = [st for _, st in trainer.tracker.history if "gradients/global_norm" in st]
    jsteps = [st for _, st in jax_ppo_lora["history"] if "gradients/global_norm" in st]
    assert len(steps) == len(jsteps) == PPO_STEPS
    for i, (st_o, st_t) in enumerate(zip(steps, jsteps)):
        keys = [k for k in st_t if k.startswith(("losses/", "policy/", "values/", "returns/"))
                or k in ("learning_rate", "gradients/global_norm")]
        assert len(keys) >= 10
        for k in keys:
            np.testing.assert_allclose(st_o[k], float(st_t[k]), rtol=RTOL, atol=STAT_ATOL,
                                       err_msg=f"step {i} {k}")
    final = params_from_jax(jax_ppo_lora["params"], trainer.tcfg)
    start = params_from_jax(jax_ppo_lora["params0"], trainer.tcfg)
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=ATOL, rtol=0, err_msg=k)
        if not trainer.param_mask[k]:
            assert torch.equal(v, start[k]), k  # the base never moves
    lora_b = trainer.model.backbone.blocks[1].attn.q_proj.lora_b
    assert float(lora_b.detach().abs().max()) > 1e-3


def _dpo_lora_config(tmp, **train):
    d = default_dpo_config().to_dict()
    d["model"].update(model_path="builtin:gpt2-test", peft_kwargs=PEFT)
    d["parallel"].update(compute_dtype="float32")
    d["optimizer"]["kwargs"].update(lr=1e-3)
    d["scheduler"]["kwargs"].update(lr=1e-3, eta_min=1e-3)
    d["train"].update(seq_length=32, batch_size=8, total_steps=3, checkpoint_interval=1,
                      checkpoint_dir=str(tmp), **train)
    d["method"]["gen_kwargs"].update(max_new_tokens=4)
    return TRLConfig.from_dict(d)


def _triples(n=16, seed=0):
    rs = np.random.RandomState(seed)
    w = lambda lo, hi: "".join(chr(c) for c in rs.randint(97, 123, size=rs.randint(lo, hi)))  # noqa: E731
    return [(w(2, 10), " " + w(1, 16), " " + w(1, 16)) for _ in range(n)]


def test_dpo_with_lora_moves_the_adapters_only_and_resumes(tmp_path):
    start = {}

    def hook(trainer):
        start.update({k: v.clone() for k, v in trainer.model.state_dict().items()})

    full = trlx_tpu_torch.train(samples=_triples(), eval_prompts=["ab"], device="cpu",
                                config=_dpo_lora_config(tmp_path / "full"), init_trainer_hook=hook)
    steps = [st for _, st in full.tracker.history if "gradients/global_norm" in st]
    np.testing.assert_allclose(steps[0]["losses/total_loss"], np.log(2.0), rtol=1e-6)
    moved = 0.0
    for k, v in full.model.state_dict().items():
        if ".lora_" in k:
            moved = max(moved, float((v - start[k]).abs().max()))
        else:
            assert torch.equal(v, start[k]), k
    assert moved > 1e-3
    state = load_state(str(tmp_path / "full" / "checkpoint_1"))
    assert any(".lora_b" in k for k in state["model"])
    n_adapters = sum(".lora_" in k for k in full.model.state_dict())
    assert len(state["optimizer"]["state"]) == n_adapters
    shutil.copytree(tmp_path / "full" / "checkpoint_1", tmp_path / "resumed" / "checkpoint_1")
    resumed = trlx_tpu_torch.train(
        samples=_triples(), eval_prompts=["ab"], device="cpu",
        config=_dpo_lora_config(tmp_path / "resumed", resume_from_checkpoint=True))
    for k, v in full.model.state_dict().items():
        gap = float((resumed.model.state_dict()[k] - v).abs().max())
        assert gap <= 1e-3 * moved, k
