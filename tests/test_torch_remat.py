"""Rematerialisation and scanned layers in the port
(``models/transformer.py::run_block``, ``models/seq2seq.py``,
``models/builder.py::assemble_overrides``, ``models/weights.py``) against
the JAX package, on the CPU in f32:

- the loss and every gradient under remat ``none``, ``minimal`` and
  ``full`` are bitwise equal, on the gpt2, llama, mixtral (MoE) and T5
  test presets (the CPU runs the same operators in the same order);
- the port's gradients under ``minimal`` and ``full`` match JAX's under
  the same policy within 1e-5 of the largest gradient (gpt2, llama);
- the memory a training forward leaves allocated for its backward (the
  profiler's allocation records over the forward) falls from ``none`` to
  ``minimal`` to ``full``; T5 under ``minimal`` is no remat, as in JAX;
- a JAX tree built with ``scan_layers`` (a stacked ``h_scan``) gives the
  same logits within 1e-5 through ``params_from_jax``, its hydra
  reference loads onto the top blocks, and ``num_layers_unfrozen``
  freezes the same blocks as JAX's mask of the stacked tree;
- ``assemble_overrides`` builds JAX's overrides from ``model`` and
  ``parallel``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelConfig as JaxModelConfig
from trlx_tpu.data.configs import ParallelConfig as JaxParallelConfig
from trlx_tpu.models.builder import _assemble_overrides as jax_assemble_overrides
from trlx_tpu.models.builder import hydra_ref_params as jax_hydra_ref_params
from trlx_tpu.models.builder import trainable_mask as jax_trainable_mask
from trlx_tpu.models.heads import CausalLMWithValueHead as JaxValueHeadLM
from trlx_tpu.models.transformer import CausalTransformer as JaxCausalTransformer
from trlx_tpu.models.transformer import TransformerConfig as JaxConfig
from trlx_tpu_torch.data.configs import ModelConfig, ParallelConfig
from trlx_tpu_torch.models.builder import (
    assemble_overrides,
    build_causal_lm,
    build_seq2seq_lm,
    hydra_ref_params,
    trainable_mask,
)
from trlx_tpu_torch.models.heads import CausalLMWithValueHead
from trlx_tpu_torch.models.transformer import CausalTransformer, HydraBranch, config_from_spec
from trlx_tpu_torch.models.weights import params_from_jax
from tests.test_torch_transformer import _numpy_params
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

POLICIES = ("none", "minimal", "full")
B, T = 3, 12


def _inputs(vocab, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (B, T))
    mask = np.ones((B, T), np.int64)
    mask[1, :3] = 0  # left padding
    weights = rs.randn(B, T, vocab).astype(np.float32) / vocab
    return ids, mask, weights


def _causal_pass(spec, remat):
    """Loss, gradients and the bytes the forward leaves allocated for a
    value-head policy of ``spec`` under ``remat`` (seeded weights)."""
    model, cfg = build_causal_lm(spec, seed=0, device="cpu", head="value", remat=remat,
                                 dtype=torch.float32)
    model.requires_grad_(True)
    ids, mask, w = _inputs(cfg.vocab_size)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                profile_memory=True) as prof:
        out = model(torch.as_tensor(ids), attention_mask=torch.as_tensor(mask))
    kept = sum(e.self_cpu_memory_usage for e in prof.key_averages())
    loss = (out["logits"] * torch.as_tensor(w)).sum() + out["value"].pow(2).mean()
    if "router_aux_loss" in out:
        loss = loss + out["router_aux_loss"].sum()
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}, kept


def _seq2seq_pass(spec, remat):
    model, cfg = build_seq2seq_lm(spec, seed=0, device="cpu", head="value", remat=remat,
                                  dtype=torch.float32)
    model.requires_grad_(True)
    ids, mask, w = _inputs(cfg.vocab_size)
    dec = torch.as_tensor(ids[:, :8])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                profile_memory=True) as prof:
        out = model(torch.as_tensor(ids), attention_mask=torch.as_tensor(mask),
                    decoder_input_ids=dec, decoder_attention_mask=torch.ones_like(dec))
    kept = sum(e.self_cpu_memory_usage for e in prof.key_averages())
    loss = (out["logits"] * torch.as_tensor(w[:, :8])).sum() + out["value"].pow(2).mean()
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}, kept


@pytest.mark.parametrize("spec", ["builtin:gpt2-test", "builtin:llama-test",
                                  "builtin:mixtral-test", "builtin:flan_t5-test"])
def test_gradients_equal_across_policies(spec):
    run = _seq2seq_pass if "t5" in spec else _causal_pass
    results = {policy: run(spec, policy) for policy in POLICIES}
    loss0, grads0, _ = results["none"]
    for policy in ("minimal", "full"):
        loss, grads, _ = results[policy]
        assert torch.equal(loss, loss0), policy
        assert grads.keys() == grads0.keys()
        for name, g in grads.items():
            assert torch.equal(g, grads0[name]), (policy, name)
    kept = {policy: results[policy][2] for policy in POLICIES}
    if "t5" in spec:
        # T5 takes remat for "full" only: "minimal" is no remat, as in JAX
        assert kept["none"] == kept["minimal"] > kept["full"], kept
    else:
        assert kept["none"] > kept["minimal"] > kept["full"], kept


def _jax_grads(jcfg, params, ids, mask, w):
    module = JaxCausalTransformer(jcfg)

    def loss_fn(p):
        out = module.apply({"params": p}, jnp.asarray(ids, jnp.int32),
                           attention_mask=jnp.asarray(mask, jnp.int32))
        return (out["logits"] * jnp.asarray(w)).sum()

    return jax.jit(jax.value_and_grad(loss_fn))(params)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("remat,scan", [("minimal", False), ("full", True)])
def test_remat_gradients_match_jax(family, remat, scan):
    jcfg = dataclasses.replace(getattr(JaxConfig, family)("test"), dtype=jnp.float32,
                               remat=remat, scan_layers=scan)
    params = jax.tree_util.tree_map(np.asarray, _numpy_params(jcfg, seed=3))
    tcfg = config_from_spec(f"builtin:{family}-test", dtype=torch.float32, remat=remat,
                            scan_layers=scan)
    model = CausalTransformer(tcfg)
    model.load_state_dict(params_from_jax(params, tcfg), strict=True)
    ids, mask, w = _inputs(tcfg.vocab_size, seed=1)
    want_loss, want_grads = _jax_grads(jcfg, params, ids, mask, w)
    out = model(torch.as_tensor(ids), attention_mask=torch.as_tensor(mask))
    loss = (out["logits"] * torch.as_tensor(w)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5, atol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_grads), tcfg)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, want[name], rtol=0, atol=1e-5 * scale, msg=name)


def test_scanned_jax_tree_matches_logits_hydra_and_frozen_set():
    jcfg = dataclasses.replace(JaxConfig.llama("test"), dtype=jnp.float32, scan_layers=True)
    params = jax.tree_util.tree_map(
        np.asarray, _numpy_params(jcfg, seed=5, module_cls=JaxValueHeadLM))
    assert "h_scan" in params["backbone"]
    tcfg = config_from_spec("builtin:llama-test", dtype=torch.float32, scan_layers=True)
    policy = CausalLMWithValueHead(tcfg).eval()
    policy.load_state_dict(params_from_jax(params, tcfg), strict=True)
    ids, mask, _ = _inputs(tcfg.vocab_size, seed=2)
    want = JaxCausalTransformer(jcfg).apply({"params": params["backbone"]},
                                            jnp.asarray(ids, jnp.int32),
                                            attention_mask=jnp.asarray(mask, jnp.int32))
    with torch.no_grad():
        got = policy(torch.as_tensor(ids), attention_mask=torch.as_tensor(mask))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=1e-5)
    # the scanned hydra reference holds the top layers, under their indices
    L = tcfg.num_layers
    ref = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_hydra_ref_params(params, jcfg, 1)), tcfg)
    branch = HydraBranch(tcfg, [L - 1])
    branch.load_state_dict(ref, strict=True)
    port_ref = hydra_ref_params(policy, tcfg, 1).state_dict()
    assert port_ref.keys() == ref.keys()
    for k in ref:
        assert torch.equal(port_ref[k], ref[k]), k
    # num_layers_unfrozen freezes the same blocks as JAX's stacked mask
    for nlu in (-1, 0, 1, L):
        jmask = jax_trainable_mask(params, jcfg, nlu)["backbone"]["h_scan"]["block"]
        leaf = np.asarray(jax.tree_util.tree_leaves(jmask)[0], np.float32)
        jax_layers = {i for i in range(L) if (leaf if leaf.ndim else np.full(L, leaf))[i]}
        mask = trainable_mask(policy, tcfg, nlu)
        port_layers = {int(n.split(".")[2]) for n, on in mask.items()
                       if on and n.startswith("backbone.blocks.")}
        assert port_layers == jax_layers, nlu


def _names(overrides):
    """dtypes by name; JAX's ``pipe_microbatches`` dropped (the port runs
    no pipeline: ``parallel.pipe > 1`` is refused)."""
    def name(v):
        return str(v).split(".")[-1] if isinstance(v, torch.dtype) else np.dtype(v).name

    return {k: (name(v) if "dtype" in k else v) for k, v in overrides.items()
            if k != "pipe_microbatches"}


@pytest.mark.parametrize("extra,peft,parallel,scan_ok", [
    ({}, None, {}, True),
    ({"num_layers": 4}, None, {"remat": "minimal", "compute_dtype": "float32"}, True),
    ({"remat": "full"}, None, {"remat": "minimal", "scan_layers": True}, True),
    ({"scan_layers": True}, {"peft_type": "lora", "r": 4}, {"scan_layers": True}, False),
    ({}, None, {"pipe": 2}, True),
])
def test_assemble_overrides_matches_jax(extra, peft, parallel, scan_ok):
    ours = assemble_overrides(ModelConfig(model_path="builtin:gpt2-test",
                                          model_extra_kwargs=dict(extra), peft_kwargs=peft),
                              ParallelConfig(**parallel), scan_layers_supported=scan_ok)
    theirs = jax_assemble_overrides(
        JaxModelConfig(model_path="builtin:gpt2-test", model_extra_kwargs=dict(extra),
                       peft_kwargs=peft),
        JaxParallelConfig(**parallel), scan_layers_supported=scan_ok)
    assert _names(ours) == _names(theirs)
