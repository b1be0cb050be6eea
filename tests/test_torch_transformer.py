"""The port's GPT-2 transformer (``trlx_tpu_torch/models``) against the JAX
``CausalTransformer``: weights carried over with ``params_from_jax``, the
same numpy inputs on both sides, logits compared in f32 at ``atol=1e-4``
— full passes over left-padded prompts (bias and flash branches),
dense-cache prefill and decode steps (a dense-cache prefill also through
the flash branch, at f32 1e-5), per-row multi-position spans (the
speculative verify's shape) through the dense and the paged branches, the
paged (block-table) branch, and the value-head policy with its hydra
branch (``branch_input``, ``forward_branch`` and the frozen
``HydraBranch`` copy)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelConfig
from trlx_tpu.models.builder import build_causal_lm as jax_build
from trlx_tpu.models.builder import hydra_ref_params as jax_hydra_ref_params
from trlx_tpu.models.heads import CausalLMWithValueHead as JaxValueHeadLM
from trlx_tpu.models.transformer import CausalTransformer as JaxCausalTransformer
from trlx_tpu.models.transformer import TransformerConfig as JaxConfig
from trlx_tpu.models.transformer import make_kv_cache as jax_make_kv_cache
from trlx_tpu.models.transformer import stack_layer_params
from trlx_tpu_torch.models.builder import build_causal_lm, hydra_ref_params, trainable_mask
from trlx_tpu_torch.models.heads import CausalLMWithILQLHeads, CausalLMWithValueHead
from trlx_tpu_torch.models.transformer import (
    CausalTransformer,
    TransformerConfig,
    config_from_spec,
    make_kv_cache,
)
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.ops.paged_kv import attach_block_table, detach_block_table
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

ATOL = 1e-4

# gpt2-test, and a 2-layer 128-wide GPT-2 with a vocab that is not a
# multiple of anything convenient
_WIDE = dict(vocab_size=301, hidden_size=128, num_layers=2, num_heads=4,
             intermediate_size=512, max_position_embeddings=64)


def _numpy_params(cfg, seed, module_cls=JaxCausalTransformer):
    """A random parameter tree in the JAX module's structure, made with
    numpy: normal(0.02) weights, non-zero biases, norm scales near 1."""
    shapes = jax.eval_shape(lambda: module_cls(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    rs = np.random.RandomState(seed)

    def make(path, leaf):
        name = path[-1].key
        x = rs.randn(*leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * x if name == "scale" else 0.02 * x

    return jax.tree_util.tree_map_with_path(make, shapes)


def _jax_model(spec):
    cfg = JaxConfig.gpt2("test", **({} if spec == "gpt2-test" else _WIDE))
    torch_cfg = TransformerConfig.gpt2(
        "test", dtype=torch.float32, **({} if spec == "gpt2-test" else _WIDE))
    cfg32 = dataclasses.replace(cfg, dtype=jnp.float32)
    params = _numpy_params(cfg32, seed=len(spec))
    return _Jitted(JaxCausalTransformer(cfg32)), params, cfg32, torch_cfg


class _Jitted:
    """``module.apply`` under one ``jax.jit`` (an eager flax forward
    compiles every op on its own, which is many times slower here)."""

    def __init__(self, module):
        self._fn = jax.jit(module.apply, static_argnames=("logits_span",))

    def apply(self, variables, ids, **kw):
        return self._fn(variables, ids, **kw)


@pytest.fixture(scope="module", params=["gpt2-test", "wide"])
def pair(request):
    jm, params, jcfg, tcfg = _jax_model(request.param)
    model = CausalTransformer(tcfg)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    model.eval()
    return jm, params, jcfg, model, tcfg


def _prompts(V, B=3, P=10, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, V, (B, P)).astype(np.int32)
    mask = np.ones_like(ids)
    for b in range(B):  # left padding of 0, 3, 1 columns
        mask[b, : (0, 3, 1)[b % 3]] = 0
    return ids, mask


def test_full_pass_left_padded(pair):
    jm, params, _, model, tcfg = pair
    ids, mask = _prompts(tcfg.vocab_size)
    want = jm.apply({"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.tensor(ids), attention_mask=torch.tensor(mask))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["hidden_states"].numpy(),
                               np.asarray(want["hidden_states"]), atol=ATOL, rtol=0)


def test_dense_cache_prefill_and_decode_steps(pair):
    jm, params, jcfg, model, tcfg = pair
    ids, mask = _prompts(tcfg.vocab_size, seed=1)
    B, P = ids.shape
    N = 2
    slot_mask = np.concatenate([mask, np.zeros((B, N), np.int32)], axis=1)
    jcache = jax_make_kv_cache(jcfg, B, P + N)
    tcache = make_kv_cache(tcfg, B, P + N)
    jo = jm.apply({"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(slot_mask),
                  cache=jcache, cache_index=jnp.asarray(0), logits_span=(P - 1, P))
    with torch.no_grad():
        to = model(torch.tensor(ids), attention_mask=torch.tensor(slot_mask), cache=tcache,
                   cache_index=0, logits_span=(P - 1, P))
    np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]), atol=ATOL, rtol=0)
    jcache = jo["cache"]
    rs = np.random.RandomState(2)
    for step in range(N):
        tok = rs.randint(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
        slot_mask[:, P + step] = 1
        pos = (mask.sum(1) + step)[:, None]
        jo = jm.apply({"params": params}, jnp.asarray(tok), attention_mask=jnp.asarray(slot_mask),
                      positions=jnp.asarray(pos), cache=jcache, cache_index=jnp.asarray(P + step))
        jcache = jo["cache"]
        with torch.no_grad():
            to = model(torch.tensor(tok), attention_mask=torch.tensor(slot_mask),
                       positions=torch.tensor(pos), cache=tcache, cache_index=P + step)
        np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]),
                                   atol=ATOL, rtol=0, err_msg=f"decode step {step}")


@pytest.mark.parametrize("cache_index", [0, 5])
def test_dense_cache_prefill_runs_the_flash_branch(pair, cache_index, monkeypatch):
    """The JAX ``use_flash`` rule: a multi-token pass over a dense cache at
    a scalar ``cache_index`` runs the flash branch (``attention_impl:
    pallas``, its plain version on CPU tensors) with its queries at slots
    ``[ci, ci + T)`` over the whole S-wide cache, and matches the JAX
    dense-cache forward at f32 1e-5; single-token steps and per-row
    indices keep the bias path."""
    import trlx_tpu_torch.ops.flash_attention as fa

    jm, params, jcfg, model, tcfg = pair
    flash = CausalTransformer(dataclasses.replace(tcfg, attention_impl="pallas")).eval()
    flash.load_state_dict(model.state_dict())
    offsets, real_flash = [], fa.flash_attention

    def spy(*args, **kw):
        offsets.append(kw["q_offset"])
        return real_flash(*args, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    ids, mask = _prompts(tcfg.vocab_size, seed=7)
    B, P = ids.shape
    S = P + 4
    slot_mask = np.concatenate([mask, np.zeros((B, S - P), np.int32)], axis=1)
    jcache, tcache = jax_make_kv_cache(jcfg, B, S), make_kv_cache(tcfg, B, S)
    spans = [(0, cache_index), (cache_index, P)] if cache_index else [(0, P)]
    for lo, hi in spans:
        jo = jm.apply({"params": params}, jnp.asarray(ids[:, lo:hi]),
                      attention_mask=jnp.asarray(slot_mask), cache=jcache,
                      cache_index=jnp.asarray(lo))
        jcache = jo["cache"]
        with torch.no_grad():
            to = flash(torch.tensor(ids[:, lo:hi]), attention_mask=torch.tensor(slot_mask),
                       cache=tcache, cache_index=lo)
        real = mask[:, lo:hi].astype(bool)  # pad queries see no key: out 0 vs uniform
        np.testing.assert_allclose(to["logits"].numpy()[real], np.asarray(jo["logits"])[real],
                                   atol=1e-5, rtol=0, err_msg=f"span [{lo}, {hi})")
    assert offsets == [lo for lo, _ in spans for _ in range(tcfg.num_layers)]
    # the cache the flash passes wrote is the JAX cache (real columns)
    np.testing.assert_allclose(tcache[-1]["k"][:, :P].numpy()[mask.astype(bool)],
                               np.asarray(jcache[-1]["k"])[:, :P][mask.astype(bool)], atol=1e-5)
    slot_mask[:, P] = 1
    with torch.no_grad():
        flash(torch.tensor(ids[:, :1]), attention_mask=torch.tensor(slot_mask), cache=tcache,
              cache_index=P)
        flash(torch.tensor(ids[:, :2]), attention_mask=torch.tensor(slot_mask), cache=tcache,
              cache_index=torch.full((B,), P - 1))
    assert len(offsets) == len(spans) * tcfg.num_layers


def _verify_step_inputs(ids, mask, T, n_out, seed):
    """A verify-shaped step after a prompt prefill: per-row first columns
    ``ci = P + n_out - 1`` and the slot mask of the committed columns plus
    each row's ``T - 1`` probe columns."""
    B, P = ids.shape
    ci = P + np.asarray(n_out) - 1
    S = P + max(n_out) + T
    rs = np.random.RandomState(seed)
    slot_mask = np.zeros((B, S), np.int32)
    slot_mask[:, :P] = mask
    for b in range(B):
        slot_mask[b, P: ci[b] + T] = 1
    tok = rs.randint(0, 250, (B, T)).astype(np.int32)
    return tok, ci, slot_mask, S


@pytest.mark.parametrize("block_size", [3, 4])
def test_per_row_multi_position_spans_match_jax(pair, block_size):
    """The speculative verify's forward: ``T`` tokens per row at a ``[B]``
    ``cache_index`` (rows at different depths, windows across block edges),
    through the dense branch's per-row windows and through the paged
    branch (``PagedWrite`` + ``paged_verify_attention``, whose plain
    version runs here), against the JAX dense forward."""
    jm, params, jcfg, model, tcfg = pair
    ids, mask = _prompts(tcfg.vocab_size, seed=8)
    B, P = ids.shape
    T, n_out = 3, [1, 4, 2]
    tok, ci, slot_mask, S = _verify_step_inputs(ids, mask, T, n_out, seed=9)
    prefill_mask = np.concatenate([mask, np.zeros((B, S - P), np.int32)], axis=1)
    jo = jm.apply({"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(prefill_mask),
                  cache=jax_make_kv_cache(jcfg, B, S), cache_index=jnp.asarray(0))
    # the committed columns between the prompt and each window
    fill = np.random.RandomState(10).randint(0, 250, (B, S - P)).astype(np.int32)
    jcache = jo["cache"]
    for k in range(max(n_out) - 1):
        sm = slot_mask.copy()
        sm[:, P + k + 1:] = 0
        sm[:, P + k] = 1
        jcache = jm.apply({"params": params}, jnp.asarray(fill[:, k:k + 1]),
                          attention_mask=jnp.asarray(sm), cache=jcache,
                          cache_index=jnp.asarray(P + k))["cache"]
    want = jm.apply({"params": params}, jnp.asarray(tok), attention_mask=jnp.asarray(slot_mask),
                    cache=jcache, cache_index=jnp.asarray(ci))

    TB = -(-S // block_size)
    NB = 1 + B * TB
    pool = make_kv_cache(tcfg, NB, block_size)
    for layer in pool:  # stale values everywhere: masking must hide them
        layer["k"].normal_()
        layer["v"].normal_()
    table = torch.tensor(np.random.RandomState(11).permutation(np.arange(1, NB))
                         .reshape(B, TB), dtype=torch.int32)
    dense = make_kv_cache(tcfg, B, S)
    with torch.no_grad():
        for cache in (dense, attach_block_table(pool, table)):
            model(torch.tensor(ids), attention_mask=torch.tensor(prefill_mask), cache=cache,
                  cache_index=0)
            for k in range(max(n_out) - 1):
                sm = slot_mask.copy()
                sm[:, P + k + 1:] = 0
                sm[:, P + k] = 1
                model(torch.tensor(fill[:, k:k + 1]), attention_mask=torch.tensor(sm),
                      cache=cache, cache_index=P + k)
        got_dense = model(torch.tensor(tok), attention_mask=torch.tensor(slot_mask),
                          cache=dense, cache_index=torch.tensor(ci))
        got_paged = model(torch.tensor(tok), attention_mask=torch.tensor(slot_mask),
                          cache=attach_block_table(pool, table), cache_index=torch.tensor(ci))
    for got in (got_dense, got_paged):
        np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                                   atol=ATOL, rtol=0)
    # each row's window landed at its own columns, in both caches
    for b in range(B):
        cols = slice(ci[b], ci[b] + T)
        np.testing.assert_allclose(dense[0]["k"][b, cols].numpy(),
                                   np.asarray(want["cache"][0]["k"])[b, cols], atol=ATOL)
        blocks = table[b].long()[torch.arange(ci[b], ci[b] + T) // block_size]
        paged_k = pool[0]["k"][blocks, torch.arange(ci[b], ci[b] + T) % block_size]
        np.testing.assert_allclose(paged_k.numpy(),
                                   np.asarray(want["cache"][0]["k"])[b, cols], atol=ATOL)


@pytest.mark.parametrize("block_size", [1, 3, 4])
def test_paged_branch_matches_jax_dense(pair, block_size):
    """Prefill through the paged branch (block tables with poisoned padding
    rows), then per-row decode steps at a [B] cache index, against the JAX
    dense-cache forward."""
    jm, params, jcfg, model, tcfg = pair
    ids, mask = _prompts(tcfg.vocab_size, seed=4)
    B, P = ids.shape
    N = 2
    S = P + N
    TB = -(-S // block_size)
    NB = 1 + (B + 1) * TB
    pool = make_kv_cache(tcfg, NB, block_size)
    for layer in pool:  # stale values everywhere: masking must hide them
        layer["k"].normal_()
        layer["v"].normal_()
    perm = np.random.RandomState(5).permutation(np.arange(1, NB))[: B * TB]
    table = torch.tensor(perm.reshape(B, TB), dtype=torch.int32)
    pad_row = torch.full((1, TB), NB, dtype=torch.int32)  # a bucket-padding row
    slot_mask = np.concatenate([mask, np.zeros((B, N), np.int32)], axis=1)
    jo = jm.apply({"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(slot_mask),
                  cache=jax_make_kv_cache(jcfg, B, S), cache_index=jnp.asarray(0))
    ids_pad = np.concatenate([ids, np.zeros((1, P), np.int32)])
    sm_pad = np.concatenate([slot_mask, np.zeros((1, S), np.int32)])
    with torch.no_grad():
        to = model(torch.tensor(ids_pad), attention_mask=torch.tensor(sm_pad),
                   cache=attach_block_table(pool, torch.cat([table, pad_row])), cache_index=0)
    # left-pad query positions see no key at all (uniform softmax over the
    # whole row, stale pool values included): only real positions count
    real = mask.astype(bool)
    np.testing.assert_allclose(to["logits"][:B].numpy()[real], np.asarray(jo["logits"])[real],
                               atol=ATOL, rtol=0)
    # the pool was updated in place: the returned cache is the same pool
    bare = detach_block_table(to["cache"])
    assert all("block_table" not in c and c["k"] is p["k"] for c, p in zip(bare, pool))
    jcache = jo["cache"]
    for step in range(N):
        tok = np.full((B, 1), 7 + step, np.int32)
        slot_mask[:, P + step] = 1
        pos = (mask.sum(1) + step)[:, None]
        jo = jm.apply({"params": params}, jnp.asarray(tok), attention_mask=jnp.asarray(slot_mask),
                      positions=jnp.asarray(pos), cache=jcache, cache_index=jnp.asarray(P + step))
        jcache = jo["cache"]
        with torch.no_grad():
            to = model(torch.tensor(tok), attention_mask=torch.tensor(slot_mask),
                       positions=torch.tensor(pos), cache=attach_block_table(pool, table),
                       cache_index=torch.full((B,), P + step))
        np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]),
                                   atol=ATOL, rtol=0, err_msg=f"paged decode step {step}")


def test_scanned_params_convert_like_unscanned():
    jcfg = JaxConfig.gpt2("test")
    params = _numpy_params(jcfg, seed=1)
    tcfg = TransformerConfig.gpt2("test")
    flat = params_from_jax(params, tcfg)
    stacked = stack_layer_params(params, jcfg.num_layers)
    scanned = params_from_jax(jax.tree_util.tree_map(np.asarray, stacked), tcfg)
    assert flat.keys() == scanned.keys()
    for k in flat:
        torch.testing.assert_close(flat[k], scanned[k], atol=0, rtol=0)
    # flax kernels are [in, out]; torch Linear weights are [out, in]
    np.testing.assert_array_equal(
        flat["blocks.0.mlp.up_proj.weight"].numpy(),
        np.asarray(params["h_0"]["mlp"]["up_proj"]["kernel"]).T)
    assert "lm_head.weight" not in flat  # tied to wte


def test_jax_builder_tree_converts():
    """The tree structure the JAX builder produces loads into the port
    (strict: every key present, every shape right)."""
    _, shapes, _ = jax_build(ModelConfig(model_path="builtin:gpt2-test"), abstract=True)
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model = CausalTransformer(TransformerConfig.gpt2("test"))
    model.load_state_dict(params_from_jax(params, model.config), strict=True)


def test_builder_is_seeded_and_validates():
    a, cfg = build_causal_lm("builtin:gpt2-test", seed=3, device="cpu")
    b, _ = build_causal_lm("builtin:gpt2-test", seed=3, device="cpu")
    c, _ = build_causal_lm("builtin:gpt2-test", seed=4, device="cpu")
    assert cfg.dtype == torch.bfloat16 and a.wte.weight.dtype == torch.float32
    assert torch.equal(a.wte.weight, b.wte.weight)
    assert not torch.equal(a.wte.weight, c.wte.weight)
    assert float(a.blocks[0].ln_attn.weight.min()) == 1.0
    assert float(a.blocks[0].attn.q_proj.bias.abs().max()) == 0.0
    assert config_from_spec("builtin:gpt2-small").hidden_size == 768
    assert config_from_spec("builtin:mixtral-test").num_experts == 4
    with pytest.raises(ValueError, match="unknown model family"):
        config_from_spec("builtin:t5-test")
    with pytest.raises(ValueError, match="norm='batchnorm'"):
        TransformerConfig.gpt2("test", norm="batchnorm")
    with pytest.raises(ValueError, match="value-head policy"):
        build_causal_lm("builtin:gpt2-test", device="cpu", head="reward")
    policy, _ = build_causal_lm("builtin:gpt2-test", seed=3, device="cpu", head="value")
    assert isinstance(policy, CausalLMWithValueHead)
    assert torch.equal(policy.backbone.wte.weight, a.wte.weight)
    ilql, _ = build_causal_lm("builtin:gpt2-test", seed=3, device="cpu", head="ilql")
    assert isinstance(ilql, CausalLMWithILQLHeads)
    assert torch.equal(ilql.backbone.wte.weight, a.wte.weight)


def test_flash_branch_matches_jax_logits(pair):
    """``attention_impl: pallas`` sends full passes through the flash
    wrappers (their plain versions on the CPU): JAX's logits still."""
    jm, params, _, model, tcfg = pair
    flash = CausalTransformer(dataclasses.replace(tcfg, attention_impl="pallas"))
    flash.load_state_dict(model.state_dict())
    ids, mask = _prompts(tcfg.vocab_size, seed=6)
    want = jm.apply({"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = flash(torch.tensor(ids), attention_mask=torch.tensor(mask))
    real = mask.astype(bool)  # pad queries see no key: out 0 vs a uniform row
    np.testing.assert_allclose(got["logits"].numpy()[real], np.asarray(want["logits"])[real],
                               atol=ATOL, rtol=0)
    assert tcfg.resolved_attention_impl(torch.device("cpu")) == "xla"
    assert flash.config.resolved_attention_impl(torch.device("cpu")) == "pallas"
    with pytest.raises(ValueError, match="attention_impl"):
        TransformerConfig.gpt2("test", attention_impl="mosaic")


def test_attention_impl_on_cuda_tensors_is_the_flash_branch():
    """Full passes on CUDA tensors run the flash kernels: ``auto`` and
    ``pallas`` resolve to them there, and ``xla`` (the bias path, kept for
    CPU tensors) raises instead of sending card tensors to it."""
    cuda = torch.device("cuda")
    for impl in ("auto", "pallas"):
        assert TransformerConfig.gpt2("test", attention_impl=impl).resolved_attention_impl(
            cuda) == "pallas"
    xla = TransformerConfig.gpt2("test", attention_impl="xla")
    assert xla.resolved_attention_impl(torch.device("cpu")) == "xla"
    with pytest.raises(ValueError, match="attention_impl='xla'"):
        xla.resolved_attention_impl(cuda)


@pytest.mark.parametrize("attention_impl", ["xla", "pallas"])
def test_value_head_and_hydra_branch_match_jax(attention_impl):
    jcfg = dataclasses.replace(JaxConfig.gpt2("test"), dtype=jnp.float32)
    params = _numpy_params(jcfg, seed=9, module_cls=JaxValueHeadLM)
    module = JaxValueHeadLM(jcfg)
    tcfg = TransformerConfig.gpt2("test", dtype=torch.float32, attention_impl=attention_impl)
    policy = CausalLMWithValueHead(tcfg)
    policy.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    ids, mask = _prompts(tcfg.vocab_size, seed=7)
    P = ids.shape[1]
    span = (2, P - 1)
    fwd = jax.jit(lambda p, i, m: module.apply({"params": p}, i, attention_mask=m,
                                               branch_layer=1, logits_span=span))
    want = fwd(params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = policy(torch.tensor(ids), attention_mask=torch.tensor(mask), branch_layer=1,
                     logits_span=span)
    real = mask.astype(bool)
    np.testing.assert_allclose(got["value"].numpy()[real], np.asarray(want["value"])[real],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["logits"].numpy()[real[:, 2:P - 1]],
                               np.asarray(want["logits"])[real[:, 2:P - 1]], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["branch_input"].numpy()[real],
                               np.asarray(want["branch_input"])[real], atol=ATOL, rtol=0)
    # the hydra branch replayed with frozen reference weights: the JAX
    # subtree through params_from_jax, and the port's own snapshot
    ref_tree = jax.tree_util.tree_map(np.asarray, jax_hydra_ref_params(params, jcfg, 1))
    branch = jax.jit(lambda r, h, m: module.apply(
        {"params": {"backbone": r}}, h, 1, m, None, span,
        method=JaxValueHeadLM.forward_branch))
    want_ref = branch(ref_tree, want["branch_input"], jnp.asarray(mask))
    snapshot = hydra_ref_params(policy, tcfg, 1)
    assert snapshot.state_dict().keys() == params_from_jax(ref_tree, tcfg).keys()
    with torch.no_grad():
        ref_out = snapshot(got["branch_input"], torch.tensor(mask), None, span)
        own = policy.forward_branch(got["branch_input"], 1, torch.tensor(mask), None, span)
    sub = real[:, 2:P - 1]
    for out in (ref_out, own):
        np.testing.assert_allclose(out["logits"].numpy()[sub], np.asarray(want_ref["logits"])[sub],
                                   atol=ATOL, rtol=0)
    mask_of = trainable_mask(policy, tcfg, 1)
    assert not mask_of["backbone.blocks.0.attn.q_proj.weight"]
    assert all(mask_of[k] for k in ("backbone.blocks.1.attn.q_proj.weight",
                                    "backbone.wte.weight", "backbone.wpe.weight",
                                    "backbone.ln_f.weight", "v_head.out_proj.bias"))
