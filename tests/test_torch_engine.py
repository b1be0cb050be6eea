"""The port's paged ``ContinuousEngine`` (``trlx_tpu_torch/engine``) against
the JAX package: more prompts than slots (so slots are refilled), an
eos-boost adjust hook for ragged lengths, greedy decoding — every
harvested sequence equals JAX ``generate`` token for token, across block
sizes. Sampled decoding is held against the port's own plain ``generate``
with the same per-row seeds (the noise is batch-composition invariant).
With a value-head policy every harvested row carries the value head's
output beside each token, as the JAX engine's harvest does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_transformer import _numpy_params
from trlx_tpu.engine.core import ContinuousEngine as JaxContinuousEngine
from trlx_tpu.models.heads import CausalLMWithValueHead as JaxValueHeadLM
from trlx_tpu.ops.paged_kv import PagedSpec as JaxPagedSpec
from trlx_tpu.ops.sampling import per_row_keys
from trlx_tpu.ops.slot_refill import make_slot_refill_fns as jax_make_slot_refill_fns
from trlx_tpu.models.transformer import CausalTransformer as JaxCausalTransformer
from trlx_tpu.models.transformer import TransformerConfig as JaxConfig
from trlx_tpu.models.transformer import make_kv_cache as jax_make_kv_cache
from trlx_tpu.ops.sampling import GenerationConfig as JaxGenerationConfig
from trlx_tpu.ops.sampling import generate as jax_generate
from trlx_tpu_torch.engine.allocator import (
    BlockAllocator,
    BlockPoolExhausted,
    TenantQuotaExceeded,
)
from trlx_tpu_torch.engine.core import ContinuousEngine
from trlx_tpu_torch.models.heads import CausalLMWithValueHead
from trlx_tpu_torch.models.transformer import CausalTransformer, TransformerConfig
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.ops.paged_kv import PagedSpec, num_table_blocks
from trlx_tpu_torch.ops.sampling import GenerationConfig, generate
from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

EOS, PAD = 3, 258
B, P, N = 2, 10, 9
BOOST = 0.5  # eos logit boost: gives ragged greedy lengths on these weights


def _boost_jax(step_out, logits):
    return logits.at[..., EOS].add(BOOST)


def _boost_torch(step_out, logits):
    logits = logits.clone()
    logits[..., EOS] += BOOST
    return logits


def _gen_config(**kw):
    base = dict(max_new_tokens=N, eos_token_id=EOS, pad_token_id=PAD,
                min_new_tokens=2, do_sample=False)
    base.update(kw)
    return GenerationConfig(**base)


def _prompt_set(n=7, seed=1):
    rs = np.random.RandomState(seed)
    prompts = rs.randint(0, 200, (n, P)).astype(np.int32)
    masks = np.ones_like(prompts)
    for i in range(n):  # vary left padding across rows
        prompts[i, : i % 3] = PAD
        masks[i, : i % 3] = 0
    return prompts, masks


@pytest.fixture(scope="module")
def lm():
    jcfg = dataclasses.replace(JaxConfig.gpt2("test"), dtype=jnp.float32)
    params = _numpy_params(jcfg, seed=11)
    tcfg = TransformerConfig.gpt2("test", dtype=torch.float32)
    model = CausalTransformer(tcfg)
    model.load_state_dict(params_from_jax(params, tcfg))
    return jcfg, params, model.eval(), tcfg


@pytest.fixture(scope="module")
def jax_reference(lm):
    """Greedy JAX ``generate`` over the whole prompt set in one batch."""
    jcfg, params, _, _ = lm
    module = JaxCausalTransformer(jcfg)
    prompts, masks = _prompt_set()
    config = JaxGenerationConfig(max_new_tokens=N, eos_token_id=EOS, pad_token_id=PAD,
                                 min_new_tokens=2, do_sample=False)
    run = jax.jit(lambda p, ids, m: jax_generate(
        lambda pp, x, **kw: module.apply({"params": pp}, x, **kw), p,
        lambda b, s: jax_make_kv_cache(jcfg, b, s), ids, m, jax.random.PRNGKey(0),
        config, adjust_logits=_boost_jax))
    out = run(params, jnp.asarray(prompts), jnp.asarray(masks))
    tokens = np.asarray(out.response_tokens)
    mask = np.asarray(out.response_mask)
    assert len({int(m.sum()) for m in mask}) > 1, "lengths must be ragged to exercise refills"
    return tokens, mask, np.asarray(out.response_logprobs)


def _engine(tcfg, model, block_size, config, segment_len=3, max_blocks=0, **kw):
    paged = PagedSpec(block_size, max_blocks or 1 + 2 * B * num_table_blocks(P + N, block_size) + 4)
    fns = make_slot_refill_fns(tcfg, B, P, config, adjust_logits=_boost_torch,
                               segment_len=segment_len, paged=paged, device="cpu")
    return ContinuousEngine(fns, model, PAD, **kw)


@pytest.mark.parametrize("block_size", [1, 3, 4])
def test_greedy_engine_matches_jax_generate(lm, jax_reference, block_size):
    _, _, model, tcfg = lm
    tokens, mask, logprobs = jax_reference
    prompts, masks = _prompt_set()
    engine = _engine(tcfg, model, block_size, _gen_config())
    engine.enqueue_prompts(prompts, masks, np.arange(len(prompts)))
    got = {c.index: c for c in engine.run()}
    assert sorted(got) == list(range(len(prompts)))
    for i, c in got.items():
        np.testing.assert_array_equal(c.tokens, tokens[i], err_msg=f"prompt {i}")
        np.testing.assert_array_equal(c.mask, mask[i], err_msg=f"prompt {i}")
        np.testing.assert_allclose(c.logprobs, logprobs[i], atol=1e-5, rtol=0)
    st = engine.stats
    assert st.harvested == len(prompts) and st.refill_prefills >= 3
    assert 0.0 < st.slot_utilization <= 1.0
    # every block went back to the free list
    assert engine.allocator.blocks_in_use == 0
    # the plain versions ran on the CPU: no kernel launched
    m = st.metrics()
    assert m["engine/decode_kernel_launches"] == 0.0
    assert m["engine/prefill_kernel_launches"] == 0.0


def test_sampled_engine_matches_plain_generate_per_seed(lm):
    """Sampled rows migrate through refilled slots yet draw exactly what a
    solo plain ``generate`` with the same seed draws."""
    _, _, model, tcfg = lm
    config = _gen_config(do_sample=True, temperature=0.9, top_k=20, top_p=0.9)
    prompts, masks = _prompt_set(n=5, seed=3)
    seeds = np.asarray([11, 12, 13, 14, 15])
    engine = _engine(tcfg, model, 4, config)
    engine.enqueue_prompts(prompts, masks, seeds)
    got = {c.index: c for c in engine.run()}
    for i in range(len(prompts)):
        solo = generate(model, torch.tensor(prompts[i : i + 1]), torch.tensor(masks[i : i + 1]),
                        torch.tensor(seeds[i : i + 1]), config, adjust_logits=_boost_torch)
        np.testing.assert_array_equal(got[i].tokens, solo.response_tokens[0].numpy())
        np.testing.assert_array_equal(got[i].mask, solo.response_mask[0].numpy())


def test_mixed_greedy_and_sampled_rows(lm, jax_reference):
    """Rows flagged greedy in a sampling engine decode exactly greedily."""
    _, _, model, tcfg = lm
    tokens, mask, _ = jax_reference
    prompts, masks = _prompt_set()
    engine = _engine(tcfg, model, 3, _gen_config(do_sample=True))
    greedy = np.arange(len(prompts)) % 2 == 0
    engine.enqueue_prompts(prompts, masks, np.arange(len(prompts)), greedy=greedy)
    for c in engine.run():
        if greedy[c.index]:
            np.testing.assert_array_equal(c.tokens, tokens[c.index])


def test_value_head_harvest_matches_jax_engine(lm):
    """The repair of the port's harvests: ``CompletedSequence.values`` (and
    ``GenerationOutput.response_values``) hold the value head's output for
    the state before each sampled token, zeros after a row ends — the JAX
    paged engine's harvest values on the same value-head weights."""
    jcfg = dataclasses.replace(JaxConfig.gpt2("test"), dtype=jnp.float32)
    params = _numpy_params(jcfg, seed=13, module_cls=JaxValueHeadLM)
    module = JaxValueHeadLM(jcfg)
    jconfig = JaxGenerationConfig(max_new_tokens=N, eos_token_id=EOS, pad_token_id=PAD,
                                  min_new_tokens=2, do_sample=False, per_row_rng=True)
    paged = 1 + 2 * B * num_table_blocks(P + N, 4) + 4
    jfns = jax_make_slot_refill_fns(
        lambda p, x, **kw: module.apply({"params": p}, x, **kw),
        lambda b, s: jax_make_kv_cache(jcfg, b, s), B, P, jconfig,
        adjust_logits=_boost_jax, segment_len=3, params_example=params,
        paged=JaxPagedSpec(4, paged))
    jengine = JaxContinuousEngine(jfns, params, PAD)
    prompts, masks = _prompt_set()
    jengine.enqueue_prompts(prompts, masks,
                            np.asarray(per_row_keys(jax.random.PRNGKey(0), len(prompts))))
    want = {c.index: c for c in jengine.run()}

    tcfg = TransformerConfig.gpt2("test", dtype=torch.float32)
    policy = CausalLMWithValueHead(tcfg).eval()
    policy.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    engine = _engine(tcfg, policy, 4, _gen_config())
    engine.enqueue_prompts(prompts, masks, np.arange(len(prompts)))
    got = {c.index: c for c in engine.run()}
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for i, c in got.items():
        np.testing.assert_array_equal(c.tokens, want[i].tokens, err_msg=f"prompt {i}")
        np.testing.assert_array_equal(c.mask, want[i].mask)
        assert np.abs(c.values).max() > 0
        np.testing.assert_allclose(c.values, np.asarray(want[i].values), atol=1e-5, rtol=0)
        np.testing.assert_allclose(c.logprobs, np.asarray(want[i].logprobs), atol=1e-5, rtol=0)
    # the plain dense generate carries the same values
    solo = generate(policy, torch.tensor(prompts[:2]), torch.tensor(masks[:2]),
                    torch.tensor([0, 1]), _gen_config(), adjust_logits=_boost_torch)
    for j in range(2):
        np.testing.assert_allclose(solo.response_values[j].numpy(), got[j].values, atol=1e-5)
    # the step state takes the structure the model emits
    assert "value" in engine.state.step_out
    # a bare LM carries no value in its step state and harvests zero values
    _, _, model, _ = lm
    bare = _engine(tcfg, model, 4, _gen_config())
    assert "value" not in bare.state.step_out
    bare.enqueue_prompts(prompts[:2], masks[:2], [0, 1])
    assert all(np.all(c.values == 0.0) for c in bare.run())


def test_rejects_unported_configurations(lm):
    """What stays refused are JAX's own combinations: the in-place kernels,
    speculation, the prefix cache and chunked prefill need the paged
    backend, speculation needs a draft. The dense backend, the gather
    kernels and speculation with the prefix cache or chunked prefill
    build (``tests/test_torch_engine_paths.py`` holds them against JAX)."""
    _, _, model, tcfg = lm
    paged = PagedSpec(4, 16)
    cfg = _gen_config()
    for knob in ("decode_kernel", "prefill_kernel"):
        with pytest.raises(ValueError, match=f"{knob}: pallas .* paged"):
            make_slot_refill_fns(tcfg, B, P, cfg, paged=None, device="cpu", **{knob: "pallas"})
        with pytest.raises(ValueError, match=f"unknown {knob}"):
            make_slot_refill_fns(tcfg, B, P, cfg, paged=paged, device="cpu", **{knob: "mosaic"})
    with pytest.raises(ValueError, match="speculative .* paged"):
        make_slot_refill_fns(tcfg, B, P, cfg, paged=None, speculative=2, draft_cfg=tcfg,
                             device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        make_slot_refill_fns(tcfg, B, P, cfg, paged=paged, speculative=2, device="cpu")
    with pytest.raises(ValueError, match="transition_mask"):
        make_slot_refill_fns(tcfg, B, P, cfg, paged=paged, device="cpu",
                             transition_mask=np.ones((259, 259), bool))
    fns = make_slot_refill_fns(tcfg, B, P, cfg, paged=paged, device="cpu")
    assert (fns.decode_kernel, fns.prefill_kernel) == ("pallas", "pallas")
    dense = make_slot_refill_fns(tcfg, B, P, cfg, device="cpu")
    assert dense.paged is None and dense.prefill_chunk_rows is None
    assert (dense.decode_kernel, dense.prefill_kernel) == ("xla", "xla")
    with pytest.raises(ValueError, match="engine.prefix_cache requires the paged"):
        ContinuousEngine(dense, model, PAD, prefix_cache=True)
    with pytest.raises(ValueError, match="engine.prefill_chunk requires the paged"):
        ContinuousEngine(dense, model, PAD, prefill_chunk=4)
    with pytest.raises(ValueError, match="dense backend prefills whole prompts"):
        dense.refill_program(2, hit=4)
    # speculation composes with the prefix cache and chunked prefill
    spec_fns = make_slot_refill_fns(tcfg, B, P, cfg, paged=paged, speculative=2,
                                    device="cpu", draft_cfg=tcfg)
    engine = ContinuousEngine(spec_fns, (model, model), PAD, prefix_cache=True,
                              prefill_chunk=4)
    assert engine.prefix is not None and engine._chunk == 4
    with pytest.raises(ValueError, match="prefill_chunk"):
        ContinuousEngine(fns, model, PAD, prefill_chunk=-1)
    engine = ContinuousEngine(fns, model, PAD, prewarm=False)
    with pytest.raises(ValueError, match="padded width"):
        engine.enqueue_prompts(np.zeros((1, P + 1)), np.ones((1, P + 1)), [0])
    with pytest.raises(ValueError, match="priority class"):
        engine.enqueue_prompts(np.zeros((1, P)), np.ones((1, P)), [0], klass="vip")


def test_priority_order_and_tenant_quota(lm):
    _, _, model, tcfg = lm
    engine = _engine(tcfg, model, 4, _gen_config())
    prompts, masks = _prompt_set(n=4)
    engine.allocator.set_tenant_quota("small", 1)  # < the 3 prompt blocks
    engine.enqueue_prompts(prompts[:2], masks[:2], [0, 1], klass="actor")
    engine.enqueue_prompts(prompts[2:3], masks[2:3], [2], klass="interactive")
    engine.enqueue_prompts(prompts[3:], masks[3:], [3], tenant="small", klass="interactive")
    engine.step()
    # interactive first; the quota'd tenant fails without failing the engine
    assert engine._slots[0].index == 2 and engine._slots[1].index == 0
    assert [req.index for req, _ in engine.failed] == [3]
    done = engine.run()
    assert {c.index for c in done} == {0, 1, 2}


class TestAllocator:
    def test_refcount_lifecycle_and_zero_block(self):
        a = BlockAllocator(6)  # blocks 1..5 allocatable
        assert a.blocks_free == 5
        got = a.alloc(3)
        assert 0 not in got and a.blocks_in_use == 3 and a.high_water == 3
        a.retain(got[:1])
        assert a.release(got) == got[1:]  # the retained block survives
        assert a.release(got[:1]) == got[:1]
        assert a.blocks_in_use == 0

    def test_exhaustion_and_bad_release(self):
        a = BlockAllocator(3)
        a.alloc(2)
        with pytest.raises(BlockPoolExhausted, match="KV blocks"):
            a.alloc(1)
        with pytest.raises(ValueError, match="unallocated"):
            a.release([0])
        with pytest.raises(ValueError):
            BlockAllocator(1)

    def test_tenant_quota(self):
        a = BlockAllocator(10)
        a.set_tenant_quota("t", 2)
        blocks = a.alloc(2, tenant="t")
        with pytest.raises(TenantQuotaExceeded):
            a.alloc(1, tenant="t")
        a.alloc(3)  # unquoted traffic is unaffected
        a.release(blocks[:1])
        assert a.tenant_blocks_in_use("t") == 1
        a.alloc(1, tenant="t")
