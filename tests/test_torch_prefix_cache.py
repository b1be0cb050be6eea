"""The port's prefix cache (``trlx_tpu_torch/engine/prefix_cache.py``) and
the paged engine's prefix path against the JAX package: the digests are
JAX's bytes, match / insert / evict follow JAX's on a scripted stream,
a hit's harvest equals a cold miss's, the prefix engine's harvest and its
host counters equal JAX's ``ContinuousEngine`` on the same stream and
weights, and cached KV is flushed after an in-place optimizer step (the
engines read the policy's live weights, so the flush follows a version,
not the module's identity). Tiny geometry: GPT-2 test (2 layers, width
64), block size 4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import EOS, PAD, _boost_jax, _boost_torch  # noqa: F401
from tests.test_torch_transformer import _numpy_params
from trlx_tpu.engine.allocator import BlockAllocator as JaxBlockAllocator
from trlx_tpu.engine.core import ContinuousEngine as JaxContinuousEngine
from trlx_tpu.engine.prefix_cache import PrefixCache as JaxPrefixCache
from trlx_tpu.models.heads import CausalLMWithValueHead as JaxValueHeadLM
from trlx_tpu.models.transformer import TransformerConfig as JaxConfig
from trlx_tpu.models.transformer import make_kv_cache as jax_make_kv_cache
from trlx_tpu.ops.paged_kv import PagedSpec as JaxPagedSpec
from trlx_tpu.ops.sampling import GenerationConfig as JaxGenerationConfig
from trlx_tpu.ops.sampling import per_row_keys
from trlx_tpu.ops.slot_refill import make_slot_refill_fns as jax_make_slot_refill_fns
from trlx_tpu_torch.engine.allocator import BlockAllocator
from trlx_tpu_torch.engine.core import ContinuousEngine
from trlx_tpu_torch.engine.prefix_cache import PrefixCache
from trlx_tpu_torch.models.heads import CausalLMWithValueHead
from trlx_tpu_torch.models.transformer import TransformerConfig
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.ops.paged_kv import PagedSpec, num_table_blocks
from trlx_tpu_torch.ops.sampling import GenerationConfig
from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

B, P, N = 2, 16, 6
# the host counters both engines keep, compared exactly
COUNTERS = ("refill_prefills", "refilled_rows", "prefill_tokens", "prefill_chunk_calls",
            "prefix_lookup_blocks", "prefix_hit_blocks", "prefix_tokens_saved",
            "prefix_evicted_blocks", "host_tier_hit_blocks", "host_tier_tokens_saved",
            "preempted_rows", "harvested", "segments", "decode_steps", "live_slot_steps")


def gen_config(**kw):
    base = dict(max_new_tokens=N, eos_token_id=EOS, pad_token_id=PAD, min_new_tokens=2,
                do_sample=False)
    base.update(kw)
    return GenerationConfig(**base)


def shared_prefix_stream(n=8, seed=3, prefix_len=12, width=P):
    """``n`` prompts of ``width`` columns: a shared ``prefix_len``-token
    system prompt and tokens of their own, a few left-padded, the last two
    exact repeats of the first two."""
    rs = np.random.RandomState(seed)
    system = rs.randint(0, 200, prefix_len)
    prompts = np.concatenate([np.tile(system, (n, 1)),
                              rs.randint(0, 200, (n, width - prefix_len))], axis=1)
    masks = np.ones_like(prompts)
    for i in (3, 5)[: max(0, n - 3)]:  # left padding: these rows share no block with the rest
        prompts[i, :5] = PAD
        masks[i, :5] = 0
    prompts[-2:], masks[-2:] = prompts[:2], masks[:2]
    return prompts.astype(np.int32), masks.astype(np.int32)


@pytest.fixture(scope="module")
def vlm():
    """A value-head GPT-2 test model: JAX params, the port's module."""
    jcfg = dataclasses.replace(JaxConfig.gpt2("test"), dtype=jnp.float32)
    params = _numpy_params(jcfg, seed=17, module_cls=JaxValueHeadLM)
    tcfg = TransformerConfig.gpt2("test", dtype=torch.float32)
    policy = CausalLMWithValueHead(tcfg).eval()
    policy.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return jcfg, params, policy, tcfg


def max_blocks_for(bs, slots=B, prompt_len=P, spare=4):
    return 1 + 2 * slots * num_table_blocks(prompt_len + N, bs) + spare


def port_engine(vlm, bs=4, chunk=0, prefix=True, capacity=0, max_blocks=0, slots=B,
                prompt_len=P, config=None, segment_len=3, **kw):
    _, _, policy, tcfg = vlm
    paged = PagedSpec(bs, max_blocks or max_blocks_for(bs, slots, prompt_len))
    fns = make_slot_refill_fns(tcfg, slots, prompt_len, config or gen_config(),
                               adjust_logits=_boost_torch, segment_len=segment_len,
                               paged=paged, device="cpu")
    return ContinuousEngine(fns, policy, PAD, prefix_cache=prefix,
                            prefix_capacity_blocks=capacity, prefill_chunk=chunk, **kw)


def jax_engine(vlm, bs=4, chunk=0, prefix=True, capacity=0, max_blocks=0, slots=B,
               prompt_len=P, segment_len=3, eos=EOS):
    jcfg, params, _, _ = vlm
    module = JaxValueHeadLM(jcfg)
    jconfig = JaxGenerationConfig(max_new_tokens=N, eos_token_id=eos, pad_token_id=PAD,
                                  min_new_tokens=2, do_sample=False, per_row_rng=True)
    jfns = jax_make_slot_refill_fns(
        lambda p, x, **kw: module.apply({"params": p}, x, **kw),
        lambda b, s: jax_make_kv_cache(jcfg, b, s), slots, prompt_len, jconfig,
        adjust_logits=_boost_jax, segment_len=segment_len, params_example=params,
        paged=JaxPagedSpec(bs, max_blocks or max_blocks_for(bs, slots, prompt_len)))
    return JaxContinuousEngine(jfns, params, PAD, prefix_cache=prefix,
                               prefix_capacity_blocks=capacity, prefill_chunk=chunk)


def row_keys(rows, wave, jax_side):
    """The rows' sampling keys: JAX per-row key chains, the port's seeds."""
    if jax_side:
        return np.asarray(per_row_keys(jax.random.PRNGKey(wave), len(rows)))
    return np.asarray(rows)


def feed(engine, prompts, masks, waves, jax_side, steps=2, **kw):
    """Enqueue ``prompts`` in ``waves`` (lists of row indices), stepping
    the engine ``steps`` times between waves; returns the harvest by
    index."""
    out = {}
    for w, rows in enumerate(waves):
        rows = list(rows)
        engine.enqueue_prompts(prompts[rows], masks[rows], row_keys(rows, w, jax_side), **kw)
        for _ in range(steps):
            for c in engine.step():
                out[c.index] = c
    for c in engine.run():
        out[c.index] = c
    return out


def assert_harvests_equal(got, want, tol=1e-5):
    assert sorted(got) == sorted(want)
    for i in got:
        np.testing.assert_array_equal(np.asarray(got[i].tokens), np.asarray(want[i].tokens),
                                      err_msg=f"row {i}")
        np.testing.assert_array_equal(np.asarray(got[i].mask), np.asarray(want[i].mask))
        np.testing.assert_allclose(np.asarray(got[i].logprobs), np.asarray(want[i].logprobs),
                                   atol=tol, rtol=0, err_msg=f"row {i}")
        np.testing.assert_allclose(np.asarray(got[i].values), np.asarray(want[i].values),
                                   atol=tol, rtol=0, err_msg=f"row {i}")


def assert_counters_equal(got, want, names=COUNTERS):
    for name in names:
        assert getattr(got, name) == getattr(want, name), name


def test_digests_equal_jax_and_separate_tenants():
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, 300, 37).astype(np.int32)
    mask = (rs.rand(37) > 0.2).astype(np.int32)
    for bs in (4, 8):
        mine, theirs = PrefixCache(bs), JaxPrefixCache(bs)
        seen = set()
        for tenant in (None, "team-a", "team-b"):
            got = mine.chain_digests(tokens, mask, 9, tenant=tenant)
            assert got == theirs.chain_digests(tokens, mask, 9, tenant=tenant)
            assert len(got) == min(9, 37 // bs)
            assert not seen & set(got), "tenants must not share a digest"
            seen |= set(got)


def test_match_insert_evict_follow_jax_on_a_scripted_stream():
    rs = np.random.RandomState(1)
    base = rs.randint(0, 50, 16).astype(np.int32)
    rows = [base.copy() for _ in range(5)]
    rows[1][8:] = 7  # shares two of four blocks with row 0
    rows[2][:] = rs.randint(0, 50, 16)
    rows[4][12:] = 9  # shares three
    mask = np.ones(16, np.int32)
    caches = [(PrefixCache(4, capacity_blocks=6), BlockAllocator(40)),
              (JaxPrefixCache(4, capacity_blocks=6), JaxBlockAllocator(40))]
    spilled = [[], []]
    for side, (cache, _) in enumerate(caches):
        cache.spill = lambda e, side=side: spilled[side].append((e.block, e.digest))
    trace = [[], []]
    for side, (cache, alloc) in enumerate(caches):
        for i, tenant in ((0, None), (1, None), (2, "t"), (0, "t"), (4, None), (3, None)):
            hit = cache.match(rows[i], mask, tenant=tenant)
            alloc.retain(hit)
            fresh = alloc.alloc(4 - len(hit), tenant=tenant)
            n_in = cache.insert(rows[i], mask, hit + fresh, alloc, tenant=tenant)
            trace[side].append((len(hit), n_in, len(cache), alloc.blocks_in_use))
            alloc.release(hit + fresh)
        trace[side].append(cache.evict(alloc, blocks_needed=2, tenant="t"))
        trace[side].append(cache.evict(alloc, entries=1))
        trace[side].append((len(cache), alloc.blocks_in_use,
                            [alloc.refcount(b) for b in range(40)]))
        cache.clear(alloc)
        trace[side].append(alloc.blocks_in_use)
    assert trace[0] == trace[1]
    assert spilled[0] == spilled[1] and spilled[0], "evictions are offered to the spill hook"
    assert trace[0][1][0] == 2  # a partial hit


def test_hit_harvest_equals_a_cold_miss(vlm):
    """Every row of a second pass over the stream hits the chains the first
    pass committed, greedy and sampled rows alike, and harvests what a cold
    engine harvests."""
    prompts, masks = shared_prefix_stream()
    for sample in (False, True):
        config = gen_config(do_sample=sample, top_k=20)
        cold = port_engine(vlm, prefix=False, config=config)
        cold.enqueue_prompts(prompts, masks, np.arange(len(prompts)))
        want = {c.index: c for c in cold.run()}
        warm = port_engine(vlm, config=config)
        warm.enqueue_prompts(prompts, masks, np.arange(len(prompts)))
        first = {c.index: c for c in warm.run()}
        warm.begin_collection()
        warm.enqueue_prompts(prompts, masks, np.arange(len(prompts)))
        second = {c.index - len(prompts): c for c in warm.run()}
        assert_harvests_equal(first, want, tol=1e-6)
        assert_harvests_equal(second, want, tol=1e-6)
        st = warm.stats
        # the last prompt block is always prefilled: 3 of 4 blocks can hit
        assert st.prefix_hit_blocks == st.prefix_lookup_blocks == 3 * len(prompts)
        assert st.prefix_tokens_saved == 12 * len(prompts)
        assert st.prefill_tokens == 4 * len(prompts)
        assert warm.stats.metrics()["engine/prefix_hit_rate"] == 1.0
    # an engine without the cache leaves the gauges out
    assert "engine/prefix_hit_rate" not in cold.stats.metrics()


@pytest.mark.parametrize("bs", [4, 8])
def test_prefix_engine_matches_jax(vlm, bs):
    """Waves of prompts sharing a system prompt, with repeats: the harvest
    and every host counter equal JAX's engine on the same stream."""
    prompts, masks = shared_prefix_stream()
    waves = [range(0, 3), range(3, 6), range(6, 8)]
    got = feed(port_engine(vlm, bs=bs), prompts, masks, waves, jax_side=False)
    jengine = jax_engine(vlm, bs=bs)
    want = feed(jengine, prompts, masks, waves, jax_side=True)
    assert_harvests_equal(got, want)
    mine = port_engine(vlm, bs=bs)
    feed(mine, prompts, masks, waves, jax_side=False)
    assert mine.stats.prefix_hit_blocks > 0
    assert_counters_equal(mine.stats, jengine.stats)
    assert mine.allocator.blocks_in_use == jengine.allocator.blocks_in_use
    assert len(mine.prefix) == len(jengine.prefix)


@pytest.mark.parametrize("limit", ["capacity", "pool"])
def test_capacity_and_pool_pressure_evictions_match_jax(vlm, limit):
    """A small entry cap, or a pool with one spare block: LRU evictions on
    insert and on allocation, as JAX's (chains of mostly distinct prompts)."""
    prompts, masks = shared_prefix_stream(seed=5, prefix_len=4)
    waves = [range(0, 4), range(4, 8)]
    kw = (dict(capacity=4) if limit == "capacity"
          else dict(max_blocks=2 + B * num_table_blocks(P + N, 4)))
    mine = port_engine(vlm, **kw)
    got = feed(mine, prompts, masks, waves, jax_side=False)
    jengine = jax_engine(vlm, **kw)
    want = feed(jengine, prompts, masks, waves, jax_side=True)
    assert_harvests_equal(got, want)
    assert_counters_equal(mine.stats, jengine.stats)
    assert mine.stats.prefix_hit_blocks > 0
    if limit == "capacity":
        assert 0 < len(mine.prefix) <= 4
    else:
        assert mine.stats.prefix_evicted_blocks > 0


def _sgd_step(model, prompts, masks):
    """One in-place optimizer step on ``model``."""
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    with torch.enable_grad():
        out = model(torch.as_tensor(prompts[:2], dtype=torch.int64),
                    attention_mask=torch.as_tensor(masks[:2], dtype=torch.int64))
        out["logits"].float().square().mean().backward()
    opt.step()
    opt.zero_grad()


def test_prefix_kv_invalidated_after_an_in_place_optimizer_step(vlm):
    """The engines read the policy's live weights: an optimizer step
    changes them in place and keeps the module's identity. With the
    trainer's weights version the next collection flushes the cache and
    harvests what a cold engine harvests under the new weights; the
    identity test alone would keep the stale KV."""
    _, _, policy, tcfg = vlm
    model = CausalLMWithValueHead(tcfg).eval()
    model.load_state_dict(policy.state_dict())
    prompts, masks = shared_prefix_stream()
    engine = port_engine(vlm)
    engine.swap_params(model, version=0)
    engine.enqueue_prompts(prompts, masks, np.arange(len(prompts)))
    engine.run()
    assert len(engine.prefix) > 0
    _sgd_step(model, prompts, masks)
    cold = port_engine(vlm, prefix=False)
    cold.swap_params(model)
    cold.enqueue_prompts(prompts, masks, np.arange(len(prompts)))
    want = {c.index: c for c in cold.run()}

    engine.begin_collection(model, version=1)
    assert len(engine.prefix) == 0 and engine.allocator.blocks_in_use == 0
    engine.enqueue_prompts(prompts, masks, np.arange(len(prompts)))
    got = {c.index - len(prompts): c for c in engine.run()}
    assert engine.stats.prefix_hit_blocks > 0  # the repeats hit the fresh chains
    assert_harvests_equal(got, want, tol=1e-6)
    # a repeated version keeps the cache warm
    engine.begin_collection(model, version=1)
    assert len(engine.prefix) > 0
    # identity alone: the same module after another step keeps stale entries
    _sgd_step(model, prompts, masks)
    engine.begin_collection(model)
    assert len(engine.prefix) > 0
