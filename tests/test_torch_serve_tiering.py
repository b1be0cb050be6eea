"""Host-RAM tiering (``trlx_tpu_torch/serve/tiering.py``) and the serving
engine's scheduling on the port's paged engine: a spilled-then-re-landed
block is bitwise the block that was spilled; a re-land's harvest equals a
cold prefill's and JAX's tiered engine on the same stream (harvest and
host counters); changed weights flush the tier; tenants never share a
chain and a quota sheds only its own tenant's entries; ``reserve_slots``
follows the rule of JAX's code (``trlx_tpu/engine/core.py`` ``_admit``
and ``_pop_next``): once non-interactive rows hold ``B − reserve_slots``
slots, only interactive requests are admitted."""

import numpy as np
import pytest
import torch

from tests.test_torch_prefix_cache import (  # noqa: F401 — the vlm fixture
    COUNTERS,
    PAD,
    assert_counters_equal,
    assert_harvests_equal,
    feed,
    gen_config,
    jax_engine,
    port_engine,
    row_keys,
    shared_prefix_stream,
    vlm,
)
from trlx_tpu.serve.tiering import HostTier as JaxHostTier
from trlx_tpu_torch.ops.paged_kv import block_bytes, host_block_buffers, read_block, write_blocks
from trlx_tpu_torch.serve.tiering import HostTier
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()


def two_system_prompts(seed=11):
    """Rows 0–2 share system prompt X, rows 3–5 system prompt Y; rows 6–7
    repeat rows 0–1 (their chain comes back from the host tier)."""
    x, _ = shared_prefix_stream(n=3, seed=seed, prefix_len=12)
    y, _ = shared_prefix_stream(n=3, seed=seed + 1, prefix_len=12)
    prompts = np.concatenate([x, y, x[:2]])
    return prompts, np.ones_like(prompts)


class RecordingTier(HostTier):
    """A tier that keeps a device copy of every spilled block and checks
    each re-landed block against it, bitwise."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.copies, self.checked = {}, 0

    def spill(self, digest, pool, block):
        if digest not in self:
            self.copies[digest] = [{n: layer[n][block].clone() for n in ("k", "v")}
                                   for layer in pool]
        super().spill(digest, pool, block)

    def reland_many(self, digests, pool, blocks):
        out = super().reland_many(digests, pool, blocks)
        for d, b in zip(digests, blocks):
            for layer, saved in zip(pool, self.copies[d]):
                for n in ("k", "v"):
                    assert torch.equal(layer[n][b], saved[n])
            self.checked += 1
        return out


def test_block_copies_are_verbatim():
    rs = np.random.RandomState(0)
    pool = [{n: torch.tensor(rs.randn(6, 4, 2, 8), dtype=torch.bfloat16) for n in ("k", "v")}
            for _ in range(3)]
    buf = host_block_buffers(pool, 2)
    read_block(pool, 4, buf, 1)
    read_block(pool, 2, buf, 0)
    want = [{n: layer[n][[4, 2]].clone() for n in ("k", "v")} for layer in pool]
    write_blocks(pool, [1, 5], buf, [1, 0])
    for layer, w in zip(pool, want):
        for n in ("k", "v"):
            assert torch.equal(layer[n][[1, 5]], w[n])
            assert layer[n].dtype == torch.bfloat16


def test_reland_equals_cold_prefill_and_jax(vlm):
    """A capped cache evicts X's chain when Y's arrives; it spills to the
    host tier, and X's repeats re-land it bitwise instead of prefilling."""
    prompts, masks = two_system_prompts()
    waves = [range(0, 3), range(3, 6), range(6, 8)]
    mine = port_engine(vlm, capacity=3)
    tier = RecordingTier(16, block_bytes=block_bytes(mine.state.cache))
    mine.attach_host_tier(tier)
    got = feed(mine, prompts, masks, waves, jax_side=False)
    jengine = jax_engine(vlm, capacity=3)
    jengine.attach_host_tier(JaxHostTier(16))
    want = feed(jengine, prompts, masks, waves, jax_side=True)
    assert_harvests_equal(got, want)
    assert_counters_equal(mine.stats, jengine.stats, COUNTERS)
    cold = feed(port_engine(vlm, prefix=False), prompts, masks, waves, jax_side=False)
    assert_harvests_equal(got, cold, tol=1e-6)
    st = mine.stats
    assert st.host_tier_hit_blocks > 0 and tier.checked == st.host_tier_hit_blocks
    assert st.host_tier_tokens_saved == 4 * st.host_tier_hit_blocks
    snap = tier.snapshot()
    assert snap == jengine.host_tier.snapshot() | {"bytes": snap["bytes"]}
    assert snap["spilled"] > 0 and snap["relanded"] == st.host_tier_hit_blocks
    m = st.metrics()
    assert m["engine/host_tier_hit_blocks"] == st.host_tier_hit_blocks


def test_changed_weights_flush_the_tier(vlm):
    prompts, masks = two_system_prompts()
    engine = port_engine(vlm, capacity=3)
    engine.attach_host_tier(HostTier(16))
    engine.swap_params(engine.params, version=0)
    feed(engine, prompts, masks, [range(0, 3), range(3, 6)], jax_side=False)
    assert len(engine.host_tier) > 0 and len(engine.prefix) > 0
    engine.begin_collection(engine.params, version=0)  # same weights: kept
    assert len(engine.host_tier) > 0
    engine.begin_collection(engine.params, version=1)
    assert len(engine.host_tier) == 0 and len(engine.prefix) == 0
    assert engine.allocator.blocks_in_use == 0
    with pytest.raises(ValueError, match="prefix cache"):
        port_engine(vlm, prefix=False).attach_host_tier(HostTier(4))


def test_tenants_are_isolated_and_quotas_shed_their_own(vlm):
    """Byte-identical prompts under two tenants build disjoint chains; a
    tenant at its quota evicts only its own entries, and a prompt its
    quota cannot cover fails that request alone — as JAX's engine."""
    prompts, masks = two_system_prompts()
    out = {}
    for side, engine in (("port", port_engine(vlm)), ("jax", jax_engine(vlm))):
        jax_side = side == "jax"
        engine.allocator.set_tenant_quota("b", 8)
        engine.allocator.set_tenant_quota("tiny", 2)
        got = feed(engine, prompts, masks, [range(0, 3)], jax_side, tenant="a")
        hits_a = engine.stats.prefix_hit_blocks
        got.update(feed(engine, prompts, masks, [range(0, 3)], jax_side, tenant="b"))
        out[side] = (got, engine, hits_a)
        # tenant b repeated a's prompts: no hit may come from a's chain
        assert engine.stats.prefix_hit_blocks == 2 * hits_a
        entries_a = sum(1 for e in engine.prefix._entries.values() if e.tenant == "a")
        got.update(feed(engine, prompts, masks, [range(3, 6)], jax_side, tenant="b"))
        assert sum(1 for e in engine.prefix._entries.values() if e.tenant == "a") == entries_a
        assert engine.stats.prefix_evicted_blocks > 0  # b's quota shed b's entries
        assert engine.allocator.tenant_blocks_in_use("b") <= 8
        feed(engine, prompts, masks, [range(6, 7)], jax_side, tenant="tiny")
        assert [req.index for req, _ in engine.failed] == [engine._submitted - 1]
    (got, mine, _), (want, jengine, _) = out["port"], out["jax"]
    assert_harvests_equal(got, want)
    assert_counters_equal(mine.stats, jengine.stats, COUNTERS)


def test_reserve_slots_follow_the_rule_of_jax_code(vlm):
    """Three slots, one reserved, rows that never finish early (no eos):
    two actors take the unreserved slots and the third waits; an
    interactive request takes the reserved slot at once; with the batch
    full, a further interactive request waits for a free slot (seeded rows
    are never preempted). JAX's engine shows the same occupancy at every
    step."""
    prompts, masks = two_system_prompts()
    lives = {}
    for side, engine in (
            ("port", port_engine(vlm, slots=3, segment_len=1,
                                 config=gen_config(eos_token_id=None))),
            ("jax", jax_engine(vlm, slots=3, segment_len=1, eos=None))):
        jax_side = side == "jax"
        engine.reserve_slots = 1
        seen = []
        for w, (rows, klass) in enumerate(((range(0, 3), "actor"),
                                           (range(3, 4), "interactive"),
                                           (range(4, 5), "interactive"))):
            rows = list(rows)
            engine.enqueue_prompts(prompts[rows], masks[rows], row_keys(rows, w, jax_side),
                                   klass=klass)
            engine.step()
            seen.append((engine.live, engine.pending))
        lives[side] = seen
        assert sorted(r.klass for r in engine._slots if r is not None) == [
            "actor", "actor", "interactive"]
    assert lives["port"] == [(2, 1), (3, 1), (3, 2)]
    assert lives["port"] == lives["jax"]
