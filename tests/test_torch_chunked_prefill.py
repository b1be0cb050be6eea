"""Chunked prefill on the port's paged engine against the JAX package:
chunk sizes 4, 8 and 16 at block sizes 4 and 8, with prefix hits, each
equal to the unchunked harvest and to JAX's ``ContinuousEngine`` (the
harvest and every host counter); the pad-skip start of a left-padded row
(``first_real``); and the preemption of a still-prefilling slot, whose
committed chunks come back as a prefix hit."""

import numpy as np
import pytest

from tests.test_torch_prefix_cache import (  # noqa: F401 — the vlm fixture
    B,
    COUNTERS,
    assert_counters_equal,
    assert_harvests_equal,
    feed,
    jax_engine,
    port_engine,
    shared_prefix_stream,
    vlm,
)
from trlx_tpu_torch.ops.paged_kv import num_table_blocks
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

P = 24  # a 16-token shared system prompt and 8 tokens of each row's own


def chunk_stream(n=6, seed=7):
    return shared_prefix_stream(n=n, seed=seed, prefix_len=16, width=P)


def geometry(bs):
    return dict(bs=bs, prompt_len=P, max_blocks=1 + 2 * B * num_table_blocks(P + 6, bs) + 4)


def left_padded(prompts, masks):
    """Rows whose leading columns are padding, as the engine pads a narrow
    prompt: the mask's zero columns become pad on both."""
    prompts, masks = prompts.copy(), masks.copy()
    masks[2, :13] = 0
    masks[4:, :5] = 0
    prompts[masks == 0] = 258
    return prompts, masks


@pytest.mark.parametrize("bs,chunk", [(4, 4), (4, 8), (8, 8), (8, 16)])
def test_chunked_equals_unchunked_and_jax(vlm, bs, chunk):
    prompts, masks = left_padded(*chunk_stream())
    waves = [range(0, 3), range(3, 6)]
    geo = geometry(bs)
    whole = feed(port_engine(vlm, prefix=False, **geo), prompts, masks, waves, jax_side=False)
    mine = port_engine(vlm, chunk=chunk, **geo)
    got = feed(mine, prompts, masks, waves, jax_side=False)
    assert_harvests_equal(got, whole, tol=1e-6)
    jengine = jax_engine(vlm, chunk=chunk, **geo)
    want = feed(jengine, prompts, masks, waves, jax_side=True)
    assert_harvests_equal(got, want)
    assert_counters_equal(mine.stats, jengine.stats)
    st = mine.stats
    assert st.prefix_hit_blocks > 0
    if chunk < P:
        assert st.prefill_chunk_calls > 0
        assert mine.stats.metrics()["rollout/prefill_chunks"] == st.prefill_chunk_calls


def test_first_real_skips_the_pad_columns(vlm):
    """A row with 13 leading pad columns starts prefilling at the chunk
    grid point at or below its first real column: columns below it are
    never prefilled (all-pad rows still run their last span)."""
    prompts, masks = left_padded(*chunk_stream(n=3))
    prompts[0] = 258
    masks[0] = 0  # an all-pad row
    engine = port_engine(vlm, chunk=4, prefix=False, **geometry(4))
    jengine = jax_engine(vlm, chunk=4, prefix=False, **geometry(4))
    got = feed(engine, prompts, masks, [range(3)], jax_side=False)
    want = feed(jengine, prompts, masks, [range(3)], jax_side=True)
    assert_harvests_equal(got, want)
    assert_counters_equal(engine.stats, jengine.stats)
    # row 0 prefills [20, 24), row 1 all 24 columns, row 2 [12, 24)
    assert engine.stats.prefill_tokens == 4 + 24 + 12


def test_preempted_prefilling_slot_comes_back_as_a_hit(vlm):
    """Two actor rows prefill a chunk each; an interactive request with no
    free slot preempts the less advanced one, whose committed chunks enter
    its chain first and come back as a prefix hit on re-admission."""
    prompts, masks = chunk_stream(n=3, seed=9)
    prompts[1, :16] = prompts[1, :16][::-1]  # row 1 shares no prefix with row 0
    geo = geometry(4)
    out = {}
    for side, engine in (("port", port_engine(vlm, chunk=4, **geo)),
                         ("jax", jax_engine(vlm, chunk=4, **geo))):
        jax_side = side == "jax"
        got = {}

        def enqueue(rows, klass, engine=engine, jax_side=jax_side):
            if jax_side:
                import jax

                from trlx_tpu.ops.sampling import per_row_keys

                keys = np.asarray(per_row_keys(jax.random.PRNGKey(rows[0]), len(rows)))
            else:
                keys = np.asarray(rows)
            engine.enqueue_prompts(prompts[rows], masks[rows], keys, klass=klass)

        enqueue([0, 1], "actor")
        for c in engine.step():  # both rows commit their first chunk
            got[c.index] = c
        enqueue([2], "interactive")
        for c in engine.step():
            got[c.index] = c
        assert engine.stats.preempted_rows == 1
        for c in engine.run():
            got[c.index] = c
        out[side] = (got, engine)
    (got, mine), (want, jengine) = out["port"], out["jax"]
    assert_harvests_equal(got, want)
    assert_counters_equal(mine.stats, jengine.stats, COUNTERS)
    # the victim's committed chunk (plus its shared chain) re-landed as a hit
    assert mine.stats.prefix_hit_blocks >= 1
    cold = feed(port_engine(vlm, prefix=False, **geo), prompts, masks, [range(3)],
                jax_side=False)
    assert_harvests_equal(got, cold, tol=1e-6)
