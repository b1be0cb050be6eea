"""The rest of the port's continuous engine against the JAX package, on
the CPU: the dense backend and the gather paths, speculation with the
prefix cache and chunked prefill, the logit hooks under speculation, and a
draft of another family (``trlx_tpu_torch/ops/slot_refill.py``,
``ops/speculative.py``, ``ops/paged_kv.py``, ``engine/core.py``).

Weights are numpy draws carried into both packages (``params_from_jax``),
f32, inputs from a numpy seed; the kernel wrappers run their plain
versions. Held:

- plain harvests (7 prompts through 2 slots, an eos-boost hook for ragged
  lengths, greedy) on the dense backend, the paged gather paths
  (``xla``/``xla``) and the paged kernels (``pallas``/``pallas``) each
  equal JAX's dense and paged-gather engines: tokens and masks equal,
  logprobs and values at 1e-5; sampled harvests agree across the port's
  three paths and with its solo ``generate`` of each row;
- ``gather_view`` / ``scatter_span`` / ``scatter_steps`` equal JAX's on one
  pool, drop-mode lanes included;
- speculation with the prefix cache and chunked prefill (JAX
  ``tests/test_spec_engine.py``'s inputs: 5 requests through 2 slots, row
  4 repeating row 1, block sizes 4 and 3, chunks of 4), for both kernel
  settings: sampled harvests equal the port's solo
  ``generate_speculative`` of each row (tokens and masks equal, logprobs
  and values at 1e-6); greedy harvests equal JAX's solo sampler at 1e-5
  and the engine's counters (spec rounds, accepted and committed tokens,
  prefix hits and lookups, prefill calls) equal JAX's engine's;
- the absorbing transition mask of JAX's ``test_transition_mask_parity``
  (tokens 0–63 may only be followed by eos) under speculation: the port's
  solo sampler and its engine equal JAX's solo sampler (greedy, at 1e-5),
  with heterogeneous lengths;
- a ``llama-test`` draft for a ``mistral-test`` target (GQA, rotary, a
  sliding window narrower than the cache): the solo sampler and the
  engine (prefix cache, chunks, both kernel settings) equal JAX's solo
  sampler at 1e-5.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_speculative import spec_models
from tests.test_torch_transformer import _numpy_params
from trlx_tpu.engine.core import ContinuousEngine as JaxContinuousEngine
from trlx_tpu.models.heads import CausalLMWithValueHead as JaxValueHeadLM
from trlx_tpu.models.transformer import CausalTransformer as JaxCausalTransformer
from trlx_tpu.models.transformer import TransformerConfig as JaxConfig
from trlx_tpu.models.transformer import make_kv_cache as jax_make_kv_cache
from trlx_tpu.ops import paged_kv as jax_paged_kv
from trlx_tpu.ops.sampling import GenerationConfig as JaxGenerationConfig
from trlx_tpu.ops.sampling import per_row_keys
from trlx_tpu.ops.slot_refill import make_slot_refill_fns as jax_make_slot_refill_fns
from trlx_tpu.ops.speculative import generate_speculative as jax_generate_speculative
from trlx_tpu_torch.engine.core import ContinuousEngine
from trlx_tpu_torch.models.heads import CausalLMWithValueHead
from trlx_tpu_torch.models.transformer import CausalTransformer, TransformerConfig
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.ops import paged_kv
from trlx_tpu_torch.ops.paged_kv import PagedSpec, num_table_blocks
from trlx_tpu_torch.ops.sampling import GenerationConfig, generate
from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns
from trlx_tpu_torch.ops.speculative import generate_speculative
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

ATOL = 1e-5
SOLO_ATOL = 1e-6
PAD, EOS = 258, 257
FIELDS = ("tokens", "logprobs", "values", "mask")


def _jax_keys(n):
    return np.asarray(per_row_keys(jax.random.PRNGKey(0), n))


def _harvest(engine, ids, mask, seeds):
    engine.enqueue_prompts(ids, mask, seeds)
    got = {}
    while engine.busy:
        for c in engine.step():
            got[c.index] = {f: np.asarray(getattr(c, f)) for f in FIELDS}
    return got


def _assert_rows(got, want, atol, ctx):
    assert sorted(got) == list(range(len(want))), ctx
    for i, w in enumerate(want):
        for f in ("tokens", "mask"):
            np.testing.assert_array_equal(got[i][f], w[f], err_msg=f"{ctx}: row {i} {f}")
        for f in ("logprobs", "values"):
            np.testing.assert_allclose(got[i][f], w[f], atol=atol, rtol=0,
                                       err_msg=f"{ctx}: row {i} {f}")


# ---------------------------------------------------------------------------
# the paged-KV gather and scatter helpers
# ---------------------------------------------------------------------------

def test_gather_and_scatter_match_jax():
    rs = np.random.RandomState(0)
    NB, bs, KV, D, R, TB, S = 9, 3, 2, 4, 3, 4, 11
    pool = [{n: rs.randn(NB, bs, KV, D).astype(np.float32) for n in ("k", "v")}
            for _ in range(2)]
    # row 2 is a padding row: every table id out of range
    table = np.asarray([[1, 4, 2, 7], [3, 5, 6, 8], [NB] * TB], np.int32)
    dense = [{n: rs.randn(R, S, KV, D).astype(np.float32) for n in ("k", "v")}
             for _ in range(2)]
    base = np.asarray([2, 5, 0])
    counts = np.asarray([4, 0, 3])

    def t(tree):
        return [{n: torch.tensor(x) for n, x in layer.items()} for layer in tree]

    def both_equal(ours, theirs):
        for a, b in zip(ours, theirs):
            for n in ("k", "v"):
                np.testing.assert_array_equal(a[n].numpy(), np.asarray(b[n]))

    jpool = [{n: jnp.asarray(x) for n, x in layer.items()} for layer in pool]
    view = paged_kv.gather_view(t(pool), torch.tensor(table), S)
    both_equal(view, jax_paged_kv.gather_view(jpool, jnp.asarray(table), S))
    got = paged_kv.scatter_span(t(pool), torch.tensor(table), t(dense), 2, 7)
    both_equal(got, jax_paged_kv.scatter_span(jpool, jnp.asarray(table),
                                              [{n: jnp.asarray(x) for n, x in layer.items()}
                                               for layer in dense], 2, 7))
    got = paged_kv.scatter_steps(t(pool), torch.tensor(table), t(dense), torch.tensor(base),
                                 torch.tensor(counts), 5)
    both_equal(got, jax_paged_kv.scatter_steps(
        jpool, jnp.asarray(table), [{n: jnp.asarray(x) for n, x in layer.items()}
                                    for layer in dense],
        jnp.asarray(base), jnp.asarray(counts), 5))


# ---------------------------------------------------------------------------
# plain harvests: the dense backend and the gather paths
# ---------------------------------------------------------------------------

PB, PP, PN = 2, 10, 9  # slots, prompt width, new tokens of the plain cases
BOOST = 0.1  # a logit boost of the eos token: hook arithmetic on every step


def _plain_prompts(n=7, seed=1):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 200, (n, PP)).astype(np.int32)
    mask = np.ones_like(ids)
    for i in range(n):
        ids[i, : i % 3] = PAD
        mask[i, : i % 3] = 0
    return ids, mask


@pytest.fixture(scope="module")
def models():
    return spec_models()


@pytest.fixture(scope="module")
def plain_case(models):
    """The plain cases' eos (the token row 2 repeats greedily without one:
    random weights repeat a token per row, so lengths are ragged and slots
    refill) and the two hooks boosting it."""
    _, target, _, _ = models
    ids, mask = _plain_prompts()
    free = generate(target, torch.tensor(ids), torch.tensor(mask), torch.zeros(len(ids)),
                    GenerationConfig(max_new_tokens=PN, pad_token_id=PAD, do_sample=False))
    eos = int(free.response_tokens[2, -1])

    def boost_torch(step_out, logits):
        logits = logits.clone()
        logits[..., eos] += BOOST
        return logits

    def config(**kw):
        base = dict(max_new_tokens=PN, eos_token_id=eos, pad_token_id=PAD, min_new_tokens=2,
                    do_sample=False)
        base.update(kw)
        return base

    return {"eos": eos, "config": config, "torch": boost_torch,
            "jax": lambda step_out, logits: logits.at[..., eos].add(BOOST)}


def _jax_plain_engine(jm, case, backend):
    paged = None
    kw = {}
    if backend == "paged":
        paged = jax_paged_kv.PagedSpec(3, 1 + 2 * PB * num_table_blocks(PP + PN, 3) + 4)
        kw = dict(decode_kernel="xla", prefill_kernel="xla")
    cfg = JaxGenerationConfig(per_row_rng=True, **case["config"]())
    fns = jax_make_slot_refill_fns(jm["t_apply"], jm["init"], PB, PP, cfg,
                                   adjust_logits=case["jax"], segment_len=3,
                                   params_example=jm["t_params"], paged=paged, **kw)
    return JaxContinuousEngine(fns, jm["t_params"], PAD)


@pytest.fixture(scope="module")
def jax_plain(models, plain_case):
    """JAX's dense and paged-gather harvests of the plain prompt set (the
    oracle, as ``tests/test_engine.py`` pins JAX's own)."""
    jm = models[0]
    ids, mask = _plain_prompts()
    out = {}
    for backend in ("dense", "paged"):
        got = _harvest(_jax_plain_engine(jm, plain_case, backend), ids, mask,
                       _jax_keys(len(ids)))
        out[backend] = [got[i] for i in range(len(ids))]
    lengths = {int(r["mask"].sum()) for r in out["dense"]}
    assert len(lengths) > 1, "lengths must be ragged to exercise refills"
    _assert_rows({i: r for i, r in enumerate(out["paged"])}, out["dense"], 0.0, "jax paged")
    return out


PLAIN_PATHS = {"dense": (None, None, None), "paged-xla": (3, "xla", "xla"),
               "paged-pallas": (3, "pallas", "pallas"), "paged-mixed": (4, "xla", "pallas")}


def _plain_engine(tcfg, model, case, path, config):
    bs, decode, prefill = PLAIN_PATHS[path]
    paged = None if bs is None else PagedSpec(bs, 1 + 2 * PB * num_table_blocks(PP + PN, bs) + 4)
    fns = make_slot_refill_fns(tcfg, PB, PP, config, adjust_logits=case["torch"],
                               segment_len=3, paged=paged, device="cpu",
                               decode_kernel=decode, prefill_kernel=prefill)
    assert (fns.paged is None) == (bs is None)
    return ContinuousEngine(fns, model, PAD)


@pytest.mark.parametrize("path", list(PLAIN_PATHS))
def test_plain_paths_match_jax_engines(models, plain_case, jax_plain, path):
    _, target, _, tcfg = models
    ids, mask = _plain_prompts()
    engine = _plain_engine(tcfg, target, plain_case, path,
                           GenerationConfig(**plain_case["config"]()))
    got = _harvest(engine, ids, mask, np.arange(len(ids)))
    for backend in ("dense", "paged"):
        _assert_rows(got, jax_plain[backend], ATOL, f"{path} vs jax {backend}")
    assert any(np.abs(r["values"]).max() > 0 for r in got.values())
    st = engine.stats
    assert st.harvested == len(ids) and st.refill_prefills >= 3
    m = st.metrics()
    if path == "dense":
        # no pool: JAX's dense-backend accounting
        assert engine.allocator is None and st.kv_blocks_total == 0
        assert m["memory/kv_cache_bytes"] == sum(
            t.numel() * t.element_size() for layer in engine.state.cache for t in layer.values())
    else:
        assert engine.allocator.blocks_in_use == 0
    assert m["engine/decode_kernel_launches"] == 0.0  # plain versions on the CPU


def test_sampled_paths_agree(models, plain_case):
    """Sampled rows draw the same tokens on every path and equal a solo
    plain ``generate`` with the row's seed."""
    _, target, _, tcfg = models
    ids, mask = _plain_prompts(n=5, seed=3)
    seeds = np.asarray([11, 12, 13, 14, 15])
    config = GenerationConfig(**plain_case["config"](do_sample=True, temperature=0.9,
                                                     top_k=20, top_p=0.9))
    harvests = {path: _harvest(_plain_engine(tcfg, target, plain_case, path, config), ids,
                               mask, seeds)
                for path in PLAIN_PATHS}
    for i in range(len(ids)):
        solo = generate(target, torch.tensor(ids[i:i + 1]), torch.tensor(mask[i:i + 1]),
                        torch.tensor(seeds[i:i + 1]), config, adjust_logits=plain_case["torch"])
        want = {"tokens": solo.response_tokens[0].numpy(), "mask": solo.response_mask[0].numpy(),
                "logprobs": solo.response_logprobs[0].numpy(),
                "values": solo.response_values[0].numpy()}
        for path, got in harvests.items():
            _assert_rows({0: got[i]}, [want], ATOL, f"{path} row {i}")


def test_dense_engine_greedy_rows_and_reuse(models, plain_case, jax_plain):
    """Rows flagged greedy in a sampling dense engine decode greedily; a
    second collection on the same engine (slots recycled, the cache rows
    overwritten whole) harvests the same rows again."""
    _, target, _, tcfg = models
    ids, mask = _plain_prompts()
    engine = _plain_engine(tcfg, target, plain_case, "dense", GenerationConfig(
        **plain_case["config"](do_sample=True, temperature=0.7)))
    for _ in range(2):
        engine.begin_collection(target)
        base = engine._submitted
        engine.enqueue_prompts(ids, mask, np.arange(len(ids)) + 50, greedy=np.ones(len(ids), bool))
        got = {c.index - base: {f: getattr(c, f) for f in FIELDS} for c in engine.run()}
        _assert_rows(got, jax_plain["dense"], ATOL, "dense greedy rows")


# ---------------------------------------------------------------------------
# speculation with the prefix cache and chunked prefill
# ---------------------------------------------------------------------------

B, P, N, G = 2, 8, 10, 3


def _spec_prompts(R=5):
    """JAX ``tests/test_spec_engine.py``'s requests: row 4 repeats row 1's
    prompt, so the prefix cache hits."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 250, (R, P)).astype(np.int32)
    mask = np.ones((R, P), np.int32)
    mask[0, :3] = 0
    mask[2, :5] = 0
    ids[mask == 0] = PAD
    ids[4], mask[4] = ids[1], mask[1]
    return ids, mask


def _spec_config(**kw):
    base = dict(max_new_tokens=N, do_sample=True, temperature=0.7, eos_token_id=EOS,
                pad_token_id=PAD)
    base.update(kw)
    return base


def _spec_engine(tcfg, target, draft, config, block_size, chunk, kernel, draft_cfg=None,
                 transition_mask=None, segment_len=2):
    paged = PagedSpec(block_size, 1 + 3 * B * num_table_blocks(P + N + G, block_size))
    fns = make_slot_refill_fns(tcfg, B, P, config, segment_len=segment_len, paged=paged,
                               speculative=G, draft_cfg=draft_cfg or tcfg, device="cpu",
                               decode_kernel=kernel, prefill_kernel=kernel,
                               transition_mask=transition_mask)
    return ContinuousEngine(fns, (target, draft), PAD, prefix_cache=True, prefill_chunk=chunk)


def _port_solo(target, draft, ids, mask, seeds, config, transition_mask=None):
    refs = []
    for i in range(len(ids)):
        out = generate_speculative(target, draft, torch.tensor(ids[i:i + 1]),
                                   torch.tensor(mask[i:i + 1]), torch.tensor(seeds[i:i + 1]),
                                   config, gamma=G, transition_mask=transition_mask)
        refs.append({f: getattr(out, f"response_{f}")[0].numpy() for f in FIELDS})
    return refs


def _jax_solo(jm, ids, mask, cfg, transition_mask=None):
    """JAX's solo ``generate_speculative`` of each row (one jit)."""
    run = jax.jit(partial(
        jax_generate_speculative, jm["t_apply"], jm["t_params"], jm["d_apply"], jm["d_params"],
        jm["init"], jm["d_init"] if "d_init" in jm else jm["init"], config=cfg, gamma=G,
        transition_mask=None if transition_mask is None else jnp.asarray(transition_mask)))
    keys = _jax_keys(len(ids))
    refs = []
    for i in range(len(ids)):
        out = run(input_ids=jnp.asarray(ids[i:i + 1]), attention_mask=jnp.asarray(mask[i:i + 1]),
                  rng=jnp.asarray(keys[i:i + 1]))
        refs.append({f: np.asarray(getattr(out, f"response_{f}"))[0] for f in FIELDS})
    return refs


SPEC_CASES = [(4, 0, "pallas"), (4, 0, "xla"), (3, 4, "pallas"), (3, 4, "xla")]


@pytest.fixture(scope="module")
def sampled_refs(models):
    _, target, draft, _ = models
    ids, mask = _spec_prompts()
    seeds = np.arange(len(ids), dtype=np.int64) + 100
    return seeds, _port_solo(target, draft, ids, mask, seeds,
                             GenerationConfig(**_spec_config()))


@pytest.mark.parametrize("block_size,chunk,kernel", SPEC_CASES)
def test_spec_prefix_and_chunks_equal_port_solo(models, sampled_refs, block_size, chunk,
                                                kernel):
    _, target, draft, tcfg = models
    ids, mask = _spec_prompts()
    seeds, refs = sampled_refs
    engine = _spec_engine(tcfg, target, draft, GenerationConfig(**_spec_config()), block_size,
                          chunk, kernel)
    got = _harvest(engine, ids, mask, seeds)
    _assert_rows(got, refs, SOLO_ATOL, f"bs={block_size} chunk={chunk} {kernel}")
    m = engine.stats.metrics()
    assert m["engine/prefix_hit_rate"] > 0.0
    assert engine.stats.prefix_tokens_saved > 0
    assert (engine.stats.prefill_chunk_calls > 0) == bool(chunk)
    assert engine.stats.spec_committed > engine.stats.spec_rounds


SPEC_COUNTERS = ("spec_rounds", "spec_live_rounds", "spec_accepted", "spec_committed",
                 "prefix_lookup_blocks", "prefix_hit_blocks", "prefix_tokens_saved",
                 "refill_prefills", "refilled_rows", "prefill_tokens", "prefill_chunk_calls",
                 "harvested")


@pytest.fixture(scope="module")
def jax_greedy_spec(models):
    """JAX's greedy solo references, and its engine's counters per (block
    size, chunk)."""
    jm = models[0]
    ids, mask = _spec_prompts()
    cfg = JaxGenerationConfig(per_row_rng=True, **_spec_config(do_sample=False))
    refs = _jax_solo(jm, ids, mask, cfg)
    counters = {}
    for bs, chunk in {(bs, chunk) for bs, chunk, _ in SPEC_CASES}:
        paged = jax_paged_kv.PagedSpec(bs, 1 + 3 * B * num_table_blocks(P + N + G, bs))
        fns = jax_make_slot_refill_fns(jm["t_apply"], jm["init"], B, P, cfg, segment_len=2,
                                       paged=paged, speculative=G, draft_apply=jm["d_apply"],
                                       init_draft_cache_fn=jm["init"])
        engine = JaxContinuousEngine(fns, (jm["t_params"], jm["d_params"]), PAD,
                                     prefix_cache=True, prefill_chunk=chunk)
        engine.begin_collection(engine.params)
        got = _harvest(engine, ids, mask, _jax_keys(len(ids)))
        # JAX's engine agrees with its solo sampler to one f32 ulp here, not
        # bitwise (ROADMAP.md Queue 3)
        _assert_rows(got, refs, ATOL, f"jax engine bs={bs}")
        counters[(bs, chunk)] = {k: getattr(engine.stats, k) for k in SPEC_COUNTERS}
    return refs, counters


@pytest.mark.parametrize("block_size,chunk,kernel", SPEC_CASES)
def test_spec_prefix_and_chunks_match_jax(models, jax_greedy_spec, block_size, chunk, kernel):
    _, target, draft, tcfg = models
    ids, mask = _spec_prompts()
    refs, counters = jax_greedy_spec
    engine = _spec_engine(tcfg, target, draft, GenerationConfig(**_spec_config(do_sample=False)),
                          block_size, chunk, kernel)
    got = _harvest(engine, ids, mask, np.arange(len(ids)))
    _assert_rows(got, refs, ATOL, f"bs={block_size} chunk={chunk} {kernel}")
    assert engine.stats.prefix_hit_rate > 0.0
    assert {k: getattr(engine.stats, k) for k in SPEC_COUNTERS} == counters[(block_size, chunk)]


# ---------------------------------------------------------------------------
# the transition mask under speculation
# ---------------------------------------------------------------------------

def _absorbing_mask(V=259):
    """JAX ``test_transition_mask_parity``'s mask: tokens 0–63 may only be
    followed by eos."""
    tmask = np.ones((V, V), bool)
    tmask[0:64, :] = False
    tmask[0:64, EOS] = True
    return tmask


@pytest.fixture(scope="module")
def jax_masked(models):
    jm = models[0]
    ids, mask = _spec_prompts()
    cfg = JaxGenerationConfig(per_row_rng=True, **_spec_config(do_sample=False))
    refs = _jax_solo(jm, ids, mask, cfg, transition_mask=_absorbing_mask())
    assert len({int(r["mask"].sum()) for r in refs}) > 1  # heterogeneous lengths
    return refs


def test_transition_mask_solo_matches_jax(models, jax_masked):
    _, target, draft, _ = models
    ids, mask = _spec_prompts()
    tmask = _absorbing_mask()
    config = GenerationConfig(**_spec_config(do_sample=False))
    refs = _port_solo(target, draft, ids, mask, np.arange(len(ids)), config,
                      transition_mask=torch.tensor(tmask))
    _assert_rows(dict(enumerate(refs)), jax_masked, ATOL, "solo")
    # the whole batch at once: rows finish at different rounds
    out = generate_speculative(target, draft, torch.tensor(ids), torch.tensor(mask),
                               torch.arange(len(ids)), config, gamma=G, transition_mask=tmask)
    for i, w in enumerate(jax_masked):
        np.testing.assert_array_equal(out.response_tokens[i].numpy(), w["tokens"])
        np.testing.assert_allclose(out.response_logprobs[i].numpy(), w["logprobs"], atol=ATOL)


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_transition_mask_engine_matches_jax(models, jax_masked, kernel):
    _, target, draft, tcfg = models
    ids, mask = _spec_prompts()
    engine = _spec_engine(tcfg, target, draft, GenerationConfig(**_spec_config(do_sample=False)),
                          4, 0, kernel, transition_mask=_absorbing_mask())
    got = _harvest(engine, ids, mask, np.arange(len(ids)))
    _assert_rows(got, jax_masked, ATOL, f"engine {kernel}")


# ---------------------------------------------------------------------------
# a draft of another family: llama-test proposing for mistral-test
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def family_models():
    """A mistral-test value-head target (GQA, rotary, window 8) and a
    llama-test draft (vocabulary 259 both), f32."""
    jt = dataclasses.replace(JaxConfig.mistral("test"), dtype=jnp.float32)
    jd = dataclasses.replace(JaxConfig.llama("test"), dtype=jnp.float32)
    tt = TransformerConfig.mistral("test", dtype=torch.float32)
    td = TransformerConfig.llama("test", dtype=torch.float32)
    assert tt.sliding_window and tt.sliding_window < P + N + G
    t_params = _numpy_params(jt, seed=31, module_cls=JaxValueHeadLM)
    d_params = _numpy_params(jd, seed=32)
    t_mod, d_mod = JaxValueHeadLM(jt), JaxCausalTransformer(jd)
    target = CausalLMWithValueHead(tt).eval()
    target.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, t_params), tt))
    draft = CausalTransformer(td).eval()
    draft.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, d_params), td))
    jm = {"t_apply": lambda p, x, **kw: t_mod.apply({"params": p}, x, **kw),
          "d_apply": lambda p, x, **kw: d_mod.apply({"params": p}, x, **kw),
          "init": lambda b, s: jax_make_kv_cache(jt, b, s),
          "d_init": lambda b, s: jax_make_kv_cache(jd, b, s),
          "t_params": t_params, "d_params": d_params}
    ids, mask = _spec_prompts()
    refs = _jax_solo(jm, ids, mask, JaxGenerationConfig(per_row_rng=True,
                                                        **_spec_config(do_sample=False)))
    return target, draft, tt, td, refs


def test_family_draft_solo_matches_jax(family_models):
    target, draft, _, _, refs = family_models
    ids, mask = _spec_prompts()
    config = GenerationConfig(**_spec_config(do_sample=False))
    got = _port_solo(target, draft, ids, mask, np.arange(len(ids)), config)
    _assert_rows(dict(enumerate(got)), refs, ATOL, "family solo")
    # greedy speculation is exact for any draft
    plain = generate(target, torch.tensor(ids), torch.tensor(mask), torch.arange(len(ids)),
                     config)
    for i, r in enumerate(got):
        np.testing.assert_array_equal(r["tokens"], plain.response_tokens[i].numpy())


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_family_draft_engine_matches_jax(family_models, kernel):
    target, draft, tt, td, refs = family_models
    ids, mask = _spec_prompts()
    engine = _spec_engine(tt, target, draft, GenerationConfig(**_spec_config(do_sample=False)),
                          3, 4, kernel, draft_cfg=td)
    # the draft's dense cache takes the draft's geometry (its own KV heads)
    assert engine.state.d_cache[0]["k"].shape == (B, P + N + G, td.kv_heads, td.dims_per_head)
    assert len(engine.state.d_cache) == td.num_layers
    got = _harvest(engine, ids, mask, np.arange(len(ids)))
    _assert_rows(got, refs, ATOL, f"family engine {kernel}")
    assert engine.stats.prefix_hit_rate > 0.0 and engine.stats.prefill_chunk_calls > 0
