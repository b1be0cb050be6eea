"""The port's speculative sampler (``trlx_tpu_torch/ops/speculative.py``)
against the JAX package, on the CPU: ``builtin:gpt2-test`` in f32 (a
value-head target and a bare draft of other weights), weights carried from
JAX through ``params_from_jax``.

- ``accept_and_extra``, fed the acceptance uniforms and the Gumbel noise
  that JAX draws from the same per-row keys (``split_row_keys`` then
  ``uniform``, and the ``gumbel`` call ``categorical`` makes), accepts the
  same number of draft tokens and draws the same extra token as JAX's; its
  committed-token marginal is the target distribution exactly (JAX
  ``test_acceptance_rule_is_distribution_exact``, ported);
- greedy ``generate_speculative`` (B=2, P=8, N=10, G=3) equals JAX's
  (tokens and mask equal, logprobs and values at 1e-5) and the port's plain
  greedy ``generate``;
- sampled rows depend only on their own seed: a batched run draws each
  row's tokens as the row run alone does (the counter-hash draws).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_transformer import _numpy_params
from trlx_tpu.models.heads import CausalLMWithValueHead as JaxValueHeadLM
from trlx_tpu.models.transformer import CausalTransformer as JaxCausalTransformer
from trlx_tpu.models.transformer import TransformerConfig as JaxConfig
from trlx_tpu.models.transformer import make_kv_cache as jax_make_kv_cache
from trlx_tpu.ops.sampling import GenerationConfig as JaxGenerationConfig
from trlx_tpu.ops.sampling import per_row_keys, split_row_keys
from trlx_tpu.ops.speculative import accept_and_extra as jax_accept_and_extra
from trlx_tpu.ops.speculative import generate_speculative as jax_generate_speculative
from trlx_tpu_torch.models.heads import CausalLMWithValueHead
from trlx_tpu_torch.models.transformer import CausalTransformer, TransformerConfig
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.ops.sampling import GenerationConfig, generate
from trlx_tpu_torch.ops.speculative import accept_and_extra, generate_speculative
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

ATOL = 1e-5
PAD = 258
B, P, N, G = 2, 8, 10, 3


def spec_models(target_seed=21, draft_seed=22):
    """``(jax, torch)`` model pairs: a value-head target and a bare draft,
    each with its own numpy weights, as apply functions on the JAX side."""
    jcfg = dataclasses.replace(JaxConfig.gpt2("test"), dtype=jnp.float32)
    tcfg = TransformerConfig.gpt2("test", dtype=torch.float32)
    t_params = _numpy_params(jcfg, seed=target_seed, module_cls=JaxValueHeadLM)
    d_params = _numpy_params(jcfg, seed=draft_seed)
    t_mod, d_mod = JaxValueHeadLM(jcfg), JaxCausalTransformer(jcfg)
    target = CausalLMWithValueHead(tcfg).eval()
    target.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, t_params), tcfg))
    draft = CausalTransformer(tcfg).eval()
    draft.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, d_params), tcfg))
    jax_side = {
        "t_apply": lambda p, x, **kw: t_mod.apply({"params": p}, x, **kw),
        "d_apply": lambda p, x, **kw: d_mod.apply({"params": p}, x, **kw),
        "init": lambda b, s: jax_make_kv_cache(jcfg, b, s),
        "t_params": t_params, "d_params": d_params, "jitted": {},
    }
    return jax_side, target, draft, tcfg


def jax_solo(jm, ids, mask, keys, cfg, gamma=G):
    """JAX ``generate_speculative`` under one jit (the solo reference),
    compiled once per models, config and gamma."""
    key = (cfg, gamma)
    if key not in jm["jitted"]:
        jm["jitted"][key] = jax.jit(partial(
            jax_generate_speculative, jm["t_apply"], jm["t_params"], jm["d_apply"],
            jm["d_params"], jm["init"], jm["init"], config=cfg, gamma=gamma))
    return jm["jitted"][key](input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                             rng=jnp.asarray(keys))


@pytest.fixture(scope="module")
def models():
    return spec_models()


def _dists(rs, rows, n, V):
    x = rs.randn(rows, n, V).astype(np.float32) * 1.5
    x[..., 0] -= 30.0  # a token the distributions (nearly) never give
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("do_sample", [True, False])
def test_accept_and_extra_matches_jax_on_jax_draws(do_sample):
    rows, V = 64, 11
    rs = np.random.RandomState(0)
    p = _dists(rs, rows, G + 1, V)
    q = _dists(rs, rows, G, V)
    # proposals drawn from q, the first r % (G + 1) of row r copied from p's
    # argmax (accepted greedily)
    d = np.asarray([[rs.choice(V, p=q[r, j] / q[r, j].sum()) for j in range(G)]
                    for r in range(rows)], np.int32)
    best = np.argmax(p[:, :G], axis=-1)
    for r in range(rows):
        d[r, : r % (G + 1)] = best[r, : r % (G + 1)]
    keys = per_row_keys(jax.random.PRNGKey(0), rows)
    jk, jextra, _ = jax_accept_and_extra(jnp.asarray(p), jnp.asarray(q), jnp.asarray(d),
                                         keys, do_sample)
    u = g = None
    if do_sample:
        rng, ru = split_row_keys(keys)
        u = torch.tensor(np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (G,)))(ru)))
        _, re = split_row_keys(rng)
        g = torch.tensor(np.asarray(jax.vmap(
            lambda kk: jax.random.gumbel(kk, (V,), jnp.float32))(re)))
    k, extra = accept_and_extra(torch.tensor(p), torch.tensor(q), torch.tensor(d), u, g,
                                do_sample)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(extra.numpy(), np.asarray(jextra))
    # every outcome occurs: full accepts (bonus draws) and rejections at each depth
    assert set(np.asarray(jk).tolist()) == set(range(G + 1))


def test_acceptance_rule_is_distribution_exact():
    """For G=1 the first committed token is d_1 if accepted, else the
    residual resample; its marginal must be p_0 exactly (Monte Carlo over
    the pure rule within binomial noise), and a token p_0 gives
    probability 0 is never committed."""
    V, rows = 5, 40_000
    rs = np.random.RandomState(0)
    p0 = np.asarray([0.5, 0.0, 0.2, 0.25, 0.05])
    p1 = np.ones(V) / V  # the bonus distribution (irrelevant to x_0)
    q1 = np.asarray([0.1, 0.4, 0.1, 0.15, 0.25])
    p_probs = torch.tensor(np.stack([p0, p1]), dtype=torch.float32).expand(rows, 2, V)
    q_probs = torch.tensor(q1[None], dtype=torch.float32).expand(rows, 1, V)
    d = torch.tensor(rs.choice(V, size=(rows, 1), p=q1))
    u = torch.tensor(rs.rand(rows, 1), dtype=torch.float32)
    g = torch.tensor(-np.log(-np.log(rs.uniform(1e-12, 1.0, (rows, V)))), dtype=torch.float32)
    k, extra = accept_and_extra(p_probs, q_probs, d, u, g, True)
    x0 = torch.where(k >= 1, d[:, 0], extra).numpy()
    freq = np.bincount(x0, minlength=V) / rows
    bound = 4 * np.sqrt(np.maximum(p0 * (1 - p0), 1e-4) / rows)
    assert np.all(np.abs(freq - p0) <= bound), (freq, p0, bound)
    assert freq[1] == 0.0, freq


def _prompts(rows=B, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 250, (rows, P)).astype(np.int32)
    mask = np.ones((rows, P), np.int32)
    mask[0, :3] = 0
    ids[mask == 0] = PAD
    return ids, mask


def test_greedy_generate_speculative_matches_jax_and_plain(models):
    jm, target, draft, _ = models
    ids, mask = _prompts()
    jcfg = JaxGenerationConfig(max_new_tokens=N, do_sample=False, eos_token_id=None,
                               pad_token_id=PAD)
    want = jax_solo(jm, ids, mask, jax.random.PRNGKey(0), jcfg)
    cfg = GenerationConfig(max_new_tokens=N, do_sample=False, eos_token_id=None,
                           pad_token_id=PAD)
    got, stats = generate_speculative(target, draft, torch.tensor(ids), torch.tensor(mask),
                                      torch.arange(B), cfg, gamma=G, return_stats=True)
    np.testing.assert_array_equal(got.response_tokens.numpy(), np.asarray(want.response_tokens))
    np.testing.assert_array_equal(got.response_mask.numpy(), np.asarray(want.response_mask))
    for f in ("response_logprobs", "response_values"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=ATOL, rtol=0, err_msg=f)
    assert np.abs(got.response_values.numpy()).max() > 0
    # greedy speculation is exact for any draft: the plain greedy decode
    plain = generate(target, torch.tensor(ids), torch.tensor(mask), torch.arange(B), cfg)
    np.testing.assert_array_equal(got.response_tokens.numpy(), plain.response_tokens.numpy())
    for f in ("response_logprobs", "response_values"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(plain, f).numpy(),
                                   atol=ATOL, rtol=0, err_msg=f)
    # a different draft: fewer than G + 1 tokens per round, more than one
    assert 1.0 <= stats["tokens_per_round"] < G + 1 and stats["rounds"] > N // (G + 1)


def test_sampled_rows_depend_only_on_their_seed(models):
    _, target, draft, _ = models
    ids, mask = _prompts(rows=3, seed=1)
    cfg = GenerationConfig(max_new_tokens=N, do_sample=True, temperature=0.8, top_k=40,
                           eos_token_id=None, pad_token_id=PAD)
    seeds = torch.tensor([7, 8, 9])
    both = generate_speculative(target, draft, torch.tensor(ids), torch.tensor(mask), seeds,
                                cfg, gamma=G)
    for i in range(3):
        solo = generate_speculative(target, draft, torch.tensor(ids[i:i + 1]),
                                    torch.tensor(mask[i:i + 1]), seeds[i:i + 1], cfg, gamma=G)
        for f in ("response_tokens", "response_mask"):
            torch.testing.assert_close(getattr(both, f)[i], getattr(solo, f)[0], atol=0, rtol=0)
        # the CPU's GEMMs round by row count: floats agree to 1e-6, not bitwise
        for f in ("response_logprobs", "response_values"):
            torch.testing.assert_close(getattr(both, f)[i], getattr(solo, f)[0], atol=1e-6,
                                       rtol=0)
    other = generate_speculative(target, draft, torch.tensor(ids), torch.tensor(mask),
                                 seeds + 100, cfg, gamma=G)
    assert not torch.equal(other.response_tokens, both.response_tokens)


def test_sampler_hooks_raise(models):
    """The hooks used to raise here; they now run (JAX parity in
    ``tests/test_torch_engine_paths.py``). An all-allowing mask and an
    identity hook leave the draws as they are; a mask that allows only
    token 5 after every token, and a hook that forbids token 5 with the
    mask allowing it and one other, each steer every committed token."""
    _, target, draft, _ = models
    ids, mask = _prompts()
    cfg = GenerationConfig(max_new_tokens=6, do_sample=True, temperature=0.9,
                           eos_token_id=None, pad_token_id=PAD)
    args = (target, draft, torch.tensor(ids), torch.tensor(mask), torch.arange(B), cfg)
    free = generate_speculative(*args, gamma=G)
    same = generate_speculative(*args, gamma=G,
                                transition_mask=torch.ones(259, 259, dtype=torch.bool),
                                adjust_logits=lambda step_out, logits: logits)
    for f in ("response_tokens", "response_logprobs", "response_values"):
        torch.testing.assert_close(getattr(same, f), getattr(free, f), atol=0, rtol=0)
    only5 = torch.zeros(259, 259, dtype=torch.bool)
    only5[:, 5] = True
    forced = generate_speculative(*args, gamma=G, transition_mask=only5)
    assert bool((forced.response_tokens == 5).all())
    assert torch.allclose(forced.response_logprobs, torch.zeros(()), atol=1e-6)
    two = torch.zeros(259, 259, dtype=torch.bool)
    two[:, 5] = two[:, 7] = True

    def no5(step_out, logits):
        assert step_out["last_tokens"].shape == logits.shape[:-1]
        return logits.masked_fill(torch.arange(logits.shape[-1]) == 5, -1e9)

    steered = generate_speculative(*args, gamma=G, transition_mask=two, adjust_logits=no5)
    assert bool((steered.response_tokens == 7).all())
