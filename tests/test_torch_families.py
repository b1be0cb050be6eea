"""The dense model families of the port (``trlx_tpu_torch/models``: llama,
mistral, gptj, gptneox, opt, bloom) against the JAX ``CausalTransformer``
on the CPU, each family's ``test`` preset at f32.

Weights come from one numpy tree per family (``_numpy_params``, carried
over with ``params_from_jax``), inputs from a seed. Held at ``atol=1e-4``,
as ``tests/test_torch_transformer.py`` holds GPT-2:

- the full pass over left-padded rows, on the bias path and on the flash
  branch (the port's wrappers run their plain versions here; the JAX side
  runs its Pallas kernel in interpret mode, as
  ``tests/test_torch_flash_attention.py`` does);
- the same full pass in bf16 over the f32 weights, against the JAX module's
  own bf16 pass (``BF16_ATOL``, and a mean error against f32 no larger than
  ``BF16_MEAN_RATIO`` times JAX's);
- dense-cache and paged-cache incremental decode (a prompt prefill, then
  one token a step) against the JAX full pass over the same tokens;
- greedy decoding through the port's paged ``ContinuousEngine``, token for
  token against JAX ``generate`` (prompts of 12 tokens, so mistral-test's
  window of 8 bites in prefill and decode);
- the value-head policy, its ``branch_input`` and the hydra branch replay
  with rotary positions (the frozen ``HydraBranch`` copy and
  ``forward_branch``) against JAX ``forward_branch`` on the JAX
  ``hydra_ref_params`` tree;
- one PPO train step on mistral-test at shared weights (loss and stats at
  ``rtol=1e-4``, the updated weights at ``atol=1e-4``).

Beside those: every preset size the JAX package gives builds the same
config in the port (mixtral's MoE fields included; ``tests/test_torch_moe.py``
holds the MoE model against JAX), and the builder's streamed seeded init
gives the state dict of the old in-place rule bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ppo_trainer import _config_dict, reward_fn
from tests.test_torch_transformer import _Jitted, _numpy_params
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.models.builder import hydra_ref_params as jax_hydra_ref_params
from trlx_tpu.models.heads import CausalLMWithValueHead as JaxValueHeadLM
from trlx_tpu.models.transformer import CausalTransformer as JaxCausalTransformer
from trlx_tpu.models.transformer import TransformerConfig as JaxConfig
from trlx_tpu.models.transformer import alibi_slopes as jax_alibi_slopes
from trlx_tpu.models.transformer import config_from_spec as jax_config_from_spec
from trlx_tpu.models.transformer import make_kv_cache as jax_make_kv_cache
from trlx_tpu.ops.sampling import GenerationConfig as JaxGenerationConfig
from trlx_tpu.ops.sampling import generate as jax_generate
from trlx_tpu.trainer.ppo import PPOTrainer as JaxPPOTrainer
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.engine.core import ContinuousEngine
from trlx_tpu_torch.models.builder import build_causal_lm, hydra_ref_params, trainable_mask
from trlx_tpu_torch.models.heads import CausalLMWithValueHead
from trlx_tpu_torch.models.transformer import (
    CausalTransformer,
    TransformerConfig,
    alibi_slopes,
    config_from_spec,
    make_kv_cache,
)
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.ops.paged_kv import PagedSpec, attach_block_table, num_table_blocks
from trlx_tpu_torch.ops.sampling import GenerationConfig
from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns
from trlx_tpu_torch.trainer.base import host_stats
from trlx_tpu_torch.trainer.ppo import PPOTrainer

ATOL = 1e-4
# bf16 against bf16: the test presets' logits stay below 2 in magnitude,
# where one bf16 step is at most 2^-7; two bf16 passes that round at the
# same places differ by about one step where a rounding falls the other way
BF16_ATOL = 1e-2
# the port's mean bf16 error against f32 over JAX bf16's (0.94-1.05 read)
BF16_MEAN_RATIO = 1.25
FAMILIES = ("llama", "mistral", "gptj", "gptneox", "opt", "bloom")
# every size of the JAX presets (trlx_tpu/models/transformer.py:253-395)
PRESET_SIZES = {
    "gpt2": ("test", "small", "medium", "large", "xl"),
    "llama": ("test", "7b", "13b", "65b"),
    "mistral": ("test", "7b"),
    "gptj": ("test", "6b"),
    "gptneox": ("test", "160m", "1.4b", "6.9b", "20b"),
    "pythia": ("test", "160m", "1.4b", "6.9b", "20b"),
    "opt": ("test", "125m", "6.7b"),
    "bloom": ("test", "560m"),
    "mixtral": ("test", "8x7b"),
}
P, N = 12, 6  # prompt width (> mistral-test's window of 8) and new tokens


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request):
    """One family at f32: the JAX value-head module and its numpy tree, the
    port's bare LM and value-head policy on the same weights."""
    name = request.param
    jcfg = dataclasses.replace(getattr(JaxConfig, name)("test"), dtype=jnp.float32)
    params = jax.tree_util.tree_map(
        np.asarray, _numpy_params(jcfg, seed=len(name), module_cls=JaxValueHeadLM))
    tcfg = config_from_spec(f"builtin:{name}-test", dtype=torch.float32)
    lm = CausalTransformer(tcfg).eval()
    lm.load_state_dict(params_from_jax(params["backbone"], tcfg), strict=True)
    policy = CausalLMWithValueHead(tcfg).eval()
    policy.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return dict(name=name, jcfg=jcfg, params=params, tcfg=tcfg, lm=lm, policy=policy,
                jm=_Jitted(JaxCausalTransformer(jcfg)))


def _prompts(V, B=3, width=P, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, V, (B, width)).astype(np.int32)
    mask = np.ones_like(ids)
    for b in range(B):  # left padding of 0, 3, 1 columns
        mask[b, : (0, 3, 1)[b % 3]] = 0
    return ids, mask


def _flash_copy(model):
    flash = type(model)(dataclasses.replace(model.config, attention_impl="pallas")).eval()
    flash.load_state_dict(model.state_dict())
    return flash


def test_config_presets_match_jax():
    jax_fields = {f.name for f in dataclasses.fields(JaxConfig)}
    shared = [f.name for f in dataclasses.fields(TransformerConfig)
              if f.name in jax_fields and f.name not in ("dtype", "param_dtype",
                                                        "attention_impl")]
    assert {"rotary_dim", "rope_theta", "sliding_window", "parallel_residual", "shared_ln",
            "embedding_layernorm", "lm_head_bias", "num_experts", "num_experts_per_tok",
            "moe_capacity_factor", "moe_group_size", "moe_renormalize", "router_aux_coef",
            "router_z_coef"} <= set(shared)
    for family, sizes in PRESET_SIZES.items():
        for size in sizes:
            ours = config_from_spec(f"builtin:{family}-{size}")
            theirs = jax_config_from_spec(f"builtin:{family}-{size}")
            for field in shared:
                assert getattr(ours, field) == getattr(theirs, field), (family, size, field)
    for n in (4, 12, 16, 20, 25, 32, 64):  # non-powers of two take the interleave
        np.testing.assert_allclose(alibi_slopes(n), jax_alibi_slopes(n), rtol=1e-15)


def _old_rule_state(spec, seed, head):
    """The builder's rule before streamed init: construct on the CPU (the
    default init runs), then draw every tensor in place from the seeded
    generator — zero biases, unit ``.ln_*`` / ``ln_f`` scales, normal(0.02)
    for the rest (the value head's tensors included)."""
    cfg = config_from_spec(spec)
    model = CausalLMWithValueHead(cfg) if head == "value" else CausalTransformer(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            inner = name.removeprefix("backbone.")
            if name.endswith("bias"):
                p.zero_()
            elif ".ln_" in inner or inner.startswith("ln_f"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return model.state_dict()


@pytest.mark.parametrize("spec", ["builtin:gpt2-test", "builtin:llama-test"])
@pytest.mark.parametrize("head", [None, "value"])
def test_streamed_init_matches_the_old_rule(spec, head):
    new, _ = build_causal_lm(spec, seed=5, device="cpu", head=head)
    old = _old_rule_state(spec, 5, head)
    got = new.state_dict()
    assert list(got) == list(old)
    for k, v in old.items():
        assert torch.equal(got[k], v), k
    assert all(p.device.type == "cpu" for p in new.parameters())


def test_family_init_scales_norms_and_zeroes_biases():
    bloom, _ = build_causal_lm("builtin:bloom-test", seed=1, device="cpu")
    assert torch.equal(bloom.emb_ln.weight, torch.ones_like(bloom.emb_ln.weight))
    assert not hasattr(bloom, "wpe")
    gptj, _ = build_causal_lm("builtin:gptj-test", seed=1, device="cpu")
    assert gptj.blocks[0].ln_mlp is None and float(gptj.lm_head.bias.abs().max()) == 0.0
    llama, _ = build_causal_lm("builtin:llama-test", seed=1, device="cpu")
    assert torch.equal(llama.blocks[0].ln_attn.weight, torch.ones(64))
    assert llama.blocks[0].mlp.gate_proj.weight.std() > 0.01


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_full_pass_left_padded(fam, impl):
    jcfg, params = fam["jcfg"], fam["params"]
    jm = fam["jm"] if impl == "xla" else _Jitted(JaxCausalTransformer(
        dataclasses.replace(jcfg, attention_impl="pallas")))
    model = fam["lm"] if impl == "xla" else _flash_copy(fam["lm"])
    ids, mask = _prompts(jcfg.vocab_size, width=14)
    want = jm.apply({"params": params["backbone"]}, jnp.asarray(ids),
                    attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.tensor(ids), attention_mask=torch.tensor(mask))
    # flash: pad queries see no key (out 0 vs a uniform row); bias: all rows
    rows = mask.astype(bool) if impl == "pallas" else np.ones_like(mask, bool)
    for key in ("logits", "hidden_states"):
        np.testing.assert_allclose(got[key].numpy()[rows], np.asarray(want[key])[rows],
                                   atol=ATOL, rtol=0, err_msg=key)


def test_bf16_logits_match_jax_bf16(fam):
    """bf16 compute over the f32 master weights (the served and trained
    dtype): the port's full-pass logits, on the bias path and on the flash
    branch, against the JAX module's own bf16 pass within ``BF16_ATOL``;
    and the port's bf16 rounding costs no more than JAX's: its mean error
    against JAX's f32 logits stays within ``BF16_MEAN_RATIO`` of JAX bf16's."""
    jcfg, params, lm = fam["jcfg"], fam["params"], fam["lm"]
    ids, mask = _prompts(jcfg.vocab_size, width=14)
    real = mask.astype(bool)
    want = {}
    for name, jm in (("bf16", _Jitted(JaxCausalTransformer(dataclasses.replace(
            jcfg, dtype=jnp.bfloat16)))), ("f32", fam["jm"])):
        out = jm.apply({"params": params["backbone"]}, jnp.asarray(ids),
                       attention_mask=jnp.asarray(mask))
        want[name] = np.asarray(out["logits"], np.float32)[real]
    jax_err = np.abs(want["bf16"] - want["f32"]).mean()
    for impl in ("xla", "pallas"):
        cfg16 = dataclasses.replace(fam["tcfg"], dtype=torch.bfloat16, attention_impl=impl)
        model = CausalTransformer(cfg16).eval()
        model.load_state_dict(lm.state_dict())
        with torch.no_grad():
            got = model(torch.tensor(ids), attention_mask=torch.tensor(mask))["logits"]
        got = got.float().numpy()[real]
        np.testing.assert_allclose(got, want["bf16"], atol=BF16_ATOL, rtol=0, err_msg=impl)
        assert np.abs(got - want["f32"]).mean() <= BF16_MEAN_RATIO * jax_err, impl


@pytest.mark.parametrize("cache_kind", ["dense", "paged"])
def test_incremental_decode_matches_the_full_pass(fam, cache_kind):
    """Prompt prefill into the cache, then one token a step at its own
    position (paged: per-row ``[B]`` cache indices through block tables of
    3-slot blocks with stale pool values), against the JAX full pass over
    prompt ‖ continuation."""
    jcfg, params, model = fam["jcfg"], fam["params"], fam["lm"]
    ids, mask = _prompts(jcfg.vocab_size, seed=1)
    B = ids.shape[0]
    cont = np.random.RandomState(2).randint(0, jcfg.vocab_size, (B, N)).astype(np.int32)
    full_ids = np.concatenate([ids, cont], axis=1)
    full_mask = np.concatenate([mask, np.ones_like(cont)], axis=1)
    want = np.asarray(fam["jm"].apply({"params": params["backbone"]}, jnp.asarray(full_ids),
                                      attention_mask=jnp.asarray(full_mask))["logits"])
    S = P + N
    slot_mask = np.concatenate([mask, np.zeros((B, N), np.int32)], axis=1)
    if cache_kind == "dense":
        cache = make_kv_cache(model.config, B, S)
        index = lambda c: c  # noqa: E731
    else:
        bs = 3
        TB = num_table_blocks(S, bs)
        pool = make_kv_cache(model.config, 1 + B * TB, bs)
        gen = torch.Generator().manual_seed(0)
        for layer in pool:  # stale values everywhere: masking must hide them
            layer["k"].normal_(generator=gen)
            layer["v"].normal_(generator=gen)
        table = torch.tensor(np.random.RandomState(3).permutation(np.arange(1, 1 + B * TB))
                             .reshape(B, TB), dtype=torch.int32)
        cache = attach_block_table(pool, table)
        index = lambda c: torch.full((B,), c)  # noqa: E731
    real = mask.astype(bool)
    with torch.no_grad():
        out = model(torch.tensor(ids), attention_mask=torch.tensor(slot_mask), cache=cache,
                    cache_index=0)
        np.testing.assert_allclose(out["logits"].numpy()[real], want[:, :P][real],
                                   atol=ATOL, rtol=0, err_msg="prefill")
        for step in range(N):
            slot_mask[:, P + step] = 1
            pos = (mask.sum(1) + step)[:, None]
            out = model(torch.tensor(cont[:, step:step + 1]),
                        attention_mask=torch.tensor(slot_mask), positions=torch.tensor(pos),
                        cache=cache, cache_index=index(P + step))
            np.testing.assert_allclose(out["logits"].numpy()[:, 0], want[:, P + step],
                                       atol=ATOL, rtol=0, err_msg=f"step {step}")


def test_greedy_engine_matches_jax_generate(fam):
    """More prompts than slots (refills), greedy, 4-slot blocks."""
    jcfg, params, model, tcfg = fam["jcfg"], fam["params"], fam["lm"], fam["tcfg"]
    eos, pad = 3, tcfg.vocab_size - 1
    prompts, masks = _prompts(200, B=5, seed=4)
    prompts[~masks.astype(bool)] = pad
    module = JaxCausalTransformer(jcfg)
    jconfig = JaxGenerationConfig(max_new_tokens=N, eos_token_id=eos, pad_token_id=pad,
                                  do_sample=False)
    run = jax.jit(lambda p, i, m: jax_generate(
        lambda pp, x, **kw: module.apply({"params": pp}, x, **kw), p,
        lambda b, s: jax_make_kv_cache(jcfg, b, s), i, m, jax.random.PRNGKey(0), jconfig))
    want = run(params["backbone"], jnp.asarray(prompts), jnp.asarray(masks))
    tokens = np.asarray(want.response_tokens)  # pad after eos

    config = GenerationConfig(max_new_tokens=N, eos_token_id=eos, pad_token_id=pad,
                              do_sample=False)
    bs, slots = 4, 2
    paged = PagedSpec(bs, 1 + 2 * slots * num_table_blocks(P + N, bs) + 4)
    fns = make_slot_refill_fns(tcfg, slots, P, config, segment_len=3, paged=paged,
                               device="cpu")
    engine = ContinuousEngine(fns, model, pad)
    engine.enqueue_prompts(prompts, masks, np.arange(len(prompts)))
    got = {c.index: c for c in engine.run()}
    assert sorted(got) == list(range(len(prompts)))
    for i, c in got.items():
        np.testing.assert_array_equal(c.tokens, tokens[i], err_msg=f"prompt {i}")


def test_value_head_and_hydra_branch_match_jax(fam):
    jcfg, params, tcfg, policy = fam["jcfg"], fam["params"], fam["tcfg"], fam["policy"]
    module = JaxValueHeadLM(jcfg)
    ids, mask = _prompts(jcfg.vocab_size, seed=7)
    span = (2, P - 1)
    want = jax.jit(lambda p, i, m: module.apply({"params": p}, i, attention_mask=m,
                                                branch_layer=1, logits_span=span))(
        params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = policy(torch.tensor(ids), attention_mask=torch.tensor(mask), branch_layer=1,
                     logits_span=span)
    for key in ("value", "logits", "branch_input"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, rtol=0,
                                   err_msg=key)
    # the top block replayed with frozen reference weights (rotary positions
    # from the mask): the JAX subtree, the port's snapshot and the policy's
    # own forward_branch, on the bias path and the flash branch
    ref_tree = jax.tree_util.tree_map(np.asarray, jax_hydra_ref_params(params, jcfg, 1))
    want_ref = jax.jit(lambda r, h, m: module.apply(
        {"params": {"backbone": r}}, h, 1, m, None, span,
        method=JaxValueHeadLM.forward_branch))(ref_tree, want["branch_input"], jnp.asarray(mask))
    snapshot = hydra_ref_params(policy, tcfg, 1)
    assert snapshot.state_dict().keys() == params_from_jax(ref_tree, tcfg).keys()
    flash = _flash_copy(policy)
    flash_snapshot = hydra_ref_params(flash, flash.config, 1)
    real = mask.astype(bool)[:, span[0]:span[1]]
    with torch.no_grad():
        outs = [snapshot(got["branch_input"], torch.tensor(mask), None, span),
                policy.forward_branch(got["branch_input"], 1, torch.tensor(mask), None, span),
                flash_snapshot(got["branch_input"], torch.tensor(mask), None, span)]
    for i, out in enumerate(outs):
        np.testing.assert_allclose(out["logits"].numpy()[real],
                                   np.asarray(want_ref["logits"])[real], atol=ATOL, rtol=0,
                                   err_msg=f"branch {i}")
    mask_of = trainable_mask(policy, tcfg, 1)
    names = [k for k in mask_of if k.startswith("backbone.") and ".blocks." not in k]
    assert names and all(mask_of[k] for k in names)  # wte, emb_ln, ln_f, lm_head
    assert not any(mask_of[k] for k in mask_of if k.startswith("backbone.blocks.0."))
    assert all(mask_of[k] for k in mask_of if k.startswith("backbone.blocks.1."))


def test_ppo_train_step_matches_jax_on_mistral(tmp_path):
    """One PPO step on one batch at shared weights: loss and stats, then
    the updated parameters (``num_layers_unfrozen: 1``)."""
    d = _config_dict(tmp_path)
    d["model"]["model_path"] = "builtin:mistral-test"
    jax_trainer = JaxPPOTrainer(config=JaxTRLConfig.from_dict(d), reward_fn=reward_fn)
    params0 = jax.tree_util.tree_map(np.asarray, jax_trainer.state.params)
    trainer = PPOTrainer(config=TRLConfig.from_dict(d), reward_fn=reward_fn, device="cpu")
    trainer.model.load_state_dict(params_from_jax(params0, trainer.tcfg), strict=True)

    rs = np.random.RandomState(0)
    B, Q, R = 4, 10, 8  # prompts past the window of 8
    qmask = np.ones((B, Q), np.int32)
    rmask = np.ones((B, R), np.int32)
    for b in range(B):
        qmask[b, : b % 3] = 0
        rmask[b, R - b:] = 0
    fmask = rmask.astype(np.float32)
    batch = {
        "query_tensors": rs.randint(0, 250, (B, Q)).astype(np.int32) * qmask,
        "query_mask": qmask,
        "response_tensors": rs.randint(0, 250, (B, R)).astype(np.int32) * rmask,
        "response_mask": rmask,
        "logprobs": (rs.randn(B, R) * 0.1 - 5.6).astype(np.float32) * fmask,
        "values": (rs.randn(B, R) * 0.1).astype(np.float32) * fmask,
        "rewards": (rs.randn(B, R) * 0.5).astype(np.float32) * fmask,
    }
    want = {k: float(v) for k, v in jax_trainer.train_step(batch).items()
            if np.ndim(v) == 0}
    got = host_stats(trainer.train_step(batch))
    keys = [k for k in want if k.startswith(("losses/", "policy/", "values/", "returns/"))
            or k in ("ratio", "learning_rate", "gradients/global_norm")]
    assert len(keys) > 15 and "losses/total_loss" in keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    after = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_trainer.state.params),
                            trainer.tcfg)
    before = params_from_jax(params0, trainer.tcfg)
    state = trainer.model.state_dict()
    for k, v in after.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=ATOL, rtol=0, err_msg=k)
    assert not torch.equal(state["backbone.blocks.1.attn.q_proj.weight"],
                           before["backbone.blocks.1.attn.q_proj.weight"])
    assert torch.equal(state["backbone.blocks.0.attn.q_proj.weight"],
                       before["backbone.blocks.0.attn.q_proj.weight"])
