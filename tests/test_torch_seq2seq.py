"""The port's T5 encoder-decoder (``trlx_tpu_torch/models/seq2seq.py``,
the seq2seq wrappers of ``models/heads.py``, the seq2seq builder functions
and ``seq2seq_params_from_jax``, ``ops/sampling.py::generate_seq2seq``)
against the JAX package, on the CPU, in f32.

The JAX side runs as ``tests/test_seq2seq.py`` runs it; both presets'
``test`` sizes (2 + 2 layers, E 64, 8 buckets at a max distance of 20, so
the log branch of the buckets is hit). Held:

- ``relative_position_bucket`` equals JAX's exactly for every offset in
  [-2048, 2048], both directions, at (8, 20) and (32, 128);
- the presets of every size equal JAX's field for field; a checkpoint
  path and an unknown family raise;
- ``params_from_jax`` on a value-head policy, an ILQL policy and one with
  LoRA on every decoder projection: encoder states, logits, values and the
  ILQL heads within ``REL`` of the largest |value|, with padded encoder
  rows (right and left) and a padded decoder mask; the encoder has no
  adapters;
- cached decode equals the full decoder pass within the same bound;
- ``forward_branch`` at k = 1 on the hydra copy
  (``seq2seq_hydra_ref_params``) equals JAX's;
- ``seq2seq_trainable_mask`` equals JAX's leaf for leaf at k in {-1, 0, 1},
  with and without LoRA, for the value-head and ILQL policies;
- greedy ``generate_seq2seq`` equals JAX's token for token (with an eos
  that stops the rows at different steps), its logprobs and values within
  ``REL``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelConfig as JaxModelConfig
from trlx_tpu.models.builder import build_seq2seq_lm as jax_build_seq2seq_lm
from trlx_tpu.models.builder import seq2seq_hydra_ref_params as jax_hydra_ref_params
from trlx_tpu.models.builder import seq2seq_trainable_mask as jax_trainable_mask
from trlx_tpu.models.heads import Seq2SeqLMWithValueHead as JaxValueHead
from trlx_tpu.models.seq2seq import Seq2SeqConfig as JaxSeq2SeqConfig
from trlx_tpu.models.seq2seq import relative_position_bucket as jax_bucket
from trlx_tpu.ops.sampling import GenerationConfig as JaxGenerationConfig
from trlx_tpu.ops.sampling import generate_seq2seq as jax_generate_seq2seq
from trlx_tpu_torch.models.builder import (
    build_seq2seq_lm,
    resolve_seq2seq_config,
    seq2seq_hydra_ref_params,
    seq2seq_trainable_mask,
)
from trlx_tpu_torch.models.seq2seq import Seq2SeqConfig, relative_position_bucket
from trlx_tpu_torch.models.weights import seq2seq_params_from_jax
from trlx_tpu_torch.ops.sampling import GenerationConfig, generate_seq2seq
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

jax.config.update("jax_default_matmul_precision", "highest")

# f32: a bound relative to the largest |value| of the compared tensor
REL = 1e-5
SPECS = ("builtin:t5-test", "builtin:flan_t5-test")
LORA = {"peft_type": "lora", "r": 4, "lora_alpha": 8,
        "modified_modules": ["q_proj", "v_proj", "o_proj", "up_proj", "down_proj"]}


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= REL, f"{what}: {err:.3g} of the largest |value|"


_JAX = {}


def _jax_model(spec, head="value", lora=False):
    """JAX module, numpy params and config in f32 (memoized: the eager
    init dispatches op by op)."""
    key = (spec, head, lora)
    if key not in _JAX:
        mc = JaxModelConfig(model_path=spec, model_arch_type="seq2seq",
                            model_extra_kwargs=dict(dtype=jnp.float32),
                            peft_kwargs=dict(LORA) if lora else {})
        module, params, scfg = jax_build_seq2seq_lm(mc, head=head, seed=3)
        params = jax.tree_util.tree_map(np.asarray, params)
        if lora:  # adapters start at B = 0: give them values to carry
            rs = np.random.RandomState(1)
            params = jax.tree_util.tree_map_with_path(
                lambda p, x: (rs.randn(*x.shape).astype(np.float32) * 0.05
                              if str(getattr(p[-1], "key", "")) == "lora_b" else x), params)
        _JAX[key] = (module, params, scfg)
    return _JAX[key]


def _port_model(spec, params, head="value", lora=False):
    extra = {}
    if lora:
        extra = dict(lora_r=4, lora_alpha=8.0, lora_targets=tuple(LORA["modified_modules"]))
    model, cfg = build_seq2seq_lm(spec, device="cpu", head=head, dtype=torch.float32, **extra)
    model.load_state_dict(seq2seq_params_from_jax(params, cfg))
    return model, cfg


def _inputs(seed=0, B=3, P=11, T=7):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, 250, (B, P))
    mask = np.ones((B, P), np.int64)
    mask[1, 8:] = 0  # right-padded
    mask[2, :3] = 0  # left-padded
    dec = rs.randint(1, 250, (B, T))
    dmask = np.ones((B, T), np.int64)
    dmask[0, 5:] = 0
    return ids, mask, dec, dmask


@pytest.mark.parametrize("buckets,distance", [(8, 20), (32, 128)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bucket_matches_jax(buckets, distance, bidirectional):
    rel = np.arange(-2048, 2049)
    want = np.asarray(jax_bucket(jnp.asarray(rel), bidirectional, buckets, distance))
    got = relative_position_bucket(torch.as_tensor(rel), bidirectional, buckets, distance)
    np.testing.assert_array_equal(got.numpy(), want)


def test_presets_match_jax():
    sizes = {"t5": ("test", "small", "base", "large", "3b", "11b"),
             "flan_t5": ("test", "small", "base", "large", "xl", "xxl")}
    skip = {"param_dtype", "dtype", "remat"}
    for family, names in sizes.items():
        for size in names:
            ours = resolve_seq2seq_config(f"builtin:{family}-{size}")
            theirs = getattr(JaxSeq2SeqConfig, family)(size)
            for f in dataclasses.fields(JaxSeq2SeqConfig):
                if f.name not in skip:
                    assert getattr(ours, f.name) == getattr(theirs, f.name), (family, size, f)
    assert resolve_seq2seq_config("builtin:t5") == Seq2SeqConfig.t5("test")
    with pytest.raises(ValueError, match="checkpoint"):
        resolve_seq2seq_config("/models/t5-small")
    with pytest.raises(ValueError, match="Unknown seq2seq family"):
        resolve_seq2seq_config("builtin:bart-base")


@pytest.mark.parametrize("spec,head,lora", [
    ("builtin:t5-test", "value", False),
    ("builtin:flan_t5-test", "value", False),
    ("builtin:flan_t5-test", "ilql", False),
    ("builtin:t5-test", "value", True),
])
def test_forward_matches_jax(spec, head, lora):
    module, params, _ = _jax_model(spec, head, lora)
    model, cfg = _port_model(spec, params, head, lora)
    if lora:
        names = [n for n, _ in model.named_parameters() if "lora" in n]
        assert names and all(".dec_blocks." in n for n in names)
    ids, mask, dec, dmask = _inputs()
    want = module.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                        decoder_input_ids=jnp.asarray(dec),
                        decoder_attention_mask=jnp.asarray(dmask))
    with torch.no_grad():
        got = model(torch.as_tensor(ids), torch.as_tensor(mask),
                    decoder_input_ids=torch.as_tensor(dec),
                    decoder_attention_mask=torch.as_tensor(dmask))
    keys = ["logits", "hidden_states", "encoder_hidden"]
    keys += ["value"] if head == "value" else ["vs"]
    for k in keys:
        _close(got[k], want[k], k)
    if head == "ilql":
        for k in ("qs", "target_qs"):
            for i, (a, b) in enumerate(zip(got[k], want[k])):
                _close(a, b, f"{k}[{i}]")


@pytest.mark.parametrize("spec", SPECS)
def test_cached_decode_matches_full_pass(spec):
    _, params, _ = _jax_model(spec)
    model, cfg = _port_model(spec, params)
    ids, mask, dec, _ = _inputs(seed=4)
    ids, mask, dec = (torch.as_tensor(x) for x in (ids, mask, dec))
    T = dec.shape[1]
    with torch.no_grad():
        full = model(ids, mask, decoder_input_ids=dec)
        enc, cache = model.encode_for_decode(ids, mask, T + 1)
        _close(enc, full["encoder_hidden"], "encoder")
        steps = [model.decode(dec[:, t : t + 1], enc, mask, cache=cache, cache_index=t)
                 for t in range(T)]
    for k in ("logits", "value"):
        _close(torch.cat([s[k] for s in steps], dim=1), full[k], k)


@pytest.mark.parametrize("spec", SPECS)
def test_forward_branch_matches_jax(spec):
    module, params, scfg = _jax_model(spec)
    model, cfg = _port_model(spec, params)
    ids, mask, dec, dmask = (jnp.asarray(x) for x in _inputs(seed=2))
    out = module.apply({"params": params}, ids, mask, decoder_input_ids=dec,
                       decoder_attention_mask=dmask, branch_layer=1)
    want = module.apply({"params": {"backbone": jax_hydra_ref_params(params, scfg, 1)}},
                        out["branch_input"], 1, out["encoder_hidden"], mask, dmask,
                        method=JaxValueHead.forward_branch)
    ref = seq2seq_hydra_ref_params(model, cfg, 1)
    assert sorted(ref.state_dict()) == sorted(seq2seq_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_hydra_ref_params(params, scfg, 1)), cfg))
    t = lambda x: torch.as_tensor(np.asarray(x))  # noqa: E731
    with torch.no_grad():
        trunk = model(t(ids), t(mask), decoder_input_ids=t(dec), decoder_attention_mask=t(dmask),
                      branch_layer=1)
        got = ref(trunk["branch_input"], trunk["encoder_hidden"], t(mask), t(dmask))
        via_model = model.forward_branch(trunk["branch_input"], 1, trunk["encoder_hidden"],
                                         t(mask), t(dmask))
    _close(trunk["branch_input"], out["branch_input"], "branch_input")
    _close(got["logits"], want["logits"], "branch logits")
    _close(via_model["logits"], want["logits"], "forward_branch logits")
    # nothing trained yet: the branch replays the trunk's own top block
    _close(got["logits"], trunk["logits"], "branch against the trunk")


def _flat_jax(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): bool(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_name(name):
    """The port's parameter name → the JAX tree path."""
    parts = name.split(".")
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p in ("enc_blocks", "dec_blocks"):
            out.append(f"{p[:3]}_{parts[i + 1]}")
            i += 2
            continue
        out.append(p)
        i += 1
    leaf = out[-1]
    if leaf == "weight":
        parent = out[-2]
        if parent.startswith(("ln_", "enc_ln_f", "dec_ln_f")):
            out[-1] = "scale"
        elif parent in ("wte", "rel_bias"):
            out[-1] = "embedding"
        else:
            out[-1] = "kernel"
    return "/".join(out)


@pytest.mark.parametrize("head", ["value", "ilql"])
@pytest.mark.parametrize("lora", [False, True])
def test_trainable_mask_matches_jax(head, lora):
    spec = "builtin:flan_t5-test"
    _, params, scfg = _jax_model(spec, head, lora)
    model, cfg = _port_model(spec, params, head, lora)
    for k in (-1, 0, 1):
        want = _flat_jax(jax_trainable_mask(params, scfg, k))
        got = {_jax_name(n): v for n, v in seq2seq_trainable_mask(model, cfg, k).items()}
        assert got == want, k
    if not lora:  # k = 0 trains every decoder block (the reference's quirk)
        mask0 = seq2seq_trainable_mask(model, cfg, 0)
        assert all(v for n, v in mask0.items() if ".dec_blocks." in n)
        assert not any(v for n, v in mask0.items() if ".enc_blocks." in n)


# flan: random T5 v1.0 weights repeat one token in every greedy row, so
# t5's greedy decode (no eos) is held by the PPO parity of
# tests/test_torch_seq2seq_trainers.py
@pytest.mark.parametrize("spec", ["builtin:flan_t5-test"])
def test_greedy_generate_matches_jax(spec):
    module, params, scfg = _jax_model(spec)
    model, cfg = _port_model(spec, params)
    ids, mask, _, _ = _inputs(seed=6, B=4, P=9)
    t_ids, t_mask = torch.as_tensor(ids), torch.as_tensor(mask)
    # the eos: a token some greedy rows emit and others do not, so the rows
    # stop at different steps
    free = generate_seq2seq(model, t_ids, t_mask, torch.arange(4),
                            GenerationConfig(max_new_tokens=12, do_sample=False))
    rows = [set(row.tolist()) for row in free.response_tokens]
    eos = min(set.union(*rows) - set.intersection(*rows))

    def encode_fn(p, i, m, n):
        return module.apply({"params": p}, i, m, n, method=JaxValueHead.encode_for_decode)

    def decode_fn(p, d, e, m, c, ci):
        return module.apply({"params": p}, d, e, m, c, ci, method=JaxValueHead.decode)

    want = jax_generate_seq2seq(
        encode_fn, decode_fn, params, jnp.asarray(ids), jnp.asarray(mask),
        jax.random.PRNGKey(0),
        JaxGenerationConfig(max_new_tokens=12, do_sample=False, eos_token_id=eos,
                            pad_token_id=0))
    got = generate_seq2seq(model, t_ids, t_mask, torch.arange(4),
                           GenerationConfig(max_new_tokens=12, do_sample=False,
                                            eos_token_id=eos, pad_token_id=0))
    lengths = got.response_mask.sum(dim=1)
    assert int(lengths.min()) < 12 and int(lengths.max()) > 1
    for k in ("sequences", "response_tokens", "response_mask", "prompt_mask"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    for k in ("response_logprobs", "response_values"):
        _close(getattr(got, k), getattr(want, k), k)
