"""Hugging Face checkpoint import of the port (``trlx_tpu_torch/models/
hf_interop.py``) against ``transformers`` and the JAX package, on the CPU.

Tiny HF models of every family (``tests/torch_hf_cases.py``), seeded,
saved by ``transformers`` as ``model.safetensors``, ``pytorch_model.bin``
and each sharded behind its index; inputs drawn by numpy from a seed:

- causal import: ``build_causal_lm(<dir>)`` in f32 gives logits within
  ``LOGIT_ATOL`` of HF's, and ``load_pretrained``'s state dict equals,
  bitwise, ``params_from_jax`` of JAX's ``params_from_hf(hf)``; the same
  for T5 v1.0 (tied, relu) and Flan (untied, gated-gelu) through
  ``build_seq2seq_lm``;
- the layouts that convert wrongly without an error (GPT-2's ``Conv1D``,
  head-major q/k/v, GPT-J's head bias, OPT's position offset, BLOOM's
  embedding norm, Mixtral's expert stacks and drop-free capacity, a tied
  head with and without ``lm_head.weight``, T5's shared embedding), each
  named in a case;
- config defaults: a ``config.json`` with one key deleted (or given under
  a ``transformers`` alias) maps to the config JAX's ``config_from_hf``
  makes of ``AutoConfig.from_pretrained`` on that file;
- the safetensors reader: F32, F16 and BF16 files written by the
  ``safetensors`` package read back bitwise;
- a directory without weights, or no directory, raises the loader's
  ``ValueError`` naming the files it looked for;
- the loaders take the card unless the CPU is named (without one they
  raise), as every entry point of the port;
- a backbone weight that the import leaves out raises (LoRA adapters
  aside, which are drawn from the seed with the heads).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import transformers as tf

from trlx_tpu.models import hf_interop as jax_hf
from trlx_tpu_torch.models import hf_interop
from trlx_tpu_torch.models.builder import build_causal_lm, build_seq2seq_lm
from trlx_tpu_torch.models.weights import params_from_jax, seq2seq_params_from_jax
from torch_hf_cases import (
    CAUSAL_FAMILIES,
    SAVE_MODES,
    T5_VARIANTS,
    causal_ids,
    hf_config,
    save,
    t5_inputs,
    tiny_hf,
)
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

# f32 logits of the imported model against HF's (the largest gap read is
# 6.7e-6, Flan-T5's normal(1) embeddings; the causal families ~1e-7)
LOGIT_ATOL = 1e-5


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_bitwise(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def hf_models():
    return {}


def _hf(hf_models, family):
    if family not in hf_models:
        hf_models[family] = tiny_hf(family)
    return hf_models[family]


@pytest.mark.parametrize("mode", SAVE_MODES)
@pytest.mark.parametrize("family", CAUSAL_FAMILIES + ("llama_tied",))
def test_causal_import(family, mode, tmp_path, hf_models):
    hf = _hf(hf_models, family)
    path = save(hf, str(tmp_path / family), mode)
    model, cfg = build_causal_lm(path, device="cpu", dtype=torch.float32)
    ids = causal_ids(cfg.vocab_size)
    with torch.no_grad():
        want = hf(torch.tensor(ids)).logits
        got = model(torch.tensor(ids))["logits"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=LOGIT_ATOL)

    state_dict, cfg = hf_interop.load_pretrained(path, device="cpu")
    jax_params, _ = jax_hf.params_from_hf(hf)
    _assert_bitwise(state_dict, params_from_jax(_np_tree(jax_params), cfg))


@pytest.mark.parametrize("mode", SAVE_MODES)
@pytest.mark.parametrize("variant", T5_VARIANTS)
def test_t5_import(variant, mode, tmp_path, hf_models):
    hf = _hf(hf_models, variant)
    path = save(hf, str(tmp_path / variant), mode)
    model, cfg = build_seq2seq_lm(path, device="cpu", dtype=torch.float32)
    ids, mask, dec = (torch.tensor(x) for x in t5_inputs(cfg.vocab_size))
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask, decoder_input_ids=dec).logits
        got = model(ids, attention_mask=mask, decoder_input_ids=dec)["logits"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=LOGIT_ATOL)

    state_dict, cfg = hf_interop.load_pretrained_seq2seq(path, device="cpu")
    jax_params, _ = jax_hf.seq2seq_params_from_hf(hf)
    _assert_bitwise(state_dict, seq2seq_params_from_jax(_np_tree(jax_params), cfg))


def _conv1d(sd, hf_sd, cfg):
    E = cfg.hidden_size  # Conv1D is [in, out]: q is the first E columns, transposed
    return sd["blocks.0.attn.q_proj.weight"], hf_sd["transformer.h.0.attn.c_attn.weight"][:, :E].t()


def _headmajor(prefix):
    def pick(sd, hf_sd, cfg):
        H, D = cfg.num_heads, cfg.dims_per_head  # rows [H, 3, D]: k is the middle third
        w = hf_sd[f"{prefix}.query_key_value.weight"].reshape(H, 3, D, -1)[:, 1]
        return sd["blocks.0.attn.k_proj.weight"], w.reshape(H * D, -1)
    return pick


def _opt_positions(sd, hf_sd, cfg):
    assert sd["wpe.weight"].shape[0] == cfg.max_position_embeddings + cfg.pos_offset == 66
    return sd["wpe.weight"], hf_sd["model.decoder.embed_positions.weight"]


def _mixtral_experts(sd, hf_sd, cfg):
    assert cfg.moe_capacity_factor == cfg.num_experts == 4  # drop-free routing
    ep = "model.layers.1.block_sparse_moe.experts.3."
    return (torch.stack([sd["blocks.1.mlp.w_gate"][3], sd["blocks.1.mlp.w_up"][3],
                         sd["blocks.1.mlp.w_down"][3].t()]),
            torch.stack([hf_sd[ep + "w1.weight"].t(), hf_sd[ep + "w3.weight"].t(),
                         hf_sd[ep + "w2.weight"]]))


LAYOUT_PITFALLS = {
    "gpt2_conv1d_in_out": ("gpt2", _conv1d),
    "gpt_neox_headmajor_qkv": ("gpt_neox", _headmajor("gpt_neox.layers.0.attention")),
    "bloom_headmajor_qkv": ("bloom", _headmajor("transformer.h.0.self_attention")),
    "gptj_lm_head_bias": ("gptj", lambda sd, h, c: (sd["lm_head.bias"], h["lm_head.bias"])),
    "opt_position_offset_2": ("opt", _opt_positions),
    "bloom_embedding_layernorm": ("bloom", lambda sd, h, c: (
        sd["emb_ln.weight"], h["transformer.word_embeddings_layernorm.weight"])),
    "mixtral_expert_stacks": ("mixtral", _mixtral_experts),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_PITFALLS))
def test_layout_pitfalls(case, hf_models):
    """Each layout that loads without an error when read the wrong way."""
    family, pick = LAYOUT_PITFALLS[case]
    hf = _hf(hf_models, family)
    state_dict, cfg = hf_interop.params_from_hf(hf)
    got, want = pick(state_dict, hf.state_dict(), cfg)
    assert torch.equal(got, want.contiguous()), case


@pytest.mark.parametrize("lm_head", ["kept", "dropped"])
def test_tied_head_with_or_without_lm_head(lm_head, tmp_path, hf_models):
    """A tied checkpoint may hold ``lm_head.weight`` or leave it out; an
    untied one without it raises."""
    hf = _hf(hf_models, "llama_tied")
    sd = dict(hf.state_dict())
    if lm_head == "kept":
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"].clone()
    else:
        sd.pop("lm_head.weight", None)
    path = str(tmp_path / "tied")
    os.makedirs(path)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    hf.config.to_json_file(os.path.join(path, "config.json"))
    state_dict, cfg = hf_interop.load_pretrained(path, device="cpu")
    assert cfg.tie_word_embeddings and "lm_head.weight" not in state_dict
    assert torch.equal(state_dict["wte.weight"], sd["model.embed_tokens.weight"])
    if lm_head == "dropped":
        untied = dataclasses.replace(cfg, tie_word_embeddings=False)
        with pytest.raises(ValueError, match="lm_head.weight"):
            hf_interop.load_pretrained(path, device="cpu", cfg=untied)


@pytest.mark.parametrize("key", ["shared.weight", "encoder.embed_tokens.weight"])
def test_t5_shared_embedding(key, tmp_path, hf_models):
    """T5's embedding read from ``shared.weight`` or, in a checkpoint
    without it, ``encoder.embed_tokens.weight``; v1.0's tied head scaling
    is held by :func:`test_t5_import`."""
    hf = _hf(hf_models, "t5")
    sd = {k: v for k, v in hf.state_dict().items()
          if k not in ("shared.weight", "encoder.embed_tokens.weight") or k == key}
    path = str(tmp_path / "t5")
    os.makedirs(path)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    hf.config.to_json_file(os.path.join(path, "config.json"))
    state_dict, _ = hf_interop.load_pretrained_seq2seq(path, device="cpu")
    assert torch.equal(state_dict["wte.weight"], hf.state_dict()["shared.weight"])


DEFAULT_CASES = [
    ("gpt2", "n_inner"), ("gpt2", "n_positions"), ("gpt2", "layer_norm_epsilon"),
    ("llama", "num_key_value_heads"), ("llama", "head_dim"), ("llama", "rope_theta"),
    ("llama", "rms_norm_eps"), ("llama", "max_position_embeddings"),
    ("llama", "tie_word_embeddings"), ("llama_tied", "tie_word_embeddings"),
    ("mistral", "num_key_value_heads"), ("mistral", "head_dim"), ("mistral", "sliding_window"),
    ("mistral", "rope_theta"), ("mistral", "rms_norm_eps"),
    ("mistral", "max_position_embeddings"), ("mistral", "tie_word_embeddings"),
    ("mixtral", "rope_theta"), ("mixtral", "num_key_value_heads"),
    ("mixtral", "sliding_window"), ("mixtral", "router_aux_loss_coef"),
    ("mixtral", "num_local_experts"), ("mixtral", "num_experts_per_tok"),
    ("mixtral", "rms_norm_eps"), ("mixtral", "tie_word_embeddings"),
    ("gpt_neox", "rotary_pct"), ("gpt_neox", "rotary_emb_base"),
    ("gpt_neox", "use_parallel_residual"), ("gpt_neox", "layer_norm_eps"),
    ("gptj", "n_inner"), ("gptj", "rotary_dim"), ("gptj", "layer_norm_epsilon"),
    ("opt", "activation_function"), ("opt", "max_position_embeddings"),
    ("bloom", "hidden_size"), ("bloom", "layer_norm_epsilon"),
    ("t5", "num_decoder_layers"), ("t5", "relative_attention_max_distance"),
    ("t5", "layer_norm_epsilon"), ("t5", "feed_forward_proj"), ("t5", "tie_word_embeddings"),
    ("t5", "decoder_start_token_id"), ("t5", "pad_token_id"),
    ("flan", "tie_word_embeddings"), ("mt5", "feed_forward_proj"),
    ("mt5", "tie_word_embeddings"), ("mt5", "decoder_start_token_id"),
]
# (family, the name transformers writes, another name its config class takes)
ALIAS_CASES = [("gpt2", "n_embd", "hidden_size"), ("gptj", "n_layer", "num_hidden_layers"),
               ("bloom", "hidden_size", "n_embed"), ("bloom", "n_head", "num_attention_heads"),
               ("t5", "d_model", "hidden_size"), ("t5", "d_kv", "head_dim")]


def _same_config(ours, theirs):
    """Every field the two dataclasses share but the dtypes."""
    names = {f.name for f in dataclasses.fields(theirs)} & {f.name for f in dataclasses.fields(ours)}
    got = {n: getattr(ours, n) for n in names - {"dtype", "param_dtype"}}
    want = {n: getattr(theirs, n) for n in names - {"dtype", "param_dtype"}}
    assert got == want


def _edited_config(tmp_path, family, edit):
    hf_config(family).save_pretrained(str(tmp_path))
    file = tmp_path / "config.json"
    d = json.loads(file.read_text())
    edit(d)
    file.write_text(json.dumps(d))
    seq2seq = family in ("t5", "flan", "mt5")
    ours = (hf_interop.seq2seq_config_from_hf if seq2seq else hf_interop.config_from_hf)(d)
    theirs = (jax_hf.seq2seq_config_from_hf if seq2seq else jax_hf.config_from_hf)(
        tf.AutoConfig.from_pretrained(str(tmp_path)))
    return ours, theirs


@pytest.mark.parametrize("family,key", DEFAULT_CASES)
def test_config_default(family, key, tmp_path):
    assert key in hf_interop.HF_DEFAULTS[{"llama_tied": "llama", "flan": "t5"}.get(family, family)]
    _same_config(*_edited_config(tmp_path, family, lambda d: d.pop(key, None)))


@pytest.mark.parametrize("family,name,alias", ALIAS_CASES)
def test_config_alias(family, name, alias, tmp_path):
    def rename(d):
        d[alias] = d.pop(name)

    ours, theirs = _edited_config(tmp_path, family, rename)
    _same_config(ours, theirs)


def test_config_from_hf_takes_config_objects():
    for family in CAUSAL_FAMILIES:
        _same_config(hf_interop.config_from_hf(hf_config(family)),
                     jax_hf.config_from_hf(hf_config(family)))
    _same_config(hf_interop.seq2seq_config_from_hf(hf_config("flan")),
                 jax_hf.seq2seq_config_from_hf(hf_config("flan")))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_reader_bitwise(dtype, tmp_path):
    from safetensors.torch import save_file

    rs = np.random.RandomState(0)
    tensors = {"w": torch.tensor(rs.randn(7, 5).astype(np.float32)).to(dtype),
               "b": torch.tensor(rs.randn(3).astype(np.float32)).to(dtype),
               "scalar": torch.tensor(1.5).to(dtype), "ids": torch.arange(6).reshape(2, 3),
               "empty": torch.zeros(0, 4, dtype=dtype)}
    file = str(tmp_path / "t.safetensors")
    save_file(tensors, file, metadata={"format": "pt"})
    got = dict(hf_interop.read_safetensors(file, device="cpu"))
    _assert_bitwise(got, tensors)
    assert all(got[k].shape == tensors[k].shape for k in tensors)


def test_missing_weights_raise(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="model.safetensors, model.safetensors.index.json, "
                                         "pytorch_model.bin, pytorch_model.bin.index.json"):
        hf_interop.read_hf_state_dict(str(empty), device="cpu")
    with pytest.raises(ValueError, match="config.json"):
        build_causal_lm(str(empty), device="cpu")
    hf_config("gpt2").save_pretrained(str(empty))  # a config and no weights
    with pytest.raises(ValueError, match=r"holds none of model.safetensors"):
        build_causal_lm(str(empty), device="cpu")
    with pytest.raises(ValueError, match="not a Hugging Face checkpoint directory"):
        build_causal_lm(str(tmp_path / "no-such-dir"), device="cpu")


def test_cut_depth_reads_the_first_layers(tmp_path, hf_models):
    """``num_layers`` below the checkpoint's imports its first layers (the
    trainer's ``model_extra_kwargs`` applied over the directory's config)."""
    hf = _hf(hf_models, "llama")
    path = save(hf, str(tmp_path / "llama"), "safetensors")
    full, _ = hf_interop.load_pretrained(path, device="cpu")
    model, cfg = build_causal_lm(path, device="cpu", num_layers=1)
    assert cfg.num_layers == 1
    got = model.state_dict()
    for k, v in got.items():
        assert torch.equal(v, full[k]), k


LOADERS = {
    "read_safetensors": lambda d: dict(hf_interop.read_safetensors(
        os.path.join(d, "model.safetensors"))),
    "read_hf_state_dict": hf_interop.read_hf_state_dict,
    "load_pretrained": hf_interop.load_pretrained,
    "build_causal_lm": build_causal_lm,
}


@pytest.mark.parametrize("loader", sorted(LOADERS))
def test_loaders_take_the_card_by_default(loader, tmp_path, hf_models):
    """Called with no device, a loader reads onto the card; with none on
    the machine it raises rather than fill the host."""
    path = save(_hf(hf_models, "gpt2"), str(tmp_path / "gpt2"), "safetensors")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LOADERS[loader](path)
        return
    out = LOADERS[loader](path)
    tensors = out[0] if isinstance(out, tuple) else out
    tensors = tensors.state_dict() if isinstance(tensors, torch.nn.Module) else tensors
    assert all(t.is_cuda for t in tensors.values())


def test_import_refuses_a_missing_backbone_weight(tmp_path, hf_models):
    """A converter that leaves out a backbone tensor must not leave it at
    its random draw: the import names it."""
    from trlx_tpu_torch.models.transformer import CausalTransformer

    path = save(_hf(hf_models, "llama"), str(tmp_path / "llama"), "safetensors")
    state_dict, cfg = hf_interop.load_pretrained(path, device="cpu")
    state_dict.pop("blocks.0.mlp.up_proj.weight")
    with torch.device("meta"):
        model = CausalTransformer(cfg)
    with pytest.raises(ValueError, match=r"lacks: \['blocks.0.mlp.up_proj.weight'\]"):
        hf_interop.import_backbone(model, state_dict, "cpu")


def test_lora_adapters_are_drawn_over_an_import(tmp_path, hf_models):
    """With LoRA on, the checkpoint holds no adapters: the backbone is the
    checkpoint's, the adapters start as a builtin spec's do (``lora_b``
    zero, ``lora_a`` drawn from the seed), so the model is its base."""
    hf = _hf(hf_models, "llama")
    path = save(hf, str(tmp_path / "llama"), "safetensors")
    full, _ = hf_interop.load_pretrained(path, device="cpu")
    model, cfg = build_causal_lm(path, device="cpu", dtype=torch.float32, lora_r=4,
                                 lora_targets=("q_proj", "v_proj"))
    again, _ = build_causal_lm(path, device="cpu", dtype=torch.float32, lora_r=4,
                               lora_targets=("q_proj", "v_proj"))
    got = model.state_dict()
    adapters = [k for k in got if k.endswith(("lora_a", "lora_b"))]
    assert len(adapters) == 2 * 2 * cfg.num_layers
    assert set(got) - set(adapters) == set(full)
    for k in full:
        assert torch.equal(got[k], full[k]), k
    for k in adapters:
        assert torch.equal(got[k], again.state_dict()[k]), k
        assert (got[k].abs().max() > 0) == k.endswith("lora_a"), k
    ids = causal_ids(cfg.vocab_size)
    with torch.no_grad():
        want = hf(torch.tensor(ids)).logits
        logits = model(torch.tensor(ids))["logits"]
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=0, atol=LOGIT_ATOL)
