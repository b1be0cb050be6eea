"""Hugging Face checkpoints ⇄ the port's models, without ``transformers``.

Port of ``trlx_tpu/models/hf_interop.py``: a local checkpoint directory is
*imported* into the port's ``state_dict`` (and a model is *exported* back
to a directory that ``transformers`` loads), for the causal families
gpt2, llama, mistral, mixtral, gpt_neox, gptj, opt and bloom, and for T5
(v1.0, v1.1 / Flan, mT5).

Design. Import goes HF state dict → a tree of JAX's layout →
``models/weights.py::params_from_jax``. The converters (``convert_gpt2`` …
``convert_bloom``, ``convert_t5``) are JAX's, one for one, with torch
tensors for leaves in place of numpy arrays: numpy has no bf16, and a
tensor stays on the device it was read onto. ``params_from_jax`` then
owns the one mapping from JAX's layout onto the port's modules (with its
transpose and norm helpers, ``weights.py::_converters``), the same mapping
the parity tests load JAX's weights through. Export runs the other way:
the port's ``state_dict`` → ``weights.py::params_to_jax`` (its inverse,
transposes as views) → JAX's exporters (``export_*``).

Neither ``transformers`` nor ``safetensors`` is imported (``transformers``
is only the CPU tests' oracle):

- :func:`read_hf_state_dict` reads ``model.safetensors``,
  ``model.safetensors.index.json`` and its shards, ``pytorch_model.bin``
  (``torch.load(..., weights_only=True, mmap=True)``) or
  ``pytorch_model.bin.index.json``, tensor by tensor onto the target
  device (:func:`read_safetensors` is a reader of the format: an 8-byte
  little-endian header length, a JSON header, raw bytes; F32, F16 and BF16
  go straight into torch tensors, in their stored type), so a 7B
  checkpoint never sits whole on the host. The device is the card unless
  the caller names the CPU, as everywhere in the port;
- :func:`config_from_hf` / :func:`seq2seq_config_from_hf` take the parsed
  ``config.json`` as a dict, or any object with attributes (a
  ``transformers`` config too); :func:`hf_config_from_transformer` returns
  a plain dict in ``transformers``' key names, which
  :func:`save_pretrained_hf` writes as ``config.json`` beside
  ``pytorch_model.bin`` (f32, the heads merged under the reference's
  prefixes).

Defaults reproduced where ``config.json`` lacks a key (each is what the
family's ``transformers`` config class gives; :data:`HF_DEFAULTS` holds
them, :data:`HF_ALIASES` the classes' ``attribute_map`` names):

- gpt2: ``n_inner`` null → 4·``n_embd``; ``n_positions`` 1024,
  ``layer_norm_epsilon`` 1e-5;
- llama: no ``num_key_value_heads`` → MHA; no ``head_dim`` →
  ``hidden_size // num_attention_heads``; no ``rope_theta`` → 10000;
  ``rms_norm_eps`` 1e-6; ``max_position_embeddings`` 2048;
  ``tie_word_embeddings`` false;
- mistral: ``num_key_value_heads`` 8; ``head_dim`` none (the model's
  ``hidden_size // num_attention_heads``); ``sliding_window`` 4096;
  ``rope_theta`` 10000; ``rms_norm_eps`` 1e-6; ``max_position_embeddings``
  131072; ``tie_word_embeddings`` false;
- mixtral: ``rope_theta`` 1e6; ``num_key_value_heads`` 8;
  ``sliding_window`` none; ``router_aux_loss_coef`` 0.001;
  ``num_local_experts`` 8, ``num_experts_per_tok`` 2; ``rms_norm_eps``
  1e-5; ``tie_word_embeddings`` false;
- gpt_neox: ``rotary_pct`` 0.25; ``rotary_emb_base`` 10000;
  ``use_parallel_residual`` true; ``layer_norm_eps`` 1e-5; untied;
- gptj: ``n_inner`` null → 4·``n_embd``; ``rotary_dim`` 64;
  ``layer_norm_epsilon`` 1e-5; untied;
- opt: ``activation_function`` relu; ``max_position_embeddings`` 2048;
  tied;
- bloom: ``n_embed`` or ``hidden_size`` (64); ``layer_norm_epsilon``
  1e-5; tied;
- t5: ``num_decoder_layers`` null → ``num_layers``;
  ``relative_attention_max_distance`` 128; ``layer_norm_epsilon`` 1e-6;
  ``feed_forward_proj`` relu; ``tie_word_embeddings`` true;
  ``decoder_start_token_id`` null → 0; ``pad_token_id`` 0 (mt5:
  gated-gelu, untied).

Places where a conversion goes wrong quietly (each is commented where it
is handled and held by ``tests/test_torch_hf_interop.py`` or
``tests/test_torch_hf_export.py``): GPT-2's ``Conv1D`` weights are already
``[in, out]``; GPT-NeoX and BLOOM interleave q/k/v head-major; GPT-J's LM
head has a bias; OPT offsets positions by 2; BLOOM normalises the
embedding; Mixtral's per-expert ``w1``/``w2``/``w3`` ``[out, in]`` stack
into ``w_gate``/``w_up`` ``[E, d, f]`` and ``w_down`` ``[E, f, d]``, and an
import routes drop-free (``moe_capacity_factor`` = E); with tied
embeddings a checkpoint may hold ``lm_head.weight`` or leave it out; T5's
``shared.weight`` against ``encoder.embed_tokens.weight`` and v1.0's tied
head scaling; on export, LoRA adapters are merged.
"""

import json
import os
import shutil
import struct
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple, Union

import torch

from trlx_tpu_torch.models.transformer import TransformerConfig
from trlx_tpu_torch.models.weights import (
    params_from_jax,
    params_to_jax,
    seq2seq_params_from_jax,
)
from trlx_tpu_torch.ops.kernel_utils import resolve_device

__all__ = [
    "CONVERTERS", "EXPORTERS", "HF_ALIASES", "HF_DEFAULTS", "UnsupportedHFExport",
    "WEIGHT_FILES", "config_from_hf", "convert_t5", "hf_config_from_transformer",
    "import_backbone", "load_pretrained", "load_pretrained_seq2seq",
    "merge_heads_into_state_dict", "params_from_hf", "params_to_hf_state_dict",
    "read_hf_config", "read_hf_state_dict", "read_safetensors", "save_pretrained_hf",
    "seq2seq_config_from_hf", "seq2seq_params_from_hf",
]

Device = Union[None, str, torch.device]


class UnsupportedHFExport(ValueError):
    """Raised when an architecture has no ``transformers`` family mapping —
    the one "skip the HF export, keep the native dump" case. Genuine
    conversion bugs raise a plain ValueError and must propagate."""


# ---------------------------------------------------------------------------
# checkpoint files
# ---------------------------------------------------------------------------

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
# in the order the loader looks for them
WEIGHT_FILES = ("model.safetensors", "model.safetensors.index.json", "pytorch_model.bin",
                "pytorch_model.bin.index.json")


def read_safetensors(path: str, device: Device = None) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` of a ``.safetensors`` file, one tensor at a time
    in file order, read into a torch tensor of the stored type (bf16
    included) and moved to ``device`` (None: the card)."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        base = 8 + n
        for name, info in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
            if info["dtype"] not in SAFETENSORS_DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which "
                                 f"the reader does not take ({sorted(SAFETENSORS_DTYPES)})")
            dtype = SAFETENSORS_DTYPES[info["dtype"]]
            begin, end = info["data_offsets"]
            if end == begin:
                tensor = torch.empty(info["shape"], dtype=dtype)
            else:
                f.seek(base + begin)
                buf = bytearray(end - begin)
                if f.readinto(buf) != len(buf):
                    raise ValueError(f"{path}: truncated at tensor {name!r}")
                tensor = torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(
                    info["shape"])
            yield name, tensor.to(device)


def _read_bin(path: str, device: Device) -> Iterator[Tuple[str, torch.Tensor]]:
    """``pytorch_model.bin``, memory-mapped: a tensor is read when it is
    moved to ``device``."""
    state = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    for name in list(state):
        tensor = state.pop(name)
        yield name, tensor.to(device)


def read_hf_state_dict(path: str, device: Device = None) -> Dict[str, torch.Tensor]:
    """The HF state dict of the checkpoint directory ``path``: the first of
    :data:`WEIGHT_FILES` found (an index reads every shard it names), each
    tensor read in its stored type onto ``device`` (None: the card) before
    the next is read. Raises a ``ValueError`` naming ``path`` and the files
    looked for when it holds none of them."""
    device = resolve_device(device)
    for name in WEIGHT_FILES:
        file = os.path.join(path, name)
        if not os.path.isfile(file):
            continue
        files = [file]
        if name.endswith(".index.json"):
            with open(file) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            files = [os.path.join(path, shard) for shard in shards]
        read = read_safetensors if ".safetensors" in name else _read_bin
        return {k: v for file in files for k, v in read(file, device)}
    raise ValueError(f"{path!r} is not a Hugging Face checkpoint directory: it holds none of "
                     f"{', '.join(WEIGHT_FILES)}")


def read_hf_config(path: str) -> Dict[str, Any]:
    """The parsed ``config.json`` of the checkpoint directory ``path``."""
    file = os.path.join(path, "config.json")
    if not os.path.isfile(file):
        raise ValueError(f"{path!r} is not a Hugging Face checkpoint directory: no config.json "
                         f"(and the weights are looked for in {', '.join(WEIGHT_FILES)})")
    with open(file) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

# transformers' defaults for the keys the mapping reads, per family
HF_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "gpt2": dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12, n_head=12,
                 n_inner=None, layer_norm_epsilon=1e-5),
    "llama": dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                  num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=None,
                  head_dim=None, max_position_embeddings=2048, rms_norm_eps=1e-6,
                  rope_theta=10000.0, tie_word_embeddings=False, rope_scaling=None),
    "mistral": dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                    head_dim=None, max_position_embeddings=131072, rms_norm_eps=1e-6,
                    rope_theta=10000.0, tie_word_embeddings=False, sliding_window=4096),
    "mixtral": dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                    max_position_embeddings=131072, rms_norm_eps=1e-5, rope_theta=1e6,
                    tie_word_embeddings=False, sliding_window=None, num_local_experts=8,
                    num_experts_per_tok=2, router_aux_loss_coef=0.001),
    "gpt_neox": dict(vocab_size=50432, hidden_size=6144, num_hidden_layers=44,
                     num_attention_heads=64, intermediate_size=24576,
                     max_position_embeddings=2048, rotary_pct=0.25, rotary_emb_base=10000,
                     use_parallel_residual=True, layer_norm_eps=1e-5),
    "gptj": dict(vocab_size=50400, n_positions=2048, n_embd=4096, n_layer=28, n_head=16,
                 rotary_dim=64, n_inner=None, layer_norm_epsilon=1e-5),
    "opt": dict(vocab_size=50272, hidden_size=768, num_hidden_layers=12, ffn_dim=3072,
                max_position_embeddings=2048, num_attention_heads=12,
                activation_function="relu", word_embed_proj_dim=None,
                do_layer_norm_before=True),
    "bloom": dict(vocab_size=250880, hidden_size=64, n_layer=2, n_head=8,
                  layer_norm_epsilon=1e-5),
    "t5": dict(vocab_size=32128, d_model=512, d_kv=64, d_ff=2048, num_layers=6,
               num_decoder_layers=None, num_heads=8, relative_attention_num_buckets=32,
               relative_attention_max_distance=128, layer_norm_epsilon=1e-6,
               feed_forward_proj="relu", tie_word_embeddings=True, decoder_start_token_id=None,
               pad_token_id=0),
    "mt5": dict(vocab_size=250112, d_model=512, d_kv=64, d_ff=1024, num_layers=8,
                num_decoder_layers=None, num_heads=6, relative_attention_num_buckets=32,
                relative_attention_max_distance=128, layer_norm_epsilon=1e-6,
                feed_forward_proj="gated-gelu", tie_word_embeddings=False,
                decoder_start_token_id=0, pad_token_id=0),
}
# other names a config.json may give a key (the classes' attribute_map;
# bloom's ``n_embed`` init argument)
_GPT_NAMES = {"n_embd": ("hidden_size",), "n_positions": ("max_position_embeddings",),
              "n_head": ("num_attention_heads",), "n_layer": ("num_hidden_layers",)}
_T5_NAMES = {"d_model": ("hidden_size",), "num_heads": ("num_attention_heads",),
             "num_layers": ("num_hidden_layers",), "d_kv": ("head_dim",)}
HF_ALIASES: Dict[str, Dict[str, Tuple[str, ...]]] = {
    "gpt2": _GPT_NAMES, "gptj": _GPT_NAMES, "t5": _T5_NAMES, "mt5": _T5_NAMES,
    "bloom": {"hidden_size": ("n_embed",), "n_layer": ("num_hidden_layers",),
              "n_head": ("num_attention_heads",)},
}
_MISSING = object()


def _hf_reader(hf_config) -> Tuple[str, Callable[[str], Any]]:
    """``(model_type, get)``: ``get(key)`` reads ``hf_config`` (a dict or an
    object with attributes) under the key or its aliases, else the
    family's default."""
    def raw(key):
        if isinstance(hf_config, Mapping):
            return hf_config.get(key, _MISSING)
        return getattr(hf_config, key, _MISSING)

    mt = raw("model_type")
    if mt not in HF_DEFAULTS:
        raise ValueError(f"Unsupported HF model type {mt!r} (known: {sorted(HF_DEFAULTS)})")

    def get(key):
        for name in (key, *HF_ALIASES.get(mt, {}).get(key, ())):
            value = raw(name)
            if value is not _MISSING:
                return value
        return HF_DEFAULTS[mt][key]

    return mt, get


def config_from_hf(hf_config) -> TransformerConfig:
    """Map an HF causal-LM config (a parsed ``config.json`` or a config
    object) to a :class:`TransformerConfig`, the JAX mapping."""
    mt, get = _hf_reader(hf_config)
    if mt == "gpt2":
        return TransformerConfig(
            model_type=mt, vocab_size=get("vocab_size"), hidden_size=get("n_embd"),
            num_layers=get("n_layer"), num_heads=get("n_head"),
            intermediate_size=get("n_inner") or 4 * get("n_embd"),
            max_position_embeddings=get("n_positions"), position_scheme="learned",
            activation="gelu_new", layer_norm_epsilon=get("layer_norm_epsilon"))
    if mt in ("llama", "mistral"):
        if mt == "llama" and get("rope_scaling"):
            raise ValueError(f"rope_scaling {get('rope_scaling')!r}: the port's rotary "
                             "positions are unscaled")
        heads = get("num_attention_heads")
        # LlamaConfig fills head_dim; MistralConfig leaves it None
        head_dim = get("head_dim")
        if mt == "llama" and head_dim is None:
            head_dim = get("hidden_size") // heads
        return TransformerConfig(
            model_type=mt, vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
            num_layers=get("num_hidden_layers"), num_heads=heads,
            num_kv_heads=get("num_key_value_heads") or heads, head_dim=head_dim,
            intermediate_size=get("intermediate_size"),
            max_position_embeddings=get("max_position_embeddings"), position_scheme="rotary",
            rope_theta=get("rope_theta"), norm="rmsnorm",
            layer_norm_epsilon=get("rms_norm_eps"), activation="silu", attn_bias=False,
            mlp_bias=False, tie_word_embeddings=bool(get("tie_word_embeddings")),
            sliding_window=get("sliding_window") if mt == "mistral" else None)
    if mt == "mixtral":
        experts = get("num_local_experts")
        return TransformerConfig(
            model_type=mt, vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
            num_layers=get("num_hidden_layers"), num_heads=get("num_attention_heads"),
            num_kv_heads=get("num_key_value_heads") or get("num_attention_heads"),
            intermediate_size=get("intermediate_size"),
            max_position_embeddings=get("max_position_embeddings"), position_scheme="rotary",
            rope_theta=get("rope_theta"), norm="rmsnorm",
            layer_norm_epsilon=get("rms_norm_eps"), activation="silu", attn_bias=False,
            mlp_bias=False, tie_word_embeddings=bool(get("tie_word_embeddings")),
            num_experts=experts, num_experts_per_tok=get("num_experts_per_tok"),
            router_aux_coef=get("router_aux_loss_coef"), moe_group_size=512,
            sliding_window=get("sliding_window"),
            # HF Mixtral routes with no capacity bound; a capacity factor of
            # E makes the one-hot dispatch drop-free (even if every token
            # picked one expert), so an import reproduces HF's logits. A
            # lower factor trades dropped overflow tokens for speed
            moe_capacity_factor=float(experts))
    if mt == "gpt_neox":
        head_dim = get("hidden_size") // get("num_attention_heads")
        return TransformerConfig(
            model_type=mt, vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
            num_layers=get("num_hidden_layers"), num_heads=get("num_attention_heads"),
            intermediate_size=get("intermediate_size"),
            max_position_embeddings=get("max_position_embeddings"), position_scheme="rotary",
            rotary_dim=int(head_dim * get("rotary_pct")), rope_theta=get("rotary_emb_base"),
            activation="gelu", parallel_residual=bool(get("use_parallel_residual")),
            shared_ln=False, layer_norm_epsilon=get("layer_norm_eps"),
            tie_word_embeddings=False)
    if mt == "gptj":
        return TransformerConfig(
            model_type=mt, vocab_size=get("vocab_size"), hidden_size=get("n_embd"),
            num_layers=get("n_layer"), num_heads=get("n_head"),
            intermediate_size=get("n_inner") or 4 * get("n_embd"),
            max_position_embeddings=get("n_positions"), position_scheme="rotary",
            rotary_dim=get("rotary_dim"), activation="gelu_new", parallel_residual=True,
            shared_ln=True, attn_bias=False, qkv_bias=False, mlp_bias=True,
            layer_norm_epsilon=get("layer_norm_epsilon"), tie_word_embeddings=False,
            lm_head_bias=True)  # GPT-J's LM head has a bias
    if mt == "opt":
        proj = get("word_embed_proj_dim")
        if (proj is not None and proj != get("hidden_size")) or not get("do_layer_norm_before"):
            raise ValueError("OPT with a projected embedding or post-norm blocks (opt-350m) "
                             "has no mapping onto the port's blocks")
        return TransformerConfig(
            model_type=mt, vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
            num_layers=get("num_hidden_layers"), num_heads=get("num_attention_heads"),
            intermediate_size=get("ffn_dim"),
            max_position_embeddings=get("max_position_embeddings"), position_scheme="learned",
            pos_offset=2,  # OPT's position table starts 2 rows in
            activation=get("activation_function"), tie_word_embeddings=True)
    if mt == "bloom":
        return TransformerConfig(
            model_type=mt, vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
            num_layers=get("n_layer"), num_heads=get("n_head"),
            intermediate_size=4 * get("hidden_size"), max_position_embeddings=2048,
            position_scheme="alibi", activation="gelu",
            embedding_layernorm=True,  # BLOOM normalises the word embedding
            layer_norm_epsilon=get("layer_norm_epsilon"), tie_word_embeddings=True)
    raise ValueError(f"Unsupported HF model type for causal import: {mt}")


def seq2seq_config_from_hf(hf_config):
    """Map an HF T5 / mT5 config (a parsed ``config.json`` or a config
    object) to a :class:`~trlx_tpu_torch.models.seq2seq.Seq2SeqConfig`."""
    from trlx_tpu_torch.models.seq2seq import Seq2SeqConfig

    mt, get = _hf_reader(hf_config)
    if mt not in ("t5", "mt5"):
        raise ValueError(f"Unsupported HF model type for seq2seq import: {mt}")
    act = get("feed_forward_proj")
    if act not in ("relu", "gated-gelu"):
        raise ValueError(f"Unsupported T5 feed_forward_proj '{act}' (supported: relu, "
                         "gated-gelu)")
    return Seq2SeqConfig(
        vocab_size=get("vocab_size"), hidden_size=get("d_model"), num_layers=get("num_layers"),
        num_decoder_layers=get("num_decoder_layers") or get("num_layers"),
        num_heads=get("num_heads"), head_dim=get("d_kv"), intermediate_size=get("d_ff"),
        relative_attention_num_buckets=get("relative_attention_num_buckets"),
        relative_attention_max_distance=get("relative_attention_max_distance"),
        layer_norm_epsilon=get("layer_norm_epsilon"), activation=act,
        # v1.0 ties the head and scales the hidden states by d_model**-0.5
        # before it (seq2seq.py::_logits); v1.1 / Flan has its own head
        tie_word_embeddings=bool(get("tie_word_embeddings")),
        decoder_start_token_id=get("decoder_start_token_id") or 0,
        pad_token_id=get("pad_token_id") or 0)


# ---------------------------------------------------------------------------
# import: HF state dict → a tree of JAX's layout (torch leaves)
# ---------------------------------------------------------------------------

def _t(x: torch.Tensor) -> torch.Tensor:
    """Torch ``Linear`` ``[out, in]`` → flax ``[in, out]`` (a view)."""
    return x.t()


def _ln(sd, prefix) -> Dict[str, torch.Tensor]:
    out = {"scale": sd[f"{prefix}.weight"]}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _proj(kernel, bias=None) -> Dict[str, torch.Tensor]:
    out = {"kernel": kernel}
    if bias is not None:
        out["bias"] = bias
    return out


def _split_headmajor_qkv(w: torch.Tensor, b, num_heads: int, head_dim: int):
    """Split a fused qkv whose rows interleave head-major (``[H, 3, D, E]``,
    GPT-NeoX and BLOOM; read as ``[3, H, D]`` it loads without error and
    scrambles the heads) into q/k/v ``[E, H*D]`` kernels and biases."""
    E = w.shape[1]
    w = w.reshape(num_heads, 3, head_dim, E)
    outs = []
    for j in range(3):
        kernel = _t(w[:, j].reshape(num_heads * head_dim, E))
        bias = None if b is None else b.reshape(num_heads, 3, head_dim)[:, j].reshape(-1)
        outs.append((kernel, bias))
    return outs


def _lm_head(sd, cfg, key="lm_head.weight") -> Dict[str, Any]:
    """An untied LM head's entry. A tied family may hold ``lm_head.weight``
    (a copy of the embedding) or leave it out: it is not read then."""
    if cfg.tie_word_embeddings:
        return {}
    if key not in sd:
        raise ValueError(f"the checkpoint has no {key} but its config unties the embedding")
    return {"lm_head": {"kernel": _t(sd[key])}}


def _rotary_attn(sd, lp) -> Dict[str, Any]:
    return {name: _proj(_t(sd[f"{lp}self_attn.{name}.weight"]))
            for name in ("q_proj", "k_proj", "v_proj", "o_proj")}


def convert_gpt2(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, Any]:
    p = "transformer."
    E = cfg.hidden_size
    backbone: Dict[str, Any] = {
        "wte": {"embedding": sd[p + "wte.weight"]},
        "wpe": {"embedding": sd[p + "wpe.weight"]},
        "ln_f": _ln(sd, p + "ln_f"),
    }
    for i in range(cfg.num_layers):
        lp = f"{p}h.{i}."
        # GPT-2's Conv1D weights are already [in, out]: no transpose here
        w = sd[lp + "attn.c_attn.weight"]  # [E, 3E]
        b = sd[lp + "attn.c_attn.bias"]
        backbone[f"h_{i}"] = {
            "ln_attn": _ln(sd, lp + "ln_1"),
            "ln_mlp": _ln(sd, lp + "ln_2"),
            "attn": {
                "q_proj": _proj(w[:, :E], b[:E]),
                "k_proj": _proj(w[:, E: 2 * E], b[E: 2 * E]),
                "v_proj": _proj(w[:, 2 * E:], b[2 * E:]),
                "o_proj": _proj(sd[lp + "attn.c_proj.weight"], sd[lp + "attn.c_proj.bias"]),
            },
            "mlp": {
                "up_proj": _proj(sd[lp + "mlp.c_fc.weight"], sd[lp + "mlp.c_fc.bias"]),
                "down_proj": _proj(sd[lp + "mlp.c_proj.weight"], sd[lp + "mlp.c_proj.bias"]),
            },
        }
    return {"backbone": backbone}


def convert_llama(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, Any]:
    p = "model."
    backbone: Dict[str, Any] = {
        "wte": {"embedding": sd[p + "embed_tokens.weight"]},
        "ln_f": {"scale": sd[p + "norm.weight"]},
        **_lm_head(sd, cfg),
    }
    for i in range(cfg.num_layers):
        lp = f"{p}layers.{i}."
        backbone[f"h_{i}"] = {
            "ln_attn": {"scale": sd[lp + "input_layernorm.weight"]},
            "ln_mlp": {"scale": sd[lp + "post_attention_layernorm.weight"]},
            "attn": _rotary_attn(sd, lp),
            "mlp": {name: _proj(_t(sd[f"{lp}mlp.{name}.weight"]))
                    for name in ("gate_proj", "up_proj", "down_proj")},
        }
    return {"backbone": backbone}


def convert_mixtral(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, Any]:
    """Mixtral (llama attention and a sparse MoE MLP): the experts'
    ``block_sparse_moe.experts.{j}.w1`` / ``w3`` / ``w2`` (``[out, in]``
    Linears) stack into ``w_gate`` / ``w_up`` ``[E, d, f]`` and ``w_down``
    ``[E, f, d]``, the port's (JAX's) layout; the router ``gate`` Linear
    becomes the router."""
    p = "model."
    backbone: Dict[str, Any] = {
        "wte": {"embedding": sd[p + "embed_tokens.weight"]},
        "ln_f": {"scale": sd[p + "norm.weight"]},
        **_lm_head(sd, cfg),
    }
    E = cfg.num_experts
    for i in range(cfg.num_layers):
        lp = f"{p}layers.{i}."
        ep = lp + "block_sparse_moe."

        def experts(name):
            return torch.stack([_t(sd[f"{ep}experts.{e}.{name}.weight"]) for e in range(E)])

        backbone[f"h_{i}"] = {
            "ln_attn": {"scale": sd[lp + "input_layernorm.weight"]},
            "ln_mlp": {"scale": sd[lp + "post_attention_layernorm.weight"]},
            "attn": _rotary_attn(sd, lp),
            "mlp": {"router": {"kernel": _t(sd[ep + "gate.weight"])},
                    "w_gate": experts("w1"), "w_up": experts("w3"), "w_down": experts("w2")},
        }
    return {"backbone": backbone}


def _fused_attn(sd, lp, prefix, cfg) -> Dict[str, Any]:
    """GPT-NeoX's / BLOOM's head-major fused qkv and the output dense."""
    (q_w, q_b), (k_w, k_b), (v_w, v_b) = _split_headmajor_qkv(
        sd[f"{lp}{prefix}.query_key_value.weight"], sd.get(f"{lp}{prefix}.query_key_value.bias"),
        cfg.num_heads, cfg.dims_per_head)
    return {"q_proj": _proj(q_w, q_b), "k_proj": _proj(k_w, k_b), "v_proj": _proj(v_w, v_b),
            "o_proj": _proj(_t(sd[f"{lp}{prefix}.dense.weight"]), sd[f"{lp}{prefix}.dense.bias"])}


def _h_to_4h(sd, lp) -> Dict[str, Any]:
    return {"up_proj": _proj(_t(sd[lp + "mlp.dense_h_to_4h.weight"]),
                             sd[lp + "mlp.dense_h_to_4h.bias"]),
            "down_proj": _proj(_t(sd[lp + "mlp.dense_4h_to_h.weight"]),
                               sd[lp + "mlp.dense_4h_to_h.bias"])}


def convert_gptneox(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, Any]:
    p = "gpt_neox."
    backbone: Dict[str, Any] = {
        "wte": {"embedding": sd[p + "embed_in.weight"]},
        "ln_f": _ln(sd, p + "final_layer_norm"),
        "lm_head": {"kernel": _t(sd["embed_out.weight"])},
    }
    for i in range(cfg.num_layers):
        lp = f"{p}layers.{i}."
        backbone[f"h_{i}"] = {
            "ln_attn": _ln(sd, lp + "input_layernorm"),
            "ln_mlp": _ln(sd, lp + "post_attention_layernorm"),
            "attn": _fused_attn(sd, lp, "attention", cfg),
            "mlp": _h_to_4h(sd, lp),
        }
    return {"backbone": backbone}


def convert_gptj(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, Any]:
    p = "transformer."
    backbone: Dict[str, Any] = {
        "wte": {"embedding": sd[p + "wte.weight"]},
        "ln_f": _ln(sd, p + "ln_f"),
        # GPT-J's LM head has a bias
        "lm_head": {"kernel": _t(sd["lm_head.weight"]), "bias": sd["lm_head.bias"]},
    }
    for i in range(cfg.num_layers):
        lp = f"{p}h.{i}."
        backbone[f"h_{i}"] = {
            "ln_attn": _ln(sd, lp + "ln_1"),
            "attn": {ours: _proj(_t(sd[f"{lp}attn.{theirs}.weight"])) for ours, theirs in (
                ("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"),
                ("o_proj", "out_proj"))},
            "mlp": {
                "up_proj": _proj(_t(sd[lp + "mlp.fc_in.weight"]), sd[lp + "mlp.fc_in.bias"]),
                "down_proj": _proj(_t(sd[lp + "mlp.fc_out.weight"]), sd[lp + "mlp.fc_out.bias"]),
            },
        }
    return {"backbone": backbone}


def convert_opt(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, Any]:
    p = "model.decoder."
    backbone: Dict[str, Any] = {
        "wte": {"embedding": sd[p + "embed_tokens.weight"]},
        # max_position_embeddings + 2 rows: the config's pos_offset reads them
        "wpe": {"embedding": sd[p + "embed_positions.weight"]},
        "ln_f": _ln(sd, p + "final_layer_norm"),
    }
    for i in range(cfg.num_layers):
        lp = f"{p}layers.{i}."
        backbone[f"h_{i}"] = {
            "ln_attn": _ln(sd, lp + "self_attn_layer_norm"),
            "ln_mlp": _ln(sd, lp + "final_layer_norm"),
            "attn": {ours: _proj(_t(sd[f"{lp}self_attn.{theirs}.weight"]),
                                 sd[f"{lp}self_attn.{theirs}.bias"]) for ours, theirs in (
                ("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"),
                ("o_proj", "out_proj"))},
            "mlp": {
                "up_proj": _proj(_t(sd[lp + "fc1.weight"]), sd[lp + "fc1.bias"]),
                "down_proj": _proj(_t(sd[lp + "fc2.weight"]), sd[lp + "fc2.bias"]),
            },
        }
    return {"backbone": backbone}


def convert_bloom(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, Any]:
    p = "transformer."
    backbone: Dict[str, Any] = {
        "wte": {"embedding": sd[p + "word_embeddings.weight"]},
        "emb_ln": _ln(sd, p + "word_embeddings_layernorm"),  # BLOOM's embedding norm
        "ln_f": _ln(sd, p + "ln_f"),
    }
    for i in range(cfg.num_layers):
        lp = f"{p}h.{i}."
        backbone[f"h_{i}"] = {
            "ln_attn": _ln(sd, lp + "input_layernorm"),
            "ln_mlp": _ln(sd, lp + "post_attention_layernorm"),
            "attn": _fused_attn(sd, lp, "self_attention", cfg),
            "mlp": _h_to_4h(sd, lp),
        }
    return {"backbone": backbone}


CONVERTERS: Dict[str, Callable] = {
    "gpt2": convert_gpt2,
    "llama": convert_llama,
    "gpt_neox": convert_gptneox,
    "gptj": convert_gptj,
    "opt": convert_opt,
    "bloom": convert_bloom,
    "mistral": convert_llama,  # llama's key layout, a sliding window in the config
    "mixtral": convert_mixtral,
}


def _t5_attn(sd, prefix) -> Dict[str, Any]:
    return {f"{n}_proj": _proj(_t(sd[f"{prefix}.{n}.weight"])) for n in ("q", "k", "v", "o")}


def _t5_mlp(sd, prefix, gated: bool) -> Dict[str, Any]:
    if gated:
        return {"gate_proj": _proj(_t(sd[prefix + ".wi_0.weight"])),
                "up_proj": _proj(_t(sd[prefix + ".wi_1.weight"])),
                "down_proj": _proj(_t(sd[prefix + ".wo.weight"]))}
    return {"up_proj": _proj(_t(sd[prefix + ".wi.weight"])),
            "down_proj": _proj(_t(sd[prefix + ".wo.weight"]))}


def convert_t5(sd: Dict[str, torch.Tensor], cfg) -> Dict[str, Any]:
    """HF T5 / Flan-T5 state dict → the T5 tree of JAX's layout."""
    gated = cfg.activation == "gated-gelu"
    rel = "block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    # the shared embedding: safetensors saves keep ``shared.weight`` and drop
    # its tied aliases; some checkpoints hold ``encoder.embed_tokens.weight``
    shared = sd["shared.weight"] if "shared.weight" in sd else sd["encoder.embed_tokens.weight"]
    backbone: Dict[str, Any] = {
        "wte": {"embedding": shared},
        "enc_rel_bias": {"rel_bias": {"embedding": sd["encoder." + rel]}},
        "dec_rel_bias": {"rel_bias": {"embedding": sd["decoder." + rel]}},
        "enc_ln_f": {"scale": sd["encoder.final_layer_norm.weight"]},
        "dec_ln_f": {"scale": sd["decoder.final_layer_norm.weight"]},
    }
    for i in range(cfg.num_layers):
        lp = f"encoder.block.{i}."
        backbone[f"enc_{i}"] = {
            "ln_self": {"scale": sd[lp + "layer.0.layer_norm.weight"]},
            "self_attn": _t5_attn(sd, lp + "layer.0.SelfAttention"),
            "ln_mlp": {"scale": sd[lp + "layer.1.layer_norm.weight"]},
            "mlp": _t5_mlp(sd, lp + "layer.1.DenseReluDense", gated),
        }
    for i in range(cfg.num_decoder_layers):
        lp = f"decoder.block.{i}."
        backbone[f"dec_{i}"] = {
            "ln_self": {"scale": sd[lp + "layer.0.layer_norm.weight"]},
            "self_attn": _t5_attn(sd, lp + "layer.0.SelfAttention"),
            "ln_cross": {"scale": sd[lp + "layer.1.layer_norm.weight"]},
            "cross_attn": _t5_attn(sd, lp + "layer.1.EncDecAttention"),
            "ln_mlp": {"scale": sd[lp + "layer.2.layer_norm.weight"]},
            "mlp": _t5_mlp(sd, lp + "layer.2.DenseReluDense", gated),
        }
    backbone.update(_lm_head(sd, cfg))
    return {"backbone": backbone}


def _hf_source(model) -> Tuple[Dict[str, torch.Tensor], Any]:
    """An HF torch model's ``(state_dict, config)``."""
    return {k: v.detach() for k, v in model.state_dict().items()}, model.config


def params_from_hf(model, cfg: Optional[TransformerConfig] = None
                   ) -> Tuple[Dict[str, torch.Tensor], TransformerConfig]:
    """A loaded HF causal LM (anything with ``state_dict()`` and
    ``config``) → ``(the port's state_dict, config)``, its tensors in the
    model's type and on its device."""
    sd, hf_config = _hf_source(model)
    cfg = cfg or config_from_hf(hf_config)
    return params_from_jax(CONVERTERS[cfg.model_type](sd, cfg), cfg), cfg


def seq2seq_params_from_hf(model, cfg=None):
    """A loaded HF T5 → ``(the port's state_dict, Seq2SeqConfig)``."""
    sd, hf_config = _hf_source(model)
    cfg = cfg or seq2seq_config_from_hf(hf_config)
    return seq2seq_params_from_jax(convert_t5(sd, cfg), cfg), cfg


def load_pretrained(path: str, device: Device = None, cfg: Optional[TransformerConfig] = None
                    ) -> Tuple[Dict[str, torch.Tensor], TransformerConfig]:
    """A local HF causal-LM checkpoint directory → ``(the port's backbone
    state_dict, config)``, the tensors in their stored type on ``device``
    (None: the card; the CPU only when named). A transposed kernel is a
    view of the tensor read, not a copy. ``cfg`` (the directory's config
    with overrides) converts the layers it has: a cut depth reads the first
    ``num_layers``."""
    cfg = cfg or config_from_hf(read_hf_config(path))
    sd = read_hf_state_dict(path, device)
    return params_from_jax(CONVERTERS[cfg.model_type](sd, cfg), cfg), cfg


def load_pretrained_seq2seq(path: str, device: Device = None, cfg=None):
    """:func:`load_pretrained` for T5: ``(state_dict, Seq2SeqConfig)``."""
    cfg = cfg or seq2seq_config_from_hf(read_hf_config(path))
    sd = read_hf_state_dict(path, device)
    return seq2seq_params_from_jax(convert_t5(sd, cfg), cfg), cfg


_ADAPTERS = ("lora_a", "lora_b")


def import_backbone(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor],
                    device: Device) -> List[str]:
    """Make an imported backbone ``state_dict`` the backbone parameters of
    ``model``, which was built on ``meta``: JAX's ``_import_hf_backbone``.
    Each tensor is moved to ``device`` and cast to its parameter's type
    (no copy where it has them and is contiguous) and taken out of
    ``state_dict``, so the checkpoint's tensors go as the model fills.
    Every other parameter — the heads and LoRA adapters — is left
    allocated on ``device`` and not drawn; their names are returned, in
    registration order, for the caller to draw. A key the backbone lacks,
    a backbone weight the checkpoint lacks (a converter that leaves one
    out would otherwise keep it random) and a shape mismatch raise."""
    prefix = "backbone." if hasattr(model, "backbone") else ""
    own = {k[len(prefix):]: p for k, p in model.named_parameters() if k.startswith(prefix)}
    unknown = sorted(set(state_dict) - set(own))
    if unknown:
        raise ValueError(f"imported weights the model does not have: {unknown[:8]}")
    missing = sorted(k for k in set(own) - set(state_dict) if not k.endswith(_ADAPTERS))
    if missing:
        raise ValueError(f"backbone weights the checkpoint import lacks: {missing[:8]}")
    for key, value in state_dict.items():
        if own[key].shape != value.shape:
            raise ValueError(f"{key}: checkpoint shape {tuple(value.shape)} != the "
                             f"model's {tuple(own[key].shape)}")
    device = resolve_device(device)
    left = []
    for name, module in model.named_modules():
        for leaf, p in list(module.named_parameters(prefix=name, recurse=False)):
            key = leaf[len(prefix):] if leaf.startswith(prefix) else None
            if key in state_dict:
                data = state_dict.pop(key).to(device=device, dtype=p.dtype).contiguous()
            else:
                data = torch.empty(p.shape, dtype=p.dtype, device=device)
                left.append(leaf)
            module.register_parameter(leaf.rpartition(".")[2],
                                      torch.nn.Parameter(data, requires_grad=p.requires_grad))
    return left


# ---------------------------------------------------------------------------
# export: the port's state_dict → HF (torch) checkpoint directory
#
# The inverse of the converters, with the reference's head merging: value
# and ILQL heads go into the state dict under ``v_head.`` / ``ilql_heads.``
# with the reference's own module names (``trlx/models/modeling_ppo.py:
# 306-328``, ``modeling_ilql.py:322-344``), so an export loads in plain
# ``transformers`` (heads ignored) and in reference trlx (heads re-split).
# ---------------------------------------------------------------------------


def _fuse_headmajor_qkv(attn: Dict[str, Any], num_heads: int, head_dim: int):
    """Inverse of :func:`_split_headmajor_qkv`: q/k/v kernels ``[E, H*D]`` →
    the fused ``[3*H*D, E]`` weight, head-major (and the fused bias)."""
    E = attn["q_proj"]["kernel"].shape[0]
    names = ("q_proj", "k_proj", "v_proj")
    w = torch.stack([_t(attn[n]["kernel"]).reshape(num_heads, head_dim, E) for n in names],
                    dim=1).reshape(num_heads * 3 * head_dim, E)
    b = None
    if "bias" in attn["q_proj"]:
        b = torch.stack([attn[n]["bias"].reshape(num_heads, head_dim) for n in names],
                        dim=1).reshape(-1)
    return w, b


def _put_ln(sd, prefix: str, ln: Dict[str, Any]) -> None:
    sd[f"{prefix}.weight"] = ln["scale"]
    if "bias" in ln:
        sd[f"{prefix}.bias"] = ln["bias"]


def _put_linear(sd, prefix, proj, transpose=True) -> None:
    sd[f"{prefix}.weight"] = _t(proj["kernel"]) if transpose else proj["kernel"]
    if "bias" in proj:
        sd[f"{prefix}.bias"] = proj["bias"]


def export_gpt2(backbone: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    p = "transformer."
    sd: Dict[str, torch.Tensor] = {p + "wte.weight": backbone["wte"]["embedding"],
                                   p + "wpe.weight": backbone["wpe"]["embedding"]}
    _put_ln(sd, p + "ln_f", backbone["ln_f"])
    for i in range(cfg.num_layers):
        lp = f"{p}h.{i}."
        h = backbone[f"h_{i}"]
        _put_ln(sd, lp + "ln_1", h["ln_attn"])
        _put_ln(sd, lp + "ln_2", h["ln_mlp"])
        attn = h["attn"]
        # Conv1D's [in, out]: the kernels go in untransposed
        names = ("q_proj", "k_proj", "v_proj")
        sd[lp + "attn.c_attn.weight"] = torch.cat([attn[k]["kernel"] for k in names], dim=1)
        sd[lp + "attn.c_attn.bias"] = torch.cat([attn[k]["bias"] for k in names])
        _put_linear(sd, lp + "attn.c_proj", attn["o_proj"], transpose=False)
        _put_linear(sd, lp + "mlp.c_fc", h["mlp"]["up_proj"], transpose=False)
        _put_linear(sd, lp + "mlp.c_proj", h["mlp"]["down_proj"], transpose=False)
    sd["lm_head.weight"] = sd[p + "wte.weight"]  # tied
    return sd


def _export_lm_head(sd, backbone, cfg, embedding_key: str) -> None:
    sd["lm_head.weight"] = (sd[embedding_key] if cfg.tie_word_embeddings
                            else _t(backbone["lm_head"]["kernel"]))


def _put_rotary_attn(sd, lp, attn) -> None:
    for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
        _put_linear(sd, f"{lp}self_attn.{name}", attn[name])


def export_llama(backbone: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    p = "model."
    sd: Dict[str, torch.Tensor] = {p + "embed_tokens.weight": backbone["wte"]["embedding"],
                                   p + "norm.weight": backbone["ln_f"]["scale"]}
    _export_lm_head(sd, backbone, cfg, p + "embed_tokens.weight")
    for i in range(cfg.num_layers):
        lp = f"{p}layers.{i}."
        h = backbone[f"h_{i}"]
        sd[lp + "input_layernorm.weight"] = h["ln_attn"]["scale"]
        sd[lp + "post_attention_layernorm.weight"] = h["ln_mlp"]["scale"]
        _put_rotary_attn(sd, lp, h["attn"])
        for name in ("gate_proj", "up_proj", "down_proj"):
            _put_linear(sd, f"{lp}mlp.{name}", h["mlp"][name])
    return sd


def _put_fused_attn(sd, lp, prefix, attn, cfg) -> None:
    w, b = _fuse_headmajor_qkv(attn, cfg.num_heads, cfg.dims_per_head)
    sd[f"{lp}{prefix}.query_key_value.weight"] = w
    if b is not None:
        sd[f"{lp}{prefix}.query_key_value.bias"] = b
    _put_linear(sd, f"{lp}{prefix}.dense", attn["o_proj"])


def _put_h_to_4h(sd, lp, mlp) -> None:
    _put_linear(sd, lp + "mlp.dense_h_to_4h", mlp["up_proj"])
    _put_linear(sd, lp + "mlp.dense_4h_to_h", mlp["down_proj"])


def export_gptneox(backbone: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    p = "gpt_neox."
    sd: Dict[str, torch.Tensor] = {p + "embed_in.weight": backbone["wte"]["embedding"],
                                   "embed_out.weight": _t(backbone["lm_head"]["kernel"])}
    _put_ln(sd, p + "final_layer_norm", backbone["ln_f"])
    for i in range(cfg.num_layers):
        lp = f"{p}layers.{i}."
        h = backbone[f"h_{i}"]
        _put_ln(sd, lp + "input_layernorm", h["ln_attn"])
        _put_ln(sd, lp + "post_attention_layernorm", h["ln_mlp"])
        _put_fused_attn(sd, lp, "attention", h["attn"], cfg)
        _put_h_to_4h(sd, lp, h["mlp"])
    return sd


def export_gptj(backbone: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    p = "transformer."
    sd: Dict[str, torch.Tensor] = {p + "wte.weight": backbone["wte"]["embedding"],
                                   "lm_head.weight": _t(backbone["lm_head"]["kernel"]),
                                   "lm_head.bias": backbone["lm_head"]["bias"]}
    _put_ln(sd, p + "ln_f", backbone["ln_f"])
    for i in range(cfg.num_layers):
        lp = f"{p}h.{i}."
        h = backbone[f"h_{i}"]
        _put_ln(sd, lp + "ln_1", h["ln_attn"])
        for ours, theirs in (("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"),
                             ("o_proj", "out_proj")):
            _put_linear(sd, f"{lp}attn.{theirs}", h["attn"][ours])
        _put_linear(sd, lp + "mlp.fc_in", h["mlp"]["up_proj"])
        _put_linear(sd, lp + "mlp.fc_out", h["mlp"]["down_proj"])
    return sd


def export_opt(backbone: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    p = "model.decoder."
    sd: Dict[str, torch.Tensor] = {p + "embed_tokens.weight": backbone["wte"]["embedding"],
                                   p + "embed_positions.weight": backbone["wpe"]["embedding"],
                                   "lm_head.weight": backbone["wte"]["embedding"]}  # tied
    _put_ln(sd, p + "final_layer_norm", backbone["ln_f"])
    for i in range(cfg.num_layers):
        lp = f"{p}layers.{i}."
        h = backbone[f"h_{i}"]
        _put_ln(sd, lp + "self_attn_layer_norm", h["ln_attn"])
        _put_ln(sd, lp + "final_layer_norm", h["ln_mlp"])
        for ours, theirs in (("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"),
                             ("o_proj", "out_proj")):
            _put_linear(sd, f"{lp}self_attn.{theirs}", h["attn"][ours])
        _put_linear(sd, lp + "fc1", h["mlp"]["up_proj"])
        _put_linear(sd, lp + "fc2", h["mlp"]["down_proj"])
    return sd


def export_bloom(backbone: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    p = "transformer."
    sd: Dict[str, torch.Tensor] = {p + "word_embeddings.weight": backbone["wte"]["embedding"],
                                   "lm_head.weight": backbone["wte"]["embedding"]}  # tied
    _put_ln(sd, p + "word_embeddings_layernorm", backbone["emb_ln"])
    _put_ln(sd, p + "ln_f", backbone["ln_f"])
    for i in range(cfg.num_layers):
        lp = f"{p}h.{i}."
        h = backbone[f"h_{i}"]
        _put_ln(sd, lp + "input_layernorm", h["ln_attn"])
        _put_ln(sd, lp + "post_attention_layernorm", h["ln_mlp"])
        _put_fused_attn(sd, lp, "self_attention", h["attn"], cfg)
        _put_h_to_4h(sd, lp, h["mlp"])
    return sd


def export_mixtral(backbone: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`convert_mixtral`: the expert stacks unstack into the
    per-expert ``w1`` / ``w3`` / ``w2`` Linears of ``MixtralForCausalLM``."""
    p = "model."
    sd: Dict[str, torch.Tensor] = {p + "embed_tokens.weight": backbone["wte"]["embedding"],
                                   p + "norm.weight": backbone["ln_f"]["scale"]}
    _export_lm_head(sd, backbone, cfg, p + "embed_tokens.weight")
    for i in range(cfg.num_layers):
        lp = f"{p}layers.{i}."
        ep = lp + "block_sparse_moe."
        h = backbone[f"h_{i}"]
        sd[lp + "input_layernorm.weight"] = h["ln_attn"]["scale"]
        sd[lp + "post_attention_layernorm.weight"] = h["ln_mlp"]["scale"]
        _put_rotary_attn(sd, lp, h["attn"])
        mlp = h["mlp"]
        sd[ep + "gate.weight"] = _t(mlp["router"]["kernel"])
        for e in range(cfg.num_experts):
            for theirs, ours in (("w1", "w_gate"), ("w3", "w_up"), ("w2", "w_down")):
                sd[f"{ep}experts.{e}.{theirs}.weight"] = _t(mlp[ours][e])
    return sd


def export_t5(backbone: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`convert_t5`: the T5 tree → an HF
    ``T5ForConditionalGeneration`` state dict."""
    gated = cfg.activation == "gated-gelu"
    shared = backbone["wte"]["embedding"]
    rel = "block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    sd: Dict[str, torch.Tensor] = {
        "shared.weight": shared,
        # the tied aliases transformers keeps in its own state dicts
        "encoder.embed_tokens.weight": shared,
        "decoder.embed_tokens.weight": shared,
        "encoder." + rel: backbone["enc_rel_bias"]["rel_bias"]["embedding"],
        "decoder." + rel: backbone["dec_rel_bias"]["rel_bias"]["embedding"],
        "encoder.final_layer_norm.weight": backbone["enc_ln_f"]["scale"],
        "decoder.final_layer_norm.weight": backbone["dec_ln_f"]["scale"],
    }

    def put_attn(prefix: str, attn: Dict[str, Any]) -> None:
        for n in ("q", "k", "v", "o"):
            sd[f"{prefix}.{n}.weight"] = _t(attn[f"{n}_proj"]["kernel"])

    def put_mlp(prefix: str, mlp: Dict[str, Any]) -> None:
        if gated:
            sd[f"{prefix}.wi_0.weight"] = _t(mlp["gate_proj"]["kernel"])
            sd[f"{prefix}.wi_1.weight"] = _t(mlp["up_proj"]["kernel"])
        else:
            sd[f"{prefix}.wi.weight"] = _t(mlp["up_proj"]["kernel"])
        sd[f"{prefix}.wo.weight"] = _t(mlp["down_proj"]["kernel"])

    for i in range(cfg.num_layers):
        lp = f"encoder.block.{i}."
        h = backbone[f"enc_{i}"]
        sd[lp + "layer.0.layer_norm.weight"] = h["ln_self"]["scale"]
        put_attn(lp + "layer.0.SelfAttention", h["self_attn"])
        sd[lp + "layer.1.layer_norm.weight"] = h["ln_mlp"]["scale"]
        put_mlp(lp + "layer.1.DenseReluDense", h["mlp"])
    for i in range(cfg.num_decoder_layers):
        lp = f"decoder.block.{i}."
        h = backbone[f"dec_{i}"]
        sd[lp + "layer.0.layer_norm.weight"] = h["ln_self"]["scale"]
        put_attn(lp + "layer.0.SelfAttention", h["self_attn"])
        sd[lp + "layer.1.layer_norm.weight"] = h["ln_cross"]["scale"]
        put_attn(lp + "layer.1.EncDecAttention", h["cross_attn"])
        sd[lp + "layer.2.layer_norm.weight"] = h["ln_mlp"]["scale"]
        put_mlp(lp + "layer.2.DenseReluDense", h["mlp"])
    sd["lm_head.weight"] = shared if cfg.tie_word_embeddings else _t(backbone["lm_head"]["kernel"])
    return sd


EXPORTERS: Dict[str, Callable] = {
    "gpt2": export_gpt2,
    "llama": export_llama,
    "gpt_neox": export_gptneox,
    "gptj": export_gptj,
    "opt": export_opt,
    "bloom": export_bloom,
    "t5": export_t5,
    "mistral": export_llama,  # llama's key layout
    "mixtral": export_mixtral,
}


def _export_mlp_head(sd, prefix: str, head: Dict[str, Any]) -> None:
    """An ``MLPHead`` → the reference ``make_head``'s ``Sequential(Linear,
    ReLU, Linear)`` names: ``{prefix}.0.*`` / ``{prefix}.2.*``."""
    _put_linear(sd, f"{prefix}.0", head["in_proj"])
    _put_linear(sd, f"{prefix}.2", head["out_proj"])


def merge_heads_into_state_dict(sd: Dict[str, torch.Tensor], params: Dict[str, Any]) -> None:
    """Fold the value or ILQL heads of ``params`` (a tree of JAX's layout)
    into ``sd`` under the reference's key names (``modeling_ppo.py:
    306-328``, ``modeling_ilql.py:322-344``)."""
    if "v_head" in params:
        _export_mlp_head(sd, "v_head", params["v_head"])
    if "ilql_heads" in params:
        heads = params["ilql_heads"]
        _export_mlp_head(sd, "ilql_heads.heads.v_head", heads["v_head"])
        for name, tree in sorted(heads.items()):
            if name.startswith("q_head_"):
                _export_mlp_head(sd, f"ilql_heads.heads.q_heads.{name[len('q_head_'):]}", tree)
            elif name.startswith("target_q_head_"):
                _export_mlp_head(
                    sd, f"ilql_heads.heads.target_q_heads.{name[len('target_q_head_'):]}", tree)


_ARCHITECTURES = {
    "gpt2": "GPT2LMHeadModel", "llama": "LlamaForCausalLM", "mistral": "MistralForCausalLM",
    "mixtral": "MixtralForCausalLM", "gpt_neox": "GPTNeoXForCausalLM", "gptj": "GPTJForCausalLM",
    "opt": "OPTForCausalLM", "bloom": "BloomForCausalLM", "t5": "T5ForConditionalGeneration",
}


def hf_config_from_transformer(cfg) -> Dict[str, Any]:
    """Inverse of :func:`config_from_hf`: the port's config → the HF
    ``config.json`` of its family (``transformers``' key names, with
    ``model_type`` and ``architectures``); a key left out reads the
    family's ``transformers`` default, as JAX's config object has it."""
    mt = getattr(cfg, "model_type", None)
    if mt == "t5":
        keys = dict(vocab_size=cfg.vocab_size, d_model=cfg.hidden_size, d_kv=cfg.head_dim,
                    d_ff=cfg.intermediate_size, num_layers=cfg.num_layers,
                    num_decoder_layers=cfg.num_decoder_layers, num_heads=cfg.num_heads,
                    relative_attention_num_buckets=cfg.relative_attention_num_buckets,
                    relative_attention_max_distance=cfg.relative_attention_max_distance,
                    layer_norm_epsilon=cfg.layer_norm_epsilon, feed_forward_proj=cfg.activation,
                    tie_word_embeddings=cfg.tie_word_embeddings,
                    decoder_start_token_id=cfg.decoder_start_token_id,
                    pad_token_id=cfg.pad_token_id)
    elif mt == "gpt2":
        keys = dict(vocab_size=cfg.vocab_size, n_positions=cfg.max_position_embeddings,
                    n_embd=cfg.hidden_size, n_layer=cfg.num_layers, n_head=cfg.num_heads,
                    n_inner=cfg.intermediate_size, layer_norm_epsilon=cfg.layer_norm_epsilon)
    elif mt in ("llama", "mistral", "mixtral"):
        keys = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                    num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
                    num_key_value_heads=cfg.kv_heads, intermediate_size=cfg.intermediate_size,
                    max_position_embeddings=cfg.max_position_embeddings,
                    rms_norm_eps=cfg.layer_norm_epsilon, rope_theta=cfg.rope_theta,
                    tie_word_embeddings=cfg.tie_word_embeddings)
        if mt == "mistral":
            keys.update(head_dim=cfg.dims_per_head, sliding_window=cfg.sliding_window)
        if mt == "mixtral":
            keys.update(num_local_experts=cfg.num_experts,
                        num_experts_per_tok=cfg.num_experts_per_tok,
                        router_aux_loss_coef=cfg.router_aux_coef,
                        sliding_window=cfg.sliding_window)
    elif mt == "gpt_neox":
        keys = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                    num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
                    intermediate_size=cfg.intermediate_size,
                    max_position_embeddings=cfg.max_position_embeddings,
                    rotary_pct=(cfg.rotary_dim or cfg.dims_per_head) / cfg.dims_per_head,
                    rotary_emb_base=cfg.rope_theta, use_parallel_residual=cfg.parallel_residual,
                    layer_norm_eps=cfg.layer_norm_epsilon, tie_word_embeddings=False)
    elif mt == "gptj":
        keys = dict(vocab_size=cfg.vocab_size, n_positions=cfg.max_position_embeddings,
                    n_embd=cfg.hidden_size, n_layer=cfg.num_layers, n_head=cfg.num_heads,
                    n_inner=cfg.intermediate_size, rotary_dim=cfg.rotary_dim,
                    layer_norm_epsilon=cfg.layer_norm_epsilon, tie_word_embeddings=False)
    elif mt == "opt":
        keys = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                    num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
                    ffn_dim=cfg.intermediate_size,
                    max_position_embeddings=cfg.max_position_embeddings,
                    activation_function=cfg.activation, word_embed_proj_dim=cfg.hidden_size,
                    do_layer_norm_before=True)
    elif mt == "bloom":
        keys = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                    n_layer=cfg.num_layers, n_head=cfg.num_heads,
                    layer_norm_epsilon=cfg.layer_norm_epsilon)
    else:
        raise UnsupportedHFExport(f"No HF export mapping for model_type={mt!r} (set the "
                                  "config's model_type to an HF family)")
    return {"model_type": mt, "architectures": [_ARCHITECTURES[mt]], **keys}


def params_to_hf_state_dict(state_dict: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (a backbone, or a policy with its heads) →
    an HF torch-layout state dict, LoRA adapters folded into their weights
    (the reference exports merged weights too) and the heads merged under
    the reference's prefixes. The port keeps per-layer modules whatever
    ``scan_layers`` says, so there is no stack to undo."""
    from trlx_tpu_torch.models.builder import merge_lora_params

    mt = getattr(cfg, "model_type", None)
    if mt not in EXPORTERS:
        raise UnsupportedHFExport(
            f"No HF exporter for model_type={mt!r}; known: {sorted(EXPORTERS)}")
    params = params_to_jax(merge_lora_params(state_dict, cfg))
    sd = EXPORTERS[mt](params.get("backbone", params), cfg)
    if "backbone" in params:
        merge_heads_into_state_dict(sd, params)
    return sd


_TOKENIZER_FILES = ("vocab.json", "merges.txt", "special_tokens_map.json")


def save_pretrained_hf(directory: str, state_dict: Dict[str, torch.Tensor], cfg,
                       tokenizer_path: Optional[str] = None) -> None:
    """Write a ``transformers``-loadable checkpoint directory:
    ``pytorch_model.bin`` (f32 CPU tensors, the heads merged under their
    reference prefixes) and ``config.json``; the tokenizer's files are
    copied when ``tokenizer_path`` is a local directory. The reference's
    ``save_pretrained`` contract (``accelerate_base_trainer.py:256-272``)."""
    os.makedirs(directory, exist_ok=True)
    sd = params_to_hf_state_dict(state_dict, cfg)
    # a fresh f32 host copy each: no view saves its whole base storage
    tensors = {k: torch.empty(v.shape, dtype=torch.float32).copy_(v.detach())
               for k, v in sd.items()}
    torch.save(tensors, os.path.join(directory, "pytorch_model.bin"))
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(hf_config_from_transformer(cfg), f, indent=2)
    if tokenizer_path and os.path.isdir(tokenizer_path):
        for name in os.listdir(tokenizer_path):
            if "token" in name or name in _TOKENIZER_FILES:
                shutil.copy(os.path.join(tokenizer_path, name), directory)
