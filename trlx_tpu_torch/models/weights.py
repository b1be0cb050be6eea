"""Weights carried across from the JAX package.

:func:`params_from_jax` turns a JAX ``CausalTransformer`` parameter tree,
given as nested dicts of numpy arrays, into the port's ``state_dict``:

- flax ``Dense`` kernels are ``[in, out]``; ``torch.nn.Linear`` weights are
  ``[out, in]`` — every kernel is transposed;
- tied embeddings: the LM head reuses ``wte`` (no ``lm_head`` entry); an
  untied ``lm_head`` carries its bias where the family has one (gptj);
- the families' trees: RMSNorm scales without a bias, the gated MLP's
  ``gate_proj``, bloom's ``emb_ln``, no ``wpe`` under rotary or ALiBi
  positions and no ``ln_mlp`` under gptj's shared norm;
- the MoE MLP (mixtral): the router ``Dense`` transposed like any kernel,
  the experts' ``w_gate`` / ``w_up`` ``[E, d, f]`` and ``w_down`` ``[E, f, d]``
  as they are (the port keeps the JAX layout);
- layers come as ``h_{i}`` subtrees (the unscanned layout). A scanned tree
  (``h_scan/block`` with a leading layer axis, ``stack_layer_params``) is
  sliced back into ``h_{i}`` first, as ``unstack_layer_params`` does (a
  scanned hydra reference's stack into the top layers' indices);
- a value-head policy's tree (``backbone`` + ``v_head``) maps onto
  :class:`~trlx_tpu_torch.models.heads.CausalLMWithValueHead`
  (``backbone.*`` and ``v_head.in_proj`` / ``v_head.out_proj``), an ILQL
  policy's (``backbone`` + ``ilql_heads/{v_head, q_head_i,
  target_q_head_i}``) onto
  :class:`~trlx_tpu_torch.models.heads.CausalLMWithILQLHeads`
  (``ilql_heads.<head>.in_proj`` / ``out_proj``);
- LoRA adapters (``lora_a`` ``[in, r]``, ``lora_b`` ``[r, out]``) beside a
  projection's kernel keep the JAX layout (``LoRALinear``'s);
- a reward model's tree (``backbone`` + ``r_head``) maps onto
  :class:`~trlx_tpu_torch.models.reward.RewardModel` (``backbone.*`` and
  ``r_head.weight``, the bias-free kernel transposed);
- a hydra reference subtree (``builder.py::hydra_ref_params``: the top
  ``h_{i}``, ``ln_f`` and ``wte`` or ``lm_head``) maps onto
  :class:`~trlx_tpu_torch.models.transformer.HydraBranch`: only the entries
  present are converted.

:func:`seq2seq_params_from_jax` does the same for a JAX ``T5Transformer``
tree (``enc_{i}`` / ``dec_{i}`` → ``enc_blocks.{i}`` / ``dec_blocks.{i}``,
the bias tables' ``rel_bias`` embeddings, the two final norms, an untied
``lm_head``), a seq2seq value-head or ILQL policy, and the seq2seq hydra
reference subtree (``seq2seq_hydra_ref_params``), which maps onto
:class:`~trlx_tpu_torch.models.seq2seq.Seq2SeqHydraBranch`.

A tree's leaves may also be torch tensors (``models/hf_interop.py`` builds
JAX's layout from a Hugging Face checkpoint read straight into torch, bf16
included): they keep their type and device, and are not copied (a
transposed kernel stays a view); numpy or JAX leaves are copied from the
host in the config's ``param_dtype``. :func:`params_to_jax` is the inverse, the
port's ``state_dict`` as a tree of JAX's layout with torch leaves, which
the HF exporters read.
"""

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from trlx_tpu_torch.models.transformer import TransformerConfig

__all__ = ["jax_param_path", "params_from_jax", "params_to_jax", "seq2seq_params_from_jax"]


def _leaf(param_dtype):
    """Leaf → torch tensor: a torch leaf as it is (its type, its device, no
    copy); a numpy or JAX leaf copied from the host in ``param_dtype``."""

    def t(x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.tensor(np.asarray(x), dtype=param_dtype)

    return t


def _transpose(x):
    return x.t() if isinstance(x, torch.Tensor) else np.asarray(x).T


def _unstack(backbone: Dict[str, Any], num_layers: int) -> Dict[str, Any]:
    """A scanned tree's ``h_scan/block`` (leading layer axis) as ``h_{i}``
    subtrees. A hydra reference's stack holds the top layers only, so its
    k entries are layers ``num_layers - k`` and up."""
    if "h_scan" not in backbone:
        return backbone
    out = {k: v for k, v in backbone.items() if k != "h_scan"}
    stacked = backbone["h_scan"]["block"]

    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    first = stacked
    while isinstance(first, dict):
        first = next(iter(first.values()))
    count = np.asarray(first).shape[0]
    for i in range(count):
        out[f"h_{num_layers - count + i}"] = take(stacked, i)
    return out


def params_from_jax(np_params: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy or torch leaves) → the port's ``state_dict``."""
    tree = np_params.get("backbone", np_params)
    tree = _unstack(tree, cfg.num_layers)
    t = _leaf(cfg.param_dtype)

    sd: Dict[str, torch.Tensor] = {}
    for name in ("wte", "wpe"):
        if name in tree:
            sd[f"{name}.weight"] = t(tree[name]["embedding"])

    dense, norm = _converters(sd, t)
    if "emb_ln" in tree:
        norm("emb_ln", tree["emb_ln"])
    for i in range(cfg.num_layers):
        if f"h_{i}" not in tree:  # a hydra reference holds the top layers only
            continue
        layer = tree[f"h_{i}"]
        p = f"blocks.{i}"
        for ln in ("ln_attn", "ln_mlp"):  # gptj's shared norm has no ln_mlp
            if ln in layer:
                norm(f"{p}.{ln}", layer[ln])
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            dense(f"{p}.attn.{proj}", layer["attn"][proj])
        for proj in ("gate_proj", "up_proj", "down_proj"):  # gate: the gated MLP
            if proj in layer["mlp"]:
                dense(f"{p}.mlp.{proj}", layer["mlp"][proj])
        if "router" in layer["mlp"]:  # the MoE MLP: experts keep the JAX layout
            dense(f"{p}.mlp.router", layer["mlp"]["router"])
            for name in ("w_gate", "w_up", "w_down"):
                if name in layer["mlp"]:
                    sd[f"{p}.mlp.{name}"] = t(layer["mlp"][name])
    if cfg.final_norm:
        norm("ln_f", tree["ln_f"])
    if not cfg.tie_word_embeddings:
        dense("lm_head", tree["lm_head"])
    return _with_heads(sd, np_params, t)


def _converters(sd: Dict[str, torch.Tensor], t):
    """``(dense, norm)``: write a flax ``Dense`` (kernel transposed, a bias
    and LoRA adapters in the JAX layout) or a norm (its scale, and a
    LayerNorm's bias) into ``sd`` under a prefix."""

    def dense(prefix, node):
        sd[f"{prefix}.weight"] = t(_transpose(node["kernel"]))
        for name in ("bias", "lora_a", "lora_b"):  # adapters keep the JAX layout
            if name in node:
                sd[f"{prefix}.{name}"] = t(node[name])

    def norm(prefix, node):  # RMSNorm has a scale alone
        sd[f"{prefix}.weight"] = t(node["scale"])
        if "bias" in node:
            sd[f"{prefix}.bias"] = t(node["bias"])

    return dense, norm


def _with_heads(sd, np_params, t) -> Dict[str, torch.Tensor]:
    """A policy's tree: the backbone's entries under ``backbone.`` and the
    value, ILQL or reward heads beside them; a bare tree as it is."""
    heads = {}
    if "v_head" in np_params:
        heads["v_head"] = np_params["v_head"]
    for name, node in np_params.get("ilql_heads", {}).items():
        heads[f"ilql_heads.{name}"] = node
    if not heads and "r_head" not in np_params:
        return sd
    sd = {f"backbone.{k}": v for k, v in sd.items()}
    dense, _ = _converters(sd, t)
    for prefix, node in heads.items():
        for proj in ("in_proj", "out_proj"):
            dense(f"{prefix}.{proj}", node[proj])
    if "r_head" in np_params:
        dense("r_head", np_params["r_head"])
    return sd


def seq2seq_params_from_jax(np_params: Dict[str, Any], scfg) -> Dict[str, torch.Tensor]:
    """JAX seq2seq parameter tree (numpy or torch leaves) → the port's
    ``state_dict`` (a bare ``T5Transformer``, a value-head or ILQL policy,
    or a hydra reference subtree, whose absent entries are skipped)."""
    tree = np_params.get("backbone", np_params)
    t = _leaf(scfg.param_dtype)

    sd: Dict[str, torch.Tensor] = {}
    dense, norm = _converters(sd, t)
    if "wte" in tree:
        sd["wte.weight"] = t(tree["wte"]["embedding"])
    for name in ("enc_rel_bias", "dec_rel_bias"):
        if name in tree:
            sd[f"{name}.rel_bias.weight"] = t(tree[name]["rel_bias"]["embedding"])
    for name in ("enc_ln_f", "dec_ln_f"):
        if name in tree:
            norm(name, tree[name])
    if "lm_head" in tree:
        dense("lm_head", tree["lm_head"])
    stacks = (("enc", scfg.num_layers, ("self_attn",), ("ln_self", "ln_mlp")),
              ("dec", scfg.num_decoder_layers, ("self_attn", "cross_attn"),
               ("ln_self", "ln_cross", "ln_mlp")))
    for stack, depth, attns, norms in stacks:
        for i in range(depth):
            if f"{stack}_{i}" not in tree:  # a hydra reference holds the top blocks only
                continue
            layer, p = tree[f"{stack}_{i}"], f"{stack}_blocks.{i}"
            for ln in norms:
                norm(f"{p}.{ln}", layer[ln])
            for attn in attns:
                for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
                    dense(f"{p}.{attn}.{proj}", layer[attn][proj])
            for proj in ("gate_proj", "up_proj", "down_proj"):  # gate: gated-GELU
                if proj in layer["mlp"]:
                    dense(f"{p}.mlp.{proj}", layer["mlp"][proj])
    return _with_heads(sd, np_params, t)


_EMBEDDINGS = ("wte", "wpe", "rel_bias")
_NORMS = ("ln_attn", "ln_mlp", "ln_f", "emb_ln", "ln_self", "ln_cross", "enc_ln_f", "dec_ln_f")
_STACKS = {"blocks": "h", "enc_blocks": "enc", "dec_blocks": "dec"}
# the head modules of a policy's state dict (its backbone then sits under
# ``backbone.``)
HEAD_PREFIXES = ("v_head", "ilql_heads", "r_head")


def jax_param_path(key: str, wrapped: bool) -> Tuple[Tuple[str, ...], bool]:
    """The JAX tree path of a key of the port's ``state_dict`` and whether
    the tensor is the transpose of JAX's leaf (a Linear weight ``[out, in]``
    against flax's ``[in, out]`` kernel). ``wrapped``: the state dict is a
    policy's, its backbone under ``backbone.``. Layers map to ``h_{i}`` /
    ``enc_{i}`` / ``dec_{i}``, the unscanned layout."""
    parts = key.split(".")
    path: List[str] = []
    if wrapped and parts[0] == "backbone":
        parts, path = parts[1:], ["backbone"]
    i = 0
    while i < len(parts) - 1:
        if parts[i] in _STACKS:
            path.append(f"{_STACKS[parts[i]]}_{parts[i + 1]}")
            i += 2
        else:
            path.append(parts[i])
            i += 1
    leaf, module = parts[-1], path[-1] if path else ""
    if module in _EMBEDDINGS:
        return tuple(path + ["embedding"]), False
    if module in _NORMS:
        return tuple(path + ["scale" if leaf == "weight" else leaf]), False
    if leaf == "weight":
        return tuple(path + ["kernel"]), True
    # a bias, a LoRA adapter or the MoE experts (``mlp.w_*``)
    return tuple(path + [leaf]), False


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax` and
    :func:`seq2seq_params_from_jax`: the port's ``state_dict`` (a bare
    backbone, or a policy with its heads) as a tree of JAX's layout whose
    leaves are the port's tensors (Linear weights transposed to flax's
    ``[in, out]`` as views; embeddings, norm scales, the MoE experts and
    LoRA adapters as they are). Layers come as ``h_{i}`` / ``enc_{i}`` /
    ``dec_{i}`` subtrees, the unscanned layout (:func:`jax_param_path`)."""
    wrapped = any(k.startswith(HEAD_PREFIXES) for k in state_dict)
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        path, transposed = jax_param_path(key, wrapped)
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = _transpose(value) if transposed else value
    return tree
