"""Weights carried across from the JAX package.

:func:`params_from_jax` turns a JAX ``CausalTransformer`` parameter tree,
given as nested dicts of numpy arrays, into the port's ``state_dict``:

- flax ``Dense`` kernels are ``[in, out]``; ``torch.nn.Linear`` weights are
  ``[out, in]`` — every kernel is transposed;
- tied embeddings: the LM head reuses ``wte`` (no ``lm_head`` entry);
- layers come as ``h_{i}`` subtrees (the unscanned layout). A scanned tree
  (``h_scan/block`` with a leading layer axis, ``stack_layer_params``) is
  sliced back into ``h_{i}`` first, as ``unstack_layer_params`` does;
- a value-head policy's tree (``backbone`` + ``v_head``) maps onto
  :class:`~trlx_tpu_torch.models.heads.CausalLMWithValueHead`
  (``backbone.*`` and ``v_head.in_proj`` / ``v_head.out_proj``), an ILQL
  policy's (``backbone`` + ``ilql_heads/{v_head, q_head_i,
  target_q_head_i}``) onto
  :class:`~trlx_tpu_torch.models.heads.CausalLMWithILQLHeads`
  (``ilql_heads.<head>.in_proj`` / ``out_proj``);
- a hydra reference subtree (``builder.py::hydra_ref_params``: the top
  ``h_{i}``, ``ln_f`` and ``wte``) maps onto
  :class:`~trlx_tpu_torch.models.transformer.HydraBranch`: only the entries
  present are converted.
"""

from typing import Any, Dict

import numpy as np
import torch

from trlx_tpu_torch.models.transformer import TransformerConfig

__all__ = ["params_from_jax"]


def _unstack(backbone: Dict[str, Any]) -> Dict[str, Any]:
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
    for i in range(np.asarray(first).shape[0]):
        out[f"h_{i}"] = take(stacked, i)
    return out


def params_from_jax(np_params: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) → the port's ``state_dict``."""
    tree = np_params.get("backbone", np_params)
    tree = _unstack(tree)

    def t(x):
        return torch.tensor(np.asarray(x), dtype=cfg.param_dtype)

    sd: Dict[str, torch.Tensor] = {}
    for name in ("wte", "wpe"):
        if name in tree:
            sd[f"{name}.weight"] = t(tree[name]["embedding"])

    def dense(prefix, node):
        sd[f"{prefix}.weight"] = t(np.asarray(node["kernel"]).T)
        if "bias" in node:
            sd[f"{prefix}.bias"] = t(node["bias"])

    def norm(prefix, node):
        sd[f"{prefix}.weight"] = t(node["scale"])
        sd[f"{prefix}.bias"] = t(node["bias"])

    for i in range(cfg.num_layers):
        if f"h_{i}" not in tree:  # a hydra reference holds the top layers only
            continue
        layer = tree[f"h_{i}"]
        p = f"blocks.{i}"
        norm(f"{p}.ln_attn", layer["ln_attn"])
        norm(f"{p}.ln_mlp", layer["ln_mlp"])
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            dense(f"{p}.attn.{proj}", layer["attn"][proj])
        for proj in ("up_proj", "down_proj"):
            dense(f"{p}.mlp.{proj}", layer["mlp"][proj])
    if cfg.final_norm:
        norm("ln_f", tree["ln_f"])
    if not cfg.tie_word_embeddings:
        dense("lm_head", tree["lm_head"])
    heads = {}
    if "v_head" in np_params:
        heads["v_head"] = np_params["v_head"]
    for name, node in np_params.get("ilql_heads", {}).items():
        heads[f"ilql_heads.{name}"] = node
    if not heads:
        return sd
    sd = {f"backbone.{k}": v for k, v in sd.items()}
    for prefix, node in heads.items():
        for proj in ("in_proj", "out_proj"):
            dense(f"{prefix}.{proj}", node[proj])
    return sd
