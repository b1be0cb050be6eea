"""Model construction from a ``builtin:<family>-<size>`` spec.

Port of the parts of ``trlx_tpu/models/builder.py`` the serving and PPO
paths need:

- :func:`build_causal_lm`: a backbone (``head=None``), the policy with a
  value head (``head="value"``) or with the ILQL heads (``head="ilql"``,
  the target heads starting as copies of the Q heads), randomly
  initialised from a seed (no download). The model is constructed on the
  ``meta`` device (no storage, no default init) and materialised on the
  target device; each tensor's draws then come from a seeded CPU
  ``torch.Generator`` in registration order and are copied over one at a
  time (``transformer.seeded_init_``), so one seed gives the same weights
  on every device and a 7B model never sits in host memory whole;
- :func:`hydra_ref_params`: the frozen hydra reference — copies of the top
  ``num_layers_unfrozen`` blocks, the final norm and the lm head (the tied
  embedding or the untied ``lm_head``);
- :func:`trainable_mask`: which parameters train. The JAX semantics: with
  ``num_layers_unfrozen = k > 0`` only the top ``k`` blocks train among the
  blocks, while every non-block backbone entry (``wte``, ``wpe``,
  ``emb_ln``, ``ln_f``, an untied ``lm_head``) and the heads train —
  except the ILQL target-Q heads, which never do (the JAX
  ``_mask_heads``); ``-1`` trains everything else. Under LoRA the base
  freezes entirely: only the adapters of the unfrozen blocks and the heads
  train;
- LoRA's configuration: :func:`parse_peft_overrides` (``model.peft_kwargs``
  → the config's ``lora_r``, ``lora_alpha`` and ``lora_targets``, with the
  JAX errors) and :func:`merge_lora_params` (adapters folded into their
  weights, for export);
- the seq2seq (T5) assembly: :func:`resolve_seq2seq_config`
  (``builtin:t5-<size>`` and ``builtin:flan_t5-<size>``),
  :func:`build_seq2seq_lm` (the same ``meta`` construction and seeded
  draws), :func:`seq2seq_hydra_ref_params` (copies of the top decoder
  blocks, the decoder's final norm and bias table, and the head) and
  :func:`seq2seq_trainable_mask` (the reference's
  ``freeze_bottom_seq2seq_layers``, with its k = 0 quirk: the whole
  decoder trains).
"""

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from trlx_tpu_torch.models.heads import (
    CausalLMWithILQLHeads,
    CausalLMWithValueHead,
    Seq2SeqLMWithILQLHeads,
    Seq2SeqLMWithValueHead,
)
from trlx_tpu_torch.models.seq2seq import (
    SEQ2SEQ_SPECS,
    Seq2SeqConfig,
    Seq2SeqHydraBranch,
    T5Transformer,
)
from trlx_tpu_torch.models.transformer import (
    CausalTransformer,
    HydraBranch,
    TransformerConfig,
    config_from_spec,
)
from trlx_tpu_torch.ops.kernel_utils import resolve_device

__all__ = ["LORA_TARGET_GROUPS", "build_causal_lm", "build_seq2seq_lm", "hydra_ref_params",
           "merge_lora_params", "parse_peft_overrides", "resolve_seq2seq_config",
           "seq2seq_hydra_ref_params", "seq2seq_trainable_mask", "trainable_mask"]

LORA_TARGET_GROUPS = {
    "attention": ("q_proj", "k_proj", "v_proj", "o_proj"),
    "mlp": ("gate_proj", "up_proj", "down_proj"),
}
LORA_TARGET_GROUPS["all"] = LORA_TARGET_GROUPS["attention"] + LORA_TARGET_GROUPS["mlp"]


def parse_peft_overrides(peft_kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """``model.peft_kwargs`` → the config overrides ``lora_r``, ``lora_alpha``
    and ``lora_targets`` (the JAX function: LoRA only; ``modified_modules``
    a group of :data:`LORA_TARGET_GROUPS` or a list of projection names;
    ``r`` / ``lora_r`` default 8, ``lora_alpha`` 16; unknown keys raise)."""
    kw = dict(peft_kwargs)
    peft_type = str(kw.pop("peft_type", kw.pop("delta_type", "lora"))).lower()
    if peft_type != "lora":
        raise ValueError(f"Only LoRA peft is supported (got '{peft_type}')")
    modified = kw.pop("modified_modules", "all")
    if isinstance(modified, str):
        if modified not in LORA_TARGET_GROUPS:
            raise ValueError(
                f"modified_modules '{modified}' not in {sorted(LORA_TARGET_GROUPS)}; "
                "pass an explicit list of projection names instead"
            )
        targets = LORA_TARGET_GROUPS[modified]
    else:
        targets = tuple(modified)
    out = dict(lora_r=int(kw.pop("r", kw.pop("lora_r", 8))),
               lora_alpha=float(kw.pop("lora_alpha", 16.0)), lora_targets=targets)
    if kw:
        raise ValueError(f"Unknown peft_kwargs keys: {sorted(kw)}")
    return out


def merge_lora_params(state_dict: Dict[str, torch.Tensor],
                      cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """Fold each adapter pair into its weight (``W += (alpha / r) · (A B)ᵀ``,
    the ``[out, in]`` layout) and drop the ``lora_*`` entries: the state
    dict of the same model without LoRA. A config without LoRA returns the
    state dict as it is."""
    if not cfg.lora_r:
        return state_dict
    scale = cfg.lora_alpha / cfg.lora_r
    out = {k: v for k, v in state_dict.items() if not k.endswith((".lora_a", ".lora_b"))}
    for key in state_dict:
        if key.endswith(".lora_a"):
            prefix = key[: -len("lora_a")]
            a, b = state_dict[key], state_dict[prefix + "lora_b"]
            out[prefix + "weight"] = out[prefix + "weight"] + (a @ b).t() * scale
    return out


def build_causal_lm(
    model_path: str = "builtin:gpt2-small",
    seed: int = 0,
    device: Union[None, str, torch.device] = None,
    head: Optional[str] = None,
    two_qs: bool = True,
    **overrides,
) -> Tuple[nn.Module, TransformerConfig]:
    """Build ``(model, config)`` for a builtin spec with seeded weights, in
    eval mode with gradients off, on ``device`` (default: the GPU; raises
    without one). ``head="value"`` wraps the backbone with the value head,
    ``head="ilql"`` with the ILQL heads (twin Q heads with ``two_qs``)."""
    heads = {None: CausalTransformer, "value": CausalLMWithValueHead,
             "ilql": lambda c: CausalLMWithILQLHeads(c, two_qs)}
    return _materialise(heads, head, config_from_spec(model_path, **overrides), seed, device)


def _materialise(heads, head, cfg, seed, device) -> Tuple[nn.Module, Any]:
    """``heads[head](cfg)`` built on ``meta`` (no storage, no default
    init), materialised on ``device`` and drawn from ``seed``; eval mode,
    gradients off."""
    if head not in heads:
        raise ValueError(f"head={head!r}: the port builds the bare LM, the value-head "
                         "policy or the ILQL policy (None | 'value' | 'ilql')")
    device = resolve_device(device)
    with torch.device("meta"):
        model = heads[head](cfg)
    model = model.to_empty(device=device)
    model.reset_parameters(torch.Generator().manual_seed(int(seed)))
    return model.eval().requires_grad_(False), cfg


def _backbone(model: nn.Module) -> CausalTransformer:
    return model.backbone if hasattr(model, "backbone") else model


def hydra_ref_params(
    model: nn.Module, tcfg: TransformerConfig, num_layers_unfrozen: int
) -> HydraBranch:
    """Frozen copy of the reference branch: the top ``num_layers_unfrozen``
    blocks + final norm + lm head (tied embedding or untied ``lm_head``), on
    the model's device, gradients off."""
    backbone = _backbone(model)
    start = tcfg.num_layers - num_layers_unfrozen
    with torch.device("meta"):  # no host copy and no default init
        ref = HydraBranch(tcfg, list(range(start, tcfg.num_layers)))
    keys = set(ref.state_dict())
    ref.load_state_dict({k: v.detach().clone() for k, v in backbone.state_dict().items()
                         if k in keys}, assign=True)
    return ref.eval().requires_grad_(False)


def trainable_mask(
    model: nn.Module, tcfg: TransformerConfig, num_layers_unfrozen: int
) -> Dict[str, bool]:
    """``{parameter name: trains}`` with the JAX ``trainable_mask`` rules.
    Under LoRA (``tcfg.lora_r > 0``) the backbone trains its adapters in the
    unfrozen blocks only, the base nothing; a bare LM (no heads) follows
    the same rule, where JAX's mask of a tree without a ``backbone`` key
    trains every leaf (``ROADMAP.md`` Queue 3)."""
    lora = tcfg.lora_r > 0
    mask: Dict[str, bool] = {}
    wrapped = hasattr(model, "backbone")
    for name, _ in model.named_parameters():
        inner = name[len("backbone."):] if wrapped and name.startswith("backbone.") else None
        if wrapped and inner is None:
            mask[name] = ".target_q_head_" not in name  # heads; targets only sync
            continue
        inner = name if inner is None else inner
        if inner.startswith("blocks."):
            layer = int(inner.split(".")[1])
            in_range = num_layers_unfrozen < 0 or (
                layer >= tcfg.num_layers - num_layers_unfrozen
            )
            mask[name] = in_range and (not lora or inner.endswith((".lora_a", ".lora_b")))
        else:
            mask[name] = not lora  # wte, wpe, emb_ln, ln_f, an untied lm_head
    return mask


# ---------------------------------------------------------------------------
# seq2seq (T5)
# ---------------------------------------------------------------------------


def resolve_seq2seq_config(model_path: str, **overrides) -> Seq2SeqConfig:
    """``builtin:t5-<size>`` or ``builtin:flan_t5-<size>`` (``test`` when no
    size is given) → :class:`Seq2SeqConfig` with ``overrides``. A
    checkpoint path raises: nothing is downloaded or imported."""
    if not model_path.startswith("builtin:"):
        raise ValueError(f"model path {model_path!r}: the port builds the builtin seq2seq "
                         f"specs (builtin:<family>-<size>, families {sorted(SEQ2SEQ_SPECS)}) "
                         "from a seed; it imports no checkpoint")
    family, _, size = model_path.split(":", 1)[1].partition("-")
    if family not in SEQ2SEQ_SPECS:
        raise ValueError(f"Unknown seq2seq family '{family}'. Known: {sorted(SEQ2SEQ_SPECS)}")
    return SEQ2SEQ_SPECS[family](size or "test", **overrides)


def build_seq2seq_lm(
    model_path: str = "builtin:t5-small",
    seed: int = 0,
    device: Union[None, str, torch.device] = None,
    head: Optional[str] = None,
    two_qs: bool = True,
    **overrides,
) -> Tuple[nn.Module, Seq2SeqConfig]:
    """:func:`build_causal_lm` for T5: the bare :class:`T5Transformer`, the
    value-head policy or the ILQL policy, seeded, on ``device``."""
    heads = {None: T5Transformer, "value": Seq2SeqLMWithValueHead,
             "ilql": lambda c: Seq2SeqLMWithILQLHeads(c, two_qs)}
    return _materialise(heads, head, resolve_seq2seq_config(model_path, **overrides), seed,
                        device)


def seq2seq_hydra_ref_params(model: nn.Module, scfg: Seq2SeqConfig,
                             num_layers_unfrozen: int) -> Seq2SeqHydraBranch:
    """Frozen copy of the seq2seq reference branch: the top
    ``num_layers_unfrozen`` decoder blocks, the decoder's final norm and
    relative-position table, and the head, on the model's device,
    gradients off."""
    backbone = _backbone(model)
    start = scfg.num_decoder_layers - num_layers_unfrozen
    with torch.device("meta"):
        ref = Seq2SeqHydraBranch(scfg, list(range(start, scfg.num_decoder_layers)))
    keys = set(ref.state_dict())
    ref.load_state_dict({k: v.detach().clone() for k, v in backbone.state_dict().items()
                         if k in keys}, assign=True)
    return ref.eval().requires_grad_(False)


_SEQ2SEQ_FROZEN = ("wte.", "enc_", "enc_ln_f.", "dec_ln_f.", "dec_rel_bias.")


def seq2seq_trainable_mask(model: nn.Module, scfg: Seq2SeqConfig,
                           num_layers_unfrozen: int) -> Dict[str, bool]:
    """``{parameter name: trains}`` with the JAX ``seq2seq_trainable_mask``
    rules: ``-1`` trains everything; ``k >= 0`` freezes the embedding, the
    whole encoder, both final norms and both bias tables, and trains the
    top ``k`` decoder blocks (all of them at ``k = 0``, the reference's
    quirk), an untied ``lm_head`` and the heads (never the ILQL target
    heads). Under LoRA only the adapters of the trained decoder blocks and
    the heads train."""
    lora = scfg.lora_r > 0
    mask: Dict[str, bool] = {}
    wrapped = hasattr(model, "backbone")
    for name, _ in model.named_parameters():
        inner = name[len("backbone."):] if wrapped and name.startswith("backbone.") else None
        if wrapped and inner is None:
            mask[name] = ".target_q_head_" not in name  # heads; targets only sync
            continue
        inner = name if inner is None else inner
        dec_block = inner.startswith("dec_blocks.")
        if num_layers_unfrozen < 0:
            trains = True
        elif inner.startswith(_SEQ2SEQ_FROZEN):
            trains = False
        elif dec_block:
            layer = int(inner.split(".")[1])
            trains = (num_layers_unfrozen == 0
                      or layer >= scfg.num_decoder_layers - num_layers_unfrozen)
        else:
            trains = True  # an untied lm_head
        if lora:
            trains = trains and dec_block and inner.endswith((".lora_a", ".lora_b"))
        mask[name] = trains
    return mask
