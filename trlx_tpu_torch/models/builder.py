"""Model construction from a ``builtin:<family>-<size>`` spec or a local
Hugging Face checkpoint directory.

Port of the parts of ``trlx_tpu/models/builder.py`` the serving and PPO
paths need:

- :func:`resolve_transformer_config`: a ``builtin:`` spec's preset, or a
  checkpoint directory's ``config.json`` (``hf_interop.config_from_hf``),
  with the overrides applied on top (JAX's ``dataclasses.replace``);
- :func:`build_causal_lm`: a backbone (``head=None``), the policy with a
  value head (``head="value"``) or with the ILQL heads (``head="ilql"``,
  the target heads starting as copies of the Q heads), randomly
  initialised from a seed. The model is constructed on the
  ``meta`` device (no storage, no default init) and materialised on the
  target device; each tensor's draws then come from a seeded CPU
  ``torch.Generator`` in registration order and are copied over one at a
  time (``transformer.seeded_init_``), so one seed gives the same weights
  on every device and a 7B model never sits in host memory whole. From a
  checkpoint directory the imported weights are the backbone and nothing
  else (JAX's ``_import_hf_backbone``): the checkpoint's tensors become the
  backbone's parameters (cast to ``param_dtype``), and only the heads and
  LoRA adapters are drawn from the seed, in registration order (so the
  heads' draws are not a builtin spec's, whose draws pass through the
  backbone first);
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
  (``builtin:t5-<size>``, ``builtin:flan_t5-<size>`` or a T5 checkpoint
  directory),
  :func:`build_seq2seq_lm` (the same ``meta`` construction and seeded
  draws), :func:`seq2seq_hydra_ref_params` (copies of the top decoder
  blocks, the decoder's final norm and bias table, and the head) and
  :func:`seq2seq_trainable_mask` (the reference's
  ``freeze_bottom_seq2seq_layers``, with its k = 0 quirk: the whole
  decoder trains).
"""

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from trlx_tpu_torch.models import hf_interop
from trlx_tpu_torch.models.heads import (
    CausalLMWithILQLHeads,
    CausalLMWithValueHead,
    Seq2SeqLMWithILQLHeads,
    Seq2SeqLMWithValueHead,
    sync_target_q_params,
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
    seeded_init_,
)
from trlx_tpu_torch.ops.kernel_utils import resolve_device

__all__ = ["DTYPES", "LORA_TARGET_GROUPS", "assemble_overrides", "build_causal_lm",
           "build_seq2seq_lm", "hydra_ref_params", "merge_lora_params", "parse_peft_overrides",
           "resolve_seq2seq_config", "resolve_transformer_config", "seq2seq_hydra_ref_params",
           "seq2seq_trainable_mask", "trainable_mask"]

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


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def assemble_overrides(model_config, parallel=None,
                       scan_layers_supported: bool = True) -> Dict[str, Any]:
    """The model config overrides of a trainer (JAX's
    ``_assemble_overrides``): ``model.model_extra_kwargs``, LoRA from
    ``model.peft_kwargs``, and from ``parallel`` the dtypes, ``remat`` and
    (where the architecture scans: not T5, whose extras lose the key)
    ``scan_layers``, each only where the extras do not set it."""
    overrides: Dict[str, Any] = dict(model_config.model_extra_kwargs or {})
    if not scan_layers_supported:
        overrides.pop("scan_layers", None)
    if model_config.peft_kwargs:
        try:
            overrides.update(parse_peft_overrides(model_config.peft_kwargs))
        except ValueError as e:
            raise ValueError(f"model.peft_kwargs: {e}") from None
    if parallel is not None:
        overrides.setdefault("param_dtype", DTYPES[parallel.param_dtype])
        overrides.setdefault("dtype", DTYPES[parallel.compute_dtype])
        overrides.setdefault("remat", parallel.remat)
        if scan_layers_supported:
            overrides.setdefault("scan_layers", bool(parallel.scan_layers or parallel.pipe > 1))
    return overrides


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


def _checkpoint_dir(model_path: str) -> Optional[str]:
    """None for a ``builtin:`` spec, else the path (a checkpoint directory)."""
    return None if model_path.startswith("builtin:") else model_path


def resolve_transformer_config(model_path: str, **overrides) -> TransformerConfig:
    """The config of a ``builtin:<family>-<size>`` spec, or of a local HF
    checkpoint directory's ``config.json``, with ``overrides`` applied on
    top. A path that is no checkpoint directory raises the loader's
    ``ValueError``."""
    path = _checkpoint_dir(model_path)
    if path is None:
        return config_from_spec(model_path, **overrides)
    cfg = hf_interop.config_from_hf(hf_interop.read_hf_config(path))
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def build_causal_lm(
    model_path: str = "builtin:gpt2-small",
    seed: int = 0,
    device: Union[None, str, torch.device] = None,
    head: Optional[str] = None,
    two_qs: bool = True,
    **overrides,
) -> Tuple[nn.Module, TransformerConfig]:
    """Build ``(model, config)`` for a builtin spec with seeded weights, or
    for a local HF checkpoint directory (its backbone imported over the
    seeded model), in eval mode with gradients off, on ``device``
    (default: the GPU; raises without one). ``head="value"`` wraps the
    backbone with the value head, ``head="ilql"`` with the ILQL heads (twin
    Q heads with ``two_qs``)."""
    heads = {None: CausalTransformer, "value": CausalLMWithValueHead,
             "ilql": lambda c: CausalLMWithILQLHeads(c, two_qs)}
    return _materialise(heads, head, resolve_transformer_config(model_path, **overrides),
                        seed, device, _checkpoint_dir(model_path), hf_interop.load_pretrained)


def _materialise(heads, head, cfg, seed, device, path=None, load=None
                 ) -> Tuple[nn.Module, Any]:
    """``heads[head](cfg)`` built on ``meta`` (no storage, no default
    init), materialised on ``device`` and drawn from ``seed``. With a
    checkpoint ``path``, ``load`` reads its backbone onto ``device`` and
    its tensors become the backbone's parameters; only the rest (the
    heads, LoRA adapters) is drawn, in registration order, so no backbone
    draw is paid and thrown away. Eval mode, gradients off."""
    if head not in heads:
        raise ValueError(f"head={head!r}: the port builds the bare LM, the value-head "
                         "policy or the ILQL policy (None | 'value' | 'ilql')")
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(int(seed))
    with torch.device("meta"):
        model = heads[head](cfg)
    if path is None:
        model = model.to_empty(device=device)
        model.reset_parameters(generator)
    else:
        state_dict, _ = load(path, device=device, cfg=cfg)
        seeded_init_(model, generator, names=hf_interop.import_backbone(model, state_dict, device))
        if hasattr(model, "ilql_heads"):  # the target heads start as the Q heads
            sync_target_q_params(model, alpha=1.0)
    return model.eval().requires_grad_(False), cfg


def _backbone(model: nn.Module) -> CausalTransformer:
    return model.backbone if hasattr(model, "backbone") else model


def hydra_ref_params(
    model: nn.Module, tcfg: TransformerConfig, num_layers_unfrozen: int,
    backbone_state: Optional[Dict[str, torch.Tensor]] = None,
) -> HydraBranch:
    """Frozen copy of the reference branch: the top ``num_layers_unfrozen``
    blocks + final norm + lm head (tied embedding or untied ``lm_head``), on
    the model's device, gradients off. ``backbone_state`` (the backbone's
    full weights, for a sharded model) replaces the model's
    ``state_dict``."""
    if backbone_state is None:
        backbone_state = _backbone(model).state_dict()
    start = tcfg.num_layers - num_layers_unfrozen
    with torch.device("meta"):  # no host copy and no default init
        ref = HydraBranch(tcfg, list(range(start, tcfg.num_layers)))
    keys = set(ref.state_dict())
    ref.load_state_dict({k: v.detach().clone() for k, v in backbone_state.items()
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
    size is given), or a local T5 checkpoint directory's ``config.json``
    → :class:`Seq2SeqConfig` with ``overrides``. A path that is no
    checkpoint directory raises the loader's ``ValueError``."""
    path = _checkpoint_dir(model_path)
    if path is not None:
        cfg = hf_interop.seq2seq_config_from_hf(hf_interop.read_hf_config(path))
        return dataclasses.replace(cfg, **overrides) if overrides else cfg
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
    value-head policy or the ILQL policy, seeded (and its backbone
    imported from a checkpoint directory), on ``device``."""
    heads = {None: T5Transformer, "value": Seq2SeqLMWithValueHead,
             "ilql": lambda c: Seq2SeqLMWithILQLHeads(c, two_qs)}
    return _materialise(heads, head, resolve_seq2seq_config(model_path, **overrides), seed,
                        device, _checkpoint_dir(model_path), hf_interop.load_pretrained_seq2seq)


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
