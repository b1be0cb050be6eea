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
  ``_mask_heads``); ``-1`` trains everything else.
"""

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from trlx_tpu_torch.models.heads import CausalLMWithILQLHeads, CausalLMWithValueHead
from trlx_tpu_torch.models.transformer import (
    CausalTransformer,
    HydraBranch,
    TransformerConfig,
    config_from_spec,
)
from trlx_tpu_torch.ops.kernel_utils import resolve_device

__all__ = ["build_causal_lm", "hydra_ref_params", "trainable_mask"]


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
    if head not in heads:
        raise ValueError(f"head={head!r}: the port builds the bare LM, the value-head "
                         "policy or the ILQL policy (None | 'value' | 'ilql')")
    device = resolve_device(device)
    cfg = config_from_spec(model_path, **overrides)
    with torch.device("meta"):  # no storage and no default init
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
    """``{parameter name: trains}`` with the JAX ``trainable_mask`` rules."""
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
            mask[name] = num_layers_unfrozen < 0 or (
                layer >= tcfg.num_layers - num_layers_unfrozen
            )
        else:
            mask[name] = True  # wte, wpe, emb_ln, ln_f, an untied lm_head
    return mask
