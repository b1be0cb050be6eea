"""The value head and the policy wrapper of the PPO path.

Port of ``trlx_tpu/models/heads.py``: :class:`MLPHead` (Linear(E→2E) in the
compute dtype → ReLU → Linear(2E→out) in f32, the JAX head's numerics) and
:class:`CausalLMWithValueHead`, which adds ``out["value"]`` (``[B, T]``
f32) to the backbone's outputs. The generation engines pick the value up
as a last-position output, so a harvested sequence carries the value
prediction beside each sampled token.
"""

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from trlx_tpu_torch.models.transformer import CausalTransformer, TransformerConfig, _linear

__all__ = ["MLPHead", "CausalLMWithValueHead"]


class MLPHead(nn.Module):
    """Two-layer MLP head: Linear(E→2E) → ReLU → Linear(2E→out); the output
    layer computes in f32."""

    def __init__(self, cfg: TransformerConfig, out_features: int):
        super().__init__()
        self.dtype = cfg.dtype
        kw = dict(dtype=cfg.param_dtype)
        self.in_proj = nn.Linear(cfg.hidden_size, 2 * cfg.hidden_size, **kw)
        self.out_proj = nn.Linear(2 * cfg.hidden_size, out_features, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(_linear(self.in_proj, x, self.dtype))
        return _linear(self.out_proj, h.float(), torch.float32)


class CausalLMWithValueHead(nn.Module):
    """Policy LM + scalar value head on the final hidden states."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.config = cfg
        self.backbone = CausalTransformer(cfg)
        self.v_head = MLPHead(cfg, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX initialisers: the backbone's, and normal(0.02) kernels with
        zero biases for the head."""
        self.backbone.reset_parameters(generator)
        with torch.no_grad():
            for name, p in self.v_head.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                else:
                    p.normal_(0.0, 0.02, generator=generator)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        cache=None,
        cache_index: Any = None,
        logits_span: Optional[Tuple[int, int]] = None,
        branch_layer: Optional[int] = None,
    ) -> Dict[str, Any]:
        out = self.backbone(
            input_ids, attention_mask=attention_mask, positions=positions, cache=cache,
            cache_index=cache_index, logits_span=logits_span, branch_layer=branch_layer,
        )
        out["value"] = self.v_head(out["hidden_states"])[..., 0]
        return out

    def forward_branch(self, hidden_states, branch_layer, attention_mask=None,
                       positions=None, logits_span=None):
        return self.backbone.forward_branch(
            hidden_states, branch_layer, attention_mask, positions, logits_span
        )
