"""Model construction from a ``builtin:<family>-<size>`` spec.

Port of the part of ``trlx_tpu/models/builder.py::build_causal_lm`` the
serving path needs: a backbone with no head, randomly initialised from a
seed (no download). Initialisation runs on the CPU from a seeded
``torch.Generator`` and the model then moves to the device, so one seed
gives the same weights on every device.
"""

from typing import Optional, Tuple, Union

import torch

from trlx_tpu_torch.models.transformer import (
    CausalTransformer,
    TransformerConfig,
    config_from_spec,
)
from trlx_tpu_torch.ops.kernel_utils import resolve_device

__all__ = ["build_causal_lm"]


def build_causal_lm(
    model_path: str = "builtin:gpt2-small",
    seed: int = 0,
    device: Union[None, str, torch.device] = None,
    head: Optional[str] = None,
    **overrides,
) -> Tuple[CausalTransformer, TransformerConfig]:
    """Build ``(model, config)`` for a builtin spec with seeded weights, in
    eval mode on ``device`` (default: the GPU; raises without one)."""
    if head is not None:
        raise ValueError(f"head={head!r}: the port builds the bare LM (no heads yet)")
    device = resolve_device(device)
    cfg = config_from_spec(model_path, **overrides)
    model = CausalTransformer(cfg)
    gen = torch.Generator().manual_seed(int(seed))
    model.reset_parameters(gen)
    return model.to(device).eval().requires_grad_(False), cfg
