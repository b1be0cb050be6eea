"""ILQL batch types.

Port of the causal part of ``trlx_tpu/data/ilql_types.py``: a ragged host
element and the padded batch the collator builds from it. ``dones``
doubles as the validity mask of the padded state positions.
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

__all__ = ["ILQLElement", "ILQLBatch"]


@dataclass
class ILQLElement:
    """One offline experience (host side, ragged numpy)."""

    input_ids: np.ndarray  # [T]
    attention_mask: np.ndarray  # [T]
    rewards: np.ndarray  # [A]
    states_ixs: np.ndarray  # [S]
    actions_ixs: np.ndarray  # [A]
    dones: np.ndarray  # [S]


class ILQLBatch(NamedTuple):
    """Padded ILQL training batch (host numpy, moved to the device whole)."""

    input_ids: np.ndarray  # [B, T]
    attention_mask: np.ndarray  # [B, T]
    rewards: np.ndarray  # [B, A]
    states_ixs: np.ndarray  # [B, S] (S = A + 1)
    actions_ixs: np.ndarray  # [B, A]
    dones: np.ndarray  # [B, S]
