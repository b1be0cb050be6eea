"""ILQL batch types.

Port of ``trlx_tpu/data/ilql_types.py``: a ragged host element and the
padded batch the collator builds from it, causal and seq2seq (where the
prompt feeds the encoder and ``decoder_input_ids`` holds the output, the
actions and states indexing decoder positions). ``dones`` doubles as the
validity mask of the padded state positions.
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

__all__ = ["ILQLElement", "ILQLBatch", "ILQLSeq2SeqElement", "ILQLSeq2SeqBatch"]


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


@dataclass
class ILQLSeq2SeqElement:
    """One offline seq2seq experience (host side, ragged numpy)."""

    input_ids: np.ndarray  # [P] encoder prompt
    attention_mask: np.ndarray  # [P]
    decoder_input_ids: np.ndarray  # [T] the output
    rewards: np.ndarray  # [A]
    states_ixs: np.ndarray  # [S]
    actions_ixs: np.ndarray  # [A]
    dones: np.ndarray  # [S]


class ILQLSeq2SeqBatch(NamedTuple):
    """Padded seq2seq ILQL training batch (host numpy)."""

    input_ids: np.ndarray  # [B, P]
    attention_mask: np.ndarray  # [B, P]
    decoder_input_ids: np.ndarray  # [B, T]
    rewards: np.ndarray  # [B, A]
    states_ixs: np.ndarray  # [B, S] (S = A + 1)
    actions_ixs: np.ndarray  # [B, A]
    dones: np.ndarray  # [B, S]
