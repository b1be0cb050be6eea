"""GRPO batch datatypes.

Port of ``trlx_tpu/data/grpo_types.py``: the same host-ragged / fixed-shape
split as ``ppo_types``, with no value or per-token reward fields — GRPO
carries one group-relative advantage per sequence and the frozen
reference's logprobs for the in-loss KL.
"""

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np


@dataclass
class GRPORLElement:
    """One collected experience (host side, ragged numpy).

    :param query_tensor: prompt token ids [Q]
    :param response_tensor: sampled response ids [R]
    :param logprobs: scoring-forward logprobs per response token [R]
    :param ref_logprobs: the frozen reference's logprobs [R]
    :param advantage: the group-relative advantage of the sequence
    :param behavior_logprobs: the sampler's own logprobs [R], only carried
        when an IW correction consumes them; None elsewhere.
    """

    query_tensor: np.ndarray
    response_tensor: np.ndarray
    logprobs: np.ndarray
    ref_logprobs: np.ndarray
    advantage: float
    behavior_logprobs: Optional[np.ndarray] = None


class GRPORLBatch(NamedTuple):
    """A fixed-shape batch of experiences: queries left-padded, responses
    right-padded; the masks carry the ragged structure."""

    query_tensors: np.ndarray  # [B, Q] int32, left-padded
    response_tensors: np.ndarray  # [B, R] int32, right-padded
    logprobs: np.ndarray  # [B, R] float32
    ref_logprobs: np.ndarray  # [B, R] float32
    advantages: np.ndarray  # [B] float32
    query_mask: np.ndarray  # [B, Q] 1 on real prompt tokens
    response_mask: np.ndarray  # [B, R] 1 on real response tokens
    behavior_logprobs: Optional[np.ndarray] = None
