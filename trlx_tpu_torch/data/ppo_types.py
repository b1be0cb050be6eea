"""PPO batch datatypes.

Port of ``trlx_tpu/data/ppo_types.py``. Host-side elements are ragged
per-sample numpy arrays; a collated batch is fixed-shape numpy with masks,
moved to the trainer's device by the train step.
"""

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np


@dataclass
class PPORLElement:
    """One collected experience (host side, ragged numpy).

    :param query_tensor: prompt token ids [Q]
    :param response_tensor: sampled response ids [R]
    :param logprobs: scoring-forward logprobs per response token [R]
    :param values: value predictions per response token [R]
    :param rewards: per-token rewards (KL penalty + score at end) [R]
    :param behavior_logprobs: the sampler's own logprobs [R], only carried
        when an IW correction consumes them; None elsewhere.
    """

    query_tensor: np.ndarray
    response_tensor: np.ndarray
    logprobs: np.ndarray
    values: np.ndarray
    rewards: np.ndarray
    behavior_logprobs: Optional[np.ndarray] = None


class PPORLBatch(NamedTuple):
    """A fixed-shape batch of experiences: queries left-padded, responses
    right-padded; the masks carry the ragged structure."""

    query_tensors: np.ndarray  # [B, Q] int32, left-padded
    response_tensors: np.ndarray  # [B, R] int32, right-padded
    logprobs: np.ndarray  # [B, R] float32
    values: np.ndarray  # [B, R] float32
    rewards: np.ndarray  # [B, R] float32
    query_mask: np.ndarray  # [B, Q] 1 on real prompt tokens
    response_mask: np.ndarray  # [B, R] 1 on real response tokens
    behavior_logprobs: Optional[np.ndarray] = None
