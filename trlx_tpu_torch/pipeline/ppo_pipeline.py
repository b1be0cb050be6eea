"""PPO rollout storage.

Port of ``trlx_tpu/pipeline/ppo_pipeline.py``: a replay buffer of per-sample
experiences with a left-pad-queries / right-pad-responses collator
(bucketed lengths), and the JSON rollout export of
``train.rollout_logging_dir`` (:meth:`PPORolloutStorage.export_history`).
"""

import json
import os
from typing import List, Optional

import numpy as np

from trlx_tpu_torch.data.ppo_types import PPORLBatch, PPORLElement
from trlx_tpu_torch.pipeline import BaseRolloutStore, BatchLoader
from trlx_tpu_torch.pipeline.offline_pipeline import pad_rows


class PPORolloutStorage(BaseRolloutStore):
    """Replay buffer of :class:`PPORLElement` used during PPO learning."""

    def __init__(self, pad_token_id: int):
        super().__init__()
        self.pad_token_id = pad_token_id
        self.history: List[PPORLElement] = []

    def push(self, exps: List[PPORLElement]):
        self.history += exps

    def clear_history(self):
        self.history = []

    def _export_row(self, exp: PPORLElement) -> dict:
        return {
            "query_tensor": np.asarray(exp.query_tensor).tolist(),
            "response_tensor": np.asarray(exp.response_tensor).tolist(),
            "logprobs": np.asarray(exp.logprobs).tolist(),
            "values": np.asarray(exp.values).tolist(),
            "rewards": np.asarray(exp.rewards).tolist(),
        }

    def export_history(self, location: str):
        """Write the store's rollouts as one JSON list into
        ``location/epoch-<n>.json``, ``n`` the next ordinal after the
        exports already there (deterministic names; no export overwrites
        another)."""
        assert os.path.exists(location)
        fpath = os.path.join(location, f"epoch-{self._next_export_index(location):06d}.json")
        with open(fpath, "w") as f:
            json.dump([self._export_row(exp) for exp in self.history], f)

    @staticmethod
    def _next_export_index(location: str) -> int:
        """The smallest ordinal above every ``epoch-*.json`` present."""
        taken = []
        for name in sorted(os.listdir(location)):
            if not (name.startswith("epoch-") and name.endswith(".json")):
                continue
            try:
                taken.append(int(name[len("epoch-"):-len(".json")]))
            except ValueError:
                continue
        return max(taken) + 1 if taken else 0

    def collate(
        self,
        elems: List[PPORLElement],
        pad_multiple: int = 8,
        query_length: Optional[int] = None,
        response_length: Optional[int] = None,
    ) -> PPORLBatch:
        queries, query_mask = pad_rows(
            [e.query_tensor for e in elems], self.pad_token_id, "left", pad_multiple, query_length
        )
        responses, response_mask = pad_rows(
            [e.response_tensor for e in elems], self.pad_token_id, "right", pad_multiple, response_length
        )
        r_len = responses.shape[1]
        logprobs, _ = pad_rows([e.logprobs for e in elems], 0.0, "right", 1, r_len, np.float32)
        values, _ = pad_rows([e.values for e in elems], 0.0, "right", 1, r_len, np.float32)
        rewards, _ = pad_rows([e.rewards for e in elems], 0.0, "right", 1, r_len, np.float32)
        # async-collection behavior logprobs ride only when EVERY element
        # carries them (mixed stores train without the IW correction)
        behavior = None
        if all(e.behavior_logprobs is not None for e in elems):
            behavior, _ = pad_rows(
                [e.behavior_logprobs for e in elems], 0.0, "right", 1, r_len, np.float32
            )
        return PPORLBatch(
            query_tensors=queries,
            response_tensors=responses,
            logprobs=logprobs,
            values=values,
            rewards=rewards,
            query_mask=query_mask,
            response_mask=response_mask,
            behavior_logprobs=behavior,
        )

    def create_loader(
        self,
        batch_size: int,
        shuffle: bool = False,
        pad_multiple: int = 8,
        query_length: Optional[int] = None,
        response_length: Optional[int] = None,
        drop_last: bool = True,
        seed: int = 0,
    ) -> BatchLoader:
        return BatchLoader(
            self,
            batch_size,
            lambda elems: self.collate(elems, pad_multiple, query_length, response_length),
            shuffle=shuffle,
            drop_last=drop_last,
            seed=seed,
        )
