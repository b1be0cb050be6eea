"""GRPO rollout storage.

Port of ``trlx_tpu/pipeline/grpo_pipeline.py``: the PPO store's buffer
and loader with the GRPO fields (a per-sequence advantage and the
reference logprobs instead of values and per-token rewards); collation
pads as the JAX store does; the JSON rollout export writes the GRPO
fields.
"""

from typing import List, Optional

import numpy as np

from trlx_tpu_torch.data.grpo_types import GRPORLBatch, GRPORLElement
from trlx_tpu_torch.pipeline.offline_pipeline import pad_rows
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage


class GRPORolloutStorage(PPORolloutStorage):
    """Replay buffer of :class:`GRPORLElement` used during GRPO learning."""

    def _export_row(self, e: GRPORLElement) -> dict:
        return {
            "query_tensor": np.asarray(e.query_tensor).tolist(),
            "response_tensor": np.asarray(e.response_tensor).tolist(),
            "logprobs": np.asarray(e.logprobs).tolist(),
            "ref_logprobs": np.asarray(e.ref_logprobs).tolist(),
            "advantage": float(e.advantage),
        }

    def collate(
        self,
        elems: List[GRPORLElement],
        pad_multiple: int = 8,
        query_length: Optional[int] = None,
        response_length: Optional[int] = None,
    ) -> GRPORLBatch:
        queries, query_mask = pad_rows(
            [e.query_tensor for e in elems], self.pad_token_id, "left", pad_multiple, query_length
        )
        responses, response_mask = pad_rows(
            [e.response_tensor for e in elems], self.pad_token_id, "right", pad_multiple,
            response_length
        )
        r_len = responses.shape[1]
        logprobs, _ = pad_rows([e.logprobs for e in elems], 0.0, "right", 1, r_len, np.float32)
        ref_logprobs, _ = pad_rows([e.ref_logprobs for e in elems], 0.0, "right", 1, r_len,
                                   np.float32)
        behavior = None
        if all(e.behavior_logprobs is not None for e in elems):
            behavior, _ = pad_rows(
                [e.behavior_logprobs for e in elems], 0.0, "right", 1, r_len, np.float32
            )
        return GRPORLBatch(
            query_tensors=queries,
            response_tensors=responses,
            logprobs=logprobs,
            ref_logprobs=ref_logprobs,
            advantages=np.asarray([e.advantage for e in elems], np.float32),
            query_mask=query_mask,
            response_mask=response_mask,
            behavior_logprobs=behavior,
        )
