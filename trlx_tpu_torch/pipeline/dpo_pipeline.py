"""DPO preference-pair storage.

Port of ``trlx_tpu/pipeline/dpo_pipeline.py`` (:class:`DPOStore`):
``(prompt, chosen, rejected)`` triples tokenized once through
:func:`~trlx_tpu_torch.pipeline.offline_pipeline.tokenize_dialogue` (each
half is the dialogue ``[prompt, completion]``; only completion tokens
carry loss), and the frozen-reference logprob sums the trainer's one
reference pass fills in before learning starts.

Collated batches interleave the pair on the row axis, ``(c0, r0, c1, r1,
…)``, so every even-sized slice (a gradient-accumulation micro-batch)
holds whole pairs; rows are right-padded to a multiple of 8.
"""

from typing import Any, Dict, List, Sequence

import numpy as np

from trlx_tpu_torch.pipeline import BaseRolloutStore, BatchLoader
from trlx_tpu_torch.pipeline.offline_pipeline import pad_rows, tokenize_dialogue

__all__ = ["DPOStore"]


def _flatten(messages) -> Dict[str, List[int]]:
    tokens, out_mask = [], []
    for m in messages:
        tokens.extend(m.tokens)
        out_mask.extend([1 if m.is_output else 0] * len(m.tokens))
    return {"tokens": tokens, "out_mask": out_mask}


class DPOStore(BaseRolloutStore):
    """Tokenized preference pairs; ``ref_chosen_logp`` / ``ref_rejected_logp``
    stay None until the reference pass writes them."""

    def __init__(self, triples: Sequence[Sequence[str]], tokenizer, max_length: int):
        super().__init__()
        self.pad_token_id = tokenizer.pad_token_id
        self.history: List[Dict[str, Any]] = []
        for triple in triples:
            if len(triple) != 3:
                raise ValueError(
                    "DPO samples must be (prompt, chosen, rejected) triples; "
                    f"got a sample of length {len(triple)}"
                )
            prompt, chosen, rejected = triple
            self.history.append({
                "chosen": _flatten(tokenize_dialogue([prompt, chosen], tokenizer, max_length)),
                "rejected": _flatten(tokenize_dialogue([prompt, rejected], tokenizer,
                                                       max_length)),
                "ref_chosen_logp": None,
                "ref_rejected_logp": None,
            })

    def push(self, exps):
        self.history += exps

    def collate(self, elems: List[Dict[str, Any]], pad_multiple: int = 8
                ) -> Dict[str, np.ndarray]:
        """``input_ids``, ``attention_mask`` and ``out_mask`` of ``[2B, T]``
        (one forward scores both halves), and ``ref_logps`` ``[2B]`` once
        every reference is filled in."""
        rows, masks, refs = [], [], []
        for e in elems:
            rows += [e["chosen"]["tokens"], e["rejected"]["tokens"]]
            masks += [e["chosen"]["out_mask"], e["rejected"]["out_mask"]]
            refs += [e["ref_chosen_logp"], e["ref_rejected_logp"]]
        ids, attn = pad_rows(rows, self.pad_token_id, "right", pad_multiple)
        out, _ = pad_rows(masks, 0, "right", 1, ids.shape[1])
        batch = {"input_ids": ids, "attention_mask": attn, "out_mask": out}
        if all(r is not None for r in refs):
            batch["ref_logps"] = np.asarray(refs, np.float32)
        return batch

    def create_loader(self, batch_size: int, shuffle: bool = False, pad_multiple: int = 8,
                      drop_last: bool = True, seed: int = 0) -> BatchLoader:
        return BatchLoader(self, batch_size, lambda elems: self.collate(elems, pad_multiple),
                           shuffle=shuffle, drop_last=drop_last, seed=seed)
