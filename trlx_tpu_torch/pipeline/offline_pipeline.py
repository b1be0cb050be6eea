"""Prompt pipeline and row padding.

Port of the parts of ``trlx_tpu/pipeline/offline_pipeline.py`` the PPO path
runs: :func:`pad_rows` (ragged rows → a ``[B, L]`` array and mask, ``L``
bucketed to a multiple or fixed) and :class:`PromptPipeline` (tokenize and
truncate prompts; left-padded collation).
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np

from trlx_tpu_torch.data.tokenizer import Tokenizer
from trlx_tpu_torch.pipeline import BasePipeline, BatchLoader, register_datapipeline


def round_up(n: int, multiple: int) -> int:
    """Round ``n`` up to the next multiple (minimum one multiple)."""
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def pad_rows(
    rows: Sequence[Sequence[int]],
    pad_value: int,
    side: str = "right",
    pad_multiple: int = 8,
    fixed_length: Optional[int] = None,
    dtype=np.int32,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack ragged rows into a [B, L] array + mask, L bucketed or fixed.

    The JAX package's numpy path (its C++ host runtime computes the same).
    """
    longest = max((len(r) for r in rows), default=1)
    length = fixed_length if fixed_length is not None else round_up(longest, pad_multiple)

    out = np.full((len(rows), length), pad_value, dtype=dtype)
    mask = np.zeros((len(rows), length), dtype=np.int32)
    for i, row in enumerate(rows):
        row = list(row)
        if len(row) > length:
            # keep the side adjacent to the content: left-padding keeps the
            # END of the row (tokens nearest the response), right-padding
            # keeps the start
            row = row[-length:] if side == "left" else row[:length]
        if side == "left":
            out[i, length - len(row) :] = row
            mask[i, length - len(row) :] = 1
        else:
            out[i, : len(row)] = row
            mask[i, : len(row)] = 1
    return out, mask


@register_datapipeline
class PromptPipeline(BasePipeline):
    """Tokenizes and right/left-truncates prompts to ``max_prompt_length``."""

    def __init__(self, prompts: List[str], max_prompt_length: int, tokenizer: Tokenizer):
        super().__init__()
        self.tokenizer = tokenizer
        out = tokenizer(
            prompts, truncation=True, max_length=max_prompt_length, add_special_tokens=False
        )
        self.prompts = [
            {"input_ids": np.asarray(ids, dtype=np.int32), "text": text}
            for ids, text in zip(out["input_ids"], prompts)
        ]

    def __getitem__(self, ix: int):
        return self.prompts[ix]

    def __len__(self) -> int:
        return len(self.prompts)

    def create_loader(
        self,
        batch_size: int,
        shuffle: bool = False,
        pad_multiple: int = 8,
        fixed_length: Optional[int] = None,
        seed: int = 0,
    ) -> BatchLoader:
        pad_id = self.tokenizer.pad_token_id

        def collate(elems: List[dict]) -> dict:
            # left-pad prompts: generation appends to the right
            ids, mask = pad_rows(
                [e["input_ids"] for e in elems], pad_id, "left", pad_multiple, fixed_length
            )
            return {
                "input_ids": ids,
                "attention_mask": mask,
                "text": [e["text"] for e in elems],
            }

        return BatchLoader(self, batch_size, collate, shuffle=shuffle, seed=seed)
