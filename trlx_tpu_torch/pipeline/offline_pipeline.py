"""Prompt pipeline, dialogue stores and row padding.

Port of ``trlx_tpu/pipeline/offline_pipeline.py`` for causal models:

- :func:`pad_rows` (ragged rows → a ``[B, L]`` array and mask, ``L``
  bucketed to a multiple or fixed);
- :class:`PromptPipeline` (tokenize and truncate prompts; left-padded
  collation);
- :func:`tokenize_dialogue` (interleaved prompt/output turns under one
  token budget) and the SFT :class:`DialogStore` (right-padded, labels
  ``IGNORE_INDEX`` off the output turns);
- :func:`ilql_collate` and :class:`ILQLRolloutStorage` (right-padded,
  ``drop_last``), and their seq2seq twins :func:`ilql_seq2seq_collate` and
  :class:`ILQLSeq2SeqRolloutStorage` (prompt, attention mask and decoder
  tokens right-padded to one width).

Loaders shuffle with ``random.Random(seed)``, as the JAX package's do, so a
store holding the same rows in the same order yields the same batches.
"""

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from trlx_tpu_torch.data.ilql_types import (
    ILQLBatch,
    ILQLElement,
    ILQLSeq2SeqBatch,
    ILQLSeq2SeqElement,
)
from trlx_tpu_torch.data.tokenizer import Tokenizer
from trlx_tpu_torch.models.sft import IGNORE_INDEX
from trlx_tpu_torch.pipeline import (
    BasePipeline,
    BaseRolloutStore,
    BatchLoader,
    register_datapipeline,
)


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


@dataclass
class DialogMessage:
    """One turn of a dialogue; ``is_output`` marks the model's turns."""

    is_output: bool
    tokens: Tuple[int, ...]


def _trim(messages: List[DialogMessage], overflow: int, from_left: bool) -> List[DialogMessage]:
    """Drop ``overflow`` tokens from one end of the flattened turns,
    keeping the turn boundaries (emptied turns stay, as empty)."""
    order = messages if from_left else list(reversed(messages))
    trimmed = []
    for m in order:
        if overflow >= len(m.tokens):
            overflow -= len(m.tokens)
            trimmed.append(DialogMessage(m.is_output, ()))
        else:
            keep = (m.tokens[overflow:] if from_left
                    else m.tokens[: len(m.tokens) - overflow]) if overflow else m.tokens
            trimmed.append(DialogMessage(m.is_output, keep))
            overflow = 0
    return trimmed if from_left else list(reversed(trimmed))


def tokenize_dialogue(
    dialogue: Union[str, Iterable[str]],
    tokenizer: Tokenizer,
    max_length: int = 2048,
) -> List[DialogMessage]:
    """Tokenize an interleaved ``(prompt_1, output_1, prompt_2, ...)``
    dialogue. A bare string ``s`` stands for ``(bos, s)``; the last output
    gets eos appended if it lacks it. Overflow past ``max_length`` tokens
    is cut from the tokenizer's ``truncation_side`` of the flattened
    dialogue, turn boundaries kept; empty turns are dropped."""
    if isinstance(dialogue, str):
        dialogue = [tokenizer.bos_token or tokenizer.eos_token, dialogue]
    else:
        dialogue = list(dialogue)
        if len(dialogue) % 2 != 0:
            raise ValueError(
                "Dialogue must have an even number of phrases, alternating prompt and output"
            )
    if not dialogue[-1].endswith(tokenizer.eos_token):
        dialogue = dialogue[:-1] + [dialogue[-1] + tokenizer.eos_token]
    messages = [
        DialogMessage(is_output=i % 2 == 1,
                      tokens=tuple(tokenizer.encode(turn, add_special_tokens=False)))
        for i, turn in enumerate(dialogue)
    ]
    overflow = max(0, sum(len(m.tokens) for m in messages) - max_length)
    if overflow:
        messages = _trim(messages, overflow, tokenizer.truncation_side == "left")
    return [m for m in messages if len(m.tokens) > 0]


class DialogStore(BaseRolloutStore):
    """The SFT store: flattened dialogues, labels ``IGNORE_INDEX`` on the
    tokens of non-output turns."""

    def __init__(self, dialogs: List[List[DialogMessage]], tokenizer: Tokenizer):
        super().__init__()
        self.tokenizer = tokenizer
        self.history = [
            {"input_ids": np.array([t for m in d for t in m.tokens], dtype=np.int32),
             "labels": np.array([t if m.is_output else IGNORE_INDEX
                                 for m in d for t in m.tokens], dtype=np.int32)}
            for d in dialogs
        ]

    def push(self, exps):
        self.history.extend(exps)

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
            input_ids, mask = pad_rows(
                [e["input_ids"] for e in elems], pad_id, "right", pad_multiple, fixed_length
            )
            labels, _ = pad_rows(
                [e["labels"] for e in elems], IGNORE_INDEX, "right", pad_multiple, fixed_length
            )
            return {"input_ids": input_ids, "attention_mask": mask, "labels": labels}

        return BatchLoader(self, batch_size, collate, shuffle=shuffle, seed=seed)


def ilql_collate(
    elems: List[ILQLElement], pad_multiple: int = 8, fixed_length: Optional[int] = None
) -> ILQLBatch:
    """Right-pad a list of elements; actions and states bucket to their own
    (smaller) widths, ``S = A + 1``."""
    input_ids, _ = pad_rows([e.input_ids for e in elems], 0, "right", pad_multiple, fixed_length)
    attn, _ = pad_rows([e.attention_mask for e in elems], 0, "right", pad_multiple, fixed_length)
    rewards, _ = pad_rows([e.rewards for e in elems], 0.0, "right", pad_multiple, None, np.float32)
    a_len = rewards.shape[1]
    actions_ixs, _ = pad_rows([e.actions_ixs for e in elems], 0, "right", 1, a_len)
    states_ixs, _ = pad_rows([e.states_ixs for e in elems], 0, "right", 1, a_len + 1)
    dones, _ = pad_rows([e.dones for e in elems], 0, "right", 1, a_len + 1)
    return ILQLBatch(input_ids, attn, rewards, states_ixs, actions_ixs, dones)


class ILQLRolloutStorage(BaseRolloutStore):
    """Rollout storage for offline ILQL training."""

    def __init__(self, input_ids, attention_mask, rewards, states_ixs, actions_ixs, dones):
        super().__init__()
        self.history = [
            ILQLElement(*row)
            for row in zip(input_ids, attention_mask, rewards, states_ixs, actions_ixs, dones)
        ]

    def push(self, exps):
        self.history.extend(exps)

    def create_loader(
        self,
        batch_size: int,
        shuffle: bool = True,
        pad_multiple: int = 8,
        fixed_length: Optional[int] = None,
        drop_last: bool = True,
        seed: int = 0,
    ) -> BatchLoader:
        return BatchLoader(
            self, batch_size, lambda elems: ilql_collate(elems, pad_multiple, fixed_length),
            shuffle=shuffle, drop_last=drop_last, seed=seed,
        )


def ilql_seq2seq_collate(
    elems: List[ILQLSeq2SeqElement], pad_multiple: int = 8, fixed_length: Optional[int] = None
) -> ILQLSeq2SeqBatch:
    """:func:`ilql_collate` for seq2seq elements: the prompt, its mask and
    the decoder tokens right-padded (each to its own bucketed width, or all
    to ``fixed_length``)."""
    input_ids, _ = pad_rows([e.input_ids for e in elems], 0, "right", pad_multiple, fixed_length)
    attn, _ = pad_rows([e.attention_mask for e in elems], 0, "right", pad_multiple, fixed_length)
    dec_ids, _ = pad_rows([e.decoder_input_ids for e in elems], 0, "right", pad_multiple,
                          fixed_length)
    rewards, _ = pad_rows([e.rewards for e in elems], 0.0, "right", pad_multiple, None, np.float32)
    a_len = rewards.shape[1]
    actions_ixs, _ = pad_rows([e.actions_ixs for e in elems], 0, "right", 1, a_len)
    states_ixs, _ = pad_rows([e.states_ixs for e in elems], 0, "right", 1, a_len + 1)
    dones, _ = pad_rows([e.dones for e in elems], 0, "right", 1, a_len + 1)
    return ILQLSeq2SeqBatch(input_ids, attn, dec_ids, rewards, states_ixs, actions_ixs, dones)


class ILQLSeq2SeqRolloutStorage(BaseRolloutStore):
    """Rollout storage for offline seq2seq ILQL training."""

    def __init__(self, input_ids, attention_mask, decoder_input_ids, rewards, states_ixs,
                 actions_ixs, dones):
        super().__init__()
        self.history = [
            ILQLSeq2SeqElement(*row)
            for row in zip(input_ids, attention_mask, decoder_input_ids, rewards, states_ixs,
                           actions_ixs, dones)
        ]

    def push(self, exps):
        self.history.extend(exps)

    def create_loader(
        self,
        batch_size: int,
        shuffle: bool = True,
        pad_multiple: int = 8,
        fixed_length: Optional[int] = None,
        drop_last: bool = True,
        seed: int = 0,
    ) -> BatchLoader:
        return BatchLoader(
            self, batch_size, lambda elems: ilql_seq2seq_collate(elems, pad_multiple, fixed_length),
            shuffle=shuffle, drop_last=drop_last, seed=seed,
        )
