"""Tokenizers of the port.

Port of ``trlx_tpu/data/tokenizer.py`` for the builtin, file-free
tokenizers: :class:`ByteTokenizer` (``builtin:bytes``: ids 0..255 are raw
bytes, then bos/eos/pad) and :class:`CharTokenizer`
(``builtin:chars:<alphabet>``). ``from_config`` dispatches on the
``tokenizer_path`` spec; other paths (Hugging Face tokenizers) raise.
"""

from typing import Dict, List, Optional, Sequence, Union


class Tokenizer:
    """Minimal tokenizer interface used across the framework."""

    bos_token: str
    eos_token: str
    pad_token: str
    bos_token_id: int
    eos_token_id: int
    pad_token_id: int
    padding_side: str = "left"
    truncation_side: str = "right"
    vocab_size: int

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        raise NotImplementedError

    def batch_decode(self, batch: Sequence[Sequence[int]], skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    def __call__(
        self,
        text: Union[str, List[str]],
        truncation: bool = False,
        max_length: Optional[int] = None,
        add_special_tokens: bool = False,
        **_,
    ) -> Dict[str, list]:
        """HF-style call: returns dict with input_ids (+ attention_mask for
        batch input), truncating according to ``truncation_side``."""
        if isinstance(text, str):
            ids = self.encode(text, add_special_tokens)
            if truncation and max_length is not None:
                ids = self._truncate(ids, max_length)
            return {"input_ids": ids}
        outs = [self(t, truncation, max_length, add_special_tokens) for t in text]
        return {
            "input_ids": [o["input_ids"] for o in outs],
            "attention_mask": [[1] * len(o["input_ids"]) for o in outs],
        }

    def _truncate(self, ids: List[int], max_length: int) -> List[int]:
        if len(ids) <= max_length:
            return ids
        if self.truncation_side == "left":
            return ids[len(ids) - max_length :]
        return ids[:max_length]


class ByteTokenizer(Tokenizer):
    """UTF-8 byte-level tokenizer: ids 0..255 = bytes, 256 = bos, 257 = eos,
    258 = pad. Needs no vocabulary files — the offline default."""

    def __init__(self, padding_side: str = "left", truncation_side: str = "right"):
        self.bos_token_id = 256
        self.eos_token_id = 257
        self.pad_token_id = 258
        self.vocab_size = 259
        self.bos_token = "<|bos|>"
        self.eos_token = "<|eos|>"
        self.pad_token = "<|pad|>"
        self.padding_side = padding_side
        self.truncation_side = truncation_side
        self._specials = {
            self.bos_token: self.bos_token_id,
            self.eos_token: self.eos_token_id,
            self.pad_token: self.pad_token_id,
        }

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids: List[int] = []
        rest = text
        while rest:
            # scan for special-token strings embedded in the text
            next_special, next_pos = None, len(rest)
            for tok in self._specials:
                pos = rest.find(tok)
                if pos != -1 and pos < next_pos:
                    next_special, next_pos = tok, pos
            ids.extend(rest[:next_pos].encode("utf-8"))
            if next_special is None:
                break
            ids.append(self._specials[next_special])
            rest = rest[next_pos + len(next_special) :]
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out: List[str] = []
        buf: List[int] = []

        def flush():
            if buf:
                out.append(bytes(buf).decode("utf-8", errors="replace"))
                buf.clear()

        rev = {v: k for k, v in self._specials.items()}
        for i in ids:
            i = int(i)
            if i < 256:
                buf.append(i)
            else:
                flush()
                if not skip_special_tokens and i in rev:
                    out.append(rev[i])
        flush()
        return "".join(out)


class CharTokenizer(Tokenizer):
    """Fixed-alphabet character tokenizer for synthetic tasks: one id per
    character of ``alphabet``, then bos/eos/pad."""

    def __init__(
        self,
        alphabet: str,
        padding_side: str = "left",
        truncation_side: str = "right",
    ):
        self.alphabet = alphabet
        self._char_to_id = {c: i for i, c in enumerate(alphabet)}
        n = len(alphabet)
        self.bos_token_id = n
        self.eos_token_id = n + 1
        self.pad_token_id = n + 2
        self.vocab_size = n + 3
        self.bos_token = "<|bos|>"
        self.eos_token = "<|eos|>"
        self.pad_token = "<|pad|>"
        self.padding_side = padding_side
        self.truncation_side = truncation_side

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids: List[int] = []
        rest = text
        while rest:
            if rest.startswith(self.bos_token):
                ids.append(self.bos_token_id)
                rest = rest[len(self.bos_token) :]
            elif rest.startswith(self.eos_token):
                ids.append(self.eos_token_id)
                rest = rest[len(self.eos_token) :]
            elif rest.startswith(self.pad_token):
                ids.append(self.pad_token_id)
                rest = rest[len(self.pad_token) :]
            else:
                c = rest[0]
                if c not in self._char_to_id:
                    raise ValueError(f"Character {c!r} not in alphabet {self.alphabet!r}")
                ids.append(self._char_to_id[c])
                rest = rest[1:]
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i < len(self.alphabet):
                out.append(self.alphabet[i])
            elif not skip_special_tokens:
                out.append(
                    {self.bos_token_id: self.bos_token, self.eos_token_id: self.eos_token}.get(
                        i, self.pad_token
                    )
                )
        return "".join(out)


def from_config(config) -> Tokenizer:
    """Build a tokenizer from a :class:`TokenizerConfig`."""
    path = config.tokenizer_path
    if path.startswith("builtin:"):
        spec = path.split(":", 1)[1]
        if spec == "bytes":
            return ByteTokenizer(config.padding_side, config.truncation_side)
        if spec.startswith("chars:"):
            return CharTokenizer(spec[len("chars:") :], config.padding_side, config.truncation_side)
        raise ValueError(f"Unknown builtin tokenizer spec: {path}")
    raise ValueError(
        f"tokenizer {path!r}: the port has the builtin tokenizers only "
        "(builtin:bytes, builtin:chars:<alphabet>)"
    )
