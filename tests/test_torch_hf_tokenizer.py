"""The port's ``HFTokenizer`` (``trlx_tpu_torch/data/tokenizer.py``) against
JAX's on the vendored byte-level BPE (``tests/fixtures/tiny_bpe``, vocab
350), on the CPU: ``from_config`` dispatch, ``encode`` / ``decode`` /
``__call__`` on texts drawn by numpy from a seed, the padding and
truncation sides, ``tokenize_dialogue`` and the prompt pipeline's left
padding; and the ``ImportError`` without ``transformers``.
"""

import os
import sys

import numpy as np
import pytest

from trlx_tpu.data.configs import TokenizerConfig as JaxTokenizerConfig
from trlx_tpu.data.tokenizer import from_config as jax_from_config
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPromptPipeline
from trlx_tpu.pipeline.offline_pipeline import tokenize_dialogue as jax_tokenize_dialogue
from trlx_tpu_torch.data.configs import TokenizerConfig
from trlx_tpu_torch.data.tokenizer import HFTokenizer, from_config
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline, tokenize_dialogue
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "tiny_bpe")
WORDS = ["the", "movie", "was", "great", "terrible", "hello", "world", "review", "film", "a",
         "!", ",", "user:", "bot:", "é", "   ", "\n", "12", "<|endoftext|>"]


def _texts(n=24, seed=0):
    rs = np.random.RandomState(seed)
    return ["".join(WORDS[i] + (" " if rs.rand() < 0.6 else "")
                    for i in rs.randint(0, len(WORDS), rs.randint(0, 12))) for _ in range(n)]


def _pair(padding_side="left", truncation_side="right"):
    ours = from_config(TokenizerConfig(FIXTURE, padding_side, truncation_side))
    theirs = jax_from_config(JaxTokenizerConfig(FIXTURE, padding_side, truncation_side))
    assert isinstance(ours, HFTokenizer)
    return ours, theirs


def test_specials_and_vocab():
    ours, theirs = _pair()
    for name in ("vocab_size", "bos_token_id", "eos_token_id", "pad_token_id", "pad_token",
                 "eos_token", "padding_side", "truncation_side"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.vocab_size == 350 and ours.pad_token_id is not None


@pytest.mark.parametrize("add_special_tokens", [False, True])
def test_encode_decode(add_special_tokens):
    ours, theirs = _pair()
    for text in _texts():
        ids = ours.encode(text, add_special_tokens=add_special_tokens)
        assert ids == theirs.encode(text, add_special_tokens=add_special_tokens), text
        for skip in (True, False):
            assert ours.decode(ids, skip_special_tokens=skip) == theirs.decode(
                ids, skip_special_tokens=skip)
        assert ours.batch_decode([ids, ids[:3]]) == theirs.batch_decode([ids, ids[:3]])


@pytest.mark.parametrize("padding_side", ["left", "right"])
@pytest.mark.parametrize("truncation_side", ["left", "right"])
def test_call_padding_and_truncation(padding_side, truncation_side):
    ours, theirs = _pair(padding_side, truncation_side)
    texts = _texts(8, seed=1)
    for kw in (dict(padding=True), dict(truncation=True, max_length=5, padding="max_length")):
        got, want = ours(texts, **kw), theirs(texts, **kw)
        assert got["input_ids"] == want["input_ids"] and \
            got["attention_mask"] == want["attention_mask"], kw


@pytest.mark.parametrize("truncation_side", ["left", "right"])
@pytest.mark.parametrize("max_length", [4, 7, 12, 64])
def test_tokenize_dialogue(truncation_side, max_length):
    ours, theirs = _pair(truncation_side=truncation_side)
    rs = np.random.RandomState(max_length)
    texts = _texts(6, seed=max_length)
    for dialogue in (texts[0] or "x", [texts[1], texts[2] or "y"],
                     ["user: " + "a" * int(rs.randint(5, 40)), "bot: " + "b" * 30]):
        got = tokenize_dialogue(dialogue, ours, max_length)
        want = jax_tokenize_dialogue(dialogue, theirs, max_length)
        assert [(tuple(m.tokens), m.is_output) for m in got] == \
            [(tuple(m.tokens), m.is_output) for m in want], dialogue


@pytest.mark.parametrize("padding_side", ["left", "right"])
@pytest.mark.parametrize("truncation_side", ["left", "right"])
def test_prompt_pipeline(padding_side, truncation_side):
    """Prompts left-pad whatever ``padding_side`` says, and truncate on
    ``truncation_side``, as in JAX."""
    ours, theirs = _pair(padding_side, truncation_side)
    prompts = _texts(6, seed=2) + [" ".join(["movie"] * 30)]
    got = next(iter(PromptPipeline(prompts, 8, ours).create_loader(len(prompts))))
    want = next(iter(JaxPromptPipeline(prompts, 8, theirs).create_loader(len(prompts))))
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))


def test_needs_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers package"):
        from_config(TokenizerConfig(FIXTURE))
