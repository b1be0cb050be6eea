"""The sentiment tasks' data and scorer, shared by the port's DPO and GRPO
drivers.

Copies of the offline fallbacks of ``examples/sentiment_util.py``: the
lexicon sentiment scorer, the templated review corpus (``load_imdb_texts``
without ``datasets``) and the review openings used as prompts. Nothing is
downloaded.
"""

from typing import List, Tuple

import numpy as np

__all__ = ["POSITIVE_WORDS", "NEGATIVE_WORDS", "lexicon_sentiment", "load_imdb_texts",
           "review_prompts"]

POSITIVE_WORDS = (
    "great good wonderful excellent amazing love loved beautiful best "
    "fantastic brilliant enjoyable masterpiece superb delightful charming "
    "perfect stunning captivating remarkable"
).split()
NEGATIVE_WORDS = (
    "bad terrible awful worst boring hate hated dull poor disappointing "
    "mediocre horrible waste annoying mess bland lifeless tedious forgettable "
    "unwatchable"
).split()

_TEMPLATES_POS = [
    "This movie was {} and I loved every minute of it.",
    "An absolutely {} film, the best I have seen this year.",
    "The acting was {} and the story kept me captivated.",
]
_TEMPLATES_NEG = [
    "This movie was {} and I hated every minute of it.",
    "An absolutely {} film, the worst I have seen this year.",
    "The acting was {} and the story was a boring mess.",
]


def lexicon_sentiment(texts: List[str]) -> List[float]:
    """Positive-sentiment score in [0, 1]: pos / (pos + neg) over the
    lexicon's words, 0.5 for a text with none."""
    scores = []
    for t in texts:
        words = t.lower().split()
        pos = sum(w.strip(".,!?") in POSITIVE_WORDS for w in words)
        neg = sum(w.strip(".,!?") in NEGATIVE_WORDS for w in words)
        scores.append(pos / (pos + neg) if pos + neg else 0.5)
    return scores


def load_imdb_texts(n: int = 512, seed: int = 0) -> Tuple[List[str], List[int]]:
    """``n`` templated reviews and their labels (1 positive, 0 negative),
    half of each at random."""
    rng = np.random.RandomState(seed)
    texts, labels = [], []
    for _ in range(n):
        if rng.rand() < 0.5:
            texts.append(rng.choice(_TEMPLATES_POS).format(rng.choice(POSITIVE_WORDS)))
            labels.append(1)
        else:
            texts.append(rng.choice(_TEMPLATES_NEG).format(rng.choice(NEGATIVE_WORDS)))
            labels.append(0)
    return texts, labels


def review_prompts(n: int = 128, seed: int = 0, prompt_words: int = 4) -> List[str]:
    """The first ``prompt_words`` words of ``n`` templated reviews."""
    texts, _ = load_imdb_texts(n, seed)
    return [" ".join(t.split()[:prompt_words]) for t in texts]
