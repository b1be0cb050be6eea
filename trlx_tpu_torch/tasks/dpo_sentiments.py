"""DPO on sentiment preference pairs, through the port.

The port's version of ``examples/dpo_sentiments.py``: ``default_dpo_config()``
with ``seq_length`` 256, batch 16, 256 ``(prompt, chosen, rejected)``
triples — the chosen completion from a positive review, the rejected from
a negative one — and 64 review openings as evaluation prompts, scored by
the lexicon sentiment of the generations (``metrics/sentiment``).

Nothing is downloaded: the model is a ``builtin:`` spec with seeded random
weights (``builtin:gpt2-small`` by default) on the byte tokenizer, and the
reviews are the example's templated offline corpus (``tasks/sentiment.py``).

Run (on the GPU, or on the device named last; ``hparams`` are dot-path
overrides); the last line printed is the sentiment at each evaluation::

    python -m trlx_tpu_torch.tasks.dpo_sentiments builtin:gpt2-test '{"train.total_steps": 4}' [cpu]
"""

from typing import Any, Dict, List, Optional, Tuple

import trlx_tpu_torch.trlx as trlx
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_dpo_config
from trlx_tpu_torch.tasks.sentiment import lexicon_sentiment, load_imdb_texts, review_prompts

__all__ = ["config", "main", "metric_fn", "preference_triples"]


def preference_triples(n: int, seed: int = 0, prompt_words: int = 4
                       ) -> List[Tuple[str, str, str]]:
    """``n`` triples: a positive review's opening words as the prompt, the
    rest of it (up to 200 characters) as the chosen completion, and the
    rest of a negative review as the rejected one."""
    texts, labels = load_imdb_texts(4 * n, seed=seed)
    pos = [t for t, label in zip(texts, labels) if label == 1]
    neg = [t for t, label in zip(texts, labels) if label == 0]
    if not pos or not neg:
        raise ValueError("need both positive and negative reviews for preference pairs")
    triples = []
    for i in range(n):
        p, q = pos[i % len(pos)], neg[i % len(neg)]
        prompt = " ".join(p.split()[:prompt_words])
        chosen = " " + " ".join(p.split()[prompt_words:])[:200]
        rejected = " " + " ".join(q.split()[prompt_words:])[:200]
        triples.append((prompt, chosen, rejected))
    return triples


def config(model_path: str = "builtin:gpt2-small",
           hparams: Optional[Dict[str, Any]] = None) -> TRLConfig:
    """The example's settings; ``hparams`` are dot-path overrides."""
    cfg = default_dpo_config().evolve(
        train=dict(seq_length=256, batch_size=16, total_steps=1000, eval_interval=100,
                   checkpoint_interval=10000, checkpoint_dir="ckpts/dpo_sentiments"),
        model=dict(model_path=model_path),
    )
    return TRLConfig.update(cfg, hparams) if hparams else cfg


def metric_fn(samples: List[str], prompts=None, outputs=None, **kwargs) -> Dict[str, List[float]]:
    return {"sentiment": lexicon_sentiment(samples)}


def main(model_path: str = "builtin:gpt2-small", hparams: Optional[Dict[str, Any]] = None,
         device: Any = None, **train_kwargs):
    """DPO through ``trlx_tpu_torch.train``; returns the trainer.
    ``train_kwargs`` pass on to ``train`` (e.g. ``init_trainer_hook``)."""
    return trlx.train(samples=preference_triples(256, seed=0),
                      eval_prompts=review_prompts(64, seed=1), metric_fn=metric_fn,
                      config=config(model_path, hparams), device=device, **train_kwargs)


if __name__ == "__main__":
    import json
    import sys

    trainer = main(sys.argv[1] if len(sys.argv) > 1 else "builtin:gpt2-small",
                   json.loads(sys.argv[2]) if len(sys.argv) > 2 else None,
                   device=sys.argv[3] if len(sys.argv) > 3 else None)
    print(json.dumps({"sentiment_curve": [st["metrics/sentiment"]
                                          for _, st in trainer.tracker.history
                                          if "metrics/sentiment" in st]}))
