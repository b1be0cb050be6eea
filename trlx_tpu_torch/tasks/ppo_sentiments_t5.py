"""PPO sentiment steering with a seq2seq (T5) policy, through the port.

The port's version of ``examples/ppo_sentiments_t5.py``:
``default_ppo_config()`` with ``seq_length`` 128, batch 32, 128 rollouts
in one chunk of 128, 40 new tokens at top-p 0.95, the whole decoder
training (``num_layers_unfrozen`` -1, a frozen full copy as the
reference), the tokenizer padding on the right; 256 templated review
openings followed by ``" <extra_id_0>"`` as prompts and 64 as evaluation
prompts, rewarded by the positive sentiment of the output.

Nothing is downloaded: the model is the example's offline choice, a
``builtin:`` spec with seeded random weights (``builtin:t5-small``; the
hub's ``lvwerra/t5-imdb`` waits for ``models/hf_interop.py``) on the byte
tokenizer, and the sentiment is the example's lexicon scorer
(``tasks/sentiment.py``).

Run (on the GPU, or on the device named last; ``hparams`` are dot-path
overrides); the last line printed is the mean eval reward, one value per
evaluation::

    python -m trlx_tpu_torch.tasks.ppo_sentiments_t5 builtin:t5-small '{"train.total_steps": 4}' [cpu]
"""

from typing import Any, Dict, List, Optional

import trlx_tpu_torch.trlx as trlx
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.tasks.sentiment import lexicon_sentiment, review_prompts

__all__ = ["config", "prompts", "main", "reward_fn"]


def config(model_path: str = "builtin:t5-small",
           hparams: Optional[Dict[str, Any]] = None) -> TRLConfig:
    """The example's settings; ``hparams`` are dot-path overrides."""
    cfg = default_ppo_config().evolve(
        train=dict(seq_length=128, batch_size=32, total_steps=10000, eval_interval=100,
                   checkpoint_interval=10000, checkpoint_dir="ckpts/ppo_sentiments_t5"),
        model=dict(model_path=model_path, model_arch_type="seq2seq", num_layers_unfrozen=-1),
        tokenizer=dict(padding_side="right"),
        method=dict(num_rollouts=128, chunk_size=128,
                    gen_kwargs=dict(max_new_tokens=40, top_k=0, top_p=0.95, do_sample=True)),
    )
    return TRLConfig.update(cfg, hparams) if hparams else cfg


def prompts(n: int = 256, seed: int = 0) -> List[str]:
    """``n`` review openings, each followed by T5's first sentinel."""
    return [p + " <extra_id_0>" for p in review_prompts(n, seed=seed)]


def reward_fn(samples: List[str], prompts=None, outputs=None, **kwargs) -> List[float]:
    """The positive sentiment of the output alone."""
    return lexicon_sentiment(outputs)


def main(model_path: str = "builtin:t5-small", hparams: Optional[Dict[str, Any]] = None,
         device: Any = None, **train_kwargs):
    """PPO through ``trlx_tpu_torch.train``; returns the trainer.
    ``train_kwargs`` pass on to ``train`` (e.g. ``init_trainer_hook``)."""
    train_kwargs.setdefault("reward_fn", reward_fn)
    return trlx.train(prompts=prompts(256, seed=0), eval_prompts=prompts(64, seed=1),
                      config=config(model_path, hparams), device=device, **train_kwargs)


if __name__ == "__main__":
    import json
    import sys

    trainer = main(sys.argv[1] if len(sys.argv) > 1 else "builtin:t5-small",
                   json.loads(sys.argv[2]) if len(sys.argv) > 2 else None,
                   device=sys.argv[3] if len(sys.argv) > 3 else None)
    print(json.dumps({"reward_curve": [st["reward/mean"] for _, st in trainer.tracker.history
                                       if "reward/mean" in st]}))
