"""GRPO on a mixture-of-experts (Mixtral-family) policy, through the port.

The port's version of ``examples/grpo_moe_mixtral.py``: ``default_grpo_config()``
with ``seq_length`` 128, batch 32, 40 sampled tokens and the router losses
on (``router_aux_coef`` 0.01, ``router_z_coef`` 0.001 through
``model.model_extra_kwargs``), 256 templated review openings as prompts
and 64 as evaluation prompts, rewarded by positive sentiment.

Nothing is downloaded: the model is a ``builtin:`` spec with seeded random
weights (``builtin:mixtral-test`` by default; ``builtin:mixtral-8x7b`` with
``main(model_extra_kwargs={"num_layers": k})`` cut to fit is the full width), the
sentiment is the example's lexicon scorer and the prompts its templated
reviews (the offline fallbacks of ``examples/sentiment_util.py``, copied
into ``tasks/sentiment.py``).

Run (on the GPU, or on the device named last; ``hparams`` are dot-path
overrides); the last line printed is the mean eval reward, one value per
evaluation::

    python -m trlx_tpu_torch.tasks.grpo_sentiments builtin:mixtral-test '{"train.total_steps": 8}' [cpu]
"""

from typing import Any, Dict, List, Optional

import trlx_tpu_torch.trlx as trlx
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_grpo_config
from trlx_tpu_torch.tasks.sentiment import lexicon_sentiment, review_prompts

__all__ = ["config", "lexicon_sentiment", "main", "review_prompts", "reward_fn"]


def config(model_path: str = "builtin:mixtral-test",
           hparams: Optional[Dict[str, Any]] = None,
           model_extra_kwargs: Optional[Dict[str, Any]] = None) -> TRLConfig:
    """The example's settings; ``hparams`` are dot-path overrides and
    ``model_extra_kwargs`` join the router coefficients (e.g. a
    ``num_layers`` cut)."""
    extra = dict(router_aux_coef=0.01, router_z_coef=0.001, **(model_extra_kwargs or {}))
    cfg = default_grpo_config().evolve(
        train=dict(seq_length=128, batch_size=32, total_steps=2000, eval_interval=100,
                   checkpoint_interval=10000, checkpoint_dir="ckpts/grpo_sentiments"),
        model=dict(model_path=model_path, model_extra_kwargs=extra),
        method=dict(gen_kwargs=dict(max_new_tokens=40, top_k=0, top_p=1.0, do_sample=True)),
    )
    return TRLConfig.update(cfg, hparams) if hparams else cfg


def reward_fn(samples: List[str], prompts=None, outputs=None, **kwargs) -> List[float]:
    return lexicon_sentiment(samples)


def main(model_path: str = "builtin:mixtral-test", hparams: Optional[Dict[str, Any]] = None,
         device: Any = None, model_extra_kwargs: Optional[Dict[str, Any]] = None,
         **train_kwargs):
    """GRPO through ``trlx_tpu_torch.train``; returns the trainer.
    ``train_kwargs`` pass on to ``train`` (e.g. ``init_trainer_hook``, or a
    ``reward_fn`` in place of the lexicon sentiment)."""
    train_kwargs.setdefault("reward_fn", reward_fn)
    return trlx.train(prompts=review_prompts(256, seed=0),
                      eval_prompts=review_prompts(64, seed=1),
                      config=config(model_path, hparams, model_extra_kwargs), device=device,
                      **train_kwargs)


if __name__ == "__main__":
    import json
    import sys

    trainer = main(sys.argv[1] if len(sys.argv) > 1 else "builtin:mixtral-test",
                   json.loads(sys.argv[2]) if len(sys.argv) > 2 else None,
                   device=sys.argv[3] if len(sys.argv) > 3 else None)
    print(json.dumps({"reward_curve": [st["reward/mean"] for _, st in trainer.tracker.history
                                       if "reward/mean" in st]}))
