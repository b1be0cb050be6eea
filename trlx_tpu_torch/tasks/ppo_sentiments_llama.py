"""PPO sentiment steering on LLaMA-7B, through the port.

The port's version of ``examples/ppo_sentiments_llama.py``, with its
settings as they stand: ``default_ppo_config()`` with ``seq_length`` 1024,
batch 32, 128 rollouts in one chunk of 128, 4 PPO epochs, 40 new tokens
(top-k 0, top-p 1.0, sampled), ``init_kl_coef`` 0.05, the hydra
reference over the top 2 layers (``num_layers_unfrozen`` 2), AdamW at
1e-5 with betas (0.9, 0.95) under cosine annealing to 1e-5, bf16 compute
and ``parallel.remat: minimal``. The example's ``fsdp: -1`` spreads the
model over the chips of one host; the port runs on one device, where that
axis has size 1.

Nothing is downloaded: the model is the example's offline choice,
``builtin:llama-7b`` with seeded random weights on the byte tokenizer, and
the sentiment is the lexicon scorer the example falls back to
(``tasks/sentiment.py``); 256 review openings are the prompts and 64 the
evaluation prompts.

Run (on the GPU, or on the device named last; ``hparams`` are dot-path
overrides, e.g. ``{"model.model_extra_kwargs.num_layers": 4}`` to cut
the depth); the last line printed is the mean eval reward, one value per
evaluation::

    python -m trlx_tpu_torch.tasks.ppo_sentiments_llama builtin:llama-7b '{"train.total_steps": 4}' [cpu]
"""

from typing import Any, Dict, List, Optional

import trlx_tpu_torch.trlx as trlx
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.tasks.sentiment import lexicon_sentiment, review_prompts

__all__ = ["config", "main", "reward_fn"]


def config(model_path: str = "builtin:llama-7b", tokenizer_path: str = "builtin:bytes",
           hparams: Optional[Dict[str, Any]] = None) -> TRLConfig:
    """The example's settings; ``hparams`` are dot-path overrides."""
    cfg = default_ppo_config().evolve(
        train=dict(seq_length=1024, batch_size=32, total_steps=10000, eval_interval=100,
                   checkpoint_interval=10000, save_best=False,
                   checkpoint_dir="ckpts/ppo_sentiments_llama"),
        model=dict(model_path=model_path, num_layers_unfrozen=2),
        tokenizer=dict(tokenizer_path=tokenizer_path, truncation_side="right"),
        optimizer=dict(name="adamw", kwargs=dict(lr=1e-5, betas=(0.9, 0.95), eps=1e-8,
                                                 weight_decay=1e-6)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=10000, eta_min=1e-5,
                                                            lr=1e-5)),
        parallel=dict(data=1, fsdp=-1, model=1, compute_dtype="bfloat16", remat="minimal"),
        method=dict(num_rollouts=128, chunk_size=128, ppo_epochs=4, init_kl_coef=0.05,
                    gen_kwargs=dict(max_new_tokens=40, top_k=0, top_p=1.0, do_sample=True)),
    )
    return TRLConfig.update(cfg, hparams) if hparams else cfg


def reward_fn(samples: List[str], prompts=None, outputs=None, **kwargs) -> List[float]:
    """The positive sentiment of the output alone."""
    return lexicon_sentiment(outputs)


def main(model_path: str = "builtin:llama-7b", hparams: Optional[Dict[str, Any]] = None,
         device: Any = None, **train_kwargs):
    """PPO through ``trlx_tpu_torch.train``; returns the trainer.
    ``train_kwargs`` pass on to ``train`` (e.g. ``init_trainer_hook``)."""
    train_kwargs.setdefault("reward_fn", reward_fn)
    return trlx.train(prompts=review_prompts(256, seed=0), eval_prompts=review_prompts(64),
                      config=config(model_path, hparams=hparams), device=device, **train_kwargs)


if __name__ == "__main__":
    import json
    import sys

    trainer = main(sys.argv[1] if len(sys.argv) > 1 else "builtin:llama-7b",
                   json.loads(sys.argv[2]) if len(sys.argv) > 2 else None,
                   device=sys.argv[3] if len(sys.argv) > 3 else None)
    print(json.dumps({"reward_curve": [st["reward/mean"] for _, st in trainer.tracker.history
                                       if "reward/mean" in st]}))
