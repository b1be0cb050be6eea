"""Offline ILQL summarization with a seq2seq (T5) policy, through the port.

The port's version of ``examples/summarize_rlhf/ilql_summarize_t5.py``:
``default_ilql_config()`` with ``seq_length`` 550, batch 8, the tokenizer
truncating on the left, AdamW at lr 1e-6 (betas 0.9 / 0.95, weight decay
1e-6) under a cosine schedule, and the example's method (tau 0.6, gamma
0.99, CQL 0.1, AWAC 1, alpha 1e-4, beta 0, the target heads synced every
step, twin Q heads; evaluation at ``beta`` 1, 2 and 3 with 50 new tokens
at top-k 50). Each TL;DR comparison gives two samples: [prompt, chosen]
at +1 and [prompt, rejected] at -1. The evaluation prompts are 64 TL;DR
posts, scored by the stage-2 reward model when ``reward_checkpoint_dir``
holds one (``tasks/summarize_rlhf.py``), else by ROUGE against their
reference summaries, as the example falls back.

Nothing is downloaded: the model is a ``builtin:`` spec with seeded random
weights (``builtin:t5-small``, the example's offline choice;
``builtin:flan_t5-xl`` is the width of the hub's
``pvduy/flant5-xl_openai_tldr_sft``, which waits for
``models/hf_interop.py``) on the byte tokenizer, and the data are the
example's templated posts and comparisons.

Run (on the GPU, or on the device named last)::

    python -m trlx_tpu_torch.tasks.ilql_summarize_t5 builtin:t5-small '{"train.total_steps": 4}' [cpu]
"""

from typing import Any, Dict, List, Optional, Tuple

import trlx_tpu_torch.trlx as trlx
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_ilql_config
from trlx_tpu_torch.tasks.summarize_rlhf import (
    load_comparisons,
    load_reward_fn,
    load_tldr,
    rouge_scores,
)

__all__ = ["config", "samples_and_rewards", "main"]


def config(model_path: str = "builtin:t5-small",
           hparams: Optional[Dict[str, Any]] = None,
           model_extra_kwargs: Optional[Dict[str, Any]] = None) -> TRLConfig:
    """The example's settings; ``hparams`` are dot-path overrides and
    ``model_extra_kwargs`` config overrides of the model (e.g. a depth
    cut)."""
    cfg = default_ilql_config().evolve(
        train=dict(seq_length=550, batch_size=8, total_steps=5000, epochs=100,
                   eval_interval=1000, checkpoint_interval=10000,
                   checkpoint_dir="ckpts/ilql_summarize_t5"),
        model=dict(model_path=model_path, model_arch_type="seq2seq", num_layers_unfrozen=-1,
                   model_extra_kwargs=dict(model_extra_kwargs or {})),
        tokenizer=dict(truncation_side="left"),
        optimizer=dict(name="adamw", kwargs=dict(lr=1e-6, betas=(0.9, 0.95), eps=1e-8,
                                                 weight_decay=1e-6)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=5000, eta_min=1e-6, lr=1e-6)),
        method=dict(tau=0.6, gamma=0.99, cql_scale=0.1, awac_scale=1, alpha=0.0001, beta=0,
                    steps_for_target_q_sync=1, two_qs=True,
                    gen_kwargs=dict(max_new_tokens=50, top_k=50, beta=[1, 2, 3],
                                    temperature=1.0)),
    )
    return TRLConfig.update(cfg, hparams) if hparams else cfg


def samples_and_rewards(n_pairs: int = 256) -> Tuple[List[List[str]], List[float]]:
    """[prompt, chosen] at +1 and [prompt, rejected] at -1 for each of
    ``n_pairs`` comparisons."""
    samples, rewards = [], []
    for pair in load_comparisons(n=n_pairs):
        samples += [[pair["prompt"], pair["chosen"]], [pair["prompt"], pair["rejected"]]]
        rewards += [1.0, -1.0]
    return samples, rewards


def main(model_path: str = "builtin:t5-small", hparams: Optional[Dict[str, Any]] = None,
         n_pairs: int = 256, n_eval: int = 64, reward_checkpoint_dir: str = "ckpts/reward_model",
         device: Any = None, model_extra_kwargs: Optional[Dict[str, Any]] = None,
         **train_kwargs):
    """ILQL through ``trlx_tpu_torch.train(samples=..., rewards=...)``;
    returns the trainer. ``train_kwargs`` pass on to ``train``."""
    samples, rewards = samples_and_rewards(n_pairs)
    tldr = load_tldr(n=n_eval)
    refs = {d["prompt"]: d["label"] for d in tldr}
    rm_score = load_reward_fn(reward_checkpoint_dir, device)

    def metric_fn(samples, prompts, outputs, **kwargs):
        if rm_score is not None:
            return {"rewards": [float(x) for x in rm_score(samples)]}
        return rouge_scores(outputs, [refs.get(p, "") for p in prompts])

    train_kwargs.setdefault("metric_fn", metric_fn)
    return trlx.train(samples=samples, rewards=rewards,
                      eval_prompts=[d["prompt"] for d in tldr],
                      config=config(model_path, hparams, model_extra_kwargs), device=device,
                      **train_kwargs)


if __name__ == "__main__":
    import json
    import sys

    trainer = main(sys.argv[1] if len(sys.argv) > 1 else "builtin:t5-small",
                   json.loads(sys.argv[2]) if len(sys.argv) > 2 else None,
                   device=sys.argv[3] if len(sys.argv) > 3 else None)
    print(json.dumps({"losses": [st["losses/loss"] for _, st in trainer.tracker.history
                                 if "losses/loss" in st]}))
