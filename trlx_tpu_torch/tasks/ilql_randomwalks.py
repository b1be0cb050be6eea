"""ILQL on offline randomwalk data, through the port.

The port's version of ``examples/randomwalks/ilql_randomwalks.py``, with
its config unchanged: it learns from the reward-labeled random walks alone
(no environment interaction) and samples with advantage-shaped logits.

Run (on the GPU, or on the device named second; ``hparams`` are dot-path
overrides); the last line printed is the optimality curve, one value per
evaluation::

    python -m trlx_tpu_torch.tasks.ilql_randomwalks '{"train.total_steps": 160}' [cpu]
"""

from typing import Any, Dict, Optional

import trlx_tpu_torch.trlx as trlx
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_ilql_config
from trlx_tpu_torch.tasks.randomwalks import generate_random_walks


def main(hparams: Optional[Dict[str, Any]] = None, device: Any = None):
    metric_fn, _reward_fn, prompts, walks, rewards, alphabet = generate_random_walks(seed=1002)

    config = default_ilql_config().evolve(
        train=dict(
            seq_length=11,
            batch_size=64,
            total_steps=1000,
            epochs=100,
            eval_interval=50,
            checkpoint_interval=1000,
            checkpoint_dir="ckpts/ilql_randomwalks",
        ),
        model=dict(
            model_path="builtin:gpt2-test",
            model_extra_kwargs=dict(
                vocab_size=len(alphabet) + 3,
                hidden_size=144,
                num_layers=6,
                num_heads=12,
                intermediate_size=576,
                max_position_embeddings=16,
            ),
        ),
        tokenizer=dict(tokenizer_path=f"builtin:chars:{alphabet}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=2e-4, weight_decay=1e-6)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=1000, eta_min=2e-4, lr=2e-4)),
        method=dict(gen_kwargs=dict(max_new_tokens=9, top_k=10, beta=1.0, temperature=0.1)),
    )
    if hparams:
        config = TRLConfig.update(config, hparams)

    return trlx.train(
        samples=walks,
        rewards=rewards,
        eval_prompts=prompts,
        metric_fn=lambda samples, **kw: metric_fn(samples),
        config=config,
        device=device,
    )


if __name__ == "__main__":
    import json
    import sys

    trainer = main(json.loads(sys.argv[1]) if len(sys.argv) > 1 else None,
                   device=sys.argv[2] if len(sys.argv) > 2 else None)
    print(json.dumps({"optimality_curve": [st["metrics/optimality"]
                                           for _, st in trainer.tracker.history
                                           if "metrics/optimality" in st]}))
