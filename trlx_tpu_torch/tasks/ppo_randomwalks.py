"""PPO on the randomwalks task, through the port.

The port's version of ``examples/randomwalks/ppo_randomwalks.py``: the same
task (seed 1002), the same six-layer model (hidden 144, 12 heads of head
dim 12, intermediate 576, 16 positions), the same preset changes, and the
same warm start: ``min(400, 2 · total_steps)`` SFT steps on the task's
walk corpus, whose backbone is then copied into the policy and into its
full frozen reference (``num_layers_unfrozen: -1``).

Changes from the example's config:

- ``train.continuous_batching: true``. The example's preset collects
  rollouts on the JAX serial dense path, which the port does not run; the
  port collects on its paged engine. The engine and loss settings beside
  it (``engine.backend: paged``, the engine kernels and
  ``method.loss_kernel: pallas``) name the kernels the port runs; the JAX
  package holds them equal to its defaults;
- the warm start's evaluation samples the task's 9 new tokens, not the
  SFT preset's 40: 40 run past the model's 16 positions, where the JAX
  embedding lookup reads NaN rows (``jnp.take`` fills out-of-range rows)
  and the port's raises. Nothing reads that evaluation.

With ``method.num_rollouts`` below ``method.chunk_size``, a collection on
the continuous path keeps the sequences that finish first (the JAX
continuous path does the same), the shortest answers of each chunk; the
serial path keeps the first ``num_rollouts`` in prompt order. Set
``chunk_size`` to ``num_rollouts`` there to keep whole chunks.

Run (on the GPU, or on the device named second; ``hparams`` are dot-path
overrides); the last line printed is the optimality curve, one value per
evaluation::

    python -m trlx_tpu_torch.tasks.ppo_randomwalks '{"train.total_steps": 160}' [cpu]
"""

from typing import Any, Dict, Optional

import trlx_tpu_torch.trlx as trlx
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_ppo_config, default_sft_config
from trlx_tpu_torch.tasks.randomwalks import generate_random_walks

# the port's paged engine and fused loss kernels (see the module docstring)
PORT_SETTINGS = dict(
    train=dict(continuous_batching=True),
    engine=dict(backend="paged", decode_kernel="pallas", prefill_kernel="pallas"),
    method=dict(loss_kernel="pallas"),
)


def model_settings(alphabet: str) -> Dict[str, Any]:
    return dict(
        model_path="builtin:gpt2-test",
        num_layers_unfrozen=-1,
        model_extra_kwargs=dict(
            vocab_size=len(alphabet) + 3,
            hidden_size=144,
            num_layers=6,
            num_heads=12,
            intermediate_size=576,
            max_position_embeddings=16,
        ),
    )


def warmstart_state(walks, prompts, alphabet, config: TRLConfig, device: Any = None):
    """SFT on the task's walks (the offline stand-in for the reference's
    pretrained ``CarperAI/randomwalks``); returns the backbone's weights."""
    steps = min(400, 2 * config.train.total_steps)
    sft_cfg = default_sft_config().evolve(
        train=dict(
            seq_length=config.train.seq_length,
            batch_size=config.train.batch_size,
            total_steps=steps,
            epochs=10_000,
            eval_interval=10 * steps,
            checkpoint_interval=10 * steps,
            save_best=False,
            checkpoint_dir=config.train.checkpoint_dir + "/sft_warmstart",
            tracker=None,
        ),
        model=model_settings(alphabet),
        tokenizer=dict(tokenizer_path=f"builtin:chars:{alphabet}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=1e-3, weight_decay=1e-6)),
        scheduler=dict(name="constant", kwargs=dict(lr=1e-3)),
        method=dict(gen_kwargs=dict(max_new_tokens=config.method.gen_kwargs["max_new_tokens"])),
    )
    sft = trlx.train(samples=[[w[:1], w[1:]] for w in walks], eval_prompts=prompts,
                     config=sft_cfg, device=device)
    return {k: v.detach().clone() for k, v in sft.model.state_dict().items()}


def main(hparams: Optional[Dict[str, Any]] = None, device: Any = None):
    metric_fn, reward_fn, prompts, walks, _rewards, alphabet = generate_random_walks(seed=1002)

    config = default_ppo_config().evolve(
        train=dict(
            seq_length=11,
            batch_size=64,
            total_steps=1000,
            epochs=100,
            eval_interval=20,
            checkpoint_interval=1000,
            checkpoint_dir="ckpts/ppo_randomwalks",
        ),
        model=model_settings(alphabet),
        tokenizer=dict(tokenizer_path=f"builtin:chars:{alphabet}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=3e-4, weight_decay=1e-6)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=1000, eta_min=3e-4, lr=3e-4)),
        method=dict(
            num_rollouts=128,
            chunk_size=128,
            ppo_epochs=4,
            init_kl_coef=0.05,
            gen_kwargs=dict(max_new_tokens=9, top_k=0, top_p=1.0, do_sample=True),
        ),
    ).evolve(**PORT_SETTINGS)
    if hparams:
        config = TRLConfig.update(config, hparams)

    warm = warmstart_state(walks, prompts, alphabet, config, device)

    def init_trainer_hook(trainer):
        # the warm-started backbone into the policy and the frozen reference
        # (a full copy: num_layers_unfrozen is -1)
        trainer.model.backbone.load_state_dict(warm)
        trainer.ref_params = trainer._ref_snapshot()

    return trlx.train(
        reward_fn=lambda samples, **kw: reward_fn(samples),
        metric_fn=lambda samples, **kw: metric_fn(samples),
        # the 20 start nodes repeated, so rollout chunks fill one shape
        prompts=prompts * 32,
        eval_prompts=prompts,
        config=config,
        init_trainer_hook=init_trainer_hook,
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
