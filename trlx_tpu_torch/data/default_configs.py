"""The PPO, ILQL, SFT, GRPO and DPO presets of the port.

Port of ``default_ppo_config``, ``default_ilql_config``,
``default_sft_config``, ``default_grpo_config`` and ``default_dpo_config`` from
``trlx_tpu/data/default_configs.py``: the
same hyperparameters, field for field, with the offline builtin model and
tokenizer.
"""

from trlx_tpu_torch.data.configs import (
    ModelConfig,
    OptimizerConfig,
    ParallelConfig,
    SchedulerConfig,
    TokenizerConfig,
    TrainConfig,
    TRLConfig,
)
from trlx_tpu_torch.models.dpo import DPOConfig
from trlx_tpu_torch.models.grpo import GRPOConfig
from trlx_tpu_torch.models.ilql import ILQLConfig
from trlx_tpu_torch.models.ppo import PPOConfig
from trlx_tpu_torch.models.sft import SFTConfig

__all__ = ["default_ppo_config", "default_ilql_config", "default_sft_config",
           "default_grpo_config"]


def default_ppo_config() -> TRLConfig:
    return TRLConfig(
        train=TrainConfig(
            seq_length=1024,
            epochs=100,
            total_steps=10000,
            batch_size=32,
            checkpoint_interval=10000,
            eval_interval=100,
            pipeline="PromptPipeline",
            trainer="PPOTrainer",
        ),
        model=ModelConfig(model_path="builtin:gpt2-small", num_layers_unfrozen=2),
        tokenizer=TokenizerConfig(tokenizer_path="builtin:bytes", truncation_side="right"),
        optimizer=OptimizerConfig(
            name="adamw",
            kwargs=dict(lr=3e-5, betas=(0.9, 0.95), eps=1.0e-8, weight_decay=1.0e-6),
        ),
        scheduler=SchedulerConfig(
            name="cosine_annealing", kwargs=dict(T_max=1e12, eta_min=3e-5, lr=3e-5)
        ),
        method=PPOConfig(
            name="PPOConfig",
            num_rollouts=128,
            chunk_size=128,
            ppo_epochs=4,
            init_kl_coef=0.001,
            target=None,
            horizon=10000,
            gamma=1.0,
            lam=0.95,
            cliprange=0.2,
            cliprange_value=0.2,
            vf_coef=1.0,
            scale_reward="ignored",
            ref_mean=None,
            ref_std=None,
            cliprange_reward=10,
            gen_kwargs=dict(max_new_tokens=40, top_k=0, top_p=1.0, do_sample=True),
        ),
        parallel=ParallelConfig(),
    )


def default_ilql_config() -> TRLConfig:
    return TRLConfig(
        train=TrainConfig(
            seq_length=64,
            batch_size=128,
            epochs=100,
            total_steps=1000,
            checkpoint_interval=1000,
            eval_interval=100,
            pipeline="PromptPipeline",
            trainer="ILQLTrainer",
        ),
        model=ModelConfig(model_path="builtin:gpt2-small", num_layers_unfrozen=-1),
        tokenizer=TokenizerConfig(tokenizer_path="builtin:bytes", truncation_side="right"),
        optimizer=OptimizerConfig(
            name="adamw",
            kwargs=dict(lr=5.0e-5, betas=(0.9, 0.95), eps=1.0e-8, weight_decay=1.0e-6),
        ),
        scheduler=SchedulerConfig(
            name="cosine_annealing", kwargs=dict(T_max=1e12, eta_min=5.0e-5, lr=5.0e-5)
        ),
        method=ILQLConfig(
            name="ILQLConfig",
            tau=0.7,
            gamma=0.99,
            cql_scale=0.1,
            awac_scale=1.0,
            alpha=0.001,
            beta=0.0,
            steps_for_target_q_sync=5,
            two_qs=True,
            gen_kwargs=dict(max_new_tokens=56, top_k=20, beta=1.0, temperature=1.0),
        ),
        parallel=ParallelConfig(),
    )


def default_sft_config() -> TRLConfig:
    return TRLConfig(
        train=TrainConfig(
            seq_length=1024,
            epochs=100,
            total_steps=1000,
            batch_size=8,
            checkpoint_interval=10000,
            eval_interval=100,
            pipeline="PromptPipeline",
            trainer="SFTTrainer",
        ),
        model=ModelConfig(model_path="builtin:gpt2-small", num_layers_unfrozen=-1),
        tokenizer=TokenizerConfig(tokenizer_path="builtin:bytes", truncation_side="right"),
        optimizer=OptimizerConfig(
            name="adamw",
            kwargs=dict(lr=1.0e-4, betas=(0.9, 0.95), eps=1.0e-8, weight_decay=1.0e-6),
        ),
        scheduler=SchedulerConfig(
            name="cosine_annealing", kwargs=dict(T_max=1e12, eta_min=1.0e-4, lr=1.0e-4)
        ),
        method=SFTConfig(
            name="SFTConfig",
            gen_kwargs=dict(max_new_tokens=40, top_k=0, top_p=1.0, do_sample=True),
        ),
        parallel=ParallelConfig(),
    )


def default_grpo_config() -> TRLConfig:
    """DeepSeekMath-style GRPO: groups of 8, a fixed in-loss KL ``beta``,
    no value function."""
    return TRLConfig(
        train=TrainConfig(
            seq_length=1024,
            epochs=100,
            total_steps=10000,
            batch_size=32,
            checkpoint_interval=10000,
            eval_interval=100,
            pipeline="PromptPipeline",
            trainer="GRPOTrainer",
        ),
        model=ModelConfig(model_path="builtin:gpt2-small", num_layers_unfrozen=2),
        tokenizer=TokenizerConfig(tokenizer_path="builtin:bytes", truncation_side="right"),
        optimizer=OptimizerConfig(
            name="adamw",
            kwargs=dict(lr=1e-5, betas=(0.9, 0.95), eps=1.0e-8, weight_decay=1.0e-6),
        ),
        scheduler=SchedulerConfig(
            name="cosine_annealing", kwargs=dict(T_max=1e12, eta_min=1e-5, lr=1e-5)
        ),
        method=GRPOConfig(
            name="GRPOConfig",
            num_rollouts=128,
            chunk_size=128,
            ppo_epochs=2,
            group_size=8,
            beta=0.04,
            scale_advantage=True,
            cliprange=0.2,
            cliprange_reward=10,
            gen_kwargs=dict(max_new_tokens=40, top_k=0, top_p=1.0, do_sample=True),
        ),
        parallel=ParallelConfig(),
    )


def default_dpo_config() -> TRLConfig:
    """DPO preset: direct preference optimization on (prompt, chosen,
    rejected) triples — no rollouts, no reward model."""
    return TRLConfig(
        train=TrainConfig(
            seq_length=1024,
            epochs=100,
            total_steps=2000,
            batch_size=16,
            checkpoint_interval=10000,
            eval_interval=100,
            pipeline="PromptPipeline",
            trainer="DPOTrainer",
        ),
        model=ModelConfig(model_path="builtin:gpt2-small", num_layers_unfrozen=-1),
        tokenizer=TokenizerConfig(tokenizer_path="builtin:bytes", truncation_side="left"),
        optimizer=OptimizerConfig(
            name="adamw",
            kwargs=dict(lr=5e-6, betas=(0.9, 0.95), eps=1.0e-8, weight_decay=1.0e-6),
        ),
        scheduler=SchedulerConfig(
            name="cosine_annealing", kwargs=dict(T_max=1e12, eta_min=5e-6, lr=5e-6)
        ),
        method=DPOConfig(
            name="DPOConfig",
            beta=0.1,
            label_smoothing=0.0,
            gen_kwargs=dict(max_new_tokens=40, top_k=0, top_p=1.0, do_sample=True),
        ),
        parallel=ParallelConfig(),
    )
