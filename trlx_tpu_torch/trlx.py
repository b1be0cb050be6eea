"""Public API of the port: ``train()`` for online RL, offline RL and
supervised fine-tuning.

Port of ``trlx_tpu/trlx.py::train``: a ``reward_fn`` selects online PPO,
``samples`` with ``rewards`` offline ILQL, ``samples`` alone SFT. The user
callback contracts are the JAX package's:

- ``reward_fn(samples, prompts, outputs) -> List[float]``
- ``metric_fn(samples, prompts, outputs) -> Dict[str, List[float]]``

Training runs on the GPU unless the caller passes ``device="cpu"``.
"""

import importlib
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import (
    default_ilql_config,
    default_ppo_config,
    default_sft_config,
)
from trlx_tpu_torch.utils import set_seed

__all__ = ["train"]


def train(  # noqa: C901
    model_path: Optional[str] = None,
    reward_fn: Optional[Callable[[List[str], List[str], List[str]], List[float]]] = None,
    dataset: Optional[Iterable[Tuple[str, float]]] = None,
    samples: Optional[List[str]] = None,
    rewards: Optional[List[float]] = None,
    prompts: Optional[List[str]] = None,
    eval_prompts: Optional[List[str]] = None,
    metric_fn: Optional[Callable[[List[str], List[str], List[str]], Dict[str, List[float]]]] = None,
    config: Optional[TRLConfig] = None,
    stop_sequences: Optional[List[str]] = None,
    init_trainer_hook: Optional[Callable] = None,
    device: Any = None,
):
    """Dispatch online RL (``reward_fn``), offline RL (``samples`` and
    ``rewards``) or supervised fine-tuning (``samples``): build the
    trainer, collect the first rollouts or the offline store, and
    ``learn()``. Returns the trainer.

    ``samples`` are strings or interleaved ``(prompt_0, output_0, ...)``
    lists; ``dataset`` (deprecated) is ``(samples, rewards)``. Without a
    ``config`` the method's preset is used, with a warning.
    ``init_trainer_hook(trainer)`` runs before any rollout or training
    (e.g. to transplant warm-start weights into the policy and its
    reference)."""
    for module in ("trlx_tpu_torch.pipeline.offline_pipeline", "trlx_tpu_torch.trainer.ppo",
                   "trlx_tpu_torch.trainer.ilql", "trlx_tpu_torch.trainer.sft"):
        importlib.import_module(module)
    from trlx_tpu_torch.pipeline import get_pipeline
    from trlx_tpu_torch.trainer import get_trainer

    if config is None:
        warnings.warn(
            "Passing the `config` argument implicitly is deprecated; adapt one "
            "from `trlx_tpu_torch/data/default_configs.py` instead"
        )
        if reward_fn:
            config = default_ppo_config()
        elif rewards:
            config = default_ilql_config()
        else:
            config = default_sft_config()
    set_seed(config.train.seed)
    if dataset:
        warnings.warn("the `dataset` argument is deprecated, split it into `samples` and `rewards`")
        samples, rewards = dataset
    if model_path:
        config.model.model_path = model_path

    trainer = get_trainer(config.train.trainer)(
        config=config, reward_fn=reward_fn, metric_fn=metric_fn,
        stop_sequences=stop_sequences or [], device=device,
        **config.train.trainer_kwargs,
    )
    if init_trainer_hook is not None:
        init_trainer_hook(trainer)

    batch_size = config.train.batch_size
    max_prompt_length = config.train.seq_length - config.method.gen_kwargs["max_new_tokens"]
    if reward_fn:
        prompts = prompts or [trainer.tokenizer.bos_token] * batch_size
        if eval_prompts is None:
            eval_prompts = prompts[:batch_size]
        pipeline = get_pipeline(config.train.pipeline)(prompts, max_prompt_length,
                                                       trainer.tokenizer)
        trainer.add_prompt_pipeline(pipeline)
        trainer.make_experience(config.method.num_rollouts)
    elif samples:
        if rewards is not None and len(samples) != len(rewards):
            raise ValueError(f"Number of samples {len(samples)} should match the number of "
                             f"rewards {len(rewards)}")
        if eval_prompts is None:
            eval_prompts = [trainer.tokenizer.bos_token] * batch_size
        if rewards is not None:
            trainer.make_experience(samples, rewards, config.train.seq_length)
        else:
            trainer.make_experience(samples, config.train.seq_length)
    else:
        raise ValueError("Either `samples` or `reward_fn` should be given for training")

    eval_pipeline = get_pipeline(config.train.pipeline)(
        eval_prompts, max_prompt_length, trainer.tokenizer)
    trainer.add_eval_pipeline(eval_pipeline)
    trainer.learn()
    return trainer
