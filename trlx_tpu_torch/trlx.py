"""Public API of the port: ``train()`` for online RL.

Port of ``trlx_tpu/trlx.py::train`` for the ``reward_fn`` branch (online
PPO). The user callback contracts are the JAX package's:

- ``reward_fn(samples, prompts, outputs) -> List[float]``
- ``metric_fn(samples, prompts, outputs) -> Dict[str, List[float]]``

Training runs on the GPU unless the caller passes ``device="cpu"``.
"""

import importlib
import warnings
from typing import Any, Callable, Dict, List, Optional

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.utils import set_seed

__all__ = ["train"]


def train(
    model_path: Optional[str] = None,
    reward_fn: Optional[Callable[[List[str], List[str], List[str]], List[float]]] = None,
    prompts: Optional[List[str]] = None,
    eval_prompts: Optional[List[str]] = None,
    metric_fn: Optional[Callable[[List[str], List[str], List[str]], Dict[str, List[float]]]] = None,
    config: Optional[TRLConfig] = None,
    stop_sequences: Optional[List[str]] = None,
    init_trainer_hook: Optional[Callable] = None,
    device: Any = None,
):
    """Online RL from a ``reward_fn``: build the trainer, the prompt
    pipeline, collect the first rollouts and ``learn()``. Returns the
    trainer. ``init_trainer_hook(trainer)`` runs before any rollout (e.g. to
    transplant warm-start weights into the policy and its reference).
    Offline training (ILQL, SFT from ``samples``) is not ported yet."""
    for module in ("trlx_tpu_torch.pipeline.offline_pipeline", "trlx_tpu_torch.trainer.ppo"):
        importlib.import_module(module)
    from trlx_tpu_torch.pipeline import get_pipeline
    from trlx_tpu_torch.trainer import get_trainer

    if reward_fn is None:
        raise ValueError(
            "the port trains online PPO from a reward_fn; offline training from "
            "samples (ILQL, SFT) is not ported yet"
        )
    if config is None:
        warnings.warn(
            "Passing the `config` argument implicitly is deprecated; adapt one "
            "from `trlx_tpu_torch/data/default_configs.py` instead"
        )
        config = default_ppo_config()
    set_seed(config.train.seed)
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
    prompts = prompts or [trainer.tokenizer.bos_token] * batch_size
    if eval_prompts is None:
        eval_prompts = prompts[:batch_size]
    pipeline = get_pipeline(config.train.pipeline)(prompts, max_prompt_length, trainer.tokenizer)
    trainer.add_prompt_pipeline(pipeline)
    trainer.make_experience(config.method.num_rollouts)
    eval_pipeline = get_pipeline(config.train.pipeline)(
        eval_prompts, max_prompt_length, trainer.tokenizer)
    trainer.add_eval_pipeline(eval_pipeline)
    trainer.learn()
    return trainer
