"""Public API of the port: ``train()`` for online RL, offline RL,
supervised fine-tuning and preference learning.

Port of ``trlx_tpu/trlx.py::train``: a ``reward_fn`` selects online RL
(PPO, or GRPO with ``config.train.trainer: GRPOTrainer``),
``samples`` with ``rewards`` offline ILQL, ``samples`` alone SFT, or
with ``config.train.trainer: DPOTrainer`` DPO on ``(prompt, chosen,
rejected)`` triples (``default_dpo_config()``). The user
callback contracts are the JAX package's:

- ``reward_fn(samples, prompts, outputs) -> List[float]``
- ``metric_fn(samples, prompts, outputs) -> Dict[str, List[float]]``

Training runs on the GPU unless the caller passes ``device="cpu"``.
Several processes (:func:`initialize_runtime`) form one
``torch.distributed`` world: every process runs ``train()`` with the
same arguments and drives one device, and every trainer builds its mesh
from ``config.parallel`` (``data`` / ``fsdp`` for all of them,
``sequence`` for SFT).
"""

import importlib
import os
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import (
    default_ilql_config,
    default_ppo_config,
    default_sft_config,
)
from trlx_tpu_torch.utils import set_seed

__all__ = ["initialize_runtime", "train"]


def initialize_runtime(device: Any = None):
    """Process-level runtime set-up from environment variables (the JAX
    ``initialize_runtime``); returns the device this process drives.

    Idempotent (a second call finds the group initialized). The world
    comes from JAX's variables (``TRLX_TPU_COORDINATOR=host:port``,
    ``TRLX_TPU_NUM_PROCESSES``, ``TRLX_TPU_PROCESS_ID``) or torchrun's
    (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``). With more than one process it calls
    ``torch.distributed.init_process_group``: ``gloo`` when the caller
    asked for the CPU, else ``nccl`` with this rank's device
    ``cuda:LOCAL_RANK`` (the process id modulo the host's card count
    when ``LOCAL_RANK`` is unset: one process per card on every host).
    With one process, or a group already initialized by the caller, it
    starts nothing and the device is the caller's."""
    import torch
    import torch.distributed as dist

    coordinator = os.environ.get("TRLX_TPU_COORDINATOR")
    if coordinator:
        world = int(os.environ.get("TRLX_TPU_NUM_PROCESSES", "1"))
        rank = int(os.environ.get("TRLX_TPU_PROCESS_ID", "0"))
        init_method = f"tcp://{coordinator}"
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
        init_method = "env://"
    cpu = device is not None and torch.device(device).type == "cpu"
    if world > 1 and not cpu:
        local_rank = os.environ.get("LOCAL_RANK")
        if local_rank is None:
            if not torch.cuda.is_available():
                raise RuntimeError("several processes on the GPU need a CUDA device; pass "
                                   "device='cpu' to run them over gloo")
            local_rank = rank % torch.cuda.device_count()
        device = torch.device("cuda", int(local_rank))
    if world == 1 or dist.is_initialized():
        return device
    if cpu:
        dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank)
    else:
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=init_method, world_size=world, rank=rank,
                                device_id=device)
    return device


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
    device = initialize_runtime(device)
    for module in ("trlx_tpu_torch.pipeline.offline_pipeline", "trlx_tpu_torch.trainer.ppo",
                   "trlx_tpu_torch.trainer.grpo", "trlx_tpu_torch.trainer.ilql",
                   "trlx_tpu_torch.trainer.sft", "trlx_tpu_torch.trainer.dpo"):
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
        # restore before collecting: the first rollouts must come from the
        # restored policy, seed stream and prompt stream
        trainer.maybe_resume()
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
