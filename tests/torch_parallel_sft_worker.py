"""One rank of the several-process SFT runs of ``tests/test_torch_parallel_sft.py``.

``python tests/torch_parallel_sft_worker.py <config.json> <params.npz> <out.json>``
runs ``trlx_tpu_torch.train`` on the CPU with the JSON config dict, the
weights of ``params.npz`` (a JAX parameter tree flattened with ``/`` keys)
loaded before training, and the synthetic documents of
``tasks/long_context_sft.py``. The world comes from the environment
(``trlx_tpu_torch.trlx.initialize_runtime``); a run with
``train.resume_from_checkpoint`` resumes from ``train.checkpoint_dir``
instead of loading the weights. Rank 0 writes ``out.json`` (the step
losses and gradient norms) and ``out.json.npz`` (the final weights, the
full state dict). Imports torch and the port only.
"""

import json
import os
import sys

import numpy as np
import torch

from trlx_tpu_torch import trlx
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.observability.tracing import process_index
from trlx_tpu_torch.tasks.long_context_sft import synthetic_documents

DOCS = 12  # the documents and the eval prompts of the parity runs
DOC_CHARS = 90


def unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = value
    return tree


def load_weights(trainer, params_path):
    from trlx_tpu_torch.parallel.sharding import load_full_model_state

    sd = params_from_jax(unflatten(dict(np.load(params_path))), trainer.tcfg)
    if trainer.mesh is None:
        trainer.model.load_state_dict(sd)
    else:  # each rank's model share and FSDP2 shard
        load_full_model_state(trainer.model, sd)


def main(config_path, params_path, out_path):
    torch.set_num_threads(1)
    with open(config_path) as f:
        config = TRLConfig.from_dict(json.load(f))
    docs = synthetic_documents(DOCS, target_chars=DOC_CHARS)
    hook = None
    if not config.train.resume_from_checkpoint:
        hook = lambda trainer: load_weights(trainer, params_path)  # noqa: E731
    trainer = trlx.train(samples=docs, eval_prompts=[d[: d.index(".") + 1] for d in docs[:2]],
                         config=config, device="cpu", init_trainer_hook=hook)
    model_sd = trainer._full_state()[0]
    if process_index() == 0:
        steps = [(s, st) for s, st in trainer.tracker.history if "gradients/global_norm" in st]
        with open(out_path, "w") as f:
            json.dump({"steps": [s for s, _ in steps],
                       "loss": [st["losses/loss"] for _, st in steps],
                       "grad_norm": [st["gradients/global_norm"] for _, st in steps],
                       "world": int(os.environ.get("TRLX_TPU_NUM_PROCESSES", "1"))}, f)
        np.savez(out_path + ".npz", **{k: v.float().numpy() for k, v in model_sd.items()})


if __name__ == "__main__":
    main(*sys.argv[1:4])
