"""One rank of the several-process RL and preference runs of
``tests/test_torch_parallel_rl.py`` and ``tests/test_torch_elastic.py``.

``python tests/torch_parallel_rl_worker.py <kind> <config.json> <params.npz> <out.json>``
runs ``trlx_tpu_torch.train`` on the CPU for ``kind`` (ppo, grpo, ilql or
dpo) with the JSON config dict and the data of :func:`train_kwargs`, the
weights of ``params.npz`` (a JAX parameter tree flattened with ``/`` keys)
loaded before training (and the PPO / GRPO reference rebuilt from them).
The world comes from the environment
(``trlx_tpu_torch.trlx.initialize_runtime``); a run with
``train.resume_from_checkpoint`` resumes from ``train.checkpoint_dir``
after the load, so its policy is the checkpoint's and its reference the
weights'. A run that a fault plan preempts records
the exception and the emergency checkpoint's path. Rank 0 writes
``out.json`` (every step's scalar stats) and ``out.json.npz`` (the final
full state dict); every rank writes ``out.json.rank<r>`` with digests of
its rollout store and its full weights. With ``TRLX_TEST_PUSH_DIR`` set
the run ends with ``push_to_hub`` through an uploader that copies the
staged export to ``<dir>/rank<r>``. Imports torch and the port only.
"""

import hashlib
import json
import os
import shutil
import sys
import zlib

import numpy as np
import torch

from trlx_tpu_torch import trlx
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.observability.tracing import process_index
from trlx_tpu_torch.parallel.sharding import full_model_state, load_full_model_state
from trlx_tpu_torch.resilience import TrainingPreempted


def _words(rs, lo, hi):
    return "".join(chr(c) for c in rs.randint(97, 123, size=rs.randint(lo, hi)))


def prompts(n=48, seed=0):
    rs = np.random.RandomState(seed)
    return [_words(rs, 3, 17) for _ in range(n)]


def vowel_reward(samples, prompts, outputs):
    return [sum(ch in "aeiou" for ch in o) / max(len(o), 1) for o in outputs]


def group_reward(samples, prompts, outputs):
    """Greedy group members are identical, so a text reward gives a group
    no advantages: this one scores a row by its prompt and its occurrence
    among the call's rows of that prompt (its member index), the same
    whether the call holds every group or one rank's whole groups."""
    seen, out = {}, []
    for p in prompts:
        k = seen.get(p, 0)
        seen[p] = k + 1
        out.append((zlib.crc32(f"{p}|{k}".encode()) % 1000) / 1000.0 - 0.5)
    return out


def ilql_samples(n=16, seed=0):
    rs = np.random.RandomState(seed)
    samples = [[_words(rs, 2, 9), _words(rs, 3, 16)] for _ in range(n)]
    return samples, list(rs.rand(n) * 2 - 0.5)


def dpo_triples(n=16, seed=0):
    rs = np.random.RandomState(seed)
    return [(_words(rs, 2, 12), " " + _words(rs, 1, 20), " " + _words(rs, 1, 20))
            for _ in range(n)]


def train_kwargs(kind):
    """The data and reward of a run of ``kind``, the same on every side."""
    if kind == "ppo":
        return dict(reward_fn=vowel_reward, prompts=prompts(), eval_prompts=["ab", "cde"])
    if kind == "grpo":
        return dict(reward_fn=group_reward, prompts=prompts(), eval_prompts=["ab", "cde"])
    if kind == "ilql":
        samples, rewards = ilql_samples()
        return dict(samples=samples, rewards=rewards, eval_prompts=["ab", "cde"])
    return dict(samples=dpo_triples(), eval_prompts=["ab", "cde"])


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
    sd = params_from_jax(unflatten(dict(np.load(params_path))), trainer.tcfg)
    if trainer.mesh is None:
        trainer.model.load_state_dict(sd)
    else:  # each rank's model share and FSDP2 shard
        load_full_model_state(trainer.model, sd)
    if hasattr(trainer, "ref_params"):
        trainer.ref_params = trainer._ref_snapshot()


def _digest(arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


def store_digest(trainer):
    store = getattr(trainer, "store", None)
    history = getattr(store, "history", None)
    if not history:
        return None
    rows = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif hasattr(x, "__dict__"):
            walk(vars(x))
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif x is not None:
            rows.append(x)

    walk(history)
    return _digest(rows)


def main(kind, config_path, params_path, out_path):
    torch.set_num_threads(1)
    with open(config_path) as f:
        config = TRLConfig.from_dict(json.load(f))
    seen = {}

    def keep(trainer):
        # before a resume too: its load then replaces the policy's weights,
        # and the reference keeps the run's initial ones
        seen["trainer"] = trainer
        load_weights(trainer, params_path)

    preempted = None
    try:
        trainer = trlx.train(config=config, device="cpu", init_trainer_hook=keep,
                             **train_kwargs(kind))
    except TrainingPreempted as e:
        trainer, preempted = seen["trainer"], e.checkpoint_dir
    push_dir = os.environ.get("TRLX_TEST_PUSH_DIR")
    if push_dir:  # push_to_hub with the hub stubbed: each uploading rank keeps its files
        def upload(repo_id, staged):
            mine = os.path.join(push_dir, f"rank{process_index()}")
            shutil.copytree(staged, os.path.join(mine, "files"))
            with open(os.path.join(mine, "url.json"), "w") as f:
                json.dump({"repo_id": repo_id, "rank": process_index()}, f)
            return mine

        trainer.push_to_hub("org/ppo-mesh", uploader=upload)
    full = full_model_state(trainer.model)
    rank = process_index()
    with open(f"{out_path}.rank{rank}", "w") as f:
        json.dump({"store": store_digest(trainer),
                   "weights": _digest(full[k].float().numpy() for k in sorted(full)),
                   "preempted": preempted, "iter_count": trainer.iter_count}, f)
    if rank == 0:
        steps = [(s, st) for s, st in trainer.tracker.history if "gradients/global_norm" in st]
        with open(out_path, "w") as f:
            json.dump({"steps": [s for s, _ in steps],
                       "stats": [{k: float(v) for k, v in st.items()
                                  if isinstance(v, (int, float))} for _, st in steps],
                       "world": int(os.environ.get("TRLX_TPU_NUM_PROCESSES", "1")),
                       "preempted": preempted,
                       "metrics": {k: float(v) for k, v in trainer.metrics.snapshot().items()
                                   if k.startswith("resilience/")}}, f)
        np.savez(out_path + ".npz", **{k: v.float().numpy() for k, v in full.items()})


if __name__ == "__main__":
    main(*sys.argv[1:5])
