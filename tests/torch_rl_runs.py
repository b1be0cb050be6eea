"""Shared runs of ``tests/test_torch_parallel_rl.py`` and
``tests/test_torch_elastic.py``: the cut configs of PPO, GRPO, ILQL and
DPO, JAX's ``train()`` on the virtual mesh, and the port's ``train()`` on
``world`` gloo processes (``tests/torch_parallel_rl_worker.py``, started
through the environment ``trlx_tpu_torch.trlx.initialize_runtime`` reads).
"""

import copy
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER_LIMIT_S = 240
# the JAX runs' mesh on the 8 virtual devices: both data axes
JAX_MESH = dict(data=2, fsdp=4, model=1, sequence=1)


def config_dict(kind, ckpt, **parallel):
    """``kind``'s preset cut in model (``builtin:gpt2-test``, f32),
    lengths and steps, greedy, with ``parallel`` on top of one device's
    axes. PPO and GRPO: two collections of 16 rollouts (GRPO: 4 prompts x
    4), batch 8, 2 epochs, 6 steps; ILQL and DPO: batch 8, 4 steps."""
    from trlx_tpu.data.default_configs import (
        default_dpo_config,
        default_grpo_config,
        default_ilql_config,
        default_ppo_config,
    )

    preset = {"ppo": default_ppo_config, "grpo": default_grpo_config,
              "ilql": default_ilql_config, "dpo": default_dpo_config}[kind]
    d = preset().to_dict()
    d["model"].update(model_path="builtin:gpt2-test")
    d["parallel"].update(compute_dtype="float32", data=-1, fsdp=1, model=1, sequence=1)
    d["parallel"].update(parallel)
    d["tokenizer"].update(tokenizer_path="builtin:bytes")
    d["train"].update(batch_size=8, epochs=100, save_best=False, checkpoint_interval=1000,
                      eval_interval=1000, checkpoint_dir=str(ckpt), tracker=None)
    d["optimizer"]["kwargs"].update(lr=1e-3)
    if kind in ("ppo", "grpo"):
        d["train"].update(seq_length=24, total_steps=6)
        d["method"].update(num_rollouts=16, chunk_size=16, ppo_epochs=2)
        d["method"]["gen_kwargs"].update(max_new_tokens=8, do_sample=False)
        if kind == "ppo":
            d["model"].update(num_layers_unfrozen=1)
        else:
            d["method"].update(group_size=4)
    elif kind == "ilql":
        d["train"].update(seq_length=20, total_steps=4)
        d["method"].update(alpha=0.1, beta=0.5, steps_for_target_q_sync=2,
                           gen_kwargs=dict(max_new_tokens=4, beta=1.0, do_sample=False))
    else:
        d["train"].update(seq_length=32, total_steps=4)
        d["scheduler"]["kwargs"].update(lr=1e-3, eta_min=1e-3)
        d["method"]["gen_kwargs"].update(max_new_tokens=4, do_sample=False)
    return d


def flat(params):
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v) for kp, v in leaves}


class Recorder:
    def __init__(self):
        self.history = []

    def log(self, stats, step):
        self.history.append((int(step), dict(stats)))

    def finish(self):
        pass


def jax_run(kind, root, **overrides):
    """JAX's ``train()`` of ``kind`` on :data:`JAX_MESH`: its initial
    weights (``params0.npz``), every step's stats and its final weights.
    ``overrides`` update config sections."""
    import trlx_tpu.trlx as jax_trlx
    from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
    from torch_parallel_rl_worker import train_kwargs

    d = with_sections(config_dict(kind, root / "ckpt", **JAX_MESH), **overrides)
    seen = {}

    def hook(trainer):
        assert dict(trainer.mesh.shape)["data"] == 2 and dict(trainer.mesh.shape)["fsdp"] == 4
        seen["params0"] = flat(trainer.state.params)
        trainer.tracker = Recorder()

    os.environ["TRLX_TPU_MFU"] = "0"  # no background MFU compile beside the run
    try:
        trainer = jax_trlx.train(config=JaxTRLConfig.from_dict(d), init_trainer_hook=hook,
                                 **train_kwargs(kind))
    finally:
        os.environ.pop("TRLX_TPU_MFU", None)
    params0 = root / "params0.npz"
    np.savez(params0, **seen["params0"])
    steps = [(s, st) for s, st in trainer.tracker.history if "gradients/global_norm" in st]
    return {"params0": str(params0), "steps": [s for s, _ in steps],
            "stats": [{k: float(v) for k, v in st.items() if np.ndim(v) == 0}
                      for _, st in steps],
            "params": flat(trainer.state.params)}


def run_world(kind, root, d, params0, world, env=None):
    """The worker of ``kind`` on ``world`` gloo ranks; rank 0's result,
    with every rank's digests under ``ranks``."""
    root.mkdir(parents=True, exist_ok=True)
    cfg, out = root / "config.json", root / "out.json"
    cfg.write_text(json.dumps(d))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = {**os.environ, "OMP_NUM_THREADS": "1", "TRLX_TPU_NUM_PROCESSES": str(world),
            "TRLX_TPU_COORDINATOR": f"127.0.0.1:{port}",
            "PYTHONPATH": os.pathsep.join([os.path.dirname(HERE), HERE,
                                           os.environ.get("PYTHONPATH", "")]),
            **(env or {})}
    base.pop("XLA_FLAGS", None)
    logs = [open(root / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_parallel_rl_worker.py"), kind, str(cfg),
         str(params0), str(out)], env={**base, "TRLX_TPU_PROCESS_ID": str(r)},
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=WORKER_LIMIT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (root / f"rank{r}.log").read_text()[-3000:]
    result = json.loads(out.read_text())
    result["params"] = dict(np.load(str(out) + ".npz"))
    result["ranks"] = [json.loads((root / f"out.json.rank{r}").read_text())
                       for r in range(world)]
    return result


def with_sections(d, **sections):
    """A copy of config dict ``d`` with each section updated by
    ``sections``' values, a dict value merged into the section's dict."""
    d = copy.deepcopy(d)
    for section, values in sections.items():
        for key, value in values.items():
            if isinstance(value, dict) and isinstance(d[section].get(key), dict):
                d[section][key] = {**d[section][key], **value}
            else:
                d[section][key] = value
    return d


def check_steps(got, want, steps, keys, rtol=1e-5, atol=1e-6):
    """Every step's ``keys`` (each present on both sides) at ``rtol``,
    with an absolute floor for stats that vanish in exact arithmetic (a
    collection's first policy loss is f32 rounding noise on both
    sides)."""
    assert got["steps"] == steps, (got["steps"], steps)
    by_step = dict(zip(want["steps"], want["stats"]))
    for s, st in zip(got["steps"], got["stats"]):
        for k in keys:
            np.testing.assert_allclose(st[k], by_step[s][k], rtol=rtol, atol=atol,
                                       err_msg=f"step {s} {k}")


# a key bias's exact gradient is zero (the softmax ignores a per-query
# constant), so its every element takes Adam steps of f32 rounding noise,
# of either sign and up to lr each, on both sides
NOISE_ONLY = ".attn.k_proj.bias"


def check_params(got, want_flat, kind, rtol=1e-5, lr=1e-3, steps=6):
    """The port's final state dict against JAX's final tree, relative in
    each tensor's 2-norm; the key biases (:data:`NOISE_ONLY`) within the
    Adam steps' bound, ``lr`` per step."""
    import torch

    from trlx_tpu_torch.models.builder import resolve_transformer_config
    from trlx_tpu_torch.models.weights import params_from_jax
    from torch_parallel_rl_worker import unflatten

    cfg = resolve_transformer_config("builtin:gpt2-test", param_dtype=torch.float32)
    want = params_from_jax(unflatten(want_flat), cfg)
    assert sorted(got) == sorted(want), kind
    gaps = {k: float(np.linalg.norm(got[k] - w.numpy()) / max(np.linalg.norm(w.numpy()), 1e-30))
            for k, w in want.items() if not k.endswith(NOISE_ONLY)}
    bad = {k: g for k, g in gaps.items() if g > rtol}
    assert not bad, bad
    for k, w in want.items():
        if k.endswith(NOISE_ONLY):
            assert np.abs(got[k] - w.numpy()).max() <= 2 * lr * steps, k
