"""SFT over several processes: the port's ``train()`` on two ``gloo`` ranks
(``tests/torch_parallel_sft_worker.py``, started as
``tests/test_multihost.py::_run_two_process`` starts its workers, through
the environment that ``trlx_tpu_torch.trlx.initialize_runtime`` reads)
against JAX's ``train()`` on the virtual 8-device mesh.

JAX runs ``attention_impl: pallas`` on a (data 2, fsdp 2, sequence 2)
mesh, so its ring attention and its fsdp sharding both run; the result
does not depend on the mesh, so that one run is the oracle of every case:

- ``sequence`` 2: each rank holds a zigzag shard of every row and K/V
  rotate between the two processes (the ring's process-group transport);
- ``fsdp`` 2: each rank holds its rows and half of every weight (FSDP2);
- the ``fsdp`` run's checkpoint of update 1 (written by rank 0 from the
  gathered state) resumed in one process, which takes update 2.

Llama-test cut to 2 layers, f32, ``seq_length`` 64, the documents of
``tasks/long_context_sft.py``, the JAX run's initial weights carried over
(``params_from_jax``). Step losses and gradient norms agree to 1e-5
relative; final weights to 1e-5 relative in each tensor's 2-norm.
"""

import copy
import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

import trlx_tpu.trlx as jax_trlx
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.data.default_configs import default_sft_config as jax_default_sft_config

from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

HERE = os.path.dirname(os.path.abspath(__file__))
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5
STEPS = 2
WORKER_LIMIT_S = 240


def _config_dict(ckpt, **parallel):
    d = jax_default_sft_config().to_dict()
    d["model"].update(model_path="builtin:llama-test",
                      model_extra_kwargs=dict(num_layers=2, attention_impl="pallas",
                                              max_position_embeddings=64))
    d["parallel"].update(compute_dtype="float32", data=-1, fsdp=1, model=1, sequence=1)
    d["parallel"].update(parallel)
    d["tokenizer"].update(tokenizer_path="builtin:bytes")
    d["train"].update(seq_length=64, batch_size=4, total_steps=STEPS, epochs=10,
                      save_best=False, checkpoint_interval=1, eval_interval=1000,
                      checkpoint_dir=str(ckpt), tracker=None)
    d["method"].update(gen_kwargs=dict(max_new_tokens=4, do_sample=False))
    d["optimizer"]["kwargs"].update(lr=1e-3)
    return d


def _flat(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v) for kp, v in flat}


class _Recorder:
    def __init__(self):
        self.history = []

    def log(self, stats, step):
        self.history.append((int(step), dict(stats)))

    def finish(self):
        pass


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's ``train()`` on the (data 2, fsdp 2, sequence 2) virtual mesh:
    its initial weights (``params0.npz``), step losses and final weights."""
    from torch_parallel_sft_worker import DOC_CHARS, DOCS
    from trlx_tpu_torch.tasks.long_context_sft import synthetic_documents

    root = tmp_path_factory.mktemp("jax_parallel_sft")
    os.environ["TRLX_TPU_MFU"] = "0"  # no background MFU compile beside the run
    try:
        config = JaxTRLConfig.from_dict(_config_dict(root / "ckpt", fsdp=2, sequence=2))
        seen = {}

        def hook(trainer):
            assert dict(trainer.mesh.shape) == {"data": 2, "pipe": 1, "fsdp": 2, "model": 1,
                                                "sequence": 2, "expert": 1}
            seen["params0"] = _flat(trainer.state.params)
            trainer.tracker = _Recorder()

        docs = synthetic_documents(DOCS, target_chars=DOC_CHARS)
        trainer = jax_trlx.train(samples=docs, eval_prompts=[d[: d.index(".") + 1]
                                                             for d in docs[:2]],
                                 config=config, init_trainer_hook=hook)
    finally:
        os.environ.pop("TRLX_TPU_MFU", None)
    params0 = root / "params0.npz"
    np.savez(params0, **seen["params0"])
    steps = [(s, st) for s, st in trainer.tracker.history if "gradients/global_norm" in st]
    return {"params0": str(params0), "steps": [s for s, _ in steps],
            "loss": [float(st["losses/loss"]) for _, st in steps],
            "grad_norm": [float(st["gradients/global_norm"]) for _, st in steps],
            "params": _flat(trainer.state.params)}


def _run_world(root, d, params0, world):
    """Run the worker on ``world`` gloo ranks; rank 0's result."""
    root.mkdir(parents=True, exist_ok=True)
    cfg, out = root / "config.json", root / "out.json"
    cfg.write_text(json.dumps(d))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "TRLX_TPU_NUM_PROCESSES": str(world),
           "TRLX_TPU_COORDINATOR": f"127.0.0.1:{port}",
           "PYTHONPATH": os.pathsep.join([os.path.dirname(HERE), HERE,
                                          os.environ.get("PYTHONPATH", "")])}
    env.pop("XLA_FLAGS", None)
    logs = [open(root / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_parallel_sft_worker.py"), str(cfg),
         str(params0), str(out)], env={**env, "TRLX_TPU_PROCESS_ID": str(r)},
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
    return result


def _check_params(got, want_tree, tcfg_spec="builtin:llama-test"):
    """The port's final state dict against JAX's final tree."""
    import torch

    from trlx_tpu_torch.models.builder import resolve_transformer_config
    from trlx_tpu_torch.models.weights import params_from_jax

    cfg = resolve_transformer_config(tcfg_spec, num_layers=2, param_dtype=torch.float32)
    tree = {}
    for key, value in want_tree.items():
        node = tree
        *path, leaf = key.split("/")
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = value
    want = params_from_jax(tree, cfg)
    assert sorted(got) == sorted(want)
    # relative in the 2-norm of each tensor: an element whose gradient is
    # f32 rounding noise takes an Adam step of either sign (up to lr), so
    # single elements may differ by ~1e-6 at lr 1e-3
    gaps = {k: float(np.linalg.norm(got[k] - w.numpy()) / np.linalg.norm(w.numpy()))
            for k, w in want.items()}
    bad = {k: g for k, g in gaps.items() if g > PARAM_RTOL}
    assert not bad, bad


def _check_losses(got, want, steps):
    """Step losses and gradient norms (before clipping): Adam's first steps
    hardly depend on the gradient's scale, the norm does."""
    assert got["steps"] == steps
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], [want[key][s - 1] for s in steps],
                                   rtol=LOSS_RTOL, err_msg=key)


def test_sequence_parallel_sft_matches_jax(tmp_path, jax_run):
    got = _run_world(tmp_path / "seq", _config_dict(tmp_path / "ckpt", sequence=2),
                     jax_run["params0"], world=2)
    assert got["world"] == 2 and jax_run["steps"] == list(range(1, STEPS + 1))
    _check_losses(got, jax_run, jax_run["steps"])
    _check_params(got["params"], jax_run["params"])


def test_tensor_parallel_sft_matches_jax(tmp_path, jax_run):
    """``model`` 2: the rank's query heads (llama-test's 4 over 2 KV
    heads) and ffn share; the 259-token vocabulary replicates."""
    got = _run_world(tmp_path / "model", _config_dict(tmp_path / "ckpt", model=2),
                     jax_run["params0"], world=2)
    assert got["world"] == 2
    _check_losses(got, jax_run, jax_run["steps"])
    _check_params(got["params"], jax_run["params"])


def test_fsdp_sft_matches_jax_and_resumes_at_world_one(tmp_path, jax_run):
    ckpt = tmp_path / "ckpt"
    got = _run_world(tmp_path / "fsdp", _config_dict(ckpt, fsdp=2), jax_run["params0"],
                     world=2)
    _check_losses(got, jax_run, jax_run["steps"])
    _check_params(got["params"], jax_run["params"])

    # update 1's checkpoint, written from the gathered state, resumed alone
    resume_dir = tmp_path / "resume_ckpt"
    shutil.copytree(ckpt / "checkpoint_1", resume_dir / "checkpoint_1")
    d = _config_dict(resume_dir)
    d["train"]["resume_from_checkpoint"] = True
    resumed = _run_world(tmp_path / "resume", copy.deepcopy(d), jax_run["params0"], world=1)
    assert resumed["world"] == 1
    _check_losses(resumed, jax_run, [STEPS])
    _check_params(resumed["params"], jax_run["params"])
