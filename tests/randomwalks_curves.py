"""The randomwalks learning curves of the JAX examples and of the port's
drivers, side by side, on the CPU.

One run a call; it prints one JSON line with the optimality curve (one
value per evaluation) and the wall seconds::

    python tests/randomwalks_curves.py jax ilql '{"train.total_steps": 160}'
    python tests/randomwalks_curves.py port ppo '{"method.chunk_size": 64}'

``jax`` runs ``examples/randomwalks/{ppo,ilql}_randomwalks.py`` on the CPU
(one device); ``port`` runs ``trlx_tpu_torch/tasks/{ppo,ilql}_randomwalks.py``
with ``device="cpu"``. The third argument holds dot-path overrides; the
checkpoints (and the JAX side's stats log) go to a temporary directory.
"""

import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_curve(task, hparams, tmp):
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.join(REPO, "examples", "randomwalks"))
    module = __import__(f"{task}_randomwalks")
    logs = os.path.join(tmp, "logs")
    module.main({**hparams, "train.checkpoint_dir": os.path.join(tmp, "ckpt"),
                 "train.logging_dir": logs, "train.tracker": "jsonl"})
    curve = []
    with open(os.path.join(logs, "stats.jsonl")) as f:
        for line in f:
            record = json.loads(line)
            if "metrics/optimality" in record:
                curve.append(float(record["metrics/optimality"]))
    return curve


def port_curve(task, hparams, tmp):
    import importlib

    module = importlib.import_module(f"trlx_tpu_torch.tasks.{task}_randomwalks")
    trainer = module.main({**hparams, "train.checkpoint_dir": os.path.join(tmp, "ckpt")},
                          device="cpu")
    return [st["metrics/optimality"] for _, st in trainer.tracker.history
            if "metrics/optimality" in st]


def main(side, task, hparams):
    sys.path.insert(0, REPO)
    tmp = tempfile.mkdtemp(prefix="randomwalks_curves_")
    t0 = time.perf_counter()
    try:
        curve = (jax_curve if side == "jax" else port_curve)(task, hparams, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"side": side, "task": task, "hparams": hparams,
                      "optimality_curve": curve, "last_three_mean": sum(curve[-3:]) / 3,
                      "wall_s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], json.loads(sys.argv[3]) if len(sys.argv) > 3 else {})
