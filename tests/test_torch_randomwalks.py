"""The port's randomwalks acceptance runs (``trlx_tpu_torch/tasks/``),
on the CPU.

- the task generator equals ``examples/randomwalks/randomwalks.py`` (the
  same graph, walks, rewards and scores for a seed);
- ``ppo_randomwalks.main`` (SFT warm start, then PPO on the example's
  preset as it stands: serial, pipelined, the staged loss) and
  ``ilql_randomwalks.main`` run end to end through
  ``trlx_tpu_torch.train`` at 2 steps, as ``tests/test_examples.py``'s
  smoke tests run the JAX examples;
- slow-marked: the learning curves of ``tests/test_examples.py::
  test_ppo_randomwalks_learns`` and ``::test_ilql_randomwalks_learns`` at
  their settings, read from ``trainer.tracker.history``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from trlx_tpu_torch.tasks import ilql_randomwalks, ppo_randomwalks
from trlx_tpu_torch.tasks.randomwalks import generate_random_walks

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples", "randomwalks")


@pytest.mark.parametrize("kwargs", [dict(seed=1002), dict(n_nodes=12, n_walks=50, seed=3)])
def test_task_matches_the_example(kwargs):
    sys.path.insert(0, os.path.abspath(EXAMPLE))
    try:
        from randomwalks import generate_random_walks as example_generate
    finally:
        sys.path.remove(os.path.abspath(EXAMPLE))
    ours, theirs = generate_random_walks(**kwargs), example_generate(**kwargs)
    for a, b in zip(ours[2:], theirs[2:]):  # prompts, walks, rewards, alphabet
        assert a == b
    probes = ours[3][:40] + ["ab", "a", "", ours[5][::-1]]
    assert ours[0](probes) == theirs[0](probes)  # metric_fn
    assert ours[1](probes) == theirs[1](probes)  # reward_fn


def _optimality(trainer):
    return [st["metrics/optimality"] for _, st in trainer.tracker.history
            if "metrics/optimality" in st]


def test_ppo_randomwalks_smoke(tmp_path):
    trainer = ppo_randomwalks.main(
        {
            "train.total_steps": 2,
            "train.epochs": 1,
            "train.eval_interval": 2,
            "train.batch_size": 16,
            "train.checkpoint_dir": str(tmp_path / "ckpt"),
            "method.num_rollouts": 16,
            "method.chunk_size": 16,
            "method.ppo_epochs": 1,
        },
        device="cpu",
    )
    assert trainer.iter_count >= 1
    assert len(_optimality(trainer)) >= 2
    # the example's preset as it stands: serial dense rollouts pipelined at
    # depth 2, the staged loss
    train, method = trainer.config.train, trainer.config.method
    assert not train.continuous_batching and train.rollout_pipeline_depth == 2
    assert method.loss_kernel == "xla"
    collections = [st for _, st in trainer.tracker.history if "time/exp" in st]
    assert collections and all("throughput/rollout_overlap_frac" in st for st in collections)
    # the warm start (the SFT run's final checkpoint) is the frozen
    # reference, and the policy's start: two steps at lr 3e-4 stay near it
    (saved,) = (tmp_path / "ckpt" / "sft_warmstart").glob("checkpoint_*/state.pt")
    warm = torch.load(saved)["model"]
    ref = trainer.ref_params.state_dict()
    assert set(ref) == set(warm)
    for k, v in warm.items():
        assert torch.equal(ref[k], v), k
        drift = (trainer.model.backbone.state_dict()[k] - v).abs().max()
        assert drift < 5e-3, (k, float(drift))


def test_ilql_randomwalks_smoke(tmp_path):
    trainer = ilql_randomwalks.main(
        {
            "train.total_steps": 2,
            "train.epochs": 1,
            "train.eval_interval": 2,
            "train.batch_size": 16,
            "train.checkpoint_dir": str(tmp_path / "ckpt"),
        },
        device="cpu",
    )
    assert trainer.iter_count >= 1
    curve = _optimality(trainer)
    assert len(curve) >= 2 and all(0.0 <= x <= 1.0 for x in curve)


@pytest.mark.slow
def test_ppo_randomwalks_learns(tmp_path):
    """PPO must optimise the reward, not merely run: the mean optimality of
    the last three evals beats the first two by more than 0.15 (the JAX
    slow test's settings and bound)."""
    trainer = ppo_randomwalks.main(
        {
            "train.total_steps": 24,
            "train.epochs": 100,
            "train.eval_interval": 4,
            "train.batch_size": 32,
            "train.checkpoint_dir": str(tmp_path / "ckpt"),
            "method.num_rollouts": 32,
            "method.chunk_size": 32,
            "method.ppo_epochs": 4,
        },
        device="cpu",
    )
    curve = _optimality(trainer)
    assert len(curve) >= 5, curve
    first, last = np.mean(curve[:2]), np.mean(curve[-3:])
    assert last > first + 0.15, f"PPO did not learn: optimality curve {curve}"


@pytest.mark.slow
def test_ilql_randomwalks_learns(tmp_path):
    """Offline ILQL lifts the mean optimality of the last three evals above
    the first two by more than 0.1 (the JAX slow test's settings and
    bound)."""
    trainer = ilql_randomwalks.main(
        {
            "train.total_steps": 160,
            "train.epochs": 100,
            "train.eval_interval": 20,
            "train.batch_size": 32,
            "train.checkpoint_dir": str(tmp_path / "ckpt"),
            "method.gen_kwargs.temperature": 0.05,
        },
        device="cpu",
    )
    curve = _optimality(trainer)
    assert len(curve) >= 6, curve
    first, last = np.mean(curve[:2]), np.mean(curve[-3:])
    assert last > first + 0.1, f"ILQL did not learn: optimality curve {curve}"
