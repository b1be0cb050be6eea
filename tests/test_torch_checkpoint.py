"""Checkpoint load and resume of the port (``trlx_tpu_torch/utils/
checkpoint.py`` and ``TorchBaseTrainer.save`` / ``load`` /
``maybe_resume``), on the CPU.

- the commit protocol: a save stages its file, writes the marker and
  renames; a directory is committed only with both the marker and
  ``state.pt``, so a crash mid-save leaves the previous checkpoint loadable
  or a directory that resume skips; checkpoint directories sort by step as
  in the JAX package;
- a PPO run on ``default_ppo_config()`` (cut in model, lengths and steps,
  sampled rollouts, the preset's pipeline depth 2 and prefetch 2) resumed
  from its mid-run checkpoint in a fresh ``trlx_tpu_torch.train`` equals
  the uninterrupted run bitwise: weights, optimizer state, store, KL
  controller, running moments, ``iter_count``, and the prompt stream
  fast-forwarded past the chunks the first collection drew; a newer partial
  checkpoint beside it is skipped with a warning;
- the rollout seed stream and torch's generator round-trip through
  ``save`` / ``load``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import trlx_tpu_torch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.trainer.ppo import PPOTrainer
from trlx_tpu_torch.utils.checkpoint import (
    COMMIT_MARKER,
    STATE_FILE,
    _checkpoint_step_dirs,
    is_committed,
    load_state,
    newest_committed_checkpoint,
    save_state,
)


def test_save_commits_and_loads(tmp_path):
    d = str(tmp_path / "checkpoint_3")
    state = {"w": torch.arange(6.0), "step": 3, "extra": {"a": [1, 2], "b": 0.5}}
    assert not is_committed(d)
    save_state(d, state)
    assert is_committed(d)
    assert sorted(os.listdir(d)) == [COMMIT_MARKER, STATE_FILE]
    out = load_state(d)
    assert torch.equal(out["w"], state["w"]) and out["step"] == 3 and out["extra"] == state["extra"]


def test_a_crash_mid_save_leaves_no_loadable_partial(tmp_path):
    root = tmp_path / "ckpts"
    save_state(str(root / "checkpoint_2"), {"step": 2})
    # a fresh save that died while writing its file: no marker, no state.pt
    partial = root / "checkpoint_4"
    partial.mkdir()
    (partial / (STATE_FILE + ".staging")).write_bytes(b"\x80\x02half a pickle")
    assert not is_committed(str(partial))
    assert newest_committed_checkpoint(str(root)) == str(root / "checkpoint_2")
    with pytest.raises(FileNotFoundError):
        load_state(str(partial))
    # an overwrite that died before its rename keeps the previous state
    (root / "checkpoint_2" / (STATE_FILE + ".staging")).write_bytes(b"junk")
    assert is_committed(str(root / "checkpoint_2"))
    assert load_state(str(root / "checkpoint_2")) == {"step": 2}
    # the next save of that directory replaces the leftover
    save_state(str(root / "checkpoint_2"), {"step": 22})
    assert load_state(str(root / "checkpoint_2")) == {"step": 22}
    assert not (root / "checkpoint_2" / (STATE_FILE + ".staging")).exists()


def test_step_dirs_sort_as_in_jax(tmp_path):
    from trlx_tpu.utils.checkpoint import _checkpoint_step_dirs as jax_step_dirs

    for name in ("checkpoint_10", "checkpoint_2", "checkpoint_007", "checkpoint_x",
                 "best_checkpoint", "other"):
        (tmp_path / name).mkdir()
    (tmp_path / "checkpoint_3").write_text("a file, not a checkpoint")
    ours = _checkpoint_step_dirs(str(tmp_path))
    assert ours == jax_step_dirs(str(tmp_path))
    assert [s for s, _ in ours] == [2, 7, 10]
    assert _checkpoint_step_dirs(str(tmp_path / "missing")) == []


def _config(checkpoint_dir, **train):
    """``default_ppo_config()`` cut in model, lengths and steps: 8 rollouts
    in chunks of 4, batch 4 and 2 PPO epochs make 4 steps a collection, so
    the step-4 checkpoint falls where the second collection follows."""
    d = default_ppo_config().to_dict()
    d["model"].update(model_path="builtin:gpt2-test", num_layers_unfrozen=1)
    d["parallel"].update(compute_dtype="float32")
    d["train"].update(seq_length=24, batch_size=4, total_steps=8, checkpoint_interval=4,
                      checkpoint_dir=str(checkpoint_dir), **train)
    d["method"].update(num_rollouts=8, chunk_size=4, ppo_epochs=2)
    d["method"]["gen_kwargs"].update(max_new_tokens=8)
    return TRLConfig.from_dict(d)


def _prompts(n=12, seed=0):
    # 12 prompts in chunks of 4: the second collection draws the last chunk
    # of the first shuffle and the first of the next
    rs = np.random.RandomState(seed)
    return ["".join(chr(c) for c in rs.randint(97, 123, size=rs.randint(3, 17)))
            for _ in range(n)]


def reward_fn(samples, prompts, outputs):
    return [sum(ch in "aeiou" for ch in o) / max(len(o), 1) for o in outputs]


def _snapshot(trainer):
    return {
        "model": {k: v.clone() for k, v in trainer.model.state_dict().items()},
        "optimizer": trainer.optimizer.state_dict(),
        "store": [(e.query_tensor, e.response_tensor, e.logprobs, e.values, e.rewards)
                  for e in trainer.store.history],
        "scalars": (trainer.iter_count, trainer.step, trainer.kl_ctl.value, trainer.mean_kl,
                    trainer.running_moments.mean, trainer.running_moments.var,
                    trainer.running_moments.std, trainer.running_moments.count,
                    trainer._prompt_chunks_drawn),
    }


def test_resume_equals_the_uninterrupted_run(tmp_path, caplog):
    full_dir, resumed_dir = tmp_path / "full", tmp_path / "resumed"
    config = _config(full_dir)
    assert not config.train.continuous_batching and config.train.rollout_pipeline_depth == 2
    full = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_prompts(), config=config,
                                device="cpu")
    want = _snapshot(full)
    assert want["scalars"][0] == 8 and want["scalars"][-1] == 4
    assert is_committed(str(full_dir / "checkpoint_4"))

    # the resumed run finds the step-4 checkpoint and, beside it, a newer
    # save that died mid-write
    shutil.copytree(full_dir / "checkpoint_4", resumed_dir / "checkpoint_4")
    (resumed_dir / "checkpoint_6").mkdir()
    (resumed_dir / "checkpoint_6" / (STATE_FILE + ".staging")).write_bytes(b"partial")
    loaded = {}

    def hook(trainer):
        # the weights at construction are the seed's, not the checkpoint's
        loaded["fresh"] = trainer.model.state_dict()["v_head.out_proj.weight"].clone()

    with caplog.at_level("WARNING", logger="trlx_tpu_torch.trainer.base"):
        resumed = trlx_tpu_torch.train(
            reward_fn=reward_fn, prompts=_prompts(),
            config=_config(resumed_dir, resume_from_checkpoint=True),
            init_trainer_hook=hook, device="cpu")
    assert any("checkpoint_6" in r.getMessage() for r in caplog.records)
    got = _snapshot(resumed)
    assert got["scalars"] == want["scalars"]
    assert got["model"].keys() == want["model"].keys()
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert not torch.equal(loaded["fresh"], want["model"]["v_head.out_proj.weight"])
    for a, b in zip(got["optimizer"]["state"].values(), want["optimizer"]["state"].values()):
        for k in b:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k
    assert len(got["store"]) == len(want["store"]) == 8
    for x, y in zip(got["store"], want["store"]):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    # the resumed run wrote its own step-8 checkpoint, the same state
    final = load_state(str(resumed_dir / "checkpoint_8"))
    assert final["step"] == 8 and final["extra"]["prompt_chunks_drawn"] == 4


def test_no_checkpoint_to_resume_starts_fresh(tmp_path):
    config = _config(tmp_path / "empty", resume_from_checkpoint=True)
    trainer = PPOTrainer(config=config, reward_fn=reward_fn, device="cpu")
    trainer.maybe_resume()
    assert trainer.iter_count == 0 and trainer.step == 0
    trainer.maybe_resume()  # runs once


def test_seed_streams_round_trip(tmp_path):
    trainer = PPOTrainer(config=_config(tmp_path), reward_fn=reward_fn, device="cpu")
    trainer._row_seeds(5)
    torch.rand(3)
    trainer._prompt_chunks_drawn = 7
    trainer.save(str(tmp_path / "checkpoint_1"))
    want = (trainer._row_seeds(9), torch.rand(4))
    trainer._row_seeds(100)
    torch.rand(10)
    trainer.load(str(tmp_path / "checkpoint_1"))
    got = (trainer._row_seeds(9), torch.rand(4))
    np.testing.assert_array_equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    state = load_state(str(tmp_path / "checkpoint_1"))
    assert state["extra"]["prompt_chunks_drawn"] == 7
    assert set(state["extra"]) >= {"iter_count", "best_reward", "kl_ctl_value", "mean_kl",
                                   "running_moments"}
