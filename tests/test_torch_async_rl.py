"""The async actor/learner split of the port (``trlx_tpu_torch/async_rl/``,
``trainer/ppo.py`` and ``trainer/grpo.py``'s async halves) on the CPU.

- **queue and channel units**, as ``tests/test_async_rl.py`` holds JAX's:
  bounded back-pressure, ``drop_oldest`` eviction, the file spool and its
  cursor, version gating, ``sync_every``, the deterministic
  ``weight_sync_drop`` fault, the file channel's fetch deadline; and the
  port's own: a weights snapshot never moves with the live module, the file
  channel restores a module by parameter name (bf16 included), and the
  fault plan's collection and version triggers poll as JAX's;
- **against JAX** (greedy, the cut preset of
  ``tests/test_torch_serial_rollouts.py``): ``trlx_tpu_torch.train`` with
  ``async_rl`` in thread mode at ``max_staleness: 0``, from JAX's initial
  weights, against JAX's async ``train()`` — PPO on the in-memory (file)
  transport and on the collective one, and GRPO. The last store agrees
  element by element (tokens equal, the rest at ``ATOL``), each step's
  stats at ``RTOL`` and the final weights at ``ATOL``;
- **against the port itself** (sampled): at ``max_staleness: 0`` the store
  is bitwise the serial store, also after an ``actor_crash`` requeue and
  for GRPO; at ``max_staleness: 1`` a whole ``train()`` consumes no chunk
  staler than 1 and records the behaviour logprobs and the IW stats of the
  fused loss; ``drop_oldest`` regenerates evicted chunks; the continuous
  path swaps published weights in at segment boundaries and flushes the
  prefix cache on a changed version;
- **process mode**: a learner process and ``run_actor`` child processes on
  the file transport, the first child killed by ``actor_crash@collection:2``
  and relaunched; both collections' stores equal thread mode's, the first
  the serial run's.

No outcome waits on the wall clock: threads signal through events and
conditions, and every wait has its own limit (there is no pytest-timeout).
"""

import copy
import os
import subprocess
import sys
import textwrap
import threading

import jax
import numpy as np
import pytest
import torch

import trlx_tpu
import trlx_tpu_torch
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.data.default_configs import default_grpo_config as jax_default_grpo_config
from trlx_tpu.data.default_configs import default_ppo_config as jax_default_ppo_config
from trlx_tpu.resilience import faults as jax_faults
from trlx_tpu_torch.async_rl.channel import FileWeightChannel, WeightChannel, assemble_params
from trlx_tpu_torch.async_rl.queue import (
    ExperienceChunk,
    ExperienceQueue,
    FileExperienceQueue,
    QueueClosed,
    flatten_payload,
    unflatten_payload,
)
from trlx_tpu_torch.async_rl.runtime import ChunkSpec
from trlx_tpu_torch.data.configs import AsyncRLConfig, TRLConfig
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.models.builder import build_causal_lm
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.pipeline import get_pipeline
from trlx_tpu_torch.resilience.faults import FaultPlan
from trlx_tpu_torch.trainer import get_trainer
from trlx_tpu_torch.trainer.grpo import GRPOTrainer  # noqa: F401 (registration)
from trlx_tpu_torch.trainer.ppo import PPOTrainer  # noqa: F401 (registration)
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-5
# the absolute floor for stats that vanish in exact arithmetic (a
# collection's first policy loss at ratio 1)
STAT_ATOL = 1e-6
# every wait on a thread or a child process has its own limit
LIMIT_S = 60.0


class _Metrics:
    def __init__(self):
        self.counts = {}

    def inc(self, name, value=1.0):
        self.counts[name] = self.counts.get(name, 0.0) + value

    def observe(self, name, value):
        pass


# ---------------------------------------------------------------------------
# queue units
# ---------------------------------------------------------------------------


class TestExperienceQueue:
    def test_fifo_and_depth(self):
        q = ExperienceQueue(capacity=4)
        for i in range(3):
            q.put(ExperienceChunk(i, version=i))
        assert q.depth == 3
        assert [q.get().index for _ in range(3)] == [0, 1, 2]

    def test_block_policy_backpressures_put(self):
        q = ExperienceQueue(capacity=1, policy="block")
        q.put(ExperienceChunk(0, 0))
        started, landed = threading.Event(), threading.Event()

        def producer():
            started.set()
            q.put(ExperienceChunk(1, 0))
            landed.set()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        assert started.wait(LIMIT_S)
        # at capacity the put cannot land, however long it is given
        assert not landed.wait(0.1)
        assert q.get().index == 0
        assert landed.wait(LIMIT_S)
        t.join(LIMIT_S)
        assert q.get().index == 1

    def test_drop_oldest_evicts_counts_and_reports(self):
        m = _Metrics()
        dropped = []
        q = ExperienceQueue(capacity=2, policy="drop_oldest", metrics=m, on_drop=dropped.append)
        for i in range(4):
            q.put(ExperienceChunk(i, 0))
        assert m.counts["async/dropped_chunks"] == 2
        # evicted chunks go back for regeneration: the learner drains in
        # strict index order
        assert [c.index for c in dropped] == [0, 1]
        assert [q.get().index, q.get().index] == [2, 3]

    def test_drop_oldest_requires_on_drop(self):
        with pytest.raises(ValueError, match="on_drop"):
            ExperienceQueue(capacity=2, policy="drop_oldest")

    def test_close_wakes_blocked_consumer(self):
        q = ExperienceQueue(capacity=1)
        errs = []

        def consumer():
            try:
                q.get()
            except QueueClosed as e:
                errs.append(e)

        t = threading.Thread(target=consumer, daemon=True)
        t.start()
        q.close()
        t.join(LIMIT_S)
        assert errs and not t.is_alive()

    def test_get_timeout(self):
        with pytest.raises(TimeoutError, match="timed out"):
            ExperienceQueue(capacity=1).get(timeout=0.05)

    def test_file_queue_roundtrip_and_cursor(self, tmp_path):
        q = FileExperienceQueue(str(tmp_path / "spool"), capacity=4)
        payload = {
            "tokens": np.arange(6, dtype=np.int32).reshape(2, 3),
            "host": {"logprobs": np.ones((2, 3), np.float32)},
            "host_s": 0.25,
            "stats": {"time/reward": 0.5},
        }
        q.put(ExperienceChunk(0, version=7, payload=payload))
        assert q.committed_indices() == {0}
        chunk = q.get(0, timeout=5)
        assert chunk.version == 7
        np.testing.assert_array_equal(chunk.payload["tokens"], payload["tokens"])
        np.testing.assert_array_equal(chunk.payload["host"]["logprobs"],
                                      payload["host"]["logprobs"])
        assert chunk.payload["host_s"] == 0.25
        assert chunk.payload["stats"] == {"time/reward": 0.5}
        # consumed: the file is gone and the cursor moved, so a respawned
        # actor skips index 0
        assert q.committed_indices() == set()
        assert q.cursor() == 1

    def test_file_queue_get_timeout(self, tmp_path):
        q = FileExperienceQueue(str(tmp_path / "spool"), poll_interval_s=0.01)
        with pytest.raises(TimeoutError, match="actor dead or stalled"):
            q.get(0, timeout=0.1)

    def test_spool_scan_order_independent_of_directory_order(self, tmp_path, monkeypatch):
        import trlx_tpu_torch.async_rl.queue as queue_mod

        q = FileExperienceQueue(str(tmp_path / "spool"), capacity=8)
        for i in (3, 0, 7):
            q.put(ExperienceChunk(i, version=1, payload={"x": np.zeros(1)}))
        shuffled = ["chunk_000007.npz", "CURSOR.json", "chunk_000000.npz",
                    "not_a_chunk.txt", "chunk_oops.npz", "chunk_000003.npz"]
        real_listdir = queue_mod.os.listdir
        monkeypatch.setattr(queue_mod.os, "listdir",
                            lambda root: list(shuffled) if root == q.root else real_listdir(root))
        assert q.committed_indices() == {0, 3, 7}
        shuffled.reverse()
        assert q.committed_indices() == {0, 3, 7}


def test_flatten_payload_rejects_dotted_keys():
    with pytest.raises(ValueError, match="flatten separator"):
        flatten_payload({"stats.time": 1.0})
    with pytest.raises(ValueError, match="flatten separator"):
        flatten_payload({"outer": {"inner.dotted": np.zeros(2)}})
    assert unflatten_payload({"a.b": np.asarray(1.0)}) == {"a": {"b": 1.0}}
    payload = {"a": {"b": np.arange(3)}, "c": 2.5}
    out = unflatten_payload(flatten_payload(payload))
    np.testing.assert_array_equal(out["a"]["b"], payload["a"]["b"])
    assert out["c"] == 2.5


# ---------------------------------------------------------------------------
# weight channel, snapshots and the staleness gate
# ---------------------------------------------------------------------------


class TestWeightChannel:
    def test_publish_fetch_and_gate(self):
        ch = WeightChannel()
        ch.publish({"w": torch.ones(2)}, version=1)
        _, version = ch.fetch()
        assert version == 1
        # target 3 under max_staleness 1 needs a payload of version >= 2
        ch.announce(3, collection=1)
        assert not ch.ready(1)
        ch.publish({"w": torch.ones(2)}, version=2)
        assert ch.ready(1) and not ch.ready(0)
        ch.publish({"w": torch.ones(2)}, version=3)
        assert ch.ready(0)
        # a later collection waits for its announcement; an earlier one is free
        assert not ch.ready(8, collection=2)
        ch.announce(10, collection=2)
        assert ch.ready(0, collection=1)

    def test_sync_every_thins_and_force_overrides(self):
        m = _Metrics()
        ch = WeightChannel(metrics=m, sync_every=2)
        ch.publish({"w": 1}, version=1)  # thinned
        assert ch._payload_version == -1
        ch.publish({"w": 1}, version=1, force=True)
        assert ch._payload_version == 1
        ch.publish({"w": 1}, version=2)
        assert ch._payload_version == 2
        assert m.counts["async/weight_syncs"] == 2

    def test_weight_sync_drop_fault_and_heal(self):
        m = _Metrics()
        ch = WeightChannel(plan=FaultPlan.parse("weight_sync_drop@version:2"), metrics=m)
        ch.publish({"w": 1}, version=1)
        ch.publish({"w": 2}, version=2)  # dropped
        assert ch._payload_version == 1
        assert m.counts["async/weight_sync_drops"] == 1
        ch.publish({"w": 3}, version=3)  # the next publish heals
        assert ch.fetch() == ({"w": 3}, 3)

    def test_wait_ready_unblocks_on_publish(self):
        ch = WeightChannel()
        ch.publish({"w": 0}, version=0)
        ch.announce(2, collection=1)
        assert not ch.ready(0, collection=1)  # target 2, payload 0, bound 0
        ready = []
        t = threading.Thread(target=lambda: ready.append(ch.wait_ready(0, collection=1)),
                             daemon=True)
        t.start()
        ch.publish({"w": 2}, version=2)
        t.join(LIMIT_S)
        assert ready == [True]

    def test_close_and_stop_release_waiters(self):
        ch = WeightChannel()
        stop = threading.Event()
        stop.set()
        assert ch.wait_ready(0, stop=stop) is False
        ch.close()
        assert ch.wait_ready(0) is False
        with pytest.raises(RuntimeError, match="closed before first publish"):
            ch.fetch()

    def test_module_snapshot_never_moves_with_the_live_module(self):
        model, _ = build_causal_lm("builtin:gpt2-test", device="cpu")
        ch = WeightChannel()
        ch.publish(model, version=1)
        snap, _ = ch.fetch()
        assert snap is not model
        before = {k: v.clone() for k, v in snap.state_dict().items()}
        with torch.no_grad():  # an optimizer step updates in place
            for p in model.parameters():
                p.add_(1.0)
        for k, v in snap.state_dict().items():
            assert torch.equal(v, before[k]), k
        assert not any(p.requires_grad for p in snap.parameters())
        assert not snap.training


class TestFileChannel:
    def test_module_round_trip_by_parameter_name(self, tmp_path):
        """The learner's npz holds the state dict by name; the actor's fetch
        loads it into a frozen copy of its own module, bf16 exactly."""
        learner, _ = build_causal_lm("builtin:gpt2-test", device="cpu", seed=1)
        actor, _ = build_causal_lm("builtin:gpt2-test", device="cpu", seed=2)
        with torch.no_grad():
            learner.wte.weight.copy_(learner.wte.weight.bfloat16().float())
        root = str(tmp_path / "weights")
        FileWeightChannel(root).publish(learner, version=4, force=True)
        with np.load(os.path.join(root, FileWeightChannel.WEIGHTS)) as data:
            assert set(data.files) == {"__version__", *learner.state_dict()}
        fetched, version = FileWeightChannel(root).fetch(template=actor)
        assert version == 4 and fetched is not actor
        for k, v in learner.state_dict().items():
            assert torch.equal(fetched.state_dict()[k], v), k
        # bf16 widens to f32 in the file and casts back on load, bitwise
        w = learner.wte.weight.detach().bfloat16()
        out = assemble_params({"w": w.float().numpy()}, {"w": torch.zeros(w.shape,
                                                                       dtype=torch.bfloat16)})
        assert torch.equal(out["w"], w)

    def test_slow_writer_within_deadline_succeeds(self, tmp_path):
        root = str(tmp_path / "weights")
        writer = FileWeightChannel(root, poll_interval_s=0.01)
        reader = FileWeightChannel(root, poll_interval_s=0.01)
        # the manifest promises version 1 while the payload still carries 0,
        # as a reader sees it while the writer's replace is in flight
        writer.publish({"w": np.zeros(4)}, version=0, force=True)
        writer._write_manifest({"version": 1, "target": 0})
        done = threading.Event()

        def land_late():
            manifest = writer._read_manifest()
            writer._write_manifest({**manifest, "version": 0})
            writer.publish({"w": np.ones(4)}, version=1, force=True)
            done.set()

        timer = threading.Timer(0.3, land_late)
        timer.start()
        try:
            params, version = reader.fetch(template={"w": np.zeros(4)})
        finally:
            timer.join(LIMIT_S)
        assert done.is_set() and version == 1
        np.testing.assert_array_equal(params["w"], np.ones(4))

    def test_dead_writer_raises_after_deadline(self, tmp_path, monkeypatch):
        import trlx_tpu_torch.async_rl.channel as channel_mod

        root = str(tmp_path / "weights")
        writer = FileWeightChannel(root, poll_interval_s=0.01)
        writer.publish({"w": np.zeros(4)}, version=0, force=True)
        writer._write_manifest({"version": 5, "target": 0})  # the writer died
        reader = FileWeightChannel(root, poll_interval_s=0.0)
        now = channel_mod.time.monotonic()
        ticks = iter([now, now + reader.fetch_timeout_s + 1])
        monkeypatch.setattr(channel_mod.time, "monotonic", lambda: next(ticks, now + 1e9))
        with pytest.raises(RuntimeError, match="writer dead"):
            reader.fetch(template={"w": np.zeros(4)})

    def test_deadline_floor_and_config_field(self, tmp_path):
        assert FileWeightChannel(str(tmp_path / "a")).fetch_timeout_s >= 30.0
        assert FileWeightChannel(str(tmp_path / "b"), fetch_timeout_s=1.0).fetch_timeout_s == 30.0
        assert AsyncRLConfig().fetch_timeout_s >= 30.0

    def test_announce_heals_and_gate(self, tmp_path):
        ch = FileWeightChannel(str(tmp_path / "w"))
        assert not ch.ready(0)  # nothing published
        ch.publish({"w": np.zeros(1)}, version=2, force=True)
        ch.announce(5, collection=1)
        assert not ch.ready(2) and ch.ready(3)
        ch.announce(2, collection=1)  # the drain-start heal lowers the target
        assert ch.ready(0)
        ch.announce(9, collection=0)  # an older collection never moves it back
        assert ch._read_manifest()["target"] == 2


def test_fault_plan_collection_and_version_triggers_poll_as_jax():
    text = "actor_crash@collection:2; weight_sync_drop@version:3*2"
    ours, theirs = FaultPlan.parse(text), jax_faults.FaultPlan.parse(text)
    polls = [("actor_crash", {"collection": c}) for c in (1, 2, 3)]
    polls += [("weight_sync_drop", {"version": v}) for v in (2, 3, 4, 5)]
    polls += [("actor_crash", {"step": 2}), ("weight_sync_drop", {})]
    for kind, kw in polls:
        assert ours.poll(kind, **kw) == theirs.poll(kind, **kw), (kind, kw)
    assert ours.fired == theirs.fired == {"actor_crash": 1, "weight_sync_drop": 2}


# ---------------------------------------------------------------------------
# against JAX: greedy async train() at max_staleness 0
# ---------------------------------------------------------------------------


def _prompts(n=48, seed=0):
    rs = np.random.RandomState(seed)
    return ["".join(chr(c) for c in rs.randint(97, 123, size=rs.randint(3, 17)))
            for _ in range(n)]


def vowel_reward(samples, prompts, outputs):
    return [sum(ch in "aeiou" for ch in o) / max(len(o), 1) for o in outputs]


def drawn_reward(seed=0):
    """Each call's scores from one seeded stream (greedy GRPO members are
    identical, so a text reward would give zero advantages)."""
    rs = np.random.RandomState(seed)

    def reward_fn(samples, prompts, outputs):
        return rs.randn(len(samples)).tolist()

    return reward_fn


class _Recorder:
    def __init__(self):
        self.history = []

    def log(self, stats, step):
        self.history.append((int(step), dict(stats)))

    def finish(self):
        pass


ASYNC_THREAD = {"enabled": True, "mode": "thread", "num_actors": 1, "max_staleness": 0}


def _ppo_dict(tmp, chunk_size=16, **gen_kwargs):
    """``default_ppo_config()`` cut as ``tests/test_torch_serial_rollouts.py``
    cuts it (greedy, 128 rollouts in chunks of 16 here, so a collection is
    eight chunks of the 48 prompts; 20 steps are two collections). No
    response is empty (``min_new_tokens`` 1) and every chunk is whole, so no
    drain tops up past its eight chunks: there JAX frees the next collection
    under stale weights (``async_rl/channel.py``)."""
    d = jax_default_ppo_config().to_dict()
    d["model"].update(model_path="builtin:gpt2-test", num_layers_unfrozen=1)
    d["parallel"].update(compute_dtype="float32")
    d["train"].update(seq_length=24, total_steps=20, checkpoint_dir=str(tmp))
    d["method"].update(chunk_size=chunk_size)
    d["method"]["gen_kwargs"].update(max_new_tokens=8, do_sample=False, min_new_tokens=1,
                                     **gen_kwargs)
    d["async_rl"].update(ASYNC_THREAD)
    return d


def _grpo_dict(tmp):
    """``default_grpo_config()`` cut as ``tests/test_torch_grpo.py`` cuts it:
    one 128-row chunk a collection, 9 steps (the 9th on the second)."""
    d = jax_default_grpo_config().to_dict()
    d["model"].update(model_path="builtin:gpt2-test")
    d["parallel"].update(compute_dtype="float32")
    d["train"].update(seq_length=24, total_steps=9, checkpoint_dir=str(tmp))
    d["method"]["gen_kwargs"].update(max_new_tokens=8, do_sample=False, min_new_tokens=1)
    d["async_rl"].update(ASYNC_THREAD)
    return d


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_run(config_dict, reward_fn):
    out = {}

    def hook(trainer):
        out["params0"] = _np_tree(trainer.state.params)
        trainer.tracker = _Recorder()

    with pytest.MonkeyPatch.context() as mp:
        # no background MFU compile racing the run for the CPU
        mp.setenv("TRLX_TPU_MFU", "0")
        trainer = trlx_tpu.train(reward_fn=reward_fn, prompts=_prompts(),
                                 config=JaxTRLConfig.from_dict(copy.deepcopy(config_dict)),
                                 init_trainer_hook=hook)
    out.update(history=trainer.tracker.history, store=list(trainer.store.history),
               params=_np_tree(trainer.state.params))
    return out


def _port_run(config_dict, jax_run, reward_fn):
    def hook(trainer):
        trainer.model.load_state_dict(params_from_jax(jax_run["params0"], trainer.tcfg))
        trainer.ref_params = trainer._ref_snapshot()
        trainer.tracker = _Recorder()

    return trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_prompts(),
                                config=TRLConfig.from_dict(config_dict), init_trainer_hook=hook,
                                device="cpu")


@pytest.fixture(scope="module")
def jax_async_ppo(tmp_path_factory):
    return _jax_run(_ppo_dict(tmp_path_factory.mktemp("jax_async_ppo")), vowel_reward)


@pytest.fixture(scope="module")
def jax_async_grpo(tmp_path_factory):
    return _jax_run(_grpo_dict(tmp_path_factory.mktemp("jax_async_grpo")), drawn_reward())


def _compare(trainer, jax_run, fields, stat_prefixes, stat_keys, steps_expected):
    ours, theirs = list(trainer.store.history), jax_run["store"]
    assert len(ours) == len(theirs) == trainer.config.method.num_rollouts
    for i, (a, b) in enumerate(zip(ours, theirs)):
        np.testing.assert_array_equal(a.query_tensor, b.query_tensor, err_msg=f"query {i}")
        np.testing.assert_array_equal(a.response_tensor, b.response_tensor,
                                      err_msg=f"response {i}")
        for name in fields:
            np.testing.assert_allclose(np.asarray(getattr(a, name), np.float32),
                                       np.asarray(getattr(b, name), np.float32),
                                       atol=ATOL, rtol=0, err_msg=f"{name} {i}")
    steps = [(s, st) for s, st in trainer.tracker.history if "gradients/global_norm" in st]
    jsteps = [(s, st) for s, st in jax_run["history"] if "gradients/global_norm" in st]
    assert len(steps) == len(jsteps) == steps_expected
    for (s_o, st_o), (s_t, st_t) in zip(steps, jsteps):
        assert s_o == s_t
        keys = [k for k in st_t if k.startswith(stat_prefixes) or k in stat_keys]
        assert len(keys) > 10
        for k in keys:
            np.testing.assert_allclose(st_o[k], float(st_t[k]), rtol=RTOL, atol=STAT_ATOL,
                                       err_msg=f"step {s_o} {k}")
    final = params_from_jax(jax_run["params"], trainer.tcfg)
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=ATOL, rtol=0, err_msg=k)
    collections = [st for _, st in trainer.tracker.history if "time/exp" in st]
    jcollections = [st for _, st in jax_run["history"] if "time/exp" in st]
    assert len(collections) == len(jcollections) == 2
    for ours_c, theirs_c in zip(collections, jcollections):
        for k in ("async/chunks", "async/staleness_max", "async/staleness_mean"):
            assert ours_c[k] == theirs_c[k], k
        assert ours_c["async/staleness_max"] == 0.0
    return collections


@pytest.mark.parametrize("transport", ["file", "collective"])
def test_async_ppo_matches_jax_train(jax_async_ppo, tmp_path, transport):
    d = _ppo_dict(tmp_path)
    d["async_rl"].update(transport=transport, num_actors=2 if transport == "collective" else 1)
    trainer = _port_run(d, jax_async_ppo, vowel_reward)
    collections = _compare(trainer, jax_async_ppo, ("logprobs", "values", "rewards"),
                           ("losses/", "policy/", "values/", "old_values/", "returns/"),
                           ("ratio", "learning_rate", "gradients/global_norm"), 20)
    assert all(c["async/chunks"] == 8.0 for c in collections)
    if transport == "collective":
        assert collections[-1]["async/fleet_size"] == 2.0
    # actors stopped with learn()
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith(("trlx-async-actor", "trlx-fleet"))]


def test_async_grpo_matches_jax_train(jax_async_grpo, tmp_path):
    trainer = _port_run(_grpo_dict(tmp_path), jax_async_grpo, drawn_reward())
    _compare(trainer, jax_async_grpo, ("logprobs", "ref_logprobs", "advantage"),
             ("losses/", "policy/", "ratio/"),
             ("advantages_mean", "padding_percentage", "learning_rate",
              "gradients/global_norm"), 9)


def test_topped_up_drain_keeps_staleness_zero_and_the_serial_stores(tmp_path):
    """Where a drain needs a fifth chunk (chunks of 32 over 48 prompts
    alternate 32 and 16 rows), the port grants that one chunk and the next
    collection still waits for the phase's last update: both collections'
    stores equal the serial run's and no chunk is stale. (JAX's drain frees
    the whole next collection under the weights of its start: staleness 16
    here.)"""
    runs = {}
    for tag, async_rl in (("serial", {"enabled": False}), ("async", {})):
        d = _ppo_dict(tmp_path / tag, chunk_size=32)
        d["async_rl"].update(async_rl)
        stores = []

        def hook(trainer, stores=stores):
            trainer.tracker = _Recorder()
            make = trainer.make_experience

            def recorded(num_rollouts=1024, iter_count=0):
                make(num_rollouts, iter_count)
                stores.append([(e.response_tensor, e.logprobs, e.values, e.rewards)
                               for e in trainer.store.history])

            trainer.make_experience = recorded

        trainer = trlx_tpu_torch.train(reward_fn=vowel_reward, prompts=_prompts(),
                                       config=TRLConfig.from_dict(d), init_trainer_hook=hook,
                                       device="cpu")
        runs[tag] = (trainer, stores)
    (_, serial), (trainer, stores) = runs["serial"], runs["async"]
    collections = [st for _, st in trainer.tracker.history if "time/exp" in st]
    assert collections[0]["async/chunks"] == 5.0  # the drain topped up
    assert [c["async/staleness_max"] for c in collections] == [0.0, 0.0]
    assert len(stores) == len(serial) == 2
    for ours, theirs in zip(stores, serial):
        assert len(ours) == len(theirs) == 128
        for a, b in zip(ours, theirs):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# against the port itself: sampled rollouts
# ---------------------------------------------------------------------------

PROMPTS = ["hello world", "the quick brown fox", "lorem ipsum", "foo bar"] * 4
_PPO_FIELDS = ("query_tensor", "response_tensor", "logprobs", "values", "rewards")
_GRPO_FIELDS = ("query_tensor", "response_tensor", "logprobs", "ref_logprobs", "advantage")


def _letter_reward(samples, prompts, outputs, **kwargs):
    return [float(sum(c in "aeiou" for c in o)) for o in outputs]


def _small_config(tmp_path, tag, cb=False, **overrides):
    return default_ppo_config().evolve(
        train=dict(seq_length=48, batch_size=8, total_steps=4, checkpoint_interval=1000,
                   eval_interval=1000, checkpoint_dir=str(tmp_path / f"ckpts_{tag}"),
                   tracker=None, rollout_pipeline_depth=0, continuous_batching=cb,
                   continuous_batching_segment=4),
        model=dict(model_path="builtin:gpt2-test", num_layers_unfrozen=1),
        method=dict(num_rollouts=16, chunk_size=4, ppo_epochs=1,
                    gen_kwargs=dict(max_new_tokens=8, top_k=0, top_p=1.0, do_sample=True)),
        **overrides,
    )


def _trainer(config):
    trainer = get_trainer(config.train.trainer)(config=config, reward_fn=_letter_reward,
                                                metric_fn=None, stop_sequences=[], device="cpu")
    trainer.add_prompt_pipeline(get_pipeline(config.train.pipeline)(PROMPTS, 40,
                                                                    trainer.tokenizer))
    return trainer


def _assert_stores_identical(store_a, store_b, fields=_PPO_FIELDS):
    assert len(store_a) == len(store_b)
    for a, b in zip(store_a.history, store_b.history):
        for field in fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                          np.asarray(getattr(b, field)), err_msg=field)


class TestAsyncThreadMode:
    def test_max_staleness_zero_bit_identical_to_serial(self, tmp_path):
        serial = _trainer(_small_config(tmp_path, "serial"))
        asy = _trainer(_small_config(tmp_path, "async", async_rl=ASYNC_THREAD))
        try:
            serial.make_experience(16)
            asy.make_experience(16)
            _assert_stores_identical(serial.store, asy.store)
            # iw_correction off: no behaviour logprobs in the store
            assert all(e.behavior_logprobs is None for e in asy.store.history)
            stats = asy.make_experience_stats
            assert stats["async/staleness_max"] == 0.0
            assert stats["async/chunks"] == 4.0
        finally:
            asy._shutdown_collectors()

    def test_actor_crash_requeued_respawned_still_bit_identical(self, tmp_path):
        serial = _trainer(_small_config(tmp_path, "serial"))
        crash = _trainer(_small_config(tmp_path, "crash", async_rl=ASYNC_THREAD,
                                       resilience=dict(fault_plan="actor_crash@collection:1")))
        try:
            serial.make_experience(16)
            crash.make_experience(16)
            snap = crash.obs.metrics.snapshot(reset_histograms=False)
            assert snap.get("async/actor_restarts") == 1.0, snap
            assert snap.get("async/requeued_chunks") == 1.0, snap
            _assert_stores_identical(serial.store, crash.store)
        finally:
            crash._shutdown_collectors()

    def test_crash_past_restarts_reaches_the_learner(self, tmp_path):
        """No fallback: with restarts exhausted on the in-memory transport
        the actor's own exception reaches the learner."""
        crash = _trainer(_small_config(
            tmp_path, "fatal", async_rl={**ASYNC_THREAD, "max_actor_restarts": 0},
            resilience=dict(fault_plan="actor_crash@collection:1")))
        try:
            with pytest.raises(RuntimeError, match="actor crash in collection 1"):
                crash.make_experience(16)
        finally:
            crash._shutdown_collectors()

    def test_learn_overlap_staleness_bounded_and_iw_recorded(self, tmp_path):
        """A whole ``train()`` at ``max_staleness: 1`` with two actors: no
        chunk consumed staler than 1, the behaviour logprobs in the store,
        and the fused loss's IW stats in the steps; the actors stop with
        ``learn()``."""
        config = _small_config(
            tmp_path, "learn", async_rl={**ASYNC_THREAD, "num_actors": 2, "max_staleness": 1})
        config = config.evolve(train=dict(epochs=2), method=dict(
            iw_correction="clip", iw_clip=2.0, loss_kernel="pallas"))
        seen = []

        def hook(trainer):
            trainer.tracker = _Recorder()
            make = trainer.make_experience

            def recorded(num_rollouts=1024, iter_count=0):
                make(num_rollouts, iter_count)
                seen.append(dict(trainer.make_experience_stats))

            trainer.make_experience = recorded

        trainer = trlx_tpu_torch.train(reward_fn=_letter_reward, prompts=PROMPTS, config=config,
                                       init_trainer_hook=hook, device="cpu")
        assert len(seen) == 2
        assert all(s["async/staleness_max"] <= 1.0 for s in seen), seen
        assert all(e.behavior_logprobs is not None for e in trainer.store.history)
        steps = [st for _, st in trainer.tracker.history if "gradients/global_norm" in st]
        assert len(steps) == 4
        assert all(0.0 < st["iw/rho_mean"] <= 2.0 and 0.0 <= st["iw/rho_clipfrac"] <= 1.0
                   for st in steps)
        snap = trainer.obs.metrics.snapshot(reset_histograms=False)
        assert snap.get("async/weight_syncs", 0) >= 4, snap
        assert not [t.name for t in threading.enumerate()
                    if t.name.startswith("trlx-async-actor")]

    def test_weight_sync_drop_keeps_the_previous_version(self, tmp_path):
        """A dropped publish: the actors keep the last version and the
        drain-start force publish heals the gate."""
        trainer = _trainer(_small_config(tmp_path, "drop", async_rl=ASYNC_THREAD,
                                         resilience=dict(fault_plan="weight_sync_drop@version:1")))
        try:
            trainer.make_experience(16)
            collector = trainer._async
            collector.on_update(trainer.model, 1)  # dropped
            assert collector.channel.fetch()[1] == 0
            collector.on_update(trainer.model, 2)
            assert collector.channel.fetch()[1] == 2
            snap = trainer.obs.metrics.snapshot(reset_histograms=False)
            assert snap.get("async/weight_sync_drops") == 1.0
        finally:
            trainer._shutdown_collectors()


def test_many_actors_under_fast_switching_keep_the_serial_store(tmp_path):
    """Eight actor threads (more than the cores) share the dispatcher, the
    trainer's engine caches and the kernel wrappers' counters under a 10 µs
    switch interval: at ``max_staleness: 0`` the store is still the serial
    one, so no spec, seed or chunk was drawn twice or lost."""
    config = _small_config(tmp_path, "stress").evolve(method=dict(num_rollouts=32))
    serial = _trainer(config)
    asy = _trainer(config.evolve(async_rl={**ASYNC_THREAD, "num_actors": 8}))
    interval = sys.getswitchinterval()
    try:
        serial.make_experience(32)
        sys.setswitchinterval(1e-5)
        asy.make_experience(32)
        sys.setswitchinterval(interval)
        _assert_stores_identical(serial.store, asy.store)
        assert asy.make_experience_stats["async/chunks"] == 8.0
        assert asy._async._next_index >= 8
    finally:
        sys.setswitchinterval(interval)
        asy._shutdown_collectors()
        serial._shutdown_collectors()


def test_drop_oldest_regenerates_evicted_chunks(tmp_path):
    config = _small_config(tmp_path, "drop_oldest", async_rl={
        **ASYNC_THREAD, "max_staleness": 8, "queue_capacity": 1, "queue_policy": "drop_oldest"})
    evictions = []
    overproduced = threading.Event()

    def hook(trainer):
        # hold the learner's first drain until the actor has overproduced
        # twice, so the queue of one has evicted (event-driven, no sleeps)
        collector = trainer._ensure_async_collector()
        next_chunk = collector.next_chunk

        def held():
            overproduced.wait(LIMIT_S)
            return next_chunk()

        collector.next_chunk = held
        on_drop = trainer._async_on_drop

        def seen(chunk):
            evictions.append(chunk.index)
            if len(evictions) >= 2:
                overproduced.set()
            on_drop(chunk)

        collector.queue.on_drop = seen

    trainer = trlx_tpu_torch.train(reward_fn=_letter_reward, prompts=PROMPTS,
                                   config=config.evolve(train=dict(epochs=2)),
                                   init_trainer_hook=hook, device="cpu")
    assert overproduced.is_set()
    assert len(trainer.store) == 16  # every evicted index came back
    snap = trainer.obs.metrics.snapshot(reset_histograms=False)
    assert evictions and snap.get("async/dropped_chunks") == len(evictions)
    assert snap.get("async/requeued_chunks", 0) >= len(evictions)


def test_grpo_async_thread_mode_bit_identical_to_serial(tmp_path):
    config = default_ppo_config().evolve(
        train=dict(seq_length=48, batch_size=8, total_steps=2, trainer="GRPOTrainer",
                   checkpoint_interval=1000, eval_interval=1000,
                   checkpoint_dir=str(tmp_path / "ckpt"), tracker=None,
                   rollout_pipeline_depth=0),
        model=dict(model_path="builtin:gpt2-test", num_layers_unfrozen=1),
        method=dict(name="GRPOConfig", num_rollouts=16, chunk_size=8, group_size=4,
                    ppo_epochs=1, iw_correction="clip",
                    gen_kwargs=dict(max_new_tokens=8, top_k=0, top_p=1.0, do_sample=True)))
    serial = _trainer(config)
    asy = _trainer(config.evolve(async_rl={**ASYNC_THREAD, "max_staleness": 1}))
    try:
        serial.make_experience(16)
        asy.make_experience(16)
        _assert_stores_identical(serial.store, asy.store, _GRPO_FIELDS)
        assert all(e.behavior_logprobs is not None for e in asy.store.history)
        assert all(e.behavior_logprobs is None for e in serial.store.history)
        # greedy or not, the sampler's own logprobs of its tokens equal the
        # scoring forward's under the same weights
        for e in asy.store.history:
            np.testing.assert_allclose(e.behavior_logprobs, e.logprobs, atol=1e-5)
        adv = np.asarray([e.advantage for e in asy.store.history])
        np.testing.assert_allclose(adv.reshape(-1, 4).mean(axis=1), 0.0, atol=1e-5)
        assert asy.make_experience_stats["async/chunks"] == 2.0
    finally:
        asy._shutdown_collectors()
        serial._shutdown_collectors()


def test_grpo_async_refuses_continuous_batching(tmp_path):
    config = default_ppo_config().evolve(
        train=dict(trainer="GRPOTrainer", continuous_batching=True,
                   checkpoint_dir=str(tmp_path)),
        model=dict(model_path="builtin:gpt2-test"),
        method=dict(name="GRPOConfig", chunk_size=8, group_size=4),
        async_rl=ASYNC_THREAD)
    with pytest.raises(NotImplementedError, match="async_rl"):
        get_trainer("GRPOTrainer")(config=config, reward_fn=_letter_reward, device="cpu")


class _SwappingChannel:
    """A thread-mode channel whose first segment-boundary fetch finds a new
    version published: the learner updated in place and published."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.channel = WeightChannel()
        self.channel.publish(trainer.model, version=0)
        self.fetches = 0

    def fetch(self, template=None):
        self.fetches += 1
        if self.fetches == 1:
            with torch.no_grad():
                self.trainer.model.backbone.wte.weight.mul_(1.5)
            self.channel.publish(self.trainer.model, version=1)
        return self.channel.fetch()


def test_continuous_actor_swaps_in_flight_and_flushes_prefix_cache(tmp_path):
    config = _small_config(tmp_path, "cb", cb=True, async_rl=ASYNC_THREAD, engine=dict(
        backend="paged", kv_block_size=4, prefix_cache=True, decode_kernel="pallas",
        prefill_kernel="pallas"))
    trainer = _trainer(config)
    channel = _SwappingChannel(trainer)
    v0, _ = channel.channel.fetch()
    batch = next(trainer.prompt_iterator)
    ids = np.asarray(batch["input_ids"], np.int64)
    spec = ChunkSpec(0, 1, ids, np.asarray(batch["attention_mask"], np.int64),
                     trainer._row_seeds(ids.shape[0]))
    flushes = []
    make_engine = trainer._cb_make_engine

    def spying(*args, **kwargs):
        engine = make_engine(*args, **kwargs)
        clear = engine.prefix.clear

        def counted(allocator):
            flushes.append(len(engine.prefix))
            clear(allocator)

        engine.prefix.clear = counted
        return engine

    trainer._cb_make_engine = spying
    payload = trainer._async_produce_chunk(spec, v0, 0, channel)
    engine = next(e for k, e in trainer._generate_fns.items()
                  if k[0] == "cb_engine" and isinstance(k[-1], tuple) and k[-1][0] == "async")
    # segments of 4 over 8 new tokens: the swap lands between them
    assert channel.fetches >= 1
    assert engine._params_version == 1 and engine.params is channel.channel.fetch()[0]
    assert flushes and flushes[0] > 0  # the committed prompt blocks were dropped
    assert payload["behavior_logprobs"].shape == payload["response_tokens"].shape
    # a fetch of the same version is one int compare: no flush
    assert engine.swap_params(trainer._engine_params(v0), 1) is False
    assert len(flushes) == 1


# ---------------------------------------------------------------------------
# process mode: a learner and run_actor children (file transport)
# ---------------------------------------------------------------------------

_COMMON = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, {tests!r})
    import hashlib
    import numpy as np
    from torch_threads import use_one_cpu_thread
    use_one_cpu_thread()
    PROMPTS = ["hello world", "the quick brown fox", "lorem ipsum", "foo bar"] * 4

    def reward_fn(samples=None, prompts=None, outputs=None, **kw):
        return [float(sum(c in "aeiou" for c in o)) for o in outputs]

    def base_config(ckpt_dir, fault=None, **async_rl):
        from trlx_tpu_torch.data.default_configs import default_ppo_config
        return default_ppo_config().evolve(
            train=dict(seq_length=48, batch_size=8, total_steps=4, checkpoint_interval=1000,
                       eval_interval=1000, checkpoint_dir=ckpt_dir, tracker=None, epochs=2),
            model=dict(model_path="builtin:gpt2-test", num_layers_unfrozen=1),
            method=dict(num_rollouts=16, chunk_size=4, ppo_epochs=1,
                        gen_kwargs=dict(max_new_tokens=8, top_k=0, top_p=1.0, do_sample=True)),
            async_rl=dict(enabled=True, mode="process", max_staleness=0, root_dir={root!r},
                          actor_timeout_s=240.0, **async_rl),
            resilience=dict(fault_plan=fault))

    def store_hash(store):
        h = hashlib.sha256()
        for e in store.history:
            for f in ("query_tensor", "response_tensor", "logprobs", "values", "rewards"):
                h.update(np.ascontiguousarray(np.asarray(getattr(e, f), np.float64)).tobytes())
        return h.hexdigest()
    """
)

ACTOR_WORKER = _COMMON + textwrap.dedent(
    """
    from trlx_tpu_torch.async_rl.actor import run_actor

    n = run_actor(base_config({ckpt!r}, fault={fault!r}, transport={transport!r}),
                  reward_fn=reward_fn, prompts=PROMPTS, device="cpu")
    print("ACTOR_DONE", n, flush=True)
    """
)

# the learner: two references first — the serial run (its first collection)
# and the same async run with in-process actor threads (both collections:
# the chunk stream is a copy of the seed stream taken at the first
# collection, so from the second collection on it differs from the serial
# run's, which evaluation draws from) — then the process-mode run at
# max_staleness 0, whose stores must hash the same
LEARNER_WORKER = _COMMON + textwrap.dedent(
    """
    import trlx_tpu_torch

    def run(config):
        hashes, stats = [], []

        def hook(trainer):
            make = trainer.make_experience

            def recorded(num_rollouts=1024, iter_count=0):
                make(num_rollouts, iter_count)
                hashes.append(store_hash(trainer.store))
                stats.append(dict(trainer.make_experience_stats))

            trainer.make_experience = recorded

        trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, config=config,
                                       init_trainer_hook=hook, device="cpu")
        return trainer, hashes, stats

    config = base_config({ckpt!r}, transport={transport!r})
    _, serial_hashes, _ = run(config.evolve(
        train=dict(checkpoint_dir={ckpt!r} + "_serial"), async_rl=dict(enabled=False)))
    _, thread_hashes, _ = run(config.evolve(
        train=dict(checkpoint_dir={ckpt!r} + "_thread"), async_rl=dict(mode="thread")))
    assert thread_hashes[0] == serial_hashes[0], "thread mode diverged from the serial run"
    trainer, hashes, stats = run(config)
    assert hashes == thread_hashes, "the process-mode stores diverged from thread mode's"
    assert [s["async/staleness_max"] for s in stats] == [0.0, 0.0], stats
    assert all(s["async/chunks"] == 4.0 for s in stats), stats
    snap = trainer.obs.metrics.snapshot(reset_histograms=False)
    print("LEARNER_OK", len(hashes), snap.get("async/weight_syncs"),
          snap.get("async/fleet_shrinks"), flush=True)
    """
)


def _spawn(src, log, **fmt):
    return subprocess.Popen([sys.executable, "-c", src.format(**fmt)], stdout=log,
                            stderr=subprocess.STDOUT, text=True, cwd=REPO)


def _finish(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(LIMIT_S)


def test_process_mode_learner_plus_actor_with_crash(tmp_path):
    """A learner process and one ``run_actor`` child on the file transport:
    ``actor_crash@collection:2`` kills the child on collection 2's first
    chunk, the supervisor relaunches it, the new child fast-forwards past
    the spooled chunks and regenerates the lost one, and both collections'
    stores equal those of the same run with actor threads (its first, the
    serial run's)."""
    root = str(tmp_path / "transport")
    fmt = dict(repo=REPO, tests=os.path.join(REPO, "tests"), root=root,
               ckpt=str(tmp_path / "ckpt"), transport="file")
    logs = [open(tmp_path / "learner.log", "w")]
    learner = _spawn(LEARNER_WORKER, logs[0], **fmt)
    procs, rcs = [learner], []
    try:
        for attempt in range(3):  # the supervisor's relaunch loop
            logs.append(open(tmp_path / f"actor{attempt}.log", "w"))
            actor = _spawn(ACTOR_WORKER, logs[-1], fault="actor_crash@collection:2", **fmt)
            procs.append(actor)
            rcs.append(actor.wait(300))
            if rcs[-1] == 0:
                break
        learner.wait(300)
    finally:
        _finish(procs)
        for log in logs:
            log.close()
    out = (tmp_path / "learner.log").read_text()
    actor_out = [(tmp_path / f"actor{i}.log").read_text() for i in range(len(rcs))]
    assert learner.returncode == 0 and "LEARNER_OK 2" in out, out[-3000:]
    assert rcs[0] != 0 and "actor_crash@collection:2" in actor_out[0], actor_out[0][-2000:]
    assert rcs[-1] == 0 and "ACTOR_DONE" in actor_out[-1], actor_out[-1][-2000:]
    # the relaunched child regenerated the crashed chunk (index 4) and the rest
    assert int(actor_out[-1].split("ACTOR_DONE")[1].split()[0]) >= 4
