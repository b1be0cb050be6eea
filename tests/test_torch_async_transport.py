"""The collective actor-fleet transport of the port
(``trlx_tpu_torch/async_rl/transport.py``) on the CPU, as
``tests/test_async_transport.py`` holds JAX's.

- **fabric units**: the tree layout, the delta encode/decode (bitwise, bf16
  tensors included), the leaf digests, the endpoint bootstrap;
- **fleet integration** (a coordinator and clients over loopback): join
  snapshots, a delta publish with unchanged-leaf skipping through a
  fanout-1 chain (a genuine relay hop), point-to-point chunk commits, lease
  requeue on a member's death, a mid-run join, the staleness-gate contract
  and its grant, and the done broadcast; a member assembles a module
  template's frozen copy from the leaves;
- **trainer**: thread mode over the collective transport at
  ``max_staleness: 0`` gives the serial store bitwise, also when an
  ``actor_crash`` with restarts exhausted shrinks the fleet; the
  collector's ``ValueError``s (``drop_oldest``, an unknown transport or
  mode, process mode without ``root_dir``);
- **process mode**: a learner and two ``run_actor`` processes; one is
  killed by ``actor_crash@collection:1`` and never relaunched, the fleet
  shrinks, the survivor takes its leases and the stores equal thread
  mode's.

The JAX test this mirrors waits on clients' versions and then reads
counters that the coordinator's own threads update a moment later; here
every wait is on the condition itself (acks drained, the counter set), each
with its own limit.
"""

import os
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from trlx_tpu_torch.async_rl.queue import ExperienceChunk, QueueClosed
from trlx_tpu_torch.async_rl.transport import (
    FleetActorClient,
    FleetCoordinator,
    _assemble,
    _decode_delta,
    _encode_delta,
    _host_leaves,
    _leaf_digest,
    read_endpoint,
    tree_parent_slot,
    write_endpoint,
)
from trlx_tpu_torch.models.builder import build_causal_lm
from torch_threads import use_one_cpu_thread

import test_torch_async_rl as async_cases

use_one_cpu_thread()

LIMIT_S = 60.0


class _Metrics:
    def __init__(self):
        self.counts = {}
        self._lock = threading.Lock()

    def inc(self, name, value=1.0):
        with self._lock:
            self.counts[name] = self.counts.get(name, 0.0) + value

    def observe(self, name, value):
        pass


def _until(predicate, limit=LIMIT_S):
    """Poll ``predicate`` until it holds; False after ``limit`` seconds."""
    deadline = time.monotonic() + limit
    pause = threading.Event()
    while not predicate():
        if time.monotonic() > deadline:
            return False
        pause.wait(0.01)
    return True


# ---------------------------------------------------------------------------
# fabric units
# ---------------------------------------------------------------------------


def test_tree_layout():
    # fanout 2: slots 0, 1 hang off the root; 2, 3 relay through slot 0
    assert [tree_parent_slot(s, 2) for s in range(5)] == [None, None, 0, 0, 1]
    # fanout 1 is a chain: every hop relays
    assert [tree_parent_slot(s, 1) for s in range(3)] == [None, 0, 1]


def test_delta_roundtrip_bit_exact():
    leaves = [
        (0, torch.arange(6, dtype=torch.float32).reshape(2, 3)),
        (3, torch.tensor([1.5, -2.25, 3.0e-3], dtype=torch.bfloat16)),
        (5, np.asarray(7, np.int64)),
        (6, torch.zeros(0)),
    ]
    out = _decode_delta(_encode_delta(leaves))
    assert [i for i, _ in out] == [0, 3, 5, 6]
    for (_, a), (_, b) in zip(leaves, out):
        assert a.dtype == b.dtype
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            np.testing.assert_array_equal(a, b)


def test_leaf_digest_sees_bits_dtype_and_shape():
    a = torch.arange(4, dtype=torch.float32)
    assert _leaf_digest(a) == _leaf_digest(a.clone())
    assert _leaf_digest(a) != _leaf_digest(a.to(torch.bfloat16))
    assert _leaf_digest(a) != _leaf_digest(a.reshape(2, 2))
    b = a.clone()
    b[3] = float(np.nextafter(np.float32(3.0), np.float32(4.0)))
    assert _leaf_digest(a) != _leaf_digest(b)
    assert _leaf_digest(np.arange(4.0)) == _leaf_digest(np.arange(4.0))


def test_module_leaves_assemble_into_a_frozen_copy():
    src, _ = build_causal_lm("builtin:gpt2-test", device="cpu", seed=1)
    dst, _ = build_causal_lm("builtin:gpt2-test", device="cpu", seed=2)
    leaves = _host_leaves(src)
    assert len(leaves) == len(src.state_dict())
    copy = _assemble(leaves, dst)
    assert copy is not dst and not copy.training
    for k, v in src.state_dict().items():
        assert torch.equal(copy.state_dict()[k], v), k
    with pytest.raises(ValueError, match="not the same model"):
        _assemble(leaves[:-1], dst)


def test_endpoint_roundtrip_and_timeout(tmp_path):
    with pytest.raises(TimeoutError, match="no fleet endpoint"):
        read_endpoint(str(tmp_path), timeout_s=0.1, poll_interval_s=0.01)
    write_endpoint(str(tmp_path), ("127.0.0.1", 12345), b"\x01\x02")
    address, authkey = read_endpoint(str(tmp_path), timeout_s=1)
    assert address == ("127.0.0.1", 12345)
    assert authkey == b"\x01\x02"


# ---------------------------------------------------------------------------
# fleet integration (loopback, no trainer)
# ---------------------------------------------------------------------------


class TestFleetFabric:
    def test_tree_dissemination_delta_skipping_and_chunks(self):
        metrics = _Metrics()
        coord = FleetCoordinator(fanout=1, capacity=8, metrics=metrics)
        params_a = {
            "w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            # a large leaf no update touches (a frozen layer): it ships in
            # join snapshots and never in a delta
            "frozen": torch.ones(10_000),
        }
        clients = []
        try:
            coord.publish(params_a, version=0, force=True)
            coord.announce(0, 1)
            assert coord.window_stats()["async/publish_bytes"] == 0.0  # nobody joined

            c1 = FleetActorClient(coord.address, coord.authkey, template=params_a)
            clients.append(c1)
            c2 = FleetActorClient(coord.address, coord.authkey, template=params_a)
            clients.append(c2)
            assert (c1.slot, c2.slot) == (0, 1)
            p1, v1 = c1.fetch()
            assert v1 == 0 and torch.equal(p1["w"], params_a["w"])
            join_bytes = coord.window_stats()["async/publish_bytes"]
            assert join_bytes > 0  # two welcome snapshots
            # c2's relay feed attaches to c1 (else the delta below heals
            # through a resync snapshot, which is correct but another path)
            assert _until(lambda: len(c1._children) == 1)

            params_b = {"w": params_a["w"] + 1, "frozen": params_a["frozen"]}
            coord.publish(params_b, version=1)
            assert _until(lambda: c1.fetch()[1] == 1 and c2.fetch()[1] == 1)
            assert torch.equal(c2.fetch()[0]["w"], params_b["w"])
            # both members acked: the publish's latency is measured
            assert _until(lambda: coord.pending_acks() == 0)
            stats = coord.window_stats()
            assert stats["async/fleet_size"] == 2.0
            assert 0 < stats["async/publish_bytes"] < join_bytes / 2
            assert stats["async/dissemination_latency_s"] > 0

            # a lease, then a point-to-point commit, bitwise
            payload = {"tokens": np.arange(4, dtype=np.int32), "nested": {"x": np.full(2, 0.5)}}
            i0 = c2.request_work(timeout=LIMIT_S)
            assert i0 == 0
            c2.put(ExperienceChunk(i0, version=1, payload=payload))
            chunk = coord.get(timeout=LIMIT_S)
            assert (chunk.index, chunk.version) == (0, 1)
            np.testing.assert_array_equal(chunk.payload["tokens"], payload["tokens"])
            np.testing.assert_array_equal(chunk.payload["nested"]["x"], payload["nested"]["x"])

            # c1 leases the next index and dies: the survivor gets it
            leased = c1.request_work(timeout=LIMIT_S)
            assert leased == 1
            clients.remove(c1)
            c1.close(graceful=False)
            assert _until(lambda: metrics.counts.get("async/fleet_shrinks") == 1.0)
            assert coord.fleet_size() == 1
            assert metrics.counts.get("async/requeued_chunks") == 1.0
            assert c2.request_work(timeout=LIMIT_S) == leased

            # a mid-run join bootstraps at the current version
            c3 = FleetActorClient(coord.address, coord.authkey, template=params_a)
            clients.append(c3)
            p3, v3 = c3.fetch()
            assert v3 == 1 and torch.equal(p3["w"], params_b["w"])
            assert coord.fleet_size() == 2
            assert metrics.counts["async/fleet_joins"] == 3.0
        finally:
            coord.close()
            for client in clients:
                client.close()

    def test_staleness_gate_contract_and_grant(self):
        coord = FleetCoordinator(fanout=2, capacity=4)
        params = {"w": torch.zeros(2)}
        client = None
        try:
            coord.publish(params, version=1, force=True)
            client = FleetActorClient(coord.address, coord.authkey, template=params)
            assert not client.ready(0, collection=1)  # nothing announced
            coord.announce(3, collection=1)
            assert _until(lambda: client._target == 3)
            assert not client.ready(1, 1)
            coord.publish(params, version=2)
            assert _until(lambda: client.ready(1, 1))
            assert not client.ready(0, 1)
            coord.publish(params, version=3)
            assert _until(lambda: client.ready(0, 1))
            # a later collection waits for its announcement ...
            assert not client.ready(8, collection=2, index=9)
            # ... unless the learner grants the chunk it drains now
            coord.grant(9)
            assert _until(lambda: client.ready(0, collection=2, index=9))
            assert not client.ready(0, collection=2, index=10)
            # a joiner learns the grant from its welcome
            late = FleetActorClient(coord.address, coord.authkey, template=params)
            try:
                assert late.ready(0, collection=2, index=9)
            finally:
                late.close()
        finally:
            coord.close()
            if client is not None:
                client.close()

    def test_done_broadcast_unblocks_members(self):
        coord = FleetCoordinator(fanout=2, capacity=4)
        coord.publish({"w": torch.zeros(2)}, version=0, force=True)
        client = FleetActorClient(coord.address, coord.authkey, template={"w": torch.zeros(2)})
        try:
            coord.close()
            assert _until(lambda: client.closed)
            assert client.request_work(timeout=1) is None
            assert not client.wait_ready(0, 1)
            with pytest.raises(QueueClosed):
                client.put(ExperienceChunk(0, 0, {"x": np.zeros(1)}))
        finally:
            client.close()

    def test_weight_sync_drop_on_the_fabric(self):
        from trlx_tpu_torch.resilience.faults import FaultPlan

        metrics = _Metrics()
        coord = FleetCoordinator(plan=FaultPlan.parse("weight_sync_drop@version:2"),
                                 metrics=metrics)
        try:
            coord.publish({"w": torch.zeros(2)}, version=1)
            coord.publish({"w": torch.ones(2)}, version=2)  # dropped
            assert coord._version == 1
            assert metrics.counts["async/weight_sync_drops"] == 1.0
            coord.publish({"w": torch.ones(2)}, version=3)
            assert coord._version == 3
        finally:
            coord.close()


# ---------------------------------------------------------------------------
# trainer: thread mode over the collective transport
# ---------------------------------------------------------------------------

_trainer = async_cases._trainer
_small_config = async_cases._small_config
_assert_stores_identical = async_cases._assert_stores_identical
COLLECTIVE = {**async_cases.ASYNC_THREAD, "transport": "collective"}


class TestCollectiveThreadMode:
    def test_max_staleness_zero_bit_identical_to_serial(self, tmp_path):
        """Two members on a fanout-1 chain (one relay hop)."""
        serial = _trainer(_small_config(tmp_path, "serial"))
        asy = _trainer(_small_config(tmp_path, "collective", async_rl={
            **COLLECTIVE, "num_actors": 2, "fanout": 1}))
        try:
            serial.make_experience(16)
            asy.make_experience(16)
            _assert_stores_identical(serial.store, asy.store)
            stats = asy.make_experience_stats
            assert stats["async/staleness_max"] == 0.0
            assert stats["async/chunks"] == 4.0
            assert stats["async/fleet_size"] == 2.0
            assert stats["async/publish_bytes"] > 0  # the join snapshots moved
            assert asy._async.fleet_size() == 2
        finally:
            asy._shutdown_collectors()
            serial._shutdown_collectors()

    def test_actor_crash_shrinks_fleet_still_bit_identical(self, tmp_path):
        """Restarts exhausted (``max_actor_restarts: 0``): the fleet shrinks
        to the survivor, which regenerates the dead member's chunk."""
        serial = _trainer(_small_config(tmp_path, "serial"))
        crash = _trainer(_small_config(
            tmp_path, "shrink", async_rl={**COLLECTIVE, "num_actors": 2,
                                          "max_actor_restarts": 0},
            resilience=dict(fault_plan="actor_crash@collection:1")))
        try:
            serial.make_experience(16)
            crash.make_experience(16)
            _assert_stores_identical(serial.store, crash.store)
            # the survivor may finish the collection before the dead
            # member's thread has left the fleet and been counted
            assert _until(lambda: crash.metrics.counter("async/fleet_shrinks") == 1.0)
            assert _until(lambda: crash._async.fleet_size() == 1)
            assert crash.metrics.counter("async/requeued_chunks") >= 1.0
            assert not crash.metrics.counter("async/actor_restarts")
        finally:
            crash._shutdown_collectors()
            serial._shutdown_collectors()

    @pytest.mark.parametrize("async_rl,match", [
        ({**COLLECTIVE, "queue_policy": "drop_oldest"}, "drop_oldest"),
        ({**COLLECTIVE, "transport": "carrier-pigeon"}, "carrier-pigeon"),
        ({**COLLECTIVE, "mode": "fork"}, "async_rl.mode 'fork'"),
        ({**COLLECTIVE, "mode": "process"}, "root_dir"),
        ({**async_cases.ASYNC_THREAD, "mode": "process"}, "root_dir"),
    ])
    def test_collector_settings_rejected(self, tmp_path, async_rl, match):
        trainer = _trainer(_small_config(tmp_path, "reject", async_rl=async_rl))
        try:
            with pytest.raises(ValueError, match=match):
                trainer._ensure_async_collector()
        finally:
            trainer._shutdown_collectors()


# ---------------------------------------------------------------------------
# process mode: a learner and two run_actor processes, one killed
# ---------------------------------------------------------------------------

# the learner: the same async run with actor threads first (its stores are
# the reference), then the process-mode run on the collective fabric
LEARNER_WORKER = async_cases._COMMON + textwrap.dedent(
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

    config = base_config({ckpt!r}, transport="collective")
    _, thread_hashes, _ = run(config.evolve(
        train=dict(checkpoint_dir={ckpt!r} + "_thread"), async_rl=dict(mode="thread")))
    trainer, hashes, stats = run(config)
    assert hashes == thread_hashes, "the process-mode stores diverged from thread mode's"
    assert [s["async/staleness_max"] for s in stats] == [0.0, 0.0], stats
    snap = trainer.obs.metrics.snapshot(reset_histograms=False)
    assert snap.get("async/fleet_shrinks", 0) >= 1, snap
    assert snap.get("async/fleet_joins", 0) >= 2, snap
    print("LEARNER_OK", [s["async/fleet_size"] for s in stats], flush=True)
    """
)


def test_process_mode_fleet_shrinks_on_actor_kill(tmp_path):
    root = str(tmp_path / "fleet")
    os.makedirs(root, exist_ok=True)
    fmt = dict(repo=async_cases.REPO, tests=os.path.join(async_cases.REPO, "tests"), root=root,
               ckpt=str(tmp_path / "ckpt"), transport="collective")
    names = ("learner", "doomed", "survivor")
    logs = {n: open(tmp_path / f"{n}.log", "w") for n in names}
    procs = {"learner": async_cases._spawn(LEARNER_WORKER, logs["learner"], **fmt)}
    try:
        procs["doomed"] = async_cases._spawn(async_cases.ACTOR_WORKER, logs["doomed"],
                                             fault="actor_crash@collection:1", **fmt)
        procs["survivor"] = async_cases._spawn(async_cases.ACTOR_WORKER, logs["survivor"],
                                               fault=None, **fmt)
        rcs = {n: procs[n].wait(300) for n in ("doomed", "learner", "survivor")}
    finally:
        async_cases._finish(list(procs.values()))
        for log in logs.values():
            log.close()
    out = {n: (tmp_path / f"{n}.log").read_text() for n in names}
    assert rcs["doomed"] != 0 and "actor_crash@collection:1" in out["doomed"], out["doomed"][-2000:]
    assert rcs["learner"] == 0 and "LEARNER_OK" in out["learner"], out["learner"][-3000:]
    assert rcs["survivor"] == 0 and "ACTOR_DONE" in out["survivor"], out["survivor"][-2000:]
