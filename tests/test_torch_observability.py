"""The port's run observability (``trlx_tpu_torch/observability/``)
against the JAX package's, on the CPU, class by class on the same inputs:

- :class:`Tracer`: nesting, the drop counter, named tracks, complete and
  instant events, both exports (the same records but for timestamps and
  thread ids), and the CUDA fence (a no-op on CPU tensors);
- :class:`MetricsRegistry`: counters, gauges, histograms and the write
  listeners give the same snapshots and the same listener calls;
- :class:`ThroughputMeter`, ``mfu`` and ``device_peak_flops``: equal on the
  same inputs; ``train_step_flops`` counts a matmul as XLA's
  ``cost_analysis`` does, and a hand-written kernel's wrapper once (its
  formula, which is ``FlopCounterMode``'s count of the same attention);
- the watchdogs: the same new-signature counts as JAX's signature branch,
  the same memory keys on the CPU;
- :class:`FlightRecorder`: the same ring and dump schema;
- :class:`ClusterTelemetry`: the same ``cluster/*`` gauges, straggler rank
  and :class:`ClusterDesyncError` on the same gathered matrices; the same
  clock offsets;
- ``merge_cluster_trace``: the same merged document from the same rank
  files;
- the :class:`Observability` bundle: export, the flight-record dump and
  the dropped-span gauge;
- the paged engine's trace on the same waves as JAX's
  ``ContinuousEngine`` (whole and chunked prefill, prefix hits): the same
  ``rollout/segment`` spans and per-request ``engine/*`` events with the
  same arguments on the same slot tracks; under speculation each request's
  ``engine/spec_verify`` event spans its decode with JAX's arguments;
- two gloo ranks on the CPU (``tests/torch_cluster_worker.py``, under its
  own time limit): the real ``all_gather`` beat flags the slow rank, the
  merged trace holds both ranks, a desynced step raises on both.

Exact equality unless stated.
"""

import json
import os
import socket
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from trlx_tpu.observability import FlightRecorder as JaxFlightRecorder
from trlx_tpu.observability import MetricsRegistry as JaxMetricsRegistry
from trlx_tpu.observability import Observability as JaxObservability
from trlx_tpu.observability import RecompileWatchdog as JaxRecompileWatchdog
from trlx_tpu.observability import ThroughputMeter as JaxThroughputMeter
from trlx_tpu.observability import Tracer as JaxTracer
from trlx_tpu.observability import device_peak_flops as jax_device_peak_flops
from trlx_tpu.observability import mfu as jax_mfu
from trlx_tpu.observability import train_step_flops as jax_train_step_flops
from trlx_tpu.observability import distributed as jax_distributed
from trlx_tpu.observability.flightrec import _jsonable as jax_jsonable
from trlx_tpu.observability.watchdogs import DeviceMemoryGauge as JaxDeviceMemoryGauge
from trlx_tpu_torch.observability import (
    DEFAULT_PEAK_FLOPS,
    ClusterDesyncError,
    ClusterTelemetry,
    DeviceMemoryGauge,
    FlightRecorder,
    MetricsRegistry,
    Observability,
    RecompileWatchdog,
    ThroughputMeter,
    Tracer,
    device_peak_flops,
    mfu,
    train_step_flops,
)
from tests.test_torch_prefix_cache import (  # noqa: F401 — the vlm fixture
    feed,
    jax_engine,
    port_engine,
    shared_prefix_stream,
    vlm,
)
from trlx_tpu_torch.observability import distributed
from trlx_tpu_torch.observability.flightrec import _jsonable
from trlx_tpu_torch.observability.metrics import GPU_PEAK_FLOPS
from trlx_tpu_torch.ops.flash_attention import flash_attention
from trlx_tpu_torch.ops.kernel_utils import attention_flops
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

HERE = os.path.dirname(os.path.abspath(__file__))


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------


def _drive_tracer(tracer):
    """One script of spans, tracks and instants on a tracer of either
    package."""
    with tracer.span("rollout", pipelined=True):
        with tracer.span("generate", eval_mode=False):
            with tracer.span("inner"):
                pass
        tracer.instant("mark", k=1)
    tracer.alias_current_thread("rollout pipeline worker")
    with tracer.span("rollout/overlap"):
        with tracer.span("score"):
            with tracer.span("reward"):
                pass
    tracer.add_complete_event("engine/prefill", 1.0, 2.5, track="engine/slot3", index=7)
    tracer.add_complete_event("engine/decode", 2.5, 2.0, track="engine/slot3", index=7)
    try:
        with tracer.span("train_step"):
            raise RuntimeError("boom")
    except RuntimeError:
        pass


def _shape(events):
    """Events without their timestamps and thread ids (the per-process
    parts)."""
    out = []
    for e in events:
        rec = {k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
        out.append(rec)
    return out


def _nesting(events):
    """(name, parent name) by containment on one track."""
    pairs = []
    xs = [e for e in events if e.get("ph") == "X"]
    for e in xs:
        parents = [p for p in xs if p is not e and p["tid"] == e["tid"]
                   and p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]]
        parent = min(parents, key=lambda p: p["dur"])["name"] if parents else None
        pairs.append((e["name"], parent))
    return sorted(pairs, key=str)


@pytest.fixture
def traced():
    port, jax_ = Tracer(), JaxTracer()
    _drive_tracer(port)
    _drive_tracer(jax_)
    return port, jax_


def test_tracer_records_the_same_events_and_nesting(traced):
    port, jax_ = traced
    assert _shape(port.events()) == _shape(jax_.events())
    assert _nesting(port.events()) == _nesting(jax_.events())
    # the explicit-endpoint events: the same durations (the epoch differs)
    ours = [e for e in port.events() if e["name"].startswith("engine/")]
    theirs = [e for e in jax_.events() if e["name"].startswith("engine/")]
    assert [e["dur"] for e in ours] == [e["dur"] for e in theirs] == [1.5e6, 0.0]
    # the aliased track ids are the same crc of the alias
    assert ({e["tid"] for e in port.events() if e["name"] == "thread_name"}
            == {e["tid"] for e in jax_.events() if e["name"] == "thread_name"})
    for name in ("inner", "generate", "train_step"):
        assert port.last_duration(name) > 0.0
    assert port.last_duration("absent", 3.0) == jax_.last_duration("absent", 3.0) == 3.0


def test_tracer_exports_match(traced, tmp_path):
    port, jax_ = traced
    p = port.export_jsonl(str(tmp_path / "port" / "spans.jsonl"))
    j = jax_.export_jsonl(str(tmp_path / "jax" / "spans.jsonl"))
    ours = [json.loads(line) for line in open(p)]
    theirs = [json.loads(line) for line in open(j)]
    strip = lambda rs: [{k: v for k, v in r.items() if k not in ("start_s", "dur_s", "tid")}
                        for r in rs]  # noqa: E731
    assert strip(ours) == strip(theirs)
    assert [r["dur_s"] for r in ours if r["name"].startswith("engine/")] == [1.5, 0.0]
    pc = json.load(open(port.export_chrome_trace(str(tmp_path / "port" / "trace.json"))))
    jc = json.load(open(jax_.export_chrome_trace(str(tmp_path / "jax" / "trace.json"))))
    assert set(pc) == set(jc) == {"traceEvents", "displayTimeUnit"}
    assert _shape(pc["traceEvents"]) == _shape(jc["traceEvents"])


@pytest.mark.parametrize("cap", [0, 3, 7])
def test_tracer_drop_counter_and_listeners(cap):
    seen = {"port": [], "jax": []}
    port, jax_ = Tracer(max_events=cap), JaxTracer(max_events=cap)
    port.add_listener(lambda e: seen["port"].append(e["name"]))
    jax_.add_listener(lambda e: seen["jax"].append(e["name"]))
    for t in (port, jax_):
        for i in range(5):
            with t.span(f"s{i}"):
                pass
        t.instant("i")
    assert port.dropped == jax_.dropped == max(6 - cap, 0)
    assert seen["port"] == seen["jax"]  # listeners see the dropped events too
    assert [e["name"] for e in port.events()] == [e["name"] for e in jax_.events()]
    assert port.to_chrome_trace().get("dropped_events") == jax_.to_chrome_trace().get(
        "dropped_events")
    port.clear()
    assert port.events() == [] and port.dropped == 0


def test_disabled_tracer_records_nothing():
    port, jax_ = Tracer(enabled=False), JaxTracer(enabled=False)
    for t in (port, jax_):
        _drive_tracer(t)
    assert port.events() == jax_.events() == []
    assert port.last_duration("rollout") > 0.0  # durations are still kept


def test_fence_on_cpu_tensors_and_callables_is_a_noop_wait():
    t = Tracer()
    x = torch.ones(4)
    with t.span("a") as sp:
        sp.fence((x, {"y": x * 2}))
    with t.span("b", fence=lambda: [x]) as sp2:
        pass
    assert sp.duration > 0.0 and sp2.duration > 0.0
    assert [e["name"] for e in t.events()] == ["a", "b"]


# ---------------------------------------------------------------------------
# metrics, throughput, MFU, FLOPs
# ---------------------------------------------------------------------------


def _drive_registry(reg, calls):
    reg.add_listener(lambda op, name, value: calls.append((op, name, value)))
    reg.inc("resilience/reward_retries")
    reg.inc("resilience/reward_retries", 2.0)
    reg.set_gauge("memory/device_bytes_in_use", 7)
    for v in (0.5, 2.0, 1.5):
        reg.observe("time/decode", v)
    first = reg.snapshot(reset_histograms=False)
    second = reg.snapshot()
    third = reg.snapshot()
    return first, second, third, reg.counter("resilience/reward_retries")


def test_registry_histograms_and_listeners_match_jax():
    calls_p, calls_j = [], []
    assert _drive_registry(MetricsRegistry(), calls_p) == _drive_registry(
        JaxMetricsRegistry(), calls_j)
    assert calls_p == calls_j
    first, second, third, _ = _drive_registry(MetricsRegistry(), [])
    assert first["time/decode_count"] == second["time/decode_count"] == 3.0
    assert "time/decode_mean" not in third  # the window reset


def test_a_failing_listener_never_breaks_recording():
    reg = MetricsRegistry()
    reg.add_listener(lambda *a: 1 / 0)
    assert reg.inc("a/b") == 1.0
    t = Tracer()
    t.add_listener(lambda e: 1 / 0)
    with t.span("x"):
        pass
    assert len(t.events()) == 1


@pytest.mark.parametrize("args", [
    (2e12, 0.5, 1e12), (1.0, 0.0, 1e12), (1e9, 0.01, 0.0), (3.3e11, 0.04, 989.4e12)])
def test_mfu_matches_jax(args):
    assert mfu(*args) == jax_mfu(*args)


def test_throughput_meter_matches_jax():
    port, jax_ = ThroughputMeter(peak_flops_per_device=5e11), JaxThroughputMeter(5e11)
    for step_s, tokens, samples, flops in ((0.1, 640, 16, None), (0.05, 700, 16, 2e10),
                                           (0.0, 10, 1, 1e9), (0.2, 0, 0, 3e10)):
        assert port.step_stats(step_s, tokens, samples, flops) == jax_.step_stats(
            step_s, tokens, samples, flops)
    assert port.summary() == jax_.summary()
    assert ThroughputMeter().summary() == JaxThroughputMeter().summary() == {}


def test_device_peak_flops(monkeypatch):
    monkeypatch.delenv("TRLX_TPU_PEAK_FLOPS", raising=False)
    assert device_peak_flops("cpu") == DEFAULT_PEAK_FLOPS == 1e12
    if not torch.cuda.is_available():
        assert device_peak_flops() == jax_device_peak_flops() == DEFAULT_PEAK_FLOPS
    assert GPU_PEAK_FLOPS["h100 80gb hbm3"] == 989.4e12
    monkeypatch.setenv("TRLX_TPU_PEAK_FLOPS", "123.5")
    assert device_peak_flops() == jax_device_peak_flops() == 123.5
    assert ThroughputMeter().peak == JaxThroughputMeter().peak == 123.5


def test_train_step_flops_counts_a_matmul_as_xla_does():
    import jax
    import jax.numpy as jnp

    rs = np.random.RandomState(0)
    a, b = rs.randn(8, 16).astype(np.float32), rs.randn(16, 4).astype(np.float32)
    want = jax_train_step_flops(jax.jit(lambda x, y: jnp.dot(x, y)), jnp.asarray(a),
                                jnp.asarray(b))
    out, got = train_step_flops(torch.matmul, torch.tensor(a), torch.tensor(b))
    assert got == want == 2 * 8 * 16 * 4
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-6)


def test_train_step_flops_disabled_by_env(monkeypatch):
    monkeypatch.setenv("TRLX_TPU_MFU", "0")
    out, flops = train_step_flops(lambda x: x + 1, torch.ones(2))
    assert flops is None and out.tolist() == [2.0, 2.0]
    monkeypatch.delenv("TRLX_TPU_MFU")
    assert train_step_flops(lambda x: x + 1, torch.ones(2))[1] is None  # nothing counted


@pytest.mark.parametrize("shape", [(2, 6, 6, 4, 2, 8), (1, 5, 9, 2, 2, 16)])
def test_kernel_wrapper_counts_once_by_its_formula(shape):
    """The flash wrapper on CPU tensors runs its plain version outside the
    counter and notes its formula, which equals FlopCounterMode's formula
    for scaled_dot_product_attention's forward and backward at the same
    shapes."""
    B, T, S, H, KV, D = shape
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, T, H, D, generator=g, requires_grad=True)
    k = torch.randn(B, S, KV, D, generator=g, requires_grad=True)
    v = torch.randn(B, S, KV, D, generator=g, requires_grad=True)
    key_mask = torch.ones(B, S)

    def step():
        out = flash_attention(q, k, v, key_mask, causal=False, q_offset=0)
        out.float().sum().backward()
        return out

    _, flops = train_step_flops(step)
    assert flops == attention_flops(B, T, S, H, D) + attention_flops(B, T, S, H, D,
                                                                      backward=True)
    from torch.utils.flop_counter import sdpa_backward_flop_count, sdpa_flop_count

    qs, ks = (B, H, T, D), (B, H, S, D)
    assert flops == sdpa_flop_count(qs, ks, ks) + sdpa_backward_flop_count(qs, qs, ks, ks)


# ---------------------------------------------------------------------------
# watchdogs
# ---------------------------------------------------------------------------


def test_recompile_watchdog_matches_jax_signature_branch():
    reg_p, reg_j = MetricsRegistry(), JaxMetricsRegistry()
    port, jax_ = RecompileWatchdog(reg_p, max_warnings=2), JaxRecompileWatchdog(reg_j,
                                                                               max_warnings=2)

    def fn():  # no _cache_size: JAX takes its signature branch
        pass

    def other():
        pass

    seq = [((4, 8),), ((4, 8),), ((4, 9),), ((4, 8),), ((5, 8),), ((6, 8),)]
    for shapes in seq:
        args = {"x": np.zeros(shapes[0], np.float32), "m": np.ones((2,), np.int32)}
        assert port.observe("train_step", fn, args) == jax_.observe("train_step", fn, args)
        assert port.observe("generate", other, args) == jax_.observe("generate", other, args)
    assert port.observe("train_step", fn) == jax_.observe("train_step", fn) == 0
    assert reg_p.snapshot() == reg_j.snapshot() == {"recompile/train_step": 3.0,
                                                    "recompile/generate": 3.0}
    assert port.excess_compiles("train_step") == jax_.excess_compiles("train_step") == 3
    assert port._warnings == 2  # capped
    # a second program under one name does not count as a drift of the first
    assert port.observe("train_step", other, {"x": np.zeros((9, 9))}) == 0


def test_memory_gauge_on_the_cpu_reads_host_rss():
    reg = MetricsRegistry()
    got = DeviceMemoryGauge(reg, device="cpu").collect()
    want = JaxDeviceMemoryGauge().collect()
    assert set(got) == set(want) == {"memory/host_rss_bytes"}
    assert got["memory/host_rss_bytes"] > 0
    assert reg.snapshot() == got


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------


def _drive_recorder(rec, tracer, reg):
    tracer.add_listener(rec.span_listener)
    reg.add_listener(rec.metric_listener)
    for i in range(5):
        with tracer.span("train_step", i=i):
            reg.inc("resilience/skipped_updates")
        rec.record("step", {"iter": i, "stats": {"a/b": np.float32(i), "arr": np.zeros(3)}})
    tracer.alias_current_thread("worker")  # a track label: not recorded
    rec.record("resilience", {"event": "rollback", "step": 4})


def _strip(records):
    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k != "t"}
        if r["kind"] == "span":
            r["data"] = {k: v for k, v in r["data"].items() if k not in ("ts_s", "dur_s", "tid")}
        out.append(r)
    return out


@pytest.mark.parametrize("capacity", [4, 512])
def test_flight_recorder_ring_and_dump_match_jax(tmp_path, capacity):
    port, jax_ = FlightRecorder(capacity), JaxFlightRecorder(capacity)
    _drive_recorder(port, Tracer(), MetricsRegistry())
    _drive_recorder(jax_, JaxTracer(), JaxMetricsRegistry())
    assert _strip(port.snapshot()) == _strip(jax_.snapshot())
    assert port.recorded == jax_.recorded == 16
    docs = []
    for rec, name in ((port, "port"), (jax_, "jax")):
        path = rec.dump(str(tmp_path / name / "flightrec.json"), reason="test",
                        extra={"x": np.int64(3)})
        docs.append(json.load(open(path)))
    assert set(docs[0]) == set(docs[1])
    for key in ("format", "reason", "capacity", "recorded_total", "dump_number", "x"):
        assert docs[0][key] == docs[1][key]
    assert _strip(docs[0]["records"]) == _strip(docs[1]["records"])


@pytest.mark.parametrize("value", [
    None, 3, 2.5, "s", [1, (2, 3)], {"a": {1: 2}}, np.float32(1.5), np.int64(4),
    np.zeros((2, 3), np.float32), np.array(7.0)])
def test_jsonable_matches_jax(value):
    assert _jsonable(value) == jax_jsonable(value)


def test_jsonable_takes_torch_tensors():
    assert _jsonable(torch.tensor(2.5)) == 2.5
    assert _jsonable(torch.zeros(2, 3)) == "<array shape=(2, 3) dtype=torch.float32>"


# ---------------------------------------------------------------------------
# cluster telemetry and merged traces
# ---------------------------------------------------------------------------


def _matrix(rows):
    base = {"preempt": 0.0, "step": 0.0, "step_time_s": 0.1, "host_wait_s": 0.0,
            "tokens_per_sec": 100.0, "device_bytes": 1e6, "clock_s": 10.0,
            "clock_hi_s": 0.0, "fleet_size": -1.0}
    return np.asarray([[float({**base, **r}[f]) for f in distributed.PACK_FIELDS]
                       for r in rows], np.float32)


def _pair(matrices, **kwargs):
    """A port and a JAX ClusterTelemetry fed the same gathered matrices."""
    out = []
    for mod, reg, tracer, rec in ((distributed, MetricsRegistry(), Tracer(), FlightRecorder()),
                                  (jax_distributed, JaxMetricsRegistry(), JaxTracer(),
                                   JaxFlightRecorder())):
        it = iter(matrices)
        cluster = mod.ClusterTelemetry(tracer, reg, flightrec=rec,
                                       allgather=lambda vec, it=it: next(it),
                                       enabled=True, **kwargs)
        out.append((cluster, reg, rec))
    return out


STREAMS = {
    "steady": [_matrix([{"step": s}, {"step": s}]) for s in range(3)],
    "straggler": [_matrix([{"step": s, "step_time_s": 0.1},
                           {"step": s, "step_time_s": 0.9, "clock_s": 7.5}])
                  for s in range(3)],
    "recovers": [_matrix([{"step": 0}, {"step": 0, "step_time_s": 0.9}]),
                 _matrix([{"step": 1}, {"step": 1, "step_time_s": 0.9}]),
                 _matrix([{"step": 2}, {"step": 2}])],
    "three_ranks_fleet": [_matrix([{"step": s, "fleet_size": 4.0}, {"step": s},
                                   {"step": s, "step_time_s": 0.12, "tokens_per_sec": 50.0}])
                          for s in range(2)],
    "preempt_flag": [_matrix([{"preempt": 0.0}, {"preempt": 1.0}])],
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_cluster_telemetry_matches_jax(stream):
    (pc, preg, prec), (jc, jreg, jrec) = _pair(STREAMS[stream], straggler_patience=2)
    for step, _ in enumerate(STREAMS[stream]):
        assert pc.beat(False, step=step) == jc.beat(False, step=step)
        assert preg.snapshot() == jreg.snapshot()
        assert pc.straggler_rank == jc.straggler_rank
    assert pc.clock_offsets() == jc.clock_offsets()
    assert ([(r["kind"], r.get("data")) for r in prec.snapshot()]
            == [(r["kind"], r.get("data")) for r in jrec.snapshot()])
    if stream == "straggler":
        assert pc.straggler_rank == 1 and pc.clock_offsets()[1] == 2.5


def test_cluster_desync_raises_as_jax():
    (pc, _, prec), (jc, _, jrec) = _pair([_matrix([{"step": 3}, {"step": 7}])] * 2)
    with pytest.raises(ClusterDesyncError, match="rank 1: step 7") as ours:
        pc.beat(False, step=3)
    with pytest.raises(jax_distributed.ClusterDesyncError) as theirs:
        jc.beat(False, step=3)
    assert str(ours.value).split(" — ")[0] == str(theirs.value).split(" — ")[0]
    assert [r.get("data") for r in prec.snapshot()] == [r.get("data") for r in jrec.snapshot()]


def test_single_process_beat_and_disabled_beat():
    reg = MetricsRegistry()
    cluster = ClusterTelemetry(Tracer(), reg, enabled=True)
    cluster.note_step(0.2, tokens_per_sec=100.0, device_bytes=1e6)
    assert cluster.beat(False, step=0) is False
    snap = reg.snapshot()
    assert snap["cluster/size"] == 1.0 and snap["cluster/straggler_rank"] == -1.0
    np.testing.assert_allclose(snap["cluster/step_time_max_s"], 0.2, rtol=1e-6)
    off = MetricsRegistry()
    assert ClusterTelemetry(Tracer(), off, enabled=False).beat(True, step=0, collective=False)
    assert off.snapshot() == {}


def _rank_files(directory, rank_events):
    for rank, events in rank_events.items():
        with open(os.path.join(directory, f"trace_rank{rank}.json"), "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


def test_merge_cluster_trace_matches_jax(tmp_path):
    peers = {1: [{"name": "train_step", "ph": "X", "ts": 100.0, "dur": 50.0, "pid": 1,
                  "tid": 7}],
             3: [{"name": "rollout", "ph": "X", "ts": 5.0, "dur": 1.0, "pid": 3, "tid": 2},
                 {"name": "thread_name", "ph": "M", "pid": 3, "tid": 2,
                  "args": {"name": "w"}}]}
    docs = []
    for mod, tracer, name in ((distributed, Tracer(), "port"),
                              (jax_distributed, JaxTracer(), "jax")):
        d = tmp_path / name
        d.mkdir()
        _rank_files(str(d), peers)
        tracer._epoch = 0.0
        tracer.add_complete_event("train_step", 1.0, 2.0)
        out = mod.merge_cluster_trace(tracer, str(d), process_count=4,
                                      offsets={1: 0.5, 3: -0.25}, timeout_s=0.0)
        docs.append(json.load(open(out)))
    for doc in docs:
        for e in doc["traceEvents"]:
            e.pop("tid", None)
    assert docs[0] == docs[1]
    assert docs[0]["missing_ranks"] == [2]


def test_write_rank_trace_round_trips(tmp_path):
    t = Tracer()
    with t.span("x"):
        pass
    path = distributed.write_rank_trace(t, str(tmp_path), 2)
    assert os.path.basename(path) == "trace_rank2.json"
    assert json.load(open(path))["traceEvents"] == t.events()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_beat_and_merge(tmp_path):
    """Two processes in one gloo group: rank 1 reports 0.9 s steps against
    rank 0's 0.1 s (injected, no sleep), so the real all_gather beat flags
    it after two boundaries on both ranks; rank 0 merges both ranks'
    spans into one trace after a barrier (no polling); a desynced step
    raises ClusterDesyncError on both."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_cluster_worker.py"), str(rank), "2",
         str(port), str(tmp_path)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r in results:
        assert r["straggler_by_beat"] == [-1, 1, 1]
        assert r["snapshot"]["cluster/size"] == 2.0
        np.testing.assert_allclose(r["snapshot"]["cluster/step_skew_s"], 0.8, rtol=1e-6)
        assert r["desync"].startswith("per-rank step counters diverged")
    assert results[0]["exported"] and not results[1]["exported"]
    doc = json.load(open(tmp_path / "trace.json"))
    assert {e["pid"] for e in doc["traceEvents"] if e["ph"] == "X"} == {0, 1}
    assert "missing_ranks" not in doc and set(doc["clock_offsets_s"]) == {"0", "1"}
    spans = [json.loads(line) for line in open(tmp_path / "spans.jsonl")]
    assert [s["name"] for s in spans] == ["train_step"] * 3


# ---------------------------------------------------------------------------
# the engine's trace
# ---------------------------------------------------------------------------


def _trace_summary(tracer):
    """Events by (name, track label or None, args), counted."""
    labels = {e["tid"]: e["args"]["name"] for e in tracer.events() if e["name"] == "thread_name"}
    return Counter((e["name"], labels.get(e["tid"]), tuple(sorted(e.get("args", {}).items())))
                   for e in tracer.events() if e["ph"] != "M")


@pytest.mark.parametrize("chunk", [0, 4])
def test_engine_trace_matches_jax(vlm, chunk):
    prompts, masks = shared_prefix_stream()
    waves = [range(0, 4), range(4, 8)]
    port_tracer, jax_tracer = Tracer(), JaxTracer()
    port = port_engine(vlm, chunk=chunk, span=port_tracer.span, tracer=port_tracer)
    jax_side = jax_engine(vlm, chunk=chunk)
    jax_side._span, jax_side._tracer = jax_tracer.span, jax_tracer
    feed(port, prompts, masks, waves, False)
    feed(jax_side, prompts, masks, waves, True)
    got, want = _trace_summary(port_tracer), _trace_summary(jax_tracer)
    assert got == want
    names = Counter(name for name, _, _ in got.elements())
    assert names["rollout/segment"] == port.stats.segments
    for name in ("engine/queue_wait", "engine/prefill", "engine/decode"):
        assert names[name] == len(prompts)
    assert (names["engine/prefill_chunk"] > 0) == bool(chunk)


def test_speculative_engine_emits_spec_verify():
    from tests.test_torch_speculative import spec_models
    from trlx_tpu_torch.engine.core import ContinuousEngine
    from trlx_tpu_torch.ops.paged_kv import PagedSpec, num_table_blocks
    from trlx_tpu_torch.ops.sampling import GenerationConfig
    from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns

    _, target, draft, tcfg = spec_models()
    B, P, N, G, pad = 2, 12, 8, 3, 258
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 250, (5, P)).astype(np.int32)
    mask = np.ones_like(ids)
    fns = make_slot_refill_fns(
        tcfg, B, P, GenerationConfig(max_new_tokens=N, do_sample=False, pad_token_id=pad),
        segment_len=2, paged=PagedSpec(4, 1 + 3 * B * num_table_blocks(P + N + G, 4)),
        speculative=G, draft_cfg=tcfg, device="cpu")
    tracer = Tracer()
    engine = ContinuousEngine(fns, (target, draft), pad, span=tracer.span, tracer=tracer)
    engine.enqueue_prompts(ids, mask, np.arange(5))
    done = {c.index: c for c in engine.run()}
    events = [e for e in tracer.events() if e["ph"] == "X"]
    verify = {e["args"]["index"]: e for e in events if e["name"] == "engine/spec_verify"}
    decode = {e["args"]["index"]: e for e in events if e["name"] == "engine/decode"}
    assert sorted(verify) == sorted(decode) == sorted(done)
    for i, e in verify.items():
        assert e["args"] == {"index": i, "gamma": G, "tokens": float(done[i].mask.sum())}
        assert (e["ts"], e["dur"], e["tid"]) == (decode[i]["ts"], decode[i]["dur"],
                                                 decode[i]["tid"])
    assert sum(e["name"] == "rollout/segment" for e in events) == engine.stats.segments


# ---------------------------------------------------------------------------
# the bundle
# ---------------------------------------------------------------------------


class _Cfg:
    class train:
        logging_dir = None
        checkpoint_dir = None

    class method:
        cliprange = 0.2
        target = 6.0


def test_bundle_wiring_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("TRLX_TPU_TRACE_DIR", raising=False)
    cfg = _Cfg()
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    port, jax_ = Observability(cfg), JaxObservability(cfg)
    assert port._trace_dir == jax_._trace_dir == os.path.join(str(tmp_path / "ckpt"), "logs")
    assert port.dynamics.cliprange == jax_.dynamics.cliprange == 0.2
    assert port.health.kl_target == jax_.health.kl_target == 6.0
    assert port.flightrec.capacity == jax_.flightrec.capacity == 512
    for obs in (port, jax_):
        with obs.span("train_step"):
            obs.metrics.inc("resilience/skipped_updates")
    paths = port.export()
    assert sorted(paths) == ["spans", "trace"] and os.path.exists(paths["trace"])
    assert port.dump_flight_record("why") == os.path.join(port._trace_dir, "flightrec.json")
    snap = port.metrics.snapshot()
    assert snap["flightrec/dumps"] == 1.0 and snap["flightrec/records"] == 3.0
    doc = json.load(open(os.path.join(port._trace_dir, "flightrec.json")))
    assert doc["reason"] == "why" and [r["kind"] for r in doc["records"]] == [
        "metric", "span", "metric"][:len(doc["records"])]
    assert Observability().export() == {} and Observability().dump_flight_record("x") is None


def test_trace_dir_env_and_flightrec_cap(tmp_path, monkeypatch):
    monkeypatch.setenv("TRLX_TPU_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("TRLX_TPU_FLIGHTREC_CAP", "16")
    port, jax_ = Observability(_Cfg()), JaxObservability(_Cfg())
    assert port._trace_dir == jax_._trace_dir == str(tmp_path)
    assert port.flightrec.capacity == jax_.flightrec.capacity == 16


def test_dropped_spans_gauge():
    port, jax_ = Observability(), JaxObservability()
    for obs in (port, jax_):
        obs.tracer.max_events = 1
        for _ in range(3):
            with obs.span("x"):
                pass
        obs.note_dropped_spans()
    assert port.metrics.snapshot()["obs/spans_dropped"] == jax_.metrics.snapshot()[
        "obs/spans_dropped"] == 2.0
