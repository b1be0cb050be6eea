"""The port's serving frontend (``trlx_tpu_torch/serve``) on the paged engine:
requests through ``ServeServer.submit`` and over HTTP (unary POST, SSE
streaming, metrics, drain). Greedy responses equal the JAX package's
solo ``generate``; every serve thread is joined (the conftest
leaked-thread sentinel checks it)."""

import copy
import http.client
import json
import threading

import numpy as np
import pytest

from tests.test_torch_engine import (  # noqa: F401 — fixtures
    B,
    N,
    P,
    PAD,
    _boost_torch,
    _gen_config,
    _prompt_set,
    jax_reference,
    lm,
)
from trlx_tpu_torch.engine.core import ContinuousEngine
from trlx_tpu_torch.ops.paged_kv import PagedSpec, num_table_blocks
from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns
from trlx_tpu_torch.serve.request import ServeRequest
from trlx_tpu_torch.serve.scheduler import AdmissionController
from trlx_tpu_torch.serve.server import ServeServer
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()


def _server(lm, **kw):
    _, _, model, tcfg = lm
    paged = PagedSpec(4, 1 + 2 * B * num_table_blocks(P + N, 4) + 4)
    fns = make_slot_refill_fns(tcfg, B, P, _gen_config(do_sample=True),
                               adjust_logits=_boost_torch, segment_len=3,
                               paged=paged, device="cpu")
    return ServeServer(ContinuousEngine(fns, model, PAD), **kw)


def _masked(tokens, mask, i):
    return tokens[i][mask[i] == 1].tolist()


def _serve_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("trlx-serve") and t.is_alive()]


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_submit_greedy_matches_jax(lm, jax_reference):
    tokens, mask, _ = jax_reference
    prompts, masks = _prompt_set()
    server = _server(lm)
    server.start()
    try:
        reqs = []
        for i in range(len(prompts)):
            req, rejection = server.submit(prompts[i], masks[i], seed=i, greedy=True)
            assert rejection is None
            reqs.append(req)
        for i, req in enumerate(reqs):
            assert req.wait_done(timeout=60) == "DONE"
            assert req.result_tokens.tolist() == _masked(tokens, mask, i)
        m = server.flat_metrics()
        assert m["serve/completed"] == len(prompts) and m["serve/active"] == 0
    finally:
        assert server.drain(timeout_s=10)
    assert not _serve_threads()


def test_http_post_sse_metrics_and_drain(lm, jax_reference):
    tokens, mask, _ = jax_reference
    prompts, masks = _prompt_set()
    server = _server(lm)
    server.start(host="127.0.0.1", port=0)
    try:
        port = server.port
        # prompt 0 has no padding: send it raw
        status, body = _post(port, {"prompt_ids": prompts[0].tolist(), "do_sample": False})
        assert status == 200
        assert json.loads(body)["tokens"] == _masked(tokens, mask, 0)
        # streamed: the SSE deltas concatenate to the full greedy response
        status, raw = _post(port, {"prompt_ids": prompts[3].tolist(), "do_sample": False,
                                   "stream": True})
        assert status == 200
        events = [json.loads(e[len("data: "):]) for e in raw.split("\n\n") if e.startswith("data: ")]
        streamed = [t for e in events for t in e.get("tokens", [])]
        assert events[-1]["done"] and events[-1]["n_tokens"] == len(streamed)
        assert streamed == _masked(tokens, mask, 3)
        # a sampled request answers with 1..N in-vocabulary tokens
        status, body = _post(port, {"prompt_ids": prompts[1].tolist(), "seed": 5})
        toks = json.loads(body)["tokens"]
        assert status == 200 and 1 <= len(toks) <= N and all(0 <= t < 259 for t in toks)
        assert _post(port, {"nope": 1})[0] == 400
        assert _post(port, {"prompt_ids": list(range(P + 1))})[0] == 400
        status, health = _get(port, "/healthz")
        assert status == 200 and health["status"] == "ok"
        status, metrics = _get(port, "/metrics")
        assert metrics["serve"]["serve/completed"] == 3.0
        assert "default/interactive" in metrics["tenants"]
        server.admission.set_draining()
        assert _post(port, {"prompt_ids": [1, 2, 3]})[0] == 503
    finally:
        assert server.drain(timeout_s=10)
    assert not _serve_threads()
    assert server.pump_error is None


def test_publish_adopts_weights_between_requests(lm):
    """Published weights are adopted while the engine is idle, and the
    response carries the version it was generated under."""
    _, _, model, _ = lm
    prompts, masks = _prompt_set()
    server = _server(lm)
    server.start()
    try:
        newer = copy.deepcopy(model)
        server.publish(newer, version=7)
        req, rejection = server.submit(prompts[0], masks[0], greedy=True)
        assert rejection is None and req.wait_done(timeout=60) == "DONE"
        assert req.snapshot()["params_version"] == 7
        assert server.engine.params is newer
        assert server.flat_metrics()["serve/params_version"] == 7
    finally:
        assert server.drain(timeout_s=10)
    assert not _serve_threads()


def test_serving_requires_paged_engine():
    class _Dense:
        spec = None

    with pytest.raises(ValueError, match="paged"):
        ServeServer(_Dense())


def test_request_and_admission_units():
    ids = np.arange(4, dtype=np.int32)
    r = ServeRequest(rid=1, prompt_ids=ids, prompt_mask=np.ones_like(ids), tenant="t",
                     klass="interactive", seed=0, stream=True, max_buffered=2, greedy=True)
    r.mark_generating(params_version=3)
    assert r.push_tokens(np.array([1], np.int32)) and r.push_tokens(np.array([2], np.int32))
    assert not r.push_tokens(np.array([3], np.int32))  # slow consumer dropped
    assert r.next_event()[0] == "dropped" and r.greedy
    adm = AdmissionController(slots=2, slo_s={"interactive": 0.5}, max_queue=2)
    assert adm.try_admit("interactive").admitted and adm.try_admit("eval").admitted
    d = adm.try_admit("interactive")
    assert not d.admitted and d.status == 429
    assert adm.try_admit("vip").status == 400
    adm.release("eval")
    adm.note_service(10.0)  # an SLO now provably blown for a queued request
    assert adm.try_admit("interactive").status == 429
    adm.set_draining()
    assert adm.try_admit("actor").status == 503
