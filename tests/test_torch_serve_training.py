"""Serving inside a trainer on the port (``serve.enabled``): PPO's
``learn()`` serves requests from its own serving engine while it trains
(continuous path, prefix cache and chunked prefill on). A request streamed
during ``learn()`` is stamped with the weights version it was generated
under, and equals a solo ``generate`` under the copy retained for that
version; the ``request_flood`` drill sheds load with 429s; a
``slow_client`` reader is dropped while its slot harvests; and the server
drains on the crash path, leaving no serve thread."""

import copy
import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

import trlx_tpu_torch
from tests.test_torch_ppo_trainer import _config_dict, _prompts, reward_fn
from tests.test_torch_prefix_cache import (  # noqa: F401 — the vlm fixture
    PAD,
    gen_config,
    port_engine,
    vlm,
)
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.ops.sampling import generate
from trlx_tpu_torch.resilience.faults import FaultPlan, set_active_plan
from trlx_tpu_torch.serve.server import ServeServer
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()


def _serve_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("trlx-serve") and t.is_alive()]


def _serving_config(tmp_path, **serve):
    d = _config_dict(tmp_path)
    d["train"].update(total_steps=4)
    d["engine"].update(prefix_cache=True, prefill_chunk=8)
    d["serve"].update(enabled=True, slots=2, retain_param_versions=16, max_new_tokens=6,
                      drain_timeout_s=30.0, **serve)
    return d


class Client(threading.Thread):
    """Streams one greedy request each time the trainer's update count
    reaches the next of ``at_steps``, through ``ServeServer.submit``."""

    def __init__(self, trainer, prompt, at_steps):
        super().__init__(name="test-serve-client", daemon=True)
        self.trainer, self.prompt, self.at_steps = trainer, prompt, at_steps
        self.server, self.answers, self.error = None, [], None

    def run(self):
        try:
            deadline = time.monotonic() + 120
            while self.trainer._serve is None or not self.trainer._serve._started:
                if time.monotonic() > deadline:
                    raise TimeoutError("the serving frontend never came up")
                time.sleep(0.005)
            self.server = self.trainer._serve
            for step in self.at_steps:
                while self.trainer.iter_count < step and self.trainer._serve is not None:
                    time.sleep(0.005)
                req, rejection = self.server.submit(self.prompt, stream=True, greedy=True)
                if req is None:
                    break  # draining: learn() is over
                streamed = []
                while True:
                    kind, payload = req.next_event(timeout=0.2)
                    if kind == "tokens":
                        streamed.extend(int(t) for t in payload)
                    elif kind in ("done", "error", "dropped"):
                        break
                snap = req.snapshot()
                assert snap["state"] == "DONE", snap
                assert streamed == [int(t) for t in req.result_tokens]
                self.answers.append((snap["params_version"], streamed))
        except BaseException as e:  # noqa: BLE001 — re-raised by the test
            self.error = e


def test_learn_serves_requests_under_versioned_weights(tmp_path):
    d = _serving_config(tmp_path, max_queue=4)
    d["resilience"]["fault_plan"] = "request_flood@step:2"
    config = TRLConfig.from_dict(copy.deepcopy(d))
    rs = np.random.RandomState(5)
    prompt = rs.randint(97, 123, 11)
    clients = []

    def hook(trainer):
        clients.append(Client(trainer, prompt, at_steps=(0, 2, 3)))
        clients[0].start()

    trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_prompts(), config=config,
                                   device="cpu", init_trainer_hook=hook)
    client = clients[0]
    client.join(timeout=120)
    if client.error is not None:
        raise client.error
    assert not _serve_threads() and trainer._serve is None
    server = client.server
    assert server.admission.draining  # drained on the clean path
    assert len(client.answers) >= 2
    versions = [v for v, _ in client.answers]
    assert versions == sorted(versions) and versions[-1] > 0
    # each answer equals a solo generate under the copy of its version
    gen, _ = trainer._resolve_gen_config(eval_mode=True, max_new_tokens=6)
    P = config.train.seq_length - 6
    ids = np.full((1, P), trainer.tokenizer.pad_token_id, np.int64)
    mask = np.zeros((1, P), np.int64)
    ids[0, -len(prompt):], mask[0, -len(prompt):] = prompt, 1
    for version, tokens in client.answers:
        weights = server.params_for_version(version)
        assert weights is not None and weights is not trainer.model
        solo = generate(weights, torch.as_tensor(ids), torch.as_tensor(mask),
                        torch.zeros(1, dtype=torch.int64), gen)
        want = solo.response_tokens[0][solo.response_mask[0] == 1].tolist()
        assert tokens == want, version
    # the copies are frozen snapshots, not the live policy
    live = dict(trainer.model.named_parameters())
    first = dict(server.params_for_version(versions[0]).named_parameters())
    assert any(not torch.equal(live[k], first[k]) for k in live)
    # the flood drill shed load through the real gate, and its stats rode
    # the step log
    assert server.flat_metrics()["serve/flood_rejected"] > 0
    logged = [st for _, st in trainer.tracker.history if "serve/flood_rejected" in st]
    assert logged and max(st["serve/flood_rejected"] for st in logged) > 0


def test_slow_client_is_dropped_while_the_slot_harvests(vlm):
    """The ``slow_client@request:1`` drill: the first streaming reader
    stalls, the producer fills the one-delta buffer and drops the request,
    and the engine still decodes the row to its harvest."""
    engine = port_engine(vlm, config=gen_config(eos_token_id=None), segment_len=1)
    server = ServeServer(engine, stream_buffer=1)
    set_active_plan(FaultPlan.parse("slow_client@request:1"))
    try:
        server.start(host="127.0.0.1", port=0)
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        conn.request("POST", "/v1/generate",
                     json.dumps({"prompt_ids": list(range(5, 17)), "stream": True,
                                 "do_sample": False}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()  # headers: the stream has started
        assert resp.status == 200
        deadline = time.monotonic() + 60
        while ((engine.stats.harvested < 1 or server.flat_metrics()["serve/dropped"] < 1)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        conn.close()
        assert engine.stats.harvested == 1 and server.flat_metrics()["serve/dropped"] == 1
        # the next request is served whole
        req, _ = server.submit(np.arange(5, 17), greedy=True)
        assert req.wait_done(timeout=60) == "DONE" and len(req.result_tokens) > 0
    finally:
        set_active_plan(None)
        server.drain()
    assert not _serve_threads()


def test_serving_drains_on_the_crash_path(tmp_path):
    d = _serving_config(tmp_path)
    config = TRLConfig.from_dict(copy.deepcopy(d))
    seen = {}

    def hook(trainer):
        step = trainer.train_step

        def crashing(batch):
            if trainer.iter_count == 1:
                seen["server"] = trainer._serve
                raise RuntimeError("injected crash in the train step")
            return step(batch)

        trainer.train_step = crashing

    with pytest.raises(RuntimeError, match="injected crash"):
        trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_prompts(), config=config,
                             device="cpu", init_trainer_hook=hook)
    assert seen["server"] is not None and seen["server"].admission.draining
    assert not _serve_threads()


def test_offline_trainers_refuse_serving_with_jax_reason(tmp_path):
    from trlx_tpu_torch.trainer.sft import SFTTrainer

    d = _config_dict(tmp_path)
    d["serve"].update(enabled=True)
    with pytest.raises(ValueError, match="PPO-family trainers only"):
        SFTTrainer(config=TRLConfig.from_dict(d), device="cpu")
