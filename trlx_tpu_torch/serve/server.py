"""ServeServer: the pump thread that owns the serving engine, plus the
request/param plumbing between it, the HTTP frontend and the owner.

Port of ``trlx_tpu/serve/server.py``. Threading model:

- the **pump thread** (``trlx-serve-pump``) exclusively drives the serving
  :class:`~trlx_tpu_torch.engine.core.ContinuousEngine` — every ``step()``,
  ``enqueue_prompts`` and ``swap_params`` happens there and only there;
- **HTTP handler threads** (``frontend.py``) talk to the pump through
  ``queue.Queue`` handoffs and per-request :class:`ServeRequest` condition
  variables — they never touch the engine;
- the **owner thread** publishes fresh weights through a latest-wins
  queue (``publish``) and owns start/drain/close.

Published weights are adopted only when the engine has no live serve work,
so every response is generated under one weights version. A request's
sampling seed is its ``seed`` field, so a sampled response is reproducible
by a solo ``ops/sampling.py::generate`` with that seed.

Graceful drain: new admissions get 503 at once, in-flight requests get a
bounded window to finish, then the pump exits — failing whatever remains
so no handler thread is left blocked — and the HTTP listener shuts down.
Both threads are joined.

The JAX server's host-RAM tier and prefix-cache hooks are not part of
this port yet; the engine exposes them as ``None``.
"""

import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from trlx_tpu_torch.serve.metrics import ServeMetrics
from trlx_tpu_torch.serve.request import ServeRequest
from trlx_tpu_torch.serve.scheduler import AdmissionController

__all__ = ["ServeServer"]


class ServeServer:
    """Serving frontend over one exclusively-owned ContinuousEngine."""

    def __init__(
        self,
        engine: Any,  # ContinuousEngine (paged backend), pump-owned
        default_tenant: str = "default",
        default_class: str = "interactive",
        slo_s: Optional[Dict[str, float]] = None,
        max_queue: int = 64,
        stream_buffer: int = 64,
        drain_timeout_s: float = 5.0,
    ):
        if getattr(engine, "spec", None) is None:
            raise ValueError(
                "serving requires the paged engine backend — streaming "
                "snapshots are block-table operations"
            )
        self.engine = engine
        self.default_tenant = default_tenant
        self.default_class = default_class
        self.stream_buffer = int(stream_buffer)
        self.drain_timeout_s = float(drain_timeout_s)
        self.admission = AdmissionController(
            slots=engine.B, slo_s=slo_s, max_queue=max_queue
        )
        self.metrics = ServeMetrics()
        self._ingress: "queue.Queue[ServeRequest]" = queue.Queue()
        self._params_q: "queue.Queue[Tuple[Any, Optional[int]]]" = queue.Queue()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._pump: Optional[threading.Thread] = None
        self._httpd: Any = None
        self._http_thread: Optional[threading.Thread] = None
        self._rid_iter = iter(range(1, 1 << 62))
        self._started = False
        self._closed = False
        # the pump's exception, if it died (its requests are failed)
        self.pump_error: Optional[BaseException] = None

    # -- lifecycle (owner thread) ----------------------------------------

    def start(self, host: Optional[str] = None, port: int = 0) -> None:
        """Start the pump (and, when ``host`` is given, the HTTP listener)."""
        if self._started:
            return
        self._started = True
        self._pump = threading.Thread(
            target=self._pump_loop, name="trlx-serve-pump", daemon=True
        )
        self._pump.start()
        if host is not None:
            from trlx_tpu_torch.serve.frontend import make_http_server

            self._httpd = make_http_server(self, host, port)
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever, name="trlx-serve-http", daemon=True
            )
            self._http_thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd is not None else 0

    def publish(self, params: Any, version: Optional[int] = None) -> None:
        """Latest-wins weights handoff; the pump adopts them at the next
        point with no live serve work."""
        self._params_q.put((params, version))
        self._wake.set()

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admitting (503), give in-flight requests
        ``timeout_s`` to finish, then stop the pump and the HTTP listener.
        Returns True when everything in flight finished in time."""
        timeout_s = self.drain_timeout_s if timeout_s is None else timeout_s
        self.admission.set_draining()
        deadline = time.monotonic() + max(0.0, timeout_s)
        clean = True
        while time.monotonic() < deadline:
            if self.metrics.metrics()["serve/active"] <= 0:
                break
            time.sleep(0.02)
        else:
            clean = self.metrics.metrics()["serve/active"] <= 0
        self.close()
        return clean

    def close(self) -> None:
        """Stop and join both serve threads. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.admission.set_draining()
        self._stop.set()
        self._wake.set()
        if self._pump is not None:
            self._pump.join(timeout=30)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=30)

    # -- submission (handler threads / callers) --------------------------

    def submit(
        self,
        prompt_ids: np.ndarray,
        prompt_mask: Optional[np.ndarray] = None,
        tenant: Optional[str] = None,
        klass: Optional[str] = None,
        seed: int = 0,
        stream: bool = False,
        greedy: bool = False,
    ) -> Tuple[Optional[ServeRequest], Optional[Tuple[int, str, float]]]:
        """Admission-checked request entry: ``(request, None)`` on
        acceptance or ``(None, (status, reason, retry_after_s))``. ``greedy``
        decodes this request greedily; otherwise it samples with ``seed``."""
        tenant = tenant or self.default_tenant
        klass = klass or self.default_class
        prompt_ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt_mask is None:
            prompt_mask = np.ones_like(prompt_ids)
        prompt_mask = np.asarray(prompt_mask, np.int32).reshape(-1)
        if prompt_ids.size == 0 or prompt_ids.shape != prompt_mask.shape:
            return None, (400, "empty prompt or mask/ids shape mismatch", 0.0)
        if prompt_ids.shape[0] > self.engine.P:
            return None, (
                400,
                f"prompt length {prompt_ids.shape[0]} exceeds the engine's "
                f"padded width {self.engine.P}",
                0.0,
            )
        decision = self.admission.try_admit(klass)
        if not decision.admitted:
            return None, (decision.status, decision.reason, decision.retry_after_s)
        req = ServeRequest(
            rid=next(self._rid_iter), prompt_ids=prompt_ids,
            prompt_mask=prompt_mask, tenant=tenant, klass=klass, seed=seed,
            stream=stream, max_buffered=self.stream_buffer, greedy=greedy,
        )
        self.metrics.adjust_active(+1)
        self._ingress.put(req)
        self._wake.set()
        return req, None

    # -- pump thread -----------------------------------------------------

    def _pump_loop(self) -> None:
        engine = self.engine
        # engine submission index → [request, tokens streamed so far]
        tracked: Dict[int, List[Any]] = {}
        pending_pub: Optional[Tuple[Any, Optional[int]]] = None
        version: Optional[int] = None
        try:
            while not self._stop.is_set():
                while True:
                    try:
                        pending_pub = self._params_q.get_nowait()
                    except queue.Empty:
                        break
                if pending_pub is not None and not engine.busy and not tracked:
                    params, version = pending_pub
                    engine.swap_params(params, version)
                    self.metrics.set_params_version(version)
                    pending_pub = None
                moved = False
                while True:
                    try:
                        req = self._ingress.get_nowait()
                    except queue.Empty:
                        break
                    engine.enqueue_prompts(
                        req.prompt_ids[None], req.prompt_mask[None],
                        np.asarray([req.seed], np.int64), metas=[req],
                        tenant=req.tenant, klass=req.klass,
                        greedy=np.asarray([req.greedy]),
                    )
                    tracked[engine._submitted - 1] = [req, 0]
                    req.mark_generating(version)
                    moved = True
                if not engine.busy:
                    if not moved:
                        self._wake.wait(0.02)
                        self._wake.clear()
                    continue
                completed = engine.step()
                # stream deltas for still-live rows (streamed == -1 marks a
                # dropped consumer: decode continues, streaming stops)
                for idx, _meta, toks in engine.progress_snapshot():
                    entry = tracked.get(idx)
                    if entry is None or entry[1] < 0 or not entry[0].stream:
                        continue
                    req, streamed = entry
                    if toks.shape[0] > streamed:
                        if req.push_tokens(toks[streamed:]):
                            entry[1] = int(toks.shape[0])
                        else:
                            entry[1] = -1
                            self._terminal(req, "dropped")
                for c in completed:
                    entry = tracked.pop(c.index, None)
                    if entry is not None:
                        self._finish(entry[0], entry[1], c)
                while engine.failed:
                    req_obj, err = engine.failed.popleft()
                    sr = req_obj.meta
                    tracked.pop(req_obj.index, None)
                    if isinstance(sr, ServeRequest):
                        sr.fail(err)
                        self._terminal(sr, "failed")
                self._publish_gauges()
        except BaseException as e:  # noqa: BLE001 — kept on pump_error, re-raised
            self.pump_error = e
            raise
        finally:
            # pump exit: nothing will finish the remaining requests — fail
            # them so no handler blocks
            for req, _streamed in tracked.values():
                req.fail("server stopped: request abandoned")
                self._terminal(req, "failed")
            while True:
                try:
                    req = self._ingress.get_nowait()
                except queue.Empty:
                    break
                req.fail("server stopped: request abandoned")
                self._terminal(req, "failed")
            self._publish_gauges()

    def _finish(self, req: ServeRequest, streamed: int, c: Any) -> None:
        masked = np.asarray(c.tokens)[np.asarray(c.mask) == 1]
        if req.stream and streamed >= 0 and masked.shape[0] > streamed:
            req.push_tokens(masked[streamed:])
        queue_wait = max(0.0, c.t_prefill0 - c.t_enqueue)
        req.finish(masked, queue_wait, t_first_token=c.t_harvest)
        snap = req.snapshot()
        if snap["state"] == "DONE":
            req._accounted = True
            n = snap["n_tokens"]
            tpot = (
                max(0.0, req.t_done - req.t_first_token) / max(1, n - 1)
                if n > 1 else 0.0
            )
            self.metrics.observe_request(
                req.tenant, req.klass, snap["ttft_s"], tpot, queue_wait, n
            )
            self.admission.release(req.klass)
            self.admission.note_service(max(0.0, req.t_done - req.t_submit))
            self.metrics.adjust_active(-1)
        else:
            self._terminal(req, "dropped")

    def _terminal(self, req: ServeRequest, how: str) -> None:
        """Terminal accounting, exactly once per request."""
        if req._accounted:
            return
        req._accounted = True
        if how == "failed":
            self.metrics.note_failed()
        else:
            self.metrics.note_dropped()
        self.admission.release(req.klass)
        self.metrics.adjust_active(-1)

    def _publish_gauges(self) -> None:
        self.metrics.set_admission(self.admission.snapshot())

    # -- observation (any thread) ----------------------------------------

    def flat_metrics(self) -> Dict[str, float]:
        return self.metrics.metrics()

    def detail_metrics(self) -> Dict[str, Any]:
        return {
            "serve": self.metrics.metrics(),
            "tenants": self.metrics.detail(),
            "admission": self.admission.snapshot(),
        }
