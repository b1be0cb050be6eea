"""Stdlib-only HTTP frontend over :class:`~trlx_tpu_torch.serve.server.ServeServer`.

Port of ``trlx_tpu/serve/frontend.py``. Endpoints:

- ``POST /v1/generate`` — JSON body::

      {"prompt_ids": [1, 2, 3],      # required, token ids
       "tenant": "team-a",           # optional
       "class": "interactive",       # optional priority class
       "seed": 7,                    # optional per-request sampling seed
       "do_sample": false,           # optional: greedy decoding
       "stream": true}               # optional: SSE token streaming

  Non-streaming: one JSON response with the full token list. Streaming:
  ``text/event-stream`` — one ``data: {"tokens": [...]}`` event per decode
  delta, then ``data: {"done": true, ...}`` (chunked transfer). Rejections:
  **429** with ``Retry-After`` when the queue-wait SLO is provably blown,
  **503** while draining, **400** on malformed bodies.
- ``GET /healthz`` — liveness + drain state.
- ``GET /metrics`` — the flat ``serve/*`` gauges plus the per-tenant /
  per-class breakdown.

Handler threads only touch the ``ServeServer`` handoff surface (``submit``
→ per-request condition variables), never the engine. The JAX frontend's
injected slow-client fault drill is not part of this port.
"""

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

__all__ = ["make_http_server"]

# how long a non-streaming handler waits for its result before giving up
_RESULT_TIMEOUT_S = 120.0


class _ServeHTTPServer(ThreadingHTTPServer):
    daemon_threads = True  # handler threads must never outlive shutdown
    allow_reuse_address = True
    serve_server: Any = None  # the ServeServer, set by make_http_server


class _Handler(BaseHTTPRequestHandler):
    server_version = "trlx-tpu-torch-serve/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, format: str, *args: Any) -> None:
        pass

    def _send_json(self, status: int, payload: dict, headers: dict = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        srv = self.server.serve_server
        if self.path == "/healthz":
            self._send_json(200, {
                "status": "draining" if srv.admission.draining else "ok",
                "active": srv.metrics.metrics()["serve/active"],
            })
        elif self.path == "/metrics":
            self._send_json(200, srv.detail_metrics())
        else:
            self._send_json(404, {"error": f"no such path {self.path!r}"})

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        srv = self.server.serve_server
        if self.path != "/v1/generate":
            self._send_json(404, {"error": f"no such path {self.path!r}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(length) or b"{}")
            prompt_ids = np.asarray(body["prompt_ids"], np.int32)
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            self._send_json(400, {"error": f"malformed request body: {e}"})
            return
        req, rejection = srv.submit(
            prompt_ids=prompt_ids,
            tenant=body.get("tenant"),
            klass=body.get("class"),
            seed=int(body.get("seed", 0)),
            stream=bool(body.get("stream", False)),
            greedy=not bool(body.get("do_sample", True)),
        )
        if req is None:
            status, reason, retry_after = rejection
            headers = {}
            if status == 429 and retry_after > 0:
                headers["Retry-After"] = str(int(retry_after))
            self._send_json(status, {"error": reason}, headers)
            return
        if req.stream:
            self._stream_response(req)
        else:
            self._unary_response(req)

    def _unary_response(self, req: Any) -> None:
        state = req.wait_done(timeout=_RESULT_TIMEOUT_S)
        snap = req.snapshot()
        if state == "DONE":
            self._send_json(200, {
                "tokens": [int(t) for t in req.result_tokens],
                "n_tokens": snap["n_tokens"],
                "params_version": snap["params_version"],
                "tenant": snap["tenant"],
                "class": snap["class"],
            })
        elif state == "pending":
            req.drop("handler result timeout")
            self._send_json(504, {"error": "generation timed out"})
        else:
            self._send_json(503, {"error": snap["error"] or state.lower()})

    def _stream_response(self, req: Any) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            while True:
                kind, payload = req.next_event(timeout=0.1)
                if kind == "tokens":
                    self._write_sse({"tokens": [int(t) for t in payload]})
                elif kind == "done":
                    snap = req.snapshot()
                    self._write_sse({
                        "done": True,
                        "n_tokens": snap["n_tokens"],
                        "params_version": snap["params_version"],
                    })
                    self._write_chunk(b"")  # chunked-transfer terminator
                    return
                elif kind in ("failed", "dropped"):
                    self._write_sse({"error": payload, "state": kind})
                    self._write_chunk(b"")
                    return
                # "pending": poll again
        except (BrokenPipeError, ConnectionResetError):
            req.drop("client connection lost")

    def _write_sse(self, payload: dict) -> None:
        self._write_chunk(f"data: {json.dumps(payload)}\n\n".encode())

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()


def make_http_server(serve_server: Any, host: str, port: int) -> _ServeHTTPServer:
    """Bind the threaded HTTP frontend (``port=0`` = ephemeral — read the
    bound port back from ``ServeServer.port``)."""
    httpd = _ServeHTTPServer((host, port), _Handler)
    httpd.serve_server = serve_server
    return httpd
