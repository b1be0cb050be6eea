"""ServeRequest: one in-flight serving request's cross-thread state.

Port of ``trlx_tpu/serve/request.py`` (host Python). The JAX request's
``max_new_tokens`` field is not carried over: nothing enforced it.

A request is born on an HTTP handler thread (``frontend.py``), generated
by the pump thread (``server.py``), and consumed — token deltas, then the
final result — back on the handler thread. This class is the ONLY object
those two threads share per request, so everything mutable on it is
guarded by one condition variable:

- the pump *produces*: stream deltas (``push_tokens``), terminal
  transitions (``finish`` / ``fail``), lifecycle timestamps;
- the handler *consumes*: ``next_event`` blocks on the condition until a
  delta or the terminal state arrives;
- the bounded stream buffer is the slow-client firewall: when a stalled
  consumer
  lets ``max_buffered`` deltas pile up, the producer marks the request
  DROPPED and stops buffering — the engine slot keeps decoding and
  harvests normally, only the
  *connection* is abandoned. The pump never blocks on a client.

States::

    QUEUED ──► GENERATING ──► DONE
       │            ├───────► FAILED   (tenant quota / internal error)
       │            └───────► DROPPED  (slow or vanished client)
       └──► (REJECTED requests never construct a ServeRequest)

Lock discipline: all
cross-thread fields are annotated ``# guarded-by: _cond`` and only touched
inside ``with self._cond:``.
"""

import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np

__all__ = ["ServeRequest"]

# terminal states — next_event() unblocks for good once one is reached
_TERMINAL = ("DONE", "FAILED", "DROPPED")


class ServeRequest:
    """One serving request's handler↔pump shared state (see module doc)."""

    def __init__(
        self,
        rid: int,
        prompt_ids: np.ndarray,  # [p] token ids (left-padded or raw)
        prompt_mask: np.ndarray,  # [p]
        tenant: str,
        klass: str,
        seed: int,
        stream: bool,
        max_buffered: int = 64,
        greedy: bool = False,
    ):
        # immutable after construction (set before the request escapes the
        # submitting thread — safe to read anywhere unlocked)
        self.rid = rid
        self.prompt_ids = np.asarray(prompt_ids, np.int32)
        self.prompt_mask = np.asarray(prompt_mask, np.int32)
        self.tenant = tenant
        self.klass = klass
        self.seed = int(seed)
        self.stream = bool(stream)
        self.max_buffered = max(1, int(max_buffered))
        self.greedy = bool(greedy)  # decode greedily instead of sampling
        self.t_submit = time.perf_counter()

        # pump-thread-only terminal-accounting latch (server.py _terminal)
        self._accounted = False

        self._cond = threading.Condition()
        self.state = "QUEUED"  # guarded-by: _cond
        self.error: Optional[str] = None  # guarded-by: _cond
        # undelivered stream deltas, each a [k] int32 chunk of new tokens
        self._chunks: List[np.ndarray] = []  # guarded-by: _cond
        # full masked response + engine span timestamps, set at finish()
        self.result_tokens: Optional[np.ndarray] = None  # guarded-by: _cond
        self.t_first_token = 0.0  # guarded-by: _cond
        self.t_done = 0.0  # guarded-by: _cond
        self.queue_wait_s = 0.0  # guarded-by: _cond
        self.n_tokens = 0  # guarded-by: _cond
        self.params_version: Optional[int] = None  # guarded-by: _cond

    # -- pump (producer) side --------------------------------------------

    def mark_generating(self, params_version: Optional[int]) -> None:
        """Request handed to the engine under ``params_version``."""
        with self._cond:
            if self.state == "QUEUED":
                self.state = "GENERATING"
                self.params_version = params_version
            self._cond.notify_all()

    def push_tokens(self, delta: np.ndarray) -> bool:
        """Buffer freshly decoded tokens for the streaming consumer.
        Returns False (and transitions to DROPPED) when the consumer has
        stalled past the buffer bound — the caller stops streaming this
        request but MUST keep driving the engine."""
        with self._cond:
            if self.state in _TERMINAL:
                return self.state == "DONE"
            if len(self._chunks) >= self.max_buffered:
                self.state = "DROPPED"
                self.error = (
                    f"client stalled: {len(self._chunks)} undelivered stream "
                    "chunks (serve.stream_buffer) — connection dropped"
                )
                self._chunks.clear()
                self._cond.notify_all()
                return False
            if self.t_first_token == 0.0:
                self.t_first_token = time.perf_counter()
            self._chunks.append(np.asarray(delta, np.int32))
            self._cond.notify_all()
            return True

    def finish(
        self,
        tokens: np.ndarray,
        queue_wait_s: float,
        t_first_token: float = 0.0,
    ) -> None:
        """Terminal success: ``tokens`` is the full masked response (what a
        solo ``generate`` at the served params version returns)."""
        with self._cond:
            if self.state in _TERMINAL:
                return
            self.result_tokens = np.asarray(tokens, np.int32)
            self.n_tokens = int(self.result_tokens.shape[0])
            self.queue_wait_s = float(queue_wait_s)
            if self.t_first_token == 0.0:
                self.t_first_token = t_first_token or time.perf_counter()
            self.t_done = time.perf_counter()
            self.state = "DONE"
            self._cond.notify_all()

    def fail(self, error: str) -> None:
        with self._cond:
            if self.state in _TERMINAL:
                return
            self.error = error
            self.t_done = time.perf_counter()
            self.state = "FAILED"
            self._chunks.clear()
            self._cond.notify_all()

    def drop(self, reason: str) -> None:
        """Consumer vanished (broken pipe / stall): stop buffering, keep
        the engine-side work running to completion."""
        with self._cond:
            if self.state in _TERMINAL:
                return
            self.error = reason
            self.t_done = time.perf_counter()
            self.state = "DROPPED"
            self._chunks.clear()
            self._cond.notify_all()

    # -- handler (consumer) side -----------------------------------------

    def next_event(self, timeout: float = 0.1) -> Tuple[str, Any]:
        """Block up to ``timeout`` for the next consumer event:

        - ``("tokens", np.ndarray)`` — one stream delta;
        - ``("done", np.ndarray)``   — terminal, remaining deltas already
          drained (the payload is the FULL masked response);
        - ``("failed"|"dropped", str)`` — terminal, error message;
        - ``("pending", None)``      — timeout, poll again.
        """
        with self._cond:
            if not self._chunks and self.state not in _TERMINAL:
                self._cond.wait(timeout)
            if self._chunks:
                return "tokens", self._chunks.pop(0)
            if self.state == "DONE":
                return "done", self.result_tokens
            if self.state == "FAILED":
                return "failed", self.error or "internal error"
            if self.state == "DROPPED":
                return "dropped", self.error or "connection dropped"
            return "pending", None

    def wait_done(self, timeout: float = 60.0) -> str:
        """Block until terminal (non-streaming responses); returns the
        terminal state, or ``"pending"`` on timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self.state not in _TERMINAL:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    return "pending"
                self._cond.wait(min(remain, 0.25))
            return self.state

    def snapshot(self) -> dict:
        """Locked copy of the SLO-relevant fields (metrics/HTTP payloads)."""
        with self._cond:
            return {
                "rid": self.rid,
                "state": self.state,
                "tenant": self.tenant,
                "class": self.klass,
                "error": self.error,
                "n_tokens": self.n_tokens,
                "params_version": self.params_version,
                "ttft_s": (
                    self.t_first_token - self.t_submit
                    if self.t_first_token
                    else 0.0
                ),
                "queue_wait_s": self.queue_wait_s,
            }
