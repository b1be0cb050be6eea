"""The continuous-batching generation engine over the paged block pool.

Port of ``trlx_tpu/engine/core.py`` for the paged path without the prefix
cache and chunked prefill (``prefix_cache=False``, ``prefill_chunk=0``):
:class:`ContinuousEngine`, :class:`EngineStats` and
:class:`CompletedSequence`.

The engine is the host half: a queue of prompts, ``B`` slots, a
refcounted :class:`~trlx_tpu_torch.engine.allocator.BlockAllocator` over
the pool and a host mirror of the block table. Each :meth:`step` admits
queued prompts into free slots (best priority class first, FIFO within a
class), prefills them in place, grows live rows' tables lazily to cover
the next segment, runs one decode segment (``ops/slot_refill.py``) and
harvests finished slots in slot order. A harvested sequence equals a solo
``ops/sampling.py::generate`` of the same prompt and seed.

Speculative segments (``fns.speculative = G > 0``): the engine's params
are a ``(target, draft)`` tuple, adopted as one object by
:meth:`ContinuousEngine.begin_collection` and
:meth:`ContinuousEngine.swap_params`; caches span ``S = P + N + G``
columns; a segment may commit up to ``segment_len · (G + 1)`` tokens per
row, so tables grow by that much, and after each segment every row's
committed length is read from the device ``step``. A harvested sequence
equals a solo ``ops/speculative.py::generate_speculative`` of the row.
``EngineStats.spec_*`` feed the ``engine/spec_*`` gauges.

Kernel gauges: ``engine/decode_kernel_launches``,
``engine/prefill_kernel_launches``, ``engine/verify_kernel_launches`` and
``engine/sample_kernel_launches`` are read from the kernel wrappers'
launch counters — what actually launched, never a configuration string.

Thread affinity: single-threaded by design — exactly one thread (the
caller, or the serve pump thread) calls ``enqueue_prompts``/``step``.
"""

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from trlx_tpu_torch.engine.allocator import (
    BlockAllocator,
    BlockPoolExhausted,
    TenantQuotaExceeded,
)
from trlx_tpu_torch.ops.paged_attention import (
    fused_sample,
    paged_attention_decode,
    paged_verify_attention,
)
from trlx_tpu_torch.ops.paged_kv import block_bytes, kv_bytes, num_table_blocks
from trlx_tpu_torch.ops.paged_prefill import paged_prefill_attention

__all__ = [
    "CompletedSequence",
    "EngineStats",
    "ContinuousEngine",
    "SERVE_CLASSES",
    "kernel_launches",
]

# Priority classes, best-first: admission pops the best-ranked queued
# request (FIFO within a class by submission index).
SERVE_CLASSES = ("interactive", "eval", "actor")
_CLASS_RANK = {k: i for i, k in enumerate(SERVE_CLASSES)}


def kernel_launches() -> Dict[str, int]:
    """The engine's kernel launch counters, read from the wrappers."""
    return {
        "paged_prefill": paged_prefill_attention.launches,
        "paged_decode": paged_attention_decode.launches,
        "paged_verify": paged_verify_attention.launches,
        "fused_sample": fused_sample.launches,
    }


@dataclass
class CompletedSequence:
    """One finished sequence, harvested from its slot."""

    index: int  # global submission index (queue order)
    prompt_ids: np.ndarray  # [P] left-padded prompt
    prompt_mask: np.ndarray  # [P]
    tokens: np.ndarray  # [N] response tokens (pad after eos)
    logprobs: np.ndarray  # [N] behaviour logprobs
    values: np.ndarray  # [N] value-head outputs (0 if no head)
    mask: np.ndarray  # [N] 1 on real response tokens (incl. eos)
    meta: Any = None
    # lifecycle timestamps (perf_counter): the serve SLO metrics derive
    # queue wait / TTFT from these
    t_enqueue: float = 0.0
    t_prefill0: float = 0.0
    t_prefill1: float = 0.0
    t_harvest: float = 0.0


@dataclass
class _Request:
    index: int
    input_ids: np.ndarray  # [P]
    attention_mask: np.ndarray  # [P]
    seed: int  # per-row sampling seed
    meta: Any = None
    greedy: bool = False  # decode this row greedily (zero noise)
    t_enqueue: float = 0.0
    t_refill0: float = 0.0
    t_refill1: float = 0.0
    tenant: Optional[str] = None
    klass: str = "actor"


@dataclass
class EngineStats:
    """Aggregate slot / block accounting over one engine collection."""

    segments: int = 0
    decode_steps: int = 0  # decode steps executed
    slot_steps: int = 0  # decode_steps × B
    live_slot_steps: int = 0  # slot-steps spent on live rows
    refill_prefills: int = 0  # refill invocations
    refilled_rows: int = 0  # prompts placed into slots
    harvested: int = 0
    decode_s: float = 0.0  # wall time inside decode segments
    refill_s: float = 0.0  # wall time inside refill prefills
    queue_wait_s: float = 0.0
    queue_wait_samples: List[float] = field(default_factory=list)
    kv_cache_bytes: int = 0  # pool allocation
    kv_blocks_total: int = 0
    kv_blocks_in_use: int = 0  # high-water blocks simultaneously held
    kv_bytes_high_water: int = 0
    prefill_tokens: int = 0
    decode_stall_s: float = 0.0
    decode_stall_samples: List[float] = field(default_factory=list)
    # kernel launches during this collection (deltas of the wrappers'
    # counters since the collection began)
    decode_kernel_launches: int = 0
    prefill_kernel_launches: int = 0
    verify_kernel_launches: int = 0
    sample_kernel_launches: int = 0
    # speculative segments: deltas of the device-cumulative counters over
    # this collection — rounds run, live row-rounds, draft tokens accepted
    # (before budget/eos clipping), tokens committed (after)
    spec_gamma: int = 0
    spec_rounds: int = 0
    spec_live_rounds: int = 0
    spec_accepted: int = 0
    spec_committed: int = 0
    gen_len_samples: List[float] = field(default_factory=list)
    repeat_pairs: int = 0
    repeat_pairs_total: int = 0

    @property
    def slot_utilization(self) -> float:
        return self.live_slot_steps / self.slot_steps if self.slot_steps else 0.0

    @property
    def padded_decode_frac(self) -> float:
        return 1.0 - self.slot_utilization if self.slot_steps else 0.0

    @property
    def spec_acceptance_rate(self) -> float:
        """Share of proposed draft tokens accepted, over live row-rounds
        (each proposes ``spec_gamma``)."""
        if self.spec_live_rounds == 0:
            return 0.0
        return self.spec_accepted / (self.spec_live_rounds * max(self.spec_gamma, 1))

    @property
    def spec_tokens_per_round(self) -> float:
        """Committed tokens per live row-round, in ``[1, gamma + 1]``."""
        if self.spec_live_rounds == 0:
            return 0.0
        return self.spec_committed / self.spec_live_rounds

    @staticmethod
    def _pct(samples: List[float], q: float) -> float:
        return float(np.percentile(np.asarray(samples), q)) if samples else 0.0

    def note_harvest(self, tokens: np.ndarray, mask: np.ndarray) -> None:
        """Per-row generated lengths and repeated adjacent-token pairs."""
        tokens = np.atleast_2d(np.asarray(tokens))
        mask = np.atleast_2d(np.asarray(mask, np.float32))
        self.gen_len_samples.extend(float(n) for n in mask.sum(axis=1))
        if tokens.shape[1] > 1:
            pair_mask = mask[:, 1:] * mask[:, :-1]
            self.repeat_pairs += int(((tokens[:, 1:] == tokens[:, :-1]) * pair_mask).sum())
            self.repeat_pairs_total += int(pair_mask.sum())

    def metrics(self) -> Dict[str, float]:
        stats: Dict[str, float] = {
            "throughput/slot_utilization": self.slot_utilization,
            "rollout/padded_decode_frac": self.padded_decode_frac,
            "rollout/refill_prefills": float(self.refill_prefills),
            "rollout/refilled_rows": float(self.refilled_rows),
            "rollout/segments": float(self.segments),
            "engine/queue_wait_s": float(self.queue_wait_s),
            "engine/queue_wait_p50": self._pct(self.queue_wait_samples, 50.0),
            "engine/queue_wait_p95": self._pct(self.queue_wait_samples, 95.0),
            "memory/kv_cache_bytes": float(self.kv_cache_bytes),
            "rollout/decode_stall_p50": self._pct(self.decode_stall_samples, 50.0),
            "rollout/decode_stall_p95": self._pct(self.decode_stall_samples, 95.0),
            "engine/kv_blocks_in_use": float(self.kv_blocks_in_use),
            "engine/block_pool_occupancy": self.kv_blocks_in_use / max(self.kv_blocks_total, 1),
            "engine/decode_kernel_launches": float(self.decode_kernel_launches),
            "engine/prefill_kernel_launches": float(self.prefill_kernel_launches),
            "engine/sample_kernel_launches": float(self.sample_kernel_launches),
        }
        if self.spec_gamma:
            stats["engine/spec_acceptance_rate"] = self.spec_acceptance_rate
            stats["engine/spec_tokens_per_round"] = self.spec_tokens_per_round
            stats["rollout/spec_rounds"] = float(self.spec_rounds)
            stats["engine/verify_kernel_launches"] = float(self.verify_kernel_launches)
            # 1.0 only when the verify kernel, not its plain version, ran
            stats["engine/spec_verify_kernel_pallas"] = float(self.verify_kernel_launches > 0)
        if self.gen_len_samples:
            stats["rollout/gen_len_p50"] = self._pct(self.gen_len_samples, 50.0)
            stats["rollout/gen_len_p95"] = self._pct(self.gen_len_samples, 95.0)
            stats["rollout/repetition_frac"] = (
                self.repeat_pairs / self.repeat_pairs_total if self.repeat_pairs_total else 0.0
            )
        return stats


class ContinuousEngine:
    """Slot-refill decode over a fixed ``[B]`` slot batch on the paged
    block pool. ``fns`` come from
    :func:`trlx_tpu_torch.ops.slot_refill.make_slot_refill_fns`; ``model``
    is the served ``CausalTransformer`` (its device must be ``fns.device``).
    """

    def __init__(
        self,
        fns: Any,  # SlotRefillFns
        model: Any,
        pad_token_id: int,
        prewarm: bool = True,
        prefix_cache: bool = False,
        prefill_chunk: int = 0,
    ):
        if prefix_cache:
            raise ValueError("the prefix cache is not ported yet (prefix_cache=False)")
        if prefill_chunk:
            raise ValueError("chunked prefill is not ported yet (prefill_chunk=0)")
        self.fns = fns
        self.params = model
        self.pad_token_id = int(pad_token_id)
        self.state = fns.init_state()
        self.B = fns.batch_size
        self.P = fns.prompt_len
        self.N = fns.max_new_tokens
        self._gamma = int(fns.speculative)
        self._S = self.P + self.N + self._gamma
        self._queue: deque = deque()
        self._slots: List[Optional[_Request]] = [None] * self.B
        self._submitted = 0
        self.stats = EngineStats()
        # serving hooks of the JAX engine that this slice leaves out
        self.host_tier: Any = None
        self.prefix: Any = None
        # requests that failed admission (tenant quota): the owner drains them
        self.failed: deque = deque()

        self.spec = fns.paged
        self._bs = self.spec.block_size
        self._TB = num_table_blocks(self._S, self._bs)
        self.allocator = BlockAllocator(self.spec.max_blocks)
        self._tables = np.zeros((self.B, self._TB), np.int32)
        self._row_blocks: List[Optional[List[int]]] = [None] * self.B
        self._alloc_upto = [0] * self.B
        self._steps_bound = [0] * self.B
        self.stats.kv_blocks_total = self.spec.max_blocks - 1
        self.stats.spec_gamma = self._gamma
        self._block_bytes = block_bytes(self.state.cache)
        self.stats.kv_cache_bytes = kv_bytes(self.state.cache)
        if self._gamma:
            # the draft's dense [B, S] cache is persistent engine state too
            self.stats.kv_cache_bytes += kv_bytes(self.state.d_cache)
        self._spec_base = self._read_spec_counters()
        self._params_version: Optional[int] = None
        before = kernel_launches()
        if prewarm:
            self.state = self.fns.prewarm(self.params, self.state)
        self._launch_base = kernel_launches()
        # the no-op prewarm refills' launches, which no collection counts
        self.prewarm_launches = {k: self._launch_base[k] - before[k] for k in before}

    def begin_collection(self, model: Any = None, version: Optional[int] = None) -> None:
        """Reuse this engine for a fresh collection: drop leftovers of an
        aborted run, adopt ``model`` and reset the per-collection stats."""
        self._queue.clear()
        self.failed.clear()
        for slot in range(self.B):
            if self._slots[slot] is None:
                continue
            if self._row_blocks[slot] is not None:
                self.allocator.release(self._row_blocks[slot])
            self._row_blocks[slot] = None
            self._alloc_upto[slot] = 0
            self._steps_bound[slot] = 0
            self._slots[slot] = None
        self.state.done.fill_(True)
        if model is not None:
            self.swap_params(model, version)
        self.stats = EngineStats(
            kv_cache_bytes=self.stats.kv_cache_bytes,
            kv_blocks_total=self.stats.kv_blocks_total,
            spec_gamma=self._gamma,
        )
        self._spec_base = self._read_spec_counters()
        self.allocator.high_water = self.allocator.blocks_in_use
        self._launch_base = kernel_launches()

    @staticmethod
    def _same_params(a: Any, b: Any) -> bool:
        """Identity, element-wise over ``(target, draft)`` tuples: the
        speculative engine's params often arrive as a fresh tuple around
        the same models."""
        if type(a) is tuple and type(b) is tuple and len(a) == len(b):
            return all(x is y for x, y in zip(a, b))
        return a is b

    def swap_params(self, model: Any, version: Optional[int] = None) -> bool:
        """Adopt an updated model — or ``(target, draft)`` pair, as one
        object, so a swap never verifies an old target against a new draft
        — at a step boundary. Returns True when it (or its memoized
        version) changed."""
        if version is not None and self._params_version is not None:
            changed = version != self._params_version
        else:
            changed = not self._same_params(model, self.params)
        self._params_version = version
        self.params = model
        return changed

    # -- feeding ---------------------------------------------------------

    def enqueue_prompts(
        self,
        input_ids: np.ndarray,  # [b, p] left-padded, p <= P
        attention_mask: np.ndarray,  # [b, p]
        seeds: np.ndarray,  # [b] per-row sampling seeds
        metas: Optional[List[Any]] = None,
        tenant: Optional[str] = None,
        klass: str = "actor",
        greedy: Optional[np.ndarray] = None,  # [b] bool, default all False
    ) -> None:
        """Queue a prompt batch; rows narrower than ``P`` are left-padded.
        Rows flagged ``greedy`` decode greedily; the rest sample (when the
        engine's config samples)."""
        if klass not in _CLASS_RANK:
            raise ValueError(
                f"unknown priority class {klass!r}: expected one of {SERVE_CLASSES}"
            )
        input_ids = np.asarray(input_ids, np.int64)
        attention_mask = np.asarray(attention_mask, np.int64)
        b, p = input_ids.shape
        if p > self.P:
            raise ValueError(
                f"prompt width {p} exceeds the engine's padded width {self.P}"
            )
        if p < self.P:
            pad = self.P - p
            input_ids = np.concatenate(
                [np.full((b, pad), self.pad_token_id, np.int64), input_ids], axis=1)
            attention_mask = np.concatenate(
                [np.zeros((b, pad), np.int64), attention_mask], axis=1)
        seeds = np.asarray(seeds, np.int64).reshape(-1)
        greedy = np.zeros((b,), bool) if greedy is None else np.asarray(greedy, bool)
        if self._gamma and self.fns.config.do_sample and greedy.any():
            raise ValueError(
                "greedy rows in a sampling speculative engine: the speculative path "
                "has no per-row greedy flag (the generation config decides for every row)"
            )
        t_enqueue = time.perf_counter()
        for i in range(b):
            self._queue.append(_Request(
                index=self._submitted, input_ids=input_ids[i],
                attention_mask=attention_mask[i], seed=int(seeds[i]),
                meta=metas[i] if metas is not None else None,
                t_enqueue=t_enqueue, tenant=tenant, klass=klass,
                greedy=bool(greedy[i]),
            ))
            self._submitted += 1

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def live(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    @property
    def busy(self) -> bool:
        return self.live > 0 or self.pending > 0

    def run(self) -> List[CompletedSequence]:
        """Drain queue + slots to completion."""
        out: List[CompletedSequence] = []
        while self.busy:
            out.extend(self.step())
        return out

    # -- paged-block bookkeeping ----------------------------------------

    def _note_block_usage(self) -> None:
        self.stats.kv_blocks_in_use = self.allocator.high_water
        self.stats.kv_bytes_high_water = self.allocator.high_water * self._block_bytes

    def _prepare_row(self, req: _Request, slot: int) -> None:
        """Fresh private blocks for the prompt region of one row."""
        n_prompt_blocks = (self.P - 1) // self._bs + 1
        fresh = self.allocator.alloc(n_prompt_blocks, tenant=req.tenant)
        row = np.zeros(self._TB, np.int32)
        row[:n_prompt_blocks] = fresh
        self._tables[slot] = row
        self._row_blocks[slot] = fresh
        self._alloc_upto[slot] = n_prompt_blocks
        self._steps_bound[slot] = 0

    def _ensure_decode_blocks(self, segment_len: int) -> bool:
        """Grow each live row's table to cover the columns the next segment
        may write. Returns True when a table changed."""
        dirty = False
        for slot in range(self.B):
            if self._slots[slot] is None:
                continue
            # a spec segment commits up to (gamma + 1) tokens per round
            need_cols = self.P + min(self.N, self._steps_bound[slot]
                                     + segment_len * (self._gamma + 1))
            need_blocks = (need_cols - 1) // self._bs + 1
            have = self._alloc_upto[slot]
            if need_blocks > have:
                fresh = self.allocator.alloc(need_blocks - have)
                self._tables[slot, have:need_blocks] = fresh
                self._row_blocks[slot].extend(fresh)
                self._alloc_upto[slot] = need_blocks
                dirty = True
        return dirty

    def _push_tables(self) -> None:
        self.state.cache.block_table.copy_(torch.as_tensor(self._tables))

    # -- the slot-refill state machine -----------------------------------

    def _pop_next(self) -> _Request:
        """Best-class-first, FIFO-within-class pop of the non-empty queue
        (classes were validated by :meth:`enqueue_prompts`)."""
        q = self._queue
        best = min(range(len(q)), key=lambda i: (_CLASS_RANK[q[i].klass], q[i].index))
        req = q[best]
        del q[best]
        return req

    def _admit(self) -> None:
        """Move queued prompts into free slots and prefill them in one
        bucketed refill. A tenant whose quota cannot cover its prompt fails
        onto :attr:`failed` instead of failing the engine."""
        free = deque(s for s in range(self.B) if self._slots[s] is None)
        rows: List[_Request] = []
        slots: List[int] = []
        while free and self._queue:
            req = self._pop_next()
            slot = free[0]
            try:
                self._prepare_row(req, slot)
            except TenantQuotaExceeded as e:
                self.failed.append((req, str(e)))
                continue
            free.popleft()
            self._slots[slot] = req
            rows.append(req)
            slots.append(slot)
        if not rows:
            return
        waiting = self.live - len(rows)
        t0 = time.perf_counter()
        self.state = self.fns.refill_rows(
            self.params, self.state,
            np.stack([r.input_ids for r in rows]),
            np.stack([r.attention_mask for r in rows]),
            np.asarray(slots, np.int64),
            np.asarray([r.seed for r in rows], np.int64),
            np.stack([self._tables[s] for s in slots]),
            greedy=np.asarray([r.greedy for r in rows], bool),
        )
        # the first sampled token rides on this prefill's logits: wait for
        # it so the prefill span measures device time
        if self.fns.device.type == "cuda":
            torch.cuda.synchronize(self.fns.device)
        t1 = time.perf_counter()
        self.stats.refill_prefills += 1
        self.stats.refilled_rows += len(rows)
        self.stats.prefill_tokens += self.P * len(rows)
        self.stats.refill_s += t1 - t0
        if waiting > 0:
            self.stats.decode_stall_s += t1 - t0
            self.stats.decode_stall_samples.append(t1 - t0)
        for req in rows:
            req.t_refill0, req.t_refill1 = t0, t1
            wait = max(t0 - req.t_enqueue, 0.0)
            self.stats.queue_wait_s += wait
            self.stats.queue_wait_samples.append(wait)
        self._note_block_usage()

    def _harvest(self) -> List[CompletedSequence]:
        done = self.state.done.cpu().numpy()
        finished = [s for s in range(self.B) if self._slots[s] is not None and done[s]]
        if not finished:
            return []
        idx = torch.as_tensor(finished, device=self.fns.device)
        host = {
            name: getattr(self.state, name)[idx, : self.N].cpu().numpy()
            for name in ("tokens", "logprobs", "values", "mask")
        }
        self.stats.note_harvest(host["tokens"], host["mask"])
        t_harvest = time.perf_counter()
        completed = []
        for j, slot in enumerate(finished):  # slot order: deterministic
            req = self._slots[slot]
            self._slots[slot] = None
            self.allocator.release(self._row_blocks[slot])
            self._row_blocks[slot] = None
            self._alloc_upto[slot] = 0
            self._steps_bound[slot] = 0
            completed.append(CompletedSequence(
                index=req.index, prompt_ids=req.input_ids,
                prompt_mask=req.attention_mask, tokens=host["tokens"][j],
                logprobs=host["logprobs"][j], values=host["values"][j],
                mask=host["mask"][j],
                meta=req.meta, t_enqueue=req.t_enqueue, t_prefill0=req.t_refill0,
                t_prefill1=req.t_refill1, t_harvest=t_harvest,
            ))
        self.stats.harvested += len(completed)
        return completed

    def progress_snapshot(self) -> List[tuple]:
        """``(index, meta, tokens)`` for every live slot: the host copy of
        the row's committed response so far (for token streaming)."""
        out: List[tuple] = []
        toks = None
        for slot in range(self.B):
            req = self._slots[slot]
            if req is None:
                continue
            n = min(self._steps_bound[slot], self.N)
            if n <= 0:
                continue
            if toks is None:
                toks = self.state.tokens.cpu().numpy()  # one device fetch
            out.append((req.index, req.meta, toks[slot, :n].copy()))
        return out

    def _note_launches(self) -> None:
        now = kernel_launches()
        base = self._launch_base
        self.stats.prefill_kernel_launches = now["paged_prefill"] - base["paged_prefill"]
        self.stats.decode_kernel_launches = now["paged_decode"] - base["paged_decode"]
        self.stats.verify_kernel_launches = now["paged_verify"] - base["paged_verify"]
        self.stats.sample_kernel_launches = now["fused_sample"] - base["fused_sample"]

    _SPEC_COUNTERS = ("rounds", "accepted", "live_rounds", "committed")

    def _read_spec_counters(self) -> Dict[str, int]:
        """The device-cumulative spec counters (one copy; zeros for a plain
        engine)."""
        if not self._gamma:
            return dict.fromkeys(self._SPEC_COUNTERS, 0)
        vals = torch.stack([getattr(self.state, k) for k in self._SPEC_COUNTERS]).tolist()
        return dict(zip(self._SPEC_COUNTERS, vals))

    def step(self) -> List[CompletedSequence]:
        """One admit → prefill → segment → harvest turn; returns newly
        completed sequences."""
        self._admit()
        if self.live == 0:
            self._note_launches()
            return []
        if self._ensure_decode_blocks(self.fns.segment_len):
            self._push_tables()
        self._note_block_usage()
        t0 = time.perf_counter()
        self.state, live_steps, steps = self.fns.decode_segment(self.params, self.state)
        self.stats.decode_s += time.perf_counter() - t0
        self.stats.segments += 1
        self.stats.decode_steps += steps
        self.stats.slot_steps += steps * self.B
        self.stats.live_slot_steps += live_steps
        if self._gamma:
            # rows advance unevenly: the device step IS each row's committed
            # length. Read once per segment, with the spec counters
            cur = self._read_spec_counters()
            for k in self._SPEC_COUNTERS:
                setattr(self.stats, f"spec_{k}", cur[k] - self._spec_base[k])
            bound = self.state.step.tolist()
        for slot in range(self.B):
            if self._slots[slot] is not None:
                self._steps_bound[slot] = (int(bound[slot]) if self._gamma else
                                           min(self.N, self._steps_bound[slot] + steps))
        out = self._harvest()
        self._note_launches()
        return out
