"""The generation engines: the serial dense engine and the
continuous-batching engine over a dense per-slot cache or the paged block
pool.

Port of ``trlx_tpu/engine/core.py``: :class:`Engine`,
:class:`SerialEngine`, :class:`ContinuousEngine`, :class:`EngineStats` and
:class:`CompletedSequence`, with the prefix cache, chunked prefill, the
host tier and priority preemption on the paged backend.

:class:`SerialEngine` is plain batch generation behind the engine
interface: it wraps the trainer's serial rollout program
(``ops/sampling.py::generate`` on a dense ``[B, P + N]`` cache, or
``ops/speculative.py::generate_speculative``) unchanged, and each
:meth:`SerialEngine.step` reproduces one such call on a submitted chunk.

The continuous engine is the host half: a queue of prompts and ``B``
slots. On the dense backend (``fns.paged`` is None, JAX's default) every
admission prefills the admitted rows' whole prompts at once into their
slots' cache rows; the prefix cache and chunked prefill need the paged
backend, as in JAX. On the paged backend it adds a refcounted
:class:`~trlx_tpu_torch.engine.allocator.BlockAllocator` over the pool
and a host mirror of the block table, and each :meth:`step` admits
queued prompts into free slots (best priority class first, FIFO within a
class), runs one prefill span for every still-prefilling slot, grows the
decoding rows' tables lazily to cover the next segment, runs one decode
segment (``ops/slot_refill.py``) and harvests finished slots in slot
order. A harvested sequence equals a solo ``ops/sampling.py::generate``
of the same prompt and seed.

- **Prefix cache** (``prefix_cache=True``): admission matches the row's
  padded prompt against the tenant's radix chain
  (``engine/prefix_cache.py``), retains the matched blocks, re-lands
  chunks the host tier holds beyond them, and prefills only the suffix
  (the refill at ``hit``); a seeded row's full prompt blocks are committed
  after the prefill that finished them. Committed KV is valid only under
  the weights that computed it: adopting changed weights flushes the
  cache and the tier. The trainers' engines read the policy's live
  weights, which an optimizer step changes in place, so they pass a
  version (the trainer's weights counter) and the flush follows it, not
  the module's identity.
- **Chunked prefill** (``prefill_chunk=c``): an admitted prompt prefills
  one span per :meth:`step`, up to the next absolute multiple of ``c``,
  between decode segments; mid-prompt spans run the cache-only chunk
  program, the last the refill at ``hit = start``. Leading all-pad
  columns are skipped (``first_real``). ``rollout/decode_stall_*``
  measure how long decoding rows waited on prefill work.
- **Priority preemption**: queued higher-class requests vacate
  still-prefilling lower-class slots at a step boundary; the victim's
  committed chunks enter its tenant's chain first, so its work comes back
  as a prefix hit. ``reserve_slots`` holds slots for interactive traffic.

Speculative segments (``fns.speculative = G > 0``): the engine's params
are a ``(target, draft)`` tuple, adopted as one object by
:meth:`ContinuousEngine.begin_collection` and
:meth:`ContinuousEngine.swap_params`; caches span ``S = P + N + G``
columns; a segment may commit up to ``segment_len · (G + 1)`` tokens per
row, so tables grow by that much, and after each segment every row's
committed length is read from the device ``step``. A harvested sequence
equals a solo ``ops/speculative.py::generate_speculative`` of the row.
Speculation composes with the prefix cache (the target prefills only the
suffix past a hit; the draft prefills whole) and with chunked prefill (the
target's prompt is chunked; the draft is seeded at the final span).

Kernel gauges: ``engine/decode_kernel_launches``,
``engine/prefill_kernel_launches``, ``engine/verify_kernel_launches`` and
``engine/sample_kernel_launches`` are read from the kernel wrappers'
launch counters — what actually launched, never a configuration string.

Tracing (``span`` and ``tracer``, an ``Observability``'s): every segment
runs under a ``rollout/segment`` span, which closes device-complete
because the segment returns step counts read back from the card (that
read is its fence: no event or synchronize is added); each harvested
request emits ``engine/queue_wait`` → ``engine/prefill`` →
``engine/decode`` (and ``engine/spec_verify`` under speculation) on its
slot's track, and each mid-prompt chunk ``engine/prefill_chunk``.

Thread affinity: single-threaded by design — exactly one thread (the
caller, or the serve pump thread) calls ``enqueue_prompts``/``step``.
"""

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from trlx_tpu_torch.engine.allocator import (
    BlockAllocator,
    BlockPoolExhausted,
    TenantQuotaExceeded,
)
from trlx_tpu_torch.engine.prefix_cache import PrefixCache
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
    "Engine",
    "SerialEngine",
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
    # chunked prefill: the next prompt column to prefill (None = prefill
    # done, or the row is not in a slot)
    prefill_pos: Optional[int] = None


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
    prefill_tokens: int = 0  # prompt columns actually prefilled
    prefill_chunk_calls: int = 0  # mid-prompt chunk program calls
    # wall seconds of prefill work that ran while >= 1 decoding slot waited,
    # one sample per such prefill event
    decode_stall_s: float = 0.0
    decode_stall_samples: List[float] = field(default_factory=list)
    # prefix cache
    prefix_enabled: bool = False
    prefix_lookup_blocks: int = 0
    prefix_hit_blocks: int = 0
    prefix_tokens_saved: int = 0  # prompt columns not prefilled
    prefix_evicted_blocks: int = 0
    # host tier: evicted prefix blocks re-landed instead of prefilled
    host_tier_enabled: bool = False
    host_tier_hit_blocks: int = 0
    host_tier_tokens_saved: int = 0
    # still-prefilling lower-class slots vacated for higher-class requests
    preempted_rows: int = 0
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

    @property
    def prefix_hit_rate(self) -> float:
        if self.prefix_lookup_blocks == 0:
            return 0.0
        return self.prefix_hit_blocks / self.prefix_lookup_blocks

    @property
    def decode_stall_max(self) -> float:
        return float(max(self.decode_stall_samples)) if self.decode_stall_samples else 0.0

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
            "rollout/decode_stall_max": self.decode_stall_max,
            "rollout/prefill_chunks": float(self.prefill_chunk_calls),
            "engine/kv_blocks_in_use": float(self.kv_blocks_in_use),
            "engine/block_pool_occupancy": self.kv_blocks_in_use / max(self.kv_blocks_total, 1),
            "engine/decode_kernel_launches": float(self.decode_kernel_launches),
            "engine/prefill_kernel_launches": float(self.prefill_kernel_launches),
            "engine/sample_kernel_launches": float(self.sample_kernel_launches),
        }
        if self.prefix_enabled:
            stats["engine/prefix_hit_rate"] = self.prefix_hit_rate
            stats["engine/prefix_tokens_saved"] = float(self.prefix_tokens_saved)
        if self.preempted_rows:
            stats["engine/preempted_rows"] = float(self.preempted_rows)
        if self.host_tier_enabled:
            stats["engine/host_tier_hit_blocks"] = float(self.host_tier_hit_blocks)
            stats["engine/host_tier_tokens_saved"] = float(self.host_tier_tokens_saved)
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


class Engine:
    """The contract every generation engine keeps: feed prompts, turn the
    crank, collect individually completed sequences. The trainers talk
    only to this surface (the paged collection through :meth:`step`,
    ``generate`` through :class:`SerialEngine`)."""

    stats: EngineStats

    def enqueue_prompts(self, input_ids: np.ndarray, attention_mask: np.ndarray,
                        seeds: np.ndarray, metas: Optional[List[Any]] = None) -> None:
        raise NotImplementedError

    def step(self) -> List[CompletedSequence]:
        raise NotImplementedError

    @property
    def busy(self) -> bool:
        raise NotImplementedError

    def run(self) -> List[CompletedSequence]:
        """Drain queue and slots to completion."""
        out: List[CompletedSequence] = []
        while self.busy:
            out.extend(self.step())
        return out


class SerialEngine(Engine):
    """Plain batch generation behind the :class:`Engine` interface.

    Wraps ``fn(params, input_ids, attention_mask, seeds)`` — the trainer's
    serial rollout program, unchanged — which returns a
    :class:`~trlx_tpu_torch.ops.sampling.GenerationOutput`, or
    ``(output, stats)`` from the speculative sampler. Whole chunks are
    buffered with the seeds they were submitted under, so each
    :meth:`step` reproduces exactly one serial :meth:`generate` call."""

    def __init__(self, generate_fn: Callable, params: Any, pad_token_id: int):
        self._fn = generate_fn
        self.params = params
        self.pad_token_id = int(pad_token_id)
        self._chunks: deque = deque()
        self._submitted = 0
        self.stats = EngineStats()

    def generate(self, input_ids, attention_mask, seeds):
        """The batch-synchronous path the trainer's ``generate`` takes:
        whatever the wrapped program returns."""
        return self._fn(self.params, input_ids, attention_mask, seeds)

    def enqueue_prompts(self, input_ids, attention_mask, seeds=None, metas=None):
        raise NotImplementedError(
            "SerialEngine decodes whole chunks: use submit_chunk(input_ids, "
            "attention_mask, seeds) (a queue of single prompts is the continuous "
            "engine's)")

    def submit_chunk(self, input_ids, attention_mask, seeds, metas=None) -> None:
        input_ids, attention_mask, seeds = (
            torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int64)
            for x in (input_ids, attention_mask, seeds))
        idx = list(range(self._submitted, self._submitted + input_ids.shape[0]))
        self._submitted += input_ids.shape[0]
        self._chunks.append((idx, input_ids, attention_mask, seeds, metas))

    @property
    def busy(self) -> bool:
        return bool(self._chunks)

    def step(self) -> List[CompletedSequence]:
        if not self._chunks:
            return []
        idx, ids, mask, seeds, metas = self._chunks.popleft()
        t0 = time.perf_counter()
        out = self.generate(ids, mask, seeds)
        if type(out) is tuple:  # the speculative sampler: (output, stats)
            out = out[0]
        host = {
            "tokens": out.response_tokens.cpu().numpy(),
            "logprobs": out.response_logprobs.cpu().numpy(),
            "values": out.response_values.cpu().numpy(),
            "mask": out.response_mask.cpu().numpy(),
        }
        self.stats.decode_s += time.perf_counter() - t0
        self.stats.segments += 1
        n = len(idx)
        steps = int(host["mask"].sum(axis=1).max()) if n else 0
        self.stats.decode_steps += steps
        self.stats.slot_steps += steps * n
        self.stats.live_slot_steps += int(host["mask"].sum())
        self.stats.harvested += n
        self.stats.note_harvest(host["tokens"], host["mask"])
        ids, mask = ids.numpy(), mask.numpy()
        return [
            CompletedSequence(
                index=idx[i], prompt_ids=ids[i], prompt_mask=mask[i],
                tokens=host["tokens"][i], logprobs=host["logprobs"][i],
                values=host["values"][i], mask=host["mask"][i],
                meta=metas[i] if metas is not None else None,
            )
            for i in range(n)
        ]


class ContinuousEngine(Engine):
    """Slot-refill decode over a fixed ``[B]`` slot batch on the paged
    block pool. ``fns`` come from
    :func:`trlx_tpu_torch.ops.slot_refill.make_slot_refill_fns`; ``model``
    is the served ``CausalTransformer`` (its device must be ``fns.device``).
    ``prefix_cache`` turns on shared-prefix prefill skipping (capped at
    ``prefix_capacity_blocks`` entries when > 0); ``prefill_chunk`` the
    chunked-prefill scheduling (see the module docstring).
    """

    def __init__(
        self,
        fns: Any,  # SlotRefillFns
        model: Any,
        pad_token_id: int,
        prewarm: bool = True,
        prefix_cache: bool = False,
        prefix_capacity_blocks: int = 0,
        prefill_chunk: int = 0,
        span: Optional[Callable[..., Any]] = None,
        tracer: Any = None,
    ):
        self._gamma = int(fns.speculative)
        # an Observability.span-shaped callable: every segment runs under a
        # "rollout/segment" span; a tracer adds each request's lifecycle
        # events at harvest (engine/queue_wait → prefill → decode, and
        # engine/spec_verify under speculation) and engine/prefill_chunk
        self._span = span
        self._tracer = tracer
        self._chunk = int(prefill_chunk)
        if self._chunk < 0:
            raise ValueError(f"prefill_chunk {self._chunk} must be >= 0")
        self.fns = fns
        self.params = model
        self.pad_token_id = int(pad_token_id)
        self.state = fns.init_state()
        self.B = fns.batch_size
        self.P = fns.prompt_len
        self.N = fns.max_new_tokens
        self._S = self.P + self.N + self._gamma
        self._queue: deque = deque()
        self._slots: List[Optional[_Request]] = [None] * self.B
        # True once the slot's final prefill span ran (the refill seeded its
        # state row); a still-prefilling slot neither decodes nor harvests
        self._seeded: List[bool] = [False] * self.B
        self._submitted = 0
        self.stats = EngineStats()
        # host tier of evicted prefix blocks (attach_host_tier)
        self.host_tier: Any = None
        # slots only interactive-class requests may take
        self.reserve_slots = 0
        # requests that failed admission (tenant quota): the owner drains them
        self.failed: deque = deque()

        # the paged geometry, or None for the dense backend
        self.spec = fns.paged
        self.allocator: Optional[BlockAllocator] = None
        self.prefix: Optional[PrefixCache] = None
        self._steps_bound = [0] * self.B
        if self.spec is not None:
            self._bs = self.spec.block_size
            self._TB = num_table_blocks(self._S, self._bs)
            self.allocator = BlockAllocator(self.spec.max_blocks)
            if prefix_cache:
                self.prefix = PrefixCache(self._bs, prefix_capacity_blocks)
                self.stats.prefix_enabled = True
            # host mirror of the device block table: authoritative between
            # programs (the refill applies the same rows on the card;
            # segment growth pushes the whole mirror)
            self._tables = np.zeros((self.B, self._TB), np.int32)
            self._row_blocks: List[Optional[List[int]]] = [None] * self.B
            self._alloc_upto = [0] * self.B
            self.stats.kv_blocks_total = self.spec.max_blocks - 1
            self._block_bytes = block_bytes(self.state.cache)
        elif prefix_cache:
            raise ValueError("engine.prefix_cache requires the paged KV backend "
                             "(engine.backend: paged) — dense per-slot caches cannot "
                             "share blocks")
        elif self._chunk:
            raise ValueError("engine.prefill_chunk requires the paged KV backend "
                             "(engine.backend: paged) — the chunk programs commit "
                             "prompt spans through the block table")
        self.stats.spec_gamma = self._gamma
        self.stats.kv_cache_bytes = kv_bytes(self.state.cache)
        if self._gamma:
            # the draft's dense [B, S] cache is persistent engine state too
            self.stats.kv_cache_bytes += kv_bytes(self.state.d_cache)
        self._spec_base = self._read_spec_counters()
        # the weights the pool's committed KV (and every prefix entry) was
        # computed under: by identity, or by the caller's version when it
        # gives one (a module updated in place keeps its identity)
        self._kv_params = model
        self._params_version: Optional[int] = None
        before = kernel_launches()
        if prewarm:
            self.state = self.fns.prewarm(self.params, self.state)
        self._launch_base = kernel_launches()
        # the no-op prewarm refills' launches, which no collection counts
        self.prewarm_launches = {k: self._launch_base[k] - before[k] for k in before}

    def begin_collection(self, model: Any = None, version: Optional[int] = None) -> None:
        """Reuse this engine for a fresh collection: drop leftovers of an
        aborted run, adopt ``model`` (flushing the prefix cache and the
        tier when the weights changed: a new object, or with ``version``
        a new version) and reset the per-collection stats."""
        self._queue.clear()
        self.failed.clear()
        for slot in range(self.B):
            if self._slots[slot] is None:
                continue
            if self.spec is not None:
                if self._row_blocks[slot] is not None:
                    self.allocator.release(self._row_blocks[slot])
                self._row_blocks[slot] = None
                self._alloc_upto[slot] = 0
            self._steps_bound[slot] = 0
            self._slots[slot] = None
            self._seeded[slot] = False
        self.state.done.fill_(True)
        if model is not None:
            self.swap_params(model, version)
        self.stats = EngineStats(
            kv_cache_bytes=self.stats.kv_cache_bytes,
            kv_blocks_total=self.stats.kv_blocks_total,
            prefix_enabled=self.stats.prefix_enabled,
            host_tier_enabled=self.stats.host_tier_enabled,
            spec_gamma=self._gamma,
        )
        self._spec_base = self._read_spec_counters()
        if self.allocator is not None:
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

    def _params_changed(self, model: Any, version: Optional[int]) -> bool:
        """One int compare when both sides carry a version, identity
        otherwise."""
        if version is not None and self._params_version is not None:
            return version != self._params_version
        return not self._same_params(model, self._kv_params)

    def swap_params(self, model: Any, version: Optional[int] = None) -> bool:
        """Adopt an updated model — or ``(target, draft)`` pair, as one
        object, so a swap never verifies an old target against a new draft
        — at a step boundary. Changed weights flush the prefix cache and
        the host tier (their KV was computed under the old ones). Returns
        True when they changed."""
        changed = self._params_changed(model, version)
        if changed:
            if self.prefix is not None:
                self.prefix.clear(self.allocator)
            if self.host_tier is not None:
                self.host_tier.clear()
            self._kv_params = model
        self._params_version = version
        self.params = model
        return changed

    def attach_host_tier(self, tier: Any) -> None:
        """Put a :class:`~trlx_tpu_torch.serve.tiering.HostTier` behind the
        prefix cache: evicted entries spill their blocks host-side, and
        admission re-lands host-resident chunks instead of prefilling."""
        if self.prefix is None:
            raise ValueError("host tiering requires the prefix cache (engine.prefix_cache: "
                             "true) — only committed prefix entries ever spill")
        self.host_tier = tier
        self.stats.host_tier_enabled = True
        self.prefix.spill = self._spill_entry

    def _spill_entry(self, entry: Any) -> None:
        """Prefix-cache eviction hook: copy the victim's block host-side
        before the cache drops its ref."""
        self.host_tier.spill(entry.digest, self.state.cache.pool, entry.block)

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
        ``tenant`` scopes the rows' prefix-cache namespace and block quota,
        ``klass`` is their priority class (:data:`SERVE_CLASSES`). Rows
        flagged ``greedy`` decode greedily; the rest sample (when the
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

    # -- paged-block bookkeeping ----------------------------------------

    def _alloc_blocks(self, n: int, tenant: Optional[str] = None) -> List[int]:
        """Allocate with one eviction retry: under pool pressure, drop LRU
        prefix entries (their blocks free unless a live row shares them);
        a quota'd tenant's pressure evicts only that tenant's entries."""
        if n == 0:
            return []
        try:
            return self.allocator.alloc(n, tenant=tenant)
        except TenantQuotaExceeded:
            if self.prefix is None:
                raise
            quota = self.allocator.tenant_quota(tenant)
            headroom = max((quota or 0) - self.allocator.tenant_blocks_in_use(tenant), 0)
            self.stats.prefix_evicted_blocks += self.prefix.evict(
                self.allocator, blocks_needed=n - headroom, tenant=tenant)
            # still over quota: the caller fails this request, not the engine
            return self.allocator.alloc(n, tenant=tenant)
        except BlockPoolExhausted:
            if self.prefix is None:
                raise
            self.stats.prefix_evicted_blocks += self.prefix.evict(
                self.allocator, blocks_needed=n - self.allocator.blocks_free)
            return self.allocator.alloc(n, tenant=tenant)

    def _note_block_usage(self) -> None:
        if self.allocator is None:
            return
        self.stats.kv_blocks_in_use = self.allocator.high_water
        self.stats.kv_bytes_high_water = self.allocator.high_water * self._block_bytes

    def _prepare_row(self, req: _Request, slot: int) -> int:
        """Assign the blocks of one admitted row: shared prefix blocks from
        the cache (one more ref each), host-tier re-lands beyond the device
        hit, fresh private blocks for the rest of the prompt. Returns the
        hit in cache columns (block-aligned, capped so the last prompt
        block is always prefilled: its last position seeds the sampler)."""
        shared: List[int] = []
        cap = (self.P - 1) // self._bs
        if self.prefix is not None:
            shared = self.prefix.match(req.input_ids, req.attention_mask,
                                       tenant=req.tenant)[:cap]
            self.stats.prefix_lookup_blocks += cap
            self.stats.prefix_hit_blocks += len(shared)
        # retain the matched chain before allocating: an eviction under
        # pool pressure then only drops the cache's ref, and the block can
        # never come back as this row's writable fresh block
        self.allocator.retain(shared)
        relanded = self._reland_from_tier(req, len(shared), cap, shared)
        hit_chain = shared + relanded
        n_prompt_blocks = (self.P - 1) // self._bs + 1
        try:
            fresh = self._alloc_blocks(n_prompt_blocks - len(hit_chain), tenant=req.tenant)
        except (BlockPoolExhausted, TenantQuotaExceeded):
            self.allocator.release(hit_chain)
            raise
        row = np.zeros(self._TB, np.int32)
        row[: len(hit_chain)] = hit_chain
        row[len(hit_chain):n_prompt_blocks] = fresh
        self._tables[slot] = row
        self._row_blocks[slot] = hit_chain + fresh
        self._alloc_upto[slot] = n_prompt_blocks
        self._steps_bound[slot] = 0
        return len(hit_chain) * self._bs

    def _reland_from_tier(self, req: _Request, n_hit: int, cap: int,
                          shared: List[int]) -> List[int]:
        """Probe the host tier for the consecutive chunks beyond the device
        hit; write each host-resident chunk into a fresh device block and
        commit it back into the tenant's chain. Returns the re-landed
        blocks, the row's ref held."""
        if self.host_tier is None or n_hit >= cap:
            return []
        digests = self.prefix.chain_digests(req.input_ids, req.attention_mask, cap,
                                            tenant=req.tenant)
        run: List[bytes] = []
        for i in range(n_hit, min(cap, len(digests))):
            if not self.host_tier.probe(digests[i]):
                break
            run.append(digests[i])
        if not run:
            return []
        try:
            blocks = self._alloc_blocks(len(run), tenant=req.tenant)
        except (BlockPoolExhausted, TenantQuotaExceeded):
            return []  # the tier is an optimisation: prefill instead
        self.host_tier.reland_many(run, self.state.cache.pool, blocks)
        self.prefix.insert(req.input_ids, req.attention_mask, shared + blocks,
                           self.allocator, tenant=req.tenant)
        self.stats.host_tier_hit_blocks += len(blocks)
        self.stats.host_tier_tokens_saved += len(blocks) * self._bs
        return blocks

    def _ensure_decode_blocks(self, segment_len: int) -> bool:
        """Grow each decoding row's table to cover the columns the next
        segment may write. Returns True when a table changed."""
        dirty = False
        for slot in range(self.B):
            if self._slots[slot] is None or not self._seeded[slot]:
                continue
            # a spec segment commits up to (gamma + 1) tokens per round
            need_cols = self.P + min(self.N, self._steps_bound[slot]
                                     + segment_len * (self._gamma + 1))
            need_blocks = (need_cols - 1) // self._bs + 1
            have = self._alloc_upto[slot]
            if need_blocks > have:
                fresh = self._alloc_blocks(need_blocks - have)
                self._tables[slot, have:need_blocks] = fresh
                self._row_blocks[slot].extend(fresh)
                self._alloc_upto[slot] = need_blocks
                dirty = True
        return dirty

    def _push_tables(self) -> None:
        self.state.cache.block_table.copy_(torch.as_tensor(self._tables))

    # -- the slot-refill state machine -----------------------------------

    def _decoding(self) -> int:
        """Slots holding a seeded (decoding or awaiting-harvest) row: the
        population a prefill event stalls."""
        return sum(1 for s in range(self.B) if self._slots[s] is not None and self._seeded[s])

    def _note_prefill_event(self, waiting: int, t0: float, t1: float) -> None:
        self.stats.refill_s += t1 - t0
        if waiting > 0:
            self.stats.decode_stall_s += t1 - t0
            self.stats.decode_stall_samples.append(t1 - t0)

    @staticmethod
    def _rank(req: _Request) -> int:
        return _CLASS_RANK[req.klass]

    def _pop_next(self, only_interactive: bool = False) -> Optional[_Request]:
        """Best-class-first, FIFO-within-class (by submission index) pop: a
        requeued preemption victim's lower index restores its place in its
        class. With ``only_interactive`` (the reserve-slot guard) only
        interactive requests are eligible."""
        best_i, best_key = -1, None
        for i, req in enumerate(self._queue):
            rank = self._rank(req)
            if only_interactive and rank > 0:
                continue
            key = (rank, req.index)
            if best_key is None or key < best_key:
                best_i, best_key = i, key
        if best_key is None:
            return None
        req = self._queue[best_i]
        del self._queue[best_i]
        return req

    def _pop_admissible(self) -> Optional[_Request]:
        """The next request a free slot may take: once non-interactive rows
        hold ``B - reserve_slots`` slots, interactive ones only."""
        only_interactive = False
        if self.reserve_slots > 0:
            non_interactive = sum(1 for r in self._slots if r is not None and self._rank(r) > 0)
            only_interactive = non_interactive >= self.B - self.reserve_slots
        return self._pop_next(only_interactive)

    def _preempt_slot(self, slot: int) -> None:
        """Vacate one still-prefilling slot: its committed prompt chunks
        enter the tenant's chain first (the insert retains them, so they
        come back as a prefix hit on re-admission), then the row's block
        refs drop and the request returns to the queue."""
        req = self._slots[slot]
        pos = req.prefill_pos or 0
        if self.prefix is not None and pos >= self._bs:
            n_committed = min(pos // self._bs, (self.P - 1) // self._bs)
            self.prefix.insert(req.input_ids, req.attention_mask,
                               list(self._tables[slot, :n_committed]), self.allocator,
                               tenant=req.tenant)
        self.allocator.release(self._row_blocks[slot])
        self._row_blocks[slot] = None
        self._alloc_upto[slot] = 0
        self._steps_bound[slot] = 0
        self._slots[slot] = None
        self._seeded[slot] = False
        req.prefill_pos = None
        self._queue.append(req)
        self.stats.preempted_rows += 1

    def _preempt_for_priority(self) -> None:
        """Queued higher-class requests that cannot find a free slot vacate
        still-prefilling lower-class slots (worst class first, least
        progressed first). Seeded slots are never preempted: their KV would
        be lost mid-sequence."""
        if not self._queue:
            return
        free = sum(1 for s in range(self.B) if self._slots[s] is None)
        waiting = sorted(self._rank(r) for r in self._queue)
        victims = sorted(
            (s for s in range(self.B) if self._slots[s] is not None and not self._seeded[s]),
            key=lambda s: (-self._rank(self._slots[s]), self._slots[s].prefill_pos or 0),
        )
        for slot in victims:
            vrank = self._rank(self._slots[slot])
            demand = sum(1 for r in waiting if r < vrank)
            if demand <= free:
                continue  # free slots already cover the outranking demand
            waiting.append(vrank)
            self._preempt_slot(slot)
            free += 1

    def _admit(self) -> None:
        """Move queued requests into free slots, best class first (FIFO
        within a class), and assign their blocks (prefix hits shared,
        host-tier re-lands, the rest fresh); each row's ``prefill_pos``
        starts at its hit, and :meth:`_advance_prefill` runs the prefill
        work. ``reserve_slots`` holds the last free slots for interactive
        requests: once non-interactive rows hold ``B - reserve_slots``
        slots, only interactive ones are admitted. A tenant whose quota
        cannot cover its prompt fails onto :attr:`failed` instead of
        failing the engine, and the slot goes to the next request. The
        dense backend prefills the admitted rows' whole prompts at once
        (:meth:`_admit_dense`)."""
        if self.spec is None:
            self._admit_dense()
            return
        self._preempt_for_priority()
        free = deque(s for s in range(self.B) if self._slots[s] is None)
        admitted = 0
        while free and self._queue:
            req = self._pop_admissible()
            if req is None:
                break
            slot = free[0]
            try:
                hit = self._prepare_row(req, slot)
            except TenantQuotaExceeded as e:
                self.failed.append((req, str(e)))
                continue
            free.popleft()
            self._slots[slot] = req
            self._seeded[slot] = False
            admitted += 1
            pos0 = hit
            if self._chunk:
                # skip the all-pad leading columns (never visible: their
                # slot mask is 0), starting at the chunk-grid point at or
                # below the first real column; the final span stays
                # non-empty for an all-pad row
                first_real = self.P - int(np.sum(req.attention_mask))
                pos0 = max(hit, min((first_real // self._chunk) * self._chunk,
                                    ((self.P - 1) // self._chunk) * self._chunk))
            req.prefill_pos = pos0
            self.stats.prefix_tokens_saved += hit
        self.stats.refilled_rows += admitted
        self._note_block_usage()

    def _admit_dense(self) -> None:
        """Dense backend: fill the free slots (best class first, FIFO
        within a class; ``reserve_slots`` as on the paged backend) and
        prefill all admitted rows in one grouped refill, which seeds
        them. Every occupied slot is seeded, so nothing is preempted."""
        free = deque(s for s in range(self.B) if self._slots[s] is None)
        rows: List[_Request] = []
        slots: List[int] = []
        while free and self._queue:
            req = self._pop_admissible()
            if req is None:
                break
            slot = free.popleft()
            self._slots[slot] = req
            rows.append(req)
            slots.append(slot)
        if not rows:
            return
        waiting = self._decoding()
        t0 = time.perf_counter()
        self.state = self.fns.refill_rows(
            self.params, self.state, np.stack([r.input_ids for r in rows]),
            np.stack([r.attention_mask for r in rows]), np.asarray(slots, np.int64),
            np.asarray([r.seed for r in rows], np.int64),
            greedy=np.asarray([r.greedy for r in rows], bool))
        if self.fns.device.type == "cuda":
            torch.cuda.synchronize(self.fns.device)
        t1 = time.perf_counter()
        self.stats.refill_prefills += 1
        self.stats.prefill_tokens += self.P * len(rows)
        self._note_prefill_event(waiting, t0, t1)
        for req, slot in zip(rows, slots):
            req.t_refill0, req.t_refill1 = t0, t1
            self._seeded[slot] = True
            self._steps_bound[slot] = 0
            wait = max(t0 - req.t_enqueue, 0.0)
            self.stats.queue_wait_s += wait
            self.stats.queue_wait_samples.append(wait)
        self.stats.refilled_rows += len(rows)

    def _next_span(self, pos: int) -> int:
        """End column of the prefill span starting at ``pos``: the whole
        remaining prompt without chunking, else the next absolute multiple
        of the chunk size (rows admitted at different hits converge onto
        one span grid after their first chunk, so they group)."""
        if not self._chunk:
            return self.P
        return min(self.P, (pos // self._chunk + 1) * self._chunk)

    def _advance_prefill(self) -> None:
        """One prefill span for every still-prefilling slot, grouped by
        identical ``(start, end)``: a mid-prompt span runs the cache-only
        chunk program, a span reaching ``P`` the refill at ``hit = start``,
        which seeds the slot. Prefix-cache insertion comes after every
        program call of the event."""
        pending = [(s, self._slots[s].prefill_pos) for s in range(self.B)
                   if self._slots[s] is not None and self._slots[s].prefill_pos is not None]
        if not pending:
            return
        waiting = self._decoding()
        by_span: Dict[tuple, List[int]] = {}
        for slot, pos in pending:
            by_span.setdefault((pos, self._next_span(pos)), []).append(slot)
        finished: List[int] = []
        for (start, end), slots in sorted(by_span.items()):
            rows = [self._slots[s] for s in slots]
            t0 = time.perf_counter()
            ids = np.stack([r.input_ids for r in rows])
            masks = np.stack([r.attention_mask for r in rows])
            tables = np.stack([self._tables[s] for s in slots])
            if end < self.P:
                self.state = self.fns.prefill_chunk_rows(self.params, self.state, ids, masks,
                                                         tables, start, end)
                self.stats.prefill_chunk_calls += 1
            else:
                self.state = self.fns.refill_rows(
                    self.params, self.state, ids, masks, np.asarray(slots, np.int64),
                    np.asarray([r.seed for r in rows], np.int64), tables, hit=start,
                    greedy=np.asarray([r.greedy for r in rows], bool))
                finished.extend(slots)
            # wait for the span, so the prefill event measures device time
            if self.fns.device.type == "cuda":
                torch.cuda.synchronize(self.fns.device)
            t1 = time.perf_counter()
            self.stats.refill_prefills += 1
            self.stats.prefill_tokens += (end - start) * len(rows)
            self._note_prefill_event(waiting, t0, t1)
            for req, slot in zip(rows, slots):
                if req.t_refill0 == 0.0:
                    req.t_refill0 = t0
                    wait = max(t0 - req.t_enqueue, 0.0)
                    self.stats.queue_wait_s += wait
                    self.stats.queue_wait_samples.append(wait)
                if self._tracer is not None and end < self.P:
                    self._tracer.add_complete_event(
                        "engine/prefill_chunk", t0, t1, track=f"engine/slot{slot}",
                        index=req.index, start=start, end=end)
                if end < self.P:
                    req.prefill_pos = end
                else:
                    req.prefill_pos = None
                    req.t_refill1 = t1
                    self._seeded[slot] = True
        if self.prefix is not None and finished:
            # commit only the blocks a later match can use: hits are capped
            # at (P - 1) // bs blocks
            n_full = (self.P - 1) // self._bs
            for slot in finished:
                req = self._slots[slot]
                self.prefix.insert(req.input_ids, req.attention_mask,
                                   list(self._tables[slot, :n_full]), self.allocator,
                                   tenant=req.tenant)
        self._note_block_usage()

    def _harvest(self) -> List[CompletedSequence]:
        done = self.state.done.cpu().numpy()
        # a still-prefilling slot reads done=True from its empty state row:
        # it has not started
        finished = [s for s in range(self.B)
                    if self._slots[s] is not None and self._seeded[s] and done[s]]
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
            self._seeded[slot] = False
            self._trace_request(req, slot, t_harvest, gen_len=float(host["mask"][j].sum()))
            if self.spec is not None:
                # blocks the prefix cache (or a sharing row) still holds
                # stay allocated
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

    def _trace_request(self, req: _Request, slot: int, t_harvest: float,
                       gen_len: float = 0.0) -> None:
        """The request's lifecycle events (queue wait → prefill → decode,
        closed by the harvest) on its slot's track: a slot holds one
        request at a time, so a stalled generation shows on its row."""
        if self._tracer is None or req.t_refill1 <= 0.0:
            return
        track = f"engine/slot{slot}"
        self._tracer.add_complete_event("engine/queue_wait", req.t_enqueue, req.t_refill0,
                                        track=track, index=req.index)
        self._tracer.add_complete_event("engine/prefill", req.t_refill0, req.t_refill1,
                                        track=track, index=req.index)
        self._tracer.add_complete_event("engine/decode", req.t_refill1, t_harvest,
                                        track=track, index=req.index)
        if self._gamma:
            # the decode window is draft-propose → verify rounds: one span
            # per request, so a low-acceptance row shows on its track
            self._tracer.add_complete_event("engine/spec_verify", req.t_refill1, t_harvest,
                                            track=track, index=req.index, gamma=self._gamma,
                                            tokens=gen_len)

    def progress_snapshot(self) -> List[tuple]:
        """``(index, meta, tokens)`` for every decoding slot: the host copy
        of the row's committed response so far (for token streaming)."""
        out: List[tuple] = []
        toks = None
        for slot in range(self.B):
            req = self._slots[slot]
            if req is None or not self._seeded[slot]:
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
        """One admit → prefill span → segment → harvest turn; returns newly
        completed sequences. With ``prefill_chunk`` set, the prefill work
        of one step is at most one chunk per still-prefilling slot."""
        self._admit()
        if self.spec is not None:
            self._advance_prefill()
        if self._decoding() == 0:
            self._note_launches()
            return []
        if self.spec is not None:
            if self._ensure_decode_blocks(self.fns.segment_len):
                self._push_tables()
            self._note_block_usage()
        if self._span is not None:
            # decode_segment returns host counts read from the card after
            # its last step, so the span closes device-complete: that read
            # is the fence, and no event or synchronize is added
            with self._span("rollout/segment", live=self.live, pending=self.pending) as sp:
                self.state, live_steps, steps = self.fns.decode_segment(self.params, self.state)
            self.stats.decode_s += sp.duration
        else:
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
            if self._slots[slot] is not None and self._seeded[slot]:
                self._steps_bound[slot] = (int(bound[slot]) if self._gamma else
                                           min(self.N, self._steps_bound[slot] + steps))
        out = self._harvest()
        self._note_launches()
        return out
