"""Slot-refill decode: the device half of the continuous-batching engine,
in PyTorch.

Port of ``trlx_tpu/ops/slot_refill.py``: the dense backend (``paged=None``,
a per-slot ``[B, S]`` KV cache, JAX's default) and the paged backend
(``paged=PagedSpec(...)``), plain or speculative (``speculative=G``).
Invalid combinations raise ``ValueError`` with the JAX module's reasons.

Decode runs in fixed-size **segments** over per-slot state: after each
segment the host engine harvests finished slots and refills them with
fresh prompts through an on-demand prefill into the freed slots. Row
independence is what makes this exact: every slot decodes at its own cache
column (a ``[B]`` ``cache_index``), samples from its own seed at its own
step, and frozen (finished) slots neither commit K/V nor advance — so a
harvested sequence equals what a solo :func:`ops.sampling.generate` of the
same prompt and seed produces.

Compute paths (``decode_kernel`` / ``prefill_kernel``, the engine's knobs
of the same names; both default to ``"pallas"`` with a paged backend and
are ``"xla"`` without one):

- ``prefill_kernel: pallas`` — the in-place paged prefill: the model's
  paged branch commits the span's K/V through the rows' block tables and
  calls the paged-prefill kernel. ``xla`` — the gather reference: a cold
  span (start 0) runs on a fresh dense ``[R, S]`` cache, a span after
  committed columns (a prefix hit, an earlier chunk) on the gathered dense
  view of the rows' blocks (``ops/paged_kv.py::gather_view``); the written
  span is committed back with ``scatter_span``. Multi-token passes on a
  dense cache at a scalar column run the flash-attention forward kernel on
  the card. The dense backend prefills cold and scatters whole rows into
  its cache.
- ``decode_kernel: pallas`` — each step samples with the fused kernel
  (``ops/paged_attention.py::sample_token_fused``) and runs the paged-decode
  kernel, frozen rows' tables poisoned out of range. ``xla`` — one
  ``gather_view`` of the slots' tables per segment, the dense loop on it
  (the plain sampler and plain attention, as the dense backend runs), and
  one ``scatter_steps`` commit of each row's live columns.

Refills pad ``R`` rows to a power-of-two bucket (padding rows carry
out-of-range tables, so every write drops). ``hit > 0`` (a prefix cache
hit, or the last span of a chunked prefill) runs only the suffix ``[hit,
P)`` at ``cache_index = hit``: its queries attend to the committed columns
below ``hit``, and the last position's logits seed the sampler.
``prefill_chunk_rows`` commits a mid-prompt span ``[start, end)`` to the
pool only (paged backends); keys keep the full width ``S`` with columns
``>= end`` masked.

Speculative segments (``speculative = G > 0``, paged only): the programs
take ``params = (target, draft)`` and the state is a :class:`SpecState`. A
refill prefills the target's suffix ``[hit, P)`` (K/V only: the first
round re-feeds the last prompt token) and the draft's whole prompt on a
fresh dense ``[R, S]`` cache, scattered whole-row into the state's draft
cache; chunked prefill chunks only the target's prompt. A segment runs up
to ``segment_len`` rounds of ``ops/speculative.py::spec_round_step``,
with ``transition_mask`` applied to draft proposals and verify
distributions separately (not composed into ``adjust_logits``). Under
``decode_kernel: pallas`` each round attaches a table in which rows done
at the round's start are poisoned, and the verify writes its probe columns
``[c − 1, c + G)`` in place (rejected ones sit above every committed
length, invisible through the slot mask). Under ``xla`` the rounds run on
one gathered view and ``scatter_steps`` commits ``[P + step_in − 1, P +
step_out]`` per row on exit; rejected probes fall outside the count.
"""

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.ops.kernel_utils import resolve_device
from trlx_tpu_torch.ops.paged_attention import sample_token_fused
from trlx_tpu_torch.ops.paged_kv import (
    PagedKV,
    PagedSpec,
    attach_block_table,
    gather_view,
    init_paged_kv,
    scatter_span,
    scatter_steps,
)
from trlx_tpu_torch.ops.sampling import (
    GenerationConfig,
    last_step_info,
    sample_token_from_logits,
    tree_map,
)
from trlx_tpu_torch.ops.speculative import spec_round_step

__all__ = ["SlotState", "SpecState", "SlotRefillFns", "make_slot_refill_fns"]

KERNELS = ("xla", "pallas")


@dataclasses.dataclass
class SlotState:
    """Per-slot decode state (``B`` slots over ``S = P + N`` cache columns).
    Tensors are updated in place by the refill and segment programs."""

    tokens: torch.Tensor  # [B, N] int32 response tokens (pad after eos)
    logprobs: torch.Tensor  # [B, N] f32 behaviour logprobs
    values: torch.Tensor  # [B, N] f32 value-head outputs (0 if no head)
    mask: torch.Tensor  # [B, N] int32, 1 on real response tokens
    slot_mask: torch.Tensor  # [B, S] int64 attention slot mask
    cache: Any  # PagedKV (block pool + [B, TB] table), or the dense [B, S] cache
    logits: torch.Tensor  # [B, V] logits feeding the next sample
    # last-position views of the model's outputs (the adjust hook reads
    # them), shaped from the model's first refill; tuple leaves allowed
    step_out: Dict[str, Any]
    prompt_len: torch.Tensor  # [B] int64 real prompt lengths
    done: torch.Tensor  # [B] bool finished (or empty) slots
    step: torch.Tensor  # [B] int64 per-slot decode step
    seed: torch.Tensor  # [B] int64 per-slot sampling seeds
    greedy: torch.Tensor  # [B] bool slots decoded greedily (zero noise)


@dataclasses.dataclass
class SpecState:
    """Per-slot state of the speculative segments: solo
    ``generate_speculative``'s geometry per slot — buffers ``[B, NB = N +
    G + 1]`` (a round's block write never clips), the target's ``S = P +
    N + G`` columns through the block table, the draft's own dense ``[B,
    S]`` cache. ``step`` counts committed tokens (rows advance unevenly);
    ``round`` is the per-row round counter behind the draws (reset at
    refill). The four scalar counters are cumulative; the engine
    differences them per collection."""

    tokens: torch.Tensor  # [B, NB] int32 response tokens (pad after eos)
    logprobs: torch.Tensor  # [B, NB] f32 target behaviour logprobs
    values: torch.Tensor  # [B, NB] f32 value-head outputs (0 if no head)
    mask: torch.Tensor  # [B, NB] int32, 1 on real response tokens
    prompt_mask: torch.Tensor  # [B, P] int64 (round masks are rebuilt from it)
    cache: PagedKV  # target block pool + [B, TB] block table
    d_cache: list  # draft dense per-layer {"k", "v"} of [B, S, KV, D]
    t_last: torch.Tensor  # [B] int64 last committed token (re-fed each round)
    prompt_len: torch.Tensor  # [B] int64 real prompt lengths
    done: torch.Tensor  # [B] bool finished (or empty) slots
    step: torch.Tensor  # [B] int64 committed generated tokens (solo's n_out)
    seed: torch.Tensor  # [B] int64 per-slot sampling seeds
    round: torch.Tensor  # [B] int64 per-slot round counters
    rounds: torch.Tensor  # [] int64 rounds run
    accepted: torch.Tensor  # [] int64 accepted draft tokens (before clipping)
    live_rounds: torch.Tensor  # [] int64 live row-rounds
    committed: torch.Tensor  # [] int64 committed tokens (after clipping)


class SlotRefillFns(NamedTuple):
    """The slot-refill programs + static shape info."""

    init_state: Callable[[], Any]
    # (model, state, ids [r,P], mask [r,P], slot_idx [r], seeds [r],
    #  table_rows [r,TB] (paged; None dense), hit=0, greedy=None) → state
    refill_rows: Callable[..., Any]
    # (bucket, hit=0) → the refill program of that (power-of-two rows,
    # committed prefix columns) pair, taking the bucket-padded arguments
    refill_program: Callable[..., Callable]
    prewarm: Callable[[Any, Any], Any]
    # (model, state) → (state, live_steps, steps_run)
    decode_segment: Callable[..., Tuple[Any, int, int]]
    batch_size: int
    prompt_len: int
    max_new_tokens: int
    segment_len: int
    paged: Optional[PagedSpec]  # None = the dense per-slot cache
    device: torch.device
    # speculative segments (0 = plain): up to ``speculative + 1`` committed
    # tokens per live row per round; the programs take (target, draft)
    speculative: int = 0
    config: Optional[GenerationConfig] = None
    # (model, state, ids [r,P], mask [r,P], table_rows [r,TB], start, end)
    # → state: a mid-prompt span committed to the pool (paged only)
    prefill_chunk_rows: Optional[Callable[..., Any]] = None
    decode_kernel: str = "xla"  # "pallas": the in-place paged decode / verify
    prefill_kernel: str = "xla"  # "pallas": the in-place paged prefill


def _row_set(buf: torch.Tensor, val: torch.Tensor, col: torch.Tensor,
             live: torch.Tensor) -> torch.Tensor:
    """``buf[i, col[i]] = val[i]`` for live rows; frozen rows keep their
    buffer (no host sync: a scatter then a row-masked select)."""
    col = torch.clamp(col, max=buf.shape[1] - 1)[:, None]
    written = buf.scatter(1, col, val.to(buf.dtype)[:, None])
    return torch.where(live[:, None], written, buf)


def _resolve_kernel(knob: str, value: Optional[str], paged: Optional[PagedSpec]) -> str:
    """``value`` checked (JAX's messages), or the default: the in-place
    kernel with a paged backend, the dense compute without one."""
    if value is None:
        return "pallas" if paged is not None else "xla"
    if value not in KERNELS:
        raise ValueError(f"unknown {knob} '{value}' (xla | pallas)")
    if value == "pallas" and paged is None:
        raise ValueError(f"{knob}: pallas is the in-place *paged* kernel — it requires the "
                         "paged KV backend (engine.backend: paged)")
    return value


def make_slot_refill_fns(
    cfg: Any,  # TransformerConfig of the served model
    batch_size: int,
    prompt_len: int,
    config: GenerationConfig,
    adjust_logits: Optional[Callable[[Dict[str, Any], torch.Tensor], torch.Tensor]] = None,
    segment_len: int = 8,
    paged: Optional[PagedSpec] = None,
    speculative: int = 0,
    device: Any = None,
    draft_cfg: Any = None,  # TransformerConfig of the draft (speculative)
    decode_kernel: Optional[str] = None,
    prefill_kernel: Optional[str] = None,
    transition_mask: Any = None,  # [V, V] bool (speculative only)
) -> SlotRefillFns:
    """Build the slot-refill programs for one engine geometry on
    ``device`` (default: the GPU; raises without one). A decode step
    records ``out["value"]`` into ``SlotState.values`` when the served
    model emits it (the step state then carries ``"value"``); a bare LM's
    values stay zero.

    ``paged=None`` is the dense backend (a ``[B, P + N]`` cache per slot);
    ``decode_kernel`` / ``prefill_kernel`` pick the compute of a paged
    backend (module docstring). ``speculative = G > 0`` swaps in the
    speculative programs (paged only): the draft model rides in the
    programs' ``params = (target, draft)`` as the target does,
    ``draft_cfg`` shapes its dense cache, and ``transition_mask`` (the
    trainer's logit mask) is passed here rather than composed into
    ``adjust_logits``: the rounds apply it to draft proposals and target
    verify distributions separately, as the solo sampler does."""
    decode_kernel = _resolve_kernel("decode_kernel", decode_kernel, paged)
    prefill_kernel = _resolve_kernel("prefill_kernel", prefill_kernel, paged)
    G = int(speculative or 0)
    if G < 0:
        raise ValueError(f"speculative must be >= 0, got {G}")
    if G:
        if paged is None:
            raise ValueError(
                "speculative decode segments require the paged KV backend "
                "(engine.backend: paged) — the verify pass commits accepted K/V "
                "through the block table with drop-mode writes")
        if draft_cfg is None:
            raise ValueError(
                "speculative decode segments need the draft model: pass draft_cfg "
                "(model.draft_model_path resolves it in the trainer) and run the "
                "programs on params = (target, draft)"
            )
    elif transition_mask is not None:
        raise ValueError("transition_mask is the speculative rounds' separate hook: plain "
                         "segments take the mask composed into adjust_logits")
    device = resolve_device(device)
    if transition_mask is not None:
        transition_mask = torch.as_tensor(np.asarray(transition_mask), dtype=torch.bool,
                                          device=device)
    B, P, N = batch_size, prompt_len, config.max_new_tokens
    # the speculative geometry is solo's: each round probes G columns past
    # the last commit
    S = P + N + G
    NB = N + G + 1
    V = cfg.vocab_size
    in_place_prefill = prefill_kernel == "pallas"
    warmed = {"done": False}

    from trlx_tpu_torch.models.transformer import make_kv_cache

    def init_cache(rows: int, length: int):
        return make_kv_cache(cfg, rows, length, device=device)

    def empty_state() -> SlotState:
        i64 = dict(dtype=torch.int64, device=device)
        return SlotState(
            tokens=torch.full((B, N), config.pad_token_id, dtype=torch.int32, device=device),
            logprobs=torch.zeros((B, N), dtype=torch.float32, device=device),
            values=torch.zeros((B, N), dtype=torch.float32, device=device),
            mask=torch.zeros((B, N), dtype=torch.int32, device=device),
            slot_mask=torch.zeros((B, S), **i64),
            cache=(init_paged_kv(init_cache, paged, B, S, device=device)
                   if paged is not None else init_cache(B, S)),
            logits=torch.zeros((B, V), dtype=cfg.dtype, device=device),
            step_out={},
            prompt_len=torch.zeros((B,), **i64),
            done=torch.ones((B,), dtype=torch.bool, device=device),
            step=torch.zeros((B,), **i64),
            seed=torch.zeros((B,), **i64),
            greedy=torch.zeros((B,), dtype=torch.bool, device=device),
        )

    def span_cache(pool, tables: torch.Tensor, rows: int, start: int):
        """The cache a paged span ``[start, ...)`` runs on: the pool with
        the rows' tables (in place), else the gathered dense view when
        columns below ``start`` are committed, else a fresh dense cache
        (the forward writes every column it reads; the rest is masked)."""
        if in_place_prefill:
            return attach_block_table(pool, tables)
        if start > 0:
            return gather_view(pool, tables, S)
        return init_cache(rows, S)

    def commit_span(pool, tables: torch.Tensor, rows_cache, start: int, end: int) -> None:
        """The gather path's write-back of the span ``[start, end)`` (the
        in-place kernel committed it inside the forward)."""
        if not in_place_prefill:
            scatter_span(pool, tables, rows_cache, start, end - start)

    def scatter_rows(big, rows, src: torch.Tensor, dst: torch.Tensor) -> None:
        """Whole-row scatter of dense per-layer caches: ``big[dst] =
        rows[src]`` (also clears a recycled slot's stale columns)."""
        for b, r in zip(big, rows):
            for name in ("k", "v"):
                b[name][dst] = r[name][src].to(b[name].dtype)

    def kept_rows(slot_idx):
        """``(src, dst)`` index tensors of the non-padding rows, or None."""
        keep = np.nonzero(np.asarray(slot_idx) < B)[0]
        if keep.size == 0:
            return None
        return (torch.as_tensor(keep, device=device),
                torch.as_tensor(np.asarray(slot_idx)[keep], dtype=torch.int64, device=device))

    def as_device(input_ids, prompt_mask, table_rows):
        ids = torch.as_tensor(input_ids, dtype=torch.int64).to(device)
        pmask = torch.as_tensor(prompt_mask, dtype=torch.int64).to(device)
        tables = (None if table_rows is None
                  else torch.as_tensor(table_rows, dtype=torch.int32).to(device))
        return ids, pmask, tables

    @torch.no_grad()
    def refill(model, state: SlotState, input_ids, prompt_mask, slot_idx,
               seeds, table_rows, greedy, hit: int = 0) -> SlotState:
        """Prefill ``R`` rows' span ``[hit, P)`` and seed their slots; the
        columns below ``hit`` are already committed in the rows' blocks.
        ``slot_idx >= B`` marks bucket padding: those rows' tables are out
        of range (their writes drop) and their results are not scattered
        into the state."""
        R = input_ids.shape[0]
        ids, pmask, tables = as_device(input_ids, prompt_mask, table_rows)
        slot_mask_r = torch.cat(
            [pmask, torch.zeros((R, N), dtype=torch.int64, device=device)], dim=1
        )
        row_cache = (span_cache(state.cache.pool, tables, R, hit) if paged is not None
                     else init_cache(R, S))
        out = model(
            ids[:, hit:], attention_mask=slot_mask_r, cache=row_cache,
            cache_index=hit, logits_span=(P - hit - 1, P - hit),
        )
        if paged is not None:
            commit_span(state.cache.pool, tables, row_cache, hit, P)
        step_out_r = {**last_step_info(out), "last_tokens": ids[:, -1]}
        if not state.step_out:  # the carry takes the structure the model emits
            state.step_out = tree_map(
                lambda x: torch.zeros((B,) + tuple(x.shape[1:]), dtype=x.dtype, device=device),
                step_out_r)
        kept = kept_rows(slot_idx)
        if kept is None:
            return state
        src, dst = kept
        state.tokens[dst] = config.pad_token_id
        state.logprobs[dst] = 0.0
        state.values[dst] = 0.0
        state.mask[dst] = 0
        state.slot_mask[dst] = slot_mask_r[src]
        if paged is not None:
            state.cache.block_table[dst] = tables[src]
        else:
            scatter_rows(state.cache, row_cache, src, dst)
        state.logits[dst] = out["logits"][src, -1].to(state.logits.dtype)
        tree_map(lambda v, r: v.index_copy_(0, dst, r[src].to(v.dtype)),
                 state.step_out, step_out_r)
        state.prompt_len[dst] = pmask[src].sum(dim=1)
        state.done[dst] = False
        state.step[dst] = 0
        state.seed[dst] = torch.as_tensor(np.asarray(seeds), dtype=torch.int64).to(device)[src]
        state.greedy[dst] = torch.as_tensor(np.asarray(greedy), dtype=torch.bool).to(device)[src]
        return state

    def empty_spec_state() -> SpecState:
        i64 = dict(dtype=torch.int64, device=device)
        return SpecState(
            tokens=torch.full((B, NB), config.pad_token_id, dtype=torch.int32, device=device),
            logprobs=torch.zeros((B, NB), dtype=torch.float32, device=device),
            values=torch.zeros((B, NB), dtype=torch.float32, device=device),
            mask=torch.zeros((B, NB), dtype=torch.int32, device=device),
            prompt_mask=torch.zeros((B, P), **i64),
            cache=init_paged_kv(init_cache, paged, B, S, device=device),
            d_cache=make_kv_cache(draft_cfg, B, S, device=device),
            t_last=torch.zeros((B,), **i64),
            prompt_len=torch.zeros((B,), **i64),
            done=torch.ones((B,), dtype=torch.bool, device=device),
            step=torch.zeros((B,), **i64),
            seed=torch.zeros((B,), **i64),
            round=torch.zeros((B,), **i64),
            **{k: torch.zeros((), **i64)
               for k in ("rounds", "accepted", "live_rounds", "committed")},
        )

    @torch.no_grad()
    def spec_refill(params, state: SpecState, input_ids, prompt_mask, slot_idx,
                    seeds, table_rows, greedy, hit: int = 0) -> SpecState:
        """The speculative twin of :func:`refill`: the target's suffix
        ``[hit, P)`` is prefilled through the rows' tables (K/V only: the
        first round re-feeds the last prompt token), the draft's whole
        prompt on a fresh dense ``[R, S]`` cache scattered whole-row into
        the state (which also clears a recycled slot's stale columns; the
        draft shares nothing across rows). Both use solo's ``S``-wide slot
        mask."""
        target, draft = params  # ``greedy``: ContinuousEngine rejects mixed rows
        R = input_ids.shape[0]
        ids, pmask, tables = as_device(input_ids, prompt_mask, table_rows)
        slot_mask_r = torch.cat(
            [pmask, torch.zeros((R, S - P), dtype=torch.int64, device=device)], dim=1)
        row_cache = span_cache(state.cache.pool, tables, R, hit)
        target(ids[:, hit:], attention_mask=slot_mask_r, cache=row_cache, cache_index=hit,
               logits_span=(0, 0))
        commit_span(state.cache.pool, tables, row_cache, hit, P)
        d_cache = make_kv_cache(draft_cfg, R, S, device=device)
        draft(ids, attention_mask=slot_mask_r, cache=d_cache, cache_index=0,
              logits_span=(0, 0))
        kept = kept_rows(slot_idx)
        if kept is None:
            return state
        src, dst = kept
        scatter_rows(state.d_cache, d_cache, src, dst)
        state.tokens[dst] = config.pad_token_id
        state.logprobs[dst] = 0.0
        state.values[dst] = 0.0
        state.mask[dst] = 0
        state.prompt_mask[dst] = pmask[src]
        state.cache.block_table[dst] = tables[src]
        state.t_last[dst] = ids[src, -1]
        state.prompt_len[dst] = pmask[src].sum(dim=1)
        state.done[dst] = False
        state.step[dst] = 0
        state.seed[dst] = torch.as_tensor(np.asarray(seeds), dtype=torch.int64).to(device)[src]
        state.round[dst] = 0
        return state

    def spec_rounds(params, state: SpecState, round_cache: Callable[[Dict[str, Any]], Any]):
        """Up to ``segment_len`` draft-propose → verify → accept rounds
        over live slots, stopping early when every slot is done (one host
        sync per round); ``round_cache(carry)`` gives each round's target
        cache. Returns ``(carry, rounds_run)``."""
        target, draft = params
        carry = {
            "seed": state.seed, "round": state.round, "n_out": state.step,
            "done": state.done, "t_last": state.t_last, "t_cache": None,
            "d_cache": state.d_cache, "tokens": state.tokens, "logprobs": state.logprobs,
            "values": state.values, "mask": state.mask, "rounds": state.rounds,
            "accepted": state.accepted, "live_rounds": state.live_rounds,
            "committed": state.committed,
        }
        rounds = 0
        while rounds < segment_len and not bool(carry["done"].all()):
            carry["t_cache"] = round_cache(carry)
            carry = spec_round_step(carry, prompt_mask=state.prompt_mask, target=target,
                                    draft=draft, config=config, G=G,
                                    transition_mask=transition_mask,
                                    adjust_logits=adjust_logits)
            rounds += 1
        return carry, rounds

    def spec_finish(state: SpecState, carry: Dict[str, Any], rounds: int):
        live_before = state.live_rounds
        for name, key in (("round", "round"), ("step", "n_out"), ("done", "done"),
                          ("t_last", "t_last"), ("rounds", "rounds"),
                          ("accepted", "accepted"), ("live_rounds", "live_rounds"),
                          ("committed", "committed")):
            setattr(state, name, carry[key])
        return state, int(state.live_rounds - live_before), rounds

    @torch.no_grad()
    def spec_decode_segment(params, state: SpecState):
        """The in-place speculative segment: each round attaches a table in
        which rows done at its start are poisoned, and the verify reads
        and commits K/V through it. Returns ``(state, live_rounds,
        rounds_run)`` — the plain segment's contract in round units."""
        table = state.cache.block_table
        poisoned = torch.full_like(table, paged.max_blocks)
        carry, rounds = spec_rounds(params, state, lambda c: attach_block_table(
            state.cache.pool, torch.where(c["done"][:, None], poisoned, table)))
        return spec_finish(state, carry, rounds)

    @torch.no_grad()
    def spec_decode_segment_gather(params, state: SpecState):
        """The gather speculative segment (``decode_kernel: xla``): one
        dense view of the slots' tables for every round, then one commit
        of each row's columns ``[P + step_in − 1, P + step_out]`` — the
        re-fed column is re-committed with the same values, accepted and
        bonus columns carry the verify's K/V, rejected probes fall outside
        the count and drop."""
        table = state.cache.block_table
        entry_live = ~state.done
        step_in = state.step.clone()
        view = gather_view(state.cache.pool, table, S)
        carry, rounds = spec_rounds(params, state, lambda c: view)
        scatter_steps(state.cache.pool, table, view, P + step_in - 1,
                      torch.where(entry_live, carry["n_out"] - step_in + 1, 0),
                      segment_len * (G + 1) + 1)
        return spec_finish(state, carry, rounds)

    run_refill = spec_refill if G else refill

    def _bucket_pad(input_ids, prompt_mask, table_rows):
        """Round ``r`` up to the next power-of-two bucket; padding rows
        carry pad tokens, all-zero masks and ``max_blocks``-poisoned
        tables (every commit drops)."""
        input_ids = np.asarray(input_ids, np.int64)
        prompt_mask = np.asarray(prompt_mask, np.int64)
        if table_rows is not None:
            table_rows = np.asarray(table_rows, np.int32)
        r = input_ids.shape[0]
        bucket = 1
        while bucket < r:
            bucket *= 2
        bucket = min(bucket, max(B, 1))
        if bucket < r:
            raise ValueError(f"refilling {r} rows into {B} slots")
        pad = bucket - r
        if pad:
            input_ids = np.concatenate(
                [input_ids, np.full((pad, P), config.pad_token_id, np.int64)])
            prompt_mask = np.concatenate([prompt_mask, np.zeros((pad, P), np.int64)])
            if table_rows is not None:
                table_rows = np.concatenate(
                    [table_rows, np.full((pad, table_rows.shape[1]), paged.max_blocks,
                                         np.int32)])
        return bucket, pad, input_ids, prompt_mask, table_rows

    programs: Dict[Tuple[int, int], Callable] = {}

    def refill_program(bucket: int, hit: int = 0) -> Callable:
        """The refill program for one (power-of-two bucket size,
        committed-prefix offset) pair — JAX's compiled-program key; here a
        checked closure over the refill. ``hit`` is 0 on the dense
        backend."""
        if (bucket, hit) not in programs:
            if bucket < 1 or bucket & (bucket - 1) and bucket != B or bucket > max(B, 1):
                raise ValueError(f"refill bucket {bucket}: a power of two up to {B} rows "
                                 "(or B itself)")
            if not 0 <= hit < P:
                raise ValueError(f"refill hit {hit} must leave a prompt column to prefill "
                                 f"(0 <= hit < P = {P})")
            if hit and paged is None:
                raise ValueError("a refill at hit > 0 needs committed prefix blocks: the "
                                 "dense backend prefills whole prompts")

            def program(model, state, input_ids, prompt_mask, slot_idx, seeds, table_rows,
                        greedy):
                if input_ids.shape[0] != bucket:
                    raise ValueError(f"the ({bucket}, {hit}) refill program got "
                                     f"{input_ids.shape[0]} rows")
                return run_refill(model, state, input_ids, prompt_mask, slot_idx, seeds,
                                  table_rows, greedy, hit)

            programs[(bucket, hit)] = program
        return programs[(bucket, hit)]

    def refill_rows(model, state, input_ids, prompt_mask, slot_idx, seeds,
                    table_rows=None, hit: int = 0, greedy=None):
        """Host wrapper: pad ``r`` rows to a power-of-two bucket (padding
        rows carry ``slot_idx = B``) and run that bucket's refill program.
        ``greedy`` ([r] bool, default all False) marks rows decoded
        greedily; ``table_rows`` are the rows' block tables (paged)."""
        slot_idx = np.asarray(slot_idx, np.int64)
        seeds = np.asarray(seeds, np.int64).reshape(-1)
        greedy = np.zeros(seeds.shape, bool) if greedy is None else np.asarray(greedy, bool)
        if paged is None:
            table_rows = None
        elif table_rows is None:
            raise ValueError("a paged refill needs the rows' block tables (table_rows)")
        bucket, pad, input_ids, prompt_mask, table_rows = _bucket_pad(
            input_ids, prompt_mask, table_rows)
        if pad:
            slot_idx = np.concatenate([slot_idx, np.full((pad,), B, np.int64)])
            seeds = np.concatenate([seeds, np.zeros((pad,), np.int64)])
            greedy = np.concatenate([greedy, np.zeros((pad,), bool)])
        return refill_program(bucket, hit)(model, state, input_ids, prompt_mask, slot_idx,
                                           seeds, table_rows, greedy)

    @torch.no_grad()
    def prefill_chunk_rows(model, state, input_ids, prompt_mask, table_rows,
                           start: int, end: int):
        """Commit the mid-prompt span ``[start, end)`` of ``r`` rows into
        their pool blocks: the cache-only chunk program (no logits, no slot
        state; the rows stay empty and done until their final span runs the
        refill with ``hit = start``). Keys keep the full width ``S`` with
        columns ``>= end`` masked out, so the span's queries attend to what
        the same rows' queries attend to inside the whole prefill. Under
        speculation only the target's prompt is chunked (the draft
        prefills whole when the row is seeded)."""
        if not 0 <= start < end < P:
            raise ValueError(f"mid-chunk span [{start}, {end}) must sit strictly inside the "
                             f"prompt region [0, {P}): the final span is the refill")
        target = model[0] if G else model
        _, _, input_ids, prompt_mask, table_rows = _bucket_pad(input_ids, prompt_mask,
                                                               table_rows)
        R = input_ids.shape[0]
        ids, pmask, tables = as_device(input_ids, prompt_mask, table_rows)
        # visibility: the prompt columns [0, end) only
        span_mask = pmask * (torch.arange(P, device=device)[None, :] < end)
        key_mask = torch.cat([span_mask, torch.zeros((R, S - P), dtype=torch.int64,
                                                     device=device)], dim=1)
        row_cache = span_cache(state.cache.pool, tables, R, start)
        target(ids[:, start:end], attention_mask=key_mask, cache=row_cache,
               cache_index=start, logits_span=(0, 0))
        commit_span(state.cache.pool, tables, row_cache, start, end)
        return state

    def prewarm(model, state):
        """Run every cold refill bucket once as a no-op (all rows padding,
        every write drops): the first call of each shape pays kernel
        loading and library setup before any request is timed. Once per
        fns."""
        if warmed["done"]:
            return state
        tables = None
        if paged is not None:
            TB = state.cache.block_table.shape[1]
        bucket = 1
        while True:
            if paged is not None:
                tables = np.full((bucket, TB), paged.max_blocks, np.int32)
            run_refill(model, state,
                       np.full((bucket, P), config.pad_token_id, np.int64),
                       np.zeros((bucket, P), np.int64),
                       np.full((bucket,), B, np.int64), np.zeros((bucket,), np.int64),
                       tables, np.zeros((bucket,), bool))
            if bucket >= B:
                break
            bucket = min(bucket * 2, B)
        warmed["done"] = True
        return state

    def segment_loop(model, st: SlotState, step_cache: Callable, sample_fn: Callable):
        """Up to ``segment_len`` decode steps over live slots, stopping
        early when every slot is done: sample, write the token's buffers,
        run the one-token forward on ``step_cache(live)``. Returns ``(st,
        live_steps, steps_run)``."""
        live_steps = torch.zeros((), dtype=torch.int64, device=device)
        steps = 0
        for _ in range(segment_len):
            if bool(st.done.all()):
                break
            live = ~st.done
            next_token, logprob = sample_fn(
                st.logits, st.step_out, st.seed, config, st.step, adjust_logits,
                greedy=st.greedy,
            )
            next_token = torch.where(
                live, next_token, torch.full_like(next_token, config.pad_token_id))
            st.tokens = _row_set(st.tokens, next_token, st.step, live)
            st.logprobs = _row_set(
                st.logprobs, torch.where(live, logprob, torch.zeros_like(logprob)),
                st.step, live)
            if "value" in st.step_out:
                # the value prediction of the state before this token
                value = st.step_out["value"]
                st.values = _row_set(
                    st.values, torch.where(live, value, torch.zeros_like(value)), st.step, live)
            st.mask = _row_set(st.mask, live.to(torch.int32), st.step, live)
            done = st.done
            if config.eos_token_id is not None:
                done = done | (live & (next_token == config.eos_token_id))
            # a live row that just wrote its N-th column is finished
            done = done | (live & (st.step + 1 >= N))
            slot = P + st.step
            st.slot_mask = _row_set(st.slot_mask, live.to(torch.int64), slot, live)
            out = model(
                next_token[:, None].to(torch.int64),
                attention_mask=st.slot_mask,
                positions=(st.prompt_len + st.step)[:, None],
                cache=step_cache(live),
                # a done row (step N) writes a dead column; clamped in range
                cache_index=torch.clamp(slot, max=S - 1),
            )
            step_out = {**last_step_info(out), "last_tokens": next_token.to(torch.int64)}
            st.logits = torch.where(live[:, None], out["logits"][:, -1], st.logits)
            st.step_out = tree_map(
                lambda v, x: torch.where(live.view(-1, *([1] * (v.ndim - 1))), x.to(v.dtype), v),
                st.step_out, step_out)
            st.done = done
            st.step = torch.where(live, st.step + 1, st.step)
            live_steps += live.sum()
            steps += 1
        return st, int(live_steps), steps

    @torch.no_grad()
    def decode_segment(model, state: SlotState):
        """Up to ``segment_len`` decode steps over live slots. Returns
        ``(state, live_steps, steps_run)``. In place (``decode_kernel:
        pallas``): fused sampling, each live row commits one K/V column
        through its table (frozen rows' tables are poisoned out of range)
        and the paged-decode kernel reads the pool. Gather (``xla``): the
        dense loop on one view of the slots' tables, then each row's live
        columns committed back. Dense backend: the dense loop on the
        state's cache."""
        if paged is not None and decode_kernel == "pallas":
            table = state.cache.block_table
            poisoned = torch.full_like(table, paged.max_blocks)
            return segment_loop(
                model, state,
                lambda live: attach_block_table(
                    state.cache.pool, torch.where(live[:, None], table, poisoned)),
                sample_token_fused)
        if paged is None:
            return segment_loop(model, state, lambda live: state.cache,
                                sample_token_from_logits)
        view = gather_view(state.cache.pool, state.cache.block_table, S)
        step_before = state.step.clone()
        state, live_steps, steps = segment_loop(model, state, lambda live: view,
                                                sample_token_from_logits)
        scatter_steps(state.cache.pool, state.cache.block_table, view, P + step_before,
                      state.step - step_before, segment_len)
        return state, live_steps, steps

    if G:
        segment = spec_decode_segment if decode_kernel == "pallas" else spec_decode_segment_gather
    else:
        segment = decode_segment
    return SlotRefillFns(
        init_state=empty_spec_state if G else empty_state,
        refill_rows=refill_rows,
        refill_program=refill_program,
        prewarm=prewarm,
        decode_segment=segment,
        prefill_chunk_rows=prefill_chunk_rows if paged is not None else None,
        batch_size=B,
        prompt_len=P,
        max_new_tokens=N,
        segment_len=segment_len,
        paged=paged,
        device=device,
        speculative=G,
        config=config,
        decode_kernel=decode_kernel,
        prefill_kernel=prefill_kernel,
    )
