"""Slot-refill decode: the device half of the paged continuous-batching
engine, in PyTorch.

Port of ``trlx_tpu/ops/slot_refill.py`` restricted to the in-place kernel
path (``paged=PagedSpec(...)``, the paged prefill and decode kernels),
plain or speculative (``speculative=G``). Anything else raises
``ValueError``, as the JAX module does for invalid combinations.

Decode runs in fixed-size **segments** over per-slot state: after each
segment the host engine harvests finished slots and refills them with
fresh prompts through an on-demand prefill into the freed slots' pool
blocks. Row independence is what makes this exact: every slot decodes at
its own cache column (a ``[B]`` ``cache_index``), samples from its own
seed at its own step, and frozen (finished) slots neither write K/V (their
table rows are poisoned out of range every step) nor advance — so a
harvested sequence equals what a solo :func:`ops.sampling.generate` of the
same prompt and seed produces.

- refill: the prompt span ``[0, P)`` of ``R`` rows is prefilled in place —
  the model's paged branch commits K/V through the rows' block tables and
  calls the paged-prefill kernel; rows are padded to a power-of-two bucket
  (padding rows carry out-of-range tables, so every write drops), which
  bounds the set of shapes the kernels see;
- decode segment: up to ``segment_len`` steps of fused sampling
  (``ops/paged_attention.py::sample_token_fused``) then a one-token forward
  through the paged-decode kernel. The JAX ``lax.while_loop`` is a Python
  loop with an early exit when every slot is done.

Speculative segments (``speculative = G > 0``, the JAX in-place
``_spec_decode_segment_paged_kernel``): the programs take ``params =
(target, draft)`` and the state is a :class:`SpecState`. A refill
prefills the target's prompt in place (paged prefill, logits unused) and
the draft's whole prompt on a fresh dense ``[R, S]`` cache (the flash
kernel on the card), scattered whole-row into the state's draft cache. A
segment runs up to ``segment_len`` rounds of
``ops/speculative.py::spec_round_step``; each round attaches a table in
which rows done at the round's start are poisoned out of range, so their
verify writes drop. The verify's probe columns ``[c − 1, c + G)`` are
written in place: rejected ones sit above every committed length and stay
invisible through the slot mask; columns past a row's allocated blocks
land in table entries left at 0 (the reserved block), which only probes
past the budget ``N`` read.
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
    init_paged_kv,
)
from trlx_tpu_torch.ops.sampling import GenerationConfig, last_step_info, tree_map
from trlx_tpu_torch.ops.speculative import reject_spec_hooks, spec_round_step

__all__ = ["SlotState", "SpecState", "SlotRefillFns", "make_slot_refill_fns"]


@dataclasses.dataclass
class SlotState:
    """Per-slot decode state (``B`` slots over ``S = P + N`` cache columns).
    Tensors are updated in place by the refill and segment programs."""

    tokens: torch.Tensor  # [B, N] int32 response tokens (pad after eos)
    logprobs: torch.Tensor  # [B, N] f32 behaviour logprobs
    values: torch.Tensor  # [B, N] f32 value-head outputs (0 if no head)
    mask: torch.Tensor  # [B, N] int32, 1 on real response tokens
    slot_mask: torch.Tensor  # [B, S] int64 attention slot mask
    cache: PagedKV  # block pool + [B, TB] block table
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

    init_state: Callable[[], SlotState]
    # (model, state, ids [r,P], mask [r,P], slot_idx [r], seeds [r],
    #  table_rows [r,TB], hit=0) → state
    refill_rows: Callable[..., SlotState]
    prewarm: Callable[[Any, SlotState], SlotState]
    # (model, state) → (state, live_steps, steps_run)
    decode_segment: Callable[..., Tuple[SlotState, int, int]]
    batch_size: int
    prompt_len: int
    max_new_tokens: int
    segment_len: int
    paged: PagedSpec
    device: torch.device
    # speculative segments (0 = plain): up to ``speculative + 1`` committed
    # tokens per live row per round; the programs take (target, draft)
    speculative: int = 0
    config: Optional[GenerationConfig] = None


def _row_set(buf: torch.Tensor, val: torch.Tensor, col: torch.Tensor,
             live: torch.Tensor) -> torch.Tensor:
    """``buf[i, col[i]] = val[i]`` for live rows; frozen rows keep their
    buffer (no host sync: a scatter then a row-masked select)."""
    col = torch.clamp(col, max=buf.shape[1] - 1)[:, None]
    written = buf.scatter(1, col, val.to(buf.dtype)[:, None])
    return torch.where(live[:, None], written, buf)


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
) -> SlotRefillFns:
    """Build the slot-refill programs for one engine geometry on
    ``device`` (default: the GPU; raises without one). A decode step
    records ``out["value"]`` into ``SlotState.values`` when the served
    model emits it (the step state then carries ``"value"``); a bare LM's
    values stay zero.

    ``speculative = G > 0`` swaps in the speculative programs: the draft
    model rides in the programs' ``params = (target, draft)`` as the
    target does, and ``draft_cfg`` shapes its dense cache."""
    if paged is None:
        raise ValueError(
            "the port's slot-refill engine is the paged backend: pass "
            "paged=PagedSpec(...) (the dense backend is not ported)"
        )
    G = int(speculative or 0)
    if G < 0:
        raise ValueError(f"speculative must be >= 0, got {G}")
    if G:
        if draft_cfg is None:
            raise ValueError(
                "speculative decode segments need the draft model: pass draft_cfg "
                "(model.draft_model_path resolves it in the trainer) and run the "
                "programs on params = (target, draft)"
            )
        reject_spec_hooks(adjust_logits=adjust_logits)
    device = resolve_device(device)
    B, P, N = batch_size, prompt_len, config.max_new_tokens
    # the speculative geometry is solo's: each round probes G columns past
    # the last commit
    S = P + N + G
    NB = N + G + 1
    V = cfg.vocab_size
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
            cache=init_paged_kv(init_cache, paged, B, S, device=device),
            logits=torch.zeros((B, V), dtype=cfg.dtype, device=device),
            step_out={},
            prompt_len=torch.zeros((B,), **i64),
            done=torch.ones((B,), dtype=torch.bool, device=device),
            step=torch.zeros((B,), **i64),
            seed=torch.zeros((B,), **i64),
            greedy=torch.zeros((B,), dtype=torch.bool, device=device),
        )

    @torch.no_grad()
    def refill(model, state: SlotState, input_ids, prompt_mask, slot_idx,
               seeds, table_rows, greedy) -> SlotState:
        """Prefill ``R`` rows in place through their block tables and seed
        their slots. ``slot_idx >= B`` marks bucket padding: those rows'
        tables are out of range (their writes drop) and their results are
        not scattered into the state."""
        R = input_ids.shape[0]
        ids = torch.as_tensor(input_ids, dtype=torch.int64).to(device)
        pmask = torch.as_tensor(prompt_mask, dtype=torch.int64).to(device)
        tables = torch.as_tensor(table_rows, dtype=torch.int32).to(device)
        slot_mask_r = torch.cat(
            [pmask, torch.zeros((R, N), dtype=torch.int64, device=device)], dim=1
        )
        out = model(
            ids, attention_mask=slot_mask_r,
            cache=attach_block_table(state.cache.pool, tables),
            cache_index=0, logits_span=(P - 1, P),
        )
        step_out_r = {**last_step_info(out), "last_tokens": ids[:, -1]}
        if not state.step_out:  # the carry takes the structure the model emits
            state.step_out = tree_map(
                lambda x: torch.zeros((B,) + tuple(x.shape[1:]), dtype=x.dtype, device=device),
                step_out_r)
        keep = np.nonzero(np.asarray(slot_idx) < B)[0]
        if keep.size == 0:
            return state
        src = torch.as_tensor(keep, device=device)
        dst = torch.as_tensor(np.asarray(slot_idx)[keep], dtype=torch.int64, device=device)
        state.tokens[dst] = config.pad_token_id
        state.logprobs[dst] = 0.0
        state.values[dst] = 0.0
        state.mask[dst] = 0
        state.slot_mask[dst] = slot_mask_r[src]
        state.cache.block_table[dst] = tables[src]
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
                    seeds, table_rows, greedy) -> SpecState:
        """The speculative twin of :func:`refill`: the target's prompt is
        prefilled in place through the rows' tables (K/V only: the first
        round re-feeds the last prompt token), the draft's on a fresh dense
        ``[R, S]`` cache scattered whole-row into the state (which also
        clears a recycled slot's stale columns). Both use solo's ``S``-wide
        slot mask."""
        target, draft = params  # ``greedy``: ContinuousEngine rejects mixed rows
        R = input_ids.shape[0]
        ids = torch.as_tensor(input_ids, dtype=torch.int64).to(device)
        pmask = torch.as_tensor(prompt_mask, dtype=torch.int64).to(device)
        tables = torch.as_tensor(table_rows, dtype=torch.int32).to(device)
        slot_mask_r = torch.cat(
            [pmask, torch.zeros((R, S - P), dtype=torch.int64, device=device)], dim=1)
        target(ids, attention_mask=slot_mask_r,
               cache=attach_block_table(state.cache.pool, tables),
               cache_index=0, logits_span=(0, 0))
        d_cache = make_kv_cache(draft_cfg, R, S, device=device)
        draft(ids, attention_mask=slot_mask_r, cache=d_cache, cache_index=0,
              logits_span=(0, 0))
        keep = np.nonzero(np.asarray(slot_idx) < B)[0]
        if keep.size == 0:
            return state
        src = torch.as_tensor(keep, device=device)
        dst = torch.as_tensor(np.asarray(slot_idx)[keep], dtype=torch.int64, device=device)
        for big, rows in zip(state.d_cache, d_cache):
            for name in ("k", "v"):
                big[name][dst] = rows[name][src]
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

    @torch.no_grad()
    def spec_decode_segment(params, state: SpecState):
        """Up to ``segment_len`` draft-propose → verify → accept rounds
        over live slots, stopping early when every slot is done (one host
        sync per round). Each round attaches a table in which rows done at
        its start are poisoned, runs the shared round body, and detaches.
        Returns ``(state, live_rounds, rounds_run)`` — the plain segment's
        contract in round units."""
        target, draft = params
        table = state.cache.block_table
        poisoned = torch.full_like(table, paged.max_blocks)
        carry = {
            "seed": state.seed, "round": state.round, "n_out": state.step,
            "done": state.done, "t_last": state.t_last, "t_cache": None,
            "d_cache": state.d_cache, "tokens": state.tokens, "logprobs": state.logprobs,
            "values": state.values, "mask": state.mask, "rounds": state.rounds,
            "accepted": state.accepted, "live_rounds": state.live_rounds,
            "committed": state.committed,
        }
        live_before, rounds = state.live_rounds, 0
        while rounds < segment_len and not bool(carry["done"].all()):
            carry["t_cache"] = attach_block_table(
                state.cache.pool, torch.where(carry["done"][:, None], poisoned, table))
            carry = spec_round_step(carry, prompt_mask=state.prompt_mask, target=target,
                                    draft=draft, config=config, G=G)
            rounds += 1
        for name, key in (("round", "round"), ("step", "n_out"), ("done", "done"),
                          ("t_last", "t_last"), ("rounds", "rounds"),
                          ("accepted", "accepted"), ("live_rounds", "live_rounds"),
                          ("committed", "committed")):
            setattr(state, name, carry[key])
        return state, int(state.live_rounds - live_before), rounds

    run_refill = spec_refill if G else refill

    def _bucket_pad(input_ids, prompt_mask, table_rows):
        """Round ``r`` up to the next power-of-two bucket; padding rows
        carry pad tokens, all-zero masks and ``max_blocks``-poisoned
        tables (every commit drops)."""
        input_ids = np.asarray(input_ids, np.int64)
        prompt_mask = np.asarray(prompt_mask, np.int64)
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
            table_rows = np.concatenate(
                [table_rows, np.full((pad, table_rows.shape[1]), paged.max_blocks, np.int32)])
        return bucket, pad, input_ids, prompt_mask, table_rows

    def refill_rows(model, state, input_ids, prompt_mask, slot_idx, seeds,
                    table_rows, hit: int = 0, greedy=None) -> SlotState:
        """Host wrapper: pad ``r`` rows to a power-of-two bucket (padding
        rows carry ``slot_idx = B``) and run the refill. ``greedy`` ([r]
        bool, default all False) marks rows decoded greedily."""
        if hit:
            raise ValueError("prefix-cache hits (hit > 0) are not ported yet")
        slot_idx = np.asarray(slot_idx, np.int64)
        seeds = np.asarray(seeds, np.int64).reshape(-1)
        greedy = np.zeros(seeds.shape, bool) if greedy is None else np.asarray(greedy, bool)
        _, pad, input_ids, prompt_mask, table_rows = _bucket_pad(
            input_ids, prompt_mask, table_rows)
        if pad:
            slot_idx = np.concatenate([slot_idx, np.full((pad,), B, np.int64)])
            seeds = np.concatenate([seeds, np.zeros((pad,), np.int64)])
            greedy = np.concatenate([greedy, np.zeros((pad,), bool)])
        return run_refill(model, state, input_ids, prompt_mask, slot_idx, seeds,
                          table_rows, greedy)

    def prewarm(model, state: SlotState) -> SlotState:
        """Run every refill bucket once as a no-op (all rows padding, every
        write drops): the first call of each shape pays kernel loading and
        library setup before any request is timed. Once per fns."""
        if warmed["done"]:
            return state
        TB = state.cache.block_table.shape[1]
        bucket = 1
        while True:
            run_refill(model, state,
                       np.full((bucket, P), config.pad_token_id, np.int64),
                       np.zeros((bucket, P), np.int64),
                       np.full((bucket,), B, np.int64), np.zeros((bucket,), np.int64),
                       np.full((bucket, TB), paged.max_blocks, np.int32),
                       np.zeros((bucket,), bool))
            if bucket >= B:
                break
            bucket = min(bucket * 2, B)
        warmed["done"] = True
        return state

    @torch.no_grad()
    def decode_segment(model, state: SlotState):
        """Up to ``segment_len`` decode steps over live slots, stopping
        early when every slot is done. Returns ``(state, live_steps,
        steps_run)``. Each step samples with the fused kernel, commits one
        K/V column per live row through its table (frozen rows' tables are
        poisoned out of range, so they write nothing) and runs the
        paged-decode kernel."""
        st = state
        table = st.cache.block_table
        poisoned = torch.full_like(table, paged.max_blocks)
        live_steps = torch.zeros((), dtype=torch.int64, device=device)
        steps = 0
        for _ in range(segment_len):
            if bool(st.done.all()):
                break
            live = ~st.done
            next_token, logprob = sample_token_fused(
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
                cache=attach_block_table(
                    st.cache.pool, torch.where(live[:, None], table, poisoned)),
                cache_index=slot,
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

    return SlotRefillFns(
        init_state=empty_spec_state if G else empty_state,
        refill_rows=refill_rows,
        prewarm=prewarm,
        decode_segment=spec_decode_segment if G else decode_segment,
        batch_size=B,
        prompt_len=P,
        max_new_tokens=N,
        segment_len=segment_len,
        paged=paged,
        device=device,
        speculative=G,
        config=config,
    )
