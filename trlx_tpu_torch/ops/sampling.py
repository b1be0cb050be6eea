"""Autoregressive generation with an explicit dense KV cache, in PyTorch.

Port of ``trlx_tpu/ops/sampling.py``: :class:`GenerationConfig`,
:func:`process_logits`, :func:`apply_transition_mask`,
:func:`sample_token_from_logits`, :func:`last_step_info` and the
dense-cache :func:`generate` — the serial rollout path's sampler
(``engine/core.py::SerialEngine``) and the plain reference the paged
engine is held against (greedy decodes must match it token for token) —
and :func:`generate_seq2seq`, its encoder-decoder (T5) counterpart.

Randomness. JAX's threefry per-row key chains become a counter-based hash
(:func:`gumbel_noise`): row ``i``'s Gumbel noise at decode step ``s``
depends only on that row's seed and ``s`` — never on batch composition or
slot position — so a sequence that migrates through refilled engine slots
draws exactly what a solo :func:`generate` with the same seed draws. The
hash is plain integer tensor arithmetic, so the CPU and the card produce
the same noise. The noise is an input to sampling, exactly as the fused
sampling kernel takes it. The speculative sampler (``ops/speculative.py``)
draws from the same hash with its own counters (:func:`uniform_noise` for
the acceptance uniforms).
"""

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

__all__ = [
    "GenerationConfig",
    "GenerationOutput",
    "process_logits",
    "apply_transition_mask",
    "uniform_noise",
    "gumbel_noise",
    "sample_token_from_logits",
    "tree_map",
    "last_step_info",
    "generate",
    "generate_seq2seq",
]


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Sampling settings (HF-compatible field names). Every row always
    samples from its own seed (the JAX package's ``per_row_rng=True``)."""

    max_new_tokens: int = 40
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    do_sample: bool = True
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    min_new_tokens: int = 0


def process_logits(
    logits: torch.Tensor,  # [B, V]
    temperature: float,
    top_k: int,
    top_p: float,
) -> torch.Tensor:
    """Standard temperature / top-k / top-p filtering (returns logits)."""
    if temperature != 1.0:
        logits = logits / max(temperature, 1e-6)
    if top_k and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cumprobs = torch.cumsum(probs, dim=-1)
        # keep tokens until cumulative prob exceeds top_p (always keep top-1)
        keep_sorted = cumprobs - probs < top_p
        threshold = torch.where(
            keep_sorted, sorted_logits, torch.full_like(sorted_logits, float("inf"))
        ).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < threshold, float("-inf"))
    return logits


def apply_transition_mask(
    mask: torch.Tensor,  # [Vm, Vm'] bool: allowed next token per last token
    last_tokens: torch.Tensor,  # [B] the conditioning tokens
    logits: torch.Tensor,  # [B, V]
) -> torch.Tensor:
    """Disallow transitions: ``mask[last, next] == False`` gives the logit
    -1e10. A mask narrower than the vocab disallows the tokens past it; a
    last token without a row (out of range) samples unconstrained."""
    mask = mask.to(device=logits.device, dtype=torch.bool)
    last_tokens = last_tokens.to(device=logits.device, dtype=torch.int64)
    sel = mask[last_tokens.clamp(0, mask.shape[0] - 1)]
    V = logits.shape[-1]
    if mask.shape[1] >= V:
        allowed = sel[..., :V]
    else:
        allowed = torch.zeros(logits.shape, dtype=torch.bool, device=logits.device)
        allowed[..., : mask.shape[1]] = sel
    row_known = (last_tokens >= 0) & (last_tokens < mask.shape[0])
    allowed = allowed | ~row_known[..., None]
    return torch.where(allowed, logits, torch.full_like(logits, -1e10))


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finaliser on int64 tensors holding values < 2**32.
    Both multipliers are < 2**31, so no product leaves int64's range."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def uniform_noise(
    seeds: torch.Tensor,  # [B] int64 per-row seeds
    counters: torch.Tensor,  # [B] int64 per-row draw counters
    n: int,
) -> torch.Tensor:
    """``[B, n]`` f32 uniforms in ``(0, 1)``; row ``i`` is a pure function
    of ``(seeds[i], counters[i])``. The counter hash behind every draw of
    the port (the Gumbel noise is ``-log(-log(u))`` of these)."""
    device = seeds.device
    row = _mix32((_mix32(seeds.to(torch.int64) & _M32)
                  + (counters.to(torch.int64) & _M32) * 2 + 1) & _M32)
    col = _mix32(torch.arange(n, device=device, dtype=torch.int64) * 2 + 1)
    bits = _mix32(row[:, None] ^ col[None, :])
    return ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / 16777216.0)


def gumbel_noise(
    seeds: torch.Tensor,  # [B] int64 per-row seeds
    steps: torch.Tensor,  # [B] int64 per-row decode steps (draw counters)
    vocab_size: int,
) -> torch.Tensor:
    """``[B, V]`` f32 standard Gumbel noise; row ``i`` is a pure function
    of ``(seeds[i], steps[i])``."""
    return -torch.log(-torch.log(uniform_noise(seeds, steps, vocab_size)))


def _block_eos(logits, config, step):
    """``min_new_tokens`` eos blocking: ``step`` is a scalar or holds the
    response position of each logits row (``logits.shape[:-1]``)."""
    if config.eos_token_id is not None and config.min_new_tokens > 0:
        step = torch.as_tensor(step, device=logits.device)
        block = step < config.min_new_tokens
        if block.ndim:
            block = block[..., None]
        is_eos = (
            torch.arange(logits.shape[-1], device=logits.device)[None, :]
            == config.eos_token_id
        )
        logits = logits.masked_fill(block & is_eos, float("-inf"))
    return logits


def sample_token_from_logits(
    logits: torch.Tensor,  # [B, V] raw last-position logits
    step_out: Dict[str, Any],
    seeds: torch.Tensor,  # [B] int64 per-row seeds
    config: GenerationConfig,
    step: torch.Tensor,  # [B] per-row decode steps
    adjust_logits: Optional[Callable[[Dict[str, Any], torch.Tensor], torch.Tensor]],
    greedy: Optional[torch.Tensor] = None,  # [B] bool rows decoded greedily
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared sampling semantics: adjust-logits hook, ``min_new_tokens``
    eos blocking, temperature/top-k/top-p filtering, Gumbel-argmax draw
    (plain argmax when greedy, and zero noise on rows flagged ``greedy``),
    and the behaviour logprob of the chosen token under the unfiltered
    row."""
    if adjust_logits is not None:
        logits = adjust_logits(step_out, logits)
    logits = _block_eos(logits.float(), config, step)
    filtered = process_logits(logits, config.temperature, config.top_k, config.top_p)
    if config.do_sample:
        noise = gumbel_noise(seeds, torch.as_tensor(step, device=logits.device)
                             .expand(logits.shape[0]), logits.shape[-1])
        if greedy is not None:
            noise = noise.masked_fill(greedy[:, None], 0.0)
        next_token = torch.argmax(noise + filtered, dim=-1)
    else:
        next_token = torch.argmax(filtered, dim=-1)
    logprob = torch.log_softmax(logits, dim=-1).gather(1, next_token[:, None])[:, 0]
    return next_token.to(torch.int32), logprob


# router_aux_loss: the MoE statistics, a [2] vector unused in decoding
_NON_CARRY_KEYS = ("cache", "logits", "branch_input", "router_aux_loss")


def tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the tensors of equally shaped trees of tuples / lists /
    dicts (the step-output structures the engines carry)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def last_step_info(out: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only last-position views of model outputs (what the
    adjust-logits hook may read); tuple outputs (an ILQL model's Q heads)
    keep their structure."""
    return {
        k: tree_map(lambda x: x[:, -1], v)
        for k, v in out.items() if k not in _NON_CARRY_KEYS and v is not None
    }


class GenerationOutput(NamedTuple):
    sequences: torch.Tensor  # [B, P + N] prompt (padded) ‖ response
    response_tokens: torch.Tensor  # [B, N] pad-filled after eos
    response_mask: torch.Tensor  # [B, N] 1 on real response tokens (incl. eos)
    response_logprobs: torch.Tensor  # [B, N] behaviour logprobs
    response_values: torch.Tensor  # [B, N] value-head outputs (0 if no head)
    prompt_mask: torch.Tensor  # [B, P]


@torch.no_grad()
def generate(
    model: Any,  # CausalTransformer
    input_ids: torch.Tensor,  # [B, P] left-padded prompts
    attention_mask: torch.Tensor,  # [B, P]
    seeds: torch.Tensor,  # [B] int64 per-row seeds
    config: GenerationConfig,
    adjust_logits: Optional[Callable[[Dict[str, Any], torch.Tensor], torch.Tensor]] = None,
) -> GenerationOutput:
    """Sample ``max_new_tokens`` continuations with a dense ``[B, P + N]``
    KV cache: one prefill forward, then a Python decode loop with per-row
    eos early exit (the JAX ``lax.while_loop``)."""
    from trlx_tpu_torch.models.transformer import make_kv_cache

    device = next(model.parameters()).device
    input_ids = input_ids.to(device=device, dtype=torch.int64)
    attention_mask = attention_mask.to(device=device, dtype=torch.int64)
    seeds = seeds.to(device=device, dtype=torch.int64)
    B, P = input_ids.shape
    N = config.max_new_tokens
    cache = make_kv_cache(model.config, B, P + N, device=device)
    slot_mask = torch.cat(
        [attention_mask, torch.zeros((B, N), dtype=torch.int64, device=device)], dim=1
    )
    out = model(input_ids, attention_mask=slot_mask, cache=cache,
                cache_index=0, logits_span=(P - 1, P))
    logits = out["logits"][:, -1]
    step_out = {**last_step_info(out), "last_tokens": input_ids[:, -1]}
    prompt_len = attention_mask.sum(dim=1)

    tokens = torch.full((B, N), config.pad_token_id, dtype=torch.int32, device=device)
    logprobs = torch.zeros((B, N), dtype=torch.float32, device=device)
    values = torch.zeros((B, N), dtype=torch.float32, device=device)
    mask = torch.zeros((B, N), dtype=torch.int32, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    for step in range(N):
        steps = torch.full((B,), step, dtype=torch.int64, device=device)
        tok, lp = sample_token_from_logits(
            logits, step_out, seeds, config, steps, adjust_logits
        )
        live = ~done
        tok = torch.where(live, tok, torch.full_like(tok, config.pad_token_id))
        tokens[:, step] = tok
        logprobs[:, step] = torch.where(live, lp, torch.zeros_like(lp))
        if "value" in step_out:
            # the value prediction of the state before this token
            values[:, step] = torch.where(live, step_out["value"].float(), torch.zeros_like(lp))
        mask[:, step] = live.to(torch.int32)
        if config.eos_token_id is not None:
            done = done | (tok == config.eos_token_id)
        slot_mask[:, P + step] = live.to(torch.int64)
        if step + 1 == N or bool(done.all()):
            break
        out = model(tok[:, None].to(torch.int64), attention_mask=slot_mask,
                    positions=(prompt_len + step)[:, None], cache=cache,
                    cache_index=P + step)
        logits = out["logits"][:, -1]
        step_out = {**last_step_info(out), "last_tokens": tok}
    return GenerationOutput(
        sequences=torch.cat([input_ids.to(torch.int32), tokens], dim=1),
        response_tokens=tokens,
        response_mask=mask,
        response_logprobs=logprobs,
        response_values=values,
        prompt_mask=attention_mask.to(torch.int32),
    )


@torch.no_grad()
def generate_seq2seq(
    model: Any,  # a T5Transformer or a seq2seq wrapper of models/heads.py
    input_ids: torch.Tensor,  # [B, P] padded encoder prompts
    attention_mask: torch.Tensor,  # [B, P]
    seeds: torch.Tensor,  # [B] int64 per-row seeds
    config: GenerationConfig,
    start_token_id: int = 0,
    adjust_logits: Optional[Callable[[Dict[str, Any], torch.Tensor], torch.Tensor]] = None,
) -> GenerationOutput:
    """Seq2seq sampling: one encoder pass
    (``model.encode_for_decode``, the cross-attention K/V projected once
    into an ``N + 1``-slot decoder cache), then the decoder from slot 0
    with ``start_token_id``, one cached step a token, with per-row eos
    early exit and the :func:`sample_token_from_logits` semantics of
    :func:`generate` (the ``adjust_logits`` hook reads the decoder step's
    last-position outputs). ``sequences`` is ``prompt ‖ tokens``."""
    device = next(model.parameters()).device
    input_ids = input_ids.to(device=device, dtype=torch.int64)
    attention_mask = attention_mask.to(device=device, dtype=torch.int64)
    seeds = seeds.to(device=device, dtype=torch.int64)
    B = input_ids.shape[0]
    N = config.max_new_tokens
    enc_hidden, cache = model.encode_for_decode(input_ids, attention_mask, N + 1)
    start = torch.full((B, 1), start_token_id, dtype=torch.int64, device=device)
    out = model.decode(start, enc_hidden, attention_mask, cache=cache, cache_index=0)
    logits = out["logits"][:, -1]
    step_out = {**last_step_info(out), "last_tokens": start[:, 0]}

    tokens = torch.full((B, N), config.pad_token_id, dtype=torch.int32, device=device)
    logprobs = torch.zeros((B, N), dtype=torch.float32, device=device)
    values = torch.zeros((B, N), dtype=torch.float32, device=device)
    mask = torch.zeros((B, N), dtype=torch.int32, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    for step in range(N):
        steps = torch.full((B,), step, dtype=torch.int64, device=device)
        tok, lp = sample_token_from_logits(logits, step_out, seeds, config, steps,
                                           adjust_logits)
        live = ~done
        tok = torch.where(live, tok, torch.full_like(tok, config.pad_token_id))
        tokens[:, step] = tok
        logprobs[:, step] = torch.where(live, lp, torch.zeros_like(lp))
        if "value" in step_out:  # the value of the state before this token
            values[:, step] = torch.where(live, step_out["value"].float(), torch.zeros_like(lp))
        mask[:, step] = live.to(torch.int32)
        if config.eos_token_id is not None:
            done = done | (tok == config.eos_token_id)
        if step + 1 == N or bool(done.all()):
            break
        out = model.decode(tok[:, None].to(torch.int64), enc_hidden, attention_mask,
                           cache=cache, cache_index=step + 1)
        logits = out["logits"][:, -1]
        step_out = {**last_step_info(out), "last_tokens": tok}
    return GenerationOutput(
        sequences=torch.cat([input_ids.to(torch.int32), tokens], dim=1),
        response_tokens=tokens,
        response_mask=mask,
        response_logprobs=logprobs,
        response_values=values,
        prompt_mask=attention_mask.to(torch.int32),
    )
