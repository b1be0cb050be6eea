"""Speculative decoding for rollout generation (draft-propose → verify →
accept), in PyTorch.

Port of ``trlx_tpu/ops/speculative.py``: :func:`_filtered_probs`,
:func:`accept_and_extra`, :func:`spec_round_step` and the solo reference
:func:`generate_speculative`. A small draft model proposes ``G`` tokens one
at a time, the target scores all of them in ONE forward of ``G + 1``
positions, and the Leviathan/Chen rejection rule keeps a prefix plus one
residual (or bonus) token — every committed token is an exact draw from
the target's distribution, and greedy output equals plain greedy decoding
for any draft.

Rounds are stateless, as in the JAX module: each re-feeds the last
committed token (whose K/V neither cache holds yet), so no logits are
carried across rounds and rewinding a cache is index arithmetic. Both
caches span ``S = P + N + G`` columns and every forward masks exactly the
committed slots plus the round's ``G`` probe slots; per-row cache depths
use the ``[B]`` ``cache_index`` path of ``models/transformer.py`` (the
dense per-row windows here, the paged verify inside the engine).

Randomness. JAX threads ``[B, 2]`` per-row key chains and advances them a
fixed ``G + 2`` times per round when sampling. The port keeps its counter
hash (``ops/sampling.py``): each row carries a round counter, and draw
``d`` of round ``r`` uses counter ``r·(G + 2) + d`` — ``d < G`` the draft
proposals (Gumbel noise), ``d = G`` the ``G`` acceptance uniforms,
``d = G + 1`` the residual/bonus draw (Gumbel noise). A row's stream
depends only on its seed and its round, so an engine slot that hosts the
row after a refill draws exactly what a solo run draws.

Logit hooks, as in JAX: ``transition_mask`` (the trainer's ``[V, V]``
prev → next mask) is applied to the draft's proposal distributions and to
the target's verify distributions alike, so constrained sampling stays
lossless; ``adjust_logits`` (an algorithm's reshaping, ILQL's ``log π +
β (min Q − V)``) is applied to the target's verify logits only, before the
mask, with the verify forward's per-position outputs (``[B, G + 1, ...]``
views and ``last_tokens = [t_last, d_1 .. d_G]``). The draft proposes from
its own unadjusted distribution and the acceptance rule corrects it, so the
committed tokens are exact draws from the adjusted target.
"""

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from trlx_tpu_torch.ops.sampling import (
    _NON_CARRY_KEYS,
    GenerationConfig,
    GenerationOutput,
    _block_eos,
    apply_transition_mask,
    gumbel_noise,
    process_logits,
    uniform_noise,
)

__all__ = [
    "accept_and_extra",
    "spec_round_step",
    "generate_speculative",
]


def _filtered_probs(logits: torch.Tensor, config: GenerationConfig) -> torch.Tensor:
    """The actual sampling distribution: temperature / top-k / top-p
    filtered softmax over the last axis."""
    return torch.softmax(
        process_logits(logits, config.temperature, config.top_k, config.top_p), dim=-1)


def accept_and_extra(
    p_probs: torch.Tensor,  # [B, G+1, V] target dists p_0..p_G
    q_probs: torch.Tensor,  # [B, G, V] draft dists q_1..q_G
    d_toks: torch.Tensor,  # [B, G] draft proposals (d_i ~ q_i)
    uniforms: Optional[torch.Tensor],  # [B, G] in [0, 1) (sampling)
    gumbel: Optional[torch.Tensor],  # [B, V] Gumbel noise (sampling)
    do_sample: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The speculative acceptance rule as a pure function of distributions
    and noise. Returns ``(k, extra)``: ``k`` accepted draft tokens (the
    committed block is ``d_1..d_k, extra``) and the residual/bonus token.

    Sampling: accept ``d_i`` iff ``u_i·q_i(d_i) < p_{i-1}(d_i)`` (strict:
    ``u = 0`` must not accept a token the target gives probability 0); on
    the first rejection resample from ``norm(max(p − q, 0))`` as
    ``argmax(gumbel + log dist)``; after a full accept draw the bonus from
    ``p_G``. Greedy: accept iff ``d_i == argmax p_{i-1}``; extra is
    ``argmax p_k``."""
    B, G = d_toks.shape
    V = p_probs.shape[-1]
    idx = d_toks.to(torch.int64)[..., None]
    q_sel = q_probs.gather(-1, idx)[..., 0]
    p_sel = p_probs[:, :G].gather(-1, idx)[..., 0]  # p_{i-1}(d_i)
    if do_sample:
        accept = uniforms * q_sel < p_sel
    else:
        accept = d_toks.to(torch.int64) == torch.argmax(p_probs[:, :G], dim=-1)
    k = torch.cumprod(accept.to(torch.int64), dim=1).sum(dim=1)
    p_row_at_k = p_probs.gather(1, k[:, None, None].expand(B, 1, V))[:, 0]
    if not do_sample:
        return k, torch.argmax(p_row_at_k, dim=-1)
    res_probs = torch.clamp(p_probs[:, :G] - q_probs, min=0.0)
    res_at_k = res_probs.gather(
        1, torch.clamp(k, max=G - 1)[:, None, None].expand(B, 1, V))[:, 0]
    res_sum = res_at_k.sum(dim=-1, keepdim=True)
    # the bonus (k == G) samples p_G; a degenerate residual (p == q
    # exactly) falls back to p too — both are distribution-exact
    extra_dist = torch.where(
        (k[:, None] < G) & (res_sum > 1e-20),
        res_at_k / torch.clamp(res_sum, min=1e-20),
        p_row_at_k,
    )
    extra_logits = torch.log(torch.clamp(extra_dist, min=1e-30))
    return k, torch.argmax(gumbel + extra_logits, dim=-1)


def spec_round_step(
    carry: Dict[str, Any],
    *,
    prompt_mask: torch.Tensor,  # [B, P] int64
    target: Any,  # target model (logits, + "value" with a value head)
    draft: Any,  # draft LM
    config: GenerationConfig,
    G: int,
    transition_mask: Optional[torch.Tensor] = None,  # [Vm, Vm'] bool
    adjust_logits: Optional[Callable[[Dict[str, Any], torch.Tensor], torch.Tensor]] = None,
) -> Dict[str, Any]:
    """One draft-propose → verify → accept round over the shared carry —
    the body of both :func:`generate_speculative` and the engine's spec
    segment (``ops/slot_refill.py``), so a slot's stream equals a solo run.

    Carry: ``seed`` / ``round`` [B] (the draw counters), ``n_out`` [B]
    committed tokens, ``done`` [B], ``t_last`` [B] (re-fed every round),
    ``t_cache`` / ``d_cache``, output buffers ``tokens`` / ``logprobs`` /
    ``values`` / ``mask`` [B, N+G+1] (written in place), and the scalar
    counters ``rounds`` / ``accepted`` / ``live_rounds`` / ``committed``.
    ``accepted`` counts acceptance before budget and eos clipping,
    ``committed`` after. The step launches work only: no host sync.
    ``transition_mask`` shapes the draft's proposals and the target's
    verify distributions; ``adjust_logits`` the target's only, first."""
    B, P = prompt_mask.shape
    N = config.max_new_tokens
    NB = N + G + 1
    dev = prompt_mask.device
    n_out, done, t_last = carry["n_out"], carry["done"], carry["t_last"]
    seed, counter0 = carry["seed"], carry["round"] * (G + 2)
    c = P + n_out  # [B] next free slot per row

    # this round's slot mask: committed slots + the G probe slots [c, c+G)
    gen_slots = torch.arange(NB - 1, device=dev)[None, :]
    probe = (gen_slots >= n_out[:, None]) & (gen_slots < (n_out + G)[:, None])
    mask_round = torch.cat(
        [prompt_mask, ((gen_slots < n_out[:, None]) | probe).to(torch.int64)], dim=1)

    # ---- the draft proposes G tokens ----
    d_cache, tok = carry["d_cache"], t_last
    d_toks = torch.empty((B, G), dtype=torch.int64, device=dev)
    q_probs = None  # [B, G, V] f32: the residual must use the accept test's q
    for j in range(G):
        out_j = draft(tok[:, None], attention_mask=mask_round, cache=d_cache,
                      cache_index=c - 1 + j)
        logits_j = out_j["logits"][:, -1].float()
        if transition_mask is not None:  # q_{j+1} conditions on the fed token
            logits_j = apply_transition_mask(transition_mask, tok, logits_j)
        logits_j = _block_eos(logits_j, config, n_out + j)
        probs_j = _filtered_probs(logits_j, config)
        if q_probs is None:
            q_probs = torch.empty((B, G, probs_j.shape[-1]), dtype=torch.float32, device=dev)
        if config.do_sample:
            noise = gumbel_noise(seed, counter0 + j, probs_j.shape[-1])
            tok = torch.argmax(noise + torch.log(torch.clamp(probs_j, min=1e-30)), dim=-1)
        else:
            tok = torch.argmax(probs_j, dim=-1)
        d_toks[:, j] = tok
        q_probs[:, j] = probs_j
    # one more draft forward writes d_G's K/V (logits unused): after a
    # fully accepted round the next round marks d_G's slot committed
    draft(tok[:, None], attention_mask=mask_round, cache=d_cache,
          cache_index=c - 1 + G, logits_span=(0, 0))

    # ---- one target forward verifies everything ----
    verify_in = torch.cat([t_last[:, None], d_toks], dim=1)  # [B, G+1]
    t_out = target(verify_in, attention_mask=mask_round, cache=carry["t_cache"],
                   cache_index=c - 1)
    # verify position j produces response position n_out + j
    pos = n_out[:, None] + torch.arange(G + 1, device=dev)[None, :]
    t_logits = t_out["logits"].float()
    if adjust_logits is not None:
        # the plain sampler's order: the algorithm's reshaping, then the
        # mask, then eos blocking; the step outputs keep the verify shape
        step_info = {k: v for k, v in t_out.items()
                     if k not in _NON_CARRY_KEYS and v is not None}
        step_info["last_tokens"] = verify_in  # position j conditions on it
        t_logits = adjust_logits(step_info, t_logits).float()
    if transition_mask is not None:
        t_logits = apply_transition_mask(transition_mask, verify_in, t_logits)
    t_logits = _block_eos(t_logits, config, pos)
    p_probs = _filtered_probs(t_logits, config)  # p_0 .. p_G
    t_logprobs_all = torch.log_softmax(t_logits, dim=-1)
    t_values = t_out.get("value")
    t_values = (torch.zeros((B, G + 1), dtype=torch.float32, device=dev)
                if t_values is None else t_values.float())

    # ---- acceptance ----
    uniforms = gumbel = None
    if config.do_sample:
        uniforms = uniform_noise(seed, counter0 + G, G)
        gumbel = gumbel_noise(seed, counter0 + G + 1, p_probs.shape[-1])
    k, extra = accept_and_extra(p_probs, q_probs, d_toks, uniforms, gumbel, config.do_sample)

    # ---- the committed block d_1..d_k, extra, clipped by budget and eos ----
    j_iota = torch.arange(G + 1, device=dev)[None, :]
    block_toks = torch.cat([d_toks, torch.zeros((B, 1), dtype=torch.int64, device=dev)], dim=1)
    block_toks = torch.where(j_iota == k[:, None], extra[:, None], block_toks)
    block_lp = t_logprobs_all.gather(-1, block_toks[..., None])[..., 0]
    valid = (j_iota <= k[:, None]) & ((n_out[:, None] + j_iota) < N) & ~done[:, None]
    if config.eos_token_id is not None:
        is_eos = (block_toks == config.eos_token_id).to(torch.int64)
        valid = valid & ((torch.cumsum(is_eos, dim=1) - is_eos) == 0)
    commit_len = valid.sum(dim=1)
    block_toks_w = torch.where(valid, block_toks, torch.full_like(block_toks, config.pad_token_id))
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    # per-row block write; done rows re-write pads over pads
    cols = torch.clamp(n_out, max=NB - (G + 1))[:, None] + j_iota
    carry["tokens"].scatter_(1, cols, block_toks_w.to(carry["tokens"].dtype))
    carry["logprobs"].scatter_(1, cols, torch.where(valid, block_lp, zero))
    carry["values"].scatter_(1, cols, torch.where(valid, t_values, zero))
    carry["mask"].scatter_(1, cols, valid.to(carry["mask"].dtype))

    n_new = n_out + commit_len
    done_new = done | (n_new >= N)
    if config.eos_token_id is not None:
        done_new = done_new | ((block_toks_w == config.eos_token_id) & valid).any(dim=1)
    last = block_toks_w.gather(1, torch.clamp(commit_len - 1, min=0)[:, None])[:, 0]
    live = ~done
    return {
        **carry,
        "round": carry["round"] + 1,
        "n_out": n_new,
        "done": done_new,
        "t_last": torch.where(commit_len > 0, last, t_last),
        "t_cache": t_out["cache"],
        "rounds": carry["rounds"] + 1,
        "accepted": carry["accepted"] + torch.where(live, k, 0).sum(),
        "live_rounds": carry["live_rounds"] + live.sum(),
        "committed": carry["committed"] + torch.where(live, commit_len, 0).sum(),
    }


@torch.no_grad()
def generate_speculative(
    target: Any,  # CausalTransformer or CausalLMWithValueHead
    draft: Any,  # CausalTransformer
    input_ids: torch.Tensor,  # [B, P] left-padded prompts
    attention_mask: torch.Tensor,  # [B, P]
    seeds: torch.Tensor,  # [B] int64 per-row seeds
    config: GenerationConfig,
    gamma: int = 4,
    return_stats: bool = False,
    transition_mask: Any = None,  # [Vm, Vm'] bool: draft and target alike
    adjust_logits: Optional[Callable[[Dict[str, Any], torch.Tensor], torch.Tensor]] = None,
):
    """Sample ``config.max_new_tokens`` continuations by draft-and-verify
    with dense caches of ``S = P + N + G`` columns — the solo reference the
    speculative engine is held against. Returns a
    :class:`~trlx_tpu_torch.ops.sampling.GenerationOutput` (the target's
    logprobs and values, with :func:`~trlx_tpu_torch.ops.sampling.generate`'s
    semantics), or ``(output, stats)``. The hooks act as in
    :func:`spec_round_step`."""
    from trlx_tpu_torch.models.transformer import make_kv_cache

    device = next(target.parameters()).device
    if transition_mask is not None:
        transition_mask = torch.as_tensor(transition_mask, dtype=torch.bool, device=device)
    input_ids = input_ids.to(device=device, dtype=torch.int64)
    prompt_mask = attention_mask.to(device=device, dtype=torch.int64)
    seeds = seeds.to(device=device, dtype=torch.int64)
    B, P = input_ids.shape
    N, G = config.max_new_tokens, int(gamma)
    NB, S = N + G + 1, P + N + G
    slot0 = torch.cat([prompt_mask, torch.zeros((B, NB - 1), dtype=torch.int64,
                                                device=device)], dim=1)
    t_cache = make_kv_cache(target.config, B, S, device=device)
    d_cache = make_kv_cache(draft.config, B, S, device=device)
    # prefill both caches over the prompt; the first round re-feeds the
    # last prompt token, so the prefill logits are never used
    target(input_ids, attention_mask=slot0, cache=t_cache, cache_index=0, logits_span=(0, 0))
    draft(input_ids, attention_mask=slot0, cache=d_cache, cache_index=0, logits_span=(0, 0))

    i64 = dict(dtype=torch.int64, device=device)
    carry = {
        "seed": seeds, "round": torch.zeros((B,), **i64),
        "n_out": torch.zeros((B,), **i64), "done": torch.zeros((B,), dtype=torch.bool,
                                                                device=device),
        "t_last": input_ids[:, -1], "t_cache": t_cache, "d_cache": d_cache,
        "tokens": torch.full((B, NB), config.pad_token_id, dtype=torch.int32, device=device),
        "logprobs": torch.zeros((B, NB), dtype=torch.float32, device=device),
        "values": torch.zeros((B, NB), dtype=torch.float32, device=device),
        "mask": torch.zeros((B, NB), dtype=torch.int32, device=device),
        **{k: torch.zeros((), **i64) for k in ("rounds", "accepted", "live_rounds",
                                                "committed")},
    }
    while not bool(carry["done"].all()):
        carry = spec_round_step(carry, prompt_mask=prompt_mask, target=target, draft=draft,
                                config=config, G=G, transition_mask=transition_mask,
                                adjust_logits=adjust_logits)
    tokens = carry["tokens"][:, :N]
    out = GenerationOutput(
        sequences=torch.cat([input_ids.to(torch.int32), tokens], dim=1),
        response_tokens=tokens,
        response_mask=carry["mask"][:, :N],
        response_logprobs=carry["logprobs"][:, :N],
        response_values=carry["values"][:, :N],
        prompt_mask=prompt_mask.to(torch.int32),
    )
    if not return_stats:
        return out
    live_rounds = max(int(carry["live_rounds"]), 1)
    return out, {
        "rounds": int(carry["rounds"]),
        "accepted_draft_tokens": int(carry["accepted"]),
        "acceptance_rate": int(carry["accepted"]) / (live_rounds * G),
        "tokens_per_round": int(carry["committed"]) / live_rounds,
    }
