"""Seeded inputs shared by the port's kernel tests: paged-attention cases
(pool, block table, bias) and sampling rows with planted ties. Numpy only,
so the tests that run on the card import no JAX."""

import numpy as np
import torch

from trlx_tpu_torch.ops.paged_kv import num_table_blocks

# (B, T, H, KV, D, block_size, S): block sizes 1/3/4, S not a multiple of
# the block size, GQA ratios 1/2/4, odd table widths
GEOMETRIES = [
    (3, 5, 4, 2, 16, 3, 10),
    (2, 3, 8, 8, 32, 1, 7),
    (2, 4, 8, 2, 16, 4, 13),
]

SAMPLE_SETTINGS = [
    dict(temperature=1.0, top_k=0, top_p=1.0),
    dict(temperature=0.7, top_k=5, top_p=1.0),
    dict(temperature=1.0, top_k=0, top_p=0.8),
    dict(temperature=1.3, top_k=7, top_p=0.6),
]


def paged_case(geometry, per_head_bias, seed):
    """Random pool/table/bias: rows see a random causal prefix with holes;
    table entries past a row's visible columns are poisoned out of range
    (they clamp, and their columns are masked); every pool block holds
    random stale values that masked columns must not leak."""
    B, T, H, KV, D, bs, S = geometry
    rs = np.random.RandomState(seed)
    TB = num_table_blocks(S, bs)
    NB = 1 + B * TB + 3
    q = rs.randn(B, T, H, D).astype(np.float32)
    k_pool = rs.randn(NB, bs, KV, D).astype(np.float32)
    v_pool = rs.randn(NB, bs, KV, D).astype(np.float32)
    table = rs.permutation(np.arange(1, NB))[: B * TB].reshape(B, TB).astype(np.int32)
    valid = rs.randint(T, S + 1, size=B)
    q_slots = valid[:, None] - T + np.arange(T)[None, :]
    vis = (np.arange(S)[None, None, :] <= q_slots[:, :, None]) & (rs.rand(B, 1, S) > 0.15)
    vis[:, :, 0] = True
    HB = H if per_head_bias else 1
    bias = np.where(vis, 0.0, -1e9)[:, None].repeat(HB, axis=1).astype(np.float32)
    if per_head_bias:  # ALiBi-shaped per-head additive terms
        bias = bias + np.where(vis[:, None], rs.randn(B, HB, 1, S) * 0.5, 0.0).astype(np.float32)
    for b in range(B):
        table[b, -(-int(valid[b]) // bs):] = NB + 2 + b
    return q, k_pool, v_pool, table, bias


def tied_logits(seed, B=6, V=97):
    """Random logits with exact ties planted at the top-k boundary (the 4th
    to 7th largest values repeat) and a run of equal values mid-row, so
    both thresholds land on ties."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(B, V) * 2.0).astype(np.float32)
    for b in range(B):
        order = np.argsort(-x[b])
        x[b, order[3:7]] = x[b, order[3]]
        x[b, order[10:20]] = x[b, order[10]]
    x[0, 5] = -np.inf  # an eos-blocked column
    return x


def t(x):
    return torch.tensor(np.asarray(x))


# flash attention: (B, T, S, H, KV, D, causal, left_pad, q_offset, k_offset,
# window, alibi) — ragged tiles (T, S not multiples of 32), GQA, a window,
# ALiBi and rows that see no key (k_offset ahead of the queries)
FLASH_CASES = [
    (2, 13, 13, 4, 4, 64, True, 3, 0, 0, 0, False),
    (2, 40, 70, 8, 2, 64, True, 5, 30, 0, 0, False),
    (1, 33, 33, 4, 2, 128, True, 0, 0, 0, 9, True),
    (2, 20, 20, 2, 2, 32, True, 0, 0, 6, 0, False),
    (2, 17, 45, 4, 4, 16, False, 7, 0, 0, 0, True),
]


def flash_case(case, seed):
    """(q, k, v, key_mask, extra kwargs, cotangent) as numpy; ``extra``
    holds the ALiBi positions and slopes when the case has them."""
    B, T, S, H, KV, D, causal, left_pad, qo, ko, window, alibi = case
    rs = np.random.RandomState(seed)
    q = rs.randn(B, T, H, D).astype(np.float32)
    k = rs.randn(B, S, KV, D).astype(np.float32)
    v = rs.randn(B, S, KV, D).astype(np.float32)
    mask = np.ones((B, S), np.float32)
    if left_pad:
        mask[:, :left_pad] = 0.0
        mask[0, : left_pad + 2] = 0.0
    extra = dict(causal=causal, q_offset=qo, k_offset=ko, window=window)
    if alibi:
        extra["k_positions"] = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
        extra["q_positions"] = (np.arange(T, dtype=np.int32)[None].repeat(B, 0) + qo)
        extra["alibi_slopes"] = (2.0 ** (-8.0 * np.arange(1, H + 1) / H)).astype(np.float32)
    return q, k, v, mask, extra, rs.randn(B, T, H, D).astype(np.float32)


def loss_case(B, R, seed, tie_values=False):
    """The fused loss's seven (B, R) f32 operands (logprobs, values,
    old_logprobs, old_values, rewards, mask, behavior_logprobs): ratios
    inside and outside the clip range, a fully masked row, and (with
    ``tie_values``) new values exactly on the value-clip bounds."""
    rs = np.random.RandomState(seed)
    lp = (rs.randn(B, R) * 0.1).astype(np.float32)
    olp = (lp + rs.randn(B, R) * 0.15).astype(np.float32)
    ov = rs.randn(B, R).astype(np.float32)
    v = (ov + rs.randn(B, R) * 0.3).astype(np.float32)
    rw = (rs.randn(B, R) * 0.05).astype(np.float32)
    mask = (rs.rand(B, R) > 0.25).astype(np.float32)
    mask[0] = 0.0
    if tie_values:
        v[:, ::4] = (ov + np.float32(0.2))[:, ::4]
        v[:, 1::4] = (ov - np.float32(0.2))[:, 1::4]
    blp = (olp + rs.randn(B, R) * 0.05).astype(np.float32)
    return [lp, v, olp, ov, rw, mask, blp]
