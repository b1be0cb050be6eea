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
