"""Seeded inputs shared by the port's kernel tests: paged-attention cases
(pool, block table, bias) and sampling rows with planted ties. Numpy only,
so the tests that run on the card import no JAX."""

import numpy as np
import torch

from chip_smoke import RIGHT_PAD_FLASH_SHAPES, right_pad_mask
from trlx_tpu_torch.ops.paged_kv import num_table_blocks

# (B, T, H, KV, D, block_size, S): block sizes 1/3/4, S not a multiple of
# the block size, GQA ratios 1/2/4, odd table widths; head dims 12 (the
# randomwalks model's) and 96 (gptneox-20b's) besides the kernels'
# templates, and 320 (above 256: split over the head dim on the card)
GEOMETRIES = [
    (3, 5, 4, 2, 16, 3, 10),
    (2, 3, 8, 8, 32, 1, 7),
    (2, 4, 8, 2, 16, 4, 13),
    (2, 3, 4, 2, 12, 4, 11),
    (2, 4, 4, 4, 96, 3, 9),
    (2, 3, 4, 2, 320, 4, 11),
]

# on the card only, the bf16 tensor-core kernel's edges besides: T on both
# sides of its layout switch at 16 (1, 5, 16, 17, 33, 64, 100; 17, 33 and
# 100 leave a ragged last query tile), block sizes 1/3/16 with S not a
# multiple of its 16- or 32-column chunks, head dims 16/64/128, GQA groups
# 1 and 4; and the decode kernel's: a one-column row (S = 1), a row split
# into four 256-column spans and merged (S = 1024), head groups of 3, 8 and
# 12 (its blocks serve up to 8 heads of a group: 3 of 4, and 8 + 4 over
# two blocks); head dims off the templates, padded inside the kernels (12,
# 48, 96 on both sides of the layout switch, on the split decode row and in
# a GQA group) and 256 (CUDA cores for the span kernel, four heads a block
# for decode), and 320 and 512 (split into 256-column chunks: a ragged and
# an even last chunk) with GQA, on both sides of the span kernel's layout
# switch and on a split decode row. Every geometry runs with head-uniform
# and per-head bias and poisoned table ids.
CUDA_GEOMETRIES = GEOMETRIES + [
    (2, 1, 4, 4, 16, 1, 9),
    (3, 5, 8, 2, 64, 3, 40),
    (2, 16, 4, 1, 128, 16, 50),
    (2, 17, 4, 4, 64, 16, 45),
    (2, 64, 2, 2, 64, 16, 104),
    (1, 100, 4, 1, 16, 3, 130),
    (2, 33, 4, 1, 128, 1, 70),
    (3, 1, 4, 4, 64, 16, 1),
    (2, 2, 4, 2, 64, 16, 1024),
    (2, 3, 16, 2, 32, 5, 60),
    (2, 4, 6, 2, 16, 3, 20),
    (1, 2, 12, 1, 128, 4, 30),
    (2, 17, 4, 2, 48, 16, 45),
    (2, 5, 4, 1, 96, 3, 40),
    (2, 33, 4, 4, 12, 16, 70),
    (2, 1, 4, 4, 12, 16, 600),
    (2, 3, 12, 2, 256, 16, 50),
    (2, 20, 4, 4, 256, 3, 40),
    (1, 2, 8, 1, 256, 16, 300),
    (2, 20, 4, 2, 320, 3, 40),
    (2, 5, 8, 2, 512, 16, 45),
    (1, 1, 4, 2, 512, 16, 600),
]

SAMPLE_SETTINGS = [
    dict(temperature=1.0, top_k=0, top_p=1.0),
    dict(temperature=0.7, top_k=5, top_p=1.0),
    dict(temperature=1.0, top_k=0, top_p=0.8),
    dict(temperature=1.3, top_k=7, top_p=0.6),
]


def paged_case(geometry, per_head_bias, seed, dead_row=False):
    """Random pool/table/bias: rows see a random causal prefix with holes;
    table entries past a row's visible columns are poisoned out of range
    (they clamp, and their columns are masked); every pool block holds
    random stale values that masked columns must not leak. ``dead_row``
    masks every column of row 0's first query (the softmax then averages
    all ``S`` columns)."""
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
    if dead_row:
        vis[0, 0] = False
    HB = H if per_head_bias else 1
    bias = np.where(vis, 0.0, -1e9)[:, None].repeat(HB, axis=1).astype(np.float32)
    if per_head_bias:  # ALiBi-shaped per-head additive terms
        bias = bias + np.where(vis[:, None], rs.randn(B, HB, 1, S) * 0.5, 0.0).astype(np.float32)
    for b in range(B):
        table[b, -(-int(valid[b]) // bs):] = NB + 2 + b
    return q, k_pool, v_pool, table, bias


# the speculative verify: (B, G, H, KV, D, block_size, P, N, done rows)
VERIFY_CASES = [
    (4, 3, 4, 2, 16, 4, 8, 10, 1),
    (5, 4, 8, 8, 32, 3, 11, 9, 2),
    (3, 2, 4, 2, 12, 4, 8, 6, 1),
    (3, 3, 4, 4, 96, 3, 7, 6, 1),
    (3, 3, 4, 2, 320, 4, 8, 6, 1),
]

# on the card only besides: D = 128 with GQA group 4, T = 16 at the bf16
# kernel's layout switch with block size 1, T = 17 (a verify through the
# prefill layout), and the speculative slice's shape (G = 4, S = 108)
CUDA_VERIFY_CASES = VERIFY_CASES + [
    (4, 4, 4, 1, 128, 16, 40, 30, 1),
    (3, 15, 4, 4, 16, 1, 20, 20, 1),
    (3, 16, 2, 2, 64, 3, 24, 20, 1),
    (32, 4, 12, 12, 64, 16, 64, 40, 4),
    (4, 4, 4, 2, 48, 16, 30, 20, 1),
    (4, 4, 4, 4, 256, 16, 30, 20, 1),
    (3, 4, 4, 2, 512, 16, 30, 20, 1),
]


def verify_case(case, seed):
    """The verify's operands at per-row depths: row ``b`` has committed
    ``n_b`` tokens behind a left-padded prompt and probes the ``T = G + 1``
    columns ``[c - 1, c + G)``, ``c = P + n_b`` (row 0's window crosses a
    block edge); the bias is the slot-causal mask over committed and probe
    slots; table entries past a row's allocated blocks stay 0 (the reserved
    block, which probe writes dirty); the last rows are done, their whole
    table poisoned out of range. Returns ``(q, k_pool, v_pool, table,
    bias)`` as numpy."""
    B, G, H, KV, D, bs, P, N, done = case
    T, S = G + 1, P + N + G
    rs = np.random.RandomState(seed)
    TB = num_table_blocks(S, bs)
    NB = 1 + B * TB + 3
    n_out = rs.randint(0, N, size=B)
    n_out[0] = (bs - (P - 1) % bs - 2) % bs  # c - 1 on a block's second-to-last column
    c = P + n_out
    slot_mask = np.zeros((B, S), bool)
    for b in range(B):
        slot_mask[b, rs.randint(0, P // 2): c[b] + G] = True
    vis = slot_mask[:, None, :] & (np.arange(S)[None, None, :]
                                   <= (c[:, None] - 1 + np.arange(T))[:, :, None])
    bias = np.where(vis, 0.0, -1e9)[:, None].astype(np.float32)
    perm = rs.permutation(np.arange(1, NB))[: B * TB].reshape(B, TB)
    table = np.zeros((B, TB), np.int32)
    for b in range(B):
        alloc = -(-int(c[b]) // bs)  # the committed columns' blocks
        table[b, :alloc] = perm[b, :alloc]
    table[B - done:] = NB
    q = rs.randn(B, T, H, D).astype(np.float32)
    k_pool = rs.randn(NB, bs, KV, D).astype(np.float32)
    v_pool = rs.randn(NB, bs, KV, D).astype(np.float32)
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
# ALiBi and rows that see no key (k_offset ahead of the queries); for the
# bf16 backward's 64-row tiles besides: T and S of 63, 65 and 129 on both
# sides of a tile edge, T = 1, GQA group 4 at D = 128 (dk/dv summed over the
# group inside a block), a window edge inside a tile, and rows that see no
# key across a whole tile; head dims 12, 48 and 96 (padded inside the
# tensor-core kernels), 256 (the CUDA-core kernels in bf16), and 320 and
# 512 with GQA (the CUDA-core kernels split over the head dim)
FLASH_CASES = [
    (2, 13, 13, 4, 4, 64, True, 3, 0, 0, 0, False),
    (2, 40, 70, 8, 2, 64, True, 5, 30, 0, 0, False),
    (1, 33, 33, 4, 2, 128, True, 0, 0, 0, 9, True),
    (2, 20, 20, 2, 2, 32, True, 0, 0, 6, 0, False),
    (2, 17, 45, 4, 4, 16, False, 7, 0, 0, 0, True),
    (2, 63, 65, 4, 4, 64, True, 3, 2, 0, 0, False),
    (1, 65, 63, 2, 1, 32, False, 5, 0, 0, 0, True),
    (1, 129, 129, 2, 2, 64, True, 9, 0, 0, 0, False),
    (2, 1, 40, 4, 2, 64, True, 3, 39, 0, 0, False),
    (1, 70, 70, 8, 2, 128, True, 4, 0, 0, 0, True),
    (1, 100, 100, 2, 2, 64, True, 0, 0, 0, 37, False),
    (1, 90, 90, 2, 2, 16, True, 0, 0, 70, 0, False),
    (2, 70, 70, 4, 4, 12, True, 3, 0, 0, 0, False),
    (1, 65, 80, 4, 2, 48, True, 5, 15, 0, 0, True),
    (2, 40, 40, 4, 2, 96, True, 2, 0, 0, 21, False),
    (1, 37, 50, 4, 2, 256, True, 3, 13, 0, 0, True),
    (1, 37, 50, 4, 2, 320, True, 3, 13, 0, 9, True),
    (2, 33, 33, 4, 2, 512, True, 2, 0, 0, 0, False),
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


# the offline trainers' right-padded flash rows (chip_smoke.py's shapes)
# on the card, and ragged tiles besides
CUDA_RIGHT_PAD_FLASH_SHAPES = [RIGHT_PAD_FLASH_SHAPES[0], RIGHT_PAD_FLASH_SHAPES[2],
                               (4, 70, 12, 12), (3, 129, 4, 64)]


def right_padded_flash_case(shape, seed):
    """``flash_case``'s tuple for a causal, right-padded, T = S shape."""
    B, T, H, D = shape
    rs = np.random.RandomState(seed)
    q, k, v, cot = (rs.randn(B, T, H, D).astype(np.float32) for _ in range(4))
    extra = dict(causal=True, q_offset=0, k_offset=0, window=0)
    return q, k, v, right_pad_mask(B, T, seed + 1), extra, cot
