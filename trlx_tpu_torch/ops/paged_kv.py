"""Paged KV cache: fixed-size KV blocks + per-slot block tables.

Port of ``trlx_tpu/ops/paged_kv.py``. The persistent KV state is a block
pool — per layer ``{"k", "v"}`` tensors of ``[max_blocks, block_size,
kv_heads, head_dim]`` — plus a
``[B, TB]`` int32 block table mapping logical cache column ``s`` of slot
``b`` to pool row ``table[b, s // block_size]``. Blocks are handed out by
the host allocator (``trlx_tpu_torch/engine/allocator.py``) as sequences
grow and freed at harvest.

Physical block 0 is the reserved block: fresh table entries point there
and the allocator never hands it out. It starts as zeros, but nothing
relies on that: the speculative verify's probe columns past a row's
allocated blocks are written into it (as in the JAX package), and every
column that reads it is masked by the ``-1e9`` bias.
Unlike the JAX package (immutable arrays), the pool here is updated in
place: the model's paged attention commits each step's K/V straight into
the pool tensors, which saves a pool copy per step.

The gather paths (``engine.decode_kernel`` / ``engine.prefill_kernel``
``xla``, JAX's reference shape) run the dense compute on a transient view:
:func:`gather_view` builds the dense ``[rows, S]`` cache of a set of table
rows, and :func:`scatter_span` (a prefill span) or :func:`scatter_steps`
(each row's decode-segment columns) commit the written columns back into
the pool. Out-of-range table ids (padding rows, frozen slots) read the last
pool block, which their masks hide, and write nothing.

Block copies for the host tier (``serve/tiering.py``; the JAX tier's
``_read_block`` / ``_write_blocks``): :func:`read_block` copies one
block's rows of every layer's K and V into a row of host buffers
(:func:`host_block_buffers`, pinned when the pool is on the card), and
:func:`write_blocks` writes a run of such rows back into pool blocks, one
host → device copy per layer and tensor for the whole run. The copies are
verbatim, so a written-back block is bitwise the block that was read.
"""

from typing import Any, List, NamedTuple

import torch

__all__ = [
    "ZERO_BLOCK",
    "PagedSpec",
    "PagedKV",
    "num_table_blocks",
    "init_paged_kv",
    "attach_block_table",
    "detach_block_table",
    "gather_view",
    "scatter_span",
    "scatter_steps",
    "kv_bytes",
    "block_bytes",
    "dense_kv_bytes",
    "host_block_buffers",
    "read_block",
    "write_blocks",
]

ZERO_BLOCK = 0


class PagedSpec(NamedTuple):
    """Static paged-cache geometry."""

    block_size: int
    max_blocks: int  # pool rows, including the reserved zero block


class PagedKV(NamedTuple):
    """The persistent paged KV state: per-layer pool list + ``[B, TB]``
    int32 block table (host-managed between engine steps)."""

    pool: List[dict]
    block_table: torch.Tensor


def num_table_blocks(slots: int, block_size: int) -> int:
    """Table width: blocks needed to cover ``slots`` logical columns."""
    return -(-slots // block_size)


def init_paged_kv(init_cache_fn, spec: PagedSpec, batch_size: int, slots: int,
                  device=None) -> PagedKV:
    """All-zeros pool + all-zero-block tables for ``batch_size`` slots.
    ``init_cache_fn(rows, length)`` builds the per-layer cache structure;
    the pool reuses it with the block axis as rows."""
    pool = init_cache_fn(spec.max_blocks, spec.block_size)
    return PagedKV(
        pool=pool,
        block_table=torch.zeros(
            (batch_size, num_table_blocks(slots, spec.block_size)),
            dtype=torch.int32,
            device=device if device is not None else pool[0]["k"].device,
        ),
    )


def attach_block_table(pool: List[dict], block_table: torch.Tensor) -> List[dict]:
    """Per-layer cache views of the pool that carry the block table — the
    cache the model's paged attention branch recognises. Rows whose table
    entries are out of range (``>= max_blocks``) write nothing and read
    clamped values their callers discard."""
    return [{**layer, "block_table": block_table} for layer in pool]


def detach_block_table(cache: List[dict]) -> List[dict]:
    """Inverse of :func:`attach_block_table`: the bare pool list."""
    return [{k: v for k, v in layer.items() if k != "block_table"} for layer in cache]


def gather_view(pool: List[dict], block_table: torch.Tensor, slots: int) -> List[dict]:
    """Dense per-layer ``{"k", "v"}`` views ``[rows, slots, KV, D]`` of
    ``block_table``'s rows (fresh tensors: the dense forwards write into
    them). Table ids are clamped into the pool, so an out-of-range padding
    id reads the last block; such columns are masked out of attention and
    never scattered back."""
    NB = pool[0]["k"].shape[0]
    R, TB = block_table.shape
    idx = torch.clamp(block_table.to(torch.int64), 0, NB - 1)

    def view(leaf):
        v = leaf[idx]  # [R, TB, bs, KV, D]
        return v.reshape((R, TB * leaf.shape[1]) + tuple(leaf.shape[2:]))[:, :slots].contiguous()

    return [{name: view(layer[name]) for name in ("k", "v")} for layer in pool]


def _commit(pool: List[dict], block_table: torch.Tensor, dense: List[dict], rows: torch.Tensor,
            cols: torch.Tensor, valid: torch.Tensor) -> List[dict]:
    """Write ``dense[l][name][rows, cols]`` into the pool at the table's
    blocks for the lanes where ``valid`` holds and the table id is in
    range (drop-mode: everything else writes nothing)."""
    NB, bs = pool[0]["k"].shape[:2]
    TB = block_table.shape[1]
    blk = block_table.to(torch.int64).gather(1, torch.clamp(cols // bs, max=TB - 1))
    keep = valid & (blk >= 0) & (blk < NB)
    r, j = keep.nonzero(as_tuple=True)
    dst = (blk * bs + cols % bs)[r, j]
    src_rows, src_cols = rows.expand_as(cols)[r, j], cols[r, j]
    for layer, view in zip(pool, dense):
        for name in ("k", "v"):
            leaf = layer[name]
            leaf.view((NB * bs,) + tuple(leaf.shape[2:]))[dst] = (
                view[name][src_rows, src_cols].to(leaf.dtype))
    return pool


def scatter_span(pool: List[dict], block_table: torch.Tensor, dense_rows: List[dict],
                 start: int, length: int) -> List[dict]:
    """Commit columns ``[start, start + length)`` of the dense row views
    into the pool through the rows' tables (the prefill write-back), in
    place; rows whose table ids are out of range write nothing."""
    if length <= 0:
        return pool
    R = block_table.shape[0]
    device = block_table.device
    cols = (start + torch.arange(length, device=device))[None, :].expand(R, length)
    rows = torch.arange(R, device=device)[:, None]
    return _commit(pool, block_table, dense_rows, rows, cols,
                   torch.ones((R, length), dtype=torch.bool, device=device))


def scatter_steps(pool: List[dict], block_table: torch.Tensor, dense_view: List[dict],
                  base_cols: torch.Tensor, counts: torch.Tensor, max_steps: int) -> List[dict]:
    """Commit each row's decode-segment writes, columns ``[base_cols[b],
    base_cols[b] + counts[b])`` of the dense view, into the pool, in
    place. A row that froze mid-segment commits only its live writes; the
    dense compute's dead writes (done rows re-writing masked columns) are
    not carried over."""
    B = block_table.shape[0]
    device = block_table.device
    S = dense_view[0]["k"].shape[1]
    j = torch.arange(max_steps, device=device)[None, :]
    cols = base_cols.to(device, torch.int64)[:, None] + j
    valid = j < counts.to(device, torch.int64)[:, None]
    rows = torch.arange(B, device=device)[:, None]
    return _commit(pool, block_table, dense_view, rows, torch.clamp(cols, 0, S - 1), valid)


def _leaves(cache: Any):
    if isinstance(cache, PagedKV):
        cache = cache.pool
    for layer in cache:
        for k in ("k", "v"):
            yield layer[k]


def kv_bytes(cache: Any) -> int:
    """Total bytes of a KV pool (or dense cache)."""
    return int(sum(t.numel() * t.element_size() for t in _leaves(cache)))


def block_bytes(cache: Any) -> int:
    """Bytes of ONE block across all layers and k/v."""
    return int(
        sum(t.numel() * t.element_size() // t.shape[0] for t in _leaves(cache))
    )


def dense_kv_bytes(cfg: Any, batch_size: int, slots: int) -> int:
    """Bytes of the dense ``[batch_size, slots]`` cache that
    :func:`~trlx_tpu_torch.models.transformer.make_kv_cache` allocates for
    ``cfg`` (k and v of every layer in ``cfg.dtype``): the serial rollout
    path's ``memory/kv_cache_bytes``."""
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    return int(2 * cfg.num_layers * batch_size * slots * cfg.cache_kv_heads
               * cfg.dims_per_head * itemsize)


def host_block_buffers(pool: List[dict], rows: int) -> List[dict]:
    """Per-layer ``{"k", "v"}`` host tensors of ``[rows, bs, KV, D]`` in the
    pool's dtype: ``rows`` blocks' worth of every layer. Pinned when the
    pool is on the card, so the copies in and out run asynchronously on the
    current stream."""
    pin = pool[0]["k"].is_cuda
    return [{name: torch.empty((rows,) + tuple(layer[name].shape[1:]),
                               dtype=layer[name].dtype, pin_memory=pin)
             for name in ("k", "v")} for layer in pool]


def read_block(pool: List[dict], block: int, out: List[dict], row: int) -> None:
    """Copy pool block ``block`` of every layer's K and V into row ``row`` of
    the host buffers ``out`` (stream-ordered: a later kernel that reuses
    the block cannot overwrite it before the copy has read it)."""
    for layer, buf in zip(pool, out):
        for name in ("k", "v"):
            buf[name][row].copy_(layer[name][block], non_blocking=True)


def write_blocks(pool: List[dict], blocks: List[int], src: List[dict],
                 rows: List[int]) -> List[dict]:
    """Write host rows ``rows`` of ``src`` verbatim into pool blocks
    ``blocks`` (in place; returns the pool): the run is gathered into one
    staging tensor per layer and tensor and copied in one transfer."""
    device = pool[0]["k"].device
    idx = torch.as_tensor(list(rows), dtype=torch.int64)
    dst = torch.as_tensor(list(blocks), dtype=torch.int64, device=device)
    for layer, buf in zip(pool, src):
        for name in ("k", "v"):
            staged = buf[name].index_select(0, idx)
            if device.type == "cuda":
                staged = staged.pin_memory()
            layer[name].index_copy_(0, dst, staged.to(device, non_blocking=True))
    return pool
