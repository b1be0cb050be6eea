"""Paged KV cache: fixed-size KV blocks + per-slot block tables.

Port of the parts of ``trlx_tpu/ops/paged_kv.py`` the in-place kernel path
runs. The persistent KV state is a block pool — per layer ``{"k", "v"}``
tensors of ``[max_blocks, block_size, kv_heads, head_dim]`` — plus a
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
    return int(2 * cfg.num_layers * batch_size * slots * cfg.kv_heads
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
