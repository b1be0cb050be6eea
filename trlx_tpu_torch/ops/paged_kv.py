"""Paged KV cache: fixed-size KV blocks + per-slot block tables.

Port of the parts of ``trlx_tpu/ops/paged_kv.py`` the in-place kernel path
runs. The persistent KV state is a block pool — per layer ``{"k", "v"}``
tensors of ``[max_blocks, block_size, kv_heads, head_dim]`` — plus a
``[B, TB]`` int32 block table mapping logical cache column ``s`` of slot
``b`` to pool row ``table[b, s // block_size]``. Blocks are handed out by
the host allocator (``trlx_tpu_torch/engine/allocator.py``) as sequences
grow and freed at harvest.

Physical block 0 is the reserved all-zeros block: fresh table entries
point there, the allocator never hands it out and nothing writes it.
Unlike the JAX package (immutable arrays), the pool here is updated in
place: the model's paged attention commits each step's K/V straight into
the pool tensors, which saves a pool copy per step.
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
