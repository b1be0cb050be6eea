"""Host-RAM tiering of evicted prefix blocks.

Port of ``trlx_tpu/serve/tiering.py``. When the block pool (or a tenant
quota) forces the prefix cache to evict a committed entry, the KV bytes a
prefill produced would be gone, and a re-arriving prompt would pay the
whole prefill again. :class:`HostTier` is the second tier: the cache's
``spill`` hook copies the evicted block's rows of every layer into a row of
a bounded host pool (pinned buffers sized in blocks, keyed by the entry's
content-chained digest, which survives evict/re-insert), and the engine's
admission (``ContinuousEngine._prepare_row``) probes it for the chunks
beyond the device hit: a host hit allocates a fresh device block and
writes the saved bytes back instead of prefilling them again.

A spill and a re-land are verbatim copies (``ops/paged_kv.py::read_block``
/ ``write_blocks``), so a re-landed block is bitwise the block that was
spilled. The tier is flushed whenever the engine adopts changed weights:
spilled KV is only valid under the weights that computed it.

Owned and touched only by the thread that drives the engine (the serve
pump, or the trainer's main thread). Serve-side readers go through
:meth:`snapshot` on that thread and ``ServeMetrics``.
"""

from collections import OrderedDict
from typing import Any, Dict, List, Optional

import torch

from trlx_tpu_torch.ops.paged_kv import host_block_buffers, read_block, write_blocks

__all__ = ["HostTier"]


class HostTier:
    """Bounded LRU host pool of spilled prefix-block KV, digest-keyed."""

    def __init__(self, max_blocks: int, block_bytes: int = 0):
        if max_blocks < 1:
            raise ValueError(f"host tier needs max_blocks >= 1, got {max_blocks}")
        self.max_blocks = int(max_blocks)
        self.block_bytes = int(block_bytes)  # informational (metrics)
        # digest → row of the host buffers, in LRU order
        self._rows: "OrderedDict[bytes, int]" = OrderedDict()
        self._free: List[int] = list(range(self.max_blocks))
        # per-layer {"k", "v"} [max_blocks, bs, KV, D], made at the first spill
        self._buf: Optional[List[Dict[str, Any]]] = None
        # recorded after the last device → host spill copy: a re-land reads
        # the host rows, so it waits for that copy first
        self._spill_done: Optional[torch.cuda.Event] = None
        # lifetime counters, read through snapshot() on the owning thread
        self.spilled = 0
        self.evicted = 0
        self.hits = 0
        self.misses = 0
        self.relanded_blocks = 0

    def __len__(self) -> int:
        return len(self._rows)

    def __contains__(self, digest: bytes) -> bool:
        return digest in self._rows

    def spill(self, digest: bytes, pool: List[dict], block: int) -> None:
        """Copy ``block``'s rows host-side under ``digest`` (LRU insert);
        a full tier drops its least recently touched spill first."""
        if digest in self._rows:
            self._rows.move_to_end(digest)
            return
        if self._buf is None:
            self._buf = host_block_buffers(pool, self.max_blocks)
        if not self._free:
            _, row = self._rows.popitem(last=False)
            self._free.append(row)
            self.evicted += 1
        row = self._free.pop()
        read_block(pool, block, self._buf, row)
        if pool[0]["k"].is_cuda:
            self._spill_done = torch.cuda.Event()
            self._spill_done.record()
        self._rows[digest] = row
        self.spilled += 1

    def probe(self, digest: bytes) -> bool:
        hit = digest in self._rows
        if hit:
            self.hits += 1
        else:
            self.misses += 1
        return hit

    def reland_many(self, digests: List[bytes], pool: List[dict],
                    blocks: List[int]) -> List[dict]:
        """Re-land a consecutive run of spilled chunks into freshly
        allocated device ``blocks``, one write per layer and tensor; returns
        the pool (updated in place). The host copies stay (a device entry
        may be evicted again before the host LRU turns)."""
        rows = [self._rows[d] for d in digests]
        for d in digests:
            self._rows.move_to_end(d)
        self.relanded_blocks += len(rows)
        if self._spill_done is not None:
            self._spill_done.synchronize()
            self._spill_done = None
        return write_blocks(pool, blocks, self._buf, rows)

    def clear(self) -> None:
        """Drop every spilled block: the weights changed, the bytes are void."""
        self._free.extend(self._rows.values())
        self._rows.clear()

    def snapshot(self) -> Dict[str, float]:
        """Counter snapshot for the serve metrics pump (owning thread)."""
        return {
            "blocks": float(len(self._rows)),
            "bytes": float(len(self._rows) * self.block_bytes),
            "spilled": float(self.spilled),
            "evicted": float(self.evicted),
            "hits": float(self.hits),
            "misses": float(self.misses),
            "relanded": float(self.relanded_blocks),
        }
