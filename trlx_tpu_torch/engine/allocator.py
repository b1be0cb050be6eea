"""Refcounted KV-block allocator (host half of the paged cache).

Port of ``trlx_tpu/engine/allocator.py`` (host Python, near verbatim).
Owns the free list over the pool built by ``ops/paged_kv.py``. Every block
carries a reference count; a decoding slot holds one ref on each block its
table points at. Block 0 is the reserved all-zeros block
(``paged_kv.ZERO_BLOCK``): never allocated, never freed.

Tenant quotas: a block allocated on behalf of a named tenant counts
against that tenant's budget until it is freed; ``tenant=None`` is
unowned and uncounted. Single-threaded, like the engine that owns it.
"""

from collections import deque
from typing import Deque, Dict, Iterable, List, Optional

from trlx_tpu_torch.ops.paged_kv import ZERO_BLOCK

__all__ = ["BlockPoolExhausted", "TenantQuotaExceeded", "BlockAllocator"]


class BlockPoolExhausted(RuntimeError):
    """An allocation cannot be satisfied — the pool is too small for the
    live working set."""


class TenantQuotaExceeded(RuntimeError):
    """An allocation would push a quota'd tenant past its block budget
    (the pool itself may have free blocks)."""


class BlockAllocator:
    """Free-list + refcount bookkeeping over ``max_blocks`` pool rows."""

    def __init__(self, max_blocks: int):
        if max_blocks < 2:
            raise ValueError(
                f"max_blocks {max_blocks} leaves no allocatable block beyond "
                "the reserved zero block"
            )
        self.max_blocks = int(max_blocks)
        # FIFO reuse keeps recycling deterministic and spreads writes over
        # the pool, so stale-data masking bugs surface in tests
        self._free: Deque[int] = deque(
            b for b in range(self.max_blocks) if b != ZERO_BLOCK
        )
        self._refcount: Dict[int, int] = {}
        self.high_water = 0  # max blocks simultaneously in use
        self._quota: Dict[str, int] = {}
        self._owner: Dict[int, str] = {}
        self._tenant_used: Dict[str, int] = {}

    @property
    def blocks_in_use(self) -> int:
        return len(self._refcount)

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        return self._refcount.get(block, 0)

    def tenant_blocks_in_use(self, tenant: str) -> int:
        return self._tenant_used.get(tenant, 0)

    def tenant_quota(self, tenant: str) -> Optional[int]:
        return self._quota.get(tenant)

    def set_tenant_quota(self, tenant: str, blocks: int) -> None:
        """Cap ``tenant``'s simultaneously-owned blocks (future
        allocations only)."""
        if blocks < 1:
            raise ValueError(f"tenant quota for {tenant!r} must be >= 1, got {blocks}")
        self._quota[tenant] = int(blocks)

    def alloc(self, n: int, tenant: Optional[str] = None) -> List[int]:
        """Take ``n`` fresh blocks (refcount 1 each)."""
        if tenant is not None:
            quota = self._quota.get(tenant)
            used = self._tenant_used.get(tenant, 0)
            if quota is not None and used + n > quota:
                raise TenantQuotaExceeded(
                    f"tenant {tenant!r} needs {n} KV blocks with {used}/"
                    f"{quota} quota blocks already owned"
                )
        if n > len(self._free):
            raise BlockPoolExhausted(
                f"need {n} KV blocks, {len(self._free)} free "
                f"({self.blocks_in_use}/{self.max_blocks - 1} in use) — "
                "raise max_blocks or shrink the slot batch"
            )
        out = [self._free.popleft() for _ in range(n)]
        for b in out:
            self._refcount[b] = 1
        if tenant is not None:
            for b in out:
                self._owner[b] = tenant
            self._tenant_used[tenant] = self._tenant_used.get(tenant, 0) + n
        self.high_water = max(self.high_water, self.blocks_in_use)
        return out

    def retain(self, blocks: Iterable[int]) -> None:
        """One more holder for already-allocated blocks."""
        for b in blocks:
            if b not in self._refcount:
                raise ValueError(f"retain of unallocated block {b}")
            self._refcount[b] += 1

    def release(self, blocks: Iterable[int]) -> List[int]:
        """Drop one ref per block; returns the blocks that became free."""
        freed: List[int] = []
        for b in blocks:
            count = self._refcount.get(b)
            if count is None:
                raise ValueError(f"release of unallocated block {b}")
            if count == 1:
                del self._refcount[b]
                self._free.append(b)
                freed.append(b)
                owner = self._owner.pop(b, None)
                if owner is not None:
                    self._tenant_used[owner] -= 1
            else:
                self._refcount[b] = count - 1
        return freed
