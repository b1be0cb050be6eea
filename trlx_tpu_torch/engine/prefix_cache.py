"""Host-side prefix cache: a radix tree over prompt token prefixes mapping
to committed KV blocks.

Port of ``trlx_tpu/engine/prefix_cache.py`` (host Python and numpy; the
digests are the JAX package's bytes for the same tokens, mask and tenant).
Each FULL prompt block (``block_size`` cache columns entirely inside the
prompt region) is keyed by its (token, mask) chunk chained on its parent
block: two padded prompt rows that agree on columns ``[0, t)`` (tokens and
attention mask) have the same KV for those columns at every layer, because
column ``j``'s KV depends only on columns ``<= j``. A lookup walks the
chain from the tenant's root and returns the longest committed run of full
blocks; the engine points the new row's block table at them (one more
allocator ref each; shared blocks are full and never written) and
prefills only the unshared suffix.

Keys cover the padded row from column 0, so sharing needs identical left
padding — what repeated prompts and GRPO groups (identical full prompts)
have. Entries hold their own allocator ref, so cached blocks outlive the
rows that produced them; eviction (LRU over leaves: an interior entry is
unreachable without its parent) drops that ref, and the block frees once
no live row shares it.

Tenants: every chain is rooted at a per-tenant root uid, so two tenants
with byte-identical prompts build disjoint chains. The trainer's own
traffic is the ``None`` tenant.

Host tiering hook (``serve/tiering.py``): when ``spill`` is set, an
evicted entry is offered to it before its allocator ref drops, keyed by
the entry's content-chained digest (tenant tag and chunk bytes hashed
along the chain; stable across evict/re-insert, unlike uids).

Single-threaded, like the engine that owns it.
"""

import hashlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from trlx_tpu_torch.engine.allocator import BlockAllocator

__all__ = ["PrefixCache"]


@dataclass
class _Entry:
    key: Tuple[int, bytes]  # (parent uid, chunk bytes)
    uid: int
    block: int  # physical pool block holding this chunk's KV
    children: int = 0
    last_used: int = 0
    parent: Optional["_Entry"] = None
    tenant: Optional[str] = None
    digest: bytes = b""  # content-chained id (set when a spill hook exists)


_ROOT_UID = -1


class PrefixCache:
    def __init__(self, block_size: int, capacity_blocks: int = 0):
        self.block_size = int(block_size)
        self.capacity_blocks = int(capacity_blocks)
        self._entries: Dict[Tuple[int, bytes], _Entry] = {}
        self._next_uid = 0
        self._clock = 0
        # per-tenant radix roots: chains chain on parent uid, so distinct
        # roots make tenant trees disjoint
        self._tenant_roots: Dict[Optional[str], int] = {None: _ROOT_UID}
        self._next_root = _ROOT_UID - 1
        # host-tiering spill hook: called with each evicted entry before
        # its allocator ref drops (never on clear: clear means the weights
        # changed and the KV bytes are void everywhere)
        self.spill: Optional[Callable[[_Entry], None]] = None

    def _root_uid(self, tenant: Optional[str]) -> int:
        uid = self._tenant_roots.get(tenant)
        if uid is None:
            uid = self._next_root
            self._next_root -= 1
            self._tenant_roots[tenant] = uid
        return uid

    @staticmethod
    def _root_digest(tenant: Optional[str]) -> bytes:
        return hashlib.sha1(repr(tenant).encode()).digest()

    def chain_digests(self, tokens: np.ndarray, mask: np.ndarray, n: int,
                      tenant: Optional[str] = None) -> List[bytes]:
        """Content-chained digests of the first ``n`` full prompt blocks:
        digest ``i`` identifies the padded prompt's columns ``[0, (i + 1) *
        block_size)`` under this tenant. The host tier is keyed by these."""
        out: List[bytes] = []
        d = self._root_digest(tenant)
        for i in range(min(n, self._full_blocks(tokens.shape[0]))):
            d = hashlib.sha1(d + self._chunk_key(tokens, mask, i)).digest()
            out.append(d)
        return out

    def __len__(self) -> int:
        return len(self._entries)

    def _chunk_key(self, tokens: np.ndarray, mask: np.ndarray, i: int) -> bytes:
        a, b = i * self.block_size, (i + 1) * self.block_size
        return (np.ascontiguousarray(tokens[a:b], np.int32).tobytes()
                + np.ascontiguousarray(mask[a:b] > 0, np.int8).tobytes())

    def _full_blocks(self, prompt_len: int) -> int:
        """Blocks entirely inside the prompt region ``[0, prompt_len)``:
        the only immutable ones (the block straddling the prompt/response
        boundary is written during decode)."""
        return prompt_len // self.block_size

    def match(self, tokens: np.ndarray, mask: np.ndarray,
              tenant: Optional[str] = None) -> List[int]:
        """Longest committed chain of full prompt blocks for this padded
        row under ``tenant``'s root; returns their physical block ids (the
        caller retains them)."""
        blocks: List[int] = []
        parent_uid = self._root_uid(tenant)
        for i in range(self._full_blocks(tokens.shape[0])):
            entry = self._entries.get((parent_uid, self._chunk_key(tokens, mask, i)))
            if entry is None:
                break
            self._clock += 1
            entry.last_used = self._clock
            blocks.append(entry.block)
            parent_uid = entry.uid
        return blocks

    def insert(self, tokens: np.ndarray, mask: np.ndarray, blocks: List[int],
               allocator: BlockAllocator, tenant: Optional[str] = None) -> int:
        """Commit a prefilled row's full prompt blocks (``blocks``: the
        row's table prefix, one id per full block) under ``tenant``'s root.
        Chunks already present are left alone (a concurrent duplicate keeps
        its private copy until harvest frees it); new entries retain their
        block so it outlives the row. Returns the entries inserted."""
        n = min(self._full_blocks(tokens.shape[0]), len(blocks))
        inserted = 0
        parent: Optional[_Entry] = None
        parent_uid = self._root_uid(tenant)
        digests = self.chain_digests(tokens, mask, n, tenant) if self.spill is not None else []
        for i in range(n):
            key = (parent_uid, self._chunk_key(tokens, mask, i))
            entry = self._entries.get(key)
            if entry is None:
                self._clock += 1
                entry = _Entry(key=key, uid=self._next_uid, block=int(blocks[i]),
                               last_used=self._clock, parent=parent, tenant=tenant,
                               digest=digests[i] if digests else b"")
                self._next_uid += 1
                allocator.retain([entry.block])
                self._entries[key] = entry
                if parent is not None:
                    parent.children += 1
                inserted += 1
            parent = entry
            parent_uid = entry.uid
        if self.capacity_blocks > 0 and len(self._entries) > self.capacity_blocks:
            self.evict(allocator, entries=len(self._entries) - self.capacity_blocks)
        return inserted

    def evict(self, allocator: BlockAllocator, blocks_needed: int = 0, entries: int = 0,
              tenant: Optional[str] = ...) -> int:
        """Drop LRU leaf entries until ``blocks_needed`` blocks came free
        (refs shared with live rows free later, at the rows' release) or
        ``entries`` entries are gone, whichever target was given; returns
        the blocks actually freed. ``tenant`` (when given, ``None``
        included) restricts the victims to that tenant's entries: the
        quota-pressure path never sheds another tenant's working set. Each
        victim is offered to ``spill`` before its ref drops (committed KV
        is immutable, so the copy is valid even while a live row still
        shares the block)."""
        freed = 0
        dropped = 0
        while self._entries:
            if blocks_needed > 0 and freed >= blocks_needed:
                break
            if entries > 0 and dropped >= entries:
                break
            if blocks_needed <= 0 and entries <= 0:
                break
            leaves = [e for e in self._entries.values()
                      if e.children == 0 and (tenant is ... or e.tenant == tenant)]
            if not leaves:
                break
            victim = min(leaves, key=lambda e: e.last_used)
            del self._entries[victim.key]
            if victim.parent is not None:
                victim.parent.children -= 1
            if self.spill is not None and victim.digest:
                self.spill(victim)
            freed += len(allocator.release([victim.block]))
            dropped += 1
        return freed

    def clear(self, allocator: BlockAllocator) -> None:
        """Release every entry's ref (the weights changed, or teardown)."""
        for entry in self._entries.values():
            allocator.release([entry.block])
        self._entries.clear()
