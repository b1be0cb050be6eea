"""One process's continuous-engine schedule, replayed on every rank of a
data-parallel mesh.

One process (and JAX) queues every prompt chunk of a continuous
collection on one engine of ``B`` slots and refills each freed slot from
the queue, the lowest free slot first and the oldest row first; the rows
one engine step finishes come out in slot order. So the order of the
store, and the groups the trainers score and finalize, cross chunk
boundaries once rows differ in length.

Over the data axes each of the ``dp`` ranks runs an engine of ``B / dp``
slots, the global slots ``[r * B / dp, (r + 1) * B / dp)`` of data rank
``r``. :class:`SlotSchedule` keeps the one-engine picture on every rank:
the queue of every row of the collection (global row ids, in submission
order), the row that holds each global slot, and, after each engine step,
the rows every rank finished (one ``all_gather_object`` over the data
axes: the freed slots). It hands the rank's engine exactly the rows one
engine would admit into the rank's slots, at the step it would admit
them, so :meth:`SlotSchedule.step` returns each step's finished rows of
every rank in one engine's harvest order. A row's tokens do not depend on
its neighbours (per-row seeds, per-row masks), so the trainers rebuild
one process's store for any number of chunks. When the data axes do not
divide ``B`` every rank runs every slot (JAX's replication of an
undivided leading dim) and nothing is exchanged. One limit: with the
prefix cache and chunked prefill, a rank's cache holds its own rows'
prefixes only, so a hit may shorten a row's prefill by other steps than
one engine's would.
"""

from collections import deque
from typing import Any, Dict, List, Tuple

import numpy as np

from trlx_tpu_torch.parallel.sharding import (
    allgather_host,
    data_parallel_rank,
    data_parallel_size,
)

__all__ = ["SlotSchedule", "local_slots"]


def local_slots(slots: int, mesh: Any) -> int:
    """The slots of this rank's engine for a one-process engine of
    ``slots``: ``slots / dp`` when the data axes divide it, else all."""
    dp = data_parallel_size(mesh)
    return slots // dp if slots % dp == 0 else slots


class SlotSchedule:
    """The global slot schedule of one collection over ``engine`` (this
    rank's, of :func:`local_slots` slots) for a one-process engine of
    ``slots`` slots. Finished rows of this rank are kept in
    :attr:`completed` (global row id → ``CompletedSequence``)."""

    def __init__(self, engine: Any, slots: int, mesh: Any):
        self.engine, self.mesh, self.B = engine, mesh, int(slots)
        width = local_slots(self.B, mesh)
        self.split = width < self.B
        lo = data_parallel_rank(mesh) * width if self.split else 0
        self.mine = range(lo, lo + width)
        self.queue: deque = deque()  # global row ids not yet admitted
        self.slots: List[Any] = [None] * self.B  # global row id per slot
        self.rows: Dict[int, Tuple[np.ndarray, np.ndarray, int]] = {}
        self.completed: Dict[int, Any] = {}
        self.submitted = 0

    def enqueue(self, input_ids: np.ndarray, attention_mask: np.ndarray,
                seeds: np.ndarray) -> None:
        """Queue every row of a prompt chunk (the whole chunk, on every
        rank) with its per-row seed."""
        for i in range(len(input_ids)):
            self.rows[self.submitted] = (input_ids[i], attention_mask[i], int(seeds[i]))
            self.queue.append(self.submitted)
            self.submitted += 1

    @property
    def busy(self) -> bool:
        """One engine's ``busy``: a queued row or an occupied slot."""
        return bool(self.queue) or any(s is not None for s in self.slots)

    def step(self) -> List[Tuple[int, bool]]:
        """One engine step of every rank: admit into the free slots (lowest
        first, oldest row first), step this rank's engine, and exchange the
        finished rows. Returns ``(row id, empty)`` of every finished row in
        one engine's harvest order (slot order), ``empty`` when the row
        generated nothing."""
        admit, where = [], {}
        for s in range(self.B):
            if self.slots[s] is None and self.queue:
                row = self.slots[s] = self.queue.popleft()
                if s in self.mine:
                    admit.append((row, self.rows.pop(row)))
                else:
                    del self.rows[row]
        if admit:
            # in ascending slot order: the engine fills its free slots the
            # same way, so each row lands in its global slot's local one
            ids, mask, seeds = zip(*(r for _, r in admit))
            self.engine.enqueue_prompts(np.stack(ids), np.stack(mask), np.asarray(seeds),
                                        metas=[row for row, _ in admit])
        done = self.engine.step() if self.engine.busy else []
        for c in done:
            self.completed[c.meta] = c
        mine = [(int(c.meta), int(np.sum(c.mask)) == 0) for c in done]
        finished = ([r for part in allgather_host(mine, self.mesh) for r in part]
                    if self.split else mine)
        for s, row in enumerate(self.slots):
            if row is not None:
                where[row] = s
        finished.sort(key=lambda r: where[r[0]])
        for row, _ in finished:
            self.slots[where[row]] = None
        return finished
