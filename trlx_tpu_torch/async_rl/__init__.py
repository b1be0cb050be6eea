"""Disaggregated async RL: actor/learner split with a staleness-bounded
experience queue and in-flight weight sync.

Port of ``trlx_tpu/async_rl/``. The single-program loop alternates
``make_experience`` and ``learn`` — the card is either generating or
training, never both. This subsystem splits training into one **learner**
and N **generation actors**:

- **thread mode** (``async_rl.mode: thread``): actors are in-process
  threads over the trainer's engine paths; the learner is the main
  thread's train loop. Actor threads launch on the learner's stream (the
  card runs one program at a time, as a TPU does); the split overlaps the
  actors' host work (string decode, ``reward_fn``, device → host landings)
  *and* whole collections with optimization — collection k+1 is generated
  while the learner optimizes on collection k, within the staleness bound.
- **process mode** (``async_rl.mode: process``): actors are separate
  processes (``actor.run_actor``, each with its own device and prompt
  stream). The transport between them is selectable
  (``async_rl.transport``): the file transport (an atomic ``.npz`` of the
  state dict + a chunk spool), or the **collective fleet fabric**
  (``transport.py``) — a weights-dissemination tree shipping versioned
  deltas with unchanged-leaf skipping over a configurable-fanout relay,
  in-fabric chunk commits, and elastic join/leave membership.

The two halves meet at two seams:

- :class:`~trlx_tpu_torch.async_rl.queue.ExperienceQueue` — a bounded
  buffer of version-tagged experience chunks. Capacity back-pressures
  actors (``block``) or evicts the oldest chunk (``drop_oldest``).
- :class:`~trlx_tpu_torch.async_rl.channel.WeightChannel` — the learner
  publishes a snapshot of its weights after each optimizer update (version
  = completed update count) and announces the version at which the next
  collection will be consumed; actors adopt the newest payload at chunk
  *and* segment boundaries (in-flight updates, riding
  ``ContinuousEngine.swap_params``'s version check so unchanged weights
  never re-walk the model and changed weights flush the prefix cache —
  stale shared KV is never reused).

**Staleness bound.** A chunk's staleness is the number of learner updates
between the weights that *started* it and the learner's version when it is
consumed. The learner announces ``target`` = the version at which the next
collection drains; an actor may only start a chunk once the newest
published payload satisfies ``target − version ≤ max_staleness``. With
``max_staleness: 0`` the gate degenerates to the alternating loop — the
store is bit-identical to the serial path under a fixed seed
(``tests/test_torch_async_rl.py``). Off-policy lag is corrected in the
loss by the clipped per-token behavior-logprob ratio
(``method.iw_correction``), off by default; the fused loss kernels take it
as their importance-weight operand.

Crash containment leans on the resilience subsystem: a dead actor's
in-flight chunk spec (prompts + seeds) is requeued and a replacement actor
respawned (thread mode), or the respawned actor process fast-forwards to
the first uncommitted chunk (process mode) — deterministic either way,
exercised by the ``actor_crash@collection:N`` fault.
"""

from trlx_tpu_torch.async_rl.channel import FileWeightChannel, WeightChannel
from trlx_tpu_torch.async_rl.queue import (
    ExperienceChunk,
    ExperienceQueue,
    FileExperienceQueue,
    QueueClosed,
)
from trlx_tpu_torch.async_rl.runtime import AsyncCollector, ChunkSpec
from trlx_tpu_torch.async_rl.transport import (
    CollectiveExperienceQueue,
    CollectiveWeightChannel,
    FleetActorClient,
    FleetCoordinator,
)

__all__ = [
    "AsyncCollector",
    "ChunkSpec",
    "CollectiveExperienceQueue",
    "CollectiveWeightChannel",
    "ExperienceChunk",
    "ExperienceQueue",
    "FileExperienceQueue",
    "FileWeightChannel",
    "FleetActorClient",
    "FleetCoordinator",
    "QueueClosed",
    "WeightChannel",
]
