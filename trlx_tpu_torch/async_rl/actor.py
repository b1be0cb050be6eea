"""Process-mode generation actor: a standalone process that builds the same
trainer (its own device, its own prompt stream), adopts learner weights
from the weight channel, and ships experience chunks to the learner.

Port of ``trlx_tpu/async_rl/actor.py``. Launch one per actor alongside the
learner, as a fresh interpreter (never ``fork`` a process that has
initialised CUDA)::

    # learner process
    cfg = cfg.evolve(async_rl=dict(enabled=True, mode="process",
                                   root_dir="/shared/async"))
    trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, config=cfg)

    # actor process(es), same config + callbacks
    from trlx_tpu_torch.async_rl.actor import run_actor
    run_actor(cfg, reward_fn=reward_fn, prompts=prompts)

The actor runs on the card unless ``device`` says otherwise, and loads the
kernel libraries the learner's process already built (a concurrent build
writes through a per-process temporary file, so either order is safe).

Determinism and crash recovery: the chunk stream (prompt batches and
per-row sampling seeds) is derived from ``train.seed`` exactly as the
learner's serial path would derive it, so chunk ``i`` is reproducible by
any actor incarnation. A respawned actor fast-forwards past chunks already
committed to the spool (or consumed past the learner's cursor) and
regenerates the one that died — requeue-on-actor-death without any
coordination beyond the spool directory. The ``actor_crash@collection:N``
fault kills the process deterministically (once — a marker file stops a
respawned actor from re-firing it); the supervisor relaunching the actor
is deployment-specific.

Every chunk carries the kernel launches its production made in this
process (``actor_launches``); the learner sums them per collection as
``async/actor_launches/<kernel>``, which shows that the engine's kernels
ran on the actor's side.

The actor exits cleanly when the learner marks the spool DONE (or, on the
collective transport, when the coordinator shuts the fleet down).
"""

import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from trlx_tpu_torch.async_rl.channel import FileWeightChannel
from trlx_tpu_torch.async_rl.queue import ExperienceChunk, FileExperienceQueue, QueueClosed
from trlx_tpu_torch.async_rl.runtime import ChunkSpec
from trlx_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = ["chunks_per_collection", "kernel_launch_counts", "run_actor"]


def chunks_per_collection(config: Any) -> int:
    """Chunks one collection consumes (deterministic collection tagging for
    ``actor_crash@collection:N``): ``ceil(num_rollouts / chunk_size)``."""
    rollouts = int(config.method.num_rollouts)
    chunk = max(1, int(config.method.chunk_size))
    return max(1, -(-rollouts // chunk))


def kernel_launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counter in this process, by kernel."""
    import importlib

    from trlx_tpu_torch.ops.kernel_utils import KERNELS

    counts = {}
    for name, (module, wrapper, _plain) in KERNELS.items():
        counts[name] = int(getattr(importlib.import_module(module), wrapper).launches)
    from trlx_tpu_torch.ops.paged_attention import paged_verify_attention

    counts["paged_verify"] = int(paged_verify_attention.launches)
    return counts


def _produce(trainer: Any, spec: ChunkSpec, params: Any, version: int,
             channel: Any) -> Dict[str, Any]:
    """One chunk's payload, with the launches its production made."""
    before = kernel_launch_counts()
    payload = trainer._async_produce_chunk(spec, params, version, channel)
    after = kernel_launch_counts()
    payload["actor_launches"] = {k: after[k] - before[k] for k in after}
    return payload


def _maybe_crash(plan: Any, root_dir: str, spec: ChunkSpec) -> None:
    """The deterministic ``actor_crash@collection:N`` fault, process
    flavor: a marker file under the shared root stops a respawned (or
    surviving) actor from re-firing the same collection's crash."""
    if not plan:
        return
    marker = os.path.join(root_dir, f"actor_crash_fired_{spec.collection}")
    if os.path.exists(marker) or not plan.poll(
        "actor_crash", collection=spec.collection
    ):
        return
    with open(marker, "w") as f:
        f.write("fired\n")
    from trlx_tpu_torch.resilience.faults import InjectedFault

    logger.warning(
        f"fault plan: actor crashing in collection {spec.collection} "
        f"(chunk {spec.index})"
    )
    raise InjectedFault(
        f"actor_crash@collection:{spec.collection} (chunk {spec.index})"
    )


def _draw_spec(trainer: Any, index: int, per_collection: int) -> ChunkSpec:
    """The next prompt batch and its per-row seeds from the trainer's own
    streams, as chunk ``index``."""
    batch = next(trainer.prompt_iterator)
    ids = np.asarray(batch["input_ids"], np.int64)
    return ChunkSpec(
        index=index,
        collection=index // per_collection + 1,
        prompt_ids=ids,
        prompt_mask=np.asarray(batch["attention_mask"], np.int64),
        seeds=trainer._async_spec_seeds(trainer._rollout_seeds, ids.shape[0]),
    )


def _run_actor_collective(
    trainer: Any,
    config: Any,
    max_chunks: Optional[int],
) -> int:
    """Collective-transport actor main loop: join the fleet (HELLO →
    WELCOME weights snapshot + tree position), lease chunk indices from the
    coordinator, and commit payloads in-fabric. The spec stream (prompt
    batches + per-row seeds) is still seed-derived and index-addressed, so
    ANY member can regenerate ANY chunk — a lease requeued from a departed
    member lands on a survivor and produces the identical chunk. Specs are
    cached from the local draw position down to the learner's broadcast
    finalize cursor (requeues below the cursor are impossible), so the
    cache stays bounded by the production window."""
    from trlx_tpu_torch.async_rl.transport import FleetActorClient, read_endpoint

    acfg = config.async_rl
    plan = trainer.resilience.plan
    per_collection = chunks_per_collection(config)
    max_staleness = max(0, int(acfg.max_staleness))
    address, authkey = read_endpoint(
        acfg.root_dir,
        timeout_s=acfg.actor_timeout_s,
        poll_interval_s=acfg.poll_interval_s,
    )
    client = FleetActorClient(
        address,
        authkey,
        template=trainer.model,
        bind_host=acfg.bind_host,
    )
    produced = 0
    local_pos = 0
    cache: Dict[int, ChunkSpec] = {}
    try:
        while max_chunks is None or produced < max_chunks:
            index = client.request_work()
            if index is None:
                break  # drained: the coordinator is shutting the fleet down
            # advance the deterministic spec stream to the assigned index —
            # every index's draws are burned exactly once, in order, so the
            # stream position matches the serial path's regardless of which
            # indices this member ends up producing
            while local_pos <= index:
                cache[local_pos] = _draw_spec(trainer, local_pos, per_collection)
                local_pos += 1
            spec = cache[index]
            cursor = client.cursor_view()
            for stale in [k for k in sorted(cache) if k < cursor and k != index]:
                del cache[stale]
            if not client.wait_ready(max_staleness, spec.collection, index=spec.index):
                break
            params, version = client.fetch()
            _maybe_crash(plan, acfg.root_dir, spec)
            payload = _produce(trainer, spec, params, version, client)
            try:
                client.put(ExperienceChunk(spec.index, version, payload))
            except QueueClosed:
                break
            trainer.obs.metrics.inc("async/chunks")
            produced += 1
    finally:
        # a crash (e.g. the injected actor_crash fault) must read as a
        # member DEATH at the coordinator (fleet shrink + lease requeue),
        # not a polite leave
        client.close(graceful=sys.exc_info()[0] is None)
    return produced


def run_actor(
    config: Any,
    reward_fn: Optional[Callable] = None,
    prompts: Optional[List[str]] = None,
    stop_sequences: Optional[List[str]] = None,
    max_chunks: Optional[int] = None,
    device: Any = None,
) -> int:
    """Run one generation actor until the learner marks the spool DONE (or
    ``max_chunks`` commits). Returns the number of chunks produced. Runs
    on the card unless ``device`` names another device."""
    import importlib

    for module in ("trlx_tpu_torch.pipeline.offline_pipeline", "trlx_tpu_torch.trainer.ppo",
                   "trlx_tpu_torch.trainer.grpo"):
        importlib.import_module(module)
    from trlx_tpu_torch.pipeline import get_pipeline
    from trlx_tpu_torch.trainer import get_trainer
    from trlx_tpu_torch.utils import set_seed

    acfg = config.async_rl
    if not acfg.root_dir:
        raise ValueError("async_rl.root_dir is required in process mode")
    set_seed(config.train.seed)
    trainer = get_trainer(config.train.trainer)(
        config=config,
        reward_fn=reward_fn,
        metric_fn=None,
        stop_sequences=stop_sequences or [],
        device=device,
        **config.train.trainer_kwargs,
    )
    batch_size = config.train.batch_size
    max_prompt_length = (
        config.train.seq_length - config.method.gen_kwargs["max_new_tokens"]
    )
    prompts = prompts or [trainer.tokenizer.bos_token] * batch_size
    trainer.add_prompt_pipeline(
        get_pipeline(config.train.pipeline)(prompts, max_prompt_length, trainer.tokenizer)
    )
    try:
        if acfg.transport == "collective":
            return _run_actor_collective(trainer, config, max_chunks)
        return _run_actor_file(trainer, config, max_chunks)
    finally:
        trainer._close_prompt_iterator()


def _run_actor_file(trainer: Any, config: Any, max_chunks: Optional[int]) -> int:
    """File-transport actor main loop: fast-forward past committed chunks,
    gate on the manifest, adopt the newest weights file, spool the chunk."""
    acfg = config.async_rl
    queue = FileExperienceQueue(
        os.path.join(acfg.root_dir, "spool"),
        capacity=trainer._async_queue_capacity(),
        poll_interval_s=acfg.poll_interval_s,
    )
    channel = FileWeightChannel(
        os.path.join(acfg.root_dir, "weights"),
        poll_interval_s=acfg.poll_interval_s,
        fetch_timeout_s=acfg.fetch_timeout_s,
    )
    plan = trainer.resilience.plan
    per_collection = chunks_per_collection(config)
    max_staleness = max(0, int(acfg.max_staleness))

    produced = 0
    index = 0
    while not queue.done and (max_chunks is None or produced < max_chunks):
        # the draw stream advances for EVERY index — committed chunks are
        # skipped but their prompt/seed draws are burned, so a respawned
        # actor's stream position matches the original's
        spec = _draw_spec(trainer, index, per_collection)
        committed = queue.committed_indices()
        cursor = queue.cursor()
        if index < cursor or index in committed:
            index += 1
            continue
        # staleness gate: wait until starting this collection's chunk under
        # the newest payload satisfies the bound, and never run more than
        # one collection ahead of the learner's announcements (bail out if
        # the learner finishes first)
        while not channel.ready(max_staleness, spec.collection, index=spec.index):
            if queue.done:
                return produced
            time.sleep(channel.poll)
        params, version = channel.fetch(template=trainer.model)
        _maybe_crash(plan, acfg.root_dir, spec)
        payload = _produce(trainer, spec, params, version, channel)
        try:
            queue.put(ExperienceChunk(spec.index, version, payload))
        except QueueClosed:
            break
        trainer.obs.metrics.inc("async/chunks")
        produced += 1
        index += 1
    return produced
