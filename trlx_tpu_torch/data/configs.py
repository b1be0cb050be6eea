"""Typed config tree of the port.

Port of ``trlx_tpu/data/configs.py``: every section's dataclass with every
field, so that :meth:`TRLConfig.from_dict` takes the same dict or YAML in
both packages, with the same strict dot-path :meth:`TRLConfig.update` and
nested :meth:`TRLConfig.evolve`. Sections and fields describe the JAX
package's knobs too (its mesh, resilience, async and serving sections);
the port's trainer rejects, by name, the settings it does not run
(``trainer/base.py``).
"""

import json
from copy import deepcopy
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

import yaml

from trlx_tpu_torch.data.method_configs import MethodConfig, get_method, strict_from_dict

_strict_from_dict = strict_from_dict


def _merge_dicts(base: Dict, update: Dict) -> Dict:
    """Recursively merge ``update`` into a deep copy of ``base``."""
    base = deepcopy(base)
    for k, v in update.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            base[k] = _merge_dicts(base[k], v)
        else:
            base[k] = v
    return base


def _merge_strict(base: Dict, update: Dict, path: str = "") -> Dict:
    """Merge ``update`` into ``base`` in place, raising on any leaf path in
    ``update`` that does not already exist in ``base`` (typo protection —
    stricter than the reference, which only checks top-level section names).
    Exception: keys inside free-form ``kwargs``/``gen_kwargs`` dicts are
    accepted as-is."""
    free_form = path.endswith("kwargs") or path.endswith("gen_experience_kwargs")
    for k, v in update.items():
        here = f"{path}.{k}" if path else k
        if k not in base:
            if free_form:
                base[k] = v
                continue
            raise ValueError(
                f"parameter {here} is not present in the config (typo or wrong config)"
            )
        if isinstance(v, dict) and isinstance(base[k], dict):
            _merge_strict(base[k], v, here)
        else:
            base[k] = v
    return base


@dataclass
class ModelConfig:
    """Which model to train and how much of it to unfreeze.

    :param model_path: HF-style path/name, local directory, or a builtin spec
        string like ``"builtin:gpt2-small"`` (random-init, offline-friendly).
    :param model_arch_type: ``"causal"`` or ``"seq2seq"``.
    :param num_layers_unfrozen: trainable top-layer count; -1 = all layers.
        When >0, the frozen reference for PPO's KL is a *hydra branch*: the
        trunk is shared and only the top-k layers are duplicated (frozen), as
        in the reference's hydra heads (``trlx/models/modeling_ppo.py:331-427``).
    :param peft_kwargs: optional LoRA config, e.g. ``{"peft_type": "lora",
        "r": 8, "alpha": 16, "target_modules": ["attn_qkv", "attn_out"]}``
        (reference: OpenDelta kwargs, ``trlx/utils/modeling.py:389-450``).
    """

    model_path: str
    model_arch_type: str = "causal"
    num_layers_unfrozen: int = -1
    peft_kwargs: Optional[Dict[str, Any]] = None
    # Extra kwargs forwarded to the model builder (vocab override etc.)
    model_extra_kwargs: Dict[str, Any] = field(default_factory=dict)
    # Speculative decoding for rollout generation: a small same-vocab draft
    # model proposes ``draft_gamma`` tokens per round and the policy verifies
    # them in one forward (lossless — the sampled distribution is the
    # policy's; ``trlx_tpu/ops/speculative.py``). None disables.
    draft_model_path: Optional[str] = None
    draft_gamma: int = 4
    draft_model_extra_kwargs: Dict[str, Any] = field(default_factory=dict)

    from_dict = classmethod(_strict_from_dict)


@dataclass
class TokenizerConfig:
    """Tokenizer path and padding/truncation behavior.

    ``tokenizer_path`` may be an HF path or ``"builtin:bytes"`` for the
    offline byte-level tokenizer.
    """

    tokenizer_path: str
    padding_side: str = "left"
    truncation_side: str = "right"

    from_dict = classmethod(_strict_from_dict)


@dataclass
class OptimizerConfig:
    """Optax optimizer by name (``adamw``, ``adam``, ``sgd``, ``lion``,
    ``adafactor``) plus kwargs (lr, betas/b1/b2, eps, weight_decay)."""

    name: str
    kwargs: Dict[str, Any] = field(default_factory=dict)

    from_dict = classmethod(_strict_from_dict)


@dataclass
class SchedulerConfig:
    """LR schedule by name (``cosine_annealing``, ``linear``, ``constant``,
    ``warmup_cosine``) plus kwargs (warmup_steps, T_max, eta_min, ...)."""

    name: str
    kwargs: Dict[str, Any] = field(default_factory=dict)

    from_dict = classmethod(_strict_from_dict)


@dataclass
class ParallelConfig:
    """TPU mesh + numerics. The compiled-program analogue of the reference's
    Accelerate/DeepSpeed + NeMo parallelism YAMLs (``configs/accelerate/``,
    ``configs/nemo_configs/``).

    Mesh axes (product must equal the device count; -1 = infer one axis):

    :param data: pure data-parallel replicas (DDP analogue).
    :param fsdp: parameter/optimizer sharding axis (ZeRO-3/FSDP analogue —
        falls out of GSPMD sharding, no runtime machinery needed).
    :param pipe: pipeline-parallel stages (the reference's Apex/Megatron
        pipeline engine, ``trlx/models/modeling_nemo_ilql.py:426-442``,
        PP=4 for 65B ``configs/nemo_configs/megatron_65b.yaml:50``). Requires
        ``scan_layers``: the stacked block params shard their layer dim over
        this axis and a GPipe microbatch schedule rotates activations
        through the stages (``trlx_tpu/parallel/pipeline.py``).
    :param model: tensor-parallel axis (Megatron TP analogue).
    :param sequence: context/sequence-parallel axis for ring attention over
        long sequences (beyond the reference, which has only Megatron SP).
    :param expert: expert-parallel axis for mixture-of-experts models
        (mixtral family): expert weights shard here and token dispatch rides
        all_to_alls over this axis (beyond the reference, which has no MoE).
    :param pipe_microbatches: microbatches per pipeline round (GPipe schedule
        fill; the reference's NeMo micro-vs-global batch split,
        ``megatron_20b.yaml:51-52``). 0 = auto (one per stage, capped at the
        batch size).

    :param param_dtype: storage dtype of parameters.
    :param compute_dtype: activation/matmul dtype (bf16 keeps the MXU busy).
    :param remat: activation checkpointing policy: ``"none"``, ``"minimal"``
        (checkpoint dots with no batch dims saveable), or ``"full"``
        (checkpoint every block).
    :param scan_layers: roll transformer blocks into one ``lax.scan`` (faster
        compiles at scale, required for very deep models).
    :param dcn_data_parallelism: data-parallel replication factor across
        slices/hosts (DCN); intra-slice axes above ride ICI.
    """

    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    model: int = 1
    sequence: int = 1
    expert: int = 1
    pipe_microbatches: int = 0

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "none"
    scan_layers: bool = False
    dcn_data_parallelism: int = 1

    from_dict = classmethod(_strict_from_dict)


@dataclass
class ResilienceConfig:
    """Fault-tolerance knobs (``trlx_tpu/resilience/``, docs/RESILIENCE.md).

    Preemption, non-finite updates, and flaky host calls are routine at
    fleet scale; this section decides how the run survives each.

    :param handle_preemption: install SIGTERM/SIGINT handlers for the
        duration of ``learn()``: the signal requests an emergency checkpoint
        at the next step boundary, the run commits it and exits cleanly, and
        a relaunch with ``train.resume_from_checkpoint`` continues
        bit-identically to an uninterrupted run.
    :param preemption_signals: which signals request preemption.
    :param update_guard: non-finite (NaN/inf) update policy — ``"off"``
        (default: the pre-guard train step, byte-for-byte), ``"skip"``
        (on-device: keep the old params/opt-state, drop the poison batch —
        NOTE the keep-old select holds both state versions live, defeating
        donation's in-place update: ≈2× train-step temp memory), or
        ``"rollback"`` / ``"halt"`` (restore the newest committed
        checkpoint / raise — flag-only on device, no memory cost). The
        finiteness check is fused into the train step (no extra host sync).
    :param max_consecutive_nonfinite: escalate skip/rollback to halt after
        this many consecutive non-finite updates (true divergence).
    :param keep_last_n: interval-checkpoint retention ring: after each
        interval save, prune committed ``checkpoint_*`` dirs beyond the
        newest N (0 = keep everything; ``best_checkpoint`` is never pruned).
    :param reward_retries: retry a failing ``reward_fn`` call this many
        times (exponential backoff with deterministic jitter) before the
        ``reward_fallback`` policy applies.
    :param reward_backoff_s: base backoff; attempt k waits
        ``min(max, base * 2**k) * U[0.5, 1)``.
    :param reward_backoff_max_s: backoff cap.
    :param reward_timeout_s: per-attempt timeout (worker thread); a hung
        endpoint counts as a failed attempt. None = no timeout.
    :param reward_fallback: ``"raise"`` (re-raise after retries — the old
        behavior) or ``"neutral"`` (zero rewards for the batch; the run
        continues and ``resilience/reward_fallbacks`` counts it).
    :param reward_max_consecutive_fallbacks: escalate ``"neutral"`` back to
        raising after this many consecutive fallbacks — a reward_fn that
        fails EVERY call is a deterministic bug, not a transient outage,
        and must not silently train on zero rewards to ``total_steps``.
        0 disables the cap.
    :param elastic: reshard-on-restore (docs/RESILIENCE.md "Elastic
        restore"): checkpoints carry a topology manifest, and a restore
        whose live mesh differs from the saved one (an n=4 checkpoint on an
        n=2 slice, or a changed process count) loads leaves host-side and
        re-places them under the live mesh's shardings — values
        byte-preserved, post-resume trajectory bit-identical to an
        uninterrupted run on the destination topology. False = strict:
        a topology mismatch fails with a clear diagnostic instead.
    :param coordinate_preemption: multihost jobs only — allgather the
        preemption flag at every step boundary so a SIGTERM on ONE host
        makes ALL processes commit the same emergency-checkpoint step
        (process 0 writes the marker). Without it, one host exits while the
        peers keep stepping and no consistent restorable state exists.
        Cost: one scalar allgather per update when ``process_count > 1``;
        no-op single-process.
    :param publish_retries: tracker/hub publish retries; after exhaustion
        the record is *dropped* (logging never kills training).
    :param publish_backoff_s: base backoff for publish retries.
    :param fault_plan: deterministic fault-injection plan string
        (``"sigterm@step:5; reward_raise@call:3*2"`` — syntax in
        docs/RESILIENCE.md). ``TRLX_TPU_FAULT_PLAN`` overrides. None = no
        injected faults.
    """

    handle_preemption: bool = True
    preemption_signals: List[str] = field(
        default_factory=lambda: ["SIGTERM", "SIGINT"]
    )
    update_guard: str = "off"
    max_consecutive_nonfinite: int = 25
    keep_last_n: int = 0
    elastic: bool = True
    coordinate_preemption: bool = True
    reward_retries: int = 3
    reward_backoff_s: float = 0.5
    reward_backoff_max_s: float = 30.0
    reward_timeout_s: Optional[float] = None
    reward_fallback: str = "raise"
    reward_max_consecutive_fallbacks: int = 20
    publish_retries: int = 2
    publish_backoff_s: float = 0.2
    fault_plan: Optional[str] = None

    from_dict = classmethod(_strict_from_dict)


@dataclass
class EngineConfig:
    """Generation-engine knobs (``trlx_tpu/engine/``, docs/PERFORMANCE.md).

    Selects the KV backend behind the unified Engine interface the
    trainers' rollout collection runs on (``train.continuous_batching``
    routes through it; the serial path is always the dense reference).

    :param backend: ``"dense"`` (default: the per-slot ``[B, S]`` KV cache,
        byte-for-byte the PR-3 engine) or ``"paged"`` (block-pool KV with
        per-slot block tables — persistent KV HBM tracks *live tokens*
        instead of ``slots × max_length``; bit-identical outputs, pinned by
        ``tests/test_engine.py``).
    :param kv_block_size: cache columns per KV block. Smaller blocks track
        live tokens tighter and share shorter prefixes, at more table/
        gather overhead; larger blocks amortize bookkeeping. Power of two
        recommended; must be ≤ the padded prompt width for prefix hits to
        exist.
    :param max_kv_blocks: pool size in blocks (including the reserved
        zero block). 0 = auto: enough for every slot at full length, plus
        an equal prefix-cache working set when ``prefix_cache`` is on.
        Under-provisioned pools evict prefix entries first and raise a
        clear error only when live rows themselves cannot be backed.
    :param prefix_cache: share committed full prompt blocks between rows
        whose *padded* prompts agree from column 0 (GRPO group members,
        repeated eval prompts): hits prefill only the unshared suffix.
        Requires ``backend: paged``. Auto-disabled (with a warning) for
        MoE policies: expert-capacity coupling across a row's tokens
        breaks the suffix-prefill bit-equality the cache relies on.
    :param prefix_cache_blocks: entry cap for the prefix cache (0 = only
        pool pressure evicts).
    :param decode_kernel: compute path for the paged decode segments.
        ``"xla"`` (default) is the gather → dense compute → scatter
        reference; ``"pallas"`` runs the in-place Pallas paged-attention
        decode kernel + fused top-k/top-p/temperature sampling
        (``ops/paged_attention.py``) — K/V read and written through the
        block table with no transient dense view, deleting the
        per-segment gather tax (docs/PERFORMANCE.md "Pallas kernels").
        Bit-identical outputs by contract (``tests/test_paged_attention
        .py``); off-TPU the kernels run under the Pallas interpreter.
        Requires ``backend: paged``.
    :param prefill_kernel: compute path for the paged refill *prefills*.
        ``"xla"`` (default) is gather → dense prefill → scatter — the last
        dense-view copy on the generation hot path; ``"pallas"`` runs the
        in-place Pallas paged-prefill kernel (``ops/paged_prefill.py``):
        prompt K/V commits through the block table and attention reads
        pool blocks straight into VMEM — refill gather/scatter bytes drop
        to exactly 0 (``benchmarks/ENGINE_PREFILL_cpu.json``).
        Bit-identical to the gather path by contract; the parity reference
        is the dense einsum attention (models whose
        ``resolved_attention_impl()`` is pallas-flash prefill through the
        flash kernel on the gather path — same masking semantics,
        flash-vs-dense numerics; docs/PERFORMANCE.md). Requires
        ``backend: paged``.
    :param prefill_chunk: chunked-prefill scheduling (0 = off): admitted
        prompts prefill at most this many columns per engine step,
        interleaved with decode segments, so a long prompt can never
        stall live decode slots longer than one chunk's prefill — the
        measured ``rollout/decode_stall_p50/p95/max`` gauges bound it.
        Harvests stay bit-identical across chunk sizes. Requires
        ``backend: paged``.
    :param speculative: speculative continuous batching (0 = off): each
        decode segment runs draft-propose → verify ROUNDS in which the
        draft model (``model.draft_model_path``) proposes this many
        tokens per live slot and the target verifies all of them in one
        paged forward — committing 1..k+1 tokens per row per round while
        every harvested sequence stays bit-identical to a solo
        ``ops/speculative.py`` run of that row (``tests/test_spec_engine
        .py``). Requires ``backend: paged``, ``model.draft_model_path``,
        and per-row RNG (always on under continuous batching). Composes
        with the in-place kernels: under ``decode_kernel: pallas`` the
        verify forward runs the multi-position Pallas verify kernel
        (``ops/paged_attention.py::paged_verify_attention``), and under
        ``prefill_kernel: pallas`` spec refills keep the zero-copy paged
        prefill — ``engine/spec_verify_kernel_pallas`` stamps which
        verify compute ran. Acceptance lands in the ``engine/spec_*``
        gauges.
    """

    backend: str = "dense"
    kv_block_size: int = 16
    max_kv_blocks: int = 0
    prefix_cache: bool = False
    prefix_cache_blocks: int = 0
    decode_kernel: str = "xla"
    prefill_kernel: str = "xla"
    prefill_chunk: int = 0
    speculative: int = 0

    from_dict = classmethod(_strict_from_dict)


@dataclass
class AsyncRLConfig:
    """Disaggregated async RL knobs (``trlx_tpu/async_rl/``,
    docs/ASYNC_RL.md).

    Splits training into one learner and N generation actors connected by a
    staleness-bounded experience queue and an in-flight weight-sync channel
    — collection k+1 is generated while the learner optimizes on
    collection k, instead of the alternating single-program loop.

    :param enabled: route PPO/GRPO experience collection through the
        actor/learner split. False = the alternating reference loop,
        byte-for-byte unchanged.
    :param mode: ``"thread"`` (actors are in-process threads over the
        existing Engine paths — single host) or ``"process"`` (actors are
        separate processes with their own JAX runtime, connected through
        the ``root_dir`` filesystem transport — launch them with
        ``trlx_tpu.async_rl.actor.run_actor``).
    :param num_actors: actor threads (thread mode). Process-mode fleet size
        is however many ``run_actor`` processes you launch.
    :param max_staleness: how many learner updates a chunk's producing
        params may lag its consumption. 0 = fully synchronous — the actor
        gate degenerates to the alternating loop and the store is
        bit-identical to the serial reference under a fixed seed. Larger
        values buy generation/optimization overlap at bounded
        off-policyness (pair with ``method.iw_correction``).
    :param queue_capacity: experience-queue bound in chunks. 0 = auto
        (2 × the chunks one collection consumes).
    :param queue_policy: ``"block"`` back-pressures actors at capacity;
        ``"drop_oldest"`` evicts the stalest queued chunk instead (counted
        as ``async/dropped_chunks``; trades rollouts for freshness).
    :param sync_every: publish learner params every N optimizer updates
        (1 = every update; phase boundaries always force a publish).
    :param root_dir: process-mode transport root (weight files + chunk
        spool) — a directory shared between learner and actors.
    :param actor_timeout_s: process mode — how long the learner waits for
        the next chunk before declaring the actor fleet dead.
    :param poll_interval_s: process-mode file polling interval.
    :param max_actor_restarts: thread mode — dead actors are respawned
        (their in-flight chunk requeued) up to this many times before the
        underlying error propagates to the learner. With the collective
        transport, exhausting restarts while OTHER actors survive shrinks
        the fleet instead (elastic membership): the dead actor's chunks
        requeue onto survivors and the run continues.
    :param transport: ``"file"`` (the PR-9 spool/weights-file transport —
        the degraded/fallback mode; thread mode uses the equivalent
        in-memory channel) or ``"collective"`` (the fleet fabric:
        param-dissemination tree with unchanged-leaf delta skipping,
        in-fabric chunk commits, elastic join/leave —
        ``async_rl/transport.py``, docs/ASYNC_RL.md "Transports").
        Rank-uniform: on a multihost learner every rank must agree (the
        fleet gauges ride the telemetry beat; graftlint GL704 registry).
    :param fanout: dissemination-tree fanout (collective transport). The
        learner sends each param delta to at most ``fanout`` direct
        children; actors relay to theirs. Rank-uniform (see above).
    :param bind_host: host/interface the collective transport's listeners
        bind (learner root and actor relay nodes). Default loopback; set
        to the pod-routable interface for a real fleet.
    :param fetch_timeout_s: file transport — how long an actor's
        ``fetch`` retries reading a mid-replace weights file before
        declaring the writer dead. The learner's npz write grows with the
        model, so this is a deadline (default 60s), not an attempt count.
    """

    enabled: bool = False
    mode: str = "thread"
    num_actors: int = 1
    max_staleness: int = 0
    queue_capacity: int = 0
    queue_policy: str = "block"
    sync_every: int = 1
    root_dir: Optional[str] = None
    actor_timeout_s: float = 300.0
    poll_interval_s: float = 0.02
    max_actor_restarts: int = 3
    transport: str = "file"
    fanout: int = 2
    bind_host: str = "127.0.0.1"
    fetch_timeout_s: float = 60.0

    from_dict = classmethod(_strict_from_dict)


@dataclass
class ServeConfig:
    """Serving-frontend knobs (``trlx_tpu/serve/``, docs/SERVING.md).

    Puts an HTTP streaming frontend with SLO-aware admission, priority
    scheduling, multi-tenant prefix isolation, and host-RAM KV tiering in
    front of a :class:`~trlx_tpu.engine.core.ContinuousEngine` — including
    serve-while-training: PPO's ``learn()`` serves interactive requests
    between optimizer steps off the freshly published params.

    :param enabled: stand up the serving frontend inside ``learn()``.
        Requires ``engine.backend: paged`` + ``train.continuous_batching``
        (streaming snapshots and segment-boundary preemption are
        block-table operations).
    :param host: HTTP bind interface; default loopback.
    :param port: HTTP port (0 = ephemeral; read it back from
        ``ServeServer.port``).
    :param slots: serving-engine slot batch (its compiled width is
        independent of the collection engines').
    :param max_new_tokens: serving-engine decode budget per request.
    :param default_tenant: prefix-cache namespace + quota identity for
        requests that don't name one.
    :param default_class: priority class for requests that don't name one
        (``interactive`` | ``eval`` | ``actor``; engine ``SERVE_CLASSES``).
    :param slo_interactive_s / slo_eval_s / slo_actor_s: per-class
        queue-wait SLOs in seconds (0 = no admission gate for that class).
        Admission rejects with 429 + Retry-After only when the EWMA
        service-time model *proves* the SLO blown for a new arrival.
    :param max_queue: hard admitted-but-unfinished depth cap (memory
        bound; rejections past it are 429s regardless of SLO evidence).
    :param reserve_slots: engine slots only interactive traffic may take
        when the batch classes have the rest saturated.
    :param stream_buffer: per-request undelivered-delta bound — a consumer
        stalled past it is dropped (the engine slot keeps decoding;
        ``slow_client@request:N``, docs/RESILIENCE.md).
    :param drain_timeout_s: graceful-drain window on shutdown/SIGTERM —
        new admissions 503 immediately, in-flight requests get this long
        to finish before being failed.
    :param host_tier_blocks: host-RAM KV tier capacity in blocks (0 =
        tiering off): evicted prefix-cache blocks spill host-side and
        re-land device-side instead of re-prefilling (bit-identical by
        construction; ``serve/tiering.py``).
    :param tenant_quota_blocks: per-tenant KV block budgets
        (``{"team-a": 64}``); an allocation past the quota evicts only
        that tenant's prefix entries, then fails only that request.
    :param retain_param_versions: keep the newest N published param trees
        for ``ServeServer.params_for_version`` — the serve-while-training
        bit-equality probe's reference (0 = keep none).
    """

    enabled: bool = False
    host: str = "127.0.0.1"
    port: int = 0
    slots: int = 2
    max_new_tokens: int = 16
    default_tenant: str = "default"
    default_class: str = "interactive"
    slo_interactive_s: float = 0.0
    slo_eval_s: float = 0.0
    slo_actor_s: float = 0.0
    max_queue: int = 64
    reserve_slots: int = 0
    stream_buffer: int = 64
    drain_timeout_s: float = 5.0
    host_tier_blocks: int = 0
    tenant_quota_blocks: Dict[str, int] = field(default_factory=dict)
    retain_param_versions: int = 0

    from_dict = classmethod(_strict_from_dict)


@dataclass
class TrainConfig:
    """Run-level knobs for the shared learn loop
    (reference: ``trlx/data/configs.py:142-230``)."""

    total_steps: int
    seq_length: int
    epochs: int
    batch_size: int

    checkpoint_interval: int
    eval_interval: int

    pipeline: str  # a registered pipeline name
    trainer: str  # a registered trainer name
    trainer_kwargs: Dict[str, Any] = field(default_factory=dict)

    project_name: str = "trlx_tpu"
    entity_name: Optional[str] = None
    group_name: Optional[str] = None

    checkpoint_dir: str = "ckpts"
    rollout_logging_dir: Optional[str] = None
    save_best: bool = True

    tracker: Optional[str] = None
    logging_dir: Optional[str] = None
    tags: List[str] = field(default_factory=list)

    seed: int = 1000

    # Number of eval prompts generated/scored per evaluate() call; None = all.
    eval_batch_size: Optional[int] = None

    # Gradient accumulation: microbatches per optimizer step. batch_size must
    # be divisible; grads are averaged over the ``lax.scan`` of microbatch
    # passes inside the one jitted step, so global batch is no longer capped
    # by per-device memory (reference gets this from DeepSpeed / NeMo's
    # micro-vs-global batch, ``megatron_20b.yaml:51-52``).
    grad_accum: int = 1

    # When set, a jax.profiler trace of optimization steps 2-5 (XLA ops,
    # device timelines; viewable in XProf/TensorBoard) is written here — the
    # TPU-native counterpart of the reference's Nsight hooks
    # (``megatron_20b.yaml:127-132``; SURVEY.md §5 tracing).
    profile_dir: Optional[str] = None

    # Crash/preemption recovery: when True, learn() restores the newest
    # interval checkpoint under checkpoint_dir (full TrainState + iteration
    # counter) before training — relaunch the same command and the run
    # continues (reference analogues: Ray session restore,
    # ``accelerate_base_trainer.py:452-460``; NeMo ``resume_if_exists``).
    resume_from_checkpoint: bool = False

    # Background-thread batch prefetch depth for the training loader (the
    # reference's torch DataLoader num_workers/prefetch_factor capability):
    # up to this many collated batches are prepared ahead while the device
    # runs the current step. 0 disables.
    prefetch_batches: int = 2

    # Software-pipelined experience collection: up to this many rollout
    # chunks' host work (string decode, reward_fn, device→host fetches) may
    # be in flight on a background worker while the device generates the
    # next chunk. Within one make_experience call the params never change,
    # so the overlap is exactly equivalent to the serial schedule — the
    # store is bit-identical under a fixed seed (docs/PERFORMANCE.md).
    # 0 = the serial reference path.
    rollout_pipeline_depth: int = 2

    # Continuous-batching rollout generation (docs/PERFORMANCE.md): decode
    # runs as fixed-size segments over per-slot state; finished sequences
    # are harvested at segment boundaries (shipped individually into the
    # rollout pipeline's host stage) and their freed KV-cache slots refill
    # from the prompt queue — the device batch stays full instead of every
    # chunk draining at the pace of its longest row. Wins grow with
    # response-length *variance*. Rollout sampling switches to per-row RNG
    # streams (required for slot invariance), so sampled tokens differ from
    # the serial path's batch-wide stream; per-sequence they are
    # bit-identical to plain generate under per-row RNG
    # (tests/test_continuous_batching.py). Causal-LM PPO/GRPO only
    # (seq2seq and speculative decoding keep the serial path).
    # False = the serial chunked reference path, byte-for-byte unchanged.
    continuous_batching: bool = False

    # Decode steps per compiled segment between harvest/refill points.
    # Smaller segments harvest/refill sooner (higher slot utilization,
    # lower completion latency) at the cost of more host round-trips and
    # refill prefills per collection.
    continuous_batching_segment: int = 8

    from_dict = classmethod(_strict_from_dict)


@dataclass
class TRLConfig:
    """Top-level config: method/model/optimizer/scheduler/tokenizer/train
    (+ TPU ``parallel``)."""

    method: MethodConfig
    model: ModelConfig
    optimizer: OptimizerConfig
    scheduler: SchedulerConfig
    tokenizer: TokenizerConfig
    train: TrainConfig
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    async_rl: AsyncRLConfig = field(default_factory=AsyncRLConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)

    @classmethod
    def load_yaml(cls, yml_fp: str) -> "TRLConfig":
        with open(yml_fp, mode="r") as f:
            return cls.from_dict(yaml.safe_load(f))

    def to_dict(self) -> Dict[str, Any]:
        def listify(x):
            if isinstance(x, tuple):
                return [listify(v) for v in x]
            if isinstance(x, list):
                return [listify(v) for v in x]
            if isinstance(x, dict):
                return {k: listify(v) for k, v in x.items()}
            return x

        return listify({
            "method": asdict(self.method),
            "model": asdict(self.model),
            "optimizer": asdict(self.optimizer),
            "scheduler": asdict(self.scheduler),
            "tokenizer": asdict(self.tokenizer),
            "train": asdict(self.train),
            "parallel": asdict(self.parallel),
            "resilience": asdict(self.resilience),
            "engine": asdict(self.engine),
            "async_rl": asdict(self.async_rl),
            "serve": asdict(self.serve),
        })

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "TRLConfig":
        return cls(
            method=get_method(config["method"]["name"]).from_dict(config["method"]),
            model=ModelConfig.from_dict(config["model"]),
            tokenizer=TokenizerConfig.from_dict(config["tokenizer"]),
            optimizer=OptimizerConfig.from_dict(config["optimizer"]),
            scheduler=SchedulerConfig.from_dict(config["scheduler"]),
            train=TrainConfig.from_dict(config["train"]),
            parallel=ParallelConfig.from_dict(config.get("parallel", {})),
            resilience=ResilienceConfig.from_dict(config.get("resilience", {})),
            engine=EngineConfig.from_dict(config.get("engine", {})),
            async_rl=AsyncRLConfig.from_dict(config.get("async_rl", {})),
            serve=ServeConfig.from_dict(config.get("serve", {})),
        )

    def evolve(self, **kwargs) -> "TRLConfig":
        """Return a new config with nested overrides applied.

        >>> config = config.evolve(method=dict(gamma=0.99))
        """
        return TRLConfig.from_dict(_merge_dicts(self.to_dict(), kwargs))

    @classmethod
    def update(cls, baseconfig, config: Dict[str, Any]) -> "TRLConfig":
        """Apply dot-path overrides (``{"train.seed": 1}``) to a base config,
        erroring on keys that do not exist anywhere in the base tree."""
        update: Dict[str, Any] = {}
        for name, value in config.items():
            if isinstance(value, dict):
                update[name] = value
            else:
                *layers, var = name.split(".")
                d = update
                for layer in layers:
                    d = d.setdefault(layer, {})
                d[var] = value

        if not isinstance(baseconfig, dict):
            baseconfig = baseconfig.to_dict()

        merged = _merge_strict(baseconfig, update)
        return cls.from_dict(merged)

    def __str__(self) -> str:
        return json.dumps(self.to_dict(), indent=4)
