"""Shared trainer of the port: model and optimizer set-up, the train step,
generation on the serial dense engine and on the paged engine, evaluation,
the learn loop and checkpoints.

Port of ``trlx_tpu/trainer/base.py`` (``TPUBaseTrainer``) as
:class:`TorchBaseTrainer`, for the settings this slice runs:

- construction validates the config as the JAX trainer does, and rejects
  with a ``ValueError`` naming the setting whatever the port does not run
  (:func:`reject_unported`);
- the train step is autograd plus one optimizer step. Every parameter
  takes a gradient, as JAX differentiates the whole tree, so
  ``gradients/global_norm`` covers the frozen layers too; frozen
  parameters get no update and no weight decay (they are not in the
  optimizer). ``learning_rate`` is the schedule at the step count before
  the update. With ``train.grad_accum`` k > 1 the batch splits into k
  micro-batches whose gradients and stats are averaged (JAX's scan: each
  micro-batch whitens its own advantages). ``model.peft_kwargs`` builds
  LoRA adapters (``builder.parse_peft_overrides``): the base freezes and
  the optimizer holds the adapters of the unfrozen blocks and the heads;
- ``generate``: a rollout trainer (PPO) with ``train.continuous_batching:
  false``, the presets' setting, samples on the serial dense
  :class:`~trlx_tpu_torch.engine.core.SerialEngine` around
  ``ops/sampling.py::generate``, or, with ``model.draft_model_path`` set,
  around ``ops/speculative.py::generate_speculative`` (``model.draft_gamma``
  draft tokens a round); with ``continuous_batching: true`` it runs the
  ``ContinuousEngine`` as ``engine:`` says, as JAX does: the dense
  backend (the default), or the paged one with the in-place kernels or
  the gather paths (``decode_kernel`` / ``prefill_kernel``), whose
  segments run draft-propose → verify → accept rounds with
  ``engine.speculative: k``. The offline trainers (SFT, ILQL) collect
  nothing: they evaluate on the paged engine with the in-place kernels
  whatever ``continuous_batching`` says, and with a draft model on the
  serial speculative sampler, as JAX's ``generate`` does (ILQL's
  speculative sampling). Both engines take the algorithm's
  ``adjust_logits`` hook and the transition ``logit_mask`` (under
  speculation separately: the mask shapes draft and target alike, the
  hook the target's verify distributions); the draft is a bare LM built
  from ``train.seed + 1``;
- seq2seq (``model.model_arch_type: seq2seq``, T5) runs under PPO and
  ILQL: the model is ``builder.build_seq2seq_lm`` with
  ``seq2seq_trainable_mask``; every generate (rollouts and evaluation) is
  ``ops/sampling.py::generate_seq2seq`` on the serial engine; a draft
  model is ignored with JAX's warning, and PPO refuses
  ``train.continuous_batching`` with JAX's ``NotImplementedError`` (the
  decoder has no slot-refill path); samples join prompt and output with
  the tokenizer's ``sep_token`` (a space without one);
- ``learn`` runs the JAX loop (epochs → batches → updates per batch,
  interval and final checkpoints, interval and final evaluation), the
  batches collated ``train.prefetch_batches`` ahead on a background
  thread, with JAX's run management and resilience
  (``trlx_tpu_torch/resilience/``): ``reward_fn`` and the tracker
  hardened once (retries, backoff, fallbacks), the preemption handler
  installed for the loop, the fault plan polled at each step boundary
  (``sigterm``/``sigint``) and in the train step (``nan_loss``), the update
  guard (``skip`` drops the update before the optimizer steps,
  ``rollback`` restores the newest committed checkpoint, ``halt``
  raises), the metrics registry's snapshot merged into every step's
  stats, the profiler window around the train steps, and the retention
  ring (``resilience.keep_last_n``) pruning before each interval save;
  the tracker is ``utils/trackers.py::make_tracker``'s (JSONL into
  ``<checkpoint_dir>/logs`` by default);
- run observability (``trlx_tpu_torch/observability/``, one
  :class:`~trlx_tpu_torch.observability.Observability` bundle per trainer,
  ``trainer.obs``): the fenced ``train_step`` and ``generate`` spans (a
  fence waits on a CUDA event; the train step's replaces the old
  synchronize), the engines' ``rollout/segment`` and per-request spans,
  throughput and MFU (the train step's FLOPs counted on its first call,
  ``observability/metrics.py::train_step_flops``), the memory and
  new-signature watchdogs, the loss's sketch histograms fetched in the
  stats' one device → host copy and summarized into ``dist/*`` gauges, the
  health detectors (a trip dumps the batch as ``triage/step<N>.npz`` and
  the flight record), the cluster beat at each step boundary, and the
  flight recorder dumped on any exception, NaN-halt or preemption and at
  the fault plan's ``flightrec_dump``; ``trace.json`` and ``spans.jsonl``
  are written at the end of ``learn`` and on its crash path, into
  ``TRLX_TPU_TRACE_DIR``, ``train.logging_dir`` or
  ``<checkpoint_dir>/logs``;
- serving inside a trainer (``serve.enabled``, the rollout trainers on
  the continuous path): ``learn`` stands up a serving engine of its own
  behind ``ServeServer`` and its HTTP listener, publishes a copy of the
  policy's weights before the listener starts and at every step boundary
  (stamped ``iter_count``; the serving engine never reads the live,
  updating weights), runs the ``request_flood`` drill there, and drains
  the server on the clean, crash and preemption paths;
- the rollout engines' prefix cache (``engine.prefix_cache``) is flushed
  whenever the weights change: an optimizer step updates the policy in
  place, so the engines take the trainer's weights counter as their
  version;
- async collection (``async_rl.enabled``, PPO and GRPO): actor threads
  draw engines from the same caches as the learner, so the caches are
  built under one lock (``_engine_lock``; the continuous engines are
  tagged per actor thread), ``generate_serial`` takes an actor's weights
  snapshot and seeds without touching the shared serial engine, and
  :attr:`last_generate_time` / :attr:`last_generate_stats` are per
  thread; ``learn`` stops the collectors (:meth:`_shutdown_collectors`)
  on every way out of it;
- ``save`` commits one ``torch.save`` file of model, optimizer, step and
  the trainer's host state (the rollout seed stream, torch's generators,
  the prompt-stream position) atomically (``utils/checkpoint.py``); an
  emergency checkpoint (preemption) adds the evaluation count and the
  rollout store, and a resume from it fast-forwards the loop to its step
  boundary, so the run continues bitwise; ``train.resume_from_checkpoint``
  loads the newest committed ``checkpoint_<step>``
  (:meth:`TorchBaseTrainer.maybe_resume`). Every checkpoint commits the
  topology manifest with its state, and every restore goes through
  ``resilience/elastic.py::restore_state_elastic`` (a changed topology, or
  ``topology_shrink``, takes the reshard path); the preemption flag is
  coordinated over the processes (``sigterm_one_proc`` signals process 0
  alone);
- over several processes (``parallel.data`` / ``fsdp``, with the
  ``dcn_data_parallelism`` layout; ``sequence`` for SFT only) every
  trainer shards its weights with FSDP2 and takes its rows of each batch
  (:meth:`TorchBaseTrainer.host_batch`); its loss joins the operands of
  every rank's rows (:meth:`TorchBaseTrainer.gather_rows`), so losses,
  stats and gradients are the global batch's; rank 0 alone writes
  checkpoints and exports (``push_to_hub`` included) from the gathered
  state.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

import copy
import dataclasses
import json
import logging
import os
import signal
import threading
import time
from abc import abstractmethod
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.data.tokenizer import from_config as tokenizer_from_config
from trlx_tpu_torch.engine.core import SERVE_CLASSES, ContinuousEngine, SerialEngine
from trlx_tpu_torch.models.builder import (
    assemble_overrides,
    build_causal_lm,
    build_seq2seq_lm,
    resolve_transformer_config,
    seq2seq_trainable_mask,
    trainable_mask,
)
from trlx_tpu_torch.observability import Observability, mfu as obs_mfu, train_step_flops
from trlx_tpu_torch.observability.tracing import process_count, process_index
from trlx_tpu_torch.ops.kernel_utils import resolve_device
from trlx_tpu_torch.ops.paged_kv import (
    PagedSpec,
    block_bytes,
    dense_kv_bytes,
    num_table_blocks,
)
from trlx_tpu_torch.ops.sampling import (
    GenerationConfig,
    GenerationOutput,
    apply_transition_mask,
    generate as dense_generate,
    generate_seq2seq,
)
from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns
from trlx_tpu_torch.ops.speculative import generate_speculative
from trlx_tpu_torch.parallel.mesh import (
    MESH_AXES,
    make_mesh,
    mesh_shape_from_config,
    set_global_mesh,
    world_size,
)
from trlx_tpu_torch.parallel.sharding import (
    data_parallel_size,
    gather_rows,
    global_grad_norm,
    shard_batch,
    shard_params,
    unsharded,
)
from trlx_tpu_torch.pipeline import PrefetchLoader
from trlx_tpu_torch.resilience import (
    UNPORTED_KINDS,
    UPDATE_OK_KEY,
    FaultPlan,
    NonFiniteUpdateError,
    Resilience,
    TrainingPreempted,
    build_manifest,
    coordinate_preemption,
    restore_state_elastic,
)
from trlx_tpu_torch.trainer import BaseRLTrainer
from trlx_tpu_torch.utils import (
    filter_non_scalars,
    get_optimizer,
    get_scheduler,
    significant,
)
from trlx_tpu_torch.utils.checkpoint import (
    _checkpoint_step_dirs,
    gather_full_state,
    is_committed,
    newest_committed_checkpoint,
    prune_checkpoints,
    push_to_hub,
    save_pretrained,
    save_state,
)
from trlx_tpu_torch.utils.trackers import make_tracker

logger = logging.getLogger(__name__)

# the triage dumps of a bad batch (_dump_triage): rows kept, files per run
TRIAGE_MAX_ROWS = 64
TRIAGE_MAX_DUMPS = 8

# the mesh axes the port runs (``data`` and ``fsdp`` for every trainer,
# ``sequence`` for those with ``sequence_ok`` too), and the ones that wait
# for a later slice, with their reasons
_PARALLEL_AXES = ("data", "fsdp", "sequence")
_UNPORTED_AXES = {
    "model": "tensor parallelism comes with slice 22",
    "pipe": "pipeline parallelism comes with slice 22",
    "expert": "expert parallelism comes with slice 22",
}


def validate_engine(config) -> None:
    """The JAX trainer's engine checks, each its own error: the paged-only
    knobs (prefix cache, the paged kernels, chunked prefill) need
    ``engine.backend: paged`` whichever path runs; ``engine.speculative
    >= 0``, and a speculative engine needs a draft model and the paged
    backend."""
    e = config.engine
    if e.prefix_cache and e.backend != "paged":
        raise ValueError("engine.prefix_cache: true requires engine.backend: paged — dense "
                         "per-slot KV caches cannot share blocks")
    for knob in ("decode_kernel", "prefill_kernel"):
        value = getattr(e, knob)
        if value not in ("xla", "pallas"):
            raise ValueError(f"unknown engine.{knob} {value!r} (xla | pallas)")
        if value == "pallas" and e.backend != "paged":
            raise ValueError(f"engine.{knob}: pallas is the in-place paged kernel — it "
                             "requires engine.backend: paged")
    if int(e.prefill_chunk) < 0:
        raise ValueError(f"engine.prefill_chunk {e.prefill_chunk} must be >= 0 "
                         "(0 = monolithic prefill)")
    if int(e.prefill_chunk) and e.backend != "paged":
        raise ValueError("engine.prefill_chunk (chunked-prefill scheduling) requires "
                         "engine.backend: paged")
    k = int(e.speculative)
    if k < 0:
        raise ValueError(f"engine.speculative {k} must be >= 0 (0 = off, k = draft "
                         "tokens proposed per verify round)")
    if not k:
        return
    if not config.model.draft_model_path:
        raise ValueError(
            "engine.speculative (speculative continuous batching) requires "
            "model.draft_model_path — the engine needs a draft model to propose "
            "tokens for the target to verify"
        )
    if e.backend != "paged":
        raise ValueError(
            "engine.speculative requires engine.backend: paged — the verify pass "
            "commits accepted K/V through the block table with drop-mode writes"
        )


def validate_serve(config) -> None:
    """The JAX trainer's construction checks of ``serve.*``, each its own
    ``ValueError`` naming the setting."""
    s = config.serve
    if not s.enabled:
        return
    if config.engine.backend != "paged":
        raise ValueError("serve.enabled requires engine.backend: paged — token streaming "
                         "snapshots and priority preemption are block-table operations")
    if not config.train.continuous_batching:
        raise ValueError("serve.enabled requires train.continuous_batching: true — the "
                         "serving engine is a ContinuousEngine built through the "
                         "slot-refill program cache")
    if int(s.slots) < 1:
        raise ValueError(f"serve.slots {s.slots} must be >= 1")
    if not 0 <= int(s.reserve_slots) < int(s.slots):
        raise ValueError(f"serve.reserve_slots {s.reserve_slots} must leave at least one "
                         f"unreserved slot of serve.slots {s.slots}")
    if float(s.drain_timeout_s) <= 0:
        raise ValueError(f"serve.drain_timeout_s {s.drain_timeout_s} must be > 0 (the "
                         "graceful-drain window)")
    if int(s.host_tier_blocks) and not config.engine.prefix_cache:
        raise ValueError("serve.host_tier_blocks requires engine.prefix_cache: true — only "
                         "committed prefix entries ever spill to the host tier")
    if s.default_class not in SERVE_CLASSES:
        raise ValueError(f"unknown serve.default_class {s.default_class!r} (expected one "
                         f"of {SERVE_CLASSES})")


def reject_unported(config, collects_rollouts: bool, seq2seq_ok: bool,
                    sequence_ok: bool = False) -> None:
    """Raise ``ValueError`` naming the first setting this slice does not
    run: parallel axes (``model``, ``pipe`` and ``expert`` above 1;
    ``sequence`` above 1 for a trainer without ``sequence_ok``: SFT alone
    rings its forwards; a mesh that does not fit the world, or a
    ``dcn_data_parallelism`` that does not divide its data axis;
    ``parallel.scan_layers`` runs, as per-layer modules, with ``pipe``
    1), async collection,
    serving inside a trainer and seq2seq models under a world above 1,
    seq2seq outside PPO and ILQL (``seq2seq_ok``), serving inside an
    offline trainer (JAX's reason: only the rollout trainers have an
    engine to serve from), and a fault plan (``resilience.fault_plan`` or
    ``TRLX_TPU_FAULT_PLAN``) that names a kind whose subsystem the port
    does not have (``resilience/faults.py::UNPORTED_KINDS``, empty now).
    Trackers, profiler windows, rollout logs, remat, the update guard,
    fault plans and the retention ring run.

    ``collects_rollouts`` (PPO, GRPO) adds the rollout settings: the loss
    kernel's name (and ``pallas`` only where the method's ``LOSS_KERNELS``
    hosts it). Async collection (``async_rl``) runs in one process, its
    own settings checked where the collector is built. Every ``engine:``
    setting runs (:func:`validate_engine` keeps JAX's checks). The offline
    trainers (SFT, ILQL, DPO) collect nothing: they evaluate on the paged
    engine, so the engine settings do not reach them."""
    m, par = config.model, config.parallel
    checks = []
    if collects_rollouts:
        loss_kernel = getattr(config.method, "loss_kernel", None)
        hostable = getattr(type(config.method), "LOSS_KERNELS", ("xla", "pallas"))
        checks += [
            (loss_kernel not in ("xla", "pallas"), f"method.loss_kernel {loss_kernel!r}: "
             "'xla' (the staged loss) or 'pallas' (the fused loss kernels)"),
            (loss_kernel == "pallas" and "pallas" not in hostable,
             f"method.loss_kernel: pallas is the fused GAE + whitening + clipped-loss "
             f"kernel pair — {type(config.method).__name__} has no GAE/value-head loss to "
             f"fuse (hostable kernels: {list(hostable)})"),
        ]
    unported_faults = sorted({
        spec.kind for spec in FaultPlan.from_config(config.resilience.fault_plan).specs
        if spec.kind in UNPORTED_KINDS})
    checks += [
        (config.serve.enabled and not collects_rollouts, "serve.enabled: this trainer has "
         "no continuous-batching engine path to serve from (PPO-family trainers only)"),
        (m.model_arch_type != "causal" and not (seq2seq_ok and m.model_arch_type == "seq2seq"),
         f"model.model_arch_type {m.model_arch_type!r}: the port runs seq2seq models under "
         "PPO and ILQL only"),
        (bool(unported_faults), "resilience.fault_plan: the port does not poll the fault "
         "kinds " + ", ".join(f"{k!r} (waits for {UNPORTED_KINDS[k]})"
                              for k in unported_faults)),
    ]
    checks += [
        (int(getattr(par, axis)) > 1, f"parallel.{axis} > 1: {reason}")
        for axis, reason in _UNPORTED_AXES.items()
    ]
    if not sequence_ok:
        checks.append((int(par.sequence) > 1, "parallel.sequence > 1: only SFT rings its "
                       "forwards; the RL and preference trainers' cacheless forwards under "
                       "sequence parallelism (a gather of the response span for the PPO loss "
                       "kernels) come with slice 22"))
    if world_size() > 1:
        checks += [
            (config.async_rl.enabled, "async_rl.enabled: async collection runs in one "
             "process; the actor/learner split over several processes comes with slice 23"),
            (config.serve.enabled, "serve.enabled: serving inside a trainer runs in one "
             "process; serving over several processes comes with slice 23"),
            (m.model_arch_type == "seq2seq", "model.model_arch_type 'seq2seq': seq2seq "
             "models run in one process; seq2seq over several processes comes with slice 23"),
        ]
    for bad, message in checks:
        if bad:
            raise ValueError(message)
    try:
        shape = mesh_shape_from_config(par)
    except ValueError as e:
        axis = next((a for a in _PARALLEL_AXES if int(getattr(par, a)) > 1), "data")
        raise ValueError(f"parallel.{axis}: {e} (start one process per device: "
                         "trlx.initialize_runtime)") from e
    if not sequence_ok and shape[MESH_AXES.index("sequence")] > 1:
        raise ValueError("parallel.sequence: the inferred axis would span "
                         f"{shape[MESH_AXES.index('sequence')]} processes; only SFT rings "
                         "its forwards (slice 22 for the other trainers)")
    dcn = int(par.dcn_data_parallelism)
    if dcn > 1 and shape[0] % dcn:
        raise ValueError(f"parallel.dcn_data_parallelism: data axis {shape[0]} not "
                         f"divisible by dcn_data_parallelism {dcn}")


def _all_reduce_(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every rank, in place."""
    import torch.distributed as dist

    dist.all_reduce(x)
    return x


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class HostCopy:
    """Device → host copies started on the calling thread: each CUDA
    tensor is copied ``non_blocking`` into a pinned host buffer and one
    event is recorded after the copies. :meth:`wait` synchronizes on that
    event only, so a pipeline worker that lands a chunk never queues
    behind work the main thread has launched since; host arrays and CPU
    tensors pass through. The caller keeps the device tensors referenced
    until the chunk is finalized."""

    def __init__(self, arrays: Dict[str, Any]):
        self._event = None
        self._host: Dict[str, Any] = {}
        for k, v in arrays.items():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                buf.copy_(v, non_blocking=True)
                self._host[k] = buf
                if self._event is None:
                    self._event = torch.cuda.Event()
            else:
                self._host[k] = v
        if self._event is not None:
            self._event.record()

    @property
    def event(self) -> Optional[Any]:
        """The CUDA event after the copies (None when nothing was copied):
        a span fences on it to wait for exactly this chunk's work."""
        return self._event

    def wait(self) -> Dict[str, np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in self._host.items()}


def host_stats(stats: Dict[str, Any]) -> Dict[str, Any]:
    """The stats on the host, fetched from the device in one copy: scalar
    tensors as floats, the other tensors (the ``dist/*_hist`` sketch
    histograms) as f32 numpy arrays of their shapes; host values pass
    through. The caller summarizes the histograms
    (``DynamicsSummarizer.summarize``) before ``filter_non_scalars`` drops
    them."""
    tensors = {k: v for k, v in stats.items() if isinstance(v, torch.Tensor)}
    out: Dict[str, Any] = {k: v for k, v in stats.items() if k not in tensors}
    if not tensors:
        return out
    flat = torch.cat([v.detach().reshape(-1).float() for v in tensors.values()]).cpu().numpy()
    at = 0
    for k, v in tensors.items():
        n = v.numel()
        out[k] = float(flat[at]) if n == 1 else flat[at:at + n].reshape(tuple(v.shape))
        at += n
    return out


class TorchBaseTrainer(BaseRLTrainer):
    """Shared learn-loop trainer on one device.

    Subclasses define ``model_head``, ``loss_fn(batch) -> (loss, stats)``
    on a dict of device tensors, ``prepare_learning()``, and optionally
    ``post_backward_callback`` / ``post_epoch_callback``."""

    model_head: Optional[str] = None
    # PPO collects rollouts through the engine; the offline trainers only
    # evaluate through it (see reject_unported)
    collects_rollouts: bool = False
    # rings its forwards over a ``sequence`` axis (every trainer runs over
    # ``data`` and ``fsdp``): SFT
    sequence_ok: bool = False
    # the trainers with a seq2seq branch (PPO and ILQL, as in JAX)
    supports_seq2seq: bool = False

    def __init__(
        self,
        config,
        reward_fn: Optional[Callable] = None,
        metric_fn: Optional[Callable] = None,
        stop_sequences: Optional[List[str]] = None,
        device: Any = None,
        **kwargs,
    ):
        super().__init__(config, reward_fn, metric_fn, stop_sequences, **kwargs)
        validate_engine(config)
        if self.collects_rollouts:
            validate_serve(config)
        self.is_seq2seq = config.model.model_arch_type == "seq2seq"
        if self.is_seq2seq and self.collects_rollouts and config.train.continuous_batching:
            raise NotImplementedError(
                "train.continuous_batching supports causal LMs only: the "
                "seq2seq decoder has no slot-refill path"
            )
        reject_unported(config, self.collects_rollouts, self.supports_seq2seq,
                        self.sequence_ok)
        if config.train.batch_size % max(1, int(config.train.grad_accum)) != 0:
            raise ValueError(
                f"train.batch_size ({config.train.batch_size}) must be divisible "
                f"by train.grad_accum ({config.train.grad_accum})"
            )
        self.device = resolve_device(device)
        # the mesh over the world's processes (JAX's constructor); at world
        # size 1 none is built and nothing is wrapped. No model code reads
        # the global mesh: a sequence-sharded forward is given its group
        self.mesh = (make_mesh(config.parallel, self.device.type) if world_size() > 1
                     else None)
        set_global_mesh(self.mesh)
        self.tokenizer = tokenizer_from_config(config.tokenizer)

        overrides = assemble_overrides(config.model, config.parallel,
                                       scan_layers_supported=not self.is_seq2seq)
        build, mask_fn = ((build_seq2seq_lm, seq2seq_trainable_mask) if self.is_seq2seq
                          else (build_causal_lm, trainable_mask))
        self.model, self.tcfg = build(
            config.model.model_path, seed=config.train.seed, device=self.device,
            head=self.model_head, two_qs=getattr(config.method, "two_qs", True), **overrides,
        )
        self.draft_model, self.draft_tcfg = None, None
        if config.model.draft_model_path and self.is_seq2seq:
            logger.warning("model.draft_model_path is ignored for seq2seq models: "
                           "speculative decoding is implemented for causal LMs only")
        elif config.model.draft_model_path:
            # a bare LM, randomly initialised from train.seed + 1 (a
            # checkpoint directory's backbone imported over it)
            draft_overrides = dict(config.model.draft_model_extra_kwargs or {})
            draft_overrides.setdefault("param_dtype", overrides["param_dtype"])
            draft_overrides.setdefault("dtype", overrides["dtype"])
            vocab = resolve_transformer_config(config.model.draft_model_path,
                                               **draft_overrides).vocab_size
            if vocab != self.tcfg.vocab_size:
                raise ValueError(
                    f"model.draft_model_path {config.model.draft_model_path!r}: draft "
                    f"vocab {vocab} != policy vocab {self.tcfg.vocab_size}: speculative "
                    "decoding needs a same-tokenizer draft"
                )
            self.draft_model, self.draft_tcfg = build_causal_lm(
                config.model.draft_model_path, seed=config.train.seed + 1,
                device=self.device, **draft_overrides,
            )
        # JAX differentiates every parameter; the mask decides who updates
        self.model.requires_grad_(True)
        self.param_mask = mask_fn(self.model, self.tcfg, config.model.num_layers_unfrozen)
        if self.mesh is not None:
            # FSDP2 over the mesh, before the optimizer sees the parameters
            shard_params(self.model, self.mesh)
        self.schedule = get_scheduler(config.scheduler.name, dict(config.scheduler.kwargs),
                                      default_lr=config.optimizer.kwargs.get("lr"))
        self.optimizer = get_optimizer(
            config.optimizer.name, dict(config.optimizer.kwargs),
            [p for n, p in self.model.named_parameters() if self.param_mask[n]],
        )
        self.step = 0  # optimizer updates taken (the JAX TrainState.step)
        # bumped whenever the weights change (an optimizer step, a load):
        # the rollout engines' version, which flushes their prefix caches
        self._weights_version = 0
        # the serving frontend (serve.enabled): built in learn(), drained
        # on every exit from it
        self._serve = None
        # per-row sampling seeds of the rollout and eval engines
        self._rollout_seeds = np.random.RandomState(config.train.seed)

        self.generate_kwargs = dict(config.method.gen_kwargs)
        self.generate_experience_kwargs = (
            dict(config.method.gen_experience_kwargs)
            if getattr(config.method, "gen_experience_kwargs", None) else None
        )
        self._generate_fns: Dict[Any, Any] = {}
        # the engine and program caches: actor threads build from them too
        self._engine_lock = threading.RLock()
        # the last generate's engine stats, and its device-complete seconds
        # (per thread: async actors generate beside the learner)
        self._generate_local = threading.local()
        self.last_generate_stats: Dict[str, float] = {}
        self.last_generate_time = 0.0
        # prompt chunks drawn from the prompt iterator: a checkpoint records
        # it and a resume replays that many draws
        self._prompt_chunks_drawn = 0
        self._resume_done = False
        self._last_batch_host: Any = None
        self._last_batch_device: Any = None
        # under the mesh: did the last host batch split over the data axes?
        self._batch_split = False
        # run observability (tracer, metrics registry, watchdogs, profiler
        # window, flight recorder, cluster beat, dynamics and health), the
        # resilience bundle (reward_fn and the tracker hardened once, so
        # every call site is)
        self.obs = Observability(config, device=self.device)
        self.metrics = self.obs.metrics
        self.resilience = Resilience(config, metrics=self.metrics)
        self.reward_fn = self.resilience.harden_reward_fn(self.reward_fn,
                                                          seed=config.train.seed)
        self.tracker = self.resilience.harden_tracker(make_tracker(config),
                                                      seed=config.train.seed)
        # the train step's FLOPs: None until its first call counts them,
        # then the count (-1.0: unavailable)
        self._train_step_flops: Optional[float] = None
        self._triage_dumps = 0
        self._emergency_resume = False
        self._batch_iter: Any = None
        self.eval_pipeline = None
        self.iter_count = 0
        self.nth_evaluation = 0
        self.best_reward = -float("inf")

    @property
    def last_generate_stats(self) -> Dict[str, float]:
        """This thread's last generate's engine stats."""
        return getattr(self._generate_local, "stats", {})

    @last_generate_stats.setter
    def last_generate_stats(self, stats: Dict[str, float]) -> None:
        self._generate_local.stats = stats

    @property
    def last_generate_time(self) -> float:
        """This thread's last serial generate's device-complete seconds."""
        return getattr(self._generate_local, "time", 0.0)

    @last_generate_time.setter
    def last_generate_time(self, seconds: float) -> None:
        self._generate_local.time = seconds

    # ------------------------------------------------------------------
    # subclass contract
    # ------------------------------------------------------------------

    @abstractmethod
    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, Any]]:
        ...

    @abstractmethod
    def prepare_learning(self) -> None:
        ...

    def post_backward_callback(self) -> None:
        pass

    def with_router_aux(self, loss_stats: Tuple[torch.Tensor, Dict[str, Any]],
                        out: Any) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Fold the MoE router losses (the Switch load balance and the
        ST-MoE z-loss, weighted by the model config's ``router_aux_coef``
        and ``router_z_coef``) into a trainer loss, logged as
        ``losses/router_load_balance`` and ``losses/router_z``, with the
        logged total (``losses/total_loss`` or ``losses/loss``) the
        optimised one. A no-op for dense models; every ``loss_fn`` returns
        through it."""
        loss, stats = loss_stats
        aux = out.get("router_aux_loss") if isinstance(out, dict) else None
        if aux is None:
            return loss, stats
        if self.mesh is not None:
            # each rank's router losses are its rows' means: the mean over
            # the data axes is the global batch's, and each rank's share of
            # it is what FSDP2's sum of the gradients makes whole
            n = data_parallel_size(self.mesh)
            logged = torch.stack([aux[0].detach(), aux[1].detach()])
            _all_reduce_(logged)
            aux = (aux[0] / n, aux[1] / n)
            new_loss = (loss + self.tcfg.router_aux_coef * aux[0]
                        + self.tcfg.router_z_coef * aux[1])
            stats = dict(stats)
            stats["losses/router_load_balance"] = logged[0] / n
            stats["losses/router_z"] = logged[1] / n
            for key in ("losses/total_loss", "losses/loss"):
                if key in stats:
                    stats[key] = stats[key] + (self.tcfg.router_aux_coef * logged[0]
                                               + self.tcfg.router_z_coef * logged[1]) / n
            return new_loss, stats
        new_loss = loss + self.tcfg.router_aux_coef * aux[0] + self.tcfg.router_z_coef * aux[1]
        stats = dict(stats)
        stats["losses/router_load_balance"] = aux[0].detach()
        stats["losses/router_z"] = aux[1].detach()
        for key in ("losses/total_loss", "losses/loss"):
            if key in stats:
                stats[key] = new_loss.detach()
        return new_loss, stats

    def _resolved_logit_chunk(self) -> int:
        """``method.logit_chunk`` when the model can stream the vocab
        projection (it has ``project_logits``), else 0 — warning once."""
        chunk = int(getattr(self.config.method, "logit_chunk", 0) or 0)
        if not chunk or hasattr(type(self.model), "project_logits"):
            return chunk
        if not getattr(self, "_warned_logit_chunk", False):
            self._warned_logit_chunk = True
            logger.warning(
                "method.logit_chunk=%d is IGNORED: %s has no project_logits — the full "
                "[B, T, V] logits will be materialized", chunk, type(self.model).__name__,
            )
        return 0

    def post_epoch_callback(self) -> None:
        pass

    def adjust_logits_fn(self, extra_kwargs: Dict[str, Any]) -> Optional[Callable]:
        """Sampling-logit hook of an algorithm (none for PPO)."""
        return None

    def add_eval_pipeline(self, eval_pipeline) -> None:
        self.eval_pipeline = eval_pipeline

    # ------------------------------------------------------------------
    # train step
    # ------------------------------------------------------------------

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        """The batch on the device, memoized on the batch object: PPO
        replays one batch ``ppo_epochs`` times."""
        if batch is self._last_batch_host:
            return self._last_batch_device
        items = batch._asdict() if hasattr(batch, "_asdict") else batch
        items = self.host_batch({k: v for k, v in items.items() if hasattr(v, "ndim")})
        arrays = {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in items.items()}
        self._last_batch_host, self._last_batch_device = batch, arrays
        return arrays

    def host_batch(self, items: Dict[str, Any], unit: int = 1) -> Dict[str, Any]:
        """The arrays a step takes from a collated host batch: the batch as
        it is, or under the mesh this rank's rows over ``data`` x ``fsdp``
        (``parallel/sharding.py::shard_batch``, aligned to the
        gradient-accumulation micro-batches) when the data axes divide its
        units of ``unit`` rows, else every row (JAX's replication of an
        undivided leading dim). :meth:`gather_rows` joins a loss operand
        back either way."""
        if self.mesh is None:
            return items
        micro = max(1, int(self.config.train.grad_accum))
        rows = next(v.shape[0] for v in items.values() if getattr(v, "ndim", 0))
        self._batch_split = (rows // unit) % (data_parallel_size(self.mesh) * micro) == 0 \
            and rows % unit == 0
        return shard_batch(items, self.mesh, micro=micro) if self._batch_split else items

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """A loss operand of this rank's rows joined over ``data`` x
        ``fsdp`` inside autograd (``parallel/sharding.py::gather_rows``):
        a loss computed on the result is the global batch's on every rank,
        and the gradients FSDP2 sums over the ranks are its gradient."""
        return gather_rows(x, self.mesh, split=self._batch_split)

    def _drop_batch_memo(self) -> None:
        self._last_batch_host = self._last_batch_device = None

    def accumulate_grads(self, arrays: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Set every parameter's ``.grad`` for one device batch and return
        the ``loss_fn`` stats. With ``train.grad_accum`` k > 1 the rows split
        into k consecutive micro-batches, each a ``loss_fn`` pass of its own
        (its own whitening and token means); gradients and stats are summed
        over them and divided by k, in JAX's order."""
        return self._accumulate(arrays)[0]

    def _accumulate(self, arrays: Dict[str, torch.Tensor], loss_scale: Optional[float] = None
                    ) -> Tuple[Dict[str, Any], Optional[torch.Tensor]]:
        """:meth:`accumulate_grads`, returning also the (scaled) loss when
        there is one micro-batch. ``loss_scale`` multiplies each
        micro-batch's loss before its backward (the fault plan's NaN; None
        leaves the loss as it is, as JAX's exact multiply by 1.0 does)."""
        accum = max(1, int(self.config.train.grad_accum))
        self.model.zero_grad(set_to_none=True)
        if accum == 1:
            loss, stats = self.loss_fn(arrays)
            if loss_scale is not None:
                loss = loss * loss_scale
            loss.backward()
            return stats, loss.detach()
        rows = next(iter(arrays.values())).shape[0]
        if rows % accum:
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"train.grad_accum ({accum}) micro-batches")
        size = rows // accum
        total: Dict[str, Any] = {}
        for i in range(accum):
            loss, stats = self.loss_fn({k: v[i * size:(i + 1) * size]
                                        for k, v in arrays.items()})
            if loss_scale is not None:
                loss = loss * loss_scale
            loss.backward()
            for k, v in stats.items():
                v = v.detach() if isinstance(v, torch.Tensor) else v
                total[k] = v if i == 0 else total[k] + v
        for p in self.model.parameters():
            if p.grad is not None:
                p.grad.div_(accum)
        return {k: v / accum for k, v in total.items()}, None

    def _loss_scale(self) -> Optional[float]:
        """None, or NaN when the fault plan poisons this update's loss
        (``nan_loss@step:N``, JAX's ``_loss_scale``): the loss and every
        gradient turn non-finite, which the update guard must catch."""
        plan = self.resilience.plan
        if plan and plan.poll("nan_loss", step=self.iter_count):
            logger.warning("fault plan: poisoning the loss of update %d to NaN",
                           self.iter_count)
            return float("nan")
        return None

    def train_step(self, batch) -> Dict[str, Any]:
        """One optimization step on a host batch; returns device stats.

        The first call runs under the FLOP counter
        (``observability/metrics.py::train_step_flops``; the MFU's
        numerator). Every call feeds the new-signature watchdog
        (``recompile/train_step``). ``sleep_one_proc@step:N`` of the fault
        plan stalls the last rank's update N for ``SLEEP_FAULT_S``.

        With ``resilience.update_guard`` on, the step checks
        ``isfinite(gradients/global_norm)`` (and ``isfinite(loss)`` with one
        micro-batch) and reads that flag on the host once, before the
        optimizer steps: under ``skip`` a failed check takes no optimizer
        step, so the parameters, the optimizer state and the step count
        that drives the LR schedule stay as they were (JAX's select of the
        old state). The flag rides the stats as ``resilience/update_ok``;
        ``rollback`` and ``halt`` act on it in the learn loop."""
        plan = self.resilience.plan
        if (plan and process_index() == process_count() - 1
                and plan.poll("sleep_one_proc", step=self.iter_count)):
            # a deterministic straggler for the cluster telemetry
            from trlx_tpu_torch.resilience.faults import SLEEP_FAULT_S

            logger.warning("fault plan: sleeping %ss inside update %d (injected straggler)",
                           SLEEP_FAULT_S, self.iter_count)
            time.sleep(SLEEP_FAULT_S)
        if self._train_step_flops is None:
            stats, flops = train_step_flops(self._optimizer_step, batch)
            self._train_step_flops = flops or -1.0
        else:
            stats = self._optimizer_step(batch)
        # keyed on the (stable) function: each access makes a new bound method
        self.obs.recompile.observe("train_step", type(self)._optimizer_step,
                                   self._device_batch(batch))
        return stats

    def _optimizer_step(self, batch) -> Dict[str, Any]:
        """:meth:`train_step`'s update: gradients, the guard, the optimizer."""
        arrays = self._device_batch(batch)
        stats, loss = self._accumulate(arrays, self._loss_scale())
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        if self.mesh is None:
            gnorm = torch.nn.utils.get_total_norm(grads)
        else:  # FSDP2's sharded gradients
            gnorm = global_grad_norm(grads)
        lr = float(self.schedule(self.step))
        stats = dict(stats)
        stats["learning_rate"] = lr
        stats["gradients/global_norm"] = gnorm
        policy = self.resilience.guard.policy
        if policy != "off":
            ok = torch.isfinite(gnorm)
            if loss is not None:
                ok = ok & torch.isfinite(loss)
            ok = bool(ok.item())  # the one host read the guard costs
            stats[UPDATE_OK_KEY] = float(ok)
            if policy == "skip" and not ok:
                return stats
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        self._weights_version += 1
        return stats

    @staticmethod
    def _batch_token_count(batch) -> int:
        """Real (unpadded) tokens the batch feeds the step: its
        ``attention_mask``, else the sum of its masks, else its width ×
        rows."""
        items = batch._asdict() if hasattr(batch, "_asdict") else batch
        if not isinstance(items, dict):
            return 0
        if "attention_mask" in items:
            return int(np.asarray(items["attention_mask"]).sum())
        masks = [v for k, v in items.items() if k.endswith("mask") and hasattr(v, "sum")]
        if masks:
            return int(sum(np.asarray(m).sum() for m in masks))
        for v in items.values():
            if hasattr(v, "shape") and len(v.shape) >= 2:
                return int(v.shape[0] * v.shape[1])
        return 0

    def _step_flops(self) -> Optional[float]:
        """The train step's counted FLOPs, or None before (or without) a
        count."""
        flops = self._train_step_flops
        return flops if flops is not None and flops > 0 else None

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------

    def _resolve_gen_config(
        self, eval_mode: bool = False, **kwargs
    ) -> Tuple[GenerationConfig, Tuple[Tuple[str, Any], ...]]:
        """``(gen_config, extra_kwargs)``: the GenerationConfig fields of the
        (eval or experience) gen kwargs, and the rest, hashable. The JAX
        ``per_row_rng`` switch is dropped: every row of the port samples
        from its own seed."""
        base = (self.generate_kwargs
                if eval_mode or self.generate_experience_kwargs is None
                else self.generate_experience_kwargs)
        gen_kwargs = dict(base)
        gen_kwargs.update(kwargs)
        gen_kwargs.pop("per_row_rng", None)
        known = {f.name for f in dataclasses.fields(GenerationConfig)}
        clean = {k: v for k, v in gen_kwargs.items() if k in known}
        clean.setdefault("eos_token_id", self.tokenizer.eos_token_id)
        clean.setdefault("pad_token_id", self.tokenizer.pad_token_id)
        extra = tuple(sorted(
            (k, tuple(v) if isinstance(v, list) else v)
            for k, v in gen_kwargs.items() if k not in known
        ))
        return GenerationConfig(**clean), extra

    def _engine_compute(self) -> Tuple[bool, str, str]:
        """``(paged, decode_kernel, prefill_kernel)`` of the continuous
        engines. A rollout trainer runs ``engine:`` as JAX does (the dense
        backend forces the dense compute, ``xla``); the offline trainers'
        evaluation engine is the paged one on the in-place kernels."""
        e = self.config.engine
        if not self.collects_rollouts:
            return True, "pallas", "pallas"
        if e.backend != "paged":
            return False, "xla", "xla"
        return True, e.decode_kernel, e.prefill_kernel

    def _resolve_paged_spec(self, batch_size: int, prompt_len: int, gen_config,
                            gamma: int = 0) -> Optional[PagedSpec]:
        """The pool geometry of ``engine:``, or None for the dense backend;
        ``max_kv_blocks: 0`` sizes the pool so every slot can reach full
        length. Speculative tables carry entries for the ``gamma`` probe
        columns past ``P + N`` too."""
        if not self._engine_compute()[0]:
            return None
        bs = int(self.config.engine.kv_block_size)
        if bs < 1:
            raise ValueError(f"engine.kv_block_size {bs} must be >= 1")
        max_blocks = int(self.config.engine.max_kv_blocks)
        if max_blocks <= 0:
            # with the prefix cache, room for as many cached blocks again
            max_blocks = 1 + batch_size * num_table_blocks(
                prompt_len + gen_config.max_new_tokens + int(gamma), bs) * (
                    2 if self._prefix_cache_enabled() else 1)
        return PagedSpec(block_size=bs, max_blocks=max_blocks)

    def _prefix_cache_enabled(self) -> bool:
        """``engine.prefix_cache``, turned off with a one-time warning for
        MoE policies, as in JAX: expert capacity is shared across a
        sequence's tokens, so a suffix-only prefill would not equal the
        whole prefill there."""
        if not self.config.engine.prefix_cache:
            return False
        if getattr(self.tcfg, "num_experts", 0):
            if not getattr(self, "_warned_moe_prefix", False):
                self._warned_moe_prefix = True
                logger.warning("engine.prefix_cache disabled: MoE expert capacity is shared "
                               "across a sequence's tokens, so suffix-only prefill would not "
                               "be bit-identical to the full prefill (set "
                               "engine.prefix_cache: false to silence)")
            return False
        return True

    def _get_slot_refill_fns(self, gen_config, extra_kwargs, batch_size: int,
                             prompt_len: int, segment_len: int):
        """The slot-refill programs for one engine geometry (cached)."""
        gamma = int(self.config.engine.speculative)
        if gamma and self.draft_model is None:
            raise ValueError("engine.speculative requires model.draft_model_path (no "
                             "draft model was built)")
        paged = self._resolve_paged_spec(batch_size, prompt_len, gen_config, gamma)
        _, decode_kernel, prefill_kernel = self._engine_compute()
        key = ("slot_refill", gen_config, extra_kwargs, batch_size, prompt_len,
               segment_len, paged, decode_kernel, prefill_kernel, gamma)
        with self._engine_lock:
            if key not in self._generate_fns:
                algo_adjust = self.adjust_logits_fn(dict(extra_kwargs))
                if gamma:
                    # the rounds take the mask separately (draft and target
                    # alike) and the algorithm's hook for the verify alone
                    hooks = dict(adjust_logits=algo_adjust,
                                 transition_mask=self._logit_mask_tensor(),
                                 draft_cfg=self.draft_tcfg)
                else:
                    hooks = dict(adjust_logits=self._compose_logit_mask(algo_adjust))
                self._generate_fns[key] = make_slot_refill_fns(
                    self.tcfg, batch_size, prompt_len, gen_config,
                    segment_len=segment_len, paged=paged, device=self.device,
                    speculative=gamma, decode_kernel=decode_kernel,
                    prefill_kernel=prefill_kernel, **hooks,
                )
            return self._generate_fns[key]

    def _engine_params(self, params: Any = None) -> Any:
        """The model the rollout engines run (the policy itself: the
        engines read its live weights), or with ``engine.speculative`` on
        the ``(target, draft)`` pair the spec programs unpack — one object,
        so the engine adopts both at once."""
        target = self.model if params is None else params
        if int(self.config.engine.speculative):
            return (target, self.draft_model)
        return target

    def _cb_make_engine(self, gen_config, extra_kwargs, rows: int, chunk_width: int,
                        tag: Any = None, params: Any = None,
                        version: Optional[int] = None,
                        prefix_and_chunks: bool = True) -> ContinuousEngine:
        """The engine for ``rows`` slots, cached per shape bucket and reset
        for a fresh collection. Its prompt width is the trainer-level
        budget ``seq_length − max_new_tokens``, bumped to the chunk's
        collation width if a loader pads wider; narrower chunks left-pad.
        The prefix cache and chunked prefill come from ``engine:`` (the
        rollout and serving engines; ``generate``'s engine, JAX's serial
        generate, runs without them). The engine runs ``params`` (default:
        the live policy, versioned by the trainer's weights counter, so
        its prefix cache is flushed after every update)."""
        seg = max(1, int(self.config.train.continuous_batching_segment or 8))
        engine_p = max(int(self.config.train.seq_length) - gen_config.max_new_tokens,
                       chunk_width)
        key = ("cb_engine", gen_config, extra_kwargs, rows, engine_p, seg, tag)
        if version is None and params is None:
            version = self._weights_version
        with self._engine_lock:  # async actors build theirs beside the learner
            engine = self._generate_fns.get(key)
            if engine is None:
                fns = self._get_slot_refill_fns(gen_config, extra_kwargs, rows, engine_p, seg)
                engine = ContinuousEngine(
                    fns, self._engine_params(params), self.tokenizer.pad_token_id,
                    # fenced rollout/segment spans, per-request lifecycle events
                    span=self.obs.span, tracer=self.obs.tracer,
                    prefix_cache=prefix_and_chunks and self._prefix_cache_enabled(),
                    prefix_capacity_blocks=int(self.config.engine.prefix_cache_blocks),
                    prefill_chunk=(int(self.config.engine.prefill_chunk)
                                   if prefix_and_chunks else 0))
                self._generate_fns[key] = engine
        engine.begin_collection(self._engine_params(params), version=version)
        return engine

    def _row_seeds(self, rows: int, stream: Optional[np.random.RandomState] = None
                   ) -> np.ndarray:
        """``rows`` per-row sampling seeds from the rollout seed stream (or
        from ``stream``, an async collector's copy of it)."""
        stream = self._rollout_seeds if stream is None else stream
        return stream.randint(0, 2**31 - 1, size=rows).astype(np.int64)

    def _compose_logit_mask(self, adjust: Optional[Callable]) -> Optional[Callable]:
        """Chain the transition ``logit_mask`` after the algorithm's logit
        hook: tokens whose ``mask[last_token, next_token]`` is False sample
        at -1e10."""
        mask = self._logit_mask_tensor()
        if mask is None:
            return adjust

        def fn(step_out: Dict[str, Any], logits: torch.Tensor) -> torch.Tensor:
            if adjust is not None:
                logits = adjust(step_out, logits)
            return apply_transition_mask(mask, step_out["last_tokens"], logits)

        return fn

    def _logit_mask_tensor(self) -> Optional[torch.Tensor]:
        if self.logit_mask is None:
            return None
        return torch.as_tensor(np.asarray(self.logit_mask), dtype=torch.bool,
                               device=self.device)

    def _serial_rollouts(self) -> bool:
        """Does ``generate`` run the serial engine? For a rollout trainer
        with ``train.continuous_batching: false``, for every seq2seq
        trainer (its decoder has no paged path), and for an offline trainer
        with a draft model (JAX's serial speculative sampler: ILQL's
        speculative sampling); the other causal offline trainers evaluate
        on the paged engine whatever it says."""
        if self.is_seq2seq:
            return True
        if self.collects_rollouts:
            return not self.config.train.continuous_batching
        return self.draft_model is not None

    def _get_generate_fn(self, gen_config: GenerationConfig,
                         extra_kwargs: Tuple[Tuple[str, Any], ...] = ()) -> Callable:
        """The serial rollout program ``fn(params, input_ids, attention_mask,
        seeds)`` of one sampling config (cached): the dense ``generate``
        with the composed logit hooks (``generate_seq2seq`` for a seq2seq
        model), or with a draft model the speculative sampler (``params``
        the ``(target, draft)`` pair), which takes the mask and the
        algorithm's hook separately."""
        key = ("serial", gen_config, extra_kwargs)
        with self._engine_lock:
            if key not in self._generate_fns:
                self._generate_fns[key] = self._build_generate_fn(gen_config, extra_kwargs)
            return self._generate_fns[key]

    def _build_generate_fn(self, gen_config: GenerationConfig,
                           extra_kwargs: Tuple[Tuple[str, Any], ...]) -> Callable:
        """:meth:`_get_generate_fn`'s program for one sampling config."""
        algo_adjust = self.adjust_logits_fn(dict(extra_kwargs))
        if self.is_seq2seq:
            adjust = self._compose_logit_mask(algo_adjust)
            start_id = self.tcfg.decoder_start_token_id

            def fn(params, input_ids, attention_mask, seeds):
                return generate_seq2seq(params, input_ids, attention_mask, seeds,
                                        gen_config, start_token_id=start_id,
                                        adjust_logits=adjust)
        elif self.draft_model is not None:
            gamma = int(self.config.model.draft_gamma)
            mask = self._logit_mask_tensor()

            def fn(params, input_ids, attention_mask, seeds):
                target, draft = params
                return generate_speculative(
                    target, draft, input_ids, attention_mask, seeds, gen_config,
                    gamma=gamma, return_stats=True, transition_mask=mask,
                    adjust_logits=algo_adjust)
        else:
            adjust = self._compose_logit_mask(algo_adjust)

            def fn(params, input_ids, attention_mask, seeds):
                return dense_generate(params, input_ids, attention_mask, seeds,
                                      gen_config, adjust_logits=adjust)
        return fn

    def _get_serial_engine(self, gen_config, extra_kwargs) -> SerialEngine:
        """The :class:`SerialEngine` around this config's rollout program
        (cached); it takes the live policy (and draft) at every call."""
        key = ("serial_engine", gen_config, extra_kwargs)
        with self._engine_lock:
            if key not in self._generate_fns:
                self._generate_fns[key] = SerialEngine(
                    self._get_generate_fn(gen_config, extra_kwargs), None,
                    self.tokenizer.pad_token_id)
            engine = self._generate_fns[key]
        engine.params = self._serial_params()
        return engine

    def _serial_params(self, model: Any = None) -> Any:
        """The serial program's ``params``: the policy (``model``, an async
        actor's weights snapshot, or the live one), paired with the draft
        under speculation."""
        model = self.model if model is None else model
        return model if self.draft_model is None else (model, self.draft_model)

    def _dense_kv_gauge(self, prompt_shape: Tuple[int, int], gen_config) -> Dict[str, float]:
        """``memory/kv_cache_bytes`` of the serial path: the dense
        ``[B, P + N]`` cache, or under speculation the target's and the
        draft's caches of ``P + N + draft_gamma`` columns each (what
        ``ops/speculative.py`` allocates). No gauge for a seq2seq model, as
        in JAX (its self- and cross-attention caches have their own layout)."""
        if self.is_seq2seq:
            return {}
        B, P = prompt_shape
        S = P + gen_config.max_new_tokens
        if self.draft_model is None:
            total = dense_kv_bytes(self.tcfg, B, S)
        else:
            S += int(self.config.model.draft_gamma)
            total = dense_kv_bytes(self.tcfg, B, S) + dense_kv_bytes(self.draft_tcfg, B, S)
        return {"memory/kv_cache_bytes": float(total)}

    @torch.no_grad()
    def generate_serial(self, input_ids: np.ndarray, attention_mask: np.ndarray,
                        eval_mode: bool = False, model: Any = None,
                        seeds: Optional[np.ndarray] = None, **kwargs) -> GenerationOutput:
        """One serial dense generate of a left-padded prompt batch on the
        device (per-row seeds from the rollout seed stream, or ``seeds``);
        the outputs stay on the device. ``model`` (an async actor's weights
        snapshot) replaces the live policy for this call. Sets
        :attr:`last_generate_time` (device-complete seconds) and
        :attr:`last_generate_stats` (the KV gauge and, under speculation,
        ``rollout/spec_acceptance_rate`` and ``rollout/spec_rounds``) for
        the calling thread."""
        gen_config, extra = self._resolve_gen_config(eval_mode, **kwargs)
        input_ids = np.asarray(input_ids, np.int64)
        if seeds is None:
            seeds = self._row_seeds(input_ids.shape[0])
        engine = self._get_serial_engine(gen_config, extra)
        stats = self._dense_kv_gauge(input_ids.shape, gen_config)
        for k, v in stats.items():  # a registry gauge too, as in JAX
            self.metrics.set_gauge(k, v)
        args = (torch.as_tensor(input_ids), torch.as_tensor(np.asarray(attention_mask, np.int64)),
                torch.as_tensor(seeds))
        # fenced: the duration is the card's decode, not its launch latency
        # (nested under the collection's "rollout" span)
        with self.obs.span("generate", eval_mode=bool(eval_mode)) as sp:
            out = engine.generate(*args, params=None if model is None
                                  else self._serial_params(model))
            if type(out) is tuple:  # the speculative sampler: (output, stats)
                out, spec = out
                stats["rollout/spec_acceptance_rate"] = float(spec["acceptance_rate"])
                stats["rollout/spec_rounds"] = float(spec["rounds"])
            sp.fence((out.sequences, out.response_tokens))
        self.last_generate_time = sp.duration
        self.last_generate_stats = stats
        self.obs.recompile.observe("generate", engine._fn, args[:2])
        return out

    @torch.no_grad()
    def generate(self, input_ids: np.ndarray, attention_mask: Optional[np.ndarray] = None,
                 eval_mode: bool = False, **kwargs) -> Dict[str, np.ndarray]:
        """Sample continuations for a left-padded prompt batch: on the
        serial dense engine for a rollout trainer with
        ``train.continuous_batching: false`` (:meth:`generate_serial`),
        else through the paged engine. Returns host arrays
        ``response_tokens``, ``response_mask``, ``response_logprobs`` and
        ``response_values`` (``[b, N]``, in the batch's row order)."""
        input_ids = np.asarray(input_ids, np.int64)
        if attention_mask is None:
            attention_mask = (input_ids != self.tokenizer.pad_token_id).astype(np.int64)
        if self._serial_rollouts():
            out = self.generate_serial(input_ids, attention_mask, eval_mode, **kwargs)
            return {"response_tokens": out.response_tokens.cpu().numpy(),
                    "response_mask": out.response_mask.cpu().numpy(),
                    "response_logprobs": out.response_logprobs.cpu().numpy(),
                    "response_values": out.response_values.cpu().numpy()}
        gen_config, extra = self._resolve_gen_config(eval_mode, **kwargs)
        rows, width = input_ids.shape
        engine = self._cb_make_engine(gen_config, extra, rows, width,
                                      tag="eval" if eval_mode else "generate",
                                      prefix_and_chunks=False)
        engine.enqueue_prompts(input_ids, attention_mask, self._row_seeds(rows))
        with self.obs.span("generate", eval_mode=bool(eval_mode)):
            done = sorted(engine.run(), key=lambda c: c.index)
        self.last_generate_stats = engine.stats.metrics()
        base = done[0].index if done else 0
        assert [c.index - base for c in done] == list(range(rows))
        return {
            "response_tokens": np.stack([c.tokens for c in done]),
            "response_mask": np.stack([c.mask for c in done]),
            "response_logprobs": np.stack([c.logprobs for c in done]),
            "response_values": np.stack([c.values for c in done]),
        }

    def generate_eval(self, input_ids, attention_mask=None, **kwargs) -> Dict[str, np.ndarray]:
        return self.generate(input_ids, attention_mask, eval_mode=True, **kwargs)

    # ------------------------------------------------------------------
    # decoding and evaluation
    # ------------------------------------------------------------------

    def decode(self, prompt_ids: np.ndarray, response_ids: np.ndarray,
               append_eos_token: bool = False) -> Tuple[List[str], List[str], List[str]]:
        """Token batches → (samples, prompts, outputs) strings, trimming
        outputs at the first stop sequence and optionally re-appending eos."""
        str_samples, str_prompts, str_outputs = [], [], []
        for prompt_row, response_row in zip(np.asarray(prompt_ids), np.asarray(response_ids)):
            str_prompt = self.tokenizer.decode(prompt_row.tolist(), skip_special_tokens=True)
            str_output = self.tokenizer.decode(response_row.tolist(), skip_special_tokens=True)
            for stop in self.stop_sequences:
                str_output = str_output.split(stop)[0]
            if append_eos_token:
                str_output += self.tokenizer.eos_token
            str_prompts.append(str_prompt)
            str_outputs.append(str_output)
            if self.is_seq2seq:  # prompt and output joined by the sep token
                sep = getattr(self.tokenizer, "sep_token", None) or " "
                str_samples.append(str_prompt + sep + str_output)
            else:
                str_samples.append(str_prompt + str_output)
        return str_samples, str_prompts, str_outputs

    def evaluate(self) -> Dict[str, Any]:
        """Generate on the eval prompts and score them with the reward and
        metric functions; a single list-valued gen kwarg is swept. The
        engine's kernel launch gauges, summed over the eval's generate
        calls, land in ``eval/*_kernel_launches``."""
        stats: Dict[str, Any] = {}
        launches: Dict[str, float] = {}
        sweep_key, sweep_values = None, [None]
        for k, v in self.generate_kwargs.items():
            if isinstance(v, list):
                sweep_key, sweep_values = k, v
                break
        eval_batch_size = self.config.train.eval_batch_size or self.config.train.batch_size
        loader = self.eval_pipeline.create_loader(eval_batch_size)
        for sweep_value in sweep_values:
            overrides = {sweep_key: sweep_value} if sweep_key else {}
            all_samples, all_prompts, all_outputs = [], [], []
            t0 = time.perf_counter()
            # every rank generates every row; under FSDP2 the weights are
            # gathered once for the sweep, not once per decode step
            outs = []
            with unsharded(self.model):
                for batch in loader:
                    out = self.generate(batch["input_ids"], batch["attention_mask"],
                                        eval_mode=True, **overrides)
                    outs.append((batch, out, dict(self.last_generate_stats)))
            for batch, out, gen_stats in outs:
                for k, v in gen_stats.items():
                    if k.endswith("_kernel_launches"):
                        name = "eval/" + k.split("/", 1)[1]
                        launches[name] = launches.get(name, 0.0) + v
                samples, prompts, outputs = self.decode(batch["input_ids"],
                                                        out["response_tokens"])
                all_samples += samples
                all_prompts += prompts
                all_outputs += outputs
            stats["time/generate"] = time.perf_counter() - t0
            suffix = f"@{sweep_key}={sweep_value}" if sweep_key else ""
            if self.reward_fn:
                rewards = np.asarray(self.reward_fn(samples=all_samples, prompts=all_prompts,
                                                    outputs=all_outputs), dtype=np.float64)
                stats[f"reward/mean{suffix}"] = float(rewards.mean())
                stats[f"reward/std{suffix}"] = float(rewards.std())
            if self.metric_fn:
                metrics = self.metric_fn(samples=all_samples, prompts=all_prompts,
                                         outputs=all_outputs)
                for name, values in metrics.items():
                    arr = np.asarray(values, dtype=np.float64)
                    stats[f"metrics/{name}{suffix}"] = float(arr.mean()) if arr.size else 0.0
        stats.update(launches)
        self.nth_evaluation += 1
        return stats

    # ------------------------------------------------------------------
    # the learn loop
    # ------------------------------------------------------------------

    def learn(self) -> Dict[str, Any]:
        """Epochs → batches → ``n_updates_per_batch`` updates per batch, with
        interval checkpoints (the retention ring pruning first), interval
        evaluation and best-reward saves. Resumes first when
        ``train.resume_from_checkpoint`` is set and :meth:`maybe_resume`
        has not run yet, and closes the prompt iterator at the end.

        The preemption handler holds SIGTERM/SIGINT for the duration of the
        loop (an emergency checkpoint at the next step boundary, then
        :class:`~trlx_tpu_torch.resilience.TrainingPreempted`); any
        exception (a crash, the update guard's halt, a preemption) closes
        the profiler window, dumps the flight recorder, exports the span
        trace and flushes the tracker before it propagates, so a dying run
        keeps its stats and its last moments. With ``serve.enabled`` the
        serving frontend starts before the loop and drains on every way out
        of it."""
        self.prepare_learning()
        self.maybe_resume()
        try:
            self._maybe_start_serving()
            with self.resilience.preemption:
                return self._learn_loop()
        except BaseException as e:
            self._shutdown_observability(reason=f"{type(e).__name__}: {e}")
            raise
        finally:
            self._shutdown_serving()
            self._shutdown_collectors()

    def _export_observability(self) -> None:
        """Span export (``trace.json`` + ``spans.jsonl``) beside the
        tracker's stats; a failed export never fails a run."""
        try:
            paths = self.obs.export()
            if paths:
                logger.info("wrote span trace: %s", paths["trace"])
        except Exception as e:  # pragma: no cover - defensive
            logger.warning("span trace export failed: %s", e)

    def _shutdown_observability(self, reason: Optional[str] = None) -> None:
        """Close the profiler window, export the span trace and flush the
        tracker, never raising; a ``reason`` (a crash path) also dumps the
        flight recorder (``flightrec.json``)."""
        try:
            self.obs.profile.stop()
        except Exception:  # pragma: no cover - defensive, crash path
            pass
        if reason is not None:
            self.obs.dump_flight_record(reason=reason)
        self._export_observability()
        try:
            self.tracker.finish()
        except Exception:  # pragma: no cover - defensive, crash path
            pass

    def _triage_extra(self, arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Derived per-token quantities to keep with a triaged batch (PPO
        adds advantages, returns and logprob deltas); best effort."""
        return {}

    def _dump_triage(self, reason: str, stats: Dict[str, Any]) -> Optional[str]:
        """Write the current batch as ``triage/step<N>.npz`` beside the
        trace exports, so a bad update can be replayed offline: its first
        ``TRIAGE_MAX_ROWS`` rows, the trainer's derived quantities and a
        ``__meta__`` record (step, reason, finite scalar stats); at most
        ``TRIAGE_MAX_DUMPS`` files a run, written atomically, rank 0 only,
        never raising. Returns the path or None."""
        if process_index() != 0:
            return None
        directory = self.obs._trace_dir
        batch = self._last_batch_host
        if hasattr(batch, "_asdict"):
            batch = batch._asdict()
        if not directory or not isinstance(batch, dict) or self._triage_dumps >= TRIAGE_MAX_DUMPS:
            return None
        try:
            arrays: Dict[str, np.ndarray] = {}
            for key, value in batch.items():
                if hasattr(value, "shape") and getattr(value, "ndim", 0) > 0:
                    arrays[key] = np.asarray(value[:TRIAGE_MAX_ROWS])
            if not arrays:
                return None
            try:
                extra = self._triage_extra(arrays)
            except Exception:  # pragma: no cover - defensive, crash path
                extra = {}
            for key, value in extra.items():
                arrays.setdefault(key, np.asarray(value)[:TRIAGE_MAX_ROWS])
            meta = {"step": self.iter_count, "reason": reason,
                    "rows": int(next(iter(arrays.values())).shape[0]),
                    "stats": {k: float(v) for k, v in stats.items()
                              if isinstance(v, (int, float)) and np.isfinite(v)}}
            arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
            triage_dir = os.path.join(directory, "triage")
            os.makedirs(triage_dir, exist_ok=True)
            path = os.path.join(triage_dir, f"step{self.iter_count}.npz")
            tmp = path + ".tmp.npz"
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, path)
            self._triage_dumps += 1
            self.metrics.inc("health/triage_dumps")
            self.obs.flightrec.record("triage", {
                "step": self.iter_count, "reason": reason, "path": path,
                "keys": sorted(k for k in arrays if k != "__meta__")})
            logger.warning("triage batch dumped to %s (%s)", path, reason)
            return path
        except Exception:  # pragma: no cover - defensive, crash path
            logger.warning("triage dump failed", exc_info=True)
            return None

    def _maybe_start_serving(self) -> None:
        """Stand up the serving frontend (``serve.enabled``): a serving
        engine of its own (``serve.slots`` slots, the evaluation generation
        settings with ``serve.max_new_tokens``, the prefix cache and chunks
        of ``engine:``), tenant quotas, the host tier when
        ``serve.host_tier_blocks > 0``, and ``ServeServer``; the first
        weights copy is published before the HTTP listener starts, so every
        admitted request is stamped with a version."""
        cfg = self.config.serve
        if not cfg.enabled or self._serve is not None:
            return
        from trlx_tpu_torch.serve.server import ServeServer
        from trlx_tpu_torch.serve.tiering import HostTier

        gen_kwargs = {}
        if int(cfg.max_new_tokens) > 0:
            gen_kwargs["max_new_tokens"] = int(cfg.max_new_tokens)
        gen_config, extra_kwargs = self._resolve_gen_config(eval_mode=True, **gen_kwargs)
        weights = self._serve_params_copy()
        engine = self._cb_make_engine(gen_config, extra_kwargs, int(cfg.slots), 1,
                                      tag="serve", params=weights, version=self.iter_count)
        engine.reserve_slots = int(cfg.reserve_slots)
        for tenant, blocks in (cfg.tenant_quota_blocks or {}).items():
            engine.allocator.set_tenant_quota(str(tenant), int(blocks))
        if int(cfg.host_tier_blocks) > 0 and engine.host_tier is None:
            engine.attach_host_tier(HostTier(int(cfg.host_tier_blocks),
                                             block_bytes=block_bytes(engine.state.cache)))
        slo_s = {k: float(v) for k, v in (("interactive", cfg.slo_interactive_s),
                                          ("eval", cfg.slo_eval_s),
                                          ("actor", cfg.slo_actor_s)) if float(v) > 0}
        self._serve = ServeServer(
            engine, default_tenant=cfg.default_tenant, default_class=cfg.default_class,
            slo_s=slo_s, max_queue=int(cfg.max_queue), stream_buffer=int(cfg.stream_buffer),
            drain_timeout_s=float(cfg.drain_timeout_s),
            retain_param_versions=int(cfg.retain_param_versions),
            default_max_new_tokens=int(cfg.max_new_tokens),
        )
        self._serve.publish(self._engine_params(weights), version=self.iter_count)
        self._serve.start(host=cfg.host, port=int(cfg.port))
        logger.info("serving frontend up on %s:%d (%d slots, classes %s)", cfg.host,
                    self._serve.port, int(cfg.slots), list(slo_s) or "un-SLO-gated")

    def _serve_params_copy(self) -> Any:
        """A copy of the policy that later optimizer steps do not touch:
        the serving engine must never read the live weights (they change
        in place under it), and ``serve.retain_param_versions`` keeps old
        copies readable after any number of updates. Parameters only (no
        gradients), frozen, in eval mode."""
        weights = copy.deepcopy(self.model)
        weights.requires_grad_(False)
        return weights.eval()

    def _shutdown_serving(self) -> None:
        """Drain the serving frontend (new admissions 503, in-flight
        requests get ``serve.drain_timeout_s``, both serve threads joined).
        Never raises."""
        serve, self._serve = self._serve, None
        if serve is not None:
            try:
                serve.drain()
            except Exception:  # pragma: no cover - defensive teardown
                logger.warning("serve drain failed", exc_info=True)

    def _close_prompt_iterator(self) -> None:
        """Close the prompt iterator at the end of learning, which stops
        its prefetch worker (a collection after ``learn`` needs a fresh
        ``add_prompt_pipeline``)."""
        iterator = getattr(self, "prompt_iterator", None)
        if iterator is not None and hasattr(iterator, "close"):
            iterator.close()

    def _maybe_prefetch(self, loader, depth: Optional[int] = None):
        """``loader`` collated ``depth`` batches ahead on a background
        thread (default ``train.prefetch_batches``; 0 leaves it as it is)."""
        if depth is None:
            depth = int(self.config.train.prefetch_batches or 0)
        if depth > 0 and loader is not None:
            return PrefetchLoader(loader, depth)
        return loader

    def _maybe_prefetch_prompts(self, loader):
        """The prompt loader prefetched ``train.rollout_pipeline_depth``
        chunks ahead: one worker keeps the order, so the rollouts do not
        change."""
        return self._maybe_prefetch(loader, int(self.config.train.rollout_pipeline_depth or 0))

    def _count_prompt_chunks(self, iterator):
        """Count every prompt chunk the trainer draws into
        ``_prompt_chunks_drawn``: a checkpoint records the count, and a
        resume draws and drops that many, so the prompt stream (and the
        loader's per-epoch shuffle behind it) sits where the uninterrupted
        run has it."""
        for chunk in iterator:
            self._prompt_chunks_drawn += 1
            yield chunk

    def _checkpoint_path(self) -> str:
        width = len(str(self.total_steps))
        return os.path.join(self.config.train.checkpoint_dir,
                            f"checkpoint_{self.iter_count:0{width}d}")

    def _check_faults_and_preemption(self) -> None:
        """The step-boundary seam, before every update: deliver the fault
        plan's signals for this step (the installed handler runs at once,
        so the request is honoured at this boundary) and, while serving,
        its ``request_flood`` drill; publish the current weights to the
        serving frontend; then honour a preemption request: stop the
        prefetch workers, wait for the card, commit one emergency
        checkpoint and raise
        :class:`~trlx_tpu_torch.resilience.TrainingPreempted`. The fault
        plan's ``flightrec_dump`` dumps the flight recorder here and its
        ``health_trip`` arms a trip the step's health update takes; the
        cluster beat exchanges the last step's scalars (and the preemption
        flag) across ranks."""
        plan = self.resilience.plan
        if plan:
            if plan.poll("sigterm", step=self.iter_count):
                signal.raise_signal(signal.SIGTERM)
            if plan.poll("sigint", step=self.iter_count):
                signal.raise_signal(signal.SIGINT)
            # every rank polls (lockstep counters) and process 0 alone is
            # signalled: the coordinated flag below carries it to the peers
            if plan.poll("sigterm_one_proc", step=self.iter_count) and process_index() == 0:
                signal.raise_signal(signal.SIGTERM)
            if plan.poll("flightrec_dump", step=self.iter_count):
                # the crash path's dump, without a crash
                self.obs.dump_flight_record(
                    reason=f"fault plan: flightrec_dump@step:{self.iter_count}")
            if plan.poll("health_trip", step=self.iter_count):
                # this step's health update takes it: flight record, triage
                self.obs.health.force_trip("fault_plan", step=self.iter_count)
            if self._serve is not None and plan.poll("request_flood", step=self.iter_count):
                # the admission drill: a synthetic burst through the real
                # gate must shed load with 429s
                rejected = self._serve.flood_drill()
                logger.warning("request_flood drill at step %d: %d synthetic requests shed "
                               "by admission", self.iter_count, rejected)
        if self._serve is not None:
            # serve-while-training: every step boundary publishes the current
            # weights; the pump adopts them at its next serve-idle point, so
            # every response is generated under one version
            self._serve.publish(self._engine_params(self._serve_params_copy()),
                                version=self.iter_count)
        preemption = self.resilience.preemption
        requested = preemption.requested
        coordinate = self.resilience.config.coordinate_preemption
        if self.obs.cluster.enabled or coordinate:
            # one gather carries the preemption flag and the per-rank
            # scalars; local when one process runs
            requested_any = coordinate_preemption(
                requested, beat=lambda flag: self.obs.cluster.beat(
                    flag, step=self.iter_count, collective=coordinate))
            if coordinate:
                requested = requested_any
        if not requested:
            return
        if not preemption.requested:  # a peer was signalled
            preemption.request("peer preemption (coordinated)")
        self.obs.flightrec.record("resilience", {
            "event": "preemption", "signal": preemption.signal_received,
            "step": self.iter_count})
        path = self._checkpoint_path()
        logger.warning("preemption (%s): writing emergency checkpoint to %s",
                       preemption.signal_received, path)
        self._shutdown_collectors()
        _sync(self.device)
        self.save(path, emergency=True)
        raise TrainingPreempted(
            f"preempted by {preemption.signal_received}; emergency checkpoint committed at "
            f"{path} — relaunch with train.resume_from_checkpoint to continue",
            checkpoint_dir=path)

    def _shutdown_collectors(self) -> None:
        """Stop the background experience collectors (PPO's async actors
        override this and chain back here), then the prefetch workers. The
        actors go first: they draw from the prompt iterator."""
        self._stop_prefetch()

    def _stop_prefetch(self) -> None:
        """Stop the train-batch and prompt prefetch workers (closing their
        generators cancels them between batches)."""
        if hasattr(self._batch_iter, "close"):
            self._batch_iter.close()
        self._batch_iter = None
        self._close_prompt_iterator()

    def _learn_loop(self) -> Dict[str, Any]:  # noqa: C901
        # an emergency checkpoint froze the run between two updates: the
        # loop fast-forwards to that boundary, running no update, evaluation
        # or callback that came before it (JAX's emergency resume); an
        # offline trainer resumed from an interval checkpoint at update k
        # skips its k updates too (a skipped epoch burns its shuffle), while
        # a rollout trainer resumes into a fresh collection
        emergency = self._emergency_resume
        self._emergency_resume = False
        skip = self.iter_count if emergency or not self.collects_rollouts else 0
        done = 0
        if emergency:
            results: Dict[str, Any] = {}
            logger.info("emergency resume: fast-forwarding to update %d", skip)
        else:
            results = self.evaluate()
            self.tracker.log(results, step=self.iter_count)
        profile = self.obs.profile
        for _ in range(self.config.train.epochs):
            per_epoch = len(self.train_dataloader) * self.n_updates_per_batch if skip else 0
            if done < skip and done + per_epoch <= skip:
                done += per_epoch
                # a rollout trainer builds a fresh loader per collection
                if not self.collects_rollouts:
                    self.train_dataloader.advance_epoch()
                continue
            epoch_ran = False
            self._batch_iter = iter(self._maybe_prefetch(self.train_dataloader))
            for batch in self._batch_iter:
                batch_ran = False
                for _ in range(self.n_updates_per_batch):
                    if done < skip:
                        done += 1
                        continue
                    batch_ran = epoch_ran = True
                    self._check_faults_and_preemption()
                    profile.on_step_start(self.iter_count)
                    counted = self._train_step_flops is None  # this step counts FLOPs
                    with profile.step_annotation("train", self.iter_count):
                        with self.obs.span("train_step") as sp:
                            device_stats = self.train_step(batch)
                            # waits on one CUDA event after the update's
                            # kernels: the duration is the card's
                            sp.fence(device_stats)
                    host = host_stats(device_stats)  # one copy, sketches included
                    stats = filter_non_scalars(host)
                    # the sketch histograms as dist/* gauges, before the
                    # filtered stats drop them
                    stats.update(self.obs.dynamics.summarize(host))
                    # a rejected update: triage the batch before any rollback
                    if stats.get(UPDATE_OK_KEY) == 0.0:
                        if self._dump_triage("update_guard", stats):
                            self.obs.dump_flight_record(
                                reason=f"update guard rejected step {self.iter_count}")
                    # the update guard: skip already kept the old state,
                    # rollback and halt are host decisions
                    if self.resilience.guard.after_step(stats) == "rollback":
                        self._rollback_to_committed()
                    step_time = sp.duration
                    stats["time/step"] = step_time
                    stats["time/train_step"] = step_time
                    items = batch._asdict() if hasattr(batch, "_asdict") else batch
                    batch_size = next((v.shape[0] for v in items.values() if hasattr(v, "shape")),
                                      self.config.train.batch_size)
                    # the counted step ran under the FLOP counter's per-op
                    # dispatch: no MFU from its time
                    stats.update(self.obs.throughput.step_stats(
                        step_time, tokens=self._batch_token_count(batch), samples=batch_size,
                        flops_per_device=None if counted else self._step_flops()))
                    stats.update(self.obs.memory.collect())
                    # feeds the next boundary's cluster beat
                    self.obs.cluster.note_step(
                        step_time, tokens_per_sec=stats.get("throughput/tokens_per_sec", 0.0),
                        device_bytes=stats.get("memory/device_bytes_in_use",
                                               stats.get("memory/host_rss_bytes", 0.0)))
                    # the collective fleet's membership rides the same beat
                    # (None off-fleet)
                    collector = getattr(self, "_async", None)
                    if collector is not None:
                        self.obs.cluster.note_fleet(collector.fleet_size())
                    self.obs.note_dropped_spans()
                    stats.update(self.metrics.snapshot())
                    if self._serve is not None:
                        stats.update(self._serve.flat_metrics())
                    # the windowed health detectors; a trip dumps the batch
                    # and the flight record
                    stats.update(self.obs.health.update(stats, step=self.iter_count))
                    tripped = self.obs.health.just_tripped
                    if tripped is not None:
                        if self._dump_triage(f"health:{tripped}", stats):
                            # this step's snapshot is already taken
                            stats["health/triage_dumps"] = float(self._triage_dumps)
                        self.obs.dump_flight_record(
                            reason=f"health_trip: {tripped} @ step {self.iter_count}")
                    self.obs.flightrec.record("step", {"iter": self.iter_count, "stats": stats})
                    profile.on_step_end(self.iter_count)
                    self.iter_count += 1

                    if self.iter_count % self.config.train.checkpoint_interval == 0:
                        # the retention ring prunes before the interval save
                        keep = int(self.resilience.config.keep_last_n)
                        if keep > 0 and process_index() == 0:
                            prune_checkpoints(self.config.train.checkpoint_dir, keep)
                        self.save(self._checkpoint_path())
                    if self.iter_count % self.config.train.eval_interval == 0:
                        results = self.evaluate()
                        stats.update(results)
                        if self.config.train.save_best:
                            reward = stats.get("reward/mean",
                                               stats.get("metrics/reward", -float("inf")))
                            if reward > self.best_reward:
                                self.best_reward = reward
                                self.save(os.path.join(self.config.train.checkpoint_dir,
                                                       "best_checkpoint"))
                    logger.info(" | ".join(f"{k}: {significant(v)}" for k, v in stats.items()
                                           if k.startswith("losses/")))
                    if self.iter_count >= self.total_steps:
                        profile.stop()
                        flops = self._step_flops()
                        if flops and "throughput/mfu" not in stats:
                            stats["throughput/mfu"] = obs_mfu(flops, step_time,
                                                              self.obs.throughput.peak)
                        self._drop_batch_memo()
                        results = self.evaluate()
                        stats.update(results)
                        stats.update(self.obs.throughput.summary())
                        self.tracker.log(stats, step=self.iter_count)
                        self.save(self._checkpoint_path())
                        self._export_observability()
                        self.tracker.finish()
                        return results
                    self.tracker.log(stats, step=self.iter_count)
                # batches an emergency resume fast-forwarded had their
                # callback before the checkpoint
                if batch_ran or not emergency:
                    self.post_backward_callback()
            if epoch_ran or not emergency:
                self._drop_batch_memo()
                self.post_epoch_callback()
        profile.stop()
        self._export_observability()
        self.tracker.finish()
        return results

    def _rollback_to_committed(self) -> None:
        """The update guard's rollback: restore the newest committed
        checkpoint's train state and host state, keeping the loop's
        position (the poisoned batch is skipped, not retried). Without a
        committed checkpoint the update has landed and nothing sane is left
        to continue from: it raises."""
        root = self.config.train.checkpoint_dir
        path = newest_committed_checkpoint(root)
        if path is None:
            raise NonFiniteUpdateError(
                f"non-finite update with update_guard='rollback' but no committed checkpoint "
                f"exists under {root} to restore — halting (lower "
                "train.checkpoint_interval, or use 'skip')")
        cur_iter, cur_best = self.iter_count, self.best_reward
        self.load(path, restore_payload=False)
        self.iter_count, self.best_reward = cur_iter, cur_best
        self._drop_batch_memo()
        self.obs.flightrec.record("resilience", {"event": "rollback", "checkpoint": path,
                                                 "step": self.iter_count})
        logger.warning("rolled back train state to %s", path)

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def _extra_checkpoint_state(self) -> Dict[str, Any]:
        return {}

    def _restore_extra_checkpoint_state(self, extra: Dict[str, Any]) -> None:
        pass

    def _emergency_payload(self) -> Dict[str, Any]:
        """Host data an exact mid-run resume needs beyond the train state
        (PPO and GRPO: the rollout store), as tensors and plain values."""
        return {}

    def _restore_emergency_payload(self, payload: Dict[str, Any]) -> None:
        pass

    def _rng_state(self) -> Dict[str, Any]:
        """The rollout seed stream and torch's generators, as tensors and
        plain numbers (loadable with ``weights_only``)."""
        name, keys, pos, has_gauss, cached = self._rollout_seeds.get_state()
        state = {"rollout_seeds": {"name": name, "keys": torch.as_tensor(keys.astype(np.int64)),
                                   "pos": int(pos), "has_gauss": int(has_gauss),
                                   "cached_gaussian": float(cached)},
                 "torch": torch.get_rng_state()}
        if self.device.type == "cuda":
            state["torch_cuda"] = torch.cuda.get_rng_state(self.device)
        return state

    def _restore_rng_state(self, state: Dict[str, Any]) -> None:
        seeds = state["rollout_seeds"]
        self._rollout_seeds.set_state((seeds["name"], seeds["keys"].numpy().astype(np.uint32),
                                       seeds["pos"], seeds["has_gauss"],
                                       seeds["cached_gaussian"]))
        torch.set_rng_state(state["torch"])
        if "torch_cuda" in state and self.device.type == "cuda":
            torch.cuda.set_rng_state(state["torch_cuda"], self.device)

    def save(self, directory: Optional[str] = None, emergency: bool = False,
             **kwargs) -> None:
        """Commit model, optimizer, step and the trainer's host state (its
        extra state, the rollout seed stream, torch's generators and the
        prompt-stream position) into ``directory/state.pt``
        (``utils/checkpoint.py``: staged file, marker, rename).
        ``emergency=True`` (preemption) also freezes the evaluation count
        and the trainer's payload (the rollout store), so a resumed run
        continues bitwise from this step boundary."""
        directory = directory or self.config.train.checkpoint_dir
        extra = {"iter_count": self.iter_count, "best_reward": self.best_reward,
                 "prompt_chunks_drawn": self._prompt_chunks_drawn}
        extra.update(self._extra_checkpoint_state())
        if emergency:
            extra.update(emergency=True, nth_evaluation=self.nth_evaluation,
                         payload=self._emergency_payload())
        model_sd, optim_sd = self._full_state()
        # the topology this state was saved from (resilience/elastic.py)
        manifest = build_manifest(self.model, self.mesh, self.device.type)
        if process_index() == 0:
            save_state(directory, {"model": model_sd, "optimizer": optim_sd,
                                   "step": self.step, "extra": extra,
                                   "rng": self._rng_state()}, manifest=manifest)
        self._barrier()

    def _full_state(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``(model, optimizer)`` state in the one-device format: under the
        mesh gathered onto rank 0 (``utils/checkpoint.py::
        gather_full_state``, a collective; other ranks get empty dicts)."""
        if self.mesh is None:
            return self.model.state_dict(), self.optimizer.state_dict()
        return gather_full_state(self.model, self.optimizer)

    def _barrier(self) -> None:
        """Under the mesh, every rank waits here for rank 0's writes."""
        if self.mesh is not None:
            import torch.distributed as dist

            dist.barrier()

    def save_pretrained(self, directory: Optional[str] = None, **kwargs) -> None:
        """Export the policy (``utils/checkpoint.py::save_pretrained``): the
        port's dump and, for an HF family, a ``transformers``-loadable
        directory with the heads merged; ``<checkpoint_dir>/hf_model`` by
        default, the tokenizer's files copied when its path is a
        directory."""
        model_sd = self._full_state()[0]
        if process_index() == 0:
            save_pretrained(directory or f"{self.config.train.checkpoint_dir}/hf_model",
                            model_sd, self.tcfg,
                            tokenizer_path=self.config.tokenizer.tokenizer_path)
        self._barrier()

    def push_to_hub(self, repo_id: str, **kwargs) -> Optional[str]:
        """Publish the current policy to the HF Hub: a full
        :meth:`save_pretrained` export staged locally, then uploaded in one
        call (``utils/checkpoint.py::push_to_hub``, whose ``uploader=``
        replaces the network step). Under a mesh the full weights are
        gathered onto rank 0, which alone writes and uploads (JAX's rank-0
        rule); the other ranks wait at the barrier and return None."""
        kwargs.setdefault("tokenizer_path", self.config.tokenizer.tokenizer_path)
        model_sd = self._full_state()[0]
        url = None
        try:
            if process_index() == 0:
                url = push_to_hub(repo_id, model_sd, self.tcfg, **kwargs)
        finally:
            self._barrier()
        return url

    def load(self, directory: Optional[str] = None, restore_payload: bool = True,
             **kwargs) -> None:
        """Restore a committed checkpoint: weights, optimizer, step and the
        host state; with ``restore_payload`` (a resume) also the rollout
        seed stream, an emergency checkpoint's payload (so ``learn()``
        fast-forwards to its boundary) and the prompt stream, fast-forwarded
        to the drawn count it records. The update guard's rollback passes
        ``restore_payload=False``: its prompt and seed streams are live and
        go on."""
        directory = directory or self.config.train.checkpoint_dir
        # the one restore entry (resilience/elastic.py): the topology
        # manifest decides between the per-rank load and the reshard
        state = restore_state_elastic(directory, self.model, self.optimizer, mesh=self.mesh,
                                      elastic=self.resilience.config.elastic,
                                      metrics=self.metrics, device_type=self.device.type)
        self._weights_version += 1
        self.step = int(state["step"])
        extra = state["extra"]
        self.iter_count = int(extra.get("iter_count", 0))
        self.best_reward = float(extra.get("best_reward", self.best_reward))
        self._restore_extra_checkpoint_state(extra)
        if not restore_payload:
            return
        self._restore_rng_state(state["rng"])
        if extra.get("emergency"):
            self._emergency_resume = True
            self.nth_evaluation = int(extra.get("nth_evaluation", self.nth_evaluation))
            self._restore_emergency_payload(extra.get("payload", {}))
        # replay the prompt stream: draw and drop until this run's fresh
        # iterator has drawn what the saved run had
        target = int(extra.get("prompt_chunks_drawn", 0))
        iterator = getattr(self, "prompt_iterator", None)
        if iterator is not None and target > self._prompt_chunks_drawn:
            logger.info("resume: fast-forwarding the prompt stream by %d chunks",
                        target - self._prompt_chunks_drawn)
            while self._prompt_chunks_drawn < target:
                next(iterator)

    def maybe_resume(self) -> None:
        """With ``train.resume_from_checkpoint``, load the newest committed
        ``checkpoint_<step>`` under ``train.checkpoint_dir``; a partial
        directory (a crash mid-save) is skipped with a warning. Runs once:
        ``train()`` calls it before the first collection (the rollouts
        must come from the restored policy) and ``learn()`` again for a
        trainer driven directly.

        A checkpoint written where a collection follows (the last update
        of a store) resumes into the uninterrupted run's trajectory: the
        seed stream, the prompt stream, the KL controller and the running
        moments are restored. The evaluations draw from the seed stream
        too, so an evaluation between that checkpoint and the next
        collection, or an adaptive KL controller's update after the
        store's last batch, would fork the two runs (as in the JAX
        package)."""
        if self._resume_done:
            return
        self._resume_done = True
        if not self.config.train.resume_from_checkpoint:
            return
        candidates = []
        for _step, path in _checkpoint_step_dirs(self.config.train.checkpoint_dir):
            if is_committed(path):
                candidates.append(path)
            else:
                logger.warning("skipping uncommitted checkpoint %s (a crash mid-save?); the "
                               "newest committed checkpoint wins", path)
        if not candidates:
            return
        logger.info("Resuming training state from %s", candidates[-1])
        self.load(candidates[-1])
