"""Shared trainer of the port: model and optimizer set-up, the train step,
generation through the paged engine, evaluation, the learn loop and
checkpoints.

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
  the update;
- rollouts and evaluation generate through the paged
  ``ContinuousEngine`` (``engine/core.py``) on the CUDA kernels; with
  ``engine.speculative: k`` and ``model.draft_model_path`` its segments
  run draft-propose → verify → accept rounds, the draft a bare LM built
  from ``train.seed + 1``;
- ``learn`` runs the JAX loop (epochs → batches → updates per batch,
  interval and final checkpoints, interval and final evaluation) without
  its observability, resilience and serving hooks;
- ``save`` writes one ``torch.save`` file of model, optimizer, step and
  the trainer's extra state, at the JAX loop's save points.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
``train.rollout_pipeline_depth`` and ``train.prefetch_batches`` only
overlap host and device work (the JAX package pins their results as equal
at any depth); the port runs both at depth 0 and says so once.
"""

import dataclasses
import logging
import os
import time
from abc import abstractmethod
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.data.tokenizer import from_config as tokenizer_from_config
from trlx_tpu_torch.engine.core import ContinuousEngine
from trlx_tpu_torch.models.builder import build_causal_lm, trainable_mask
from trlx_tpu_torch.models.transformer import config_from_spec
from trlx_tpu_torch.ops.kernel_utils import resolve_device
from trlx_tpu_torch.ops.paged_kv import PagedSpec, num_table_blocks
from trlx_tpu_torch.ops.sampling import GenerationConfig
from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns
from trlx_tpu_torch.trainer import BaseRLTrainer
from trlx_tpu_torch.utils import (
    filter_non_scalars,
    get_optimizer,
    get_scheduler,
    significant,
)

logger = logging.getLogger(__name__)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

# parallel axes of the JAX mesh: the port runs on one device
_PARALLEL_AXES = ("fsdp", "pipe", "model", "sequence", "expert", "dcn_data_parallelism")


def validate_speculative(config) -> None:
    """The JAX trainer's speculative-engine checks, each its own error:
    ``engine.speculative >= 0``, a draft model, the paged backend."""
    k = int(config.engine.speculative)
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
    if config.engine.backend != "paged":
        raise ValueError(
            "engine.speculative requires engine.backend: paged — the verify pass "
            "commits accepted K/V through the block table with drop-mode writes"
        )


def reject_unported(config, collects_rollouts: bool) -> None:
    """Raise ``ValueError`` naming the first setting this slice does not
    run (gradient accumulation, parallel axes, scanned or rematerialised
    layers, seq2seq, LoRA, resume, a tracker, serving inside a trainer).

    ``collects_rollouts`` (PPO) adds the rollout settings: the serial
    dense rollout path — which also holds the serial speculative sampler
    —, async collection, the engine's prefix cache / chunked prefill /
    gather kernels and the staged loss. The offline trainers (SFT, ILQL)
    collect nothing: the JAX package evaluates them on its serial dense
    engine whatever ``engine:`` says, and the port on the paged engine
    with its kernels, so those settings do not reach them."""
    t, e, m, par, res = (config.train, config.engine, config.model, config.parallel,
                         config.resilience)
    checks = []
    if collects_rollouts:
        loss_kernel = getattr(config.method, "loss_kernel", None)
        checks += [
            (not t.continuous_batching, "train.continuous_batching: false (the serial dense "
             "rollout path) is not ported; the port collects through the paged engine"),
            (config.async_rl.enabled, "async_rl.enabled: async collection is not ported"),
            (e.backend != "paged", f"engine.backend {e.backend!r}: the port's engine is paged"),
            (e.prefix_cache, "engine.prefix_cache: the prefix cache is not ported"),
            (int(e.prefill_chunk) != 0, "engine.prefill_chunk: chunked prefill is not ported"),
            (e.decode_kernel != "pallas", f"engine.decode_kernel {e.decode_kernel!r}: the "
             "port runs the paged-decode kernel ('pallas'); the gather path is not ported"),
            (e.prefill_kernel != "pallas", f"engine.prefill_kernel {e.prefill_kernel!r}: the "
             "port runs the paged-prefill kernel ('pallas'); the gather path is not ported"),
            (loss_kernel != "pallas", f"method.loss_kernel {loss_kernel!r}: the port runs the "
             "fused PPO loss kernels ('pallas'); the staged loss path is not ported"),
        ]
    checks += [
        (config.serve.enabled, "serve.enabled: serving inside a trainer is not ported"),
        (int(t.grad_accum) > 1, "train.grad_accum > 1: gradient accumulation is not ported"),
        (int(par.data) not in (-1, 1), "parallel.data > 1: the port runs on one device"),
        (par.scan_layers, "parallel.scan_layers: scanned layers are not ported"),
        (par.remat != "none", f"parallel.remat {par.remat!r}: rematerialisation is not ported"),
        (m.model_arch_type != "causal",
         f"model.model_arch_type {m.model_arch_type!r}: seq2seq is not ported"),
        (bool(m.peft_kwargs), "model.peft_kwargs: LoRA/PEFT is not ported"),
        (t.resume_from_checkpoint, "train.resume_from_checkpoint: checkpoint load and "
         "resume are not ported"),
        (t.tracker is not None, f"train.tracker {t.tracker!r}: the port logs to an "
         "in-memory tracker only (tracker: null)"),
        (t.profile_dir is not None, "train.profile_dir: profiler traces are not ported"),
        (t.rollout_logging_dir is not None, "train.rollout_logging_dir: rollout export is "
         "not ported"),
        (res.update_guard != "off", f"resilience.update_guard {res.update_guard!r}: the "
         "update guard is not ported"),
        (res.fault_plan is not None, "resilience.fault_plan: fault injection is not ported"),
    ]
    checks += [
        (int(getattr(par, axis)) > 1, f"parallel.{axis} > 1: the port runs on one device")
        for axis in _PARALLEL_AXES
    ]
    for bad, message in checks:
        if bad:
            raise ValueError(message)


class MemoryTracker:
    """The ``tracker: null`` sink: keeps every logged stats dict in
    :attr:`history` as ``(step, stats)``."""

    def __init__(self):
        self.history: List[Tuple[int, Dict[str, Any]]] = []

    def log(self, stats: Dict[str, Any], step: int) -> None:
        self.history.append((int(step), dict(stats)))

    def finish(self) -> None:
        pass


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_stats(stats: Dict[str, Any]) -> Dict[str, float]:
    """Scalar stats as floats, fetched from the device in one copy;
    non-scalar entries (the sketch histograms) are dropped."""
    scalars = {k: v for k, v in stats.items()
               if isinstance(v, torch.Tensor) and v.numel() == 1}
    out = filter_non_scalars({k: v for k, v in stats.items()
                              if not isinstance(v, torch.Tensor)})
    if scalars:
        vals = torch.stack([v.detach().reshape(()).float() for v in scalars.values()]).cpu()
        out.update(zip(scalars, vals.tolist()))
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
        validate_speculative(config)
        reject_unported(config, self.collects_rollouts)
        depths = {k: int(getattr(config.train, k) or 0)
                  for k in ("rollout_pipeline_depth", "prefetch_batches")}
        if any(depths.values()):
            logger.info(
                "train.rollout_pipeline_depth / train.prefetch_batches %s only overlap host "
                "and device work; the port runs both at depth 0", depths,
            )
        self.device = resolve_device(device)
        self.tokenizer = tokenizer_from_config(config.tokenizer)

        overrides = dict(config.model.model_extra_kwargs or {})
        overrides.setdefault("param_dtype", DTYPES[config.parallel.param_dtype])
        overrides.setdefault("dtype", DTYPES[config.parallel.compute_dtype])
        self.model, self.tcfg = build_causal_lm(
            config.model.model_path, seed=config.train.seed, device=self.device,
            head=self.model_head, two_qs=getattr(config.method, "two_qs", True), **overrides,
        )
        self.draft_model, self.draft_tcfg = None, None
        if config.model.draft_model_path:
            # a bare LM, randomly initialised from train.seed + 1
            draft_overrides = dict(config.model.draft_model_extra_kwargs or {})
            draft_overrides.setdefault("param_dtype", overrides["param_dtype"])
            draft_overrides.setdefault("dtype", overrides["dtype"])
            vocab = config_from_spec(config.model.draft_model_path,
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
        self.param_mask = trainable_mask(self.model, self.tcfg, config.model.num_layers_unfrozen)
        self.schedule = get_scheduler(config.scheduler.name, dict(config.scheduler.kwargs),
                                      default_lr=config.optimizer.kwargs.get("lr"))
        self.optimizer = get_optimizer(
            config.optimizer.name, dict(config.optimizer.kwargs),
            [p for n, p in self.model.named_parameters() if self.param_mask[n]],
        )
        self.step = 0  # optimizer updates taken (the JAX TrainState.step)
        # per-row sampling seeds of the rollout and eval engines
        self._rollout_seeds = np.random.RandomState(config.train.seed)

        self.generate_kwargs = dict(config.method.gen_kwargs)
        self.generate_experience_kwargs = (
            dict(config.method.gen_experience_kwargs)
            if getattr(config.method, "gen_experience_kwargs", None) else None
        )
        self._generate_fns: Dict[Any, Any] = {}
        self._warned_cb_draft = False
        self.last_generate_stats: Dict[str, float] = {}  # the last generate's engine stats
        self._last_batch_host: Any = None
        self._last_batch_device: Any = None
        self.tracker = MemoryTracker()
        self.eval_pipeline = None
        self.iter_count = 0
        self.nth_evaluation = 0
        self.best_reward = -float("inf")

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
        arrays = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                  for k, v in items.items() if hasattr(v, "ndim")}
        self._last_batch_host, self._last_batch_device = batch, arrays
        return arrays

    def _drop_batch_memo(self) -> None:
        self._last_batch_host = self._last_batch_device = None

    def train_step(self, batch) -> Dict[str, Any]:
        """One optimization step on a host batch; returns device stats."""
        arrays = self._device_batch(batch)
        self.model.zero_grad(set_to_none=True)
        loss, stats = self.loss_fn(arrays)
        loss.backward()
        gnorm = torch.nn.utils.get_total_norm(
            [p.grad for p in self.model.parameters() if p.grad is not None])
        lr = float(self.schedule(self.step))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        stats = dict(stats)
        stats["learning_rate"] = lr
        stats["gradients/global_norm"] = gnorm
        return stats

    @staticmethod
    def _batch_token_count(batch) -> int:
        items = batch._asdict() if hasattr(batch, "_asdict") else batch
        return int(sum(np.asarray(v).sum() for k, v in items.items()
                       if k.endswith("mask") and hasattr(v, "sum")))

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

    def _resolve_paged_spec(self, batch_size: int, prompt_len: int, gen_config,
                            gamma: int = 0) -> PagedSpec:
        """The pool geometry of ``engine:``; ``max_kv_blocks: 0`` sizes the
        pool so every slot can reach full length. Speculative tables carry
        entries for the ``gamma`` probe columns past ``P + N`` too."""
        bs = int(self.config.engine.kv_block_size)
        if bs < 1:
            raise ValueError(f"engine.kv_block_size {bs} must be >= 1")
        max_blocks = int(self.config.engine.max_kv_blocks)
        if max_blocks <= 0:
            max_blocks = 1 + batch_size * num_table_blocks(
                prompt_len + gen_config.max_new_tokens + int(gamma), bs)
        return PagedSpec(block_size=bs, max_blocks=max_blocks)

    def _get_slot_refill_fns(self, gen_config, extra_kwargs, batch_size: int,
                             prompt_len: int, segment_len: int):
        """The slot-refill programs for one engine geometry (cached)."""
        gamma = int(self.config.engine.speculative)
        if gamma and self.draft_model is None:
            raise ValueError("engine.speculative requires model.draft_model_path (no "
                             "draft model was built)")
        if self.draft_model is not None and not gamma and not self._warned_cb_draft:
            self._warned_cb_draft = True
            logger.warning(
                "model.draft_model_path is set but engine.speculative is 0: the engine "
                "runs plain decode segments (set engine.speculative to propose k "
                "tokens per verify round)"
            )
        paged = self._resolve_paged_spec(batch_size, prompt_len, gen_config, gamma)
        key = ("slot_refill", gen_config, extra_kwargs, batch_size, prompt_len,
               segment_len, paged, gamma)
        if key not in self._generate_fns:
            self._generate_fns[key] = make_slot_refill_fns(
                self.tcfg, batch_size, prompt_len, gen_config,
                adjust_logits=self.adjust_logits_fn(dict(extra_kwargs)),
                segment_len=segment_len, paged=paged, device=self.device,
                speculative=gamma, draft_cfg=self.draft_tcfg if gamma else None,
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
                        tag: Any = None) -> ContinuousEngine:
        """The engine for ``rows`` slots, cached per shape bucket and reset
        for a fresh collection. Its prompt width is the trainer-level
        budget ``seq_length − max_new_tokens``, bumped to the chunk's
        collation width if a loader pads wider; narrower chunks left-pad."""
        seg = max(1, int(self.config.train.continuous_batching_segment or 8))
        engine_p = max(int(self.config.train.seq_length) - gen_config.max_new_tokens,
                       chunk_width)
        key = ("cb_engine", gen_config, extra_kwargs, rows, engine_p, seg, tag)
        engine = self._generate_fns.get(key)
        if engine is None:
            fns = self._get_slot_refill_fns(gen_config, extra_kwargs, rows, engine_p, seg)
            engine = ContinuousEngine(fns, self._engine_params(), self.tokenizer.pad_token_id)
            self._generate_fns[key] = engine
        engine.begin_collection(self._engine_params())
        return engine

    def _row_seeds(self, rows: int) -> np.ndarray:
        return self._rollout_seeds.randint(0, 2**31 - 1, size=rows).astype(np.int64)

    @torch.no_grad()
    def generate(self, input_ids: np.ndarray, attention_mask: Optional[np.ndarray] = None,
                 eval_mode: bool = False, **kwargs) -> Dict[str, np.ndarray]:
        """Sample continuations for a left-padded prompt batch through the
        paged engine. Returns host arrays ``response_tokens``,
        ``response_mask``, ``response_logprobs`` and ``response_values``
        (``[b, N]``, in the batch's row order)."""
        gen_config, extra = self._resolve_gen_config(eval_mode, **kwargs)
        input_ids = np.asarray(input_ids, np.int64)
        if attention_mask is None:
            attention_mask = (input_ids != self.tokenizer.pad_token_id).astype(np.int64)
        rows, width = input_ids.shape
        engine = self._cb_make_engine(gen_config, extra, rows, width,
                                      tag="eval" if eval_mode else "generate")
        engine.enqueue_prompts(input_ids, attention_mask, self._row_seeds(rows))
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
            for batch in loader:
                out = self.generate(batch["input_ids"], batch["attention_mask"],
                                    eval_mode=True, **overrides)
                for k, v in self.last_generate_stats.items():
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
        interval checkpoints, interval evaluation and best-reward saves."""
        self.prepare_learning()
        return self._learn_loop()

    def _checkpoint_path(self) -> str:
        width = len(str(self.total_steps))
        return os.path.join(self.config.train.checkpoint_dir,
                            f"checkpoint_{self.iter_count:0{width}d}")

    def _learn_loop(self) -> Dict[str, Any]:
        results = self.evaluate()
        self.tracker.log(results, step=self.iter_count)
        for _ in range(self.config.train.epochs):
            for batch in self.train_dataloader:
                for _ in range(self.n_updates_per_batch):
                    t0 = time.perf_counter()
                    device_stats = self.train_step(batch)
                    stats = host_stats(device_stats)  # one fetch; waits for the step
                    _sync(self.device)
                    step_time = time.perf_counter() - t0
                    stats["time/step"] = step_time
                    stats["throughput/tokens_per_sec"] = (
                        self._batch_token_count(batch) / step_time if step_time > 0 else 0.0)
                    self.iter_count += 1

                    if self.iter_count % self.config.train.checkpoint_interval == 0:
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
                        self._drop_batch_memo()
                        results = self.evaluate()
                        stats.update(results)
                        self.tracker.log(stats, step=self.iter_count)
                        self.save(self._checkpoint_path())
                        self.tracker.finish()
                        return results
                    self.tracker.log(stats, step=self.iter_count)
                self.post_backward_callback()
            self._drop_batch_memo()
            self.post_epoch_callback()
        self.tracker.finish()
        return results

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def _extra_checkpoint_state(self) -> Dict[str, Any]:
        return {}

    def save(self, directory: Optional[str] = None, **kwargs) -> None:
        """``torch.save`` of model, optimizer, step and the trainer's extra
        state into ``directory/state.pt``."""
        directory = directory or self.config.train.checkpoint_dir
        os.makedirs(directory, exist_ok=True)
        extra = {"iter_count": self.iter_count, "best_reward": self.best_reward}
        extra.update(self._extra_checkpoint_state())
        torch.save({"model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "step": self.step, "extra": extra},
                   os.path.join(directory, "state.pt"))
