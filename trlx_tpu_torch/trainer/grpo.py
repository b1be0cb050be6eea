"""GRPO trainer: group sampling, group-relative advantages, no value head.

Port of ``trlx_tpu/trainer/grpo.py`` (``GRPOTrainer``) for causal models.
The PPO trainer's rollout machinery is inherited — the serial dense
engine (plain, or speculative with ``model.draft_model_path``), the
scoring forward dispatched on the generation's device tensors, the hydra
reference branch — and what is learned from a rollout changes:

- each prompt is repeated ``group_size`` times in a row (group-contiguous);
- each sequence's scalar reward is normalised within its group
  (:func:`~trlx_tpu_torch.models.grpo.group_advantages_np`): no values, no
  GAE;
- the KL penalty against the frozen reference moves from reward shaping
  into the loss (:meth:`~trlx_tpu_torch.models.grpo.GRPOConfig.loss`), with
  a fixed coefficient ``method.beta``.

``make_experience`` dispatches as JAX's does: ``async_rl.enabled`` → the
actor/learner split (:meth:`GRPOTrainer._collect_async_grpo`: actors fan
each prompt batch out, generate serially under their weights snapshot and
score it, the learner finalizes in index order), else
``train.continuous_batching`` → the group-aware harvest on the paged
engine (:meth:`GRPOTrainer._grpo_collect_continuous`), anything else → the
serial path (:meth:`GRPOTrainer._grpo_collect_serial`). Async GRPO keeps
the serial generation path: with ``train.continuous_batching`` it is
refused at construction, as in JAX. GRPO has no pipelined path, so
``train.rollout_pipeline_depth`` only sets the prompt prefetch.
"""

from collections import deque
from time import perf_counter
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.data.grpo_types import GRPORLElement
from trlx_tpu_torch.models.grpo import BASELINES, GRPOConfig, group_advantages_np
from trlx_tpu_torch.parallel.sharding import unsharded
from trlx_tpu_torch.pipeline.grpo_pipeline import GRPORolloutStorage
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.base import HostCopy, logger
from trlx_tpu_torch.trainer.ppo import PPOTrainer
from trlx_tpu_torch.utils import infinite_loader
from trlx_tpu_torch.utils.stats import logprobs_of_labels


@register_trainer
class GRPOTrainer(PPOTrainer):
    model_head = None  # no value function

    def __init__(self, config, **kwargs):
        # the JAX construction checks, before the model is built
        if config.model.model_arch_type == "seq2seq":
            raise NotImplementedError("GRPO is implemented for causal LMs")
        method = config.method
        if not isinstance(method, GRPOConfig):
            raise ValueError("config.method must be GRPOConfig")
        if method.chunk_size % method.group_size:
            raise ValueError(f"chunk_size {method.chunk_size} must be a multiple of "
                             f"group_size {method.group_size}")
        if method.baseline not in BASELINES:
            raise ValueError(f"unknown method.baseline '{method.baseline}'; known: {BASELINES}")
        if config.async_rl.enabled and config.train.continuous_batching:
            raise NotImplementedError(
                "async_rl + train.continuous_batching is implemented for the PPO trainer "
                "only: GRPO's group-aware harvest keeps the single-program CB loop. Drop "
                "one of the two.")
        if method.baseline == "rloo":
            if method.group_size < 2:
                raise ValueError("baseline=rloo needs group_size >= 2")
            if method.scale_advantage:
                logger.warning("baseline=rloo ignores scale_advantage (RLOO is unscaled by "
                               "definition) — set method.scale_advantage: false to silence "
                               "this")
        super().__init__(config, **kwargs)
        self.store = GRPORolloutStorage(self.tokenizer.pad_token_id)

    def add_prompt_pipeline(self, pipeline) -> None:
        """One loader row fans out into ``group_size`` rollout rows, so the
        loader yields ``chunk_size // group_size`` prompts."""
        method: GRPOConfig = self.config.method
        loader = pipeline.create_loader(max(method.chunk_size // method.group_size, 1),
                                        shuffle=True, seed=self.config.train.seed)
        self.prompt_iterator = self._count_prompt_chunks(
            infinite_loader(self._maybe_prefetch_prompts(loader)))

    def post_backward_callback(self) -> None:
        pass  # the KL coefficient (method.beta) is fixed in the loss

    def _store_element_cls(self) -> type:
        return GRPORLElement

    def _extra_checkpoint_state(self) -> Dict[str, Any]:
        extra = super()._extra_checkpoint_state()
        extra.pop("kl_ctl_value", None)
        return extra

    # ------------------------------------------------------------------
    # rollout collection
    # ------------------------------------------------------------------

    def _grpo_score_batch(self, prompt_ids: np.ndarray, prompt_mask: np.ndarray,
                          response_tokens: np.ndarray, response_mask: np.ndarray,
                          elements: list, agg: Dict[str, Any], score_out=None,
                          split: bool = False, order: Optional[np.ndarray] = None) -> int:
        """Score and store one group-contiguous batch (``split``: this
        rank's groups of it, with the rows' sort keys ``order`` from the
        group-aware harvest, :meth:`_gather_chunk`): the produce half
        (:meth:`_grpo_chunk_produce`), then the ordered tail
        (:meth:`_grpo_chunk_finalize`) — the halves the async split runs on
        the actor and on the learner. Returns the rows stored (every
        rank's)."""
        chunk = self._grpo_chunk_produce(prompt_ids, prompt_mask, response_tokens,
                                         response_mask, score_out=score_out)
        chunk["split"] = split
        if order is not None:
            chunk["order"] = order
        agg["score_time_sum"] += chunk["score_s"]
        return self._grpo_chunk_finalize(chunk, elements, agg)

    def _grpo_chunk_produce(self, prompt_ids: np.ndarray, prompt_mask: np.ndarray,
                            response_tokens: np.ndarray, response_mask: np.ndarray,
                            score_out=None, model=None) -> Dict[str, Any]:
        """The device and host half of one group-contiguous batch: the
        scoring forward (unless the caller dispatched it on the
        generation's tensors; under ``model``, default the live policy),
        string decoding and ``reward_fn`` while its outputs land. It needs
        no learner state, so an async actor runs it."""
        if score_out is None:
            score_out = self._dispatch_score(
                np.concatenate([prompt_ids, response_tokens], axis=1), prompt_mask,
                response_tokens, response_mask, model=model)
        landing = HostCopy(score_out)
        samples, prompts, outputs = self.decode(prompt_ids, response_tokens,
                                                append_eos_token=True)
        t0 = perf_counter()
        scores = np.asarray(self.reward_fn(samples=samples, prompts=prompts, outputs=outputs),
                            dtype=np.float32)
        score_s = perf_counter() - t0
        return {"prompt_ids": prompt_ids, "prompt_mask": prompt_mask,
                "response_tokens": response_tokens, "response_mask": response_mask,
                "scores": scores, "host": landing.wait(), "score_s": score_s}

    def _grpo_chunk_finalize(self, chunk: Dict[str, Any], elements: list,
                             agg: Dict[str, Any]) -> None:
        """Reward clipping, running moments (logged only: the group
        normalisation is GRPO's reward scaling), group-relative
        advantages, the logged k3 KL and one element per non-empty row, on
        every rank's rows under the mesh (:meth:`_gather_chunk`)."""
        chunk = self._gather_chunk(chunk)
        method: GRPOConfig = self.config.method
        prompt_ids, prompt_mask = chunk["prompt_ids"], chunk["prompt_mask"]
        response_tokens, response_mask = chunk["response_tokens"], chunk["response_mask"]
        scores, host = chunk["scores"], chunk["host"]

        clip = method.cliprange_reward
        if clip:
            scores = np.clip(scores, -clip, clip)
        self.running_moments.update(scores)
        agg["all_scores"].append(scores)
        advantages = group_advantages_np(scores, method.group_size, method.scale_advantage,
                                         baseline=method.baseline)
        lp, rlp = host["logprobs"], host["ref_logprobs"]
        delta = (rlp - lp) * response_mask
        n_tok = max(response_mask.sum(), 1)
        agg["kl_sum"] += float(((np.exp(delta) - delta - 1.0) * response_mask).sum() / n_tok)
        agg["kl_batches"] += 1
        agg["gen_tokens"] += int(response_mask.sum())
        # async chunks carry the sampler's behaviour logprobs, kept only
        # when the IW correction consumes them
        behavior = chunk.get("behavior_logprobs")
        if method.iw_correction == "off":
            behavior = None
        for i in range(prompt_ids.shape[0]):
            n_i = int(response_mask[i].sum())
            if n_i == 0:
                continue
            elements.append(GRPORLElement(
                query_tensor=prompt_ids[i][prompt_mask[i] > 0],
                response_tensor=response_tokens[i, :n_i],
                logprobs=lp[i, :n_i],
                ref_logprobs=rlp[i, :n_i],
                advantage=float(advantages[i]),
                behavior_logprobs=(np.asarray(behavior[i, :n_i], np.float32)
                                   if behavior is not None else None),
            ))
        return int(prompt_ids.shape[0])

    def _grpo_collect_serial(self, num_rollouts: int, elements: list,
                             agg: Dict[str, Any]) -> None:
        """Each prompt batch fans out into ``group_size`` rows, generates on
        the serial dense engine to the slowest row, then scores; the
        scoring forward is dispatched on the generation's device tensors
        before the tokens land."""
        G = self.config.method.group_size
        while len(elements) < num_rollouts:
            batch = next(self.prompt_iterator)
            prompt_ids = np.repeat(np.asarray(batch["input_ids"], np.int64), G, axis=0)
            prompt_mask = np.repeat(np.asarray(batch["attention_mask"], np.int64), G, axis=0)
            prompt_ids, prompt_mask, seeds, at = self._rank_rows(prompt_ids, prompt_mask,
                                                                 unit=G)
            t0 = perf_counter()
            gen_out = self.generate_serial(prompt_ids, prompt_mask, seeds=seeds)
            score_out = self._dispatch_score(gen_out.sequences, prompt_mask,
                                             gen_out.response_tokens, gen_out.response_mask)
            landed = HostCopy({"response_tokens": gen_out.response_tokens,
                               "response_mask": gen_out.response_mask}).wait()
            response_tokens, response_mask = landed["response_tokens"], landed["response_mask"]
            agg["gen_time_sum"] += perf_counter() - t0
            # a chunk decodes max(n_i) steps over its rows
            n_per_row = response_mask.sum(axis=1)
            agg["slot_steps"] += int(response_mask.shape[0]) * (
                int(n_per_row.max()) if n_per_row.size else 0)
            agg["live_slot_steps"] += int(n_per_row.sum())
            self._grpo_score_batch(prompt_ids, prompt_mask, response_tokens, response_mask,
                                   elements, agg, score_out=score_out, split=at is not None)

    def _grpo_collect_continuous(self, num_rollouts: int, elements: list,
                                 agg: Dict[str, Any]) -> None:
        """The group-aware harvest on the paged engine: prompts are queued
        with ``meta = (group id, member)``; a group is ready when its last
        member finishes, and ready groups flush in completion order,
        ``chunk_size // group_size`` at a time, members sorted by index.

        Under the mesh each rank collects its whole groups of one chunk at
        a time, on an idle engine, and flushes them once the engine
        drains; each row is keyed by (the engine step that completed its
        group, the group's global index in the chunk, its member), one
        process's flush order for a chunk on an idle engine, which
        :meth:`_gather_chunk` restores on the joined rows."""
        if num_rollouts <= 0:
            return
        method: GRPOConfig = self.config.method
        G = method.group_size
        gen_config, extra_kwargs = self._resolve_gen_config(eval_mode=False)
        groups_per_batch = max(method.chunk_size // G, 1)
        state: Dict[str, Any] = {"engine": None, "supplied": 0, "processed": 0,
                                 "next_group": 0, "split": False, "steps": 0}
        partial: Dict[int, list] = {}  # group id → completed members
        # (the engine step that completed it, members) of every complete
        # group, in completion order
        ready: deque = deque()
        mesh = self.mesh is not None

        def fetch_chunk() -> None:
            batch = next(self.prompt_iterator)
            ids = np.repeat(np.asarray(batch["input_ids"], np.int32), G, axis=0)
            mask = np.repeat(np.asarray(batch["attention_mask"], np.int32), G, axis=0)
            rows = ids.shape[0]
            ids, mask, seeds, at = self._rank_rows(ids, mask, unit=G)
            state["split"], state["steps"] = at is not None, 0
            # (group id, member, the group's global index in the chunk)
            g0 = (at or 0) // G
            metas = [(state["next_group"] + r // G, r % G, g0 + r // G)
                     for r in range(ids.shape[0])]
            state["next_group"] += ids.shape[0] // G
            if state["engine"] is None:
                state["engine"] = self._cb_make_engine(gen_config, extra_kwargs,
                                                       ids.shape[0], ids.shape[1])
            state["engine"].enqueue_prompts(ids, mask, seeds, metas=metas)
            state["supplied"] += rows

        def flush(n_groups: int) -> None:
            groups = [ready.popleft() for _ in range(n_groups)]
            keyed = [(step, member) for step, group in groups
                     for member in sorted(group, key=lambda c: c.meta[1])]
            rows = [member for _, member in keyed]
            state["processed"] += self._grpo_score_batch(
                np.stack([c.prompt_ids for c in rows]).astype(np.int64),
                np.stack([c.prompt_mask for c in rows]).astype(np.int64),
                np.stack([c.tokens for c in rows]).astype(np.int64),
                np.stack([c.mask for c in rows]).astype(np.int64),
                elements, agg, split=state["split"],
                order=(np.asarray([(step, c.meta[2], c.meta[1]) for step, c in keyed],
                                  np.int64) if state["split"] else None))

        while True:
            while len(elements) + state["supplied"] - state["processed"] < num_rollouts:
                # under the mesh: the last chunk harvested and flushed
                if mesh and (ready or state["engine"] is not None and state["engine"].busy):
                    break
                fetch_chunk()
                if mesh:
                    break
            engine = state["engine"]
            if not engine.busy:
                if ready:
                    flush(len(ready))
                if len(elements) >= num_rollouts:
                    break
                continue
            state["steps"] += 1
            for c in engine.step():
                members = partial.setdefault(c.meta[0], [])
                members.append(c)
                if len(members) == G:
                    ready.append((state["steps"], partial.pop(c.meta[0])))
            while not mesh and len(ready) >= groups_per_batch:
                flush(groups_per_batch)

        agg["gen_time_sum"] += engine.stats.decode_s + engine.stats.refill_s
        agg["engine_stats"] = engine.stats

    # ------------------------------------------------------------------
    # async collection (async_rl.enabled)
    # ------------------------------------------------------------------

    def _async_spec_seeds(self, stream: np.random.RandomState, rows: int) -> np.ndarray:
        """A chunk's seeds: one per row after the group fan-out, as the
        serial path draws them."""
        return self._row_seeds(rows * self.config.method.group_size, stream)

    def _async_produce_chunk(self, spec, params, version, channel) -> Dict[str, Any]:
        """GRPO actor chunk: the spec's prompt batch fans out into
        ``group_size`` group-contiguous rows, generates serially under the
        adopted weights and the spec's seeds, and produces the score batch
        with the sampler's behaviour logprobs. (Async GRPO keeps the serial
        generation path; the group-aware harvest stays on the
        single-program loop.)"""
        if self.config.train.continuous_batching:
            raise NotImplementedError(
                "async_rl + train.continuous_batching is implemented for the PPO trainer "
                "only: GRPO's group-aware harvest keeps the single-program CB loop. Drop "
                "one of the two.")
        G = self.config.method.group_size
        prompt_ids = np.repeat(spec.prompt_ids, G, axis=0)
        prompt_mask = np.repeat(spec.prompt_mask, G, axis=0)
        gen_out = self.generate_serial(prompt_ids, prompt_mask, model=params, seeds=spec.seeds)
        score_out = self._dispatch_score(gen_out.sequences, prompt_mask,
                                         gen_out.response_tokens, gen_out.response_mask,
                                         model=params)
        landed = HostCopy({"response_tokens": gen_out.response_tokens,
                           "response_mask": gen_out.response_mask,
                           "behavior_logprobs": gen_out.response_logprobs}).wait()
        chunk = self._grpo_chunk_produce(prompt_ids, prompt_mask, landed["response_tokens"],
                                         landed["response_mask"], score_out=score_out)
        chunk["behavior_logprobs"] = np.asarray(landed["behavior_logprobs"], np.float32)
        return chunk

    def _collect_async_grpo(self, num_rollouts: int, elements: list,
                            agg: Dict[str, Any]) -> None:
        """Learner-side drain for GRPO: the PPO collector's ordered-finalize
        contract, with the GRPO finalize tail."""
        collector = self._ensure_async_collector()
        collector.begin_collection()
        while len(elements) < num_rollouts:
            chunk = collector.next_chunk()
            agg["score_time_sum"] += chunk.payload["score_s"]
            self._grpo_chunk_finalize(chunk.payload, elements, agg)
            mask = chunk.payload["response_mask"]
            n_per_row = mask.sum(axis=1)
            agg["slot_steps"] += int(mask.shape[0]) * (
                int(n_per_row.max()) if n_per_row.size else 0)
            agg["live_slot_steps"] += int(n_per_row.sum())
        collector.end_collection()
        agg["async_stats"] = collector.collection_stats()

    def make_experience(self, num_rollouts: int = 1024, iter_count: int = 0) -> None:
        """Collect grouped rollouts with group-relative advantages."""
        if self._consume_skip_initial_experience():
            return
        logger.info("Collecting GRPO rollouts")
        if self.prompt_iterator is None:
            raise RuntimeError("add_prompt_pipeline must be called before make_experience")
        stats: Dict[str, float] = {}
        elements: list = []
        agg: Dict[str, Any] = {"kl_sum": 0.0, "kl_batches": 0, "all_scores": [],
                               "gen_time_sum": 0.0, "score_time_sum": 0.0, "gen_tokens": 0,
                               "slot_steps": 0, "live_slot_steps": 0}
        exp_time = perf_counter()
        with unsharded(self.model):  # each rank decodes its own groups
            if self.config.async_rl.enabled:
                self._collect_async_grpo(num_rollouts, elements, agg)
            elif self.config.train.continuous_batching:
                self._grpo_collect_continuous(num_rollouts, elements, agg)
            else:
                self._grpo_collect_serial(num_rollouts, elements, agg)

        self.mean_kl = agg["kl_sum"] / max(agg["kl_batches"], 1)
        stats["policy/sqrt_ref_kl"] = float(np.sqrt(max(self.mean_kl, 0.0)))
        stats["time/exp_generate"] = agg["gen_time_sum"]
        engine_stats = agg.get("engine_stats")
        if engine_stats is None:
            # the serial generate's KV gauge and, under speculation, its
            # acceptance and rounds
            stats.update(self.last_generate_stats)
        stats["time/exp_score"] = agg["score_time_sum"]
        pooled = (np.concatenate(agg["all_scores"]) if agg["all_scores"]
                  else np.zeros((0,), np.float32))
        stats["exp_scores/mean"] = float(pooled.mean()) if pooled.size else 0.0
        stats["exp_scores/std"] = float(pooled.std()) if pooled.size else 0.0
        if "async_stats" in agg:
            stats.update(agg["async_stats"])
        if engine_stats is not None:
            engine_metrics = engine_stats.metrics()
            stats.update(engine_metrics)
            # the engine's picture survives a run that dies mid-collection
            self.obs.flightrec.record("engine_stats", engine_metrics)
        elif agg["slot_steps"]:
            util = agg["live_slot_steps"] / agg["slot_steps"]
            stats["throughput/slot_utilization"] = util
            stats["rollout/padded_decode_frac"] = 1.0 - util
        total = perf_counter() - exp_time
        stats["time/exp"] = total
        stats["rollout/gen_tokens"] = float(agg["gen_tokens"])
        if total > 0 and agg["gen_tokens"]:
            stats["throughput/rollout_tokens_per_sec"] = agg["gen_tokens"] / total
        self.make_experience_stats = stats
        self.tracker.log(stats, step=iter_count)
        self.store.push(elements[:num_rollouts] if num_rollouts else elements)
        self._export_rollouts()

    # ------------------------------------------------------------------
    # optimization
    # ------------------------------------------------------------------

    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """The query‖response forward (the flash kernels on the card), then
        the GRPO objective and the MoE router losses."""
        method: GRPOConfig = self.config.method
        queries = batch["query_tensors"].to(torch.int64)
        responses = batch["response_tensors"].to(torch.int64)
        Q, R = queries.shape[1], responses.shape[1]
        input_ids = torch.cat([queries, responses], dim=1)
        attention_mask = torch.cat([batch["query_mask"], batch["response_mask"]], dim=1)
        out = self.model(input_ids, attention_mask=attention_mask, logits_span=(Q - 1, Q + R - 1))
        logprobs = logprobs_of_labels(out["logits"], responses)
        operands = dict(logprobs=logprobs, old_logprobs=batch["logprobs"],
                        ref_logprobs=batch["ref_logprobs"], advantages=batch["advantages"],
                        mask=batch["response_mask"],
                        behavior_logprobs=batch.get("behavior_logprobs"))
        if self.mesh is not None:
            # the token normalisation spans the global minibatch (PPO's
            # gather: each rank's backward keeps its own rows)
            operands = {k: None if v is None else self.gather_rows(v)
                        for k, v in operands.items()}
        return self.with_router_aux(method.loss(**operands), out)
