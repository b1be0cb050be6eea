"""PPO trainer: rollout collection with a KL penalty against a frozen
reference, reward scaling, GAE and the clipped objective.

Port of ``trlx_tpu/trainer/ppo.py`` (``PPOTrainer``), causal and seq2seq:

- ``__init__`` takes the frozen reference snapshot — the hydra branch
  (copies of the top ``num_layers_unfrozen`` blocks, final norm and tied
  embedding; for T5 the top decoder blocks, the decoder's final norm and
  bias table, and the head) when ``num_layers_unfrozen > 0``, else a full
  frozen copy of the backbone;
- ``make_experience`` dispatches as JAX's does: ``async_rl.enabled`` →
  :meth:`_collect_async`, else ``train.continuous_batching`` →
  :meth:`_collect_continuous`, else ``train.rollout_pipeline_depth`` > 0
  → :meth:`_collect_pipelined`, else :meth:`_collect_serial`;
- the async actor/learner split (``trlx_tpu_torch/async_rl/``): actors
  (threads, or ``run_actor`` processes) produce chunks —
  :meth:`_async_produce_chunk`, the serial device and host halves under
  the actor's weights snapshot and the chunk's seeds, or with
  ``train.continuous_batching`` an engine of the actor's own that swaps
  newly published weights in at segment boundaries — while the learner
  drains them in index order through the same finalize; every optimizer
  update publishes a snapshot (:meth:`train_step`). The payload carries
  the sampler's behaviour logprobs, which ride into the store when
  ``method.iw_correction`` consumes them (the fused loss kernels' IW
  operand);
- the serial and pipelined paths run whole prompt chunks: the device side
  (:meth:`_chunk_device`: one serial dense generate, the scoring forward
  dispatched on its device outputs, and device → host copies started
  behind each) on the main thread, the host side
  (:meth:`_rollout_chunk_host`: landing the copies, string decoding,
  ``reward_fn``) inline at depth 0 or on the :class:`RolloutPipeline`
  worker, which launches no device work, and the ordered tail
  (:meth:`_rollout_chunk_finalize`: running moments, KL-penalty rewards,
  ``PPORLElement`` rows) on the main thread in submission order, so the
  store is the same at any depth. The store keeps the first
  ``num_rollouts`` rows in prompt order;
- the continuous path queues prompt chunks on the ``ContinuousEngine``,
  groups finished sequences ``B`` at a time in completion order (the JAX
  order), and runs each group through the same scoring forward, host
  stage (inline at depth 0, on the :class:`RolloutPipeline` worker at
  depth > 0 while the engine keeps stepping) and finalize;
- ``loss_fn``: the train-step forward (flash-attention kernels on the
  card), then with ``method.loss_kernel: xla`` the staged loss
  (``get_advantages_and_returns``, then ``loss``), with ``pallas`` the
  fused loss kernels; the ``dist/entropy_hist`` sketch;
- observability, at JAX's sites: the ``rollout`` span of each chunk (on
  the pipelined path the device side; the worker's host side as a
  ``rollout/overlap`` span fenced on the chunk's scoring copies), inside
  it ``score`` and ``reward``; per collection the reference-KL sketch
  (``dist/ref_kl_*``), the generation lengths and the repetition canary,
  which feed the health detectors (``obs.health.observe_rollout``);
- ``train.rollout_logging_dir`` exports the store after every collection
  (``PPORolloutStorage.export_history``); an emergency checkpoint carries
  the store (:meth:`_emergency_payload`), and the first collection after
  its resume is skipped, as the store already holds those rollouts;
- seq2seq (T5): the prompt feeds the encoder and the decoder is
  teacher-forced on the start token followed by ``response[:-1]``, so
  decoder position i scores response token i (:meth:`_score_seq2seq` and
  ``loss_fn``'s seq2seq branch: the same staged or fused loss and sketch).
"""

import copy
import dataclasses
import os
import threading
from collections import deque
from contextlib import ExitStack
from time import perf_counter
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.data.ppo_types import PPORLElement
from trlx_tpu_torch.models.builder import hydra_ref_params, seq2seq_hydra_ref_params
from trlx_tpu_torch.models.ppo import PPOConfig, kl_penalty_rewards_np
from trlx_tpu_torch.parallel.sharding import (
    allgather_host,
    full_model_state,
    row_part,
    unsharded,
)
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage
from trlx_tpu_torch.pipeline.rollout_pipeline import RolloutPipeline
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.base import HostCopy, TorchBaseTrainer, logger
from trlx_tpu_torch.utils import infinite_loader
from trlx_tpu_torch.observability.dynamics import (
    SKETCH_RANGES,
    entropy_of_logits,
    loss_sketches,
    sketch_np,
)
from trlx_tpu_torch.utils.stats import RunningMoments, logprobs_of_labels


@register_trainer
class PPOTrainer(TorchBaseTrainer):
    model_head = "value"
    collects_rollouts = True
    supports_seq2seq = True

    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        method: PPOConfig = config.method
        if not isinstance(method, PPOConfig):
            raise ValueError("config.method must be PPOConfig")
        if self.reward_fn is None:
            raise ValueError("PPO requires a reward_fn")
        if config.train.continuous_batching and 0 < method.num_rollouts < method.chunk_size:
            logger.warning(
                "method.chunk_size %d > method.num_rollouts %d: each collection keeps "
                "the first %d sequences of a chunk to finish, i.e. its shortest "
                "answers, which biases the store toward short answers; set "
                "chunk_size to num_rollouts to keep whole chunks",
                method.chunk_size, method.num_rollouts, method.num_rollouts)
        self.store = PPORolloutStorage(self.tokenizer.pad_token_id)
        self.kl_ctl = method.kl_controller()
        self.num_layers_unfrozen = config.model.num_layers_unfrozen
        self.ref_params = self._ref_snapshot()
        self.running_moments = RunningMoments()
        self.ref_mean: Optional[float] = method.ref_mean
        self.ref_std: Optional[float] = method.ref_std
        self.prompt_iterator = None
        self.mean_kl = 0.0
        self.make_experience_stats: Dict[str, float] = {}
        self._skip_initial_experience = False
        self.rollout_logging_dir = config.train.rollout_logging_dir
        if self.rollout_logging_dir is not None:
            os.makedirs(self.rollout_logging_dir, exist_ok=True)
        # the async collector, built at the first async make_experience;
        # _async_version is the learner's update clock (the channel version)
        self._async = None
        self._async_version = 0

    def _ref_snapshot(self) -> torch.nn.Module:
        """Frozen reference of the current weights (buffer-owning copies):
        the hydra branch, or the whole backbone when every layer trains.
        Under the mesh every rank holds it whole, built from the gathered
        weights (a collective)."""
        if self.mesh is not None:
            return self._ref_snapshot_gathered()
        if self.num_layers_unfrozen > 0:
            branch = seq2seq_hydra_ref_params if self.is_seq2seq else hydra_ref_params
            return branch(self.model, self.tcfg, self.num_layers_unfrozen)
        backbone = getattr(self.model, "backbone", self.model)  # a head-less policy is one
        return copy.deepcopy(backbone).eval().requires_grad_(False)

    def _ref_snapshot_gathered(self) -> torch.nn.Module:
        """:meth:`_ref_snapshot` of an FSDP2-sharded causal policy: the
        backbone's full weights on every rank, loaded into the hydra branch
        or into a fresh backbone (seq2seq runs in one process)."""
        prefix = "backbone." if hasattr(self.model, "backbone") else ""
        state = {k[len(prefix):]: v for k, v in full_model_state(self.model).items()
                 if k.startswith(prefix)}
        if self.num_layers_unfrozen > 0:
            return hydra_ref_params(self.model, self.tcfg, self.num_layers_unfrozen,
                                    backbone_state=state)
        backbone = getattr(self.model, "backbone", self.model)
        with torch.device("meta"):
            ref = type(backbone)(self.tcfg)
        ref.load_state_dict({k: v.detach().clone() for k, v in state.items()}, assign=True)
        return ref.eval().requires_grad_(False)

    # ------------------------------------------------------------------
    # rollout collection
    # ------------------------------------------------------------------

    def add_prompt_pipeline(self, pipeline) -> None:
        loader = pipeline.create_loader(
            self.config.method.chunk_size, shuffle=True, seed=self.config.train.seed
        )
        self.prompt_iterator = self._count_prompt_chunks(
            infinite_loader(self._maybe_prefetch_prompts(loader)))

    def _extra_checkpoint_state(self) -> Dict[str, Any]:
        return {
            "kl_ctl_value": float(self.kl_ctl.value),
            "mean_kl": float(self.mean_kl),
            "running_moments": {
                "mean": self.running_moments.mean,
                "std": self.running_moments.std,
                "var": self.running_moments.var,
                "count": self.running_moments.count,
            },
        }

    def _restore_extra_checkpoint_state(self, extra: Dict[str, Any]) -> None:
        if "kl_ctl_value" in extra:
            self.kl_ctl.value = float(extra["kl_ctl_value"])
        if "mean_kl" in extra:
            self.mean_kl = float(extra["mean_kl"])
        rm = extra.get("running_moments")
        if rm:
            self.running_moments.mean = rm["mean"]
            self.running_moments.std = rm["std"]
            self.running_moments.var = rm["var"]
            self.running_moments.count = rm["count"]

    def _store_element_cls(self) -> type:
        return PPORLElement

    def _emergency_payload(self) -> Dict[str, Any]:
        """The rollout store, field by field as tensors (an optional field
        that is None is left out)."""
        rows = []
        for elem in self.store.history:
            row = {}
            for f in dataclasses.fields(elem):
                value = getattr(elem, f.name)
                if value is not None:
                    # np.array keeps a scalar field (GRPO's advantage) 0-d
                    row[f.name] = torch.from_numpy(np.array(value))
            rows.append(row)
        return {"store": rows}

    def _restore_emergency_payload(self, payload: Dict[str, Any]) -> None:
        if "store" not in payload:
            return
        cls = self._store_element_cls()
        self.store.clear_history()
        self.store.push([cls(**{k: v.item() if v.ndim == 0 else v.numpy()
                                for k, v in row.items()}) for row in payload["store"]])
        # the uninterrupted run trains on these rollouts here
        self._skip_initial_experience = True

    def _consume_skip_initial_experience(self) -> bool:
        """True once after an emergency resume restored the store."""
        if self._skip_initial_experience:
            self._skip_initial_experience = False
            logger.info("emergency resume: rollout store restored from the checkpoint; "
                        "skipping the initial collection")
            return True
        return False

    def _export_rollouts(self) -> None:
        if self.rollout_logging_dir is not None:
            self.store.export_history(location=self.rollout_logging_dir)

    @torch.no_grad()
    def _score(self, sequences, prompt_mask, response_tokens, response_mask, model=None):
        """The scoring forward of one (B, P, N) group: policy logprobs and
        values (none for a head-less policy), and the frozen reference's logprobs (hydra branch replay on
        the trunk activations, or the full frozen copy). Logits at t
        predict token t + 1, so response token i is scored at P - 1 + i;
        the vocab projection is restricted to that span. ``model`` (an
        async actor's weights snapshot) replaces the live policy."""
        model = self.model if model is None else model
        if self.is_seq2seq:
            return self._score_seq2seq(sequences, prompt_mask, response_tokens, response_mask,
                                       model)
        P, N = prompt_mask.shape[1], response_tokens.shape[1]
        nlu = self.num_layers_unfrozen
        full_mask = torch.cat([prompt_mask, response_mask], dim=1)
        span = (P - 1, P + N - 1)
        out = model(sequences, attention_mask=full_mask,
                         branch_layer=nlu if nlu > 0 else None, logits_span=span)
        logprobs = logprobs_of_labels(out["logits"], response_tokens)
        if nlu > 0:
            ref_out = self.ref_params(out["branch_input"], full_mask, None, span)
        else:
            ref_out = self.ref_params(sequences, attention_mask=full_mask, logits_span=span)
        score = {"logprobs": logprobs,
                 "ref_logprobs": logprobs_of_labels(ref_out["logits"], response_tokens)}
        if "value" in out:  # a head-less policy (GRPO) scores no values
            score["values"] = out["value"][:, P - 1 : P + N - 1].float()
        return score

    def _decoder_inputs(self, response_tokens, response_mask):
        """The teacher-forced decoder input (the start token, then
        ``response[:-1]``) and its mask."""
        start = torch.full_like(response_tokens[:, :1], self.tcfg.decoder_start_token_id)
        return (torch.cat([start, response_tokens[:, :-1]], dim=1),
                torch.cat([torch.ones_like(response_mask[:, :1]), response_mask[:, :-1]],
                          dim=1))

    def _score_seq2seq(self, sequences, prompt_mask, response_tokens, response_mask, model):
        """The seq2seq scoring forward: the prompt through the encoder, the
        decoder teacher-forced (decoder position i scores response token
        i); values from the value head; the reference's logprobs from the
        hydra branch on the trunk's decoder activations (its bias from its
        own table) or from the full frozen copy."""
        P = prompt_mask.shape[1]
        nlu = self.num_layers_unfrozen
        prompt_ids = sequences[:, :P]
        dec_in, dec_mask = self._decoder_inputs(response_tokens, response_mask)
        out = model(prompt_ids, attention_mask=prompt_mask, decoder_input_ids=dec_in,
                    decoder_attention_mask=dec_mask, branch_layer=nlu if nlu > 0 else None)
        if nlu > 0:
            ref_out = self.ref_params(out["branch_input"], out["encoder_hidden"], prompt_mask,
                                      dec_mask)
        else:
            ref_out = self.ref_params(prompt_ids, attention_mask=prompt_mask,
                                      decoder_input_ids=dec_in, decoder_attention_mask=dec_mask)
        return {"logprobs": logprobs_of_labels(out["logits"], response_tokens),
                "values": out["value"].float(),
                "ref_logprobs": logprobs_of_labels(ref_out["logits"], response_tokens)}

    def _dispatch_score(self, sequences, prompt_mask, response_tokens,
                        response_mask, model=None) -> Dict[str, torch.Tensor]:
        """Run the scoring forward on host rows or on the generation's
        device tensors (under ``model``, default the live policy); the
        outputs stay on the device until the host stage lands them."""
        def dev(x):
            x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
            return x.to(device=self.device, dtype=torch.int64)

        return self._score(dev(sequences), dev(prompt_mask), dev(response_tokens),
                           dev(response_mask), model=model)

    def _cb_group_device(self, group: list, model=None) -> Dict[str, Any]:
        """Device side of one harvested group: assemble the score batch
        from individually completed sequences and run the scoring forward
        (under ``model``, default the live policy). The harvest's own
        logprobs ride along as the behaviour logprobs."""
        prompt_ids = np.stack([c.prompt_ids for c in group]).astype(np.int32)
        prompt_mask = np.stack([c.prompt_mask for c in group]).astype(np.int32)
        response_tokens = np.stack([c.tokens for c in group]).astype(np.int32)
        response_mask = np.stack([c.mask for c in group]).astype(np.int32)
        sequences = np.concatenate([prompt_ids, response_tokens], axis=1)
        score_out = self._dispatch_score(sequences, prompt_mask, response_tokens,
                                         response_mask, model=model)
        return {"prompt_ids": prompt_ids, "prompt_mask": prompt_mask,
                "gen_landing": HostCopy({"response_tokens": response_tokens,
                                         "response_mask": response_mask}),
                "score_out": score_out, "score_landing": HostCopy(score_out),
                "behavior_logprobs": np.stack([c.logprobs for c in group]).astype(np.float32)}

    def _rollout_chunk_device(self, stats: Dict[str, float]) -> Dict[str, Any]:
        """Main-thread device side of one prompt chunk of the serial and
        pipelined paths: prompt fetch, generation, and the scoring forward
        with its device → host copies."""
        batch = next(self.prompt_iterator)
        ids, mask, seeds, at = self._rank_rows(np.asarray(batch["input_ids"], np.int64),
                                               np.asarray(batch["attention_mask"], np.int64))
        dev = self._chunk_device(ids, mask, stats, seeds=seeds)
        dev.update(rows=len(batch["input_ids"]), split=at is not None)
        return dev

    def _rank_rows(self, ids: np.ndarray, mask: np.ndarray, unit: int = 1):
        """A prompt chunk's per-row seeds, all drawn (every rank draws the
        whole chunk's from one shared stream, so its draws are the global
        rows' draws), and this rank's rows of the chunk and the seeds in
        whole units of ``unit`` rows (a GRPO group): ``(ids, mask, seeds,
        at)``, ``at`` the global index of the rank's first row; every row and
        ``at`` None when the data axes do not divide the units
        (``parallel/sharding.py::row_part``)."""
        seeds = self._row_seeds(ids.shape[0])
        part = row_part(ids.shape[0], self.mesh, unit)
        if part is None:
            return ids, mask, seeds, None
        return ids[part], mask[part], seeds[part], part.start

    def _chunk_device(self, prompt_ids: np.ndarray, prompt_mask: np.ndarray,
                      stats: Dict[str, float], model=None,
                      seeds: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """One serial dense generate of the chunk; the scoring forward runs
        straight on its device outputs while the host stage decodes and
        scores the landed tokens. The device tensors stay referenced here
        until the chunk is finalized. Shared by the serial paths (the live
        policy, seeds from the rollout stream) and the async actors (their
        weights snapshot ``model`` and the chunk's ``seeds``)."""
        t0 = perf_counter()
        gen_out = self.generate_serial(prompt_ids, prompt_mask, model=model, seeds=seeds)
        stats["time/exp_generate"] = perf_counter() - t0
        stats["time/generate"] = self.last_generate_time
        stats.update(self.last_generate_stats)
        gen_landing = HostCopy({"response_tokens": gen_out.response_tokens,
                                "response_mask": gen_out.response_mask})
        score_out = self._dispatch_score(gen_out.sequences, prompt_mask,
                                         gen_out.response_tokens, gen_out.response_mask,
                                         model=model)
        return {"prompt_ids": prompt_ids, "prompt_mask": prompt_mask, "gen_out": gen_out,
                "gen_landing": gen_landing, "score_out": score_out,
                "score_landing": HostCopy(score_out)}

    def _rollout_chunk_host(self, dev: Dict[str, Any]) -> Dict[str, Any]:
        """Host side of one chunk or group (the pipeline worker at depth >
        0): land the generated tokens, decode strings, run ``reward_fn``,
        land the scoring outputs (usually there by then). Waits on the
        copies' events only, and launches no device work."""
        host_t0 = perf_counter()
        stats: Dict[str, float] = {}
        # the "score" span stays open across the overlapped decode and
        # reward, to the scoring outputs' landing
        with self.obs.span("score") as score_sp:
            landed = dev["gen_landing"].wait()
            response_tokens, response_mask = landed["response_tokens"], landed["response_mask"]
            samples, prompts, outputs = self.decode(dev["prompt_ids"], response_tokens,
                                                    append_eos_token=True)
            with self.obs.span("reward") as reward_sp:
                scores = np.asarray(self.reward_fn(samples=samples, prompts=prompts,
                                                   outputs=outputs), dtype=np.float32)
            stats["time/reward"] = stats["time/exp_score"] = reward_sp.duration
            host = dev["score_landing"].wait()
        stats["time/score"] = score_sp.duration
        chunk = {"prompt_ids": dev["prompt_ids"], "prompt_mask": dev["prompt_mask"],
                 "response_tokens": response_tokens, "response_mask": response_mask,
                 "scores": scores, "host": host, "stats": stats,
                 "host_s": perf_counter() - host_t0, "split": dev.get("split", False)}
        if "order" in dev:  # a split harvest's sort keys (:meth:`_gather_chunk`)
            chunk["order"] = dev["order"]
        return chunk

    # the per-row host results of a chunk that the ranks split
    _GATHERED_ROWS = ("prompt_ids", "prompt_mask", "response_tokens", "response_mask",
                      "scores", "behavior_logprobs", "order")

    def _gather_chunk(self, chunk: Dict[str, Any]) -> Dict[str, Any]:
        """The whole chunk from every rank's part (``chunk["split"]``):
        each per-row host array, the scoring outputs included, joined in
        rank order, so the ordered tail sees the global rows on every rank
        and the store is the one a single process builds. A harvest of the
        continuous paths carries ``order``, per-row integer keys (the first
        column first) that put the joined rows in one process's completion
        order. A chunk every rank collected whole passes as it is."""
        if not chunk.get("split"):
            return chunk
        local = {k: chunk[k] for k in self._GATHERED_ROWS if chunk.get(k) is not None}
        local["host"] = chunk["host"]
        parts = allgather_host(local, self.mesh)
        whole = dict(chunk, split=False)
        for k in local:
            if k == "host":
                whole[k] = {h: np.concatenate([p[k][h] for p in parts]) for h in local[k]}
            else:
                whole[k] = np.concatenate([p[k] for p in parts])
        if "order" in local:
            keys = whole.pop("order")
            perm = np.lexsort(keys.T[::-1])
            for k in local:
                if k == "host":
                    whole[k] = {h: v[perm] for h, v in whole[k].items()}
                elif k != "order":
                    whole[k] = whole[k][perm]
        return whole

    def _rollout_chunk_finalize(self, chunk: Dict[str, Any], elements: list,
                                stats: Dict[str, float], acc: Dict[str, float]) -> int:
        """Ordered tail of one chunk or group, on the main thread in
        submission order at any depth: the rows of every rank joined under
        the mesh (:meth:`_gather_chunk`), then reward scaling (running
        moments), KL-penalty rewards and the store rows. Returns the rows
        it finalized (every rank's)."""
        chunk = self._gather_chunk(chunk)
        stats.update(chunk["stats"])
        acc["host_s"] += chunk["host_s"]
        response_mask = chunk["response_mask"]
        response_tokens = chunk["response_tokens"]
        host = chunk["host"]

        # non-finite scores are zeroed before the running moments fold them in
        scores = np.asarray(chunk["scores"], np.float32)
        nonfinite = ~np.isfinite(scores)
        if nonfinite.any():
            stats["health/nonfinite_scores"] = stats.get(
                "health/nonfinite_scores", 0.0) + float(nonfinite.sum())
            scores = np.where(nonfinite, 0.0, scores)
        scores_mean, scores_std = self.running_moments.update(scores)
        stats["exp_scores/mean"] = float(scores_mean)
        stats["exp_scores/std"] = float(scores_std)
        stats["exp_scores/running_mean"] = float(self.running_moments.mean)
        stats["exp_scores/running_std"] = float(self.running_moments.std)
        if self.config.method.scale_reward == "running":
            scores /= max(self.running_moments.std, 1e-8)
        elif self.config.method.scale_reward == "ref":
            scores /= max(self.ref_std or 1.0, 1e-8)
        clip = self.config.method.cliprange_reward
        if clip:
            scores = np.clip(scores, -clip, clip)

        rewards, (mean_kl, _) = kl_penalty_rewards_np(
            host["logprobs"], host["ref_logprobs"], response_mask, scores, self.kl_ctl.value)
        if np.isfinite(mean_kl):
            acc["kl_sum"] += mean_kl
            acc["kl_batches"] += 1
            stats["policy/sqrt_kl"] = float(np.sqrt(max(mean_kl, 0.0)))
        else:
            stats["health/nonfinite_kl_chunks"] = stats.get(
                "health/nonfinite_kl_chunks", 0.0) + 1.0
            stats["policy/sqrt_kl"] = 0.0
        acc["gen_tokens"] += int(response_mask.sum())
        acc["chunks"] += 1
        # the rollout side's sketch: per-token k3 KL against the frozen
        # reference, which only the host holds here
        fmask = np.asarray(response_mask, np.float32)
        ref_lr = (np.asarray(host["logprobs"]) - np.asarray(host["ref_logprobs"])) * fmask
        ref_k3 = (np.exp(ref_lr) - 1.0) - ref_lr
        lo, hi = SKETCH_RANGES["ref_kl"]
        acc["ref_kl_hist"] = acc.get("ref_kl_hist", 0.0) + sketch_np(ref_k3, fmask, lo=lo, hi=hi)
        # generation lengths and the repeated-adjacent-token canary (the
        # continuous path keeps its engine's exact numbers)
        toks = np.asarray(response_tokens)
        pair_mask = fmask[:, 1:] * fmask[:, :-1]
        acc["rep_pairs"] = acc.get("rep_pairs", 0.0) + float(
            ((toks[:, 1:] == toks[:, :-1]) * pair_mask).sum())
        acc["rep_total"] = acc.get("rep_total", 0.0) + float(pair_mask.sum())
        acc.setdefault("gen_lens", []).extend(fmask.sum(axis=1).astype(np.int64).tolist())
        # slot accounting of the chunked paths: a chunk decodes max(n_i)
        # steps over its rows (the continuous path reports its engine's)
        n_per_row = response_mask.sum(axis=1)
        acc["slot_steps"] += int(response_mask.shape[0]) * (
            int(n_per_row.max()) if n_per_row.size else 0)
        acc["live_slot_steps"] += int(n_per_row.sum())

        prompt_ids, prompt_mask = chunk["prompt_ids"], chunk["prompt_mask"]
        # async chunks carry the sampler's behaviour logprobs; they ride into
        # the store only when the IW correction consumes them
        behavior = chunk.get("behavior_logprobs")
        if self.config.method.iw_correction == "off":
            behavior = None
        for i in range(prompt_ids.shape[0]):
            n_i = int(response_mask[i].sum())
            if n_i == 0:
                continue
            elements.append(PPORLElement(
                query_tensor=prompt_ids[i][prompt_mask[i] > 0],
                response_tensor=response_tokens[i, :n_i],
                logprobs=host["logprobs"][i, :n_i],
                values=host["values"][i, :n_i],
                rewards=rewards[i, :n_i],
                behavior_logprobs=(np.asarray(behavior[i, :n_i], np.float32)
                                   if behavior is not None else None),
            ))
        return int(prompt_ids.shape[0])

    def _collect_continuous(self, num_rollouts: int, depth: int, elements: list,
                            stats: Dict[str, float], acc: Dict[str, float]) -> None:
        """Continuous-batching collection: prompt chunks are queued while
        the expected rows cannot cover the target; every engine step's
        harvest is grouped B at a time in completion order and each group's
        scoring forward dispatched at once. Its host stage runs inline at
        ``train.rollout_pipeline_depth`` 0, else on the
        :class:`RolloutPipeline` worker (up to ``depth`` groups in flight)
        while the engine keeps stepping; finalize runs on this thread in
        submission order, so the store equals the inline one. The partial
        tail flushes once the engine drains.

        Under the mesh each rank collects its rows of one chunk at a time,
        on an idle engine, and submits the chunk's harvest as one group
        once the engine drains. Every row is keyed by (the engine step that
        finished it, its global row), one process's harvest order for a
        chunk on an idle engine, and :meth:`_gather_chunk` sorts the joined
        rows by these keys; so a collection of one chunk stores what one
        process stores. Over several chunks one process refills freed
        slots from the next chunk, and its order can differ."""
        if num_rollouts <= 0:
            stats["throughput/rollout_overlap_frac"] = 0.0
            return
        gen_config, extra_kwargs = self._resolve_gen_config(eval_mode=False)
        state = {"engine": None, "supplied": 0, "finalized_rows": 0, "split": False,
                 "steps": 0}
        harvest_buf: list = []
        mesh = self.mesh is not None

        def fetch_chunk() -> None:
            batch = next(self.prompt_iterator)
            rows = len(batch["input_ids"])
            ids, mask, seeds, at = self._rank_rows(
                np.asarray(batch["input_ids"], np.int32),
                np.asarray(batch["attention_mask"], np.int32))
            state["split"], state["steps"] = at is not None, 0
            if state["engine"] is None:
                state["engine"] = self._cb_make_engine(gen_config, extra_kwargs,
                                                       ids.shape[0], ids.shape[1])
            # under the mesh each row's meta is its global index in the chunk
            start = at or 0
            state["engine"].enqueue_prompts(
                ids, mask, seeds, metas=list(range(start, start + len(ids))) if mesh else None)
            state["supplied"] += rows

        def finalize(chunk: Dict[str, Any]) -> None:
            state["finalized_rows"] += self._rollout_chunk_finalize(chunk, elements, stats, acc)

        t0 = perf_counter()
        with ExitStack() as ctx:
            pipe = None
            if depth > 0:
                pipe = ctx.enter_context(RolloutPipeline(
                    depth=depth, finalize=finalize, name="rollout", tracer=self.obs.tracer))

            def submit_group(group: list) -> None:
                dev = self._cb_group_device(group)
                dev["split"] = state["split"]
                if state["split"]:
                    dev["order"] = np.asarray([c.meta for c in group], np.int64)
                if pipe is None:
                    finalize(self._rollout_chunk_host(dev))
                    return

                def work(dev=dev):
                    # fenced on the group's scoring copies (their event)
                    with self.obs.span("rollout/overlap") as sp:
                        sp.fence(dev["score_landing"].event)
                        return self._rollout_chunk_host(dev)

                pipe.submit(work)

            while True:
                # rows in the pipeline are supplied and not yet finalized:
                # they count as expected elements
                while (len(elements) + state["supplied"] - state["finalized_rows"]
                       < num_rollouts):
                    # under the mesh: the last chunk harvested and submitted
                    if mesh and (harvest_buf or state["engine"] is not None
                                 and state["engine"].busy):
                        break
                    fetch_chunk()
                    if mesh:
                        break
                engine = state["engine"]
                B = engine.B
                if not engine.busy:
                    while harvest_buf:
                        group, harvest_buf = harvest_buf[:B], harvest_buf[B:]
                        submit_group(group)
                    if pipe is not None:
                        pipe.drain()
                    if len(elements) >= num_rollouts:
                        break
                    continue
                done = engine.step()
                if mesh:
                    state["steps"] += 1
                    for c in done:
                        c.meta = (state["steps"], c.meta)
                harvest_buf.extend(done)
                while not mesh and len(harvest_buf) >= B:
                    group, harvest_buf = harvest_buf[:B], harvest_buf[B:]
                    submit_group(group)
            stats["throughput/rollout_overlap_frac"] = (
                pipe.stats.overlap_frac(perf_counter() - t0) if pipe is not None else 0.0)

        engine = state["engine"]
        engine_metrics = engine.stats.metrics()
        stats.update(engine_metrics)
        stats["time/exp_generate"] = engine.stats.decode_s + engine.stats.refill_s
        stats["time/generate"] = engine.stats.decode_s
        # the engine's picture survives a run that dies mid-collection
        self.obs.flightrec.record("engine_stats", engine_metrics)

    def _collect_serial(self, num_rollouts: int, elements: list, stats: Dict[str, float],
                        acc: Dict[str, float]) -> None:
        """Depth 0: each chunk runs device → host → finalize in sequence,
        the reference the pipelined path is held to."""
        while len(elements) < num_rollouts:
            with self.obs.span("rollout"):
                chunk = self._rollout_chunk_host(self._rollout_chunk_device(stats))
            self._rollout_chunk_finalize(chunk, elements, stats, acc)
        stats["throughput/rollout_overlap_frac"] = 0.0

    def _collect_pipelined(self, num_rollouts: int, depth: int, elements: list,
                           stats: Dict[str, float], acc: Dict[str, float]) -> None:
        """Software-pipelined collection: the main thread keeps the device
        busy (chunk k + 1's generation dispatches as soon as chunk k's
        scoring forward is queued) while up to ``depth`` chunks of host work
        drain on the pipeline worker; finalize runs here, in submission
        order, so the store equals the serial path's."""
        rows_in_flight: deque = deque()  # row count of each chunk in flight

        def finalize(chunk: Dict[str, Any]) -> None:
            rows_in_flight.popleft()
            self._rollout_chunk_finalize(chunk, elements, stats, acc)

        t0 = perf_counter()
        with RolloutPipeline(depth=depth, finalize=finalize, name="rollout",
                             tracer=self.obs.tracer) as pipe:
            while True:
                # submit while even full chunks cannot cover the target; when
                # the rows in flight may, drain and count exactly (rows with
                # empty responses are dropped at finalize), so the chunks
                # processed are the serial loop's
                if len(elements) + sum(rows_in_flight) >= num_rollouts:
                    pipe.drain()
                    if len(elements) >= num_rollouts:
                        break
                    continue
                # the device side on this thread; the host side shows as
                # "rollout/overlap" on the worker's track
                with self.obs.span("rollout", pipelined=True) as rollout_sp:
                    dev = self._rollout_chunk_device(stats)
                stats["time/rollout_device"] = rollout_sp.duration
                rows_in_flight.append(int(dev["rows"]))

                def work(dev=dev):
                    # fenced on this chunk's scoring copies (their event):
                    # the span closes once they are on the host
                    with self.obs.span("rollout/overlap") as sp:
                        sp.fence(dev["score_landing"].event)
                        return self._rollout_chunk_host(dev)

                pipe.submit(work)
            pipe_stats = pipe.stats
        stats["throughput/rollout_overlap_frac"] = pipe_stats.overlap_frac(perf_counter() - t0)

    # ------------------------------------------------------------------
    # async collection (async_rl.enabled): the actor/learner split
    # ------------------------------------------------------------------
    #
    # N actors (threads here, or run_actor processes) produce experience
    # chunks continuously — gated by the weight channel's staleness bound —
    # while the learner drains chunks in index order and trains. The
    # learner publishes a weights snapshot after every update (in-flight
    # weight sync), so collection k+1 is generated under weights at most
    # max_staleness updates behind its consumption.

    def _async_chunks_per_collection(self) -> int:
        from trlx_tpu_torch.async_rl.actor import chunks_per_collection

        return chunks_per_collection(self.config)

    def _async_queue_capacity(self) -> int:
        cap = int(self.config.async_rl.queue_capacity)
        return cap if cap > 0 else 2 * self._async_chunks_per_collection()

    def _async_updates_per_phase(self) -> int:
        """Optimizer updates between two collections: one learn-loop epoch
        (the gate target the learner announces at drain end)."""
        method = self.config.method
        batches = max(1, int(method.num_rollouts) // int(self.config.train.batch_size))
        return int(method.ppo_epochs) * batches

    def _async_spec_seeds(self, stream: np.random.RandomState, rows: int) -> np.ndarray:
        """The per-row seeds of a chunk of ``rows`` prompts, drawn from
        ``stream`` as the serial path draws them from the rollout stream."""
        return self._row_seeds(rows, stream)

    def _ensure_async_collector(self):
        if self._async is not None:
            return self._async
        from trlx_tpu_torch.async_rl.channel import FileWeightChannel, WeightChannel
        from trlx_tpu_torch.async_rl.queue import ExperienceQueue, FileExperienceQueue
        from trlx_tpu_torch.async_rl.runtime import AsyncCollector

        acfg = self.config.async_rl
        capacity = self._async_queue_capacity()
        coordinator = None
        member_factory = None
        if acfg.transport not in ("file", "collective"):
            raise ValueError(f"unknown async_rl.transport '{acfg.transport}' "
                             "(file | collective)")
        if acfg.mode not in ("thread", "process"):
            raise ValueError(f"unknown async_rl.mode '{acfg.mode}' (thread | process)")
        if acfg.mode == "process" and not acfg.root_dir:
            raise ValueError(
                "async_rl.mode: process requires async_rl.root_dir (a directory shared "
                "with the run_actor processes: the spool and weights, or the collective "
                "fleet's endpoint)")
        if acfg.transport == "collective":
            # the fleet fabric: weights-dissemination tree + in-fabric chunk
            # commits + elastic membership
            if acfg.queue_policy == "drop_oldest":
                raise ValueError(
                    "async_rl.transport: collective back-pressures through the fleet "
                    "production window; queue_policy: drop_oldest is a file-transport knob")
            from trlx_tpu_torch.async_rl.transport import (
                CollectiveExperienceQueue,
                CollectiveWeightChannel,
                FleetCoordinator,
                make_member_factory,
                write_endpoint,
            )

            coordinator = FleetCoordinator(
                fanout=acfg.fanout, bind_host=acfg.bind_host, capacity=capacity,
                plan=self.resilience.plan, metrics=self.obs.metrics,
                sync_every=acfg.sync_every, actor_timeout_s=acfg.actor_timeout_s)
            queue = CollectiveExperienceQueue(coordinator)
            channel = CollectiveWeightChannel(coordinator)
            if acfg.mode == "process":
                write_endpoint(acfg.root_dir, coordinator.address, coordinator.authkey)
            else:
                # each actor thread joins the fleet as its own member over
                # loopback — the same wire protocol as actor processes
                member_factory = make_member_factory(coordinator, lambda: self.model)
        elif acfg.mode == "process":
            queue = FileExperienceQueue(
                os.path.join(acfg.root_dir, "spool"), capacity=capacity,
                poll_interval_s=acfg.poll_interval_s, metrics=self.obs.metrics)
            channel = FileWeightChannel(
                os.path.join(acfg.root_dir, "weights"), plan=self.resilience.plan,
                metrics=self.obs.metrics, sync_every=acfg.sync_every,
                poll_interval_s=acfg.poll_interval_s, fetch_timeout_s=acfg.fetch_timeout_s)
        else:
            queue = ExperienceQueue(
                capacity, policy=acfg.queue_policy, metrics=self.obs.metrics,
                # late-bound through self._async: evicted chunks regenerate
                on_drop=self._async_on_drop if acfg.queue_policy == "drop_oldest" else None)
            channel = WeightChannel(plan=self.resilience.plan, metrics=self.obs.metrics,
                                    sync_every=acfg.sync_every)
        self._async = AsyncCollector(
            trainer=self, queue=queue, channel=channel, num_actors=acfg.num_actors,
            max_staleness=acfg.max_staleness,
            updates_per_phase=self._async_updates_per_phase(),
            chunks_per_collection=self._async_chunks_per_collection(),
            # process mode: the actors are external run_actor processes
            spawn_actors=acfg.mode == "thread",
            chunk_timeout_s=acfg.actor_timeout_s,
            max_actor_restarts=acfg.max_actor_restarts, metrics=self.obs.metrics,
            tracer=self.obs.tracer, span=self.obs.span, member_factory=member_factory,
            transport=coordinator)
        self._async.version = self._async_version
        return self._async

    def _async_on_drop(self, chunk) -> None:
        """drop_oldest eviction callback: hand the evicted chunk back to the
        collector for regeneration under fresher weights."""
        if self._async is not None:
            self._async.requeue_dropped(chunk)

    def _async_produce_chunk(self, spec, params, version, channel) -> Dict[str, Any]:
        """One actor chunk, device and host halves, under the actor's
        adopted ``params`` (a channel snapshot — never the live policy,
        which the optimizer updates in place) and the spec's seeds. Serial
        generation by default; with ``train.continuous_batching`` the chunk
        decodes on an engine of the actor's own with in-flight weight
        swaps at segment boundaries. The payload always carries the
        sampler's exact behaviour logprobs — under in-flight swaps they are
        the only honest record of the (mixed-version) behaviour policy."""
        stats: Dict[str, float] = {}
        if self.config.train.continuous_batching:
            dev = self._async_produce_cb(spec, params, version, channel, stats)
            behavior = dev["behavior_logprobs"]
        else:
            dev = self._chunk_device(spec.prompt_ids, spec.prompt_mask, stats, model=params,
                                     seeds=spec.seeds)
            behavior = HostCopy({"lp": dev["gen_out"].response_logprobs})
        chunk = self._rollout_chunk_host(dev)
        chunk["stats"].update(stats)
        if isinstance(behavior, HostCopy):
            behavior = behavior.wait()["lp"]
        chunk["behavior_logprobs"] = np.asarray(behavior, np.float32)
        return chunk

    def _async_produce_cb(self, spec, params, version, channel,
                          stats: Dict[str, float]) -> Dict[str, Any]:
        """Continuous-batching actor chunk: slot-refill segment decode over
        the chunk's prompts with their per-row seeds, on an engine tagged
        with this actor thread, adopting newly published weights at every
        segment boundary (``ContinuousEngine.swap_params``' version check
        is one int compare; a real change flushes the prefix cache, so
        stale shared KV is never reused). Live rows keep decoding across a
        swap — their recorded logprobs stay the exact behaviour
        distribution. The group is scored under the last adopted weights."""
        gen_config, extra_kwargs = self._resolve_gen_config(eval_mode=False)
        ids, mask = spec.prompt_ids, spec.prompt_mask
        engine = self._cb_make_engine(gen_config, extra_kwargs, ids.shape[0], ids.shape[1],
                                      tag=("async", threading.get_ident()), params=params,
                                      version=version)
        engine.enqueue_prompts(ids, mask, spec.seeds)
        completed = []
        while engine.busy:
            completed.extend(engine.step())
            if channel is not None and engine.busy:
                fresh, fresh_version = channel.fetch(template=self.model)
                # speculative engines swap the (target, draft) pair at once
                engine.swap_params(self._engine_params(fresh), fresh_version)
        completed.sort(key=lambda c: c.index)
        stats["time/exp_generate"] = engine.stats.decode_s + engine.stats.refill_s
        stats["time/generate"] = engine.stats.decode_s
        gen_params = engine.params
        if int(self.config.engine.speculative):
            gen_params = gen_params[0]  # scoring runs under the target
        return self._cb_group_device(completed, model=gen_params)

    def _collect_async(self, num_rollouts: int, elements: list, stats: Dict[str, float],
                       acc: Dict[str, float]) -> None:
        """Learner-side drain: consume actor chunks in strict index order
        (running moments fold exactly as the serial path's) and finalize on
        this thread. ``begin_collection`` force-publishes the weights this
        collection is consumed under; ``end_collection`` announces the
        upcoming phase's end version — the staleness gate for the chunks
        feeding the NEXT collection."""
        collector = self._ensure_async_collector()
        collector.begin_collection()
        while len(elements) < num_rollouts:
            chunk = collector.next_chunk()
            self._rollout_chunk_finalize(chunk.payload, elements, stats, acc)
        collector.end_collection()
        stats.update(collector.collection_stats())

    def train_step(self, batch) -> Dict[str, Any]:
        stats = super().train_step(batch)
        if self._async is not None:
            # the learner's update clock IS the weight-channel version:
            # publish after every optimizer update (in-flight sync; thinned
            # by async_rl.sync_every inside the channel)
            self._async_version += 1
            self._async.on_update(self.model, self._async_version)
        return stats

    def _shutdown_collectors(self) -> None:
        # actors first (they draw from the prompt iterator), then the base
        # stops the prefetch workers and closes the iterator chain
        if self._async is not None:
            try:
                self._async.close()
            except Exception:  # pragma: no cover - defensive
                pass
        super()._shutdown_collectors()


    def make_experience(self, num_rollouts: int = 1024, iter_count: int = 0) -> None:
        """Collect ``num_rollouts`` experiences into the store."""
        if self._consume_skip_initial_experience():
            return
        logger.info("Collecting rollouts")
        if self.prompt_iterator is None:
            raise RuntimeError("add_prompt_pipeline must be called before make_experience")
        stats: Dict[str, float] = {}
        elements: list = []
        acc: Dict[str, float] = {"kl_sum": 0.0, "kl_batches": 0, "host_s": 0.0,
                                 "gen_tokens": 0, "chunks": 0, "slot_steps": 0,
                                 "live_slot_steps": 0}
        depth = int(self.config.train.rollout_pipeline_depth or 0)
        exp_time = perf_counter()
        # under the mesh each rank generates and scores its own rows, as many
        # decode steps as they need: the weights stay gathered meanwhile
        with unsharded(self.model):
            if self.config.async_rl.enabled:
                # actors generate — continuously, across collections — and
                # this thread only drains and finalizes; continuous_batching
                # selects the actors' engine path
                self._collect_async(num_rollouts, elements, stats, acc)
            elif self.config.train.continuous_batching:
                self._collect_continuous(num_rollouts, depth, elements, stats, acc)
            elif depth > 0:
                self._collect_pipelined(num_rollouts, depth, elements, stats, acc)
            else:
                self._collect_serial(num_rollouts, elements, stats, acc)
        self.mean_kl = acc["kl_sum"] / max(acc["kl_batches"], 1)
        stats["kl_ctl_value"] = self.kl_ctl.value
        stats["time/rollout_host"] = acc["host_s"]
        total = perf_counter() - exp_time
        stats["time/exp"] = total
        stats["time/rollout"] = total / max(acc["chunks"], 1)
        if total > 0 and acc["gen_tokens"]:
            stats["throughput/rollout_tokens_per_sec"] = acc["gen_tokens"] / total
        stats["rollout/gen_tokens"] = float(acc["gen_tokens"])
        if acc["slot_steps"]:
            # the continuous path already holds its engine's exact counts
            util = acc["live_slot_steps"] / acc["slot_steps"]
            stats.setdefault("throughput/slot_utilization", util)
            stats.setdefault("rollout/padded_decode_frac", 1.0 - util)
        # the rollout side's dynamics summaries and the health canary
        # (setdefault keeps the engine's exact counters)
        ref_hist = acc.get("ref_kl_hist")
        if ref_hist is not None:
            stats.update(self.obs.dynamics.summarize({"dist/ref_kl_hist": ref_hist}))
        gen_lens = acc.get("gen_lens")
        if gen_lens:
            stats.setdefault("rollout/gen_len_p50", float(np.percentile(gen_lens, 50)))
            stats.setdefault("rollout/gen_len_p95", float(np.percentile(gen_lens, 95)))
        if acc.get("rep_total"):
            stats.setdefault("rollout/repetition_frac", acc["rep_pairs"] / acc["rep_total"])
        self.obs.health.observe_rollout(stats)
        self.make_experience_stats = stats
        self.tracker.log(stats, step=iter_count)
        self.store.push(elements[:num_rollouts] if num_rollouts else elements)
        self._export_rollouts()

    # ------------------------------------------------------------------
    # optimization
    # ------------------------------------------------------------------

    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """GAE + clipped PPO objective on a rollout minibatch."""
        method: PPOConfig = self.config.method
        queries = batch["query_tensors"].to(torch.int64)
        responses = batch["response_tensors"].to(torch.int64)
        query_mask = batch["query_mask"]
        response_mask = batch["response_mask"].float()
        Q, R = queries.shape[1], responses.shape[1]
        old_logprobs = batch["logprobs"]
        old_values = batch["values"]
        rewards = batch["rewards"]
        behavior = batch.get("behavior_logprobs")

        if self.is_seq2seq:
            dec_in, dec_mask = self._decoder_inputs(responses, batch["response_mask"])
            out = self.model(queries, attention_mask=query_mask, decoder_input_ids=dec_in,
                             decoder_attention_mask=dec_mask)
            values_pred = out["value"]
        else:
            input_ids = torch.cat([queries, responses], dim=1)
            attention_mask = torch.cat([query_mask, batch["response_mask"]], dim=1)
            out = self.model(input_ids, attention_mask=attention_mask,
                             logits_span=(Q - 1, Q + R - 1))
            values_pred = out["value"][:, Q - 1 : Q + R - 1]
        logprobs = logprobs_of_labels(out["logits"], responses)
        entropy = entropy_of_logits(out["logits"]) if method.dist_sketches else None
        if self.mesh is not None:
            # the minibatch's [B, R] operands over data x fsdp: the loss (its
            # GAE scan, whitening and masked means) spans the global
            # minibatch on every rank, and each rank's backward keeps its
            # own rows' slice
            g = self.gather_rows
            logprobs, values_pred = g(logprobs), g(values_pred)
            old_logprobs, old_values, rewards = g(old_logprobs), g(old_values), g(rewards)
            response_mask = g(response_mask)
            behavior = None if behavior is None else g(behavior)
            entropy = None if entropy is None else g(entropy.detach())

        if method.loss_kernel == "pallas":
            # GAE + whitening + the clipped loss in the fused kernels, which
            # take the raw rewards
            loss, stats = method.loss_fused(
                logprobs=logprobs, values=values_pred, old_logprobs=old_logprobs,
                old_values=old_values, rewards=rewards, mask=response_mask,
                behavior_logprobs=behavior,
            )
            # 1.0 only when the kernels, not their plain versions, ran
            fused_ran = float(logprobs.is_cuda)
        else:
            # the staged loss: GAE and whitening on the batch, then the
            # clipped loss, in plain ops
            advantages, returns = method.get_advantages_and_returns(
                old_values, rewards, response_mask)
            loss, stats = method.loss(
                logprobs=logprobs, values=values_pred, old_logprobs=old_logprobs,
                old_values=old_values, advantages=advantages, returns=returns,
                mask=response_mask, behavior_logprobs=behavior,
            )
            fused_ran = 0.0
        stats["train/loss_kernel_pallas"] = torch.tensor(fused_ran, device=logprobs.device)
        if entropy is not None:
            stats.update(loss_sketches({"entropy": (entropy, response_mask)}))
        return self.with_router_aux((loss, stats), out)

    def prepare_learning(self) -> None:
        self.train_dataloader = self.store.create_loader(
            self.config.train.batch_size, shuffle=True, seed=self.config.train.seed)
        self.n_updates_per_batch = self.config.method.ppo_epochs
        self.total_steps = min(
            self.config.train.total_steps,
            self.config.train.epochs * self.n_updates_per_batch * len(self.train_dataloader),
        )

    def _triage_extra(self, arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """A triaged batch's GAE advantages and returns, and the per-token
        logprob deltas of one forward under the current weights (one
        process only; best effort: the tokens and masks are the part that
        matters)."""
        extra: Dict[str, np.ndarray] = {}
        values, rewards, mask = (arrays.get(k) for k in ("values", "rewards", "response_mask"))
        try:
            if values is not None and rewards is not None and mask is not None:
                adv, ret = self.config.method.get_advantages_and_returns(
                    torch.as_tensor(values), torch.as_tensor(rewards),
                    torch.as_tensor(mask, dtype=torch.float32))
                extra["advantages"] = adv.numpy()
                extra["returns"] = ret.numpy()
        except Exception:  # pragma: no cover - defensive, crash path
            pass
        needed = ("query_tensors", "response_tensors", "query_mask", "response_mask", "logprobs")
        try:
            # rank 0 alone triages: under the mesh a forward of its own would
            # break FSDP2's lockstep, so the deltas are left out there
            if not self.is_seq2seq and self.mesh is None and all(k in arrays for k in needed):
                dev = {k: torch.as_tensor(arrays[k]).to(self.device) for k in needed}
                Q, R = dev["query_tensors"].shape[1], dev["response_tensors"].shape[1]
                responses = dev["response_tensors"].to(torch.int64)
                with torch.no_grad():
                    out = self.model(
                        torch.cat([dev["query_tensors"].to(torch.int64), responses], dim=1),
                        attention_mask=torch.cat([dev["query_mask"], dev["response_mask"]], dim=1),
                        logits_span=(Q - 1, Q + R - 1))
                    new_logprobs = logprobs_of_labels(out["logits"], responses)
                extra["logprob_deltas"] = (new_logprobs.float().cpu().numpy()
                                           - np.asarray(arrays["logprobs"]))
        except Exception:  # pragma: no cover - defensive, crash path
            pass
        return extra

    def post_backward_callback(self) -> None:
        self.kl_ctl.update(self.mean_kl, n_steps=self.config.train.batch_size)
        skips = getattr(self.kl_ctl, "skipped", 0)
        if skips:
            # non-finite chunk KLs the controller refused to fold in
            self.metrics.set_gauge("health/kl_ctl_skips", float(skips))

    def post_epoch_callback(self) -> None:
        # fresh rollouts with the updated policy
        self.store.clear_history()
        self.make_experience(self.config.method.num_rollouts, self.iter_count)
        self.train_dataloader = self.store.create_loader(
            self.config.train.batch_size, shuffle=True, seed=self.config.train.seed)
