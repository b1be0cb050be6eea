"""PPO trainer: rollout collection with a KL penalty against a frozen
reference, reward scaling, GAE and the clipped objective.

Port of ``trlx_tpu/trainer/ppo.py`` (``PPOTrainer``) for causal models on
the continuous-batching path at rollout pipeline depth 0:

- ``__init__`` takes the frozen reference snapshot — the hydra branch
  (copies of the top ``num_layers_unfrozen`` blocks, final norm and tied
  embedding) when ``num_layers_unfrozen > 0``, else a full frozen copy of
  the backbone;
- ``make_experience`` → ``_collect_continuous``: prompt chunks are queued on
  the paged ``ContinuousEngine``; finished sequences are harvested at
  segment boundaries, grouped ``B`` at a time in completion order (the JAX
  order, so the store holds the same rows in the same order), scored (one
  policy forward with the value head and the hydra branch replay, on the
  flash-attention kernels), then scored by ``reward_fn`` on the host and
  finalized strictly in order (running moments, KL-penalty rewards,
  ``PPORLElement`` rows);
- ``loss_fn``: the train-step forward and the PPO loss through the fused
  loss kernels (``loss_kernel: pallas``; the trainer rejects the staged
  ``xla`` path), with the ``dist/entropy_hist`` sketch.
"""

import copy
from time import perf_counter
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.data.ppo_types import PPORLElement
from trlx_tpu_torch.models.builder import hydra_ref_params
from trlx_tpu_torch.models.ppo import PPOConfig, kl_penalty_rewards_np
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.base import TorchBaseTrainer, logger
from trlx_tpu_torch.utils import infinite_loader
from trlx_tpu_torch.utils.dynamics import entropy_of_logits, loss_sketches
from trlx_tpu_torch.utils.stats import RunningMoments, logprobs_of_labels


@register_trainer
class PPOTrainer(TorchBaseTrainer):
    model_head = "value"
    collects_rollouts = True

    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        method: PPOConfig = config.method
        if not isinstance(method, PPOConfig):
            raise ValueError("config.method must be PPOConfig")
        if self.reward_fn is None:
            raise ValueError("PPO requires a reward_fn")
        if 0 < method.num_rollouts < method.chunk_size:
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

    def _ref_snapshot(self) -> torch.nn.Module:
        """Frozen reference of the current weights (buffer-owning copies):
        the hydra branch, or the whole backbone when every layer trains."""
        if self.num_layers_unfrozen > 0:
            return hydra_ref_params(self.model, self.tcfg, self.num_layers_unfrozen)
        return copy.deepcopy(self.model.backbone).eval().requires_grad_(False)

    # ------------------------------------------------------------------
    # rollout collection
    # ------------------------------------------------------------------

    def add_prompt_pipeline(self, pipeline) -> None:
        loader = pipeline.create_loader(
            self.config.method.chunk_size, shuffle=True, seed=self.config.train.seed
        )
        self.prompt_iterator = infinite_loader(loader)

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

    @torch.no_grad()
    def _score(self, sequences, prompt_mask, response_tokens, response_mask):
        """The scoring forward of one (B, P, N) group: policy logprobs and
        values, and the frozen reference's logprobs (hydra branch replay on
        the trunk activations, or the full frozen copy). Logits at t
        predict token t + 1, so response token i is scored at P - 1 + i;
        the vocab projection is restricted to that span."""
        P, N = prompt_mask.shape[1], response_tokens.shape[1]
        nlu = self.num_layers_unfrozen
        full_mask = torch.cat([prompt_mask, response_mask], dim=1)
        span = (P - 1, P + N - 1)
        out = self.model(sequences, attention_mask=full_mask,
                         branch_layer=nlu if nlu > 0 else None, logits_span=span)
        logprobs = logprobs_of_labels(out["logits"], response_tokens)
        if nlu > 0:
            ref_out = self.ref_params(out["branch_input"], full_mask, None, span)
        else:
            ref_out = self.ref_params(sequences, attention_mask=full_mask, logits_span=span)
        return {
            "logprobs": logprobs,
            "ref_logprobs": logprobs_of_labels(ref_out["logits"], response_tokens),
            "values": out["value"][:, P - 1 : P + N - 1].float(),
        }

    def _dispatch_score(self, sequences, prompt_mask, response_tokens,
                        response_mask) -> Dict[str, torch.Tensor]:
        """Run the scoring forward on host rows; the outputs stay on the
        device until the host stage lands them."""
        def dev(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.int64).to(self.device)

        return self._score(dev(sequences), dev(prompt_mask), dev(response_tokens),
                           dev(response_mask))

    def _cb_group_device(self, group: list) -> Dict[str, Any]:
        """Device side of one harvested group: assemble the score batch
        from individually completed sequences and run the scoring forward."""
        prompt_ids = np.stack([c.prompt_ids for c in group]).astype(np.int32)
        prompt_mask = np.stack([c.prompt_mask for c in group]).astype(np.int32)
        response_tokens = np.stack([c.tokens for c in group]).astype(np.int32)
        response_mask = np.stack([c.mask for c in group]).astype(np.int32)
        sequences = np.concatenate([prompt_ids, response_tokens], axis=1)
        score_out = self._dispatch_score(sequences, prompt_mask, response_tokens,
                                         response_mask)
        return {"prompt_ids": prompt_ids, "prompt_mask": prompt_mask,
                "response_tokens": response_tokens, "response_mask": response_mask,
                "score_out": score_out}

    def _rollout_chunk_host(self, dev: Dict[str, Any]) -> Dict[str, Any]:
        """Host side of one group: decode strings, run ``reward_fn``, land
        the scoring outputs."""
        host_t0 = perf_counter()
        stats: Dict[str, float] = {}
        response_tokens, response_mask = dev["response_tokens"], dev["response_mask"]
        samples, prompts, outputs = self.decode(dev["prompt_ids"], response_tokens,
                                                append_eos_token=True)
        t0 = perf_counter()
        scores = np.asarray(self.reward_fn(samples=samples, prompts=prompts, outputs=outputs),
                            dtype=np.float32)
        stats["time/reward"] = stats["time/exp_score"] = perf_counter() - t0
        t0 = perf_counter()
        host = {k: v.cpu().numpy() for k, v in dev["score_out"].items()}
        stats["time/score"] = perf_counter() - t0
        return {"prompt_ids": dev["prompt_ids"], "prompt_mask": dev["prompt_mask"],
                "response_tokens": response_tokens, "response_mask": response_mask,
                "scores": scores, "host": host, "stats": stats,
                "host_s": perf_counter() - host_t0}

    def _rollout_chunk_finalize(self, chunk: Dict[str, Any], elements: list,
                                stats: Dict[str, float], acc: Dict[str, float]) -> None:
        """Ordered tail of one group: reward scaling (running moments),
        KL-penalty rewards and the store rows, in submission order."""
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

        prompt_ids, prompt_mask = chunk["prompt_ids"], chunk["prompt_mask"]
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
            ))

    def _collect_continuous(self, num_rollouts: int, elements: list,
                            stats: Dict[str, float], acc: Dict[str, float]) -> None:
        """Continuous-batching collection at pipeline depth 0: prompt chunks
        are queued while the expected rows cannot cover the target; every
        engine step's harvest is grouped B at a time in completion order,
        scored and finalized immediately; the partial tail flushes once the
        engine drains."""
        if num_rollouts <= 0:
            return
        gen_config, extra_kwargs = self._resolve_gen_config(eval_mode=False)
        state = {"engine": None, "supplied": 0, "finalized_rows": 0}
        harvest_buf: list = []

        def fetch_chunk() -> None:
            batch = next(self.prompt_iterator)
            ids = np.asarray(batch["input_ids"], np.int32)
            mask = np.asarray(batch["attention_mask"], np.int32)
            if state["engine"] is None:
                state["engine"] = self._cb_make_engine(gen_config, extra_kwargs,
                                                       ids.shape[0], ids.shape[1])
            state["engine"].enqueue_prompts(ids, mask, self._row_seeds(ids.shape[0]))
            state["supplied"] += ids.shape[0]

        def submit_group(group: list) -> None:
            chunk = self._rollout_chunk_host(self._cb_group_device(group))
            state["finalized_rows"] += int(chunk["prompt_ids"].shape[0])
            self._rollout_chunk_finalize(chunk, elements, stats, acc)

        while True:
            while len(elements) + state["supplied"] - state["finalized_rows"] < num_rollouts:
                fetch_chunk()
            engine = state["engine"]
            B = engine.B
            if not engine.busy:
                while harvest_buf:
                    group, harvest_buf = harvest_buf[:B], harvest_buf[B:]
                    submit_group(group)
                if len(elements) >= num_rollouts:
                    break
                continue
            harvest_buf.extend(engine.step())
            while len(harvest_buf) >= B:
                group, harvest_buf = harvest_buf[:B], harvest_buf[B:]
                submit_group(group)

        engine = state["engine"]
        stats.update(engine.stats.metrics())
        stats["time/exp_generate"] = engine.stats.decode_s + engine.stats.refill_s
        stats["time/generate"] = engine.stats.decode_s

    def make_experience(self, num_rollouts: int = 1024, iter_count: int = 0) -> None:
        """Collect ``num_rollouts`` experiences into the store."""
        logger.info("Collecting rollouts")
        if self.prompt_iterator is None:
            raise RuntimeError("add_prompt_pipeline must be called before make_experience")
        stats: Dict[str, float] = {}
        elements: list = []
        acc: Dict[str, float] = {"kl_sum": 0.0, "kl_batches": 0, "host_s": 0.0,
                                 "gen_tokens": 0, "chunks": 0}
        exp_time = perf_counter()
        self._collect_continuous(num_rollouts, elements, stats, acc)
        self.mean_kl = acc["kl_sum"] / max(acc["kl_batches"], 1)
        stats["kl_ctl_value"] = self.kl_ctl.value
        stats["time/rollout_host"] = acc["host_s"]
        total = perf_counter() - exp_time
        stats["time/exp"] = total
        stats["time/rollout"] = total / max(acc["chunks"], 1)
        if total > 0 and acc["gen_tokens"]:
            stats["throughput/rollout_tokens_per_sec"] = acc["gen_tokens"] / total
        stats["rollout/gen_tokens"] = float(acc["gen_tokens"])
        self.make_experience_stats = stats
        self.tracker.log(stats, step=iter_count)
        self.store.push(elements[:num_rollouts] if num_rollouts else elements)

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

        input_ids = torch.cat([queries, responses], dim=1)
        attention_mask = torch.cat([query_mask, batch["response_mask"]], dim=1)
        out = self.model(input_ids, attention_mask=attention_mask, logits_span=(Q - 1, Q + R - 1))
        logprobs = logprobs_of_labels(out["logits"], responses)
        values_pred = out["value"][:, Q - 1 : Q + R - 1]

        # GAE + whitening + the clipped loss in the fused kernels, which take
        # the raw rewards
        loss, stats = method.loss_fused(
            logprobs=logprobs, values=values_pred, old_logprobs=old_logprobs,
            old_values=old_values, rewards=rewards, mask=response_mask,
            behavior_logprobs=behavior,
        )
        # 1.0 only when the kernels, not their plain versions, ran
        stats["train/loss_kernel_pallas"] = torch.tensor(
            float(logprobs.is_cuda), device=logprobs.device)
        if method.dist_sketches:
            stats.update(loss_sketches(
                {"entropy": (entropy_of_logits(out["logits"]), response_mask)}))
        return loss, stats

    def prepare_learning(self) -> None:
        self.train_dataloader = self.store.create_loader(
            self.config.train.batch_size, shuffle=True, seed=self.config.train.seed)
        self.n_updates_per_batch = self.config.method.ppo_epochs
        self.total_steps = min(
            self.config.train.total_steps,
            self.config.train.epochs * self.n_updates_per_batch * len(self.train_dataloader),
        )

    def post_backward_callback(self) -> None:
        self.kl_ctl.update(self.mean_kl, n_steps=self.config.train.batch_size)

    def post_epoch_callback(self) -> None:
        # fresh rollouts with the updated policy
        self.store.clear_history()
        self.make_experience(self.config.method.num_rollouts, self.iter_count)
        self.train_dataloader = self.store.create_loader(
            self.config.train.batch_size, shuffle=True, seed=self.config.train.seed)
