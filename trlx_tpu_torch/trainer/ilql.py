"""ILQL trainer: offline RL from reward-labeled samples.

Port of ``trlx_tpu/trainer/ilql.py``:

- :func:`make_experience` tokenizes dialogues, builds per-token action and
  state indices (an action at output position t − 1, the causal shift),
  normalizes the returns over the dataset (float64) and puts each scalar
  return on its sample's last action; :func:`make_experience_seq2seq`
  (``model.model_arch_type: seq2seq``) sends the prompt to the encoder and
  the output to the decoder, actions at decoder positions 0 … L − 2 and
  states 0 … L − 1;
- ``loss_fn`` runs the backbone once (for T5 the encoder and the decoder
  on the output tokens), gathers hidden states at the action and state
  indices, and applies the heads and the vocab projection to the gathered
  rows only;
- the target-Q heads Polyak-sync every ``steps_for_target_q_sync``
  optimizer steps (``post_backward_callback``, after the batch's update);
- generation shapes the sampling logits to ``log π + β (min target-Q − V)``
  through the engine's ``adjust_logits`` hook, before the sampler's own
  top-k / temperature filters.

``train.rollout_pipeline_depth`` > 0 tokenizes in chunks on a
:class:`~trlx_tpu_torch.pipeline.rollout_pipeline.RolloutPipeline` worker
while the calling thread builds the indices of earlier chunks (the same
store at any depth). A seq2seq trainer evaluates through
``ops/sampling.py::generate_seq2seq`` on the serial engine, the hook
reading the decoder step's heads.
"""

import logging
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from trlx_tpu_torch.data.tokenizer import Tokenizer
from trlx_tpu_torch.models.heads import sync_target_q_params
from trlx_tpu_torch.models.ilql import ILQLConfig, batched_index_select
from trlx_tpu_torch.pipeline.offline_pipeline import (
    ILQLRolloutStorage,
    ILQLSeq2SeqRolloutStorage,
    tokenize_dialogue,
)
from trlx_tpu_torch.pipeline.rollout_pipeline import RolloutPipeline
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.base import TorchBaseTrainer

logger = logging.getLogger(__name__)

# samples per pipelined tokenization chunk
_TOKENIZE_CHUNK = 64


def _fold_tokenized(samples, tokenizer: Optional[Tokenizer], max_length: int,
                    pipeline_depth: int, fold: Callable, chunk_size: int = _TOKENIZE_CHUNK) -> None:
    """Feed ``fold`` the tokenized samples in order: with
    ``pipeline_depth`` > 0 chunks tokenize on the pipeline worker while
    ``fold`` drains earlier chunks here (one worker and an ordered drain:
    the same output as the serial path)."""
    if tokenizer is None:
        fold(list(samples))  # already tokenized
        return
    if pipeline_depth > 0 and len(samples) > chunk_size:
        with RolloutPipeline(depth=pipeline_depth, finalize=fold,
                             name="ilql_tokenize") as pipe:
            for start in range(0, len(samples), chunk_size):
                part = samples[start : start + chunk_size]
                pipe.submit(lambda part=part: [tokenize_dialogue(s, tokenizer, max_length)
                                               for s in part])
        return
    fold([tokenize_dialogue(s, tokenizer, max_length) for s in samples])


def _causal_sample_arrays(sample) -> tuple:
    """``(input_ids, actions_ixs, states_ixs, dones)`` of one tokenized
    dialogue. Actions index the shifted sequence: the action chosen at
    state t is the token at t + 1."""
    length = 0
    input_ids = np.array([t for m in sample for t in m.tokens], dtype=np.int32)
    actions_ixs = []
    for dm in sample:
        if dm.is_output:
            actions_ixs.append(np.arange(length - 1, length + len(dm.tokens) - 1, dtype=np.int32))
        length += len(dm.tokens)
    ixs = np.concatenate(actions_ixs) if actions_ixs else np.zeros(0, np.int32)
    states_ixs = np.concatenate([ixs, np.array([length - 1], np.int32)])
    dones = np.array([1] * (len(states_ixs) - 1) + [0], dtype=np.int32)
    return input_ids, ixs, states_ixs, dones


def make_experience(
    samples: List[Union[str, List[str]]],
    rewards: List[float],
    tokenizer: Optional[Tokenizer] = None,
    max_length: int = 2048,
    pipeline_depth: int = 0,
) -> ILQLRolloutStorage:
    """Tokenize samples (already-tokenized dialogues when ``tokenizer`` is
    None) and shape their rewards into an :class:`ILQLRolloutStorage`;
    ``pipeline_depth`` > 0 overlaps the tokenization with the index
    building (:func:`_fold_tokenized`)."""
    logger.info("Collecting rollouts")
    rows: list = []
    _fold_tokenized(samples, tokenizer, max_length, pipeline_depth,
                    lambda chunk: rows.extend(_causal_sample_arrays(d) for d in chunk))
    all_input_ids = [r[0] for r in rows]
    all_actions_ixs = [r[1] for r in rows]

    sample_lengths = np.array([len(x) for x in all_input_ids])
    output_lengths = np.array([len(x) for x in all_actions_ixs])
    prompt_lengths = sample_lengths - output_lengths
    logger.info(
        "Experience string stats: prompt %.2f ∈ [%d, %d], output %.2f ∈ [%d, %d], "
        "sample %.2f ∈ [%d, %d]",
        prompt_lengths.mean(), prompt_lengths.min(), prompt_lengths.max(),
        output_lengths.mean(), output_lengths.min(), output_lengths.max(),
        sample_lengths.mean(), sample_lengths.min(), sample_lengths.max(),
    )

    attention_mask = [np.ones(len(x), np.int32) for x in all_input_ids]
    return ILQLRolloutStorage(all_input_ids, attention_mask,
                              _token_rewards(rewards, all_actions_ixs),
                              [r[2] for r in rows], all_actions_ixs, [r[3] for r in rows])


def _token_rewards(rewards, all_actions_ixs) -> List[np.ndarray]:
    """Dataset-level return normalization (float64); each scalar return
    lands on its sample's last action token."""
    returns = np.asarray(rewards, dtype=np.float64)
    returns = returns - returns.mean()
    std = returns.std()
    if not np.isnan(std) and std > 0:
        returns = returns / (std + np.finfo(returns.dtype).eps)
    token_rewards = [np.zeros(len(ixs), np.float32) for ixs in all_actions_ixs]
    for rs, ret in zip(token_rewards, returns):
        if len(rs):
            rs[-1] = ret
    return token_rewards


def _seq2seq_sample_arrays(sample) -> tuple:
    """``(prompt_ids, output_ids, actions_ixs, states_ixs, dones)`` of one
    tokenized dialogue: the prompt turns feed the encoder, the output turns
    the decoder, whose positions the actions and states index."""
    prompt = np.asarray([t for m in sample if not m.is_output for t in m.tokens], np.int32)
    output = np.asarray([t for m in sample if m.is_output for t in m.tokens], np.int32)
    actions_ixs = np.arange(0, max(len(output) - 1, 0), dtype=np.int32)
    states_ixs = np.concatenate([actions_ixs, np.array([max(len(output) - 1, 0)], np.int32)])
    dones = np.array([1] * (len(states_ixs) - 1) + [0], np.int32)
    return prompt, output, actions_ixs, states_ixs, dones


def make_experience_seq2seq(
    samples: List[Union[str, List[str]]],
    rewards: List[float],
    tokenizer: Optional[Tokenizer] = None,
    max_length: int = 2048,
    pipeline_depth: int = 0,
) -> ILQLSeq2SeqRolloutStorage:
    """:func:`make_experience` for a seq2seq model: an
    :class:`ILQLSeq2SeqRolloutStorage` of (prompt, output) pairs with the
    actions and states over decoder positions."""
    logger.info("Collecting rollouts")
    rows: list = []
    _fold_tokenized(samples, tokenizer, max_length, pipeline_depth,
                    lambda chunk: rows.extend(_seq2seq_sample_arrays(d) for d in chunk))
    prompts, outputs, actions_ixs, states_ixs, dones = (list(col) for col in zip(*rows))
    return ILQLSeq2SeqRolloutStorage(
        prompts, [np.ones(len(x), np.int32) for x in prompts], outputs,
        _token_rewards(rewards, actions_ixs), states_ixs, actions_ixs, dones)


@register_trainer
class ILQLTrainer(TorchBaseTrainer):
    model_head = "ilql"
    supports_seq2seq = True

    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        if not isinstance(config.method, ILQLConfig):
            raise ValueError("config.method must be ILQLConfig")
        self.ilql: ILQLConfig = config.method
        self.store: Optional[ILQLRolloutStorage] = None

    def make_experience(self, samples, rewards, max_length: int = 2048) -> None:
        build = make_experience_seq2seq if self.is_seq2seq else make_experience
        self.store = build(samples, rewards, self.tokenizer, max_length=max_length,
                           pipeline_depth=int(self.config.train.rollout_pipeline_depth or 0))

    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, Any]]:
        # logits_span (0, 0): hidden states only — the cross-entropy needs
        # logits at the action positions alone, projected below
        if self.is_seq2seq:  # actions and states index the decoder positions
            action_source = batch["decoder_input_ids"]
            out = self.model.backbone_forward(
                batch["input_ids"], attention_mask=batch["attention_mask"],
                decoder_input_ids=action_source, logits_span=(0, 0))
        else:
            action_source = batch["input_ids"]
            out = self.model.backbone_forward(
                action_source, attention_mask=batch["attention_mask"], logits_span=(0, 0))
        hidden = out["hidden_states"]
        hs_actions = batched_index_select(hidden, batch["actions_ixs"])
        hs_states = batched_index_select(hidden, batch["states_ixs"])
        qs, target_qs, vs = self.model.heads_on(hs_actions, hs_states)
        logits = self.model.project_logits(hs_actions)
        # the action itself: the token after the action index
        actions = action_source[:, 1:].to(torch.int64).gather(
            1, batch["actions_ixs"].to(torch.int64))
        return self.with_router_aux(
            self.ilql.loss(logits=logits, qs=qs, target_qs=target_qs, vs=vs, actions=actions,
                           rewards=batch["rewards"], dones=batch["dones"]), out)

    def prepare_learning(self) -> None:
        self.train_dataloader = self.store.create_loader(
            self.config.train.batch_size, shuffle=True, seed=self.config.train.seed)
        self.n_updates_per_batch = 1
        self.total_steps = min(self.config.train.total_steps,
                               self.config.train.epochs * len(self.train_dataloader))

    def post_backward_callback(self) -> None:
        if self.iter_count % self.ilql.steps_for_target_q_sync == 0:
            sync_target_q_params(self.model, self.ilql.alpha)

    def adjust_logits_fn(self, extra_kwargs: Dict[str, Any]) -> Optional[Callable]:
        """logits ← log π + β (min target-Q − V), in f32; the sampler's
        top-k / temperature filters then apply to the shaped logits (top-k
        selection is invariant under a positive temperature, so the order
        matches the reference's top-k-then-temperature). ``beta`` resolves
        per generate call, so overrides and eval sweeps take effect."""
        beta = float(extra_kwargs.get("beta", 1.0))

        def adjust(step_out: Dict[str, Any], logits: torch.Tensor) -> torch.Tensor:
            target_qs = step_out["target_qs"]
            q = target_qs[0]
            for tq in target_qs[1:]:
                q = torch.minimum(q, tq)
            adv = q.float() - step_out["vs"].float()  # vs: [B, 1]
            return torch.log_softmax(logits.float(), dim=-1) + beta * adv

        return adjust
