"""DPO trainer: preference pairs → logistic loss on implicit reward margins.

Port of ``trlx_tpu/trainer/dpo.py`` (``DPOTrainer``), offline like SFT:
``trlx_tpu_torch.train(samples=[(prompt, chosen, rejected), ...],
config=default_dpo_config())``.

- ``make_experience`` tokenizes the triples (:class:`DPOStore`) and runs
  the one reference pass: the current weights under ``torch.no_grad``,
  before any optimizer step (``train()`` collects first; a resume loads
  inside ``learn()``), so the weights *are* the frozen reference and no
  reference copy of the model is ever kept. ``reference_free`` writes
  zeros;
- ``loss_fn``: one forward over the interleaved chosen and rejected rows,
  the summed f32 completion logprobs (:func:`completion_logps`, the full
  logits or streamed through the vocab projection with
  ``method.logit_chunk``), :meth:`DPOConfig.loss`, then
  ``with_router_aux`` (an MoE policy's router losses);
- evaluation generates on the paged engine (``trainer/base.py``);
- over a mesh (``parallel.data`` / ``fsdp``) each rank takes whole pairs
  of every batch, in the reference pass and in the step; the pairs'
  summed logprobs of every rank are joined before the loss, so it is the
  global mean.

The seq2seq path is not ported (``NotImplementedError``, as in JAX).
"""

import logging
import time
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from trlx_tpu_torch.models.dpo import DPOConfig
from trlx_tpu_torch.parallel.sharding import allgather_host, row_part
from trlx_tpu_torch.pipeline.dpo_pipeline import DPOStore
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.base import TorchBaseTrainer
from trlx_tpu_torch.utils.stats import logprobs_of_labels

logger = logging.getLogger(__name__)

__all__ = ["DPOTrainer", "completion_logps"]


def completion_logps(model, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                     out_mask: torch.Tensor, chunk: int = 0,
                     logprobs=logprobs_of_labels) -> Tuple[torch.Tensor, Any]:
    """Summed logprob of each row's completion tokens (token t predicted at
    position t − 1, counted where ``out_mask`` and ``attention_mask`` hold),
    in f32, and the forward's outputs (the router losses of an MoE policy).

    With ``chunk`` > 0 the vocab projection streams in T-chunks
    (``ops/chunked.py``): the ``[B, T, V]`` logits never exist whole, which
    matters more here than in SFT, as every pair holds two rows.
    ``logprobs`` reads the logits (the trainer's ``label_logprobs`` under
    a vocabulary split over ``model``)."""
    sel = (out_mask[:, 1:] * attention_mask[:, 1:]).float()
    labels = input_ids[:, 1:]
    if chunk:
        from trlx_tpu_torch.ops.chunked import stream_projected_reduce

        out = model(input_ids, attention_mask=attention_mask, logits_span=(0, 0))

        def body(carry, logits, lab, s):
            return carry + torch.sum(logprobs(logits, lab) * s, dim=1)

        sums = stream_projected_reduce(
            model, out["hidden_states"][:, :-1], [(labels, 0), (sel, 0.0)], chunk,
            torch.zeros((input_ids.shape[0],), dtype=torch.float32, device=input_ids.device),
            body)
        return sums, out
    out = model(input_ids, attention_mask=attention_mask)
    lp = logprobs(out["logits"][:, :-1], labels)
    # an f32 sum: a bf16 sum of hundreds of logprobs has an ulp of O(1)
    # nats, the order of real DPO margins
    return torch.sum(lp.float() * sel, dim=1), out


@register_trainer
class DPOTrainer(TorchBaseTrainer):
    model_head = None

    def __init__(self, config, **kwargs):
        # the JAX construction checks, before the model is built
        if not isinstance(config.method, DPOConfig):
            raise ValueError("config.method must be DPOConfig")
        if config.model.model_arch_type == "seq2seq":
            raise NotImplementedError("DPO is implemented for causal LMs")
        super().__init__(config, **kwargs)
        self.store: DPOStore = None
        self.ref_pass_time = 0.0  # seconds of the last reference pass

    @torch.no_grad()
    def make_experience(self, samples: Sequence[Sequence[str]], seq_length: int) -> None:
        """Tokenize the preference triples and write every pair's
        frozen-reference completion logprobs into the store."""
        self.store = DPOStore(samples, self.tokenizer, seq_length)
        if self.config.method.reference_free:
            for e in self.store.history:
                e["ref_chosen_logp"] = e["ref_rejected_logp"] = 0.0
            return
        logger.info("Reference logprobs for %d pairs", len(self.store))
        t0 = time.perf_counter()
        chunk = self._resolved_logit_chunk()
        bs = min(self.config.train.batch_size, len(self.store))
        idx = 0
        for batch in self.store.create_loader(bs, shuffle=False, drop_last=False):
            arrays = {k: np.asarray(batch[k]) for k in ("input_ids", "attention_mask",
                                                        "out_mask")}
            # under the mesh each rank scores its pairs (every pair when the
            # data axes do not divide them), joined in rank order
            part = row_part(arrays["input_ids"].shape[0], self.mesh, unit=2)
            if part is not None:
                arrays = {k: v[part] for k, v in arrays.items()}
            ids, attn, out = (torch.as_tensor(arrays[k]).to(self.device)
                              for k in ("input_ids", "attention_mask", "out_mask"))
            # the weights before any update are the reference
            logps = completion_logps(self.model, ids, attn, out, chunk)[0].cpu().numpy()
            if part is not None:
                logps = np.concatenate(allgather_host(logps, self.mesh))
            n = logps.shape[0] // 2
            for j in range(n):  # interleaved (c0, r0, c1, r1, ...)
                self.store.history[idx + j]["ref_chosen_logp"] = float(logps[2 * j])
                self.store.history[idx + j]["ref_rejected_logp"] = float(logps[2 * j + 1])
            idx += n
        assert idx == len(self.store)
        self.ref_pass_time = time.perf_counter() - t0

    def loss_fn(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        with self.vocab_local():
            logps, out = completion_logps(self.model, batch["input_ids"],
                                          batch["attention_mask"], batch["out_mask"],
                                          self._resolved_logit_chunk(), self.label_logprobs)
        refs = batch["ref_logps"]
        if self.mesh is not None:
            # every rank's pairs (whole, interleaved): the loss is the global
            # mean, and each rank's backward keeps its own pairs
            logps, refs = self.gather_rows(logps), self.gather_rows(refs)
        # chosen at even rows, rejected at odd
        return self.with_router_aux(self.config.method.loss(
            policy_chosen_logps=logps[0::2], policy_rejected_logps=logps[1::2],
            ref_chosen_logps=refs[0::2], ref_rejected_logps=refs[1::2]), out)

    def host_batch(self, items: Dict[str, Any], unit: int = 2) -> Dict[str, Any]:
        """The step's rows: under the mesh whole pairs (two interleaved
        rows) per rank."""
        return super().host_batch(items, unit=unit)

    def prepare_learning(self) -> None:
        if len(self.store) < self.config.train.batch_size:
            raise ValueError(
                f"preference dataset has {len(self.store)} pairs but "
                f"train.batch_size={self.config.train.batch_size}; the loader "
                "drops incomplete batches, so training would silently run zero "
                "updates — lower train.batch_size or provide more pairs"
            )
        self.train_dataloader = self.store.create_loader(
            self.config.train.batch_size, shuffle=True, seed=self.config.train.seed)
        self.n_updates_per_batch = 1
        self.total_steps = min(self.config.train.total_steps,
                               self.config.train.epochs * len(self.train_dataloader))
