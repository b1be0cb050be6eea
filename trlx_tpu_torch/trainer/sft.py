"""Supervised fine-tuning trainer.

Port of ``trlx_tpu/trainer/sft.py`` (``SFTTrainer``): cross-entropy on
plain samples, or on prompt/output dialogues with the prompt turns left
out of the loss through ``IGNORE_INDEX`` labels (``DialogStore``).
``method.logit_chunk > 0`` streams the vocab projection in T-chunks.
Evaluation generates on the paged engine (``trainer/base.py``).

Over a mesh of several processes (``parallel.data`` / ``fsdp`` /
``sequence``, JAX's ``examples/long_context_sft.py``) each rank takes its
rows over ``data`` x ``fsdp`` and, over ``sequence``, its zigzag shard of
every row (:meth:`SFTTrainer.host_batch`); the loss is the global
token mean (``models/sft.py::_token_mean``) and FSDP2 sums the gradients
(``parallel/sharding.py``). Evaluation generates with a cache, so every
rank generates its rows whole, from the same seed.
"""

from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch

from trlx_tpu_torch.models.sft import IGNORE_INDEX, SFTConfig, next_token_labels
from trlx_tpu_torch.parallel.mesh import axis_sizes
from trlx_tpu_torch.parallel.sharding import shard_batch
from trlx_tpu_torch.pipeline.offline_pipeline import DialogStore, tokenize_dialogue
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.base import TorchBaseTrainer


@register_trainer
class SFTTrainer(TorchBaseTrainer):
    model_head = None
    sequence_ok = True

    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        if not isinstance(config.method, SFTConfig):
            raise ValueError("config.method must be SFTConfig")
        self.store: DialogStore = None
        # the ``sequence`` group of the ring: only this trainer's loss
        # forward, on the zigzag shards of ``host_batch``, is given it
        n = 1 if self.mesh is None else axis_sizes(self.mesh)["sequence"]
        self.sequence_group = self.mesh["sequence"].get_group() if n > 1 else None

    def make_experience(self, samples: List[Union[str, List[str]]], seq_length: int) -> None:
        """Tokenize samples (strings or interleaved prompt/output lists)
        into a loss-masked :class:`DialogStore`."""
        dialogs = [tokenize_dialogue(s, self.tokenizer, seq_length) for s in samples]
        self.store = DialogStore(dialogs, self.tokenizer)

    def loss_fn(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        chunk = self._resolved_logit_chunk()
        # the labels are the next-token labels (``host_batch``); under the
        # mesh the token count is summed over every rank
        reduce = None if self.mesh is None else _all_reduce_sum
        kw = {}
        if self.sequence_group is not None:
            kw = {"positions": batch["positions"], "sequence_group": self.sequence_group}
        if chunk:
            # logits_span (0, 0): hidden states only; chunked_loss projects
            out = self.model(batch["input_ids"], attention_mask=batch["attention_mask"],
                             logits_span=(0, 0), **kw)
            return self.with_router_aux(self.config.method.chunked_loss(
                self.model, out["hidden_states"], batch["labels"], chunk, reduce), out)
        out = self.model(batch["input_ids"], attention_mask=batch["attention_mask"], **kw)
        return self.with_router_aux(self.config.method.loss(out["logits"], batch["labels"],
                                                            reduce), out)

    def host_batch(self, items: Dict[str, Any], unit: int = 1) -> Dict[str, Any]:
        """The step's arrays: the labels shifted to the next-token labels
        on the whole rows (the last position ignored). Under the mesh, this
        rank's part (``parallel/sharding.py::shard_batch``): over
        ``sequence`` the global positions are taken on the whole rows, and
        the rows padded on the right to a multiple of ``2 x sequence``
        (masked keys, ignored labels) before the zigzag split."""
        arrays = {k: np.asarray(items[k]) for k in ("input_ids", "attention_mask", "labels")}
        arrays["labels"] = next_token_labels(arrays["labels"])
        if self.mesh is None:
            return arrays
        n = axis_sizes(self.mesh)["sequence"]
        if n > 1:
            mask = arrays["attention_mask"]
            arrays["positions"] = np.maximum(np.cumsum(mask, axis=1) - 1, 0)
            pad = (-mask.shape[1]) % (2 * n)
            fill = {"labels": IGNORE_INDEX, "input_ids": self.tokenizer.pad_token_id}
            arrays = {k: np.pad(v, ((0, 0), (0, pad)), constant_values=fill.get(k, 0))
                      for k, v in arrays.items()}
        return shard_batch(arrays, self.mesh, sequence_sharded=n > 1,
                           micro=max(1, int(self.config.train.grad_accum)))

    def prepare_learning(self) -> None:
        self._resolved_logit_chunk()  # the ignored-knob warning, before any step
        self.train_dataloader = self.store.create_loader(
            self.config.train.batch_size, shuffle=True, seed=self.config.train.seed)
        self.n_updates_per_batch = 1
        self.total_steps = min(self.config.train.total_steps,
                               self.config.train.epochs * len(self.train_dataloader))


def _all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every rank of the world (a copy)."""
    import torch.distributed as dist

    x = x.clone()
    dist.all_reduce(x)
    return x
