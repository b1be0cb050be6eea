"""Supervised fine-tuning trainer.

Port of ``trlx_tpu/trainer/sft.py`` (``SFTTrainer``): cross-entropy on
plain samples, or on prompt/output dialogues with the prompt turns left
out of the loss through ``IGNORE_INDEX`` labels (``DialogStore``).
``method.logit_chunk > 0`` streams the vocab projection in T-chunks.
Evaluation generates on the paged engine (``trainer/base.py``).
"""

from typing import Dict, List, Tuple, Union

import torch

from trlx_tpu_torch.models.sft import SFTConfig
from trlx_tpu_torch.pipeline.offline_pipeline import DialogStore, tokenize_dialogue
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.base import TorchBaseTrainer


@register_trainer
class SFTTrainer(TorchBaseTrainer):
    model_head = None

    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        if not isinstance(config.method, SFTConfig):
            raise ValueError("config.method must be SFTConfig")
        self.store: DialogStore = None

    def make_experience(self, samples: List[Union[str, List[str]]], seq_length: int) -> None:
        """Tokenize samples (strings or interleaved prompt/output lists)
        into a loss-masked :class:`DialogStore`."""
        dialogs = [tokenize_dialogue(s, self.tokenizer, seq_length) for s in samples]
        self.store = DialogStore(dialogs, self.tokenizer)

    def loss_fn(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        chunk = self._resolved_logit_chunk()
        if chunk:
            # logits_span (0, 0): hidden states only; chunked_loss projects
            out = self.model(batch["input_ids"], attention_mask=batch["attention_mask"],
                             logits_span=(0, 0))
            return self.with_router_aux(self.config.method.chunked_loss(
                self.model, out["hidden_states"], batch["labels"], chunk), out)
        out = self.model(batch["input_ids"], attention_mask=batch["attention_mask"])
        return self.with_router_aux(self.config.method.loss(out["logits"], batch["labels"]),
                                    out)

    def prepare_learning(self) -> None:
        self._resolved_logit_chunk()  # the ignored-knob warning, before any step
        self.train_dataloader = self.store.create_loader(
            self.config.train.batch_size, shuffle=True, seed=self.config.train.seed)
        self.n_updates_per_batch = 1
        self.total_steps = min(self.config.train.total_steps,
                               self.config.train.epochs * len(self.train_dataloader))
