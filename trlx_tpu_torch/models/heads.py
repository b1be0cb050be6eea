"""Value and Q heads and the policy wrappers of the PPO and ILQL paths.

Port of ``trlx_tpu/models/heads.py`` for causal models:

- :class:`MLPHead`: Linear(E→2E) in the compute dtype → ReLU →
  Linear(2E→out) in f32, the JAX head's numerics;
- :class:`CausalLMWithValueHead`, which adds ``out["value"]`` (``[B, T]``
  f32) to the backbone's outputs. The generation engines pick the value
  up as a last-position output, so a harvested sequence carries the value
  prediction beside each sampled token;
- :class:`ILQLHeadsModule` (a V head, ``n`` Q heads and ``n`` target-Q
  heads), :class:`CausalLMWithILQLHeads` and the Polyak
  :func:`sync_target_q_params`. The target heads take no gradient (their
  outputs are detached, the JAX ``stop_gradient``) and stay out of the
  optimizer (``builder.trainable_mask``): they move only by the sync;
- the seq2seq (T5) wrappers :class:`Seq2SeqLMWithValueHead` and
  :class:`Seq2SeqLMWithILQLHeads`, whose heads read the *decoder* hidden
  states; their ``decode`` (the cached decoder step of
  ``ops/sampling.py::generate_seq2seq``) adds the heads' outputs, so the
  value and ILQL's Q/V reach the sampling hook as they do on the causal
  path.
"""

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from trlx_tpu_torch.models.seq2seq import Seq2SeqConfig, T5Transformer
from trlx_tpu_torch.models.transformer import (
    CausalTransformer,
    TransformerConfig,
    _linear,
    seeded_init_,
)

__all__ = ["MLPHead", "CausalLMWithValueHead", "ILQLHeadsModule", "CausalLMWithILQLHeads",
           "Seq2SeqLMWithValueHead", "Seq2SeqLMWithILQLHeads", "sync_target_q_params"]


class MLPHead(nn.Module):
    """Two-layer MLP head: Linear(E→2E) → ReLU → Linear(2E→out); the output
    layer computes in f32."""

    def __init__(self, cfg: TransformerConfig, out_features: int):
        super().__init__()
        self.dtype = cfg.dtype
        kw = dict(dtype=cfg.param_dtype)
        self.in_proj = nn.Linear(cfg.hidden_size, 2 * cfg.hidden_size, **kw)
        self.out_proj = nn.Linear(2 * cfg.hidden_size, out_features, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(_linear(self.in_proj, x, self.dtype))
        return _linear(self.out_proj, h.float(), torch.float32)


class CausalLMWithValueHead(nn.Module):
    """Policy LM + scalar value head on the final hidden states."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.config = cfg
        self.backbone = CausalTransformer(cfg)
        self.v_head = MLPHead(cfg, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX initialisers: the backbone's, and normal(0.02) kernels with
        zero biases for the head."""
        self.backbone.reset_parameters(generator)
        seeded_init_(self.v_head, generator)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        cache=None,
        cache_index: Any = None,
        logits_span: Optional[Tuple[int, int]] = None,
        branch_layer: Optional[int] = None,
    ) -> Dict[str, Any]:
        out = self.backbone(
            input_ids, attention_mask=attention_mask, positions=positions, cache=cache,
            cache_index=cache_index, logits_span=logits_span, branch_layer=branch_layer,
        )
        out["value"] = self.v_head(out["hidden_states"])[..., 0]
        return out

    def forward_branch(self, hidden_states, branch_layer, attention_mask=None,
                       positions=None, logits_span=None):
        return self.backbone.forward_branch(
            hidden_states, branch_layer, attention_mask, positions, logits_span
        )


class ILQLHeadsModule(nn.Module):
    """V head + ``n`` Q heads + ``n`` target-Q heads over hidden states
    (``n`` = 2 with ``two_qs``), named as in the JAX tree: ``v_head``,
    ``q_head_<i>``, ``target_q_head_<i>``."""

    def __init__(self, cfg: TransformerConfig, two_qs: bool = True):
        super().__init__()
        self.n_qs = 2 if two_qs else 1
        self.v_head = MLPHead(cfg, 1)
        for i in range(self.n_qs):
            self.add_module(f"q_head_{i}", MLPHead(cfg, cfg.vocab_size))
            self.add_module(f"target_q_head_{i}", MLPHead(cfg, cfg.vocab_size))

    def heads_on(self, hs_actions: torch.Tensor, hs_states: torch.Tensor):
        """``(qs, target_qs, vs)``: the Q and target-Q heads at the action
        positions (targets detached), V at the state positions."""
        qs = tuple(getattr(self, f"q_head_{i}")(hs_actions) for i in range(self.n_qs))
        target_qs = tuple(getattr(self, f"target_q_head_{i}")(hs_actions).detach()
                          for i in range(self.n_qs))
        return qs, target_qs, self.v_head(hs_states)


class CausalLMWithILQLHeads(nn.Module):
    """Policy LM + ILQL heads. ``forward`` adds ``qs``, ``target_qs``
    (tuples of ``[B, T', V]`` f32 over the ``logits_span`` positions) and
    ``vs`` (``[B, T, 1]`` f32 over every position) to the backbone's
    outputs; the engines carry their last positions into the sampling
    hook."""

    def __init__(self, cfg: TransformerConfig, two_qs: bool = True):
        super().__init__()
        self.config = cfg
        self.backbone = CausalTransformer(cfg)
        self.ilql_heads = ILQLHeadsModule(cfg, two_qs)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX initialisers, then the target heads set to copies of the
        Q heads (``sync_target_q_params`` at alpha 1)."""
        self.backbone.reset_parameters(generator)
        seeded_init_(self.ilql_heads, generator)
        sync_target_q_params(self, alpha=1.0)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        cache=None,
        cache_index: Any = None,
        logits_span: Optional[Tuple[int, int]] = None,
    ) -> Dict[str, Any]:
        out = self.backbone(
            input_ids, attention_mask=attention_mask, positions=positions, cache=cache,
            cache_index=cache_index, logits_span=logits_span,
        )
        # the vocab-wide Q heads cost what the LM head costs: restrict them
        # to the same span (V stays full: one scalar per state)
        hs = out["hidden_states"]
        hs_q = hs if logits_span is None else hs[:, logits_span[0] : logits_span[1]]
        qs, target_qs, vs = self.ilql_heads.heads_on(hs_q, hs)
        out.update(qs=qs, target_qs=target_qs, vs=vs)
        return out

    def backbone_forward(self, input_ids, attention_mask=None, positions=None,
                         logits_span=None) -> Dict[str, Any]:
        """The backbone alone: the loss gathers hidden states at the action
        and state indices first and applies the heads to those rows only."""
        return self.backbone(input_ids, attention_mask=attention_mask, positions=positions,
                             logits_span=logits_span)

    def project_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Vocab projection of gathered (final-normed) hidden states."""
        return self.backbone.project_logits(hidden)

    def heads_on(self, hs_actions: torch.Tensor, hs_states: torch.Tensor):
        return self.ilql_heads.heads_on(hs_actions, hs_states)


class _Seq2SeqLM(nn.Module):
    """The T5 backbone's entry points, shared by the two seq2seq
    wrappers; ``_with_heads`` adds a wrapper's head outputs."""

    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.config = cfg
        self.backbone = T5Transformer(cfg)

    def _with_heads(self, out: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    def encode_for_decode(self, input_ids, attention_mask, max_decode_len):
        return self.backbone.encode_for_decode(input_ids, attention_mask, max_decode_len)

    def decode(self, decoder_input_ids, encoder_hidden, encoder_mask, cache=None,
               cache_index=0) -> Dict[str, Any]:
        """One cached decoder step (or a full decoder pass), with the heads
        on its hidden states."""
        return self._with_heads(self.backbone.decode(
            decoder_input_ids, encoder_hidden, encoder_mask, cache=cache,
            cache_index=cache_index))

    def project_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.backbone.project_logits(hidden)


class Seq2SeqLMWithValueHead(_Seq2SeqLM):
    """T5 policy + scalar value head on the decoder hidden states
    (``out["value"]``, ``[B, T]`` f32)."""

    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__(cfg)
        self.v_head = MLPHead(cfg, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.backbone.reset_parameters(generator)
        seeded_init_(self.v_head, generator)

    def _with_heads(self, out: Dict[str, Any]) -> Dict[str, Any]:
        out["value"] = self.v_head(out["hidden_states"])[..., 0]
        return out

    def forward(self, input_ids, attention_mask=None, decoder_input_ids=None,
                decoder_attention_mask=None, branch_layer=None) -> Dict[str, Any]:
        return self._with_heads(self.backbone(
            input_ids, attention_mask=attention_mask, decoder_input_ids=decoder_input_ids,
            decoder_attention_mask=decoder_attention_mask, branch_layer=branch_layer))

    def forward_branch(self, hidden_states, branch_layer, encoder_hidden, encoder_mask,
                       decoder_mask=None):
        return self.backbone.forward_branch(hidden_states, branch_layer, encoder_hidden,
                                            encoder_mask, decoder_mask)


class Seq2SeqLMWithILQLHeads(_Seq2SeqLM):
    """T5 policy + ILQL heads (V, twin Q, twin target-Q) on the decoder
    hidden states: ``forward`` and ``decode`` add ``qs``, ``target_qs`` and
    ``vs`` over every decoder position (ILQL's ``adjust_logits`` reads the
    last one's)."""

    def __init__(self, cfg: Seq2SeqConfig, two_qs: bool = True):
        super().__init__(cfg)
        self.ilql_heads = ILQLHeadsModule(cfg, two_qs)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.backbone.reset_parameters(generator)
        seeded_init_(self.ilql_heads, generator)
        sync_target_q_params(self, alpha=1.0)

    def _with_heads(self, out: Dict[str, Any]) -> Dict[str, Any]:
        hs = out["hidden_states"]
        qs, target_qs, vs = self.ilql_heads.heads_on(hs, hs)
        out.update(qs=qs, target_qs=target_qs, vs=vs)
        return out

    def forward(self, input_ids, attention_mask=None, decoder_input_ids=None,
                decoder_attention_mask=None) -> Dict[str, Any]:
        return self._with_heads(self.backbone_forward(
            input_ids, attention_mask, decoder_input_ids, decoder_attention_mask))

    def backbone_forward(self, input_ids, attention_mask=None, decoder_input_ids=None,
                         decoder_attention_mask=None, logits_span=None) -> Dict[str, Any]:
        """The backbone alone: the loss gathers decoder hidden states at the
        action and state indices first and applies the heads to those rows
        only."""
        return self.backbone(input_ids, attention_mask=attention_mask,
                             decoder_input_ids=decoder_input_ids,
                             decoder_attention_mask=decoder_attention_mask,
                             logits_span=logits_span)

    def heads_on(self, hs_actions: torch.Tensor, hs_states: torch.Tensor):
        return self.ilql_heads.heads_on(hs_actions, hs_states)


@torch.no_grad()
def sync_target_q_params(model: nn.Module, alpha: float) -> None:
    """Polyak update in place: target ← α·q + (1−α)·target, for each
    ``q_head_<i>`` / ``target_q_head_<i>`` pair of ``model.ilql_heads``."""
    heads = model.ilql_heads
    for i in range(heads.n_qs):
        q = dict(getattr(heads, f"q_head_{i}").named_parameters())
        for name, t in getattr(heads, f"target_q_head_{i}").named_parameters():
            t.copy_(alpha * q[name] + (1.0 - alpha) * t)
