"""T5-family encoder-decoder in PyTorch (T5 v1.0 and Flan-T5 v1.1).

Port of ``trlx_tpu/models/seq2seq.py``: :class:`Seq2SeqConfig` with the
``t5`` presets (relu MLP, tied embeddings: test, small, base, large, 3b,
11b) and the ``flan_t5`` presets (gated-GELU MLP, untied head: test,
small, base, large, xl, xxl), :func:`relative_position_bucket`,
:class:`RelativePositionBias`, :class:`T5Attention`, :class:`T5MLP`, the
encoder and decoder blocks, :class:`T5Transformer` and the frozen hydra
reference :class:`Seq2SeqHydraBranch`.

Numerics follow the JAX module: f32 master weights cast to the compute
``dtype`` at use (``transformer._linear``); RMS norms without mean
subtraction, their statistics in f32; attention scores in the compute
dtype with **no** 1/sqrt(d) scale, the f32 additive bias (relative
positions, causal and padding terms of -1e9) cast to the score dtype and
added, the softmax in f32 and cast back; the relative-position bias is
computed once per stack from layer 0's table and shared by every layer;
tied logits scale the hidden states by ``d_model**-0.5``.

Attention is two ``einsum`` products around that bias, as in JAX, where
they run outside any Pallas kernel: neither the flash nor the paged
kernels take an arbitrary additive bias.

The decoder cache is a list of per-layer ``{"k", "v", "ck", "cv"}``:
self-attention K/V of ``[B, N + 1, H, D]`` written in place at
``cache_index``, and the cross-attention K/V projected once from the
encoder states (:meth:`T5Transformer.encode_for_decode`).

``remat: full`` wraps each encoder and decoder block of a pass that takes
gradients in ``torch.utils.checkpoint`` (``transformer.run_block``); T5
takes no other policy, so ``minimal`` is no remat, as in JAX.

LoRA (``lora_r > 0``) adds adapters to the decoder's named projections
only: encoder modules get none, as in JAX (the reference restricts T5's
adapters to the decoder blocks).
"""

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from trlx_tpu_torch.models.transformer import (
    LoRALinear,
    RMSNorm,
    _linear,
    run_block,
    seeded_init_,
)

__all__ = [
    "Seq2SeqConfig",
    "relative_position_bucket",
    "RelativePositionBias",
    "T5Attention",
    "T5MLP",
    "T5EncoderBlock",
    "T5DecoderBlock",
    "T5Transformer",
    "Seq2SeqHydraBranch",
]

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    """Architecture of a T5-style encoder-decoder."""

    vocab_size: int
    hidden_size: int  # d_model
    num_layers: int  # encoder layers
    num_decoder_layers: int
    num_heads: int
    head_dim: int  # d_kv (t5-small's is not hidden / heads)
    intermediate_size: int  # d_ff
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    activation: str = "relu"  # relu (v1.0) | gated-gelu (v1.1 / flan)
    tie_word_embeddings: bool = True
    decoder_start_token_id: int = 0
    pad_token_id: int = 0
    param_dtype: torch.dtype = torch.float32
    dtype: torch.dtype = torch.bfloat16
    # LoRA (``builder.parse_peft_overrides``); r = 0 disables
    lora_r: int = 0
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ()
    # ``parallel.remat``: "full" recomputes each block in the backward;
    # any other value is no remat
    remat: str = "none"

    @property
    def block_remat(self) -> str:
        return "full" if self.remat == "full" else "none"

    def __post_init__(self):
        if self.activation not in ("relu", "gated-gelu"):
            raise ValueError(f"activation={self.activation!r} (relu | gated-gelu)")

    @staticmethod
    def t5(size: str = "small", **overrides) -> "Seq2SeqConfig":
        dims = {
            "test": dict(vocab_size=259, hidden_size=64, num_layers=2, num_decoder_layers=2, num_heads=4, head_dim=16, intermediate_size=128, relative_attention_num_buckets=8, relative_attention_max_distance=20),
            "small": dict(vocab_size=32128, hidden_size=512, num_layers=6, num_decoder_layers=6, num_heads=8, head_dim=64, intermediate_size=2048),
            "base": dict(vocab_size=32128, hidden_size=768, num_layers=12, num_decoder_layers=12, num_heads=12, head_dim=64, intermediate_size=3072),
            "large": dict(vocab_size=32128, hidden_size=1024, num_layers=24, num_decoder_layers=24, num_heads=16, head_dim=64, intermediate_size=4096),
            "3b": dict(vocab_size=32128, hidden_size=1024, num_layers=24, num_decoder_layers=24, num_heads=32, head_dim=128, intermediate_size=16384),
            "11b": dict(vocab_size=32128, hidden_size=1024, num_layers=24, num_decoder_layers=24, num_heads=128, head_dim=128, intermediate_size=65536),
        }[size]
        dims.update(overrides)
        return Seq2SeqConfig(**{"activation": "relu", "tie_word_embeddings": True, **dims})

    @staticmethod
    def flan_t5(size: str = "small", **overrides) -> "Seq2SeqConfig":
        dims = {
            "test": dict(vocab_size=259, hidden_size=64, num_layers=2, num_decoder_layers=2, num_heads=4, head_dim=16, intermediate_size=128, relative_attention_num_buckets=8, relative_attention_max_distance=20),
            "small": dict(vocab_size=32128, hidden_size=512, num_layers=8, num_decoder_layers=8, num_heads=6, head_dim=64, intermediate_size=1024),
            "base": dict(vocab_size=32128, hidden_size=768, num_layers=12, num_decoder_layers=12, num_heads=12, head_dim=64, intermediate_size=2048),
            "large": dict(vocab_size=32128, hidden_size=1024, num_layers=24, num_decoder_layers=24, num_heads=16, head_dim=64, intermediate_size=2816),
            "xl": dict(vocab_size=32128, hidden_size=2048, num_layers=24, num_decoder_layers=24, num_heads=32, head_dim=64, intermediate_size=5120),
            "xxl": dict(vocab_size=32128, hidden_size=4096, num_layers=24, num_decoder_layers=24, num_heads=64, head_dim=64, intermediate_size=10240),
        }[size]
        dims.update(overrides)
        return Seq2SeqConfig(**{"activation": "gated-gelu", "tie_word_embeddings": False,
                                **dims})


SEQ2SEQ_SPECS = {"t5": Seq2SeqConfig.t5, "flan_t5": Seq2SeqConfig.flan_t5}


def _t5_dense(cfg: Seq2SeqConfig, name: str, in_features: int, out_features: int,
              lora_ok: bool = True) -> nn.Linear:
    """A bias-free projection (T5 has no biases); a :class:`LoRALinear`
    when LoRA targets ``name`` and the module takes adapters."""
    if lora_ok and cfg.lora_r and name in cfg.lora_targets:
        return LoRALinear(in_features, out_features, False, cfg.lora_r, cfg.lora_alpha,
                          cfg.param_dtype)
    return nn.Linear(in_features, out_features, bias=False, dtype=cfg.param_dtype)


def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's log-bucketed relative position (``k_pos - q_pos``), computed as
    JAX computes it: the log in f32, divided by the f32 rounding of
    ``log(max_distance / max_exact)`` (a numpy float64 scalar, which JAX
    canonicalises to f32), truncated toward zero."""
    n = relative_position.to(torch.int32)
    ret = torch.zeros_like(n)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n > 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = torch.clamp(-n, min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    denom = float(np.float32(np.log(max_distance / max_exact)))
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-6) / denom * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class RelativePositionBias(nn.Module):
    """The learned relative-position bias table (``[buckets, H]``, read in
    f32), owned by layer 0 of each stack."""

    def __init__(self, cfg: Seq2SeqConfig, bidirectional: bool):
        super().__init__()
        self.bidirectional = bidirectional
        self.num_buckets = cfg.relative_attention_num_buckets
        self.max_distance = cfg.relative_attention_max_distance
        self.rel_bias = nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads,
                                     dtype=cfg.param_dtype)

    def forward(self, q_positions: torch.Tensor, k_positions: torch.Tensor) -> torch.Tensor:
        """``[Tq]``, ``[Tk]`` → additive bias ``[1, H, Tq, Tk]`` (f32)."""
        rel = k_positions[None, :] - q_positions[:, None]
        buckets = relative_position_bucket(rel, self.bidirectional, self.num_buckets,
                                           self.max_distance)
        table = self.rel_bias.weight.float()[buckets.to(torch.int64)]  # [Tq, Tk, H]
        return table.permute(2, 0, 1)[None]


class T5Attention(nn.Module):
    """Self- or cross-attention, T5 style (no 1/sqrt(d) scale, no biases).
    ``lora_ok=False`` (the encoder) builds no adapters."""

    def __init__(self, cfg: Seq2SeqConfig, lora_ok: bool = True):
        super().__init__()
        self.dtype = cfg.dtype
        self.H, self.D = cfg.num_heads, cfg.head_dim
        E, HD = cfg.hidden_size, cfg.num_heads * cfg.head_dim
        self.q_proj = _t5_dense(cfg, "q_proj", E, HD, lora_ok)
        self.k_proj = _t5_dense(cfg, "k_proj", E, HD, lora_ok)
        self.v_proj = _t5_dense(cfg, "v_proj", E, HD, lora_ok)
        self.o_proj = _t5_dense(cfg, "o_proj", HD, E, lora_ok)

    def compute_kv(self, src: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """K and V of ``src`` (``[B, S, H, D]`` each)."""
        B, S, _ = src.shape
        return (_linear(self.k_proj, src, self.dtype).view(B, S, self.H, self.D),
                _linear(self.v_proj, src, self.dtype).view(B, S, self.H, self.D))

    def forward(
        self,
        x: torch.Tensor,  # [B, T, E] queries
        kv: Optional[torch.Tensor] = None,  # [B, S, E] for cross-attention (None: self)
        bias: Optional[torch.Tensor] = None,  # additive, in the score dtype
        cache: Optional[Dict[str, torch.Tensor]] = None,
        cache_index: int = 0,
        precomputed_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        B, T, _ = x.shape
        q = _linear(self.q_proj, x, self.dtype).view(B, T, self.H, self.D)
        if precomputed_kv is not None:  # cross-attention during decode
            k, v = precomputed_kv
        else:
            k, v = self.compute_kv(x if kv is None else kv)
        if cache is not None:  # decoder self-attention: this step's K/V into the cache
            cache["k"][:, cache_index : cache_index + T] = k.to(cache["k"].dtype)
            cache["v"][:, cache_index : cache_index + T] = v.to(cache["v"].dtype)
            k, v = cache["k"], cache["v"]
        scores = torch.einsum("bthd,bshd->bhts", q, k)  # no sqrt(d) scale
        if bias is not None:
            scores = scores + bias
        probs = torch.softmax(scores.float(), dim=-1).to(self.dtype)
        out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, self.H * self.D)
        return _linear(self.o_proj, out, self.dtype)


class T5MLP(nn.Module):
    """relu(x W_up) W_down (v1.0), or gelu_tanh(x W_gate) · (x W_up) W_down
    (v1.1 / Flan)."""

    def __init__(self, cfg: Seq2SeqConfig, lora_ok: bool = True):
        super().__init__()
        self.dtype = cfg.dtype
        self.gated = cfg.activation == "gated-gelu"
        E, F_ = cfg.hidden_size, cfg.intermediate_size
        if self.gated:
            self.gate_proj = _t5_dense(cfg, "gate_proj", E, F_, lora_ok)
        self.up_proj = _t5_dense(cfg, "up_proj", E, F_, lora_ok)
        self.down_proj = _t5_dense(cfg, "down_proj", F_, E, lora_ok)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.gated:
            h = (F.gelu(_linear(self.gate_proj, x, dt), approximate="tanh")
                 * _linear(self.up_proj, x, dt))
        else:
            h = F.relu(_linear(self.up_proj, x, dt))
        return _linear(self.down_proj, h, dt)


class T5EncoderBlock(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.ln_self = RMSNorm(cfg)
        self.self_attn = T5Attention(cfg, lora_ok=False)
        self.ln_mlp = RMSNorm(cfg)
        self.mlp = T5MLP(cfg, lora_ok=False)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.ln_self(x), bias=bias)
        return x + self.mlp(self.ln_mlp(x))


class T5DecoderBlock(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.ln_self = RMSNorm(cfg)
        self.self_attn = T5Attention(cfg)
        self.ln_cross = RMSNorm(cfg)
        self.cross_attn = T5Attention(cfg)
        self.ln_mlp = RMSNorm(cfg)
        self.mlp = T5MLP(cfg)

    def forward(self, x, self_bias, enc_hidden, cross_bias, cache=None, cache_index=0):
        x = x + self.self_attn(self.ln_self(x), bias=self_bias, cache=cache,
                               cache_index=cache_index)
        cross_kv = None if cache is None else (cache["ck"], cache["cv"])
        x = x + self.cross_attn(self.ln_cross(x), kv=enc_hidden, bias=cross_bias,
                                precomputed_kv=cross_kv)
        return x + self.mlp(self.ln_mlp(x))


def _pad_bias(mask: torch.Tensor) -> torch.Tensor:
    """``[B, S]`` key mask → additive f32 ``[B, 1, 1, S]`` (0 or -1e9)."""
    return torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF).to(torch.float32)


def _causal_bias(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """``[1, 1, Tq, Tk]`` f32: 0 where ``k <= q``, else -1e9."""
    visible = k_pos[None, :] <= q_pos[:, None]
    return torch.where(visible, 0.0, NEG_INF).to(torch.float32)[None, None]


def _decoder_bias(owner, T: int, decoder_mask: Optional[torch.Tensor], device) -> torch.Tensor:
    """The full decoder pass's self-attention bias from ``owner``'s table:
    relative positions + causal (+ the decoder padding), f32."""
    pos = torch.arange(T, device=device)
    bias = owner.dec_rel_bias(pos, pos) + _causal_bias(pos, pos)
    if decoder_mask is not None:
        bias = bias + _pad_bias(decoder_mask.to(device))
    return bias


def _logits(owner, h: torch.Tensor) -> torch.Tensor:
    """The vocab projection: the tied embedding on ``h · d_model**-0.5``
    (the scale rounded to the compute dtype, as JAX's weak-typed scalar
    is), else the untied ``lm_head``."""
    cfg = owner.config
    dt = cfg.dtype
    if cfg.tie_word_embeddings:
        scale = float(torch.tensor(cfg.hidden_size ** -0.5, dtype=dt))
        return (h * scale) @ owner.wte.weight.to(dt).t()
    return _linear(owner.lm_head, h, dt)


def _run_decoder_branch(owner, blocks, hidden_states, encoder_hidden, encoder_mask,
                        decoder_mask) -> Dict[str, torch.Tensor]:
    """Replay ``blocks`` + ``owner``'s final norm and head on the decoder
    activations entering them, the self-attention bias from ``owner``'s own
    table."""
    cfg = owner.config
    B, T, _ = hidden_states.shape
    device = hidden_states.device
    self_bias = _decoder_bias(owner, T, decoder_mask, device).to(cfg.dtype)
    cross_bias = _pad_bias(encoder_mask.to(device)).to(cfg.dtype)
    x = hidden_states
    for block in blocks:
        x = run_block(block, cfg.block_remat, x, self_bias, encoder_hidden, cross_bias)
    h = owner.dec_ln_f(x)
    return {"logits": _logits(owner, h), "hidden_states": h}


class T5Transformer(nn.Module):
    """Encoder-decoder: ``forward`` returns the decoder's logits, its final
    hidden states, ``branch_input`` and the encoder states; decoder slots
    are positions (no left padding on the decoder side)."""

    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.config = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=cfg.param_dtype)
        self.enc_rel_bias = RelativePositionBias(cfg, bidirectional=True)
        self.dec_rel_bias = RelativePositionBias(cfg, bidirectional=False)
        self.enc_blocks = nn.ModuleList(T5EncoderBlock(cfg) for _ in range(cfg.num_layers))
        self.dec_blocks = nn.ModuleList(T5DecoderBlock(cfg)
                                        for _ in range(cfg.num_decoder_layers))
        self.enc_ln_f = RMSNorm(cfg)
        self.dec_ln_f = RMSNorm(cfg)
        if not cfg.tie_word_embeddings:
            self.lm_head = _t5_dense(cfg, "lm_head", cfg.hidden_size, cfg.vocab_size)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX initialisers: normal(1.0) for the embedding, normal(0.02)
        for the projections and bias tables, unit norm scales."""
        seeded_init_(self, generator, stds={"wte.weight": 1.0})

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.wte.weight.to(self.config.dtype)[ids.to(torch.int64)]

    def project_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Vocab projection of (final-normed) decoder hidden states."""
        return _logits(self, hidden)

    def encode(self, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, S = input_ids.shape
        device = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones((B, S), dtype=torch.int64, device=device)
        pos = torch.arange(S, device=device)
        bias = self.enc_rel_bias(pos, pos) + _pad_bias(attention_mask.to(device))
        bias = bias.to(self.config.dtype)
        x = self._embed(input_ids)
        for block in self.enc_blocks:
            x = run_block(block, self.config.block_remat, x, bias)
        return self.enc_ln_f(x)

    def decode(
        self,
        decoder_input_ids: torch.Tensor,  # [B, T]
        encoder_hidden: torch.Tensor,  # [B, S, E]
        encoder_mask: torch.Tensor,  # [B, S]
        decoder_mask: Optional[torch.Tensor] = None,  # [B, T] (right-padded)
        cache: Optional[List[Dict[str, torch.Tensor]]] = None,
        cache_index: int = 0,
        branch_layer: Optional[int] = None,
        logits_span: Optional[Tuple[int, int]] = None,  # decoder positions to project
    ) -> Dict[str, Any]:
        """The decoder pass: a full pass (causal, with the decoder padding)
        or, with ``cache``, ``T`` steps written at ``cache_index`` and
        attending over the cache. ``logits_span`` (a, b) projects only
        positions [a, b) ((0, 0): hidden states alone)."""
        cfg = self.config
        B, T = decoder_input_ids.shape
        device = decoder_input_ids.device
        x = self._embed(decoder_input_ids)
        if cache is None:
            self_bias = _decoder_bias(self, T, decoder_mask, device)
        else:
            q_pos = cache_index + torch.arange(T, device=device)
            k_pos = torch.arange(cache[0]["k"].shape[1], device=device)
            self_bias = self.dec_rel_bias(q_pos, k_pos) + _causal_bias(q_pos, k_pos)
        self_bias = self_bias.to(cfg.dtype)
        cross_bias = _pad_bias(encoder_mask.to(device)).to(cfg.dtype)
        branch_input = None
        remat = cfg.block_remat if cache is None else "none"
        for i, block in enumerate(self.dec_blocks):
            if branch_layer is not None and i == len(self.dec_blocks) - branch_layer:
                branch_input = x
            x = run_block(block, remat, x, self_bias, encoder_hidden, cross_bias,
                          None if cache is None else cache[i], cache_index)
        h = self.dec_ln_f(x)
        span = h if logits_span is None else h[:, logits_span[0] : logits_span[1]]
        return {"logits": _logits(self, span), "hidden_states": h,
                "branch_input": branch_input, "cache": cache}

    def forward(
        self,
        input_ids: torch.Tensor,  # encoder tokens [B, S]
        attention_mask: Optional[torch.Tensor] = None,
        decoder_input_ids: Optional[torch.Tensor] = None,  # [B, T]
        decoder_attention_mask: Optional[torch.Tensor] = None,
        branch_layer: Optional[int] = None,
        logits_span: Optional[Tuple[int, int]] = None,
    ) -> Dict[str, Any]:
        B = input_ids.shape[0]
        device = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones(input_ids.shape, dtype=torch.int64, device=device)
        if decoder_input_ids is None:
            decoder_input_ids = torch.full((B, 1), self.config.decoder_start_token_id,
                                           dtype=torch.int64, device=device)
        enc = self.encode(input_ids, attention_mask)
        out = self.decode(decoder_input_ids, enc, attention_mask,
                          decoder_mask=decoder_attention_mask, branch_layer=branch_layer,
                          logits_span=logits_span)
        out["encoder_hidden"] = enc
        return out

    def forward_branch(
        self,
        hidden_states: torch.Tensor,  # [B, T, E] decoder activations entering the branch
        branch_layer: int,
        encoder_hidden: torch.Tensor,
        encoder_mask: torch.Tensor,
        decoder_mask: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Replay the top ``branch_layer`` decoder blocks + the final norm +
        the head; the self-attention bias comes from this model's own
        decoder table."""
        blocks = list(self.dec_blocks)[len(self.dec_blocks) - branch_layer:]
        return _run_decoder_branch(self, blocks, hidden_states, encoder_hidden,
                                   encoder_mask, decoder_mask)

    def encode_for_decode(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, max_decode_len: int
    ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
        """The encoder pass and a fresh decoder cache: zero self-attention
        K/V of ``max_decode_len`` slots, the cross-attention K/V projected
        once from the encoder states."""
        cfg = self.config
        B = input_ids.shape[0]
        enc = self.encode(input_ids, attention_mask)
        shape = (B, max_decode_len, cfg.num_heads, cfg.head_dim)
        cache = []
        for block in self.dec_blocks:
            ck, cv = block.cross_attn.compute_kv(enc)
            cache.append({"k": torch.zeros(shape, dtype=cfg.dtype, device=enc.device),
                          "v": torch.zeros(shape, dtype=cfg.dtype, device=enc.device),
                          "ck": ck, "cv": cv})
        return enc, cache


class Seq2SeqHydraBranch(nn.Module):
    """The frozen hydra reference of a partially unfrozen T5: copies of the
    top decoder blocks (named by their layer index, as in the backbone's
    state dict), the decoder's final norm and relative-position table, and
    the head (the tied embedding or the untied ``lm_head``) — what
    ``trlx_tpu/models/builder.py::seq2seq_hydra_ref_params`` keeps. The
    bias comes from the branch's own (frozen) table."""

    def __init__(self, cfg: Seq2SeqConfig, layers: List[int]):
        super().__init__()
        self.config = cfg
        self.layers = list(layers)
        self.dec_blocks = nn.ModuleDict({str(i): T5DecoderBlock(cfg) for i in self.layers})
        self.dec_ln_f = RMSNorm(cfg)
        self.dec_rel_bias = RelativePositionBias(cfg, bidirectional=False)
        if cfg.tie_word_embeddings:
            self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=cfg.param_dtype)
        else:
            self.lm_head = _t5_dense(cfg, "lm_head", cfg.hidden_size, cfg.vocab_size)

    def forward(self, hidden_states, encoder_hidden, encoder_mask, decoder_mask=None):
        blocks = [self.dec_blocks[str(i)] for i in self.layers]
        return _run_decoder_branch(self, blocks, hidden_states, encoder_hidden, encoder_mask,
                                   decoder_mask)
