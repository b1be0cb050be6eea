"""Causal transformer backbone in PyTorch (the dense families and the
mixture-of-experts family).

Port of ``trlx_tpu/models/transformer.py``: :class:`TransformerConfig`
with the presets of the dense families (gpt2, llama, mistral, gptj,
gptneox/pythia, opt, bloom) and of mixtral, whose blocks run the
:class:`MoEMLP` (top-k router, capacity-bounded one-hot dispatch, gated
SiLU experts; the forward returns the token-weighted router statistics as
``router_aux_loss``), rotary
(:func:`rotary_sin_cos`, :func:`apply_rotary`, neox and gptj styles,
partial ``rotary_dim``) and ALiBi (:func:`alibi_slopes`) positions,
LayerNorm and RMSNorm, the gelu/silu (gated)/relu MLPs, sequential and
parallel residual blocks, :class:`CausalTransformer`, the additive
``-1e9`` attention bias with its window and ALiBi terms
(:func:`attention_bias`) and :func:`make_kv_cache`.

Numerics follow the JAX module: parameters are kept in ``param_dtype``
(f32 master weights) and cast to the compute ``dtype`` (bf16 by default)
at use; layer norms compute their statistics in f32; attention scores are
formed in the compute dtype, the softmax runs in f32.

Attention has three branches:

- **flash** (``T > 1`` with no cache or a dense cache at a scalar
  ``cache_index``, when :meth:`TransformerConfig.resolved_attention_impl`
  says so — the JAX ``use_flash`` rule): the flash-attention forward and
  backward kernels (``ops/flash_attention.py``) with the same masking
  semantics as the bias (slot-causal + key validity + the window, ALiBi
  from true token positions), resolved inside the kernel — no
  ``[B, 1, T, S]`` bias exists. This is the scoring and
  training path, and a dense-cache prefill (the span's K/V are written
  into the cache first, then the queries at slots ``[ci, ci + T)`` attend
  over the whole ``S``-wide cache). A full pass given a
  ``sequence_group`` holds this rank's zigzag shard of every row, with
  the global positions, and attends through ring attention over that
  group (``parallel/ring_attention.py``);
- **dense** (``cache = {"k", "v"}`` of ``[B, S, KV, D]``, or no cache on
  the bias path): this call's K/V are written at ``cache_index`` (a
  scalar, or a ``[B]`` vector of per-row first columns: each row writes
  its own ``[ci, ci + T)`` window) and the einsum attention runs over the
  whole cache — the plain reference path behind ``ops/sampling.py::generate``
  and ``ops/speculative.py::generate_speculative``;
- **paged** (the cache carries a ``"block_table"``, see
  ``ops/paged_kv.py::attach_block_table``): K/V live in the block pool and
  this call's K/V are committed straight through each row's table, rows
  whose table ids are out of range writing nothing (the JAX drop-mode
  writes). A single-token step then calls the paged-decode kernel, a span
  at a scalar ``cache_index`` the paged-prefill kernel, and a span at a
  ``[B]`` ``cache_index`` (the speculative verify: ``G + 1`` probe columns
  per row at per-row depths) the paged-verify entry. The pool is updated
  in place.

Rotary positions rotate q and k before the cache write, on every branch;
a forward computes its ``(sin, cos)`` tables once and every layer shares
them.

The PPO path adds the hydra branch: ``forward(branch_layer=k)`` returns the
activations entering the top ``k`` blocks as ``branch_input``, and
:meth:`CausalTransformer.forward_branch` (or a frozen :class:`HydraBranch`
copy of those blocks) replays the top of the model from them.

Rematerialisation (``remat``, JAX's ``_remat_policy``) wraps each block of
a pass that takes gradients (no cache, grad enabled: the train step's
forward and the hydra branch's) in ``torch.utils.checkpoint``
(:func:`run_block`): ``full`` saves only the block's inputs and recomputes
the block in the backward; ``minimal`` is JAX's
``checkpoint_dots_with_no_batch_dims``, a selective policy that keeps the
outputs of ``aten.mm`` / ``aten.addmm`` (what the projections' ``F.linear``
becomes) and recomputes the rest — the per-call weight casts, the norms,
the attention products and the attention kernels, which are calls into
their libraries the policy cannot see, so flash attention's forward kernel
runs again in the backward under both policies. A block returns its MoE
router statistics as a value, so a recomputed block records nothing twice.
"""

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Collection, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "TransformerConfig",
    "BUILTIN_SPECS",
    "RMSNorm",
    "LayerNorm",
    "rotary_sin_cos",
    "apply_rotary",
    "alibi_slopes",
    "attention_bias",
    "get_activation",
    "seeded_init_",
    "Attention",
    "LoRALinear",
    "MLP",
    "MoEMLP",
    "router_aux_summary",
    "Block",
    "run_block",
    "CausalTransformer",
    "HydraBranch",
    "make_kv_cache",
    "config_from_spec",
]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Architecture of a decoder-only transformer (the GPT-2, llama,
    mistral, gptj, gptneox, opt and bloom families, and mixtral's
    mixture-of-experts MLP when ``num_experts > 0``)."""

    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    max_position_embeddings: int = 2048
    num_kv_heads: Optional[int] = None  # < num_heads → grouped-query attention
    head_dim: Optional[int] = None
    model_type: Optional[str] = None
    position_scheme: str = "learned"  # learned | rotary | alibi
    pos_offset: int = 0  # OPT stores positions with an offset of 2
    rotary_dim: Optional[int] = None  # partial rotary (gptj/neox); None = full
    rope_theta: float = 10000.0
    # sliding-window attention (mistral): each query sees the last
    # ``sliding_window`` slots. Padding is left-only, so slot distance is
    # position distance and every path enforces the window on slots
    sliding_window: Optional[int] = None
    norm: str = "layernorm"  # layernorm | rmsnorm
    layer_norm_epsilon: float = 1e-5
    activation: str = "gelu_new"  # gelu_new | gelu | silu (gated MLP) | relu
    parallel_residual: bool = False  # gptj/neox: x + attn(ln(x)) + mlp(ln'(x))
    shared_ln: bool = False  # gptj: one norm feeds both attention and MLP
    attn_bias: bool = True
    mlp_bias: bool = True
    qkv_bias: Optional[bool] = None  # overrides attn_bias for q/k/v if set
    tie_word_embeddings: bool = True
    final_norm: bool = True
    embedding_layernorm: bool = False  # bloom: a norm after the word embedding
    lm_head_bias: bool = False  # gptj: a bias on the untied lm head
    # mixture-of-experts MLP (mixtral; 0 = the dense MLP): a token group of
    # G tokens (the largest divisor of T <= moe_group_size, 0 = the whole
    # row) routes each token to its top ``num_experts_per_tok`` experts with
    # C = ceil(k·G·moe_capacity_factor/E) slots per expert and group
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 0
    moe_renormalize: bool = True  # renormalise the top-k gate probabilities
    router_aux_coef: float = 0.01  # load-balance loss weight (Switch)
    router_z_coef: float = 0.0  # router logit z-loss weight (ST-MoE)
    param_dtype: torch.dtype = torch.float32
    dtype: torch.dtype = torch.bfloat16  # activation/compute dtype
    # attention implementation of full passes: "auto" (the flash kernels for
    # CUDA tensors, the bias path otherwise — as JAX's "auto" means the TPU
    # kernel on a TPU), "xla" (the bias path, the JAX name; CPU tensors only)
    # or "pallas" (force the flash branch; on CPU tensors its wrappers run
    # their plain versions)
    attention_impl: str = "auto"
    # LoRA (``model.peft_kwargs``, ``builder.parse_peft_overrides``): r = 0
    # disables; every projection named in ``lora_targets`` gets the adapter
    # pair of :class:`LoRALinear`, and ``builder.trainable_mask`` trains the
    # adapters of the unfrozen layer range only
    lora_r: int = 0
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ()
    # rematerialisation of the blocks in passes that take gradients
    # (``parallel.remat``, :func:`run_block`): "full" recomputes each block
    # in the backward, "minimal" keeps the products without a batch
    # dimension (the projections) and recomputes the rest; anything else is
    # no remat, as in JAX
    remat: str = "none"
    # ``parallel.scan_layers``: JAX stacks the blocks on a layer axis; the
    # port keeps per-layer modules either way (``weights.py`` unstacks a
    # scanned JAX tree)
    scan_layers: bool = False
    # the ``model`` axis's size on the modules of a tensor-parallel rank
    # (``parallel/tensor_parallel.py::apply_tensor_parallel`` sets it; the
    # other fields stay the full model's)
    model_parallel: int = 1

    def __post_init__(self):
        allowed = {
            "position_scheme": ("learned", "rotary", "alibi"),
            "norm": ("layernorm", "rmsnorm"),
            "activation": tuple(_ACTIVATIONS),
            "attention_impl": ("auto", "xla", "pallas"),
        }
        for field, values in allowed.items():
            got = getattr(self, field)
            if got not in values:
                raise ValueError(f"{field}={got!r} ({' | '.join(values)})")

    def resolved_attention_impl(self, device: Optional[torch.device] = None) -> str:
        """``"pallas"`` (the flash branch) or ``"xla"`` (the bias path) for
        full passes on ``device``. Full passes on CUDA tensors run the flash
        kernels: ``"xla"`` there raises."""
        cuda = device is not None and device.type == "cuda"
        if self.attention_impl == "auto":
            return "pallas" if cuda else "xla"
        if self.attention_impl == "xla" and cuda:
            raise ValueError(
                "attention_impl='xla': the bias path serves CPU tensors only; full "
                "passes on the GPU run the flash-attention kernels ('auto' or 'pallas')"
            )
        return self.attention_impl

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def cache_kv_heads(self) -> int:
        """The KV heads of one rank's cache and block pool."""
        if self.model_parallel == 1:
            return self.kv_heads
        from trlx_tpu_torch.parallel.tensor_parallel import local_kv_heads

        return local_kv_heads(self, self.model_parallel)

    @property
    def dims_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def neox_rotary(self) -> bool:
        """Rotary on split halves (llama/neox) rather than interleaved
        pairs (gptj): the JAX rule."""
        return self.norm == "rmsnorm" or not self.shared_ln

    # ---- family presets (the JAX package's, sizes per the model cards) ----

    @staticmethod
    def gpt2(size: str = "small", **overrides) -> "TransformerConfig":
        dims = {
            "test": dict(vocab_size=259, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=256, max_position_embeddings=128),
            "small": dict(vocab_size=50257, hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072, max_position_embeddings=1024),
            "medium": dict(vocab_size=50257, hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096, max_position_embeddings=1024),
            "large": dict(vocab_size=50257, hidden_size=1280, num_layers=36, num_heads=20, intermediate_size=5120, max_position_embeddings=1024),
            "xl": dict(vocab_size=50257, hidden_size=1600, num_layers=48, num_heads=25, intermediate_size=6400, max_position_embeddings=1024),
        }[size]
        return _make_preset(dims, overrides, model_type="gpt2", position_scheme="learned",
                            norm="layernorm", activation="gelu_new", tie_word_embeddings=True)

    @staticmethod
    def llama(size: str = "7b", **overrides) -> "TransformerConfig":
        dims = {
            "test": dict(vocab_size=259, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, intermediate_size=128, max_position_embeddings=128),
            "7b": dict(vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32, intermediate_size=11008, max_position_embeddings=2048),
            "13b": dict(vocab_size=32000, hidden_size=5120, num_layers=40, num_heads=40, intermediate_size=13824, max_position_embeddings=2048),
            "65b": dict(vocab_size=32000, hidden_size=8192, num_layers=80, num_heads=64, intermediate_size=22016, max_position_embeddings=2048),
        }[size]
        return _make_preset(dims, overrides, model_type="llama", position_scheme="rotary",
                            norm="rmsnorm", layer_norm_epsilon=1e-6, activation="silu",
                            attn_bias=False, mlp_bias=False, tie_word_embeddings=False)

    @staticmethod
    def mistral(size: str = "7b", **overrides) -> "TransformerConfig":
        dims = {
            "test": dict(vocab_size=259, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, intermediate_size=128, max_position_embeddings=128, sliding_window=8),
            "7b": dict(vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32, num_kv_heads=8, intermediate_size=14336, max_position_embeddings=32768, sliding_window=4096),
        }[size]
        return _make_preset(dims, overrides, model_type="mistral", position_scheme="rotary",
                            norm="rmsnorm", layer_norm_epsilon=1e-5, activation="silu",
                            attn_bias=False, mlp_bias=False, tie_word_embeddings=False)

    @staticmethod
    def mixtral(size: str = "8x7b", **overrides) -> "TransformerConfig":
        dims = {
            "test": dict(vocab_size=259, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, intermediate_size=96, max_position_embeddings=128, num_experts=4),
            "8x7b": dict(vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32, num_kv_heads=8, intermediate_size=14336, max_position_embeddings=32768, num_experts=8, moe_group_size=512),
        }[size]
        return _make_preset(dims, overrides, model_type="mixtral", position_scheme="rotary",
                            rope_theta=1e6, norm="rmsnorm", layer_norm_epsilon=1e-5,
                            activation="silu", attn_bias=False, mlp_bias=False,
                            tie_word_embeddings=False, num_experts_per_tok=2)

    @staticmethod
    def gptj(size: str = "6b", **overrides) -> "TransformerConfig":
        dims = {
            "test": dict(vocab_size=259, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=256, max_position_embeddings=128),
            "6b": dict(vocab_size=50400, hidden_size=4096, num_layers=28, num_heads=16, intermediate_size=16384, max_position_embeddings=2048),
        }[size]
        return _make_preset(dims, overrides, model_type="gptj", position_scheme="rotary",
                            rotary_dim=64 if size != "test" else 8, norm="layernorm",
                            activation="gelu_new", parallel_residual=True, shared_ln=True,
                            attn_bias=False, qkv_bias=False, mlp_bias=True,
                            tie_word_embeddings=False, lm_head_bias=True)

    @staticmethod
    def gptneox(size: str = "160m", **overrides) -> "TransformerConfig":
        dims = {
            "test": dict(vocab_size=259, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=256, max_position_embeddings=128),
            "160m": dict(vocab_size=50304, hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072, max_position_embeddings=2048),
            "1.4b": dict(vocab_size=50304, hidden_size=2048, num_layers=24, num_heads=16, intermediate_size=8192, max_position_embeddings=2048),
            "6.9b": dict(vocab_size=50432, hidden_size=4096, num_layers=32, num_heads=32, intermediate_size=16384, max_position_embeddings=2048),
            "20b": dict(vocab_size=50432, hidden_size=6144, num_layers=44, num_heads=64, intermediate_size=24576, max_position_embeddings=2048),
        }[size]
        rotary_dim = (dims["hidden_size"] // dims["num_heads"]) // 4 if size != "test" else 4
        return _make_preset(dims, overrides, model_type="gpt_neox", position_scheme="rotary",
                            rotary_dim=rotary_dim, norm="layernorm", activation="gelu",
                            parallel_residual=True, shared_ln=False, attn_bias=True,
                            mlp_bias=True, tie_word_embeddings=False)

    @staticmethod
    def opt(size: str = "125m", **overrides) -> "TransformerConfig":
        dims = {
            "test": dict(vocab_size=259, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=256, max_position_embeddings=128),
            "125m": dict(vocab_size=50272, hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072, max_position_embeddings=2048),
            "6.7b": dict(vocab_size=50272, hidden_size=4096, num_layers=32, num_heads=32, intermediate_size=16384, max_position_embeddings=2048),
        }[size]
        return _make_preset(dims, overrides, model_type="opt", position_scheme="learned",
                            pos_offset=2, norm="layernorm", activation="relu",
                            tie_word_embeddings=True)

    @staticmethod
    def bloom(size: str = "560m", **overrides) -> "TransformerConfig":
        dims = {
            "test": dict(vocab_size=259, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=256, max_position_embeddings=128),
            "560m": dict(vocab_size=250880, hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096, max_position_embeddings=2048),
        }[size]
        return _make_preset(dims, overrides, model_type="bloom", position_scheme="alibi",
                            norm="layernorm", activation="gelu", embedding_layernorm=True,
                            tie_word_embeddings=True)


def _make_preset(dims: dict, overrides: dict, **flags) -> TransformerConfig:
    """Dims + family flags, ``overrides`` replacing any field."""
    return TransformerConfig(**{**dims, **flags, **overrides})


BUILTIN_SPECS = {
    "gpt2": TransformerConfig.gpt2,
    "llama": TransformerConfig.llama,
    "mistral": TransformerConfig.mistral,
    "mixtral": TransformerConfig.mixtral,
    "gptj": TransformerConfig.gptj,
    "gptneox": TransformerConfig.gptneox,
    "pythia": TransformerConfig.gptneox,
    "opt": TransformerConfig.opt,
    "bloom": TransformerConfig.bloom,
}


def config_from_spec(spec: str, **overrides) -> TransformerConfig:
    """Parse a ``builtin:<family>-<size>`` model spec into a config."""
    if spec.startswith("builtin:"):
        spec = spec.split(":", 1)[1]
    family, _, size = spec.partition("-")
    if family not in BUILTIN_SPECS:
        raise ValueError(f"unknown model family {family!r}: known {sorted(BUILTIN_SPECS)}")
    return BUILTIN_SPECS[family](size or "test", **overrides)


_ACTIVATIONS = {
    "gelu_new": partial(F.gelu, approximate="tanh"),
    "gelu": partial(F.gelu, approximate="none"),
    "silu": F.silu,
    "relu": F.relu,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return _ACTIVATIONS[name]


# ---------------------------------------------------------------------------
# positional encodings
# ---------------------------------------------------------------------------


def rotary_sin_cos(positions: torch.Tensor, dim: int, theta: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 sin/cos tables for RoPE at integer ``positions`` [B, T] →
    [B, T, dim/2]."""
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    inv_freq = 1.0 / (theta ** exponent)
    freqs = positions[..., None].to(torch.float32) * inv_freq
    return torch.sin(freqs), torch.cos(freqs)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor, rotary_dim: int,
                 neox_style: bool) -> torch.Tensor:
    """RoPE on the first ``rotary_dim`` dims of ``x`` [B, T, H, D]: split
    halves with ``neox_style`` (llama/neox), interleaved pairs otherwise
    (gptj). The rotation runs in f32 (the tables' type, as JAX promotes)
    and the result is cast back to ``x.dtype``."""
    x_rot, x_pass = x[..., :rotary_dim], x[..., rotary_dim:]
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    if neox_style:
        half = rotary_dim // 2
        x1, x2 = x_rot[..., :half], x_rot[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    else:
        x1, x2 = x_rot[..., ::2], x_rot[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)
    return torch.cat([out, x_pass.to(out.dtype)], dim=-1).to(x.dtype)


def alibi_slopes(num_heads: int) -> np.ndarray:
    """ALiBi per-head slopes (Press et al.), the BLOOM recipe: a geometric
    series for the largest power of two, then every other slope of the
    next power's series."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(np.log2(n) - 3)))
        return start * (start ** np.arange(n))

    if np.log2(num_heads).is_integer():
        return pow2_slopes(num_heads)
    closest = 2 ** int(np.floor(np.log2(num_heads)))
    base = pow2_slopes(closest)
    extra = pow2_slopes(2 * closest)[0::2][: num_heads - closest]
    return np.concatenate([base, extra])


def key_positions(key_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] token positions of key slots: ``cumsum(mask) - 1`` (left
    padding at 0)."""
    return torch.clamp(torch.cumsum(key_mask, dim=1) - 1, min=0)


def attention_bias(key_mask: torch.Tensor, query_slots: torch.Tensor,
                   query_positions: Optional[torch.Tensor] = None, *,
                   window: Optional[int] = None,
                   slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Additive f32 bias over key slots: slot-causal, key validity and the
    window on slot distance (0 visible, -1e9 masked), ``[B, 1, T, S]``; with
    ALiBi ``slopes`` ``[B, H, T, S]``, adding ``slope · (key position −
    query position)`` on visible pairs (the JAX ``_attention_bias``)."""
    S = key_mask.shape[1]
    key_slots = torch.arange(S, device=key_mask.device)[None, None, :]
    visible = (key_slots <= query_slots[:, :, None]) & (key_mask[:, None, :] > 0)
    if window:
        visible = visible & (query_slots[:, :, None] - key_slots < window)
    visible = visible[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=key_mask.device)
    bias = torch.where(visible, zero, torch.full((), -1e9, dtype=torch.float32,
                                                 device=key_mask.device))
    if slopes is not None:
        dist = (key_positions(key_mask)[:, None, :] - query_positions[:, :, None]).float()
        alibi = slopes.to(key_mask.device, torch.float32)[None, :, None, None] * dist[:, None]
        bias = bias + torch.where(visible, alibi, zero)
    return bias


class LoRALinear(nn.Linear):
    """``nn.Linear`` with the additive low-rank branch of the JAX
    ``LoRADense``: ``y = x Wᵀ (+ b) + (alpha / r) · (x A) B``, where
    ``lora_a`` is ``[in, r]`` and ``lora_b`` ``[r, out]`` (the JAX layout).
    ``lora_b`` starts at zero, so the layer is its base until trained."""

    def __init__(self, in_features: int, out_features: int, bias: bool, r: int, alpha: float,
                 dtype: torch.dtype):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype)
        self.lora_a = nn.Parameter(torch.empty(in_features, r, dtype=dtype))
        self.lora_b = nn.Parameter(torch.empty(r, out_features, dtype=dtype))
        self.lora_scale = alpha / r


def _dense(cfg: TransformerConfig, name: str, in_features: int, out_features: int,
           bias: bool) -> nn.Linear:
    """The projection ``name``: a :class:`LoRALinear` when LoRA targets it
    (the JAX ``_dense``), else a plain ``nn.Linear``."""
    if cfg.lora_r and name in cfg.lora_targets:
        return LoRALinear(in_features, out_features, bias, cfg.lora_r, cfg.lora_alpha,
                          cfg.param_dtype)
    return nn.Linear(in_features, out_features, bias=bias, dtype=cfg.param_dtype)


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ W.T + b`` with the f32 master weights cast to the compute
    dtype, plus a :class:`LoRALinear`'s low-rank branch. A layer that
    ``parallel/tensor_parallel.py`` split runs column-parallel (the rank's
    output features; the backward sums the input's gradient over
    ``model``) or row-parallel (the rank's input features, the partial
    products summed over ``model``, then the bias once); LoRA's replicated
    adapters take the rank's columns of ``lora_b`` or rows of ``lora_a``."""
    mode = getattr(layer, "tp_mode", None)
    if mode is None:
        bias = None if layer.bias is None else layer.bias.to(dtype)
        y = F.linear(x, layer.weight.to(dtype), bias)
        if isinstance(layer, LoRALinear):
            y = y + (x @ layer.lora_a.to(dtype)) @ layer.lora_b.to(dtype) * layer.lora_scale
        return y
    from trlx_tpu_torch.parallel.tensor_parallel import copy_to_model, reduce_from_model

    lo, hi = layer.tp_range
    if mode == "column":
        x = copy_to_model(x, layer.tp)
        bias = None if layer.bias is None else layer.bias.to(dtype)
        y = F.linear(x, layer.weight.to(dtype), bias)
        if isinstance(layer, LoRALinear):
            y = y + (x @ layer.lora_a.to(dtype)) @ layer.lora_b[:, lo:hi].to(dtype) \
                * layer.lora_scale
        return y
    y = F.linear(x, layer.weight.to(dtype))
    if isinstance(layer, LoRALinear):
        y = y + (x @ layer.lora_a[lo:hi].to(dtype)) @ layer.lora_b.to(dtype) * layer.lora_scale
    y = reduce_from_model(y, layer.tp)
    return y if layer.bias is None else y + layer.bias.to(dtype)


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics and output in the compute dtype."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.eps = cfg.layer_norm_epsilon
        self.dtype = cfg.dtype
        self.weight = nn.Parameter(torch.ones(cfg.hidden_size, dtype=cfg.param_dtype))
        self.bias = nn.Parameter(torch.zeros(cfg.hidden_size, dtype=cfg.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.dtype)


class RMSNorm(nn.Module):
    """RMSNorm (a scale, no bias) with f32 statistics and output in the
    compute dtype: ``x · (rsqrt(mean(x²) + eps) · scale)``, as flax's."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.eps = cfg.layer_norm_epsilon
        self.dtype = cfg.dtype
        self.weight = nn.Parameter(torch.ones(cfg.hidden_size, dtype=cfg.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mul = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (xf * (mul * self.weight.float())).to(self.dtype)


def Norm(cfg: TransformerConfig) -> nn.Module:
    return RMSNorm(cfg) if cfg.norm == "rmsnorm" else LayerNorm(cfg)


class PagedWrite:
    """Where one forward's ``T`` new K/V columns land in the pool: the
    ``(row, position)`` pairs whose table id is in range, and their flat
    ``block * block_size + offset`` pool rows. Computed once per forward
    and shared by every layer (the pools of all layers share one table).

    ``cache_index`` is a scalar (every row writes ``[ci, ci + T)``) or a
    ``[B]`` vector (row ``b`` writes ``[ci[b], ci[b] + T)``: a decode step,
    or the speculative verify's per-row probe windows, which may cross
    block edges)."""

    def __init__(self, table: torch.Tensor, cache_index: Any, T: int,
                 num_blocks: int, block_size: int):
        B, TB = table.shape
        ci = torch.as_tensor(cache_index, device=table.device).to(torch.int64)
        cols = (ci.reshape(-1, 1) + torch.arange(T, device=table.device)).expand(B, T)
        blk = table.to(torch.int64).gather(1, torch.clamp(cols // block_size, max=TB - 1))
        off = cols % block_size
        valid = (blk >= 0) & (blk < num_blocks)
        self.rows, self.pos = valid.nonzero(as_tuple=True)
        self.dst = (blk * block_size + off)[self.rows, self.pos]

    def commit(self, pool: torch.Tensor, new: torch.Tensor) -> None:
        """Write ``new[rows, pos]`` (``[B, T, KV, D]``) into ``pool``."""
        NB, bs, KV, D = pool.shape
        pool.view(NB * bs, KV, D)[self.dst] = new[self.rows, self.pos].to(pool.dtype)


class Attention(nn.Module):
    """Multi-head / grouped-query attention with rotary or ALiBi positions
    and an explicit KV cache. Under tensor parallelism it runs the rank's
    ``heads`` query heads and ``n_kv`` KV heads (``kv_index`` picks them
    from replicated k/v projections)."""

    kv_index: Optional[List[int]] = None

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        H, KV, D, E = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head, cfg.hidden_size
        self.heads, self.n_kv = H, KV
        qkv_bias = cfg.attn_bias if cfg.qkv_bias is None else cfg.qkv_bias
        self.q_proj = _dense(cfg, "q_proj", E, H * D, qkv_bias)
        self.k_proj = _dense(cfg, "k_proj", E, KV * D, qkv_bias)
        self.v_proj = _dense(cfg, "v_proj", E, KV * D, qkv_bias)
        self.o_proj = _dense(cfg, "o_proj", H * D, E, cfg.attn_bias)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, E]
        attention_bias: Optional[torch.Tensor],  # [B, 1 or H, T, S] additive f32
        rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # rotary (sin, cos)
        cache: Optional[Dict[str, torch.Tensor]] = None,
        cache_index: Any = None,
        paged_write: Optional[PagedWrite] = None,
        flash_args: Optional[Dict[str, Any]] = None,
    ):
        cfg = self.cfg
        dt = cfg.dtype
        B, T, _ = x.shape
        H, KV, D = self.heads, self.n_kv, cfg.dims_per_head
        q = _linear(self.q_proj, x, dt).view(B, T, H, D)
        if self.kv_index is not None:
            # replicated k/v, of which the rank reads its query heads' KV
            # heads: the input's gradient and the k/v weights' are partial,
            # summed over ``model`` (here and in ``sync_model_grads``)
            from trlx_tpu_torch.parallel.tensor_parallel import copy_to_model

            x = copy_to_model(x, self.tp)
        k = _linear(self.k_proj, x, dt).view(B, T, -1, D)
        v = _linear(self.v_proj, x, dt).view(B, T, -1, D)
        if self.kv_index is not None:
            k, v = k[:, :, self.kv_index], v[:, :, self.kv_index]
        if rope is not None:  # before the cache write, on every branch
            rdim = cfg.rotary_dim or D
            q = apply_rotary(q, *rope, rdim, cfg.neox_rotary)
            k = apply_rotary(k, *rope, rdim, cfg.neox_rotary)

        if cache is not None and "block_table" in cache:
            from trlx_tpu_torch.ops.paged_attention import (
                paged_attention_decode,
                paged_verify_attention,
            )
            from trlx_tpu_torch.ops.paged_prefill import paged_prefill_attention

            table = cache["block_table"]
            paged_write.commit(cache["k"], k)
            paged_write.commit(cache["v"], v)
            if T == 1:
                out = paged_attention_decode(
                    q[:, 0].contiguous(), cache["k"], cache["v"], table,
                    attention_bias[:, :, 0, :].contiguous(),
                )
            else:
                span = (paged_prefill_attention if torch.as_tensor(cache_index).ndim == 0
                        else paged_verify_attention)
                out = span(q.contiguous(), cache["k"], cache["v"], table,
                           attention_bias.contiguous())
            return _linear(self.o_proj, out.reshape(B, T, H * D), dt), cache

        if cache is not None:
            ci = torch.as_tensor(cache_index)
            if ci.ndim == 0:
                c = int(ci)
                cache["k"][:, c : c + T] = k.to(cache["k"].dtype)
                cache["v"][:, c : c + T] = v.to(cache["v"].dtype)
            else:  # per-row windows [ci, ci + T)
                rows = torch.arange(B, device=x.device)[:, None]
                cols = ci.to(x.device, torch.int64)[:, None] + torch.arange(T, device=x.device)
                cache["k"][rows, cols] = k.to(cache["k"].dtype)
                cache["v"][rows, cols] = v.to(cache["v"].dtype)
            k, v = cache["k"].to(dt), cache["v"].to(dt)

        if flash_args is not None and "ring" in flash_args:
            # sequence-parallel exact attention: this rank holds one zigzag
            # shard of the sequence and K/V rotate over the mesh's
            # ``sequence`` group (the JAX ``ring_flash_attention`` hook)
            from trlx_tpu_torch.parallel.ring_attention import ring_flash_attention_group

            fa = flash_args
            out = ring_flash_attention_group(q, k, v, fa["key_mask"], fa["ring"],
                                             q_positions=fa.get("q_positions"),
                                             k_positions=fa.get("k_positions"),
                                             alibi_slopes=fa.get("alibi_slopes"),
                                             window=fa.get("window"))
            return _linear(self.o_proj, out.reshape(B, T, H * D), dt), cache
        if flash_args is not None:
            from trlx_tpu_torch.ops.flash_attention import flash_attention

            fa = flash_args
            out = flash_attention(q, k, v, fa["key_mask"], causal=True, q_offset=fa["q_offset"],
                                  q_positions=fa.get("q_positions"),
                                  k_positions=fa.get("k_positions"),
                                  alibi_slopes=fa.get("alibi_slopes"), window=fa.get("window"))
            return _linear(self.o_proj, out.reshape(B, T, H * D), dt), cache

        if KV < H:
            k = torch.repeat_interleave(k, H // KV, dim=2)
            v = torch.repeat_interleave(v, H // KV, dim=2)
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(D)
        scores = scores + attention_bias.to(scores.dtype)
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, H * D)
        return _linear(self.o_proj, out, dt), cache


class MLP(nn.Module):
    """``down(act(up(x)))``, or with ``silu`` the gated (llama) form
    ``down(silu(gate(x)) · up(x))``."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.act = get_activation(cfg.activation)
        E, F_, bias = cfg.hidden_size, cfg.intermediate_size, cfg.mlp_bias
        self.gated = cfg.activation == "silu"
        if self.gated:
            self.gate_proj = _dense(cfg, "gate_proj", E, F_, bias)
        self.up_proj = _dense(cfg, "up_proj", E, F_, bias)
        self.down_proj = _dense(cfg, "down_proj", F_, E, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            h = self.act(_linear(self.gate_proj, x, self.dtype)) * _linear(self.up_proj, x,
                                                                         self.dtype)
        else:
            h = self.act(_linear(self.up_proj, x, self.dtype))
        return _linear(self.down_proj, h, self.dtype)


class MoEMLP(nn.Module):
    """Mixture-of-experts MLP (the JAX ``MoEMLP``): an f32 router, softmax,
    top-``k`` (renormalised with ``moe_renormalize``), and one-hot dispatch
    into ``C`` static slots per expert and token group, gated SiLU experts
    (``w_gate``, ``w_up`` of ``[E, d, f]``, ``w_down`` of ``[E, f, d]``, the
    JAX layout), and the gate-weighted combine.

    Slots are taken in choice priority: the running count runs over the
    ``[N, k·G, E]`` k-major order, so every token's first choice outranks
    any second choice. Overflow tokens and padding (``token_mask`` 0) get
    a zero output; padding claims no slot. A decode step (T = 1) never
    drops: ``C >= 1`` and the top-k experts are distinct.

    Returns ``(y, aux)``; ``aux`` is ``[lb · n_real, Σ w · lse², n_real]``,
    the Switch load-balance loss and the z-loss sum over real tokens, as
    token-weighted sufficient statistics (:func:`router_aux_summary`
    normalises their sum over layers)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        E, d, f = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
        self.act = get_activation(cfg.activation)
        self.gated = cfg.activation == "silu"
        self.router = nn.Linear(d, E, bias=False, dtype=cfg.param_dtype)
        if self.gated:
            self.w_gate = nn.Parameter(torch.empty(E, d, f, dtype=cfg.param_dtype))
        self.w_up = nn.Parameter(torch.empty(E, d, f, dtype=cfg.param_dtype))
        self.w_down = nn.Parameter(torch.empty(E, f, d, dtype=cfg.param_dtype))

    def group_size(self, T: int) -> int:
        """The dispatch group: the largest divisor of ``T`` at most
        ``moe_group_size`` (the whole row when 0)."""
        G = T
        if self.cfg.moe_group_size > 0:
            G = min(self.cfg.moe_group_size, T)
            while T % G:
                G -= 1
        return G

    def capacity(self, G: int) -> int:
        cfg = self.cfg
        return max(1, int(math.ceil(cfg.num_experts_per_tok * G * cfg.moe_capacity_factor
                                    / cfg.num_experts)))

    def forward(self, x: torch.Tensor, token_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        E, K = cfg.num_experts, cfg.num_experts_per_tok
        B, T, d = x.shape
        dt = cfg.dtype
        logits = F.linear(x.float(), self.router.weight.float())  # [B, T, E]
        probs = torch.softmax(logits, dim=-1)
        gate_vals, idx = torch.topk(probs, K, dim=-1)  # [B, T, K]
        if cfg.moe_renormalize:
            gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

        G = self.group_size(T)
        N = B * (T // G)
        xg = x.reshape(N, G, d)
        w = (torch.ones((N, G), dtype=torch.float32, device=x.device) if token_mask is None
             else token_mask.reshape(N, G).float())
        C = self.capacity(G)
        onehot = F.one_hot(idx.to(torch.int64), E).reshape(N, G, K, E)
        onehot = onehot * w[..., None, None].to(onehot.dtype)  # padding claims no slot
        perm = onehot.permute(0, 2, 1, 3).reshape(N, K * G, E)
        pos = torch.cumsum(perm, dim=1) - perm  # slots taken before this entry
        kept = perm * (pos < C)
        slot = (pos[..., None] == torch.arange(C, device=x.device)).float() * kept[..., None]
        gates_perm = gate_vals.reshape(N, G, K).permute(0, 2, 1).reshape(N, K * G)
        combine = (slot * gates_perm[..., None, None]).reshape(N, K, G, E, C).sum(1)
        dispatch = slot.reshape(N, K, G, E, C).sum(1)  # [N, G, E, C]

        tp = getattr(self, "tp", None)
        if tp is not None:
            # the rank's share of every expert's ffn: the input's gradient
            # and the combine weights' are summed over ``model``, the
            # partial outputs after the combine
            from trlx_tpu_torch.parallel.tensor_parallel import copy_to_model

            xg, combine = copy_to_model(xg, tp), copy_to_model(combine, tp)
        xin = torch.einsum("ngd,ngec->encd", xg, dispatch.to(x.dtype))
        if self.gated:
            h = self.act(torch.einsum("encd,edf->encf", xin, self.w_gate.to(dt)))
            h = h * torch.einsum("encd,edf->encf", xin, self.w_up.to(dt))
        else:
            h = self.act(torch.einsum("encd,edf->encf", xin, self.w_up.to(dt)))
        out = torch.einsum("encf,efd->encd", h, self.w_down.to(dt))
        y = torch.einsum("encd,ngec->ngd", out, combine.to(out.dtype)).reshape(B, T, d)
        if tp is not None:
            from trlx_tpu_torch.parallel.tensor_parallel import reduce_from_model

            y = reduce_from_model(y, tp)

        # load balance over pre-capacity assignments, z-loss, real tokens only
        n_real = w.sum()
        denom = torch.clamp(n_real, min=1.0)
        wf = w.reshape(B, T)
        me = (probs * wf[..., None]).sum(dim=(0, 1)) / denom
        ce = onehot.float().sum(dim=(0, 1, 2)) / (denom * K)
        aux_lb = E * (me * ce).sum()
        z_sum = (torch.logsumexp(logits, dim=-1).square() * wf).sum()
        return y.to(dt), torch.stack([aux_lb * n_real, z_sum, n_real])


def router_aux_summary(aux: torch.Tensor) -> torch.Tensor:
    """The per-layer sum of :class:`MoEMLP` statistics → ``[load_balance,
    router_z]``, token-weighted means."""
    return aux[:2] / torch.clamp(aux[2], min=1.0)


class Block(nn.Module):
    """Pre-norm block: sequential (``x + attn``, then ``+ mlp``) or, with
    ``parallel_residual``, ``x + attn(ln(x)) + mlp(ln'(x))`` where gptj's
    ``shared_ln`` feeds both from one norm (no ``ln_mlp``). With
    ``num_experts > 0`` the MLP is the :class:`MoEMLP`, routing the tokens
    ``token_mask`` marks real; the block returns ``(x, cache, aux)``, the
    router statistics or None."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.parallel_residual = cfg.parallel_residual
        self.ln_attn = Norm(cfg)
        self.attn = Attention(cfg)
        self.ln_mlp = None if cfg.parallel_residual and cfg.shared_ln else Norm(cfg)
        self.mlp = MoEMLP(cfg) if cfg.num_experts > 0 else MLP(cfg)
        self.moe = cfg.num_experts > 0

    def _mlp(self, h, token_mask):
        if self.moe:
            return self.mlp(h, token_mask)
        return self.mlp(h), None

    def forward(self, x, attention_bias, rope=None, cache=None, cache_index=None,
                paged_write=None, flash_args=None, token_mask=None):
        h = self.ln_attn(x)
        attn_out, new_cache = self.attn(h, attention_bias, rope, cache, cache_index,
                                        paged_write, flash_args)
        if self.parallel_residual:
            mlp_out, aux = self._mlp(h if self.ln_mlp is None else self.ln_mlp(x), token_mask)
            return x + attn_out + mlp_out, new_cache, aux
        x = x + attn_out
        mlp_out, aux = self._mlp(self.ln_mlp(x), token_mask)
        return x + mlp_out, new_cache, aux


REMAT_POLICIES = ("full", "minimal")


def _minimal_policy(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: keep the projections'
    products, recompute everything else (``bmm`` and einsums with a batch
    dimension, casts, norms, elementwise)."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def run_block(block: nn.Module, remat: str, *args):
    """``block(*args)``, under ``torch.utils.checkpoint`` (non-reentrant)
    when ``remat`` is ``full`` or ``minimal`` and autograd records: the
    caller passes ``"none"`` for cached passes."""
    if remat not in REMAT_POLICIES or not torch.is_grad_enabled():
        return block(*args)
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    if remat == "minimal":
        return checkpoint(block, *args, use_reentrant=False,
                          context_fn=partial(create_selective_checkpoint_contexts,
                                             _minimal_policy))
    return checkpoint(block, *args, use_reentrant=False)


def _query_slots(q_offset: Any, B: int, T: int, device) -> torch.Tensor:
    """[B, T] slot indices of queries at ``q_offset`` (scalar or [B])."""
    off = torch.as_tensor(q_offset, device=device).to(torch.int64)
    if off.ndim == 1:
        off = off[:, None]
    return (off + torch.arange(T, device=device)[None, :]).expand(B, T)


def _rope(cfg: TransformerConfig, positions: torch.Tensor):
    """The rotary ``(sin, cos)`` tables of one forward (shared by every
    layer), or None."""
    if cfg.position_scheme != "rotary":
        return None
    return rotary_sin_cos(positions, cfg.rotary_dim or cfg.dims_per_head, cfg.rope_theta)


def _check_sequence_shard(cfg: TransformerConfig, flash: bool) -> None:
    """Refuse a sequence-sharded forward that would not run the ring: the
    bias path would attend within the shard alone."""
    if cfg.num_experts > 0:
        raise ValueError("parallel.sequence > 1 with a mixture-of-experts model: the MoE "
                         "dispatch groups whole rows, which a sequence shard does not hold "
                         "(expert parallelism comes with slice 23)")
    if not flash:
        raise ValueError("parallel.sequence > 1 runs ring attention on the flash path: a "
                         "full pass with no cache and model.attention_impl 'pallas' (on the "
                         "CPU 'auto' takes the bias path, which attends within a shard)")


def attn_inputs(cfg: TransformerConfig, key_mask, query_slots, positions, use_flash,
                q_offset=0, ring=None, heads: Optional[Tuple[int, int]] = None):
    """``(bias, flash_args)`` for one forward — the single definition of the
    masking semantics, shared by the full pass, the cached passes and the
    hydra branch replay (the JAX ``_attn_inputs``). Flash queries sit at
    slots ``[q_offset, q_offset + T)`` (a scalar); the window and ALiBi go
    to the kernel, which builds no bias. ``ring`` (the process group of a
    sequence-sharded full pass) routes the flash call through ring
    attention; ALiBi's key positions are then the (global) ``positions``
    of the shard's own slots. ``heads`` (``[lo, hi)``, a tensor-parallel
    rank's query heads) takes those heads' ALiBi slopes."""
    alibi = cfg.position_scheme == "alibi"
    slopes = None
    if alibi:
        lo, hi = heads or (0, cfg.num_heads)
        slopes = torch.tensor(alibi_slopes(cfg.num_heads)[lo:hi], dtype=torch.float32,
                              device=key_mask.device)
    if not use_flash:
        return attention_bias(key_mask, query_slots, positions, window=cfg.sliding_window,
                              slopes=slopes), None
    args = {"key_mask": key_mask, "q_offset": int(q_offset)}
    if ring is not None:
        args["ring"] = ring
    if cfg.sliding_window:
        args["window"] = cfg.sliding_window
    if alibi:
        args.update(alibi_slopes=slopes, q_positions=positions,
                    k_positions=positions if ring is not None else key_positions(key_mask))
    return None, args


class CausalTransformer(nn.Module):
    """Decoder-only LM: ``forward`` returns logits, final hidden states and
    the (updated) cache. Under tensor parallelism (``tp``, set by
    ``parallel/tensor_parallel.py``) the rank holds ``vocab_range`` of the
    word embedding and LM head (None: replicated) and runs ``head_range``
    of the query heads; the logits come back whole (gathered over
    ``model``) unless the forward runs under ``local_logits()``."""

    tp: Any = None
    vocab_range: Optional[Tuple[int, int]] = None
    head_range: Optional[Tuple[int, int]] = None

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.config = cfg
        E = cfg.hidden_size
        self.wte = nn.Embedding(cfg.vocab_size, E, dtype=cfg.param_dtype)
        if cfg.position_scheme == "learned":
            self.wpe = nn.Embedding(cfg.max_position_embeddings + cfg.pos_offset, E,
                                    dtype=cfg.param_dtype)
        if cfg.embedding_layernorm:
            self.emb_ln = Norm(cfg)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        if cfg.final_norm:
            self.ln_f = Norm(cfg)
        if not cfg.tie_word_embeddings:
            self.lm_head = _dense(cfg, "lm_head", E, cfg.vocab_size, cfg.lm_head_bias)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX initialisers: normal(0.02) weights and embeddings, zero
        biases, unit norm scales."""
        seeded_init_(self, generator)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        dt = self.config.dtype
        if self.vocab_range is None:
            if self.config.tie_word_embeddings:
                return h @ self.wte.weight.to(dt).t()
            return _linear(self.lm_head, h, dt)
        from trlx_tpu_torch.parallel.tensor_parallel import (
            copy_to_model,
            gather_from_model,
            logits_stay_local,
        )

        if self.config.tie_word_embeddings:
            local = copy_to_model(h, self.tp) @ self.wte.weight.to(dt).t()
        else:
            local = _linear(self.lm_head, h, dt)
        return local if logits_stay_local() else gather_from_model(local, self.tp)

    @property
    def vocab_shard(self) -> Optional[Tuple[int, Any]]:
        """``(first id, TensorParallel)`` of the rank's logits under
        ``local_logits()``, or None when they are whole."""
        return None if self.vocab_range is None else (self.vocab_range[0], self.tp)

    def project_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Vocab projection of (already final-normed) hidden states."""
        return self._logits(hidden)

    def _embed(self, input_ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """The JAX ``_embed``: the table cast to the compute dtype, then
        gathered (so the backward accumulates in that dtype, as JAX's)."""
        cfg = self.config
        if self.vocab_range is not None:
            from trlx_tpu_torch.parallel.tensor_parallel import vocab_parallel_embed

            x = vocab_parallel_embed(self.wte.weight.to(cfg.dtype), input_ids,
                                     self.vocab_range[0], self.tp)
        else:
            x = self.wte.weight.to(cfg.dtype)[input_ids.to(torch.int64)]
        if cfg.position_scheme == "learned":
            x = x + self.wpe.weight.to(cfg.dtype)[positions + cfg.pos_offset]
        if cfg.embedding_layernorm:
            x = self.emb_ln(x)
        return x

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, T]
        attention_mask: Optional[torch.Tensor] = None,  # [B, T] (or [B, S] with a cache)
        positions: Optional[torch.Tensor] = None,  # [B, T]
        cache: Optional[List[Dict[str, torch.Tensor]]] = None,
        cache_index: Any = None,
        logits_span: Optional[Tuple[int, int]] = None,
        branch_layer: Optional[int] = None,
        sequence_group: Any = None,
    ) -> Dict[str, Any]:
        """``sequence_group`` (a ``torch.distributed`` process group, the
        mesh's ``sequence`` axis): ``input_ids`` are this rank's zigzag
        shard of every row and ``positions`` their global positions; the
        attention runs as ring attention over the group (the JAX
        ``_maybe_ring_mesh``). It needs the flash path and no cache."""
        cfg = self.config
        B, T = input_ids.shape
        device = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones((B, T), dtype=torch.int64, device=device)
        attention_mask = attention_mask.to(device)
        offset = cache_index if (cache is not None and cache_index is not None) else 0
        query_slots = _query_slots(offset, B, T, device)
        if positions is None:
            key_pos = key_positions(attention_mask)
            positions = key_pos if cache is None else key_pos.gather(1, query_slots)
        positions = positions.to(device=device, dtype=torch.int64)

        token_mask = None
        if cfg.num_experts > 0:
            # the MoE routes real query tokens only: under a cache, the slot
            # mask at the query slots (the JAX ``_token_validity``)
            token_mask = attention_mask if cache is None else attention_mask.gather(
                1, torch.clamp(query_slots, max=attention_mask.shape[1] - 1))

        x = self._embed(input_ids, positions)
        # the JAX rule: flash for every multi-token pass except per-row
        # (vector) cache indices and paged caches, whose kernels consume the
        # additive bias rows
        paged = cache is not None and "block_table" in cache[0]
        use_flash = (
            T > 1 and torch.as_tensor(offset).ndim == 0 and not paged
            and cfg.resolved_attention_impl(device) == "pallas"
        )
        if sequence_group is not None:
            _check_sequence_shard(cfg, use_flash and cache is None)
        bias, flash_args = attn_inputs(cfg, attention_mask, query_slots, positions, use_flash,
                                       offset, sequence_group, self.head_range)
        rope = _rope(cfg, positions)

        paged_write = None
        if paged:
            pool = cache[0]["k"]
            paged_write = PagedWrite(cache[0]["block_table"], offset, T,
                                     pool.shape[0], pool.shape[1])
        new_cache = [] if cache is not None else None
        branch_input = None
        aux = None
        remat = cfg.remat if cache is None else "none"
        for i, block in enumerate(self.blocks):
            if branch_layer is not None and i == len(self.blocks) - branch_layer:
                branch_input = x
            layer_cache = cache[i] if cache is not None else None
            x, updated, aux_i = run_block(block, remat, x, bias, rope, layer_cache, offset,
                                          paged_write, flash_args, token_mask)
            if aux_i is not None:
                aux = aux_i if aux is None else aux + aux_i
            if cache is not None:
                new_cache.append(updated)

        h = self.ln_f(x) if cfg.final_norm else x
        logits = self._logits(h if logits_span is None else h[:, logits_span[0] : logits_span[1]])
        out = {"logits": logits, "hidden_states": h, "branch_input": branch_input,
               "cache": new_cache}
        if aux is not None:
            # token-weighted [load_balance, router_z] over every layer; the
            # trainers fold them into the loss (``with_router_aux``)
            out["router_aux_loss"] = router_aux_summary(aux)
        return out

    def forward_branch(
        self,
        hidden_states: torch.Tensor,  # [B, T, E] activations entering the branch
        branch_layer: int,
        attention_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        logits_span: Optional[Tuple[int, int]] = None,
    ) -> Dict[str, Any]:
        """Run the top ``branch_layer`` blocks + final norm + lm head (the
        JAX ``forward_branch``): rotary positions are ``cumsum(mask) - 1``
        unless given."""
        blocks = list(self.blocks)[len(self.blocks) - branch_layer:]
        return _run_branch(self, blocks, hidden_states, attention_mask, positions, logits_span)


def _run_branch(owner, blocks, hidden_states, attention_mask, positions, logits_span):
    """Replay ``blocks`` + ``owner``'s final norm and lm head on
    ``hidden_states`` (a full pass: slot-causal over ``attention_mask``)."""
    cfg = owner.config
    B, T, _ = hidden_states.shape
    device = hidden_states.device
    if attention_mask is None:
        attention_mask = torch.ones((B, T), dtype=torch.int64, device=device)
    attention_mask = attention_mask.to(device)
    if positions is None:
        positions = key_positions(attention_mask)
    positions = positions.to(device=device, dtype=torch.int64)
    use_flash = T > 1 and cfg.resolved_attention_impl(device) == "pallas"
    bias, flash_args = attn_inputs(cfg, attention_mask, _query_slots(0, B, T, device),
                                   positions, use_flash, heads=owner.head_range)
    rope = _rope(cfg, positions)
    x = hidden_states
    for block in blocks:
        x, _, _ = run_block(block, cfg.remat, x, bias, rope, None, None, None, flash_args,
                            attention_mask)
    h = owner.ln_f(x) if cfg.final_norm else x
    logits = owner._logits(h if logits_span is None else h[:, logits_span[0] : logits_span[1]])
    return {"logits": logits, "hidden_states": h}


class HydraBranch(nn.Module):
    """The frozen hydra reference of a partially unfrozen model: copies of
    the top blocks (named by their layer index, as in the backbone's state
    dict), the final norm and the lm head (the tied embedding, or the
    untied ``lm_head``) — what
    ``trlx_tpu/models/builder.py::hydra_ref_params`` keeps."""

    def __init__(self, cfg: TransformerConfig, layers: List[int]):
        super().__init__()
        self.config = cfg
        self.layers = list(layers)
        self.blocks = nn.ModuleDict({str(i): Block(cfg) for i in self.layers})
        if cfg.final_norm:
            self.ln_f = Norm(cfg)
        if cfg.tie_word_embeddings:
            self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=cfg.param_dtype)
        else:
            self.lm_head = _dense(cfg, "lm_head", cfg.hidden_size, cfg.vocab_size,
                                  cfg.lm_head_bias)

    tp = CausalTransformer.tp
    vocab_range = CausalTransformer.vocab_range
    head_range = CausalTransformer.head_range
    _logits = CausalTransformer._logits
    vocab_shard = CausalTransformer.vocab_shard

    def forward(self, hidden_states, attention_mask=None, positions=None, logits_span=None):
        blocks = [self.blocks[str(i)] for i in self.layers]
        return _run_branch(self, blocks, hidden_states, attention_mask, positions, logits_span)


def seeded_init_(module: nn.Module, generator: Optional[torch.Generator],
                 stds: Optional[Dict[str, float]] = None,
                 names: Optional[Collection[str]] = None,
                 cuts: Optional[Dict[str, Tuple[int, int, Tuple[int, ...]]]] = None) -> None:
    """The JAX initialisers over ``module``'s parameters in registration
    order: zero biases, unit norm scales, LoRA's zero ``lora_b`` and He-uniform
    ``lora_a`` (bound √(6 / in)), normal(0.02) for the rest (normal(``stds
    [name]``) for a parameter named there). The draws come
    from the CPU ``generator`` one tensor at a time and are copied to the
    parameter's device, so one seed gives the same weights on every device
    and a 7B model never exists on the host whole. ``names`` limits the
    draws to those parameters (a model whose backbone was imported).
    ``cuts`` (``{name: (dim, start, whole shape)}``, a tensor-parallel
    rank's split parameters) draws the whole tensor and keeps the
    parameter's share from ``start`` along ``dim``."""
    stds, cuts = stds or {}, cuts or {}

    def draw(name, p, fill):
        if name not in cuts:
            return fill(torch.empty(p.shape, dtype=p.dtype))
        dim, start, whole = cuts[name]
        return fill(torch.empty(whole, dtype=p.dtype)).narrow(dim, start, p.shape[dim])

    norm_scales = {f"{name}.weight" for name, m in module.named_modules()
                   if isinstance(m, (LayerNorm, RMSNorm))}
    with torch.no_grad():
        for name, p in module.named_parameters():
            if names is not None and name not in names:
                continue
            if name.endswith(("bias", "lora_b")):
                p.zero_()
            elif name in norm_scales:
                p.fill_(1.0)
            elif name.endswith("lora_a"):
                bound = math.sqrt(6.0 / p.shape[0])
                p.copy_(draw(name, p, lambda t: t.uniform_(-bound, bound,
                                                           generator=generator)))
            else:
                p.copy_(draw(name, p, lambda t: t.normal_(0.0, stds.get(name, 0.02),
                                                          generator=generator)))


def make_kv_cache(
    cfg: TransformerConfig, batch_size: int, max_length: int, dtype=None, device=None
) -> List[Dict[str, torch.Tensor]]:
    """All-zeros per-layer ``{"k", "v"}`` cache of ``[batch, max_length,
    kv_heads, head_dim]`` (also the block-pool layout: rows = blocks); a
    tensor-parallel rank's holds its KV heads only."""
    dtype = dtype or cfg.dtype
    shape = (batch_size, max_length, cfg.cache_kv_heads, cfg.dims_per_head)
    return [
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(cfg.num_layers)
    ]
