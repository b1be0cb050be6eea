"""Causal transformer backbone in PyTorch (GPT-2 family).

Port of ``trlx_tpu/models/transformer.py``: :class:`TransformerConfig`
(the fields and GPT-2 presets this path reads), :class:`CausalTransformer`,
:class:`Block`, :class:`MLP`, :class:`Attention`, the additive ``-1e9``
attention bias (``CausalTransformer._attention_bias``) and
:func:`make_kv_cache`.

Numerics follow the JAX module: parameters are kept in ``param_dtype``
(f32 master weights) and cast to the compute ``dtype`` (bf16 by default)
at use; layer norms compute their statistics in f32; attention scores are
formed in the compute dtype, the softmax runs in f32.

Attention has three branches:

- **flash** (full passes: no cache, ``T > 1``, when
  :meth:`TransformerConfig.resolved_attention_impl` says so): the
  flash-attention forward and backward kernels (``ops/flash_attention.py``)
  with the same masking semantics as the bias (slot-causal + key validity),
  resolved inside the kernel — no ``[B, 1, T, S]`` bias exists. This is the
  scoring and training path;

- **dense** (``cache = {"k", "v"}`` of ``[B, S, KV, D]``, or no cache on
  the bias path): this call's K/V
  are written at ``cache_index`` (a scalar, or a ``[B]`` vector of per-row
  columns) and the einsum attention runs over the whole cache — the plain
  reference path behind ``ops/sampling.py::generate``;
- **paged** (the cache carries a ``"block_table"``, see
  ``ops/paged_kv.py::attach_block_table``): K/V live in the block pool and
  this call's K/V are committed straight through each row's table, rows
  whose table ids are out of range writing nothing (the JAX drop-mode
  writes). A single-token step then calls the paged-decode kernel, a span
  (``T > 1``, scalar ``cache_index``) the paged-prefill kernel. The pool is
  updated in place.

The PPO path adds the hydra branch: ``forward(branch_layer=k)`` returns the
activations entering the top ``k`` blocks as ``branch_input``, and
:meth:`CausalTransformer.forward_branch` (or a frozen :class:`HydraBranch`
copy of those blocks) replays the top of the model from them.
"""

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "TransformerConfig",
    "Attention",
    "MLP",
    "Block",
    "CausalTransformer",
    "HydraBranch",
    "make_kv_cache",
    "config_from_spec",
]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Architecture of a decoder-only transformer (GPT-2 family)."""

    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    max_position_embeddings: int = 2048
    num_kv_heads: Optional[int] = None  # < num_heads → grouped-query attention
    head_dim: Optional[int] = None
    model_type: Optional[str] = None
    position_scheme: str = "learned"
    pos_offset: int = 0
    norm: str = "layernorm"
    layer_norm_epsilon: float = 1e-5
    activation: str = "gelu_new"
    attn_bias: bool = True
    mlp_bias: bool = True
    qkv_bias: Optional[bool] = None  # overrides attn_bias for q/k/v if set
    tie_word_embeddings: bool = True
    final_norm: bool = True
    param_dtype: torch.dtype = torch.float32
    dtype: torch.dtype = torch.bfloat16  # activation/compute dtype
    # attention implementation of full passes: "auto" (the flash kernels for
    # CUDA tensors, the bias path otherwise — as JAX's "auto" means the TPU
    # kernel on a TPU), "xla" (the bias path, the JAX name; CPU tensors only)
    # or "pallas" (force the flash branch; on CPU tensors its wrappers run
    # their plain versions)
    attention_impl: str = "auto"

    def __post_init__(self):
        unsupported = {
            "position_scheme": (self.position_scheme, "learned"),
            "norm": (self.norm, "layernorm"),
            "activation": (self.activation, "gelu_new"),
        }
        for field, (got, want) in unsupported.items():
            if got != want:
                raise ValueError(
                    f"{field}={got!r}: the port supports the GPT-2 family "
                    f"({field}={want!r}) so far"
                )
        if self.attention_impl not in ("auto", "xla", "pallas"):
            raise ValueError(
                f"attention_impl={self.attention_impl!r} (auto | xla | pallas)"
            )

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
    def dims_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @staticmethod
    def gpt2(size: str = "small", **overrides) -> "TransformerConfig":
        dims = {
            "test": dict(vocab_size=259, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=256, max_position_embeddings=128),
            "small": dict(vocab_size=50257, hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072, max_position_embeddings=1024),
            "medium": dict(vocab_size=50257, hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096, max_position_embeddings=1024),
            "large": dict(vocab_size=50257, hidden_size=1280, num_layers=36, num_heads=20, intermediate_size=5120, max_position_embeddings=1024),
            "xl": dict(vocab_size=50257, hidden_size=1600, num_layers=48, num_heads=25, intermediate_size=6400, max_position_embeddings=1024),
        }[size]
        base = {**dims, "model_type": "gpt2"}
        base.update(overrides)
        return TransformerConfig(**base)


def config_from_spec(spec: str, **overrides) -> TransformerConfig:
    """Parse a ``builtin:<family>-<size>`` model spec into a config."""
    if spec.startswith("builtin:"):
        spec = spec.split(":", 1)[1]
    family, _, size = spec.partition("-")
    if family != "gpt2":
        raise ValueError(
            f"unknown or unported model family {family!r}: the port has gpt2"
        )
    return TransformerConfig.gpt2(size or "test", **overrides)


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ W.T + b`` with the f32 master weights cast to the compute dtype."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x, layer.weight.to(dtype), bias)


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


class PagedWrite:
    """Where one forward's ``T`` new K/V columns land in the pool: the
    ``(row, position)`` pairs whose table id is in range, and their flat
    ``block * block_size + offset`` pool rows. Computed once per forward
    and shared by every layer (the pools of all layers share one table)."""

    def __init__(self, table: torch.Tensor, cache_index: Any, T: int,
                 num_blocks: int, block_size: int):
        B, TB = table.shape
        ci = torch.as_tensor(cache_index, device=table.device)
        if T == 1:
            ci = ci.expand(B) if ci.ndim == 0 else ci
            ci = ci.to(torch.int64)[:, None]  # [B, 1]
            blk = table.to(torch.int64).gather(
                1, torch.clamp(ci // block_size, max=TB - 1)
            )
            off = ci % block_size
        else:
            if ci.ndim != 0:
                raise ValueError(
                    "a multi-position paged span needs one scalar cache_index "
                    "(per-row spans are the speculative verify path)"
                )
            cols = int(ci) + torch.arange(T, device=table.device)
            blk = table.to(torch.int64)[:, cols // block_size]  # [B, T]
            off = (cols % block_size)[None, :].expand(B, T)
        valid = (blk >= 0) & (blk < num_blocks)
        self.rows, self.pos = valid.nonzero(as_tuple=True)
        self.dst = (blk * block_size + off)[self.rows, self.pos]

    def commit(self, pool: torch.Tensor, new: torch.Tensor) -> None:
        """Write ``new[rows, pos]`` (``[B, T, KV, D]``) into ``pool``."""
        NB, bs, KV, D = pool.shape
        pool.view(NB * bs, KV, D)[self.dst] = new[self.rows, self.pos].to(pool.dtype)


class Attention(nn.Module):
    """Multi-head / grouped-query attention with an explicit KV cache."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        H, KV, D, E = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head, cfg.hidden_size
        qkv_bias = cfg.attn_bias if cfg.qkv_bias is None else cfg.qkv_bias
        kw = dict(dtype=cfg.param_dtype)
        self.q_proj = nn.Linear(E, H * D, bias=qkv_bias, **kw)
        self.k_proj = nn.Linear(E, KV * D, bias=qkv_bias, **kw)
        self.v_proj = nn.Linear(E, KV * D, bias=qkv_bias, **kw)
        self.o_proj = nn.Linear(H * D, E, bias=cfg.attn_bias, **kw)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, E]
        attention_bias: torch.Tensor,  # [B, 1, T, S] additive f32
        cache: Optional[Dict[str, torch.Tensor]] = None,
        cache_index: Any = None,
        paged_write: Optional[PagedWrite] = None,
        flash_args: Optional[Dict[str, Any]] = None,
    ):
        cfg = self.cfg
        dt = cfg.dtype
        B, T, _ = x.shape
        H, KV, D = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
        q = _linear(self.q_proj, x, dt).view(B, T, H, D)
        k = _linear(self.k_proj, x, dt).view(B, T, KV, D)
        v = _linear(self.v_proj, x, dt).view(B, T, KV, D)

        if cache is not None and "block_table" in cache:
            from trlx_tpu_torch.ops.paged_attention import paged_attention_decode
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
                out = paged_prefill_attention(
                    q.contiguous(), cache["k"], cache["v"], table,
                    attention_bias.contiguous(),
                )
            return _linear(self.o_proj, out.reshape(B, T, H * D), dt), cache

        if flash_args is not None:
            from trlx_tpu_torch.ops.flash_attention import flash_attention

            out = flash_attention(q, k, v, flash_args["key_mask"], causal=True,
                                  q_offset=flash_args.get("q_offset", 0))
            return _linear(self.o_proj, out.reshape(B, T, H * D), dt), None

        if cache is not None:
            ci = torch.as_tensor(cache_index)
            if ci.ndim == 0:
                c = int(ci)
                cache["k"][:, c : c + T] = k.to(cache["k"].dtype)
                cache["v"][:, c : c + T] = v.to(cache["v"].dtype)
            else:  # per-row columns, one position each
                rows = torch.arange(B, device=x.device)
                cache["k"][rows, ci.to(x.device)] = k[:, 0].to(cache["k"].dtype)
                cache["v"][rows, ci.to(x.device)] = v[:, 0].to(cache["v"].dtype)
            k, v = cache["k"].to(dt), cache["v"].to(dt)

        if KV < H:
            k = torch.repeat_interleave(k, H // KV, dim=2)
            v = torch.repeat_interleave(v, H // KV, dim=2)
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(D)
        scores = scores + attention_bias.to(scores.dtype)
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, H * D)
        return _linear(self.o_proj, out, dt), cache


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.dtype = cfg.dtype
        kw = dict(bias=cfg.mlp_bias, dtype=cfg.param_dtype)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(_linear(self.up_proj, x, self.dtype), approximate="tanh")
        return _linear(self.down_proj, h, self.dtype)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.ln_attn = LayerNorm(cfg)
        self.attn = Attention(cfg)
        self.ln_mlp = LayerNorm(cfg)
        self.mlp = MLP(cfg)

    def forward(self, x, attention_bias, cache=None, cache_index=None, paged_write=None,
                flash_args=None):
        attn_out, new_cache = self.attn(
            self.ln_attn(x), attention_bias, cache, cache_index, paged_write, flash_args
        )
        x = x + attn_out
        x = x + self.mlp(self.ln_mlp(x))
        return x, new_cache


def _query_slots(q_offset: Any, B: int, T: int, device) -> torch.Tensor:
    """[B, T] slot indices of queries at ``q_offset`` (scalar or [B])."""
    off = torch.as_tensor(q_offset, device=device).to(torch.int64)
    if off.ndim == 1:
        off = off[:, None]
    return (off + torch.arange(T, device=device)[None, :]).expand(B, T)


class CausalTransformer(nn.Module):
    """Decoder-only LM: ``forward`` returns logits, final hidden states and
    the (updated) cache."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.config = cfg
        E = cfg.hidden_size
        self.wte = nn.Embedding(cfg.vocab_size, E, dtype=cfg.param_dtype)
        self.wpe = nn.Embedding(cfg.max_position_embeddings + cfg.pos_offset, E,
                                dtype=cfg.param_dtype)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        if cfg.final_norm:
            self.ln_f = LayerNorm(cfg)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(E, cfg.vocab_size, bias=False, dtype=cfg.param_dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX initialisers: normal(0.02) weights and embeddings, zero
        biases, unit norm scales."""
        for name, p in self.named_parameters():
            with torch.no_grad():
                if name.endswith("bias"):
                    p.zero_()
                elif ".ln_" in name or name.startswith("ln_f"):
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, 0.02, generator=generator)

    def _attention_bias(self, key_mask: torch.Tensor, query_slots: torch.Tensor):
        """Additive ``[B, 1, T, S]`` f32 bias over key slots: slot-causal
        plus key validity (0 visible, -1e9 masked)."""
        S = key_mask.shape[1]
        key_slots = torch.arange(S, device=key_mask.device)[None, None, :]
        visible = (key_slots <= query_slots[:, :, None]) & (key_mask[:, None, :] > 0)
        bias = torch.where(
            visible,
            torch.zeros((), dtype=torch.float32, device=key_mask.device),
            torch.full((), -1e9, dtype=torch.float32, device=key_mask.device),
        )
        return bias[:, None]

    def _attn_inputs(self, key_mask, query_slots, use_flash):
        """``(bias, flash_args)`` for one forward — the single definition of
        the masking semantics, shared by the full pass, the cached passes
        and the hydra branch replay."""
        if use_flash:
            return None, {"key_mask": key_mask, "q_offset": 0}
        return self._attention_bias(key_mask, query_slots), None

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        dt = self.config.dtype
        if self.config.tie_word_embeddings:
            return h @ self.wte.weight.to(dt).t()
        return _linear(self.lm_head, h, dt)

    def project_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Vocab projection of (already final-normed) hidden states."""
        return self._logits(hidden)

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, T]
        attention_mask: Optional[torch.Tensor] = None,  # [B, T] (or [B, S] with a cache)
        positions: Optional[torch.Tensor] = None,  # [B, T]
        cache: Optional[List[Dict[str, torch.Tensor]]] = None,
        cache_index: Any = None,
        logits_span: Optional[Tuple[int, int]] = None,
        branch_layer: Optional[int] = None,
    ) -> Dict[str, Any]:
        cfg = self.config
        B, T = input_ids.shape
        device = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones((B, T), dtype=torch.int64, device=device)
        attention_mask = attention_mask.to(device)
        offset = cache_index if (cache is not None and cache_index is not None) else 0
        query_slots = _query_slots(offset, B, T, device)
        if positions is None:
            key_pos = torch.clamp(torch.cumsum(attention_mask, dim=1) - 1, min=0)
            positions = key_pos if cache is None else key_pos.gather(1, query_slots)
        positions = positions.to(device=device, dtype=torch.int64)

        dt = cfg.dtype
        x = self.wte.weight.to(dt)[input_ids.to(torch.int64)]
        x = x + self.wpe.weight.to(dt)[positions + cfg.pos_offset]
        use_flash = (
            cache is None and T > 1 and cfg.resolved_attention_impl(device) == "pallas"
        )
        bias, flash_args = self._attn_inputs(attention_mask, query_slots, use_flash)

        paged_write = None
        if cache is not None and "block_table" in cache[0]:
            pool = cache[0]["k"]
            paged_write = PagedWrite(cache[0]["block_table"], offset, T,
                                     pool.shape[0], pool.shape[1])
        new_cache = [] if cache is not None else None
        branch_input = None
        for i, block in enumerate(self.blocks):
            if branch_layer is not None and i == len(self.blocks) - branch_layer:
                branch_input = x
            layer_cache = cache[i] if cache is not None else None
            x, updated = block(x, bias, layer_cache, offset, paged_write, flash_args)
            if cache is not None:
                new_cache.append(updated)

        h = self.ln_f(x) if cfg.final_norm else x
        logits = self._logits(h if logits_span is None else h[:, logits_span[0] : logits_span[1]])
        return {"logits": logits, "hidden_states": h, "branch_input": branch_input,
                "cache": new_cache}

    def forward_branch(
        self,
        hidden_states: torch.Tensor,  # [B, T, E] activations entering the branch
        branch_layer: int,
        attention_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        logits_span: Optional[Tuple[int, int]] = None,
    ) -> Dict[str, Any]:
        """Run the top ``branch_layer`` blocks + final norm + lm head (the
        JAX ``forward_branch``; GPT-2's learned positions entered at the
        embedding, so ``positions`` is unused)."""
        blocks = list(self.blocks)[len(self.blocks) - branch_layer:]
        return _run_branch(self, blocks, hidden_states, attention_mask, logits_span)


def _run_branch(owner, blocks, hidden_states, attention_mask, logits_span):
    """Replay ``blocks`` + ``owner``'s final norm and lm head on
    ``hidden_states`` (a full pass: slot-causal over ``attention_mask``)."""
    cfg = owner.config
    B, T, _ = hidden_states.shape
    device = hidden_states.device
    if attention_mask is None:
        attention_mask = torch.ones((B, T), dtype=torch.int64, device=device)
    attention_mask = attention_mask.to(device)
    use_flash = T > 1 and cfg.resolved_attention_impl(device) == "pallas"
    bias, flash_args = CausalTransformer._attn_inputs(
        owner, attention_mask, _query_slots(0, B, T, device), use_flash)
    x = hidden_states
    for block in blocks:
        x, _ = block(x, bias, flash_args=flash_args)
    h = owner.ln_f(x) if cfg.final_norm else x
    logits = owner._logits(h if logits_span is None else h[:, logits_span[0] : logits_span[1]])
    return {"logits": logits, "hidden_states": h}


class HydraBranch(nn.Module):
    """The frozen hydra reference of a partially unfrozen model: copies of
    the top blocks (named by their layer index, as in the backbone's state
    dict), the final norm and the (tied) embedding — what
    ``trlx_tpu/models/builder.py::hydra_ref_params`` keeps."""

    def __init__(self, cfg: TransformerConfig, layers: List[int]):
        super().__init__()
        self.config = cfg
        self.layers = list(layers)
        self.blocks = nn.ModuleDict({str(i): Block(cfg) for i in self.layers})
        if cfg.final_norm:
            self.ln_f = LayerNorm(cfg)
        if cfg.tie_word_embeddings:
            self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=cfg.param_dtype)
        else:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                     dtype=cfg.param_dtype)

    _attention_bias = CausalTransformer._attention_bias
    _logits = CausalTransformer._logits

    def forward(self, hidden_states, attention_mask=None, positions=None, logits_span=None):
        blocks = [self.blocks[str(i)] for i in self.layers]
        return _run_branch(self, blocks, hidden_states, attention_mask, logits_span)


def make_kv_cache(
    cfg: TransformerConfig, batch_size: int, max_length: int, dtype=None, device=None
) -> List[Dict[str, torch.Tensor]]:
    """All-zeros per-layer ``{"k", "v"}`` cache of ``[batch, max_length,
    kv_heads, head_dim]`` (also the block-pool layout: rows = blocks)."""
    dtype = dtype or cfg.dtype
    shape = (batch_size, max_length, cfg.kv_heads, cfg.dims_per_head)
    return [
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(cfg.num_layers)
    ]
