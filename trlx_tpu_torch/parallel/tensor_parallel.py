"""Tensor parallelism over the mesh's ``model`` axis, Megatron-style.

JAX gets tensor parallelism from GSPMD: the rule table
(``parallel/sharding.py``) names the ``model`` dims of every weight and
the compiler inserts the collectives. The port writes them itself, as
``torch.autograd.Function`` s on plain c10d calls (DTensor's functional
collectives do not run on a ``gloo`` group with CUDA tensors):

- :func:`copy_to_model` (identity; backward all-reduces) and
  :func:`reduce_from_model` (all-reduce; backward identity) bracket a
  column-parallel projection (its output features on the rank) and a
  row-parallel one (its input features on the rank): q/k/v → o_proj,
  gate/up → down, the heads' in_proj → out_proj. A row-parallel bias is
  added once, after the all-reduce;
- :func:`gather_from_model` joins the rank's vocabulary slice of the
  logits (backward: the rank's slice of the gradient);
- :func:`vocab_parallel_embed`: each rank looks up the ids of its
  vocabulary range, the others read zero, and one all-reduce sums them;
- :func:`vocab_parallel_logprobs` / :func:`vocab_parallel_entropy`: the
  log-softmax of vocabulary-sharded logits from all-reduced maxima and
  sums, without gathering ``[B, T, V]``.

:func:`apply_tensor_parallel` cuts a model's weights to the rank's share
in place and tells each module how it runs. Splits are head-aligned:

- attention splits when ``model`` divides the query heads. The KV heads
  split with them when ``model`` divides them too; otherwise (GQA with
  fewer KV heads than ranks) k/v replicate and each rank keeps the KV
  heads its query heads read (:func:`kv_heads_of_rank`), the same math
  as JAX's split. Otherwise the whole attention replicates;
- the dense MLP and the MoE experts' ffn dim split when ``model``
  divides ``intermediate_size`` (the router replicates, so routing and
  capacity drops agree across ranks);
- the word embedding and the LM head split the vocabulary when ``model``
  divides it (JAX's ``fit_spec`` drops ``model`` otherwise: GPT-2's
  50257, the ``test`` presets' 259), tied heads following ``wte``;
- the MLP heads split their hidden ``2E`` when ``model`` divides it.

A replicated weight takes the same gradient on every ``model`` rank up to
rounding, except LoRA's adapters on a split projection and the
replicated k/v projections of a GQA split (their adapters included),
which each see the rank's share: :func:`sync_model_grads` sums those
over ``model`` and averages the rest, so the ranks' weights stay
bitwise equal.
"""

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

__all__ = [
    "TensorParallel",
    "apply_tensor_parallel",
    "attention_split",
    "copy_to_model",
    "gather_from_model",
    "kv_heads_of_rank",
    "local_logits",
    "mlp_split",
    "reduce_from_model",
    "sync_model_grads",
    "tp_param_dims",
    "vocab_parallel_embed",
    "vocab_parallel_entropy",
    "vocab_parallel_logprobs",
    "vocab_split",
]


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A rank's place on the ``model`` axis: the process group, its size
    and this rank's index in it."""

    group: Any
    size: int
    rank: int

    def part(self, n: int) -> Tuple[int, int]:
        """``[lo, hi)`` of this rank's contiguous ``n / size`` share."""
        width = n // self.size
        return self.rank * width, (self.rank + 1) * width


# ---------------------------------------------------------------------------
# the split decisions (pure functions of the config and the axis size: the
# modules, the rule table's port specs and the manifests agree on them)
# ---------------------------------------------------------------------------


def attention_split(cfg, n: int) -> bool:
    """Attention splits its query heads over ``n`` ranks."""
    return n > 1 and cfg.num_heads % n == 0


def kv_split(cfg, n: int) -> bool:
    """k/v split with the query heads (``n`` divides the KV heads)."""
    return attention_split(cfg, n) and cfg.kv_heads % n == 0


def kv_heads_of_rank(cfg, n: int, rank: int) -> List[int]:
    """The global KV heads the rank's cache holds. Split: its contiguous
    share. GQA with KV heads that ``n`` does not divide: the KV heads its
    query heads read, once each when its heads form whole groups or one
    group's share (a uniform local GQA), else one per query head."""
    H, KV = cfg.num_heads, cfg.kv_heads
    if not attention_split(cfg, n):
        return list(range(KV))
    heads = range(rank * (H // n), (rank + 1) * (H // n))
    group = H // KV
    read = [h // group for h in heads]
    unique = sorted(set(read))
    if len(heads) % len(unique) == 0 and read == [u for u in unique
                                                  for _ in range(len(heads) // len(unique))]:
        return unique
    return read


def local_kv_heads(cfg, n: int) -> int:
    """The KV heads of one rank's cache and pool."""
    return len(kv_heads_of_rank(cfg, n, 0))


def mlp_split(cfg, n: int) -> bool:
    """The (dense or per-expert) ffn dim splits over ``n`` ranks."""
    return n > 1 and cfg.intermediate_size % n == 0


def vocab_split(cfg, n: int) -> bool:
    """The word embedding and the LM head split the vocabulary."""
    return n > 1 and cfg.vocab_size % n == 0


def head_split(cfg, n: int) -> bool:
    """The MLP heads split their hidden ``2 E``."""
    return n > 1 and (2 * cfg.hidden_size) % n == 0


def tp_param_dims(name: str, shape: Tuple[int, ...], cfg, n: int) -> Optional[int]:
    """The dim of the port's parameter ``name`` (a ``state_dict`` key, full
    ``shape``) that the ``model`` axis splits, or None where it
    replicates: the rule table's ``model`` dims, head-aligned."""
    if n <= 1:
        return None
    parts = name.split(".")
    leaf, owner = parts[-1], parts[-2] if len(parts) > 1 else ""
    if leaf in ("lora_a", "lora_b", "router") or owner == "router":
        return None
    if owner in ("wte", "lm_head"):
        if not vocab_split(cfg, n):
            return None
        return 0  # [V, E] and the lm_head bias [V]
    if owner in ("q_proj", "o_proj"):
        if not attention_split(cfg, n):
            return None
        return 1 if owner == "o_proj" and leaf == "weight" else (
            0 if owner == "q_proj" else None)
    if owner in ("k_proj", "v_proj"):
        return 0 if kv_split(cfg, n) else None
    if owner in ("gate_proj", "up_proj", "down_proj"):
        if not mlp_split(cfg, n):
            return None
        if owner == "down_proj":
            return 1 if leaf == "weight" else None
        return 0
    if leaf in ("w_gate", "w_up", "w_down"):
        if not mlp_split(cfg, n):
            return None
        return 1 if leaf == "w_down" else 2
    if owner in ("in_proj", "out_proj"):
        if not head_split(cfg, n):
            return None
        if owner == "out_proj":
            return 1 if leaf == "weight" else None
        return 0
    return None


# ---------------------------------------------------------------------------
# collectives inside autograd
# ---------------------------------------------------------------------------


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``, in f32 (gloo does not reduce every dtype),
    in ``x``'s dtype."""
    y = x.float().contiguous() if x.dtype != torch.float32 else x.clone().contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp: TensorParallel):
        ctx.tp, ctx.width = tp, x.shape[-1]
        parts = x.movedim(-1, 0).contiguous()
        out = parts.new_empty((tp.size * parts.shape[0],) + tuple(parts.shape[1:]))
        dist.all_gather_into_tensor(out, parts, group=tp.group)
        return out.movedim(0, -1).contiguous()

    @staticmethod
    def backward(ctx, g):
        lo = ctx.tp.rank * ctx.width
        return g[..., lo:lo + ctx.width], None


def copy_to_model(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """Identity; the backward sums the gradient over ``model`` (the input
    of a column-parallel projection)."""
    if tp is None or not torch.is_grad_enabled() or not x.requires_grad:
        return x
    return _Copy.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """The sum over ``model`` (the output of a row-parallel projection);
    the backward passes the gradient as it is."""
    if tp is None:
        return x
    return _Reduce.apply(x, tp.group)


def gather_from_model(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """Every rank's last-dim slice joined in rank order; the backward
    keeps the rank's slice."""
    if tp is None:
        return x
    return _Gather.apply(x, tp)


def vocab_parallel_embed(weight: torch.Tensor, ids: torch.Tensor, lo: int,
                         tp: TensorParallel) -> torch.Tensor:
    """Rows of a vocabulary-sharded table (``weight`` holds ids ``[lo, lo +
    rows)``): ids outside the range read zero, one all-reduce sums the
    ranks."""
    local = ids.to(torch.int64) - lo
    inside = (local >= 0) & (local < weight.shape[0])
    x = weight[local.clamp(0, weight.shape[0] - 1)] * inside[..., None].to(weight.dtype)
    return reduce_from_model(x, tp)


class _VocabLogprobs(torch.autograd.Function):
    """``log_softmax(logits)[label]`` over vocabulary-sharded f32 logits:
    the max and the sum of exponentials all-reduced, the label's logit
    from the rank that holds it. Backward: ``onehot - softmax`` on the
    rank's slice."""

    @staticmethod
    def forward(ctx, logits, labels, lo, tp):
        m = logits.max(dim=-1).values
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
        shifted = logits - m[..., None]
        e = shifted.exp()
        s = e.sum(dim=-1)
        dist.all_reduce(s, group=tp.group)
        local = labels.to(torch.int64) - lo
        inside = (local >= 0) & (local < logits.shape[-1])
        picked = shifted.gather(-1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
        picked = torch.where(inside, picked, torch.zeros_like(picked))
        dist.all_reduce(picked, group=tp.group)
        ctx.save_for_backward(e, s, local, inside)
        return picked - s.log()

    @staticmethod
    def backward(ctx, g):
        e, s, local, inside = ctx.saved_tensors
        grad = -(e / s[..., None]) * g[..., None]
        onehot = torch.zeros_like(grad)
        onehot.scatter_(-1, local.clamp(0, e.shape[-1] - 1)[..., None],
                        (g * inside.to(g.dtype))[..., None])
        return grad + onehot, None, None, None


def vocab_parallel_logprobs(logits: torch.Tensor, labels: torch.Tensor, lo: int,
                            tp: TensorParallel) -> torch.Tensor:
    """Log-probabilities of ``labels`` under vocabulary-sharded ``logits``
    (``[.., V / model]``, ids ``[lo, lo + V / model)``), in f32, with no
    ``[.., V]`` tensor."""
    return _VocabLogprobs.apply(logits.float(), labels, lo, tp)


def vocab_parallel_entropy(logits: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The softmax entropy of vocabulary-sharded logits (no gradient:
    the loss logs it)."""
    with torch.no_grad():
        x = logits.detach().float()
        m = x.max(dim=-1).values
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
        shifted = x - m[..., None]
        e = shifted.exp()
        s = e.sum(dim=-1)
        es = (e * shifted).sum(dim=-1)
        dist.all_reduce(s, group=tp.group)
        dist.all_reduce(es, group=tp.group)
        return s.log() - es / s


# a forward under :func:`local_logits` keeps the rank's vocabulary slice
_LOCAL = threading.local()


@contextlib.contextmanager
def local_logits() -> Iterator[None]:
    """Forwards inside return each rank's vocabulary slice of the logits
    (no gather); the loss reads them with :func:`vocab_parallel_logprobs`
    through the model's ``vocab_shard``."""
    before = getattr(_LOCAL, "on", False)
    _LOCAL.on = True
    try:
        yield
    finally:
        _LOCAL.on = before


def logits_stay_local() -> bool:
    return getattr(_LOCAL, "on", False)


# ---------------------------------------------------------------------------
# cutting a model to the rank's share
# ---------------------------------------------------------------------------


def _cut(module: nn.Module, name: str, dim: int, tp: TensorParallel) -> Tuple[int, int]:
    """Replace parameter ``name`` of ``module`` by its rank's contiguous
    share along ``dim``; returns the share's ``[lo, hi)``."""
    p = getattr(module, name)
    lo, hi = tp.part(p.shape[dim])
    piece = p.detach().narrow(dim, lo, hi - lo).clone()
    setattr(module, name, nn.Parameter(piece, requires_grad=p.requires_grad))
    return lo, hi


def _column(layer: nn.Linear, tp: TensorParallel) -> None:
    lo, hi = _cut(layer, "weight", 0, tp)
    if layer.bias is not None:
        _cut(layer, "bias", 0, tp)
    layer.out_features = hi - lo
    layer.tp, layer.tp_mode, layer.tp_range = tp, "column", (lo, hi)


def _row(layer: nn.Linear, tp: TensorParallel) -> None:
    lo, hi = _cut(layer, "weight", 1, tp)
    layer.in_features = hi - lo
    layer.tp, layer.tp_mode, layer.tp_range = tp, "row", (lo, hi)


def _with_tp(cfg, n: int):
    return dataclasses.replace(cfg, model_parallel=n)


def apply_tensor_parallel(model: nn.Module, tp: TensorParallel) -> Dict[str, int]:
    """Cut ``model``'s weights (a policy with or without heads, a hydra
    branch, a bare backbone) to this rank's share of the ``model`` axis in
    place, and set up each module's collectives. Returns ``{state_dict
    key: split dim}`` of every split parameter (also kept as the root's
    ``tp_dims``). Call before FSDP2 wraps the model and before an
    optimizer sees it."""
    from trlx_tpu_torch.models.heads import MLPHead
    from trlx_tpu_torch.models.transformer import (
        Attention,
        CausalTransformer,
        HydraBranch,
        MLP,
        MoEMLP,
        TransformerConfig,
    )

    n = tp.size
    cfg = next(m.config for m in model.modules()
               if isinstance(getattr(m, "config", None), TransformerConfig))
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    with torch.no_grad():
        for m in list(model.modules()):
            if isinstance(m, Attention) and attention_split(cfg, n):
                lo, hi = tp.part(cfg.num_heads)
                m.heads, m.head_range = hi - lo, (lo, hi)
                _column(m.q_proj, tp)
                kv = kv_heads_of_rank(cfg, n, tp.rank)
                if kv_split(cfg, n):
                    _column(m.k_proj, tp)
                    _column(m.v_proj, tp)
                else:
                    m.kv_index, m.tp = kv, tp
                    m.k_proj.tp_grad_partial = m.v_proj.tp_grad_partial = True
                m.n_kv = len(kv)
                _row(m.o_proj, tp)
            elif isinstance(m, MLP) and mlp_split(cfg, n):
                for layer in ((m.gate_proj,) if m.gated else ()) + (m.up_proj,):
                    _column(layer, tp)
                _row(m.down_proj, tp)
            elif isinstance(m, MoEMLP) and mlp_split(cfg, n):
                for name in (("w_gate",) if m.gated else ()) + ("w_up",):
                    _cut(m, name, 2, tp)
                _cut(m, "w_down", 1, tp)
                m.tp = tp
            elif isinstance(m, MLPHead) and head_split(cfg, n):
                _column(m.in_proj, tp)
                _row(m.out_proj, tp)
            if isinstance(m, (CausalTransformer, HydraBranch)):
                m.tp = tp
                if attention_split(cfg, n):
                    m.head_range = tp.part(cfg.num_heads)
                if vocab_split(cfg, n):
                    if hasattr(m, "wte"):
                        m.vocab_range = _cut(m.wte, "weight", 0, tp)
                        m.wte.num_embeddings = m.vocab_range[1] - m.vocab_range[0]
                    if hasattr(m, "lm_head"):
                        _column(m.lm_head, tp)
                        m.vocab_range = m.lm_head.tp_range
            for attr in ("config", "cfg"):
                if isinstance(getattr(m, attr, None), TransformerConfig):
                    setattr(m, attr, _with_tp(getattr(m, attr), n))
    dims = {}
    for k, p in model.named_parameters():
        if tuple(p.shape) != shapes[k]:
            dims[k] = next(d for d, (a, b) in enumerate(zip(p.shape, shapes[k])) if a != b)
    model.tp_dims = dims
    model.tp_partial = [k for k, _ in model.named_parameters()
                        if k not in dims and _partial_grad(model, k)]
    model.tensor_parallel = tp
    return dims


def _partial_grad(model: nn.Module, key: str) -> bool:
    """Each ``model`` rank holds the parameter ``key`` whole but takes only
    its share of the gradient: LoRA's adapters on a split projection, and
    every parameter of a replicated k/v projection whose KV heads the
    ranks read in part."""
    layer = model.get_submodule(key.rsplit(".", 1)[0])
    if getattr(layer, "tp_grad_partial", False):
        return True
    return (key.endswith((".lora_a", ".lora_b"))
            and getattr(layer, "tp_mode", None) is not None)


def sync_model_grads(model: nn.Module) -> None:
    """Make the replicated parameters' gradients whole and equal on every
    ``model`` rank, in one all-reduce over ``model``: summed for those each
    rank sees a share of (LoRA's adapters on a split projection, the
    replicated k/v projections of a GQA split), averaged
    for the rest. Each rank computes the latter whole, but a backward that
    accumulates in no fixed order (the embedding's, on the card or on CPU
    threads) may round them apart, and the ranks' weights must stay equal.
    A no-op without tensor parallelism."""
    tp = getattr(model, "tensor_parallel", None)
    if tp is None:
        return
    partial, dims = set(getattr(model, "tp_partial", ())), getattr(model, "tp_dims", {})
    grads = [(k in partial, p.grad.to_local() if hasattr(p.grad, "to_local") else p.grad)
             for k, p in model.named_parameters() if k not in dims and p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for _, g in grads])
    dist.all_reduce(flat, group=tp.group)
    at = 0
    for summed, g in grads:
        n = g.numel()
        part = flat[at:at + n].view_as(g)
        g.copy_(part if summed else part / tp.size)
        at += n
