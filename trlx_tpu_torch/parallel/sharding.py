"""Path-based parameter sharding rules, FSDP2 placement and batch sharding.

Port of ``trlx_tpu/parallel/sharding.py``. One ordered rule table
(:data:`_RULES`, JAX's, first match wins) maps every parameter *path* of
the JAX tree to a spec over the mesh axes; specs are tuples of axis names
(an entry is None, a name, or a tuple of names sharding one dim together),
the port's stand-in for ``PartitionSpec``. :func:`fit_spec` keeps, per dim,
the longest prefix of its axis group that divides it.

The port's tensors are not JAX's: a ``Linear`` weight is ``[out, in]``
where flax's kernel is ``[in, out]``, and layers are ``blocks.{i}``
modules where JAX may stack them. :func:`port_param_spec` maps a
parameter of the port onto JAX's path and shape
(``models/weights.py::jax_param_path``), resolves the rule there and maps
the dims back through the transpose.

:func:`shard_params` first cuts each weight to the rank's share of the
``model`` axis (``parallel/tensor_parallel.py``: head-aligned; a
parameter the port replicates keeps no ``model`` entry in
:func:`port_param_spec`), then applies the ``fsdp`` part to the share
with FSDP2 (``torch.distributed.fsdp.fully_shard``), each block first,
then the root. Design: FSDP2 runs over a two-dim mesh of its own per
``model`` coordinate, ``replicate`` = every axis but ``fsdp`` and
``model`` (``data`` x ``sequence`` here) and ``shard`` = ``fsdp``, the
ranks taken from the global mesh (a 3-D mesh ``model`` x ``replicate`` x
``shard`` sliced to the rank's coordinate); with ``model`` alone (``data``
x ``fsdp`` = 1) no FSDP2 is applied. So a weight is sharded
over ``fsdp`` on the dim the rule table names (``shard_placement_fn``;
dim 0 where the table replicates, since FSDP2 shards every parameter) and
replicated over ``data`` and ``sequence``, as JAX's specs say; and the
gradient reduction is one FSDP2 reduction over both dims: a
reduce-scatter over ``fsdp``, then an all-reduce over ``data`` x
``sequence``. It sums (the divide factor is 1, the collectives plain
sums): each rank's loss is its share of the global token mean (its NLL
sum over the token count of every rank), so the sum over all ranks is the
gradient of the global loss, scaled once, by the one division inside the
loss. A flattened (``fsdp``, ``sequence``) shard dim would also sum, but
would shard weights over ``sequence`` too, against the table.

:func:`shard_batch` gives each rank its rows over ``data`` x ``fsdp``
and, for sequence-sharded arrays, its zigzag shard of the sequence over
``sequence`` (``parallel/ring_attention.py::zigzag_order``).

The RL and preference trainers (PPO, GRPO, ILQL, DPO) run over ``data``
x ``fsdp`` (ranks that differ only in ``model`` take the same rows):
:func:`row_part` is a rank's contiguous rows of a host batch
(None when the data axes do not divide it, which replicates, as in JAX);
:func:`allgather_host` joins per-rank host results in rank order (the
rollout store is the one a single process builds); :func:`gather_rows`
joins a loss operand's rows over the data axes inside autograd, its
backward keeping this rank's slice only, so a loss every rank computes on
the whole minibatch is differentiated once (FSDP2 sums the ranks);
:func:`unsharded` holds every FSDP2 unit's full weights for a stretch of
forwards whose number differs per rank (a collection on the rank's rows)
and :func:`full_model_state` gives every rank the full weights (a frozen
reference copy), joined over ``fsdp`` and ``model``;
:func:`load_full_model_state` hands each rank its share of full weights.
"""

import contextlib
import functools
import logging
import re
import sys
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from trlx_tpu_torch.parallel.mesh import axis_sizes

__all__ = [
    "allgather_host",
    "load_full_model_state",
    "batch_spec",
    "data_parallel_rank",
    "data_parallel_size",
    "full_model_state",
    "full_tensor",
    "gather_rows",
    "global_grad_norm",
    "local_shard",
    "row_part",
    "unsharded",
    "fit_spec",
    "param_spec_for_path",
    "port_param_spec",
    "shard_batch",
    "shard_params",
    "spec_shards",
    "spec_to_jsonable",
]

logger = logging.getLogger(__name__)

# Ordered (path regex, spec) rules; first match wins. Paths are joined with
# "/" and include every key from the root of the JAX param tree.
_RULES: Tuple[Tuple[str, tuple], ...] = (
    # attention + mlp column-parallel (output features on `model`)
    (r".*/(q_proj|k_proj|v_proj|gate_proj|up_proj)/kernel$", ("fsdp", "model")),
    (r".*/(q_proj|k_proj|v_proj|gate_proj|up_proj)/bias$", ("model",)),
    # row-parallel (input features on `model`); bias replicated
    (r".*/(o_proj|down_proj)/kernel$", ("model", "fsdp")),
    (r".*/(o_proj|down_proj)/bias$", (None,)),
    # mixture-of-experts MLP: expert dim over `expert`, per-expert matmul
    # dims over fsdp/model like the dense column/row split; the router
    # replicates
    (r".*/mlp/w_(gate|up)$", ("expert", "fsdp", "model")),
    (r".*/mlp/w_down$", ("expert", "model", "fsdp")),
    (r".*/mlp/router/kernel$", (None,)),
    # vocab-parallel embedding (vocab over model x fsdp, embed replicated)
    (r".*/wte/embedding$", (("model", "fsdp"), None)),
    (r".*/wpe/embedding$", (None, None)),
    (r".*/lm_head/kernel$", ("fsdp", "model")),
    (r".*/lm_head/bias$", ("model",)),
    # MLP heads (value / Q): column-parallel in, row-parallel out
    (r".*/in_proj/kernel$", ("fsdp", "model")),
    (r".*/in_proj/bias$", ("model",)),
    (r".*/out_proj/kernel$", ("model", None)),
    (r".*/out_proj/bias$", (None,)),
    # everything else (norm scales/biases, odd singletons): replicated
    (r".*", ()),
)

# Params at or above this size (bytes, assuming 4 B/element: specs see
# only shapes) get a warning when a dim sheds its whole axis group.
_REPLICATE_WARN_BYTES = 8 << 20


def _group_size(sizes: Dict[str, int], axis) -> int:
    if axis is None:
        return 1
    names = axis if isinstance(axis, tuple) else (axis,)
    return int(np.prod([sizes[n] for n in names if n in sizes] or [1]))


def param_spec_for_path(path: str, shape: Tuple[int, ...], mesh: Optional[Any] = None
                        ) -> tuple:
    """The spec of a JAX parameter path. With a ``mesh`` (a ``DeviceMesh``
    or ``{axis: size}``) each dim keeps the longest prefix of its axis
    group that divides it (:func:`fit_spec`); without one the rule's spec
    is padded with None to the rank."""
    for pattern, spec in _RULES:
        if re.match(pattern, path):
            break
    partitions = tuple(spec)
    if "/h_scan/" in path or path.startswith("h_scan/"):
        # scan_layers layout: a leading layer dim over `pipe`
        partitions = ("pipe",) + partitions
    partitions = partitions[: len(shape)]
    if mesh is None:
        return partitions + (None,) * (len(shape) - len(partitions))
    fitted = fit_spec(mesh, shape, partitions)
    sizes = axis_sizes(mesh)
    if int(np.prod(shape)) * 4 >= _REPLICATE_WARN_BYTES:
        for dim, axis, kept in zip(shape, partitions, fitted):
            if axis is None or kept is not None:
                continue
            names = axis if isinstance(axis, tuple) else (axis,)
            present = tuple(n for n in names if n in sizes)
            group = _group_size(sizes, present)
            if group > 1:
                _warn_dropped_axis_group(path, tuple(shape), dim, present, group)
    return fitted


@functools.lru_cache(maxsize=None)
def _warn_dropped_axis_group(path, shape, dim, names, group) -> None:
    """Warn once per (param, shape, axes): no prefix of the group divides
    the dim, so a large parameter replicates instead of sharding."""
    logger.warning(
        "param %s of shape %s (>= %d MiB assuming 4 B/elem): the %d-sized dim "
        "is divisible by no prefix of mesh axes %s (combined size %d) — the "
        "dim replicates instead of sharding; resize the dim or the mesh axes "
        "to recover it",
        path, shape, _REPLICATE_WARN_BYTES >> 20, dim, names, group,
    )


def fit_spec(mesh: Any, shape: Tuple[int, ...], spec: Tuple[Any, ...]) -> tuple:
    """Fit a spec to a concrete shape: per dim, keep the longest prefix of
    the axis group whose product divides the dim (None when no present
    axis divides). Size-1 axes that divide are kept."""
    if len(spec) > len(shape):
        raise ValueError(
            f"spec {tuple(spec)} has more entries than array rank {len(shape)}"
        )
    sizes = axis_sizes(mesh)
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axis is None:
            out.append(None)
            continue
        names = axis if isinstance(axis, tuple) else (axis,)
        keep: list = []
        size = 1
        for n in names:
            if n not in sizes:
                continue  # an absent axis contributes size 1
            s = sizes[n]
            if dim % (size * s):
                break
            keep.append(n)
            size *= s
        if keep:
            out.append(tuple(keep) if len(keep) > 1 else keep[0])
        else:
            out.append(None)
    return tuple(out)


def spec_to_jsonable(spec: tuple) -> list:
    """A spec as JSON-safe nested lists (None | axis name | list of names
    per dim)."""
    out = []
    for axis in tuple(spec):
        if axis is None:
            out.append(None)
        elif isinstance(axis, tuple):
            out.append([str(a) for a in axis])
        else:
            out.append(str(axis))
    return out


def spec_shards(mesh: Any, spec: tuple) -> int:
    """Total ways ``spec`` splits an array on ``mesh`` (1 = a no-op)."""
    sizes = axis_sizes(mesh)
    total = 1
    for axis in spec:
        total *= _group_size(sizes, axis)
    return total


def batch_spec(ndim: int = 2, sequence_sharded: bool = False) -> tuple:
    """Batch arrays shard their leading dim over the data axes (``data`` x
    ``fsdp``), optionally the second (sequence) dim over ``sequence``."""
    rest: Tuple[Optional[str], ...] = ("sequence",) if sequence_sharded else (None,)
    rest = rest + (None,) * (ndim - 2)
    return (("data", "fsdp"),) + rest[: max(ndim - 1, 0)]


def port_param_spec(name: str, shape: Tuple[int, ...], wrapped: bool,
                    mesh: Optional[Any] = None, cfg: Optional[Any] = None) -> tuple:
    """The spec of the port's parameter ``name`` (a ``state_dict`` key) in
    the port's own dims: the rule of its JAX path on JAX's shape, mapped
    back through the ``[out, in]`` transpose of a Linear weight. With the
    model's config ``cfg`` and a ``model`` axis above 1, a ``model`` entry
    stays only where the port splits the parameter
    (``parallel/tensor_parallel.py::tp_param_dims``: head-aligned splits;
    a projection whose heads ``model`` does not divide replicates)."""
    from trlx_tpu_torch.models.weights import jax_param_path

    path, transposed = jax_param_path(name, wrapped)
    jax_shape = tuple(shape)[::-1] if transposed else tuple(shape)
    spec = param_spec_for_path("/".join(path), jax_shape, mesh)
    spec = tuple(spec)[::-1] if transposed else tuple(spec)
    n = axis_sizes(mesh).get("model", 1) if mesh is not None else 1
    if cfg is None or n == 1:
        return spec
    from trlx_tpu_torch.parallel.tensor_parallel import tp_param_dims

    split = tp_param_dims(name, tuple(shape), cfg, n)
    out = []
    for dim, axis in enumerate(spec):
        names = axis if isinstance(axis, tuple) else (axis,)
        if "model" in names and dim != split:
            names = tuple(a for a in names if a != "model")
            axis = None if not names else names if len(names) > 1 else names[0]
        out.append(axis)
    return tuple(out)


def _fsdp_mesh(mesh):
    """FSDP2's two-dim mesh (``replicate``, ``shard``) of this rank's
    ``model`` coordinate: ``shard`` is the global mesh's ``fsdp`` axis,
    ``replicate`` every other axis but ``model``, flattened in mesh order.
    Every rank builds the one 3-D mesh (``model``, ``replicate``,
    ``shard``) of the global mesh's ranks and takes its slice."""
    from torch.distributed.device_mesh import DeviceMesh

    names = list(mesh.mesh_dim_names)
    f, m = names.index("fsdp"), names.index("model")
    order = [m] + [i for i in range(len(names)) if i not in (f, m)] + [f]
    ranks = mesh.mesh.permute(*order).reshape(mesh.mesh.shape[m], -1, mesh.mesh.shape[f])
    full = DeviceMesh(mesh.device_type, ranks,
                      mesh_dim_names=("model", "replicate", "shard"))
    return full["replicate", "shard"]


def shard_params(model, mesh) -> None:
    """Shard ``model`` in place over ``mesh`` (the module docstring's
    design): with a ``model`` axis above 1 each weight first cut to the
    rank's share of it (``parallel/tensor_parallel.py::
    apply_tensor_parallel``), then FSDP2 on this rank's ``model``
    coordinate: ``fully_shard`` on each transformer block, then on the
    root, every parameter sharded over ``fsdp`` on the dim its rule names
    (dim 0 where the rule replicates or no prefix divides), gradients
    summed over the data axes. Build the optimizer after this call: the
    parameters become ``DTensor`` s."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from trlx_tpu_torch.models.transformer import Block
    from trlx_tpu_torch.models.weights import HEAD_PREFIXES
    from trlx_tpu_torch.parallel.mesh import tensor_parallel
    from trlx_tpu_torch.parallel.tensor_parallel import apply_tensor_parallel

    tp = tensor_parallel(mesh)
    if tp is not None and getattr(model, "tensor_parallel", None) is None:
        apply_tensor_parallel(model, tp)
    if tp is not None and data_parallel_size(mesh) == 1:
        # the model axis alone: no FSDP2 (nothing to shard or reduce over
        # the data axes), the rank's share stays plain tensors
        return
    names = {id(p): n for n, p in model.named_parameters()}
    wrapped = any(n.startswith(HEAD_PREFIXES) for n in names.values())

    def placement(param: torch.nn.Parameter):
        spec = port_param_spec(names[id(param)], tuple(param.shape), wrapped, mesh)
        for dim, axis in enumerate(spec):
            if axis == "fsdp" or (isinstance(axis, tuple) and "fsdp" in axis):
                return Shard(dim)
        return Shard(0)

    fsdp_mesh = _fsdp_mesh(mesh)
    units = [m for m in model.modules() if isinstance(m, Block)] + [model]
    for unit in units:
        fully_shard(unit, mesh=fsdp_mesh, shard_placement_fn=placement)
    for unit in units:
        # plain sums: PREMUL_SUM, FSDP2's scaled reduction, is NCCL-only
        unit.set_gradient_divide_factor(1.0)
        unit.set_force_sum_reduction_for_comms(True)
    # the root's other entry (ILQL's loss runs the backbone, then the heads
    # and the projection on gathered rows): FSDP2 gathers the root's
    # weights around it as around ``forward``
    from torch.distributed.fsdp import register_fsdp_forward_method

    if hasattr(model, "backbone_forward"):
        register_fsdp_forward_method(model, "backbone_forward")


def _coords(mesh) -> Dict[str, int]:
    """This rank's index along every axis of ``mesh``."""

    me = dist.get_rank()
    where = (mesh.mesh == me).nonzero()[0].tolist()
    return dict(zip(mesh.mesh_dim_names, where))


def shard_batch(batch: Dict[str, Any], mesh, sequence_sharded: bool = False,
                micro: int = 1) -> Dict[str, Any]:
    """This rank's part of a host batch (numpy arrays): rows over ``data``
    x ``fsdp`` and, with ``sequence_sharded``, the zigzag shard of dim 1
    over ``sequence`` (the caller has made the sequence divisible by ``2 x
    sequence``). ``micro`` > 1 (gradient accumulation) cuts each of the
    ``micro`` consecutive micro-batches of the global batch apart, so the
    rank's ``k``-th local micro-batch is its part of the global one. A
    leading dim that the data axes do not divide replicates, as in JAX.
    Non-array leaves pass through."""
    from trlx_tpu_torch.parallel.ring_attention import zigzag_order

    sizes, at = axis_sizes(mesh), _coords(mesh)
    dp = sizes["data"] * sizes["fsdp"]
    row = at["data"] * sizes["fsdp"] + at["fsdp"]
    n = sizes["sequence"]

    def put(x):
        if not hasattr(x, "ndim") or x.ndim == 0:
            return x
        x = np.asarray(x)
        if x.shape[0] % (dp * micro) == 0:
            x = x.reshape((micro, dp, -1) + x.shape[1:])[:, row].reshape((-1,) + x.shape[1:])
        if sequence_sharded and n > 1 and x.ndim >= 2:
            T = x.shape[1]
            if T % (2 * n):
                raise ValueError(f"sequence length {T} not divisible by 2 x sequence = {2 * n}")
            order = zigzag_order(T, n).reshape(n, -1)[at["sequence"]]
            x = x[:, order]
        return x

    return {k: put(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the RL and preference trainers over ``data`` x ``fsdp``
# ---------------------------------------------------------------------------


def _tp_of(model):
    """``(TensorParallel, {key: split dim})`` of a tensor-parallel model,
    or ``(None, {})``."""
    return getattr(model, "tensor_parallel", None), getattr(model, "tp_dims", {})


def data_parallel_size(mesh) -> int:
    """``data`` x ``fsdp``: the ranks a batch's rows split over (1 without a
    mesh)."""
    if mesh is None:
        return 1
    sizes = axis_sizes(mesh)
    return sizes["data"] * sizes["fsdp"]


def data_parallel_rank(mesh) -> int:
    """This rank's index over ``data`` x ``fsdp`` (``data`` major, as
    :func:`shard_batch` takes rows)."""
    if mesh is None:
        return 0
    sizes, at = axis_sizes(mesh), _coords(mesh)
    return at["data"] * sizes["fsdp"] + at["fsdp"]


def _data_parallel_group(mesh):
    """The process group of this rank's ``data`` x ``fsdp`` ranks (the
    ranks of its ``model`` coordinate; None: the whole world)."""
    from trlx_tpu_torch.parallel.mesh import data_parallel_group

    return data_parallel_group(mesh)


def row_part(rows: int, mesh, unit: int = 1) -> Optional[slice]:
    """This rank's contiguous part of ``rows`` host rows over ``data`` x
    ``fsdp``, in whole units of ``unit`` rows (a GRPO group, a DPO pair);
    None when there is no mesh or the data axes do not divide the units,
    and then every rank takes every row (JAX's replication of an undivided
    leading dim)."""
    dp = data_parallel_size(mesh)
    if dp == 1 or rows % unit or (rows // unit) % dp:
        return None
    size = rows // dp
    at = data_parallel_rank(mesh)
    return slice(at * size, (at + 1) * size)


def allgather_host(obj: Any, mesh) -> List[Any]:
    """Every rank's ``obj`` (picklable host data), in rank order over
    ``data`` x ``fsdp``: one ``all_gather_object`` over this rank's
    data-parallel group, which every rank calls in the same order. Ranks
    that differ only in ``model`` hold the same rows and gather the same
    list, each data-parallel row block once."""

    group = _data_parallel_group(mesh)
    out: List[Any] = [None] * data_parallel_size(mesh)
    dist.all_gather_object(out, obj, group=group)
    return out


class _GatherRows(torch.autograd.Function):
    """Forward: the rows of every rank, concatenated in rank order
    (``all_gather_into_tensor``). Backward: this rank's slice of the
    incoming gradient, not summed, since every rank computes the same loss
    on the gathered rows and FSDP2 sums the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, n: int, at: int, group):
        ctx.rows, ctx.at = x.shape[0], at
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[ctx.at * ctx.rows:(ctx.at + 1) * ctx.rows], None, None, None


class _ReplicatedRows(torch.autograd.Function):
    """Rows every rank already holds whole: the identity forward, and a
    ``1 / n`` share of the gradient, which FSDP2's sum over the ranks makes
    whole."""

    @staticmethod
    def forward(ctx, x, n: int):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def gather_rows(x, mesh, split: bool = True):
    """A loss operand's rows over ``data`` x ``fsdp``, inside autograd:
    with ``split`` (each rank holds its part, :func:`row_part`) the rows of
    every rank in rank order, whose backward keeps this rank's slice only;
    without it (each rank holds every row) ``x`` itself, whose backward
    passes ``1 / n`` of the gradient. Either way a loss every rank computes
    on the result takes, summed over the ranks by FSDP2, the gradient of
    the one global loss. The identity without a mesh."""
    n = data_parallel_size(mesh)
    if n == 1:
        return x
    if not split:
        return _ReplicatedRows.apply(x, n) if x.requires_grad else x
    return _GatherRows.apply(x, n, data_parallel_rank(mesh), _data_parallel_group(mesh))


def fsdp_units(model) -> List[Any]:
    """The model's FSDP2 units (the root, then each block), or none. No
    module is wrapped before FSDP2 is imported, and one process never
    imports it (its import costs seconds), so that case returns at once."""
    if "torch.distributed.fsdp" not in sys.modules:
        return []
    from torch.distributed.fsdp import FSDPModule

    return [m for m in model.modules() if isinstance(m, FSDPModule)]


@contextlib.contextmanager
def unsharded(model) -> Iterator[None]:
    """Hold every FSDP2 unit's full weights for the duration: one
    all-gather per unit on entry (in module order, the same on every rank),
    no reshard after a forward inside, a reshard on exit. The forwards
    inside issue no collective, so each rank may run as many as its own
    rows need (a collection's decode steps). A no-op for a model FSDP2 does
    not wrap."""
    units = fsdp_units(model)
    if not units:
        yield
        return
    # the root keeps its weights after a forward already (FSDP2's root rule)
    inner = [unit for unit in units if unit is not model]
    for unit in inner:
        unit.set_reshard_after_forward(False, recurse=False)
    try:
        for unit in units:
            unit.unshard()
        yield
    finally:
        for unit in units:
            unit.reshard()
        for unit in inner:
            unit.set_reshard_after_forward(True, recurse=False)


def _shard_of(t) -> Optional[Tuple[int, int]]:
    """``(mesh dim, tensor dim)`` of a DTensor's one ``Shard`` placement
    (FSDP2 shards over one mesh dim); None for a replicated DTensor or a
    plain tensor."""
    for mesh_dim, placement in enumerate(getattr(t, "placements", ())):
        if placement.is_shard():
            return mesh_dim, placement.dim
    return None


def full_tensor(t, tp=None, tp_dim: Optional[int] = None):
    """The whole tensor of an FSDP2 ``DTensor`` on every rank (a plain
    tensor passes through): the local shards joined with one
    ``all_gather_into_tensor`` over the shard dim's group, each padded to
    ``torch.chunk``'s size, then, for a tensor that tensor parallelism
    split on ``tp_dim``, every ``model`` rank's share joined over ``tp``'s
    group. Plain c10d collectives only: the functional collectives behind
    ``DTensor.full_tensor`` / ``redistribute`` are not carried by every
    backend on every device (gloo on CUDA tensors)."""
    t = _fsdp_full(t)
    if tp is None or tp_dim is None:
        return t
    part = t.detach().movedim(tp_dim, 0).contiguous()
    out = part.new_empty((tp.size * part.shape[0],) + tuple(part.shape[1:]))
    dist.all_gather_into_tensor(out, part, group=tp.group)
    return out.movedim(0, tp_dim).contiguous()


def _fsdp_full(t):
    where = _shard_of(t)
    if where is None:
        return t.to_local() if hasattr(t, "to_local") else t
    mesh_dim, dim = where
    group = t.device_mesh.get_group(mesh_dim)
    n = dist.get_world_size(group)
    size = t.shape[dim]
    chunk = -(-size // n)
    part = t.to_local().detach().movedim(dim, 0)
    if part.shape[0] < chunk:
        part = torch.cat([part, part.new_zeros((chunk - part.shape[0],) + part.shape[1:])])
    out = part.new_empty((n * chunk,) + part.shape[1:])
    dist.all_gather_into_tensor(out, part.contiguous(), group=group)
    return out[:size].movedim(0, dim).contiguous()


def local_shard(full, like, tp=None, tp_dim: Optional[int] = None):
    """This rank's shard of a whole tensor ``full``: its ``model`` share
    along ``tp_dim`` (a tensor-parallel split), then ``like``'s (a
    DTensor's) placement, as ``torch.chunk`` splits it; ``full`` itself
    for a plain or replicated ``like`` and no split."""
    if tp is not None and tp_dim is not None:
        lo, hi = tp.part(full.shape[tp_dim])
        full = full.narrow(tp_dim, lo, hi - lo)
    where = _shard_of(like)
    if where is None:
        return full
    mesh_dim, dim = where
    group = like.device_mesh.get_group(mesh_dim)
    pieces = full.chunk(dist.get_world_size(group), dim=dim)
    at = dist.get_rank(group)
    return pieces[at] if at < len(pieces) else full.narrow(dim, 0, 0)


def global_grad_norm(grads, split: Optional[List[bool]] = None, tp=None):
    """The 2-norm of every gradient, FSDP2's sharded ones included: each
    shard group's squared sum of its local shards joined by a plain
    ``all_reduce``, replicated gradients counted once. ``split`` flags the
    gradients of parameters tensor parallelism split over ``tp``'s group:
    their squared sums are joined over ``model`` too, each share counted
    once, while a parameter every ``model`` rank holds whole counts once."""
    totals = {}
    for i, g in enumerate(grads):
        where = _shard_of(g)
        local = g.to_local() if hasattr(g, "to_local") else g
        sq = local.detach().float().pow(2).sum()
        key = (None if where is None else g.device_mesh.get_group(where[0]),
               bool(split[i]) if split is not None and tp is not None else False)
        totals[key] = totals.get(key, 0.0) + sq
    out = 0.0
    for (group, over_model), sq in totals.items():
        sq = torch.as_tensor(sq)
        if group is not None:
            dist.all_reduce(sq, group=group)
        if over_model:
            dist.all_reduce(sq, group=tp.group)
        out = out + sq
    return torch.as_tensor(out).sqrt()


def full_model_state(model) -> Dict[str, Any]:
    """The full ``state_dict`` of a sharded model on every rank, on the
    model's device, joined over ``fsdp`` and ``model`` (:func:`full_tensor`,
    a collective: every rank calls it); the model's own ``state_dict``
    when nothing is sharded."""
    tp, dims = _tp_of(model)
    if not fsdp_units(model) and tp is None:
        return model.state_dict()
    return {k: full_tensor(v, tp, dims.get(k)) for k, v in model.state_dict().items()}


def load_full_model_state(model, state: Dict[str, Any]) -> None:
    """Copy a full ``state_dict`` (one device's format, e.g. JAX's weights
    carried over by ``models/weights.py::params_from_jax``) into a sharded
    model: each rank takes its ``model`` share and its FSDP2 shard of every
    tensor (:func:`local_shard`; no collective)."""
    tp, dims = _tp_of(model)
    live = model.state_dict()
    missing = sorted(set(live) ^ set(state))
    if missing:
        raise KeyError(f"the state's keys differ from the model's: {missing[:8]}")
    with torch.no_grad():
        for k, v in live.items():
            target = v.to_local() if hasattr(v, "to_local") else v
            target.copy_(local_shard(torch.as_tensor(state[k]).to(target.device, target.dtype),
                                     v, tp, dims.get(k)))
