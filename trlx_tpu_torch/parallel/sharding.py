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

:func:`shard_params` applies the ``fsdp`` part with FSDP2
(``torch.distributed.fsdp.fully_shard``), each block first, then the root.
Design: FSDP2 runs over a two-dim mesh of its own, ``replicate`` =
every axis but ``fsdp`` (``data`` x ``sequence`` here) and ``shard`` =
``fsdp``, the ranks taken from the global mesh. So a weight is sharded
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
"""

import functools
import logging
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

from trlx_tpu_torch.parallel.mesh import axis_sizes

__all__ = [
    "batch_spec",
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
                    mesh: Optional[Any] = None) -> tuple:
    """The spec of the port's parameter ``name`` (a ``state_dict`` key) in
    the port's own dims: the rule of its JAX path on JAX's shape, mapped
    back through the ``[out, in]`` transpose of a Linear weight."""
    from trlx_tpu_torch.models.weights import jax_param_path

    path, transposed = jax_param_path(name, wrapped)
    jax_shape = tuple(shape)[::-1] if transposed else tuple(shape)
    spec = param_spec_for_path("/".join(path), jax_shape, mesh)
    return tuple(spec)[::-1] if transposed else tuple(spec)


def _fsdp_mesh(mesh):
    """FSDP2's two-dim mesh (``replicate``, ``shard``): ``shard`` is the
    global mesh's ``fsdp`` axis, ``replicate`` every other axis, flattened
    in mesh order; the ranks are the global mesh's."""
    from torch.distributed.device_mesh import DeviceMesh

    names = list(mesh.mesh_dim_names)
    f = names.index("fsdp")
    order = [i for i in range(len(names)) if i != f] + [f]
    ranks = mesh.mesh.permute(*order).reshape(-1, mesh.mesh.shape[f])
    return DeviceMesh(mesh.device_type, ranks, mesh_dim_names=("replicate", "shard"))


def shard_params(model, mesh) -> None:
    """Shard ``model`` in place with FSDP2 over ``mesh`` (the module
    docstring's design): ``fully_shard`` on each transformer block, then
    on the root, every parameter sharded over ``fsdp`` on the dim its rule
    names (dim 0 where the rule replicates or no prefix divides), gradients
    summed over every rank. Build the optimizer after this call: the
    parameters become ``DTensor`` s."""
    import torch
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from trlx_tpu_torch.models.transformer import Block
    from trlx_tpu_torch.models.weights import HEAD_PREFIXES

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


def _coords(mesh) -> Dict[str, int]:
    """This rank's index along every axis of ``mesh``."""
    import torch.distributed as dist

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
