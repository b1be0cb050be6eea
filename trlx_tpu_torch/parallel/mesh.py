"""Device mesh construction.

Port of ``trlx_tpu/parallel/mesh.py``. The axes are JAX's, in JAX's
order (:data:`MESH_AXES`): ``data`` (replicas), ``pipe`` (pipeline
stages), ``fsdp`` (sharded parameters and optimizer state; a data axis for
the batch), ``model`` (tensor parallelism), ``sequence`` (ring attention)
and ``expert`` (expert parallelism). The port runs one device per process,
so the mesh spans the processes of the ``torch.distributed`` world: its
device count is the world size, and :func:`make_mesh` returns a
``torch.distributed.device_mesh.DeviceMesh`` over them, rank ``r`` at the
row-major position ``r`` of the shape (``data`` outermost, so with ranks
numbered host by host the data axis is the one that crosses hosts).
``parallel.dcn_data_parallelism`` = k splits the data axis into (k, data
/ k) with the k factor across hosts, as JAX's
``create_hybrid_device_mesh`` lays it (:func:`hybrid_rank_array`): each
host (a contiguous block of ranks) holds an ``ici`` sub-mesh of the shape
with the data axis cut by k, and the k blocks stack along ``data``. With
one device per process that layout is the row-major one, so only the
data-parallel collectives cross hosts either way.

A trainer builds the mesh only when the world holds more than one
process; at world size 1 no ``DeviceMesh`` exists, :func:`get_global_mesh`
returns None and the one-device path runs as before.
"""

import math
from typing import Any, Optional, Tuple

from trlx_tpu_torch.data.configs import ParallelConfig

__all__ = [
    "MESH_AXES",
    "get_global_mesh",
    "hybrid_rank_array",
    "local_mesh",
    "make_mesh",
    "mesh_descriptor",
    "mesh_shape_from_config",
    "set_global_mesh",
    "world_size",
]

MESH_AXES = ("data", "pipe", "fsdp", "model", "sequence", "expert")

# The process-wide mesh, set by trainers at construction (JAX's). The
# port's model code does not read it: its tensors are per rank, so only a
# forward on a sequence-sharded batch is given the ``sequence`` group.
_GLOBAL_MESH: Optional[Any] = None


def set_global_mesh(mesh: Optional[Any]) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_global_mesh() -> Optional[Any]:
    return _GLOBAL_MESH


def world_size() -> int:
    """The initialized ``torch.distributed`` world's size, else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def axis_sizes(mesh: Any) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` (or of a mapping, as it is)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_descriptor(mesh: Any) -> dict:
    """JSON-serializable identity of a mesh: axis names and sizes, the
    device and process counts (one device per process in the port) and the
    device type. Ranks are left out: the same topology on other hosts
    compares equal."""
    sizes = axis_sizes(mesh)
    n = int(math.prod(sizes.values()))
    return {
        "axes": [str(a) for a in sizes],
        "shape": [int(s) for s in sizes.values()],
        "device_count": n,
        "process_count": n,
        "platform": str(mesh.device_type),
    }


def local_mesh(parallel: Optional[ParallelConfig] = None) -> None:
    """The mesh over this process's own devices, the actor-slice mesh of a
    disaggregated fleet (JAX's ``local_mesh``). A process of the port
    drives one device, so the config must fit one device
    (``mesh_shape_from_config`` raises otherwise) and the mesh is the
    one-device path: None, no ``DeviceMesh``."""
    mesh_shape_from_config(parallel or ParallelConfig(), 1)
    return None


def mesh_shape_from_config(
    parallel: ParallelConfig, device_count: Optional[int] = None
) -> Tuple[int, int, int, int, int, int]:
    """Resolve the 6-axis mesh shape; a single ``-1`` axis is inferred. The
    device count defaults to the world size."""
    n = device_count if device_count is not None else world_size()
    sizes = [
        parallel.data,
        parallel.pipe,
        parallel.fsdp,
        parallel.model,
        parallel.sequence,
        parallel.expert,
    ]
    if sizes.count(-1) > 1:
        raise ValueError(f"At most one mesh axis may be -1, got {sizes}")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known != 0:
            raise ValueError(
                f"Device count {n} not divisible by fixed axes product {known}"
            )
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(
            f"Mesh {dict(zip(MESH_AXES, sizes))} needs {math.prod(sizes)} devices, "
            f"have {n}"
        )
    return tuple(sizes)


def hybrid_rank_array(shape: Tuple[int, ...], dcn: int):
    """The ranks of a mesh of ``shape`` laid out as JAX's
    ``create_hybrid_device_mesh(ici_shape, dcn_shape)`` lays devices, for
    one device per process and ranks numbered host by host: ``dcn`` blocks
    of ``n / dcn`` consecutive ranks (the hosts), each reshaped row-major to
    ``ici_shape`` (``shape`` with its data axis cut by ``dcn``), stacked
    along the data axis."""
    import numpy as np

    n = int(math.prod(shape))
    if dcn < 1 or shape[0] % dcn:
        raise ValueError(f"data axis {shape[0]} not divisible by dcn_data_parallelism {dcn}")
    ici_shape = (shape[0] // dcn,) + tuple(shape[1:])
    blocks = [np.arange(g * n // dcn, (g + 1) * n // dcn).reshape(ici_shape)
              for g in range(dcn)]
    return np.concatenate(blocks, axis=0)


def make_mesh(parallel: Optional[ParallelConfig] = None, device_type: str = "cuda"):
    """The global ``DeviceMesh`` of a :class:`ParallelConfig` over the
    initialized world (``init_device_mesh`` with :data:`MESH_AXES` as its
    dimension names). With ``dcn_data_parallelism`` > 1 the ranks take
    JAX's hybrid layout (:func:`hybrid_rank_array`), which must divide the
    data axis, as in JAX."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    parallel = parallel or ParallelConfig()
    shape = mesh_shape_from_config(parallel)
    dcn = int(parallel.dcn_data_parallelism)
    if dcn > 1:
        import torch

        ranks = torch.as_tensor(hybrid_rank_array(shape, dcn))
        return DeviceMesh(device_type, ranks, mesh_dim_names=MESH_AXES)
    return init_device_mesh(device_type, shape, mesh_dim_names=MESH_AXES)
