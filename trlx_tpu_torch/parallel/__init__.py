"""Parallelism: the device mesh, the sharding rules and ring attention.

Port of ``trlx_tpu/parallel`` for the ``data``, ``fsdp`` and ``sequence``
axes: :mod:`.mesh` (a ``torch.distributed`` ``DeviceMesh`` over the
world's processes, one device each), :mod:`.sharding` (JAX's rule table,
FSDP2 placement of the ``fsdp`` part, each rank's part of a batch) and
:mod:`.ring_attention` (exact attention over a sequence split around a
ring, on the flash kernels). Tensor, expert and pipeline parallelism are
not ported (the trainers refuse ``model``, ``expert`` and ``pipe`` above
1).
"""

from trlx_tpu_torch.parallel.mesh import (
    MESH_AXES,
    get_global_mesh,
    make_mesh,
    mesh_shape_from_config,
    set_global_mesh,
)
from trlx_tpu_torch.parallel.sharding import (
    batch_spec,
    param_spec_for_path,
    shard_batch,
    shard_params,
)

__all__ = [
    "MESH_AXES",
    "get_global_mesh",
    "set_global_mesh",
    "make_mesh",
    "mesh_shape_from_config",
    "param_spec_for_path",
    "batch_spec",
    "shard_batch",
    "shard_params",
]
