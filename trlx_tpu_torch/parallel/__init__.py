"""Parallelism: the device mesh, the sharding rules and ring attention.

Port of ``trlx_tpu/parallel`` for the ``data`` (with its
``dcn_data_parallelism`` layout), ``fsdp``, ``model`` and ``sequence``
axes: :mod:`.mesh` (a ``torch.distributed`` ``DeviceMesh`` over the
world's processes, one device each, with its data-parallel and ``model``
groups), :mod:`.sharding` (JAX's rule table, each rank's ``model`` share
and the FSDP2 placement of the ``fsdp`` part, each rank's part of a
batch), :mod:`.tensor_parallel` (the ``model`` axis's collectives inside
autograd and the head-aligned cut of a model), :mod:`.ring_attention`
(exact attention over a sequence split around a ring, on the flash
kernels), :mod:`.slot_schedule` (one engine's continuous schedule replayed
over the data axes), and the row gathers of the RL and preference
trainers over ``data`` x ``fsdp``. Expert and pipeline parallelism are
not ported (the trainers refuse ``expert`` and ``pipe`` above 1).
"""

from trlx_tpu_torch.parallel.mesh import (
    MESH_AXES,
    get_global_mesh,
    hybrid_rank_array,
    make_mesh,
    mesh_descriptor,
    mesh_shape_from_config,
    set_global_mesh,
)
from trlx_tpu_torch.parallel.sharding import (
    allgather_host,
    batch_spec,
    full_model_state,
    gather_rows,
    param_spec_for_path,
    row_part,
    shard_batch,
    shard_params,
    unsharded,
)

__all__ = [
    "MESH_AXES",
    "get_global_mesh",
    "set_global_mesh",
    "hybrid_rank_array",
    "make_mesh",
    "mesh_descriptor",
    "mesh_shape_from_config",
    "param_spec_for_path",
    "batch_spec",
    "shard_batch",
    "shard_params",
    "allgather_host",
    "full_model_state",
    "gather_rows",
    "row_part",
    "unsharded",
]
