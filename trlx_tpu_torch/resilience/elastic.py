"""Elastic restore across topologies and coordinated preemption over
several processes.

Port of ``trlx_tpu/resilience/elastic.py`` with its names:

**The topology manifest.** Every committed checkpoint carries
``topology.json`` (:func:`build_manifest`, staged and committed with the
state by ``utils/checkpoint.py::save_state``): the mesh's axis names and
shape (``parallel/mesh.py::mesh_descriptor``; one process without a mesh
records every axis at 1), the process and device counts, and per
parameter its JAX path (``models/weights.py::jax_param_path``), the
placement in JAX's dims (``fsdp`` on the dim ``parallel/sharding.py``
shards, ``model`` on the dim tensor parallelism splits, both where both
do, None elsewhere), its dtype and its global shape (the whole tensor's,
across ``model`` too).

**Restore.** :func:`restore_state_elastic` is the one restore entry of the
trainers. It compares the manifest with the live topology
(:func:`manifest_mismatch`) before any tensor is loaded. The port's checkpoint is one full-state file written by rank 0 from the
gathered state, so every restore reads it whole and loads it the same way:
each weight cast to the live parameter's dtype, then
``utils/checkpoint.py::load_full_state`` copies each rank's shards onto
the live mesh. What the comparison decides is the accounting and the
errors:

- a match restores silently;
- a mismatch, or a ``topology_shrink@resume:N`` fault, is an elastic
  restore: timed into ``resilience/reshard_s`` and counted in
  ``resilience/elastic_restores``;
- ``resilience.elastic: false`` turns a mismatch into
  :class:`ElasticRestoreError` (naming the fault when one forced it);
- a global shape that differs from the live parameter's raises: a
  topology change moves placement only;
- a checkpoint without a manifest restores on a matching topology, and a
  failed load is re-raised as a diagnostic that the topology may have
  changed.

**Coordinated preemption.** A SIGTERM lands on one process; the others
keep stepping. :func:`coordinate_preemption` joins the local flag over the
world at every step boundary (through the cluster beat's gather when the
trainer passes it), so every rank takes its emergency checkpoint at the
same step, and rank 0 alone commits it. ``sigterm_one_proc@step:N``
signals process 0 only, to drill exactly this.
"""

import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from trlx_tpu_torch.parallel.mesh import MESH_AXES, mesh_descriptor

logger = logging.getLogger(__name__)

__all__ = [
    "MANIFEST_FORMAT",
    "MANIFEST_NAME",
    "ElasticRestoreError",
    "build_manifest",
    "coordinate_preemption",
    "live_descriptor",
    "manifest_mismatch",
    "read_manifest",
    "restore_state_elastic",
]

MANIFEST_NAME = "topology.json"
MANIFEST_FORMAT = 1


class ElasticRestoreError(RuntimeError):
    """A checkpoint cannot be restored onto the live topology, with the
    reason spelled out (a topology change with elastic restore off, a
    changed global shape, or a manifest-less checkpoint meeting a changed
    topology)."""


def live_descriptor(mesh: Any, device_type: str = "cpu") -> Dict[str, Any]:
    """The live topology in :func:`~trlx_tpu_torch.parallel.mesh.mesh_descriptor`'s
    form: the mesh's, or one process on one device (every axis 1) when no
    mesh is built."""
    if mesh is not None:
        return mesh_descriptor(mesh)
    return {"axes": list(MESH_AXES), "shape": [1] * len(MESH_AXES), "device_count": 1,
            "process_count": 1, "platform": str(device_type)}


def _leaf_records(model: torch.nn.Module) -> Dict[str, Dict[str, Any]]:
    """``{JAX path: {spec, dtype, shape}}`` of every parameter, in JAX's
    dims (a Linear weight transposed); a name without a JAX path keeps the
    port's own."""
    from trlx_tpu_torch.models.weights import HEAD_PREFIXES, jax_param_path

    named = list(model.named_parameters())
    wrapped = any(n.startswith(HEAD_PREFIXES) for n, _ in named)
    tp, dims = getattr(model, "tensor_parallel", None), getattr(model, "tp_dims", {})
    leaves: Dict[str, Dict[str, Any]] = {}
    for name, p in named:
        shape = [int(d) for d in p.shape]
        spec: List[Any] = [None] * len(shape)
        if tp is not None and name in dims:
            # a tensor-parallel share: the global shape, split over model
            shape[dims[name]] *= tp.size
            spec[dims[name]] = "model"
        for placement in getattr(p, "placements", ()):
            if placement.is_shard():
                d = placement.dim
                spec[d] = "fsdp" if spec[d] is None else [spec[d], "fsdp"]
        try:
            path, transposed = jax_param_path(name, wrapped)
            key = "/".join(path)
        except (IndexError, KeyError, ValueError):
            key, transposed = name, False
        if transposed:
            shape, spec = shape[::-1], spec[::-1]
        leaves[key] = {"spec": spec, "dtype": str(p.dtype).replace("torch.", ""),
                       "shape": shape}
    return leaves


def build_manifest(model: torch.nn.Module, mesh: Any = None,
                   device_type: str = "cpu") -> Dict[str, Any]:
    """The topology manifest of a live model: the mesh descriptor and a
    per-leaf ``{spec, dtype, shape}`` record."""
    return {"format": MANIFEST_FORMAT, "mesh": live_descriptor(mesh, device_type),
            "leaves": _leaf_records(model)}


def read_manifest(directory: str) -> Optional[Dict[str, Any]]:
    """The committed topology manifest of ``directory``, or None for a
    checkpoint written without one."""
    path = os.path.join(os.path.abspath(directory), MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def manifest_mismatch(manifest: Dict[str, Any], live: Any) -> Optional[str]:
    """None when the manifest's topology matches ``live`` (a descriptor, a
    ``DeviceMesh``, or None for one process); else what changed."""
    if not isinstance(live, dict):
        live = live_descriptor(live)
    saved = manifest.get("mesh") or {}
    diffs = [f"{field}: saved {saved.get(field)} != live {live.get(field)}"
             for field in ("axes", "shape", "device_count", "process_count")
             if saved.get(field) != live.get(field)]
    return "; ".join(diffs) if diffs else None


def _validate_leaves(manifest: Dict[str, Any], model: torch.nn.Module, directory: str) -> None:
    """Global shapes must agree between the manifest and the live model:
    resharding changes placement, never values or geometry."""
    saved = manifest.get("leaves") or {}
    for path, rec in _leaf_records(model).items():
        want = saved.get(path)
        if want is None:
            continue
        shape = tuple(want.get("shape") or ())
        if shape and shape != tuple(rec["shape"]):
            raise ElasticRestoreError(
                f"checkpoint {directory} leaf {path!r} has global shape {shape}, but the live "
                f"state expects {tuple(rec['shape'])} — a topology change reshards placement "
                "only; a model/config change needs a fresh run")


def _load(model, optimizer, state: Dict[str, Any]) -> None:
    """The state's full tensors into the live model and optimizer, each
    weight cast to the live parameter's dtype and each rank copying in its
    own shards under a mesh (``utils/checkpoint.py::load_full_state``)."""
    from trlx_tpu_torch.utils.checkpoint import load_full_state

    load_full_state(model, optimizer, state["model"], state["optimizer"])


def restore_state_elastic(directory: str, model: torch.nn.Module, optimizer: Any,
                          mesh: Any = None, elastic: bool = True, metrics: Any = None,
                          device_type: str = "cpu") -> Dict[str, Any]:
    """Restore a committed checkpoint into ``model`` and ``optimizer`` on
    whatever topology they live on (the module docstring's decision
    table); returns the whole loaded state (step, extras, generators)."""
    from trlx_tpu_torch.resilience.faults import poll_fault
    from trlx_tpu_torch.utils.checkpoint import load_state

    manifest = read_manifest(directory)
    forced = poll_fault("topology_shrink")
    if forced:
        logger.warning("fault plan: topology_shrink — forcing the elastic reshard path for "
                       "restore from %s", directory)
    state = load_state(directory)
    if manifest is None:
        if forced:
            return _timed_reshard(directory, model, optimizer, state, metrics,
                                  "forced (manifest-less)")
        try:
            _load(model, optimizer, state)
        except (RuntimeError, ValueError, KeyError) as e:
            raise ElasticRestoreError(
                f"restore from {directory} failed and the checkpoint carries no topology "
                "manifest: if the process topology changed since the save, this checkpoint "
                "cannot be resharded automatically — re-save it on its original topology to "
                f"stamp a manifest, or restore on a matching one. Underlying error: {e}"
            ) from e
        return state
    _validate_leaves(manifest, model, directory)
    mismatch = manifest_mismatch(manifest, live_descriptor(mesh, device_type))
    if mismatch is None and not forced:
        _load(model, optimizer, state)
        return state
    if not elastic:
        if mismatch is None:
            raise ElasticRestoreError(
                f"fault plan injected topology_shrink for restore from {directory}, but "
                "resilience.elastic is off and the live mesh matches the manifest — drop the "
                "fault or enable resilience.elastic")
        raise ElasticRestoreError(
            f"checkpoint {directory} was saved on a different topology ({mismatch}) and "
            "resilience.elastic is off — enable it to reshard on restore, or relaunch on the "
            "original topology")
    return _timed_reshard(directory, model, optimizer, state, metrics, mismatch or "forced")


def _timed_reshard(directory, model, optimizer, state, metrics, reason: str) -> Dict[str, Any]:
    t0 = time.monotonic()
    _load(model, optimizer, state)
    dt = time.monotonic() - t0
    logger.warning("elastic restore: resharded %s onto the live topology in %.2fs (%s)",
                   directory, dt, reason)
    if metrics is not None:
        metrics.set_gauge("resilience/reshard_s", float(dt))
        metrics.inc("resilience/elastic_restores")
    return state


def coordinate_preemption(requested: bool,
                          beat: Optional[Callable[[bool], bool]] = None) -> bool:
    """True when any process of the world was signalled. Called at every
    step boundary, where every rank arrives in lockstep, so all ranks pick
    the same emergency-checkpoint step. ``beat`` (the trainer's cluster
    beat, whose one gather carries the flag beside the step's scalars)
    does the exchange when given; else one ``all_reduce`` of the flag, and
    nothing at all in one process."""
    if beat is not None:
        return bool(beat(bool(requested)))
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return bool(requested)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    flag = torch.tensor([int(bool(requested))], dtype=torch.int32, device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())
