"""The port's mesh and sharding rules (``trlx_tpu_torch/parallel/mesh.py``,
``sharding.py``) and the ring's schedule helpers against the JAX package's,
and the trainers' refusals of the parallel axes this slice does not run.

- ``mesh_shape_from_config`` over a table of configs and device counts,
  errors included (the same messages);
- ``param_spec_for_path`` for every parameter of the gpt2-test, llama-test
  and mixtral-test presets, mapped through the port's layout
  (``port_param_spec``: ``[out, in]`` Linear weights, ``blocks.{i}``
  modules) on an 8-device mesh and without one;
- ``fit_spec``, ``spec_shards``, ``spec_to_jsonable``, ``batch_spec``,
  ``zigzag_order`` and ``ring_schedule_work``;
- ``reject_unported`` refuses ``model`` / ``pipe`` / ``expert`` above 1
  for every trainer and any axis above 1 for PPO, GRPO, ILQL and DPO,
  naming the slice that brings it.

Exact equality throughout.
"""

import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import jax
from trlx_tpu.data.configs import ParallelConfig as JaxParallelConfig
from trlx_tpu.data.default_configs import default_sft_config as jax_default_sft_config
from trlx_tpu.models.builder import build_causal_lm as jax_build_causal_lm
from trlx_tpu.parallel import mesh as jax_mesh
from trlx_tpu.parallel import ring_attention as jax_ring
from trlx_tpu.parallel import sharding as jax_sharding
from trlx_tpu_torch.data.configs import ParallelConfig, TRLConfig
from trlx_tpu_torch.data.default_configs import (
    default_grpo_config,
    default_ilql_config,
    default_ppo_config,
    default_sft_config,
)
from trlx_tpu_torch.models.builder import resolve_transformer_config
from trlx_tpu_torch.models.transformer import CausalTransformer
from trlx_tpu_torch.models.weights import jax_param_path
from trlx_tpu_torch.parallel import mesh, ring_attention, sharding
from trlx_tpu_torch.trainer.base import reject_unported

from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

AXES = ("data", "pipe", "fsdp", "model", "sequence", "expert")


def _jax_spec(spec: P) -> tuple:
    return tuple(spec)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axes,count", [
    ({}, 1), ({}, 4), ({"data": -1}, 8), ({"data": -1, "sequence": 2}, 8),
    ({"data": 2, "fsdp": 2, "sequence": 2}, 8), ({"fsdp": -1, "model": 2}, 8),
    ({"data": -1, "sequence": 4}, 4), ({"data": 2, "fsdp": 2}, 8),
    ({"data": -1, "fsdp": -1}, 8), ({"data": -1, "sequence": 3}, 8),
    ({"sequence": 2}, 1), ({"data": 1, "expert": 2, "pipe": 2}, 4),
])
def test_mesh_shape_from_config_matches_jax(axes, count):
    ours, theirs = ParallelConfig(**axes), JaxParallelConfig(**axes)
    try:
        want = jax_mesh.mesh_shape_from_config(theirs, count)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            mesh.mesh_shape_from_config(ours, count)
        assert str(err.value) == str(e)
        return
    assert mesh.mesh_shape_from_config(ours, count) == want
    assert mesh.MESH_AXES == jax_mesh.MESH_AXES


def test_mesh_at_world_size_one():
    """Without a process group the world is one process: the default
    device count is 1, the global mesh starts unset, and the local mesh of
    a config that needs more than one device raises as JAX's does."""
    assert mesh.world_size() == 1
    assert mesh.mesh_shape_from_config(ParallelConfig()) == (1,) * 6
    assert mesh.get_global_mesh() is None and mesh.local_mesh() is None
    with pytest.raises(ValueError, match="Device count 1 not divisible by fixed axes product 2"):
        mesh.local_mesh(ParallelConfig(sequence=2))
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        mesh.local_mesh(ParallelConfig(data=1, sequence=2))


def test_mesh_descriptor_matches_jax():
    """JAX's fields, but a process of the port drives one device, so its
    process count is the device count (JAX's virtual mesh is one process)."""
    class _Mesh:  # the attributes mesh_descriptor reads off a DeviceMesh
        mesh_dim_names = AXES
        mesh = torch.arange(8).reshape(2, 1, 2, 1, 2, 1)
        device_type = "cpu"

    want = jax_mesh.mesh_descriptor(_jax_mesh((2, 1, 2, 1, 2, 1)))
    got = mesh.mesh_descriptor(_Mesh())
    assert got.pop("process_count") == got["device_count"] == 8
    assert want.pop("process_count") == 1
    assert got == want


# ---------------------------------------------------------------------------
# the sharding rules
# ---------------------------------------------------------------------------


def _jax_mesh(shape):
    devices = np.asarray(jax.devices()[: int(np.prod(shape))]).reshape(shape)
    return Mesh(devices, AXES)


MESH_SHAPES = [(1, 1, 2, 2, 1, 2), (2, 1, 4, 1, 1, 1), (1, 1, 8, 1, 1, 1)]


def _flat_jax_params(spec):
    config = jax_default_sft_config().evolve(model=dict(model_path=spec))
    _, params, _ = jax_build_causal_lm(config.model, config.parallel, abstract=True)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax_sharding._path_str(kp): tuple(leaf.shape) for kp, leaf in flat}


@pytest.mark.parametrize("spec", ["builtin:gpt2-test", "builtin:llama-test",
                                  "builtin:mixtral-test"])
def test_param_specs_match_jax_through_the_port_layout(spec):
    """Every parameter of the port maps onto a JAX path of the same
    preset's tree, with the transposed shape for a Linear weight, and its
    spec (with and without a mesh) is JAX's spec of that path, transposed
    back."""
    jax_params = _flat_jax_params(spec)
    with torch.device("meta"):
        model = CausalTransformer(resolve_transformer_config(spec))
    seen = set()
    for name, param in model.named_parameters():
        path, transposed = jax_param_path(name, wrapped=False)
        path = "/".join(path)
        shape = tuple(param.shape)
        jax_shape = shape[::-1] if transposed else shape
        assert jax_params[path] == jax_shape, name
        seen.add(path)
        for shape_of_mesh in [None] + MESH_SHAPES:
            jm = None if shape_of_mesh is None else _jax_mesh(shape_of_mesh)
            ours = None if shape_of_mesh is None else dict(zip(AXES, shape_of_mesh))
            want = _jax_spec(jax_sharding.param_spec_for_path(path, jax_shape, jm))
            got = sharding.port_param_spec(name, shape, False, ours)
            assert got == (want[::-1] if transposed else want), (name, shape_of_mesh)
            assert sharding.param_spec_for_path(path, jax_shape, ours) == want
    assert seen == set(jax_params)


def test_wrapped_policy_paths_match_jax():
    """A value-head policy's keys map under ``backbone`` and ``v_head``, as
    JAX's tree nests them, so the embedding rule applies (the bare tree's
    root ``wte/embedding`` matches no rule in JAX either)."""
    jm, ours = _jax_mesh((1, 1, 2, 2, 1, 2)), dict(zip(AXES, (1, 1, 2, 2, 1, 2)))
    for name, shape in (("backbone.wte.weight", (256, 64)),
                        ("v_head.in_proj.weight", (128, 64)),
                        ("v_head.out_proj.weight", (1, 128)),
                        ("backbone.blocks.0.attn.o_proj.bias", (64,))):
        path, transposed = jax_param_path(name, wrapped=True)
        jshape = shape[::-1] if transposed else shape
        want = _jax_spec(jax_sharding.param_spec_for_path("/".join(path), jshape, jm))
        assert sharding.port_param_spec(name, shape, True, ours) == (
            want[::-1] if transposed else want)


@pytest.mark.parametrize("shape_of_mesh", MESH_SHAPES)
@pytest.mark.parametrize("shape,spec", [
    ((8, 6), ("fsdp", "model")), ((50257, 64), (("model", "fsdp"), None)),
    ((6, 16), (("fsdp", "model"),)), ((1, 4, 16), ("data", None, "sequence")),
    ((4, 12, 3), ("expert", "fsdp", "model")), ((16,), (("data", "fsdp"),)),
    ((3,), (None,)), ((8, 8), ()),
])
def test_fit_spec_and_shards_match_jax(shape_of_mesh, shape, spec):
    jm, ours = _jax_mesh(shape_of_mesh), dict(zip(AXES, shape_of_mesh))
    want = jax_sharding.fit_spec(jm, shape, P(*spec))
    got = sharding.fit_spec(ours, shape, spec)
    assert got == _jax_spec(want)
    assert sharding.spec_shards(ours, got) == jax_sharding.spec_shards(jm, want)
    assert sharding.spec_to_jsonable(got) == jax_sharding.spec_to_jsonable(want)


def test_fit_spec_rejects_a_longer_spec():
    with pytest.raises(ValueError, match="more entries than array rank"):
        sharding.fit_spec({"fsdp": 2}, (4,), ("fsdp", None))


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("sequence_sharded", [False, True])
def test_batch_spec_matches_jax(ndim, sequence_sharded):
    assert sharding.batch_spec(ndim, sequence_sharded) == _jax_spec(
        jax_sharding.batch_spec(ndim, sequence_sharded))


def test_shard_batch_cuts_rows_and_zigzag_shards(monkeypatch):
    """Each rank of a (data 2, fsdp 2, sequence 2) mesh gets its rows of
    every micro-batch and its zigzag half-chunks; the parts tile the
    batch exactly once."""
    class _Mesh:
        mesh_dim_names = AXES
        mesh = torch.arange(8).reshape(2, 1, 2, 1, 2, 1)

    T, rows = 16, 8
    x = np.arange(rows * T).reshape(rows, T)
    seen = []
    for rank in range(8):
        monkeypatch.setattr("torch.distributed.get_rank", lambda rank=rank: rank)
        part = sharding.shard_batch({"x": x, "s": "kept"}, _Mesh(), sequence_sharded=True,
                                    micro=2)
        assert part["s"] == "kept" and part["x"].shape == (2, T // 2)
        d, f, s = np.argwhere(_Mesh.mesh.numpy()[:, 0, :, 0, :, 0] == rank)[0]
        cols = ring_attention.zigzag_order(T, 2).reshape(2, -1)[s]
        want_rows = [m * 4 + d * 2 + f for m in range(2)]
        np.testing.assert_array_equal(part["x"], x[want_rows][:, cols])
        seen.extend(part["x"].ravel().tolist())
    assert sorted(seen) == list(range(rows * T))


# ---------------------------------------------------------------------------
# the ring's schedule helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,n", [(8, 2), (16, 4), (64, 2), (96, 3), (128, 8)])
def test_zigzag_order_matches_jax(T, n):
    np.testing.assert_array_equal(ring_attention.zigzag_order(T, n),
                                  jax_ring.zigzag_order(T, n))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("placement", ["zigzag", "contiguous"])
def test_ring_schedule_work_matches_jax(n, placement):
    assert ring_attention.ring_schedule_work(n, placement) == \
        jax_ring.ring_schedule_work(n, placement)


# ---------------------------------------------------------------------------
# the trainers' refusals
# ---------------------------------------------------------------------------

PRESETS = {"ppo": default_ppo_config, "grpo": default_grpo_config,
           "ilql": default_ilql_config, "sft": default_sft_config}


def _dpo_config():
    from trlx_tpu_torch.data.default_configs import default_dpo_config

    return default_dpo_config()


PRESETS["dpo"] = _dpo_config
# (collects_rollouts, seq2seq_ok, sequence_ok) as each trainer passes them
TRAINER_FLAGS = {"ppo": (True, True, False), "grpo": (True, False, False),
                 "ilql": (False, True, False), "dpo": (False, False, False),
                 "sft": (False, False, True)}


def _with_parallel(name, **axes) -> TRLConfig:
    config = PRESETS[name]()
    return config.evolve(parallel=axes)


@pytest.mark.parametrize("trainer", sorted(PRESETS))
@pytest.mark.parametrize("axis", ["model", "pipe", "expert"])
def test_unported_axes_refused_for_every_trainer(trainer, axis):
    with pytest.raises(ValueError, match=rf"parallel\.{axis} > 1: .*slice 22"):
        reject_unported(_with_parallel(trainer, **{axis: 2}), *TRAINER_FLAGS[trainer])


@pytest.mark.parametrize("trainer", ["ppo", "grpo", "ilql", "dpo"])
@pytest.mark.parametrize("axis", ["data", "fsdp", "sequence"])
def test_parallel_axes_refused_outside_sft(trainer, axis):
    """Outside SFT only ``sequence`` is refused (slice 22 rings the RL and
    preference trainers' forwards); ``data`` and ``fsdp`` run, so at world
    size 1 an axis of 2 fails only to fit the world (an inferred ``data``
    axis leaves no device for it), and the error names it."""
    match = (r"parallel\.sequence > 1: .*slice 22" if axis == "sequence"
             else rf"parallel\.{axis}: .*(needs 2 devices, have 1|Device count 1 not divisible)")
    with pytest.raises(ValueError, match=match):
        reject_unported(_with_parallel(trainer, **{axis: 2}), *TRAINER_FLAGS[trainer])


def test_sft_takes_the_axes_the_world_fits():
    """SFT takes data / fsdp / sequence; at world size 1 an axis above 1
    does not fit the world and the error names it."""
    reject_unported(_with_parallel("sft", data=-1, sequence=1), *TRAINER_FLAGS["sft"])
    with pytest.raises(ValueError, match=r"parallel\.sequence: Device count 1 not divisible"):
        reject_unported(_with_parallel("sft", sequence=2), *TRAINER_FLAGS["sft"])
    with pytest.raises(ValueError, match=r"parallel\.fsdp: .*needs 2 devices, have 1"):
        reject_unported(_with_parallel("sft", data=1, fsdp=2), *TRAINER_FLAGS["sft"])
    with pytest.raises(ValueError, match=r"parallel\.dcn_data_parallelism: data axis 1 not "
                       r"divisible by dcn_data_parallelism 2"):
        reject_unported(_with_parallel("sft", dcn_data_parallelism=2), *TRAINER_FLAGS["sft"])


def test_initialize_runtime_at_one_process(monkeypatch):
    """One process (no world variables, or a world of 1) starts no group
    and keeps the caller's device, so the one-device path is unchanged."""
    import torch.distributed as dist

    from trlx_tpu_torch.trlx import initialize_runtime

    for name in ("TRLX_TPU_COORDINATOR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_runtime("cpu") == "cpu" and initialize_runtime(None) is None
    monkeypatch.setenv("TRLX_TPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("TRLX_TPU_NUM_PROCESSES", "1")
    assert initialize_runtime("cpu") == "cpu"
    assert not dist.is_initialized()


def test_initialize_runtime_picks_the_local_card(monkeypatch):
    """Several processes on the GPU: each drives ``cuda:LOCAL_RANK``, or,
    with only JAX's variables, its process id modulo the host's card count
    (rank 11 of 16 on 8-card hosts drives ``cuda:3``). Without a card and
    without ``device="cpu"`` it raises rather than pick a device."""
    import torch.distributed as dist

    from trlx_tpu_torch.trlx import initialize_runtime

    joined = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: joined.append((backend, kw["device_id"])))
    monkeypatch.setattr(torch.cuda, "set_device", lambda device: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TRLX_TPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("TRLX_TPU_NUM_PROCESSES", "16")
    monkeypatch.setenv("TRLX_TPU_PROCESS_ID", "11")
    assert initialize_runtime(None) == torch.device("cuda", 3)
    monkeypatch.setenv("LOCAL_RANK", "5")
    assert initialize_runtime(None) == torch.device("cuda", 5)
    assert joined == [("nccl", torch.device("cuda", 3)), ("nccl", torch.device("cuda", 5))]
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_runtime(None)


def _tiny_lm(preset, attention_impl):
    cfg = resolve_transformer_config(preset, num_layers=1, param_dtype=torch.float32,
                                     attention_impl=attention_impl)
    torch.manual_seed(0)
    return CausalTransformer(cfg).eval()


@pytest.mark.parametrize("attention_impl", ["auto", "xla"])
def test_sequence_shard_refuses_the_bias_path(attention_impl):
    """A sequence-sharded forward on the CPU's bias path would attend
    within its shard alone: it raises, as does a cached one."""
    lm = _tiny_lm("builtin:llama-test", attention_impl)
    ids = torch.arange(8)[None] % 50
    with pytest.raises(ValueError, match="ring attention on the flash path"):
        lm(ids, sequence_group=object())
    lm = _tiny_lm("builtin:llama-test", "pallas")
    cache = [{"k": torch.zeros(1, 8, lm.config.kv_heads, lm.config.dims_per_head),
              "v": torch.zeros(1, 8, lm.config.kv_heads, lm.config.dims_per_head)}]
    with pytest.raises(ValueError, match="ring attention on the flash path"):
        lm(ids, cache=cache, cache_index=0, sequence_group=object())
    with pytest.raises(ValueError, match="mixture-of-experts.*slice 22"):
        _tiny_lm("builtin:mixtral-test", "pallas")(ids, sequence_group=object())


def test_only_a_forward_given_the_group_takes_the_ring():
    """The global mesh steers no forward: under one, a full pass with no
    ``sequence_group`` (a reference or reward model's) is the plain flash
    pass on whole rows."""
    lm = _tiny_lm("builtin:llama-test", "pallas")
    ids = torch.arange(16).reshape(2, 8) % 50
    want = lm(ids)["logits"]
    mesh.set_global_mesh(object())
    try:
        got = lm(ids)["logits"]
    finally:
        mesh.set_global_mesh(None)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
