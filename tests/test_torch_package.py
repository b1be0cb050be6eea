"""Hygiene of the PyTorch/CUDA port (``trlx_tpu_torch``): it imports neither
JAX nor the JAX package, its entry points default to the GPU and raise
without one unless the caller asks for the CPU, every CUDA source has a
wrapper with a launch counter and a plain version beside it, and
``chip_smoke.py`` fails without a card or without the repository."""

import ast
import importlib
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from trlx_tpu_torch.ops import kernel_utils
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "trlx_tpu_torch"
_FORBIDDEN = ("jax", "flax", "trlx_tpu", "jaxlib", "optax")


def _modules():
    return sorted(PKG.rglob("*.py"))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", [*_modules(), REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_imports(path):
    bad = sorted({r for r in _imported_roots(path) if r in _FORBIDDEN})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


# One interpreter (one torch import) runs the three subprocess checks, JAX
# and the JAX package blocked throughout: chip_smoke.py copied alone into
# an empty directory, with a card faked present so that only the missing
# repository can stop it; chip_smoke.py in the repository with no card;
# then the import of every module of the port.
_SUBPROCESS_CHECKS = """
import sys
for name in ('jax', 'jaxlib', 'flax', 'trlx_tpu'):
    sys.modules[name] = None
import contextlib, importlib, io, json, runpy
import torch

def run_script(path, fake_card):
    out, real = io.StringIO(), torch.cuda.is_available
    if fake_card:
        torch.cuda.is_available = lambda: True
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(path, run_name='__main__')
        code = 0
    except SystemExit as e:
        code = e.code
    except Exception as e:
        code = type(e).__name__
    finally:
        torch.cuda.is_available = real
    return {'code': code, 'stdout': out.getvalue()}

res = {'alone': run_script(sys.argv[1], True), 'repo': run_script(sys.argv[2], False)}
for m in json.loads(sys.argv[3]):
    importlib.import_module(m)
res['imports'] = 'ok'
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def subprocess_checks(tmp_path_factory):
    alone = tmp_path_factory.mktemp("alone") / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    mods = [
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(".__init__", "")
        for p in _modules()
    ]
    out = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS_CHECKS, str(alone), str(REPO / "chip_smoke.py"),
         json.dumps(mods)],
        cwd=alone.parent, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ""},
    )
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_imports_with_jax_unavailable(subprocess_checks):
    assert subprocess_checks["imports"] == "ok"


def test_entry_points_default_to_cuda():
    from trlx_tpu_torch.models.builder import build_causal_lm
    from trlx_tpu_torch.models.transformer import TransformerConfig
    from trlx_tpu_torch.ops.paged_kv import PagedSpec
    from trlx_tpu_torch.ops.sampling import GenerationConfig
    from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns

    cfg = TransformerConfig.gpt2("test")
    if torch.cuda.is_available():
        assert kernel_utils.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_causal_lm("builtin:gpt2-test")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_slot_refill_fns(cfg, 2, 4, GenerationConfig(), paged=PagedSpec(4, 8))
    with pytest.raises(RuntimeError):
        kernel_utils.resolve_device("cuda:0")
    model, _ = build_causal_lm("builtin:gpt2-test", device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert kernel_utils.resolve_device("cpu").type == "cpu"


def test_every_cuda_source_has_wrapper_counter_and_plain_version():
    sources = sorted(p.stem for p in (PKG / "csrc").glob("*.cu"))
    assert sources == sorted(kernel_utils.KERNELS)
    assert {"paged_decode", "paged_prefill", "fused_sample", "flash_fwd", "flash_bwd",
            "fused_loss_fwd", "fused_loss_bwd"} == set(sources)
    for stem in sources:
        text = (PKG / "csrc" / f"{stem}.cu").read_text()
        # the source note: what it replaces, what bounds it, the design
        assert "Replaces: trlx_tpu/ops/" in text and "bounds it on an H100" in text
        assert f'extern "C" int {stem}(' in text
        mod_name, wrapper_name, plain_name = kernel_utils.KERNELS[stem]
        mod = importlib.import_module(mod_name)
        wrapper, plain = getattr(mod, wrapper_name), getattr(mod, plain_name)
        assert isinstance(wrapper.launches, int)
        assert callable(plain)
        src = inspect.getsource(wrapper)
        # counted where the kernel launches, and the plain version only for CPU tensors
        assert src.count(f"{wrapper_name}.launches += 1") == 1
        # actor threads launch beside the learner: no count may be lost
        assert f"with launch_lock:  # actor threads launch beside the learner\n        {wrapper_name}.launches += 1" in src
        assert f'kernel_fn("{stem}"' in src
        assert 'device.type == "cpu"' in src and plain_name in src


_KERNEL_DEF = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")


@pytest.mark.parametrize("stem", sorted(kernel_utils.KERNELS))
def test_profilers_count_every_device_kernel_as_the_ports(stem):
    # profile_serve.py and profile_train.py group device time by kernel name:
    # every __global__ function of the port's sources must land in the
    # port's group of one of them, or its time would be filed as "other"
    from trlx_tpu_torch import profile_serve, profile_train

    names = _KERNEL_DEF.findall((PKG / "csrc" / f"{stem}.cu").read_text())
    assert names
    for name in names:
        mangled = f"void (anonymous namespace)::{name}<float>(float const*)"
        assert "port_kernels" in (profile_serve._group(mangled), profile_train._group(mangled)), name


def test_trainer_and_train_default_to_cuda(tmp_path):
    from trlx_tpu_torch.data.default_configs import default_ppo_config
    from trlx_tpu_torch.trainer.ppo import PPOTrainer
    from trlx_tpu_torch.trlx import train

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    config = default_ppo_config().evolve(
        model=dict(model_path="builtin:gpt2-test"),
        train=dict(continuous_batching=True, checkpoint_dir=str(tmp_path)),
        engine=dict(backend="paged", decode_kernel="pallas", prefill_kernel="pallas"),
        method=dict(loss_kernel="pallas"),
    )
    reward = lambda samples, prompts, outputs: [0.0] * len(samples)  # noqa: E731
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PPOTrainer(config=config, reward_fn=reward)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(reward_fn=reward, prompts=["a"], config=config)
    assert PPOTrainer(config=config, reward_fn=reward, device="cpu").device.type == "cpu"


def test_wrappers_raise_on_other_devices():
    from trlx_tpu_torch.ops.paged_attention import fused_sample, paged_attention_decode

    meta = torch.device("meta")
    q = torch.empty(2, 4, 8, device=meta)
    pool = torch.empty(5, 4, 4, 8, device=meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_attention_decode(q, pool, pool, torch.zeros(2, 2, dtype=torch.int32, device=meta),
                               torch.empty(2, 1, 8, device=meta))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_sample(torch.empty(2, 9, device=meta), None, temperature=1.0, top_k=0, top_p=1.0)


def test_kernel_build_needs_nvcc(monkeypatch):
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc present: the build itself is exercised by chip_smoke.py")
    monkeypatch.setattr(kernel_utils, "BUILD_DIR", Path("/nonexistent-build-dir"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel_utils.build_kernels(["paged_decode"])


def test_chip_smoke_fails_without_card_or_repo(subprocess_checks):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    for case in ("alone", "repo"):
        res = subprocess_checks[case]
        assert res["code"] not in (0, None), (case, res)
        assert '"ok": true' not in res["stdout"], (case, res)
    # alone, with a card faked present, only the missing repository stops it
    assert subprocess_checks["alone"]["code"] == "ModuleNotFoundError"
