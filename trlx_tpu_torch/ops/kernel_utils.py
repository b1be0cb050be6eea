"""Shared plumbing for the port's hand-written CUDA kernels.

Counterpart of ``trlx_tpu/ops/pallas_utils.py``. Three things live here:

- **Device resolution**: every entry point of the port runs on the card
  unless the caller asks for the CPU. :func:`resolve_device` turns
  ``None`` into ``cuda`` and raises when CUDA is absent — there is no
  silent CPU path.
- **Kernel build and load**: each ``csrc/<name>.cu`` is compiled by
  ``nvcc`` into a shared library with a plain C interface at first use
  (``build/trlx_tpu_torch/`` under the checkout) and loaded with
  ``ctypes``. Pointers and the current stream pass as ``c_void_p``; every C
  entry returns ``cudaGetLastError()`` and :func:`check_launch` raises when
  it is not 0. Nothing is built when a module is imported.
- **Paged-table helpers** shared by the paged kernels' plain versions:
  :func:`clamp_block_table` and :func:`pad_bias_to`.

Shared device code lives in ``csrc/*.cuh`` headers, included by the
sources that need it; a library's name hashes its source and the headers,
so editing a header rebuilds every kernel.

Masking convention shared with the JAX package: masked key columns carry
an additive ``-1e9`` bias, so ``exp(masked - max)`` underflows to exactly
``0.0`` and stale values in recycled pool blocks contribute nothing.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Optional, Union

import torch

__all__ = [
    "CSRC_DIR",
    "BUILD_DIR",
    "KERNELS",
    "resolve_device",
    "build_kernels",
    "load_kernel",
    "kernel_fn",
    "check_launch",
    "check_cuda_operand",
    "HEAD_DIMS",
    "check_head_dim",
    "current_stream_ptr",
    "clamp_block_table",
    "pad_bias_to",
]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "trlx_tpu_torch"

# kernel source stem → (wrapper module, wrapper function, plain version).
# Every csrc/*.cu has exactly one entry (tests/test_torch_package.py).
KERNELS: Dict[str, tuple] = {
    "paged_decode": (
        "trlx_tpu_torch.ops.paged_attention",
        "paged_attention_decode",
        "paged_attention_decode_reference",
    ),
    "paged_prefill": (
        "trlx_tpu_torch.ops.paged_prefill",
        "paged_prefill_attention",
        "paged_prefill_attention_reference",
    ),
    "fused_sample": (
        "trlx_tpu_torch.ops.paged_attention",
        "fused_sample",
        "fused_sample_reference",
    ),
    "flash_fwd": (
        "trlx_tpu_torch.ops.flash_attention",
        "flash_fwd",
        "flash_fwd_reference",
    ),
    "flash_bwd": (
        "trlx_tpu_torch.ops.flash_attention",
        "flash_bwd",
        "flash_bwd_reference",
    ),
    "fused_loss_fwd": (
        "trlx_tpu_torch.ops.fused_loss",
        "fused_loss_fwd",
        "fused_loss_fwd_reference",
    ),
    "fused_loss_bwd": (
        "trlx_tpu_torch.ops.fused_loss",
        "fused_loss_bwd",
        "fused_loss_bwd_reference",
    ),
}

_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # guarded-by: _lock


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """``None`` means the card. A CUDA device without a usable card raises;
    the CPU is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "passes device='cpu'"
        )
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by the hash of the source
    and of every shared header beside it (``csrc/*.cuh``)."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _compile(name: str) -> Path:
    out = _lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def build_kernels(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (default: all), one ``nvcc`` per source,
    all started together. Returns the library paths."""
    names = list(names or KERNELS)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        paths = list(pool.map(_compile, names))
    return dict(zip(names, paths))


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name)))
            _libs[name] = lib
        return lib


def kernel_fn(name: str, argtypes: list):
    """The C entry ``name`` of ``csrc/<name>.cu`` with its ctypes
    signature set (pointers and the stream as ``c_void_p``)."""
    fn = getattr(load_kernel(name), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, rc: int) -> None:
    """Raise on a refused or faulted launch (the C entry's
    ``cudaGetLastError()``)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def check_cuda_operand(
    t: torch.Tensor, name: str, device: torch.device, dtypes: tuple
) -> None:
    """Raise unless ``t`` is a contiguous tensor of one of ``dtypes`` on
    ``device`` — the operands a kernel takes as raw pointers."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


HEAD_DIMS = (16, 32, 64, 128)


def check_head_dim(what: str, D: int, *tensors: torch.Tensor) -> None:
    """Raise unless ``D`` is one of :data:`HEAD_DIMS` (the head dims the
    kernels that copy rows 16 bytes at a time are templated on) and every
    tensor starts on a 16-byte boundary."""
    if D not in HEAD_DIMS:
        raise ValueError(f"{what} takes head dim D in {HEAD_DIMS}, not D={D}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what} needs 16-byte aligned operands")


def current_stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def clamp_block_table(block_table: torch.Tensor, num_blocks: int) -> torch.Tensor:
    """Block-table ids as safe fetch indices: out-of-range entries
    (poisoned rows, padding lanes) clamp to the last pool block — their
    lanes are bias-masked or their outputs dropped, so the clamped fetch
    only has to be legal."""
    return torch.clamp(block_table.to(torch.int64), max=num_blocks - 1)


def pad_bias_to(bias: torch.Tensor, width: int) -> torch.Tensor:
    """Additive bias as f32 with the key axis zero-padded to ``width``."""
    bias = bias.to(torch.float32)
    short = width - bias.shape[-1]
    if short <= 0:
        return bias
    return torch.nn.functional.pad(bias, (0, short))
