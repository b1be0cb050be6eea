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
- **FLOP tallies** for the train step's MFU
  (``observability/metrics.py::train_step_flops``): every wrapper notes its
  kernel's FLOP formula (:func:`note_kernel_flops`) beside its launch
  counter, into each open :func:`counting_kernel_flops` tally, and runs its
  plain version on CPU tensors inside :func:`plain_version`, which hides
  the plain version's aten ops from ``FlopCounterMode`` while a tally is
  open, so no call counts twice.

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
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Union

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
    "launch_lock",
    "check_cuda_operand",
    "check_head_dim",
    "current_stream_ptr",
    "clamp_block_table",
    "pad_bias_to",
    "KernelFlops",
    "counting_kernel_flops",
    "note_kernel_flops",
    "plain_version",
    "attention_flops",
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
_fns: Dict[str, tuple] = {}  # name → (library, its C entry with argtypes set); guarded-by: _lock
# every wrapper's ``launches += 1`` runs under this lock: async actor threads
# launch beside the learner, and an unlocked read-add-store can lose a count
launch_lock = threading.Lock()


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
    signature set (pointers and the stream as ``c_void_p``), kept per
    loaded library so that a call sets it once."""
    lib = _libs.get(name) or load_kernel(name)
    hit = _fns.get(name)
    if hit is not None and hit[0] is lib:
        return hit[1]
    with _lock:  # set once, never while another thread calls the entry
        hit = _fns.get(name)
        if hit is not None and hit[0] is lib:
            return hit[1]
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = (lib, fn)
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


# The attention kernels take any head dim D >= 1, as the JAX kernels do. The
# tensor-core kernels are compiled for padded head dims 16, 32, 64 and 128
# and take any D up to 128 padded inside their loads; bf16 above 128 runs
# the CUDA-core kernels, f32 always does; decode runs on CUDA cores with a
# padded 256 besides. Above 256 the CUDA-core kernels split the head dim
# into 256-column output chunks (a grid dimension), streaming q.k over
# every chunk. Each C entry picks its instantiation by D (and by the
# operands' 16-byte alignment) before the launch.
def check_head_dim(what: str, D: int) -> None:
    """Raise unless ``D >= 1``."""
    if D < 1:
        raise ValueError(f"{what} takes head dim D >= 1, not D={D}")


def current_stream_ptr(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of ``device``'s current stream (as
    ``torch.cuda.current_stream(device).cuda_stream``, without building a
    ``Stream`` object on every launch)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


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


# ---------------------------------------------------------------------------
# FLOP tallies (the train step's MFU)
# ---------------------------------------------------------------------------


class KernelFlops:
    """FLOPs the kernel wrappers noted while one tally was open, by kernel."""

    def __init__(self):
        self.by_kernel: Dict[str, float] = {}

    @property
    def total(self) -> float:
        return float(sum(self.by_kernel.values()))


_flop_lock = threading.Lock()
# the open tallies; process-wide, as a CUDA backward runs the wrappers on
# autograd's device thread (so a serving thread's launches during a counted
# train step count too)
_flop_tallies: List[KernelFlops] = []  # guarded-by: _flop_lock


@contextmanager
def counting_kernel_flops() -> Iterator[KernelFlops]:
    """Open a tally of every wrapper's FLOP formula until exit."""
    tally = KernelFlops()
    with _flop_lock:
        _flop_tallies.append(tally)
    try:
        yield tally
    finally:
        with _flop_lock:
            _flop_tallies.remove(tally)


def note_kernel_flops(name: str, flops: float) -> None:
    """Add one call's FLOP formula to every open tally (a wrapper calls it
    on the kernel's and on the plain version's path alike)."""
    with _flop_lock:
        for tally in _flop_tallies:
            tally.by_kernel[name] = tally.by_kernel.get(name, 0.0) + float(flops)


@contextmanager
def plain_version() -> Iterator[None]:
    """Run a wrapper's plain version. While a tally is open its aten ops run
    outside the torch dispatch modes (``FlopCounterMode``), as the kernel's
    launch is invisible to them: the call counts once, by its formula."""
    with _flop_lock:
        counting = bool(_flop_tallies)
    if not counting:
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield


def attention_flops(B: int, T: int, S: int, H: int, D: int, backward: bool = False) -> float:
    """Matmul FLOPs of attention over a dense ``T × S`` score block, as
    ``FlopCounterMode`` counts ``scaled_dot_product_attention``: forward
    q·k and p·v (``4 B H T S D``), backward the recomputed scores and four
    gradient products (``10 B H T S D``). Masked columns are counted."""
    return (10.0 if backward else 4.0) * B * H * T * S * D
