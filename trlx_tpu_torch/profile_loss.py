"""Where the fused loss forward kernel (#7) spends its time, phase by phase.

Builds a copy of ``csrc/fused_loss_fwd.cu`` with ``clock64()`` stamps from
thread 0 at the kernel's phase boundaries (written to a ``__device__``
array and read back through an extra C entry), runs it through the
port's own wrapper at (B, R) = (16, 40), (32, 40) and (32, 128), with and
without the sketches, and prints one JSON line per run: the SM cycles from
entry to each stamp, the per-phase cycles, and the device time per call
(``chip_smoke.time_ms``). A last line times an empty one-block launch (the
floor). Run from the repository root on a machine with one GPU::

    python3 -m trlx_tpu_torch.profile_loss

The stamped copy goes to the build directory; the kernel the port runs is
untouched. Without a CUDA device the script exits non-zero.
"""

import ctypes
import subprocess
import sys

import torch

from trlx_tpu_torch.ops import fused_loss as fl
from trlx_tpu_torch.ops import kernel_utils as ku

# (stamp, anchor in the source, stamp before the anchor?) in kernel order
_STAMPS = (
    ("entry", "  const int Lc = max(0, min(C, R - t0));  // its columns in range\n", False),
    ("loaded", "  // 1. GAE by rows, then the first moments and the extrema\n", True),
    ("gae_moments", "  binary = __all_sync(FULL, binary);\n", True),
    ("reduce1_barrier", "  block_totals<8, false>(s1, red1, nw);\n", True),
    ("means", "  // 2. centred second moments\n", True),
    ("second_moments", "  warp_totals<4, false>(s2, red2);\n", True),
    ("reduce2", "  // 3. losses, stats and sketches\n", True),
    ("stats_sketches", "  warp_totals<16, false>(s3, red3);\n", True),
    ("reduce3_barrier", "  const int wx = nw > 1 ? 1 : 0;\n", True),
    ("final_folds", "    if ((lane & 1) == 0 && (lane >> 1) < N_SUM3) fin[lane >> 1] = y;\n", False),
    ("written", "      out[V_ERROR] = fin[VERR] * inv_n;\n", False),
)
_EXTRA = r'''
extern "C" int read_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamp, sizeof(long long) * 16);
}
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 256, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
'''


def stamped_source() -> str:
    """``fused_loss_fwd.cu`` with the stamps of :data:`_STAMPS`."""
    src = (ku.CSRC_DIR / "fused_loss_fwd.cu").read_text()
    head = '#include "fused_loss_common.cuh"\n'
    src = src.replace(head, head + "__device__ long long g_stamp[16];\n"
                      "#define STAMP(i) if (threadIdx.x == 0) g_stamp[i] = clock64();\n")
    for i, (_, anchor, before) in enumerate(_STAMPS):
        if src.count(anchor) != 1:
            raise RuntimeError(f"stamp anchor not found once: {anchor!r}")
        stamp = f"  STAMP({i})\n"
        src = src.replace(anchor, stamp + anchor if before else anchor + stamp)
    return src + _EXTRA


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_loss: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ku.CSRC_DIR.parent.parent))
    import chip_smoke as c

    ku.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = ku.BUILD_DIR / "fused_loss_fwd_stamped.cu"
    cu.write_text(stamped_source())
    lib_path = ku.BUILD_DIR / "libfused_loss_fwd_stamped.so"
    subprocess.run([ku._nvcc(), *ku._NVCC_FLAGS, f"-I{ku.CSRC_DIR}", "-o", str(lib_path),
                    str(cu)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    ku._libs["fused_loss_fwd"] = lib  # the wrapper launches the stamped copy
    ku._fns.pop("fused_loss_fwd", None)
    lib.read_stamps.argtypes = [ctypes.c_void_p]
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    names = [s[0] for s in _STAMPS]
    for B, R in ((16, 40), (32, 40), (32, 128)):
        ops = c.loss_operands(B, R, B * R, dev)[:6]
        for sketches in (True, False):
            p = fl.LossParams(1.0, 0.95, 0.2, 0.2, 1.0, "off", 1.05, sketches)
            fl.fused_loss_fwd(p, ops)
            torch.cuda.synchronize()
            st = (ctypes.c_longlong * 16)()
            ku.check_launch("read_stamps", lib.read_stamps(st))
            at = [st[i] - st[0] for i in range(len(names))]
            ms, call_ms = c.time_ms(lambda: fl.fused_loss_fwd(p, ops))
            c.emit({"B": B, "R": R, "sketches": sketches, "ms": ms, "call_ms": call_ms,
                    "cycles_at": dict(zip(names, at)),
                    "phase_cycles": {names[i]: at[i] - at[i - 1] for i in range(1, len(at))}})
    stream = ku.current_stream_ptr(dev)
    ms, call_ms = c.time_ms(lambda: lib.empty_launch(stream))
    c.emit({"empty_launch_ms": ms, "call_ms": call_ms})
    return 0


if __name__ == "__main__":
    sys.exit(main())
