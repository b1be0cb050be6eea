"""Parent against new on one card: kernel times of two checkouts, in turns.

Run from the repository root on a machine with one NVIDIA GPU, with the
other checkout unpacked somewhere (``git archive <commit> | tar -x -C
DIR``)::

    python3 -m trlx_tpu_torch.ab_kernels --parent DIR [--out build/ab_kernels.json]

Four turns, parent, new, new, parent, each a fresh process started in its
own tree, so each times that tree's kernels with that tree's own
``chip_smoke.check_loss``, ``check_attention``, ``check_flash`` and
``time_ms`` (every check also holds the kernel to its plain version). Each
turn records, in milliseconds, device time per call and ``call_ms`` (one
call, host included):

- the fused loss forward (#7) and backward (#8), f32, IW off, at (B, R) =
  (16, 40), (32, 40) and (32, 128);
- the attention kernels in bf16 at the serving shapes (prefill, decode,
  verify) and the flash forward and backward at the training shape, and the
  CUDA-core kernels at head dim 256 (prefill, decode, flash), which the
  split above 256 must leave as they were.

Prints one JSON line per turn and the card's name and power limit; writes
everything to ``--out``.
"""

import argparse
import json
import os
import subprocess
import sys

# run inside a tree: that tree's chip_smoke and kernels
_TURN = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as c
from trlx_tpu_torch.ops.kernel_utils import build_kernels

build_kernels()
out = {}
for B, R in ((16, 40), (32, 40), (32, 128)):
    r = c.check_loss(B, R, False, seed=B * R, timed=True)
    for part in ("fwd", "bwd"):
        out[f"loss_{part}_{B}x{R}"] = {k: r[part][k] for k in ("kernel_ms", "call_ms")}
serve = dict(B=8, H=12, KV=12, D=64, bs=16, HB=1)
wide = dict(B=4, H=8, KV=4, D=256, bs=16, HB=1)
for label, kind, T, S, poison, seed, geo in (
        ("paged_prefill", "paged_prefill", 64, 104, False, 1, serve),
        ("paged_decode", "paged_decode", 1, 104, True, 2, serve),
        ("paged_verify", "paged_verify", 5, 108, 4, 5, dict(serve, B=32)),
        ("paged_prefill_d256", "paged_prefill", 64, 104, True, 296, wide),
        ("paged_decode_d256", "paged_decode", 1, 104, True, 297, wide)):
    r = c.check_attention(kind, T=T, S=S, dtype=torch.bfloat16, poison=poison, seed=seed,
                          timed=True, **geo)
    out[label] = {k: r[k] for k in ("kernel_ms", "call_ms")}
for label, kw in (("flash_train", dict(B=16, T=104, S=104, H=12, KV=12, D=64, seed=21)),
                  ("flash_d256", dict(B=2, T=90, S=90, H=8, KV=4, D=256, seed=280))):
    r = c.check_flash(label, dtype=torch.bfloat16, timed=True, **kw)
    for part in ("fwd", "bwd"):
        out[f"{label}_{part}"] = {k: r[part][k] for k in ("kernel_ms", "call_ms")}
print("AB " + json.dumps(out), flush=True)
'''


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the other checkout's root")
    ap.add_argument("--out", default="build/ab_kernels.json")
    args = ap.parse_args(argv)
    trees = {"parent": os.path.abspath(args.parent), "new": os.getcwd()}
    turns = []
    for turn, tree in enumerate(("parent", "new", "new", "parent")):
        proc = subprocess.run([sys.executable, "-c", _TURN], cwd=trees[tree],
                              capture_output=True, text=True)
        line = [x for x in proc.stdout.splitlines() if x.startswith("AB ")]
        if proc.returncode or not line:
            print(f"{tree} turn failed (rc {proc.returncode}):\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        turns.append({"turn": turn, "tree": tree, **json.loads(line[0][3:])})
        print(json.dumps(turns[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"nvidia_smi": smi, "turns": turns}, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
