"""Build the kernels and run ``chip_smoke.py``'s ``slice_tensor_parallel``
phase alone on one card, printing the card's name and power limit, the
build's and the phase's seconds and rank 0's launches.

Run from the root of the repository on a machine with one CUDA card:

    python3 scripts/chip_tp_phase.py

Each phase prints its JSON record as ``chip_smoke.py`` does; the script
exits with the phase's exception when a check fails.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402


def main() -> int:
    smi = c.phase_device()
    print(smi, flush=True)
    t = time.perf_counter()
    c.phase_build()
    print("AB build_s", time.perf_counter() - t, flush=True)
    t = time.perf_counter()
    launches = c.phase_slice_tensor_parallel(card=smi)
    print("AB tensor_parallel_s", time.perf_counter() - t, json.dumps(launches), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
