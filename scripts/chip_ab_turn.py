"""One turn of a parent-against-change A/B of ``chip_smoke.py``'s phases.

Run from the root of either checkout (the parent's or the change's), on a
machine with one NVIDIA GPU::

    python3 <this checkout>/scripts/chip_ab_turn.py [with-new-phase]

It imports that tree's ``chip_smoke`` and clocks, on the host, its
``phase_build`` and then the phases whose depth was cut to pay for
``slice_parallel_rl`` (``slice_serial_parity``, ``slice_grpo``,
``slice_grpo_cb``, ``slice_grpo_parity``, ``slice_grpo_spec``), each
keeping its own checks; ``with-new-phase`` adds ``slice_parallel_rl``.
Prints one ``AB {json}`` line of seconds. Run the parent's turn and the
change's in one call, on one host.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())  # the tree run from, not this script's
import chip_smoke as c  # noqa: E402

smi = c.phase_device()
out = {}


def timed(name, fn, *a, **kw):
    t0 = time.perf_counter()
    result = fn(*a, **kw)
    out[name] = time.perf_counter() - t0
    return result


timed("build", c.phase_build)
timed("slice_serial_parity", c.phase_slice_serial_parity, card=smi)
_, run = timed("slice_grpo", c.phase_slice_grpo, card=smi, keep=True)
timed("slice_grpo_cb", c.phase_slice_grpo, continuous=True, card=smi)
timed("slice_grpo_parity", c.phase_slice_grpo_parity, run, card=smi)
del run
timed("slice_grpo_spec", c.phase_slice_grpo, continuous=True, card=smi,
      total_steps=c.GRPO_SPEC_STEPS, checkpoint_interval=10 ** 6, speculative=c.SPEC_GAMMA)
if sys.argv[1:] == ["with-new-phase"]:
    timed("slice_parallel_rl", c.phase_slice_parallel_rl, card=smi)
out["total"] = sum(out.values())
print("AB " + json.dumps(out), flush=True)
