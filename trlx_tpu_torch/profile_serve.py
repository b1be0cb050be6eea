"""Where the serving slice's time goes on the card.

Runs the slice's engine workload (full-width GPT-2 small with seeded
random weights, 8 slots, ``kv_block_size`` 16, ``segment_len`` 8, 16
prompts of 64 tokens, up to 40 new tokens, half greedy and half sampled)
on the paged ``ContinuousEngine`` directly, without the HTTP frontend:
once untimed to warm up, once timed, then once under ``torch.profiler``.
Prints one JSON line with the wall time and ms per decode step of the
timed run, the device's busy and idle share over the profiled run (the
union of the device kernels' intervals over the wall time; also over the
untraced run's wall time, since tracing slows the host and not the
kernels), kernel launches per decode step, and device time grouped by
the port's kernels, matrix products and everything else, with the top
kernels by device time. Run from the repository root on a machine with
one GPU::

    python3 -m trlx_tpu_torch.profile_serve [--trace PATH]

``--trace`` also writes the Chrome trace of the profiled run. Without a
CUDA device the script exits non-zero: a CPU run measures nothing of the
card.
"""

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from typing import Any, Dict

import numpy as np
import torch

# substrings of the device kernel names, by group
_PORT_KERNELS = ("paged_decode_", "paged_prefill_", "fused_sample_")
# cuBLAS's kernels on Hopper are named nvjet_*
_MATMUL = ("gemm", "gemv", "cutlass", "xmma", "cublas", "splitk", "nvjet")


def _workload(device: torch.device, spec: str, slots: int = 8, block_size: int = 16,
              segment_len: int = 8, prompt_len: int = 64, max_new: int = 40,
              n_requests: int = 16):
    """The engine and the prompts of one run (same settings as the slice
    phase of ``chip_smoke.py``)."""
    from trlx_tpu_torch.engine.core import ContinuousEngine
    from trlx_tpu_torch.models.builder import build_causal_lm
    from trlx_tpu_torch.ops.paged_kv import PagedSpec, num_table_blocks
    from trlx_tpu_torch.ops.sampling import GenerationConfig
    from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns

    model, cfg = build_causal_lm(spec, seed=0, device=device)
    eos = cfg.vocab_size - 1
    gen = GenerationConfig(max_new_tokens=max_new, temperature=1.0, top_k=50,
                           top_p=0.95, do_sample=True, eos_token_id=eos,
                           pad_token_id=eos)
    S = prompt_len + max_new
    paged = PagedSpec(block_size, 1 + slots * num_table_blocks(S, block_size) + 8)
    fns = make_slot_refill_fns(cfg, slots, prompt_len, gen, segment_len=segment_len,
                               paged=paged, device=device)
    engine = ContinuousEngine(fns, model, eos)
    rs = np.random.RandomState(1234)
    prompts = rs.randint(0, cfg.vocab_size - 1, size=(n_requests, prompt_len))
    return engine, prompts


def _run(engine, prompts, sync) -> Dict[str, Any]:
    n = len(prompts)
    engine.begin_collection()
    engine.enqueue_prompts(prompts, np.ones_like(prompts), np.arange(n),
                           greedy=np.arange(n) % 2 == 0)
    sync()
    t0 = time.perf_counter()
    done = engine.run()
    sync()
    wall = time.perf_counter() - t0
    st = engine.stats
    return {"wall_s": wall, "tokens": int(sum(int(c.mask.sum()) for c in done)),
            "decode_steps": st.decode_steps, "segments": st.segments,
            "refill_prefills": st.refill_prefills, "decode_s": st.decode_s,
            "refill_s": st.refill_s}


def _rates(run: Dict[str, Any]) -> Dict[str, Any]:
    return {**run, "tokens_per_s": run["tokens"] / run["wall_s"],
            "decode_step_ms": 1e3 * run["decode_s"] / max(run["decode_steps"], 1)}


def _busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_events(prof):
    """The profiler's device kernel events, without the user annotations
    (such as ``Optimizer.step``) that the CUDA timeline also carries and
    that overlap the kernels they enclose."""
    return [evt for evt in prof.events()
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)
            and not evt.name.startswith(("Optimizer.", "ProfilerStep"))]


def _group(name: str) -> str:
    if any(k in name for k in _PORT_KERNELS):
        return "port_kernels"
    low = name.lower()
    if any(k in low for k in _MATMUL):
        return "matmul"
    return "other"


def profile_serve(device: torch.device, spec: str = "builtin:gpt2-small",
                  trace: str = "") -> Dict[str, Any]:
    from torch.profiler import ProfilerActivity, profile

    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    engine, prompts = _workload(device, spec)
    _run(engine, prompts[:8], sync)  # warm-up: kernel loading, library setup
    plain = _run(engine, prompts, sync)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        traced = _run(engine, prompts, sync)
    if trace:
        prof.export_chrome_trace(trace)

    by_name: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    intervals = []
    for evt in device_events(prof):
        dur = evt.time_range.end - evt.time_range.start
        intervals.append((evt.time_range.start, evt.time_range.end))
        by_name[evt.name][0] += 1
        by_name[evt.name][1] += dur
    busy_s = _busy_us(intervals) * 1e-6
    groups: Dict[str, float] = defaultdict(float)
    for name, (_, us) in by_name.items():
        groups[_group(name)] += us * 1e-3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    launches = sum(c for c, _ in by_name.values())
    steps = max(traced["decode_steps"], 1)
    return {
        "phase": "profile_serve", "model": spec, "requests": len(prompts),
        "untraced": _rates(plain),
        "traced": traced,
        "device_busy_s": busy_s,
        "device_busy_share": busy_s / traced["wall_s"],
        "device_idle_share": 1.0 - busy_s / traced["wall_s"],
        # tracing slows the host, not the kernels: the same device time
        # over the untraced run's wall time
        "device_busy_share_untraced": busy_s / plain["wall_s"],
        "device_launches": launches,
        "device_launches_per_decode_step": launches / steps,
        "device_ms_by_group": dict(groups),
        "top_kernels": [{"name": n[:120], "count": c, "ms": us * 1e-3}
                        for n, (c, us) in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default="", help="write the Chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    rec = profile_serve(torch.device("cuda"), trace=args.trace)
    rec["card"] = smi
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
