"""Where the training slice's time goes on the card.

Builds the PPO trainer of the training slice (``train_config``: full-width
GPT-2 small, ``num_layers_unfrozen`` 2, bf16 compute over f32 master
weights, batch 16, prompts of 64 bytes, 40 new tokens, the fused loss
kernels), collects one set of 64 rollouts, then runs optimizer steps on
the store's first batch: three untimed to warm up, ``--steps`` timed, and
``--steps`` under ``torch.profiler``. Prints one JSON line with the median
train-step ms, the rollout collection's time, the device's busy share
over the profiled steps (the union of the device kernels' intervals over
the wall time; also over the untraced steps' wall time), device launches
per step, and device time grouped by the port's kernels, matrix products,
the optimizer and everything else, with the top kernels by device time.
Run from the repository root on a machine with one GPU::

    python3 -m trlx_tpu_torch.profile_train [--steps N] [--trace PATH]

Without a CUDA device the script exits non-zero: a CPU run measures
nothing of the card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from typing import Any, Dict

import numpy as np
import torch

from trlx_tpu_torch.profile_serve import _MATMUL, _busy_us, device_events

# substrings of the device kernel names, by group
_PORT_KERNELS = ("flash_fwd_", "flash_bwd_", "fused_loss_fwd_", "fused_loss_bwd_")
_OPTIMIZER = ("adam", "multi_tensor", "foreach")

REWARD_BYTES = set(b"etaoin shrdlu")


def reward_fn(samples, prompts, outputs):
    """Share of response bytes in a fixed set (deterministic, host-side)."""
    return [sum(b in REWARD_BYTES for b in o.encode()) / max(len(o.encode()), 1)
            for o in outputs]


def train_config(checkpoint_dir: str, spec: str = "builtin:gpt2-small", total_steps: int = 12):
    """``default_ppo_config()`` cut to the training slice: seq_length 104,
    batch 16, 2 PPO epochs over 64 rollouts collected 32 at a time, 40
    sampled new tokens, the paged engine's kernels and the fused loss."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    d = default_ppo_config().to_dict()
    d["model"].update(model_path=spec, num_layers_unfrozen=2)
    d["train"].update(seq_length=104, batch_size=16, total_steps=total_steps,
                      continuous_batching=True, rollout_pipeline_depth=0,
                      prefetch_batches=0, save_best=False,
                      checkpoint_dir=checkpoint_dir, tracker=None)
    d["method"].update(ppo_epochs=2, num_rollouts=64, chunk_size=32, loss_kernel="pallas",
                       gen_kwargs=dict(max_new_tokens=40, top_k=0, top_p=1.0, do_sample=True))
    d["engine"].update(backend="paged", decode_kernel="pallas", prefill_kernel="pallas")
    return TRLConfig.from_dict(d)


def slice_prompts(n: int = 64, seed: int = 2024):
    """``n`` prompts of 64 printable bytes from a seeded generator."""
    rs = np.random.RandomState(seed)
    return ["".join(chr(c) for c in rs.randint(32, 127, size=64)) for _ in range(n)]


def _group(name: str) -> str:
    if any(k in name for k in _PORT_KERNELS):
        return "port_kernels"
    low = name.lower()
    if any(k in low for k in _OPTIMIZER):
        return "optimizer"
    if any(k in low for k in _MATMUL):
        return "matmul"
    return "other"


def profile_train(device: torch.device, spec: str = "builtin:gpt2-small", steps: int = 4,
                  trace: str = "") -> Dict[str, Any]:
    from torch.profiler import ProfilerActivity, profile

    from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    config = train_config(os.path.join("build", "profile_train"), spec)
    trainer = PPOTrainer(config=config, reward_fn=reward_fn, device=device)
    max_prompt = config.train.seq_length - config.method.gen_kwargs["max_new_tokens"]
    trainer.add_prompt_pipeline(PromptPipeline(slice_prompts(), max_prompt, trainer.tokenizer))
    t0 = time.perf_counter()
    trainer.make_experience(config.method.num_rollouts)
    exp_s = time.perf_counter() - t0
    trainer.prepare_learning()
    batch = next(iter(trainer.train_dataloader))

    def step():
        trainer.train_step(batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(3):
        step()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        traced_s = time.perf_counter() - t0
    if trace:
        prof.export_chrome_trace(trace)

    by_name: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    intervals = []
    for evt in device_events(prof):
        intervals.append((evt.time_range.start, evt.time_range.end))
        by_name[evt.name][0] += 1
        by_name[evt.name][1] += evt.time_range.end - evt.time_range.start
    busy_s = _busy_us(intervals) * 1e-6
    groups: Dict[str, float] = defaultdict(float)
    for name, (_, us) in by_name.items():
        groups[_group(name)] += us * 1e-3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    untraced_s = sum(times)
    tokens = trainer._batch_token_count(batch)
    return {
        "phase": "profile_train", "model": spec, "batch": list(batch.query_tensors.shape)
        + [int(batch.response_tensors.shape[1])], "tokens_per_batch": tokens,
        "rollout_collection_s": exp_s, "rollout_stats": {
            k: v for k, v in trainer.make_experience_stats.items()
            if k.startswith(("time/", "throughput/"))},
        "train_step_ms_median": 1e3 * statistics.median(times),
        "train_step_ms": [1e3 * t for t in times],
        "train_tokens_per_s": tokens / statistics.median(times),
        "traced_step_ms": 1e3 * traced_s / steps,
        "device_busy_ms_per_step": 1e3 * busy_s / steps,
        "device_busy_share": busy_s / traced_s,
        "device_idle_share": 1.0 - busy_s / traced_s,
        # tracing slows the host, not the kernels
        "device_busy_share_untraced": busy_s / untraced_s,
        "device_launches_per_step": sum(c for c, _ in by_name.values()) / steps,
        "device_ms_per_step_by_group": dict(groups),
        "top_kernels": [{"name": n[:120], "count": c, "ms": us * 1e-3} for n, (c, us) in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4, help="timed and profiled steps")
    ap.add_argument("--trace", default="", help="write the Chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    rec = profile_train(torch.device("cuda"), steps=args.steps, trace=args.trace)
    rec["card"] = smi
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
