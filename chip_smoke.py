#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``trlx_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device facts (``torch.cuda.get_device_name`` and ``nvidia-smi``'s name
   and power limit); no CUDA device is a failure (exit 1);
2. build every kernel from ``trlx_tpu_torch/csrc`` with ``nvcc`` (one
   process per source, all started together) and print the build seconds;
   beside it, the registers, shared memory and spills (``nvcc -Xptxas -v``)
   of the redesigned kernels (``paged_prefill``, ``flash_bwd``,
   ``paged_decode``, ``flash_fwd``, ``fused_sample``) and, where
   ``cuobjdump`` exists, their tensor-core (``HMMA``) instruction counts;
3. every kernel against its plain PyTorch version on the card, at the
   serving slice's shapes, at the shapes the offline paths give the
   engine's kernels (``OFFLINE_ENGINE_SHAPES``: SFT's 984-column eval
   prefill, ILQL's 128 slots, the randomwalks model's head dim 12), at
   the paged span kernel's layout edges (T = 5 and 17), at a GQA shape,
   (decode) at a 1000-column row and every attention kernel at head dims
   12, 48, 96, 256, 320 and 512, in bf16 and f32; the fused sampler in
   every mode the paths meet at B = 8 and 32, at ILQL's 128 slots, on a
   128256-wide row and on the randomwalks vocabulary of 24; the fused
   loss at (B, R) = (16, 40), (32, 40) and (32, 128), IW on and off, with
   its residuals; with the max error, the stated tolerance, kernel /
   plain / library times (device time per call of back-to-back calls
   enqueued behind a sleeping card, and the per-call time with the host's
   launch, ``call_ms``; see ``time_ms``) and the least time the card could
   take;
4. the slice: full-width GPT-2 small (random weights from a seed) on the
   paged ``ContinuousEngine`` behind ``ServeServer`` and its HTTP
   frontend, warmed up off the clock; 16 POSTed requests (half greedy,
   half sampled, one streamed over SSE); every kernel's launch count on
   that run must be > 0 and equal the engine's own launch gauges. Greedy
   parity with the plain dense-cache ``generate`` in f32: the same
   server, engine and kernels run in f32 must answer the greedy requests
   over HTTP token for token as it does (a divergence is tolerated only
   at a near tie of the plain path's top-2 logits), and each bf16 served
   greedy token, teacher-forced through the f32 model, must be within a
   stated logit gap of the f32 argmax (bf16 rounding flips argmaxes at
   gaps far above any tie tolerance); the line prints the f32 top-2 gaps
   at the served positions, i.e. how often a second-best token would be
   caught;
5. the training kernels against their plain versions, and the training
   slice: PPO on full-width GPT-2 small through ``trlx_tpu_torch.train``
   (``slice_train``), then one f32 batch held card against CPU
   (``slice_train_parity``);
6. the speculative slice: the same PPO run with ``engine.speculative: 4``
   and a six-layer GPT-2 draft (``slice_spec``; the verify kernel must
   launch and the spec gauges must be in range), and in f32 with TF32
   off, greedy, the speculative engine's answers against the plain
   ``generate`` token for token, and with the draft set to the target's
   own weights an acceptance of exactly 1.0 (``slice_spec_parity``);
7. the serial slice, PPO at the presets' own settings: ``trlx_tpu_torch.
   train`` on ``default_ppo_config()`` unchanged but for the checkpoint
   directory, 32 steps (two collections of 128 rollouts in one chunk,
   batch 32, 4 PPO epochs) and a checkpoint every 16: full-width GPT-2
   small, 128 prompts of 64 bytes, serial dense rollouts pipelined at
   depth 2, prefetch 2, the staged loss (``slice_serial``); the same run
   with the six-layer draft and ``engine.speculative`` 0, the serial
   speculative sampler (``slice_serial_spec``). Only #5 and #6 may launch
   there, and both must; the trainable weights must move; each prints step
   ms, ``time/exp``, rollout tokens/s, ``rollout_overlap_frac`` and the KV
   gauge, and ``slice_serial`` over one profiled collection the card's
   busy share and launches per decode step. In f32 with TF32 off, at
   ``PARITY_LAYERS`` (3) of the 12 layers (``slice_serial_parity``):
   (a) a collection's store at depth 0 equals depth 2's element for
   element; (b) one batch card against CPU (the staged loss); (c) serial
   greedy answers equal the paged engine's; (d) the serial speculative
   answers equal the plain ``generate``'s, and a self-draft accepts
   exactly 1.0; (e) ``grad_accum`` 2 against the mean of 1 on the halves;
   (f) a run resumed from its step-16 checkpoint against the uninterrupted
   one (weights within tolerance; ``kl_ctl``, running moments and
   ``iter_count`` exact);
8. the offline slices through ``trlx_tpu_torch.train(samples=...)``: SFT
   on ``default_sft_config()`` (GPT-2 small, seq_length 1024, batch 8,
   12 steps; ``slice_sft``) and ILQL on ``default_ilql_config()`` (batch
   128 at seq_length 64, twin Q heads, 12 steps, the target heads synced
   after steps 5 and 10 and at no other; ``slice_ilql``), each with its
   evaluation on the paged engine (the ILQL hook shaping the sampler's f32
   logits) and a profile of three steps; the flash kernels and #1–#3 must
   launch, #1–#3 as often as the engine's gauges and prewarm say. In f32
   with TF32 off, one batch of each store card against CPU and the ILQL
   greedy answers on the card's engine against the CPU's plain
   ``generate`` (``slice_offline_parity``). The kernel checks of phase 3
   and 5 hold the flash kernels on right-padded rows at the SFT and ILQL
   shapes and the sampler on hook-shaped f32 logits under top-k;
9. the acceptance runs on the randomwalks model (head dim 12,
   ``slice_randomwalks``): ``tasks/ppo_randomwalks.py`` (SFT warm start,
   then 160 PPO steps on the example's own settings: serial rollouts at
   depth 2, the staged loss, chunks of 128; see ``RANDOMWALKS_PPO``)
   must end with a mean optimality of at least 0.9 over its last three
   evals, printed beside the continuous path's reading at chunks of 128,
   ``tasks/ilql_randomwalks.py`` (160 steps)
   must lift its last three evals over its first two by more than 0.1;
10. the family slice (``FAMILY_SPEC``, Mistral-7B: rotary positions,
   RMSNorm, the gated SiLU MLP, GQA 4:1 at head dim 128, a 4096 window):
   at full width and 1 of its 32 layers, 16 HTTP requests on 8 slots with
   4160-token
   prompts (half cut to 512 tokens, left-padded by the engine), so the
   window bites in prefill (#1) and decode (#2), beside the time of the
   per-call f32 → bf16 weight cast and of the prefill's bias
   (``slice_family_serve``); the same requests at one layer, greedy,
   under the parity rules of phase 4, the bf16 tokens held to
   ``FAMILY_BF16_GAP_TOL`` (``slice_family_parity``); PPO at
   one layer through ``trlx_tpu_torch.train`` with the hydra branch
   replaying its rotary block, #1–#3 and #5–#8 launching, and two rows
   of one batch held card against CPU (``slice_family_train``,
   ``slice_family_train_parity``). Phases 3 and 5 check the kernels at
   this slice's shapes (the 4160-token windowed prefill over 4192 slots,
   its decode, the sampler at V = 32000, the flash kernels at (16, 104,
   32, 8, 128) with the window, the PPO collections' engine at 32 slots,
   T 64, S 104, and their unfiltered sampler at V = 32000) and
   bloom-560m's per-head ALiBi bias;
11. the GRPO slice: ``trlx_tpu_torch.train`` on ``default_grpo_config()``
   unchanged but for the checkpoint directory (GPT-2 small's width at
   ``GRPO_LAYERS`` (4) of its 12 layers, ``num_layers_unfrozen`` 2, 128
   rollouts in one chunk of 16 prompts × groups of 8, batch 32, 2 epochs, 40 sampled tokens, ``beta`` 0.04, the
   staged loss; depth 2, which GRPO ignores), 16 steps with a checkpoint
   at 8, on 128 seeded 64-byte prompts under :func:`grpo_reward`
   (``slice_grpo``: only #5 and #6 launch); the same run with
   ``train.continuous_batching`` and the paged engine, the group-aware
   harvest (``slice_grpo_cb``: #1–#3, #5 and #6 launch). Each prints step
   ms (median and spread), ``time/exp``, rollout tokens/s,
   ``exp_scores/mean``, ``policy/sqrt_ref_kl`` and, serial, a profiled
   collection's busy share. In f32 with TF32 off, (a), (b) and (d) at
   ``PARITY_LAYERS`` (3) of the 12 layers (``slice_grpo_parity``):
   (a) greedy, under a seeded call-ordered reward, the serial store
   against the continuous one group for group; (b) one batch's loss and
   gradients on the kernels against a CPU copy's plain attention; (c) a
   run resumed from ``slice_grpo``'s step-8 checkpoint against it;
12. the MoE slice at Mixtral-8x7B's width (``MOE_SPEC``): served at one
   layer, 16 HTTP requests on 8 slots, half 1024-token prompts and half
   512, 32 new tokens, half greedy, with the build seconds, the experts'
   per-call cast and the peak memory (``slice_moe_serve``); the f32
   engine's greedy answers against the plain ``generate`` at one layer
   (``slice_moe_parity``); and ``tasks/grpo_sentiments.py``'s GRPO at two
   layers for 4 steps, with the router losses and the peak memory
   (``slice_moe_grpo``). Phases 3 and 5 check the kernels at these
   slices' shapes (the 1024-token prefill over 1056 slots and its decode;
   the GRPO engine's 128-row refill at T = 984; its sampler at B = 128;
   the flash kernels at (32, 104, 12, 12, 64) and (32, 72, 32, 8, 128));
13. preference learning: DPO through ``trlx_tpu_torch.train(samples=
   triples)`` on ``tasks/dpo_sentiments.py`` (``default_dpo_config()``,
   GPT-2 small, 256 triples, batch 16, one epoch of 16 steps, then the
   evaluation on 64 review openings; ``slice_dpo``: the reference pass
   launches #5 alone, the steps #5/#6, the evaluations #1–#3, counted
   apart; the first loss must be ln 2); in f32 with TF32 off the reference
   logps, one stepped batch's loss and gradients card against CPU, and
   ``logit_chunk`` 64 against the full projection (``slice_dpo_parity``);
   the TL;DR recipe's stage 2 (the reward model at the example's settings,
   64 steps) with its end scores against the plain f32 forward, then stage
   3's serial PPO against it (``slice_reward``: #5/#6 only); DPO with LoRA
   (r 8, every projection) at Mistral-7B's width cut to
   ``FAMILY_TRAIN_LAYERS`` layers, 4 steps: the base must not move and
   every adapter must (``slice_dpo_lora``). Phase 5 checks the flash
   kernels at these paths' right-padded shapes (``PREFERENCE_FLASH_SHAPES``)
   and the stage-3 PPO's left-padded train batch and prefill;
14. the seq2seq (T5) path: ``tasks/ppo_sentiments_t5.py`` as it stands on
   ``builtin:t5-small`` (full width and depth, 128 rollouts in one chunk,
   40 tokens at top-p 0.95, right padding, the lexicon reward) for one
   collection and the 16 updates it feeds, with a profiled collection
   (``slice_t5_ppo``); ``tasks/ilql_summarize_t5.py``'s settings at
   Flan-T5-XL's width cut to 2 + 2 layers, 256 comparisons, 8 steps and
   the evaluations on 16 TL;DR posts at ``beta`` 1, 2 and 3
   (``slice_t5_ilql``). Neither launches a kernel: T5's attention is an
   einsum around a learned bias (no Pallas kernel in JAX either) and the
   examples' loss is the staged one. In f32 with TF32 off
   (``slice_t5_parity``): the buckets, the encoder and decoder passes and
   greedy decoding card against CPU, cached decode against the full pass,
   and one PPO step at ``loss_kernel`` xla and pallas, where #7/#8 must
   launch; the bf16 logits' gap against f32;
15. run management and resilience: ``tasks/ppo_sentiments_llama.py`` as it
   stands (``remat: minimal``, bf16, ``seq_length`` 1024, batch 32, 128
   rollouts in one chunk, 4 PPO epochs, 40 new tokens,
   ``num_layers_unfrozen`` 2) at ``builtin:llama-7b``'s full width cut to
   ``REMAT_LAYERS`` of 32 layers, one collection and its 16 updates, with
   the step ms, the peak memory and #5/#6 launching twice / once per
   layer and step (``slice_remat``); one of its batches through remat
   ``none``, ``minimal`` and ``full`` on the same model: the loss and the
   gradients equal, the peak memory falling, #5 launching once per layer
   under ``none`` and twice under the others (``slice_remat_policies``);
   and the presets' serial PPO path at gpt2-small's width (6 of its 12
   layers) under a fault plan, at both loss kernels: reward retries, a NaN loss skipped by the update
   guard, a SIGTERM's emergency checkpoint and its resume equal bitwise to
   the uninterrupted run, the retention ring, the JSONL tracker, rollout
   logs and a profiler window naming the flash kernels
   (``slice_resilience``);
16. the rest of serving on GPT-2 small at full width and depth: the prefix
   cache, chunked prefill, priority preemption and the host tier over HTTP
   (``slice_serve_prefix``, bf16: :func:`prefix_stream`'s 32 requests of
   two tenants in six waves on 8 slots, 256-token prompts, chunks of 64, a
   40-entry cap and a 64-block host tier, no eos token; prefix hits, tier
   hits and preemptions must all happen, #1–#3 launch as the engine's
   gauges plus its prewarm say); the same stream in f32 with TF32 off,
   its greedy answers against a cold engine and the plain ``generate``,
   warm against cold logprobs, every re-landed block bitwise, the host
   counters equal to the bf16 run's (``slice_serve_prefix_parity``); and
   serving inside PPO's ``learn()`` on ``default_ppo_config()`` with the
   continuous path, the prefix cache, chunks of 32 and ``serve.enabled``,
   8 streamed greedy requests held against a solo ``generate`` under
   their version's retained weights, a ``request_flood`` drill
   (``slice_serve_train``, after ``slice_grpo_parity``, which holds the
   group-aware harvest with the prefix cache against without as its (d)).
   Phase 3 checks #1 at these phases' spans (``PREFIX_SPAN_SHAPES``);
17. Hugging Face checkpoints (``slice_hf``, no ``transformers`` and no
   ``safetensors`` package), each part right after the phase whose model
   it reuses: (a) after ``slice_serial``, its policy through
   ``trainer.save_pretrained`` (GPT-2's HF ``config.json``, the value head
   merged as ``v_head.*``), ``build_causal_lm(<dir>, head="value")`` with a
   backbone bitwise the trainer's, 16 HTTP requests (half greedy) on the
   loaded model equal to the in-memory policy's on one gated schedule
   (#1–#3), and PPO from ``model_path=<dir>`` for one collection and two
   updates under the fused loss (#5–#8), its first scoring logprobs equal
   to the in-memory policy's (``phase_slice_hf_gpt2``); (b) after
   ``slice_family_parity``, its Mistral-7B-width model written as a
   sharded bf16 ``model.safetensors.index.json`` (:func:`write_safetensors`)
   and read back by ``load_pretrained`` alone and by ``build_causal_lm
   (<dir>)``, each with its seconds, GB/s and peak device memory, the
   weights and logits equal to the model's rounded to bf16, and one
   prefill and four decode steps of the paged engine on the built model (#1–#3;
   ``phase_slice_hf_mistral``); (c) after ``slice_t5_ppo``, its t5-small
   exported and reloaded by ``build_seq2seq_lm``, greedy tokens equal
   (``phase_slice_hf_t5``). Their seconds add up under ``slice_hf``, their
   launches under the path ``hf``;
18. the rest of the engine, each part on a model an earlier phase built:
   (a) after ``slice_spec_parity``, speculation with the prefix cache and
   chunked prefill together on the prefix phases' bf16 GPT-2 small with a
   six-layer draft (``SPEC_PREFIX``: two tenants' 256-token prompts, two
   waves, hits of 192 and 240 columns, chunks of 64; #1, #4 and #5
   launch, decode stalls measured) and its f32 twin against the solo
   sampler (``slice_spec_prefix``); (b) PPO on ``default_ppo_config()``
   with ``train.continuous_batching`` at the engine's defaults, the dense
   backend, inline and with the pipelined host stage, the stores equal,
   and in f32 the dense, paged-gather and paged-kernel engines against
   ``generate`` (``slice_engine_dense``); (c) after ``slice_grpo_parity``,
   ``slice_grpo_cb``'s run for 2 steps under ``engine.speculative`` 4
   (``slice_grpo_spec``); (d) after ``slice_hf``'s (b), a Llama-family
   draft (vocabulary 32000, a quarter of the width) for the family
   parity's f32 Mistral-7B-width model, greedy with the prefix cache on
   repeated prompts, against ``generate`` (``slice_family_spec``); (e) in
   ``slice_offline_parity``, ILQL's speculative sampling: greedy against
   the hooked ``generate`` in f32, and the trainer's own ``generate``
   with a two-layer draft. Phase 3 checks #1 after a 192-column hit over
   the speculative key width and #4 over rows sharing their first 12
   blocks;
19. async RL (``slice_async``, after ``slice_hf``'s (a), on the policy
   ``slice_serial`` trained): the PPO preset on the continuous paged path
   with the fused loss and the clipped IW correction, ``async_rl`` in
   thread mode: (a) at ``max_staleness: 0`` one collection whose store
   equals the serial continuous path's from the same seeds; (b) two
   actors at ``max_staleness: 1`` through ``trlx_tpu_torch.train`` for
   32 steps: no chunk staler than 1, the ``async/*`` stats, the IW clip
   fraction, ``time/exp`` beside ``slice_serial``'s, the actor/learner
   span overlap, the snapshot copy and the peak memory, #1–#3 and #5–#8
   all launching; (c) process mode on the file transport with one
   ``run_actor`` child on the same card (its own launches reported in its
   chunks, the npz write seconds); (d) the collective transport for one
   collection; (e) GRPO async for one collection.
20. the ring (``slice_ring``, after ``train_kernels``): ring attention in
   one process on #5 and #6' against the monolithic flash call;
21. PPO over two processes on the one card (``slice_parallel_rl``, last):
   two ranks in a gloo group of their own (one card holds no second NCCL
   rank) run the training slice's PPO at ``data`` 2, and two more at
   ``fsdp`` 2 beside them (f32, ``PARALLEL_RL_LAYERS`` (6) layers), each
   after a probe of gloo's collectives on CUDA tensors; the ranks' weights
   bitwise equal after
   every step, step 1 against a one-process step over the same store,
   ``sigterm_one_proc`` stopping both ranks at one checkpoint, and its
   resume in one process through the elastic reshard (launches per rank
   under the path ``parallel_rl``).

Phase 3 and 5 time the plain versions and the library calls only at the
shapes ``PERF.md`` records (the table's rows and its other shapes); at
every other shape the kernel alone is timed (``KERNEL_ONLY``), and the
plain version runs once for the error check.

Before the kernel summary, ``phase_seconds`` gives each phase's wall
seconds.

The line before the last holds the kernel summary (each kernel's launches
on its own slice's path, and on every path in ``launches_by_path``), the one before it the
card's name and power limit; the last line is the result object. Any
failure raises, and the script exits non-zero without the result line.
"""

import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per type

# file:line of each replaced TPU kernel's pl.pallas_call (the verify's
# entry, which delegates to the prefill's pallas_call)
REPLACES = {
    "paged_decode": "trlx_tpu/ops/paged_attention.py:226",
    "paged_prefill": "trlx_tpu/ops/paged_prefill.py:212",
    "paged_verify": "trlx_tpu/ops/paged_attention.py:269",
    "fused_sample": "trlx_tpu/ops/paged_attention.py:373",
    "flash_fwd": "trlx_tpu/ops/flash_attention.py:318",
    "flash_bwd": "trlx_tpu/ops/flash_attention.py:377",
    "flash_bwd_chunk": "trlx_tpu/ops/flash_attention.py:434",
    "fused_loss_fwd": "trlx_tpu/ops/fused_loss.py:274",
    "fused_loss_bwd": "trlx_tpu/ops/fused_loss.py:309",
}
# the CUDA source of each kernel row (the verify runs the prefill kernel,
# the backward's chunk form the backward kernel)
SOURCES = {"paged_verify": "paged_prefill", "flash_bwd_chunk": "flash_bwd"}
SERVE_KERNELS = ("paged_prefill", "paged_decode", "fused_sample")
TRAIN_KERNELS = ("flash_fwd", "flash_bwd", "fused_loss_fwd", "fused_loss_bwd")
# the speculative rollout path: target refill, verify, draft refill and
# scoring, train step
SPEC_KERNELS = ("paged_prefill", "paged_verify") + TRAIN_KERNELS


def kernel_wrappers():
    """name → wrapper (each carries its ``launches`` counter)."""
    from trlx_tpu_torch.ops.flash_attention import flash_attention_bwd_chunk, flash_bwd, flash_fwd
    from trlx_tpu_torch.ops.fused_loss import fused_loss_bwd, fused_loss_fwd
    from trlx_tpu_torch.ops.paged_attention import (
        fused_sample,
        paged_attention_decode,
        paged_verify_attention,
    )
    from trlx_tpu_torch.ops.paged_prefill import paged_prefill_attention

    return {"paged_prefill": paged_prefill_attention, "paged_decode": paged_attention_decode,
            "paged_verify": paged_verify_attention,
            "fused_sample": fused_sample, "flash_fwd": flash_fwd, "flash_bwd": flash_bwd,
            "flash_bwd_chunk": flash_attention_bwd_chunk,
            "fused_loss_fwd": fused_loss_fwd, "fused_loss_bwd": fused_loss_bwd}


def launch_counts():
    return {k: w.launches for k, w in kernel_wrappers().items()}


def zero_launch_counts():
    for w in kernel_wrappers().values():
        w.launches = 0


def emit(obj):
    print(json.dumps(obj), flush=True)


# torch.cuda._sleep spins for a number of SM clock cycles; at or above this
# many per millisecond (the H100's boost clock is ~1.98 GHz) a sleep lasts
# at least as many milliseconds as it was sized for
SLEEP_CYCLES_PER_MS = 2.0e6


def time_ms(fn, n=50, windows=5, calls=25, warmup=3, waits=False):
    """``(ms, call_ms)`` of ``fn``, in milliseconds per call.

    ``ms`` is device time alone: the card sleeps (``torch.cuda._sleep``)
    while the host enqueues event ``a``, ``n`` back-to-back calls and event
    ``b``, so the calls run one after another with no host time between
    them, and (b - a) / n is what the card spends on one call. The sleep is
    sized from the host time of ``n`` calls and must still be running when
    ``b`` is enqueued (``a`` not yet reached). If it is not, the host fell
    behind: the sleep was short, or ``n`` calls of many small kernels
    filled the launch queue and the host waited for the card; the window is
    taken again with half the calls behind twice the sleep; a ``fn`` that
    still falls behind at one call waits for the card itself and reads
    :func:`busy_ms` instead. Median over ``windows`` windows; warm L2, as
    on the main path, where a layer reads what it has just written.

    ``call_ms`` is the per-call figure the main path pays, host included:
    event, one call, event, synchronize; median over ``calls`` calls.
    ``waits``: ``fn`` is known to wait for the card itself, so ``ms`` is
    :func:`busy_ms` at once, without the sleeping windows it would fail."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    per_call = []
    for _ in range(calls):
        a, b = ev(), ev()
        a.record()
        fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b))
    if waits:
        return busy_ms(fn), statistics.median(per_call)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    cycles = int((2.0 * host_ms + 1.0) * SLEEP_CYCLES_PER_MS)
    device = []
    while len(device) < windows:
        a, b = ev(), ev()
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        covered = not a.query()
        b.synchronize()
        if covered:
            device.append(a.elapsed_time(b) / n)
            continue
        if n == 1:  # fn waits for the card itself: its kernels' busy time
            emit({"phase": "timer", "busy_ms_for": f"chip_smoke.py:{fn.__code__.co_firstlineno}"})
            return busy_ms(fn), statistics.median(per_call)
        cycles = min(2 * cycles, int(2000 * SLEEP_CYCLES_PER_MS))  # at most a 2 s sleep
        n = n // 2
    return statistics.median(device), statistics.median(per_call)


def busy_ms(fn, calls=10):
    """Device time per call of a ``fn`` that waits for the card itself (a
    host sync inside), whose calls cannot queue behind a sleep: the union
    of its kernels' intervals on ``torch.profiler``'s device timeline."""
    from torch.profiler import ProfilerActivity, profile

    from trlx_tpu_torch.profile_serve import _busy_us, device_events

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in device_events(prof)]
    return _busy_us(spans) / calls / 1e3


# a check's ``timed`` level at the shapes whose times PERF.md does not
# record: the kernel alone is timed (the plain versions and library calls,
# host-bound, are timed only at the recorded shapes; ``timed=True``)
KERNEL_ONLY = "kernel"


def timed_pair(kernel, plain, with_plain=True, plain_waits=False, **timing):
    """Device and per-call times of a kernel and, ``with_plain``, of its
    plain version (``timing``: :func:`time_ms`'s counts; ``plain_waits``:
    the plain version waits for the card itself)."""
    rec = {}
    rec["kernel_ms"], rec["call_ms"] = time_ms(kernel, **timing)
    rec["plain_ms"], rec["plain_call_ms"] = (time_ms(plain, waits=plain_waits, **timing)
                                             if with_plain else (None, None))
    return rec


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "torch_name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


# the sources whose kernels' resources phase_build reports (the redesigned
# kernels), and whether their bf16 kernels run on tensor cores
RESOURCE_SOURCES = {"paged_prefill": True, "flash_bwd": True, "paged_decode": False,
                    "flash_fwd": True, "fused_sample": False, "fused_loss_fwd": False,
                    "fused_loss_bwd": False}


def phase_build():
    """Every kernel built, and beside the build (their own nvcc processes,
    all started together) the resources of the redesigned kernels."""
    from concurrent.futures import ThreadPoolExecutor

    from trlx_tpu_torch.ops.kernel_utils import build_kernels

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(RESOURCE_SOURCES)) as pool:
        resources = [pool.submit(kernel_resources, name, mma)
                     for name, mma in RESOURCE_SOURCES.items()]
        paths = build_kernels()
        resources = [r.result() for r in resources]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "kernels": sorted(paths)})
    for rec in resources:
        emit(rec)


def _cuda_tool(name):
    """A CUDA toolkit binary (``cuobjdump``, ``cu++filt``), or None."""
    import shutil

    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    try:  # Triton's wheel carries cuobjdump and nvdisasm
        import triton

        cand = os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin", name)
        return cand if os.path.exists(cand) else None
    except ImportError:
        return None


def kernel_resources(name, tensor_cores):
    """``nvcc -Xptxas -v`` of ``csrc/<name>.cu`` compiled to a cubin:
    registers, static shared memory and spill bytes of each kernel in it;
    with ``cuobjdump``, the count of ``HMMA`` (tensor-core) instructions in
    each kernel's SASS. With ``tensor_cores``, a source without a kernel
    named ``*mma*``, or such a kernel without ``HMMA``, fails."""
    import re

    from trlx_tpu_torch.ops.kernel_utils import BUILD_DIR, CSRC_DIR, _nvcc

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cubin = BUILD_DIR / f"{name}-{os.getpid()}.cubin"
    proc = subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin",
         "-Xptxas", "-v", "-o", str(cubin), str(CSRC_DIR / f"{name}.cu")],
        capture_output=True, text=True, check=True)
    kernels, current = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            current = kernels.setdefault(m.group(1), {})
        elif current is not None:
            for key, pat in (("spill_store_bytes", r"(\d+) bytes spill stores"),
                             ("spill_load_bytes", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("static_smem_bytes", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    current[key] = int(m.group(1))
    cuobjdump = _cuda_tool("cuobjdump")
    if cuobjdump:
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True,
                              check=True).stdout
        for section in sass.split("Function : ")[1:]:
            fn = section.split()[0]
            kernels.setdefault(fn, {})["hmma"] = section.count("HMMA")
    cubin.unlink()
    demangle = _cuda_tool("cu++filt")
    rows = []
    for fn, info in sorted(kernels.items()):
        readable = fn
        if demangle:
            readable = subprocess.run([demangle, fn], capture_output=True, text=True).stdout.strip()
        rows.append({"kernel": readable or fn, **info})
    rec = {"phase": "kernel_resources", "source": f"trlx_tpu_torch/csrc/{name}.cu",
           "cuobjdump": cuobjdump, "kernels": rows}
    mma = [r for r in rows if "mma" in r["kernel"]]
    if tensor_cores and cuobjdump and (not mma or any(r.get("hmma", 0) == 0 for r in mma)):
        raise AssertionError(f"a tensor-core kernel has no HMMA in its SASS: {rec}")
    return rec


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def device_generator(rs, dev):
    """A generator on ``dev`` seeded by the case's numpy stream: the large
    operands of the kernel checks are drawn on the device, as host draws of
    billions of values would dominate the checks' time."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rs.randint(0, 2**31 - 1)))
    return gen


def device_randn(rs, dev):
    """``randn(*shape)`` in f32 on ``dev`` (:func:`device_generator`)."""
    gen = device_generator(rs, dev)
    return lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)


def paged_inputs(rs, B, T, H, KV, D, bs, S, HB, dtype, dev, poison, window=0, q_start=None):
    """Random pool/table/bias for one geometry: rows see a random valid
    key prefix (causal over the chunk for T > 1, within ``window`` slots
    of the query when set); table entries past a row's valid columns are
    poisoned out of range when ``poison``; every pool block holds random
    stale values. With ``q_start`` every row's queries sit at the slots
    ``[q_start, q_start + T)`` (a suffix after a prefix hit, or a chunk
    span): the committed columns below them are visible, and every column
    from ``q_start + T`` on is masked. ``vis`` (``[B, T, S]`` bool) is on
    ``dev``."""
    from trlx_tpu_torch.ops.paged_kv import num_table_blocks

    dev = torch.device(dev)
    TB = num_table_blocks(S, bs)
    NB = 1 + B * TB + 3
    randn = device_randn(rs, dev)
    q, kp, vp = randn(B, T, H, D), randn(NB, bs, KV, D), randn(NB, bs, KV, D)
    perm = rs.permutation(np.arange(1, NB))[: B * TB].reshape(B, TB)
    valid = (rs.randint(T, S + 1, size=B) if q_start is None
             else np.full(B, q_start + T))  # visible key columns per row
    end_col = torch.as_tensor(valid[:, None] - T + np.arange(T)[None, :],
                              device=dev)  # query slots
    cols = torch.arange(S, device=dev)[None, None, :]
    vis = (cols <= end_col[:, :, None]) & torch.as_tensor(rs.rand(B, 1, S) > 0.1, device=dev)
    if window:
        vis &= end_col[:, :, None] - cols < window
        vis.scatter_(2, end_col[:, :, None], True)
    else:
        vis[:, :, 0] = True
    bias = torch.where(vis, 0.0, -1e9)[:, None].expand(B, HB, T, S)
    if HB > 1:
        bias = bias + torch.where(vis[:, None], randn(B, HB, 1, S) * 0.3, 0.0)
    table = perm.copy()
    if poison:
        for b in range(B):
            first_dead = -(-int(valid[b]) // bs)
            table[b, first_dead:] = NB + 1 + b
    f = lambda x: x.to(dev, dtype).contiguous()  # noqa: E731
    return dict(
        q=f(q), k=f(kp), v=f(vp),
        table=torch.tensor(table, dtype=torch.int32, device=dev),
        bias=bias.float().contiguous(),
        vis=vis, TB=TB, NB=NB,
    )


def verify_inputs(rs, B, T, H, KV, D, bs, S, dtype, dev, poison, P=64, shared_blocks=0):
    """The speculative verify's operands at per-row depths: ``G = T - 1``,
    ``N = S - P - G``; row ``b`` has committed ``n_b`` tokens (random, row
    1's probe window ``[c - 1, c + G)`` crossing a block edge), a
    left-padded prompt, and the slot-causal bias over its committed slots
    and probe slots, as the model builds it; table entries past the row's
    allocated blocks stay 0 (the reserved block), and the last ``poison``
    rows are done (whole table out of range). With ``shared_blocks`` every
    row's first table entries are row 0's blocks (a prefix-cache hit
    shared by every slot)."""
    from trlx_tpu_torch.models.transformer import attention_bias
    from trlx_tpu_torch.ops.paged_kv import num_table_blocks

    G = T - 1
    N = S - P - G
    TB = num_table_blocks(S, bs)
    NB = 1 + B * TB + 3
    n_out = rs.randint(0, N - G, size=B)
    n_out[1] = bs * (-(-(P + G) // bs)) - 1 - P  # c - 1: a block's second-to-last column
    c = P + n_out
    slot_mask = np.zeros((B, S), np.int64)
    for b in range(B):
        slot_mask[b, rs.randint(0, 8): c[b] + G] = 1
    query_slots = torch.tensor(c[:, None] - 1 + np.arange(T)[None, :])
    bias = attention_bias(torch.tensor(slot_mask), query_slots)
    perm = rs.permutation(np.arange(1, NB))[: B * TB].reshape(B, TB)
    table = np.zeros((B, TB), np.int64)
    for b in range(B):
        alloc = -(-int(c[b] + rs.randint(0, G + 1)) // bs)  # covers the committed columns
        table[b, :alloc] = perm[b, :alloc]
        table[b, :shared_blocks] = perm[0, :shared_blocks]
    table[B - poison:] = NB
    randn = device_randn(rs, dev)
    f = lambda *shape: randn(*shape).to(dtype)  # noqa: E731
    return dict(
        q=f(B, T, H, D), k=f(NB, bs, KV, D), v=f(NB, bs, KV, D),
        table=torch.tensor(table, dtype=torch.int32, device=dev),
        bias=bias.to(dev).contiguous(), vis=(bias[:, 0] > -1).numpy(), TB=TB, NB=NB,
    )


def attention_bound(inp, B, T, H, KV, D, S, HB, dtype):
    elem = torch.finfo(dtype).bits // 8
    visible_cols = int(inp["vis"].any(1).sum())  # key columns any query needs
    visible_pairs = int(inp["vis"].sum())  # (query, key) pairs per head
    nbytes = (2 * B * T * H * D * elem  # q in, out
              + 2 * visible_cols * KV * D * elem  # K and V columns read
              + B * HB * T * S * 4 + B * inp["TB"] * 4)
    ops = 4 * visible_pairs * H * D
    return bound(nbytes, ops, dtype)


def check_attention(kind, B, T, H, KV, D, bs, S, HB, dtype, poison, seed,
                    timed=False, window=0, timing=None, q_start=None, verify_geo=None):
    """One paged attention kernel against its plain version; ``window``
    bounds every query's keys to its last ``window`` slots, ``timing``
    passes :func:`time_ms`'s counts (long shapes), ``q_start`` places the
    queries at a fixed offset (:func:`paged_inputs`), ``verify_geo`` the
    verify's prompt width and shared blocks (:func:`verify_inputs`)."""
    from trlx_tpu_torch.ops.paged_attention import (
        _gathered_view,
        paged_attention_decode,
        paged_attention_decode_reference,
        paged_verify_attention,
        paged_verify_attention_reference,
    )
    from trlx_tpu_torch.ops.paged_prefill import (
        paged_prefill_attention,
        paged_prefill_attention_reference,
    )

    dev = torch.device("cuda")
    rs = np.random.RandomState(seed)
    if kind == "paged_verify":
        inp = verify_inputs(rs, B, T, H, KV, D, bs, S, dtype, dev, poison, **(verify_geo or {}))
    else:
        inp = paged_inputs(rs, B, T, H, KV, D, bs, S, HB, dtype, dev, poison, window, q_start)
    if kind == "paged_decode":
        q, bias = inp["q"][:, 0].contiguous(), inp["bias"][:, :, 0].contiguous()
        kern, ref = paged_attention_decode, paged_attention_decode_reference
    elif kind == "paged_verify":
        q, bias = inp["q"], inp["bias"]
        kern, ref = paged_verify_attention, paged_verify_attention_reference
    else:
        q, bias = inp["q"], inp["bias"]
        kern, ref = paged_prefill_attention, paged_prefill_attention_reference
    args = (q, inp["k"], inp["v"], inp["table"], bias)
    before = kern.launches
    out = kern(*args)
    torch.cuda.synchronize()
    # bf16: held against the plain version run in f32 on the same bf16
    # inputs (the kernel accumulates in f32; its output rounds to bf16)
    want = ref(*(a.float() if a.is_floating_point() else a for a in args))
    err = float((out.float() - want).abs().max())
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    rec = {"phase": "kernel_check", "kernel": kind, "dtype": str(dtype).split(".")[-1],
           "B": B, "T": T, "H": H, "KV": KV, "D": D, "bs": bs, "S": S, "TB": inp["TB"],
           "HB": HB, "window": window, "q_start": q_start, "poisoned_ids": poison,
           **({"verify_geo": verify_geo} if verify_geo else {}),
           "max_abs_err": err, "tol": tol}
    if not math.isfinite(err) or err > tol:
        emit({**rec, "ok": False})
        raise AssertionError(f"{kind} disagrees with its plain version: {err} > {tol}")
    if timed:
        timing = timing or {}
        full = timed is True
        rec.update(timed_pair(lambda: kern(*args), lambda: ref(*args), full, **timing))
        rec["library_ms"] = rec["library_call_ms"] = None
        if full:
            # library yardstick: SDPA on a gathered dense view with the same
            # bias (the gather itself is not timed)
            kd = _gathered_view(inp["k"], inp["table"], S, H).transpose(1, 2)
            vd = _gathered_view(inp["v"], inp["table"], S, H).transpose(1, 2)
            qd = inp["q"].transpose(1, 2)
            mask = inp["bias"].to(dtype)
            rec["library_ms"], rec["library_call_ms"] = time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(qd, kd, vd,
                                                                         attn_mask=mask),
                **timing)
        b_ms, b_by = attention_bound(inp, B, T, H, KV, D, S, HB, dtype)
        rec["bound_ms"], rec["bound_by"] = b_ms, b_by
        rec["bound_us"] = 1e3 * b_ms
    kern.launches = before  # comparison launches are not main-path launches
    emit({**rec, "ok": True})
    return rec


# the fused sampler's settings: the three timed since PR 1, the served
# slice's and the training collections'
SAMPLE_MODES = {
    "greedy": dict(temperature=1.0, top_k=0, top_p=1.0, sample=False),
    "temp_topk": dict(temperature=0.7, top_k=50, top_p=1.0, sample=True),
    "topp": dict(temperature=1.0, top_k=0, top_p=0.9, sample=True),
    "served": dict(temperature=1.0, top_k=50, top_p=0.95, sample=True),
    "train": dict(temperature=1.0, top_k=0, top_p=1.0, sample=True),
}
# the ILQL eval's: f32 logits shaped by the trainer's hook
# (log_softmax(logits) + β (min target-Q − V)) under the preset's top-k 20
# at temperature 1, ilql_randomwalks' top-k 10 at 0.1, and the acceptance
# run's 0.05 (RANDOMWALKS_ILQL); the gpu tests share these
ILQL_SAMPLE_MODES = {
    "ilql": dict(temperature=1.0, top_k=20, top_p=1.0),
    "ilql_randomwalks": dict(temperature=0.1, top_k=10, top_p=1.0),
    "ilql_randomwalks_t0.05": dict(temperature=0.05, top_k=10, top_p=1.0),
}


def ilql_shaped_logits(B, V, seed, beta=1.0):
    """[B, V] f32 logits as the ILQL hook hands them to the sampler."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(B, V) * 3.0
    logp = logits - logits.max(-1, keepdims=True)
    logp -= np.log(np.exp(logp).sum(-1, keepdims=True))
    adv = rs.randn(B, V) * 0.5 - rs.randn(B, 1) * 0.5  # min target-Q − V
    return (logp + beta * adv).astype(np.float32)


def sample_mode(mode):
    if mode in ILQL_SAMPLE_MODES:
        return dict(ILQL_SAMPLE_MODES[mode], sample=True)
    return dict(SAMPLE_MODES[mode])


def check_sample(mode, dtype_name, B, V, seed, timed=False):
    """``dtype_name``: ``bfloat16`` (bf16-rounded model logits), ``float32``,
    or ``ilql_f32`` (f32 logits shaped by the ILQL hook)."""
    from trlx_tpu_torch.ops.paged_attention import fused_sample, fused_sample_reference

    dev = torch.device("cuda")
    rs = np.random.RandomState(seed)
    gen = device_generator(rs, dev)
    logits = 3.0 * torch.randn((B, V), generator=gen, device=dev)
    if dtype_name == "bfloat16":  # bf16 model logits: many exact ties
        logits = logits.to(torch.bfloat16).float()
    if dtype_name == "ilql_f32":
        logits = torch.tensor(ilql_shaped_logits(B, V, seed), device=dev)
    logits = logits.contiguous()
    settings = sample_mode(mode)
    gumbel = None
    if settings.pop("sample"):
        u = 1e-7 + (1.0 - 2e-7) * torch.rand((B, V), generator=gen, device=dev)
        gumbel = -torch.log(-torch.log(u))
    before = fused_sample.launches
    tok, lp = fused_sample(logits, gumbel, **settings)
    torch.cuda.synchronize()
    rtok, rlp = fused_sample_reference(logits, gumbel, **settings)
    mism = int((tok != rtok).sum())
    err = float((lp - rlp).abs().max()) if mism == 0 else float("inf")
    tol = 1e-4
    rec = {"phase": "kernel_check", "kernel": "fused_sample", "mode": mode,
           "logits": dtype_name, "B": B, "V": V, **settings,
           "token_mismatches": mism, "max_abs_err": err, "tol": tol}
    if mism or err > tol:
        emit({**rec, "ok": False})
        raise AssertionError(f"fused_sample {mode} disagrees: {mism} tokens, lp err {err}")
    if timed:
        rec.update(timed_pair(lambda: fused_sample(logits, gumbel, **settings),
                              lambda: fused_sample_reference(logits, gumbel, **settings),
                              timed is True))
        rec["library_ms"] = None  # no single PyTorch call computes it
        nbytes = B * V * 4 * (2 if gumbel is not None else 1) + B * 8
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 4 * B * V, torch.float32)
        rec["bound_us"] = 1e3 * rec["bound_ms"]
    fused_sample.launches = before
    emit({**rec, "ok": True})
    return rec


def phase_kernels():
    """Returns the slice-shape bf16 record of each kernel (timed)."""
    slice_geo = dict(B=8, H=12, KV=12, D=64, bs=16, S=104, HB=1)
    gqa_geo = dict(B=4, H=32, KV=8, D=128, bs=16, S=72, HB=32)  # TB = 5
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        bf = dtype == torch.bfloat16
        pre = check_attention("paged_prefill", T=64, dtype=dtype, poison=False,
                              seed=1, timed=bf, **slice_geo)
        dec = check_attention("paged_decode", T=1, dtype=dtype, poison=True,
                              seed=2, timed=bf, **slice_geo)
        # a long row (recorded, not gated): the decode's column split over
        # 4 spans of 256 and its merge launch
        check_attention("paged_decode", T=1, dtype=dtype, poison=True, seed=7,
                        timed=bf and KERNEL_ONLY, **{**slice_geo, "S": 1000})
        if bf:
            timed["paged_prefill"], timed["paged_decode"] = pre, dec
        # the bf16 kernel's layout edges: T = 5 (the verify's G + 1, keys
        # split over four warps) and T = 17 (two-warp query tiles, ragged)
        for T in (5, 17):
            check_attention("paged_prefill", T=T, dtype=dtype, poison=True, seed=6 + T,
                            **slice_geo)
        check_attention("paged_prefill", T=24, dtype=dtype, poison=True, seed=3,
                        **gqa_geo)
        check_attention("paged_decode", T=1, dtype=dtype, poison=True, seed=4,
                        **gqa_geo)
    # the speculative verify (#4): 32 slots, G = 4 probes over S = 64 + 40 + 4
    # columns, rows at their own depths, 4 done rows poisoned
    for dtype in (torch.bfloat16, torch.float32):
        rec = check_attention("paged_verify", B=32, T=5, H=12, KV=12, D=64, bs=16, S=108,
                              HB=1, dtype=dtype, poison=4, seed=5,
                              timed=dtype == torch.bfloat16)
        if "kernel_ms" in rec:
            timed["paged_verify"] = rec
    # the prefix-cache and chunked-prefill spans of the serving phases
    # (PREFIX_SERVE: P = 256, 40 new tokens, S = 296): the suffix after a
    # 48-column hit (T = 208, the two-warp layout) and after a 240-column
    # one (T = 16 = bs: a repeated prompt's hit is capped one block short,
    # the four-warp layout), and a T = 64 chunk span at offset 128, every
    # column from its end on masked (timed in bf16)
    for dtype in (torch.bfloat16, torch.float32):
        bf = dtype == torch.bfloat16
        for name, T, q_start in PREFIX_SPAN_SHAPES:
            rec = check_attention("paged_prefill", B=8, T=T, H=12, KV=12, D=64, bs=16, S=296,
                                  HB=1, dtype=dtype, poison=True, seed=120 + q_start,
                                  timed=bf, q_start=q_start)
            if bf:
                timed[f"paged_prefill_{name}"] = rec
    # slice_spec_prefix's spans (SPEC_PREFIX: P = 256, 40 new tokens, G = 4,
    # so S = 300): #1 on the suffix after a 192-column hit over the
    # speculative key width, and #4 over probes whose rows share their first
    # 12 blocks (the tenant's system prompt); errors in both types, one
    # device time each in bf16
    spec_S = SPEC_PREFIX["prompt_len"] + SPEC_PREFIX["max_new"] + SPEC_GAMMA
    for dtype in (torch.bfloat16, torch.float32):
        bf = dtype == torch.bfloat16
        rec = check_attention("paged_prefill", B=8, T=64, H=12, KV=12, D=64, bs=16, S=spec_S,
                              HB=1, dtype=dtype, poison=True, seed=130, q_start=192,
                              timed=bf and KERNEL_ONLY)
        if bf:
            timed["paged_prefill_spec_suffix_after_192"] = rec
        rec = check_attention("paged_verify", B=8, T=SPEC_GAMMA + 1, H=12, KV=12, D=64, bs=16,
                              S=spec_S, HB=1, dtype=dtype, poison=2, seed=131,
                              timed=bf and KERNEL_ONLY,
                              verify_geo={"P": SPEC_PREFIX["prompt_len"],
                                          "shared_blocks": SPEC_PREFIX["system_len"] // 16})
        if bf:
            timed["paged_verify_shared_prefix"] = rec
    # every attention kernel at head dims off the tensor-core templates
    # (padded inside the loads), at 256 (CUDA cores for the span kernel,
    # decode's padded 256) and above (split over the head dim), GQA, in
    # both types
    for D in HEAD_DIM_CHECKS:
        geo = dict(B=4, H=8, KV=4, D=D, bs=16, S=104, HB=1)
        for dtype in (torch.bfloat16, torch.float32):
            check_attention("paged_prefill", T=64, dtype=dtype, poison=True, seed=40 + D, **geo)
            check_attention("paged_decode", T=1, dtype=dtype, poison=True, seed=41 + D, **geo)
            check_attention("paged_verify", B=8, T=5, H=8, KV=4, D=D, bs=16, S=108, HB=1,
                            dtype=dtype, poison=2, seed=42 + D)
    # the offline paths' engine shapes, in both types (timed in bf16)
    for name, (B, P, S, H, D) in OFFLINE_ENGINE_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            bf = dtype == torch.bfloat16
            geo = dict(B=B, H=H, KV=H, D=D, bs=16, S=S, HB=1)
            pre = check_attention("paged_prefill", T=P, dtype=dtype, poison=True,
                                  seed=80 + P + B, timed=bf and KERNEL_ONLY, **geo)
            dec = check_attention("paged_decode", T=1, dtype=dtype, poison=True,
                                  seed=81 + P + B, timed=bf and KERNEL_ONLY, **geo)
            if bf:
                timed[f"paged_prefill_{name}"], timed[f"paged_decode_{name}"] = pre, dec
    # the family slice (Mistral-7B, FAMILY_SERVE): the 4160-token prefill
    # over S = 4192 slots and its decode, GQA 4:1, D 128, the 4096 window
    # biting (timed in bf16, the long prefill with fewer calls); bloom-560m's
    # per-head ALiBi bias (HB = H = 16, D 64)
    for dtype in (torch.bfloat16, torch.float32):
        bf = dtype == torch.bfloat16
        geo = dict(B=8, H=32, KV=8, D=128, bs=16, S=4192, HB=1, window=4096)
        pre = check_attention("paged_prefill", T=4160, dtype=dtype, poison=True, seed=100,
                              timed=bf, timing=dict(n=4, windows=3, calls=3), **geo)
        dec = check_attention("paged_decode", T=1, dtype=dtype, poison=True, seed=101,
                              timed=bf, **geo)
        alibi_geo = dict(B=4, H=16, KV=16, D=64, bs=16, S=104, HB=16)
        check_attention("paged_prefill", T=64, dtype=dtype, poison=True, seed=102,
                        timed=bf and KERNEL_ONLY, **alibi_geo)
        check_attention("paged_decode", T=1, dtype=dtype, poison=True, seed=103,
                        timed=bf and KERNEL_ONLY, **alibi_geo)
        if bf:
            timed["paged_prefill_family"], timed["paged_decode_family"] = pre, dec
        # the family slice's PPO collections (FAMILY_TRAIN_LAYERS of the same
        # widths): a chunk's 32 slots, 64-token prompts, S = 64 + 40 new
        geo = dict(B=32, H=32, KV=8, D=128, bs=16, S=104, HB=1, window=4096)
        pre = check_attention("paged_prefill", T=64, dtype=dtype, poison=True, seed=105,
                              timed=bf and KERNEL_ONLY, **geo)
        dec = check_attention("paged_decode", T=1, dtype=dtype, poison=True, seed=106,
                              timed=bf and KERNEL_ONLY, **geo)
        if bf:
            timed["paged_prefill_family_train"], timed["paged_decode_family_train"] = pre, dec
    # the MoE slice (Mixtral-8x7B's width, MOE_SERVE): 1024-token prefills
    # over S = 1056 slots and their decode, GQA 4:1, D 128; the GRPO
    # continuous slice's engine: a 128-row refill at T = 984 (seq_length
    # 1024 − 40 new tokens) over S = 1024, GPT-2 small's heads (timed in bf16)
    for dtype in (torch.bfloat16, torch.float32):
        bf = dtype == torch.bfloat16
        geo = dict(B=8, H=32, KV=8, D=128, bs=16, S=1056, HB=1)
        pre = check_attention("paged_prefill", T=1024, dtype=dtype, poison=True, seed=110,
                              timed=bf, timing=dict(n=8, windows=3, calls=3), **geo)
        dec = check_attention("paged_decode", T=1, dtype=dtype, poison=True, seed=111,
                              timed=bf and KERNEL_ONLY, **geo)
        if bf:
            timed["paged_prefill_moe"], timed["paged_decode_moe"] = pre, dec
        # (f32 on 16 of the rows: its plain version's [B, H, T, S] scores)
        geo = dict(B=128 if bf else 16, H=12, KV=12, D=64, bs=16, S=1024, HB=1)
        pre = check_attention("paged_prefill", T=984, dtype=dtype, poison=True, seed=112,
                              timed=bf, timing=dict(n=4, windows=3, calls=3), **geo)
        dec = check_attention("paged_decode", T=1, dtype=dtype, poison=True, seed=113,
                              timed=bf and KERNEL_ONLY, **geo)
        if bf:
            timed["paged_prefill_grpo_cb"], timed["paged_decode_grpo_cb"] = pre, dec
    timed["fused_sample_grpo_cb"] = check_sample("train", "bfloat16", B=128, V=50257,
                                                 seed=114, timed=KERNEL_ONLY)
    for mode in ("served", "greedy"):
        rec = check_sample(mode, "bfloat16", B=8, V=32000, seed=104, timed=KERNEL_ONLY)
        if mode == "served":
            timed["fused_sample_family"] = rec
    timed["fused_sample_family_train"] = check_sample("train", "bfloat16", B=32, V=32000,
                                                      seed=107, timed=KERNEL_ONLY)
    # the fused sampler: every mode, B = 8 and 32 (timed on bf16-rounded
    # logits), and a 128256-wide row (llama-3's vocabulary)
    for i, mode in enumerate(SAMPLE_MODES):
        for B in (8, 32):
            for dname in ("bfloat16", "float32"):
                recorded = (mode, B) == ("topp", 8)  # the table's shape
                rec = check_sample(mode, dname, B=B, V=50257, seed=10 + i + B,
                                   timed=dname == "bfloat16" and (recorded or KERNEL_ONLY))
                if (mode, B, dname) == ("topp", 8, "bfloat16"):
                    timed["fused_sample"] = rec
    for mode in ("served", "train", "greedy"):
        check_sample(mode, "bfloat16", B=8, V=128256, seed=60, timed=KERNEL_ONLY)
    # the ILQL eval: hook-shaped f32 logits, top-k, sampled, B = 8 and 32
    for i, mode in enumerate(ILQL_SAMPLE_MODES):
        for B in (8, 32):
            rec = check_sample(mode, "ilql_f32", B=B, V=50257, seed=70 + i + B,
                               timed=KERNEL_ONLY)
            if (mode, B) == ("ilql", 32):
                timed["fused_sample_ilql"] = rec
    # the offline paths' sampler shapes: ILQL's 128 eval slots; the
    # randomwalks vocabulary of 24 (21 nodes and 3 specials) under the
    # PPO collection's unfiltered sampling (64 rows) and ILQL's top-k 10
    # (20 eval prompts)
    timed["fused_sample_ilql_128"] = check_sample("ilql", "ilql_f32", B=128, V=50257,
                                                  seed=90, timed=KERNEL_ONLY)
    for B in (64, 20):
        check_sample("train", "bfloat16", B=B, V=RANDOMWALKS_VOCAB, seed=91 + B)
    for mode in ("ilql_randomwalks", "ilql_randomwalks_t0.05"):
        check_sample(mode, "ilql_f32", B=20, V=RANDOMWALKS_VOCAB, seed=93)
    return timed


# the serving phases' #1 spans over S = 296: (name, T, first query slot)
PREFIX_SPAN_SHAPES = (("suffix_after_48", 208, 48), ("suffix_after_240", 16, 240),
                      ("chunk_at_128", 64, 128))


# the engine geometry (B, P, S, H, D) the offline paths give #1 and #2:
# SFT's eval prefills its 8 prompts left-padded to seq_length −
# max_new_tokens = 984 columns (S = 1024); ILQL's eval runs 128 slots (bos
# × batch 128) at P = 8, S = 64; the randomwalks runs collect 64 rows and
# evaluate 20 prompts on 12 heads of head dim 12, P = 8 (the prompt
# loader's width), S = 8 + 9
OFFLINE_ENGINE_SHAPES = {
    "sft": (8, 984, 1024, 12, 64),
    "ilql": (128, 8, 64, 12, 64),
    "randomwalks_collect": (64, 8, 17, 12, 12),
    "randomwalks_eval": (20, 8, 17, 12, 12),
}
RANDOMWALKS_VOCAB = 24


# head dims besides the kernels' templates: the randomwalks model's 12, 48,
# gptneox-20b's 96 and gptj-6b's 256; 320 and 512, which the CUDA-core
# kernels split into 256-column chunks (a ragged and an even last chunk)
HEAD_DIM_CHECKS = (12, 48, 96, 256, 320, 512)


# ---------------------------------------------------------------------------
# phase 4: the slice — GPT-2 small served over HTTP on the paged engine
# ---------------------------------------------------------------------------

# the f32 served path must reproduce the f32 plain path token for token; a
# divergence is tolerated only where the plain path's top-2 logit gap is
# below this (a near tie that summation order may flip)
F32_TIE_GAP = 1e-4
# bf16 serving vs the f32 plain path, teacher-forced on the served tokens:
# the served token's f32 logit may trail the f32 best by at most this.
# Sound runs on an H100 read at most 0.021 over 320 positions. The parity
# line prints the f32 top-2 gaps at the served positions: the share above
# this limit is the share of second-best substitutions it would catch
BF16_GAP_TOL = 0.05


def http_generate(port, body, meta=None):
    """POST /v1/generate; returns (status, tokens, n_tokens_reported). With
    ``meta`` (a dict), the response's ``params_version`` lands in it."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/v1/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read().decode()
    finally:
        conn.close()
    if resp.status != 200:
        return resp.status, None, None
    if not body.get("stream"):
        data = json.loads(raw)
        if meta is not None:
            meta["params_version"] = data["params_version"]
        return resp.status, data["tokens"], data["n_tokens"]
    tokens, n_done = [], None
    for event in raw.split("\n\n"):
        if not event.startswith("data: "):
            continue
        payload = json.loads(event[len("data: "):])
        if "error" in payload:
            return 500, None, None
        tokens.extend(payload.get("tokens", []))
        if payload.get("done"):
            n_done = payload["n_tokens"]
            if meta is not None:
                meta["params_version"] = payload["params_version"]
    return resp.status, tokens, n_done


def f32_gaps(model32, prompts, responses, masks=None):
    """Teacher-forced f32 logits over prompt ‖ response (left padding of
    the prompt masked by ``masks``): for each response position, (best
    logit − logit of the given token, top-2 gap)."""
    out = []
    dev = next(model32.parameters()).device
    for j, (p, r) in enumerate(zip(prompts, responses)):
        ids = torch.tensor(np.concatenate([p, r])[None], dtype=torch.int64, device=dev)
        pmask = np.ones(len(p), np.int64) if masks is None else np.asarray(masks[j], np.int64)
        mask = torch.tensor(np.concatenate([pmask, np.ones(len(r), np.int64)])[None], device=dev)
        span = (len(p) - 1, len(p) - 1 + len(r))
        with torch.no_grad():
            logits = model32(ids, attention_mask=mask, logits_span=span)["logits"][0].float()
        top2 = torch.topk(logits, 2, dim=-1).values
        given = logits.gather(1, torch.tensor(r, device=dev)[:, None])[:, 0]
        out.append(((top2[:, 0] - given).cpu().numpy(),
                    (top2[:, 0] - top2[:, 1]).cpu().numpy()))
    return out


def serve_over_http(engine, bodies, max_new, vocab, sync):
    """Start ``ServeServer`` with its HTTP frontend on ``engine``, POST
    ``bodies`` concurrently, drain and join the server's threads. Every
    response must be 200 with 1..``max_new`` in-vocabulary tokens. Returns
    (results, wall seconds, server)."""
    from concurrent.futures import ThreadPoolExecutor

    from trlx_tpu_torch.serve.server import ServeServer

    server = ServeServer(engine, max_queue=64, drain_timeout_s=120.0)
    server.start(host="127.0.0.1", port=0)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
        results = list(pool.map(lambda b: http_generate(server.port, b), bodies))
    wall = time.perf_counter() - t0
    clean = server.drain(timeout_s=60.0)
    sync()
    threads_alive = [t.name for t in (server._pump, server._http_thread) if t.is_alive()]
    if server.pump_error is not None or threads_alive or not clean:
        raise AssertionError(f"server did not stop cleanly: {server.pump_error!r} "
                             f"alive={threads_alive} clean={clean}")
    for i, (status, toks, n_rep) in enumerate(results):
        if status != 200 or toks is None or not 1 <= len(toks) <= max_new:
            raise AssertionError(f"request {i}: status {status}, tokens {toks}")
        if n_rep != len(toks) or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"request {i}: bad tokens or count ({n_rep} vs {len(toks)})")
    return results, wall, server


class ServedSlice:
    """One served configuration: the spec (with ``overrides``), the
    generation settings and the paged engine's geometry, and the request
    set — ``n_requests`` seeded prompts of ``prompt_len`` tokens, the even
    ones greedy, the odd ones sampled (top-k 50, top-p 0.95), request 0
    streamed; with ``short_len`` the requests ``i`` with ``i // 2`` odd
    are cut to their last ``short_len`` tokens, left-padded by the
    engine. ``eos`` defaults to the last token id (GPT-2's
    ``<|endoftext|>``)."""

    def __init__(self, spec, device, slots=8, block_size=16, segment_len=8, prompt_len=64,
                 max_new=40, n_requests=16, short_len=0, eos=None, **overrides):
        from trlx_tpu_torch.models.transformer import config_from_spec
        from trlx_tpu_torch.ops.paged_kv import PagedSpec, num_table_blocks
        from trlx_tpu_torch.ops.sampling import GenerationConfig

        self.spec, self.overrides, self.dev = spec, overrides, torch.device(device)
        self.slots, self.prompt_len, self.max_new = slots, prompt_len, max_new
        self.block_size, self.segment_len, self.n_requests = block_size, segment_len, n_requests
        self.vocab = V = config_from_spec(spec, **overrides).vocab_size
        eos = V - 1 if eos is None else eos
        self.gen = GenerationConfig(max_new_tokens=max_new, temperature=1.0, top_k=50,
                                    top_p=0.95, do_sample=True, eos_token_id=eos,
                                    pad_token_id=eos)
        self.paged = PagedSpec(block_size, 1 + slots * num_table_blocks(prompt_len + max_new,
                                                                        block_size) + 8)
        rs = np.random.RandomState(1234)
        self.prompts = rs.randint(0, V - 1, size=(n_requests, prompt_len))
        self.masks = np.ones_like(self.prompts)
        if short_len:
            for i in range(n_requests):
                if (i // 2) % 2:
                    self.masks[i, : prompt_len - short_len] = 0
                    self.prompts[i, : prompt_len - short_len] = eos
        self.bodies = [{"prompt_ids": self.prompts[i][self.masks[i] == 1].tolist(), "seed": i,
                        "do_sample": bool(i % 2), "stream": i == 0}
                       for i in range(n_requests)]
        self.greedy_idx = [i for i in range(n_requests) if i % 2 == 0]
        self.sync = ((lambda: torch.cuda.synchronize()) if self.dev.type == "cuda"
                     else (lambda: None))

    def build(self, **kw):
        from trlx_tpu_torch.models.builder import build_causal_lm

        return build_causal_lm(self.spec, seed=0, device=self.dev, **self.overrides, **kw)

    def engine(self, model, cfg):
        from trlx_tpu_torch.engine.core import ContinuousEngine
        from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns

        fns = make_slot_refill_fns(cfg, self.slots, self.prompt_len, self.gen,
                                   segment_len=self.segment_len, paged=self.paged,
                                   device=self.dev)
        return ContinuousEngine(fns, model, self.gen.eos_token_id)

    def serve(self, model, cfg, phase, card="", **extra):
        """The main path: warm up off the clock (the first decode segment
        pays CUDA module loading and library set-up, which no later request
        sees), set every count to 0, serve the request set over HTTP, read
        the counts. Emits ``phase``'s line; returns (results, launches,
        engine)."""
        from trlx_tpu_torch.engine.core import kernel_launches

        engine = self.engine(model, cfg)
        warm = slice(0, self.slots)
        engine.enqueue_prompts(self.prompts[warm], self.masks[warm], np.arange(self.slots))
        engine.run()
        self.sync()
        zero_launch_counts()
        engine.begin_collection()  # the engine's launch gauges count from here
        # -- the main path: HTTP requests through the server ---------------
        results, wall, server = serve_over_http(engine, self.bodies, self.max_new, self.vocab,
                                                self.sync)
        launches = kernel_launches()
        # -----------------------------------------------------------------
        st = engine.stats
        gauges = {"paged_prefill": st.prefill_kernel_launches,
                  "paged_decode": st.decode_kernel_launches,
                  "paged_verify": st.verify_kernel_launches,
                  "fused_sample": st.sample_kernel_launches}
        if gauges != launches:
            raise AssertionError(f"engine launch gauges {gauges} != wrapper counts {launches}")
        launches = {k: launches[k] for k in SERVE_KERNELS}
        # on CPU tensors the wrappers run their plain versions and count nothing
        if self.dev.type == "cuda" and min(launches.values()) <= 0:
            raise AssertionError(f"a kernel of the path never launched: {launches}")
        served = sum(len(r[1]) for r in results)
        sm = server.flat_metrics()
        emit({"phase": phase, "model": self.spec, "overrides": self.overrides,
              "dtype": str(cfg.dtype).split(".")[-1], "requests": self.n_requests,
              "slots": self.slots, "kv_block_size": self.block_size,
              "segment_len": self.segment_len, "prompt_len": self.prompt_len,
              "true_prompt_lens": sorted({int(m.sum()) for m in self.masks}),
              "max_new_tokens": self.max_new,
              "served_tokens": served, "wall_s": wall, "tokens_per_s": served / wall,
              "ttft_p50_s": sm["serve/ttft_p50"], "queue_wait_p50_s": sm["serve/queue_wait_p50"],
              "decode_segment_ms_mean": 1e3 * st.decode_s / max(st.segments, 1),
              "decode_step_ms_mean": 1e3 * st.decode_s / max(st.decode_steps, 1),
              "segments": st.segments, "refill_prefills": st.refill_prefills,
              "prefill_ms_mean": 1e3 * st.refill_s / max(st.refill_prefills, 1),
              "slot_utilization": st.slot_utilization, "launches": launches,
              "launches_per_request": {k: v / self.n_requests for k, v in launches.items()},
              "stream_tokens": len(results[0][1]), "card": card, **extra})
        return results, launches, engine

    def profile(self, engine, phase):
        """Where a served run's time goes: the request set through
        ``engine`` directly (no HTTP), once timed and once under
        ``torch.profiler``. Emits the wall time and ms per decode step of
        the timed run, the device's busy share (the union of its kernels'
        intervals over the traced run's wall time, and over the timed
        run's, since tracing slows the host and not the kernels), launches
        per decode step, device ms by group (the port's kernels, matrix
        products, the rest) and the top kernels."""
        from torch.profiler import ProfilerActivity, profile

        from trlx_tpu_torch.profile_serve import _busy_us, _group, device_events

        def run():
            engine.begin_collection()
            engine.enqueue_prompts(self.prompts, self.masks, np.arange(self.n_requests),
                                   greedy=np.arange(self.n_requests) % 2 == 0)
            self.sync()
            t0 = time.perf_counter()
            engine.run()
            self.sync()
            st = engine.stats
            return {"wall_s": time.perf_counter() - t0, "decode_steps": st.decode_steps,
                    "decode_step_ms": 1e3 * st.decode_s / max(st.decode_steps, 1),
                    "refill_prefills": st.refill_prefills,
                    "prefill_ms": 1e3 * st.refill_s / max(st.refill_prefills, 1)}

        timed = run()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced = run()
        by_name, spans = {}, []
        for evt in device_events(prof):
            spans.append((evt.time_range.start, evt.time_range.end))
            count, us = by_name.get(evt.name, (0, 0.0))
            by_name[evt.name] = (count + 1, us + evt.time_range.end - evt.time_range.start)
        busy_s = _busy_us(spans) * 1e-6
        groups = {}
        for name, (_, us) in by_name.items():
            groups[_group(name)] = groups.get(_group(name), 0.0) + us * 1e-3
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        emit({"phase": phase, "model": self.spec, "timed": timed, "traced": traced,
              "device_busy_share": busy_s / traced["wall_s"],
              "device_busy_share_untraced": busy_s / timed["wall_s"],
              "device_launches_per_decode_step": sum(c for c, _ in by_name.values())
              / max(traced["decode_steps"], 1),
              "device_ms_by_group": groups,
              "top_kernels": [{"name": n[:100], "count": c, "ms": us * 1e-3}
                              for n, (c, us) in top]})

    def plain_greedy(self, model):
        """``model``'s greedy responses to the greedy requests through the
        plain dense-cache ``generate``."""
        from trlx_tpu_torch.ops.sampling import generate

        gi = self.greedy_idx
        out = generate(model, torch.tensor(self.prompts[gi]), torch.tensor(self.masks[gi]),
                       torch.tensor(np.asarray(gi, np.int64)),
                       dataclasses.replace(self.gen, do_sample=False))
        tok, mask = out.response_tokens.cpu().numpy(), out.response_mask.cpu().numpy()
        return [tok[j][mask[j] == 1] for j in range(len(gi))]

    def parity(self, bf16_results, phase, gap_tol=BF16_GAP_TOL, model16=None):
        """Greedy parity against the plain dense-cache ``generate`` in f32:
        (a) the greedy requests served over HTTP by the same server, engine
        and kernels in f32, token for token (a divergence tolerated only at
        a near tie of the plain path's top-2 logits); (b) the bf16 served
        greedy responses ``bf16_results`` (aligned with ``greedy_idx``),
        teacher-forced in f32, within ``gap_tol`` of the f32 argmax. With
        ``model16`` (the served bf16 model) the record also prints its
        largest teacher-forced logit error against f32 on the f32 plain
        responses (the rounding that sets those gaps); it sets no limit."""
        model32, cfg32 = self.build(dtype=torch.float32)
        self.model32, self.cfg32 = model32, cfg32  # slice_family_spec reuses them
        gi = self.greedy_idx
        gp, gm = self.prompts[gi], self.masks[gi]
        plain_resp = self.plain_greedy(model32)
        served32, _, _ = serve_over_http(self.engine(model32, cfg32),
                                         [self.bodies[i] for i in gi], self.max_new,
                                         self.vocab, self.sync)
        ties = []
        for j in range(len(gi)):
            a, b = np.asarray(served32[j][1]), plain_resp[j]
            n = min(len(a), len(b))
            diff = np.nonzero(a[:n] != b[:n])[0]
            if len(diff) == 0 and len(a) == len(b):
                continue
            pos = min(int(diff[0]) if len(diff) else n, len(b) - 1)
            _, gap2 = f32_gaps(model32, [gp[j]], [b[: pos + 1]], [gm[j]])[0]
            ties.append({"request": gi[j], "position": pos, "top2_gap": float(gap2[pos])})
            if gap2[pos] >= F32_TIE_GAP:
                emit({"phase": phase, "ok": False, "f32_divergence": ties[-1]})
                raise AssertionError(f"f32 served greedy tokens diverge from plain generate: "
                                     f"{ties[-1]}")
        gaps = f32_gaps(model32, gp, [np.asarray(r[1]) for r in bf16_results], gm)
        trail = np.concatenate([g for g, _ in gaps])
        top2 = np.concatenate([g2 for _, g2 in gaps])
        worst = float(trail.max())
        envelope = {} if model16 is None else {
            "bf16_plain_logit_max_err": logit_error(model16, model32, gp, gm, plain_resp)}
        rec = {"phase": phase, "model": self.spec, "overrides": self.overrides,
               "f32_served_vs_plain_rows": len(gi),
               "f32_near_ties": ties, "f32_tie_gap_tol": F32_TIE_GAP,
               "bf16_served_positions": int(trail.size),
               "bf16_served_vs_f32_max_gap": worst, "bf16_gap_tol": gap_tol, **envelope,
               "bf16_served_f32_argmax_frac": float((trail == 0).mean()),
               "bf16_served_rows_equal_to_plain": sum(
                   int(np.array_equal(r[1], p)) for r, p in zip(bf16_results, plain_resp)),
               # how often the f32 second-best token would have broken the limit
               "f32_top2_gap_quantiles": {str(q): float(np.quantile(top2, q))
                                          for q in (0.05, 0.25, 0.5, 0.75, 0.95)},
               "f32_top2_gap_above_tol_frac": float((top2 > gap_tol).mean())}
        if worst > gap_tol:
            emit({**rec, "ok": False})
            raise AssertionError(f"bf16 served greedy tokens stray from the f32 argmax: {worst}")
        emit({**rec, "ok": True})
        return rec


def logit_error(model16, model32, prompts, masks, responses):
    """Largest |bf16 logit − f32 logit| over the response positions of
    prompt ‖ response, both models teacher-forced on the same tokens."""
    worst = 0.0
    dev = next(model32.parameters()).device
    for p, m, r in zip(prompts, masks, responses):
        ids = torch.tensor(np.concatenate([p, r])[None], dtype=torch.int64, device=dev)
        mask = torch.tensor(np.concatenate([m, np.ones(len(r), np.int64)])[None], device=dev)
        span = (len(p) - 1, len(p) - 1 + len(r))
        with torch.no_grad():
            l16, l32 = (mdl(ids, attention_mask=mask, logits_span=span)["logits"].float()
                        for mdl in (model16, model32))
        worst = max(worst, float((l16 - l32).abs().max()))
    return worst


def phase_slice(device="cuda", spec="builtin:gpt2-small", slots=8, block_size=16,
                segment_len=8, prompt_len=64, max_new=40, n_requests=16, card=""):
    sl = ServedSlice(spec, device, slots, block_size, segment_len, prompt_len, max_new,
                     n_requests)
    model, cfg = sl.build()
    results, launches, _ = sl.serve(model, cfg, "slice_serve", card)
    sl.parity([results[i] for i in sl.greedy_idx], "slice_parity")
    return launches


# ---------------------------------------------------------------------------
# phase 16: the rest of serving — the prefix cache, chunked prefill,
# priority preemption and the host tier over HTTP, and serving inside PPO
# ---------------------------------------------------------------------------

# slice_serve_prefix's geometry: GPT-2 small at full width and depth, 8
# slots, 256-token prompts (each tenant's 192-token system prompt and 64
# tokens of the request's own), 40 new tokens and no eos token (every
# request's length, hence the schedule, is fixed), 16-token blocks, chunks
# of 64, an entry cap of 40 below two tenants' chains (12 shared and 3 own
# blocks a request: 36 for 8 requests) and a 64-block host tier
PREFIX_SERVE = dict(slots=8, prompt_len=256, system_len=192, block_size=16, max_new=40,
                    prefill_chunk=64, cap_blocks=40, tier_blocks=64, segment_len=8)
# the host counters of the stream: the bf16 and the f32 run read them alike
PREFIX_COUNTERS = ("refill_prefills", "refilled_rows", "prefill_tokens", "prefill_chunk_calls",
                   "prefix_lookup_blocks", "prefix_hit_blocks", "prefix_tokens_saved",
                   "prefix_evicted_blocks", "host_tier_hit_blocks", "host_tier_tokens_saved",
                   "preempted_rows", "segments", "decode_steps", "harvested")
# behaviour logprobs of equal greedy tokens, warm (hits, chunks, re-lands)
# against a cold engine, f32 with TF32 off
PREFIX_LOGPROB_ATOL = 1e-4


def prefix_stream(vocab, geo=PREFIX_SERVE, seed=4321):
    """The 32 requests of the prefix phases, in waves ``[(requests,
    steps)]``: each request a dict of ``tenant``, ``class``, ``ids`` (the
    full prompt), ``greedy`` and ``seed``; ``steps`` the engine steps
    granted once the wave is in (None: until the engine is idle).

    1. 8 actor requests of tenant A, one step: every slot prefills its
       first chunk;
    2. 2 interactive requests of A, arriving while the actors still
       prefill: they preempt two actor slots, whose committed chunk comes
       back as a prefix hit;
    3. 8 actor requests of tenant B, one step; 4. 2 interactive ones of B
       (B's chains push A's out of the capped cache, into the host tier);
    5. 6 new actor requests of A, three steps (their prefill, then they
       decode): A's system prompt re-lands from the tier;
    6. 6 exact repeats (3 of wave 5, 3 of wave 3), arriving while wave 5
       decodes: a whole-prompt hit, capped one block short, leaves a
       16-token suffix, whose prefill stalls the decoding rows.

    Even requests decode greedily, odd ones sample."""
    rs = np.random.RandomState(seed)
    P, L = geo["prompt_len"], geo["system_len"]
    system = {t: rs.randint(0, vocab - 1, L) for t in ("A", "B")}
    made = []

    def req(tenant, klass, ids=None):
        if ids is None:
            ids = np.concatenate([system[tenant], rs.randint(0, vocab - 1, P - L)])
        made.append({"tenant": tenant, "class": klass, "ids": ids,
                     "greedy": len(made) % 2 == 0, "seed": len(made)})
        return made[-1]

    w1 = [req("A", "actor") for _ in range(8)]
    w2 = [req("A", "interactive") for _ in range(2)]
    w3 = [req("B", "actor") for _ in range(8)]
    w4 = [req("B", "interactive") for _ in range(2)]
    w5 = [req("A", "actor") for _ in range(6)]
    w6 = [req(r["tenant"], "actor", r["ids"]) for r in w5[:3] + w3[:3]]
    return [(w1, 1), (w2, None), (w3, 1), (w4, None), (w5, 3), (w6, None)]


class GatedEngine:
    """A ``ContinuousEngine`` behind a gate: the serve pump sees it busy,
    and steps it, only while the gate grants steps. A wave of requests is
    all in the engine before the step that must see it, whatever the HTTP
    handlers' timing, so a stream's schedule (and every host counter) is
    the same on every run. Everything else is the engine's."""

    def __init__(self, engine):
        self._engine = engine
        self._cv = threading.Condition()
        self._grant = 0  # steps left; -1: until the engine is idle
        self.completed = []

    def __getattr__(self, name):
        return getattr(self._engine, name)

    @property
    def busy(self):
        with self._cv:
            return self._engine.busy and self._grant != 0

    def step(self):
        out = self._engine.step()
        with self._cv:
            self.completed.extend(out)
            if self._grant > 0:
                self._grant -= 1
            self._cv.notify_all()
        return out

    def run_granted(self, steps, timeout=600.0):
        """Grant ``steps`` (None: until idle) and wait for them."""
        deadline = time.monotonic() + timeout
        with self._cv:
            self._grant = -1 if steps is None else steps
            while self._grant > 0 or (self._grant == -1 and self._engine.busy):
                if not self._cv.wait(max(deadline - time.monotonic(), 0.0)):
                    raise TimeoutError(f"granted steps did not run: {self._grant}")
            self._grant = 0


def serve_prefix_stream(engine, waves, max_new, sync):
    """Serve ``waves`` over HTTP through ``ServeServer`` on ``engine``
    behind a :class:`GatedEngine`: each request POSTed on its own thread
    once the one before it is in the engine (request 0 streamed), then
    the wave's steps granted. Returns (HTTP results by request, completed
    sequences by request, server, wall seconds)."""
    from trlx_tpu_torch.serve.server import ServeServer

    gated = GatedEngine(engine)
    server = ServeServer(gated, max_queue=64, drain_timeout_s=120.0)
    server.start(host="127.0.0.1", port=0)
    base, results, threads = engine._submitted, {}, []
    t0 = time.perf_counter()
    try:
        for requests, steps in waves:
            for r in requests:
                i = len(threads)
                body = {"prompt_ids": r["ids"].tolist(), "tenant": r["tenant"],
                        "class": r["class"], "seed": r["seed"], "do_sample": not r["greedy"],
                        "stream": i == 0}
                th = threading.Thread(
                    target=lambda i=i, b=body: results.__setitem__(
                        i, http_generate(server.port, b)), name=f"prefix-client-{i}")
                th.start()
                threads.append(th)
                deadline = time.monotonic() + 60
                while engine._submitted < base + i + 1:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"request {i} never reached the engine")
                    time.sleep(0.0005)
            gated.run_granted(steps)
        for th in threads:
            th.join(timeout=300)
    finally:
        clean = server.drain(timeout_s=60.0)
    sync()
    wall = time.perf_counter() - t0
    alive = [t.name for t in (server._pump, server._http_thread) if t.is_alive()]
    if server.pump_error is not None or alive or not clean:
        raise AssertionError(f"server did not stop cleanly: {server.pump_error!r} "
                             f"alive={alive} clean={clean}")
    for i in range(len(threads)):
        status, toks, n_rep = results.get(i, (None, None, None))
        if status != 200 or toks is None or len(toks) != max_new or n_rep != max_new:
            raise AssertionError(f"request {i}: status {status}, tokens {toks}")
    completed = {c.index - base: c for c in gated.completed}
    return results, completed, server, wall


def recording_tier(max_blocks, block_bytes):
    """A ``HostTier`` that keeps a device copy of every spilled block and
    holds each re-landed block to it, bitwise (``checked``, ``unequal``)."""
    from trlx_tpu_torch.serve.tiering import HostTier

    class _Recording(HostTier):
        def __init__(self):
            super().__init__(max_blocks, block_bytes=block_bytes)
            self.copies, self.checked, self.unequal = {}, 0, 0

        def spill(self, digest, pool, block):
            if digest not in self:
                self.copies[digest] = [{n: layer[n][block].clone() for n in ("k", "v")}
                                       for layer in pool]
            super().spill(digest, pool, block)

        def reland_many(self, digests, pool, blocks):
            out = super().reland_many(digests, pool, blocks)
            for d, b in zip(digests, blocks):
                same = all(torch.equal(layer[n][b], saved[n])
                           for layer, saved in zip(pool, self.copies[d]) for n in ("k", "v"))
                self.checked += 1
                self.unequal += not same
            return out

    return _Recording()


def prefix_engine(model, cfg, dev, geo=PREFIX_SERVE, prefix=True, tier=None, sample=True):
    """The prefix phases' engine: ``geo``'s slots, prompt width, blocks,
    chunks, entry cap and (``tier``) host tier; no eos token."""
    from trlx_tpu_torch.engine.core import ContinuousEngine
    from trlx_tpu_torch.ops.paged_kv import PagedSpec, num_table_blocks
    from trlx_tpu_torch.ops.sampling import GenerationConfig
    from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns

    P, N, bs = geo["prompt_len"], geo["max_new"], geo["block_size"]
    gen = GenerationConfig(max_new_tokens=N, temperature=1.0, top_k=50, top_p=0.95,
                           do_sample=sample, eos_token_id=None,
                           pad_token_id=cfg.vocab_size - 1)
    paged = PagedSpec(bs, 1 + 2 * geo["slots"] * num_table_blocks(P + N, bs) + 8)
    fns = make_slot_refill_fns(cfg, geo["slots"], P, gen, segment_len=geo["segment_len"],
                               paged=paged, device=dev)
    engine = ContinuousEngine(fns, model, gen.pad_token_id, prefix_cache=prefix,
                              prefix_capacity_blocks=geo["cap_blocks"] if prefix else 0,
                              prefill_chunk=geo["prefill_chunk"] if prefix else 0)
    if tier is not None:
        engine.attach_host_tier(tier)
    return engine, gen


def record_hits(engine):
    """Each request's final prefix hit in columns (a preempted request is
    prepared again on re-admission), by engine submission index."""
    hits, prepare = {}, engine._prepare_row

    def recorded(req, slot):
        hits[req.index] = prepare(req, slot)
        return hits[req.index]

    engine._prepare_row = recorded
    return hits


def phase_slice_serve_prefix(device="cuda", spec="builtin:gpt2-small", geo=PREFIX_SERVE,
                             card="", dtype=None, phase="slice_serve_prefix", tier_cls=None,
                             overrides=None):
    """The prefix cache, chunked prefill, priority preemption and the host
    tier on the served path (bf16): :func:`prefix_stream`'s 32 requests
    over HTTP through ``ServeServer`` on one engine (:func:`prefix_engine`,
    its tier ``geo["tier_blocks"]`` blocks), the kernel counters set to 0
    just before the engine is built and read after the server drained.
    Prints TTFT p50 of cold (no hit) and warm requests (to the prefill that
    seeds the first token; a wave's submission time included), decode ms a
    step, the prefix, tier, chunk, preemption and decode-stall gauges. Fails
    unless prefix hits, tier hits and preemptions are all > 0, every
    request got its 40 tokens, and on the card #1–#3 launched, as often as
    the engine's gauges plus its prewarm say. ``overrides`` (a CPU
    rehearsal's smaller widths) go to the model's config. Returns
    (launches, the run)."""
    from trlx_tpu_torch.engine.core import kernel_launches
    from trlx_tpu_torch.models.builder import build_causal_lm
    from trlx_tpu_torch.ops.paged_kv import block_bytes
    from trlx_tpu_torch.serve.tiering import HostTier

    dev = torch.device(device)
    extra = dict(overrides or {}, **({} if dtype is None else {"dtype": dtype}))
    model, cfg = build_causal_lm(spec, seed=0, device=dev, **extra)
    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" else (lambda: None)
    waves = prefix_stream(cfg.vocab_size, geo)
    sync()
    zero_launch_counts()
    engine, _ = prefix_engine(model, cfg, dev, geo)
    make_tier = tier_cls or (lambda n, b: HostTier(n, block_bytes=b))
    tier = make_tier(geo["tier_blocks"], block_bytes(engine.state.cache))
    engine.attach_host_tier(tier)
    engine.begin_collection()
    hits = record_hits(engine)
    # -- the main path: HTTP requests through the server ------------------
    results, completed, server, wall = serve_prefix_stream(engine, waves, geo["max_new"], sync)
    launches = kernel_launches()
    # ---------------------------------------------------------------------
    st = engine.stats
    gauges = {"paged_prefill": st.prefill_kernel_launches,
              "paged_decode": st.decode_kernel_launches,
              "paged_verify": st.verify_kernel_launches,
              "fused_sample": st.sample_kernel_launches}
    expected = {k: gauges[k] + engine.prewarm_launches[k] for k in gauges}
    problems = []
    if launches != expected:
        problems.append(f"launches {launches} != gauges + prewarm {expected}")
    launches = {k: launches[k] for k in SERVE_KERNELS}
    if dev.type == "cuda" and min(launches.values()) <= 0:
        problems.append(f"a kernel of the path never launched: {launches}")
    counters = {k: getattr(st, k) for k in PREFIX_COUNTERS}
    for name in ("prefix_hit_blocks", "host_tier_hit_blocks", "preempted_rows",
                 "prefill_chunk_calls"):
        if counters[name] <= 0:
            problems.append(f"{name} is {counters[name]}")
    ttft = {i: c.t_prefill1 - c.t_enqueue for i, c in completed.items()}
    cold = [ttft[i] for i in ttft if hits.get(i, 0) == 0]
    warm = [ttft[i] for i in ttft if hits.get(i, 0) > 0]
    snap, sm, m = tier.snapshot(), server.flat_metrics(), st.metrics()
    rec = {"phase": phase, "model": spec, "dtype": str(cfg.dtype).split(".")[-1],
           "geometry": geo, "requests": len(completed), "wall_s": wall,
           "requests_by_hit_columns": {str(h): sum(1 for v in hits.values() if v == h)
                                       for h in sorted(set(hits.values()))},
           "served_tokens": sum(len(r[1]) for r in results.values()),
           "ttft_p50_cold_s": float(np.median(cold)) if cold else None,
           "ttft_p50_warm_s": float(np.median(warm)) if warm else None,
           "cold_requests": len(cold), "warm_requests": len(warm),
           "serve_ttft_p50_s": sm["serve/ttft_p50"],
           "decode_step_ms_mean": 1e3 * st.decode_s / max(st.decode_steps, 1),
           "prefix_hit_rate": m["engine/prefix_hit_rate"],
           "prefix_tokens_saved": m["engine/prefix_tokens_saved"],
           "host_tier_hit_blocks": m["engine/host_tier_hit_blocks"],
           "spilled_blocks": snap["spilled"], "tier": snap,
           "preempted_rows": st.preempted_rows,
           "decode_stall_s": {q: m[f"rollout/decode_stall_{q}"] for q in ("p50", "p95", "max")},
           "counters": counters, "launches": launches, "card": card}
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"{phase}: {problems}")
    return launches, {"counters": counters, "results": results, "completed": completed,
                      "waves": waves, "engine": engine, "model": model, "cfg": cfg,
                      "tier": tier}


def phase_slice_serve_prefix_parity(reference, device="cuda", spec="builtin:gpt2-small",
                                    geo=PREFIX_SERVE, card="", overrides=None):
    """In f32 with TF32 off, the same stream as ``slice_serve_prefix``
    (``reference``: its return) on the same path: (a) the greedy answers
    with the cache, chunks and tier equal a cold engine's (no cache, no
    chunks) and the plain ``generate``'s token for token (a divergence
    tolerated only at a near tie of the plain path's top-2 logits), their
    behaviour logprobs within ``PREFIX_LOGPROB_ATOL`` of the cold engine's;
    (b) every spilled-then-re-landed block bitwise the spilled one; (c) the
    host counters equal ``slice_serve_prefix``'s."""
    from trlx_tpu_torch.ops.sampling import generate

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    _, run = phase_slice_serve_prefix(
        device, spec, geo, card, dtype=torch.float32, phase="slice_serve_prefix_f32",
        tier_cls=recording_tier, overrides=overrides)
    model, cfg, completed, tier = run["model"], run["cfg"], run["completed"], run["tier"]
    requests = [r for wave, _ in run["waves"] for r in wave]
    greedy = [i for i, r in enumerate(requests) if r["greedy"]]
    prompts = np.stack([requests[i]["ids"] for i in greedy])
    masks = np.ones_like(prompts)
    warm = [completed[i].tokens[completed[i].mask == 1] for i in greedy]
    cold_engine, gen = prefix_engine(model, cfg, dev, geo, prefix=False)
    cold_engine.enqueue_prompts(prompts, masks, np.asarray(greedy),
                                greedy=np.ones(len(greedy), bool))
    cold_done = {c.index: c for c in cold_engine.run()}
    cold = [cold_done[j] for j in range(len(greedy))]
    out = generate(model, torch.tensor(prompts), torch.tensor(masks),
                   torch.tensor(np.asarray(greedy, np.int64)),
                   dataclasses.replace(gen, do_sample=False))
    tok, msk = out.response_tokens.cpu().numpy(), out.response_mask.cpu().numpy()
    plain = [tok[j][msk[j] == 1] for j in range(len(greedy))]
    problems, report = [], {}
    for name, want in (("cold_engine", [c.tokens[c.mask == 1] for c in cold]),
                       ("plain_generate", plain)):
        div = greedy_divergences(model, prompts, masks, warm, want)
        report[name] = div
        problems += [f"{name}: request {greedy[d['row']]} diverges at {d['position']} "
                     f"(top-2 gap {d['top2_gap']})" for d in div if d["top2_gap"] >= F32_TIE_GAP]
    worst = 0.0
    for j, i in enumerate(greedy):
        if np.array_equal(completed[i].tokens, cold[j].tokens):
            worst = max(worst, float(np.abs(completed[i].logprobs - cold[j].logprobs).max()))
    if not worst <= PREFIX_LOGPROB_ATOL:
        problems.append(f"warm against cold logprobs differ by {worst}")
    if tier.checked <= 0 or tier.unequal:
        problems.append(f"re-landed blocks: {tier.checked} checked, {tier.unequal} unequal")
    ref = reference["counters"]
    if run["counters"] != ref:
        problems.append(f"host counters {run['counters']} != slice_serve_prefix's {ref}")
    rec = {"phase": "slice_serve_prefix_parity", "model": spec, "dtype": "float32",
           "tf32": False, "greedy_requests": len(greedy), "divergences": report,
           "f32_tie_gap_tol": F32_TIE_GAP, "warm_vs_cold_logprob_max_abs_diff": worst,
           "logprob_atol": PREFIX_LOGPROB_ATOL, "relanded_blocks_checked": tier.checked,
           "relanded_blocks_unequal": tier.unequal, "counters": run["counters"],
           "counters_equal": run["counters"] == ref, "card": card}
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"slice_serve_prefix_parity: {problems}")
    zero_launch_counts()
    return rec


# slice_serve_train: PPO on default_ppo_config() on the continuous path
# with serving inside learn(), 8 steps, 8 streamed greedy requests
SERVE_TRAIN_STEPS, SERVE_TRAIN_REQUESTS = 8, 8
SERVE_TRAIN_KERNELS = SERVE_KERNELS + ("flash_fwd", "flash_bwd")


def phase_slice_serve_train(device="cuda", spec="builtin:gpt2-small", card="",
                            total_steps=SERVE_TRAIN_STEPS, n_requests=SERVE_TRAIN_REQUESTS,
                            n_prompts=None, sections=None):
    """Serving inside PPO's ``learn()``: ``trlx_tpu_torch.train`` on
    ``default_ppo_config()`` with ``train.continuous_batching``, the paged
    engine and its kernels, ``engine.prefix_cache``, ``prefill_chunk`` 32
    and ``serve.enabled`` (2 slots, ``retain_param_versions`` 4), f32 with
    TF32 off, ``total_steps`` updates, ``request_flood@step:4``. A client
    thread streams ``n_requests`` greedy interactive requests through the
    running server, one at each of an even spread of step boundaries, and
    keeps the weights of the version each answer is stamped with
    (``params_for_version``, while retained). The harness paces
    ``learn()`` so that the answers spread over the run: at a request's
    step boundary, after the weights are published, the next update waits
    (at most 120 s, outside the step's timer) for the answer, since on the
    card eight updates take about a second. After ``learn()`` each
    answer must equal a solo plain ``generate`` under its version's
    weights (the near-tie rule), the drill must have shed load with 429s,
    no serve thread may be alive, and #1–#3 and #5/#6 must have launched.
    Prints step ms and the served requests' TTFT p50. Returns the
    launches."""
    import shutil

    import trlx_tpu_torch
    from trlx_tpu_torch.ops.sampling import generate
    from trlx_tpu_torch.profile_train import reward_fn, slice_prompts

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ckpt = _scratch_dir("slice_serve_train")
    sections = {k: dict(v) for k, v in (sections or {}).items()}
    for name, values in (
            ("train", dict(continuous_batching=True)),
            ("engine", dict(backend="paged", decode_kernel="pallas", prefill_kernel="pallas",
                            prefix_cache=True, prefill_chunk=32)),
            ("serve", dict(enabled=True, slots=2, retain_param_versions=4,
                           drain_timeout_s=120.0)),
            ("parallel", dict(compute_dtype="float32")),
            ("resilience", dict(fault_plan="request_flood@step:4"))):
        sections[name] = {**values, **sections.get(name, {})}
    config = serial_config(ckpt, spec, total_steps, total_steps, **sections)
    prompt = np.random.RandomState(77).randint(0, 50000, 48)
    boundaries = [k * total_steps // n_requests for k in range(n_requests)]
    answered = {b: threading.Event() for b in boundaries}
    state = {"server": None, "requests": [], "weights": {}, "error": None}

    def client(trainer):
        try:
            deadline = time.monotonic() + 600
            while trainer._serve is None or not trainer._serve.port:
                if time.monotonic() > deadline:
                    raise TimeoutError("the serving frontend never came up")
                time.sleep(0.002)
            server = state["server"] = trainer._serve
            for b in boundaries:
                # version b is published at the boundary before update b + 1
                while (server.params_for_version(b) is None and trainer._serve is not None
                       and trainer.iter_count <= b):
                    time.sleep(0.002)
                req, rejection = server.submit(prompt, klass="interactive", stream=True,
                                               greedy=True)
                if req is None:
                    raise AssertionError(f"request at step {b} rejected: {rejection}")
                state["requests"].append(req)
                req.wait_done(timeout=300)
                version = req.snapshot()["params_version"]
                if version not in state["weights"]:
                    state["weights"][version] = server.params_for_version(version)
                answered[b].set()
        except BaseException as e:  # noqa: BLE001 — re-raised by the phase
            state["error"] = e
        finally:
            for event in answered.values():
                event.set()

    threads = []

    def hook(trainer):
        boundary = trainer._check_faults_and_preemption

        def paced():
            boundary()  # publishes the version the next request is served under
            if trainer.iter_count in answered:
                answered[trainer.iter_count].wait(timeout=120)

        trainer._check_faults_and_preemption = paced
        threads.append(threading.Thread(target=client, args=(trainer,),
                                        name="serve-train-client", daemon=True))
        threads[0].start()

    if dev.type == "cuda":
        torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    try:
        trainer = trlx_tpu_torch.train(reward_fn=reward_fn,
                                       prompts=slice_prompts(n_prompts or SERIAL_PROMPTS),
                                       config=config, device=dev, init_trainer_hook=hook)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    threads[0].join(timeout=300)
    if state["error"] is not None:
        raise state["error"]
    server, problems = state["server"], []
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("trlx-serve") and t.is_alive()]
    if alive or trainer._serve is not None or not server.admission.draining:
        problems.append(f"serving was not drained: alive {alive}")
    gen, _ = trainer._resolve_gen_config(eval_mode=True,
                                         max_new_tokens=int(config.serve.max_new_tokens))
    gen = dataclasses.replace(gen, do_sample=False)
    P = config.train.seq_length - gen.max_new_tokens
    ids = np.full((1, P), trainer.tokenizer.pad_token_id, np.int64)
    mask = np.zeros((1, P), np.int64)
    ids[0, -len(prompt):], mask[0, -len(prompt):] = prompt, 1
    checked, versions = [], []
    for k, req in enumerate(state["requests"]):
        streamed = []
        while True:
            kind, payload = req.next_event(timeout=1.0)
            if kind == "tokens":
                streamed.extend(int(t) for t in payload)
            elif kind != "pending":
                break
        snap = req.snapshot()
        version = snap["params_version"]
        weights = state["weights"].get(version)
        if snap["state"] != "DONE" or streamed != [int(t) for t in req.result_tokens]:
            problems.append(f"request {k}: {snap['state']}, streamed {len(streamed)} tokens")
            continue
        if weights is None:
            problems.append(f"request {k}: version {version}'s weights were not kept")
            continue
        versions.append(version)
        out = generate(weights, torch.tensor(ids), torch.tensor(mask),
                       torch.zeros(1, dtype=torch.int64), gen)
        want = out.response_tokens[0][out.response_mask[0] == 1].cpu().numpy()
        div = greedy_divergences(weights, ids, mask, [np.asarray(streamed)], [want])
        checked.append({"request": k, "version": version, "tokens": len(streamed),
                        "ttft_s": snap["ttft_s"], "divergences": div})
        problems += [f"request {k} (version {version}) diverges at {d['position']} "
                     f"(gap {d['top2_gap']})" for d in div if d["top2_gap"] >= F32_TIE_GAP]
    if len(versions) != n_requests or len(set(versions)) < 2:
        problems.append(f"answers' versions {versions} of {n_requests} requests")
    sm = server.flat_metrics()
    if not sm["serve/flood_rejected"] > 0:
        problems.append(f"the request_flood drill shed nothing: {sm['serve/flood_rejected']}")
    launches = {k: launches[k] for k in REPLACES}
    if dev.type == "cuda" and min(launches[k] for k in SERVE_TRAIN_KERNELS) <= 0:
        problems.append(f"a kernel of the path never launched: {launches}")
    steps = [st["time/step"] for _, st in trainer.tracker.history if "time/step" in st]
    rec = {"phase": "slice_serve_train", "model": spec, "dtype": "float32", "tf32": False,
           "steps": trainer.iter_count, "wall_s": wall,
           "step_ms_median": 1e3 * float(np.median(steps)) if steps else None,
           "step_ms": [1e3 * s for s in steps], "answers": checked,
           "versions_kept": sorted(v for v, w in state["weights"].items() if w is not None),
           "served_ttft_p50_s": sm["serve/ttft_p50"], "flood_rejected": sm["serve/flood_rejected"],
           "launches": launches, "card": card}
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"slice_serve_train: {problems}")
    return launches


# the family slice: Mistral-7B (mistralai/Mistral-7B-v0.1 config.json: the
# JAX preset's widths) served with prompts that cross its 4096 window
FAMILY_SPEC = "builtin:mistral-7b"
# served at 1 of its 32 layers: with the GRPO and MoE phases the full
# depth took the script to 896 s of phases (the limit is 800), 8 layers
# with the preference phases 880 s, 4 with the T5 phases 886 s, 2 with
# the serving phases 820 s on a slow host
FAMILY_SERVE_LAYERS = 1
FAMILY_SERVE = dict(slots=8, prompt_len=4160, max_new=32, n_requests=16, short_len=512, eos=2)
# the parity and PPO runs of the family slice at full width, cut in depth:
# two f32 7B copies and the KV pool exceed 80 GB, Adam over a full-depth 7B
# exceeds one card; the parity at one layer (two until the GRPO and MoE
# phases came), the PPO run at one (two until the serving phases came; its
# hydra branch replays that block)
FAMILY_PARITY_LAYERS = 1
# bf16 serving at this width against f32 (parity (b)): the JAX module's own
# bf16 pass at 4 layers of these widths, on the CPU over 2048 positions
# (tests/torch_family_bf16_reading.py), trails f32 by up to 0.196, its
# 99.9th percentile 0.136; the parity reads 256 positions
FAMILY_BF16_GAP_TOL = 0.15
FAMILY_TRAIN_LAYERS = 1


def phase_family_serve(device="cuda", spec=FAMILY_SPEC, card="", layers=FAMILY_SERVE_LAYERS,
                       **kw):
    """Mistral-7B at full width, ``layers`` deep, on the paged engine behind
    the HTTP frontend; beside the served run, the build's seconds, what two
    costs of this path take on the card — the per-call f32→bf16 cast of
    every projection weight (``_linear``, once per forward) and the
    prefill's ``[B, 1, T, S]`` f32 bias — and, after it, a profile of the
    same requests (:meth:`ServedSlice.profile`). Returns the launches."""
    from trlx_tpu_torch.models.transformer import _query_slots, attention_bias

    sl = ServedSlice(spec, device, **{**FAMILY_SERVE, **kw}, num_layers=layers)
    t0 = time.perf_counter()
    model, cfg = sl.build()
    extra = {"build_s": time.perf_counter() - t0, "layers": layers}  # host draws
    if sl.dev.type == "cuda":
        weights = [m.weight for m in model.modules() if isinstance(m, torch.nn.Linear)]

        def cast_all():
            for w in weights:
                w.to(cfg.dtype)

        extra["cast_weights_gb"] = sum(w.numel() for w in weights) * 6 / 1e9  # read f32, write bf16
        extra["cast_weights_ms"], _ = time_ms(cast_all, n=3, windows=3, calls=3)
        B, T = sl.slots, sl.prompt_len
        mask = torch.ones((B, T + sl.max_new), dtype=torch.int64, device=sl.dev)
        slots = _query_slots(0, B, T, sl.dev)
        extra["prefill_bias_gb"] = B * T * (T + sl.max_new) * 4 / 1e9
        extra["prefill_bias_ms"], _ = time_ms(
            lambda: attention_bias(mask, slots, window=cfg.sliding_window), n=3, windows=3,
            calls=3)
    _, launches, engine = sl.serve(model, cfg, "slice_family_serve", card, **extra)
    if sl.dev.type == "cuda":
        sl.profile(engine, "slice_family_profile")
    return launches


def phase_family_parity(device="cuda", spec=FAMILY_SPEC, layers=FAMILY_PARITY_LAYERS,
                        keep=False, **kw):
    """The family slice's requests at ``layers`` layers (full width): the
    greedy ones served in bf16, then the f32 parity of
    :meth:`ServedSlice.parity` with (b) held to ``FAMILY_BF16_GAP_TOL``.
    With ``keep``, returns the served model and its config too
    (``slice_hf``'s (b) writes it as a checkpoint), and the parity's f32
    model and config (``slice_family_spec`` speculates on it)."""
    sl = ServedSlice(spec, device, **{**FAMILY_SERVE, **kw}, num_layers=layers)
    model, cfg = sl.build()
    results, _, _ = serve_over_http(sl.engine(model, cfg), [sl.bodies[i] for i in sl.greedy_idx],
                                    sl.max_new, sl.vocab, sl.sync)
    rec = sl.parity(results, "slice_family_parity", gap_tol=FAMILY_BF16_GAP_TOL, model16=model)
    zero_launch_counts()
    return (rec, model, cfg, sl.model32, sl.cfg32) if keep else rec


# ---------------------------------------------------------------------------
# phase 5: the training kernels against their plain versions
# ---------------------------------------------------------------------------

# (atol, rtol) per tensor and type. f32: summation order only (up to 1024
# terms per sum). bf16: the kernel reads bf16 and accumulates in f32; it is
# held against the plain version run in f32 on the same (upcast) inputs,
# so the difference is the rounding of the bf16 outputs.
FLASH_TOL = {
    torch.float32: {"out": (1e-4, 0.0), "lse": (1e-4, 0.0), "grad": (1e-3, 1e-4)},
    torch.bfloat16: {"out": (2e-2, 0.0), "lse": (1e-3, 0.0), "grad": (2e-2, 1e-2)},
}
# fused loss, f32 in both: reduction order differs
LOSS_RTOL, LOSS_ATOL, LOSS_GRAD_ATOL = 1e-4, 1e-6, 1e-7


def excess(got, want, atol, rtol):
    """Largest amount by which |got - want| exceeds atol + rtol |want|
    (≤ 0 passes), and the max abs error."""
    got, want = got.float(), want.float()
    err = torch.nan_to_num((got - want).abs(), nan=float("inf"))  # NaN fails
    return float((err - atol - rtol * want.abs()).max()), float(err.max())


# the offline trainers' flash calls: DialogStore and ilql_collate pad on
# the right, so each row's keys end early and the queries past a row's end
# still see its valid keys (causal). (B, T, H, D), T = S, KV = H: SFT's
# training shape (GPT-2 small at seq_length 1024, batch 8), ILQL's (batch
# 128 at seq_length 64) and ilql_randomwalks' (batch 32 at seq_length 11,
# head dim 12); the gpu tests share these
RIGHT_PAD_FLASH_SHAPES = [(8, 1024, 12, 64), (128, 64, 12, 64), (32, 11, 12, 12)]
# the preference paths' flash calls, right-padded, T = S: (B, T, H, KV, D,
# window). DPO's batch of 16 pairs (32 rows of prompt ‖ completion: the
# task's triples pad to 64 or 72 bytes) at GPT-2 small's width, the reward
# model's 8 pairs (16 rows padded to max_length 256, at most 110 real),
# DPO + LoRA's 16 pairs at Mistral-7B's width; the gpu tests share these
PREFERENCE_FLASH_SHAPES = {"dpo": (32, 72, 12, 12, 64, 0), "reward": (16, 256, 12, 12, 64, 0),
                           "dpo_lora": (32, 72, 32, 8, 128, 4096)}


def right_pad_mask(B, S, seed):
    """[B, S] f32 key mask padded on the right: row 0 full, row 1 one
    token long, the others of random lengths in [S / 4, S)."""
    rs = np.random.RandomState(seed)
    lengths = [S, 1] + list(rs.randint(max(S // 4, 1), S, size=max(B - 2, 0)))
    mask = np.zeros((B, S), np.float32)
    for b, n in enumerate(lengths[:B]):
        mask[b, :n] = 1.0
    return mask


def flash_case_inputs(rs, B, T, S, H, KV, D, dtype, dev, left_pad, alibi, q_offset,
                      dead_keys, right_pad=False, seed=0):
    """q, k, v, key mask (random left padding per row, or with
    ``right_pad`` the offline batches' right padding of ``right_pad_mask``;
    ``dead_keys`` masks a key range
    of row 0 so that some of its queries see no key), ALiBi positions and
    slopes, the output cotangent."""
    mask = np.ones((B, S), np.float32)
    if right_pad:
        mask = right_pad_mask(B, S, seed)
    elif left_pad:
        for b in range(B):
            mask[b, : rs.randint(0, max(S // 4, 1))] = 0.0
    if dead_keys:
        mask[0, dead_keys[0]:dead_keys[1]] = 0.0
    randn = device_randn(rs, dev)
    q, k, v, do = (randn(*shape).to(dtype)
                   for shape in ((B, T, H, D), (B, S, KV, D), (B, S, KV, D), (B, T, H, D)))
    alibi_args = [None, None, None]
    if alibi:
        kpos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
        qpos = (np.arange(T, dtype=np.int32)[None].repeat(B, 0) + q_offset)
        slopes = (2.0 ** (-8.0 * np.arange(1, H + 1) / H)).astype(np.float32)
        alibi_args = [torch.tensor(x, device=dev) for x in (qpos, kpos, slopes)]
    return q, k, v, torch.tensor(mask, device=dev), alibi_args, do


def flash_visible_pairs(mask, T, S, causal, q_offset, window):
    """(query, key) pairs visible per head, summed over the batch, and the
    boolean [B, 1, T, S] visibility."""
    qs = torch.arange(T, device=mask.device)[:, None] + q_offset
    ks = torch.arange(S, device=mask.device)[None, :]
    vis = (mask > 0.5)[:, None, None, :]
    if causal:
        vis = vis & (ks <= qs)
    if window:
        vis = vis & (qs - ks < window)
    return int(vis.sum()), vis


def check_flash(label, B, T, S, H, KV, D, dtype, seed, causal=True, q_offset=0, window=0,
                alibi=False, left_pad=True, dead_keys=None, right_pad=False, timed=False):
    """Kernels #5 and #6 against their plain versions: out, lse, dq, dk,
    dv. With ``timed``: kernel, plain and library times and the bound."""
    from trlx_tpu_torch.ops.flash_attention import (
        flash_bwd,
        flash_bwd_reference,
        flash_fwd,
        flash_fwd_reference,
    )

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    rs = np.random.RandomState(seed)
    q, k, v, mask, alibi_args, do = flash_case_inputs(
        rs, B, T, S, H, KV, D, dtype, dev, left_pad, alibi, q_offset, dead_keys,
        right_pad, seed)
    kw = dict(sm_scale=D ** -0.5, causal=causal, q_offset=q_offset, k_offset=0, window=window)
    before = (flash_fwd.launches, flash_bwd.launches)
    out, lse = flash_fwd(q, k, v, mask, *alibi_args, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    grads = flash_bwd(q, k, v, mask, *alibi_args, lse, delta, do, **kw)
    torch.cuda.synchronize()
    f32 = [x.float() for x in (q, k, v)]
    want, want_lse = flash_fwd_reference(*f32, mask, *alibi_args, **kw)
    wgrads = flash_bwd_reference(*f32, mask, *alibi_args, lse, delta, do.float(), **kw)
    tol = FLASH_TOL[dtype]
    worst, max_err, report = -1.0, 0.0, {}
    for name, got, w, t in (("out", out, want, "out"), ("lse", lse, want_lse, "lse"),
                            ("dq", grads[0], wgrads[0], "grad"),
                            ("dk", grads[1], wgrads[1], "grad"),
                            ("dv", grads[2], wgrads[2], "grad")):
        ex, err = excess(got, w, *tol[t])
        report[name] = err
        worst, max_err = max(worst, ex), max(max_err, err)
    dead_rows = int((lse <= -1e29).sum())
    pairs, vis = flash_visible_pairs(mask, T, S, causal, q_offset, window)
    rec = {"phase": "kernel_check", "kernel": "flash_fwd+flash_bwd", "case": label,
           "dtype": str(dtype).split(".")[-1], "B": B, "T": T, "S": S, "H": H, "KV": KV,
           "D": D, "q_offset": q_offset, "window": window, "alibi": alibi,
           "padding": "right" if right_pad else "left" if left_pad else "none",
           "fully_masked_rows": dead_rows, "max_abs_err": report, "tol": tol}
    if not math.isfinite(max_err) or worst > 0:
        emit({**rec, "ok": False})
        raise AssertionError(f"flash {label} {dtype} disagrees with its plain version: {report}")
    if timed:
        elem = torch.finfo(dtype).bits // 8
        io = elem * (2 * B * T * H * D + 2 * B * S * KV * D)
        fwd_bytes = io + 4 * B * S + 4 * B * H * T
        bwd_bytes = 2 * io + 8 * B * H * T + 4 * B * S
        full = timed is True
        rec["fwd"] = timed_pair(
            lambda: flash_fwd(q, k, v, mask, *alibi_args, **kw),
            lambda: flash_fwd_reference(q, k, v, mask, *alibi_args, **kw), full)
        rec["bwd"] = timed_pair(
            lambda: flash_bwd(q, k, v, mask, *alibi_args, lse, delta, do, **kw),
            lambda: flash_bwd_reference(q, k, v, mask, *alibi_args, lse, delta, do, **kw),
            full)
        for part in ("fwd", "bwd"):
            rec[part]["library_ms"] = rec[part]["library_call_ms"] = None
        if full:
            # library yardstick: SDPA with the same boolean mask (GQA
            # repeated), forward, and its backward alone on a retained graph
            g = H // KV
            qd = q.transpose(1, 2).detach().requires_grad_(True)
            kd = k.repeat_interleave(g, dim=2).transpose(1, 2).detach().requires_grad_(True)
            vd = v.repeat_interleave(g, dim=2).transpose(1, 2).detach().requires_grad_(True)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            with torch.no_grad():
                rec["fwd"]["library_ms"], rec["fwd"]["library_call_ms"] = time_ms(
                    lambda: sdpa(qd, kd, vd, attn_mask=vis))
            ref_out = sdpa(qd, kd, vd, attn_mask=vis)
            dod = do.transpose(1, 2)
            rec["bwd"]["library_ms"], rec["bwd"]["library_call_ms"] = time_ms(
                lambda: torch.autograd.grad(ref_out, (qd, kd, vd), dod, retain_graph=True))
        rec["fwd"]["bound_ms"], rec["fwd"]["bound_by"] = bound(fwd_bytes, 4 * D * H * pairs, dtype)
        rec["bwd"]["bound_ms"], rec["bwd"]["bound_by"] = bound(bwd_bytes, 10 * D * H * pairs, dtype)
        rec["visible_pairs_per_head"] = pairs
    flash_fwd.launches, flash_bwd.launches = before
    rec["seconds"] = time.perf_counter() - t0
    emit({**rec, "ok": True})
    return rec


def loss_operands(B, R, seed, dev):
    """The fused loss's seven (B, R) f32 operands: ratios inside and
    outside the clip range, a fully masked row, new values exactly on the
    value-clip bounds (exact ties for the backward), behaviour logprobs."""
    rs = np.random.RandomState(seed)
    lp = (rs.randn(B, R) * 0.1).astype(np.float32)
    olp = (lp + rs.randn(B, R) * 0.15).astype(np.float32)
    ov = rs.randn(B, R).astype(np.float32)
    v = (ov + rs.randn(B, R) * 0.3).astype(np.float32)
    v[:, ::4] = (ov + np.float32(0.2))[:, ::4]
    rw = (rs.randn(B, R) * 0.05).astype(np.float32)
    mask = (rs.rand(B, R) > 0.25).astype(np.float32)
    mask[0] = 0.0
    blp = (olp + rs.randn(B, R) * 0.05).astype(np.float32)
    return [torch.tensor(x, device=dev) for x in (lp, v, olp, ov, rw, mask, blp)]


def edge_values(p, ops):
    """Masked sketched values within 1e-5 of a bin edge (a 1-ulp
    difference may move them to the neighbouring bin)."""
    from trlx_tpu_torch.ops.fused_loss import _method_of
    from trlx_tpu_torch.observability.dynamics import SKETCH_BINS, SKETCH_RANGES

    m = _method_of(p)
    lp, v, olp, ov, rw, mask = ops[:6]
    adv, ret = m.get_advantages_and_returns(ov, rw, mask)
    lr = (lp - olp) * mask
    vals = {"log_ratio": lr, "kl": (torch.exp(lr) - 1) - lr, "advantages": adv,
            "value_error": v - ret}
    n = 0
    for name, x in vals.items():
        lo, hi = SKETCH_RANGES[name]
        edges = lo + (hi - lo) / SKETCH_BINS * torch.arange(SKETCH_BINS + 1, device=x.device)
        d = (x[..., None] - edges).abs().amin(-1)
        n += int(((d < 1e-5) & (mask > 0)).sum())
    return n


def check_loss(B, R, use_iw, seed, timed=False):
    """Kernels #7 and #8 against their plain versions: the loss, every
    stat, every bin, the residuals (raw advantages and returns, whitening
    moments), dlogprobs and dvalues."""
    from trlx_tpu_torch.ops.fused_loss import (
        LossParams,
        fused_loss_bwd,
        fused_loss_bwd_reference,
        fused_loss_fwd,
        fused_loss_fwd_reference,
    )

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    p = LossParams(gamma=1.0, lam=0.95, cliprange=0.2, cliprange_value=0.2, vf_coef=1.0,
                   iw_correction="clip" if use_iw else "off", iw_clip=1.05, dist_sketches=True)
    ops = loss_operands(B, R, seed, dev)[: 7 if use_iw else 6]
    g = torch.tensor(1.0, device=dev)
    before = (fused_loss_fwd.launches, fused_loss_bwd.launches)
    loss, sc, hist, res = fused_loss_fwd(p, ops)
    dlp, dv = fused_loss_bwd(p, ops, res, g)
    torch.cuda.synchronize()
    wloss, wsc, whist, wres = fused_loss_fwd_reference(p, ops)
    wlp, wv = fused_loss_bwd_reference(p, ops, wres, g)
    errs = {"loss": excess(loss, wloss, LOSS_ATOL, LOSS_RTOL),
            "stats": excess(sc, wsc, LOSS_ATOL, LOSS_RTOL),
            "residuals": excess(res, wres, LOSS_ATOL, LOSS_RTOL),
            "dlogprobs": excess(dlp, wlp, LOSS_GRAD_ATOL, LOSS_RTOL),
            "dvalues": excess(dv, wv, LOSS_GRAD_ATOL, LOSS_RTOL)}
    bin_diff = float((hist - whist).abs().sum())
    edge = edge_values(p, ops)
    rec = {"phase": "kernel_check", "kernel": "fused_loss_fwd+fused_loss_bwd", "B": B, "R": R,
           "iw": use_iw, "sketches": True, "max_abs_err": {k: e[1] for k, e in errs.items()},
           "bins_abs_diff": bin_diff, "values_near_bin_edges": edge,
           "tol": {"rtol": LOSS_RTOL, "atol": LOSS_ATOL, "grad_atol": LOSS_GRAD_ATOL}}
    if any(e[0] > 0 or not math.isfinite(e[1]) for e in errs.values()) or bin_diff > 2 * edge:
        emit({**rec, "ok": False})
        raise AssertionError(f"fused loss ({B}, {R}, iw={use_iw}) disagrees: {rec}")
    if timed:
        n = B * R
        # forward: the operands read, the residuals, loss, stats, sketches
        # and moments written; backward: the operands but the rewards and the
        # residuals read, two gradients written
        fwd_bytes = 4 * n * len(ops) + 4 * (2 * n + 1 + sc.numel() + hist.numel() + 3)
        bwd_bytes = 4 * n * (len(ops) - 1 + 2) + 4 * (3 + 1) + 4 * 2 * n
        # no single PyTorch call computes either
        # the plain versions read stats back to the host: they wait for the
        # card, so they are timed by their kernels' busy time
        rec["fwd"] = {**timed_pair(lambda: fused_loss_fwd(p, ops),
                                   lambda: fused_loss_fwd_reference(p, ops), timed is True,
                                   plain_waits=True),
                      "library_ms": None}
        rec["bwd"] = {**timed_pair(lambda: fused_loss_bwd(p, ops, res, g),
                                   lambda: fused_loss_bwd_reference(p, ops, wres, g),
                                   timed is True, plain_waits=True),
                      "library_ms": None}
        # about 60 f32 operations per element forward (GAE, whitening,
        # both clipped losses, stats, sketches), about 40 backward
        rec["fwd"]["bound_ms"], rec["fwd"]["bound_by"] = bound(fwd_bytes, 60 * n, torch.float32)
        rec["bwd"]["bound_ms"], rec["bwd"]["bound_by"] = bound(bwd_bytes, 40 * n, torch.float32)
    fused_loss_fwd.launches, fused_loss_bwd.launches = before
    rec["seconds"] = time.perf_counter() - t0
    emit({**rec, "ok": True})
    return rec


# the fused loss's (B, R): the training slice's, default_ppo_config's batch
# of 32 at 40 new tokens, examples/hh/ppo_hh.py's 125M rung (batch 32, 128
# new tokens) — the three timed, IW off — and a ragged shape and one past
# the forward's staged shared-memory layout (read from global memory)
LOSS_SHAPES = ((16, 40), (32, 40), (32, 128), (13, 77), (48, 160))
LOSS_TIMED = LOSS_SHAPES[:3]
LOSS_RECORDED = LOSS_SHAPES[:2]


def phase_train_kernels():
    """Returns the timed bf16 record of each training kernel at the
    training shape (and the long-sequence flash record)."""
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        bf = dtype == torch.bfloat16
        # (a) the slice's train shape
        a = check_flash("train", B=16, T=104, S=104, H=12, KV=12, D=64, dtype=dtype, seed=21,
                        timed=bf)
        # (b) the default config's length
        b = check_flash("long", B=4, T=1024, S=1024, H=12, KV=12, D=64, dtype=dtype, seed=22,
                        timed=bf and KERNEL_ONLY)
        # (c) GQA, T != S, a query offset, a window, ALiBi, fully masked rows
        check_flash("gqa_window_alibi", B=2, T=77, S=300, H=32, KV=8, D=128, dtype=dtype,
                    seed=23, q_offset=223, window=64, alibi=True, dead_keys=(200, 290))
        # (d) head dims off the tensor-core templates, 256 (CUDA cores) and
        # above (split over the head dim)
        for D in HEAD_DIM_CHECKS:
            check_flash(f"head_dim_{D}", B=2, T=90, S=90, H=8, KV=4, D=D, dtype=dtype,
                        seed=24 + D, alibi=D == 96)
        # (e) the offline trainers' right-padded rows: SFT's shape, ILQL's
        # and ilql_randomwalks' (timed)
        for i, (B, T, H, D) in enumerate(RIGHT_PAD_FLASH_SHAPES):
            rec = check_flash(f"right_pad_{B}x{T}", B=B, T=T, S=T, H=H, KV=H, D=D, dtype=dtype,
                              seed=31 + i, right_pad=True, timed=bf and KERNEL_ONLY)
            if bf:
                timed[f"flash_right_pad_{B}x{T}"] = rec
        # (f) ppo_randomwalks' train batches: 64 rows of 11 (left-padded
        # prompts), head dim 12
        check_flash("randomwalks_ppo", B=64, T=11, S=11, H=12, KV=12, D=12, dtype=dtype,
                    seed=35)
        # (g) the family slice's train batches (Mistral-7B's GQA 4:1, D 128,
        # its window of 4096, timed) and the window biting at 64; bloom-560m's
        # ALiBi over H 16, D 64
        fam = check_flash("family_train", B=16, T=104, S=104, H=32, KV=8, D=128, dtype=dtype,
                          seed=36, window=4096, timed=bf and KERNEL_ONLY)
        check_flash("family_window_64", B=4, T=104, S=104, H=32, KV=8, D=128, dtype=dtype,
                    seed=37, window=64)
        check_flash("bloom_alibi", B=4, T=104, S=104, H=16, KV=16, D=64, dtype=dtype, seed=38,
                    alibi=True)
        # (h) the GRPO slices' train batches: GPT-2 small at batch 32 (64-byte
        # prompts ‖ 40 new tokens) and Mixtral's GQA 4:1, D 128 on the task's
        # review openings (32 ‖ 40), the kernels timed (the plain versions
        # and SDPA only at (a)'s shape, PERF.md's table row)
        grpo = check_flash("grpo_train", B=32, T=104, S=104, H=12, KV=12, D=64, dtype=dtype,
                           seed=39, timed=bf and KERNEL_ONLY)
        moe = check_flash("moe_grpo_train", B=32, T=72, S=72, H=32, KV=8, D=128, dtype=dtype,
                          seed=41, timed=bf and KERNEL_ONLY)
        # (i) the GRPO collections' passes, left-padded at both widths: the
        # scoring forward and the hydra reference replay over all 128 rows of
        # a chunk (16 prompts × 8 members, prompt ‖ 40 new tokens), the serial
        # dense-cache prefill of those rows (T = the prompt width, S = T + 40)
        # and the evaluation's prefill at batch 32
        for tag, H, KV, D, P, seed in (("grpo", 12, 12, 64, 64, 42),
                                       ("moe_grpo", 32, 8, 128, 32, 46)):
            check_flash(f"{tag}_score", B=128, T=P + 40, S=P + 40, H=H, KV=KV, D=D,
                        dtype=dtype, seed=seed)
            for i, B in enumerate((128, 32)):
                check_flash(f"{tag}_prefill_{B}", B=B, T=P, S=P + 40, H=H, KV=KV, D=D,
                            dtype=dtype, seed=seed + 1 + i)
        # (j) the preference paths' train batches, right-padded: DPO's 16
        # pairs (the kernels timed) and the reward model's 8 at GPT-2 small's width, DPO
        # + LoRA at Mistral-7B's (GQA 4:1, D 128, its window; timed at (h)'s
        # MoE GRPO shape, which it equals)
        for i, (tag, (B, T, H, KV, D, window)) in enumerate(PREFERENCE_FLASH_SHAPES.items()):
            rec = check_flash(f"{tag}_train", B=B, T=T, S=T, H=H, KV=KV, D=D, dtype=dtype,
                              seed=51 + i, window=window, right_pad=True,
                              timed=bf and tag == "dpo" and KERNEL_ONLY)
            if bf and tag == "dpo":
                timed["flash_dpo"] = rec
        # (k) the reward model's stage-3 PPO, left-padded: its train batches
        # (16 rows of 206-byte prompts ‖ 50 tokens) and the serial
        # collection's dense-cache prefill of a 16-row chunk
        check_flash("reward_ppo_train", B=16, T=256, S=256, H=12, KV=12, D=64, dtype=dtype,
                    seed=55)
        check_flash("reward_ppo_prefill", B=16, T=206, S=256, H=12, KV=12, D=64, dtype=dtype,
                    seed=56)
        # (l) the Llama-7B remat path (MHA, D 128), left-padded: its train
        # batches (32 rows of review openings ‖ 40 tokens; the kernels timed), the
        # scoring forward and hydra replay over the 128-row chunk, and the
        # serial prefills of the chunk and of an evaluation batch
        llama = check_flash("llama_train", B=32, T=72, S=72, H=32, KV=32, D=128, dtype=dtype,
                            seed=57, timed=bf and KERNEL_ONLY)
        check_flash("llama_score", B=128, T=72, S=72, H=32, KV=32, D=128, dtype=dtype,
                    seed=58)
        for i, B in enumerate((128, 32)):
            check_flash(f"llama_prefill_{B}", B=B, T=32, S=72, H=32, KV=32, D=128,
                        dtype=dtype, seed=59 + i)
        if bf:
            timed["flash_llama"] = llama
            timed["flash_train"], timed["flash_long"], timed["flash_family"] = a, b, fam
            timed["flash_grpo"], timed["flash_moe_grpo"] = grpo, moe
    for B, R in LOSS_SHAPES:
        for use_iw in (False, True):
            # the table's (16, 40) and T5's (32, 40) in full, (32, 128) the
            # kernels alone
            rec = check_loss(B, R, use_iw, seed=B * R + use_iw,
                             timed=(B, R) in LOSS_TIMED and not use_iw
                             and ((B, R) in LOSS_RECORDED or KERNEL_ONLY))
            if (B, R, use_iw) == (16, 40, False):
                timed["loss"] = rec
    return timed


# ---------------------------------------------------------------------------
# phase 5b: the ring — sequence parallelism on the flash kernels
# ---------------------------------------------------------------------------

# ring size and widths: examples/long_context_sft.py's (sequence 4, T 8192,
# batch 8, llama-test at hidden 256, 8 heads) and Llama-7B's attention (32
# heads of 128) at the same length, one row, left-padded
RING_N = 4
RING_EXAMPLE = dict(B=8, T=8192, H=8, KV=8, D=32)
RING_LLAMA = dict(B=1, T=8192, H=32, KV=32, D=128)
RING_LLAMA_WINDOW = 4096
RING_PLAIN_T = 1024  # the plain versions' check: dense f32 scores fit there
RING_SFT_STEPS = 2


def ring_operands(B, T, H, KV, D, dtype, seed, dev, left_pad=0):
    """q, k, v, the key mask (row 0 left-padded by ``left_pad``) and the
    output cotangent, drawn on the card."""
    rs = np.random.RandomState(seed)
    randn = device_randn(rs, dev)
    q, g = (randn(B, T, H, D).to(dtype) for _ in range(2))
    k, v = (randn(B, T, KV, D).to(dtype) for _ in range(2))
    mask = torch.ones(B, T, device=dev)
    mask[0, :left_pad] = 0.0
    return q, k, v, mask, g


def attention_fwd_bwd(fn, q, k, v, mask, g, **kw):
    """``fn``'s output and the gradients of q, k and v for cotangent g."""
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves, mask, **kw)
    return out.detach(), torch.autograd.grad(out, leaves, g)


def attention_gaps(got, want, mask, dtype):
    """``{name: (excess over FLASH_TOL, max abs err)}`` of an (out, grads)
    pair against another; the output on unmasked query rows (a row that
    sees no key is 0 on the kernel side, undefined on the plain one)."""
    tol = FLASH_TOL[dtype]
    valid = mask > 0.5
    gaps = {"out": excess(got[0][valid], want[0][valid], *tol["out"])}
    for name, a, b in zip(("dq", "dk", "dv"), got[1], want[1]):
        gaps[name] = excess(a, b, *tol["grad"])
    return gaps


def events_ms(fn, reps=3):
    """Median CUDA-event milliseconds of ``fn`` (after one warm call)."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ring_pair_record(dtype, dev, B, Tp, H, D, q_offset, timed):
    """#5 and #6' (``flash_attention_bwd_chunk``) on one (q-half x k-half)
    pair of the ring at slot offsets ``(q_offset, 0)``, against their plain
    versions; with ``timed`` their device times (the plain versions' too)
    and bounds. The lse and delta are the pair's own (a global lse takes
    the same kernel path)."""
    from trlx_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_chunk,
        flash_bwd_reference,
        flash_fwd,
        flash_fwd_reference,
    )

    q, k, v, mask, do = ring_operands(B, Tp, H, H, D, dtype, 71 + q_offset, dev)
    kw = dict(sm_scale=D ** -0.5, causal=True, q_offset=q_offset, k_offset=0, window=0)
    before = launch_counts()
    out, lse = flash_fwd(q, k, v, mask, None, None, None, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    chunk = lambda: flash_attention_bwd_chunk(q, k, v, mask, lse, delta, do,  # noqa: E731
                                              q_offset=q_offset)
    grads = chunk()
    f32 = [x.float() for x in (q, k, v)]
    want, want_lse = flash_fwd_reference(*f32, mask, None, None, None, **kw)
    plain_bwd = lambda: flash_bwd_reference(*f32, mask, None, None, None, lse,  # noqa: E731
                                            delta, do.float(), **kw)
    wgrads = plain_bwd()
    tol = FLASH_TOL[dtype]
    fwd_err = max(excess(out, want, *tol["out"])[1], excess(lse, want_lse, *tol["lse"])[1])
    bwd = [excess(a, b, *tol["grad"]) for a, b in zip(grads, wgrads)]
    fwd_ex = max(excess(out, want, *tol["out"])[0], excess(lse, want_lse, *tol["lse"])[0])
    rec = {"B": B, "T": Tp, "S": Tp, "H": H, "D": D, "q_offset": q_offset,
           "dtype": str(dtype).split(".")[-1],
           "fwd_max_abs_err": fwd_err, "bwd_max_abs_err": max(e for _, e in bwd),
           "ok": fwd_ex <= 0 and max(x for x, _ in bwd) <= 0}
    if timed:
        pairs, _ = flash_visible_pairs(mask, Tp, Tp, True, q_offset, 0)
        elem = torch.finfo(dtype).bits // 8
        io = elem * 4 * B * Tp * H * D
        rec["fwd"] = timed_pair(lambda: flash_fwd(q, k, v, mask, None, None, None, **kw),
                                lambda: flash_fwd_reference(q, k, v, mask, None, None, None,
                                                            **kw), timed is True)
        rec["bwd"] = timed_pair(chunk, plain_bwd, timed is True)
        rec["fwd"]["bound_ms"], rec["fwd"]["bound_by"] = bound(
            io + 4 * B * Tp + 4 * B * H * Tp, 4 * D * H * pairs, dtype)
        rec["bwd"]["bound_ms"], rec["bwd"]["bound_by"] = bound(
            2 * io + 8 * B * H * Tp + 4 * B * Tp, 10 * D * H * pairs, dtype)
        rec["fwd"]["library_ms"] = rec["bwd"]["library_ms"] = None
        rec["visible_pairs_per_head"] = pairs
    # these launches are checks, not the main path's
    for name, w in kernel_wrappers().items():
        w.launches = before[name]
    return rec


def phase_slice_ring(device="cuda", card="", n=RING_N, example=RING_EXAMPLE, llama=RING_LLAMA,
                     plain_T=RING_PLAIN_T, sft_steps=RING_SFT_STEPS, sft_seq=None):
    """Ring attention on the card, the in-process transport (one card holds
    no second NCCL rank):

    (c) the main path: every counter 0, the ring's forward and backward at
        long_context_sft's width (``sequence`` 4, T 8192) in bf16, the
        counters read: #5, #6 and #6' (``flash_attention_bwd_chunk``) must
        have launched; its ms beside the monolithic flash call's;
    (a) that run and an f32 one against one monolithic ``flash_attention``
        call and its backward (``FLASH_TOL``), and the ring at T
        ``plain_T`` against the plain versions (``attention_reference``, f32
        autograd);
    (b) Llama-7B's attention width, bf16, the row left-padded, and again
        with a window of 4096, against the monolithic kernels; #5 and #6'
        on one of the ring's pairs against their plain versions, timed;
    (d) ``tasks/long_context_sft.py`` through ``trlx_tpu_torch.train`` in
        one process (``sequence`` 1, T 8192, ``sft_steps`` steps): the mesh
        and trainer wiring leave the one-device path as it was.

    Returns ``(launches, record of #6' for the kernels line)``."""
    import shutil

    import trlx_tpu_torch
    from trlx_tpu_torch.ops.flash_attention import attention_reference, flash_attention
    from trlx_tpu_torch.parallel.ring_attention import ring_flash_attention
    from trlx_tpu_torch.tasks.long_context_sft import config as sft_config
    from trlx_tpu_torch.tasks.long_context_sft import synthetic_documents

    dev = torch.device(device)
    card_run = dev.type == "cuda"  # a CPU rehearsal runs the plain versions, untimed
    sync = torch.cuda.synchronize if card_run else (lambda: None)
    t0 = time.perf_counter()
    problems, rec = [], {"phase": "slice_ring", "card": card, "n": n, "example": example,
                         "llama": llama}
    bf16, f32 = torch.bfloat16, torch.float32
    ring = lambda *a, **kw: ring_flash_attention(*a, n, **kw)  # noqa: E731
    parts, t_part = {}, [time.perf_counter()]

    def part(name):  # wall seconds of each part, for the phase's budget
        sync()
        now = time.perf_counter()
        parts[name], t_part[0] = now - t_part[0], now

    # -- (c) the main path ------------------------------------------------
    ops = ring_operands(**example, dtype=bf16, seed=61, dev=dev)
    sync()
    zero_launch_counts()
    got = attention_fwd_bwd(ring, *ops)
    sync()
    launches = launch_counts()
    # -------------------------------------------------------------------
    rec["launches"] = {k: launches[k] for k in ("flash_fwd", "flash_bwd", "flash_bwd_chunk")}
    for name in ("flash_fwd", "flash_bwd", "flash_bwd_chunk"):
        if card_run and not launches[name]:
            problems.append(f"{name} never launched on the ring's path")
    want = attention_fwd_bwd(flash_attention, *ops)
    gaps = {"example_bf16": attention_gaps(got, want, ops[3], bf16)}
    if card_run:
        rec["ring_fwd_bwd_ms"] = events_ms(lambda: attention_fwd_bwd(ring, *ops))
        rec["monolithic_fwd_bwd_ms"] = events_ms(lambda: attention_fwd_bwd(flash_attention,
                                                                           *ops))
    del got, want, ops
    part("c_main_path_and_monolithic_bf16")

    # -- (a) f32, and the plain versions at plain_T -----------------------
    ops = ring_operands(**example, dtype=f32, seed=62, dev=dev)
    gaps["example_f32"] = attention_gaps(attention_fwd_bwd(ring, *ops),
                                         attention_fwd_bwd(flash_attention, *ops), ops[3], f32)
    del ops
    part("a_example_f32")
    for dtype in (bf16, f32):
        ops = ring_operands(**{**example, "T": plain_T}, dtype=dtype, seed=63, dev=dev,
                            left_pad=37)
        plain = attention_fwd_bwd(lambda q, k, v, m: attention_reference(q, k, v, m)[0],
                                  *[x.float() for x in ops[:3]], ops[3], ops[4].float())
        gaps[f"plain_T{plain_T}_{str(dtype)[6:]}"] = attention_gaps(
            attention_fwd_bwd(ring, *ops), plain, ops[3], dtype)
        del ops, plain
    part("a_plain_versions")

    # -- (b) Llama-7B's attention width -----------------------------------
    ops = ring_operands(**llama, dtype=bf16, seed=64, dev=dev, left_pad=llama["T"] // 8)
    for tag, window in (("llama", None), ("llama_window", RING_LLAMA_WINDOW)):
        gaps[tag] = attention_gaps(attention_fwd_bwd(ring, *ops, window=window),
                                   attention_fwd_bwd(flash_attention, *ops, window=window),
                                   ops[3], bf16)
    del ops
    part("b_llama")
    half = example["T"] // (2 * n)
    pair = ring_pair_record(bf16, dev, example["B"], half, example["H"], example["D"],
                            q_offset=(2 * n - 1) * half, timed=card_run)
    diagonal = ring_pair_record(bf16, dev, example["B"], half, example["H"], example["D"],
                                q_offset=0, timed=card_run and KERNEL_ONLY)
    rec["pair"], rec["diagonal_pair"] = pair, diagonal
    part("b_pairs_timed")
    for name, p in (("pair", pair), ("diagonal_pair", diagonal)):
        if not p["ok"]:
            problems.append(f"#5/#6' disagree with their plain versions on the {name}")
    rec["max_abs_err"] = {tag: {k: e for k, (_, e) in g.items()} for tag, g in gaps.items()}
    for tag, g in gaps.items():
        bad = {k: e for k, (x, e) in g.items() if not math.isfinite(e) or x > 0}
        if bad:
            problems.append(f"{tag}: the ring disagrees beyond FLASH_TOL: {bad}")
    if card_run:
        torch.cuda.empty_cache()

    # -- (d) long_context_sft in one process ------------------------------
    ckpt = _scratch_dir("slice_ring")
    cfg = sft_config({"parallel.data": 1, "parallel.sequence": 1, "train.total_steps": sft_steps,
                      "train.epochs": 1, "train.checkpoint_dir": ckpt, "train.tracker": None,
                      **({"train.seq_length": sft_seq} if sft_seq else {})})
    T = cfg.train.seq_length
    docs = synthetic_documents(sft_steps * cfg.train.batch_size, target_chars=T - 64)
    zero_launch_counts()
    try:
        trainer = trlx_tpu_torch.train(samples=docs, config=cfg, device=dev,
                                       eval_prompts=[d[: d.index(".") + 1] for d in docs[:8]])
        sync()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    sft_launches = launch_counts()
    steps = [st for _, st in trainer.tracker.history if "gradients/global_norm" in st]
    rec["sft"] = {"seq_length": T, "batch_size": cfg.train.batch_size, "mesh": trainer.mesh,
                  "losses": [st["losses/loss"] for st in steps],
                  "train_step_ms": [1e3 * st["time/train_step"] for st in steps],
                  "launches": {k: sft_launches[k] for k in ("flash_fwd", "flash_bwd",
                                                            "flash_bwd_chunk")}}
    if len(steps) != sft_steps or not all(math.isfinite(x) for x in rec["sft"]["losses"]):
        problems.append(f"long_context_sft: {rec['sft']['losses']} over {len(steps)} steps")
    if trainer.mesh is not None or sft_launches["flash_bwd_chunk"]:
        problems.append("long_context_sft at one process built a mesh or ran the ring")
    if card_run and not (sft_launches["flash_fwd"] and sft_launches["flash_bwd"]):
        problems.append("long_context_sft ran without the flash kernels")
    del trainer
    part("d_long_context_sft")
    zero_launch_counts()
    rec["part_seconds"] = parts
    rec["seconds"] = time.perf_counter() - t0
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"slice_ring: {problems}")
    chunk = {**pair.get("bwd", {}), "max_abs_err": max(pair["bwd_max_abs_err"],
                                                       rec["max_abs_err"]["example_bf16"]["dk"])}
    return launches, chunk


# ---------------------------------------------------------------------------
# phase 6: the training slice — PPO on GPT-2 small through trlx.train
# ---------------------------------------------------------------------------

def phase_slice_train(device="cuda", spec="builtin:gpt2-small", total_steps=12, card="",
                      phase="slice_train", model_extra_kwargs=None, ckpt="chip_smoke_train",
                      num_layers_unfrozen=None):
    """PPO through ``trlx_tpu_torch.trlx.train`` (``model_extra_kwargs``
    into ``model.model_extra_kwargs``, ``num_layers_unfrozen`` in place of
    the training config's 2); every kernel counter is set to 0 just before
    and read just after. Returns (trainer, launches)."""
    import trlx_tpu_torch
    from trlx_tpu_torch.profile_train import reward_fn, slice_prompts, train_config

    dev = torch.device(device)
    ckpt = os.path.join(ROOT, "build", ckpt)
    # total_steps 12, not 8: 64 rollouts / batch 16 × 2 PPO epochs is 8
    # updates per collection, so 8 steps would end before the second one
    config = train_config(ckpt, spec, total_steps)
    if model_extra_kwargs:
        config = config.evolve(model=dict(model_extra_kwargs=model_extra_kwargs))
    if num_layers_unfrozen is not None:
        config = config.evolve(model=dict(num_layers_unfrozen=num_layers_unfrozen))
    prompts = slice_prompts()
    start = {}

    def hook(trainer):
        start.update({k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()})

    if dev.type == "cuda":
        torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    # -- the main path ---------------------------------------------------
    trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, config=config,
                                   init_trainer_hook=hook, device=dev)
    # -------------------------------------------------------------------
    wall = time.perf_counter() - t0
    launches = launch_counts()
    hist = trainer.tracker.history
    steps = [st for _, st in hist if "gradients/global_norm" in st]
    collections = [st for _, st in hist if "time/exp" in st]
    losses = [st["losses/total_loss"] for st in steps]
    end = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    L = trainer.tcfg.num_layers
    frozen = [k for k in end if k.startswith("backbone.blocks.")
              and int(k.split(".")[2]) < L - 2]
    moved_keys = [k for k in end if k not in frozen]
    unchanged = [k for k in frozen if not torch.equal(end[k], start[k])]
    not_moved = [k for k in moved_keys if k.startswith(("backbone.blocks.", "backbone.ln_f",
                                                        "backbone.wte", "backbone.lm_head",
                                                        "v_head"))
                 and k.endswith("weight") and torch.equal(end[k], start[k])]
    step_ms = [1e3 * st["time/step"] for st in steps]
    tok_s = [st["throughput/tokens_per_sec"] for st in steps]
    rec = {"phase": phase, "model": spec, "model_extra_kwargs": model_extra_kwargs,
           "dtype": str(trainer.tcfg.dtype).split(".")[-1],
           "num_layers_unfrozen": trainer.config.model.num_layers_unfrozen,
           "seq_length": 104, "batch_size": 16,
           "ppo_epochs": 2, "num_rollouts": 64, "chunk_size": 32, "max_new_tokens": 40,
           "optimizer_steps": len(steps), "rollout_collections": len(collections),
           "losses": losses, "wall_s": wall,
           "rollout_tokens_per_s": [c.get("throughput/rollout_tokens_per_sec") for c in collections],
           "time_exp_s": [c["time/exp"] for c in collections],
           "train_step_ms_median": statistics.median(step_ms) if step_ms else None,
           "train_step_ms": step_ms,
           "train_tokens_per_s_median": statistics.median(tok_s) if tok_s else None,
           "launches": launches,
           "launches_per_train_step": {k: launches[k] / max(len(steps), 1) for k in TRAIN_KERNELS},
           "frozen_blocks_changed": unchanged, "trained_weights_unmoved": not_moved,
           "card": card}
    problems = []
    if len(steps) < 8:
        problems.append(f"only {len(steps)} optimizer steps")
    if len(collections) < 2:
        problems.append(f"only {len(collections)} rollout collections")
    if not all(math.isfinite(x) for x in losses):
        problems.append("a non-finite loss")
    if unchanged:
        problems.append(f"frozen blocks changed: {unchanged[:4]}")
    if not_moved:
        problems.append(f"trainable weights did not move: {not_moved[:4]}")
    if dev.type == "cuda" and min(launches[k] for k in SERVE_KERNELS + TRAIN_KERNELS) <= 0:
        problems.append(f"a kernel of the path never launched: {launches}")
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"{phase}: {problems}")
    return trainer, launches


# gradients on the card (kernels, f32) against the CPU plain versions (f32):
# reduction order and the order of the kernels' sums differ
PARITY_GRAD_RTOL = 1e-3
PARITY_STAT_RTOL, PARITY_STAT_ATOL = 1e-4, 1e-5
# the CPU may take the card's value-head ReLU branch only at a kink within
# f32 rounding: |pre-activation| at most RELU_KINK_ATOL (the H100 read at
# most 1.43e-6 over 5 such units), and at most RELU_KINK_MAX units a batch
RELU_KINK_ATOL, RELU_KINK_MAX = 1e-5, 32


class CardReluBranches:
    """``torch.nn.functional`` for ``models/heads.py`` while the parity
    phase runs: ``relu`` records the card pass's branch mask, and the CPU
    pass takes the card's branch (``x * mask``), as the sampling parity
    hands both sides the same noise. A value-head unit whose pre-activation
    lies within f32 rounding of 0 would otherwise take the other branch on
    the CPU and move that unit's weight gradient by a whole token's term,
    a difference of the ReLU's kink, not of a kernel. The record counts the
    branches taken from the card and the largest |pre-activation| there;
    :meth:`problems` bounds both and checks that every mask recorded was
    replayed once."""

    def __init__(self):
        self.recording, self.masks, self.replayed = True, [], 0
        self.taken, self.taken_pre_max = 0, 0.0

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    def relu(self, x):
        if self.recording:
            self.masks.append((x > 0).detach().cpu())
            return torch.nn.functional.relu(x)
        mask = self.masks[self.replayed].to(x.device)
        self.replayed += 1
        if mask.shape != x.shape:
            raise AssertionError(f"ReLU replay: mask {tuple(mask.shape)} for {tuple(x.shape)}")
        differs = mask != (x > 0)
        if bool(differs.any()):
            self.taken += int(differs.sum())
            self.taken_pre_max = max(self.taken_pre_max, float(x.detach()[differs].abs().max()))
        return x * mask.to(x.dtype)

    def problems(self):
        out = []
        if not self.masks or self.replayed != len(self.masks):
            out.append(f"ReLU replay: {len(self.masks)} masks recorded, {self.replayed} replayed")
        if not (self.taken <= RELU_KINK_MAX and self.taken_pre_max <= RELU_KINK_ATOL):
            out.append(f"ReLU branches from the card: {self.taken} units, "
                       f"|pre-activation| up to {self.taken_pre_max}")
        return out


def card_cpu_backward(trainer, build, batch, card, relu=None):
    """``trainer.loss_fn`` and backward on one host ``batch``: on the card
    in f32 through the kernels (TF32 off), and on a CPU copy of the same
    f32 model through the plain versions. ``build(cfg32)`` makes an empty
    model of the trainer's class; with ``relu`` (:class:`CardReluBranches`)
    the heads' ReLU takes the card's branches on the CPU. Returns
    ``{"card": ..., "cpu": ...}``: loss, host stats, gradients and the
    launches of each pass."""
    from trlx_tpu_torch.models import heads
    from trlx_tpu_torch.trainer.base import host_stats
    from trlx_tpu_torch.utils import filter_non_scalars

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(trainer.tcfg, dtype=torch.float32, attention_impl="pallas")
    state = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    model, device = trainer.model, trainer.device
    results = {}
    if relu is not None:
        heads.F = relu
    try:
        for key, dev in (("card", torch.device(card)), ("cpu", torch.device("cpu"))):
            if relu is not None:
                relu.recording = key == "card"
            with torch.device("meta"):  # no default init: every tensor comes from state
                m = build(cfg32)
            m = m.to_empty(device=dev)
            m.load_state_dict(state)
            m.requires_grad_(True)
            trainer.model, trainer.device = m, dev
            trainer._drop_batch_memo()
            zero_launch_counts()
            loss, stats = trainer.loss_fn(trainer._device_batch(batch))
            loss.backward()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            results[key] = {
                "loss": float(loss.detach()),
                "stats": filter_non_scalars(host_stats(stats)),
                "grads": {k: p.grad.detach().cpu() for k, p in m.named_parameters()
                          if p.grad is not None},
                "launches": launch_counts(),
            }
            del m, loss, stats
    finally:
        heads.F = torch.nn.functional
        trainer.model, trainer.device = model, device
        trainer._drop_batch_memo()
    return results


def compare_card_cpu(results, card, kernels, stat_atol=None):
    """Problems and record fields of a :func:`card_cpu_backward` pair:
    stats within ``PARITY_STAT_RTOL`` (+ ``stat_atol(key)``, default
    ``PARITY_STAT_ATOL``), the loss within ``PARITY_STAT_RTOL``, every
    gradient within ``PARITY_GRAD_RTOL`` of its tensor's largest (with an
    absolute floor of 1e-5 of the model's largest gradient), no launch on
    the CPU and each of ``kernels`` launched on the card."""
    gpu, cpu = results["card"], results["cpu"]
    problems = []
    if set(gpu["grads"]) != set(cpu["grads"]):
        problems.append("the two passes gave gradients to different parameters")
    worst_stat, stat_name = 0.0, None
    for k, want in cpu["stats"].items():
        if k == "train/loss_kernel_pallas":
            continue
        got = gpu["stats"][k]
        atol = stat_atol(k) if stat_atol else PARITY_STAT_ATOL
        err = abs(got - want)
        if not err <= atol + PARITY_STAT_RTOL * abs(want):
            problems.append(f"stat {k}: {got} vs {want}")
        rel = err / max(abs(want), 1e-12)
        if rel > worst_stat:
            worst_stat, stat_name = rel, k
    # relative to each tensor's largest gradient, with an absolute floor of
    # 1e-5 of the model's largest: the key-projection biases have a zero
    # gradient in exact arithmetic (softmax ignores a shift every key
    # shares, so each query's terms cancel), and both sides hold rounding
    # noise there. The record prints that noise: the largest error over the
    # model's largest gradient among the tensors the floor governs
    gmax = max(float(g.abs().max()) for g in cpu["grads"].values())
    floor = 1e-5 * gmax
    worst_grad, grad_name = 0.0, None
    worst_floored, floored_name = 0.0, None
    for k, want in cpu["grads"].items():
        err = float((gpu["grads"][k] - want).abs().max())
        scale = float(want.abs().max())
        rel = err / max(scale, floor)
        if not rel <= worst_grad:  # NaN counts as worst
            worst_grad, grad_name = rel, k
        if scale < floor and not err / gmax <= worst_floored:
            worst_floored, floored_name = err / gmax, k
    if not worst_grad <= PARITY_GRAD_RTOL:
        problems.append(f"gradient {grad_name}: relative {worst_grad}")
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / max(abs(cpu["loss"]), 1e-12)
    if not loss_rel <= PARITY_STAT_RTOL:
        problems.append(f"loss {gpu['loss']} vs {cpu['loss']}")
    through = {k: gpu["launches"][k] for k in kernels}
    if max(cpu["launches"].values()) != 0 or (
            torch.device(card).type == "cuda" and min(through.values()) <= 0):
        problems.append(f"launches card {gpu['launches']} / cpu {cpu['launches']}")
    rec = {"tf32": False, "loss_card": gpu["loss"], "loss_cpu": cpu["loss"],
           "loss_rel_err": loss_rel, "worst_stat_rel_err": worst_stat, "worst_stat": stat_name,
           "worst_grad_rel_err": worst_grad, "worst_grad": grad_name,
           "grad_abs_floor": floor, "largest_grad": gmax,
           "floored_grad_err_over_largest": worst_floored, "floored_grad": floored_name,
           "grad_rtol": PARITY_GRAD_RTOL, "stat_rtol": PARITY_STAT_RTOL,
           "kernel_launches_card": through, "params_compared": len(cpu["grads"])}
    return problems, rec


def phase_slice_train_parity(trainer, card="cuda", phase="slice_train_parity", rows=None,
                             kernels=TRAIN_KERNELS):
    """One collated batch of the run's store (``rows`` rows, the train
    batch size by default) through ``loss_fn`` and backward: on the card
    in f32 through the kernels (TF32 off; each of ``kernels`` must launch),
    and on a CPU copy of the same f32 model through the plain versions, the
    value head's ReLU taking the card's branches (:class:`CardReluBranches`)."""
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead

    batch = next(iter(trainer.store.create_loader(rows or trainer.config.train.batch_size)))
    relu = CardReluBranches()
    results = card_cpu_backward(trainer, CausalLMWithValueHead, batch, card, relu)
    n = float(np.asarray(batch.response_mask).sum())
    # a ratio within rounding of a clip bound may flip one token
    problems, fields = compare_card_cpu(
        results, card, kernels,
        stat_atol=lambda k: 1.5 / n if k.endswith("clipfrac") else PARITY_STAT_ATOL)
    problems = relu.problems() + problems
    rec = {"phase": phase, "batch": list(np.asarray(batch.query_tensors).shape)
           + [int(np.asarray(batch.response_tensors).shape[1])], **fields,
           "relu_branches_from_card": relu.taken, "relu_pre_max_there": relu.taken_pre_max,
           "relu_masks_replayed": relu.replayed,
           "relu_kink_bounds": [RELU_KINK_MAX, RELU_KINK_ATOL]}
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"{phase}: {problems}")
    zero_launch_counts()
    return rec


def phase_family_train(device="cuda", spec=FAMILY_SPEC, layers=FAMILY_TRAIN_LAYERS, card="",
                       parity_rows=2):
    """``slice_train``'s PPO run on the family slice's spec at ``layers``
    layers (full width, ``num_layers_unfrozen`` the smaller of 2 and
    ``layers``: the hydra branch replays the top blocks with rotary
    positions), then one batch of
    ``parity_rows`` rows held card against CPU in f32 (the CPU pass of a
    1.1B-parameter model is what bounds the rows). The run's final
    checkpoint (~10 GB) is removed. Returns the launches."""
    import shutil

    name = "chip_smoke_family_train"
    trainer, launches = phase_slice_train(device, spec, card=card, phase="slice_family_train",
                                          model_extra_kwargs={"num_layers": layers}, ckpt=name,
                                          num_layers_unfrozen=min(2, layers))
    shutil.rmtree(os.path.join(ROOT, "build", name), ignore_errors=True)
    phase_slice_train_parity(trainer, card=device, phase="slice_family_train_parity",
                             rows=parity_rows)
    return launches


# ---------------------------------------------------------------------------
# phase 7: the speculative slice — PPO with draft-propose → verify → accept
# ---------------------------------------------------------------------------

SPEC_GAMMA = 4
# distilgpt2's published shape: GPT-2 small's widths at 6 layers
DRAFT_LAYERS = 6


def phase_slice_spec(device="cuda", spec="builtin:gpt2-small", draft_layers=DRAFT_LAYERS,
                     total_steps=12, card=""):
    """``slice_train``'s PPO run with speculative rollouts: every kernel
    counter is set to 0 just before ``trlx_tpu_torch.train`` and read just
    after. Returns the launches."""
    import trlx_tpu_torch
    from trlx_tpu_torch.profile_train import reward_fn, slice_prompts, train_config

    dev = torch.device(device)
    ckpt = os.path.join(ROOT, "build", "chip_smoke_spec")
    config = train_config(ckpt, spec, total_steps).evolve(
        engine=dict(speculative=SPEC_GAMMA),
        model=dict(draft_model_path=spec, draft_model_extra_kwargs={"num_layers": draft_layers}),
    )
    if dev.type == "cuda":
        torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    # -- the main path ---------------------------------------------------
    trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=slice_prompts(),
                                   config=config, device=dev)
    # -------------------------------------------------------------------
    wall = time.perf_counter() - t0
    launches = launch_counts()
    hist = trainer.tracker.history
    steps = [st for _, st in hist if "gradients/global_norm" in st]
    collections = [st for _, st in hist if "time/exp" in st]
    losses = [st["losses/total_loss"] for st in steps]
    acc = [c["engine/spec_acceptance_rate"] for c in collections]
    tpr = [c["engine/spec_tokens_per_round"] for c in collections]
    rec = {"phase": "slice_spec", "model": spec, "draft_layers": draft_layers,
           "speculative": SPEC_GAMMA, "dtype": str(trainer.tcfg.dtype).split(".")[-1],
           "optimizer_steps": len(steps), "rollout_collections": len(collections),
           "losses": losses, "wall_s": wall,
           "time_exp_s": [c["time/exp"] for c in collections],
           "rollout_tokens_per_s": [c.get("throughput/rollout_tokens_per_sec")
                                    for c in collections],
           "spec_acceptance_rate": acc, "spec_tokens_per_round": tpr,
           "spec_rounds": [c["rollout/spec_rounds"] for c in collections],
           "verify_launches_per_collection": [c["engine/verify_kernel_launches"]
                                              for c in collections],
           "train_step_ms_median": statistics.median(1e3 * st["time/step"] for st in steps),
           "launches": launches, "card": card}
    problems = []
    if len(collections) < 2:
        problems.append(f"only {len(collections)} rollout collections")
    if not all(math.isfinite(x) for x in losses):
        problems.append("a non-finite loss")
    if not all(0.0 < a <= 1.0 for a in acc):
        problems.append(f"acceptance {acc} outside (0, 1]")
    if not all(1.0 <= x <= SPEC_GAMMA + 1 for x in tpr):
        problems.append(f"tokens per round {tpr} outside [1, {SPEC_GAMMA + 1}]")
    if dev.type == "cuda" and min(launches[k] for k in SPEC_KERNELS) <= 0:
        problems.append(f"a kernel of the path never launched: {launches}")
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"slice_spec: {problems}")
    return launches


def spec_engine(target, draft, draft_cfg, cfg, gen, slots, prompt_len, dev):
    from trlx_tpu_torch.engine.core import ContinuousEngine
    from trlx_tpu_torch.ops.paged_kv import PagedSpec, num_table_blocks
    from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns

    S = prompt_len + gen.max_new_tokens + SPEC_GAMMA
    paged = PagedSpec(16, 1 + slots * num_table_blocks(S, 16))
    fns = make_slot_refill_fns(cfg, slots, prompt_len, gen, segment_len=4, paged=paged,
                               speculative=SPEC_GAMMA, draft_cfg=draft_cfg, device=dev)
    return ContinuousEngine(fns, (target, draft), gen.pad_token_id)


def phase_slice_spec_parity(device="cuda", spec="builtin:gpt2-small",
                            draft_layers=DRAFT_LAYERS, slots=8, prompt_len=64, max_new=40,
                            n_prompts=16, card="", keep=False):
    """f32, TF32 off, greedy. (a) The speculative engine (six-layer draft)
    answers ``n_prompts`` prompts; each answer equals the plain ``generate``
    of the target token for token (a divergence is tolerated only at a
    near tie of the plain path's top-2 logits, as in ``slice_parity``):
    greedy speculation is exact for any draft. (b) With the target's own
    weights as the draft, acceptance is exactly 1.0 and every round
    commits ``G + 1`` tokens (``max_new`` a multiple of ``G + 1``, no eos).
    With ``keep``, returns the f32 target and draft with their configs
    too (``slice_spec_prefix`` and ``slice_engine_dense`` reuse them)."""
    from trlx_tpu_torch.models.builder import build_causal_lm
    from trlx_tpu_torch.ops.sampling import GenerationConfig, generate

    if max_new % (SPEC_GAMMA + 1):
        raise ValueError(f"max_new {max_new} must be a multiple of {SPEC_GAMMA + 1}")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    f32 = dict(dtype=torch.float32)
    target, cfg = build_causal_lm(spec, seed=0, device=dev, **f32)
    draft, draft_cfg = build_causal_lm(spec, seed=1, device=dev, num_layers=draft_layers, **f32)
    V = cfg.vocab_size
    gen = GenerationConfig(max_new_tokens=max_new, do_sample=False, eos_token_id=V - 1,
                           pad_token_id=V - 1)
    prompts = np.random.RandomState(4321).randint(0, V - 1, size=(n_prompts, prompt_len))
    ones = np.ones_like(prompts)
    zero_launch_counts()
    engine = spec_engine(target, draft, draft_cfg, cfg, gen, slots, prompt_len, dev)
    engine.enqueue_prompts(prompts, ones, np.arange(n_prompts))
    got = {c.index: c for c in engine.run()}
    verify_launches = launch_counts()["paged_verify"]
    plain = generate(target, torch.tensor(prompts), torch.tensor(ones),
                     torch.arange(n_prompts), gen)
    plain_tok = plain.response_tokens.cpu().numpy()
    plain_mask = plain.response_mask.cpu().numpy()
    ties, rows_equal = [], 0
    for i in range(n_prompts):
        a = got[i].tokens[got[i].mask == 1]
        b = plain_tok[i][plain_mask[i] == 1]
        if np.array_equal(a, b):
            rows_equal += 1
            continue
        n = min(len(a), len(b))
        diff = np.nonzero(a[:n] != b[:n])[0]
        pos = min(int(diff[0]) if len(diff) else n, len(b) - 1)
        _, gap2 = f32_gaps(target, [prompts[i]], [b[: pos + 1]])[0]
        ties.append({"prompt": i, "position": pos, "top2_gap": float(gap2[pos])})
    draft_stats = {"acceptance": engine.stats.spec_acceptance_rate,
                   "tokens_per_round": engine.stats.spec_tokens_per_round}

    # (b) the target as its own draft
    self_gen = dataclasses.replace(gen, eos_token_id=None)
    n_self = n_prompts // 2
    engine = spec_engine(target, target, cfg, cfg, self_gen, slots, prompt_len, dev)
    engine.enqueue_prompts(prompts[:n_self], ones[:n_self], np.arange(n_self))
    engine.run()
    st = engine.stats
    rec = {"phase": "slice_spec_parity", "model": spec, "draft_layers": draft_layers,
           "dtype": "float32", "tf32": False, "prompts": n_prompts, "max_new_tokens": max_new,
           "rows_equal_to_plain": rows_equal, "near_ties": ties,
           "tie_gap_tol": F32_TIE_GAP, "draft": draft_stats, "verify_launches": verify_launches,
           "self_draft": {"prompts": n_self, "acceptance": st.spec_acceptance_rate,
                          "tokens_per_round": st.spec_tokens_per_round,
                          "rounds": st.spec_rounds}, "card": card}
    problems = [f"prompt {t['prompt']} diverges at {t['position']}" for t in ties
                if t["top2_gap"] >= F32_TIE_GAP]
    if st.spec_acceptance_rate != 1.0 or st.spec_tokens_per_round != SPEC_GAMMA + 1:
        problems.append(f"self-draft acceptance {st.spec_acceptance_rate}, tokens per "
                        f"round {st.spec_tokens_per_round}")
    if dev.type == "cuda" and verify_launches <= 0:
        problems.append("the verify kernel never launched")
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"slice_spec_parity: {problems}")
    zero_launch_counts()
    return (rec, {"target": target, "cfg": cfg, "draft": draft, "draft_cfg": draft_cfg}
            ) if keep else rec


# ---------------------------------------------------------------------------
# the rest of the engine: speculation with the prefix cache and chunked
# prefill, the dense backend and the gather paths, a draft of another family
# ---------------------------------------------------------------------------

# slice_spec_prefix: PREFIX_SERVE's geometry (8 slots, two tenants' 256-token
# prompts sharing 192-token system prompts, 40 new tokens, blocks of 16,
# chunks of 64) under speculation with slice_spec's draft; 16 requests in
# two waves: 4 fresh ones (2 a tenant), given 4 engine steps (their 4
# prefill spans, the last one's step decoding 4 rounds: at most 20 of the
# 40 tokens), then 8 fresh and 4 exact repeats of the
# first wave, which find its chains committed (hits of 192 and 240
# columns) and whose prefills stall the rows already decoding
SPEC_PREFIX = dict(slots=8, prompt_len=256, system_len=192, block_size=16, max_new=40,
                   prefill_chunk=64, segment_len=4, fresh=12, repeats=4, first_wave=4,
                   first_steps=4)
SPEC_PREFIX_KERNELS = ("paged_prefill", "paged_verify", "flash_fwd")
# the PPO collection of slice_engine_dense: the preset's one collection and
# its 16 updates (128 rollouts, batch 32, 4 epochs), the fused loss
ENGINE_DENSE_STEPS = 16
ENGINE_DENSE_KERNELS = TRAIN_KERNELS
# slice_family_spec: the draft a model.draft_model_extra_kwargs of
# builtin:llama-7b makes: Llama's family and vocabulary (32000), a quarter of
# Mistral-7B's width, one layer; 4 prompts of 512 tokens and their repeats
FAMILY_DRAFT_SPEC = "builtin:llama-7b"
FAMILY_DRAFT_KWARGS = dict(num_layers=1, hidden_size=1024, num_heads=8, num_kv_heads=8,
                           intermediate_size=2816)
FAMILY_SPEC_GEO = dict(slots=4, prompt_len=512, max_new=32, n_prompts=4, block_size=16,
                       segment_len=4)
FAMILY_SPEC_KERNELS = ("paged_prefill", "paged_verify")
# GRPO's harvest under speculation: slice_grpo_cb's run for 2 steps
GRPO_SPEC_STEPS = 2
GRPO_SPEC_KERNELS = ("paged_prefill", "paged_verify", "flash_fwd", "flash_bwd")


def spec_prefix_requests(vocab, geo=SPEC_PREFIX, seed=2718):
    """``(ids [R, P], tenants)``: ``geo["fresh"]`` prompts of two tenants'
    system prompts plus their own tokens (A and B alternating), then
    ``geo["repeats"]`` exact repeats of the first ones."""
    rs = np.random.RandomState(seed)
    P, L = geo["prompt_len"], geo["system_len"]
    system = {t: rs.randint(0, vocab - 1, L) for t in ("A", "B")}
    tenants = ["A" if i % 2 == 0 else "B" for i in range(geo["fresh"])]
    ids = [np.concatenate([system[t], rs.randint(0, vocab - 1, P - L)]) for t in tenants]
    ids += ids[: geo["repeats"]]
    tenants += tenants[: geo["repeats"]]
    return np.stack(ids).astype(np.int64), tenants


def spec_prefix_engine(target, draft, draft_cfg, cfg, dev, geo, gen):
    """The speculative engine over the prefix cache and chunked prefill
    (the in-place kernels; ``SPEC_GAMMA`` draft tokens a round)."""
    from trlx_tpu_torch.engine.core import ContinuousEngine
    from trlx_tpu_torch.ops.paged_kv import PagedSpec, num_table_blocks
    from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns

    P, bs = geo["prompt_len"], geo["block_size"]
    S = P + gen.max_new_tokens + SPEC_GAMMA
    paged = PagedSpec(bs, 1 + 2 * geo["slots"] * num_table_blocks(S, bs) + 8)
    fns = make_slot_refill_fns(cfg, geo["slots"], P, gen, segment_len=geo["segment_len"],
                               paged=paged, speculative=SPEC_GAMMA, draft_cfg=draft_cfg,
                               device=dev)
    return ContinuousEngine(fns, (target, draft), gen.pad_token_id, prefix_cache=True,
                            prefill_chunk=geo.get("prefill_chunk", 0))


def run_tenants(engine, ids, tenants, seeds, first_wave=None, first_steps=0):
    """Queue each row under its tenant and drain; with ``first_wave``, only
    that many rows first, ``first_steps`` engine steps, then the rest. The
    harvest by row."""
    base, done = engine._submitted, []
    first_wave = len(ids) if first_wave is None else first_wave
    for lo, hi in ((0, first_wave), (first_wave, len(ids))):
        for i in range(lo, hi):
            engine.enqueue_prompts(ids[i:i + 1], np.ones_like(ids[i:i + 1]), seeds[i:i + 1],
                                   tenant=tenants[i])
        if lo == 0:
            for _ in range(first_steps):
                done.extend(engine.step())
    done.extend(engine.run())
    return {c.index - base: c for c in done}


def phase_slice_spec_prefix(model16, f32, device="cuda", spec="builtin:gpt2-small",
                            draft_layers=DRAFT_LAYERS, geo=SPEC_PREFIX, card=""):
    """Speculation with the prefix cache and chunked prefill together. The
    bf16 run (``model16``: the prefix phases' GPT-2 small, seed 0; a
    ``draft_layers``-layer draft, seed 1): :func:`spec_prefix_requests`'s
    16 requests in two waves, sampled (top-k 50, top-p 0.95), no eos, the counters set
    to 0 once the engine is built and read after it drained. Prints the
    prefix hit rate, acceptance, tokens per round, decode ms a round and
    the decode stalls; fails unless prefix hits and chunk calls happened,
    every row got its 40 tokens, the second wave stalled decoding rows,
    and #1 (hits, chunks), #4 (verify) and #5
    (the draft's dense prefill) launched. Then in f32 with TF32 off
    (``f32``: ``slice_spec_parity``'s target and draft), greedy, every row
    against the solo ``generate_speculative`` (all rows in one call):
    tokens equal, a divergence tolerated only at a near tie of the plain
    path's top-2 logits."""
    from trlx_tpu_torch.models.builder import build_causal_lm
    from trlx_tpu_torch.ops.sampling import GenerationConfig
    from trlx_tpu_torch.ops.speculative import generate_speculative

    dev = torch.device(device)
    draft16, draft_cfg = build_causal_lm(spec, seed=1, device=dev, num_layers=draft_layers,
                                         dtype=model16.config.dtype)
    cfg = model16.config
    V = cfg.vocab_size
    ids, tenants = spec_prefix_requests(V, geo)
    seeds = np.arange(len(ids), dtype=np.int64)
    gen = GenerationConfig(max_new_tokens=geo["max_new"], temperature=1.0, top_k=50,
                           top_p=0.95, do_sample=True, eos_token_id=None, pad_token_id=V - 1)
    engine = spec_prefix_engine(model16, draft16, draft_cfg, cfg, dev, geo, gen)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    zero_launch_counts()
    engine.begin_collection()
    t0 = time.perf_counter()
    # -- the main path ---------------------------------------------------
    got = run_tenants(engine, ids, tenants, seeds, geo.get("first_wave"),
                      geo.get("first_steps", 0))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    # ---------------------------------------------------------------------
    wall = time.perf_counter() - t0
    launches = launch_counts()
    st, m = engine.stats, engine.stats.metrics()
    rec = {"phase": "slice_spec_prefix", "model": spec, "draft_layers": draft_layers,
           "dtype": str(cfg.dtype).split(".")[-1], "speculative": SPEC_GAMMA, "geometry": geo,
           "requests": len(ids), "wall_s": wall,
           "prefix_hit_rate": m["engine/prefix_hit_rate"],
           "prefix_tokens_saved": st.prefix_tokens_saved,
           "prefill_chunk_calls": st.prefill_chunk_calls,
           "spec_acceptance_rate": st.spec_acceptance_rate,
           "spec_tokens_per_round": st.spec_tokens_per_round, "spec_rounds": st.spec_rounds,
           "decode_round_ms_mean": 1e3 * st.decode_s / max(st.decode_steps, 1),
           # a round's time over the tokens it commits a live row: the
           # counterpart of a plain engine's decode step
           "decode_ms_per_token_step": 1e3 * st.decode_s / max(st.decode_steps, 1)
           / max(st.spec_tokens_per_round, 1.0),
           "decode_stall_s": {q: m[f"rollout/decode_stall_{q}"] for q in ("p50", "p95", "max")},
           "decode_stall_samples": len(st.decode_stall_samples),
           "launches": launches, "card": card}
    problems = []
    if sorted(got) != list(range(len(ids))) or any(int(c.mask.sum()) != geo["max_new"]
                                                    for c in got.values()):
        problems.append("a request did not get its tokens")
    if st.prefix_hit_blocks <= 0 or st.prefill_chunk_calls <= 0 or not st.decode_stall_samples:
        problems.append(f"hits {st.prefix_hit_blocks}, chunk calls {st.prefill_chunk_calls}, "
                        f"stalls {len(st.decode_stall_samples)}")
    if not 0.0 <= st.spec_acceptance_rate <= 1.0:
        problems.append(f"acceptance {st.spec_acceptance_rate}")
    if dev.type == "cuda" and min(launches[k] for k in SPEC_PREFIX_KERNELS) <= 0:
        problems.append(f"a kernel of the path never launched: {launches}")
    if any(launches[k] for k in ("paged_decode", "fused_sample")):
        problems.append(f"a kernel off the speculative path launched: {launches}")
    del engine

    # the f32 twin: greedy, every row against its solo sampler
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    greedy = dataclasses.replace(gen, do_sample=False)
    engine = spec_prefix_engine(f32["target"], f32["draft"], f32["draft_cfg"], f32["cfg"], dev,
                                geo, greedy)
    got32 = run_tenants(engine, ids, tenants, seeds, geo.get("first_wave"),
                        geo.get("first_steps", 0))
    ones = np.ones_like(ids)
    # the solo sampler over all rows in one call: a row's rounds read its
    # own caches only, so each row is its solo run (up to the GEMMs'
    # rounding by row count, which the near-tie rule covers)
    solo = generate_speculative(f32["target"], f32["draft"], torch.tensor(ids),
                                torch.tensor(ones), torch.tensor(seeds), greedy,
                                gamma=SPEC_GAMMA)
    want = list(solo.response_tokens.cpu().numpy())
    ties = greedy_divergences(f32["target"], ids, ones, [got32[i].tokens for i in range(len(ids))],
                              want)
    rec["f32"] = {"rows_equal_to_solo": len(ids) - len(ties), "near_ties": ties,
                  "tie_gap_tol": F32_TIE_GAP, "prefix_hit_rate": engine.stats.prefix_hit_rate,
                  "spec_acceptance_rate": engine.stats.spec_acceptance_rate}
    problems += [f"f32 row {t['row']} diverges at {t['position']}" for t in ties
                 if t["top2_gap"] >= F32_TIE_GAP]
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"slice_spec_prefix: {problems}")
    zero_launch_counts()
    return {k: launches[k] for k in REPLACES}


def dense_engine_answers(model, cfg, prompts, gen, dev, backend, slots=8, bs=16):
    """Greedy answers of ``prompts`` on one continuous path: ``backend``
    ``dense``, ``paged-xla`` (the gather paths) or ``paged-pallas`` (the
    in-place kernels)."""
    from trlx_tpu_torch.engine.core import ContinuousEngine
    from trlx_tpu_torch.ops.paged_kv import PagedSpec, num_table_blocks
    from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns

    P = prompts.shape[1]
    kw = {}
    if backend != "dense":
        kernel = backend.split("-")[1]
        kw = dict(paged=PagedSpec(bs, 1 + slots * num_table_blocks(P + gen.max_new_tokens, bs)),
                  decode_kernel=kernel, prefill_kernel=kernel)
    fns = make_slot_refill_fns(cfg, slots, P, gen, segment_len=8, device=dev, **kw)
    engine = ContinuousEngine(fns, model, gen.pad_token_id)
    engine.enqueue_prompts(prompts, np.ones_like(prompts), np.arange(len(prompts)))
    got = {c.index: c for c in engine.run()}
    return [got[i].tokens[got[i].mask == 1] for i in range(len(prompts))]


def phase_slice_engine_dense(f32, device="cuda", spec="builtin:gpt2-small", card="",
                             n_prompts=128, total_steps=ENGINE_DENSE_STEPS,
                             sections=None, parity_prompts=16, parity_len=64, parity_new=40):
    """PPO on the continuous path at the engine's default settings (the
    dense backend, JAX's default): ``default_ppo_config()`` with
    ``train.continuous_batching`` and the fused loss, one collection of 128
    rollouts on 128 slots and its ``total_steps`` updates, once with the
    host stage inline (depth 0) and once on the ``RolloutPipeline`` (the
    preset's depth 2). Each run's counters are set to 0 just before and
    read just after: #5 (the refills' and scoring's prefills) and #6–#8
    must launch, the paged kernels must not; the two runs' stores must be
    equal element for element. Then in f32 with TF32 off (``f32``:
    ``slice_spec_parity``'s target), ``parity_prompts`` greedy prompts on
    the dense backend, the paged gather paths and the paged kernels: each
    equal to the plain ``generate`` token for token (a divergence only at
    a near tie). Returns the launches of the depth-0 run."""
    import shutil

    import trlx_tpu_torch
    from trlx_tpu_torch.ops.sampling import GenerationConfig, generate
    from trlx_tpu_torch.profile_train import reward_fn, slice_prompts

    dev = torch.device(device)
    prompts = slice_prompts(n_prompts)
    runs, problems = {}, []
    for depth in (0, 2):
        ckpt = _scratch_dir(f"slice_engine_dense_{depth}")
        config = serial_config(ckpt, spec, total_steps, 10 ** 6,
                               train=dict(continuous_batching=True,
                                          rollout_pipeline_depth=depth),
                               method=dict(loss_kernel="pallas"))
        if sections:
            config = config.evolve(**sections)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        try:
            # -- the main path -------------------------------------------
            trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, config=config,
                                           device=dev)
            # -----------------------------------------------------------
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        wall = time.perf_counter() - t0
        launches = launch_counts()
        hist = trainer.tracker.history
        steps = [st for _, st in hist if "gradients/global_norm" in st]
        collections = [st for _, st in hist if "time/exp" in st]
        fns = [v for k, v in trainer._generate_fns.items() if k[0] == "slot_refill"]
        runs[depth] = {
            "depth": depth, "wall_s": wall, "optimizer_steps": len(steps),
            "backend": "dense" if fns and all(f.paged is None for f in fns) else "paged",
            "train_step_ms_median": statistics.median(1e3 * st["time/step"] for st in steps),
            "time_exp_s": [c["time/exp"] for c in collections],
            "rollout_tokens_per_s": [c.get("throughput/rollout_tokens_per_sec")
                                     for c in collections],
            "rollout_overlap_frac": [c["throughput/rollout_overlap_frac"] for c in collections],
            "decode_segment_ms": [1e3 * c["time/generate"] / max(c["rollout/segments"], 1)
                                  for c in collections],
            "kv_cache_bytes": [c["memory/kv_cache_bytes"] for c in collections],
            "launches": launches,
            "store": [(e.query_tensor, e.response_tensor, e.logprobs, e.values, e.rewards)
                      for e in trainer.store.history]}
        if len(steps) != total_steps or not collections:
            problems.append(f"depth {depth}: {len(steps)} steps, {len(collections)} collections")
        if runs[depth]["backend"] != "dense":
            problems.append(f"depth {depth}: the continuous engine was not the dense backend")
        if dev.type == "cuda" and min(launches[k] for k in ENGINE_DENSE_KERNELS) <= 0:
            problems.append(f"depth {depth}: a kernel of the path never launched: {launches}")
        if any(launches[k] for k in SERVE_KERNELS + ("paged_verify",)):
            problems.append(f"depth {depth}: a paged kernel launched: {launches}")
        trainer._close_prompt_iterator()
        del trainer
    a, b = runs[0].pop("store"), runs[2].pop("store")
    unequal = [i for i, (x, y) in enumerate(zip(a, b))
               if not all(np.array_equal(np.asarray(u), np.asarray(w)) for u, w in zip(x, y))]
    if len(a) != len(b) or unequal:
        problems.append(f"stores at depth 0 and 2 differ: {len(a)} / {len(b)} rows, "
                        f"rows {unequal[:4]}")

    # f32: the three continuous paths against the plain generate
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model, cfg = f32["target"], f32["cfg"]
    V = cfg.vocab_size
    gen = GenerationConfig(max_new_tokens=parity_new, do_sample=False, eos_token_id=V - 1,
                           pad_token_id=V - 1)
    ids = np.random.RandomState(6060).randint(0, V - 1, size=(parity_prompts, parity_len))
    ones = np.ones_like(ids)
    plain = generate(model, torch.tensor(ids), torch.tensor(ones), torch.arange(parity_prompts),
                     gen)
    want = [plain.response_tokens[i][plain.response_mask[i] == 1].cpu().numpy()
            for i in range(parity_prompts)]
    parity = {}
    for backend in ("dense", "paged-xla", "paged-pallas"):
        ties = greedy_divergences(model, ids, ones,
                                  dense_engine_answers(model, cfg, ids, gen, dev, backend), want)
        parity[backend] = {"rows_equal_to_plain": parity_prompts - len(ties), "near_ties": ties}
        problems += [f"f32 {backend} row {t['row']} diverges at {t['position']}" for t in ties
                     if t["top2_gap"] >= F32_TIE_GAP]
    rec = {"phase": "slice_engine_dense", "model": spec, "steps": total_steps, "runs": runs,
           "stores_equal": not unequal and len(a) == len(b), "store_rows": len(a),
           "f32_paths": parity, "tie_gap_tol": F32_TIE_GAP, "card": card}
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"slice_engine_dense: {problems}")
    zero_launch_counts()
    return runs[0]["launches"]


def phase_slice_family_spec(model32, cfg32, device="cuda", card="", geo=FAMILY_SPEC_GEO,
                            spec=FAMILY_SPEC, draft_spec=FAMILY_DRAFT_SPEC, draft_kwargs=None):
    """A draft of another family on the speculative engine: ``model32``
    (``slice_family_parity``'s f32 Mistral-7B-width model at one layer) as
    the target, a Llama-family draft of vocabulary 32000 and a quarter of
    its width (``FAMILY_DRAFT_KWARGS``, what ``model.draft_model_extra_kwargs``
    gives the trainer's draft), TF32 off, greedy, the prefix cache on: 4
    prompts of 512 tokens, then their exact repeats (a hit of 496 columns,
    the suffix of 16 prefilled at the hit). Every answer must equal the
    plain greedy ``generate`` token for token (a divergence only at a near
    tie), the repeats must hit, and #1 and #4 must launch (counters set to
    0 once the engine is built)."""
    from trlx_tpu_torch.models.builder import build_causal_lm
    from trlx_tpu_torch.ops.sampling import GenerationConfig, generate

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    draft, draft_cfg = build_causal_lm(draft_spec, seed=11, device=dev, dtype=torch.float32,
                                       **(FAMILY_DRAFT_KWARGS if draft_kwargs is None
                                          else draft_kwargs))
    build_s = time.perf_counter() - t0
    V = cfg32.vocab_size
    if draft_cfg.vocab_size != V:
        raise AssertionError(f"draft vocabulary {draft_cfg.vocab_size} != {V}")
    n, P = geo["n_prompts"], geo["prompt_len"]
    base = np.random.RandomState(8080).randint(3, V, size=(n, P))
    ids = np.concatenate([base, base])
    ones = np.ones_like(ids)
    gen = GenerationConfig(max_new_tokens=geo["max_new"], do_sample=False, eos_token_id=2,
                           pad_token_id=2)
    engine = spec_prefix_engine(model32, draft, draft_cfg, cfg32, dev, geo, gen)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    zero_launch_counts()
    engine.begin_collection()
    t0 = time.perf_counter()
    # -- the main path -----------------------------------------------------
    engine.enqueue_prompts(ids, ones, np.arange(len(ids)))
    done = {c.index: c for c in engine.run()}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    # -----------------------------------------------------------------------
    wall = time.perf_counter() - t0
    launches = launch_counts()
    got = [done[i].tokens[done[i].mask == 1] for i in range(len(ids))]
    plain = generate(model32, torch.tensor(base), torch.tensor(ones[:n]), torch.arange(n), gen)
    want = [plain.response_tokens[i][plain.response_mask[i] == 1].cpu().numpy()
            for i in range(n)] * 2
    ties = greedy_divergences(model32, ids, ones, got, want)
    st = engine.stats
    rec = {"phase": "slice_family_spec", "target": spec, "target_layers":
           cfg32.num_layers, "draft": draft_spec, "draft_kwargs": draft_kwargs or
           FAMILY_DRAFT_KWARGS, "draft_build_s": build_s, "dtype": "float32", "tf32": False,
           "geometry": geo, "wall_s": wall, "rows_equal_to_plain": len(ids) - len(ties),
           "near_ties": ties, "tie_gap_tol": F32_TIE_GAP,
           "prefix_hit_rate": st.prefix_hit_rate, "prefix_tokens_saved": st.prefix_tokens_saved,
           "spec_acceptance_rate": st.spec_acceptance_rate,
           "spec_tokens_per_round": st.spec_tokens_per_round,
           "decode_round_ms_mean": 1e3 * st.decode_s / max(st.decode_steps, 1),
           "launches": launches, "card": card}
    problems = [f"row {t['row']} diverges at {t['position']}" for t in ties
                if t["top2_gap"] >= F32_TIE_GAP]
    if st.prefix_hit_blocks <= 0:
        problems.append("the repeated prompts did not hit")
    if dev.type == "cuda" and min(launches[k] for k in FAMILY_SPEC_KERNELS) <= 0:
        problems.append(f"a kernel of the path never launched: {launches}")
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"slice_family_spec: {problems}")
    zero_launch_counts()
    return {k: launches[k] for k in REPLACES}


# ---------------------------------------------------------------------------
# the serial slice — PPO at the presets' own settings
# ---------------------------------------------------------------------------

# the preset path's kernels: the flash forward (dense-cache prefill, scoring,
# train forward) and backward; every other kernel must stay idle there
SERIAL_KERNELS = ("flash_fwd", "flash_bwd")
SERIAL_IDLE = tuple(k for k in REPLACES if k not in SERIAL_KERNELS)
# two collections of 128 rollouts (batch 32, 4 PPO epochs: 16 steps each)
SERIAL_STEPS, SERIAL_CHECKPOINT, SERIAL_PROMPTS = 32, 16, 128


def serial_config(ckpt, spec="builtin:gpt2-small", total_steps=SERIAL_STEPS,
                  checkpoint_interval=SERIAL_CHECKPOINT, **sections):
    """``default_ppo_config()`` as it stands but for ``checkpoint_dir``,
    ``total_steps``, ``checkpoint_interval`` and the model spec (the
    preset's own on the card); ``sections`` evolve it further."""
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    config = default_ppo_config().evolve(
        train=dict(checkpoint_dir=ckpt, total_steps=total_steps,
                   checkpoint_interval=checkpoint_interval),
        model=dict(model_path=spec))
    return config.evolve(**sections) if sections else config


def trained_keys(trainer):
    """The policy's trainable weight tensors (``param_mask``), by name."""
    return [k for k, on in trainer.param_mask.items() if on and k.endswith("weight")]


def profile_collection(trainer, prompts, n_rows):
    """One serial dense generate of ``n_rows`` prompts and its scoring
    forward under ``torch.profiler`` (after one warm-up call): wall ms, the
    card's busy share (the union of the device kernels' intervals over the
    wall time), device launches and the decode steps, and per decode step
    the wall, busy and launches."""
    from torch.profiler import ProfilerActivity, profile

    from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu_torch.profile_serve import _busy_us, device_events

    cfg = trainer.config
    width = cfg.train.seq_length - cfg.method.gen_kwargs["max_new_tokens"]
    batch = next(iter(PromptPipeline(prompts[:n_rows], width, trainer.tokenizer)
                      .create_loader(n_rows)))
    ids, mask = np.asarray(batch["input_ids"]), np.asarray(batch["attention_mask"])

    def run():
        out = trainer.generate_serial(ids, mask)
        gen_s = trainer.last_generate_time
        score = trainer._dispatch_score(out.sequences, mask, out.response_tokens,
                                        out.response_mask)
        torch.cuda.synchronize()
        return out, score, gen_s

    run()
    spans_before = len(trainer.obs.tracer.events())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out, _, gen_s = run()
        wall = time.perf_counter() - t0
    spans = len(trainer.obs.tracer.events()) - spans_before
    events = device_events(prof)
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in events]) * 1e-6
    steps = int(out.response_mask.sum(dim=1).max())
    return {"rows": n_rows, "prompt_width": int(ids.shape[1]), "decode_steps": steps,
            "wall_ms": 1e3 * wall, "generate_ms": 1e3 * gen_s,
            "device_busy_share": busy / wall, "device_idle_share": 1.0 - busy / wall,
            "device_launches": len(events),
            "spans": spans,
            "per_decode_step": {"wall_ms": 1e3 * gen_s / max(steps, 1),
                                "launches": len(events) / max(steps, 1),
                                "spans": spans / max(steps, 1)}}


def phase_slice_serial(device="cuda", spec="builtin:gpt2-small", draft_layers=0, card="",
                       n_prompts=SERIAL_PROMPTS, total_steps=SERIAL_STEPS,
                       checkpoint_interval=SERIAL_CHECKPOINT, sections=None, keep=False):
    """PPO through ``trlx_tpu_torch.train`` on ``default_ppo_config()``
    unchanged but for the checkpoint directory, ``total_steps`` and
    ``checkpoint_interval``: serial dense rollouts pipelined at depth 2,
    prefetch 2, the staged loss. With ``draft_layers`` the same run with
    ``model.draft_model_path`` (the target spec cut to ``draft_layers``)
    and ``engine.speculative`` 0: the serial speculative sampler
    (``slice_serial_spec``). Every kernel counter is set to 0 just before
    and read just after; #5 and #6 must launch and no other kernel may.
    Then, without a draft, one collection's generate and scoring forward
    under the profiler (``profile_collection``). ``sections`` (a CPU rehearsal's smaller
    sizes) evolve the config further. Returns the launches (and, with
    ``keep``, the trainer: ``slice_hf``'s (a) exports its policy)."""
    import shutil

    import trlx_tpu_torch
    from trlx_tpu_torch.profile_train import reward_fn, slice_prompts

    phase = "slice_serial_spec" if draft_layers else "slice_serial"
    dev = torch.device(device)
    ckpt = _scratch_dir(phase)
    sections = dict(sections or {})
    if draft_layers:
        sections["model"] = dict(draft_model_path=spec,
                                 draft_model_extra_kwargs={"num_layers": draft_layers})
    config = serial_config(ckpt, spec, total_steps, checkpoint_interval, **sections)
    prompts = slice_prompts(n_prompts)
    start = {}

    def hook(trainer):
        start.update({k: trainer.model.state_dict()[k].detach().cpu().clone()
                      for k in trained_keys(trainer)})

    if dev.type == "cuda":
        torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    try:
        # -- the main path -----------------------------------------------
        trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, config=config,
                                       init_trainer_hook=hook, device=dev)
        # ---------------------------------------------------------------
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    hist = trainer.tracker.history
    steps = [st for _, st in hist if "gradients/global_norm" in st]
    collections = [st for _, st in hist if "time/exp" in st]
    losses = [st["losses/total_loss"] for st in steps]
    end = trainer.model.state_dict()
    not_moved = [k for k in start if torch.equal(end[k].detach().cpu(), start[k])]
    train = config.train
    # the first step counts the FLOPs and carries no MFU
    mfus = [st["throughput/mfu"] for st in steps if "throughput/mfu" in st]
    rec = {"phase": phase, "model": spec, "dtype": str(trainer.tcfg.dtype).split(".")[-1],
           "settings": {"continuous_batching": train.continuous_batching,
                        "rollout_pipeline_depth": train.rollout_pipeline_depth,
                        "prefetch_batches": train.prefetch_batches,
                        "loss_kernel": config.method.loss_kernel,
                        "num_rollouts": config.method.num_rollouts,
                        "chunk_size": config.method.chunk_size,
                        "batch_size": train.batch_size, "ppo_epochs": config.method.ppo_epochs,
                        "max_new_tokens": config.method.gen_kwargs["max_new_tokens"],
                        "draft_layers": draft_layers,
                        "draft_gamma": config.model.draft_gamma if draft_layers else None},
           "optimizer_steps": len(steps), "rollout_collections": len(collections),
           "losses": losses, "wall_s": wall,
           "train_step_ms_median": statistics.median(1e3 * st["time/step"] for st in steps),
           "mfu": [st.get("throughput/mfu") for st in steps],
           "mfu_median": statistics.median(mfus) if mfus else None,
           "train_step_flops": trainer._train_step_flops,
           "spans": dict(Counter(e["name"] for e in trainer.obs.tracer.events()
                                 if e.get("ph") != "M")),
           "time_exp_s": [c["time/exp"] for c in collections],
           "time_generate_s": [c["time/generate"] for c in collections],
           "rollout_tokens_per_s": [c.get("throughput/rollout_tokens_per_sec")
                                    for c in collections],
           "rollout_overlap_frac": [c["throughput/rollout_overlap_frac"] for c in collections],
           "slot_utilization": [c["throughput/slot_utilization"] for c in collections],
           "kv_cache_bytes": [c["memory/kv_cache_bytes"] for c in collections],
           "loss_kernel_pallas": max(st["train/loss_kernel_pallas"] for st in steps),
           "launches": launches, "trained_weights_unmoved": not_moved, "card": card}
    if draft_layers:
        rec["spec_acceptance_rate"] = [c["rollout/spec_acceptance_rate"] for c in collections]
        rec["spec_rounds"] = [c["rollout/spec_rounds"] for c in collections]
    problems = []
    if len(steps) != total_steps or len(collections) < 2:
        problems.append(f"{len(steps)} steps, {len(collections)} collections")
    if not all(math.isfinite(x) for x in losses):
        problems.append("a non-finite loss")
    if not start or not_moved:
        problems.append(f"trainable weights did not move: {not_moved[:4]}")
    if dev.type == "cuda" and min(launches[k] for k in SERIAL_KERNELS) <= 0:
        problems.append(f"#5 or #6 never launched: {launches}")
    if any(launches[k] for k in SERIAL_IDLE):
        problems.append(f"a kernel off the preset path launched: {launches}")
    if len(mfus) != len(steps) - 1 or not all(0.0 < m <= 1.0 for m in mfus):
        problems.append(f"throughput/mfu outside (0, 1]: {rec['mfu']}")
    if draft_layers and not all(0.0 <= a <= 1.0 for a in rec["spec_acceptance_rate"]):
        problems.append(f"acceptance {rec['spec_acceptance_rate']} outside [0, 1]")
    if dev.type == "cuda" and not problems and not draft_layers:
        rec["profiled_collection"] = profile_collection(trainer, prompts, n_prompts)
        zero_launch_counts()
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"{phase}: {problems}")
    return (launches, trainer) if keep else launches


def phase_slice_serial_spec(device="cuda", spec="builtin:gpt2-small",
                            draft_layers=DRAFT_LAYERS, **kw):
    """``phase_slice_serial`` with a ``draft_layers``-layer draft: the
    serial speculative sampler."""
    return phase_slice_serial(device, spec, draft_layers=draft_layers, **kw)


def greedy_divergences(model32, prompts, masks, got, want):
    """Rows of ``got`` that differ from ``want`` (token lists), each with
    the f32 top-2 gap of ``model32`` at the first differing position of
    ``want`` (phase 4's rule: a divergence is tolerated only at a gap
    below ``F32_TIE_GAP``)."""
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        if np.array_equal(a, b):
            continue
        n = min(len(a), len(b))
        diff = np.nonzero(a[:n] != b[:n])[0]
        pos = min(int(diff[0]) if len(diff) else n, len(b) - 1)
        _, gap2 = f32_gaps(model32, [prompts[i]], [b[: pos + 1]], [masks[i]])[0]
        out.append({"row": i, "position": pos, "top2_gap": float(gap2[pos])})
    return out


def weight_gap(a, b, start):
    """Largest |a − b| over all weight tensors, over the largest change
    from ``start`` of any weight in ``b``; with the tensor where it lies
    and the absolute difference. A resume fault (another step count, other
    data, a lost optimizer state) moves every trained tensor by about its
    own update; rounding noise in gradients that are zero in exact
    arithmetic (the key biases), which Adam's normalisation turns into
    small steps, stays orders of magnitude below the largest change (two
    uninterrupted CPU runs differ by ~1e-7 there)."""
    moved = max(float((b[k] - start[k]).abs().max()) for k in b)
    name, biggest = None, 0.0
    for k in b:
        err = float((a[k] - b[k]).abs().max())
        if not err <= biggest:
            name, biggest = k, err
    return biggest / moved, name, biggest


# the f32 parity phases of the preset paths run GPT-2 small's width at 3
# of its 12 layers (slice_parallel_rl's time): every check compares two
# paths on one model, and with the presets' 2 unfrozen layers one block
# stays frozen, so the hydra reference branch still starts mid-stack and
# the gradient still stops at the frozen boundary
PARITY_LAYERS = 3


def phase_slice_serial_parity(device="cuda", spec="builtin:gpt2-small", card="",
                              draft_layers=DRAFT_LAYERS, n_prompts=SERIAL_PROMPTS,
                              greedy_rows=16, total_steps=SERIAL_STEPS,
                              checkpoint_interval=SERIAL_CHECKPOINT, parity_rows=16,
                              sections=None, layers=PARITY_LAYERS):
    """The preset path in f32 with TF32 off (``parallel.compute_dtype``
    float32): (a) the store of one collection at pipeline depth 0 equals
    the one at depth 2, element for element; (b) one batch of that store
    card against CPU (``phase_slice_train_parity``: the staged loss, #5 and
    #6); (c) the serial greedy answers equal the paged engine's token for
    token; (d) the serial speculative sampler's greedy answers equal the
    plain ``generate``'s, and with the target as its own draft the
    acceptance is exactly 1.0; (e) ``grad_accum`` 2 on a batch against the
    mean of ``grad_accum`` 1 on its two halves, within
    ``PARITY_GRAD_RTOL``; (f) a run resumed from its step-16 checkpoint in
    a fresh ``train`` against the uninterrupted run: the final weights
    within ``PARITY_GRAD_RTOL`` of the run's largest weight change
    (``weight_gap``),
    ``kl_ctl``, the running moments and ``iter_count`` exactly. Divergences
    in (c) and (d) are tolerated only at f32 near ties (phase 4's rule).
    The model runs ``layers`` of its layers (``PARITY_LAYERS``; None: all).
    ``sections`` (a CPU rehearsal's smaller sizes) evolve every config."""
    import shutil

    import trlx_tpu_torch
    from trlx_tpu_torch.ops.sampling import generate
    from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu_torch.profile_train import reward_fn, slice_prompts
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    def f32(**more):
        """``sections`` with f32 compute, the cut depth and ``more`` merged
        in."""
        out = {k: dict(v) for k, v in (sections or {}).items()}
        if layers:
            out.setdefault("model", {})["model_extra_kwargs"] = dict(num_layers=layers)
        for k, v in {"parallel": dict(compute_dtype="float32"), **more}.items():
            out.setdefault(k, {}).update(v)
        return out

    prompts = slice_prompts(n_prompts)
    rec, problems = {"phase": "slice_serial_parity", "model": spec, "dtype": "float32",
                     "tf32": False, "card": card}, []

    def width(config):
        return config.train.seq_length - config.method.gen_kwargs["max_new_tokens"]

    def trainer_at(depth=0, **sections):
        # these trainers save nothing: the directory is never made
        config = serial_config(os.path.join(ROOT, "build", "chip_smoke_serial_parity"), spec,
                               total_steps, checkpoint_interval, **f32(**sections))
        config.train.rollout_pipeline_depth = depth
        trainer = PPOTrainer(config=config, reward_fn=reward_fn, device=dev)
        trainer.add_prompt_pipeline(PromptPipeline(prompts, width(config), trainer.tokenizer))
        return trainer


    # (a) depth 0 against depth 2
    stores, launches_a = {}, {}
    for depth in (0, 2):
        t = trainer_at(depth)
        zero_launch_counts()
        t.make_experience(t.config.method.num_rollouts)
        launches_a[depth] = launch_counts()
        stores[depth] = t
    a, b = stores[0].store.history, stores[2].store.history
    fields = ("query_tensor", "response_tensor", "logprobs", "values", "rewards")
    equal = len(a) == len(b) and all(np.array_equal(getattr(x, f), getattr(y, f))
                                     for x, y in zip(a, b) for f in fields)
    rec["a_depth0_vs_depth2"] = {"rows": [len(a), len(b)], "equal": bool(equal),
                                 "launches": launches_a[2]}
    if not equal:
        problems.append("(a) the depth-2 store differs from depth 0")
    trainer = stores[0]
    stores[2]._close_prompt_iterator()
    del stores

    # (b) one batch card against CPU, the staged loss
    rec["b_train_parity"] = phase_slice_train_parity(
        trainer, card=device, phase="slice_serial_train_parity", rows=parity_rows,
        kernels=SERIAL_KERNELS)

    # (c) serial greedy against the paged engine, one prompt batch
    batch = next(iter(PromptPipeline(prompts[:greedy_rows], width(trainer.config),
                                     trainer.tokenizer).create_loader(greedy_rows)))
    ids, mask = np.asarray(batch["input_ids"]), np.asarray(batch["attention_mask"])

    def rows(out):
        return [out["response_tokens"][i][out["response_mask"][i] == 1]
                for i in range(len(ids))]

    serial = rows(trainer.generate(ids, mask, do_sample=False))
    trainer.config.train.continuous_batching = True
    paged = rows(trainer.generate(ids, mask, do_sample=False))
    trainer.config.train.continuous_batching = False
    ties = greedy_divergences(trainer.model, ids, mask, serial, paged)
    rec["c_serial_vs_paged"] = {"rows": len(ids), "divergences": ties,
                                "tie_gap_tol": F32_TIE_GAP}
    problems += [f"(c) row {t['row']} diverges at {t['position']}" for t in ties
                 if t["top2_gap"] >= F32_TIE_GAP]

    # (e) grad_accum 2 against the mean of grad_accum 1 on the halves
    full = trainer._device_batch(next(iter(trainer.store.create_loader(
        trainer.config.train.batch_size))))
    half = trainer.config.train.batch_size // 2
    grads = []
    for part in ({k: v[:half] for k, v in full.items()}, {k: v[half:] for k, v in full.items()}):
        trainer.config.train.grad_accum = 1
        trainer.accumulate_grads(part)
        grads.append({n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()
                      if p.grad is not None})
    trainer.config.train.grad_accum = 2
    trainer.accumulate_grads(full)
    trainer.config.train.grad_accum = 1
    got = {n: p.grad.detach() for n, p in trainer.model.named_parameters()
           if p.grad is not None}
    if not got.keys() == grads[0].keys() == grads[1].keys():
        problems.append("(e) the passes gave gradients to different parameters")
    want = {n: (grads[0][n] + grads[1][n]) / 2 for n in got}
    gmax = max(float(g.abs().max()) for g in want.values())
    worst, worst_name = 0.0, None
    for n in want:
        rel = float((got[n] - want[n]).abs().max()) / max(float(want[n].abs().max()),
                                                           1e-5 * gmax)
        if not rel <= worst:
            worst, worst_name = rel, n
    trainer.model.zero_grad(set_to_none=True)
    rec["e_grad_accum"] = {"rows": 2 * half, "worst_grad_rel_err": worst,
                           "worst_grad": worst_name, "grad_rtol": PARITY_GRAD_RTOL}
    if not worst <= PARITY_GRAD_RTOL:
        problems.append(f"(e) grad_accum 2: {worst_name} relative {worst}")
    trainer._close_prompt_iterator()
    del trainer, full, grads, got, want

    # (d) the serial speculative sampler, greedy
    spec_t = trainer_at(model=dict(draft_model_path=spec,
                                   draft_model_extra_kwargs={"num_layers": draft_layers}))
    G = int(spec_t.config.model.draft_gamma)
    zero_launch_counts()
    got = rows(spec_t.generate(ids, mask, do_sample=False))
    draft_stats = dict(spec_t.last_generate_stats)
    gen_config, _ = spec_t._resolve_gen_config(do_sample=False)
    plain = generate(spec_t.model, torch.tensor(ids), torch.tensor(mask),
                     torch.zeros(len(ids), dtype=torch.int64), gen_config)
    want = [plain.response_tokens[i][plain.response_mask[i] == 1].cpu().numpy()
            for i in range(len(ids))]
    ties = greedy_divergences(spec_t.model, ids, mask, got, want)
    n_self = len(ids) // 2
    max_new = gen_config.max_new_tokens
    spec_t.draft_model, spec_t.draft_tcfg = spec_t.model.backbone, spec_t.tcfg
    spec_t.generate(ids[:n_self], mask[:n_self], do_sample=False, eos_token_id=None)
    self_stats = dict(spec_t.last_generate_stats)
    rec["d_serial_spec"] = {"rows": len(ids), "draft_layers": draft_layers, "gamma": G,
                            "divergences": ties, "draft": draft_stats,
                            "self_draft": {"rows": n_self, **self_stats},
                            "launches": launch_counts()}
    problems += [f"(d) row {t['row']} diverges at {t['position']}" for t in ties
                 if t["top2_gap"] >= F32_TIE_GAP]
    if max_new % (G + 1) == 0 and self_stats["rollout/spec_acceptance_rate"] != 1.0:
        problems.append(f"(d) self-draft acceptance {self_stats['rollout/spec_acceptance_rate']}")
    del spec_t

    # (f) resume from the step-16 checkpoint against the uninterrupted run
    runs = {}
    for name in ("uninterrupted", "resumed"):
        ckpt = _scratch_dir(f"serial_{name}")
        if name == "resumed":
            step_dir = f"checkpoint_{checkpoint_interval:0{len(str(total_steps))}d}"
            shutil.copytree(os.path.join(runs["uninterrupted"]["ckpt"], step_dir),
                            os.path.join(ckpt, step_dir))
        config = serial_config(ckpt, spec, total_steps, checkpoint_interval,
                               **f32(train=dict(resume_from_checkpoint=name == "resumed")))
        start = {}

        def hook(t):
            start.update({k: v.detach().cpu().clone() for k, v in t.model.state_dict().items()})

        t = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, config=config,
                                 init_trainer_hook=hook, device=dev)
        rm = t.running_moments
        runs[name] = {"ckpt": ckpt, "start": start,
                      "weights": {k: v.detach().cpu() for k, v in t.model.state_dict().items()},
                      "exact": {"iter_count": t.iter_count, "step": t.step,
                                "kl_ctl": t.kl_ctl.value,
                                "running_moments": [rm.mean, rm.var, rm.std, rm.count],
                                "prompt_chunks_drawn": t._prompt_chunks_drawn}}
        del t
    worst, name, biggest = weight_gap(runs["resumed"]["weights"], runs["uninterrupted"]["weights"],
                                      runs["uninterrupted"]["start"])
    rec["f_resume"] = {"exact": {k: runs[k]["exact"] for k in runs},
                       "weights_diff_over_largest_change": worst, "weights_worst": name,
                       "weights_max_abs_diff": biggest, "rtol": PARITY_GRAD_RTOL}
    for run in runs.values():
        shutil.rmtree(run["ckpt"], ignore_errors=True)
    if runs["resumed"]["exact"] != runs["uninterrupted"]["exact"]:
        problems.append(f"(f) resumed state {runs['resumed']['exact']} != "
                        f"{runs['uninterrupted']['exact']}")
    if not worst <= PARITY_GRAD_RTOL:
        problems.append(f"(f) resumed weights: {name} off by {worst} of the largest change")
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"slice_serial_parity: {problems}")
    zero_launch_counts()
    return rec


# ---------------------------------------------------------------------------
# phase 8: the offline slices — SFT and ILQL through trlx.train(samples=...)
# ---------------------------------------------------------------------------

# the kernels of the offline paths: training (flash), evaluation (engine)
OFFLINE_KERNELS = ("flash_fwd", "flash_bwd") + SERVE_KERNELS


def offline_dialogs(n, lo, hi, seed):
    """``n`` seeded [prompt, output] dialogues of lowercase bytes, ``lo`` to
    ``hi`` bytes in all (the eos appended by the tokenizer may add one),
    and a reward per dialogue (the output's share of vowels)."""
    rs = np.random.RandomState(seed)
    dialogs, rewards = [], []
    for _ in range(n):
        total = int(rs.randint(lo, hi))
        cut = int(rs.randint(1, max(total // 4, 2)))
        text = "".join(chr(c) for c in rs.randint(97, 123, size=total - 1))
        dialogs.append([text[:cut], text[cut:]])
        rewards.append(sum(ch in "aeiou" for ch in text[cut:]) / max(len(text) - cut, 1))
    return dialogs, rewards


def offline_launch_problems(trainer, launches, dev):
    """The offline path's kernels launched, and #1–#3 exactly as often as
    the engine's gauges (summed over the evals) plus its no-op prewarm
    refills say."""
    from trlx_tpu_torch.engine.core import ContinuousEngine

    names = {"paged_prefill": "eval/prefill_kernel_launches",
             "paged_decode": "eval/decode_kernel_launches",
             "fused_sample": "eval/sample_kernel_launches"}
    gauges = {k: sum(int(st.get(name, 0)) for _, st in trainer.tracker.history)
              for k, name in names.items()}
    for engine in trainer._generate_fns.values():
        if isinstance(engine, ContinuousEngine):
            for k in gauges:
                gauges[k] += engine.prewarm_launches[k]
    problems = []
    if gauges != {k: launches[k] for k in gauges}:
        problems.append(f"engine gauges + prewarm {gauges} != wrapper counts {launches}")
    if dev.type == "cuda" and min(launches[k] for k in OFFLINE_KERNELS) <= 0:
        problems.append(f"a kernel of the path never launched: {launches}")
    return problems, gauges


def _scratch_dir(tag):
    import tempfile

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    return tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_", dir=os.path.join(ROOT, "build"))


def offline_slice(phase, config, samples, dev, card, check, profile_steps=3,
                  loss_key="losses/loss", **train_kwargs):
    """``trlx_tpu_torch.train(samples=...)`` on ``config`` with its
    checkpoints in a scratch directory (removed after), every kernel
    counter set to 0 just before and read just after; then
    ``profile_steps`` steps of one batch under ``torch.profiler`` (on the
    card). ``check(trainer, steps)`` returns ``(problems, fields)`` of the
    method; ``loss_key`` names its logged loss. Emits the phase's record; returns the trainer and the
    launches."""
    import shutil

    import trlx_tpu_torch
    from trlx_tpu_torch.profile_train import profile_steps as profile

    ckpt = _scratch_dir(phase)
    config = config.evolve(train=dict(checkpoint_dir=ckpt, tracker=None))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    try:
        # -- the main path -----------------------------------------------
        trainer = trlx_tpu_torch.train(samples=samples, config=config, device=dev,
                                       **train_kwargs)
        # ---------------------------------------------------------------
        if dev.type == "cuda":
            torch.cuda.synchronize()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    hist = trainer.tracker.history
    steps = [st for _, st in hist if "gradients/global_norm" in st]
    step_ms = [1e3 * st["time/step"] for st in steps]
    problems, gauges = offline_launch_problems(trainer, launches, dev)
    if len(steps) != config.train.total_steps:
        problems.append(f"{len(steps)} optimizer steps, not {config.train.total_steps}")
    if not all(math.isfinite(st[loss_key]) for st in steps):
        problems.append("a non-finite loss")
    method_problems, fields = check(trainer, steps)
    problems += method_problems
    prof = {}
    if dev.type == "cuda":
        trainer.prepare_learning()
        prof = profile(trainer, next(iter(trainer.train_dataloader)), profile_steps)
    rec = {"phase": phase, "model": config.model.model_path,
           "dtype": str(trainer.tcfg.dtype).split(".")[-1],
           "seq_length": config.train.seq_length, "batch_size": config.train.batch_size,
           "samples": len(samples), "optimizer_steps": len(steps),
           "losses": [st[loss_key] for st in steps], **fields, "wall_s": wall,
           "train_step_ms_median": statistics.median(step_ms), "train_step_ms": step_ms,
           "train_tokens_per_s_median": statistics.median(
               st["throughput/tokens_per_sec"] for st in steps),
           "eval_generate_s": [st["time/generate"] for _, st in hist if "time/generate" in st],
           "eval_gen_kwargs": config.method.gen_kwargs,
           "launches": launches, "engine_gauges_plus_prewarm": gauges,
           "profile": {k: prof[k] for k in ("train_step_ms_median", "device_busy_ms_per_step",
                                             "device_busy_share", "device_busy_share_untraced",
                                             "device_launches_per_step",
                                             "device_ms_per_step_by_group", "top_kernels")
                       if k in prof},
           "card": card}
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"{phase}: {problems}")
    return trainer, launches


def phase_slice_sft(device="cuda", spec="builtin:gpt2-small", total_steps=12, n_dialogs=96,
                    seq_length=None, card=""):
    """SFT through ``trlx_tpu_torch.train(samples=...)`` on
    ``default_sft_config()`` (seq_length 1024, batch 8, bf16 over f32
    masters), cut to ``total_steps``; the eval of 8 prompts at 40 new
    tokens before and after. The loss must fall from the first step to the
    last. Returns the trainer and the launches."""
    from trlx_tpu_torch.data.default_configs import default_sft_config

    train = dict(total_steps=total_steps)
    if seq_length:
        train["seq_length"] = seq_length
    config = default_sft_config().evolve(train=train, model=dict(model_path=spec))
    T = config.train.seq_length
    samples, _ = offline_dialogs(n_dialogs, T // 4, T, seed=808)

    def check(trainer, steps):
        first, last = steps[0]["losses/loss"], steps[-1]["losses/loss"]
        return ([] if last < first else [f"loss {first} → {last}: not lower"],
                {"loss_first": first, "loss_last": last})

    return offline_slice("slice_sft", config, samples, torch.device(device), card, check,
                         eval_prompts=[s[0][:16] for s in samples[:8]])


def _target_fingerprint(model):
    """The first 4096 entries of every target-Q head parameter (a sync
    moves every entry whose Q-head twin moved)."""
    heads = model.ilql_heads
    return torch.cat([p.detach().flatten()[:4096].clone()
                      for name, p in heads.named_parameters() if name.startswith("target_q")])


def phase_slice_ilql(device="cuda", spec="builtin:gpt2-small", total_steps=12, n_dialogs=1024,
                     card=""):
    """ILQL through ``trlx_tpu_torch.train(samples=..., rewards=...)`` on
    ``default_ilql_config()`` (seq_length 64, batch 128, twin Q heads,
    target syncs every 5 steps, bf16 over f32 masters), cut to
    ``total_steps``; the eval (β 1, top-k 20, 56 new tokens) before and
    after. The target heads must change after steps 5 and 10 and at no
    other step. Returns the trainer and the launches."""
    from trlx_tpu_torch.data.default_configs import default_ilql_config

    config = default_ilql_config().evolve(train=dict(total_steps=total_steps),
                                          model=dict(model_path=spec))
    T = config.train.seq_length
    samples, rewards = offline_dialogs(n_dialogs, T // 4, T, seed=909)
    prints = {}

    def hook(trainer):  # target-head fingerprints after each batch's callback
        callback = trainer.post_backward_callback
        prints[0] = _target_fingerprint(trainer.model)

        def recording():
            callback()
            prints[trainer.iter_count] = _target_fingerprint(trainer.model)

        trainer.post_backward_callback = recording

    def check(trainer, steps):
        every = config.method.steps_for_target_q_sync
        its = sorted(prints)[1:]
        changed = [it for it in its if not torch.equal(prints[it], prints[it - 1])]
        want = [it for it in its if it % every == 0]
        return ([] if changed == want else
                [f"target heads changed after steps {changed}, not {want}"],
                {"two_qs": config.method.two_qs, "target_sync_steps": changed})

    return offline_slice("slice_ilql", config, samples, torch.device(device), card, check,
                         rewards=rewards, init_trainer_hook=hook)


def ilql_greedy_gaps(model, hook, prompt, tokens):
    """The top-2 gaps of the ILQL-shaped logits (``hook`` applied to the
    f32 model's outputs) at each response position of ``prompt`` followed
    by ``tokens``, teacher-forced on the CPU."""
    ids = torch.tensor(np.concatenate([prompt, tokens])[None], dtype=torch.int64)
    with torch.no_grad():
        out = model(ids)
    P = len(prompt)
    gaps = []
    for pos in range(P - 1, P - 1 + len(tokens)):
        step_out = {"target_qs": tuple(q[:, pos] for q in out["target_qs"]),
                    "vs": out["vs"][:, pos]}
        shaped = hook(step_out, out["logits"][:, pos])[0]
        top2 = torch.topk(shaped, 2).values
        gaps.append(float(top2[0] - top2[1]))
    return gaps


def phase_slice_offline_parity(sft, ilql, card="cuda", sft_rows=2, ilql_rows=16,
                               n_prompts=16, max_new=24):
    """f32, TF32 off. (a) One collated batch of each offline store (SFT:
    ``sft_rows`` rows of 1024 tokens, right-padded; ILQL: ``ilql_rows``)
    through ``loss_fn`` and backward on the card and on the CPU: loss and
    stats within 1e-4, gradients within 1e-3, as ``slice_train_parity``
    holds PPO. (b) The ILQL model's greedy eval answers (β 1, top-k 20) on
    the card's paged engine equal the plain dense ``generate`` on the CPU
    with the same hook, token for token; a divergence is tolerated only at
    a near tie of the plain path's top-2 shaped logits."""
    from trlx_tpu_torch.models.heads import CausalLMWithILQLHeads
    from trlx_tpu_torch.models.transformer import CausalTransformer
    from trlx_tpu_torch.ops.paged_kv import PagedSpec, num_table_blocks
    from trlx_tpu_torch.ops.sampling import GenerationConfig, generate
    from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns
    from trlx_tpu_torch.engine.core import ContinuousEngine

    problems, rec = [], {"phase": "slice_offline_parity", "card": card}
    batch = next(iter(sft.store.create_loader(sft_rows)))
    res = card_cpu_backward(sft, CausalTransformer, batch, card)
    p, fields = compare_card_cpu(res, card, ("flash_fwd", "flash_bwd"))
    problems += [f"sft: {x}" for x in p]
    rec["sft"] = {"batch": list(batch["input_ids"].shape), **fields}
    del res
    batch = next(iter(ilql.store.create_loader(ilql_rows)))
    relu = CardReluBranches()
    two_qs = ilql.config.method.two_qs
    res = card_cpu_backward(ilql, lambda c: CausalLMWithILQLHeads(c, two_qs), batch, card, relu)
    p, fields = compare_card_cpu(res, card, ("flash_fwd", "flash_bwd"))
    problems += [f"ilql: {x}" for x in relu.problems() + p]
    rec["ilql"] = {"batch": list(batch.input_ids.shape), **fields,
                   "relu_branches_from_card": relu.taken,
                   "relu_pre_max_there": relu.taken_pre_max}
    del res

    # (b) greedy answers through the hook: the card's engine, the CPU's
    # plain dense generate
    cfg32 = dataclasses.replace(ilql.tcfg, dtype=torch.float32, attention_impl="auto")
    state = {k: v.detach().cpu() for k, v in ilql.model.state_dict().items()}
    hook = ilql.adjust_logits_fn({"beta": 1.0})
    tok = ilql.tokenizer
    gen = GenerationConfig(max_new_tokens=max_new, top_k=20, do_sample=False,
                           eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id)
    rs = np.random.RandomState(5150)
    P = ilql.config.train.seq_length - ilql.config.method.gen_kwargs["max_new_tokens"]
    prompts = np.full((n_prompts, P), tok.pad_token_id, np.int64)
    pmask = np.zeros((n_prompts, P), np.int64)
    for i in range(n_prompts):
        n = int(rs.randint(1, P + 1))
        prompts[i, P - n:] = rs.randint(97, 123, size=n)
        pmask[i, P - n:] = 1
    models = {}
    for key, dev in (("card", torch.device(card)), ("cpu", torch.device("cpu"))):
        m = CausalLMWithILQLHeads(cfg32, two_qs)
        m.load_state_dict(state)
        models[key] = m.to(dev).eval().requires_grad_(False)
    zero_launch_counts()
    paged = PagedSpec(16, 1 + 8 * num_table_blocks(P + max_new, 16))
    fns = make_slot_refill_fns(cfg32, 8, P, gen, adjust_logits=hook, segment_len=8,
                               paged=paged, device=torch.device(card))
    engine = ContinuousEngine(fns, models["card"], tok.pad_token_id)
    engine.enqueue_prompts(prompts, pmask, np.arange(n_prompts))
    got = {c.index: c for c in engine.run()}
    engine_launches = launch_counts()
    plain = generate(models["cpu"], torch.tensor(prompts), torch.tensor(pmask),
                     torch.arange(n_prompts), gen, adjust_logits=hook)
    plain_tok = plain.response_tokens.numpy()
    plain_mask = plain.response_mask.numpy()
    ties, rows_equal, answered = [], 0, 0
    for i in range(n_prompts):
        a = got[i].tokens[got[i].mask == 1]
        b = plain_tok[i][plain_mask[i] == 1]
        answered += len(b)
        if np.array_equal(a, b):
            rows_equal += 1
            continue
        n = min(len(a), len(b))
        diff = np.nonzero(a[:n] != b[:n])[0]
        pos = min(int(diff[0]) if len(diff) else n, len(b) - 1)
        gaps = ilql_greedy_gaps(models["cpu"], hook, prompts[i][pmask[i] == 1], b[: pos + 1])
        ties.append({"prompt": i, "position": pos, "top2_gap": gaps[pos]})
    problems += [f"greedy prompt {t['prompt']} diverges at {t['position']}" for t in ties
                 if t["top2_gap"] >= F32_TIE_GAP]
    if torch.device(card).type == "cuda" and min(
            engine_launches[k] for k in SERVE_KERNELS) <= 0:
        problems.append(f"the engine's kernels did not all launch: {engine_launches}")
    rec["ilql_greedy"] = {"prompts": n_prompts, "max_new_tokens": max_new, "beta": 1.0,
                          "top_k": 20, "tokens_answered": answered,
                          "rows_equal_to_plain": rows_equal, "near_ties": ties,
                          "tie_gap_tol": F32_TIE_GAP, "launches": engine_launches}
    del engine
    rec["ilql_spec"], spec_problems = ilql_speculative(ilql, models, prompts, pmask, gen, hook,
                                                       plain_tok, plain_mask, card)
    problems += spec_problems
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"slice_offline_parity: {problems}")
    zero_launch_counts()
    return rec


ILQL_DRAFT_LAYERS = 2


def ilql_speculative(ilql, models, prompts, pmask, gen, hook, plain_tok, plain_mask, card):
    """ILQL's speculative sampling (JAX ``generate``'s draft path): a
    ``ILQL_DRAFT_LAYERS``-layer draft of the policy's spec. (1) f32 on the
    card, greedy: ``generate_speculative`` with ILQL's hook on the
    verify distributions answers as the CPU's plain hooked ``generate``
    (``plain_tok``), a divergence only at a near tie of the shaped logits;
    (2) the trainer's own ``generate`` with the draft in its place (bf16,
    its eval settings): it samples through the serial speculative sampler
    (the acceptance gauge appears) and #5 launches there (the target's and
    the draft's dense prefills). Returns (record, problems)."""
    from trlx_tpu_torch.models.builder import build_causal_lm
    from trlx_tpu_torch.ops.speculative import generate_speculative

    dev = torch.device(card)
    spec = ilql.config.model.model_path
    draft32, _ = build_causal_lm(spec, seed=17, device=dev, dtype=torch.float32,
                                 num_layers=ILQL_DRAFT_LAYERS)
    gamma = int(ilql.config.model.draft_gamma)
    out, stats = generate_speculative(models["card"], draft32, torch.tensor(prompts),
                                      torch.tensor(pmask), torch.arange(len(prompts)), gen,
                                      gamma=gamma, return_stats=True, adjust_logits=hook)
    tok, mask = out.response_tokens.cpu().numpy(), out.response_mask.cpu().numpy()
    ties, problems = [], []
    for i in range(len(prompts)):
        a, b = tok[i][mask[i] == 1], plain_tok[i][plain_mask[i] == 1]
        if np.array_equal(a, b):
            continue
        n = min(len(a), len(b))
        diff = np.nonzero(a[:n] != b[:n])[0]
        pos = min(int(diff[0]) if len(diff) else n, len(b) - 1)
        gaps = ilql_greedy_gaps(models["cpu"], hook, prompts[i][pmask[i] == 1], b[: pos + 1])
        ties.append({"prompt": i, "position": pos, "top2_gap": gaps[pos]})
    problems += [f"speculative greedy prompt {t['prompt']} diverges at {t['position']}"
                 for t in ties if t["top2_gap"] >= F32_TIE_GAP]
    del draft32
    # (2) the trainer's entry point, sampling as its evaluation does
    draft16, draft_cfg = build_causal_lm(spec, seed=17, device=dev, dtype=ilql.tcfg.dtype,
                                         num_layers=ILQL_DRAFT_LAYERS)
    ilql.draft_model, ilql.draft_tcfg = draft16, draft_cfg
    ilql._generate_fns.clear()
    try:
        if dev.type == "cuda":
            torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        answers = ilql.generate(prompts, pmask, eval_mode=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        gstats = dict(ilql.last_generate_stats)
    finally:
        ilql.draft_model, ilql.draft_tcfg = None, None
        ilql._generate_fns.clear()
    if "rollout/spec_acceptance_rate" not in gstats:
        problems.append(f"the trainer's generate did not speculate: {gstats}")
    if dev.type == "cuda" and launches["flash_fwd"] <= 0:
        problems.append(f"#5 never launched in the speculative sampler: {launches}")
    if any(launches[k] for k in SERVE_KERNELS + ("paged_verify",)):
        problems.append(f"a paged kernel launched in the serial sampler: {launches}")
    rec = {"draft_layers": ILQL_DRAFT_LAYERS, "gamma": gamma,
           "greedy_f32": {"rows_equal_to_plain": len(prompts) - len(ties), "near_ties": ties,
                          "acceptance": stats["acceptance_rate"],
                          "tokens_per_round": stats["tokens_per_round"]},
           "trainer_generate": {"wall_s": wall, "gen_kwargs": dict(ilql.generate_kwargs),
                                "tokens": int(answers["response_mask"].sum()),
                                "spec_acceptance_rate": gstats.get(
                                    "rollout/spec_acceptance_rate"),
                                "spec_rounds": gstats.get("rollout/spec_rounds"),
                                "launches": launches}}
    return rec, problems


# the acceptance runs' settings: benchmarks/randomwalks/PPO_CURVE.json's
# config for PPO (its warm start: min(400, 2 · 160) SFT steps), and
# tests/test_examples.py::test_ilql_randomwalks_learns' for ILQL. One
# departure from PPO_CURVE.json, which sets no chunk_size (the example's
# 128 applies): chunk_size 64, num_rollouts. A collection on the
# the example's own settings (tasks/ppo_randomwalks.py: serial rollouts at
# pipeline depth 2, the staged loss, chunks of 128), cut to 160 steps; the
# port ends at 0.98 and 0.96 over two seeds there on the CPU
# (tests/randomwalks_curves.py, PERF.md §6)
RANDOMWALKS_PPO = {"train.total_steps": 160, "train.eval_interval": 8}
# the card's reading of the continuous path with chunks of 128, which keep
# each chunk's shortest answers (PERF.md §6), printed beside the new one
RANDOMWALKS_PPO_CONTINUOUS_128 = 0.714
RANDOMWALKS_ILQL = {"train.total_steps": 160, "train.epochs": 100,
                    "train.eval_interval": 20, "train.batch_size": 32,
                    "method.gen_kwargs.temperature": 0.05}
# the bars: the PPO curve's last three evals at a mean optimality of at
# least 0.9 (the JAX run went 0.078 → 0.99); ILQL's last three above its
# first two by more than 0.1 (the JAX slow test's bound)
RANDOMWALKS_PPO_BAR, RANDOMWALKS_ILQL_LIFT = 0.9, 0.1


def phase_slice_randomwalks(device="cuda", ppo=None, ilql=None, card=""):
    """The acceptance runs on the randomwalks model (six layers, hidden
    144, head dim 12): ``tasks/ppo_randomwalks.py`` (SFT warm start, then
    PPO on the example's settings: serial rollouts pipelined at depth 2,
    the staged loss, chunks of 128) and ``tasks/ilql_randomwalks.py``, each through
    ``trlx_tpu_torch.train`` with the kernel counters set to 0 just before
    and read just after. Returns the launches of each."""
    import shutil

    from trlx_tpu_torch.tasks import ilql_randomwalks, ppo_randomwalks

    dev = torch.device(device)
    out, problems = {"phase": "slice_randomwalks", "card": card}, []
    for name, main, hparams in (("ppo", ppo_randomwalks.main, ppo or RANDOMWALKS_PPO),
                                ("ilql", ilql_randomwalks.main, ilql or RANDOMWALKS_ILQL)):
        ckpt = _scratch_dir(f"randomwalks_{name}")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        try:
            # -- the main path -------------------------------------------
            trainer = main({**hparams, "train.checkpoint_dir": ckpt}, device=dev)
            # -----------------------------------------------------------
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        curve = [st["metrics/optimality"] for _, st in trainer.tracker.history
                 if "metrics/optimality" in st]
        first, last = float(np.mean(curve[:2])), float(np.mean(curve[-3:]))
        steps = [st for _, st in trainer.tracker.history if "gradients/global_norm" in st]
        out[name] = {"hparams": hparams, "optimality_curve": curve, "first_two_mean": first,
                     "last_three_mean": last, "optimizer_steps": len(steps),
                     "train_step_ms_median": statistics.median(
                         1e3 * st["time/step"] for st in steps),
                     "head_dim": trainer.tcfg.dims_per_head, "wall_s": wall,
                     "launches": launches}
        if name == "ppo":
            out[name]["continuous_path_chunk128_reading"] = RANDOMWALKS_PPO_CONTINUOUS_128
            if not last >= RANDOMWALKS_PPO_BAR:
                problems.append(f"PPO's last three evals {last} < {RANDOMWALKS_PPO_BAR}")
            # the staged loss: the fused loss kernels stay idle
            if launches["fused_loss_fwd"] or launches["fused_loss_bwd"]:
                problems.append(f"ppo: the fused loss launched on the staged path: {launches}")
        if name == "ilql" and not last > first + RANDOMWALKS_ILQL_LIFT:
            problems.append(f"ILQL lifted {first} → {last}, not by > {RANDOMWALKS_ILQL_LIFT}")
        # PPO: the warm start's evaluation runs the engine's kernels, the
        # serial rollouts and the train steps the flash kernels
        if dev.type == "cuda" and min(launches[k] for k in OFFLINE_KERNELS) <= 0:
            problems.append(f"{name}: a kernel of the path never launched: {launches}")
        del trainer
    out["wall_s"] = out["ppo"]["wall_s"] + out["ilql"]["wall_s"]
    emit({**out, "ok": not problems})
    if problems:
        raise AssertionError(f"slice_randomwalks: {problems}")
    return {name: out[name]["launches"] for name in ("ppo", "ilql")}


# ---------------------------------------------------------------------------
# phase 11: the GRPO slice — default_grpo_config() through trlx.train
# ---------------------------------------------------------------------------

# the serial path's kernels: the flash forward (dense-cache prefill, scoring,
# train forward) and backward; the continuous path adds the engine's #1-#3
GRPO_KERNELS = ("flash_fwd", "flash_bwd")
GRPO_CB_KERNELS = SERVE_KERNELS + GRPO_KERNELS
# two collections of 128 rollouts (16 prompts x groups of 8, batch 32, 2
# epochs: 8 steps each), a checkpoint after the first
GRPO_STEPS, GRPO_CHECKPOINT, GRPO_PROMPTS = 16, 8, 128
# the GRPO phases run GPT-2 small's width at 4 of its 12 layers
# (slice_parallel_rl's time): the preset's settings otherwise, a frozen
# trunk of 2 blocks under the 2 unfrozen ones
GRPO_LAYERS = 4
# (a) of the parity phase: serial and continuous logprobs of equal tokens,
# f32 with TF32 off (different attention kernels, summation order only)
GRPO_LOGPROB_ATOL = 1e-4
# (b) of the parity phase: one step on the kernels against the plain
# attention, f32
GRPO_PARITY_LOSS_RTOL, GRPO_PARITY_GRAD_RTOL = 1e-5, 1e-4
# the key-projection biases' gradient, zero in exact arithmetic, over the
# model's largest gradient (f32 noise reads ~1e-9)
GRPO_ZERO_GRAD_ATOL = 1e-7


def grpo_reward(samples, prompts, outputs):
    """The port's lexicon sentiment of each sample (``tasks/
    grpo_sentiments.py``) plus the serial phases' byte share of its output
    (``profile_train.reward_fn``): random weights write no lexicon word, so
    the byte share is what tells a group's members apart."""
    from trlx_tpu_torch.profile_train import reward_fn
    from trlx_tpu_torch.tasks.grpo_sentiments import lexicon_sentiment

    return [a + b for a, b in zip(lexicon_sentiment(samples),
                                  reward_fn(samples, prompts, outputs))]


def drawn_reward(seed=0):
    """Scores drawn in call order from one seeded stream (greedy members of
    a group are identical, so a text reward would give zero advantages)."""
    rs = np.random.RandomState(seed)
    return lambda samples, prompts, outputs: rs.randn(len(samples)).tolist()


def grpo_config(ckpt, spec="builtin:gpt2-small", total_steps=GRPO_STEPS,
                checkpoint_interval=GRPO_CHECKPOINT, continuous=False, **sections):
    """``default_grpo_config()`` as it stands but for ``checkpoint_dir``,
    ``total_steps``, ``checkpoint_interval`` and the spec; ``continuous``
    turns on ``train.continuous_batching`` with the paged engine and its
    kernels; ``sections`` evolve it further."""
    from trlx_tpu_torch.data.default_configs import default_grpo_config

    config = default_grpo_config().evolve(
        train=dict(checkpoint_dir=ckpt, total_steps=total_steps,
                   checkpoint_interval=checkpoint_interval),
        model=dict(model_path=spec))
    if continuous:
        config = config.evolve(train=dict(continuous_batching=True),
                               engine=dict(backend="paged", decode_kernel="pallas",
                                           prefill_kernel="pallas"))
    return config.evolve(**sections) if sections else config


def phase_slice_grpo(device="cuda", spec="builtin:gpt2-small", continuous=False, card="",
                     n_prompts=GRPO_PROMPTS, total_steps=GRPO_STEPS,
                     checkpoint_interval=GRPO_CHECKPOINT, sections=None, keep=False,
                     speculative=0, draft_layers=DRAFT_LAYERS, layers=GRPO_LAYERS):
    """GRPO through ``trlx_tpu_torch.train`` on ``default_grpo_config()``:
    GPT-2 small at ``layers`` of its layers (``GRPO_LAYERS``; None: all),
    ``num_layers_unfrozen`` 2, 128 rollouts in one chunk (16
    prompts × groups of 8), batch 32, 2 epochs, 40 sampled tokens, ``beta``
    0.04, the staged loss; depth 2, which GRPO ignores (its serial path
    has no pipeline). ``continuous`` runs the group-aware harvest on the
    paged engine (``slice_grpo_cb``). Every counter is set to 0 just
    before and read just after: the serial run must launch #5/#6 and
    nothing else, the continuous one #1-#3 and #5/#6. With ``keep`` the
    checkpoints stay and the run's weights come back for the resume check
    of :func:`phase_slice_grpo_parity`. ``speculative`` k runs the harvest
    under ``engine.speculative`` k with a ``draft_layers``-layer draft
    (``slice_grpo_spec``: #1, #4, #5 and #6 launch, and neither #2 nor #3:
    rounds sample with the plain sampler, as in JAX). Returns (launches,
    run)."""
    import shutil

    import trlx_tpu_torch
    from trlx_tpu_torch.profile_train import slice_prompts

    phase = ("slice_grpo_spec" if speculative else "slice_grpo_cb" if continuous
             else "slice_grpo")
    dev = torch.device(device)
    ckpt = _scratch_dir(phase)
    sections = dict(sections or {})
    if layers:
        sections["model"] = {**sections.get("model", {}),
                             "model_extra_kwargs": {"num_layers": layers}}
    if speculative:
        sections["engine"] = {**sections.get("engine", {}), "speculative": speculative}
        sections["model"] = {**sections.get("model", {}), "draft_model_path": spec,
                             "draft_model_extra_kwargs": {"num_layers": draft_layers}}
    config = grpo_config(ckpt, spec, total_steps, checkpoint_interval, continuous, **sections)
    prompts = slice_prompts(n_prompts)
    start = {}

    def hook(trainer):
        start.update({k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()})

    if dev.type == "cuda":
        torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    try:
        # -- the main path -----------------------------------------------
        trainer = trlx_tpu_torch.train(reward_fn=grpo_reward, prompts=prompts, config=config,
                                       init_trainer_hook=hook, device=dev)
        # ---------------------------------------------------------------
    finally:
        if not keep:
            shutil.rmtree(ckpt, ignore_errors=True)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    hist = trainer.tracker.history
    steps = [st for _, st in hist if "gradients/global_norm" in st]
    collections = [st for _, st in hist if "time/exp" in st]
    losses = [st["losses/total_loss"] for st in steps]
    end = trainer.model.state_dict()
    moved = [k for k in trained_keys(trainer) if not torch.equal(end[k].detach().cpu(), start[k])]
    step_ms = [1e3 * st["time/step"] for st in steps]
    method = config.method
    rec = {"phase": phase, "model": spec, "dtype": str(trainer.tcfg.dtype).split(".")[-1],
           "settings": {"continuous_batching": config.train.continuous_batching,
                        "rollout_pipeline_depth": config.train.rollout_pipeline_depth,
                        "num_rollouts": method.num_rollouts, "chunk_size": method.chunk_size,
                        "group_size": method.group_size, "batch_size": config.train.batch_size,
                        "ppo_epochs": method.ppo_epochs, "beta": method.beta,
                        "loss_kernel": method.loss_kernel,
                        "max_new_tokens": method.gen_kwargs["max_new_tokens"]},
           "optimizer_steps": len(steps), "rollout_collections": len(collections),
           "losses": losses, "wall_s": wall,
           "train_step_ms_median": statistics.median(step_ms),
           "train_step_ms_spread": [min(step_ms), max(step_ms)],
           "time_exp_s": [c["time/exp"] for c in collections],
           "time_exp_generate_s": [c["time/exp_generate"] for c in collections],
           "rollout_tokens_per_s": [c.get("throughput/rollout_tokens_per_sec")
                                    for c in collections],
           "exp_scores_mean": [c["exp_scores/mean"] for c in collections],
           "sqrt_ref_kl": [c["policy/sqrt_ref_kl"] for c in collections],
           "slot_utilization": [c["throughput/slot_utilization"] for c in collections],
           "launches": launches, "trained_weights_moved": len(moved), "card": card}
    if speculative:
        rec.update(speculative=speculative, draft_layers=draft_layers,
                   spec_acceptance_rate=[c["engine/spec_acceptance_rate"] for c in collections],
                   spec_tokens_per_round=[c["engine/spec_tokens_per_round"]
                                          for c in collections],
                   spec_rounds=[c["rollout/spec_rounds"] for c in collections])
    problems = []
    per_collection = method.num_rollouts // config.train.batch_size * method.ppo_epochs
    if len(steps) != total_steps or len(collections) < min(2, -(-total_steps // per_collection)):
        problems.append(f"{len(steps)} steps, {len(collections)} collections")
    if not all(math.isfinite(x) for x in losses):
        problems.append("a non-finite loss")
    if not moved:
        problems.append("no trainable weight moved")
    if speculative and not all(0.0 <= a <= 1.0 for a in rec["spec_acceptance_rate"]):
        problems.append(f"acceptance {rec['spec_acceptance_rate']} outside [0, 1]")
    must = (GRPO_SPEC_KERNELS if speculative else GRPO_CB_KERNELS if continuous
            else GRPO_KERNELS)
    if dev.type == "cuda" and min(launches[k] for k in must) <= 0:
        problems.append(f"a kernel of the path never launched: {launches}")
    if any(launches[k] for k in REPLACES if k not in must):
        problems.append(f"a kernel off the path launched: {launches}")
    if dev.type == "cuda" and not problems and not continuous:
        rec["profiled_collection"] = profile_grpo_collection(trainer, prompts)
        zero_launch_counts()
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"{phase}: {problems}")
    run = None
    if keep:
        run = {"ckpt": ckpt, "start": start, "layers": layers,
               "weights": {k: v.detach().cpu() for k, v in end.items()},
               "exact": grpo_exact(trainer)}
    trainer._close_prompt_iterator()
    return launches, run


def grpo_exact(trainer):
    """The host state a resumed GRPO run must restore exactly."""
    rm = trainer.running_moments
    return {"iter_count": trainer.iter_count, "step": trainer.step, "mean_kl": trainer.mean_kl,
            "running_moments": [rm.mean, rm.var, rm.std, rm.count],
            "prompt_chunks_drawn": trainer._prompt_chunks_drawn}


def profile_grpo_collection(trainer, prompts):
    """One GRPO collection's generate and scoring (16 prompts fanned out
    into 128 rows) under ``torch.profiler``, after a warm one: the card's
    busy share and launches per decode step (:func:`profile_collection`)."""
    G = trainer.config.method.group_size
    rows = [p for p in prompts[: trainer.config.method.chunk_size // G] for _ in range(G)]
    return profile_collection(trainer, rows, len(rows))


def phase_slice_grpo_parity(run, device="cuda", spec="builtin:gpt2-small", card="",
                            n_prompts=GRPO_PROMPTS, parity_rows=16, total_steps=GRPO_STEPS,
                            checkpoint_interval=GRPO_CHECKPOINT, sections=None,
                            layers=PARITY_LAYERS):
    """In f32 with TF32 off: (a) under greedy rollouts and a seeded
    call-ordered reward (:func:`drawn_reward`), one collection's serial
    store against the continuous one, group for group (matched by prompt):
    tokens equal, logprobs and reference logprobs within
    ``GRPO_LOGPROB_ATOL``; (b) after one optimizer step on a sampled
    collection (a greedy batch's exact gradient is zero), a batch of each
    group's best member through ``loss_fn`` and backward on the card's
    kernels against a CPU copy's plain attention: the loss within
    ``GRPO_PARITY_LOSS_RTOL`` of its own value (which must not cancel: at
    least half the token-mean |advantage|, with a KL above 0), every
    gradient within ``GRPO_PARITY_GRAD_RTOL`` of its tensor's largest
    (floored at 1e-5 of the model's largest). Then (c), on ``slice_grpo``'s own run
    (``run``, bf16): a fresh ``train`` resumed from its step-8 checkpoint
    against it, the weights within ``PARITY_GRAD_RTOL`` of the run's
    largest change and the host state exactly. (d): greedy, the
    group-aware harvest with ``engine.prefix_cache`` on against the same
    collection without it, over chunks of the same 8 prompts: the stores
    equal element for element (the near-tie rule), logprobs within
    ``GRPO_LOGPROB_ATOL``, with prefix hits > 0. (a), (b) and (d) run
    ``layers`` of the model's layers (``PARITY_LAYERS``; None: all)."""
    import shutil

    import trlx_tpu_torch
    from trlx_tpu_torch.models.transformer import CausalTransformer
    from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu_torch.profile_train import slice_prompts
    from trlx_tpu_torch.trainer.grpo import GRPOTrainer

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    prompts = slice_prompts(n_prompts)
    rec, problems = {"phase": "slice_grpo_parity", "model": spec, "dtype": "float32",
                     "tf32": False, "card": card}, []
    f32 = {k: dict(v) for k, v in (sections or {}).items()}
    f32.setdefault("parallel", {})["compute_dtype"] = "float32"
    f32.setdefault("method", {})["gen_kwargs"] = dict(max_new_tokens=40, do_sample=False)
    if layers:
        f32.setdefault("model", {})["model_extra_kwargs"] = dict(num_layers=layers)

    # (a) serial against continuous, greedy
    stores = {}
    for continuous in (False, True):
        # these trainers save nothing: the directory is never made
        config = grpo_config(os.path.join(ROOT, "build", "chip_smoke_grpo_parity"), spec,
                             total_steps, checkpoint_interval, continuous, **f32)
        t = GRPOTrainer(config=config, reward_fn=drawn_reward(), device=dev)
        width = config.train.seq_length - config.method.gen_kwargs["max_new_tokens"]
        t.add_prompt_pipeline(PromptPipeline(prompts, width, t.tokenizer))
        zero_launch_counts()
        t.make_experience(config.method.num_rollouts)
        stores[continuous] = (t, launch_counts())
        t._close_prompt_iterator()
    serial, cb = stores[False][0].store.history, stores[True][0].store.history
    key = lambda e: np.asarray(e.query_tensor).tobytes()  # noqa: E731
    groups = {}
    for e in cb:
        groups.setdefault(key(e), []).append(e)
    worst, unequal = 0.0, []
    for i, e in enumerate(serial):
        others = groups.get(key(e), [])
        match = [o for o in others if np.array_equal(o.response_tensor, e.response_tensor)]
        if not match:
            unequal.append(i)
            continue
        for f in ("logprobs", "ref_logprobs"):
            worst = max(worst, float(np.abs(np.asarray(getattr(match[0], f))
                                            - np.asarray(getattr(e, f))).max()))
    ties = []
    if unequal:  # tolerated only at an f32 near tie of the serial path
        t = stores[False][0]
        ties = greedy_divergences(
            t.model, [np.asarray(serial[i].query_tensor) for i in unequal],
            [np.ones(len(serial[i].query_tensor), np.int64) for i in unequal],
            [groups.get(key(serial[i]), [serial[i]])[0].response_tensor for i in unequal],
            [serial[i].response_tensor for i in unequal])
    rec["a_serial_vs_continuous"] = {
        "rows": [len(serial), len(cb)], "groups": len(groups), "unequal_rows": len(unequal),
        "divergences": ties, "logprob_max_abs_diff": worst, "atol": GRPO_LOGPROB_ATOL,
        "launches": {"serial": stores[False][1], "continuous": stores[True][1]}}
    if len(serial) != len(cb) or len(groups) != len(serial) // 8:
        problems.append(f"(a) rows {len(serial)} / {len(cb)}, {len(groups)} groups")
    problems += [f"(a) row {unequal[j]} diverges" for j, t in enumerate(ties)
                 if t["top2_gap"] >= F32_TIE_GAP]
    if not worst <= GRPO_LOGPROB_ATOL:
        problems.append(f"(a) logprobs differ by {worst}")
    del stores, cb

    # (d) the group-aware harvest with engine.prefix_cache against without,
    # greedy: half the preset's rollouts (64) in two chunks of the same
    # prompts (4 at the preset's groups of 8), so the second chunk's groups
    # are admitted, as the first chunk's rows harvest, onto committed
    # chains; the stores equal element for element
    from trlx_tpu_torch.engine.core import ContinuousEngine

    base = grpo_config("", spec, total_steps, checkpoint_interval, True, **f32).method
    rollouts = base.num_rollouts // 2
    chunk = rollouts // 2
    repeated, stores_d = slice_prompts(max(chunk // base.group_size, 1)), {}
    for prefix in (False, True):
        config = grpo_config(os.path.join(ROOT, "build", "chip_smoke_grpo_parity"), spec,
                             total_steps, checkpoint_interval, True,
                             **{**f32, "method": {**f32["method"], "chunk_size": chunk,
                                                  "num_rollouts": rollouts},
                                "engine": {**f32.get("engine", {}), "prefix_cache": prefix}})
        t = GRPOTrainer(config=config, reward_fn=drawn_reward(), device=dev)
        width = config.train.seq_length - config.method.gen_kwargs["max_new_tokens"]
        t.add_prompt_pipeline(PromptPipeline(repeated, width, t.tokenizer))
        t.make_experience(config.method.num_rollouts)
        t._close_prompt_iterator()
        engines = [e for e in t._generate_fns.values() if isinstance(e, ContinuousEngine)]
        stores_d[prefix] = (t, sum(e.stats.prefix_hit_blocks for e in engines))
    (cold_t, _), (warm_t, hits) = stores_d[False], stores_d[True]
    cold_s, warm_s = cold_t.store.history, warm_t.store.history
    unequal = [i for i, (a, b) in enumerate(zip(cold_s, warm_s))
               if not np.array_equal(a.response_tensor, b.response_tensor)]
    worst_d = max((float(np.abs(np.asarray(getattr(a, f)) - np.asarray(getattr(b, f))).max())
                   for i, (a, b) in enumerate(zip(cold_s, warm_s)) if i not in unequal
                   for f in ("logprobs", "ref_logprobs")), default=0.0)
    ties_d = greedy_divergences(
        cold_t.model, [np.asarray(cold_s[i].query_tensor) for i in unequal],
        [np.ones(len(cold_s[i].query_tensor), np.int64) for i in unequal],
        [warm_s[i].response_tensor for i in unequal],
        [cold_s[i].response_tensor for i in unequal]) if unequal else []
    rec["d_prefix_cache"] = {"rows": [len(cold_s), len(warm_s)], "prefix_hit_blocks": hits,
                             "unequal_rows": len(unequal), "divergences": ties_d,
                             "logprob_max_abs_diff": worst_d, "atol": GRPO_LOGPROB_ATOL}
    if len(cold_s) != len(warm_s) or hits <= 0:
        problems.append(f"(d) rows {len(cold_s)} / {len(warm_s)}, prefix hits {hits}")
    problems += [f"(d) row {unequal[j]} diverges" for j, t in enumerate(ties_d)
                 if t["top2_gap"] >= F32_TIE_GAP]
    if not worst_d <= GRPO_LOGPROB_ATOL:
        problems.append(f"(d) logprobs differ by {worst_d}")
    del stores_d, cold_t, warm_t, cold_s, warm_s

    # (b) one batch on the card's kernels against the CPU's plain attention,
    # after one optimizer step on the card: the ratio leaves 1 and the KL 0.
    # Sampled: greedy members of a group are equal rows whose advantages sum
    # to 0, so a greedy batch's exact gradient is 0 and both sides hold noise.
    # The batch holds each group's best member: a batch of whole groups at
    # equal lengths weighs each group's advantages, which sum to 0, equally,
    # and its loss would cancel
    config = grpo_config(os.path.join(ROOT, "build", "chip_smoke_grpo_parity"), spec,
                         total_steps, checkpoint_interval,
                         **{**f32, "method": {**f32["method"], "gen_kwargs": dict(
                             max_new_tokens=40, top_k=0, top_p=1.0, do_sample=True)}})
    trainer = GRPOTrainer(config=config, reward_fn=grpo_reward, device=dev)
    width = config.train.seq_length - config.method.gen_kwargs["max_new_tokens"]
    trainer.add_prompt_pipeline(PromptPipeline(prompts, width, trainer.tokenizer))
    trainer.make_experience(config.method.num_rollouts)
    trainer._close_prompt_iterator()
    trainer.train_step(next(iter(trainer.store.create_loader(config.train.batch_size,
                                                             shuffle=True))))
    groups = {}
    for e in trainer.store.history:
        groups.setdefault(key(e), []).append(e)
    best = [max(g, key=lambda e: float(e.advantage)) for g in groups.values()]
    batch = trainer.store.collate(best[:parity_rows])
    results = card_cpu_backward(trainer, CausalTransformer, batch, device)
    gpu, cpu = results["card"], results["cpu"]
    # the size of the loss's terms, the token-mean |advantage|: the loss must
    # not cancel against it for the comparison to mean anything
    mask = np.asarray(batch.response_mask, np.float64)
    adv_scale = float((np.abs(np.asarray(batch.advantages, np.float64))[:, None] * mask).sum()
                      / max(mask.sum(), 1.0))
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / max(abs(cpu["loss"]), 1e-30)
    grad_worst, grad_name, zero_worst = grad_gaps(gpu["grads"], cpu["grads"])
    through = {k: gpu["launches"][k] for k in GRPO_KERNELS}
    kl = {k: cpu["stats"][k] for k in ("losses/kl_loss", "policy/approx_kl")}
    rec["b_step_parity"] = {"rows": len(batch.advantages), "loss_card": gpu["loss"],
                            "loss_cpu": cpu["loss"], "token_mean_abs_advantage": adv_scale,
                            "kl_after_one_step": kl,
                            "loss_rel_err": loss_rel, "loss_rtol": GRPO_PARITY_LOSS_RTOL,
                            "worst_grad_rel_err": grad_worst, "worst_grad": grad_name,
                            "grad_rtol": GRPO_PARITY_GRAD_RTOL,
                            "key_bias_err_over_largest": zero_worst,
                            "key_bias_atol_over_largest": GRPO_ZERO_GRAD_ATOL,
                            "params_compared": len(cpu["grads"]), "launches": through}
    if not loss_rel <= GRPO_PARITY_LOSS_RTOL:
        problems.append(f"(b) loss {gpu['loss']} vs {cpu['loss']}")
    if not abs(cpu["loss"]) >= 0.5 * adv_scale or not min(kl.values()) > 0:
        problems.append(f"(b) the compared loss {cpu['loss']} cancels against its terms "
                        f"({adv_scale}) or the step left no KL: {kl}")
    if not grad_worst <= GRPO_PARITY_GRAD_RTOL:
        problems.append(f"(b) gradient {grad_name}: relative {grad_worst}")
    if not zero_worst <= GRPO_ZERO_GRAD_ATOL:
        problems.append(f"(b) key-bias gradients {zero_worst} of the largest")
    if set(gpu["grads"]) != set(cpu["grads"]) or max(cpu["launches"].values()) != 0 or (
            dev.type == "cuda" and min(through.values()) <= 0):
        problems.append(f"(b) gradients or launches: card {gpu['launches']}, cpu "
                        f"{cpu['launches']}")
    del trainer, results

    # (c) resume slice_grpo's run from its step-8 checkpoint
    if run is not None:
        ckpt = _scratch_dir("grpo_resumed")
        step_dir = f"checkpoint_{checkpoint_interval:0{len(str(total_steps))}d}"
        shutil.copytree(os.path.join(run["ckpt"], step_dir), os.path.join(ckpt, step_dir))
        model = dict((sections or {}).get("model", {}))
        if run.get("layers"):  # the run's own depth
            model["model_extra_kwargs"] = {"num_layers": run["layers"]}
        config = grpo_config(ckpt, spec, total_steps, checkpoint_interval,
                             **{**(sections or {}), "model": model, "train": {
                                 **(sections or {}).get("train", {}),
                                 "resume_from_checkpoint": True}})
        try:
            t = trlx_tpu_torch.train(reward_fn=grpo_reward, prompts=prompts, config=config,
                                     device=dev)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
            shutil.rmtree(run["ckpt"], ignore_errors=True)
        weights = {k: v.detach().cpu() for k, v in t.model.state_dict().items()}
        exact = grpo_exact(t)
        gap, name, biggest = weight_gap(weights, run["weights"], run["start"])
        rec["c_resume"] = {"exact": {"resumed": exact, "uninterrupted": run["exact"]},
                           "weights_diff_over_largest_change": gap, "weights_worst": name,
                           "weights_max_abs_diff": biggest, "rtol": PARITY_GRAD_RTOL}
        if exact != run["exact"]:
            problems.append(f"(c) resumed state {exact} != {run['exact']}")
        if not gap <= PARITY_GRAD_RTOL:
            problems.append(f"(c) resumed weights: {name} off by {gap} of the largest change")
        del t
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"slice_grpo_parity: {problems}")
    zero_launch_counts()
    return rec


# ---------------------------------------------------------------------------
# phase 12: the MoE slice — Mixtral-8x7B's width served and trained (GRPO)
# ---------------------------------------------------------------------------

# mistralai/Mixtral-8x7B-v0.1 config.json (the JAX preset): E 4096, GQA 32
# over 8, D 128, SiLU experts of 14336, 8 experts top-2, vocab 32000,
# rope_theta 1e6, dispatch groups of 512 tokens
MOE_SPEC = "builtin:mixtral-8x7b"
MOE_SERVE = dict(slots=8, prompt_len=1024, max_new=32, n_requests=16, short_len=512, eos=2)
# depth cuts: one served layer holds 1.67 B f32 parameters (2 layers, 3.17
# B, drew for ~27 s on the host, and with the T5 phases the script read
# 886 s of phases; 4 layers, 6.07 B, ~50 s); the f32 parity holds one;
# GRPO at 2 layers (the preset trains the top 2: its hydra branch needs
# both) holds weights, gradients, AdamW's moments and the hydra reference
# (~63 GB)
MOE_SERVE_LAYERS, MOE_PARITY_LAYERS, MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 1, 1, 2, 4


def phase_moe_serve(device="cuda", spec=MOE_SPEC, layers=MOE_SERVE_LAYERS,
                    parity_layers=MOE_PARITY_LAYERS, card="", **kw):
    """Mixtral-8x7B's width at ``layers`` layers on the paged engine behind
    the HTTP frontend: 16 requests on 8 slots, half 1024-token prompts and
    half 512, 32 new tokens, half greedy (``slice_moe_serve``: tokens/s,
    TTFT p50, decode step ms, build seconds, peak memory). Then the served
    model's first ``parity_layers`` blocks (the same f32 masters, with its
    embedding, final norm and head) in f32 (``slice_moe_parity``): the
    engine's greedy answers over HTTP against the plain dense-cache
    ``generate``, token for token (a divergence tolerated only at an f32
    near tie). Returns the launches."""
    dev = torch.device(device)
    sl = ServedSlice(spec, device, **{**MOE_SERVE, **kw}, num_layers=layers)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, cfg = sl.build()
    extra = {"build_s": time.perf_counter() - t0, "layers": layers,
             "parameters": sum(p.numel() for p in model.parameters())}
    if dev.type == "cuda":
        # the cast of the experts' f32 masters at every call (read f32, write bf16)
        experts = [p for n, p in model.named_parameters() if ".mlp.w_" in n]
        extra["expert_cast_gb"] = sum(p.numel() for p in experts) * 6 / 1e9

        def cast_all():
            for p in experts:
                p.to(cfg.dtype)

        extra["expert_cast_ms"], _ = time_ms(cast_all, n=3, windows=3, calls=3)
    if dev.type == "cuda":
        extra["memory_after_build_gb"] = torch.cuda.memory_allocated(dev) / 1e9
    _, launches, engine = sl.serve(model, cfg, "slice_moe_serve", card, **extra)
    if dev.type == "cuda":  # the build, the warm-up and the served run
        emit({"phase": "slice_moe_serve_memory", "layers": layers,
              "after_build_gb": extra["memory_after_build_gb"],
              "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
              "peak_reserved_gb": torch.cuda.max_memory_reserved(dev) / 1e9, "card": card})
    del engine
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    # the parity model: the served model's first blocks, embedding, final
    # norm and head (its f32 masters, shared, not drawn again) in f32
    from trlx_tpu_torch.models.transformer import CausalTransformer

    ps = ServedSlice(spec, device, **{**MOE_SERVE, **kw}, num_layers=parity_layers)
    cfg32 = dataclasses.replace(cfg, num_layers=parity_layers, dtype=torch.float32)
    with torch.device("meta"):
        model32 = CausalTransformer(cfg32)
    keys = set(model32.state_dict())
    model32.load_state_dict({k: v for k, v in model.state_dict().items() if k in keys},
                            assign=True)
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gi = ps.greedy_idx
    plain = ps.plain_greedy(model32)
    served, _, _ = serve_over_http(ps.engine(model32, cfg32), [ps.bodies[i] for i in gi],
                                   ps.max_new, ps.vocab, ps.sync)
    ties = greedy_divergences(model32, ps.prompts[gi], ps.masks[gi],
                              [np.asarray(r[1]) for r in served], plain)
    rec = {"phase": "slice_moe_parity", "model": spec, "layers": parity_layers,
           "dtype": "float32", "tf32": False, "greedy_rows": len(gi), "divergences": ties,
           "tie_gap_tol": F32_TIE_GAP, "card": card}
    bad = [t for t in ties if t["top2_gap"] >= F32_TIE_GAP]
    emit({**rec, "ok": not bad})
    if bad:
        raise AssertionError(f"slice_moe_parity: served greedy tokens diverge: {bad}")
    del model32
    zero_launch_counts()
    return launches


def expert_rows(trainer):
    """Host copies of the first 64 hidden rows of the last block's expert
    weights, every expert's (its output feeds no router, so only the
    policy loss and the KL move them)."""
    mlp = trainer.model.blocks[-1].mlp
    return {"w_up": mlp.w_up[:, :, :64].detach().cpu().clone(),
            "w_down": mlp.w_down[:, :64].detach().cpu().clone()}


def phase_moe_grpo(device="cuda", spec=MOE_SPEC, layers=MOE_TRAIN_LAYERS,
                   total_steps=MOE_TRAIN_STEPS, card="", hparams=None):
    """``tasks/grpo_sentiments.py``'s settings (seq_length 128, batch 32, 40
    sampled tokens, the router losses at 0.01 and 0.001, 256 prompts and 64
    eval prompts) at Mixtral-8x7B's width, ``layers`` layers (all of them
    trained: ``num_layers_unfrozen`` 2), ``total_steps`` steps, rewarded by
    :func:`grpo_reward` (the task's lexicon alone scores every member of a
    random-weight policy alike: zero advantages, no policy gradient). The
    run writes no checkpoint (``save`` is a no-op: the weights and AdamW
    state would be ~38 GB). Prints step ms, the router losses and the peak
    memory; a non-finite loss, advantages all 0, a router or a last
    block's experts (which feed no router: only the policy terms reach
    them) that did not move, or a kernel of the serial path that never
    launched fails. Returns the launches."""
    import shutil

    from trlx_tpu_torch.tasks import grpo_sentiments as task

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    built, memory = {}, {}

    def hook(trainer):
        trainer.save = lambda *a, **k: None
        built["s"] = time.perf_counter() - t0
        built["router0"] = trainer.model.blocks[0].mlp.router.weight.detach().cpu().clone()
        built["experts"] = expert_rows(trainer)
        if dev.type == "cuda":
            memory["built"] = torch.cuda.memory_allocated(dev) / 1e9
        for name in ("make_experience", "evaluate", "accumulate_grads", "train_step"):
            record_memory(trainer, name, memory, dev)

    ckpt = _scratch_dir("moe_grpo")
    zero_launch_counts()
    t0 = time.perf_counter()
    # -- the main path ---------------------------------------------------
    trainer = task.main(spec, {"train.total_steps": total_steps, "train.checkpoint_dir": ckpt,
                               **(hparams or {})},
                        device=dev, model_extra_kwargs={"num_layers": layers},
                        init_trainer_hook=hook, reward_fn=grpo_reward)
    # ---------------------------------------------------------------------
    wall = time.perf_counter() - t0
    launches = launch_counts()
    hist = trainer.tracker.history
    steps = [st for _, st in hist if "gradients/global_norm" in st]
    collections = [st for _, st in hist if "time/exp" in st]
    losses = [st["losses/total_loss"] for st in steps]
    moved = not torch.equal(trainer.model.blocks[0].mlp.router.weight.detach().cpu(),
                            built["router0"])
    experts_moved = {k: not torch.equal(v, built["experts"][k])
                     for k, v in expert_rows(trainer).items()}
    nonzero_adv = sum(float(e.advantage) != 0.0 for e in trainer.store.history)
    rec = {"phase": "slice_moe_grpo", "model": spec, "layers": layers,
           "parameters": sum(p.numel() for p in trainer.model.parameters()),
           "dtype": str(trainer.tcfg.dtype).split(".")[-1], "build_s": built["s"], "wall_s": wall,
           "optimizer_steps": len(steps), "losses": losses,
           "train_step_ms": [1e3 * st["time/step"] for st in steps],
           "train_step_ms_median": statistics.median(1e3 * st["time/step"] for st in steps),
           "router_load_balance": [st["losses/router_load_balance"] for st in steps],
           "router_z": [st["losses/router_z"] for st in steps],
           "time_exp_s": [c["time/exp"] for c in collections],
           "rollout_tokens_per_s": [c.get("throughput/rollout_tokens_per_sec")
                                    for c in collections],
           "exp_scores_mean": [c["exp_scores/mean"] for c in collections],
           "router_moved": moved, "last_block_experts_moved": experts_moved,
           "nonzero_advantages": [nonzero_adv, len(trainer.store.history)],
           "launches": launches, "card": card,
           "memory_by_stage_gb": memory,
           "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                              if dev.type == "cuda" else None)}
    problems = []
    if len(steps) != total_steps:
        problems.append(f"{len(steps)} steps")
    if not all(math.isfinite(x) for x in losses + rec["router_z"] + rec["router_load_balance"]):
        problems.append("a non-finite loss")
    if not moved:
        problems.append("the router did not move")
    if not nonzero_adv or not all(experts_moved.values()):
        problems.append(f"{nonzero_adv} nonzero advantages; experts moved: {experts_moved}")
    if dev.type == "cuda" and min(launches[k] for k in GRPO_KERNELS) <= 0:
        problems.append(f"#5 or #6 never launched: {launches}")
    if any(launches[k] for k in REPLACES if k not in GRPO_KERNELS):
        problems.append(f"a kernel off the serial path launched: {launches}")
    emit({**rec, "ok": not problems})
    shutil.rmtree(ckpt, ignore_errors=True)
    trainer._close_prompt_iterator()
    del trainer
    if problems:
        raise AssertionError(f"slice_moe_grpo: {problems}")
    return launches


# ---------------------------------------------------------------------------
# phase 13: preference learning — DPO, the reward model (TL;DR stages 2–3)
# and DPO with LoRA
# ---------------------------------------------------------------------------

# DPO: the reference pass runs #5, the steps #5/#6, the evaluation #1–#3
DPO_KERNELS = OFFLINE_KERNELS
DPO_STEPS, DPO_TRIPLES, DPO_EVAL_PROMPTS = 16, 256, 64  # one epoch at batch 16
# the first step's loss: the policy is its own reference, so every margin
# is 0 and the loss ln 2, up to the bf16 rounding of two passes' logps
DPO_FIRST_LOSS_ATOL = 1e-2
# slice_dpo_parity, f32 with TF32 off: pairs per batch; the reference
# logps (relative), the loss (relative) and the gradients (of each
# tensor's largest, floored at 1e-5 of the model's largest) held card
# against the CPU's plain attention, and logit_chunk against the full
# projection
DPO_PARITY_PAIRS, DPO_PARITY_CHUNK, DPO_PARITY_LR = 4, 64, 1e-4
DPO_LOGP_RTOL, DPO_PARITY_LOSS_RTOL, DPO_PARITY_GRAD_RTOL = 1e-4, 1e-5, 1e-4
# the reward model: stage 2 cut to REWARD_STEPS steps, then stage 3's
# serial PPO for REWARD_PPO_STEPS steps of one 64-rollout collection
REWARD_KERNELS = ("flash_fwd", "flash_bwd")
REWARD_STEPS, REWARD_PPO_STEPS = 64, 4
# the trained model's end scores (bf16 compute over f32 weights) against
# the f32 plain forward, over the largest |score|: bf16 rounds each hidden
# entry by up to 2^-9 of itself and the errors grow through 12 blocks, so
# a score moves by ~1 % of the scores' scale (64 steps train them to ~10);
# the card's own f32 pass agrees to summation order, absolutely
REWARD_BF16_SCORE_RTOL, REWARD_F32_SCORE_ATOL = 2e-2, 1e-4
# DPO with LoRA at Mistral-7B's width, cut in depth to the family PPO's
# FAMILY_TRAIN_LAYERS (8 layers drew 2.0 B parameters for 18.7 s of a
# 21.4 s phase, and the script ran 880 s of phases)
LORA_PEFT = {"peft_type": "lora", "r": 8, "lora_alpha": 16, "modified_modules": "all"}
LORA_LAYERS, LORA_STEPS, LORA_EVAL_PROMPTS = FAMILY_TRAIN_LAYERS, 4, 16


def record_memory(trainer, name, memory, dev):
    """Wrap ``trainer.<name>``: its first call records the allocated device
    memory before and after and the peak so far (GB) in ``memory[name]``."""
    fn = getattr(trainer, name)

    def wrapped(*a, **k):
        if name in memory or dev.type != "cuda":
            return fn(*a, **k)
        before = torch.cuda.memory_allocated(dev) / 1e9
        out = fn(*a, **k)
        memory[name] = {"before": before, "after": torch.cuda.memory_allocated(dev) / 1e9,
                        "peak": torch.cuda.max_memory_allocated(dev) / 1e9}
        return out

    setattr(trainer, name, wrapped)


def count_launches(trainer, name, stages):
    """Wrap ``trainer.<name>``: the kernel launches of its calls add up in
    ``stages[name]``."""
    fn = getattr(trainer, name)

    def wrapped(*a, **k):
        before = launch_counts()
        out = fn(*a, **k)
        after = launch_counts()
        total = stages.setdefault(name, {key: 0 for key in after})
        for key in after:
            total[key] += after[key] - before[key]
        return out

    setattr(trainer, name, wrapped)


def dpo_launch_problems(launches, stages, dev, steps_must=("flash_fwd", "flash_bwd")):
    """The DPO path's launches: #5 alone in the reference pass, #5/#6 in
    the steps, #1–#3 in the evaluations, nothing off the path."""
    steps = {k: launches[k] - sum(s.get(k, 0) for s in stages.values()) for k in launches}
    problems = []
    if any(launches[k] for k in REPLACES if k not in DPO_KERNELS):
        problems.append(f"a kernel off the path launched: {launches}")
    if dev.type == "cuda":
        ref = stages.get("make_experience", {})
        if ref.get("flash_fwd", 0) <= 0 or any(v for k, v in ref.items() if k != "flash_fwd"):
            problems.append(f"the reference pass launched {ref}")
        if min(steps[k] for k in steps_must) <= 0:
            problems.append(f"the steps launched {steps}")
        if min(stages.get("evaluate", {}).get(k, 0) for k in SERVE_KERNELS) <= 0:
            problems.append(f"the evaluation launched {stages.get('evaluate')}")
    return problems, steps


def phase_slice_dpo(device="cuda", spec="builtin:gpt2-small", total_steps=DPO_STEPS,
                    n_triples=DPO_TRIPLES, n_eval=DPO_EVAL_PROMPTS, card="", hparams=None):
    """DPO through ``trlx_tpu_torch.train(samples=triples)`` on
    ``tasks/dpo_sentiments.py``'s settings (``default_dpo_config()``:
    GPT-2 small at full width and depth, bf16 over f32 masters,
    ``num_layers_unfrozen`` −1, ``seq_length`` 256, batch 16, ``beta`` 0.1)
    on its 256 triples: the reference pass, one epoch (16 steps), the
    evaluations on 64 review openings (40 sampled tokens, the lexicon
    sentiment). Every counter is set to 0 just before and read just after;
    the reference pass, the steps and the evaluations are counted apart.
    A non-finite loss, a first loss off ln 2 by more than
    ``DPO_FIRST_LOSS_ATOL``, no trained weight moving, a kernel off the
    path or one of the path's never launching fails. Returns (trainer,
    launches)."""
    from trlx_tpu_torch.tasks import dpo_sentiments as task
    from trlx_tpu_torch.tasks.sentiment import review_prompts

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    config = task.config(spec, {"train.total_steps": total_steps, **(hparams or {})})
    stages, start = {}, {}

    def hook(trainer):
        start.update({k: trainer.model.state_dict()[k].detach().cpu().clone()
                      for k in trained_keys(trainer)})
        for name in ("make_experience", "evaluate"):
            count_launches(trainer, name, stages)

    def check(trainer, steps):
        losses = [st["losses/total_loss"] for st in steps]
        end = trainer.model.state_dict()
        moved = [k for k in start if not torch.equal(end[k].detach().cpu(), start[k])]
        problems, step_launches = dpo_launch_problems(launch_counts(), stages, dev)
        if not abs(losses[0] - math.log(2.0)) <= DPO_FIRST_LOSS_ATOL:
            problems.append(f"first loss {losses[0]}, not ln 2")
        if not moved:
            problems.append("no trained weight moved")
        step_s = statistics.median(st["time/step"] for st in steps)
        evals = [st for _, st in trainer.tracker.history if "metrics/sentiment" in st]
        return problems, {
            "reference_pass_s": trainer.ref_pass_time,
            "pairs_per_s_median": config.train.batch_size / step_s,
            "rewards_margin": [st["rewards/margin"] for st in steps],
            "rewards_accuracy": [st["rewards/accuracy"] for st in steps],
            "logps_chosen": [st["logps/chosen"] for st in steps],
            "eval_sentiment": [st["metrics/sentiment"] for st in evals],
            "launches_by_stage": {"reference_pass": stages.get("make_experience"),
                                  "steps": step_launches, "evaluate": stages.get("evaluate")},
            "trained_weights_moved": len(moved),
            "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                               if dev.type == "cuda" else None)}

    return offline_slice("slice_dpo", config, task.preference_triples(n_triples, seed=0), dev,
                         card, check, loss_key="losses/total_loss",
                         eval_prompts=review_prompts(n_eval, seed=1), metric_fn=task.metric_fn,
                         init_trainer_hook=hook)


def grad_gaps(got, want):
    """``(worst, name, key_bias)``: the largest gradient error over its
    tensor's largest (floored at 1e-5 of the model's largest) and where,
    and the key-projection biases' largest error over the model's largest
    gradient: theirs is 0 in exact arithmetic (softmax ignores a shift
    every key shares), so both sides hold f32 noise, held absolutely
    against ``GRPO_ZERO_GRAD_ATOL`` as in :func:`phase_slice_grpo_parity`."""
    gmax = max(float(g.abs().max()) for g in want.values())
    worst, name, key_bias = 0.0, None, 0.0
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        if k.endswith("attn.k_proj.bias"):
            key_bias = max(key_bias, err / gmax)
            continue
        rel = err / max(float(w.abs().max()), 1e-5 * gmax)
        if not rel <= worst:  # NaN counts as worst
            worst, name = rel, k
    return worst, name, key_bias


def phase_slice_dpo_parity(device="cuda", spec="builtin:gpt2-small", pairs=DPO_PARITY_PAIRS,
                           chunk=DPO_PARITY_CHUNK, card=""):
    """In f32 with TF32 off, on ``tasks/dpo_sentiments.py``'s settings at
    ``pairs`` pairs a batch (lr ``DPO_PARITY_LR``): (a) the reference pass
    on the card's kernels against a CPU copy's plain attention, every
    pair's two logps within ``DPO_LOGP_RTOL``; (b) after one optimizer step
    on a batch (so its loss leaves ln 2), that batch's loss and gradients
    on the card against the CPU copy, the loss within
    ``DPO_PARITY_LOSS_RTOL`` and every gradient within
    ``DPO_PARITY_GRAD_RTOL`` of its tensor's largest (the key biases, whose
    exact gradient is 0, within ``GRPO_ZERO_GRAD_ATOL`` of the model's
    largest: :func:`grad_gaps`); (c) on the card,
    ``method.logit_chunk`` ``chunk`` against the full projection, the same
    tolerances."""
    from trlx_tpu_torch.models.transformer import CausalTransformer
    from trlx_tpu_torch.tasks import dpo_sentiments as task
    from trlx_tpu_torch.trainer.dpo import DPOTrainer, completion_logps

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    config = task.config(spec, {
        "train.batch_size": pairs, "parallel.compute_dtype": "float32",
        "optimizer.kwargs.lr": DPO_PARITY_LR, "scheduler.kwargs.lr": DPO_PARITY_LR,
        "scheduler.kwargs.eta_min": DPO_PARITY_LR,
        # these trainers save nothing: the directory is never made
        "train.checkpoint_dir": os.path.join(ROOT, "build", "chip_smoke_dpo_parity")})
    trainer = DPOTrainer(config=config, device=dev)
    triples = task.preference_triples(2 * pairs, seed=5)
    state0 = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    zero_launch_counts()
    trainer.make_experience(triples, config.train.seq_length)
    ref_launches = launch_counts()
    card_refs = np.asarray([(e["ref_chosen_logp"], e["ref_rejected_logp"])
                            for e in trainer.store.history], np.float64)
    batches = list(trainer.store.create_loader(pairs, shuffle=False))
    # (a) the CPU's plain forward of the same rows from the same weights
    cfg32 = dataclasses.replace(trainer.tcfg, dtype=torch.float32)
    with torch.device("meta"):
        cpu_model = CausalTransformer(cfg32)
    cpu_model.load_state_dict(state0, assign=True)
    cpu_refs = []
    with torch.no_grad():
        for batch in batches:
            ids, attn, out = (torch.as_tensor(batch[k]) for k in ("input_ids", "attention_mask",
                                                                 "out_mask"))
            cpu_refs.append(completion_logps(cpu_model, ids, attn, out)[0].numpy())
    cpu_refs = np.concatenate(cpu_refs).reshape(-1, 2).astype(np.float64)
    del cpu_model
    logp_rel = float((np.abs(card_refs - cpu_refs) / np.abs(cpu_refs)).max())
    rec = {"phase": "slice_dpo_parity", "model": spec, "dtype": "float32", "tf32": False,
           "pairs": pairs, "seq_length": config.train.seq_length, "card": card,
           "a_reference_logps": {"pairs": len(card_refs), "max_rel_err": logp_rel,
                                 "rtol": DPO_LOGP_RTOL, "launches": ref_launches}}
    problems = []
    if not logp_rel <= DPO_LOGP_RTOL:
        problems.append(f"(a) reference logps off by {logp_rel} relative")
    if dev.type == "cuda" and (ref_launches["flash_fwd"] <= 0 or ref_launches["flash_bwd"]):
        problems.append(f"(a) the reference pass launched {ref_launches}")

    # (b) one step, then that batch on the card against the CPU
    trainer.train_step(batches[0])
    results = card_cpu_backward(trainer, CausalTransformer, batches[0], device)
    gpu, cpu = results["card"], results["cpu"]
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    grad_worst, grad_name, key_bias = grad_gaps(gpu["grads"], cpu["grads"])
    rec["b_step_parity"] = {
        "loss_card": gpu["loss"], "loss_cpu": cpu["loss"], "loss_minus_ln2": cpu["loss"]
        - math.log(2.0), "margin_cpu": cpu["stats"]["rewards/margin"],
        "loss_rel_err": loss_rel, "loss_rtol": DPO_PARITY_LOSS_RTOL,
        "worst_grad_rel_err": grad_worst, "worst_grad": grad_name,
        "grad_rtol": DPO_PARITY_GRAD_RTOL, "key_bias_err_over_largest": key_bias,
        "key_bias_atol_over_largest": GRPO_ZERO_GRAD_ATOL, "params_compared": len(cpu["grads"]),
        "launches_card": {k: gpu["launches"][k] for k in ("flash_fwd", "flash_bwd")}}
    if not loss_rel <= DPO_PARITY_LOSS_RTOL:
        problems.append(f"(b) loss {gpu['loss']} vs {cpu['loss']}")
    if not abs(cpu["loss"] - math.log(2.0)) >= 1e-3:
        problems.append(f"(b) the compared loss {cpu['loss']} is still the first step's ln 2")
    if not grad_worst <= DPO_PARITY_GRAD_RTOL:
        problems.append(f"(b) gradient {grad_name}: relative {grad_worst}")
    if not key_bias <= GRPO_ZERO_GRAD_ATOL:
        problems.append(f"(b) key-bias gradients {key_bias} of the largest")
    if set(gpu["grads"]) != set(cpu["grads"]) or max(cpu["launches"].values()) != 0 or (
            dev.type == "cuda" and min(gpu["launches"][k] for k in REWARD_KERNELS) <= 0):
        problems.append(f"(b) gradients or launches: card {gpu['launches']}, cpu "
                        f"{cpu['launches']}")
    del results

    # (c) the streamed vocab projection against the full one, on the card
    arrays = trainer._device_batch(batches[0])
    passes, resolved = {}, []
    for c in (0, chunk):
        trainer.config.method.logit_chunk = c
        resolved.append(trainer._resolved_logit_chunk())
        trainer.model.zero_grad(set_to_none=True)
        loss, _ = trainer.loss_fn(arrays)
        loss.backward()
        passes[c] = (float(loss.detach()), {k: p.grad.detach().clone()
                                            for k, p in trainer.model.named_parameters()})
    trainer.config.method.logit_chunk = 0
    chunk_rel = abs(passes[chunk][0] - passes[0][0]) / abs(passes[0][0])
    chunk_worst, chunk_name, chunk_key_bias = grad_gaps(passes[chunk][1], passes[0][1])
    rec["c_logit_chunk"] = {"chunk": chunk, "resolved": resolved, "loss_full": passes[0][0],
                            "loss_chunked": passes[chunk][0], "loss_rel_err": chunk_rel,
                            "worst_grad_rel_err": chunk_worst, "worst_grad": chunk_name,
                            "key_bias_err_over_largest": chunk_key_bias}
    if not chunk_rel <= DPO_PARITY_LOSS_RTOL or resolved != [0, chunk]:
        problems.append(f"(c) chunked loss {passes[chunk][0]} vs {passes[0][0]} (chunks "
                        f"{resolved})")
    if not chunk_worst <= DPO_PARITY_GRAD_RTOL or not chunk_key_bias <= GRPO_ZERO_GRAD_ATOL:
        problems.append(f"(c) chunked gradient {chunk_name}: relative {chunk_worst}, key "
                        f"biases {chunk_key_bias} of the largest")
    del passes, trainer
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"slice_dpo_parity: {problems}")


def reward_score_texts(n=64, posts=16):
    """Prompt ‖ chosen and prompt ‖ rejected of ``(n - posts) / 2``
    comparison pairs (short rows) and ``posts`` TL;DR posts ‖ their
    reference summary (cut at 256 bytes): right-padded rows of many
    lengths."""
    from trlx_tpu_torch.tasks import summarize_rlhf as task

    pairs = task.load_comparisons((n - posts) // 2, seed=7)
    texts = [p["prompt"] + p[k] for p in pairs for k in ("chosen", "rejected")]
    return texts + [d["prompt"] + d["label"] for d in task.load_tldr(n - len(texts), seed=8)]


def phase_slice_reward(device="cuda", spec="builtin:gpt2-small", steps=REWARD_STEPS,
                       ppo_steps=REWARD_PPO_STEPS, card="", ppo_hparams=None):
    """The TL;DR recipe's stages 2 and 3 (``tasks/summarize_rlhf.py``):
    the reward model (GPT-2 small, bf16 over f32 masters) trained at the
    example's settings (``max_length`` 256, batch 8, lr 1e-5, 256 pairs),
    cut to ``steps`` steps; then PPO at the example's settings (``seq_length``
    256, batch 16, one collection of 64 rollouts in chunks of 16, 50 tokens
    at top-p 0.95, ``num_layers_unfrozen`` 8) for ``ppo_steps`` steps
    against it, the reward the score minus the reference summary's (no
    checkpoint is written: ``save`` is a no-op). Every
    counter is set to 0 just before stage 2 and read just after stage 3;
    between them the trained model's end scores on 64 texts are held
    against the CPU's plain f32 forward (bf16 within
    ``REWARD_BF16_SCORE_RTOL`` of the largest |score|; the card's f32 pass
    within ``REWARD_F32_SCORE_ATOL``), with their launches taken back out. A
    non-finite value, an unmoved reward model, a score off, or a kernel
    other than #5/#6 launching (or either never) fails; ``ppo_hparams``
    are further dot-path overrides of stage 3. Returns the launches."""
    import shutil

    from trlx_tpu_torch.tasks import summarize_rlhf as task

    dev = torch.device(device)
    rm_dir, ppo_dir = _scratch_dir("reward_model"), _scratch_dir("reward_ppo")
    start, stamps = {}, []

    def no_checkpoints(trainer):  # stage 3 writes no checkpoint
        trainer.save = lambda *a, **k: None

    def init_hook(model):
        start.update({k: v.detach().cpu().clone() for k, v in model.state_dict().items()})
        stamps.append(time.perf_counter())

    def step_hook(_):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stamps.append(time.perf_counter())

    try:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        zero_launch_counts()
        # -- the main path, stage 2 -------------------------------------------
        model, cfg, history = task.train_reward_model(
            spec, device=dev, total_steps=steps, checkpoint_dir=rm_dir, init_hook=init_hook,
            step_hook=step_hook)
        # ---------------------------------------------------------------------
        stage2 = launch_counts()
        moved = sum(not torch.equal(v.detach().cpu(), start[k])
                    for k, v in model.state_dict().items())
        del model
        # the scores against the plain f32 forward (launches taken back out)
        texts = reward_score_texts()
        want = task.load_reward_fn(rm_dir, "cpu", dtype=torch.float32)(texts)
        got = task.load_reward_fn(rm_dir, dev)(texts)
        torch.backends.cuda.matmul.allow_tf32 = False
        got32 = task.load_reward_fn(rm_dir, dev, dtype=torch.float32)(texts)
        for name, w in kernel_wrappers().items():
            w.launches = stage2[name]
        # -- the main path, stage 3 -------------------------------------------
        trainer = task.main(spec, {"train.total_steps": ppo_steps,
                                   "train.checkpoint_dir": ppo_dir, **(ppo_hparams or {})},
                            reward_checkpoint_dir=rm_dir, device=dev,
                            init_trainer_hook=no_checkpoints)
        # ---------------------------------------------------------------------
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        shutil.rmtree(rm_dir, ignore_errors=True)
        shutil.rmtree(ppo_dir, ignore_errors=True)
    launches = launch_counts()
    hist = trainer.tracker.history
    ppo_steps_st = [st for _, st in hist if "gradients/global_norm" in st]
    collections = [st for _, st in hist if "time/exp" in st]
    step_ms = [1e3 * (b - a) for a, b in zip(stamps[1:], stamps[2:])]  # steps 2..n
    scale = float(np.abs(want).max())
    err16, err32 = float(np.abs(got - want).max()), float(np.abs(got32 - want).max())
    rec = {"phase": "slice_reward", "model": spec, "dtype": str(cfg.dtype).split(".")[-1],
           "stage2": {"steps": len(history), "max_length": 256, "batch_size": 8, "lr": 1e-5,
                      "train_step_ms_median": statistics.median(step_ms),
                      "train_step_ms_spread": [min(step_ms), max(step_ms)],
                      "reward_loss": [h["reward/loss"] for h in history],
                      "reward_accuracy": [h["reward/accuracy"] for h in history],
                      "tensors_moved": moved, "launches": stage2},
           "scores": {"texts": len(texts), "spread": [float(want.min()), float(want.max())],
                      "bf16_max_abs_err": err16, "bf16_err_over_largest": err16 / scale,
                      "bf16_rtol_of_largest": REWARD_BF16_SCORE_RTOL,
                      "f32_card_max_abs_err": err32, "f32_atol": REWARD_F32_SCORE_ATOL},
           "stage3": {"optimizer_steps": len(ppo_steps_st),
                      "losses": [st["losses/total_loss"] for st in ppo_steps_st],
                      "train_step_ms": [1e3 * st["time/step"] for st in ppo_steps_st],
                      "time_exp_s": [c["time/exp"] for c in collections],
                      "reward_fn_s": [c["time/exp_score"] for c in collections],
                      "rollout_tokens_per_s": [c.get("throughput/rollout_tokens_per_sec")
                                               for c in collections],
                      "exp_scores_mean": [c["exp_scores/mean"] for c in collections]},
           "launches": launches, "card": card}
    problems = []
    values = (rec["stage2"]["reward_loss"] + rec["stage3"]["losses"] + list(got)
              + list(got32) + rec["stage3"]["exp_scores_mean"])
    if not all(math.isfinite(x) for x in values):
        problems.append("a non-finite value")
    if len(history) != steps or len(ppo_steps_st) != ppo_steps or not collections:
        problems.append(f"{len(history)} stage-2 steps, {len(ppo_steps_st)} PPO steps, "
                        f"{len(collections)} collections")
    if not moved:
        problems.append("the reward model did not move")
    if not err16 <= REWARD_BF16_SCORE_RTOL * scale or not err32 <= REWARD_F32_SCORE_ATOL:
        problems.append(f"scores off the plain f32 forward: bf16 {err16}, f32 {err32}")
    if dev.type == "cuda" and min(launches[k] for k in REWARD_KERNELS) <= 0:
        problems.append(f"#5 or #6 never launched: {launches}")
    if any(launches[k] for k in REPLACES if k not in REWARD_KERNELS):
        problems.append(f"a kernel off the path launched: {launches}")
    emit({**rec, "ok": not problems})
    trainer._close_prompt_iterator()
    del trainer
    if problems:
        raise AssertionError(f"slice_reward: {problems}")
    return launches


def phase_slice_dpo_lora(device="cuda", spec=FAMILY_SPEC, layers=LORA_LAYERS,
                         total_steps=LORA_STEPS, n_eval=LORA_EVAL_PROMPTS, card=""):
    """DPO with ``model.peft_kwargs`` ``LORA_PEFT`` (r 8, alpha 16, every
    projection) on ``tasks/dpo_sentiments.py``'s settings at Mistral-7B's
    full width (``FAMILY_SPEC``), cut to ``layers`` layers: 16 pairs a
    batch, ``total_steps`` steps over 16 × ``total_steps`` triples, the
    evaluations on ``n_eval`` review openings; no checkpoint is written
    (``save`` is a no-op). Prints the trainable and total parameters, the
    memory by stage, step ms and the launches (counted as in
    :func:`phase_slice_dpo`). A first loss off ln 2, a base weight that
    moved, an adapter ``lora_b`` still zero, or the DPO path's launch
    rules broken fails. Returns the launches."""
    import shutil

    import trlx_tpu_torch
    from trlx_tpu_torch.tasks import dpo_sentiments as task
    from trlx_tpu_torch.tasks.sentiment import review_prompts

    dev = torch.device(device)
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    ckpt = _scratch_dir("dpo_lora")
    config = task.config(spec, {"train.total_steps": total_steps,
                                "train.checkpoint_dir": ckpt}).evolve(
        model=dict(peft_kwargs=dict(LORA_PEFT), model_extra_kwargs={"num_layers": layers}))
    batch = config.train.batch_size
    memory, stages, built, base0 = {}, {}, {}, {}

    def base_rows(model):
        """Host copies of the first 64 rows of every frozen weight matrix
        of the first and last blocks, and of the embedding and LM head."""
        keep = ("blocks.0.", f"blocks.{layers - 1}.", "wte.", "lm_head.")
        return {k: v.detach()[:64].cpu().clone() for k, v in model.state_dict().items()
                if k.startswith(keep) and ".lora_" not in k and v.ndim == 2}

    def hook(trainer):
        trainer.save = lambda *a, **k: None
        built["s"] = time.perf_counter() - t0
        base0.update(base_rows(trainer.model))
        if dev.type == "cuda":
            memory["built"] = torch.cuda.memory_allocated(dev) / 1e9
        for name in ("make_experience", "evaluate", "accumulate_grads", "train_step"):
            record_memory(trainer, name, memory, dev)
        for name in ("make_experience", "evaluate"):
            count_launches(trainer, name, stages)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    zero_launch_counts()
    t0 = time.perf_counter()
    # -- the main path -------------------------------------------------------
    trainer = trlx_tpu_torch.train(
        samples=task.preference_triples(batch * total_steps, seed=0),
        eval_prompts=review_prompts(n_eval, seed=1), metric_fn=task.metric_fn, config=config,
        init_trainer_hook=hook, device=dev)
    # -------------------------------------------------------------------------
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    steps = [st for _, st in trainer.tracker.history if "gradients/global_norm" in st]
    losses = [st["losses/total_loss"] for st in steps]
    params = dict(trainer.model.named_parameters())
    trainable = sum(p.numel() for k, p in params.items() if trainer.param_mask[k])
    base_moved = [k for k, v in base_rows(trainer.model).items() if not torch.equal(v, base0[k])]
    lora_b = {k: float(p.detach().abs().max()) for k, p in params.items()
              if k.endswith(".lora_b")}
    problems, step_launches = dpo_launch_problems(launches, stages, dev)
    rec = {"phase": "slice_dpo_lora", "model": spec, "layers": layers, "peft": LORA_PEFT,
           "dtype": str(trainer.tcfg.dtype).split(".")[-1], "batch_pairs": batch,
           "parameters": sum(p.numel() for p in params.values()),
           "trainable_parameters": trainable,
           "optimizer_tensors": sum(len(g["params"]) for g in trainer.optimizer.param_groups),
           "build_s": built["s"], "wall_s": wall, "reference_pass_s": trainer.ref_pass_time,
           "optimizer_steps": len(steps), "losses": losses,
           "rewards_margin": [st["rewards/margin"] for st in steps],
           "train_step_ms": [1e3 * st["time/step"] for st in steps],
           "train_step_ms_median": statistics.median(1e3 * st["time/step"] for st in steps),
           "base_tensors_checked": len(base0), "base_tensors_moved": base_moved,
           "adapters": len(lora_b), "adapters_moved": sum(v > 0 for v in lora_b.values()),
           "launches": launches,
           "launches_by_stage": {"reference_pass": stages.get("make_experience"),
                                 "steps": step_launches, "evaluate": stages.get("evaluate")},
           "memory_by_stage_gb": memory,
           "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                              if dev.type == "cuda" else None), "card": card}
    if len(steps) != total_steps or not all(math.isfinite(x) for x in losses):
        problems.append(f"{len(steps)} steps, losses {losses}")
    if not abs(losses[0] - math.log(2.0)) <= DPO_FIRST_LOSS_ATOL:
        problems.append(f"first loss {losses[0]}, not ln 2")
    if base_moved or not base0:
        problems.append(f"base weights moved: {base_moved}")
    if not lora_b or not all(v > 0 for v in lora_b.values()):
        problems.append(f"{sum(v == 0 for v in lora_b.values())} adapters never moved")
    if trainable != sum(p.numel() for k, p in params.items() if ".lora_" in k):
        problems.append(f"{trainable} trainable parameters are not the adapters")
    emit({**rec, "ok": not problems})
    shutil.rmtree(ckpt, ignore_errors=True)
    del trainer
    if problems:
        raise AssertionError(f"slice_dpo_lora: {problems}")
    return launches


# ---------------------------------------------------------------------------
# phase 14: the seq2seq (T5) path
# ---------------------------------------------------------------------------

T5_PPO_SPEC = "builtin:t5-small"
# the width of the TL;DR T5 example's checkpoint (pvduy/flant5-xl_openai_tldr_sft),
# cut in depth from 24 + 24 layers
T5_ILQL_SPEC, T5_ILQL_LAYERS = "builtin:flan_t5-xl", 2
T5_ILQL_STEPS, T5_ILQL_PAIRS, T5_ILQL_EVAL = 8, 256, 16
# the fused loss pair runs under method.loss_kernel: pallas; T5's attention is
# plain torch (an einsum around a learned bias, as in JAX)
T5_KERNELS = ("fused_loss_fwd", "fused_loss_bwd")
# f32 with TF32 off: card against CPU, cached against full, pallas against
# xla, each relative to the largest |value| of the compared tensor
T5_PARITY_REL = 1e-5
# a gradient tensor whose largest entry is below this share of the model's
# largest is ~0 in exact arithmetic and holds rounding noise on both sides
# (random T5's std-1 tied embeddings saturate the decoder's self-attention
# softmax, so its q/k projections read ~1e-10 of the largest on the card):
# it is held to T5_PARITY_REL of this floor instead of its own largest
T5_GRAD_FLOOR = 1e-3


def timed_calls(trainer, name, seconds):
    """Wrap ``trainer.<name>``: the wall seconds of each call (the card
    synchronised at its end) append to ``seconds[name]``."""
    fn = getattr(trainer, name)

    def wrapped(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        seconds.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    setattr(trainer, name, wrapped)


def phase_slice_t5_ppo(device="cuda", spec=T5_PPO_SPEC, card="", hparams=None, keep=False):
    """``tasks/ppo_sentiments_t5.py`` (``examples/ppo_sentiments_t5.py`` on
    the port) as it stands on the model its offline branch resolves to
    (``builtin:t5-small`` at full width and depth: E 512, 6 + 6 layers, 8
    heads × 64, FFN 2048 relu, vocab 32128, tied; bf16 over f32 masters),
    cut only in steps: one collection of 128 rollouts and the
    ``ppo_epochs`` updates it feeds (16), then the final evaluation and
    checkpoint. Every kernel counter is set to 0 just before and read just
    after: the example's path (T5's plain attention, the staged loss)
    launches none, and a launch fails. Prints step ms (median and spread),
    ``time/exp``, rollout tokens/s, the peak memory and, over one profiled
    collection of the 128 prompts, the card's busy share and launches per
    decode step. ``hparams`` (a CPU rehearsal's sizes) are dot-path
    overrides. Returns the launches (and, with ``keep``, the trainer:
    ``slice_hf``'s (c) exports its policy)."""
    import shutil

    from trlx_tpu_torch.tasks import ppo_sentiments_t5 as task

    dev = torch.device(device)
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    ckpt = _scratch_dir("t5_ppo")
    base = task.config(spec, hparams)
    steps = base.method.num_rollouts // base.train.batch_size * base.method.ppo_epochs
    overrides = {"train.total_steps": steps, "train.checkpoint_dir": ckpt, **(hparams or {})}
    config = task.config(spec, overrides)
    steps = config.train.total_steps
    start = {}

    def hook(trainer):
        start.update({k: trainer.model.state_dict()[k].detach().cpu().clone()
                      for k in trained_keys(trainer)})

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    zero_launch_counts()
    t0 = time.perf_counter()
    try:
        # -- the main path -------------------------------------------------
        trainer = task.main(spec, overrides, device=dev, init_trainer_hook=hook)
        # -------------------------------------------------------------------
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    hist = trainer.tracker.history
    step_stats = [st for _, st in hist if "gradients/global_norm" in st]
    collections = [st for _, st in hist if "time/exp" in st]
    losses = [st["losses/total_loss"] for st in step_stats]
    step_ms = [1e3 * st["time/step"] for st in step_stats]
    end = trainer.model.state_dict()
    not_moved = [k for k in start if torch.equal(end[k].detach().cpu(), start[k])]
    rec = {"phase": "slice_t5_ppo", "model": spec, "dtype": str(trainer.tcfg.dtype).split(".")[-1],
           "parameters": sum(p.numel() for p in trainer.model.parameters()),
           "settings": {"seq_length": config.train.seq_length,
                        "batch_size": config.train.batch_size,
                        "num_rollouts": config.method.num_rollouts,
                        "chunk_size": config.method.chunk_size,
                        "ppo_epochs": config.method.ppo_epochs,
                        "num_layers_unfrozen": config.model.num_layers_unfrozen,
                        "padding_side": config.tokenizer.padding_side,
                        "loss_kernel": config.method.loss_kernel,
                        "rollout_pipeline_depth": config.train.rollout_pipeline_depth,
                        "gen_kwargs": dict(config.method.gen_kwargs)},
           "optimizer_steps": len(step_stats), "rollout_collections": len(collections),
           "losses": losses, "wall_s": wall, "train_step_ms": step_ms,
           "train_step_ms_median": statistics.median(step_ms) if step_ms else None,
           "train_step_ms_spread": [min(step_ms), max(step_ms)] if step_ms else None,
           "time_exp_s": [c["time/exp"] for c in collections],
           "time_generate_s": [c["time/generate"] for c in collections],
           "rollout_tokens_per_s": [c.get("throughput/rollout_tokens_per_sec")
                                    for c in collections],
           "exp_scores_mean": [c["exp_scores/mean"] for c in collections],
           "eval_reward_mean": [st["reward/mean"] for _, st in hist if "reward/mean" in st],
           "launches": launches, "trained_weights_unmoved": not_moved,
           "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                              if dev.type == "cuda" else None), "card": card}
    problems = []
    if len(step_stats) != steps or len(collections) != 1:
        problems.append(f"{len(step_stats)} steps, {len(collections)} collections")
    if not all(math.isfinite(x) for x in losses):
        problems.append("a non-finite loss")
    if not start or not_moved:
        problems.append(f"trainable weights did not move: {not_moved[:4]}")
    if any(launches.values()):
        problems.append(f"a kernel off the example's path launched: {launches}")
    if dev.type == "cuda" and not problems:
        t0 = time.perf_counter()
        rec["profiled_collection"] = profile_collection(trainer, task.prompts(),
                                                        config.method.chunk_size)
        rec["profile_s"] = time.perf_counter() - t0
        zero_launch_counts()
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"slice_t5_ppo: {problems}")
    return (launches, trainer) if keep else launches


def phase_slice_t5_ilql(device="cuda", spec=T5_ILQL_SPEC, layers=T5_ILQL_LAYERS,
                        total_steps=T5_ILQL_STEPS, n_pairs=T5_ILQL_PAIRS, n_eval=T5_ILQL_EVAL,
                        card="", hparams=None):
    """``tasks/ilql_summarize_t5.py`` (the TL;DR T5 example's settings:
    ``seq_length`` 550, batch 8, lr 1e-6, tau 0.6, gamma 0.99, CQL 0.1,
    AWAC 1, alpha 1e-4, the target heads synced every step, twin Q heads)
    at Flan-T5-XL's width (``T5_ILQL_SPEC``: E 2048, 32 heads × 64, FFN
    5120 gated-GELU, untied, vocab 32128; bf16 over f32 masters) cut to
    ``layers`` + ``layers`` layers: ``n_pairs`` comparisons (2 × ``n_pairs``
    samples at ±1), ``total_steps`` steps, the evaluations (at the start
    and the end of ``learn``) on ``n_eval`` TL;DR posts at ``beta`` 1, 2
    and 3, 50 tokens at top-k 50, scored by ROUGE; no checkpoint is
    written (``save`` is a no-op: the state is ~11 GB). Every kernel
    counter is set to 0 just before and read just after: nothing launches
    on this path. Prints the parameters, step ms, the memory by stage and
    the evaluation seconds. A non-finite loss, a launch, a trained weight
    or a target head that did not move fails. Returns the launches."""
    import shutil

    from trlx_tpu_torch.tasks import ilql_summarize_t5 as task

    dev = torch.device(device)
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    ckpt = _scratch_dir("t5_ilql")
    overrides = {"train.total_steps": total_steps, "train.checkpoint_dir": ckpt,
                 **(hparams or {})}
    memory, seconds, built, start = {}, {}, {}, {}

    def hook(trainer):
        trainer.save = lambda *a, **k: None
        built["s"] = time.perf_counter() - t0
        if dev.type == "cuda":
            memory["built"] = torch.cuda.memory_allocated(dev) / 1e9
        start["targets"] = _target_fingerprint(trainer.model).cpu()
        start["q"] = trainer.model.ilql_heads.q_head_0.out_proj.weight.detach()[:64].cpu().clone()
        start["dec"] = (trainer.model.backbone.dec_blocks[0].self_attn.q_proj.weight
                        .detach()[:64].cpu().clone())
        for name in ("make_experience", "evaluate", "accumulate_grads", "train_step"):
            record_memory(trainer, name, memory, dev)
        timed_calls(trainer, "evaluate", seconds)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    zero_launch_counts()
    t0 = time.perf_counter()
    # -- the main path -------------------------------------------------------
    trainer = task.main(spec, overrides, n_pairs=n_pairs, n_eval=n_eval,
                        reward_checkpoint_dir=os.path.join(ckpt, "no_reward_model"),
                        device=dev, init_trainer_hook=hook,
                        model_extra_kwargs={"num_layers": layers, "num_decoder_layers": layers})
    # -------------------------------------------------------------------------
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    hist = trainer.tracker.history
    step_stats = [st for _, st in hist if "gradients/global_norm" in st]
    losses = [st["losses/loss"] for st in step_stats]
    step_ms = [1e3 * st["time/step"] for st in step_stats]
    model = trainer.model
    moved = {
        "target_heads": not torch.equal(_target_fingerprint(model).cpu(), start["targets"]),
        "q_head": not torch.equal(model.ilql_heads.q_head_0.out_proj.weight.detach()[:64].cpu(),
                                  start["q"]),
        "decoder": not torch.equal(model.backbone.dec_blocks[0].self_attn.q_proj.weight
                                   .detach()[:64].cpu(), start["dec"]),
    }
    store = trainer.store
    rec = {"phase": "slice_t5_ilql", "model": spec, "layers": [layers, layers],
           "dtype": str(trainer.tcfg.dtype).split(".")[-1],
           "parameters": sum(p.numel() for p in model.parameters()),
           "head_parameters": sum(p.numel() for p in model.ilql_heads.parameters()),
           "samples": len(store), "batch_size": trainer.config.train.batch_size,
           "prompt_tokens_max": max(len(e.input_ids) for e in store.history),
           "output_tokens_max": max(len(e.decoder_input_ids) for e in store.history),
           "build_s": built["s"], "wall_s": wall, "optimizer_steps": len(step_stats),
           "losses": losses, "train_step_ms": step_ms,
           "train_step_ms_median": statistics.median(step_ms) if step_ms else None,
           "evaluate_s": seconds.get("evaluate"),
           "eval_metrics": [{k: v for k, v in st.items() if k.startswith("metrics/rouge_avg")}
                            for _, st in hist if any(k.startswith("metrics/") for k in st)],
           "moved": moved, "launches": launches, "memory_by_stage_gb": memory,
           "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                              if dev.type == "cuda" else None), "card": card}
    problems = []
    if len(step_stats) != total_steps or not all(math.isfinite(x) for x in losses):
        problems.append(f"{len(step_stats)} steps, losses {losses}")
    if not all(moved.values()):
        problems.append(f"did not move: {moved}")
    if any(launches.values()):
        problems.append(f"a kernel launched on a path with none: {launches}")
    emit({**rec, "ok": not problems})
    shutil.rmtree(ckpt, ignore_errors=True)
    del trainer, model
    if problems:
        raise AssertionError(f"slice_t5_ilql: {problems}")
    return launches


def rel_gap(got, want):
    """max |got - want| over the largest |want| (host f32)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def t5_parity_inputs(vocab, rows=4, prompt_len=32, dec_len=24, seed=0):
    """Encoder ids with right- and left-padded rows, decoder ids with a
    right-padded row (the T5 tasks' layouts)."""
    rs = np.random.RandomState(seed)
    ids = torch.as_tensor(rs.randint(3, vocab, (rows, prompt_len)))
    mask = torch.ones((rows, prompt_len), dtype=torch.int64)
    mask[1, prompt_len * 2 // 3:] = 0
    mask[2, : prompt_len // 4] = 0
    dec = torch.as_tensor(rs.randint(3, vocab, (rows, dec_len)))
    dmask = torch.ones((rows, dec_len), dtype=torch.int64)
    dmask[0, dec_len // 2:] = 0
    return ids, mask, dec, dmask


def t5_ppo_step_parity(dev, spec, rollouts=32, max_new=40):
    """One collected batch of ``tasks/ppo_sentiments_t5.py``'s PPO (f32,
    ``rollouts`` rollouts in one chunk) through ``loss_fn`` and backward on
    the card with ``loss_kernel`` xla (the staged loss) and pallas (#7/#8)
    on the same weights, then one pallas ``train_step``: the loss, the
    loss's own gradients (d logprobs, d values: what #8 returns) and every
    model gradient within ``T5_PARITY_REL`` of the tensor's largest (the
    largest at least ``T5_GRAD_FLOOR`` of the model's largest gradient),
    #7/#8 launching in the pallas passes only."""
    import shutil

    from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu_torch.tasks import ppo_sentiments_t5 as task
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    ckpt = _scratch_dir("t5_parity")
    config = task.config(spec, {"parallel.compute_dtype": "float32",
                                "method.num_rollouts": rollouts, "method.chunk_size": rollouts,
                                "train.batch_size": rollouts, "train.checkpoint_dir": ckpt,
                                "method.gen_kwargs.max_new_tokens": max_new})
    trainer = PPOTrainer(config=config, reward_fn=task.reward_fn, device=dev)
    width = config.train.seq_length - max_new
    trainer.add_prompt_pipeline(PromptPipeline(task.prompts(rollouts), width, trainer.tokenizer))
    trainer.make_experience(rollouts)
    batch = next(iter(trainer.store.create_loader(rollouts)))
    trainer.model.requires_grad_(True)
    passes = {}
    for kernel in ("xla", "pallas"):
        trainer.config.method.loss_kernel = kernel
        trainer.model.zero_grad(set_to_none=True)
        zero_launch_counts()
        loss, _ = trainer.loss_fn(trainer._device_batch(batch))
        loss.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        passes[kernel] = {"loss": float(loss.detach()), "launches": launch_counts(),
                          "grads": {k: p.grad.detach().clone()
                                    for k, p in trainer.model.named_parameters()
                                    if p.grad is not None}}
    xla, fused = passes["xla"], passes["pallas"]
    gmax = max(float(g.abs().max()) for g in xla["grads"].values())
    floor = T5_GRAD_FLOOR * gmax
    worst, worst_name = 0.0, None
    for k, want in xla["grads"].items():
        err = float((fused["grads"][k] - want).abs().max())
        rel = err / max(float(want.abs().max()), floor)
        if worst_name is None or not rel <= worst:
            worst, worst_name = rel, k
    loss_rel = abs(fused["loss"] - xla["loss"]) / max(abs(xla["loss"]), 1e-12)
    loss_grads = t5_loss_grads(trainer, batch)
    zero_launch_counts()
    stats = trainer.train_step(batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    step_launches = launch_counts()
    rec = {"batch": [int(x) for x in np.asarray(batch.query_tensors).shape]
           + [int(np.asarray(batch.response_tensors).shape[1])],
           "loss_xla": xla["loss"], "loss_pallas": fused["loss"], "loss_rel_err": loss_rel,
           "worst_grad_rel_err": worst, "worst_grad": worst_name, "largest_grad": gmax,
           "grad_floor": floor,
           "floored_grads": sum(float(g.abs().max()) < floor for g in xla["grads"].values()),
           "grads_compared": len(xla["grads"]), "loss_grads_rel_err": loss_grads,
           "launches_xla": xla["launches"],
           "launches_pallas": fused["launches"], "train_step_launches": step_launches,
           "train_step_loss": float(stats["losses/total_loss"])}
    problems = []
    if set(fused["grads"]) != set(xla["grads"]):
        problems.append("the two passes gave gradients to different parameters")
    if not (worst <= T5_PARITY_REL and loss_rel <= T5_PARITY_REL
            and max(loss_grads.values()) <= T5_PARITY_REL):
        problems.append(f"pallas against xla: loss {loss_rel}, loss gradients {loss_grads}, "
                        f"gradient {worst_name} {worst}")
    if any(xla["launches"].values()):
        problems.append(f"the staged loss launched {xla['launches']}")
    for name, counts in (("loss_fn", fused["launches"]), ("train_step", step_launches)):
        if any(v for k, v in counts.items() if k not in T5_KERNELS) or (
                dev.type == "cuda" and min(counts[k] for k in T5_KERNELS) <= 0):
            problems.append(f"the pallas {name} launched {counts}")
    shutil.rmtree(ckpt, ignore_errors=True)
    return problems, rec, step_launches


def t5_loss_grads(trainer, batch):
    """The staged and the fused loss's gradients with respect to the
    logprobs and values of one forward (detached leaves): their largest gap
    over the staged one's largest, by input."""
    from trlx_tpu_torch.utils.stats import logprobs_of_labels

    m, arr = trainer.config.method, trainer._device_batch(batch)
    responses = arr["response_tensors"].to(torch.int64)
    dec_in, dec_mask = trainer._decoder_inputs(responses, arr["response_mask"])
    with torch.no_grad():
        out = trainer.model(arr["query_tensors"].to(torch.int64),
                            attention_mask=arr["query_mask"], decoder_input_ids=dec_in,
                            decoder_attention_mask=dec_mask)
    mask = arr["response_mask"].float()
    old = dict(old_logprobs=arr["logprobs"], old_values=arr["values"], mask=mask)
    grads = {}
    for kernel in ("xla", "pallas"):
        lp = logprobs_of_labels(out["logits"], responses).detach().requires_grad_(True)
        v = out["value"].detach().float().requires_grad_(True)
        if kernel == "xla":
            adv, ret = m.get_advantages_and_returns(arr["values"], arr["rewards"], mask)
            loss, _ = m.loss(logprobs=lp, values=v, advantages=adv, returns=ret, **old)
        else:
            loss, _ = m.loss_fused(logprobs=lp, values=v, rewards=arr["rewards"], **old)
        grads[kernel] = torch.autograd.grad(loss, (lp, v))
    return {name: rel_gap(grads["pallas"][i], grads["xla"][i])
            for i, name in enumerate(("logprobs", "values"))}


def phase_slice_t5_parity(card="cuda", spec=T5_PPO_SPEC, max_new=24, rollouts=32):
    """In f32 with TF32 off, at ``spec`` (t5-small) from one seed on the
    card and on the CPU: (a) ``relative_position_bucket`` on the card
    equals the CPU's for every offset in [-1024, 1024], both directions,
    at (32, 128) and (8, 20); (b) the encoder states, the full decoder
    pass's logits and values within ``T5_PARITY_REL`` of the largest
    |value|, on padded rows; (c) cached decode against the full pass on
    the card, the same bound; (d) greedy ``generate_seq2seq`` on the card
    equal to the CPU's token for token; (e) one PPO step at ``loss_kernel``
    xla and pallas (:func:`t5_ppo_step_parity`: #7/#8 must launch). Prints
    the bf16 logits' gap against f32 on the card (largest over the largest
    |logit|, and where the greedy tokens part). Returns the pallas step's
    launches."""
    from trlx_tpu_torch.models.builder import build_seq2seq_lm
    from trlx_tpu_torch.models.seq2seq import relative_position_bucket
    from trlx_tpu_torch.ops.sampling import GenerationConfig, generate_seq2seq

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, cpu = torch.device(card), torch.device("cpu")
    rec = {"phase": "slice_t5_parity", "model": spec, "tf32": False, "rel_bound": T5_PARITY_REL}
    problems = []
    rel = torch.arange(-1024, 1025)
    buckets = {}
    for nb, md in ((32, 128), (8, 20)):
        for bidirectional in (True, False):
            got = relative_position_bucket(rel.to(dev), bidirectional, nb, md).cpu()
            want = relative_position_bucket(rel, bidirectional, nb, md)
            buckets[f"{nb}/{md}/{'bi' if bidirectional else 'uni'}"] = int((got != want).sum())
    rec["bucket_mismatches"] = buckets
    if any(buckets.values()):
        problems.append(f"buckets differ: {buckets}")

    models = {d.type: build_seq2seq_lm(spec, seed=0, device=d, head="value",
                                       dtype=torch.float32)[0] for d in (dev, cpu)}
    cfg = models[dev.type].config
    ids, mask, dec, dmask = t5_parity_inputs(cfg.vocab_size)
    outs = {}
    with torch.no_grad():
        for key, m in models.items():
            d = next(m.parameters()).device
            outs[key] = m(ids.to(d), mask.to(d), decoder_input_ids=dec.to(d),
                          decoder_attention_mask=dmask.to(d))
        card_out, cpu_out = outs[dev.type], outs["cpu"]
        gaps = {k: rel_gap(card_out[k], cpu_out[k])
                for k in ("encoder_hidden", "logits", "value")}
        m = models[dev.type]
        T = dec.shape[1]
        enc, cache = m.encode_for_decode(ids.to(dev), mask.to(dev), T + 1)
        cached = torch.cat([m.decode(dec[:, t : t + 1].to(dev), enc, mask.to(dev), cache=cache,
                                     cache_index=t)["logits"] for t in range(T)], dim=1)
        full = m(ids.to(dev), mask.to(dev), decoder_input_ids=dec.to(dev))["logits"]
        gaps["cached_decode"] = rel_gap(cached, full)
        gen = GenerationConfig(max_new_tokens=max_new, do_sample=False)
        seeds = torch.arange(ids.shape[0])
        greedy = {key: generate_seq2seq(m_, ids, mask, seeds, gen).response_tokens.cpu()
                  for key, m_ in models.items()}
        bf16 = build_seq2seq_lm(spec, seed=0, device=dev, head="value",
                                dtype=torch.bfloat16)[0]
        logits16 = bf16(ids.to(dev), mask.to(dev), decoder_input_ids=dec.to(dev),
                        decoder_attention_mask=dmask.to(dev))["logits"]
        greedy16 = generate_seq2seq(bf16, ids, mask, seeds, gen).response_tokens.cpu()
    rows = (dmask > 0).to(dev)
    rec["gaps"] = gaps
    rec["greedy_equal"] = bool(torch.equal(greedy[dev.type], greedy["cpu"]))
    rec["greedy_tokens"] = int(greedy["cpu"].numel())
    rec["bf16_logit_gap_over_largest"] = rel_gap(logits16[rows], card_out["logits"][rows])
    rec["bf16_greedy_tokens_equal_f32"] = int((greedy16 == greedy[dev.type]).sum())
    bad = {k: v for k, v in gaps.items() if not v <= T5_PARITY_REL}
    if bad:
        problems.append(f"gaps above {T5_PARITY_REL}: {bad}")
    if not rec["greedy_equal"]:
        problems.append("greedy tokens differ between the card and the CPU")
    del models, bf16, outs, card_out, cpu_out
    step_problems, rec["ppo_step"], launches = t5_ppo_step_parity(dev, spec, rollouts)
    problems += step_problems
    emit({**rec, "ok": not problems})
    zero_launch_counts()
    if problems:
        raise AssertionError(f"slice_t5_parity: {problems}")
    return launches


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# run management and resilience (remat, the update guard, preemption, retries,
# fault plans, the retention ring, trackers, profiler windows, rollout logs)
# ---------------------------------------------------------------------------

REMAT_SPEC = "builtin:llama-7b"
# the depth slice_remat and slice_remat_policies run (of 32): remat "none"
# in the policies phase must fit beside the f32 weights and the gradients
# JAX's semantics keep for every layer (it does not at 32), and the
# phases share the 800 s line (on an H100 the whole depth under "minimal"
# took 61.8 s and 64.8 GB, 8 layers 30.5 s: PERF.md; 4 until the serving
# phases came)
REMAT_LAYERS = 2
# the flash kernels each policy launches per layer of one training forward
# and backward: the forward kernel runs again in the backward under remat
REMAT_FLASH_FWD_PER_LAYER = {"none": 1, "minimal": 2, "full": 2}
# a gradient that goes through an atomic accumulation (the embedding's
# index backward) may differ in rounding across policies; every other one
# must be bitwise equal. Held to this share of its tensor's largest |grad|
REMAT_ATOMIC_REL = 1e-2
REMAT_ATOMIC = ("wte.weight", "wpe.weight")


def remat_hparams(layers, ckpt, steps):
    return {"model.model_extra_kwargs.num_layers": layers, "train.total_steps": steps,
            "train.checkpoint_dir": ckpt}


def phase_slice_remat(device="cuda", spec=REMAT_SPEC, layers=REMAT_LAYERS, card="",
                      hparams=None):
    """``tasks/ppo_sentiments_llama.py`` (``examples/ppo_sentiments_llama.py``
    on the port) as it stands — ``remat: minimal``, bf16 over f32 masters,
    ``seq_length`` 1024, batch 32, 128 rollouts in one chunk, 4 PPO epochs,
    40 new tokens, ``num_layers_unfrozen`` 2 — at ``builtin:llama-7b``'s
    full width cut to ``layers`` of its 32 layers: one collection and its
    16 updates, then the final evaluation. The final checkpoint write is
    skipped (``trainer.save`` is a no-op: the f32 state is tens of GB).
    Every kernel counter is set to 0 just before and read just after; the
    train steps' own launches are counted apart: per step #5 launches
    twice per layer (the forward and its recompute) and #6 once. Prints the
    depth, step ms, the peak memory and the launches. Returns ``(trainer,
    launches)``; ``hparams`` (a CPU rehearsal's sizes) are dot-path
    overrides."""
    import shutil

    from trlx_tpu_torch.tasks import ppo_sentiments_llama as task

    dev = torch.device(device)
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    ckpt = _scratch_dir("remat")
    base = task.config(spec, hparams=hparams)
    steps = base.method.num_rollouts // base.train.batch_size * base.method.ppo_epochs
    overrides = {**remat_hparams(layers, ckpt, steps), **(hparams or {})}
    config = task.config(spec, hparams=overrides)
    steps = config.train.total_steps
    stages, memory = {}, {}

    def hook(trainer):
        trainer.save = lambda *a, **k: None
        count_launches(trainer, "train_step", stages)
        record_memory(trainer, "make_experience", memory, dev)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    zero_launch_counts()
    t0 = time.perf_counter()
    try:
        # -- the main path -------------------------------------------------
        trainer = task.main(spec, overrides, device=dev, init_trainer_hook=hook)
        # -------------------------------------------------------------------
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    hist = trainer.tracker.history
    step_stats = [st for _, st in hist if "gradients/global_norm" in st]
    collections = [st for _, st in hist if "time/exp" in st]
    losses = [st["losses/total_loss"] for st in step_stats]
    step_ms = [1e3 * st["time/step"] for st in step_stats]
    in_steps = stages.get("train_step", {k: 0 for k in launches})
    tcfg = trainer.tcfg
    want = {"flash_fwd": 2 * tcfg.num_layers * steps, "flash_bwd": tcfg.num_layers * steps}
    rec = {"phase": "slice_remat", "model": spec, "layers": tcfg.num_layers,
           "of_layers": config_layers(spec), "remat": tcfg.remat,
           "dtype": str(tcfg.dtype).split(".")[-1],
           "parameters": sum(p.numel() for p in trainer.model.parameters()),
           "settings": {"seq_length": config.train.seq_length,
                        "batch_size": config.train.batch_size,
                        "num_rollouts": config.method.num_rollouts,
                        "chunk_size": config.method.chunk_size,
                        "ppo_epochs": config.method.ppo_epochs,
                        "num_layers_unfrozen": config.model.num_layers_unfrozen,
                        "loss_kernel": config.method.loss_kernel,
                        "gen_kwargs": dict(config.method.gen_kwargs)},
           "optimizer_steps": len(step_stats), "rollout_collections": len(collections),
           "losses": losses, "wall_s": wall, "train_step_ms": step_ms,
           "train_step_ms_median": statistics.median(step_ms) if step_ms else None,
           "time_exp_s": [c["time/exp"] for c in collections],
           "launches": launches, "train_step_launches": in_steps,
           "train_step_launches_expected": want, "memory_gb": memory,
           "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                              if dev.type == "cuda" else None), "card": card}
    problems = []
    if len(step_stats) != steps or len(collections) != 1:
        problems.append(f"{len(step_stats)} steps, {len(collections)} collections")
    if not all(math.isfinite(x) for x in losses):
        problems.append("a non-finite loss")
    if dev.type == "cuda" and any(in_steps[k] != n for k, n in want.items()):
        problems.append(f"the steps launched {in_steps}, not {want}")
    if any(launches[k] for k in REPLACES if k not in SERIAL_KERNELS):
        problems.append(f"a kernel off the example's path launched: {launches}")
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"slice_remat: {problems}")
    return trainer, launches


def config_layers(spec):
    from trlx_tpu_torch.models.transformer import config_from_spec

    return config_from_spec(spec).num_layers


def phase_slice_remat_policies(trainer, card=""):
    """One batch of ``slice_remat``'s store through the train step's loss
    and backward under remat ``none``, ``minimal`` and ``full``, on the
    same model: the loss must be bitwise equal, and every gradient too but
    those of an atomic accumulation (``REMAT_ATOMIC``, held to
    ``REMAT_ATOMIC_REL`` of their largest |grad|); the memory the forward
    keeps for the backward and the peak above the pass's start (the
    gradient buffers allocated before it) must fall from ``none`` to
    ``minimal`` to ``full``;
    #5 launches once per layer under ``none`` and twice under the others
    (``REMAT_FLASH_FWD_PER_LAYER``), #6 once. The gradients of ``none``
    are kept on the host for the comparison."""
    dev = trainer.device
    model = trainer.model
    backbone = getattr(model, "backbone", model)
    cfg0 = backbone.config
    L = cfg0.num_layers
    batch = next(iter(trainer.store.create_loader(trainer.config.train.batch_size)))
    arrays = trainer._device_batch(batch)
    results, ref = {}, {}
    problems = []
    # the gradient buffers (f32, every tensor) exist before each pass and
    # are zeroed in place, so the memory above the pass's start is what the
    # policy keeps for the backward and the backward's transients
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    gb = (lambda n: n / 1e9) if dev.type == "cuda" else (lambda n: None)
    try:
        for policy in ("none", "minimal", "full"):
            backbone.config = dataclasses.replace(cfg0, remat=policy)
            model.zero_grad(set_to_none=False)
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
            zero_launch_counts()
            t0 = time.perf_counter()
            loss, _ = trainer.loss_fn(arrays)
            kept = torch.cuda.memory_allocated(dev) - start if dev.type == "cuda" else 0
            loss.backward()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
            launches = launch_counts()
            peak = torch.cuda.max_memory_allocated(dev) - start if dev.type == "cuda" else 0
            grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
            gaps = {}
            if policy == "none":
                ref = {n: g.detach().to("cpu", copy=True) for n, g in grads.items()}
                ref_loss = loss.detach().cpu()
            else:
                for n, g in grads.items():
                    want = ref[n].to(dev)
                    if not torch.equal(g, want):
                        gaps[n] = float((g - want).abs().max()) / max(float(want.abs().max()), 1e-30)
                if not torch.equal(loss.detach().cpu(), ref_loss):
                    problems.append(f"{policy}: loss {float(loss)} != {float(ref_loss)}")
                if set(grads) != set(ref):
                    problems.append(f"{policy}: gradients of other tensors")
                bad = {n: v for n, v in gaps.items()
                       if not n.endswith(REMAT_ATOMIC) or v > REMAT_ATOMIC_REL}
                if bad:
                    problems.append(f"{policy}: gradients differ: {sorted(bad.items())[:6]}")
            want_fwd = REMAT_FLASH_FWD_PER_LAYER[policy] * L
            if dev.type == "cuda" and (launches["flash_fwd"] != want_fwd
                                       or launches["flash_bwd"] != L):
                problems.append(f"{policy}: #5/#6 launched {launches['flash_fwd']}/"
                                f"{launches['flash_bwd']}, not {want_fwd}/{L}")
            results[policy] = {"loss": loss.item(), "peak_gb_above_start": gb(peak),
                               "kept_after_forward_gb": gb(kept),
                               "seconds": seconds, "flash_fwd": launches["flash_fwd"],
                               "flash_bwd": launches["flash_bwd"],
                               "gradients_not_bitwise": gaps}
            del loss, grads
    finally:
        backbone.config = cfg0
        model.zero_grad(set_to_none=True)
        zero_launch_counts()
    for key in ("peak_gb_above_start", "kept_after_forward_gb"):
        vals = [results[p][key] for p in ("none", "minimal", "full")]
        if dev.type == "cuda" and not vals[0] > vals[1] > vals[2]:
            problems.append(f"{key} does not fall none > minimal > full: {vals}")
    emit({"phase": "slice_remat_policies", "layers": L, "rows": int(arrays["query_tensors"].shape[0]),
          "width": int(arrays["query_tensors"].shape[1] + arrays["response_tensors"].shape[1]),
          "policies": results, "atomic_rel_tol": REMAT_ATOMIC_REL, "card": card,
          "ok": not problems})
    if problems:
        raise AssertionError(f"slice_remat_policies: {problems}")


RESILIENCE_PLAN = ("reward_raise@call:2*2; nan_loss@step:3; flightrec_dump@step:2; "
                   "health_trip@step:4; sleep_one_proc@step:2")
RESILIENCE_PREEMPT = "sigterm@step:5"
RESILIENCE_STEPS, RESILIENCE_INTERVAL, RESILIENCE_KEEP = 8, 2, 2
# the presets' model cut to 6 of GPT-2 small's 12 layers (full width): with
# slice_hf the script read 722.4 s of phases on a fast host, against 670.9
# before it; the drills' checks do not depend on the depth (at 2 layers the
# phase read within its host noise of 6: it is not depth-bound)
RESILIENCE_LAYERS = 6


def ring_survivors(saves, keep):
    """The ``checkpoint_<step>`` dirs the retention ring leaves: each
    interval save first prunes the committed ones beyond the newest
    ``keep``; an emergency or final save does not prune."""
    alive = []
    for step, interval in saves:
        if interval and keep > 0:
            alive = alive[-keep:] if len(alive) > keep else alive
        if step not in alive:
            alive.append(step)
    return alive


def resilience_run(config, prompts, dev, expect_preempt=False):
    """``trlx_tpu_torch.train`` once; ``(trainer or None, preempted)``."""
    import trlx_tpu_torch
    from trlx_tpu_torch.profile_train import reward_fn
    from trlx_tpu_torch.resilience import TrainingPreempted

    try:
        trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, config=config,
                                       device=dev)
    except TrainingPreempted:
        if not expect_preempt:
            raise
        return None, True
    return trainer, False


def phase_slice_resilience(device="cuda", spec="builtin:gpt2-small", card="",
                           total_steps=RESILIENCE_STEPS, n_prompts=SERIAL_PROMPTS,
                           sections=None):
    """The presets' serial PPO path (``serial_config``; the model cut to
    ``RESILIENCE_LAYERS`` layers) under a fault plan,
    for each loss kernel (``xla``, ``pallas``): ``RESILIENCE_PLAN`` (the
    reward function fails its 2nd and 3rd attempts, the loss of update 4 is
    poisoned to NaN) with ``update_guard: skip``, ``keep_last_n`` 2,
    checkpoints every 2 updates, the JSONL tracker, rollout logs and a
    profiler window of 2 steps (``TRLX_TPU_PROFILE``). An uninterrupted run,
    then the same plan with ``sigterm@step:5`` (an emergency checkpoint),
    then a resume to ``total_steps`` from it: the final weights must equal
    the uninterrupted run's bitwise; ``stats.jsonl`` must show one skipped
    update, the guard's flag and the gradient norm non-finite at the
    poisoned update (so the NaN came through the loss kernels' backward),
    and 2 reward retries; the checkpoints left are the ring's; the trace
    names #5 and #6; rollout files are written; the default signal handlers
    are back. Observability (``observability_problems``): the
    uninterrupted run's ``trace.json`` and ``spans.jsonl`` hold one fenced
    ``train_step`` span per update whose duration is the logged
    ``time/step`` (update 2 holding the injected straggler's sleep), the
    flight recorder dumped at step 2 (``flightrec_dump``) and, in the
    preempted run, on the preemption, ``health/verdict`` tripped at step 4
    (``health_trip``, with its triage batch), ``throughput/mfu`` in (0, 1]
    on every update after the counted first, the ``memory/device_*`` gauges
    read; after both kernels, the ``dist/*`` gauges of the ``pallas`` run
    (#7's sketch bins) equal the ``xla`` run's at the first update, where
    both loss paths take the same operands (later updates' gaps are
    reported). Every
    kernel counter is set to 0 just before the three runs of each kernel
    and read after; #5 and #6 (and, at ``pallas``, #7/#8) must launch.
    Returns the launches summed over both kernels."""
    import glob
    import shutil
    import signal

    from trlx_tpu_torch.observability.profiling import PROFILE_ENV
    from trlx_tpu_torch.profile_train import slice_prompts

    dev = torch.device(device)
    prompts = slice_prompts(n_prompts)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    total = {k: 0 for k in REPLACES}
    records, problems = [], []
    dist_by_kernel = {}
    for loss_kernel in ("xla", "pallas"):
        root = _scratch_dir(f"resilience_{loss_kernel}")
        prof_dir = os.path.join(root, "profile")
        os.environ[PROFILE_ENV] = f"steps:1-2,dir:{prof_dir}"

        def config(tag, plan):
            d = os.path.join(root, tag)
            sec = {**(sections or {})}
            sec["train"] = dict(sec.get("train", {}), tracker="jsonl",
                                rollout_logging_dir=os.path.join(d, "rollouts"),
                                resume_from_checkpoint=True)
            sec["method"] = dict(sec.get("method", {}), loss_kernel=loss_kernel)
            sec["resilience"] = dict(fault_plan=plan, update_guard="skip",
                                     keep_last_n=RESILIENCE_KEEP, reward_backoff_s=0.01)
            sec["model"] = dict(sec.get("model", {}), model_extra_kwargs={
                "num_layers": min(RESILIENCE_LAYERS, config_layers(spec))})
            return serial_config(d, spec, total_steps, RESILIENCE_INTERVAL, **sec)

        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        zero_launch_counts()
        t0 = time.perf_counter()
        try:
            # -- the main path: uninterrupted, preempted, resumed -------------
            ref, _ = resilience_run(config("ref", RESILIENCE_PLAN), prompts, dev)
            os.environ.pop(PROFILE_ENV, None)
            _, preempted = resilience_run(
                config("run", f"{RESILIENCE_PLAN}; {RESILIENCE_PREEMPT}"), prompts, dev,
                expect_preempt=True)
            emergency = sorted(os.listdir(os.path.join(root, "run")))
            resumed, _ = resilience_run(config("run", RESILIENCE_PLAN), prompts, dev)
            # ------------------------------------------------------------------
            wall = time.perf_counter() - t0
            launches = launch_counts()
            a, b = ref.model.state_dict(), resumed.model.state_dict()
            unequal = [k for k in a if not torch.equal(a[k], b[k])]
            records_jsonl = [json.loads(line) for line in
                             open(os.path.join(root, "ref", "logs", "stats.jsonl"))]
            steps = [r for r in records_jsonl if "gradients/global_norm" in r]
            poisoned = [r for r in steps if r.get("resilience/update_ok") == 0.0]
            last = steps[-1] if steps else {}
            left = {tag: sorted(int(n.rsplit("_", 1)[1]) for n in
                                os.listdir(os.path.join(root, tag)) if n.startswith("checkpoint_"))
                    for tag in ("ref", "run")}
            saves_ref = [(s, True) for s in range(RESILIENCE_INTERVAL, total_steps + 1,
                                                  RESILIENCE_INTERVAL)] + [(total_steps, False)]
            preempt_at = int(RESILIENCE_PREEMPT.rsplit(":", 1)[1])
            saves_run = ([(s, True) for s in range(RESILIENCE_INTERVAL, preempt_at + 1,
                                                     RESILIENCE_INTERVAL)]
                         + [(preempt_at, False)]
                         + [(s, True) for s in range(preempt_at + 1, total_steps + 1)
                            if s % RESILIENCE_INTERVAL == 0] + [(total_steps, False)])
            want_left = {"ref": ring_survivors(saves_ref, RESILIENCE_KEEP),
                         "run": ring_survivors(saves_run, RESILIENCE_KEEP)}
            traces = glob.glob(os.path.join(prof_dir, "*.json"))
            names = set()
            for path in traces:
                with open(path) as f:
                    names |= {e.get("name", "") for e in json.load(f).get("traceEvents", [])
                              if e.get("cat") == "kernel"}
            rollouts = {tag: sorted(os.listdir(os.path.join(root, tag, "rollouts")))
                        for tag in ("ref", "run")}
            obs_rec, obs_bad = observability_problems(root, ref, dev)
            dist_by_kernel[loss_kernel] = [
                {k: v for k, v in st.items() if k.startswith("dist/")}
                for _, st in ref.tracker.history if "gradients/global_norm" in st]
        finally:
            os.environ.pop(PROFILE_ENV, None)
            shutil.rmtree(root, ignore_errors=True)
        rec = {"phase": "slice_resilience", "loss_kernel": loss_kernel, "wall_s": wall,
               "preempted": preempted, "emergency_dir": emergency,
               "final_weights_unequal": unequal[:8], "steps": len(steps),
               "poisoned_steps": [{k: r.get(k) for k in ("step", "resilience/update_ok",
                                                         "gradients/global_norm",
                                                         "losses/total_loss")}
                                  for r in poisoned],
               "skipped_updates": last.get("resilience/skipped_updates"),
               "reward_retries": last.get("resilience/reward_retries"),
               "learning_rate": [r.get("learning_rate") for r in steps],
               "checkpoints_left": left, "checkpoints_expected": want_left,
               "trace_kernels": sorted(n for n in names if "flash_" in n or "fused_" in n)[:8],
               "rollout_files": rollouts, "observability": obs_rec, "launches": launches,
               "card": card}
        bad = list(obs_bad)
        if not preempted:
            bad.append("no preemption")
        if unequal:
            bad.append(f"resumed weights differ: {unequal[:4]}")
        if len(steps) != total_steps or last.get("resilience/skipped_updates") != 1.0:
            bad.append(f"{len(steps)} steps, skipped {last.get('resilience/skipped_updates')}")
        if (len(poisoned) != 1
                or math.isfinite(float(poisoned[0].get("gradients/global_norm", 0.0)))):
            bad.append(f"the guard's flag or the norm at the poisoned update: {poisoned}")
        if last.get("resilience/reward_retries") != 2.0:
            bad.append(f"reward retries {last.get('resilience/reward_retries')}")
        if left != want_left:
            bad.append(f"checkpoints left {left}, the ring's {want_left}")
        if dev.type == "cuda" and not all(any(k in n for n in names)
                                           for k in ("flash_fwd", "flash_bwd")):
            bad.append(f"the trace names no flash kernel: {sorted(names)[:8]}")
        if not traces:
            bad.append("no trace written")
        if not rollouts["ref"] or not rollouts["run"]:
            bad.append(f"rollout files {rollouts}")
        must = SERIAL_KERNELS + (T5_KERNELS if loss_kernel == "pallas" else ())
        if dev.type == "cuda" and min(launches[k] for k in must) <= 0:
            bad.append(f"a kernel of the path never launched: {launches}")
        if any(launches[k] for k in REPLACES if k not in must):
            bad.append(f"a kernel off the path launched: {launches}")
        if any(signal.getsignal(s) != h for s, h in handlers.items()):
            bad.append("the signal handlers were not restored")
        emit({**rec, "ok": not bad})
        problems += [f"{loss_kernel}: {p}" for p in bad]
        for k in total:
            total[k] += launches[k]
        del ref, resumed
    # the first update feeds both loss paths the same operands (the same
    # rollouts and weights), so #7's sketch bins must give the staged
    # loss's gauges exactly; later updates start from weights the two
    # runs' last-bit gradient differences moved apart (Adam's step on
    # gradients that are zero in exact arithmetic), and are reported
    first_x, first_p = (dist_by_kernel[k][0] if dist_by_kernel[k] else {}
                        for k in ("xla", "pallas"))
    first_gaps = [(k, first_x.get(k), first_p.get(k)) for k in sorted(set(first_x) | set(first_p))
                  if first_x.get(k) != first_p.get(k)]
    later = [max((abs(a[k] - b[k]) for k in a if k in b), default=0.0)
             for a, b in zip(dist_by_kernel["xla"][1:], dist_by_kernel["pallas"][1:])]
    emit({"phase": "slice_resilience_dist", "updates": len(dist_by_kernel["xla"]),
          "first_update_gauges": len(first_x), "first_update_unequal": first_gaps,
          "later_updates_max_abs_gap": later,
          "ok": not first_gaps and len(first_x) > 0})
    if first_gaps or not first_x or len(dist_by_kernel["xla"]) != len(dist_by_kernel["pallas"]):
        problems.append(f"dist/* of pallas differ from xla at the first update: {first_gaps}")
    if problems:
        raise AssertionError(f"slice_resilience: {problems}")
    return total


def observability_problems(root, ref, dev):
    """``slice_resilience``'s observability checks of one loss kernel's
    runs under ``root`` (``ref``: the uninterrupted run's trainer):
    ``(record, problems)``."""
    from trlx_tpu_torch.resilience.faults import SLEEP_FAULT_S

    problems = []
    ref_logs, run_logs = os.path.join(root, "ref", "logs"), os.path.join(root, "run", "logs")
    steps = [st for _, st in ref.tracker.history if "gradients/global_norm" in st]
    for name in ("trace.json", "spans.jsonl", "flightrec.json"):
        if not os.path.exists(os.path.join(ref_logs, name)):
            problems.append(f"no {name} in the uninterrupted run's logs")
    spans = []
    if os.path.exists(os.path.join(ref_logs, "spans.jsonl")):
        with open(os.path.join(ref_logs, "spans.jsonl")) as f:
            spans = [json.loads(line) for line in f]
    step_spans = [sp["dur_s"] for sp in spans if sp["name"] == "train_step"]
    logged = [st["time/step"] for st in steps]
    if len(step_spans) != len(steps) or not all(
            math.isclose(a, b, rel_tol=1e-9) for a, b in zip(step_spans, logged)):
        problems.append(f"train_step spans {step_spans} against time/step {logged}")
    if len(logged) > 2 and not logged[2] >= SLEEP_FAULT_S:
        problems.append(f"update 2 took {logged[2]} s, under the injected {SLEEP_FAULT_S} s")
    dumps = [st.get("flightrec/dumps") for st in steps]
    if dumps[:3] != [None, None, 1.0]:
        problems.append(f"flightrec/dumps by update {dumps}: no dump at step 2")
    preempt_dump = {}
    if os.path.exists(os.path.join(run_logs, "flightrec.json")):
        with open(os.path.join(run_logs, "flightrec.json")) as f:
            preempt_dump = json.load(f)
    preempt_records = [r for r in preempt_dump.get("records", [])
                       if r["kind"] == "resilience"
                       and r.get("data", {}).get("event") == "preemption"]
    if not str(preempt_dump.get("reason", "")).startswith("TrainingPreempted") or \
            not preempt_records:
        problems.append(f"the preempted run's flight record: {preempt_dump.get('reason')}")
    verdicts = [st.get("health/verdict") for st in steps]
    if len(verdicts) < 5 or verdicts[4] != 1.0:
        problems.append(f"health/verdict by update {verdicts}: no trip at step 4")
    if not os.path.exists(os.path.join(ref_logs, "triage", "step4.npz")):
        problems.append("no triage batch at step 4")
    mfus = [st.get("throughput/mfu") for st in steps]
    if not all(m is not None and 0.0 < m <= 1.0 for m in mfus[1:]):
        problems.append(f"throughput/mfu {mfus}")
    memory = {k: steps[-1].get(k) for k in ("memory/device_bytes_in_use",
                                             "memory/device_peak_bytes",
                                             "memory/device_limit_bytes")}
    if dev.type == "cuda" and not all(v and v > 0 for v in memory.values()):
        problems.append(f"memory gauges {memory}")
    rec = {"train_step_spans": len(step_spans), "time_step_s": logged,
           "flightrec_dumps": dumps, "preempt_dump_reason": preempt_dump.get("reason"),
           "preempt_dump_records": len(preempt_dump.get("records", [])),
           "health_verdict": verdicts, "mfu": mfus, "train_step_flops": ref._train_step_flops,
           "memory": memory, "span_names": sorted({sp["name"] for sp in spans})}
    return rec, problems


# ---------------------------------------------------------------------------
# phase 17: Hugging Face checkpoints on the card (no transformers, no
# safetensors package)
# ---------------------------------------------------------------------------

# the key names of transformers' GPT2Config that the export writes
GPT2_HF_KEYS = {"model_type", "architectures", "vocab_size", "n_positions", "n_embd", "n_layer",
                "n_head", "n_inner", "layer_norm_epsilon"}
# the reference's value head, Sequential(Linear, ReLU, Linear), against the port's
V_HEAD_KEYS = {"v_head.0.weight": "v_head.in_proj.weight", "v_head.0.bias": "v_head.in_proj.bias",
               "v_head.2.weight": "v_head.out_proj.weight", "v_head.2.bias": "v_head.out_proj.bias"}
# (a)'s 16 requests: 64-token prompts, 32 new tokens (no eos), half greedy
HF_SERVE = dict(slots=8, prompt_len=64, block_size=16, max_new=32, segment_len=8)
HF_REQUESTS = 16
# (a)'s PPO from the directory: one collection of 64 rollouts, two updates of
# 32 under the fused loss (#7/#8)
HF_PPO = dict(num_rollouts=64, chunk_size=64, ppo_epochs=1, loss_kernel="pallas")
HF_PPO_STEPS = 2
# f32 round-off: the scoring logprobs are f32, the weights bitwise equal
HF_LOGPROB_ATOL = 1e-5
HF_LOGIT_ATOL = 1e-5
# (b): shards of at most 512 MiB (two at Mistral-7B's width, one layer, bf16)
HF_SHARD_BYTES = 512 * 2 ** 20
HF_ENGINE = dict(slots=4, prompt_len=256, block_size=16, max_new=4, segment_len=4)
SAFETENSORS_NAMES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"}


def write_safetensors(directory, tensors, dtype, shard_bytes):
    """A small writer of the safetensors format (an 8-byte little-endian
    header length, a JSON header, raw bytes), no ``safetensors`` package:
    ``tensors`` cast to ``dtype`` into shards of at most ``shard_bytes`` (a
    tensor is never split) named as ``transformers`` names them, and
    ``model.safetensors.index.json``. Returns (shard files, bytes)."""
    item = torch.empty((), dtype=dtype).element_size()
    groups, size = [[]], 0
    for name, t in tensors.items():
        n = t.numel() * item
        if groups[-1] and size + n > shard_bytes:
            groups.append([])
            size = 0
        groups[-1].append(name)
        size += n
    files, weight_map, total = [], {}, 0
    for i, names in enumerate(groups):
        file = f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors"
        header, offset = {"__metadata__": {"format": "pt"}}, 0
        for name in names:
            n = tensors[name].numel() * item
            header[name] = {"dtype": SAFETENSORS_NAMES[dtype],
                            "shape": list(tensors[name].shape), "data_offsets": [offset, offset + n]}
            offset += n
            weight_map[name] = file
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)
        with open(os.path.join(directory, file), "wb") as f:
            f.write(len(raw).to_bytes(8, "little"))
            f.write(raw)
            for name in names:
                t = tensors[name].detach().to(dtype).contiguous().cpu()
                t.view(torch.uint8).numpy().tofile(f)
        files.append(file)
        total += 8 + len(raw) + offset
    with open(os.path.join(directory, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    return files, total


def hf_requests(vocab, n=HF_REQUESTS, geo=HF_SERVE, seed=1717):
    """(a)'s requests in one wave: seeded full-width prompts, the even
    ones greedy."""
    rs = np.random.RandomState(seed)
    reqs = [{"tenant": None, "class": "actor", "ids": rs.randint(0, vocab - 1, geo["prompt_len"]),
             "greedy": i % 2 == 0, "seed": i} for i in range(n)]
    return [(reqs, None)]


def hf_serve(model, cfg, dev, sync, waves):
    """``waves`` over HTTP through ``ServeServer`` on a paged engine over
    ``model``, behind the gate (every request in the engine before its
    first step, so two models see one schedule). Returns (tokens by
    request, wall seconds)."""
    geo = {**HF_SERVE, "cap_blocks": 0, "prefill_chunk": 0}
    engine, _ = prefix_engine(model, cfg, dev, geo=geo, prefix=False)
    results, _, _, wall = serve_prefix_stream(engine, waves, geo["max_new"], sync)
    return {i: list(r[1]) for i, r in results.items()}, wall


def phase_slice_hf_gpt2(trainer, device="cuda", card="", sections=None):
    """(a) The policy ``slice_serial`` trained (GPT-2 small, full width and
    depth, f32 masters): ``trainer.save_pretrained`` writes the HF
    directory (``config.json`` in GPT-2's HF keys, ``pytorch_model.bin``
    with the value head merged as ``v_head.*``, bitwise the trainer's);
    ``build_causal_lm(<dir>, head="value")`` gives a backbone bitwise equal
    to the trainer's (the heads are seeded, as from any checkpoint); 16
    requests over HTTP, half greedy, on the loaded model equal the
    trainer's in-memory policy's on the same schedule (#1–#3); and
    ``trlx_tpu_torch.train`` with ``model.model_path`` the directory
    (``HF_PPO``: one collection, two updates under the fused loss, #5–#8),
    whose first scoring logprobs equal the in-memory policy's on the same
    rows within ``HF_LOGPROB_ATOL``. Counts are set to 0 just before the
    serve and the PPO run and read just after; the directory is removed at
    the end. ``sections`` (a CPU rehearsal's sizes) evolve the PPO config.
    Returns the launches."""
    import shutil

    import trlx_tpu_torch
    from trlx_tpu_torch.models.builder import build_causal_lm
    from trlx_tpu_torch.profile_train import reward_fn, slice_prompts

    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    tmp = _scratch_dir("slice_hf_gpt2")
    problems, launches = [], Counter()
    rec = {"phase": "slice_hf_gpt2", "policy": trainer.config.model.model_path, "card": card}
    policy = {k: v.detach() for k, v in trainer.model.state_dict().items()}
    try:
        t0 = time.perf_counter()
        trainer.save_pretrained(tmp)
        rec["save_s"] = time.perf_counter() - t0
        rec["files"] = sorted(os.listdir(tmp))
        with open(os.path.join(tmp, "config.json")) as f:
            rec["config_json"] = hf_cfg = json.load(f)
        if hf_cfg.get("model_type") != "gpt2" or set(hf_cfg) != GPT2_HF_KEYS:
            problems.append(f"config.json is not GPT-2's: {sorted(hf_cfg)}")
        saved = torch.load(os.path.join(tmp, "pytorch_model.bin"), weights_only=True)
        rec["v_head_unequal"] = [k for k, ours in V_HEAD_KEYS.items()
                                 if k not in saved or not torch.equal(saved[k],
                                                                     policy[ours].cpu())]
        del saved
        if rec["v_head_unequal"]:
            problems.append(f"the merged value head differs: {rec['v_head_unequal']}")

        t0 = time.perf_counter()
        model, cfg = build_causal_lm(tmp, head="value", device=dev)
        sync()
        rec["load_s"] = time.perf_counter() - t0
        loaded = model.state_dict()
        rec["backbone_unequal"] = [k for k in policy if k.startswith("backbone.")
                                   and not torch.equal(loaded[k], policy[k])]
        if rec["backbone_unequal"]:
            problems.append(f"reloaded backbone differs: {rec['backbone_unequal'][:4]}")

        waves = hf_requests(cfg.vocab_size)
        sync()
        zero_launch_counts()
        # -- the main path: the loaded model served over HTTP ---------------
        served, rec["serve_wall_s"] = hf_serve(model, cfg, dev, sync, waves)
        served_launches = launch_counts()
        # -------------------------------------------------------------------
        launches.update(served_launches)
        in_memory, _ = hf_serve(trainer.model, trainer.tcfg, dev, sync, waves)
        zero_launch_counts()
        greedy = [i for i, r in enumerate(waves[0][0]) if r["greedy"]]
        rec["greedy_rows_equal"] = sum(served[i] == in_memory[i] for i in greedy)
        rec["sampled_rows_equal"] = sum(served[i] == in_memory[i] for i in served
                                        if i not in greedy)
        rec["serve_launches"] = {k: served_launches[k] for k in SERVE_KERNELS}
        if rec["greedy_rows_equal"] != len(greedy):
            problems.append(f"greedy rows differ from the in-memory policy's: "
                            f"{rec['greedy_rows_equal']} of {len(greedy)} equal")
        if dev.type == "cuda" and min(rec["serve_launches"].values()) <= 0:
            problems.append(f"#1-#3 never launched serving the loaded model: {served_launches}")
        del model, loaded

        scored = {}

        def hook(t):
            score = t._dispatch_score

            def first_score(*args, **kwargs):
                out = score(*args, **kwargs)
                if not scored:
                    scored["args"] = [torch.as_tensor(a).clone() for a in args]
                    scored["logprobs"] = out["logprobs"].detach().clone()
                return out

            t._dispatch_score = first_score

        ckpt = _scratch_dir("slice_hf_ppo")
        ppo_sections = dict(sections or {})
        ppo_sections["method"] = {**HF_PPO, **ppo_sections.get("method", {})}
        config = serial_config(ckpt, tmp, HF_PPO_STEPS, HF_PPO_STEPS * 8, **ppo_sections)
        sync()
        zero_launch_counts()
        try:
            # -- the main path: PPO from the checkpoint directory ------------
            ppo = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=slice_prompts(64),
                                       config=config, init_trainer_hook=hook, device=dev)
            sync()
            ppo_launches = launch_counts()
            # ----------------------------------------------------------------
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        launches.update(ppo_launches)
        steps = [st for _, st in ppo.tracker.history if "gradients/global_norm" in st]
        want = trainer._dispatch_score(*scored["args"])["logprobs"]
        zero_launch_counts()
        mask = scored["args"][3].to(want.device) > 0
        rec["ppo"] = {"model_path_is_dir": os.path.isdir(config.model.model_path),
                      "optimizer_steps": len(steps),
                      "losses": [st["losses/total_loss"] for st in steps],
                      "first_scoring_rows": int(want.shape[0]),
                      "first_logprob_max_abs_err": float(
                          (scored["logprobs"] - want).abs()[mask].max()),
                      "launches": ppo_launches}
        del ppo
        if len(steps) != HF_PPO_STEPS or not all(math.isfinite(x) for x in rec["ppo"]["losses"]):
            problems.append(f"PPO from the directory: {rec['ppo']}")
        if rec["ppo"]["first_logprob_max_abs_err"] > HF_LOGPROB_ATOL:
            problems.append(f"first scoring logprobs differ: {rec['ppo']['first_logprob_max_abs_err']}")
        if dev.type == "cuda" and min(ppo_launches[k] for k in TRAIN_KERNELS) <= 0:
            problems.append(f"#5-#8 never launched in PPO from the directory: {ppo_launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({**rec, "launches": dict(launches), "ok": not problems})
    if problems:
        raise AssertionError(f"slice_hf_gpt2: {problems}")
    return dict(launches)


def phase_slice_hf_mistral(model, cfg, device="cuda", card="", rows=2, geo=HF_ENGINE):
    """(b) Mistral-7B's width at the family phases' depth — their model, no
    new draw — as a hub checkpoint looks: its HF state dict (the port's
    exporter) in bf16, sharded by :func:`write_safetensors` (at most
    ``HF_SHARD_BYTES`` a shard), beside its ``config.json``. Two reads of
    it onto the card, each with its seconds, GB/s of checkpoint and peak
    device memory above what was allocated before it (a warm read of
    files just written): ``load_pretrained`` alone (the weights as
    stored, bf16), then ``build_causal_lm(<dir>)``, the path users and
    trainers take (the backbone cast to its f32 masters, nothing drawn).
    Both give the in-memory model's weights rounded to bf16 (rounded in
    place: the phase is the model's last use), bitwise; the built model's
    logits equal the rounded model's within ``HF_LOGIT_ATOL``; then one
    prefill and ``geo["max_new"]`` decode steps of the paged engine on the
    built model (#1–#3, counted from 0), its greedy tokens equal to the
    rounded in-memory model's. Returns the launches."""
    import shutil

    from trlx_tpu_torch.models import hf_interop
    from trlx_tpu_torch.models.builder import build_causal_lm

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)

    def timed_read(read):
        """``(read(), seconds, peak bytes above the allocation before)``."""
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev) if cuda else 0
        t0 = time.perf_counter()
        out = read()
        sync()
        return out, time.perf_counter() - t0, (
            torch.cuda.max_memory_allocated(dev) - base if cuda else None)

    tmp = _scratch_dir("slice_hf_mistral")
    try:
        t0 = time.perf_counter()
        files, nbytes = write_safetensors(
            tmp, hf_interop.params_to_hf_state_dict(model.state_dict(), cfg), torch.bfloat16,
            HF_SHARD_BYTES)
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(hf_interop.hf_config_from_transformer(cfg), f)
        write_s = time.perf_counter() - t0
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(p.to(torch.bfloat16))
        want = model.state_dict()
        (state_dict, _), load_s, load_peak = timed_read(
            lambda: hf_interop.load_pretrained(tmp, device=dev))
        loaded_dtype = str(state_dict["wte.weight"].dtype).split(".")[-1]
        unequal = [k for k in want if not torch.equal(state_dict[k].float(), want[k])]
        del state_dict
        (loaded, lcfg), build_s, build_peak = timed_read(
            lambda: build_causal_lm(tmp, device=dev))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    unequal += [f"built:{k}" for k, v in loaded.state_dict().items()
                if not torch.equal(v, want[k])]
    ids = torch.as_tensor(np.random.RandomState(7).randint(
        0, cfg.vocab_size - 1, (rows, geo["prompt_len"])), device=dev)
    with torch.no_grad():
        logit_err = float((loaded(ids)["logits"].float() - model(ids)["logits"].float())
                          .abs().max())
    prompts = np.random.RandomState(8).randint(0, cfg.vocab_size - 1,
                                               (geo["slots"], geo["prompt_len"]))

    def engine_tokens(m, c):
        engine, _ = prefix_engine(m, c, dev, geo={**geo, "cap_blocks": 0, "prefill_chunk": 0},
                                  prefix=False, sample=False)
        engine.enqueue_prompts(prompts, np.ones_like(prompts), np.arange(len(prompts)))
        done = engine.run()
        sync()
        return {c_.index: c_.tokens.tolist() for c_ in done}

    sync()
    zero_launch_counts()
    # -- the main path: the loaded model through the paged engine ------------
    got = engine_tokens(loaded, lcfg)
    launches = launch_counts()
    # -------------------------------------------------------------------------
    ref = engine_tokens(model, cfg)
    zero_launch_counts()
    weights_gb = sum(v.numel() * v.element_size() for v in want.values()) / 1e9
    rec = {"phase": "slice_hf_mistral", "model": FAMILY_SPEC, "layers": cfg.num_layers,
           "shards": files, "checkpoint_gb": nbytes / 1e9, "write_s": write_s, "read": "warm",
           "load_s": load_s, "load_gb_per_s": nbytes / 1e9 / load_s, "loaded_dtype": loaded_dtype,
           "load_peak_gb": load_peak and load_peak / 1e9, "build_s": build_s,
           "build_gb_per_s": nbytes / 1e9 / build_s, "built_weights_gb": weights_gb,
           "build_peak_gb": build_peak and build_peak / 1e9,
           "weights_unequal_to_bf16_rounded": unequal, "logit_max_abs_err": logit_err,
           "engine_rows_equal": sum(got[i] == ref[i] for i in ref), "engine_rows": len(ref),
           "launches": {k: launches[k] for k in SERVE_KERNELS}, "card": card}
    problems = []
    if len(files) < 2:
        problems.append(f"{len(files)} shard(s)")
    if unequal:
        problems.append(f"loaded weights differ from the bf16-rounded model: {unequal[:4]}")
    if not logit_err <= HF_LOGIT_ATOL:
        problems.append(f"logits differ by {logit_err}")
    if rec["engine_rows_equal"] != len(ref):
        problems.append("the loaded model's greedy tokens differ")
    if dev.type == "cuda" and min(rec["launches"].values()) <= 0:
        problems.append(f"#1-#3 never launched: {launches}")
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"slice_hf_mistral: {problems}")
    return launches


def phase_slice_hf_t5(trainer, device="cuda", card="", rows=4, max_new=24):
    """(c) The t5-small policy ``slice_t5_ppo`` trained:
    ``trainer.save_pretrained`` → ``build_seq2seq_lm(<dir>)``; greedy
    ``generate_seq2seq`` on the loaded model equals the in-memory model's
    token for token, its backbone bitwise the trainer's (T5 launches none
    of the port's kernels). Returns the launches of the loaded model's
    decode (counted from 0: all zero)."""
    import shutil

    from trlx_tpu_torch.models.builder import build_seq2seq_lm
    from trlx_tpu_torch.ops.sampling import GenerationConfig, generate_seq2seq

    dev = torch.device(device)
    tmp = _scratch_dir("slice_hf_t5")
    try:
        trainer.save_pretrained(tmp)
        files = sorted(os.listdir(tmp))
        model, cfg = build_seq2seq_lm(tmp, device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    policy = trainer.model.backbone
    unequal = [k for k, v in policy.state_dict().items()
               if not torch.equal(model.state_dict()[k], v)]
    ids, mask, _, _ = t5_parity_inputs(cfg.vocab_size, rows=rows)
    gen = GenerationConfig(max_new_tokens=max_new, do_sample=False, eos_token_id=1,
                           pad_token_id=cfg.pad_token_id)
    seeds = torch.arange(rows)
    zero_launch_counts()
    with torch.no_grad():
        # -- the main path: greedy decoding on the loaded model --------------
        got = generate_seq2seq(model, ids, mask, seeds, gen).response_tokens.cpu()
        launches = launch_counts()
        # ---------------------------------------------------------------------
        want = generate_seq2seq(policy, ids, mask, seeds, gen).response_tokens.cpu()
    rec = {"phase": "slice_hf_t5", "model": trainer.config.model.model_path, "files": files,
           "backbone_unequal": unequal, "greedy_rows": rows, "max_new_tokens": max_new,
           "greedy_tokens_equal": bool(torch.equal(got, want)), "launches": launches,
           "card": card}
    ok = not unequal and rec["greedy_tokens_equal"] and not any(launches.values())
    emit({**rec, "ok": ok})
    if not ok:
        raise AssertionError(f"slice_hf_t5: {rec}")
    return launches


# ---------------------------------------------------------------------------
# async RL on the card — the actor/learner split
# ---------------------------------------------------------------------------

# the card path: the engine's kernels on the actor threads, the flash
# kernels and the fused loss (with its IW operand) on the learner
ASYNC_KERNELS = SERVE_KERNELS + TRAIN_KERNELS
# (b): the presets' two collections of 128 rollouts, 16 updates each
ASYNC_STEPS = 32
# (c): the process-mode run, cut to one PPO epoch (4 updates a phase) so
# that two collections take 8 updates, each published as a weights file
# (publishing at the phase ends only)
ASYNC_PROCESS = dict(total_steps=8, ppo_epochs=1, sync_every=4)
ASYNC_CHILD_LIMIT_S = 600
# (a): the serial continuous store against the async one, matched by prompt
# and response: the same rows scored in another batch order (bf16)
ASYNC_LOGPROB_ATOL = 5e-2
# (e): the sampler's bf16 decode logprobs against the scoring forward's bf16
# pass over the same tokens and weights; a row or version mismatch moves
# them by whole nats
ASYNC_BEHAVIOR_GAP_TOL = 0.5


def async_card_config(ckpt, spec="builtin:gpt2-small", total_steps=ASYNC_STEPS, sections=None,
                      **async_rl):
    """``serial_config`` with the card path of the async slice: the
    continuous path on the paged engine and its kernels, the fused loss
    with the clipped IW correction, and ``async_rl`` (thread mode unless
    ``async_rl`` says otherwise; ``enabled: False`` is the serial
    continuous path); ``sections`` (a CPU rehearsal's sizes) evolve it
    further."""
    config = serial_config(
        ckpt, spec, total_steps, 10 ** 6, train=dict(continuous_batching=True),
        engine=dict(backend="paged", decode_kernel="pallas", prefill_kernel="pallas"),
        method=dict(loss_kernel="pallas", iw_correction="clip"),
        async_rl={"enabled": True, "mode": "thread", **async_rl})
    return config.evolve(**sections) if sections else config


def store_pairs(trainer):
    """The store's elements sorted by (prompt, response) bytes."""
    return sorted(trainer.store.history,
                  key=lambda e: (e.query_tensor.tobytes(), e.response_tensor.tobytes()))


def store_gaps(got, want):
    """Tokens equal row for row (``store_pairs`` order) and the largest
    logprob and value gaps, or the first row whose tokens differ."""
    if len(got) != len(want):
        return {"rows": [len(got), len(want)], "tokens_equal": False}
    lp = val = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if not (np.array_equal(a.query_tensor, b.query_tensor)
                and np.array_equal(a.response_tensor, b.response_tensor)):
            return {"rows": len(got), "tokens_equal": False, "first_unequal": i}
        lp = max(lp, float(np.abs(a.logprobs - b.logprobs).max()))
        val = max(val, float(np.abs(a.values - b.values).max()))
    return {"rows": len(got), "tokens_equal": True, "logprob_max_abs_gap": lp,
            "value_max_abs_gap": val}


def union_s(intervals):
    """Seconds covered by the union of ``(t0, t1)`` intervals."""
    total, end = 0.0, -math.inf
    for t0, t1 in sorted(intervals):
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total


def span_overlap(events, a, b):
    """Union seconds of the spans named ``a``, of those named ``b``, and of
    their intersection (Chrome-trace microseconds in, seconds out)."""
    def spans(name):
        return [(e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6) for e in events
                if e.get("ph") == "X" and e.get("name") == name]

    sa, sb = spans(a), spans(b)
    both = [(max(x0, y0), min(x1, y1)) for x0, x1 in sa for y0, y1 in sb
            if min(x1, y1) > max(x0, y0)]
    return union_s(sa), union_s(sb), union_s(both)


def ppo_trainer(config, prompts, dev, policy=None, reward=None):
    """A PPO (or GRPO) trainer with its prompt pipeline (``policy``: a
    state dict to start from, the reference re-taken from it; ``reward``:
    default ``profile_train.reward_fn``)."""
    import trlx_tpu_torch.trainer.grpo  # noqa: F401 (registers GRPOTrainer)
    from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu_torch.profile_train import reward_fn
    from trlx_tpu_torch.trainer import get_trainer

    trainer = get_trainer(config.train.trainer)(config=config, reward_fn=reward or reward_fn,
                                                device=dev)
    if policy is not None:
        trainer.model.load_state_dict(policy)
        trainer.ref_params = trainer._ref_snapshot()
    width = config.train.seq_length - config.method.gen_kwargs["max_new_tokens"]
    trainer.add_prompt_pipeline(PromptPipeline(prompts, width, trainer.tokenizer))
    return trainer


def async_actor_child(config_json, device, n_prompts=SERIAL_PROMPTS):
    """The process-mode actor of ``slice_async``'s (c), run in a fresh
    interpreter: ``run_actor`` on the config, the slice's reward and
    prompts, until the learner marks the spool done."""
    import trlx_tpu_torch.trainer.ppo  # noqa: F401 (registers PPOConfig)
    from trlx_tpu_torch.async_rl.actor import run_actor
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.profile_train import reward_fn, slice_prompts

    config = TRLConfig.from_dict(json.loads(config_json))
    n = run_actor(config, reward_fn=reward_fn, prompts=slice_prompts(n_prompts),
                  device=device)
    print("ACTOR_DONE", n, flush=True)


def phase_slice_async(serial, device="cuda", spec="builtin:gpt2-small", card="",
                      sections=None, process=ASYNC_PROCESS, steps=ASYNC_STEPS,
                      n_prompts=SERIAL_PROMPTS):
    """Async RL on the card: the presets' PPO on the card path
    (``async_card_config``) from the policy ``slice_serial`` trained
    (``serial``, kept for ``slice_hf``), with ``async_rl`` in thread mode:

    (a) at ``max_staleness: 0``, one collection, the store against the
    serial continuous path's from the same seeds: tokens equal, the
    logprob gap stated (``ASYNC_LOGPROB_ATOL``);
    (b) ``trlx_tpu_torch.train`` at ``max_staleness: 1`` with 2 actors for
    two collections (``ASYNC_STEPS``): every chunk's staleness <= 1, the
    ``async/*`` stats, the IW clip fraction, ``time/exp`` beside
    ``slice_serial``'s, the actors' busy time against the learner's
    train steps (span overlap), one weights snapshot's copy ms and bytes,
    the peak memory, and the launches: counts set to 0 just before and
    read just after, #1–#3 and #5–#8 must all launch;
    (c) process mode on the file transport: one ``run_actor`` child (a
    fresh interpreter on the same card, the seed's weights on both sides as
    the process-mode actor builds its own trainer) for two collections
    (``ASYNC_PROCESS``), the npz write seconds, and the child's launch counts
    reported in its chunks (#1–#3 must launch there);
    (d) the collective transport in thread mode for one collection, two
    fleet members, its store's tokens equal (a)'s;
    (e) GRPO async for one collection on ``default_grpo_config()`` (the
    bare LM starts from the same policy's backbone): the sampler's
    behaviour logprobs against the scoring forward's.

    ``sections`` (a CPU rehearsal's sizes) evolve every config; ``process``,
    ``steps`` and ``n_prompts`` cut (c), (b) and the prompts. Returns (b)'s
    launches."""
    import shutil

    import trlx_tpu_torch
    from trlx_tpu_torch.async_rl.channel import snapshot_params
    from trlx_tpu_torch.profile_train import reward_fn, slice_prompts

    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    problems, rec = [], {"phase": "slice_async", "card": card}
    policy = {k: v.detach().clone() for k, v in serial.model.state_dict().items()}
    prompts = slice_prompts(n_prompts)
    serial_exp = [st["time/exp"] for _, st in serial.tracker.history if "time/exp" in st]

    # (c)'s actor child starts first: its interpreter and trainer come up
    # while (a) and (b) run, then it waits on the weights manifest
    ckpt_c, root = _scratch_dir("slice_async_c"), _scratch_dir("slice_async_root")
    pconfig = async_card_config(ckpt_c, spec, process["total_steps"], sections, mode="process",
                                root_dir=root, max_staleness=0, actor_timeout_s=300.0,
                                sync_every=process["sync_every"])
    pconfig = pconfig.evolve(method=dict(ppo_epochs=process["ppo_epochs"]))
    log_path = os.path.join(root, "actor.log")
    child_src = ("import sys; sys.path.insert(0, {root!r}); import chip_smoke; "
                 "chip_smoke.async_actor_child({cfg!r}, {dev!r}, {n})").format(
        root=ROOT, cfg=json.dumps(pconfig.to_dict()), dev=str(dev), n=n_prompts)
    with open(log_path, "w") as log:
        child = subprocess.Popen([sys.executable, "-c", child_src], stdout=log,
                                 stderr=subprocess.STDOUT, cwd=ROOT)
    try:
        # -- (a) staleness 0 against the serial continuous path ----------------
        ckpt = _scratch_dir("slice_async_a")
        try:
            cb = ppo_trainer(async_card_config(ckpt, spec, sections=sections, enabled=False),
                             prompts, dev, policy)
            n = cb.config.method.num_rollouts
            cb.make_experience(n)
            want = store_pairs(cb)
            cb_exp = cb.make_experience_stats["time/exp"]
            cb._shutdown_collectors()
            del cb
            asy = ppo_trainer(async_card_config(ckpt, spec, sections=sections, max_staleness=0),
                              prompts, dev, policy)
            try:
                sync()
                zero_launch_counts()
                asy.make_experience(n)
                sync()
                launches_a = launch_counts()
            finally:
                asy._shutdown_collectors()
            stats = asy.make_experience_stats
            got = store_pairs(asy)
            rec["a"] = {"staleness_max": stats["async/staleness_max"],
                        "chunks": stats["async/chunks"], "time_exp_s": stats["time/exp"],
                        "serial_continuous_time_exp_s": cb_exp, "launches": launches_a,
                        **store_gaps(got, want)}
            del asy
            if not rec["a"]["tokens_equal"]:
                problems.append(f"(a) the async store's tokens differ from the serial one's: "
                                f"{rec['a']}")
            elif rec["a"]["logprob_max_abs_gap"] > ASYNC_LOGPROB_ATOL:
                problems.append(f"(a) logprob gap {rec['a']['logprob_max_abs_gap']}")
            if stats["async/staleness_max"] != 0.0:
                problems.append(f"(a) staleness {stats['async/staleness_max']} at bound 0")
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # -- (b) the card path at staleness 1, two actors -----------------------
        ckpt = _scratch_dir("slice_async_b")
        config = async_card_config(ckpt, spec, steps, sections, num_actors=2, max_staleness=1)

        def hook(trainer):
            trainer.model.load_state_dict(policy)
            trainer.ref_params = trainer._ref_snapshot()
            trainer.save = lambda *a, **k: None  # the run's f32 state: no file needed

        try:
            sync()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
                before_gb = torch.cuda.memory_allocated(dev) / 1e9
            zero_launch_counts()
            t0 = time.perf_counter()
            # -- the main path -------------------------------------------------
            trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, config=config,
                                           init_trainer_hook=hook, device=dev)
            sync()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            # ------------------------------------------------------------------
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        hist = trainer.tracker.history
        steps_st = [st for _, st in hist if "gradients/global_norm" in st]
        collections = [st for _, st in hist if "time/exp" in st]
        actor_s, learner_s, overlap_s = span_overlap(trainer.obs.tracer.events(),
                                                     "async/actor_chunk", "train_step")
        snap_bytes = sum(t.numel() * t.element_size() for t in trainer.model.state_dict().values())
        copies = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            snap = snapshot_params(trainer.model)
            sync()
            copies.append(1e3 * (time.perf_counter() - t0))
            del snap
        rec["b"] = {"settings": {"num_actors": 2, "max_staleness": 1, "steps": steps,
                                 "num_rollouts": config.method.num_rollouts,
                                 "chunk_size": config.method.chunk_size},
                    "optimizer_steps": len(steps_st), "wall_s": wall,
                    "collections": [{k: v for k, v in c.items() if k.startswith("async/")}
                                    for c in collections],
                    "staleness_max": max(c["async/staleness_max"] for c in collections),
                    "iw_rho_clipfrac": [st.get("iw/rho_clipfrac") for st in steps_st],
                    "iw_rho_mean": [st.get("iw/rho_mean") for st in steps_st],
                    "time_exp_s": [c["time/exp"] for c in collections],
                    "serial_time_exp_s": serial_exp,
                    "train_step_ms_median": statistics.median(1e3 * st["time/step"]
                                                              for st in steps_st),
                    "actor_busy_s": actor_s, "learner_train_s": learner_s, "overlap_s": overlap_s,
                    "publish_copy_ms": copies, "snapshot_gb": snap_bytes / 1e9,
                    "weight_syncs": trainer.metrics.counter("async/weight_syncs"),
                    "launches": launches}
        if dev.type == "cuda":
            rec["b"]["memory_gb"] = {"before": before_gb,
                                     "peak": torch.cuda.max_memory_allocated(dev) / 1e9}
        losses = [st["losses/total_loss"] for st in steps_st]
        if len(steps_st) != steps or len(collections) != 2 or not all(map(math.isfinite, losses)):
            problems.append(f"(b) {len(steps_st)} steps, {len(collections)} collections, {losses}")
        if rec["b"]["staleness_max"] > 1.0:
            problems.append(f"(b) staleness {rec['b']['staleness_max']} above the bound 1")
        if not all(e.behavior_logprobs is not None for e in trainer.store.history):
            problems.append("(b) behaviour logprobs missing from the store")
        if any(x is None for x in rec["b"]["iw_rho_clipfrac"]):
            problems.append("(b) a step without the IW stats")
        if dev.type == "cuda" and min(launches[k] for k in ASYNC_KERNELS) <= 0:
            problems.append(f"(b) a kernel of the card path never launched: {launches}")
        trainer._shutdown_collectors()
        del trainer
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # -- (c) process mode: the run_actor child started above -------------
        writes = []

        def phook(t):
            t.save = lambda *a, **k: None
            channel = t._ensure_async_collector().channel
            publish = channel.publish

            def timed(params, version, force=False):
                t0 = time.perf_counter()
                publish(params, version, force=force)
                writes.append(time.perf_counter() - t0)

            channel.publish = timed

        learner = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, config=pconfig,
                                       init_trainer_hook=phook, device=dev)
        child_rc = child.wait(ASYNC_CHILD_LIMIT_S)
        with open(log_path) as f:
            child_log = f.read()
        pcols = [st for _, st in learner.tracker.history if "time/exp" in st]
        child_launches = [{k.split("/")[-1]: v for k, v in c.items()
                           if k.startswith("async/actor_launches/")} for c in pcols]
        weights_gb = sum(t.numel() * 4 for t in learner.model.state_dict().values()) / 1e9
        rec["c"] = {"settings": process, "child_rc": child_rc,
                    "child_chunks": child_log.split("ACTOR_DONE")[-1].split()[0]
                    if "ACTOR_DONE" in child_log else None,
                    "collections": len(pcols),
                    "staleness_max": [c.get("async/staleness_max") for c in pcols],
                    "time_exp_s": [c["time/exp"] for c in pcols],
                    "child_launches": child_launches,
                    "npz_writes": len([w for w in writes if w > 1e-3]),
                    "npz_write_s": [w for w in writes if w > 1e-3], "npz_gb": weights_gb}
        learner._shutdown_collectors()
        del learner
        if child_rc != 0 or "ACTOR_DONE" not in child_log:
            problems.append(f"(c) the actor child failed (rc {child_rc}): {child_log[-2000:]}")
        if len(pcols) != 2 or any(c.get("async/staleness_max") != 0.0 for c in pcols):
            problems.append(f"(c) collections {rec['c']}")
        if dev.type == "cuda" and not all(min(c.get(k, 0) for k in SERVE_KERNELS) > 0
                                          for c in child_launches):
            problems.append(f"(c) #1-#3 did not launch in the actor child: {child_launches}")
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # -- (d) the collective transport, thread mode, one collection ---------
        ckpt = _scratch_dir("slice_async_d")
        try:
            fleet = ppo_trainer(async_card_config(ckpt, spec, sections=sections, max_staleness=0,
                                                  num_actors=2, transport="collective"),
                                prompts, dev, policy)
            try:
                sync()
                zero_launch_counts()
                fleet.make_experience(n)
                sync()
                launches_d = launch_counts()
            finally:
                fleet._shutdown_collectors()
            stats = fleet.make_experience_stats
            rec["d"] = {"fleet_size": stats.get("async/fleet_size"),
                        "publish_gb": stats.get("async/publish_bytes", 0.0) / 1e9,
                        "time_exp_s": stats["time/exp"],
                        "staleness_max": stats["async/staleness_max"],
                        "launches": launches_d, **store_gaps(store_pairs(fleet), want)}
            del fleet
            if not rec["d"]["tokens_equal"] or rec["d"]["fleet_size"] != 2.0:
                problems.append(f"(d) {rec['d']}")
            if dev.type == "cuda" and min(launches_d[k] for k in SERVE_KERNELS) <= 0:
                problems.append(f"(d) #1-#3 never launched: {launches_d}")
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # -- (e) GRPO async, one collection ------------------------------------
        ckpt = _scratch_dir("slice_async_e")
        try:
            gconfig = grpo_config(ckpt, spec, async_rl=dict(enabled=True, mode="thread",
                                                            max_staleness=0),
                                  method=dict(iw_correction="clip"))
            if sections:
                gconfig = gconfig.evolve(**{k: v for k, v in sections.items() if k != "method"})
            backbone = {k[len("backbone."):]: v for k, v in policy.items()
                        if k.startswith("backbone.")}
            grpo = ppo_trainer(gconfig, prompts, dev, backbone, reward=grpo_reward)
            try:
                sync()
                zero_launch_counts()
                grpo.make_experience(gconfig.method.num_rollouts)
                sync()
                launches_e = launch_counts()
            finally:
                grpo._shutdown_collectors()
            hist_e = grpo.store.history
            gap = max(float(np.abs(e.behavior_logprobs - e.logprobs).max()) for e in hist_e)
            G = gconfig.method.group_size
            adv = np.asarray([e.advantage for e in hist_e])
            rec["e"] = {"rows": len(hist_e), "chunks": grpo.make_experience_stats["async/chunks"],
                        "behavior_vs_scoring_logprob_gap": gap,
                        "group_advantage_mean_max": float(np.abs(
                            adv[: len(adv) // G * G].reshape(-1, G).mean(axis=1)).max()),
                        "time_exp_s": grpo.make_experience_stats["time/exp"],
                        "launches": launches_e}
            del grpo
            if len(hist_e) != gconfig.method.num_rollouts or gap > ASYNC_BEHAVIOR_GAP_TOL:
                problems.append(f"(e) {rec['e']}")
            if dev.type == "cuda" and launches_e["flash_fwd"] <= 0:
                problems.append(f"(e) #5 never launched: {launches_e}")
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(60)
        shutil.rmtree(ckpt_c, ignore_errors=True)
        shutil.rmtree(root, ignore_errors=True)
    zero_launch_counts()
    emit({**rec, "ok": not problems})
    if problems:
        raise AssertionError(f"slice_async: {problems}")
    return launches


# the slice's PPO over two processes on the one card: the training slice's
# settings (continuous paged rollouts, the fused loss) at full width in
# f32, cut to PARALLEL_RL_LAYERS layers; preempted by sigterm_one_proc at
# PARALLEL_RL_PREEMPT, then resumed in one process to PARALLEL_RL_STEPS
PARALLEL_RL_KERNELS = SERVE_KERNELS + TRAIN_KERNELS
PARALLEL_RL_LAYERS = 6
# the axes run on the card: FSDP2 over gloo needs the four collectives of
# GLOO_COLLECTIVES on CUDA tensors (PERF.md records the probe)
PARALLEL_RL_AXES = ({"data": 2, "fsdp": 1}, {"data": 1, "fsdp": 2})
PARALLEL_RL_PREEMPT, PARALLEL_RL_STEPS = 3, 5
PARALLEL_RL_RTOL = 1e-5
PARALLEL_RL_LIMIT_S = 420
GLOO_COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
                    "broadcast")


def gloo_cuda_probe(dev):
    """Each of FSDP2's collectives once on ``dev`` tensors over the default
    (gloo) group: ``{name: "ok" | the error's own words}``, a wrong result
    counted as an error. Recorded, never used to pick a path."""
    import torch.distributed as dist

    r, n = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), float(r + 1), device=dev)
    want_sum = float(n * (n + 1) / 2)

    def gather():
        out = torch.empty(4 * n, device=dev)
        dist.all_gather_into_tensor(out, x)
        return bool((out.view(n, 4)[:, 0].cpu() == torch.arange(1, n + 1).float()).all())

    def scatter():
        out = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(out, torch.cat([x] * n))
        return bool((out.cpu() == want_sum).all())

    def reduce():
        y = x.clone()
        dist.all_reduce(y)
        return bool((y.cpu() == want_sum).all())

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=0)
        return bool((y.cpu() == 1.0).all())

    out = {}
    for name, fn in zip(GLOO_COLLECTIVES, (gather, scatter, reduce, broadcast)):
        try:
            out[name] = "ok" if fn() else "wrong result"
        except Exception as e:  # the probe's record: the error's own words
            out[name] = f"{type(e).__name__}: {e}"[:300]
    return out


def _state_digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        flat = tensors[k].detach().cpu().reshape(-1).contiguous()
        h.update(flat.view(torch.uint8).numpy())
    return h.hexdigest()


def _optimizer_digest(optim_sd):
    return _state_digest({f"{i}/{k}": torch.as_tensor(v) for i, st in optim_sd["state"].items()
                          for k, v in st.items()})


def parallel_rl_config(ckpt, parallel, spec="builtin:gpt2-small", layers=PARALLEL_RL_LAYERS,
                       total_steps=PARALLEL_RL_STEPS, fault_plan=None, resume=False):
    """``profile_train.train_config`` (the training slice) in f32 at
    ``layers`` layers over ``parallel``; ``fault_plan`` and a resume from
    ``ckpt`` on top."""
    from trlx_tpu_torch.profile_train import train_config

    config = train_config(ckpt, spec, total_steps)
    return config.evolve(
        model=dict(model_extra_kwargs=dict(num_layers=layers)),
        parallel=dict(compute_dtype="float32", **parallel),
        resilience=dict(fault_plan=fault_plan),
        train=dict(resume_from_checkpoint=resume))


def parallel_rl_worker(args_path):
    """One rank of ``slice_parallel_rl`` (its own process, started by
    :func:`parallel_rl_ranks`): a gloo group of two made here, on the
    card, before ``train()`` (``initialize_runtime`` leaves it as it is);
    the probe; then for each of the phase's axes the preempted world-2 PPO
    run with every step's full-weight digest, the launch counts of this
    rank (zeroed just before ``train()``), the store, and at the
    preemption the full state's digests, the KL controller and the running
    moments. Writes ``<out>.rank<r>.json`` (a record per axis); rank 0
    also each axis's first store and batch (``<ckpt>.store.pt``) and step
    1's stats."""
    import faulthandler

    import torch.distributed as dist

    import trlx_tpu_torch
    from trlx_tpu_torch.parallel.sharding import full_model_state
    from trlx_tpu_torch.profile_train import reward_fn, slice_prompts
    from trlx_tpu_torch.resilience import TrainingPreempted
    from trlx_tpu_torch.utils.checkpoint import gather_full_state

    faulthandler.enable()  # a crash in a collective still leaves its stack in the log
    with open(args_path) as f:
        args = json.load(f)
    rank, dev = int(args["rank"]), torch.device(args["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args['port']}",
                            world_size=2, rank=rank)
    t0 = time.perf_counter()
    probe = gloo_cuda_probe(dev)
    records = []
    for parallel, ckpt in zip(args["axes"], args["ckpts"]):
        config = parallel_rl_config(ckpt, parallel, spec=args["spec"], layers=args["layers"],
                                    fault_plan=f"sigterm_one_proc@step:{PARALLEL_RL_PREEMPT}")
        out, digests, seen = {"rank": rank, "probe": probe}, [], {}
        # seconds since the group formed: the trainer built, each step done
        clock = out["clock_s"] = {"start": time.perf_counter() - t0, "steps": []}

        def hook(trainer):
            clock["built"] = time.perf_counter() - t0
            seen["trainer"] = trainer
            step = trainer.train_step

            def train_step(batch):
                stats = step(batch)
                if not digests and rank == 0:  # the store and batch of step 1
                    items = batch._asdict() if hasattr(batch, "_asdict") else batch
                    torch.save({"store": trainer._emergency_payload()["store"],
                                "batch": {k: torch.as_tensor(np.asarray(v))
                                          for k, v in items.items() if hasattr(v, "shape")}},
                               ckpt + ".store.pt")
                if not digests:
                    out["step1"] = {k: float(stats[k]) for k in ("losses/total_loss",
                                                                 "gradients/global_norm")}
                digests.append(_state_digest(full_model_state(trainer.model)))
                clock["steps"].append(time.perf_counter() - t0)
                return stats

            trainer.train_step = train_step

        zero_launch_counts()
        try:
            trlx_tpu_torch.train(reward_fn=reward_fn, prompts=slice_prompts(), config=config,
                                 init_trainer_hook=hook, device=dev)
            out["preempted"] = None
        except TrainingPreempted as e:
            out["preempted"] = e.checkpoint_dir
        out["launches"] = launch_counts()
        clock["preempted"] = time.perf_counter() - t0
        trainer = seen.pop("trainer")
        model_sd, optim_sd = gather_full_state(trainer.model, trainer.optimizer)
        if rank == 0:
            out["state"] = {"model": _state_digest(model_sd),
                            "optimizer": _optimizer_digest(optim_sd)}
        rm = trainer.running_moments
        out.update(digests=digests, iter_count=trainer.iter_count,
                   kl_ctl=float(trainer.kl_ctl.value), mean_kl=float(trainer.mean_kl),
                   running_moments=[float(rm.mean), float(rm.var), float(rm.count)],
                   store=_state_digest({str(i): torch.as_tensor(np.concatenate(
                       [np.asarray(v, np.float64).ravel() for v in vars(e).values()
                        if v is not None])) for i, e in enumerate(trainer.store.history)}))
        records.append(out)
        del trainer, model_sd, optim_sd
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    with open(f"{args['out']}.rank{rank}.json", "w") as f:
        json.dump(records, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def start_rank_groups(worker, groups):
    """Start every rank of ``groups`` at once, each group a gloo world of
    its own on a free port: for each ``(sub, ranks)`` one process
    (``sys.executable``) per entry of ``ranks`` running
    ``chip_smoke.<worker>`` on that rank's JSON arguments (``rank`` and
    ``port`` added), logged to ``sub/rank<r>.log``. Returns ``[(sub,
    procs, logs)]``; kills what it started if one cannot start."""
    import socket

    socks = [socket.socket() for _ in groups]  # bound together: distinct ports
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    started = []
    try:
        for (sub, ranks), port in zip(groups, ports):
            procs, logs = [], []
            started.append((sub, procs, logs))
            for rank, args in enumerate(ranks):
                path = os.path.join(sub, f"args{rank}.json")
                with open(path, "w") as f:
                    json.dump(dict(args, rank=rank, port=port), f)
                logs.append(open(os.path.join(sub, f"rank{rank}.log"), "w"))
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", "import sys, chip_smoke; "
                     f"sys.exit(chip_smoke.{worker}({path!r}))"],
                    stdout=logs[-1], stderr=subprocess.STDOUT, cwd=ROOT))
    except BaseException:
        kill_ranks(started)
        raise
    return started


def wait_rank_group(group, deadline, phase):
    """Wait for one group of :func:`start_rank_groups` until ``deadline``
    (``time.monotonic()``); raise with the log's tail of a rank that
    exited with another code than 0."""
    sub, procs, logs = group
    for p in procs:
        p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            logs[rank].flush()
            with open(os.path.join(sub, f"rank{rank}.log")) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"{phase} rank {rank} exited {p.returncode}: {tail}")


def kill_ranks(groups):
    """Kill every rank of ``groups`` still running and close its log."""
    for _, procs, logs in groups:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
        for f in logs:
            f.close()


def start_parallel_rl_ranks(axes, dev, spec, layers, root):
    """The ranks of :func:`parallel_rl_worker`: a pair for each axis, in
    ``root/axis<i>`` with its checkpoint in ``ckpt`` there, every pair
    started at once (:func:`start_rank_groups`)."""
    groups = []
    for i, parallel in enumerate(axes):
        sub = os.path.join(root, f"axis{i}")
        os.makedirs(sub)
        args = {"device": str(dev), "axes": [parallel], "ckpts": [os.path.join(sub, "ckpt")],
                "spec": spec, "layers": layers, "out": os.path.join(sub, "out")}
        groups.append((sub, [args, args]))
    return start_rank_groups("parallel_rl_worker", groups)


def parallel_rl_ranks(axes, dev, spec, layers, root, pairs=None):
    """The pairs of :func:`start_parallel_rl_ranks` (started here unless
    given). Yields per axis, in order, once its pair has exited, the two
    ranks' records and the checkpoint directory; every rank still running
    at ``PARALLEL_RL_LIMIT_S``, or when the caller closes the generator, is
    killed."""
    try:
        if pairs is None:
            pairs = start_parallel_rl_ranks(axes, dev, spec, layers, root)
        deadline = time.monotonic() + PARALLEL_RL_LIMIT_S
        for pair in pairs:
            sub = pair[0]
            wait_rank_group(pair, deadline, "slice_parallel_rl")
            ranks = []
            for rank in range(2):
                with open(os.path.join(sub, f"out.rank{rank}.json")) as f:
                    ranks.append(json.load(f)[0])
            yield ranks, os.path.join(sub, "ckpt")
    finally:
        kill_ranks(pairs or [])


def parallel_rl_resume(ckpt, store_path, dev, spec, layers):
    """In one process on the card: first, from the same seeded weights, a
    step over the world-2 run's first store and batch (its loss and
    gradient norm); then the world-2 emergency checkpoint resumed over it
    (the load replaces the weights, the optimizer, the step and the store)
    and the run finished. Returns the step-1 stats, the restored state's
    digests (taken right after the load), the KL controller, the running
    moments, and the elastic restore count with the remaining steps'
    losses."""
    import trlx_tpu_torch
    from trlx_tpu_torch.profile_train import reward_fn, slice_prompts

    config = parallel_rl_config(ckpt, {"data": -1, "fsdp": 1}, spec=spec, layers=layers,
                                resume=True)
    step1, restored = {}, {}

    def hook(trainer):
        saved = torch.load(store_path, weights_only=True)
        trainer._restore_emergency_payload({"store": saved["store"]})
        stats = trainer.train_step({k: v.numpy() for k, v in saved["batch"].items()})
        step1.update({k: float(stats[k]) for k in ("losses/total_loss",
                                                   "gradients/global_norm")})
        load = trainer.load

        def traced(*a, **kw):
            load(*a, **kw)
            rm = trainer.running_moments
            restored.update(
                model=_state_digest(trainer.model.state_dict()),
                optimizer=_optimizer_digest(trainer.optimizer.state_dict()),
                kl_ctl=float(trainer.kl_ctl.value), mean_kl=float(trainer.mean_kl),
                running_moments=[float(rm.mean), float(rm.var), float(rm.count)],
                iter_count=trainer.iter_count)

        trainer.load = traced

    trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=slice_prompts(), config=config,
                                   init_trainer_hook=hook, device=dev)
    steps = [(s, st) for s, st in trainer.tracker.history if "gradients/global_norm" in st]
    return step1, restored, {
        "elastic_restores": trainer.metrics.counter("resilience/elastic_restores"),
        "reshard_s": trainer.metrics.snapshot().get("resilience/reshard_s"),
        "steps": [s for s, _ in steps],
        "losses": [float(st["losses/total_loss"]) for _, st in steps]}


def phase_slice_parallel_rl(device="cuda", spec="builtin:gpt2-small", layers=PARALLEL_RL_LAYERS,
                            card="", axes=PARALLEL_RL_AXES, phase="slice_parallel_rl",
                            pairs=None, root=None):
    """PPO over two processes on one card (NCCL takes one rank per card, so
    the two ranks make a gloo group of their own). For each of ``axes``
    (``data`` 2, ``fsdp`` 2), two ranks run the training slice's PPO
    (continuous paged rollouts, the fused loss; f32; ``layers`` layers)
    with ``sigterm_one_proc@step:PARALLEL_RL_PREEMPT``, every axis's pair
    at once, and each axis is checked once its pair exits
    (:func:`parallel_rl_check`); the probe of
    gloo's collectives on CUDA tensors runs first in each. Checks: every
    collective the axis needs ran (FSDP2's four for ``fsdp``; the ``data``
    axis's gradient all-reduce and the row gathers); each rank launched
    #1–#3 and #5–#8 (counts zeroed just before ``train()``, read after);
    the ranks' full weights are bitwise equal after every step and their
    stores equal; step 1's loss and gradient norm are within
    ``PARALLEL_RL_RTOL`` of a world-1 step on the card over the same store
    and batch; both ranks stopped at the preemption step with one committed
    checkpoint whose manifest records two processes; resumed in one
    process, the reshard path ran once, the restored weights, AdamW
    moments, KL controller and running moments equal the ranks' state
    bitwise, and the remaining steps' losses are finite. ``pairs`` (of
    :func:`start_parallel_rl_ranks`, in ``root``) are ranks started
    earlier. Returns the launches of rank 0 summed over the axes (per
    rank)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:  # both ranks on the one card
        dev = torch.device("cuda", torch.cuda.current_device())
    launches = Counter({k: 0 for k in REPLACES})
    root = root or _scratch_dir(phase.removeprefix("slice_"))
    t0 = time.perf_counter()
    with contextlib.closing(parallel_rl_ranks(axes, dev, spec, layers, root, pairs)) as runs:
        for parallel, (ranks, ckpt) in zip(axes, runs):
            # seconds from the start of every pair to this axis's exit
            world2_s = time.perf_counter() - t0
            parallel_rl_check(parallel, ranks, ckpt, dev, spec, layers, card, world2_s,
                              launches, phase)
    return dict(launches)


def parallel_rl_check(parallel, ranks, ckpt, dev, spec, layers, card, world2_s, launches,
                      phase="slice_parallel_rl"):
    """One axis of :func:`phase_slice_parallel_rl`: the checks of its two
    ranks' records and the one-process resume of its checkpoint; rank 0's
    launches added to ``launches``."""
    from trlx_tpu_torch.resilience import read_manifest
    from trlx_tpu_torch.utils.checkpoint import is_committed

    name = next((f"{a}{parallel[a]}" for a in ("model", "fsdp") if parallel.get(a, 1) > 1),
                "data2")
    problems = []
    need = GLOO_COLLECTIVES if parallel["fsdp"] > 1 else ("all_gather_into_tensor",
                                                          "all_reduce")
    for r in ranks:
        bad = {k: v for k, v in r["probe"].items() if k in need and v != "ok"}
        if bad:
            problems.append(f"rank {r['rank']}: collectives failed {bad}")
        if dev.type == "cuda":
            idle = [k for k in PARALLEL_RL_KERNELS if r["launches"][k] <= 0]
            if idle:
                problems.append(f"rank {r['rank']}: kernels never launched {idle}")
    if ranks[0]["digests"] != ranks[1]["digests"]:
        problems.append("the ranks' full weights differ after a step")
    if len(ranks[0]["digests"]) != PARALLEL_RL_PREEMPT:
        problems.append(f"{len(ranks[0]['digests'])} steps before the preemption")
    if ranks[0]["store"] != ranks[1]["store"]:
        problems.append("the ranks' stores differ")
    for key in ("kl_ctl", "mean_kl", "running_moments", "iter_count"):
        if ranks[0][key] != ranks[1][key]:
            problems.append(f"the ranks' {key} differ")
    if [r["preempted"] for r in ranks] != [ranks[0]["preempted"]] * 2 or not ranks[0][
            "preempted"] or ranks[0]["iter_count"] != PARALLEL_RL_PREEMPT:
        problems.append(f"preemption: {[(r['preempted'], r['iter_count']) for r in ranks]}")
    committed = sorted(p for p in os.listdir(ckpt) if p.startswith("checkpoint_")
                       and is_committed(os.path.join(ckpt, p)))
    manifest = read_manifest(os.path.join(ckpt, committed[0])) if committed else None
    if len(committed) != 1 or (manifest or {}).get("mesh", {}).get("process_count") != 2:
        problems.append(f"committed checkpoints {committed}, manifest "
                        f"{(manifest or {}).get('mesh')}")
    t1 = time.perf_counter()
    world1, restored, resumed = parallel_rl_resume(ckpt, ckpt + ".store.pt", dev, spec,
                                                   layers)
    world1_s = time.perf_counter() - t1
    gaps = {k: abs(ranks[0]["step1"][k] - v) / max(abs(v), 1e-12) for k, v in world1.items()}
    if max(gaps.values()) > PARALLEL_RL_RTOL:
        problems.append(f"step 1 against world 1: {gaps}")
    want = dict(ranks[0]["state"], kl_ctl=ranks[0]["kl_ctl"], mean_kl=ranks[0]["mean_kl"],
                running_moments=ranks[0]["running_moments"],
                iter_count=PARALLEL_RL_PREEMPT)
    diff = [k for k, v in want.items() if restored.get(k) != v]
    if diff:
        problems.append(f"the restored state differs from the ranks': {diff}")
    if resumed["elastic_restores"] != 1.0:
        problems.append(f"elastic restores {resumed['elastic_restores']}")
    if resumed["steps"] != list(range(PARALLEL_RL_PREEMPT + 1, PARALLEL_RL_STEPS + 1)) or \
            not all(math.isfinite(x) for x in resumed["losses"]):
        problems.append(f"resumed steps {resumed['steps']} losses {resumed['losses']}")
    launches.update(ranks[0]["launches"])
    emit({"phase": phase, "axes": parallel, "layers": layers, "model": spec,
          "dtype": "float32", "probe": [r["probe"] for r in ranks],
          "launches_per_rank": [r["launches"] for r in ranks],
          "step1": ranks[0]["step1"], "world1_step1": world1, "step1_rel_gap": gaps,
          "weight_digests_equal": ranks[0]["digests"] == ranks[1]["digests"],
          "preempted_at": ranks[0]["iter_count"], "committed": committed,
          "manifest_mesh": (manifest or {}).get("mesh"), "resumed": resumed,
          "restored_equal": not diff, "world2_s": world2_s, "world1_s": world1_s,
          "rank0_clock_s": ranks[0]["clock_s"],
          "card": card, "ok": not problems})
    if problems:
        raise AssertionError(f"{phase} {name}: {problems}")


# ---------------------------------------------------------------------------
# slice_tensor_parallel: tensor parallelism over the mesh's ``model`` axis
# ---------------------------------------------------------------------------

# (a) examples/ilql_sentiments_20b.py's settings (ILQL, data 1, fsdp -1,
# model 4, bf16, remat full, 64 new tokens at top-k 20 and beta 2) at
# GPT-NeoX-20B's width, four ranks sharing the one card through gloo. Cut:
# the depth to 2 of 44 layers, the batch from 8 to 2 and the sequence from
# 1024 to 256 (the batch first, then the sequence): each rank holds a
# quarter of 2 blocks, of the embedding and LM head and of four
# vocab-wide Q heads, with f32 weights, gradients and Adam moments
TP_SPEC, TP_RANKS, TP_LAYERS = "builtin:gptneox-20b", 4, 2
TP_BATCH, TP_SEQ, TP_STEPS, TP_NEW_TOKENS = 2, 256, 3, 64
TP_SAMPLES, TP_EVAL_PROMPTS = 32, 4
TP_CUTS = {"num_layers": [44, TP_LAYERS], "batch_size": [8, TP_BATCH],
           "seq_length": [1024, TP_SEQ], "total_steps": [2000, TP_STEPS],
           "samples": ["512 IMDB reviews (not in the repository)",
                       f"{TP_SAMPLES} seeded byte strings"],
           "eval_prompts": [64, TP_EVAL_PROMPTS],
           "evaluations": ["before the steps, every 200 and after", "after the steps"]}
# the kernels every rank of (a) launches: the train and score forwards and
# the backward on its heads, the eval engine on its heads and the gathered
# logits
TP_KERNELS = ("flash_fwd", "flash_bwd", "paged_prefill", "paged_decode", "fused_sample")
# step 1's bf16 losses and gradient norm against one process on the same
# batch (its forward and backward: a backward-only fault, such as a
# missing gradient sum over ``model``, moves the norm): the ranks sum
# partial products of the row-parallel projections in f32 and round to
# bf16 after the sum, where one process rounds each GEMM's output once
TP_LOSS_RTOL, TP_LOSS_ATOL = 2e-2, 1e-3
TP_LIMIT_S = 600
# (b) PPO at model 2 on slice_parallel_rl's machinery (the fused loss
# kernels; GPT-2 small's width at PARITY_LAYERS, f32; its vocabulary of
# 50257 replicates the head)
TP_PPO_AXES = ({"data": 1, "fsdp": 1, "model": 2},)


def tp_ilql_config(ckpt, parallel, spec=TP_SPEC, layers=TP_LAYERS):
    """``examples/ilql_sentiments_20b.py``'s config with :data:`TP_CUTS`,
    over ``parallel`` (no checkpoints, one evaluation at each end)."""
    from trlx_tpu_torch.data.default_configs import default_ilql_config

    return default_ilql_config().evolve(
        train=dict(seq_length=TP_SEQ, batch_size=TP_BATCH, total_steps=TP_STEPS,
                   eval_interval=10 ** 6, checkpoint_interval=10 ** 6, save_best=False,
                   checkpoint_dir=ckpt, tracker=None),
        model=dict(model_path=spec, model_extra_kwargs=dict(num_layers=layers)),
        tokenizer=dict(tokenizer_path="builtin:bytes"),
        parallel=dict(compute_dtype="bfloat16", remat="full", **parallel),
        method=dict(gen_kwargs=dict(max_new_tokens=TP_NEW_TOKENS, top_k=20, beta=2.0)))


def tp_data(seed=2022):
    """Seeded stand-ins for the example's IMDB texts, rewards and prompts."""
    rs = np.random.RandomState(seed)
    texts = ["".join(chr(c) for c in rs.randint(97, 123, size=int(rs.randint(40, 120))))
             for _ in range(TP_SAMPLES)]
    prompts = ["".join(chr(c) for c in rs.randint(97, 123, size=12))
               for _ in range(TP_EVAL_PROMPTS)]
    return texts, [float(x) for x in rs.rand(TP_SAMPLES)], prompts


def shard_digests(model):
    """``(replicated, whole)`` BLAKE2 digests of a tensor-parallel model:
    of the parameters every ``model`` rank holds whole, and of the whole
    weights gathered over ``model``, as the digest of every rank's digest
    of its shares, gathered in rank order (one ``all_gather_object``, not
    the weights: two ranks' gathered weights are equal when every share
    is)."""
    import hashlib

    import torch.distributed as dist

    dims = model.tp_dims
    rep, mine = hashlib.blake2b(), hashlib.blake2b()
    for k, v in model.state_dict().items():
        local = v.detach().cpu().contiguous().view(torch.uint8).numpy()
        (mine if k in dims else rep).update(k.encode() + local.tobytes())
    shares = [None] * model.tensor_parallel.size
    dist.all_gather_object(shares, mine.hexdigest(), group=model.tensor_parallel.group)
    return rep.hexdigest(), hashlib.blake2b("".join(shares + [rep.hexdigest()]).encode()
                                            ).hexdigest()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tensor_parallel_worker(args_path):
    """One of the :data:`TP_RANKS` ranks of ``slice_tensor_parallel`` (a):
    a gloo group made here on the card, then ``train(samples=...,
    rewards=...)`` on :func:`tp_ilql_config` at ``model`` 4, every kernel
    counter set to 0 just before, its evaluation before the steps skipped
    (the one after them runs); records every step's losses and seconds,
    the peak memory, the launches and the :func:`shard_digests`. Rank 0
    also saves step 1's batch (``<out>.batch.pt``). The checkpoint saves
    are no-ops (the f32 state of the cut model is tens of GB)."""
    import faulthandler

    import torch.distributed as dist

    import trlx_tpu_torch

    entry = time.perf_counter()
    faulthandler.enable()
    with open(args_path) as f:
        args = json.load(f)
    rank, dev = int(args["rank"]), torch.device(args["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    else:  # a rehearsal on the CPU
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args['port']}",
                            world_size=TP_RANKS, rank=rank)
    t0 = time.perf_counter()
    config = tp_ilql_config(args["ckpt"], dict(data=1, fsdp=-1, model=TP_RANKS, sequence=1),
                            spec=args["spec"], layers=args["layers"])
    texts, rewards, prompts = tp_data()
    out = {"rank": rank, "steps": [], "step_s": [], "group_s": t0 - entry}
    seen = {}

    def hook(trainer):
        out["built_s"] = time.perf_counter() - t0
        seen["trainer"] = trainer
        trainer.save = lambda *a, **kw: None
        evaluate = trainer.evaluate

        def after_the_steps():
            # the steps first, then the one evaluation
            return evaluate() if out["steps"] else {}

        trainer.evaluate = after_the_steps
        step = trainer.train_step

        def train_step(batch):
            if not out["steps"] and rank == 0:
                items = batch._asdict() if hasattr(batch, "_asdict") else batch
                torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in items.items()
                            if hasattr(v, "shape")}, args["out"] + ".batch.pt")
            _sync(dev)
            t = time.perf_counter()
            stats = step(batch)
            _sync(dev)
            out["step_s"].append(time.perf_counter() - t)
            out["steps"].append({k: float(v) for k, v in stats.items()
                                 if k.startswith("losses/") or k == "gradients/global_norm"})
            return stats

        trainer.train_step = train_step

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    zero_launch_counts()
    trainer = trlx_tpu_torch.train(samples=texts, rewards=rewards, eval_prompts=prompts,
                                   config=config, device=dev, init_trainer_hook=hook)
    _sync(dev)
    out["launches"] = launch_counts()
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else None
    out["train_s"] = time.perf_counter() - t0
    evals = [st for _, st in trainer.tracker.history if any(k.startswith("eval/")
                                                             for k in st)]
    out["eval_keys"] = sorted({k for st in evals for k in st if k.startswith("eval/")})[:12]
    out["tp"] = {"size": trainer.model.tensor_parallel.size,
                 "split": len(trainer.model.tp_dims),
                 "kv_heads_per_rank": trainer.tcfg.cache_kv_heads,
                 "vocab_range": list(trainer.model.backbone.vocab_range or ())}
    t1 = time.perf_counter()
    out["replicated"], out["whole"] = shard_digests(trainer.model)
    out["digest_s"] = time.perf_counter() - t1
    with open(f"{args['out']}.rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def tensor_parallel_ranks(dev, spec, layers, root):
    """The :data:`TP_RANKS` processes of :func:`tensor_parallel_worker`,
    started at once (:func:`start_rank_groups`); their records once all
    have exited (every rank still running at :data:`TP_LIMIT_S` is
    killed)."""
    out = os.path.join(root, "out")
    args = {"device": str(dev), "spec": spec, "layers": layers,
            "ckpt": os.path.join(root, "ckpt"), "out": out}
    groups = start_rank_groups("tensor_parallel_worker", [(root, [args] * TP_RANKS)])
    try:
        wait_rank_group(groups[0], time.monotonic() + TP_LIMIT_S, "slice_tensor_parallel")
        ranks = []
        for rank in range(TP_RANKS):
            with open(f"{out}.rank{rank}.json") as f:
                ranks.append(json.load(f))
        return ranks, out + ".batch.pt"
    finally:
        kill_ranks(groups)


class _Stop(Exception):
    pass


def tensor_parallel_reference(batch_path, dev, spec, layers, root):
    """Step 1's losses and gradient norm of one process on the card (no
    mesh) over the four-rank run's first batch, from the same seeded
    weights: the loss forward and backward of the cut model, no optimizer
    step (and so no optimizer state)."""
    import trlx_tpu_torch

    config = tp_ilql_config(os.path.join(root, "ckpt1"), dict(data=1, fsdp=1, model=1),
                            spec=spec, layers=layers)
    texts, rewards, prompts = tp_data()
    got = {}

    def hook(trainer):
        batch = {k: v.numpy() for k, v in torch.load(batch_path, weights_only=True).items()}
        stats, _ = trainer._accumulate(trainer._device_batch(batch))
        got.update({k: float(v) for k, v in stats.items() if k.startswith("losses/")})
        got["gradients/global_norm"] = float(torch.nn.utils.get_total_norm(
            [p.grad for p in trainer.model.parameters() if p.grad is not None]))
        raise _Stop

    try:
        trlx_tpu_torch.train(samples=texts, rewards=rewards, eval_prompts=prompts,
                             config=config, device=dev, init_trainer_hook=hook)
    except _Stop:
        pass
    return got


def tensor_parallel_part_a(dev, spec, layers, root, card, t0):
    """(a) of :func:`phase_slice_tensor_parallel`: the four ranks, their
    checks, step 1 of one process, the record; returns the ranks'
    records."""
    ranks, batch_path = tensor_parallel_ranks(dev, spec, layers, root)
    ranks_s = time.perf_counter() - t0
    problems = []
    for r in ranks:
        if len(r["steps"]) != TP_STEPS or not all(
                math.isfinite(v) for st in r["steps"] for v in st.values()):
            problems.append(f"rank {r['rank']}: steps {r['steps']}")
        idle = [k for k in TP_KERNELS if r["launches"][k] <= 0]
        if idle and dev.type == "cuda":
            problems.append(f"rank {r['rank']}: kernels never launched {idle}")
    for key in ("replicated", "whole"):
        if len({r[key] for r in ranks}) != 1:
            problems.append(f"the ranks' {key} weights differ")
    if any(r["steps"] != ranks[0]["steps"] for r in ranks):
        problems.append("the ranks logged different losses")
    t1 = time.perf_counter()
    ref = tensor_parallel_reference(batch_path, dev, spec, layers, root)
    ref_s = time.perf_counter() - t1
    gc.collect()
    torch.cuda.empty_cache()
    step1 = ranks[0]["steps"][0] if ranks[0]["steps"] else {}
    missing = sorted(set(ref) - set(step1))
    gaps = {k: abs(step1[k] - v) / max(abs(v), 1e-6) for k, v in ref.items() if k in step1}
    if missing or not gaps or any(abs(step1[k] - v) > TP_LOSS_RTOL * abs(v) + TP_LOSS_ATOL
                                  for k, v in ref.items() if k in step1):
        problems.append(f"step 1 against one process: {gaps}, missing {missing}")
    emit({"phase": "slice_tensor_parallel", "part": "a", "model": spec, "layers": layers,
          "ranks": TP_RANKS, "axes": {"data": 1, "fsdp": 1, "model": TP_RANKS},
          "dtype": "bfloat16", "remat": "full", "cuts": TP_CUTS, "tp": ranks[0]["tp"],
          "launches_per_rank": [r["launches"] for r in ranks],
          "peak_gb_per_rank": [r["peak_gb"] for r in ranks],
          "step_s_per_rank": [r["step_s"] for r in ranks],
          "built_s_per_rank": [r["built_s"] for r in ranks],
          "train_s_per_rank": [r["train_s"] for r in ranks],
          "digest_s_per_rank": [r["digest_s"] for r in ranks],
          "group_s_per_rank": [r["group_s"] for r in ranks],
          "step1": step1, "one_process_step1": ref, "step1_rel_gap": gaps,
          "loss_tol": [TP_LOSS_RTOL, TP_LOSS_ATOL], "eval_keys": ranks[0]["eval_keys"],
          "weights_equal": len({r["whole"] for r in ranks}) == 1,
          "replicated_equal": len({r["replicated"] for r in ranks}) == 1,
          "ranks_s": ranks_s, "one_process_s": ref_s, "card": card, "ok": not problems})
    if problems:
        raise AssertionError(f"slice_tensor_parallel (a): {problems}")
    return ranks


def phase_slice_tensor_parallel(device="cuda", card="", spec=TP_SPEC, layers=TP_LAYERS,
                                ppo_spec="builtin:gpt2-small", ppo_layers=PARITY_LAYERS):
    """Tensor parallelism on the card, in two parts.

    (a) ILQL at GPT-NeoX-20B's full width (hidden 6144, 64 heads, ffn
    24576, vocabulary 50432: 16 heads, a quarter of the ffn and 12608 ids
    a rank) on :func:`tp_ilql_config` (``examples/ilql_sentiments_20b.py``
    with :data:`TP_CUTS`), four ranks on the one card in a gloo group
    (:func:`tensor_parallel_ranks`), through ``train(samples=...,
    rewards=...)``: :data:`TP_STEPS` updates, then one evaluation's 64 new
    tokens through the paged engine (the one before the steps skipped).
    Checks: every rank took every step
    with finite losses, and launched each of :data:`TP_KERNELS` (counts
    zeroed just before ``train()``); the parameters every rank holds whole
    and the whole weights gathered over ``model`` are bitwise equal across
    the ranks; once the ranks exit, step 1's losses and gradient norm of
    one process over the same batch and seeded weights (its forward and
    backward) agree within :data:`TP_LOSS_RTOL` relative plus
    :data:`TP_LOSS_ATOL`.
    Records the peak memory per rank and the seconds per step.

    (b) PPO at ``model`` 2 (:data:`TP_PPO_AXES`) on
    :func:`phase_slice_parallel_rl`'s machinery at ``ppo_spec``'s width and
    ``ppo_layers`` depth in f32, its pair started beside (a)'s ranks,
    with the fused loss kernels: the ranks'
    weights bitwise equal after every step, step 1 within 1e-5 of one
    process, #1–#3 and #5–#8 launched on each rank, the preemption and its
    one-process resume. Returns rank 0's launches of (a) and (b)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    root, ppo_root = _scratch_dir("tensor_parallel"), _scratch_dir("tensor_parallel_ppo")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # (b)'s pair runs beside (a)'s ranks, which spend their first tens of
    # seconds drawing weights on the host
    ppo_pairs = start_parallel_rl_ranks(TP_PPO_AXES, dev, ppo_spec, ppo_layers, ppo_root)
    try:
        ranks = tensor_parallel_part_a(dev, spec, layers, root, card, t0)
    except BaseException:
        kill_ranks(ppo_pairs)
        raise
    launches = Counter(ranks[0]["launches"])
    launches.update(phase_slice_parallel_rl(device, spec=ppo_spec, layers=ppo_layers, card=card,
                                            axes=TP_PPO_AXES, phase="slice_tensor_parallel",
                                            pairs=ppo_pairs, root=ppo_root))
    return dict(launches)


def kernel_record(name, launches, max_abs_err, rec, by_path):
    """One kernel's entry: ``launches`` from its own slice's main path,
    ``launches_by_path`` from every path's run."""
    source = SOURCES.get(name, name)
    return {"name": name, "route": "cuda", "source": f"trlx_tpu_torch/csrc/{source}.cu",
            "replaces": REPLACES[name], "launches": launches, "max_abs_err": max_abs_err,
            "ms": rec["kernel_ms"], "call_ms": rec["call_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()}}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from trlx_tpu_torch.ops import kernel_utils  # noqa: F401 — needs the repo


    seconds = {}

    def clocked(fn, *args, _as=None, **kw):
        """``fn(*args, **kw)``, its wall seconds kept under its name (or
        ``_as``)."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        name = _as or fn.__name__.removeprefix("phase_")
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return out

    try:
        return run_phases(clocked, seconds)
    except BaseException:
        # the phases that ran, for the record; then the failure
        emit({"phase": "phase_seconds", **seconds, "total": sum(seconds.values())})
        raise


def run_phases(clocked, seconds):
    """Every phase in order, then the summary lines; returns 0."""
    smi = clocked(phase_device)
    clocked(phase_build)
    timed = clocked(phase_kernels)
    timed_train = clocked(phase_train_kernels)
    ring_launches, ring_chunk = clocked(phase_slice_ring, card=smi)
    serve_launches = clocked(phase_slice, card=smi)
    prefix_launches, prefix_run = clocked(phase_slice_serve_prefix, card=smi)
    clocked(phase_slice_serve_prefix_parity, prefix_run, card=smi)
    prefix_model = prefix_run["model"]  # slice_spec_prefix speculates on it
    del prefix_run
    gc.collect()
    torch.cuda.empty_cache()
    trainer, train_launches = clocked(phase_slice_train, card=smi)
    clocked(phase_slice_train_parity, trainer)
    del trainer
    spec_launches = clocked(phase_slice_spec, card=smi)
    _, spec32 = clocked(phase_slice_spec_parity, card=smi, keep=True)
    spec_prefix_launches = clocked(phase_slice_spec_prefix, prefix_model, spec32, card=smi)
    engine_dense_launches = clocked(phase_slice_engine_dense, spec32, card=smi)
    del prefix_model, spec32
    gc.collect()
    torch.cuda.empty_cache()
    serial_launches, serial_trainer = clocked(phase_slice_serial, card=smi, keep=True)
    hf_launches = Counter(clocked(phase_slice_hf_gpt2, serial_trainer, card=smi,
                                  _as="slice_hf"))
    async_launches = clocked(phase_slice_async, serial_trainer, card=smi)
    del serial_trainer
    gc.collect()
    torch.cuda.empty_cache()
    serial_spec_launches = clocked(phase_slice_serial_spec, card=smi)
    clocked(phase_slice_serial_parity, card=smi)
    grpo_launches, grpo_run = clocked(phase_slice_grpo, card=smi, keep=True)
    grpo_cb_launches, _ = clocked(phase_slice_grpo, continuous=True, card=smi,
                                  _as="slice_grpo_cb")
    clocked(phase_slice_grpo_parity, grpo_run, card=smi)
    del grpo_run
    grpo_spec_launches, _ = clocked(phase_slice_grpo, continuous=True, card=smi,
                                    total_steps=GRPO_SPEC_STEPS, checkpoint_interval=10 ** 6,
                                    speculative=SPEC_GAMMA, _as="slice_grpo_spec")
    torch.cuda.empty_cache()
    serve_train_launches = clocked(phase_slice_serve_train, card=smi)
    gc.collect()
    torch.cuda.empty_cache()
    sft, sft_launches = clocked(phase_slice_sft, card=smi)
    ilql, ilql_launches = clocked(phase_slice_ilql, card=smi)
    offline = clocked(phase_slice_offline_parity, sft, ilql)
    del sft, ilql
    dpo, dpo_launches = clocked(phase_slice_dpo, card=smi)
    del dpo
    clocked(phase_slice_dpo_parity, card=smi)
    reward_launches = clocked(phase_slice_reward, card=smi)
    torch.cuda.empty_cache()
    randomwalks = clocked(phase_slice_randomwalks, card=smi)
    torch.cuda.empty_cache()
    family_serve = clocked(phase_family_serve, card=smi)
    torch.cuda.empty_cache()
    _, family_model, family_cfg, family32, family32_cfg = clocked(phase_family_parity,
                                                                  keep=True)
    hf_launches.update(clocked(phase_slice_hf_mistral, family_model, family_cfg, card=smi,
                               _as="slice_hf"))
    del family_model
    family_spec_launches = clocked(phase_slice_family_spec, family32, family32_cfg, card=smi)
    del family32
    gc.collect()
    torch.cuda.empty_cache()
    family_train = clocked(phase_family_train, card=smi)
    gc.collect()
    torch.cuda.empty_cache()
    moe_serve = clocked(phase_moe_serve, card=smi)
    gc.collect()
    torch.cuda.empty_cache()
    moe_grpo = clocked(phase_moe_grpo, card=smi)
    gc.collect()
    torch.cuda.empty_cache()
    dpo_lora_launches = clocked(phase_slice_dpo_lora, card=smi)
    gc.collect()
    torch.cuda.empty_cache()
    t5_ppo_launches, t5_trainer = clocked(phase_slice_t5_ppo, card=smi, keep=True)
    hf_launches.update(clocked(phase_slice_hf_t5, t5_trainer, card=smi, _as="slice_hf"))
    del t5_trainer
    t5_ilql_launches = clocked(phase_slice_t5_ilql, card=smi)
    gc.collect()
    torch.cuda.empty_cache()
    clocked(phase_slice_t5_parity)
    gc.collect()
    torch.cuda.empty_cache()
    remat_trainer, remat_launches = clocked(phase_slice_remat, card=smi)
    clocked(phase_slice_remat_policies, remat_trainer, card=smi)
    del remat_trainer
    gc.collect()
    torch.cuda.empty_cache()
    resilience_launches = clocked(phase_slice_resilience, card=smi)
    gc.collect()
    torch.cuda.empty_cache()
    parallel_rl_launches = clocked(phase_slice_parallel_rl, card=smi)
    gc.collect()
    torch.cuda.empty_cache()
    tensor_parallel_launches = clocked(phase_slice_tensor_parallel, card=smi)
    emit({"phase": "phase_seconds", **seconds, "total": sum(seconds.values())})
    # a served run counts the engine's kernels; nothing else launches there
    served = {k: 0 for k in REPLACES}
    by_path = {"serve": {**served, **serve_launches},
               "serve_prefix": {**served, **prefix_launches}, "train": train_launches,
               "spec": spec_launches, "serial": serial_launches,
               "serial_spec": serial_spec_launches, "sft": sft_launches, "ilql": ilql_launches,
               "randomwalks_ppo": randomwalks["ppo"], "randomwalks_ilql": randomwalks["ilql"],
               "family_serve": {**served, **family_serve}, "family_train": family_train,
               "grpo": grpo_launches, "grpo_cb": grpo_cb_launches,
               "moe_serve": {**served, **moe_serve}, "moe_grpo": moe_grpo,
               "dpo": dpo_launches, "reward": reward_launches, "dpo_lora": dpo_lora_launches,
               "t5_ppo": t5_ppo_launches, "t5_ilql": t5_ilql_launches,
               "remat": remat_launches, "resilience": resilience_launches,
               "serve_train": serve_train_launches, "hf": {**served, **hf_launches},
               "spec_prefix": spec_prefix_launches, "engine_dense": engine_dense_launches,
               "grpo_spec": grpo_spec_launches, "family_spec": family_spec_launches,
               "ilql_spec": offline["ilql_spec"]["trainer_generate"]["launches"],
               "async": async_launches, "ring": ring_launches,
               "parallel_rl": parallel_rl_launches,
               "tensor_parallel": tensor_parallel_launches}
    kernels = [kernel_record(name, serve_launches[name], timed[name]["max_abs_err"], timed[name],
                             by_path)
               for name in SERVE_KERNELS]
    kernels.insert(2, kernel_record("paged_verify", spec_launches["paged_verify"],
                                    timed["paged_verify"]["max_abs_err"],
                                    timed["paged_verify"], by_path))
    flash, loss = timed_train["flash_train"], timed_train["loss"]
    for name, rec, part, err in (
        ("flash_fwd", flash, "fwd", max(flash["max_abs_err"]["out"], flash["max_abs_err"]["lse"])),
        ("flash_bwd", flash, "bwd", max(flash["max_abs_err"][g] for g in ("dq", "dk", "dv"))),
        ("fused_loss_fwd", loss, "fwd", max(loss["max_abs_err"][k]
                                            for k in ("loss", "stats", "residuals"))),
        ("fused_loss_bwd", loss, "bwd", max(loss["max_abs_err"]["dlogprobs"],
                                            loss["max_abs_err"]["dvalues"])),
    ):
        kernels.append(kernel_record(name, train_launches[name], err, rec[part], by_path))
        if name == "flash_bwd":  # its chunk form, on the ring's path
            kernels.append(kernel_record("flash_bwd_chunk", ring_launches["flash_bwd_chunk"],
                                         ring_chunk["max_abs_err"], ring_chunk, by_path))
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
