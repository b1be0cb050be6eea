#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``trlx_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device facts (``torch.cuda.get_device_name`` and ``nvidia-smi``'s name
   and power limit); no CUDA device is a failure (exit 1);
2. build every kernel from ``trlx_tpu_torch/csrc`` with ``nvcc`` (one
   process per source, all started together) and print the build seconds;
3. every kernel against its plain PyTorch version on the card, at the
   serving slice's shapes and at a GQA shape, in bf16 and f32, with the
   max error, the stated tolerance, kernel / plain / library times (median
   of CUDA-event timed runs) and the least time the card could take;
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
   caught.

The line before the last holds the kernel summary, the one before it the
card's name and power limit; the last line is the result object. Any
failure raises, and the script exits non-zero without the result line.
"""

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per type

# file:line of each replaced TPU kernel's pl.pallas_call
REPLACES = {
    "paged_decode": "trlx_tpu/ops/paged_attention.py:226",
    "paged_prefill": "trlx_tpu/ops/paged_prefill.py:212",
    "fused_sample": "trlx_tpu/ops/paged_attention.py:373",
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, runs=25, warmup=3):
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event timed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def phase_build():
    from trlx_tpu_torch.ops.kernel_utils import build_kernels

    t0 = time.perf_counter()
    paths = build_kernels()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "kernels": sorted(paths)})


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def paged_inputs(rs, B, T, H, KV, D, bs, S, HB, dtype, dev, poison):
    """Random pool/table/bias for one geometry: rows see a random valid
    key prefix (causal over the chunk for T > 1); table entries past a
    row's valid columns are poisoned out of range when ``poison``; every
    pool block holds random stale values."""
    from trlx_tpu_torch.ops.paged_kv import num_table_blocks

    TB = num_table_blocks(S, bs)
    NB = 1 + B * TB + 3
    q = torch.tensor(rs.randn(B, T, H, D), dtype=torch.float32)
    kp = torch.tensor(rs.randn(NB, bs, KV, D), dtype=torch.float32)
    vp = torch.tensor(rs.randn(NB, bs, KV, D), dtype=torch.float32)
    perm = rs.permutation(np.arange(1, NB))[: B * TB].reshape(B, TB)
    valid = rs.randint(T, S + 1, size=B)  # visible key columns per row
    end_col = valid[:, None] - T + np.arange(T)[None, :]  # query slots
    cols = np.arange(S)[None, None, :]
    vis = (cols <= end_col[:, :, None]) & (rs.rand(B, 1, S) > 0.1)
    vis[:, :, 0] = True
    bias = np.where(vis, 0.0, -1e9)[:, None].repeat(HB, axis=1)
    if HB > 1:
        bias = bias + np.where(vis[:, None], rs.randn(B, HB, 1, S) * 0.3, 0.0)
    table = perm.copy()
    if poison:
        for b in range(B):
            first_dead = -(-int(valid[b]) // bs)
            table[b, first_dead:] = NB + 1 + b
    f = lambda x: x.to(dev, dtype).contiguous()  # noqa: E731
    return dict(
        q=f(q), k=f(kp), v=f(vp),
        table=torch.tensor(table, dtype=torch.int32, device=dev),
        bias=torch.tensor(bias, dtype=torch.float32, device=dev),
        vis=vis, TB=TB, NB=NB,
    )


def attention_bound(inp, B, T, H, KV, D, S, HB, dtype):
    elem = torch.finfo(dtype).bits // 8
    visible_cols = int(inp["vis"].any(axis=1).sum())  # key columns any query needs
    visible_pairs = int(inp["vis"].sum())  # (query, key) pairs per head
    nbytes = (2 * B * T * H * D * elem  # q in, out
              + 2 * visible_cols * KV * D * elem  # K and V columns read
              + B * HB * T * S * 4 + B * inp["TB"] * 4)
    ops = 4 * visible_pairs * H * D
    return bound(nbytes, ops, dtype)


def check_attention(kind, B, T, H, KV, D, bs, S, HB, dtype, poison, seed,
                    timed=False):
    from trlx_tpu_torch.ops.paged_attention import (
        _gathered_view,
        paged_attention_decode,
        paged_attention_decode_reference,
    )
    from trlx_tpu_torch.ops.paged_prefill import (
        paged_prefill_attention,
        paged_prefill_attention_reference,
    )

    dev = torch.device("cuda")
    rs = np.random.RandomState(seed)
    inp = paged_inputs(rs, B, T, H, KV, D, bs, S, HB, dtype, dev, poison)
    if kind == "paged_decode":
        q, bias = inp["q"][:, 0].contiguous(), inp["bias"][:, :, 0].contiguous()
        kern, ref = paged_attention_decode, paged_attention_decode_reference
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
           "HB": HB, "poisoned_ids": poison, "max_abs_err": err, "tol": tol}
    if not math.isfinite(err) or err > tol:
        emit({**rec, "ok": False})
        raise AssertionError(f"{kind} disagrees with its plain version: {err} > {tol}")
    if timed:
        rec["kernel_ms"] = time_ms(lambda: kern(*args))
        rec["plain_ms"] = time_ms(lambda: ref(*args))
        # library yardstick: SDPA on a gathered dense view with the same
        # bias (the gather itself is not timed)
        kd = _gathered_view(inp["k"], inp["table"], S, H).transpose(1, 2)
        vd = _gathered_view(inp["v"], inp["table"], S, H).transpose(1, 2)
        qd = inp["q"].transpose(1, 2)
        mask = inp["bias"].to(dtype)
        rec["library_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask))
        b_ms, b_by = attention_bound(inp, B, T, H, KV, D, S, HB, dtype)
        rec["bound_ms"], rec["bound_by"] = b_ms, b_by
        rec["bound_us"] = 1e3 * b_ms
    kern.launches = before  # comparison launches are not main-path launches
    emit({**rec, "ok": True})
    return rec


def check_sample(mode, dtype_name, B, V, seed, timed=False):
    from trlx_tpu_torch.ops.paged_attention import fused_sample, fused_sample_reference

    dev = torch.device("cuda")
    rs = np.random.RandomState(seed)
    logits = torch.tensor(rs.randn(B, V) * 3.0, dtype=torch.float32)
    if dtype_name == "bfloat16":  # bf16 model logits: many exact ties
        logits = logits.to(torch.bfloat16).float()
    logits = logits.to(dev).contiguous()
    settings = {
        "greedy": dict(temperature=1.0, top_k=0, top_p=1.0, sample=False),
        "temp_topk": dict(temperature=0.7, top_k=50, top_p=1.0, sample=True),
        "topp": dict(temperature=1.0, top_k=0, top_p=0.9, sample=True),
    }[mode]
    gumbel = None
    if settings.pop("sample"):
        u = rs.uniform(1e-7, 1 - 1e-7, size=(B, V))
        gumbel = torch.tensor(-np.log(-np.log(u)), dtype=torch.float32, device=dev)
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
        rec["kernel_ms"] = time_ms(lambda: fused_sample(logits, gumbel, **settings))
        rec["plain_ms"] = time_ms(lambda: fused_sample_reference(logits, gumbel, **settings))
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
        if bf:
            timed["paged_prefill"], timed["paged_decode"] = pre, dec
        check_attention("paged_prefill", T=24, dtype=dtype, poison=True, seed=3,
                        **gqa_geo)
        check_attention("paged_decode", T=1, dtype=dtype, poison=True, seed=4,
                        **gqa_geo)
    for i, mode in enumerate(("greedy", "temp_topk", "topp")):
        for dname in ("bfloat16", "float32"):
            rec = check_sample(mode, dname, B=8, V=50257, seed=10 + i,
                               timed=(mode == "topp" and dname == "bfloat16"))
            if "kernel_ms" in rec:
                timed["fused_sample"] = rec
    return timed


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


def http_generate(port, body):
    """POST /v1/generate; returns (status, tokens, n_tokens_reported)."""
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
    return resp.status, tokens, n_done


def f32_gaps(model32, prompts, responses):
    """Teacher-forced f32 logits over prompt ‖ response: for each response
    position, (best logit − logit of the given token, top-2 gap)."""
    out = []
    dev = next(model32.parameters()).device
    for p, r in zip(prompts, responses):
        ids = torch.tensor(np.concatenate([p, r])[None], dtype=torch.int64, device=dev)
        with torch.no_grad():
            logits = model32(ids)["logits"][0, len(p) - 1 : len(p) - 1 + len(r)].float()
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


def phase_slice(device="cuda", spec="builtin:gpt2-small", slots=8, block_size=16,
                segment_len=8, prompt_len=64, max_new=40, n_requests=16, card=""):
    from trlx_tpu_torch.engine.core import ContinuousEngine, kernel_launches
    from trlx_tpu_torch.models.builder import build_causal_lm
    from trlx_tpu_torch.ops.paged_attention import fused_sample, paged_attention_decode
    from trlx_tpu_torch.ops.paged_kv import PagedSpec, num_table_blocks
    from trlx_tpu_torch.ops.paged_prefill import paged_prefill_attention
    from trlx_tpu_torch.ops.sampling import GenerationConfig, generate
    from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns

    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" else (lambda: None)
    model, cfg = build_causal_lm(spec, seed=0, device=dev)
    V = cfg.vocab_size
    eos = V - 1  # GPT-2's <|endoftext|>
    gen = GenerationConfig(max_new_tokens=max_new, temperature=1.0, top_k=50,
                           top_p=0.95, do_sample=True, eos_token_id=eos,
                           pad_token_id=eos)
    S = prompt_len + max_new
    paged = PagedSpec(block_size, 1 + slots * num_table_blocks(S, block_size) + 8)

    def make_engine(m, c):
        fns = make_slot_refill_fns(c, slots, prompt_len, gen, segment_len=segment_len,
                                   paged=paged, device=dev)
        return ContinuousEngine(fns, m, eos)

    engine = make_engine(model, cfg)
    rs = np.random.RandomState(1234)
    prompts = rs.randint(0, V - 1, size=(n_requests, prompt_len))
    # warm-up off the clock: the first decode segment pays CUDA module
    # loading and library set-up, which no later request sees
    warm = prompts[:slots]
    engine.enqueue_prompts(warm, np.ones_like(warm), np.arange(slots))
    engine.run()
    bodies = [{"prompt_ids": prompts[i].tolist(), "seed": i,
               "do_sample": bool(i % 2), "stream": i == 0}
              for i in range(n_requests)]
    sync()
    for wrapper in (paged_prefill_attention, paged_attention_decode, fused_sample):
        wrapper.launches = 0
    engine.begin_collection()  # the engine's launch gauges count from here
    # -- the main path: HTTP requests through the server -----------------
    results, wall, server = serve_over_http(engine, bodies, max_new, V, sync)
    launches = kernel_launches()
    # -------------------------------------------------------------------
    st = engine.stats
    gauges = {"paged_prefill": st.prefill_kernel_launches,
              "paged_decode": st.decode_kernel_launches,
              "fused_sample": st.sample_kernel_launches}
    if gauges != launches:
        raise AssertionError(f"engine launch gauges {gauges} != wrapper counts {launches}")
    # on CPU tensors the wrappers run their plain versions and count nothing
    if dev.type == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    served = sum(len(r[1]) for r in results)
    sm = server.flat_metrics()
    emit({"phase": "slice_serve", "model": spec, "dtype": str(cfg.dtype).split(".")[-1],
          "requests": n_requests, "slots": slots, "kv_block_size": block_size,
          "segment_len": segment_len, "prompt_len": prompt_len, "max_new_tokens": max_new,
          "served_tokens": served, "wall_s": wall, "tokens_per_s": served / wall,
          "ttft_p50_s": sm["serve/ttft_p50"], "queue_wait_p50_s": sm["serve/queue_wait_p50"],
          "decode_segment_ms_mean": 1e3 * st.decode_s / max(st.segments, 1),
          "decode_step_ms_mean": 1e3 * st.decode_s / max(st.decode_steps, 1),
          "segments": st.segments, "refill_prefills": st.refill_prefills,
          "prefill_ms_mean": 1e3 * st.refill_s / max(st.refill_prefills, 1),
          "slot_utilization": st.slot_utilization, "launches": launches,
          "launches_per_request": {k: v / n_requests for k, v in launches.items()},
          "stream_tokens": len(results[0][1]), "card": card})

    # -- parity: greedy responses against the plain dense-cache generate --
    model32, cfg32 = build_causal_lm(spec, seed=0, device=dev, dtype=torch.float32)
    greedy_idx = [i for i in range(n_requests) if i % 2 == 0]
    gp = prompts[greedy_idx]
    plain = generate(model32, torch.tensor(gp), torch.tensor(np.ones_like(gp)),
                     torch.tensor(np.asarray(greedy_idx, np.int64)),
                     dataclasses.replace(gen, do_sample=False))
    plain_tok = plain.response_tokens.cpu().numpy()
    plain_mask = plain.response_mask.cpu().numpy()
    plain_resp = [plain_tok[j][plain_mask[j] == 1] for j in range(len(greedy_idx))]
    # (a) the greedy requests served over HTTP by the same server, engine
    # and kernels in f32, against plain, token for token
    served32, _, _ = serve_over_http(make_engine(model32, cfg32),
                                     [bodies[i] for i in greedy_idx], max_new, V, sync)
    ties = []
    for j in range(len(greedy_idx)):
        a, b = np.asarray(served32[j][1]), plain_resp[j]
        n = min(len(a), len(b))
        diff = np.nonzero(a[:n] != b[:n])[0]
        if len(diff) == 0 and len(a) == len(b):
            continue
        pos = min(int(diff[0]) if len(diff) else n, len(b) - 1)
        _, gap2 = f32_gaps(model32, [gp[j]], [b[: pos + 1]])[0]
        ties.append({"request": greedy_idx[j], "position": pos, "top2_gap": float(gap2[pos])})
        if gap2[pos] >= F32_TIE_GAP:
            emit({"phase": "slice_parity", "ok": False, "f32_divergence": ties[-1]})
            raise AssertionError(f"f32 served greedy tokens diverge from plain generate: {ties[-1]}")
    # (b) the bf16 served greedy responses, teacher-forced in f32
    gaps = f32_gaps(model32, gp, [np.asarray(results[i][1]) for i in greedy_idx])
    trail = np.concatenate([g for g, _ in gaps])
    top2 = np.concatenate([g2 for _, g2 in gaps])
    worst = float(trail.max())
    rec = {"phase": "slice_parity", "f32_served_vs_plain_rows": len(greedy_idx),
           "f32_near_ties": ties, "f32_tie_gap_tol": F32_TIE_GAP,
           "bf16_served_positions": int(trail.size),
           "bf16_served_vs_f32_max_gap": worst, "bf16_gap_tol": BF16_GAP_TOL,
           "bf16_served_f32_argmax_frac": float((trail == 0).mean()),
           "bf16_served_rows_equal_to_plain": sum(
               int(np.array_equal(results[i][1], p)) for i, p in zip(greedy_idx, plain_resp)),
           # how often the f32 second-best token would have broken the limit
           "f32_top2_gap_quantiles": {str(q): float(np.quantile(top2, q))
                                      for q in (0.05, 0.25, 0.5, 0.75, 0.95)},
           "f32_top2_gap_above_tol_frac": float((top2 > BF16_GAP_TOL).mean())}
    if worst > BF16_GAP_TOL:
        emit({**rec, "ok": False})
        raise AssertionError(f"bf16 served greedy tokens stray from the f32 argmax: {worst}")
    emit({**rec, "ok": True})
    return launches


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from trlx_tpu_torch.ops import kernel_utils  # noqa: F401 — needs the repo

    smi = phase_device()
    phase_build()
    timed = phase_kernels()
    launches = phase_slice(card=smi)
    kernels = []
    for name in ("paged_prefill", "paged_decode", "fused_sample"):
        rec = timed[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"trlx_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
