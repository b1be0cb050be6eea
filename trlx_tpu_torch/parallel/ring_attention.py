"""Ring attention: exact causal attention over a sequence split ``n`` ways.

Port of ``trlx_tpu/parallel/ring_attention.py``. Each of ``n`` shards
holds one ``T / n`` chunk of Q, K and V; the K/V chunks (with their key
mask and ALiBi positions) rotate around the ring, and the online-softmax
combiner (:func:`_combine`) merges the per-chunk ``(out, lse)`` pairs, so
the result is the full-sequence softmax up to f32 rounding.

**Zigzag placement** (:func:`zigzag_order`): the sequence splits into
``2n`` half-chunks and shard ``i`` holds halves ``i`` and ``2n - 1 - i``,
one early and one late span, so the causal work per ring step is near
uniform (:func:`ring_schedule_work`); ``contiguous`` gives shard ``i``
chunk ``i``.

**Forward**: ``n`` ring steps; per step, one ``flash_attention(...,
return_lse=True)`` call (kernel #5, ``csrc/flash_fwd.cu``) per (local
half x visiting half) pair, its slot offsets selecting global slots, so
the causal rule and the window hold on the true slot distance. A pair
wholly in the causal future costs one launch whose blocks exit at once.

**Backward** (:class:`_RingAttention`, a ``torch.autograd.Function``):
one sweep carrying ``(k, v, mask, kpos, dk, dv)`` around the ring; each
pair is one ``flash_attention_bwd_chunk`` call (kernel #6,
``csrc/flash_bwd.cu``) with the *global* ``lse`` and ``delta`` saved from
the forward. After the sweep every ``dk`` / ``dv`` accumulator is back on
its home shard, complete.

One schedule, two transports, the same per-(shard, step) body:

- :func:`ring_flash_attention` (**in-process**, JAX's signature: global
  in, global out): all ``n`` shards sit on one device and a rotation is
  an index shift of the list of shards. ``n = 1`` is one flash call. The
  tests and the card's ring phase use it (one card cannot hold two NCCL
  ranks).
- :func:`ring_flash_attention_group` (**process group**): the inputs are
  this rank's shard, already in the placement's order, and K/V rotate
  over ``group`` with ``torch.distributed.batch_isend_irecv``. The model
  takes it in a forward given a ``sequence_group``
  (``models/transformer.py``; SFT's loss under a ``sequence`` axis above
  1).

ALiBi positions are global token positions, taken before the split; they
ride the ring beside K/V. K/V stay unrepeated (GQA).
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from trlx_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_bwd_chunk,
)

__all__ = [
    "ring_flash_attention",
    "ring_flash_attention_group",
    "ring_schedule_work",
    "zigzag_order",
]


def _combine(out_a, lse_a, out_b, lse_b):
    """Merge two normalized partial-softmax results by their logsumexps.

    out / lse: ``[B, T, H, D]`` / ``[B, H, T]``. Rows masked everywhere
    carry the ``NEG_INF`` sentinel and a zero output on both sides, which
    this keeps."""
    m = torch.maximum(lse_a, lse_b)
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    w_a = torch.where(lse_a > 0.5 * NEG_INF, torch.exp(lse_a - m), zero)
    w_b = torch.where(lse_b > 0.5 * NEG_INF, torch.exp(lse_b - m), zero)
    denom = w_a + w_b
    safe = torch.where(denom > 0.0, denom, torch.ones_like(denom))
    lse = torch.where(denom > 0.0, m + torch.log(safe), torch.full_like(m, NEG_INF))
    wa = (w_a / safe).transpose(1, 2)[..., None]  # [B, T, H, 1]
    wb = (w_b / safe).transpose(1, 2)[..., None]
    return out_a * wa + out_b * wb, lse


def zigzag_order(T: int, n: int) -> np.ndarray:
    """Global → zigzag gather indices: shard ``i`` holds half-chunks ``i``
    and ``2n - 1 - i`` of the 2n-way split."""
    half = T // (2 * n)
    order = []
    for i in range(n):
        order.extend(range(i * half, (i + 1) * half))
        order.extend(range((2 * n - 1 - i) * half, (2 * n - i) * half))
    return np.asarray(order, np.int32)


def ring_schedule_work(n: int, placement: str) -> Tuple[List[float], float, float]:
    """Analytic causal-work schedule: per-ring-step wall cost (max over
    shards, in units of one full chunk-pair attention), total wall, and
    total useful work. The imbalance the zigzag placement removes is
    ``total_wall / (total_work / n)``: ~2 for contiguous, ~1 for zigzag."""

    def segs(dev):
        if placement == "contiguous":
            return [(dev, 1.0)]  # (offset in chunk units, length in chunks)
        return [(dev * 0.5, 0.5), ((2 * n - 1 - dev) * 0.5, 0.5)]

    def pair_cost(qoff, qlen, koff, klen):
        # visible fraction of the (qlen x klen) tile under k_slot <= q_slot
        q_lo, q_hi = qoff, qoff + qlen
        k_lo, k_hi = koff, koff + klen
        if k_hi <= q_lo:
            return qlen * klen  # fully past: dense
        if k_lo >= q_hi:
            return 0.0  # fully future: skipped
        return 0.5 * qlen * klen  # diagonal: half-causal

    per_step, total_work = [], 0.0
    for s in range(n):
        costs = []
        for dev in range(n):
            src = (dev - s) % n
            c = sum(
                pair_cost(qo, ql, ko, kl)
                for qo, ql in segs(dev)
                for ko, kl in segs(src)
            )
            costs.append(c)
        per_step.append(max(costs))
        total_work += sum(costs)
    return per_step, sum(per_step), total_work


# ---------------------------------------------------------------------------
# transports: where the shards live and how a rotation moves them
# ---------------------------------------------------------------------------


class _InProcess:
    """All ``n`` shards in this process (one device): ``split`` cuts a
    global tensor into them, a rotation shifts the list (shard ``j``
    receives shard ``j - 1``'s chunk)."""

    def __init__(self, n: int):
        self.n = n
        self.shards = list(range(n))

    def split(self, x: Optional[torch.Tensor], dim: int) -> List[Optional[torch.Tensor]]:
        if x is None:
            return [None] * self.n
        return list(torch.chunk(x, self.n, dim=dim))

    def join(self, xs: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        return torch.cat(list(xs), dim=dim)

    def rotate(self, lists: Sequence[List[Optional[torch.Tensor]]]):
        return [xs[-1:] + xs[:-1] for xs in lists]


class _Group:
    """This rank's one shard; a rotation sends it to the next rank of
    ``group`` and receives the previous rank's (``batch_isend_irecv``, one
    tag per tensor)."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        self.n = dist.get_world_size(group)
        me = dist.get_rank(group)
        ranks = dist.get_process_group_ranks(group)
        self.next, self.prev = ranks[(me + 1) % self.n], ranks[(me - 1) % self.n]
        self.shards = [me]

    def split(self, x, dim):
        return [x]

    def join(self, xs, dim):
        return xs[0]

    def rotate(self, lists):
        import torch.distributed as dist

        ops, out = [], []
        for tag, (x,) in enumerate(lists):
            if x is None:
                out.append([None])
                continue
            x = x.contiguous()
            buf = torch.empty_like(x)
            ops.append(dist.P2POp(dist.isend, x, self.next, self.group, tag))
            ops.append(dist.P2POp(dist.irecv, buf, self.prev, self.group, tag))
            out.append([buf])
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out


def _segments(shard: int, Tl: int, n: int, zigzag: bool):
    """Local ``(start, length, global slot offset)`` spans of a shard."""
    if not zigzag:
        return [(0, Tl, shard * Tl)]
    half = Tl // 2
    return [(0, half, shard * half), (half, half, (2 * n - 1 - shard) * half)]


def _cut(x: Optional[torch.Tensor], start: int, length: int, dim: int = 1):
    return None if x is None else x.narrow(dim, start, length)


class _RingAttention(torch.autograd.Function):
    """The ring forward and its one-sweep backward over a transport.
    Gradients flow to q, k and v only."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, q_positions, k_positions, alibi_slopes, ring, opts):
        n, zig = ring.n, opts["zigzag"]
        kw = dict(causal=opts["causal"], sm_scale=opts["sm_scale"], window=opts["window"])
        qs, ms = ring.split(q, 1), ring.split(key_mask, 1)
        kc, vc, mc = ring.split(k, 1), ring.split(v, 1), ms
        qps, kpc = ring.split(q_positions, 1), ring.split(k_positions, 1)
        Tl = qs[0].shape[1]
        outs, lses = [], []
        for j, shard in enumerate(ring.shards):
            B, _, H, D = qs[j].shape
            outs.append([q.new_zeros((B, ql, H, D), dtype=torch.float32)
                         for _, ql, _ in _segments(shard, Tl, n, zig)])
            lses.append([q.new_full((B, H, ql), NEG_INF, dtype=torch.float32)
                         for _, ql, _ in _segments(shard, Tl, n, zig)])
        for step in range(n):
            for j, shard in enumerate(ring.shards):
                src = (shard - step) % n
                for i, (q0, ql, qoff) in enumerate(_segments(shard, Tl, n, zig)):
                    for k0, kl, koff in _segments(src, Tl, n, zig):
                        o, l = flash_attention(
                            _cut(qs[j], q0, ql), _cut(kc[j], k0, kl), _cut(vc[j], k0, kl),
                            _cut(mc[j], k0, kl), q_offset=qoff, k_offset=koff,
                            q_positions=_cut(qps[j], q0, ql),
                            k_positions=_cut(kpc[j], k0, kl),
                            alibi_slopes=alibi_slopes, return_lse=True, **kw)
                        outs[j][i], lses[j][i] = _combine(outs[j][i], lses[j][i], o.float(), l)
            if step != n - 1:
                kc, vc, mc, kpc = ring.rotate([kc, vc, mc, kpc])
        out = ring.join([torch.cat(o, dim=1) for o in outs], 1).to(q.dtype)
        lse = ring.join([torch.cat(l, dim=2) for l in lses], 2)
        ctx.save_for_backward(q, k, v, key_mask, q_positions, k_positions, alibi_slopes,
                              out, lse)
        ctx.ring, ctx.opts = ring, opts
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, q_positions, k_positions, alibi_slopes, out, lse = ctx.saved_tensors
        ring, opts = ctx.ring, ctx.opts
        n, zig = ring.n, opts["zigzag"]
        kw = dict(causal=opts["causal"], sm_scale=opts["sm_scale"], window=opts["window"])
        do = do.to(q.dtype).contiguous()
        delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2)  # [B, H, T]
        qs, dos = ring.split(q, 1), ring.split(do, 1)
        lss, dls = ring.split(lse, 2), ring.split(delta, 2)
        qps = ring.split(q_positions, 1)
        kc, vc, mc = ring.split(k, 1), ring.split(v, 1), ring.split(key_mask, 1)
        kpc = ring.split(k_positions, 1)
        Tl = qs[0].shape[1]
        dq = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in qs]
        dkc = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in kc]
        dvc = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in vc]
        for step in range(n):
            for j, shard in enumerate(ring.shards):
                src = (shard - step) % n
                for q0, ql, qoff in _segments(shard, Tl, n, zig):
                    for k0, kl, koff in _segments(src, Tl, n, zig):
                        g_q, g_k, g_v = flash_attention_bwd_chunk(
                            _cut(qs[j], q0, ql), _cut(kc[j], k0, kl), _cut(vc[j], k0, kl),
                            _cut(mc[j], k0, kl), _cut(lss[j], q0, ql, 2),
                            _cut(dls[j], q0, ql, 2), _cut(dos[j], q0, ql),
                            q_offset=qoff, k_offset=koff,
                            q_positions=_cut(qps[j], q0, ql),
                            k_positions=_cut(kpc[j], k0, kl),
                            alibi_slopes=alibi_slopes, **kw)
                        dq[j][:, q0:q0 + ql] += g_q.float()
                        dkc[j][:, k0:k0 + kl] += g_k.float()
                        dvc[j][:, k0:k0 + kl] += g_v.float()
            # the chunk travels on with its gradient accumulator; the last
            # rotation brings every accumulator home, the chunks need not
            if step != n - 1:
                kc, vc, mc, kpc, dkc, dvc = ring.rotate([kc, vc, mc, kpc, dkc, dvc])
            else:
                dkc, dvc = ring.rotate([dkc, dvc])
        return (ring.join(dq, 1).to(q.dtype), ring.join(dkc, 1).to(k.dtype),
                ring.join(dvc, 1).to(v.dtype), None, None, None, None, None, None)


def _ring_opts(D, causal, sm_scale, window, zigzag):
    return dict(causal=bool(causal), sm_scale=float(sm_scale if sm_scale is not None
                                                    else D ** -0.5),
                window=int(window or 0), zigzag=bool(zigzag))


def _alibi_operands(q_positions, k_positions, alibi_slopes):
    if alibi_slopes is None:
        return None, None, None
    if q_positions is None or k_positions is None:
        raise ValueError("alibi ring attention needs q_positions/k_positions")
    return (q_positions.to(torch.int32), k_positions.to(torch.int32),
            alibi_slopes.to(torch.float32))


def ring_flash_attention(
    q: torch.Tensor,  # [B, T, H, D] global
    k: torch.Tensor,  # [B, T, KV, D]
    v: torch.Tensor,  # [B, T, KV, D]
    key_mask: torch.Tensor,  # [B, T]
    n: int,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    q_positions: Optional[torch.Tensor] = None,  # [B, T] (ALiBi)
    k_positions: Optional[torch.Tensor] = None,  # [B, T] (ALiBi)
    alibi_slopes: Optional[torch.Tensor] = None,  # [H]
    placement: str = "auto",  # auto | zigzag | contiguous
    window: Optional[int] = None,  # sliding-window width (slot distance)
) -> torch.Tensor:
    """Exact attention with K/V rotating around a ring of ``n`` shards, all
    in this process (the in-process transport). Global in, global out;
    ``T`` must divide by ``n``; ``n = 1`` is one flash call.
    Differentiable in q, k and v.

    ``placement="auto"`` takes zigzag whenever it pays (causal, ``T``
    divisible by ``2n``) and contiguous otherwise."""
    if n == 1:
        return flash_attention(q, k, v, key_mask, causal=causal, sm_scale=sm_scale,
                               q_positions=q_positions, k_positions=k_positions,
                               alibi_slopes=alibi_slopes, window=window)
    B, T, H, D = q.shape
    if T % n:
        raise ValueError(f"sequence length {T} not divisible by ring size {n}")
    if placement == "auto":
        placement = "zigzag" if causal and T % (2 * n) == 0 else "contiguous"
    if placement == "zigzag" and T % (2 * n):
        raise ValueError(f"zigzag needs T divisible by 2n={2 * n}, got T={T}")
    zigzag = placement == "zigzag"
    qpos, kpos, slopes = _alibi_operands(q_positions, k_positions, alibi_slopes)
    key_mask = key_mask.to(torch.float32)
    if zigzag:
        order = torch.as_tensor(zigzag_order(T, n), dtype=torch.int64, device=q.device)
        q, k, v, key_mask = (x.index_select(1, order) for x in (q, k, v, key_mask))
        if slopes is not None:
            qpos, kpos = qpos.index_select(1, order), kpos.index_select(1, order)
    out = _RingAttention.apply(q, k, v, key_mask, qpos, kpos, slopes, _InProcess(n),
                               _ring_opts(D, causal, sm_scale, window, zigzag))
    if zigzag:
        inverse = torch.as_tensor(np.argsort(zigzag_order(T, n)), dtype=torch.int64,
                                  device=q.device)
        out = out.index_select(1, inverse)
    return out


def ring_flash_attention_group(
    q: torch.Tensor,  # [B, T/n, H, D] this rank's shard
    k: torch.Tensor,  # [B, T/n, KV, D]
    v: torch.Tensor,  # [B, T/n, KV, D]
    key_mask: torch.Tensor,  # [B, T/n]
    group,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    q_positions: Optional[torch.Tensor] = None,  # [B, T/n] global positions (ALiBi)
    k_positions: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    placement: str = "zigzag",  # the order the shards were cut in
    window: Optional[int] = None,
) -> torch.Tensor:
    """Ring attention over the ranks of ``group`` (the process-group
    transport): every rank passes its shard, cut in ``placement``'s order
    (rank ``i`` of a zigzag split holds global half-chunks ``i`` and
    ``2n - 1 - i``), and gets its shard of the output. Every rank of the
    group must call it with the same shapes."""
    if placement not in ("zigzag", "contiguous"):
        raise ValueError(f"placement {placement!r}: zigzag | contiguous")
    ring = _Group(group)
    if placement == "zigzag" and q.shape[1] % 2:
        raise ValueError(f"a zigzag shard holds two halves: local length {q.shape[1]} is odd")
    qpos, kpos, slopes = _alibi_operands(q_positions, k_positions, alibi_slopes)
    return _RingAttention.apply(q, k, v, key_mask.to(torch.float32), qpos, kpos, slopes, ring,
                                _ring_opts(q.shape[3], causal, sm_scale, window,
                                           placement == "zigzag"))
