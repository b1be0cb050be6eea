"""The port's flash attention (``trlx_tpu_torch/ops/flash_attention.py``)
against the JAX package, on the CPU.

On CPU tensors the wrappers run their plain versions, wired through the
same ``torch.autograd.Function`` the kernels use on the card. The forward
(out and lse) is held against JAX ``flash_attention`` (the Pallas kernel in
interpret mode) and ``attention_reference``; the gradients (dq, dk, dv of
``sum(out * cotangent)``) against ``jax.grad`` through the reference.
Cases: causal and not, left-padded masks, q/k slot offsets, GQA (H=4,
KV=2), a sliding window, ALiBi, fully masked rows, T != S and odd lengths,
head dims 12 and 96. Tolerance (f32): out and lse ``atol=1e-5``, gradients
``atol=1e-4``. The card kernels' bf16 rounding is emulated here too (end
of file), forward and backward, against the card's bf16 tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.models.transformer import alibi_slopes as jax_alibi_slopes
from trlx_tpu.ops.flash_attention import attention_reference as jax_attention_reference
from trlx_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from trlx_tpu_torch.ops.flash_attention import (
    NEG_INF,
    attention_reference,
    flash_attention,
    flash_bwd,
    flash_fwd,
)
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4

# (B, T, S, H, KV, D, causal, left_pad, q_offset, k_offset, window, alibi)
CASES = {
    "causal": (2, 16, 16, 2, 2, 8, True, 0, 0, 0, 0, False),
    "noncausal_leftpad": (2, 16, 16, 2, 2, 8, False, 3, 0, 0, 0, False),
    "causal_leftpad_odd": (3, 13, 13, 2, 2, 8, True, 4, 0, 0, 0, False),
    "offsets_t_ne_s": (2, 9, 21, 2, 2, 8, True, 0, 12, 0, 0, False),
    "gqa": (2, 11, 11, 4, 2, 8, True, 2, 0, 0, 0, False),
    "window": (2, 17, 17, 2, 2, 8, True, 3, 0, 0, 5, False),
    "alibi": (2, 12, 12, 4, 4, 8, True, 3, 0, 0, 0, True),
    # k_offset ahead of the queries: the first rows see no key at all
    "fully_masked_rows": (2, 10, 10, 2, 2, 8, True, 0, 0, 4, 0, False),
    "window_offsets_gqa_alibi": (2, 7, 19, 4, 2, 16, True, 5, 12, 0, 6, True),
    # head dims off the card kernels' templates: the randomwalks model's 12
    # and gptneox-20b's 96; 320, which the card splits over the head dim
    "head_dim_12_gqa": (2, 11, 11, 4, 2, 12, True, 2, 0, 0, 0, False),
    "head_dim_96_window_alibi": (1, 9, 13, 2, 2, 96, True, 2, 3, 0, 6, True),
    "head_dim_320_gqa_alibi": (2, 9, 11, 4, 2, 320, True, 2, 0, 0, 0, True),
}


def _inputs(case, seed=0):
    B, T, S, H, KV, D, causal, left_pad, qo, ko, window, alibi = case
    rs = np.random.RandomState(seed)
    q = rs.randn(B, T, H, D).astype(np.float32)
    k = rs.randn(B, S, KV, D).astype(np.float32)
    v = rs.randn(B, S, KV, D).astype(np.float32)
    mask = np.ones((B, S), np.float32)
    if left_pad:
        mask[:, :left_pad] = 0.0
        mask[0, : left_pad + 2] = 0.0  # ragged across the batch
    cot = rs.randn(B, T, H, D).astype(np.float32)
    extra = dict(causal=causal, q_offset=qo, k_offset=ko, window=window or None)
    if alibi:
        kpos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
        # queries at slots [qo, qo + T) of a sequence whose keys start at ko
        qpos = np.arange(T, dtype=np.int32)[None].repeat(B, 0) + qo
        extra.update(q_positions=qpos, k_positions=kpos,
                     alibi_slopes=np.asarray(jax_alibi_slopes(H), np.float32))
    return q, k, v, mask, cot, extra


def _rep(x, H):
    return np.repeat(x, H // x.shape[2], axis=2)


def _jax(extra):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in extra.items()}


def _split(extra):
    """(array kwargs, static kwargs) — arrays go through ``jax.jit`` as
    arguments, the rest are closed over."""
    arrays = {k: v for k, v in extra.items() if hasattr(v, "shape")}
    return arrays, {k: v for k, v in extra.items() if k not in arrays}


def _torch(extra):
    return {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v) for k, v in extra.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    case = CASES[name]
    H = case[3]
    q, k, v, mask, _, extra = _inputs(case)
    out, lse = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                               torch.tensor(mask), return_lse=True, **_torch(extra))
    # the JAX kernel (interpret) runs GQA natively; its reference needs
    # repeated K/V
    arrays, statics = _split(_jax(extra))
    jout, jlse = jax.jit(lambda *a: jax_flash_attention(
        *a[:4], interpret=True, return_lse=True, block_q=8, block_k=8,
        **dict(zip(arrays, a[4:])), **statics))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), *arrays.values())
    rout, rlse = jax.jit(lambda *a: jax_attention_reference(
        *a[:4], **dict(zip(arrays, a[4:])), **statics))(
        jnp.asarray(q), jnp.asarray(_rep(k, H)), jnp.asarray(_rep(v, H)), jnp.asarray(mask),
        *arrays.values())
    for want, want_lse in ((jout, jlse), (rout, rlse)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=OUT_ATOL, rtol=0)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=OUT_ATOL, rtol=0)
    # the port's own oracle agrees too
    tout, tlse = attention_reference(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                     torch.tensor(mask), **_torch(extra))
    np.testing.assert_allclose(out.numpy(), tout.numpy(), atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), tlse.numpy(), atol=OUT_ATOL, rtol=0)
    if name == "fully_masked_rows":
        dead = lse.numpy() <= NEG_INF / 2
        assert dead.any()
        assert np.all(out.numpy().transpose(0, 2, 1, 3)[dead] == 0.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_jax_grad(name):
    case = CASES[name]
    H = case[3]
    q, k, v, mask, cot, extra = _inputs(case, seed=1)
    tq, tk, tv = (torch.tensor(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, torch.tensor(mask), **_torch(extra))
    (out * torch.tensor(cot)).sum().backward()

    def loss(qq, kk, vv):
        o, _ = jax_attention_reference(qq, jnp.repeat(kk, H // kk.shape[2], axis=2),
                                       jnp.repeat(vv, H // vv.shape[2], axis=2),
                                       jnp.asarray(mask), **_jax(extra))
        return jnp.sum(o * jnp.asarray(cot))

    jdq, jdk, jdv = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jdq), atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(jdk), atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jdv), atol=GRAD_ATOL, rtol=0)


def test_wrappers_check_shapes_and_devices():
    q = torch.zeros(1, 4, 3, 8)
    k = torch.zeros(1, 4, 2, 8)
    mask = torch.ones(1, 4)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_fwd(q, k, k, mask, None, None, None, sm_scale=1.0, causal=True)
    meta = torch.device("meta")
    q = torch.empty(1, 4, 2, 8, device=meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_fwd(q, q, q, torch.empty(1, 4, device=meta), None, None, None,
                  sm_scale=1.0, causal=True)
    lse = torch.empty(1, 2, 4, device=meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_bwd(q, q, q, torch.empty(1, 4, device=meta), None, None, None, lse, lse, q,
                  sm_scale=1.0, causal=True)


# ---------------------------------------------------------------------------
# the bf16 backward's rounding, emulated on the CPU
# ---------------------------------------------------------------------------

# chip_smoke.py's FLASH_TOL[bf16]["grad"]: the card's bf16 gradients are held
# to atol + rtol * |want| against the plain version run in f32
BF16_GRAD_ATOL, BF16_GRAD_RTOL = 2e-2, 1e-2

# chip_smoke.py's check_flash shapes: (B, T, S, H, KV, D, q_offset, window,
# alibi, dead key range of row 0) — the training shape, and GQA at D = 128
# with a window, ALiBi and rows that see no key
BUDGET_SHAPES = {
    "train": (16, 104, 104, 12, 12, 64, 0, 0, False, None),
    "gqa_window_alibi": (2, 77, 300, 32, 8, 128, 223, 64, True, (200, 290)),
}


def _bf16_case(shape, seed):
    """bf16 operands as chip_smoke.py's check_flash makes them (random left
    padding per row), and the plain forward's lse and delta."""
    B, T, S, H, KV, D, qo, window, alibi, dead = shape
    rs = np.random.RandomState(seed)
    mask = np.ones((B, S), np.float32)
    for b in range(B):
        mask[b, : rs.randint(0, max(S // 4, 1))] = 0.0
    if dead:
        mask[0, dead[0]:dead[1]] = 0.0
    bf = lambda *s: torch.tensor(rs.randn(*s), dtype=torch.float32).to(torch.bfloat16)  # noqa: E731
    q, k, v, do = bf(B, T, H, D), bf(B, S, KV, D), bf(B, S, KV, D), bf(B, T, H, D)
    alibi_args = [None, None, None]
    if alibi:
        kpos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
        qpos = np.arange(T, dtype=np.int32)[None].repeat(B, 0) + qo
        slopes = (2.0 ** (-8.0 * np.arange(1, H + 1) / H)).astype(np.float32)
        alibi_args = [torch.tensor(x) for x in (qpos, kpos, slopes)]
    kw = dict(sm_scale=D ** -0.5, causal=True, q_offset=qo, k_offset=0, window=window)
    f32 = [x.float() for x in (q, k, v)]
    mask = torch.tensor(mask)
    out, lse = flash_fwd(*f32, mask, *alibi_args, **kw)
    delta = (do.float() * out.to(torch.bfloat16).float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, mask, alibi_args, lse, delta, do, kw


def _bf16_kernel_emulation(q, k, v, mask, alibi_args, lse, delta, do, kw):
    """``csrc/flash_bwd.cu``'s bf16 arithmetic in plain torch: bf16
    operands, f32 products and sums; ``p`` enters ``dv = p^T do`` as a bf16
    high half plus a bf16 low half, ``ds`` enters ``dk`` and ``dq`` rounded
    to bf16 once; sm_scale applied to ``s`` in f32 and to ``dk``/``dq`` at
    the end; the gradients rounded to bf16."""
    from trlx_tpu_torch.ops.flash_attention import _visible

    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    g = H // KV
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    krep, vrep = (torch.repeat_interleave(x, g, dim=2) for x in (kf, vf))
    s = torch.einsum("bthd,bshd->bhts", qf, krep) * kw["sm_scale"]
    qpos, kpos, slopes = alibi_args
    if slopes is not None:
        s = s + slopes[None, :, None, None] * (kpos[:, None, :] - qpos[:, :, None]).float()[:, None]
    vis = _visible(mask, T, S, kw["causal"], kw["q_offset"], kw["k_offset"], kw["window"])
    p = torch.where(vis, torch.exp(torch.where(vis, s, torch.zeros_like(s)) - lse[..., None]),
                    torch.zeros_like(s))
    p_hi = bf(p)
    dv = torch.einsum("bhts,bthd->bshd", p_hi, dof) + torch.einsum(
        "bhts,bthd->bshd", bf(p - p_hi), dof)
    dp = torch.einsum("bthd,bshd->bhts", dof, vrep)
    ds = bf(p * (dp - delta[..., None]))
    dk = torch.einsum("bhts,bthd->bshd", ds, qf) * kw["sm_scale"]
    dq = torch.einsum("bhts,bshd->bthd", ds, krep) * kw["sm_scale"]
    dk = dk.reshape(B, S, KV, g, D).sum(dim=3)
    dv = dv.reshape(B, S, KV, g, D).sum(dim=3)
    return bf(dq), bf(dk), bf(dv)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", sorted(BUDGET_SHAPES))
def test_bf16_backward_rounding_within_the_card_tolerance(shape, seed):
    """The bf16 backward's rounding design, checked before any chip run: its
    emulation stays within the card's bf16 gradient tolerance of the plain
    version run in f32 on the same bf16 operands."""
    q, k, v, mask, alibi_args, lse, delta, do, kw = _bf16_case(BUDGET_SHAPES[shape], 20 + seed)
    got = _bf16_kernel_emulation(q, k, v, mask, alibi_args, lse, delta, do, kw)
    f32 = [x.float() for x in (q, k, v)]
    want = flash_bwd(*f32, mask, *alibi_args, lse, delta, do.float(), **kw)
    for name, gg, w in zip(("dq", "dk", "dv"), got, want):
        excess = (gg - w).abs() - BF16_GRAD_ATOL - BF16_GRAD_RTOL * w.abs()
        assert float(excess.max()) <= 0, f"{shape} {name}: {float((gg - w).abs().max())}"


# chip_smoke.py's FLASH_TOL[bf16]: the card's bf16 out and lse are held to
# these against the plain version run in f32
BF16_OUT_ATOL, BF16_LSE_ATOL = 2e-2, 1e-3


def _bf16_forward_emulation(q, k, v, mask, alibi_args, kw, tile=64):
    """``csrc/flash_fwd.cu``'s bf16 arithmetic in plain torch: bf16
    operands, f32 scores, an online softmax over 64-key tiles; each tile's
    P rounded to bf16 for ``P V``; the output divided by the sum of the
    rounded P, lse from the f32 sum of the unrounded P; out rounded to
    bf16. A row that sees no key gives out 0 and lse ``NEG_INF``."""
    from trlx_tpu_torch.ops.flash_attention import _visible

    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    g = H // KV
    qf = q.float()
    krep, vrep = (torch.repeat_interleave(x.float(), g, dim=2) for x in (k, v))
    s = torch.einsum("bthd,bshd->bhts", qf, krep) * kw["sm_scale"]
    qpos, kpos, slopes = alibi_args
    if slopes is not None:
        s = s + slopes[None, :, None, None] * (kpos[:, None, :] - qpos[:, :, None]).float()[:, None]
    vis = _visible(mask, T, S, kw["causal"], kw["q_offset"], kw["k_offset"], kw["window"])
    s = torch.where(vis, s, torch.full_like(s, -float("inf")))
    m = torch.full((B, H, T, 1), -float("inf"))
    lf, lb = torch.zeros(B, H, T, 1), torch.zeros(B, H, T, 1)
    acc = torch.zeros(B, H, T, D)
    for s0 in range(0, S, tile):
        st = s[..., s0:s0 + tile]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        live = m_new > -float("inf")
        alpha = torch.where(live, torch.exp(m - torch.where(live, m_new, torch.zeros_like(m_new))),
                            torch.ones_like(m))
        p = torch.where(st > -float("inf"), torch.exp(st - torch.where(live, m_new, 0.0)),
                        torch.zeros_like(st))
        pb = bf(p)
        lf = lf * alpha + p.sum(-1, keepdim=True)
        lb = lb * alpha + pb.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhts,bshd->bhtd", pb, vrep[:, s0:s0 + tile])
        m = m_new
    out = torch.where(lb > 0, acc / torch.where(lb > 0, lb, torch.ones_like(lb)),
                      torch.zeros_like(acc))
    lse = torch.where(lf > 0, m + torch.log(torch.where(lf > 0, lf, torch.ones_like(lf))),
                      torch.full_like(lf, NEG_INF))
    return bf(out.transpose(1, 2)), lse[..., 0]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", sorted(BUDGET_SHAPES))
def test_bf16_forward_rounding_within_the_card_tolerance(shape, seed):
    """The bf16 forward's rounding design (bf16 P into P V, the output
    normalised by the rounded P's sum, lse from the f32 sum), checked before
    any chip run: its emulation stays within the card's bf16 out and lse
    tolerances of the f32 JAX forward on the same bf16 operands."""
    q, k, v, mask, alibi_args, _, _, _, kw = _bf16_case(BUDGET_SHAPES[shape], 30 + seed)
    out, lse = _bf16_forward_emulation(q, k, v, mask, alibi_args, kw)
    H = q.shape[2]
    qpos, kpos, slopes = alibi_args
    extra = dict(causal=kw["causal"], q_offset=kw["q_offset"], k_offset=kw["k_offset"],
                 window=kw["window"] or None, sm_scale=kw["sm_scale"])
    if slopes is not None:
        extra.update(q_positions=jnp.asarray(qpos.numpy()), k_positions=jnp.asarray(kpos.numpy()),
                     alibi_slopes=jnp.asarray(slopes.numpy()))
    want, want_lse = jax_attention_reference(
        jnp.asarray(q.float().numpy()), jnp.asarray(_rep(k.float().numpy(), H)),
        jnp.asarray(_rep(v.float().numpy(), H)), jnp.asarray(mask.numpy()), **extra)
    out_err = float(np.abs(out.numpy() - np.asarray(want)).max())
    lse_err = float(np.abs(lse.numpy() - np.asarray(want_lse)).max())
    assert out_err <= BF16_OUT_ATOL, f"{shape} out: {out_err}"
    assert lse_err <= BF16_LSE_ATOL, f"{shape} lse: {lse_err}"
