"""The port's flash attention (``trlx_tpu_torch/ops/flash_attention.py``)
against the JAX package, on the CPU.

On CPU tensors the wrappers run their plain versions, wired through the
same ``torch.autograd.Function`` the kernels use on the card. The forward
(out and lse) is held against JAX ``flash_attention`` (the Pallas kernel in
interpret mode) and ``attention_reference``; the gradients (dq, dk, dv of
``sum(out * cotangent)``) against ``jax.grad`` through the reference.
Cases: causal and not, left-padded masks, q/k slot offsets, GQA (H=4,
KV=2), a sliding window, ALiBi, fully masked rows, T != S and odd lengths.
Tolerance (f32): out and lse ``atol=1e-5``, gradients ``atol=1e-4``.
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
