"""Ring attention (``trlx_tpu_torch/parallel/ring_attention.py``) and the
flash backward's chunk form (``ops/flash_attention.py::
flash_attention_bwd_chunk``) against the JAX package on the CPU.

- the in-process ring against JAX's ``ring_flash_attention`` on the
  conftest's virtual 8-device mesh (``n`` 2 and 4; the Pallas kernels in
  interpret mode), output and the gradients of q, k and v, with left
  padding, ALiBi, a window, GQA and both placements; JAX's own tolerances
  (``tests/test_ring_attention.py``): 3e-5 forward, 1e-4 gradients (5e-4
  where JAX's model-level check uses it: ALiBi with a window);
- ``flash_attention_bwd_chunk``'s plain path against JAX's (interpret
  mode) at nonzero offsets, with the global ``lse`` / ``delta`` of a
  longer sequence, a key-masked row and GQA; a pair wholly in the causal
  future gives exact zeros;
- the process-group transport on two ``gloo`` ranks against the
  in-process one (1e-6), forward and gradients;
- a model forward under a ``sequence`` mesh (the ring hook in
  ``models/transformer.py``) is covered by ``test_torch_parallel_sft.py``.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from trlx_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_bwd_chunk as jax_flash_attention_bwd_chunk,
)
from trlx_tpu.parallel.ring_attention import ring_flash_attention as jax_ring_flash_attention
from trlx_tpu_torch.ops.flash_attention import flash_attention_bwd_chunk
from trlx_tpu_torch.parallel.ring_attention import ring_flash_attention

from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

HERE = os.path.dirname(os.path.abspath(__file__))
FWD_TOL = 3e-5
GRAD_TOL = 1e-4


def _jax_mesh(n):
    devs = np.array(jax.devices()[:n]).reshape(1, 1, 1, n)
    return Mesh(devs, ("data", "fsdp", "model", "sequence"))


def _inputs(B, T, H, KV, D, left_pad, seed):
    rs = np.random.RandomState(seed)
    q, k, v, g = (rs.randn(*s).astype(np.float32)
                  for s in ((B, T, H, D), (B, T, KV, D), (B, T, KV, D), (B, T, H, D)))
    mask = np.ones((B, T), np.float32)
    if left_pad:
        mask[0, :left_pad] = 0.0
        mask[1, : left_pad + 3] = 0.0
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    slopes = (2.0 ** (-8.0 * np.arange(1, H + 1) / H)).astype(np.float32)
    return q, k, v, g, mask, pos, slopes


# (n, placement, left_pad, alibi, window, KV): H is 4, so KV 2 is GQA
RING_CASES = [
    (2, "zigzag", 5, False, None, 2),
    (2, "contiguous", 3, True, 9, 2),
    (4, "auto", 5, True, 11, 2),
]


@pytest.mark.parametrize("n,placement,left_pad,alibi,window,KV", RING_CASES)
def test_ring_matches_jax(n, placement, left_pad, alibi, window, KV):
    B, T, H, D = 2, 32, 4, 8
    q, k, v, g, mask, pos, slopes = _inputs(B, T, H, KV, D, left_pad, seed=n + KV)
    kw = dict(placement=placement, window=window)
    jkw, tkw = dict(kw), dict(kw)
    if alibi:
        jkw.update(q_positions=jnp.asarray(pos), k_positions=jnp.asarray(pos),
                   alibi_slopes=jnp.asarray(slopes))
        tkw.update(q_positions=torch.tensor(pos), k_positions=torch.tensor(pos),
                   alibi_slopes=torch.tensor(slopes))
    mesh = _jax_mesh(n)

    def jax_ring(q, k, v):
        return jax_ring_flash_attention(q, k, v, jnp.asarray(mask), mesh, block_q=8,
                                        block_k=8, interpret=True, **jkw)

    @jax.jit
    def jax_out_and_grads(q, k, v, g):
        out, vjp = jax.vjp(jax_ring, q, k, v)
        return out, vjp(g)

    want, want_grads = jax_out_and_grads(*(jnp.asarray(x) for x in (q, k, v, g)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = ring_flash_attention(tq, tk, tv, torch.tensor(mask), n, **tkw)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(g))
    valid = mask > 0
    np.testing.assert_allclose(out.detach().numpy()[valid], np.asarray(want)[valid],
                               atol=FWD_TOL, rtol=FWD_TOL)
    tol = 5e-4 if alibi and window else GRAD_TOL
    for name, got, w in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=tol, rtol=tol,
                                   err_msg=f"d{name}")


def test_ring_rejects_indivisible_length():
    q, k, v, _, mask, _, _ = _inputs(2, 30, 4, 4, 8, 0, seed=0)
    with pytest.raises(ValueError, match="not divisible"):
        ring_flash_attention(*(torch.tensor(x) for x in (q, k, v, mask)), 4)


def test_ring_size_one_is_one_flash_call():
    q, k, v, _, mask, _, _ = _inputs(2, 16, 4, 2, 8, 5, seed=1)
    out = ring_flash_attention(*(torch.tensor(x) for x in (q, k, v, mask)), 1)
    want = jax_flash_attention(*(jnp.asarray(x) for x in (q, k, v, mask)), block_q=8,
                               block_k=8, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


# (T, S, q_offset, k_offset, alibi, window, KV): chunks of a 3 x 8 = 24-slot
# sequence; the last pair lies wholly in the causal future
CHUNK_CASES = [
    (8, 8, 8, 0, False, 0, 4),
    (8, 8, 16, 8, True, 0, 2),
    (8, 8, 16, 0, False, 6, 2),
    (8, 12, 12, 0, True, 10, 4),
    (8, 8, 0, 16, False, 0, 2),
]


@pytest.mark.parametrize("T,S,q_offset,k_offset,alibi,window,KV", CHUNK_CASES)
def test_bwd_chunk_matches_jax(T, S, q_offset, k_offset, alibi, window, KV):
    rs = np.random.RandomState(T + S + q_offset + k_offset)
    B, H, D = 2, 4, 8
    q, do = (rs.randn(B, T, H, D).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(B, S, KV, D).astype(np.float32) for _ in range(2))
    mask = np.ones((B, S), np.float32)
    mask[0, :3] = 0.0
    mask[1] = 0.0  # every key of row 1 masked: its global lse is NEG_INF
    # the global softmax statistics of a longer sequence: any finite lse
    # where a row sees a key somewhere
    lse = (rs.randn(B, H, T) + 3.0).astype(np.float32)
    lse[1] = -1e30
    delta = rs.randn(B, H, T).astype(np.float32)
    kw = dict(causal=True, q_offset=q_offset, k_offset=k_offset, window=window or None)
    extra_j, extra_t = {}, {}
    if alibi:
        qpos = (np.arange(T)[None].repeat(B, 0) + q_offset).astype(np.int32)
        kpos = (np.arange(S)[None].repeat(B, 0) + k_offset).astype(np.int32)
        slopes = (2.0 ** (-8.0 * np.arange(1, H + 1) / H)).astype(np.float32)
        extra_j = dict(q_positions=jnp.asarray(qpos), k_positions=jnp.asarray(kpos),
                       alibi_slopes=jnp.asarray(slopes))
        extra_t = dict(q_positions=torch.tensor(qpos), k_positions=torch.tensor(kpos),
                       alibi_slopes=torch.tensor(slopes))
    want = jax_flash_attention_bwd_chunk(
        *(jnp.asarray(x) for x in (q, k, v, mask, lse, delta, do)), block_q=8, block_k=8,
        interpret=True, **kw, **extra_j)
    before = flash_attention_bwd_chunk.launches
    got = flash_attention_bwd_chunk(*(torch.tensor(x) for x in (q, k, v, mask, lse, delta,
                                                               do)), **kw, **extra_t)
    assert flash_attention_bwd_chunk.launches == before  # CPU tensors: the plain version
    future = k_offset >= q_offset + T
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        if future:
            assert not g.any(), name  # exact zeros
        assert not g[1].any(), name  # the fully masked row: zeros, not inf
        # f32 sums of a few terms of size ~exp(s - lse)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def test_group_transport_matches_in_process():
    """Two gloo ranks (``tests/torch_ring_worker.py``), each with its
    zigzag shard: the ring's output and gradients equal the in-process
    ring's on the global tensors (1e-6)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([os.path.dirname(HERE),
                                          os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_ring_worker.py"),
                               str(rank), "2", str(port)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for rank in range(2)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            assert out.strip().splitlines()[-1] == "RING_OK", out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
