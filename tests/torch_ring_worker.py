"""One rank of the two-rank ring drill of ``tests/test_torch_ring_attention.py``.

``python tests/torch_ring_worker.py <rank> <world> <port>``: joins a gloo
group at ``tcp://127.0.0.1:<port>``, draws the global q, k, v, key mask,
ALiBi positions and output cotangent from one seed, runs the ring's
process-group transport on this rank's zigzag shard (GQA, left padding,
ALiBi, a window) and the in-process ring on the global tensors, and
prints ``RING_OK`` when this rank's output and gradients equal its shard
of the in-process ones to 1e-6. Imports torch and the port only.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from trlx_tpu_torch.parallel.ring_attention import (
    ring_flash_attention,
    ring_flash_attention_group,
    zigzag_order,
)

TOL = 1e-6


def main(rank: int, world: int, port: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        B, T, H, KV, D = 2, 32, 4, 2, 8
        rs = np.random.RandomState(0)
        q, g = (torch.tensor(rs.randn(B, T, H, D).astype(np.float32)) for _ in range(2))
        k, v = (torch.tensor(rs.randn(B, T, KV, D).astype(np.float32)) for _ in range(2))
        mask = torch.ones(B, T)
        mask[0, :5] = 0.0
        pos = torch.clamp(torch.cumsum(mask, 1) - 1, min=0).to(torch.int32)
        slopes = torch.tensor([0.5, 0.25, 0.125, 0.0625])
        kw = dict(alibi_slopes=slopes, window=11)

        gq, gk, gv = (x.clone().requires_grad_(True) for x in (q, k, v))
        want = ring_flash_attention(gq, gk, gv, mask, world, q_positions=pos,
                                    k_positions=pos, **kw)
        want_grads = torch.autograd.grad(want, (gq, gk, gv), g)

        mine = torch.as_tensor(zigzag_order(T, world).reshape(world, -1)[rank],
                               dtype=torch.int64)
        lq, lk, lv = (x[:, mine].clone().requires_grad_(True) for x in (q, k, v))
        out = ring_flash_attention_group(lq, lk, lv, mask[:, mine], dist.group.WORLD,
                                         q_positions=pos[:, mine], k_positions=pos[:, mine],
                                         **kw)
        grads = torch.autograd.grad(out, (lq, lk, lv), g[:, mine])
        errs = [float((out - want[:, mine]).abs().max())]
        errs += [float((a - b[:, mine]).abs().max()) for a, b in zip(grads, want_grads)]
        if max(errs) > TOL:
            raise AssertionError(f"rank {rank}: the group ring differs by {errs}")
        print("RING_OK", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
