"""Shared cases of the tensor-parallel tests (``tests/test_torch_tensor_parallel.py``
on the CPU, ``tests/test_torch_kernels_cuda.py`` on the card). Imports no
JAX.

- :class:`ThreadGroup` / :func:`run_ranks`: an in-process stand-in for the
  ``model`` group — one thread per rank, the collectives that
  ``trlx_tpu_torch/parallel/tensor_parallel.py`` calls done by exchanging
  tensors between the threads;
- :func:`engine_tokens`: greedy rows through the paged
  ``ContinuousEngine`` (the kernels' wrappers on every span and step) of a
  model, whole or cut to one rank's share.
"""

import threading

import numpy as np
import torch

from trlx_tpu_torch.engine.core import ContinuousEngine
from trlx_tpu_torch.ops.paged_kv import PagedSpec, num_table_blocks
from trlx_tpu_torch.ops.sampling import GenerationConfig
from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns
from trlx_tpu_torch.parallel import tensor_parallel as tpm

# the engine case: a value-head GPT-NeoX test model with a 260-token
# vocabulary (its embedding, LM head and heads split at model 2)
ENGINE_SPEC, ENGINE_OVERRIDES = "builtin:gptneox-test", dict(vocab_size=260)
SLOTS, PROMPT, NEW, BLOCK, PAD = 4, 12, 6, 4, 0


class ThreadGroup:
    """The collectives ``tensor_parallel`` calls, over ``n`` threads."""

    ReduceOp = torch.distributed.ReduceOp

    def __init__(self, n):
        self.n, self.barrier, self.slots = n, threading.Barrier(n), [None] * n
        self.me = threading.local()

    def _exchange(self, t):
        self.slots[self.me.rank] = t.detach().clone()
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out

    def all_reduce(self, t, op=None, group=None):
        parts = self._exchange(t)
        if op == self.ReduceOp.MAX:
            res = torch.stack(parts).amax(0)
        else:
            res = parts[0].clone()
            for p in parts[1:]:
                res += p
        t.copy_(res)

    def all_gather_into_tensor(self, out, t, group=None):
        out.copy_(torch.cat(self._exchange(t), 0))


def run_ranks(n, fn, monkeypatch):
    """``fn(tp)`` on ``n`` thread ranks; their results in rank order."""
    group = ThreadGroup(n)
    monkeypatch.setattr(tpm, "dist", group)
    out, errors = [None] * n, []

    def body(r):
        group.me.rank = r
        torch.set_num_threads(1)
        try:
            out[r] = fn(tpm.TensorParallel(group, n, r))
        except BaseException as e:  # surfaced below
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors:
        raise errors[0]
    return out


def engine_prompts(vocab, rows=6, seed=5):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, vocab, size=(rows, PROMPT))
    mask = np.ones_like(ids)
    for i in range(rows):  # left padding of different widths
        mask[i, : i % 4] = 0
        ids[i, : i % 4] = PAD
    return ids, mask


def engine_tokens(model, cfg, device, ids, mask):
    """Greedy rows of ``ids`` through a paged engine of :data:`SLOTS` slots
    on ``device`` (the kernels' wrappers for prefill, decode and the
    sampler): ``{row: tokens}``."""
    config = GenerationConfig(max_new_tokens=NEW, eos_token_id=-1, pad_token_id=PAD,
                              do_sample=False)
    blocks = 1 + 2 * SLOTS * num_table_blocks(PROMPT + NEW, BLOCK)
    fns = make_slot_refill_fns(cfg, SLOTS, PROMPT, config, segment_len=3,
                               paged=PagedSpec(BLOCK, blocks), device=device)
    engine = ContinuousEngine(fns, model, PAD)
    engine.enqueue_prompts(ids, mask, np.arange(len(ids)), metas=list(range(len(ids))))
    out = {}
    while engine.busy:
        for c in engine.step():
            out[c.meta] = np.asarray(c.tokens[: int(np.sum(c.mask))])
    return out
