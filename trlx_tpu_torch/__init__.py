"""trlx_tpu_torch: the PyTorch/CUDA port of ``trlx_tpu``.

The JAX package ``trlx_tpu`` stays the reference; this package mirrors its
layout (``models/``, ``ops/``, ``engine/``, ``serve/``) and imports
``torch``, never ``jax``. Entry points run on the GPU unless the caller
passes ``device="cpu"``. Kernels are hand-written CUDA C++ for Hopper
(``csrc/``), built with ``nvcc`` at first use.

Ported so far:

- the serving path — GPT-2 on the paged ``ContinuousEngine`` with in-place
  paged prefill, paged decode and fused sampling kernels, behind the
  ``ServeServer`` HTTP frontend;
- online PPO through :func:`train` (``trlx.py``) — rollouts on that engine,
  scoring and training on the flash-attention forward and backward
  kernels, the loss on the fused PPO loss kernels;
- speculative PPO rollouts (``engine.speculative``);
- offline training through ``train(samples=...)``: SFT, and ILQL with
  ``rewards=...`` — training on the flash-attention kernels, evaluation
  on the paged engine (ILQL through its advantage-shaped sampling hook);
- GRPO, the Mixtral MoE MLP, and preference learning: DPO through
  ``train(samples=triples)``, the pairwise reward model
  (``models/reward.py``) and LoRA through ``model.peft_kwargs``.
"""

__version__ = "0.2.0"


def train(*args, **kwargs):
    """``trlx_tpu_torch.trlx.train`` (imported on first call)."""
    from trlx_tpu_torch.trlx import train as _train

    return _train(*args, **kwargs)
