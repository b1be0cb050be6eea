"""trlx_tpu_torch: the PyTorch/CUDA port of ``trlx_tpu``.

The JAX package ``trlx_tpu`` stays the reference; this package mirrors its
layout (``models/``, ``ops/``, ``engine/``, ``serve/``) and imports
``torch``, never ``jax``. Entry points run on the GPU unless the caller
passes ``device="cpu"``. Kernels are hand-written CUDA C++ for Hopper
(``csrc/``), built with ``nvcc`` at first use.

Ported so far: the serving path — GPT-2 on the paged ``ContinuousEngine``
with in-place paged prefill, paged decode and fused sampling kernels,
behind the ``ServeServer`` HTTP frontend.
"""

__version__ = "0.1.0"
