"""PyTorch ops of the port: sampling, the paged KV layout, and the
paged-attention / fused-sampling wrappers over the CUDA kernels in
``trlx_tpu_torch/csrc/``."""
