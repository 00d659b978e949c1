"""Sampling, embeddings, correlation and attention ops.

corr_kernel (K1 and its int8 and mxu variants) and attention (K2, K3,
K4) wrap hand-written CUDA kernels; on
CPU tensors they run their plain PyTorch versions.
"""

from batrack_tpu_torch.ops import attention, corr, corr_kernel, embeddings, sampling

__all__ = ["attention", "corr", "corr_kernel", "embeddings", "sampling"]
