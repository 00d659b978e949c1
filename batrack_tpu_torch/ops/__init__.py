"""Sampling, embeddings, correlation and attention ops.

corr_kernel (K1) and attention (K2) wrap hand-written CUDA kernels; on CPU
tensors they run their plain PyTorch versions.
"""

from batrack_tpu_torch.ops import attention, corr, corr_kernel, embeddings, sampling

__all__ = ["attention", "corr", "corr_kernel", "embeddings", "sampling"]
