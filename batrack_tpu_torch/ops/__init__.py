"""Sampling, embeddings, correlation and attention ops.

corr_kernel (K1 and its int8 and mxu variants) and attention (K2, K3,
K4) wrap hand-written CUDA kernels; on
CPU tensors they run their plain PyTorch versions.
"""

from batrack_tpu_torch.ops import attention, corr, corr_kernel, embeddings, sampling

__all__ = ["attention", "corr", "corr_kernel", "embeddings", "sampling", "launch_counts"]


def launch_counts() -> dict:
    """Every kernel's launch counter: K1, its mxu and int8 options, K2 (all
    launches, and those with a kv= source), K3 and K4. The plain versions
    count nothing."""
    a, c = attention, corr_kernel.corr_sample
    return {"corr_sample": c.launches, "corr_sample_mxu": c.mxu_launches,
            "corr_sample_int8": c.int8_launches,
            "fused_qkv_attention": a.fused_qkv_attention.launches,
            "fused_qkv_attention_kv": a.fused_qkv_attention.kv_launches,
            "vmem_attention": a.vmem_attention.launches,
            "flash_attention": a.flash_attention.launches}
