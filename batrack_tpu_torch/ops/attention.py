"""K2: packed-qkv multi-head attention (csrc/fused_qkv_attention.cu).

Replaces the TPU kernel
batrack_tpu/ops/pallas_attention.py::_fused_qkv_kernel (entry point
fused_qkv_attention). It reads q, k and v straight from the (B, N, 3C)
output of the qkv projection and writes (B, N, C) with the heads merged, so
neither the head split nor the merge is materialised. bf16 input runs on
the tensor cores (mma.sync), float32 input on the float32 pipes. What bounds
it on the H100 and how the kernel is laid out is in the source note of the
.cu file.

On a CUDA tensor `fused_qkv_attention` launches the kernel; on a CPU tensor
it runs the plain version, `fused_qkv_attention_plain`, which the kernel is
held against on the card. The `kv=` variant of the TPU kernel (separate
key/value source, used only by the sharded path) is not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from batrack_tpu_torch.ops import cuda_build

_KERNEL_HEAD_DIM = 48  # the tracker's: hidden 384 over 8 heads


def fused_qkv_attention_plain(qkv: torch.Tensor, heads: int, scale: float,
                              key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K2, one head at a time, the TPU kernel's numerics:
    float32 logits and softmax, masked keys at -1e30, p/s cast to v's dtype
    for the PV product."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // heads
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    for h in range(heads):
        sl = slice(h * hd, (h + 1) * hd)
        q = qkv[..., sl].float()
        k = qkv[..., C:][..., sl].float()
        v = qkv[..., 2 * C:][..., sl]
        logits = (q @ k.transpose(1, 2)) * scale
        if key_mask is not None:
            logits = logits.masked_fill(~key_mask.bool()[None, None, :], -1e30)
        p = torch.exp(logits - logits.amax(-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True)
        out[..., sl] = (p.to(v.dtype) @ v).to(qkv.dtype)
    return out


def fused_qkv_attention(qkv: torch.Tensor, heads: int, scale: float,
                        key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head softmax attention on the packed (B, N, 3C) qkv -> (B, N, C).

    key_mask: optional (N,) bool; False keys are excluded from every
    query's softmax (logit -1e30)."""
    if qkv.device.type == "cpu":
        return fused_qkv_attention_plain(qkv, heads, scale, key_mask)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention: unsupported device {qkv.device}")
    B, N, C3 = qkv.shape
    C = C3 // 3
    if C3 % 3 or C % heads or C // heads != _KERNEL_HEAD_DIM:
        raise ValueError(f"fused_qkv_attention: qkv {tuple(qkv.shape)} with "
                         f"{heads} heads (the kernel's head dim is {_KERNEL_HEAD_DIM})")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_qkv_attention: dtype {qkv.dtype}")
    qkv = qkv.contiguous()
    if qkv.data_ptr() % 16:  # the kernel reads 16-byte rows of K and V
        qkv = qkv.clone()
    mask = None
    if key_mask is not None:
        if key_mask.shape != (N,) or key_mask.device != qkv.device:
            raise ValueError("fused_qkv_attention: key_mask must be (N,) on the qkv device")
        mask = key_mask.to(torch.uint8).contiguous()
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    fn = cuda_build.load("fused_qkv_attention").fused_qkv_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(qkv.data_ptr(), None if mask is None else mask.data_ptr(),
                    out.data_ptr(), B, N, C, heads, float(scale),
                    int(qkv.dtype == torch.bfloat16), stream)
    cuda_build.check(status, "fused_qkv_attention")
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0
