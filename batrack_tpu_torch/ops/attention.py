"""K2, packed-qkv multi-head attention, and K3, single-head attention
(csrc/fused_qkv_attention.cu, one kernel template for both).

K2 replaces the TPU kernel batrack_tpu/ops/pallas_attention.py::
_fused_qkv_kernel (entry point fused_qkv_attention). It reads q, k and v
straight from the (B, N, 3C) output of the qkv projection and writes
(B, N, C) with the heads merged, so neither the head split nor the merge is
materialised. With `kv=` the keys and values come from a separate
(B, Nk, 2C) slim or (B, Nk, 3C) packed source instead: the track-sharded
space attention (parallel/shard_kernels.py) runs this rank's queries
against the key/value lanes gathered from every rank.

K3 replaces ::_attn_kernel (entry point vmem_attention): single-head
softmax(q k^T * scale) v over (B, N, d). The JAX package calls it nowhere;
it is ported so that every Pallas kernel of the repository has a
counterpart.

K4, `flash_attention`, replaces batrack_tpu/tracker/blocks.py::
_tpu_flash_attention, the split-head route to JAX's Pallas TPU flash
attention that `Attention` takes under BATRACK_TPU_ATTN=flash: (B, h, N, d)
with an optional key mask. On the tracker's split views of one packed qkv
it launches the same kernel template as K2, on the views' own rows and
head lanes, with no copy in or out; other layouts are folded into one head
per batch row first.

The kernels take every head dim d that the TPU kernels take on the
tracker's path: a multiple of 8 from 8 to 128 (ModelConfig's hidden_size /
num_heads; 48 at every shipped config). Each d is its own build of the
source, compiled at its first use (ops/cuda_build.py); any other d raises
ValueError on a CUDA tensor before a build or a launch.

bf16 input runs on Hopper's tensor cores (TMA-fed shared-memory ring,
wgmma, 128 queries per block), float32 input on the float32 pipes. The bf16
kernel reads K and V by TMA, so the key and value lanes must start 16-byte
aligned. What bounds the kernels on the H100 and how they are laid out is in
the source note of the .cu file. On a CUDA tensor each wrapper launches the
kernel or raises; on a CPU tensor it runs the plain version
(`fused_qkv_attention_plain`, `vmem_attention_plain`,
`flash_attention_plain`), which the kernel is held against on the card.
The kernels have no backward (nor have the TPU kernels): on the card a
wrapper raises when autograd would record through it, and gradients go
through the plain versions on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from batrack_tpu_torch.ops import cuda_build

KERNEL_HEAD_DIMS = range(8, 129, 8)  # the head dims the kernel is built for


def check_head_dim(d: int, what: str) -> None:
    """Raise ValueError unless the kernel takes head dim d."""
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} (the kernel takes a multiple of 8 "
                         "from 8 to 128)")


def _kv_source(qkv: torch.Tensor, kv: Optional[torch.Tensor]):
    """(source, lane offset of K in it): the packed qkv itself, or a
    separate slim (B, Nk, 2C) or packed (B, Nk, 3C) key/value array."""
    B, _, C3 = qkv.shape
    C = C3 // 3
    if kv is None:
        return qkv, C
    if kv.ndim != 3 or kv.shape[0] != B or kv.shape[-1] not in (2 * C, 3 * C):
        raise ValueError(f"kv {tuple(kv.shape)} must be (B, Nk, 2C) or (B, Nk, 3C) "
                         f"for qkv {tuple(qkv.shape)}")
    return kv, kv.shape[-1] - 2 * C


def _softmax_pv(q, k, v, scale, key_mask):
    """The TPU kernels' numerics for one head: float32 logits and softmax,
    masked keys at -1e30, p cast to v's dtype for the PV product."""
    logits = (q.float() @ k.float().transpose(1, 2)) * scale
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask.bool()[None, None, :], -1e30)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return p.to(v.dtype) @ v


def fused_qkv_attention_plain(qkv: torch.Tensor, heads: int, scale: float,
                              key_mask: Optional[torch.Tensor] = None,
                              kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K2, one head at a time."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // heads
    src, koff = _kv_source(qkv, kv)
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    for h in range(heads):
        sl = slice(h * hd, (h + 1) * hd)
        k = src[..., koff + h * hd: koff + (h + 1) * hd]
        v = src[..., koff + C + h * hd: koff + C + (h + 1) * hd]
        out[..., sl] = _softmax_pv(qkv[..., sl], k, v, scale, key_mask).to(qkv.dtype)
    return out


def _launch(q, k, v, key_mask, out, B, N, Nk, heads, d, q_stride, kv_stride, scale, what):
    """One launch of the attention kernel built for head dim d on base
    pointers and row strides (elements) over contiguous tensors."""
    mask = None
    if key_mask is not None:
        if key_mask.shape != (Nk,) or key_mask.device != out.device:
            raise ValueError(f"{what}: key_mask must be ({Nk},) on {out.device}")
        mask = key_mask.to(torch.uint8).contiguous()
    fn = cuda_build.load("fused_qkv_attention", HEAD_DIM=d).attention_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q, k, v, None if mask is None else mask.data_ptr(), out.data_ptr(),
                    B, N, Nk, heads, q_stride, kv_stride, out.shape[-1], float(scale),
                    int(out.dtype == torch.bfloat16), stream)
    cuda_build.check(status, what)


def _kernel_input(x: torch.Tensor, what: str) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the bf16 kernel's TMA copies need
    16-byte aligned bases and row strides); float32 or bf16 only."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype {x.dtype}")
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def fused_qkv_attention(qkv: torch.Tensor, heads: int, scale: float,
                        key_mask: Optional[torch.Tensor] = None,
                        kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head softmax attention on the packed (B, N, 3C) qkv -> (B, N, C).

    kv: optional separate key/value source, (B, Nk, 2C) slim or (B, Nk, 3C)
    packed (its q third is ignored); queries still come from qkv.
    key_mask: optional (Nk,) bool (Nk = N without kv); False keys are
    excluded from every query's softmax (logit -1e30)."""
    if qkv.device.type == "cpu":
        return fused_qkv_attention_plain(qkv, heads, scale, key_mask, kv)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention: unsupported device {qkv.device}")
    cuda_build.refuse_autograd("fused_qkv_attention", qkv, kv)
    B, N, C3 = qkv.shape
    C = C3 // 3
    if C3 % 3 or C % heads:
        raise ValueError(f"fused_qkv_attention: qkv {tuple(qkv.shape)} with {heads} heads")
    check_head_dim(C // heads, "fused_qkv_attention")
    qkv = _kernel_input(qkv, "fused_qkv_attention")
    src, koff = _kv_source(qkv, kv)
    if kv is not None:
        src = _kernel_input(src, "fused_qkv_attention")
        if src.dtype != qkv.dtype or src.device != qkv.device:
            raise TypeError("fused_qkv_attention: kv must match qkv's dtype and device")
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    row = src.shape[-1]
    base, esize = src.data_ptr(), src.element_size()
    _launch(qkv.data_ptr(), base + koff * esize, base + (koff + C) * esize, key_mask, out,
            B, N, src.shape[1], heads, C // heads, 3 * C, row, scale, "fused_qkv_attention")
    fused_qkv_attention.launches += 1
    if kv is not None:
        fused_qkv_attention.kv_launches += 1
    if key_mask is not None:
        fused_qkv_attention.masked_launches += 1
    return out


fused_qkv_attention.launches = 0         # every launch, packed or kv=
fused_qkv_attention.kv_launches = 0      # launches with a kv= source
fused_qkv_attention.masked_launches = 0  # launches with a key mask


def vmem_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Plain version of K3: float32 logits and softmax, p cast to v's dtype
    for the PV product, output in q's dtype."""
    return _softmax_pv(q, k, v, scale, None).to(q.dtype)


def _one_head(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              key_mask: Optional[torch.Tensor], ndim: int, what: str) -> torch.Tensor:
    """One launch with one head per batch row on (..., N, d) q, k and v of
    `ndim` dims, their leading axes folded into the batch axis: rows of 2d
    (bf16) or 4d (f32) bytes, a multiple of 16, so every base and row stays
    16-byte aligned for the TMA copies. Returns the output in q's shape."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    cuda_build.refuse_autograd(what, q, k, v)
    if not (q.shape == k.shape == v.shape) or q.ndim != ndim:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"(the kernel takes equal {ndim}-d shapes)")
    check_head_dim(q.shape[-1], what)
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise TypeError(f"{what}: q, k and v must share dtype and device")
    N, d = q.shape[-2:]
    q3, k3, v3 = (_kernel_input(x.reshape(-1, N, d), what) for x in (q, k, v))
    out = torch.empty_like(q3)
    _launch(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), key_mask, out, q3.shape[0], N, N, 1,
            d, d, d, scale, what)
    return out.view(q.shape)


def vmem_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   block_q: int = 512) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, N, D) -> (B, N, D), D a head dim
    the kernel takes (`KERNEL_HEAD_DIMS`).

    block_q is the TPU kernel's query tiling; it is accepted and ignored
    (the CUDA kernel tiles queries by 128 in bf16 and float32)."""
    del block_q
    if q.device.type == "cpu":
        return vmem_attention_plain(q, k, v, scale)
    out = _one_head(q, k, v, scale, None, 3, "vmem_attention")
    vmem_attention.launches += 1
    return out


vmem_attention.launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                          key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K4: each (batch, head) row as K3's, with the key mask
    as K2 applies it; output in q's dtype."""
    B, h, N, d = q.shape
    q, k, v = (x.reshape(B * h, x.shape[2], d) for x in (q, k, v))
    return _softmax_pv(q, k, v, scale, key_mask).to(q.dtype).view(B, h, N, d)


def split_row_stride(x: torch.Tensor) -> Optional[int]:
    """R when the (B, h, N, d) tensor x is a head split of rows of R
    elements (strides (N*R, d, R, 1), as the views of one packed qkv are)
    that the kernel can read in place: d a head dim it takes, R a multiple
    of 8 and at least h*d, the base 16-byte aligned (the TMA copies' rule).
    None otherwise."""
    if x.ndim != 4 or x.shape[-1] not in KERNEL_HEAD_DIMS:
        return None
    _, h, N, d = x.shape
    R = x.stride(2)
    if (x.stride() != (N * R, d, R, 1) or R % 8 or R < h * d
            or x.data_ptr() % 16):
        return None
    return R


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Split-head softmax attention, (B, h, N, d) -> (B, h, N, d).

    key_mask: optional (N,) bool; False keys are excluded from every query's
    softmax (logit -1e30), as K2 excludes them. The JAX route assumes at
    least one live key; with none, each query averages the N values.

    When q, k and v are head splits of rows (`split_row_stride`), k and v
    of one row stride, the kernel reads them in place, as K2 reads the
    packed qkv, and writes (B, N, h*d) rows whose (B, h, N, d) view it
    returns: the caller's merge of the heads is then a view too. Any other
    layout is folded into (B*h, N, d) copies first."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, key_mask)
    r_q, r_k, r_v = (split_row_stride(x) for x in (q, k, v))
    if (q.device.type == "cuda" and r_q and r_k and r_k == r_v and q.shape == k.shape == v.shape
            and q.dtype == k.dtype == v.dtype and q.dtype in (torch.float32, torch.bfloat16)
            and q.device == k.device == v.device):
        cuda_build.refuse_autograd("flash_attention", q, k, v)
        B, h, N, d = q.shape
        out = torch.empty((B, N, h * d), dtype=q.dtype, device=q.device)
        _launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask, out, B, N, N, h, d, r_q, r_k,
                scale, "flash_attention")
        flash_attention.strided_launches += 1
        out = out.view(B, N, h, d).permute(0, 2, 1, 3)
    else:
        out = _one_head(q, k, v, scale, key_mask, 4, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0          # every launch
flash_attention.strided_launches = 0  # launches on the split views, no fold copies
