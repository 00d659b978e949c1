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
wgmma, 128 queries per block). float32 input runs on the same pipeline as
three-term bf16 products: on the H100 the six bf16 products of a
float32-accurate QK^T and PV bound it, at 40 % of the time the float32
pipes would take. So each float32 call is two launches: `split_terms`
writes the q, k and v rows it reads in place as three bf16 terms each
(t1 = bf16(x), t2 = bf16(x - t1), t3 = bf16(x - t1 - t2)), and the kernel
sums the products of the term pairs of order <= 2 in float32, for QK^T
and, after splitting the probabilities the same way in registers, for PV.
The kernels read q, k and v by TMA, so their lanes must start 16-byte
aligned. What bounds the kernels on the H100 and how they are laid out is in
the source note of the .cu file. On a CUDA tensor each wrapper launches the
kernel (in float32 the split pass, then the kernel) or raises; on a CPU
tensor it runs the plain version (`fused_qkv_attention_plain`,
`vmem_attention_plain`, `flash_attention_plain`, `split_terms_plain`),
which the kernel is held against on the card.
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


def split_terms_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the split pass: (3, *x.shape) bf16 terms of the
    float32 x, t1 = bf16(x), t2 = bf16(x - t1), t3 = bf16(x - t1 - t2), each
    rounded to nearest even (both differences are exact in float32). The
    terms sum to x within float32 rounding."""
    x = x.float()
    t1 = x.to(torch.bfloat16)
    r = x - t1.float()
    t2 = r.to(torch.bfloat16)
    return torch.stack([t1, t2, (r - t2.float()).to(torch.bfloat16)])


def split_terms(*rows: torch.Tensor, head_dim: int = 48):
    """The three-term split (`split_terms_plain`) of up to three float32
    row sets in one launch: each a 2-D (rows, lanes) view whose rows are
    `stride(0)` elements apart, read in place (the lanes of a packed qkv,
    a kv= source or K4's split views need no copy). Returns a contiguous
    (3, rows, lanes) bf16 tensor for each.

    On the card each view needs lanes a multiple of 8, a row stride a
    multiple of 4 and a 16-byte aligned start. The pass is compiled into
    every head-dim build of the attention source; `head_dim` names the
    build to launch it from (the attention wrappers pass their own, so no
    other build is made). On CPU tensors it runs the plain version."""
    if not 1 <= len(rows) <= 3:
        raise ValueError(f"split_terms: 1 to 3 row sets, not {len(rows)}")
    if all(x.device.type == "cpu" for x in rows):
        return tuple(split_terms_plain(x) for x in rows)
    for x in rows:
        if x.device.type != "cuda" or x.device != rows[0].device or x.dtype != torch.float32:
            raise TypeError(f"split_terms: float32 rows on one CUDA device, not {x.dtype} on "
                            f"{x.device}")
        if (x.ndim != 2 or x.stride(1) != 1 or x.shape[1] % 8 or x.stride(0) % 4
                or x.stride(0) < x.shape[1] or x.data_ptr() % 16):
            raise ValueError(f"split_terms: rows {tuple(x.shape)} with strides {x.stride()}, "
                             f"start {x.data_ptr() % 16} bytes past 16-byte alignment (the kernel "
                             "takes 2-D rows: lanes a multiple of 8, a row stride a multiple of 4 "
                             "and at least the lanes, a 16-byte aligned start)")
    outs = tuple(torch.empty((3, *x.shape), dtype=torch.bfloat16, device=x.device) for x in rows)
    n = len(rows)
    fn = cuda_build.load("fused_qkv_attention", HEAD_DIM=head_dim).split_terms_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    def array(ctype, values):
        return (ctype * n)(*values)

    with torch.cuda.device(rows[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(array(ctypes.c_void_p, [x.data_ptr() for x in rows]),
                    array(ctypes.c_void_p, [t.data_ptr() for t in outs]),
                    array(ctypes.c_longlong, [x.shape[0] for x in rows]),
                    array(ctypes.c_longlong, [x.stride(0) for x in rows]),
                    array(ctypes.c_int, [x.shape[1] for x in rows]), n, stream)
    cuda_build.check(status, "split_terms")
    split_terms.launches += 1
    return outs


split_terms.launches = 0


def _launch(q, k, v, key_mask, out, B, N, Nk, heads, d, scale, what):
    """One launch of the attention kernel built for head dim d on 2-D row
    views, q (B*N, lanes) and k, v (B*Nk, lanes) of one row stride, whose
    head h is lanes h*d .. h*d+d-1. In float32 their three-term splits are
    made first (`split_terms`, one launch) and the kernel reads those."""
    mask = None
    if key_mask is not None:
        if key_mask.shape != (Nk,) or key_mask.device != out.device:
            raise ValueError(f"{what}: key_mask must be ({Nk},) on {out.device}")
        mask = key_mask.to(torch.uint8).contiguous()
    if out.dtype == torch.float32:
        q, k, v = (t[0] for t in split_terms(q, k, v, head_dim=d))
    fn = cuda_build.load("fused_qkv_attention", HEAD_DIM=d).attention_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if mask is None else mask.data_ptr(), out.data_ptr(),
                    B, N, Nk, heads, q.stride(0), k.stride(0), out.shape[-1], float(scale),
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
    Nk = src.shape[1]
    rows = src.view(B * Nk, src.shape[-1])
    _launch(qkv.view(B * N, 3 * C)[:, :C], rows[:, koff:koff + C], rows[:, koff + C:koff + 2 * C],
            key_mask, out, B, N, Nk, heads, C // heads, scale, "fused_qkv_attention")
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
    _launch(q3.view(-1, d), k3.view(-1, d), v3.view(-1, d), key_mask, out, q3.shape[0], N, N, 1,
            d, scale, what)
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
        q2, k2, v2 = (torch.as_strided(x, (B * N, h * d), (r, 1))
                      for x, r in ((q, r_q), (k, r_k), (v, r_k)))
        _launch(q2, k2, v2, key_mask, out, B, N, N, h, d, scale, "flash_attention")
        flash_attention.strided_launches += 1
        out = out.view(B, N, h, d).permute(0, 2, 1, 3)
    else:
        out = _one_head(q, k, v, scale, key_mask, 4, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0          # every launch
flash_attention.strided_launches = 0  # launches on the split views, no fold copies
