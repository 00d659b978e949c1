"""K1: correlation-window sampling over the whole pyramid (csrc/corr_sample.cu).

Replaces the TPU kernel batrack_tpu/ops/pallas_corr.py::_corr_kernel_multi
(entry point corr_sample_pyramid_pallas). What bounds it on the H100 and how
the kernel is laid out is in the source note of csrc/corr_sample.cu.

The pyramid is packed once per tracker forward (`pack_pyramid`): bf16,
channels-last (S, H_l, W_l, C), all levels in one flat buffer, since it does
not change across the I refinement iterations. `corr_sample` then returns
the track-major (N, S, L*(2r+1)^2) layout the transformer input consumes.
On a CUDA tensor it launches the kernel (one launch for all levels); on a
CPU tensor it runs the plain version, `corr_sample_plain`, which the CUDA
kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch

from batrack_tpu_torch.ops import cuda_build
from batrack_tpu_torch.ops.corr import corr_sample_level


class CorrPyramid(NamedTuple):
    flat: torch.Tensor              # bf16, levels concatenated
    shapes: Tuple[Tuple[int, int], ...]  # (H_l, W_l) per level
    offsets: Tuple[int, ...]        # element offset of each level in flat
    S: int
    C: int

    def level(self, l: int) -> torch.Tensor:
        """Level l as an (S, H_l, W_l, C) view."""
        H, W = self.shapes[l]
        n = self.S * H * W * self.C
        return self.flat[self.offsets[l]: self.offsets[l] + n].view(self.S, H, W, self.C)


def pack_pyramid(pyramid: List[torch.Tensor]) -> CorrPyramid:
    """[(S, C, H_l, W_l)] -> one bf16 channels-last buffer (the precision the
    TPU kernel reads the maps in; the contraction accumulates in f32)."""
    S, C = pyramid[0].shape[:2]
    parts = [fm.permute(0, 2, 3, 1).reshape(-1) for fm in pyramid]
    offsets, total = [], 0
    for p in parts:
        offsets.append(total)
        total += p.numel()
    flat = torch.cat(parts).to(torch.bfloat16)
    shapes = tuple((fm.shape[2], fm.shape[3]) for fm in pyramid)
    return CorrPyramid(flat, shapes, tuple(offsets), S, C)


def corr_sample_plain(pyr: CorrPyramid, targets: torch.Tensor,
                      coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain version of K1: ops.corr sampling on the bf16 maps in float32.

    targets (N, S, C) f32, coords (S, N, 2) at level-0 resolution ->
    (N, S, L*(2r+1)^2) f32."""
    t_snc = targets.float().transpose(0, 1)
    outs = []
    for l in range(len(pyr.shapes)):
        fm = pyr.level(l).float().permute(0, 3, 1, 2)  # (S, C, H, W)
        outs.append(corr_sample_level(fm, t_snc, coords.float() / (2.0 ** l), radius))
    return torch.cat(outs, dim=-1).transpose(0, 1)


def corr_sample(pyr: CorrPyramid, targets: torch.Tensor, coords: torch.Tensor,
                radius: int) -> torch.Tensor:
    """Correlation windows of all levels, (N, S, L*(2r+1)^2) float32."""
    if pyr.flat.device.type == "cpu":
        return corr_sample_plain(pyr, targets, coords, radius)
    N, S, C = targets.shape
    L = len(pyr.shapes)
    if pyr.flat.device.type != "cuda":
        raise ValueError(f"corr_sample: unsupported device {pyr.flat.device}")
    if (targets.dtype != torch.float32 or coords.dtype != torch.float32
            or pyr.flat.dtype != torch.bfloat16):
        raise TypeError("corr_sample: needs f32 targets/coords and a bf16 pyramid")
    if (C != pyr.C or S != pyr.S or coords.shape != (S, N, 2)
            or C != 128 or L > 8 or radius < 0):
        raise ValueError(
            f"corr_sample: shapes targets {tuple(targets.shape)}, coords "
            f"{tuple(coords.shape)}, pyramid S={pyr.S} C={pyr.C} L={L} r={radius} "
            "(the kernel takes C = 128, the tracker's latent width, and L <= 8)")
    targets = targets.contiguous()
    coords = coords.contiguous()
    if not (targets.device == coords.device == pyr.flat.device):
        raise ValueError("corr_sample: inputs on different devices")
    d = 2 * radius + 1
    out = torch.empty((N, S, L * d * d), dtype=torch.float32, device=targets.device)
    lib = cuda_build.load("corr_sample")
    fn = lib.corr_sample_pyramid
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    offs = (ctypes.c_longlong * L)(*pyr.offsets)
    hs = (ctypes.c_int * L)(*[h for h, _ in pyr.shapes])
    ws = (ctypes.c_int * L)(*[w for _, w in pyr.shapes])
    with torch.cuda.device(targets.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(pyr.flat.data_ptr(), targets.data_ptr(), coords.data_ptr(),
                    out.data_ptr(), N, S, C, L, radius, offs, hs, ws, stream)
    cuda_build.check(status, "corr_sample")
    corr_sample.launches += 1
    return out


corr_sample.launches = 0
