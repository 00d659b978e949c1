"""K1: correlation-window sampling over the whole pyramid (csrc/corr_sample.cu).

Replaces the TPU kernel batrack_tpu/ops/pallas_corr.py::_corr_kernel_multi
(entry point corr_sample_pyramid_pallas). What bounds it on the H100 and how
the kernel is laid out is in the source note of csrc/corr_sample.cu.

The pyramid is packed once per tracker forward (`pack_pyramid`):
channels-last (S, H_l, W_l, C), all levels in one flat buffer, since it does
not change across the I refinement iterations. `corr_sample` then returns
the track-major (N, S, L*(2r+1)^2) layout the transformer input consumes.
On a CUDA tensor it launches the kernel (one launch for all levels); on a
CPU tensor it runs the plain version, `corr_sample_plain`, which the CUDA
kernel is held against on the card. The kernel has no backward (nor has
the TPU kernel): on the card the wrapper raises when autograd would record
through it.

The kernel keeps a level's map of one frame in shared memory when it fits
(`resident_levels`: the coarse levels) and streams the windows of the
others by TMA; the choice is made here from the shapes, and the tensor maps
of a packed pyramid are encoded once (`_plan`, keyed by the buffer's
address and shapes, which is all a map encodes) and reused by its calls.

The TPU kernel's two options are two more instantiations of the same
kernel, on the same pipeline and plan, each with its own entry point:
  * fmap_dtype="int8" (pack_pyramid): each level quantised to symmetric
    int8 with the scale amax/127, computed in the pyramid's own dtype as
    pallas_corr.py::_pad_fmap does; one byte per channel through the same
    TMA boxes, the values converted to bf16 exactly for the tensor cores,
    and the scale folded into 1/sqrt(C);
  * contract="mxu" (corr_sample): the target rounded to bf16, one term on
    the tensor cores instead of three, f32 accumulation.
Each route counts its own launches: `corr_sample.launches` (bf16 maps,
float32 contraction, the tracker's), `.mxu_launches`, `.int8_launches`.
No config of either package selects the options; scripts/torch_corr_ab.py
does, as scripts/corr_ab.py does for the TPU kernel.

Every route takes the widths the Pallas function takes: radius 1 to 4, C
64, 128 or 256 channels, up to 8 levels (the tracker's are radius 3 and C
128). Each (radius, C) is its own build of the source, compiled at its
first use (ops/cuda_build.py); any other width raises ValueError on a CUDA
tensor before a build or a launch.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from batrack_tpu_torch.ops import cuda_build
from batrack_tpu_torch.ops.corr import corr_sample_level

FMAP_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}
CONTRACTS = ("vpu", "mxu")

# The kernel's widths and layout (csrc/corr_sample.cu): the window radii
# and channel counts it is built for, the levels one launch takes, a
# block's shared memory on the H100, and the work per block.
KERNEL_RADII = range(1, 5)
KERNEL_CHANNELS = (64, 128, 256)
MAX_LEVELS = 8
SMEM_LIMIT = 232448
RES_CHUNK = 256     # tracks per block of a resident level (one frame's map)
STREAM_CHUNK = 128  # windows per block of a streamed level
_PLAN_CACHE = 16    # packed pyramids whose tensor maps are kept
# the launch of each route: entry point, launch counter, what an error names
_ROUTES = {("bf16", "vpu"): ("corr_sample_pyramid", "launches", "corr_sample"),
           ("bf16", "mxu"): ("corr_sample_pyramid_mxu", "mxu_launches", "corr_sample (mxu)"),
           ("int8", "vpu"): ("corr_sample_pyramid_int8", "int8_launches",
                             "corr_sample (int8 maps)")}


def check_widths(radius: int, C: int, L: int) -> None:
    """Raise ValueError unless the kernel takes this radius, channel count
    and number of levels."""
    if radius not in KERNEL_RADII or C not in KERNEL_CHANNELS or not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"corr_sample: radius {radius}, C {C}, {L} levels (the kernel takes "
                         f"radius 1 to 4, C in {KERNEL_CHANNELS} and 1 to {MAX_LEVELS} levels)")


def resident_map_bytes(h: int, w: int, C: int = 128, elem_bytes: int = 2) -> int:
    """Shared memory of one frame's (h, w, C) map held by a block: its
    taps' C * elem_bytes bytes cut into 128-byte rows (C/64 sections of 64
    bf16 channels, or C/128 of 128 int8 ones, at least one: int8 maps at C
    64 fill half of each row), each section h*w rows rounded up to 1024
    bytes (the 128-byte swizzle's period)."""
    section = h * w * 128
    return max(1, C * elem_bytes // 128) * (-(-section // 1024) * 1024)


def resident_levels(shapes, C: int = 128, elem_bytes: int = 2, radius: int = 3,
                    reserve: Optional[int] = None) -> Tuple[bool, ...]:
    """Per level (h, w): whether the kernel keeps one frame's map in shared
    memory. It must fit beside the kernel's reserve, and measure at most
    256 x 256 (one TMA box per section). The other levels are streamed.
    The reserve is the (radius, C) build's own (corr_extra_bytes(): 3072
    bytes at radius 3), read from the library unless it is given."""
    if reserve is None:
        check_widths(radius, C, len(shapes))
        reserve = _library(radius, C).corr_extra_bytes()
    return tuple(h <= 256 and w <= 256
                 and resident_map_bytes(h, w, C, elem_bytes) + reserve <= SMEM_LIMIT
                 for h, w in shapes)


class CorrPyramid(NamedTuple):
    flat: torch.Tensor              # bf16 or int8, levels concatenated
    shapes: Tuple[Tuple[int, int], ...]  # (H_l, W_l) per level
    offsets: Tuple[int, ...]        # element offset of each level in flat
    S: int
    C: int
    scales: Optional[torch.Tensor] = None  # int8: (L,) float32 dequantisation scales

    def level(self, l: int) -> torch.Tensor:
        """Level l as an (S, H_l, W_l, C) view."""
        H, W = self.shapes[l]
        n = self.S * H * W * self.C
        return self.flat[self.offsets[l]: self.offsets[l] + n].view(self.S, H, W, self.C)


def _quantise(fm: torch.Tensor):
    """pallas_corr.py::_pad_fmap's int8 branch, in fm's own dtype: amax over
    the whole level, round half to even of fm * (127 / amax), clamp to
    +-127. Returns (int8 values, scale amax / 127 as a float32 0-d tensor)."""
    amax = fm.abs().amax().clamp_min(1e-12)
    q = torch.round(fm * (127.0 / amax)).clamp(-127, 127).to(torch.int8)
    return q, (amax / 127.0).float()


def pack_pyramid(pyramid: List[torch.Tensor], fmap_dtype: str = "bf16") -> CorrPyramid:
    """[(S, C, H_l, W_l)] -> one channels-last buffer: bf16 (the precision
    the TPU kernel reads the maps in; the contraction accumulates in f32),
    or int8 with per-level scales kept on the maps' device."""
    if fmap_dtype not in FMAP_DTYPES:
        raise ValueError(f"pack_pyramid: fmap_dtype {fmap_dtype!r}, not one of {list(FMAP_DTYPES)}")
    S, C = pyramid[0].shape[:2]
    scales = None
    if fmap_dtype == "int8":
        quantised = [_quantise(fm) for fm in pyramid]
        pyramid = [q for q, _ in quantised]
        scales = torch.stack([s for _, s in quantised])
    parts = [fm.permute(0, 2, 3, 1).reshape(-1) for fm in pyramid]
    offsets, total = [], 0
    for p in parts:
        offsets.append(total)
        total += p.numel()
    flat = torch.cat(parts).to(FMAP_DTYPES[fmap_dtype])
    shapes = tuple((fm.shape[2], fm.shape[3]) for fm in pyramid)
    return CorrPyramid(flat, shapes, tuple(offsets), S, C, scales)


def _check_options(pyr: CorrPyramid, contract: str) -> None:
    if contract not in CONTRACTS:
        raise ValueError(f"corr_sample: contract {contract!r}, not one of {list(CONTRACTS)}")
    if contract == "mxu" and pyr.scales is not None:
        raise ValueError("corr_sample: int8 maps take only the vpu contraction "
                         "(as pallas_corr.py asserts)")


def corr_sample_plain(pyr: CorrPyramid, targets: torch.Tensor, coords: torch.Tensor,
                      radius: int, contract: str = "vpu") -> torch.Tensor:
    """Plain version of K1: ops.corr sampling on the packed maps in float32.

    targets (N, S, C) f32, coords (S, N, 2) at level-0 resolution ->
    (N, S, L*(2r+1)^2) f32. contract="mxu" rounds the targets to bf16 first;
    int8 maps multiply as float32 and take their level's scale."""
    _check_options(pyr, contract)
    t = targets.float()
    if contract == "mxu":
        t = t.to(torch.bfloat16).float()
    t_snc = t.transpose(0, 1)
    outs = []
    for l in range(len(pyr.shapes)):
        fm = pyr.level(l).float().permute(0, 3, 1, 2)  # (S, C, H, W)
        out = corr_sample_level(fm, t_snc, coords.float() / (2.0 ** l), radius)
        outs.append(out if pyr.scales is None else out * pyr.scales[l])
    return torch.cat(outs, dim=-1).transpose(0, 1)


def corr_sample(pyr: CorrPyramid, targets: torch.Tensor, coords: torch.Tensor,
                radius: int, contract: str = "vpu") -> torch.Tensor:
    """Correlation windows of all levels, (N, S, L*(2r+1)^2) float32."""
    _check_options(pyr, contract)
    if pyr.flat.device.type == "cpu":
        return corr_sample_plain(pyr, targets, coords, radius, contract)
    N, S, C = targets.shape
    L = len(pyr.shapes)
    if pyr.flat.device.type != "cuda":
        raise ValueError(f"corr_sample: unsupported device {pyr.flat.device}")
    cuda_build.refuse_autograd("corr_sample", pyr.flat, targets, coords)
    if (targets.dtype != torch.float32 or coords.dtype != torch.float32
            or pyr.flat.dtype not in (torch.bfloat16, torch.int8)):
        raise TypeError("corr_sample: needs f32 targets/coords and a bf16 or int8 pyramid")
    if C != pyr.C or S != pyr.S or coords.shape != (S, N, 2):
        raise ValueError(
            f"corr_sample: shapes targets {tuple(targets.shape)}, coords "
            f"{tuple(coords.shape)}, pyramid S={pyr.S} C={pyr.C} L={L}")
    check_widths(radius, C, L)
    int8 = pyr.flat.dtype == torch.int8
    if int8 and (pyr.scales is None or pyr.scales.shape != (L,)
                 or pyr.scales.dtype != torch.float32):
        raise ValueError("corr_sample: int8 maps need (L,) float32 scales")
    targets = targets.contiguous()
    coords = coords.contiguous()
    devices = {targets.device, coords.device, pyr.flat.device}
    if int8:
        devices.add(pyr.scales.device)
    if len(devices) != 1:
        raise ValueError("corr_sample: inputs on different devices")
    out = torch.empty((N, S, L * (2 * radius + 1) ** 2), dtype=torch.float32,
                      device=targets.device)
    lib = _library(radius, C)
    entry, counter, what = _ROUTES["int8" if int8 else "bf16", contract]
    args = [_plan(lib, pyr, radius), targets.data_ptr(), coords.data_ptr(), out.data_ptr()]
    if int8:
        args.append(pyr.scales.data_ptr())  # read by the kernel on the same stream
    with torch.cuda.device(targets.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, entry)(*args, N, radius, RES_CHUNK, STREAM_CHUNK, stream)
    cuda_build.check(status, what)
    setattr(corr_sample, counter, getattr(corr_sample, counter) + 1)
    return out


def blocks_per_sm(pyr: CorrPyramid, contract: str = "vpu", radius: int = 3) -> int:
    """Blocks of the kernel that one SM holds at once for this packed (CUDA)
    pyramid's launch at this radius: its shared memory and registers allow."""
    _check_options(pyr, contract)
    check_widths(radius, pyr.C, len(pyr.shapes))
    lib = _library(radius, pyr.C)
    with torch.cuda.device(pyr.flat.device):
        n = lib.corr_sample_blocks_per_sm(_plan(lib, pyr, radius), int(contract == "mxu"))
    if n < 0:
        raise RuntimeError("corr_sample: occupancy query failed")
    return n


_libs: Dict[Tuple[int, int], ctypes.CDLL] = {}
_plans: "OrderedDict[tuple, ctypes.Array]" = OrderedDict()


def _library(radius: int, C: int) -> ctypes.CDLL:
    """csrc/corr_sample.cu built for (radius, C) at first use, its entry
    points typed once."""
    lib = _libs.get((radius, C))
    if lib is None:
        lib = cuda_build.load("corr_sample", RADIUS=radius, C=C)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tables = [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(i32), ctypes.POINTER(i32)]
        for query in (lib.corr_plan_bytes, lib.corr_extra_bytes):
            query.restype = i32
            query.argtypes = []
        lib.corr_sample_plan.restype = i32
        lib.corr_sample_plan.argtypes = [ptr, ptr, i32, i32, i32, *tables, ctypes.POINTER(i32),
                                         i32]
        lib.corr_sample_blocks_per_sm.restype = i32
        lib.corr_sample_blocks_per_sm.argtypes = [ptr, i32]
        for entry, _, _ in _ROUTES.values():
            fn = getattr(lib, entry)
            fn.restype = i32
            fn.argtypes = [ptr] * (5 if entry.endswith("int8") else 4) + [i32] * 4 + [ptr]
        _libs[radius, C] = lib
    return lib


def _level_tables(pyr: CorrPyramid):
    """The level offsets, heights and widths as C arrays."""
    L = len(pyr.shapes)
    return ((ctypes.c_longlong * L)(*pyr.offsets), (ctypes.c_int * L)(*[h for h, _ in pyr.shapes]),
            (ctypes.c_int * L)(*[w for _, w in pyr.shapes]))


def _plan(lib: ctypes.CDLL, pyr: CorrPyramid, radius: int) -> ctypes.Array:
    """The tensor maps of the build for `radius` for a packed pyramid,
    encoded on its first call and reused by the next ones. A map encodes
    only the buffer's address, element type, shapes, the window box (from
    the radius) and the residency chosen from them, so the key is exactly
    that: a new pyramid packed at the same address with the same type and
    shapes gets the same maps, and an int8 and a bf16 pyramid, or two radii,
    never share them."""
    key = (pyr.flat.device.index, pyr.flat.data_ptr(), pyr.flat.dtype, pyr.S, pyr.C, pyr.shapes,
           radius)
    plan = _plans.get(key)
    if plan is not None:
        _plans.move_to_end(key)
        return plan
    L = len(pyr.shapes)
    if any(h < 1 or w < 1 for h, w in pyr.shapes):
        raise ValueError(f"corr_sample: empty pyramid level in {pyr.shapes}")
    plan = ctypes.create_string_buffer(lib.corr_plan_bytes())
    elem = pyr.flat.element_size()
    resident = (ctypes.c_int * L)(*resident_levels(pyr.shapes, pyr.C, elem,
                                                    reserve=lib.corr_extra_bytes()))
    with torch.cuda.device(pyr.flat.device):
        status = lib.corr_sample_plan(plan, pyr.flat.data_ptr(), pyr.S, pyr.C, L,
                                      *_level_tables(pyr), resident, int(elem == 1))
    cuda_build.check(status, "corr_sample (tensor maps)")
    _plans[key] = plan
    if len(_plans) > _PLAN_CACHE:
        _plans.popitem(last=False)
    return plan


corr_sample.launches = 0       # bf16 maps, float32 contraction (the tracker's)
corr_sample.mxu_launches = 0   # bf16 maps, tensor-core contraction
corr_sample.int8_launches = 0  # int8 maps, float32 contraction
