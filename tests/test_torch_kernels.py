"""The hand-written CUDA kernels of batrack_tpu_torch against their plain
PyTorch versions. This file imports no JAX, so it also runs on a GPU
machine without it: `python -m pytest tests/test_torch_kernels.py -q`.

On the CPU it checks the layout code around the kernels (the packed bf16
pyramid, the plain attention against a textbook split-head softmax, the
kv= source and K3 against the packed plain version). The kernel tests are
marked gpu and skip without a CUDA device. Tolerances: K1 1e-4 (same bf16
maps, float32 sums in another order); K2 (packed and kv=), K3 and K4 1e-4
in float32, where the kernel sums the six bf16 products of three-term
splits of q, k, v and the probabilities (float32 sums in another order);
the split pass bitwise against its plain version, on rows read in place
from a packed qkv, a kv= source and K4's split views; the float32 route
within 2e-5 of a float64 evaluation on q, k and v of 3 N(0, 1), or within
the float32 plain version's own distance from it where that is larger,
whose peaked softmax shows a dropped third term (3.6-5.1e-4 off); and
in bf16 two bf16 ulps of the largest output magnitude
(`bf16_tol`): both versions cast the probabilities to bf16 for the PV
product (the plain one after normalising, the kernel before, relative to
its running maximum) and round the output to bf16, so a correct kernel is
one output rounding off the plain version, while a kernel that drops a
key tile is many ulps off. The shapes leave the bf16 kernel's 128-query
and 128-key tiles ragged, and the "tiles" key masks mask whole key tiles,
under the same limits. K1's int8 and mxu variants (instantiations of K1's
kernel) are held to 1e-4 like K1 (exact products, sums in another order;
the three-term bf16 split of the target, which K1 and its int8 variant
use, leaves about 5e-7 of the terms' size), K4 (split-head attention on
the same kernel) to K2's limits. The card tests run every kernel at every
width its wrapper takes: K2-K4 at head dims 8 to 128 in steps of 8, K1's
three routes at each radius 1-4 with each C of 64, 128 and 256; each width
is its own build, all built together before the first test (`cuda`
fixture).
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from batrack_tpu_torch.ops import corr, cuda_build
from batrack_tpu_torch.ops.attention import (
    KERNEL_HEAD_DIMS,
    flash_attention,
    flash_attention_plain,
    fused_qkv_attention,
    fused_qkv_attention_plain,
    split_row_stride,
    split_terms,
    split_terms_plain,
    vmem_attention,
    vmem_attention_plain,
)
from batrack_tpu_torch.ops.corr_kernel import (
    KERNEL_CHANNELS,
    KERNEL_RADII,
    _library,
    corr_sample,
    corr_sample_plain,
    pack_pyramid,
    resident_levels,
    resident_map_bytes,
)
from batrack_tpu_torch.utils.config import full_fp32
from chip_smoke import key_tile_plan

# every width the wrappers take on the card: head dims 8 to 128 in steps of
# 8 (those with d % 16 == 8 have a last 16-lane box half of zeros), and each
# (radius, C) of K1
HEAD_DIMS = list(KERNEL_HEAD_DIMS)
K1_WIDTHS = [(r, c) for c in KERNEL_CHANNELS for r in KERNEL_RADII]
# K1's shared memory beside a resident map (kExtraBytes) in the build of
# each radius; the channel count leaves it unchanged
K1_RESERVE = {1: 2048, 2: 3072, 3: 3072, 4: 4096}
K1_ROUTES = [("bf16", "vpu", "launches"), ("bf16", "mxu", "mxu_launches"),
             ("int8", "vpu", "int8_launches")]


def bf16_tol(ref: torch.Tensor) -> float:
    """Two bf16 ulps (8 significand bits) of the largest magnitude in ref."""
    return 2.0 * 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)


@pytest.fixture(scope="module")
def kernels_built():
    """Every build the card tests use, one nvcc each, all started together
    (a width's first call would otherwise build it alone)."""
    if torch.cuda.is_available():
        cuda_build.build([cuda_build.spec("fused_qkv_attention", HEAD_DIM=d) for d in HEAD_DIMS]
                         + [cuda_build.spec("corr_sample", RADIUS=r, C=c) for r, c in K1_WIDTHS])


@pytest.fixture
def cuda(kernels_built):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.fixture
def no_builds(monkeypatch):
    """Fail any kernel build: a refused width must raise before one."""
    def refuse(items):
        raise AssertionError(f"a build was started for {list(items)}")
    monkeypatch.setattr(cuda_build, "build", refuse)


def _k1_inputs(rng, S, C, N, H, W, margin=8.0):
    fm = torch.from_numpy(rng.normal(size=(S, C, H, W)).astype(np.float32))
    tg = torch.from_numpy(rng.normal(size=(N, S, C)).astype(np.float32))
    xy = torch.from_numpy(np.stack([rng.uniform(-margin, W + margin, (S, N)),
                                    rng.uniform(-margin, H + margin, (S, N))],
                                   -1).astype(np.float32))
    return fm, tg, xy


def test_pack_pyramid_levels_are_channels_last_bf16(rng):
    fm, _, _ = _k1_inputs(rng, S=2, C=128, N=1, H=16, W=24)
    pyramid = corr.build_pyramid(fm, 3)
    pyr = pack_pyramid(pyramid)
    assert pyr.flat.dtype == torch.bfloat16 and pyr.flat.numel() == sum(p.numel() for p in pyramid)
    for lvl, p in enumerate(pyramid):
        assert torch.equal(pyr.level(lvl), p.permute(0, 2, 3, 1).to(torch.bfloat16))


def test_corr_sample_plain_is_track_major_ops_corr(rng):
    """The plain K1 is ops.corr on the bf16-rounded maps, (N, S, L*49)."""
    fm, tg, xy = _k1_inputs(rng, S=2, C=128, N=9, H=16, W=24)
    pyramid = corr.build_pyramid(fm, 3)
    out = corr_sample(pack_pyramid(pyramid), tg, xy, 3)  # CPU tensor -> plain version
    ref = corr.corr_sample_pyramid([p.to(torch.bfloat16).float() for p in pyramid],
                                   tg.transpose(0, 1), xy, 3).transpose(0, 1)
    assert out.shape == (9, 2, 3 * 49)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_plain_matches_split_head_softmax(rng, masked):
    B, N, H, d = 2, 37, 4, 16
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * H * d)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=N) > 0.3) if masked else None
    q, k, v = qkv.reshape(B, N, 3, H, d).permute(2, 0, 3, 1, 4)
    logits = q @ k.transpose(-1, -2) * d ** -0.5
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    ref = (logits.softmax(-1) @ v).transpose(1, 2).reshape(B, N, H * d)
    out = fused_qkv_attention(qkv, H, d ** -0.5, mask)  # CPU tensor -> plain version
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(fused_qkv_attention_plain(qkv, H, d ** -0.5, mask), out,
                               atol=0, rtol=0)


def test_attention_plain_kv_source_is_the_packed_layout(rng):
    """A kv= source holding the same keys and values, packed (B, N, 3C) or
    slim (B, N, 2C), gives the packed result exactly; K3's plain version is
    the one-head packed one."""
    B, N, H, d = 2, 19, 3, 16
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * H * d)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=N) > 0.3)
    ref = fused_qkv_attention_plain(qkv, H, 0.3, mask)
    for kv in (qkv.clone(), qkv[..., H * d:].clone()):
        assert torch.equal(fused_qkv_attention_plain(qkv, H, 0.3, mask, kv=kv), ref)
    q, k, v = (qkv[..., :d], qkv[..., H * d: H * d + d], qkv[..., 2 * H * d: 2 * H * d + d])
    one = torch.cat([q, k, v], -1)
    assert torch.equal(vmem_attention_plain(q, k, v, 0.3), fused_qkv_attention_plain(one, 1, 0.3))


def test_pack_pyramid_int8_levels_and_scales(rng):
    """int8 levels are within half a quantisation step of the maps, with
    one float32 scale per level, amax / 127."""
    fm, _, _ = _k1_inputs(rng, S=2, C=128, N=1, H=16, W=24)
    pyramid = corr.build_pyramid(fm, 3)
    pyr = pack_pyramid(pyramid, "int8")
    assert pyr.flat.dtype == torch.int8 and pyr.scales.shape == (3,)
    assert pyr.scales.dtype == torch.float32
    for lvl, p in enumerate(pyramid):
        scale = pyr.scales[lvl]
        torch.testing.assert_close(scale, p.abs().max() / 127.0, atol=0, rtol=1e-6)
        err = (pyr.level(lvl).float() * scale - p.permute(0, 2, 3, 1)).abs().max()
        assert err <= 0.5 * scale * (1 + 1e-5)


def test_corr_sample_plain_mxu_is_vpu_on_bf16_targets(rng):
    """The plain mxu contraction is the plain vpu one on targets rounded to
    bf16, exactly."""
    fm, tg, xy = _k1_inputs(rng, S=2, C=128, N=9, H=16, W=24)
    pyr = pack_pyramid(corr.build_pyramid(fm, 3))
    torch.testing.assert_close(corr_sample(pyr, tg, xy, 3, contract="mxu"),
                               corr_sample_plain(pyr, tg.to(torch.bfloat16).float(), xy, 3),
                               atol=0, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_flash_attention_plain_is_the_packed_layout(rng, masked):
    """K4's plain version on split heads (B, h, N, d) gives K2's plain
    version on the packed qkv of the same heads, exactly."""
    B, N, H, d = 2, 19, 3, 48
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * H * d)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=N) > 0.3) if masked else None
    q, k, v = qkv.reshape(B, N, 3, H, d).permute(2, 0, 3, 1, 4)
    out = flash_attention(q, k, v, 0.3, mask)  # CPU tensor -> plain version
    assert out.shape == (B, H, N, d)
    ref = fused_qkv_attention_plain(qkv, H, 0.3, mask)
    assert torch.equal(out.transpose(1, 2).reshape(B, N, H * d), ref)
    assert torch.equal(flash_attention_plain(q, k, v, 0.3, mask), out)


@pytest.mark.parametrize("S,H,W,L,resident,C,radius", [
    pytest.param(12, 96, 128, 4, (False, False, True, True), 128, 3,  # davis_demo: 24x32
                 id="12-96-128-4-resident0"),                         # and 12x16 stay
    pytest.param(3, 24, 32, 4, (True, True, True, True), 128, 3,  # the kernel tests' small maps
                 id="3-24-32-4-resident1"),
    pytest.param(2, 9, 13, 2, (True, True), 128, 3, id="2-9-13-2-resident2"),
    pytest.param(2, 64, 80, 3, (False, False, True), 128, 3,  # both kinds in one launch
                 id="2-64-80-3-resident3"),
    pytest.param(1, 8, 300, 2, (False, True), 128, 3,  # 300 columns: wider than one TMA box
                 id="1-8-300-2-resident4"),
    # other widths: C 64 halves a map, C 256 doubles it (davis_demo's level
    # 2 no longer fits); radius 4 reserves 1 KB more than radius 3, so a
    # 28x32 level (224 KB at C 128) is resident at radius 3 only
    pytest.param(12, 96, 128, 4, (False, False, True, True), 64, 3, id="davis-c64"),
    pytest.param(12, 96, 128, 4, (False, False, False, True), 256, 3, id="davis-c256"),
    pytest.param(2, 56, 64, 2, (False, True), 128, 3, id="56x64-r3"),
    pytest.param(2, 56, 64, 2, (False, False), 128, 4, id="56x64-r4"),
])
def test_corr_kernel_residency(S, H, W, L, resident, C, radius):
    """Which levels K1 keeps in shared memory, from the pyramid's shapes,
    channels and radius: one frame's map must fit beside the kernel's
    reserve for the radius (232,448 bytes in all) and measure at most
    256 x 256; the rest are streamed."""
    fm = torch.zeros((S, C, H, W))
    pyr = pack_pyramid(corr.build_pyramid(fm, L))
    assert resident_levels(pyr.shapes, C, 2, reserve=K1_RESERVE[radius]) == resident
    assert resident_map_bytes(24, 32) == 196608  # davis_demo's level 2
    assert resident_map_bytes(48, 64) + 3072 > 232448  # its level 1 does not fit
    assert resident_map_bytes(9, 13) == 2 * 15 * 1024  # halves rounded up to 1024 bytes
    assert resident_map_bytes(9, 13, C) == C // 64 * 15 * 1024  # C/64 sections of 64 channels


@pytest.mark.parametrize("radius,reserve", [(1, 2048), (2, 3072), (3, 3072), (4, 4096)])
def test_corr_kernel_reserve_follows_the_radius(radius, reserve):
    """The shared memory K1 keeps beside a resident map (kExtraBytes, which
    each build exports; test_corr_kernel_reserve_of_each_build_on_gpu holds
    the builds to K1_RESERVE): six warps' taps padded to 16-row tiles (16,
    48, 64, 112 rows for radius 1-4), the zero row, 25 barriers and 1 KB of
    slack, rounded up to 1 KB. A 28x32 bf16 map of 128 channels (229,376
    bytes) fits beside the reserve of radius 1-3 and not beside radius 4's."""
    assert K1_RESERVE[radius] == reserve
    need = 1024 + 6 * -(-(2 * radius + 2) ** 2 // 16) * 16 * 4 + 128 + 25 * 8
    assert reserve % 1024 == 0 and 0 <= reserve - need < 1024
    assert resident_map_bytes(28, 32) == 229376
    assert resident_levels([(28, 32)], reserve=reserve) == (radius < 4,)


def test_corr_kernel_int8_residency():
    """int8 maps take one byte per channel, one 128-byte section per tap:
    at davis_demo levels 2-3 stay resident and level 1 (48x64x128 = 384 KB)
    is still streamed; a level that fits only at one byte per channel is
    resident for int8 maps alone."""
    davis = [(96, 128), (48, 64), (24, 32), (12, 16)]
    assert resident_levels(davis, 128, 1, reserve=3072) == (False, False, True, True)
    assert resident_map_bytes(24, 32, 128, 1) == 98304
    assert resident_map_bytes(48, 64, 128, 1) == 393216
    assert resident_map_bytes(9, 13, 128, 1) == 15 * 1024
    assert resident_levels([(32, 40)], 128, 1, reserve=3072) == (True,)
    assert resident_levels([(32, 40)], 128, 2, reserve=3072) == (False,)
    # C 64: half of each 128-byte row is zero fill, so a map takes what it
    # takes at C 128; C 256: two sections
    assert resident_map_bytes(24, 32, 64, 1) == 98304
    assert resident_map_bytes(24, 32, 256, 1) == 196608
    assert resident_levels(davis, 64, 1, reserve=3072) == (False, False, True, True)
    assert resident_levels(davis, 256, 1, reserve=3072) == (False, False, True, True)
    assert resident_levels(davis, 256, 1, reserve=K1_RESERVE[4]) == (False, False, True, True)


def test_flash_attention_direct_route_strides():
    """K4 reads q, k and v in place when they are head splits of packed rows
    (strides (N*R, d, R, 1), d a head dim the kernel takes, R % 8 == 0,
    16-byte bases): the tracker's views of one qkv. Contiguous (B, h, N, d)
    tensors, rows that are not a multiple of 8 elements and misaligned
    bases take the folded route."""
    B, N, h, d = 2, 19, 3, 48
    qkv = torch.zeros((B, N, 3 * h * d), dtype=torch.bfloat16)
    q, k, v = qkv.view(B, N, 3, h, d).permute(2, 0, 3, 1, 4)
    assert [split_row_stride(x) for x in (q, k, v)] == [3 * h * d] * 3
    kv = torch.zeros((B, N, 2 * h * d))
    assert split_row_stride(kv.view(B, N, 2, h, d).permute(2, 0, 3, 1, 4)[1]) == 2 * h * d
    assert split_row_stride(torch.zeros((B, h, N, d))) is None
    odd = torch.zeros((B, N, 3 * h * d + 4))[..., :3 * h * d]  # rows of 436 elements
    assert split_row_stride(odd.view(B, N, 3, h, d).permute(2, 0, 3, 1, 4)[0]) is None
    shifted = torch.zeros((B, N, 3 * h * d + 8), dtype=torch.bfloat16)[..., 1:3 * h * d + 1]
    assert split_row_stride(shifted.reshape(B, N, 3, h, d).permute(2, 0, 3, 1, 4)[0]) is None
    assert split_row_stride(q[..., :32]) is None  # a lane slice of each head, not a split
    for dh, R in ((64, 3 * h * 64), (8, 3 * h * 8), (36, None), (136, None)):
        # head dims the kernel takes are read in place; 36 and 136 are not taken
        views = torch.zeros((B, N, 3 * h * dh)).view(B, N, 3, h, dh).permute(2, 0, 3, 1, 4)
        assert split_row_stride(views[0]) == R


def test_cuda_build_command_for_a_width(monkeypatch, tmp_path):
    """A width's build carries its -D flags and writes its own library;
    the default widths (given or left out) are the default build, with no
    flags and the source's own name. build() starts every stale build at
    once; nvcc is never called here."""
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    d64 = cuda_build.spec("fused_qkv_attention", HEAD_DIM=64)
    r4 = cuda_build.spec("corr_sample", RADIUS=4)
    assert cuda_build.lib_path(d64).name == "libfused_qkv_attention_d64.so"
    assert cuda_build.lib_path(r4).name == "libcorr_sample_r4_c128.so"
    assert cuda_build.lib_path(cuda_build.spec("corr_sample", C=256)).name == \
        "libcorr_sample_r3_c256.so"
    cmd = cuda_build.command(d64, tmp_path / "x.so")
    assert cmd[0] == "nvcc" and "-DBT_HEAD_DIM=64" in cmd and cmd[-1].endswith(
        "csrc/fused_qkv_attention.cu")
    assert cmd[cmd.index("-o") + 1] == str(tmp_path / "x.so")
    assert {"-DBT_CORR_RADIUS=4", "-DBT_CORR_C=128"} <= set(cuda_build.command(r4, tmp_path))
    for default in (cuda_build.spec("fused_qkv_attention"),
                    cuda_build.spec("fused_qkv_attention", HEAD_DIM=48),
                    cuda_build.spec("corr_sample", RADIUS=3, C=128)):
        assert default[1] == ()
        assert not any(a.startswith("-D") for a in cuda_build.command(default, tmp_path))
        assert cuda_build.lib_path(default).name == f"lib{default[0]}.so"
    with pytest.raises(ValueError, match="HEAD_DIM"):
        cuda_build.spec("corr_sample", HEAD_DIM=64)

    started = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            started.append(cmd)
            self.out = Path(cmd[cmd.index("-o") + 1])

        def communicate(self):
            assert len(started) == 2  # both builds started before either is read
            self.out.write_bytes(b"")
            return ("ptxas info",)

    monkeypatch.setattr(cuda_build.subprocess, "Popen", Proc)
    logs = cuda_build.build([d64, ("corr_sample", (("RADIUS", 4),)), d64])
    assert sorted(logs) == ["corr_sample_r4_c128", "fused_qkv_attention_d64"]
    assert {"-DBT_HEAD_DIM=64"} <= set(started[0]) and "-DBT_CORR_RADIUS=4" in started[1]
    assert (tmp_path / "libfused_qkv_attention_d64.so").exists()
    assert (tmp_path / "libcorr_sample_r4_c128.so").exists()
    assert cuda_build.build([d64]) == {}  # up to date: nothing started
    assert len(started) == 2


def test_attention_kv_source_of_wrong_width_raises(rng):
    qkv = torch.zeros((1, 5, 3 * 96))
    with pytest.raises(ValueError, match="kv"):
        fused_qkv_attention(qkv, 2, 0.1, kv=torch.zeros((1, 7, 96)))


def key_mask(kind, Nk: int, rng):
    """None: no mask. "random": 70 % of the Nk keys live. "tiles": the same
    with keys 0-127 (the bf16 kernel's whole first key tile) and 256-383 (a
    whole later tile) masked; below 129 keys every key is then masked, and
    each query averages all Nk values, as the plain version does. The
    kinds whose plans (`key_tile_plan`) skip whole key tiles: "prefix", the
    first 60 % live (the keyframe path's active tracks); "striped", every
    other 128-key tile dead and 70 % of the rest live; "last_key", only the
    third key from the end (in a ragged last tile); "none", no live key."""
    if kind is None:
        return None
    m = rng.uniform(size=Nk) > 0.3
    if kind == "tiles":
        m[:128] = False
        m[256:384] = False
    elif kind == "striped":
        m[(np.arange(Nk) // 128) % 2 == 1] = False
    elif kind in ("prefix", "last_key", "none"):
        m[:] = False
        if kind == "prefix":
            m[:Nk * 3 // 5] = True
        elif kind == "last_key":
            m[-3] = True
    return torch.from_numpy(m)


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_127attention_bf16_wgmma_kernelILb1EEEv' for 'sm_90a'
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are serialized due to insufficient register resources for the function '_ZN12_GLOBAL__N_127attention_bf16_wgmma_kernelILb1EEEv'
ptxas info    : Function properties for _ZN12_GLOBAL__N_127attention_bf16_wgmma_kernelILb1EEEv
    16 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_126attention_f32_wgmma_kernelEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 249 registers, used 16 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_118split_terms_kernelEv
    0 bytes stack frame, 8 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers
"""


@pytest.mark.parametrize("kernels,faults", [
    (cuda_build.ATTENTION_KERNELS, 2),  # the bf16 kernel's C7512 and spill lines
    (("attention_f32_wgmma_kernel",), 0),
    (("split_terms_kernel",), 1),
])
def test_ptxas_faults_read_each_function_s_lines(kernels, faults):
    """ptxas_lines ties each register, spill and C75xx line to its function
    (a C75xx line by the name it holds), and ptxas_faults keeps the spills
    with nonzero bytes and the C75xx lines of the named kernels only."""
    lines = cuda_build.ptxas_lines({"b": PTXAS_LOG})["b"]
    assert len(lines) == 7
    assert [fn.split("N_")[1][:6] for fn, _ in lines] == ["127att"] * 3 + ["126att"] * 2 + [
        "118spl"] * 2
    got = cuda_build.ptxas_faults({"b": PTXAS_LOG}, kernels)
    assert len(got.get("b", [])) == faults


# ---------------------------------------------------------------- on the card
@pytest.mark.gpu
@pytest.mark.parametrize("radius,C", K1_WIDTHS)
@pytest.mark.parametrize("fmap_dtype,contract,counter", K1_ROUTES)
@pytest.mark.parametrize("L,shape,margin", [
    (4, (3, 70, 24, 32), 8.0),    # every level resident
    (2, (2, 33, 9, 13), 8.0),
    (3, (2, 50, 64, 80), 8.0),    # levels 0-1 streamed by TMA, level 2 resident
    (3, (2, 41, 16, 24), 60.0),   # most windows partly or wholly outside the map
    (3, (2, 50, 64, 80), 60.0),   # the same for streamed boxes: negative and far-out origins
    (3, (3, 301, 64, 80), 8.0),   # ragged last chunks: 301 tracks, 903 windows per level
])
def test_corr_kernel_matches_plain_on_gpu(rng, cuda, L, shape, margin, fmap_dtype, contract,
                                          counter, radius, C):
    """K1 == its plain version on the same maps (1e-4), on each of its three
    routes and at each width it takes, with levels kept in shared memory and
    levels streamed (resident_levels), windows far outside the map, and
    track counts that leave the last block's chunk ragged; only the route's
    own counter moves."""
    S, N, H, W = shape
    fm, tg, xy = (x.to(cuda) for x in _k1_inputs(rng, S=S, C=C, N=N, H=H, W=W, margin=margin))
    pyr = pack_pyramid(corr.build_pyramid(fm, L), fmap_dtype)
    counters = [c for _, _, c in K1_ROUTES]
    before = {c: getattr(corr_sample, c) for c in counters}
    out = corr_sample(pyr, tg, xy, radius, contract=contract)
    torch.cuda.synchronize()
    assert {c: getattr(corr_sample, c) - before[c] for c in counters} == {
        c: int(c == counter) for c in counters}
    assert out.shape == (N, S, L * (2 * radius + 1) ** 2)
    with full_fp32():
        ref = corr_sample_plain(pyr, tg, xy, radius, contract=contract)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    # a second call reuses the pyramid's tensor maps and gives the same output
    assert torch.equal(corr_sample(pyr, tg, xy, radius, contract=contract), out)


@pytest.mark.gpu
@pytest.mark.parametrize("radius,C", K1_WIDTHS)
def test_corr_kernel_reserve_of_each_build_on_gpu(cuda, radius, C):
    """Each (radius, C) build exports the reserve that the residency choice
    reads (corr_extra_bytes), K1_RESERVE's for its radius."""
    assert _library(radius, C).corr_extra_bytes() == K1_RESERVE[radius]
    assert resident_levels([(28, 32)], 128, 2, radius) == (radius < 4,)


@pytest.mark.gpu
@pytest.mark.parametrize("fmap_dtype", ["bf16", "int8"])
def test_corr_kernel_keeps_float32_targets_on_gpu(rng, cuda, fmap_dtype):
    """K1 contracts the float32 target as three bf16 terms on the tensor
    cores, on bf16 maps and on int8 maps converted to bf16: within 3e-6 of
    a float64 evaluation of the same windows (int8: of the dequantised
    maps). A CPU emulation of the split over 20,000 windows (N(0, 1) maps
    and targets, scaled by 1/sqrt(128)) gives 6.2e-7 for three terms and
    1.2e-5 for two, so this check sees a lost term that the 1e-4 limit
    against the float32 plain version does not."""
    S, N, H, W, L = 2, 50, 64, 80, 3  # streamed and resident levels
    fm, tg, xy = (x.to(cuda) for x in _k1_inputs(rng, S=S, C=128, N=N, H=H, W=W))
    pyr = pack_pyramid(corr.build_pyramid(fm, L), fmap_dtype)
    out = corr_sample(pyr, tg, xy, 3)
    levels = [pyr.level(lvl).double().permute(0, 3, 1, 2)
              * (1.0 if pyr.scales is None else pyr.scales[lvl].double()) for lvl in range(L)]
    ref = corr.corr_sample_pyramid(levels, tg.double().transpose(0, 1), xy.double(), 3)
    torch.testing.assert_close(out.double(), ref.transpose(0, 1), atol=3e-6, rtol=0)


@pytest.mark.gpu
def test_corr_kernel_raises_on_what_it_does_not_take(rng, cuda, no_builds):
    """No fallback: a radius outside 1-4, a channel count other than 64,
    128 or 256, more than 8 levels or a non-bf16, non-int8 map raises on the
    card, before any build or launch."""
    fm, tg, xy = (x.to(cuda) for x in _k1_inputs(rng, S=2, C=128, N=5, H=16, W=24))
    pyr = pack_pyramid(corr.build_pyramid(fm, 2))
    counters = [c for _, _, c in K1_ROUTES]
    before = {c: getattr(corr_sample, c) for c in counters}
    for radius in (0, 5, 7):
        with pytest.raises(ValueError, match="radius 1 to 4"):
            corr_sample(pyr, tg, xy, radius)
    with pytest.raises(TypeError):
        corr_sample(pyr._replace(flat=pyr.flat.float()), tg, xy, 3)
    for C in (32, 96, 192, 512):
        fm_c, tg_c, xy_c = (x.to(cuda) for x in _k1_inputs(rng, S=2, C=C, N=5, H=16, W=24))
        for fmap_dtype in ("bf16", "int8"):
            pyr_c = pack_pyramid(corr.build_pyramid(fm_c, 2), fmap_dtype)
            with pytest.raises(ValueError, match=f"C {C}"):
                corr_sample(pyr_c, tg_c, xy_c, 3)
    pyr9 = pack_pyramid(corr.build_pyramid(torch.randn(2, 128, 512, 512, device=cuda), 9))
    with pytest.raises(ValueError, match="9 levels"):
        corr_sample(pyr9, tg, xy, 3)
    assert {c: getattr(corr_sample, c) for c in counters} == before


@pytest.mark.gpu
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", [None, "random", "tiles"])
@pytest.mark.parametrize("N,H", [(333, 8), (70, 2)])
def test_attention_kernel_matches_plain_on_gpu(rng, cuda, dtype, mask_kind, N, H, d):
    """K2 packed at each head dim; N = 333 and 70 leave the bf16 kernel's
    128-query and 128-key tiles ragged."""
    B = 3
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * H * d)).astype(np.float32)).to(cuda, dtype)
    mask = key_mask(mask_kind, N, rng)
    mask = None if mask is None else mask.to(cuda)
    before = fused_qkv_attention.launches
    out = fused_qkv_attention(qkv, H, d ** -0.5, mask)
    torch.cuda.synchronize()
    assert fused_qkv_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, N, H * d)
    with full_fp32():
        ref = fused_qkv_attention_plain(qkv, H, d ** -0.5, mask)
    tol = 1e-4 if dtype == torch.float32 else bf16_tol(ref.float())
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [48, 64, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("source", [None, "slim"])
@pytest.mark.parametrize("mask_kind", ["prefix", "striped", "last_key", "none"])
def test_attention_key_tile_plans_on_gpu(rng, cuda, dtype, source, mask_kind, d):
    """K2 packed (1100 queries and keys: nine key tiles, the last ragged) and
    with a slim kv= source (150 queries against them) on the masks whose
    plans leave whole key tiles out, so that the walk wraps the K/V ring
    (four stages, three at d 128) over the tiles it keeps; with no live key
    every query averages all values. In bf16 the keys and values of the
    tiles the plan (chip_smoke.key_tile_plan, which the reports print)
    calls dead are NaN in the kernel's input and not in the plain
    version's: a dead tile that the kernel loaded and computed would carry
    NaN into every row (its weights are 0, 0 x NaN is NaN), and a live one
    that it skipped would change the rows."""
    B, N, H, Nk = 3, 1100 if source is None else 150, 8, 1100
    C = H * d
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * C)).astype(np.float32)).to(cuda, dtype)
    kv = None if source is None else torch.from_numpy(
        rng.normal(size=(B, Nk, 2 * C)).astype(np.float32)).to(cuda, dtype)
    mask = key_mask(mask_kind, Nk, rng)
    plan = key_tile_plan(mask)
    assert plan["dead"] > 0 or mask_kind == "none"
    with full_fp32():
        ref = fused_qkv_attention_plain(qkv, H, d ** -0.5, mask.to(cuda), kv=kv)
    if dtype == torch.bfloat16:
        dead = torch.ones(Nk, dtype=torch.bool)
        for j in plan["walk"]:
            dead[j * 128:(j + 1) * 128] = False
        if kv is None:
            qkv = qkv.clone()
            qkv[:, dead.to(cuda), C:] = float("nan")  # keys and values, not the queries
        else:
            kv = kv.clone()
            kv[:, dead.to(cuda)] = float("nan")
    out = fused_qkv_attention(qkv, H, d ** -0.5, mask.to(cuda), kv=kv)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (B, N, C)
    tol = 1e-4 if dtype == torch.float32 else bf16_tol(ref.float())
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d,Nk", [(128, 13000), (96, 66000)])
def test_attention_long_key_masks_on_gpu(rng, cuda, d, Nk):
    """A key mask over so many keys that the bf16 kernel's plan does not fit
    beside its full K/V ring (beyond about 12,500 keys at d 120-128, 65,000
    at d 88-96), so the launch takes the two-stage ring: 150 queries of 2
    heads against a slim kv= source, every other key tile dead."""
    B, N, H = 1, 150, 2
    C = H * d
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * C)).astype(np.float32)).to(cuda,
                                                                                torch.bfloat16)
    kv = torch.from_numpy(rng.normal(size=(B, Nk, 2 * C)).astype(np.float32)).to(cuda,
                                                                               torch.bfloat16)
    mask = key_mask("striped", Nk, rng).to(cuda)
    out = fused_qkv_attention(qkv, H, d ** -0.5, mask, kv=kv)
    torch.cuda.synchronize()
    ref = fused_qkv_attention_plain(qkv, H, d ** -0.5, mask, kv=kv)
    torch.testing.assert_close(out.float(), ref.float(), atol=bf16_tol(ref.float()), rtol=0)


@pytest.mark.gpu
def test_attention_builds_neither_spill_nor_serialise_on_gpu(cuda, tmp_path, monkeypatch):
    """Every head dim's build, compiled afresh: ptxas reports no spill and
    no C75xx advisory (a serialised or fenced wgmma) for the bf16 or the
    float32 kernel."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    logs = cuda_build.build([cuda_build.spec("fused_qkv_attention", HEAD_DIM=d)
                             for d in HEAD_DIMS])
    assert len(logs) == len(HEAD_DIMS)
    assert cuda_build.ptxas_faults(logs, cuda_build.ATTENTION_KERNELS) == {}


@pytest.mark.gpu
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("source", ["slim", "packed"])
@pytest.mark.parametrize("mask_kind", [None, "random", "tiles"])
@pytest.mark.parametrize("Nk", [333, 37])
def test_attention_kv_kernel_matches_plain_on_gpu(rng, cuda, dtype, source, mask_kind, Nk, d):
    """K2 with a separate key/value source at each head dim: queries
    (3, 150) against Nk = 333 keys (ragged key tiles) or 37 (fewer than one
    key tile) of a slim or packed source."""
    B, N, H = 3, 150, 8
    C = H * d
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * C)).astype(np.float32)).to(cuda, dtype)
    width = (2 if source == "slim" else 3) * C
    kv = torch.from_numpy(rng.normal(size=(B, Nk, width)).astype(np.float32)).to(cuda, dtype)
    mask = key_mask(mask_kind, Nk, rng)
    mask = None if mask is None else mask.to(cuda)
    before, before_kv = fused_qkv_attention.launches, fused_qkv_attention.kv_launches
    out = fused_qkv_attention(qkv, H, d ** -0.5, mask, kv=kv)
    torch.cuda.synchronize()
    assert fused_qkv_attention.launches == before + 1
    assert fused_qkv_attention.kv_launches == before_kv + 1
    assert out.dtype == dtype and out.shape == (B, N, C)
    with full_fp32():
        ref = fused_qkv_attention_plain(qkv, H, d ** -0.5, mask, kv=kv)
    tol = 1e-4 if dtype == torch.float32 else bf16_tol(ref.float())
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1, 37, 129, 200, 333])
def test_vmem_attention_kernel_matches_plain_on_gpu(rng, cuda, dtype, N, d):
    """K3 on (B, N, d): one key, fewer than one 128-key tile, one key past
    a tile, ragged second and third tiles."""
    q, k, v = (torch.from_numpy(rng.normal(size=(5, N, d)).astype(np.float32)).to(cuda, dtype)
               for _ in range(3))
    before = vmem_attention.launches
    out = vmem_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert vmem_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    with full_fp32():
        ref = vmem_attention_plain(q, k, v, d ** -0.5)
    tol = 1e-4 if dtype == torch.float32 else bf16_tol(ref.float())
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [4, 12, 36, 132, 136, 256])
def test_attention_kernels_raise_on_other_head_dims_on_gpu(rng, cuda, no_builds, d):
    """No fallback: K2 (packed and kv=), K3 and K4 (split views and
    contiguous heads) raise ValueError on a head dim outside 8-128 or not a
    multiple of 8, before any build or launch."""
    B, N, H = 2, 40, 2
    qkv = torch.randn(B, N, 3 * H * d, device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv.view(B, N, 3, H, d).permute(2, 0, 3, 1, 4)
    calls = [(fused_qkv_attention, (qkv, H, 0.1)),
             (lambda *a: fused_qkv_attention(*a, kv=qkv[..., H * d:].contiguous()),
              (qkv, H, 0.1)),
             (vmem_attention, (q[0], k[0], v[0], 0.1)),
             (flash_attention, (q, k, v, 0.1)),
             (flash_attention, (q.contiguous(), k.contiguous(), v.contiguous(), 0.1))]
    counts = (fused_qkv_attention.launches, vmem_attention.launches, flash_attention.launches)
    for fn, args in calls:
        with pytest.raises(ValueError, match=f"head dim {d}"):
            fn(*args)
    assert (fused_qkv_attention.launches, vmem_attention.launches,
            flash_attention.launches) == counts



@pytest.mark.gpu
@pytest.mark.parametrize("fmap_dtype,contract", [("bf16", "mxu"), ("int8", "vpu")])
@pytest.mark.parametrize("L,shape,margin", [
    (4, (3, 70, 24, 32), 8.0),    # every level resident
    (2, (2, 33, 9, 13), 8.0),
    (3, (2, 41, 16, 24), 60.0),   # most windows partly or wholly outside the map
    (3, (2, 50, 64, 80), 8.0),    # resident and streamed levels in one launch, for both
    (3, (3, 301, 64, 80), 60.0),  # streamed boxes far out, ragged last chunks
])
def test_corr_kernel_options_match_plain_on_gpu(rng, cuda, fmap_dtype, contract, L, shape,
                                                margin):
    """K1's mxu and int8 variants == their plain versions (1e-4), with levels
    resident and streamed in one launch (bf16 keeps level 2 of 64x80 maps
    resident, int8 levels 1-2), windows far outside the map, and ragged
    chunks; only the variant's own counter moves."""
    S, N, H, W = shape
    fm, tg, xy = (x.to(cuda) for x in _k1_inputs(rng, S=S, C=128, N=N, H=H, W=W, margin=margin))
    pyr = pack_pyramid(corr.build_pyramid(fm, L), fmap_dtype)
    counters = ("launches", "mxu_launches", "int8_launches")
    before = {c: getattr(corr_sample, c) for c in counters}
    out = corr_sample(pyr, tg, xy, 3, contract=contract)
    torch.cuda.synchronize()
    mine = "int8_launches" if fmap_dtype == "int8" else "mxu_launches"
    assert {c: getattr(corr_sample, c) - before[c] for c in counters} == {
        c: int(c == mine) for c in counters}
    with full_fp32():
        ref = corr_sample_plain(pyr, tg, xy, 3, contract=contract)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    if fmap_dtype == "int8":
        with pytest.raises(ValueError, match="int8"):
            corr_sample(pyr, tg, xy, 3, contract="mxu")
    if shape[1] == 50:
        assert resident_levels(pyr.shapes, 128, pyr.flat.element_size()) == (
            (False, True, True) if fmap_dtype == "int8" else (False, False, True))


@pytest.mark.gpu
@pytest.mark.parametrize("fmap_dtype,contract", [("bf16", "mxu"), ("int8", "vpu")])
def test_corr_kernel_options_raise_on_other_radius_on_gpu(rng, cuda, no_builds, fmap_dtype,
                                                          contract):
    """The variants run on K1's pipeline, which takes radius 1 to 4: radius
    5 raises ValueError before any build or launch."""
    fm, tg, xy = (x.to(cuda) for x in _k1_inputs(rng, S=2, C=128, N=5, H=16, W=24))
    pyr = pack_pyramid(corr.build_pyramid(fm, 2), fmap_dtype)
    counters = ("launches", "mxu_launches", "int8_launches")
    before = {c: getattr(corr_sample, c) for c in counters}
    with pytest.raises(ValueError, match="radius"):
        corr_sample(pyr, tg, xy, 5, contract=contract)
    assert {c: getattr(corr_sample, c) for c in counters} == before


@pytest.mark.gpu
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("layout", ["split", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", [None, "random", "tiles"])
@pytest.mark.parametrize("N,H", [(333, 8), (70, 2)])
def test_flash_attention_kernel_matches_plain_on_gpu(rng, cuda, layout, dtype, mask_kind, N, H,
                                                     d):
    """K4 on split heads (3, H, N, d) taken from a packed qkv, as the
    tracker's split-head route gives them (read in place: the strided
    counter moves), and on contiguous (3, H, N, d) tensors (folded into one
    head per batch row), at each head dim; N = 333 and 70 leave the bf16
    kernel's 128-query and 128-key tiles ragged."""
    B = 3
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * H * d)).astype(np.float32)).to(cuda, dtype)
    q, k, v = qkv.view(B, N, 3, H, d).permute(2, 0, 3, 1, 4)
    if layout == "contiguous":
        q, k, v = (x.contiguous() for x in (q, k, v))
    mask = key_mask(mask_kind, N, rng)
    mask = None if mask is None else mask.to(cuda)
    before, before_strided = flash_attention.launches, flash_attention.strided_launches
    out = flash_attention(q, k, v, d ** -0.5, mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert flash_attention.strided_launches == before_strided + (layout == "split")
    assert out.dtype == dtype and out.shape == (B, H, N, d)
    if layout == "split":  # the merge of the heads is a view of the kernel's rows
        assert out.transpose(1, 2).is_contiguous()
    with full_fp32():
        ref = flash_attention_plain(q, k, v, d ** -0.5, mask)
    tol = 1e-4 if dtype == torch.float32 else bf16_tol(ref.float())
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


def attention_f64(qkv: torch.Tensor, heads: int, scale: float, mask) -> torch.Tensor:
    """K2's function on the packed qkv in float64, one head at a time."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    d = C // heads
    x = qkv.double()
    out = []
    for h in range(heads):
        q, k, v = (x[..., i * C + h * d: i * C + (h + 1) * d] for i in range(3))
        logits = q @ k.transpose(1, 2) * scale
        if mask is not None:
            logits = logits.masked_fill(~mask.bool()[None, None, :], -1e30)
        out.append(torch.softmax(logits, -1) @ v)
    return torch.cat(out, -1)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [8, 48, 128])
@pytest.mark.parametrize("mask_kind", [None, "random"])
def test_attention_f32_keeps_three_terms_on_gpu(rng, cuda, mask_kind, d):
    """The float32 route sums three bf16 terms of every operand: on q, k
    and v of 3 N(0, 1) (a peaked softmax, outputs up to about 10) it is
    within 2e-5 of a float64 evaluation of the same attention, or no
    farther from it than the float32 plain version (cuBLAS float32) on the
    same inputs where that is farther: at d 128 float32 itself strays
    4.7-5.8e-5 on such inputs and the kernel 1.8-1.9e-5 (chip_smoke.py
    phase 2; PERF.md). Two terms leave 3.6-5.1e-4 in a CPU emulation
    of the sums (tests/test_torch_attention_f32_split.py), so a dropped
    term fails this check at every d; the 1e-4 limit against the plain
    version does not see it at N(0, 1) inputs."""
    B, N, H = 2, 333, 2
    qkv = torch.from_numpy((3 * rng.normal(size=(B, N, 3 * H * d))).astype(np.float32)).to(cuda)
    mask = key_mask(mask_kind, N, rng)
    mask = None if mask is None else mask.to(cuda)
    out = fused_qkv_attention(qkv, H, d ** -0.5, mask)
    torch.cuda.synchronize()
    ref = attention_f64(qkv, H, d ** -0.5, mask)
    with full_fp32():
        plain = fused_qkv_attention_plain(qkv, H, d ** -0.5, mask)
    tol = max(2e-5, (plain.double() - ref).abs().max().item())
    torch.testing.assert_close(out.double(), ref, atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["packed", "kv_slim", "split_views"])
def test_split_terms_matches_plain_on_gpu(rng, cuda, layout):
    """The split pass == its plain version, bitwise, on the row sets the
    float32 route hands it, read in place: q, k and v lanes of a packed
    qkv; q of a qkv with k and v of a slim kv= source; K4's split views
    (B, h, N, d) as (B*N, h*d) rows of stride 3C. One launch for the three
    sets; magnitudes over six decades exercise every rounding."""
    B, N, Nk, H, d = 3, 70, 37, 2, 48
    C = H * d
    mag = 10.0 ** rng.uniform(-3, 3, size=(B, N, 3 * C))
    qkv = torch.from_numpy((rng.normal(size=(B, N, 3 * C)) * mag).astype(np.float32)).to(cuda)
    packed = qkv.view(B * N, 3 * C)
    if layout == "packed":
        rows = [packed[:, i * C:(i + 1) * C] for i in range(3)]
    elif layout == "kv_slim":
        kv = torch.from_numpy(rng.normal(size=(B * Nk, 2 * C)).astype(np.float32)).to(cuda)
        rows = [packed[:, :C], kv[:, :C], kv[:, C:]]
    else:
        q, k, v = qkv.view(B, N, 3, H, d).permute(2, 0, 3, 1, 4)
        assert split_row_stride(q) == 3 * C
        rows = [torch.as_strided(x, (B * N, C), (3 * C, 1)) for x in (q, k, v)]
    before = split_terms.launches
    terms = split_terms(*rows, head_dim=d)
    torch.cuda.synchronize()
    assert split_terms.launches == before + 1
    for x, t in zip(rows, terms):
        assert t.shape == (3, *x.shape) and t.dtype == torch.bfloat16 and t.is_contiguous()
        assert torch.equal(t, split_terms_plain(x))


def test_autograd_guard_names_the_kernel():
    """The guard each wrapper runs before a launch: it raises when autograd
    would record (grad mode on and an input that requires grad), and
    passes under no_grad or for inputs that need no gradient."""
    from batrack_tpu_torch.ops.cuda_build import refuse_autograd

    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="fused_qkv_attention: the CUDA kernel has no backward"):
        refuse_autograd("fused_qkv_attention", x, None)
    refuse_autograd("corr_sample", torch.zeros(3), None)
    with torch.no_grad():
        refuse_autograd("corr_sample", x)


@pytest.mark.gpu
def test_kernel_wrappers_raise_under_autograd_on_gpu(rng, cuda):
    """K1, K2, K3 and K4 have no backward (nor have the TPU kernels): on
    the card each wrapper raises when autograd would record through it,
    launches nothing, and launches under no_grad."""
    fm, tg, xy = (x.to(cuda) for x in _k1_inputs(rng, S=2, C=128, N=40, H=24, W=32))
    pyr = pack_pyramid(corr.build_pyramid(fm, 2))
    qkv = torch.randn(2, 130, 3 * 384, device=cuda)
    q = torch.randn(2, 8, 130, 48, device=cuda)
    calls = {
        "corr_sample": (corr_sample, lambda g: (pyr, tg.requires_grad_(g), xy, 3)),
        "fused_qkv_attention": (fused_qkv_attention,
                                lambda g: (qkv.requires_grad_(g), 8, 0.1)),
        "vmem_attention": (vmem_attention,
                           lambda g: (q[0].requires_grad_(g), q[0], q[0], 0.1)),
        "flash_attention": (flash_attention, lambda g: (q.requires_grad_(g), q, q, 0.1)),
    }
    for name, (fn, args) in calls.items():
        before = fn.launches
        with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel has no backward"):
            fn(*args(True))
        assert fn.launches == before, name
        with torch.no_grad():
            fn(*args(True))
        assert fn.launches == before + 1, name
        args(False)
