"""The hand-written CUDA kernels of batrack_tpu_torch against their plain
PyTorch versions. This file imports no JAX, so it also runs on a GPU
machine without it: `python -m pytest tests/test_torch_kernels.py -q`.

On the CPU it checks the layout code around the kernels (the packed bf16
pyramid, the plain attention against a textbook split-head softmax, the
kv= source and K3 against the packed plain version). The kernel tests are
marked gpu and skip without a CUDA device. Tolerances: K1 1e-4 (same bf16
maps, float32 sums in another order); K2 (packed and kv=) and K3 1e-4 in
float32, and in bf16 two bf16 ulps of the largest output magnitude
(`bf16_tol`): both versions cast the probabilities to bf16 for the PV
product (the plain one after normalising, the kernel before, relative to
its running maximum) and round the output to bf16, so a correct kernel is
one output rounding off the plain version, while a kernel that drops a
key tile is many ulps off. The shapes leave the bf16 kernel's 128-query
and 128-key tiles ragged, and the "tiles" key masks mask whole key tiles,
under the same limits. K1's int8 and mxu variants are held to 1e-4 like
K1 (exact products, sums in another order; K1's three-term bf16 split of
the target leaves about 5e-7 of the terms' size), K4 (split-head attention
on the same kernel) to K2's limits.
"""

import math

import numpy as np
import pytest
import torch

from batrack_tpu_torch.ops import corr
from batrack_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_plain,
    fused_qkv_attention,
    fused_qkv_attention_plain,
    split_row_stride,
    vmem_attention,
    vmem_attention_plain,
)
from batrack_tpu_torch.ops.corr_kernel import (
    corr_sample,
    corr_sample_plain,
    pack_pyramid,
    resident_levels,
    resident_map_bytes,
)
from batrack_tpu_torch.utils.config import full_fp32


def bf16_tol(ref: torch.Tensor) -> float:
    """Two bf16 ulps (8 significand bits) of the largest magnitude in ref."""
    return 2.0 * 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


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


@pytest.mark.parametrize("S,H,W,L,resident", [
    (12, 96, 128, 4, (False, False, True, True)),  # davis_demo: 24x32 and 12x16 stay
    (3, 24, 32, 4, (True, True, True, True)),      # the kernel tests' small maps
    (2, 9, 13, 2, (True, True)),
    (2, 64, 80, 3, (False, False, True)),          # both kinds in one launch
    (1, 8, 300, 2, (False, True)),                 # 300 columns: wider than one TMA box
])
def test_corr_kernel_residency(S, H, W, L, resident):
    """Which levels K1 keeps in shared memory, from the pyramid's shapes:
    one frame's map must fit beside the kernel's reserve (232,448 bytes in
    all) and measure at most 256 x 256; the rest are streamed."""
    fm = torch.zeros((S, 128, H, W))
    pyr = pack_pyramid(corr.build_pyramid(fm, L))
    assert resident_levels(pyr.shapes) == resident
    assert resident_map_bytes(24, 32) == 196608  # davis_demo's level 2
    assert resident_map_bytes(48, 64) + 3072 > 232448  # its level 1 does not fit
    assert resident_map_bytes(9, 13) == 2 * 15 * 1024  # halves rounded up to 1024 bytes


def test_flash_attention_direct_route_strides():
    """K4 reads q, k and v in place when they are head splits of packed rows
    (strides (N*R, 48, R, 1), R % 8 == 0, 16-byte bases): the tracker's
    views of one qkv. Contiguous (B, h, N, 48) tensors, rows that are not a
    multiple of 8 elements and misaligned bases take the folded route."""
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
    assert split_row_stride(q[..., :32]) is None  # head dim other than the kernel's 48


def test_attention_kv_source_of_wrong_width_raises(rng):
    qkv = torch.zeros((1, 5, 3 * 96))
    with pytest.raises(ValueError, match="kv"):
        fused_qkv_attention(qkv, 2, 0.1, kv=torch.zeros((1, 7, 96)))


def key_mask(kind, Nk: int, rng):
    """None: no mask. "random": 70 % of the Nk keys live. "tiles": the same
    with keys 0-127 (the bf16 kernel's whole first key tile) and 256-383 (a
    whole later tile) masked; below 129 keys every key is then masked, and
    each query averages all Nk values, as the plain version does."""
    if kind is None:
        return None
    m = rng.uniform(size=Nk) > 0.3
    if kind == "tiles":
        m[:128] = False
        m[256:384] = False
    return torch.from_numpy(m)


# ---------------------------------------------------------------- on the card
@pytest.mark.gpu
@pytest.mark.parametrize("L,shape,margin", [
    (4, (3, 70, 24, 32), 8.0),    # every level resident
    (2, (2, 33, 9, 13), 8.0),
    (3, (2, 50, 64, 80), 8.0),    # levels 0-1 streamed by TMA, level 2 resident
    (3, (2, 41, 16, 24), 60.0),   # most windows partly or wholly outside the map
    (3, (2, 50, 64, 80), 60.0),   # the same for streamed boxes: negative and far-out origins
    (3, (3, 301, 64, 80), 8.0),   # ragged last chunks: 301 tracks, 903 windows per level
])
def test_corr_kernel_matches_plain_on_gpu(rng, cuda, L, shape, margin):
    """K1 == its plain version on the same bf16 maps (1e-4), with levels
    kept in shared memory and levels streamed (resident_levels), windows
    far outside the map, and track counts that leave the last block's chunk
    ragged; only the main kernel's counter moves."""
    S, N, H, W = shape
    fm, tg, xy = (x.to(cuda) for x in _k1_inputs(rng, S=S, C=128, N=N, H=H, W=W, margin=margin))
    pyr = pack_pyramid(corr.build_pyramid(fm, L))
    counters = ("launches", "mxu_launches", "int8_launches")
    before = {c: getattr(corr_sample, c) for c in counters}
    out = corr_sample(pyr, tg, xy, 3)
    torch.cuda.synchronize()
    assert {c: getattr(corr_sample, c) - before[c] for c in counters} == {
        "launches": 1, "mxu_launches": 0, "int8_launches": 0}
    with full_fp32():
        torch.testing.assert_close(out, corr_sample_plain(pyr, tg, xy, 3), atol=1e-4, rtol=0)
    # a second call reuses the pyramid's tensor maps and gives the same output
    assert torch.equal(corr_sample(pyr, tg, xy, 3), out)


@pytest.mark.gpu
def test_corr_kernel_keeps_float32_targets_on_gpu(rng, cuda):
    """K1 contracts the float32 target as three bf16 terms on the tensor
    cores: within 3e-6 of a float64 evaluation of the same windows. A CPU
    emulation of the split over 20,000 windows (N(0, 1) maps and targets,
    scaled by 1/sqrt(128)) gives 6.2e-7 for three terms and 1.2e-5 for two,
    so this check sees a lost term that the 1e-4 limit against the float32
    plain version does not."""
    S, N, H, W, L = 2, 50, 64, 80, 3  # streamed and resident levels
    fm, tg, xy = (x.to(cuda) for x in _k1_inputs(rng, S=S, C=128, N=N, H=H, W=W))
    pyr = pack_pyramid(corr.build_pyramid(fm, L))
    out = corr_sample(pyr, tg, xy, 3)
    levels = [pyr.level(lvl).double().permute(0, 3, 1, 2) for lvl in range(L)]
    ref = corr.corr_sample_pyramid(levels, tg.double().transpose(0, 1), xy.double(), 3)
    torch.testing.assert_close(out.double(), ref.transpose(0, 1), atol=3e-6, rtol=0)


@pytest.mark.gpu
def test_corr_kernel_raises_on_what_it_does_not_take(rng, cuda):
    """No fallback: a radius other than 3 or a non-bf16 map raises on the card."""
    fm, tg, xy = (x.to(cuda) for x in _k1_inputs(rng, S=2, C=128, N=5, H=16, W=24))
    pyr = pack_pyramid(corr.build_pyramid(fm, 2))
    with pytest.raises(ValueError, match="radius"):
        corr_sample(pyr, tg, xy, 2)
    with pytest.raises(TypeError):
        corr_sample(pyr._replace(flat=pyr.flat.float()), tg, xy, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", [None, "random", "tiles"])
@pytest.mark.parametrize("N,H", [(333, 8), (70, 2)])
def test_attention_kernel_matches_plain_on_gpu(rng, cuda, dtype, mask_kind, N, H):
    """K2 packed; N = 333 and 70 leave the bf16 kernel's 128-query and
    128-key tiles ragged."""
    B, d = 3, 48  # the kernel's one head dim
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("source", ["slim", "packed"])
@pytest.mark.parametrize("mask_kind", [None, "random", "tiles"])
@pytest.mark.parametrize("Nk", [333, 37])
def test_attention_kv_kernel_matches_plain_on_gpu(rng, cuda, dtype, source, mask_kind, Nk):
    """K2 with a separate key/value source: queries (3, 150) against
    Nk = 333 keys (ragged key tiles) or 37 (fewer than one key tile) of a
    slim or packed source."""
    B, N, H, d = 3, 150, 8, 48
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1, 37, 129, 200, 333])
def test_vmem_attention_kernel_matches_plain_on_gpu(rng, cuda, dtype, N):
    """K3 on (B, N, 48): one key, fewer than one 128-key tile, one key past
    a tile, ragged second and third tiles."""
    q, k, v = (torch.from_numpy(rng.normal(size=(5, N, 48)).astype(np.float32)).to(cuda, dtype)
               for _ in range(3))
    before = vmem_attention.launches
    out = vmem_attention(q, k, v, 48 ** -0.5)
    torch.cuda.synchronize()
    assert vmem_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    with full_fp32():
        ref = vmem_attention_plain(q, k, v, 48 ** -0.5)
    tol = 1e-4 if dtype == torch.float32 else bf16_tol(ref.float())
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    with pytest.raises(ValueError, match="48"):
        vmem_attention(q[..., :32], k[..., :32], v[..., :32], 0.1)



@pytest.mark.gpu
@pytest.mark.parametrize("fmap_dtype,contract", [("bf16", "mxu"), ("int8", "vpu")])
@pytest.mark.parametrize("L,shape,margin", [(4, (3, 70, 24, 32), 8.0), (2, (2, 33, 9, 13), 8.0),
                                            (3, (2, 41, 16, 24), 60.0)])
def test_corr_kernel_options_match_plain_on_gpu(rng, cuda, fmap_dtype, contract, L, shape,
                                                margin):
    """K1's mxu and int8 variants == their plain versions (1e-4); the last
    shape puts most windows far outside the map, partly or wholly."""
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


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["split", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", [None, "random", "tiles"])
@pytest.mark.parametrize("N,H", [(333, 8), (70, 2)])
def test_flash_attention_kernel_matches_plain_on_gpu(rng, cuda, layout, dtype, mask_kind, N, H):
    """K4 on split heads (3, H, N, 48) taken from a packed qkv, as the
    tracker's split-head route gives them (read in place: the strided
    counter moves), and on contiguous (3, H, N, 48) tensors (folded into one
    head per batch row); N = 333 and 70 leave the bf16 kernel's 128-query
    and 128-key tiles ragged."""
    B, d = 3, 48
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
