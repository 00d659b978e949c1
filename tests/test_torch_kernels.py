"""The hand-written CUDA kernels of batrack_tpu_torch against their plain
PyTorch versions. This file imports no JAX, so it also runs on a GPU
machine without it: `python -m pytest tests/test_torch_kernels.py -q`.

On the CPU it checks the layout code around the kernels (the packed bf16
pyramid, the plain attention against a textbook split-head softmax). The
kernel tests are marked gpu and skip without a CUDA device. Tolerances:
K1 1e-4 (same bf16 maps, float32 sums in another order); K2 1e-4 in
float32, and in bf16 two bf16 ulps of the largest output magnitude
(`bf16_tol`): both versions cast the probabilities to bf16 for the PV
product (the plain one after normalising, the kernel before, relative to
its running maximum) and round the output to bf16, so a correct kernel is
one output rounding off the plain version, while a kernel that drops a
key tile is many ulps off.
"""

import math

import numpy as np
import pytest
import torch

from batrack_tpu_torch.ops import corr
from batrack_tpu_torch.ops.attention import fused_qkv_attention, fused_qkv_attention_plain
from batrack_tpu_torch.ops.corr_kernel import corr_sample, corr_sample_plain, pack_pyramid
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


# ---------------------------------------------------------------- on the card
@pytest.mark.gpu
@pytest.mark.parametrize("L,shape", [(4, (3, 70, 24, 32)), (2, (2, 33, 9, 13))])
def test_corr_kernel_matches_plain_on_gpu(rng, cuda, L, shape):
    """K1 == its plain version on the same bf16 maps (1e-4)."""
    S, N, H, W = shape
    fm, tg, xy = (x.to(cuda) for x in _k1_inputs(rng, S=S, C=128, N=N, H=H, W=W))
    pyr = pack_pyramid(corr.build_pyramid(fm, L))
    before = corr_sample.launches
    out = corr_sample(pyr, tg, xy, 3)
    torch.cuda.synchronize()
    assert corr_sample.launches == before + 1
    with full_fp32():
        torch.testing.assert_close(out, corr_sample_plain(pyr, tg, xy, 3), atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("N,H", [(333, 8), (70, 2)])
def test_attention_kernel_matches_plain_on_gpu(rng, cuda, dtype, masked, N, H):
    B, d = 3, 48  # the kernel's one head dim
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * H * d)).astype(np.float32)).to(cuda, dtype)
    mask = torch.from_numpy(rng.uniform(size=N) > 0.3).to(cuda) if masked else None
    before = fused_qkv_attention.launches
    out = fused_qkv_attention(qkv, H, d ** -0.5, mask)
    torch.cuda.synchronize()
    assert fused_qkv_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, N, H * d)
    with full_fp32():
        ref = fused_qkv_attention_plain(qkv, H, d ** -0.5, mask)
    tol = 1e-4 if dtype == torch.float32 else bf16_tol(ref.float())
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
