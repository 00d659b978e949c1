"""batrack_tpu_torch.ops against batrack_tpu.ops on the same inputs.

Tolerances (float32): sampling and embeddings 1e-5; the plain S-major
correlation against ops/corr.py 1e-4; K1's plain version against the Pallas
kernel in interpret mode 2e-2 (both read the feature maps in bf16); K2's
plain version against the Pallas kernel in interpret mode 2e-5. The CUDA
kernels themselves are held against their plain versions on the card in
tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from batrack_tpu.ops import corr as jcorr
from batrack_tpu.ops import embeddings as jemb
from batrack_tpu.ops import sampling as jsamp
from batrack_tpu_torch.ops import corr, embeddings, sampling
from batrack_tpu_torch.ops.attention import fused_qkv_attention
from batrack_tpu_torch.ops.corr_kernel import corr_sample, corr_sample_plain, pack_pyramid
from torch_parity import assert_close, j, t


def _coords(rng, B, N, H, W, margin=3.0):
    return np.stack([rng.uniform(-margin, W + margin, (B, N)),
                     rng.uniform(-margin, H + margin, (B, N))], -1).astype(np.float32)


def test_bilinear_sample2d_matches_jax(rng):
    im = rng.normal(size=(2, 5, 9, 13)).astype(np.float32)
    xy = _coords(rng, 2, 40, 9, 13)
    out = sampling.bilinear_sample2d(t(im), t(xy[..., 0]), t(xy[..., 1]))
    ref = jsamp.bilinear_sample2d(j(im), j(xy[..., 0]), j(xy[..., 1]))
    assert_close(out, ref, atol=1e-5)


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_patchify_matches_jax(rng, mode):
    im = rng.normal(size=(2, 4, 10, 12)).astype(np.float32)
    xy = _coords(rng, 2, 25, 10, 12)
    out = sampling.patchify(t(im), t(xy), 3, padding_mode=mode)
    ref = jsamp.patchify(j(im), j(xy), 3, padding_mode=mode)
    assert_close(out, ref, atol=1e-5)


def test_bilinear_sample_per_frame_matches_jax(rng):
    maps = rng.normal(size=(3, 8, 11, 6)).astype(np.float32)
    fi = rng.integers(0, 3, 30)
    xy = _coords(rng, 1, 30, 8, 11)[0]
    out = sampling.bilinear_sample_per_frame(t(maps), t(fi), t(xy))
    ref = jsamp.bilinear_sample_per_frame(j(maps), j(fi), j(xy))
    assert_close(out, ref, atol=1e-5)


@pytest.mark.parametrize("align", [False, True])
def test_interpolate_and_pool_match_jax(rng, align):
    im = rng.normal(size=(2, 3, 12, 16)).astype(np.float32)
    for hw in [(9, 20), (6, 8)]:
        out = sampling.interpolate_bilinear(t(im), hw, align_corners=align)
        ref = jsamp.interpolate_bilinear(j(im), hw, align_corners=align)
        assert_close(out, ref, atol=1e-5)
    assert_close(sampling.avg_pool2d(t(im), 2), jsamp.avg_pool2d(j(im), 2), atol=1e-5)


def test_embeddings_match_jax(rng):
    xyz = rng.normal(size=(4, 7, 3)).astype(np.float32)
    assert_close(embeddings.get_3d_embedding(t(xyz), 64), jemb.get_3d_embedding(j(xyz), 64),
                 atol=1e-5)
    fe, jfe = embeddings.FourierEmbedder(3, 10.0, 10), jemb.FourierEmbedder(3, 10.0, 10)
    small = xyz * 0.1
    assert_close(fe(t(small)), jfe(j(small)), atol=1e-5)
    np.testing.assert_array_equal(embeddings.get_2d_sincos_pos_embed(456, (6, 8)),
                                  jemb.get_2d_sincos_pos_embed(456, (6, 8)))


def test_corr_pyramid_plain_matches_jax(rng):
    S, C, N, H, W = 2, 32, 30, 16, 20
    fm = rng.normal(size=(S, C, H, W)).astype(np.float32)
    tg = rng.normal(size=(S, N, C)).astype(np.float32)
    xy = _coords(rng, S, N, H, W, margin=6.0)
    out = corr.corr_sample_pyramid(corr.build_pyramid(t(fm), 3), t(tg), t(xy), 3)
    ref = jcorr.corr_sample_pyramid(jcorr.build_pyramid(j(fm), 3), j(tg), j(xy), 3)
    assert_close(out, ref, atol=1e-4)


def _k1_inputs(rng, S=2, C=128, N=16, H=16, W=24, L=3):
    fm = rng.normal(size=(S, C, H, W)).astype(np.float32)
    tg = rng.normal(size=(N, S, C)).astype(np.float32)
    xy = _coords(rng, S, N, H, W, margin=8.0)
    return fm, tg, xy, L


def test_corr_kernel_plain_matches_pallas_interpret(rng):
    """K1's plain version == the TPU kernel (Pallas interpret mode), both on
    bf16 feature maps, track-major (N, S, L*49), all levels at once."""
    from batrack_tpu.ops.pallas_corr import corr_sample_levels_pallas

    fm, tg, xy, L = _k1_inputs(rng)
    jpyr = jcorr.build_pyramid(j(fm), L)
    ref = jnp.concatenate(corr_sample_levels_pallas(
        jpyr, j(tg), j(xy), 3, block_n=8, group=8, interpret=True), axis=-1)
    pyr = pack_pyramid(corr.build_pyramid(t(fm), L))
    out = corr_sample(pyr, t(tg), t(xy), 3)  # CPU tensor -> plain version
    assert out.shape == (16, 2, L * 49)
    assert_close(out, ref, atol=2e-2)
    assert_close(corr_sample_plain(pyr, t(tg), t(xy), 3), out, atol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_plain_matches_pallas_interpret(rng, masked):
    from batrack_tpu.ops.pallas_attention import fused_qkv_attention as jfused

    B, N, H, d = 2, 150, 4, 48
    qkv = rng.normal(size=(B, N, 3 * H * d)).astype(np.float32)
    mask = rng.uniform(size=N) > 0.3 if masked else None
    ref = jfused(j(qkv), H, d ** -0.5, interpret=True,
                 key_mask=None if mask is None else j(mask))
    out = fused_qkv_attention(t(qkv), H, d ** -0.5, None if mask is None else t(mask))
    assert_close(out, ref, atol=2e-5)
