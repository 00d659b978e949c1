"""batrack_tpu_torch.ops against batrack_tpu.ops on the same inputs.

Tolerances (float32): sampling and embeddings 1e-5; the plain S-major
correlation against ops/corr.py 1e-4; K1's plain version against the Pallas
kernel in interpret mode 2e-2 (both read the feature maps in bf16); K2's
plain version against the Pallas kernel in interpret mode 2e-5, with a
separate kv= source 1e-5; K3's plain version against the Pallas kernel in
interpret mode 1e-5; the tile-edge cases (ragged 128-query and 128-key
tiles, whole masked key tiles) 1e-5; a row with every key masked, where
the Pallas kernel also averages its zero padding, 1e-5 against the
reference scaled by padded over live keys. The CUDA kernels themselves are held
against their plain versions on the card in tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from batrack_tpu.ops import corr as jcorr
from batrack_tpu.ops import embeddings as jemb
from batrack_tpu.ops import sampling as jsamp
from batrack_tpu_torch.ops import corr, embeddings, sampling
from batrack_tpu_torch.ops.attention import (
    fused_qkv_attention,
    fused_qkv_attention_plain,
    vmem_attention,
    vmem_attention_plain,
)
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


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("source", ["slim", "packed"])
def test_attention_kv_source_plain_matches_pallas_interpret(rng, source, masked):
    """K2 with a separate key/value source (the track-sharded path): queries
    from qkv (N = 37), keys and values from a slim (B, Nk, 2C) or packed
    (B, Nk, 3C) array with Nk = 53, key mask of length Nk."""
    from batrack_tpu.ops.pallas_attention import fused_qkv_attention as jfused

    B, N, Nk, H, d = 2, 37, 53, 2, 48
    C = H * d
    qkv = rng.normal(size=(B, N, 3 * C)).astype(np.float32)
    kv = rng.normal(size=(B, Nk, (2 if source == "slim" else 3) * C)).astype(np.float32)
    mask = rng.uniform(size=Nk) > 0.3 if masked else None
    ref = jfused(j(qkv), H, d ** -0.5, interpret=True, kv=j(kv),
                 key_mask=None if mask is None else j(mask))
    tmask = None if mask is None else t(mask)
    out = fused_qkv_attention(t(qkv), H, d ** -0.5, tmask, kv=t(kv))  # CPU -> plain version
    assert out.shape == (B, N, C)
    assert_close(out, ref, atol=1e-5)
    assert_close(fused_qkv_attention_plain(t(qkv), H, d ** -0.5, tmask, kv=t(kv)), out, atol=0)


def test_vmem_attention_plain_matches_pallas_interpret(rng):
    """K3: single-head softmax(q k^T * scale) v over (B, N, 48)."""
    from batrack_tpu.ops.pallas_attention import vmem_attention as jvmem

    q, k, v = (rng.normal(size=(3, 37, 48)).astype(np.float32) for _ in range(3))
    ref = jvmem(j(q), j(k), j(v), 48 ** -0.5, interpret=True)
    out = vmem_attention(t(q), t(k), t(v), 48 ** -0.5)  # CPU tensor -> plain version
    assert out.shape == (3, 37, 48)
    assert_close(out, ref, atol=1e-5)
    assert_close(vmem_attention_plain(t(q), t(k), t(v), 48 ** -0.5), out, atol=0)


def _edge_mask(rng, Nk, kind):
    """None; or 70 % of the keys live at random with keys 0-127 masked (the
    CUDA kernel's whole first key tile) and, where they exist, keys 256-383
    (a whole later tile). Every row keeps live keys: with all keys masked
    the TPU kernel also averages its zero-padded keys, which the port does
    not (test_attention_all_masked_row_vs_pallas_interpret)."""
    if kind is None:
        return None
    m = rng.uniform(size=Nk) > 0.3
    if kind == "tiles":
        m[:128] = False
        m[256:384] = False
    m[-1] = True
    return m


@pytest.mark.parametrize("source,N,Nk,mask", [
    (None, 200, 200, None), (None, 200, 200, "tiles"),
    ("slim", 37, 300, None), ("slim", 37, 300, "tiles"), ("packed", 37, 300, "tiles"),
    ("slim", 37, 50, None), ("slim", 37, 50, "random"), ("packed", 37, 50, "random")])
def test_attention_tile_edges_plain_match_pallas_interpret(rng, source, N, Nk, mask):
    """K2's plain version against the Pallas kernel (interpret mode) where
    the CUDA kernel's 128-query and 128-key tiles are ragged (N and Nk not
    multiples of 128, Nk below one key tile) and whole key tiles are
    masked, with the packed qkv or a slim or packed kv= source."""
    from batrack_tpu.ops.pallas_attention import fused_qkv_attention as jfused

    B, H, d = 2, 2, 48
    C = H * d
    qkv = rng.normal(size=(B, N, 3 * C)).astype(np.float32)
    kv = None if source is None else rng.normal(
        size=(B, Nk, (2 if source == "slim" else 3) * C)).astype(np.float32)
    m = _edge_mask(rng, Nk, mask)
    ref = jfused(j(qkv), H, d ** -0.5, interpret=True, kv=None if kv is None else j(kv),
                 key_mask=None if m is None else j(m))
    out = fused_qkv_attention(t(qkv), H, d ** -0.5, None if m is None else t(m),
                              kv=None if kv is None else t(kv))  # CPU tensor -> plain version
    assert out.shape == (B, N, C)
    assert_close(out, ref, atol=1e-5)


@pytest.mark.parametrize("source,N,Nk", [(None, 70, 70), (None, 200, 200), ("slim", 37, 50),
                                         ("packed", 37, 300)])
def test_attention_all_masked_row_vs_pallas_interpret(rng, source, N, Nk):
    """Every key masked: each query's softmax is uniform. The port averages
    the Nk values; the Pallas kernel gives its zero-padded keys (up to Nkp,
    the next multiple of 128) the same -1e30 logit, so it averages Nkp
    values of which Nkp - Nk are zero. Port = reference * Nkp / Nk."""
    from batrack_tpu.ops.pallas_attention import fused_qkv_attention as jfused

    B, H, d = 2, 2, 48
    C = H * d
    qkv = rng.normal(size=(B, N, 3 * C)).astype(np.float32)
    kv = None if source is None else rng.normal(
        size=(B, Nk, (2 if source == "slim" else 3) * C)).astype(np.float32)
    m = np.zeros(Nk, bool)
    ref = jfused(j(qkv), H, d ** -0.5, interpret=True, kv=None if kv is None else j(kv),
                 key_mask=j(m))
    out = fused_qkv_attention(t(qkv), H, d ** -0.5, t(m), kv=None if kv is None else t(kv))
    src = qkv if kv is None else kv
    koff = src.shape[-1] - 2 * C
    mean_v = src[..., koff + C: koff + 2 * C].mean(1, keepdims=True)  # (B, 1, C)
    assert_close(out, np.broadcast_to(mean_v, (B, N, C)), atol=1e-5)
    nkp = -(-Nk // 128) * 128
    assert_close(out, np.asarray(ref) * (nkp / Nk), atol=1e-5)


@pytest.mark.parametrize("N", [1, 150])
def test_vmem_attention_tile_edges_plain_match_pallas_interpret(rng, N):
    """K3's plain version against the Pallas kernel at one key and at a
    ragged second 128-key tile."""
    from batrack_tpu.ops.pallas_attention import vmem_attention as jvmem

    q, k, v = (rng.normal(size=(2, N, 48)).astype(np.float32) for _ in range(3))
    ref = jvmem(j(q), j(k), j(v), 48 ** -0.5, interpret=True)
    assert_close(vmem_attention(t(q), t(k), t(v), 48 ** -0.5), ref, atol=1e-5)
