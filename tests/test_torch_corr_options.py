"""K1's options in batrack_tpu_torch against batrack_tpu's Pallas kernel.

contract="mxu" (the target rounded to bf16, tensor-core contraction) and
fmap_dtype="int8" (per-level symmetric int8 maps, scale amax/127 folded into
1/sqrt(C)): the port's plain versions against
corr_sample_levels_pallas(..., interpret=True) with the same option, on the
same pyramid levels (built once by the JAX package and handed to both, so
the bf16 rounding and the int8 quantisation see identical inputs). Each
case is run on a float32 and on a bf16 pyramid: the int8 quantisation is
computed in the pyramid's own dtype, and the two differ by about 2e-2.

Tolerance 1e-5 absolute (outputs up to about 2.3): the products are exact
in float32 on both sides, and the sums run in another order. The CUDA
kernels are held against these plain versions on the card in
tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batrack_tpu.ops import corr as jcorr
from batrack_tpu.ops.pallas_corr import _pad_fmap, corr_sample_levels_pallas
from batrack_tpu_torch.ops.corr_kernel import corr_sample, corr_sample_plain, pack_pyramid
from torch_parity import assert_close, j, t

S, C, N, H, W, L, R = 2, 128, 16, 16, 24, 3, 3
DTYPES = {"float32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(rng, dtype):
    """The JAX pyramid in `dtype` and the same levels as torch tensors."""
    fm = rng.normal(size=(S, C, H, W)).astype(np.float32)
    tg = rng.normal(size=(N, S, C)).astype(np.float32)
    xy = np.stack([rng.uniform(-8, W + 8, (S, N)), rng.uniform(-8, H + 8, (S, N))],
                  -1).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jpyr = jcorr.build_pyramid(j(fm).astype(jdt), L)
    tpyr = [t(np.asarray(p.astype(jnp.float32))).to(tdt) for p in jpyr]
    return jpyr, tpyr, tg, xy


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("fmap_dtype,contract", [("bf16", "mxu"), ("int8", "vpu")])
def test_corr_option_plain_matches_pallas_interpret(rng, dtype, fmap_dtype, contract):
    jpyr, tpyr, tg, xy = _inputs(rng, dtype)
    ref = jnp.concatenate(corr_sample_levels_pallas(
        jpyr, j(tg), j(xy), R, block_n=8, group=8, interpret=True, contract=contract,
        fmap_dtype=fmap_dtype), axis=-1)
    pyr = pack_pyramid(tpyr, fmap_dtype)
    out = corr_sample(pyr, t(tg), t(xy), R, contract=contract)  # CPU tensor -> plain version
    assert out.shape == (N, S, L * (2 * R + 1) ** 2)
    assert_close(out, ref, atol=1e-5)
    assert_close(corr_sample_plain(pyr, t(tg), t(xy), R, contract=contract), out, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_int8_pack_matches_pad_fmap(rng, dtype):
    """pack_pyramid(fmap_dtype="int8") gives _pad_fmap's int8 values inside
    the padding and its scales, exactly, quantising in the pyramid's dtype."""
    jpyr, tpyr, _, _ = _inputs(rng, dtype)
    pyr = pack_pyramid(tpyr, "int8")
    assert pyr.flat.dtype == torch.int8 and pyr.scales.dtype == torch.float32
    pad = 2 * R + 2
    for lvl, p in enumerate(jpyr):
        q, scale = _pad_fmap(p, R, "int8")
        h, w = p.shape[2:]
        np.testing.assert_array_equal(pyr.level(lvl).numpy(),
                                      np.asarray(q)[:, pad:pad + h, pad:pad + w, :])
        assert pyr.scales[lvl].item() == float(jnp.asarray(scale, jnp.float32))


def test_int8_maps_refuse_the_mxu_contraction(rng):
    _, tpyr, tg, xy = _inputs(rng, "float32")
    pyr = pack_pyramid(tpyr, "int8")
    with pytest.raises(ValueError, match="int8"):
        corr_sample(pyr, t(tg), t(xy), R, contract="mxu")
    with pytest.raises(ValueError, match="int8"):
        corr_sample_plain(pyr, t(tg), t(xy), R, contract="mxu")
    with pytest.raises(ValueError, match="contract"):
        corr_sample(pack_pyramid(tpyr), t(tg), t(xy), R, contract="tensor")
    with pytest.raises(ValueError, match="fmap_dtype"):
        pack_pyramid(tpyr, "fp8")


@pytest.mark.parametrize("radius,channels,fmap_dtype", [(4, 64, "int8"), (1, 256, "bf16")])
def test_corr_plain_matches_pallas_interpret_at_other_widths(rng, radius, channels, fmap_dtype):
    """K1's plain version at widths beside the tracker's (radius 4 on 64
    channels, radius 1 on 256; the kernel is built per width) against the
    Pallas kernel with the same radius and channel count, on the same float32
    levels, 1e-5 as above."""
    fm = rng.normal(size=(S, channels, H, W)).astype(np.float32)
    tg = rng.normal(size=(8, S, channels)).astype(np.float32)
    xy = np.stack([rng.uniform(-8, W + 8, (S, 8)), rng.uniform(-8, H + 8, (S, 8))],
                  -1).astype(np.float32)
    jpyr = jcorr.build_pyramid(j(fm), 2)
    ref = jnp.concatenate(corr_sample_levels_pallas(
        jpyr, j(tg), j(xy), radius, block_n=8, group=8, interpret=True,
        fmap_dtype=fmap_dtype), axis=-1)
    pyr = pack_pyramid([t(np.asarray(p)) for p in jpyr], fmap_dtype)
    out = corr_sample(pyr, t(tg), t(xy), radius)  # CPU tensor -> plain version
    assert out.shape == (8, S, 2 * (2 * radius + 1) ** 2)
    assert_close(out, ref, atol=1e-5)
