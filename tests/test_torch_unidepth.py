"""UniDepthV2 of batrack_tpu_torch against batrack_tpu, in pieces: the
functional pieces, Nystrom attention and each decoder head (the depth head
with exact and with Nystrom self-attention). The whole network, `infer` and
the weights are in test_torch_unidepth_net.py.

Same seeded inputs and weights on both sides (the JAX package takes the
port's state dict through convert_unidepth_checkpoint), at vits. Tolerance
1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import perturb_

from batrack_tpu.depth import unidepth as jud
from batrack_tpu_torch.depth import unidepth as ud

ARCH = "vits"
RTOL = 1e-4
IMG_HW = (126, 168)
K = np.array([[150.0, 0, 84], [0, 150.0, 63], [0, 0, 1]], np.float32)


def rel_err(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return float(np.abs(port.astype(np.float64) - ref).max() / max(np.abs(ref).max(), 1e-30))


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def nets():
    """(port model, JAX module, Flax params, numpy state dict)."""
    torch.manual_seed(0)
    model = perturb_(ud.UniDepthV2(ARCH), seed=1).eval()
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    params = jax.tree.map(jnp.asarray, jud.convert_unidepth_checkpoint(sd, ARCH))
    return model, jud.UniDepthV2(ARCH), params, sd


@pytest.fixture(scope="module")
def decoder_inputs():
    """Seeded decoder inputs at a 12x16 token grid (image 168x224): 192
    tokens, more than the 128 Nystrom landmarks."""
    rng = np.random.default_rng(2)
    shapes, hw = (12, 16), (168, 224)
    n = shapes[0] * shapes[1]
    feats = [rng.normal(size=(1, n, ud.HIDDEN)).astype(np.float32) for _ in range(4)]
    cls = rng.normal(size=(1, 4, ud.HIDDEN)).astype(np.float32)
    pos = rng.normal(size=(1, 4 * n, ud.HIDDEN)).astype(np.float32)
    level = rng.normal(size=(1, 4 * n, ud.HIDDEN)).astype(np.float32)
    rays = rng.normal(size=(1, hw[0] * hw[1], 3)).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    return dict(feats=feats, cls=cls, pos=pos, level=level, rays=rays, shapes=shapes, hw=hw)


def test_functional_pieces_match_jax():
    rng = np.random.default_rng(0)
    Kb = np.stack([K, K * np.array([[1.1, 1, 0.9], [1, 0.95, 1.05], [1, 1, 1]], np.float32)])
    for a, b in zip(ud.generate_rays(t(Kb), (24, 32)), jud.generate_rays(jnp.asarray(Kb), (24, 32))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    sph = np.concatenate([rng.uniform(-1, 1, (2, 50, 1)), rng.uniform(0.5, 2.5, (2, 50, 1)),
                          rng.uniform(1, 5, (2, 50, 1))], -1).astype(np.float32)
    assert rel_err(ud.spherical_zbuffer_to_euclidean(t(sph)),
                   jud.spherical_zbuffer_to_euclidean(jnp.asarray(sph))) < 1e-6
    x = rng.uniform(-1, 1, (2, 40, 3)).astype(np.float32)
    np.testing.assert_allclose(ud.fourier_features(t(x), ud.CAMERA_DIM, 14).numpy(),
                               np.asarray(jud.fourier_features(jnp.asarray(x), ud.CAMERA_DIM, 14)),
                               atol=2e-5)
    f = rng.uniform(size=(1, 42 * 56, 3)).astype(np.float32)
    np.testing.assert_allclose(ud.flat_interpolate(t(f), (42, 56), (6, 8)).numpy(),
                               np.asarray(jud.flat_interpolate(jnp.asarray(f), (42, 56), (6, 8))),
                               atol=1e-6)
    np.testing.assert_array_equal(ud.sine_pos_embed((5, 7), 64), jud.sine_pos_embed((5, 7), 64))
    img = rng.normal(size=(1, 5, 6, 8)).astype(np.float32)
    np.testing.assert_allclose(
        ud._upsample2x_align_corners(t(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy(),
        np.asarray(jud._upsample2x_align_corners(jnp.asarray(img))), atol=1e-6)
    np.testing.assert_array_equal(
        torch.nn.functional.pixel_shuffle(t(img).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1),
        np.asarray(jud._pixel_shuffle2(jnp.asarray(img))))
    a = np.asarray(jax.nn.softmax(jnp.asarray(rng.normal(size=(2, 16, 16)).astype(np.float32))))
    assert rel_err(ud._iterative_pinv(t(a)), jud._iterative_pinv(jnp.asarray(a))) < 1e-4


@pytest.mark.parametrize("n", [64, 300, 2400])
def test_nystrom_attention_matches_jax(n):
    """Fewer tokens than landmarks (exact), a trailing partial segment
    (300 = 128 x 3 - 84) and the vitl decoder's 2400 tokens."""
    rng = np.random.default_rng(n)
    q, k, v = (rng.normal(size=(1, 2, n, 32)).astype(np.float32) * 0.5 for _ in range(3))
    ref = jud._nystrom_attention(*map(jnp.asarray, (q, k, v)))
    got = ud._nystrom_attention(t(q), t(k), t(v))
    assert rel_err(got, ref) < RTOL


def test_camera_head_matches_jax(nets, decoder_inputs):
    model, _, params, _ = nets
    d = decoder_inputs
    ref = jax.jit(jud.CameraHead().apply)(
        {"params": params["params"]["pixel_decoder"]["camera_layer"]},
        [jnp.asarray(f) for f in d["feats"]], jnp.asarray(d["cls"]), jnp.asarray(d["pos"]))
    with torch.no_grad():
        got = model.pixel_decoder.camera_layer([t(f) for f in d["feats"]], t(d["cls"]),
                                               t(d["pos"]))
    assert rel_err(got, ref) < RTOL


def test_global_head_matches_jax(nets, decoder_inputs):
    model, _, params, _ = nets
    d = decoder_inputs
    ref = jax.jit(jud.GlobalHead().apply, static_argnums=(4, 5))(
        {"params": params["params"]["pixel_decoder"]["global_layer"]},
        [jnp.asarray(f) for f in d["feats"]], jnp.asarray(d["cls"][:, :2]),
        jnp.asarray(d["rays"]), d["hw"], d["shapes"])
    with torch.no_grad():
        got = model.pixel_decoder.global_layer([t(f) for f in d["feats"]], t(d["cls"][:, :2]),
                                               t(d["rays"]), d["hw"], d["shapes"])
    for a, b in zip(got, ref):
        assert rel_err(a, b) < RTOL


@pytest.mark.parametrize("use_nystrom", [False, True])
def test_depth_head_matches_jax(nets, decoder_inputs, use_nystrom):
    model, _, params, _ = nets
    d = decoder_inputs
    ref = jax.jit(jud.DepthHead(use_nystrom).apply, static_argnums=(5, 6))(
        {"params": params["params"]["pixel_decoder"]["depth_layer"]},
        [jnp.asarray(f) for f in d["feats"]], jnp.asarray(d["rays"]), jnp.asarray(d["pos"]),
        jnp.asarray(d["level"]), d["hw"], d["shapes"])
    head = ud.DepthHead(use_nystrom=use_nystrom)
    head.load_state_dict(model.pixel_decoder.depth_layer.state_dict())
    with torch.no_grad():
        got = head([t(f) for f in d["feats"]], t(d["rays"]), t(d["pos"]), t(d["level"]),
                   d["hw"], d["shapes"])
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert rel_err(a, b) < RTOL
