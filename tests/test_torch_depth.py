"""Stage 1 of batrack_tpu_torch against batrack_tpu: the linear resize, the
pos-embed bicubic, DepthAnythingV2 layer by layer and whole, infer_depth,
the network's input (cv2's uint8 bicubic) and the alignment's
nearest-exact resize, the alignment, the weight round trips and the
safetensors reader.

The same seeded numpy inputs and the same weights go to both packages: the
port's modules are made from a seed, their weights moved off the default
init (torch_parity.perturb_), and the JAX package gets them through its own
converter (convert_da2_checkpoint). At vits and 70x98 inputs.

Tolerances: 1e-6 absolute for the linear resizes (inputs in [0, 1)), 1e-4
relative for the networks; the network's input, the nearest-exact resize
and the alignment bitwise.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import perturb_

from batrack_tpu.depth import align as jalign
from batrack_tpu.depth import dpt as jdpt
from batrack_tpu_torch.depth import align, dpt
from batrack_tpu_torch.ops.sampling import resize_linear
from batrack_tpu_torch.utils.tensorfile import read_safetensors, write_safetensors

ARCH = "vits"
HW = (70, 98)
RTOL = 1e-4


def rel_err(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return float(np.abs(port.astype(np.float64) - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def da2():
    """(port model, JAX module, Flax params, numpy state dict)."""
    torch.manual_seed(0)
    model = perturb_(dpt.DepthAnythingV2(ARCH), seed=1).eval()
    with torch.no_grad():
        # random weights put every disparity under the final ReLU's zero;
        # a positive bias keeps the output a function of the input
        model.depth_head.scratch.output_conv2[2].bias.fill_(1.0)
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    params = jax.tree.map(jnp.asarray, jdpt.convert_da2_checkpoint(sd, ARCH))
    jmodel = jdpt.DepthAnythingV2(ARCH, **dpt.HEADS[ARCH])
    return model, jmodel, params, sd


@pytest.fixture(scope="module")
def image_in():
    rng = np.random.default_rng(3)
    return rng.normal(size=(1,) + HW + (3,)).astype(np.float32)


@pytest.mark.parametrize("shape,out_hw", [((1, 10, 12, 3), (23, 7)), ((2, 42, 56, 5), (14, 18)),
                                          ((1, 126, 168, 3), (140, 182)),
                                          ((1, 7, 9, 2), (7, 30))])
def test_resize_linear_matches_jax_image_resize(shape, out_hw):
    x = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (shape[0],) + out_hw + (shape[3],), method="linear")
    got = resize_linear(torch.from_numpy(x), out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("offset,grid", [(0.1, (5, 7)), (0.0, (5, 7)), (0.1, (40, 45)),
                                         (0.0, (30, 44))])
def test_pos_embed_bicubic_matches_torch_bicubic_matrix(offset, grid):
    torch.manual_seed(0)
    enc = dpt.DINOv2(ARCH, interpolate_offset=offset)
    ph, pw = grid
    side = dpt.PRETRAIN_SIDE
    pos = enc.pos_embed.detach().numpy()
    inv = (side / (ph + offset), side / (pw + offset)) if offset else (side / ph, side / pw)
    Wh = jdpt._torch_bicubic_matrix(side, ph, inv[0]).astype(np.float64)
    Ww = jdpt._torch_bicubic_matrix(side, pw, inv[1]).astype(np.float64)
    grid_ref = np.einsum("hm,mnd,wn->hwd", Wh, pos[0, 1:].reshape(side, side, -1), Ww)
    got = enc.interpolate_pos_embed(ph, pw).detach().numpy()[0]
    np.testing.assert_array_equal(got[0], pos[0, 0])
    np.testing.assert_allclose(got[1:], grid_ref.reshape(ph * pw, -1), atol=1e-6, rtol=0)


def test_vit_block_matches_jax(da2):
    model, _, params, _ = da2
    dim, _, heads, _ = dpt.ARCHS[ARCH]
    x = np.random.default_rng(1).normal(size=(2, 37, dim)).astype(np.float32)
    ref = jdpt.ViTBlock(dim, heads).apply({"params": params["params"]["pretrained"]["block3"]},
                                          jnp.asarray(x))
    with torch.no_grad():
        got = model.pretrained.blocks[3](torch.from_numpy(x))
    assert rel_err(got, ref) < RTOL


def test_dinov2_taps_match_jax(da2, image_in):
    model, _, params, _ = da2
    take = dpt.ARCHS[ARCH][3]
    ref = jdpt.DINOv2(ARCH).apply({"params": params["params"]["pretrained"]},
                                  jnp.asarray(image_in), take)
    with torch.no_grad():
        got = model.pretrained(torch.from_numpy(image_in), take)
    assert len(got) == len(ref) == 4
    for (t, c), (tr, cr) in zip(got, ref):
        assert t.shape == tr.shape and c.shape == cr.shape
        assert rel_err(t, tr) < RTOL and rel_err(c, cr) < RTOL


def test_dpt_head_matches_jax(da2):
    model, _, params, _ = da2
    dim = dpt.ARCHS[ARCH][0]
    ph, pw = HW[0] // dpt.PATCH, HW[1] // dpt.PATCH
    rng = np.random.default_rng(2)
    feats = [(rng.normal(size=(1, ph * pw, dim)).astype(np.float32),
              rng.normal(size=(1, dim)).astype(np.float32)) for _ in range(4)]
    ref = jdpt.DPTHead(dim, **dpt.HEADS[ARCH]).apply(
        {"params": params["params"]["depth_head"]},
        [(jnp.asarray(t), jnp.asarray(c)) for t, c in feats], ph, pw)
    with torch.no_grad():
        got = model.depth_head([(torch.from_numpy(t), torch.from_numpy(c)) for t, c in feats],
                               ph, pw)
    assert got.shape == ref.shape == (1,) + HW
    assert float(np.asarray(ref).min()) > 0.0
    assert rel_err(got, ref) < RTOL


def test_depth_anything_v2_matches_jax(da2, image_in):
    model, jmodel, params, _ = da2
    ref = jmodel.apply(params, jnp.asarray(image_in))
    with torch.no_grad():
        got = model(torch.from_numpy(image_in))
    assert got.shape == ref.shape == (1,) + HW
    assert float(np.asarray(ref).std()) > 1e-3
    assert rel_err(got, ref) < RTOL


def test_infer_depth_matches_jax(da2):
    """infer_depth at a size that needs no resize (input_size 70 on 70x98),
    so both sides see the same pixels; the resize itself is held against
    cv2 below."""
    model, jmodel, params, _ = da2
    img = np.random.default_rng(4).integers(0, 256, HW + (3,), dtype=np.uint8)
    ref = jdpt.infer_depth(jmodel, params, img, input_size=70)
    got = dpt.infer_depth(model, img, input_size=70)
    assert got.shape == ref.shape == HW and got.dtype == np.float32
    assert rel_err(got, ref) < RTOL


def test_state_dict_round_trip_da2(da2):
    """port state dict -> convert_da2_checkpoint -> state_dict_from_flax is
    the identity, bitwise; what the Flax tree lacks (mask_token and
    refinenet4.resConfUnit1) comes through `unused`."""
    _, _, _, sd = da2
    params = jdpt.convert_da2_checkpoint(sd, ARCH)
    unused = {k: v for k, v in sd.items() if "refinenet4.resConfUnit1" in k or "mask_token" in k}
    assert len(unused) == 5
    back = dpt.state_dict_from_flax(params, ARCH, unused)
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype and np.array_equal(back[k], sd[k]), k
    model = dpt.DepthAnythingV2(ARCH)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in back.items()},
                          strict=True)


def test_load_checkpoint_takes_a_saved_state_dict(da2, tmp_path):
    model, _, _, sd = da2
    path = tmp_path / "da2.pth"
    torch.save({"model": model.state_dict()}, path)
    loaded = dpt.load_checkpoint(path, ARCH)
    for k, v in loaded.state_dict().items():
        assert np.array_equal(v.numpy(), sd[k]), k


# cv2's process-wide IPP setting as the process starts: on in cv2's default build
IPP_DEFAULT = cv2.ipp.useIPP()
IPP_SETTINGS = {"default": IPP_DEFAULT, "off": False}


@pytest.mark.parametrize("ipp", list(IPP_SETTINGS))
@pytest.mark.parametrize("src_hw,input_size", [((480, 640), 518), ((480, 854), 518),
                                               ((436, 1024), 518), ((127, 171), 518),
                                               ((126, 168), 126), ((37, 41), 70)])
def test_preprocess_against_jax(src_hw, input_size, ipp):
    """dpt.preprocess against the JAX package's, bitwise, with both under
    the same IPP setting (cv2 hands the uint8 bicubic to Intel IPP by
    default, whose rounding differs from OpenCV's own path). At the
    pipeline's frames (480x640, DAVIS 480x854, Sintel 436x1024) and at
    small and odd ones."""
    img = np.random.default_rng(sum(src_hw) + input_size).integers(
        0, 256, src_hw + (3,), dtype=np.uint8)
    before = cv2.ipp.useIPP()
    try:
        cv2.ipp.setUseIPP(IPP_SETTINGS[ipp])
        got = dpt.preprocess(img, input_size)
        ref = jdpt.preprocess(img, input_size)
    finally:
        cv2.ipp.setUseIPP(before)
    assert got.shape == ref.shape == (1,) + dpt.preprocess_shape(src_hw, input_size) + (3,)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("src_hw,dst_hw", [((126, 168), (126, 168)), ((126, 168), (252, 336)),
                                           ((480, 640), (240, 320)), ((518, 686), (480, 640)),
                                           ((37, 41), (100, 77))])
def test_resize_nearest_matches_jax(src_hw, dst_hw):
    """align.resize_nearest (the alignment's disparity resize) against the
    JAX package's, bitwise, at whole and other ratios."""
    img = np.random.default_rng(0).normal(size=src_hw).astype(np.float32)
    got = align.resize_nearest(img, dst_hw)
    ref = jalign.resize_nearest(img, dst_hw)
    assert got.shape == ref.shape == dst_hw and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_align_depth_sequence_matches_jax():
    rng = np.random.default_rng(6)
    T, H, W = 5, 42, 56
    metric = [rng.uniform(1.0, 8.0, (H, W)).astype(np.float32) for _ in range(T)]
    mono = [(1.0 / d) * rng.uniform(1.5, 2.0) + rng.uniform(0.0, 0.1)
            + rng.normal(0, 0.01, (H, W)).astype(np.float32) for d in metric]
    mono[2][:5] = 0.005                                      # a sky band
    mono[3] = mono[3][::2, ::2]                              # a disparity at half size
    Ks = [np.array([[60.0 + t, 0, 28], [0, 61.0, 21], [0, 0, 1]], np.float32) for t in range(T)]
    got, K = align.align_depth_sequence(mono, metric, Ks, (W, H))
    ref, Kr = jalign.align_depth_sequence(mono, metric, Ks, (W, H))
    np.testing.assert_array_equal(K, Kr)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_align_depth_dirs_reads_the_png_header(tmp_path):
    """The alignment's image size comes from the first frame's header (PNG
    or JPEG); a JPEG without a frame header raises."""
    from batrack_tpu_torch.data.image import image_size
    from batrack_tpu_torch.data.png import write_png

    rng = np.random.default_rng(7)
    write_png(tmp_path / "0000.png", rng.integers(0, 256, (30, 44, 3), dtype=np.uint8))
    assert image_size(tmp_path / "0000.png") == (30, 44)
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8")
    with pytest.raises(ValueError, match="start-of-frame"):
        image_size(tmp_path / "x.jpg")


def test_safetensors_writer_and_reader_round_trip(tmp_path):
    tensors = {"a.weight": torch.randn(3, 5), "b": torch.arange(7, dtype=torch.int64),
               "c": torch.randn(2, 2).to(torch.bfloat16), "empty": torch.zeros(0, 3),
               "flag": torch.tensor([True, False]), "h": torch.randn(4).half()}
    write_safetensors(tmp_path / "x.safetensors", tensors)
    back = read_safetensors(tmp_path / "x.safetensors")
    assert set(back) == set(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_safetensors_reader_matches_the_package(tmp_path):
    st = pytest.importorskip("safetensors.numpy")
    rng = np.random.default_rng(8)
    arrays = {"x": rng.normal(size=(4, 3)).astype(np.float32), "y": np.arange(5, dtype=np.int32),
              "z": rng.normal(size=(2, 1, 3)).astype(np.float64)}
    st.save_file(arrays, str(tmp_path / "pkg.safetensors"), metadata={"format": "np"})
    back = read_safetensors(tmp_path / "pkg.safetensors")
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        assert back[k].numpy().dtype == v.dtype and np.array_equal(back[k].numpy(), v)
    write_safetensors(tmp_path / "port.safetensors", {k: torch.from_numpy(v)
                                                       for k, v in arrays.items()})
    again = st.load_file(str(tmp_path / "port.safetensors"))
    for k, v in arrays.items():
        assert again[k].dtype == v.dtype and np.array_equal(again[k], v)


def test_pos_embed_cache_follows_the_weights():
    """Without autograd the resized grid is reused at the same grid size,
    and recomputed once pos_embed changes in place or another size is
    asked for; with autograd it is computed every call."""
    torch.manual_seed(0)
    enc = dpt.DINOv2(ARCH)
    with torch.no_grad():
        a = enc.interpolate_pos_embed(5, 7)
        assert enc.interpolate_pos_embed(5, 7) is a
        assert enc.interpolate_pos_embed(6, 7).shape == (1, 43, dpt.ARCHS[ARCH][0])
        b = enc.interpolate_pos_embed(5, 7)
        assert b is not a and torch.equal(a, b)
        enc.pos_embed.mul_(2.0)
        c = enc.interpolate_pos_embed(5, 7)
        assert torch.allclose(c, 2.0 * a)
    d = enc.interpolate_pos_embed(5, 7)
    assert d.requires_grad and d is not c and torch.equal(d, c)
