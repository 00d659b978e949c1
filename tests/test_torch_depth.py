"""Stage 1 of batrack_tpu_torch against batrack_tpu: the linear resize, the
pos-embed bicubic, DepthAnythingV2 layer by layer and whole, infer_depth,
the numpy replicas of OpenCV's uint8 bicubic and nearest-exact resizes,
the alignment, the weight round trips and the safetensors reader.

The same seeded numpy inputs and the same weights go to both packages: the
port's modules are made from a seed, their weights moved off the default
init (torch_parity.perturb_), and the JAX package gets them through its own
converter (convert_da2_checkpoint). At vits and 70x98 inputs.

Tolerances: 1e-6 absolute for the resizes (inputs in [0, 1)), 1e-4
relative for the networks; the replicas and the alignment bitwise.
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
from batrack_tpu_torch.depth import align, cvresize, dpt
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


CUBIC_SHAPES = [((480, 640), (518, 686)), ((126, 168), (140, 182)), ((126, 168), (98, 126)),
                ((37, 41), (100, 77)), ((480, 640), (240, 320)), ((127, 171), (518, 700))]


@pytest.mark.parametrize("src_hw,dst_hw", CUBIC_SHAPES)
def test_cubic_replica_matches_opencv(src_hw, dst_hw):
    """Bitwise against OpenCV's own uint8 INTER_CUBIC (its fixed-point
    horizontal pass and float32 SIMD lanes), which cv2 runs with IPP off.
    cv2's default build hands this resize to Intel IPP, whose rounding
    differs: there the replica is held to one uint8 level, and the count of
    values that differ is printed."""
    rng = np.random.default_rng(sum(src_hw + dst_hw))
    img = rng.integers(0, 256, src_hw + (3,), dtype=np.uint8)
    got = cvresize.resize_cubic_u8(img, dst_hw)
    use_ipp = cv2.ipp.useIPP()
    try:
        cv2.ipp.setUseIPP(False)
        ref = cv2.resize(img, dst_hw[::-1], interpolation=cv2.INTER_CUBIC)
        np.testing.assert_array_equal(got, ref)
        gray = np.ascontiguousarray(img[..., 1])
        np.testing.assert_array_equal(cvresize.resize_cubic_u8(gray, dst_hw),
                                      cv2.resize(gray, dst_hw[::-1], interpolation=cv2.INTER_CUBIC))
    finally:
        cv2.ipp.setUseIPP(use_ipp)
    default = cv2.resize(img, dst_hw[::-1], interpolation=cv2.INTER_CUBIC)
    diff = np.abs(got.astype(int) - default)
    print(f"cv2 default (IPP {use_ipp}) {src_hw}->{dst_hw}: {(diff > 0).sum()} of {diff.size} "
          "values differ by one level")
    assert diff.max() <= 1


@pytest.mark.parametrize("src_hw,dst_hw", [((126, 168), (126, 168)), ((126, 168), (252, 336)),
                                           ((480, 640), (240, 320)), ((518, 686), (480, 640)),
                                           ((37, 41), (100, 77))])
def test_nearest_exact_replica(src_hw, dst_hw):
    """OpenCV 4's INTER_NEAREST_EXACT rule, source (x * ifx + ifx/2 - W%2) >>
    16 in 16.16 fixed point: equal to cv2 at the shapes the pipeline gives it
    (the disparity and the metric depth are both at the frame's size) and at
    whole ratios; at other ratios the cv2 build here (5.x) moves a source
    index that sits on a pixel boundary by one at some outputs, so there each
    index is held within one of cv2's and the count is printed."""
    rng = np.random.default_rng(0)
    img = rng.normal(size=src_hw).astype(np.float32)
    got = cvresize.resize_nearest_exact(img, dst_hw)
    ref = cv2.resize(img, dst_hw[::-1], interpolation=cv2.INTER_NEAREST_EXACT)
    assert got.shape == ref.shape == dst_hw
    ratio_whole = all(a % b == 0 or b % a == 0 for a, b in zip(src_hw, dst_hw))
    if ratio_whole:
        np.testing.assert_array_equal(got, ref)
        return
    idx = np.arange(np.prod(src_hw), dtype=np.float64).reshape(src_hw)
    gi = cvresize.resize_nearest_exact(idx, dst_hw)
    ri = cv2.resize(idx.astype(np.float32), dst_hw[::-1], interpolation=cv2.INTER_NEAREST_EXACT)
    dy = np.abs(gi // src_hw[1] - ri // src_hw[1])
    dx = np.abs(gi % src_hw[1] - ri % src_hw[1])
    print(f"{src_hw}->{dst_hw}: {(dy + dx > 0).sum()} of {dy.size} source indices differ")
    assert dy.max() <= 1 and dx.max() <= 1 and (dy + dx > 0).mean() < 0.01


def test_preprocess_against_jax():
    """dpt.preprocess against the JAX package's (cv2 bicubic) at the
    pipeline's 480x640 frame: same shape; pixels within one uint8 level
    after the ImageNet normalisation (bitwise where cv2 runs without IPP)."""
    img = np.random.default_rng(5).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    got = dpt.preprocess(img)
    ref = jdpt.preprocess(img)
    assert got.shape == ref.shape == (1, 518, 686, 3)
    assert np.abs(got - ref).max() <= 1.0 / 255.0 / dpt.IMAGENET_STD.min() + 1e-6


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
