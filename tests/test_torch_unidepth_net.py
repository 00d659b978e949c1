"""UniDepthV2 of batrack_tpu_torch against batrack_tpu, whole: the network
with and without given rays, `infer` at a 100-patch bound with and without
K (its `outputs=` pruning and the exact pass-through of a caller's K), the
network-size rule, the weight round trip and the released-checkpoint loader
(.pth with `module.` and chunked DINOv2 blocks, .safetensors). The pieces
and heads are in test_torch_unidepth.py, whose fixtures this file shares.

Tolerance 1e-4 relative on depth and K.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unidepth import ARCH, IMG_HW, K, RTOL, nets, rel_err, t  # noqa: F401

from batrack_tpu.depth import unidepth as jud
from batrack_tpu_torch.depth import unidepth as ud
from batrack_tpu_torch.utils.tensorfile import write_safetensors


def test_unidepthv2_matches_jax(nets):
    """The whole network on a 42x56 image, with its own camera and with the
    rays of a given K."""
    model, jmodel, params, _ = nets
    x = np.random.default_rng(3).normal(size=(1, 42, 56, 3)).astype(np.float32)
    rays = np.asarray(jud.generate_rays(jnp.asarray(K[None] * 0.3), (42, 56))[0])
    for r in (None, rays):
        ref = jax.jit(jmodel.apply)(params, jnp.asarray(x), None if r is None else jnp.asarray(r))
        with torch.no_grad():
            got = model(t(x), None if r is None else t(r))
        for key in ("depth", "K", "confidence", "depth_features", "rays"):
            assert got[key].shape == ref[key].shape, key
            assert rel_err(got[key], ref[key]) < RTOL, key


@pytest.mark.parametrize("with_K", [False, True])
def test_infer_matches_jax(nets, with_K):
    """infer at pixels_bounds=(100, 100), resolution_level=0 on a 126x168
    frame (network input 126x168 from the forced 100-patch count), all four
    outputs, then the pruned run: same depth bitwise, two keys, a caller's K
    back exactly."""
    model, jmodel, params, _ = nets
    img = np.random.default_rng(4).integers(0, 256, IMG_HW + (3,), dtype=np.uint8)
    kw = dict(intrinsics=K if with_K else None, pixels_bounds=(100, 100), resolution_level=0)
    ref = jud.infer(jmodel, params, img, **kw)
    full = ud.infer(model, img, **kw)
    slim = ud.infer(model, img, **kw, outputs=("depth", "intrinsics"))
    assert set(full) == set(ref) == {"depth", "intrinsics", "confidence", "points"}
    assert set(slim) == {"depth", "intrinsics"}
    for key in full:
        assert full[key].shape == np.asarray(ref[key]).shape, key
        assert rel_err(full[key], ref[key]) < RTOL, key
    np.testing.assert_array_equal(slim["depth"], full["depth"])
    if with_K:
        np.testing.assert_array_equal(full["intrinsics"], K)
        np.testing.assert_array_equal(slim["intrinsics"], K)
    else:
        np.testing.assert_array_equal(slim["intrinsics"], full["intrinsics"])


def test_infer_shape_matches_jax():
    for hw in [(480, 640), (126, 168), (720, 1280), (540, 960)]:
        for level in (None, 0, 3, 10):
            assert ud._infer_shape(hw, level) == jud._infer_shape(hw, level)
    (h, w), _ = ud._infer_shape((480, 640))
    assert (h, w) == (588, 784) and (h // 14) * (w // 14) == 2352
    assert math.isclose(ud._infer_shape((480, 640))[1], 588 / 480)


def test_state_dict_round_trip_unidepth(nets):
    _, _, _, sd = nets
    params = jud.convert_unidepth_checkpoint(sd, ARCH)
    unused = {k: v for k, v in sd.items() if "mask_token" in k}
    assert list(unused) == ["pixel_encoder.mask_token"]
    back = ud.state_dict_from_flax(params, ARCH, unused)
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype and np.array_equal(back[k], sd[k]), k


def chunked(sd, chunks=4, depth=12):
    """The released layout: `module.` prefixes and DINOv2 blocks in chunks
    (pixel_encoder.blocks.<chunk>.<global index>.*)."""
    per = depth // chunks
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if k.startswith("pixel_encoder.blocks."):
            i = int(parts[2])
            k = ".".join(parts[:2] + [str(i // per), str(i)] + parts[3:])
        out["module." + k] = v
    return out


@pytest.mark.parametrize("fmt", ["pth", "safetensors"])
def test_load_checkpoint_released_layouts(nets, tmp_path, fmt):
    model, _, _, sd = nets
    released = {k: torch.from_numpy(v) for k, v in chunked(sd).items()}
    assert "module.pixel_encoder.blocks.3.11.attn.qkv.weight" in released
    path = tmp_path / f"ud.{fmt}"
    if fmt == "pth":
        torch.save(released, path)
    else:
        write_safetensors(path, released)
    loaded = ud.load_checkpoint(path, ARCH)
    for k, v in loaded.state_dict().items():
        assert np.array_equal(v.numpy(), sd[k]), k
    bad = dict(released)
    bad.pop("module.pixel_decoder.depth_layer.to_depth.bias")
    torch.save(bad, tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="to_depth.bias"):
        ud.load_checkpoint(tmp_path / "bad.pth", ARCH)
