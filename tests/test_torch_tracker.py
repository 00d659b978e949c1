"""batrack_tpu_torch.tracker against batrack_tpu.tracker with the weights
carried across (port state dict -> batrack_tpu.tracker.convert ->
Flax params), float32 on the CPU, at small widths (S=4, 32x48 frames, one
block per transformer).

Tolerances: encoder features, transformer blocks and tracks 1e-3 (tracks
in pixels), visibility and dynamic probabilities 1e-4. The weight round
trip is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batrack_tpu.tracker import blocks as jblocks
from batrack_tpu.tracker import mdtracker as jmd
from batrack_tpu_torch.tracker.adapter import MDTrackerAdapter
from batrack_tpu_torch.tracker.blocks import AttnBlock, UpdateFormer
from batrack_tpu_torch.tracker.convert import state_dict_from_flax
from batrack_tpu_torch.tracker.mdtracker import MDTracker, _scrambled_concat
from batrack_tpu_torch.utils.config import ModelConfig
from torch_parity import DEPTHS, H, W, assert_close, flax_params, j, npy, port_model, queries, t, window


def test_weight_round_trip_is_exact():
    model = port_model()
    params, sd = flax_params(model)
    back = state_dict_from_flax(jax.tree.map(np.asarray, params))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    MDTracker(model.p).load_state_dict(back)  # names and shapes load


def test_basic_encoder_matches_jax(rng):
    model = port_model()
    params, _ = flax_params(model)
    x = rng.normal(size=(2, 3, H, W)).astype(np.float32)
    with torch.no_grad():
        out = model.fnet(t(x))
    ref = jblocks.BasicEncoder(output_dim=128, stride=4).apply(
        {"params": params["params"]["fnet"]}, jnp.moveaxis(j(x), 1, -1))
    assert_close(out, np.moveaxis(np.asarray(ref), -1, 1), atol=1e-3)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_attn_block_matches_jax(rng, masked, use_kernel):
    """AttnBlock: with use_kernel the JAX side runs the Pallas K2 in
    interpret mode and the port K2's plain version; without, both run their
    plain multi-head attention (tolerance 1e-4)."""
    torch.manual_seed(2)
    blk = AttnBlock(64, 4, use_kernel=use_kernel, kernel_threshold=1).eval()
    sd = {k: v.numpy() for k, v in blk.state_dict().items()}

    def dense(name):
        return {"kernel": jnp.asarray(sd[f"{name}.weight"].T), "bias": jnp.asarray(sd[f"{name}.bias"])}

    params = {"attn": {"qkv": dense("attn.qkv"), "proj": dense("attn.proj")},
              "mlp": {"fc1": dense("mlp.fc1"), "fc2": dense("mlp.fc2")}}
    x = rng.normal(size=(3, 17, 64)).astype(np.float32)
    mask = rng.uniform(size=17) > 0.4 if masked else None
    with torch.no_grad():
        out = blk(t(x), None if mask is None else t(mask))
    ref = jblocks.AttnBlock(64, 4, use_flash=use_kernel, interpret=True, flash_threshold=1).apply(
        {"params": params}, j(x), None if mask is None else j(mask))
    assert_close(out, ref, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_flash_route_matches_jax(rng, monkeypatch, masked):
    """Attention under BATRACK_TPU_ATTN=flash: the port splits the heads and
    calls K4 (flash_attention, its plain version on the CPU); batrack_tpu's
    Attention(use_flash=True) takes its split-head route, which off the TPU
    is its dense softmax (tolerance 1e-5, float32)."""
    from batrack_tpu_torch.tracker import blocks

    monkeypatch.setenv("BATRACK_TPU_ATTN", "flash")
    calls, flash = [], blocks.flash_attention

    def counted(*args):
        calls.append(args[0].shape)
        return flash(*args)  # CPU tensors -> plain version

    monkeypatch.setattr(blocks, "flash_attention", counted)
    torch.manual_seed(3)
    attn = blocks.Attention(96, 2, use_kernel=True, kernel_threshold=1).eval()
    sd = {k: v.numpy() for k, v in attn.state_dict().items()}
    params = {name: {"kernel": jnp.asarray(sd[f"{name}.weight"].T),
                     "bias": jnp.asarray(sd[f"{name}.bias"])} for name in ("qkv", "proj")}
    x = rng.normal(size=(3, 37, 96)).astype(np.float32)
    mask = rng.uniform(size=37) > 0.4 if masked else None
    with torch.no_grad():
        out = attn(t(x), None if mask is None else t(mask))
    ref = jblocks.Attention(96, 2, use_flash=True, flash_threshold=1).apply(
        {"params": params}, j(x), None if mask is None else j(mask))
    assert calls == [(3, 2, 37, 48)]
    assert_close(out, ref, atol=1e-5)


@pytest.mark.parametrize("masked,num_heads", [
    pytest.param(False, 4, id="False"),   # head dim 16
    pytest.param(True, 4, id="True"),
    pytest.param(False, 8, id="False-d8"),
    pytest.param(True, 2, id="True-d32"),
])
def test_updateformer_matches_jax(rng, masked, num_heads):
    """UpdateFormer (time + space AttnBlocks) at hidden 64 over 4, 8 or 2
    heads (head dims 16, 8 and 32, as ModelConfig's hidden_size / num_heads
    give them); the port's space attention goes through K2's plain version
    (kernel_threshold=1)."""
    torch.manual_seed(1)
    uf = UpdateFormer(space_depth=2, time_depth=2, input_dim=40, hidden_size=64,
                      num_heads=num_heads, output_dim=11, use_kernel=True,
                      kernel_threshold=1).eval()
    sd = {f"updateformer.{k}": v.numpy() for k, v in uf.state_dict().items()}
    from batrack_tpu.tracker.convert import _updateformer
    params = jax.tree.map(jnp.asarray, _updateformer(sd, "updateformer", 2, 2))
    x = rng.normal(size=(1, 9, 5, 40)).astype(np.float32)
    mask = rng.uniform(size=9) > 0.4 if masked else None
    with torch.no_grad():
        out = uf(t(x), None if mask is None else t(mask))
    ref = jblocks.UpdateFormer(space_depth=2, time_depth=2, input_dim=40, hidden_size=64,
                               num_heads=num_heads, output_dim=11).apply(
        {"params": params}, j(x), None if mask is None else j(mask))
    assert_close(out, ref, atol=1e-4)


def test_scrambled_concat_matches_jax(rng):
    S, N = 4, 10
    tm = (rng.uniform(size=(S, N)) > 0.5).astype(np.float32)
    vis = rng.normal(size=(S, N)).astype(np.float32)
    for cnt in (None, 7):
        out = _scrambled_concat(t(tm), t(vis), None if cnt is None else torch.tensor(cnt))
        ref = jmd._scrambled_concat(j(tm), j(vis), cnt)
        np.testing.assert_array_equal(npy(out), np.asarray(ref))


def test_adapter_static_merge_and_skip(rng):
    """Static merge as in batrack_tpu (batrack.py:556-566); with both merge
    flags off the static branch is not run, and its output is unused."""
    S, NQ = 4, 6
    traj = t(rng.normal(size=(S, NQ, 2)).astype(np.float32))
    depth = t(rng.uniform(1, 5, size=(S, NQ)).astype(np.float32))
    static3d = t(rng.normal(size=(S, NQ, 3)).astype(np.float32))
    dyn = t(rng.uniform(0, 1, size=(S, NQ)).astype(np.float32))
    ad = MDTrackerAdapter(ModelConfig(S=S, use_static=True), device="cpu")
    t2, d2 = ad._static_merge(traj, depth, static3d, dyn)
    assert torch.equal(t2, static3d[..., :2]) and torch.equal(d2, static3d[..., 2])
    ad = MDTrackerAdapter(ModelConfig(S=S, use_static_mask=True), static_threshold=0.3,
                          device="cpu")
    t2, _ = ad._static_merge(traj, depth, static3d, dyn)
    m = dyn > 0.7
    assert torch.equal(t2[m], static3d[..., :2][m]) and torch.equal(t2[~m], traj[~m])

    calls = []
    mc = ModelConfig(S=4, sliding_window_len=4, I=1, static_iters=1, interp_shape=(H, W),
                     compute_dtype="float32", **DEPTHS)
    ad = MDTrackerAdapter(mc, device="cpu")
    ad.model.updateformer_dyn.register_forward_hook(lambda *a: calls.append(1))
    out, _ = ad.forward(t(window(rng, 4)), t(queries(rng, [0, 2])))
    assert out.tracks.shape == (4, 2, 2) and not calls


def test_mdtracker_kernel_path_matches_jax_pallas(rng):
    """The kernel call sites: the port's K1 path (packed bf16 pyramid,
    track-major windows) and K2 path, here through their plain versions,
    against the JAX tracker with both Pallas kernels in interpret mode
    (both read the feature maps in bf16)."""
    model = port_model(use_corr_kernel=True, use_attention_kernel=True, kernel_threshold=1)
    params, _ = flax_params(model)
    win, q = window(rng, 4), queries(rng, [0, 0, 2, 1, 0, 2])
    with torch.no_grad():
        out = model(t(win), t(q))
    jp = jmd.TrackerParams(S=4, iters=2, static_iters=1, interp_shape=(H, W), **DEPTHS,
                           use_pallas_corr=True, use_flash_attention=True,
                           pallas_interpret=True, flash_threshold=1)
    ref = jax.jit(jmd.MDTracker(jp).apply)(params, j(win), j(q))
    for k, tol in enumerate([1e-3, 1e-3, 1e-3, 1e-4, 1e-4]):
        assert_close(out[k], ref[k], atol=tol)
