"""utils/flops.py of batrack_tpu_torch against batrack_tpu's: every
function at davis_demo's tracker (the shipped config: 2400 tracks, 384x512
tracker input) and at a small config, exactly (the same float arithmetic);
the port's tracker_forward_flops_from_params from an MDTracker, its
TrackerParams and its state dict against the JAX function from the JAX
TrackerParams of the same config."""

import os

import pytest

from batrack_tpu.tracker.mdtracker import TrackerParams as JParams
from batrack_tpu.utils import flops as jflops
from batrack_tpu.utils.config import load_config as jload_config
from batrack_tpu_torch.tracker.mdtracker import MDTracker, TrackerParams
from batrack_tpu_torch.utils import flops
from batrack_tpu_torch.utils.config import load_config

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "davis_demo.yaml")
SMALL = dict(S=4, space_depth=1, time_depth=2, space_depth_dyn=1, time_depth_dyn=1, iters=2,
             static_iters=1, interp_shape=(64, 96), hidden_size=96, num_heads=2)


@pytest.mark.parametrize("args", [(63, 97, 4, 64, 7, 2), (96, 128, 96, 96, 3)])
def test_conv_and_dense_match_jax(args):
    assert flops.conv2d(*args) == jflops.conv2d(*args)
    assert flops.dense(*args[:3]) == jflops.dense(*args[:3])


@pytest.mark.parametrize("H,W,N,S,C", [(384, 512, 2400, 12, 384), (64, 96, 64, 4, 96)])
def test_components_match_jax(H, W, N, S, C):
    assert flops.basic_encoder(H, W) == jflops.basic_encoder(H, W)
    assert flops.attn_block(N, S, C) == jflops.attn_block(N, S, C)
    assert flops.attn_block(S, N, C, 2.0) == jflops.attn_block(S, N, C, 2.0)
    assert (flops.updateformer(N, S, 456, C, 131, 6, 6)
            == jflops.updateformer(N, S, 456, C, 131, 6, 6))
    assert flops.corr_sampling(N, S, 4, 3, 128) == jflops.corr_sampling(N, S, 4, 3, 128)


@pytest.mark.parametrize("kind", ["davis_demo", "small"])
def test_tracker_forward_flops_match_jax(kind):
    if kind == "davis_demo":
        m, jm = load_config(CONFIG, []).model, jload_config(CONFIG, []).model
        p, jp = TrackerParams.from_config(m), JParams.from_config(jm)
        N, (H, W) = 2400, tuple(m.interp_shape)
        assert (N, H, W) == (2400, 384, 512)
    else:
        p, N, (H, W) = TrackerParams(**SMALL), 64, SMALL["interp_shape"]
        jp = JParams(**{k: getattr(p, k) for k in JParams._fields if k in p._fields})
    ref = jflops.tracker_forward_flops_from_params(jp, N, H, W)
    assert ref["total"] > 0 and set(ref) == set(flops.tracker_forward_flops(N=N, S=p.S, H=H, W=W))
    assert flops.tracker_forward_flops_from_params(p, N, H, W) == ref
    model = MDTracker(p)
    assert flops.tracker_forward_flops_from_params(model, N, H, W) == ref
    assert flops.tracker_forward_flops_from_params(model.state_dict(), N, H, W, params=p) == ref
    assert (flops.tracker_forward_flops_from_params(p, N, H, W, new_frames=12)
            == jflops.tracker_forward_flops_from_params(jp, N, H, W, new_frames=12))
