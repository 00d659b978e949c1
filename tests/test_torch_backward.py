"""Backward tracking in batrack_tpu_torch's MDTrackerAdapter against
batrack_tpu's: S_slam = 2 x model.S (8 frames for S=4), so the tracker
runs three sliding windows with key masks, then a second pass on the
flipped window fills the slots the forward pass never reached. Small
widths (tests/torch_parity.py: one block per transformer, 32x48 frames),
float32, flow heads x0.05, the weights carried across by
convert.convert_state_dict. Both with the static branch skipped in the
backward pass (its default) and with the static-mask merge, which keeps
it. Tolerance: the tracker tests' 1e-3 px on tracks and depths, 1e-4 on
visibility and the dynamic probability.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batrack_tpu.tracker.adapter import MDTrackerAdapter as JAdapter
from batrack_tpu.tracker.convert import convert_state_dict
from batrack_tpu.utils.config import ModelConfig as JModelConfig
from batrack_tpu_torch.tracker import MDTrackerAdapter
from batrack_tpu_torch.utils.config import ModelConfig
from torch_parity import DEPTHS, H, W, assert_close, damp_flow_heads, queries, t, window

S_SLAM = 8


@pytest.mark.parametrize("static_mask", [False, True])
def test_backward_tracking_matches_jax(static_mask):
    rng = np.random.default_rng(11)
    model = dict(S=4, sliding_window_len=4, I=1, static_iters=1, interp_shape=(H, W),
                 compute_dtype="float32", use_static_mask=static_mask, **DEPTHS)
    ad = MDTrackerAdapter(ModelConfig(**model), seed=0, backward_tracking=True, device="cpu")
    damp_flow_heads(ad.model)
    sd = {k: v.numpy() for k, v in ad.model.state_dict().items()}
    params = jax.tree.map(jnp.asarray, convert_state_dict(sd, **DEPTHS))
    jad = JAdapter(JModelConfig(**model, use_pallas_corr=False), params=params,
                   backward_tracking=True, static_threshold=0.1)
    win = window(rng, S_SLAM)
    q = queries(rng, [0, 2, 4, 6, 3, 7, 5, 1, 6, 4])
    out, _ = ad.forward(t(win), t(q))
    ref, _ = jad._apply(params, jnp.asarray(win), jnp.asarray(q), None, reuse=0)
    assert_close(out.tracks, ref.tracks, atol=1e-3)
    assert_close(out.depths, ref.depths, atol=1e-3)
    assert_close(out.vis, ref.vis, atol=1e-4)
    assert_close(out.dynamic, ref.dynamic, atol=1e-4)

    # the backward pass filled the frames before each query's first frame
    ad.backward_tracking = False
    fwd, _ = ad.forward(t(win), t(q))
    filled = (fwd.tracks == 0).all(-1)
    assert filled.any() and not (out.tracks[filled] == 0).all()
    assert torch.equal(out.tracks[~filled], fwd.tracks[~filled])
