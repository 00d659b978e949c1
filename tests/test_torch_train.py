"""MDTracker.forward(train=True) of batrack_tpu_torch against batrack_tpu's
train=True outputs, with the weights carried across (float32, CPU, small
widths, flow heads damped as in tests/test_torch_mdtracker.py):

* every train_data entry over two windows (T=6, S=4: key masks, late
  queries, window hand-off), at the tracker parity tests' tolerances:
  coords, depths and static outputs 1e-3, the visibility and motion
  probabilities (sigmoids of the logits) 1e-4; the window starts, activity
  and track masks exactly; the inference outputs are the same with and
  without train;
* at tests/test_tracker.py's detach-free configuration (iters=1,
  static_iters=0, where the per-iteration detach is the identity), the
  parameter gradients of that file's loss through the port's plain paths
  against jax.value_and_grad's, carried to the port's layout by
  state_dict_from_flax: within 1e-4 of the largest gradient of each
  parameter (or of 1e-3 of the largest of all, where a parameter's own is
  rounding noise), and the loss within 1e-5 relative.
* with the default detaches: tests/test_torch_train_detach.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from batrack_tpu.tracker import mdtracker as jmd
from batrack_tpu_torch.tracker.convert import state_dict_from_flax
from batrack_tpu_torch.tracker.mdtracker import MDTracker, TrackerParams
from torch_parity import (DEPTHS, H, W, assert_close, damp_flow_heads, flax_params, j, queries,
                          t, window)

FIRST = [0, 0, 1, 4, 3, 2]


def models(iters, static_iters):
    torch.manual_seed(0)
    p = TrackerParams(S=4, iters=iters, static_iters=static_iters, interp_shape=(H, W), **DEPTHS)
    model = damp_flow_heads(MDTracker(p).eval())
    params, _ = flax_params(model)
    jp = jmd.TrackerParams(S=4, iters=iters, static_iters=static_iters, interp_shape=(H, W),
                           **DEPTHS)
    return model, params, jmd.MDTracker(jp)


def test_train_outputs_match_jax(rng):
    model, params, jnet = models(2, 1)
    win, q = window(rng, 6), queries(rng, FIRST)
    with torch.no_grad():
        out = model(t(win), t(q), train=True)
        plain = model(t(win), t(q))
    ref = jax.jit(functools.partial(jnet.apply, train=True))(params, j(win), j(q))
    assert len(out) == len(ref) == 7 and len(plain) == 6
    for a, b in zip(out[:6], plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    td, jtd = out[6], ref[6]
    assert set(td) == set(jtd)
    np.testing.assert_array_equal(td["inds"], jtd["inds"])
    assert list(td["inds"]) == [0, 2]
    for k in ("active", "track_mask"):
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jtd[k]))
    for k in ("coords", "depths", "statics"):
        assert td[k].shape == jtd[k].shape, k
        assert_close(td[k], jtd[k], atol=1e-3)
    for k in ("vis_logits", "dyn_logits"):   # as probabilities, as the tracker tests hold them
        assert td[k].shape == jtd[k].shape, k
        assert_close(torch.sigmoid(td[k]), jax.nn.sigmoid(jtd[k]), atol=1e-4)
    assert td["coords"].shape == (2, 2, 4, len(FIRST), 2)
    assert td["statics"].shape == (2, 1, 4, len(FIRST), 3)


def _grad_pair(model, params, jnet, loss_fn, win, q):
    """(port loss, port grads by name, JAX loss, JAX grads as a state dict)."""
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda prm: loss_fn(jnet.apply(prm, j(win), j(q), train=True)[6], jnp)))(params)
    model.zero_grad()
    loss = loss_fn(model(t(win), t(q), train=True)[6], torch)
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return (loss.item(), grads, float(jloss),
            state_dict_from_flax(jax.tree.map(np.asarray, jgrads)))


def _assert_grads_close(grads, ref, rel):
    """Each parameter's gradient within rel of its largest magnitude; where
    that is below 1e-3 of the largest of all (rounding noise, as the bias
    of a convolution under instance norm), within rel of that floor."""
    assert set(ref) <= set(grads)
    floor = 1e-3 * max(float(g.abs().max()) for g in ref.values())
    assert floor > 0
    for k, g in ref.items():
        got = torch.zeros_like(g) if grads[k] is None else grads[k]
        scale = max(float(g.abs().max()), floor)
        err = float((got - g).abs().max())
        assert err <= rel * scale, (k, err, scale)


def test_train_gradients_match_jax_detach_free(rng):
    """tests/test_tracker.py::test_train_gradient_matches_fd's loss and
    configuration, one window."""
    model, params, jnet = models(1, 0)
    win = window(rng, 4)
    q = queries(rng, [0, 0, 0, 0])
    gt = q[:, 1:3][None] + np.arange(4, dtype=np.float32)[:, None, None] * 0.3

    def loss_fn(td, xp):
        m = td["track_mask"][0][..., None]
        g = xp.asarray(gt) if xp is jnp else torch.from_numpy(gt)
        return xp.sum(((td["coords"][0, 0] - g) * m) ** 2) / 100.0 + \
            xp.sum(td["vis_logits"][0] ** 2) * 1e-3

    loss, grads, jloss, jgrads = _grad_pair(model, params, jnet, loss_fn, win, q)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    _assert_grads_close(grads, jgrads, 1e-4)
