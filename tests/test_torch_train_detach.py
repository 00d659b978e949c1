"""MDTracker.forward(train=True) gradients with the default detaches
(iters=2, static_iters=1): the gradients of a loss over every train_data
entry against jax.value_and_grad's within 1e-3 of each parameter's largest
(two iterations of random weights amplify float32 rounding to 1.5e-4), so
the port stops gradients where the JAX package does. The helpers and the
detach-free case are in tests/test_torch_train.py.
"""

from test_torch_train import _assert_grads_close, _grad_pair, models
from torch_parity import queries, window


def test_train_gradients_match_jax_with_detaches(rng):
    """Every entry in the loss, one window with the default iterations: the
    gradients agree only if the port stops them where the JAX package does
    (each iteration's coords, the static branch's inputs, the detached
    motion mask); a detach missed or added moves some parameter's gradient
    by a large part of itself, so 1e-3 of the largest catches it."""
    model, params, jnet = models(2, 1)
    win, q = window(rng, 4), queries(rng, [0, 0, 1, 3])

    def loss_fn(td, xp):
        total = 0.0
        for i in range(td["coords"].shape[1]):
            total = total + 0.8 ** (1 - i) * xp.sum(xp.abs(td["coords"][:, i] - 10.0)) / 50.0
        total = total + xp.sum(td["depths"] ** 2) * 1e-3 + xp.sum(td["statics"] ** 2) * 1e-4
        return total + xp.sum(td["vis_logits"] ** 2) * 1e-3 + xp.sum(td["dyn_logits"] ** 2) * 1e-2

    loss, grads, jloss, jgrads = _grad_pair(model, params, jnet, loss_fn, win, q)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    _assert_grads_close(grads, jgrads, 1e-3)
