"""The port's plain attention in bf16 against batrack_tpu's, a recorded
deviation (ROADMAP C).

The time blocks (and any space block below the kernel threshold) take the
plain attention, `ops/attention.py::_softmax_pv`, which computes logits and
softmax in float32 whatever the model dtype, as the TPU kernels K2-K4 do.
batrack_tpu's dense path (`tracker/blocks.py::Attention`) computes them in
the model dtype, so in bf16 the two differ. The port keeps float32 logits:
it is no further from the float32 result than JAX's bf16 core is, and it
stays within a few bf16 ulps of JAX's bf16 output. Both relations are
pinned here at the time blocks' shape: (256 tracks, 12 frames, 384), 8
heads, inputs and weights from a seed.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batrack_tpu.tracker import blocks as jblocks
from batrack_tpu_torch.tracker.blocks import Attention
from torch_parity import j, npy, t

B, N, DIM, HEADS = 256, 12, 384, 8
# port bf16 vs JAX bf16, in bf16 ulps (8 significand bits) of the largest
# output magnitude: both round qkv and the output to bf16, and the softmax
# rounding differs (float32 here, bf16 there); measured one ulp (3.9e-3 at
# a largest magnitude of 0.52) on the CPU
ULPS = 2


def bf16_ulp(x: np.ndarray) -> float:
    return 2.0 ** (math.floor(math.log2(np.abs(x).max())) - 7)


@pytest.fixture(scope="module")
def outputs():
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    attn = Attention(DIM, HEADS).eval()
    sd = {k: v.numpy() for k, v in attn.state_dict().items()}
    params = {name: {"kernel": jnp.asarray(sd[f"{name}.weight"].T),
                     "bias": jnp.asarray(sd[f"{name}.bias"])} for name in ("qkv", "proj")}
    # the same bf16 input for every side
    x = t(rng.normal(size=(B, N, DIM)).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        port = attn.to(torch.bfloat16)(x).float()
    xj = j(x.float())
    jax_bf16 = jblocks.Attention(DIM, HEADS, dtype=jnp.bfloat16).apply({"params": params}, xj)
    jax_f32 = jblocks.Attention(DIM, HEADS, dtype=jnp.float32).apply({"params": params}, xj)
    return (npy(port).astype(np.float64), np.asarray(jax_bf16, np.float64),
            np.asarray(jax_f32, np.float64))


def test_port_bf16_attention_is_no_further_from_float32_than_jax_bf16(outputs):
    port, jax_bf16, jax_f32 = outputs
    assert np.isfinite(port).all() and port.shape == (B, N, DIM)
    port_err = np.abs(port - jax_f32).mean()
    jax_err = np.abs(jax_bf16 - jax_f32).mean()
    assert port_err <= jax_err, (port_err, jax_err)


def test_port_bf16_attention_within_bf16_ulps_of_jax_bf16(outputs):
    port, jax_bf16, _ = outputs
    diff = np.abs(port - jax_bf16).max()
    assert diff <= ULPS * bf16_ulp(jax_bf16), (diff, bf16_ulp(jax_bf16))
