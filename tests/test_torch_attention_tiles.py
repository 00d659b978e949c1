"""K2's key-mask plan (csrc/fused_qkv_attention.cu): the bf16 kernel walks
only the 128-key tiles with a live key, full tiles on the fast softmax and
the rest (mixed) on the general one with the tile's bits. Here, on the CPU:

- the port's plain version against the Pallas kernel in interpret mode on
  each mask the plan tells apart, packed and with a slim kv= source, at
  head dims 48 and 128: 2e-5 (float32, as tests/test_torch_ops.py holds
  K2). With no live key the Pallas kernel also averages its zero-padded
  keys, so the port is held to the reference scaled by padded over live
  keys (test_torch_ops.py::test_attention_all_masked_row_vs_pallas_interpret);
- the exactness that skipping dead tiles relies on: the plain computation
  on the walked tiles' keys alone gives the full computation's rows within
  1e-6 relative in norm (a masked key's weight 2^(-1e30 - m) is 0 in float32 once
  a row has a live key, so only the order of the sums changes);
- the counts of the plan that chip_smoke.py's reports print
  (`key_tile_plan`), the kernel's classification, for each mask.
"""

import numpy as np
import pytest
import torch

from batrack_tpu_torch.ops.attention import fused_qkv_attention, fused_qkv_attention_plain
from chip_smoke import key_tile_plan
from torch_parity import assert_close, j, t

KEY_TILE = 128  # keys per tile of the bf16 kernel

NK = 400  # keys: tiles [0, 128), [128, 256), [256, 384) and a ragged [384, 400)
KINDS = ["prefix", "dead_tiles", "last_key", "none"]


def mask_of(kind, rng):
    """(NK,) bool. prefix: keys 0-169 live (phase 9's active tracks: a full
    tile, a mixed one, two dead ones); dead_tiles: keys 128-255 and 384-399
    dead, the first tile full, the third 70 % live; last_key: only key 390,
    in the ragged last tile; none: no live key."""
    m = np.zeros(NK, bool)
    if kind == "prefix":
        m[:170] = True
    elif kind == "dead_tiles":
        m[:128] = True
        m[256:384] = rng.uniform(size=128) > 0.3
    elif kind == "last_key":
        m[390] = True
    return m


PLANS = {"prefix": (2, 1, 1), "dead_tiles": (2, 1, 1), "last_key": (3, 0, 1), "none": (0, 0, 4)}


@pytest.mark.parametrize("kind", KINDS)
def test_key_tile_plan_counts(rng, kind):
    """dead, full and mixed tiles, and the walk, as the kernel builds them."""
    plan = key_tile_plan(torch.from_numpy(mask_of(kind, rng)))
    assert (plan["dead"], plan["full"], plan["mixed"]) == PLANS[kind]
    walks = {"prefix": [0, 1], "dead_tiles": [0, 2], "last_key": [3], "none": [0, 1, 2, 3]}
    assert plan["walk"] == walks[kind]


def _inputs(rng, source, d, heads=2):
    """qkv (B, N, 3C) and, for a slim source, kv (B, NK, 2C): packed
    attention over NK queries and keys, or 37 queries against NK keys."""
    B, C = 2, heads * d
    n = NK if source == "packed" else 37
    qkv = rng.normal(size=(B, n, 3 * C)).astype(np.float32)
    kv = None if source == "packed" else rng.normal(size=(B, NK, 2 * C)).astype(np.float32)
    return qkv, kv


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [48, 128])
@pytest.mark.parametrize("source", ["packed", "slim"])
def test_key_tile_masks_plain_match_pallas_interpret(rng, kind, d, source):
    from batrack_tpu.ops.pallas_attention import fused_qkv_attention as jfused

    heads = 2
    qkv, kv = _inputs(rng, source, d, heads)
    m = mask_of(kind, rng)
    ref = np.asarray(jfused(j(qkv), heads, d ** -0.5, interpret=True,
                            kv=None if kv is None else j(kv), key_mask=j(m)))
    out = fused_qkv_attention(t(qkv), heads, d ** -0.5, t(m),
                              kv=None if kv is None else t(kv))  # CPU tensor -> plain version
    assert out.shape == (qkv.shape[0], qkv.shape[1], heads * d)
    if kind == "none":
        ref = ref * (-(-NK // KEY_TILE) * KEY_TILE / NK)
    assert_close(out, ref, atol=2e-5)


@pytest.mark.parametrize("kind", ["prefix", "dead_tiles", "last_key"])
@pytest.mark.parametrize("d", [48, 128])
@pytest.mark.parametrize("source", ["packed", "slim"])
def test_dead_key_tiles_drop_out_exactly(rng, kind, d, source):
    """The plain version on the walked tiles' keys and values alone (as a
    kv= source of the same layout) against the full computation."""
    heads = 2
    qkv, kv = _inputs(rng, source, d, heads)
    m = mask_of(kind, rng)
    plan = key_tile_plan(torch.from_numpy(m))
    assert plan["dead"] > 0
    keep = np.concatenate([np.arange(i * KEY_TILE, min((i + 1) * KEY_TILE, NK))
                           for i in plan["walk"]])
    src = qkv if kv is None else kv  # packed: the qkv rows are a packed kv= source
    full = fused_qkv_attention_plain(t(qkv), heads, d ** -0.5, t(m),
                                     kv=None if kv is None else t(kv))
    walked = fused_qkv_attention_plain(t(qkv), heads, d ** -0.5, t(m[keep]),
                                       kv=t(np.ascontiguousarray(src[:, keep])))
    assert m[keep].any()
    # every row has a live key: each row's change against the row, in norm
    err = (walked - full).norm(dim=-1) / full.norm(dim=-1)
    assert float(err.max()) <= 1e-6, float(err.max())
