"""The float32 route of K2-K4 as an algorithm, on the CPU: the split pass's
plain version (`split_terms_plain`) and the kernel's sums emulated in plain
PyTorch, against batrack_tpu's fused_qkv_attention (the Pallas kernel in
interpret mode, float32) and against float64.

On the card the float32 route writes q, k and v as three bf16 terms each
and sums the six products of the term pairs of order <= 2, for QK^T and,
with the probabilities split the same way, for PV, one key tile at a time
under an online softmax (csrc/fused_qkv_attention.cu). `three_term_attention`
does the same arithmetic with float32 matrix products of the terms (exact
products, float32 sums). Tolerances: 1e-4 against the Pallas kernel (the
kernel's limit against its float32 plain version on the card); against a
float64 evaluation on q, k, v of 3 N(0, 1) (a peaked softmax), three terms
within 2e-5, or within the float32 plain version's distance where that is
larger, and two terms (three products) beyond it: the card test's limit
(tests/test_torch_kernels.py::test_attention_f32_keeps_three_terms_on_gpu).
The terms sum back to x exactly here: each float32 needs at most 24
significand bits, which three rounded bf16 terms of 8 cover.
"""

import numpy as np
import pytest
import torch

from batrack_tpu_torch.ops.attention import (fused_qkv_attention_plain, split_terms,
                                              split_terms_plain)
from torch_parity import assert_close, j, t

# the kernel's term pairs (i, j), i + j <= 2, smallest products first
PAIRS = [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]
LOG2E = 1.4426950408889634


def products(a, b, pairs):
    """sum over pairs (i, j) of a[i] @ b[j], float32, in the pairs' order."""
    acc = None
    for i, jj in pairs:
        part = a[i] @ b[jj]
        acc = part if acc is None else acc + part
    return acc


def three_term_attention(q, k, v, scale, mask=None, tile=64, order=2):
    """softmax(q k^T scale) v over (B, N, d) q and (B, Nk, d) k, v as the
    float32 route computes it: split_terms_plain terms of q, k and v; per
    tile of `tile` keys, QK^T as the products of the term pairs of order <=
    `order`; logits times scale log2(e) in base 2, masked keys at -1e30,
    running maximum and sum; the probabilities split into terms, PV the same
    products into a fresh tile sum added to the running output."""
    pairs = [(a, b) for a, b in PAIRS if a + b <= order]
    qt, kt, vt = (split_terms_plain(x).float() for x in (q, k, v))
    kt = kt.transpose(-1, -2)
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    B, N, d = q.shape
    m = torch.full((B, N, 1), -float("inf"))
    l = torch.zeros((B, N, 1))
    o = torch.zeros((B, N, d))
    for k0 in range(0, k.shape[1], tile):
        ks = slice(k0, k0 + tile)
        x = products(qt, kt[..., ks], pairs) * c
        if mask is not None:
            x = x.masked_fill(~mask[ks][None, None, :], -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        m = m_new
        p = torch.exp2(x - m)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + products(split_terms_plain(p).float(), vt[:, :, ks], pairs)
    return o / l


def three_term_fused(qkv, heads, scale, mask=None, kv=None, order=2):
    """K2 (packed qkv, or queries from qkv and keys and values from a slim
    (B, Nk, 2C) or packed (B, Nk, 3C) kv) through three_term_attention."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    d = C // heads
    src = qkv if kv is None else kv
    koff = src.shape[-1] - 2 * C
    Nk = src.shape[1]

    def heads_of(x, n):
        return x.reshape(B, n, heads, d).transpose(1, 2).reshape(B * heads, n, d)

    q = heads_of(qkv[..., :C], N)
    k, v = (heads_of(src[..., koff + i * C: koff + (i + 1) * C], Nk) for i in range(2))
    out = three_term_attention(q, k, v, scale, mask, order=order)
    return out.reshape(B, heads, N, d).transpose(1, 2).reshape(B, N, C)


def test_split_terms_sum_back_to_x_as_bf16_values(rng):
    """Each term is a bf16 value (its float32 pattern has 16 zero low
    bits), each is the rounding of what the ones before leave, and the
    three sum back to x; the CPU wrapper on strided rows is the plain
    version."""
    x = (rng.normal(size=(40, 96)) * 10.0 ** rng.uniform(-30, 30, size=(40, 96)))
    x = torch.from_numpy(x.astype(np.float32))
    terms = split_terms_plain(x)
    assert terms.shape == (3, 40, 96) and terms.dtype == torch.bfloat16
    f = terms.float()
    assert ((f.view(torch.int32) & 0xFFFF) == 0).all()
    assert torch.equal(terms[0], x.to(torch.bfloat16))
    assert torch.equal(terms[1], (x - f[0]).to(torch.bfloat16))
    assert torch.equal(terms[2], (x - f[0] - f[1]).to(torch.bfloat16))
    err = (f.double().sum(0) - x.double()).abs()
    assert (err <= x.double().abs() * 2.0 ** -24).all()
    assert (f[1].abs() <= f[0].abs() * 2.0 ** -8).all()
    rows = x.view(20, 192)[:, 32:128]  # a strided (rows, lanes) view, as the kernel reads it
    assert torch.equal(split_terms(rows)[0], split_terms_plain(rows))


@pytest.mark.parametrize("mult", [1.0, 3.0])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("source", [None, "slim"])
def test_three_term_attention_matches_pallas_interpret(rng, source, masked, mult):
    """The float32 route's sums on K2's inputs, packed qkv or a kv= source,
    with and without a key mask, at N(0, 1) and 3 N(0, 1) inputs, within
    1e-4 of batrack_tpu's fused_qkv_attention in float32 (interpret mode)."""
    from batrack_tpu.ops.pallas_attention import fused_qkv_attention as jfused

    B, N, Nk, H, d = 2, 150, 133, 2, 48
    C = H * d
    qkv = (mult * rng.normal(size=(B, N, 3 * C))).astype(np.float32)
    kv = None if source is None else (mult * rng.normal(size=(B, Nk, 2 * C))).astype(np.float32)
    nk = N if kv is None else Nk
    mask = rng.uniform(size=nk) > 0.3 if masked else None
    ref = jfused(j(qkv), H, d ** -0.5, interpret=True, key_mask=None if mask is None else j(mask),
                 kv=None if kv is None else j(kv))
    out = three_term_fused(t(qkv), H, d ** -0.5, None if mask is None else t(mask),
                           None if kv is None else t(kv))
    assert out.shape == (B, N, C)
    assert_close(out, ref, atol=1e-4)


@pytest.mark.parametrize("d", [8, 48, 128])
def test_three_terms_hold_float64_where_two_do_not(rng, d):
    """On q, k, v of 3 N(0, 1) three terms stay within 2e-5 of a float64
    evaluation, or within the float32 plain version's own distance from it
    where that is larger (from d 96 float32 sums stray farther), and two
    terms (three products) do not: the card test's limit tells a dropped
    term from float32 rounding."""
    B, N, Nk, H = 1, 128, 333, 2
    qkv = torch.from_numpy((3 * rng.normal(size=(B, Nk, 3 * H * d))).astype(np.float32))
    qkv = qkv[:, :N].contiguous()
    kv = torch.from_numpy((3 * rng.normal(size=(B, Nk, 2 * H * d))).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=Nk) > 0.3)
    C = H * d
    x = qkv.double()
    ref = []
    for h in range(H):
        q = x[..., h * d:(h + 1) * d]
        k, v = (kv.double()[..., i * C + h * d: i * C + (h + 1) * d] for i in range(2))
        logits = (q @ k.transpose(1, 2) * d ** -0.5).masked_fill(~mask[None, None], -1e30)
        ref.append(torch.softmax(logits, -1) @ v)
    ref = torch.cat(ref, -1)
    plain = fused_qkv_attention_plain(qkv, H, d ** -0.5, mask, kv=kv)
    tol = max(2e-5, (plain.double() - ref).abs().max().item())
    three = three_term_fused(qkv, H, d ** -0.5, mask, kv)
    two = three_term_fused(qkv, H, d ** -0.5, mask, kv, order=1)
    assert (three.double() - ref).abs().max() <= tol
    assert (two.double() - ref).abs().max() > tol
