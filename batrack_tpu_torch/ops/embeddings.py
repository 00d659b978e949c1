"""Positional embeddings (sincos + NeRF-style Fourier), torch/numpy.

Same values as batrack_tpu/ops/embeddings.py (and the reference
embeddings.py): the tracker weights depend on them.
"""

from __future__ import annotations

import numpy as np
import torch


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos) -> np.ndarray:
    """(M,) positions -> (M, D) sincos embedding, float64."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    pos = np.asarray(pos).reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed_from_grid(embed_dim: int, grid) -> np.ndarray:
    assert embed_dim % 2 == 0
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size) -> np.ndarray:
    """(H*W, D) grid embedding."""
    gh, gw = grid_size if isinstance(grid_size, tuple) else (grid_size, grid_size)
    grid_h = np.arange(gh, dtype=np.float32)
    grid_w = np.arange(gw, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)  # w goes first
    grid = np.stack(grid, axis=0).reshape([2, 1, gh, gw])
    return get_2d_sincos_pos_embed_from_grid(embed_dim, grid)


def _sincos_nd(x: torch.Tensor, C: int) -> torch.Tensor:
    """Interleaved sin/cos of each channel of x against C/2 frequencies.
    x: (..., D) -> (..., D*C), per-dim blocks [sin0, cos0, sin1, cos1, ...]."""
    div_term = torch.arange(0, C, 2, dtype=torch.float32, device=x.device) * (1000.0 / C)
    outs = []
    for i in range(x.shape[-1]):
        v = x[..., i : i + 1] * div_term  # (..., C/2)
        outs.append(torch.stack([torch.sin(v), torch.cos(v)], dim=-1).flatten(-2))
    return torch.cat(outs, dim=-1)


def get_3d_embedding(xyz: torch.Tensor, C: int, cat_coords: bool = True) -> torch.Tensor:
    pe = _sincos_nd(xyz, C)
    if cat_coords:
        pe = torch.cat([pe, xyz], dim=-1)  # coords last (reference :141-143)
    return pe


class FourierEmbedder:
    """NeRF-style Fourier embedding (reference Embedder_Fourier)."""

    def __init__(
        self,
        input_dim: int,
        max_freq_log2: float,
        N_freqs: int,
        log_sampling: bool = True,
        include_input: bool = True,
    ):
        self.input_dim = input_dim
        self.include_input = include_input
        if log_sampling:
            bands = 2.0 ** np.linspace(0.0, max_freq_log2, N_freqs)
        else:
            bands = np.linspace(2.0**0.0, 2.0**max_freq_log2, N_freqs)
        # float32 like the JAX package, which multiplies float32 arrays by
        # these scalars with x64 disabled
        self.freq_bands = [float(np.float32(f)) for f in bands]
        self.out_dim = input_dim * (include_input + 2 * N_freqs)

    def __call__(self, x: torch.Tensor, rescale: float = 1.0) -> torch.Tensor:
        out = []
        if self.include_input:
            out.append(x / rescale)
        for freq in self.freq_bands:
            out.append(torch.sin(x * freq))
            out.append(torch.cos(x * freq))
        return torch.cat(out, dim=-1)
