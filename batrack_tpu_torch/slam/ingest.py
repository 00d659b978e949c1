"""Per-frame ingestion: window roll, patch generation, depth init, motion
model (counterpart of batrack_tpu/slam/ingest.py).

Random draws: torch cannot reproduce jax.random, so the patch generators
take their random arrays from the caller (`draws`); BATrack fills them from
its torch.Generator, or from a hook that tests fill with JAX's draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from batrack_tpu_torch.geometry import se3
from batrack_tpu_torch.ops.sampling import avg_pool2d, bilinear_sample2d, patchify
from batrack_tpu_torch.slam.state import SLAMState, StaticDims

REL_MARGIN = 0.15
NUM_EXPAND = 8


def image_gradient(image: torch.Tensor) -> torch.Tensor:
    """Pooled gradient magnitude of an (H, W, 3) image -> (H//4, W//4)."""
    gray = image.sum(-1)
    padded = torch.nn.functional.pad(gray, (1, 1, 1, 1))
    dx = padded[:-1, 1:] - padded[:-1, :-1]
    dy = padded[1:, :-1] - padded[:-1, :-1]
    g = torch.sqrt(dx * dx + dy * dy)
    return avg_pool2d(g, 4, 4)


def draw_shapes(patch_gen: str, M: int):
    """Shape and kind of the two random arrays (x, y) a generator consumes:
    ('uniform', shape) for grid_grad, ('randint', (M,)) for random, None
    for the deterministic generators."""
    if patch_gen.startswith("grid_grad"):
        g = int(patch_gen.split("_")[-1])
        num_grid = g * g
        return "uniform", (num_grid, NUM_EXPAND * (M // num_grid))
    if patch_gen == "random":
        return "randint", (M,)
    return None


def make_draws(patch_gen: str, M: int, ht: int, wd: int,
               generator: torch.Generator) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The frame's random arrays from a torch.Generator (on its device)."""
    spec = draw_shapes(patch_gen, M)
    if spec is None:
        return None
    kind, shape = spec
    dev = generator.device
    if kind == "uniform":
        return (torch.rand(shape, generator=generator, device=dev),
                torch.rand(shape, generator=generator, device=dev))
    return (torch.randint(1, wd - 1, shape, generator=generator, device=dev),
            torch.randint(1, ht - 1, shape, generator=generator, device=dev))


def generate_patches_grid_grad(
    image: torch.Tensor,  # (H, W, 3) float
    draws: Tuple[torch.Tensor, torch.Tensor],  # uniforms in [0, 1)
    *,
    grid_size: int,
    M: int,
    ht: int,
    wd: int,
) -> torch.Tensor:
    """`grid_grad_K` patch sampling: in each of grid_size^2 cells draw
    NUM_EXPAND * grid_M margin-inset candidates and keep the grid_M with the
    largest pooled image gradient. Returns rounded (M, 2) pixel coords."""
    num_grid = grid_size * grid_size
    grid_M = M // num_grid
    if grid_M == 0:
        raise ValueError(
            f"PATCH_GEN=grid_grad_{grid_size} needs PATCHES_PER_FRAME >= "
            f"{num_grid} (one patch per grid cell); got M={M}")
    n_cand = NUM_EXPAND * grid_M
    h_grid, w_grid = ht // grid_size, wd // grid_size
    g = image_gradient(image)

    ux, uy = draws
    x = ux * (1 - 2 * REL_MARGIN) + REL_MARGIN
    y = uy * (1 - 2 * REL_MARGIN) + REL_MARGIN
    cell = torch.arange(num_grid, device=image.device)
    off_x = (cell % grid_size).to(torch.float32) * w_grid
    off_y = (cell // grid_size).to(torch.float32) * h_grid
    x_global = torch.round(x * w_grid + off_x[:, None])
    y_global = torch.round(y * h_grid + off_y[:, None])

    gg = bilinear_sample2d(
        g[None, None], (x_global / 4.0).reshape(1, -1), (y_global / 4.0).reshape(1, -1)
    )[0, 0].reshape(num_grid, n_cand)
    # stable ascending sort (the JAX default): rounded candidates tie often
    top = torch.argsort(gg, dim=-1, stable=True)[:, -grid_M:]
    xg = torch.gather(x_global, 1, top)
    yg = torch.gather(y_global, 1, top)
    return torch.stack([xg.reshape(-1), yg.reshape(-1)], dim=-1)


def generate_patches_uniform(*, M, ht, wd, device) -> torch.Tensor:
    """`uniform` grid patch sampling."""
    m = int(round(M ** 0.5))
    gy, gx = torch.meshgrid(torch.arange(m, dtype=torch.float32, device=device),
                            torch.arange(m, dtype=torch.float32, device=device),
                            indexing="ij")
    gy = 8.0 + gy.reshape(-1) / float(m - 1) * (ht - 16)
    gx = 8.0 + gx.reshape(-1) / float(m - 1) * (wd - 16)
    coords = torch.stack([gx, gy], dim=-1)
    reps = -(-M // coords.shape[0])
    return coords.repeat(reps, 1)[:M]


def init_patch_depth(coords: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Disparity init from the depth map."""
    d = bilinear_sample2d(depth[None, None], coords[None, :, 0], coords[None, :, 1])[0, 0]
    return 1.0 / torch.clamp(d, min=1e-2)


def motion_model(poses: torch.Tensor, n: int, damping: float) -> None:
    """Damped-linear SE3 extrapolation for frame n, in place:
    poses[n] := Exp(damping * Log(P_{n-1} P_{n-2}^{-1})) * P_{n-1} for n > 1."""
    if n == 1:
        poses[1] = poses[0]
    elif n > 1:
        P1, P2 = poses[n - 1], poses[n - 2]
        xi = damping * se3.log(se3.mul(P1, se3.inv(P2)))
        poses[n] = se3.mul(se3.exp(xi), P1)


def ingest_frame(
    state: SLAMState,
    image: torch.Tensor,       # (H, W, 3) uint8 or float32 0..255
    depth: torch.Tensor,       # (H, W) float32
    intrinsics: torch.Tensor,  # (4,)
    n: int,                    # current frame index (pre-increment)
    counter: int,              # global frame counter
    dims: StaticDims,
    *,
    patch_gen: str,
    motion_damping: float,
    mark_valid: bool,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """One frame into the buffers, updating `state` in place. Returns the
    (M, 2) patch coords."""
    M = dims.M
    image = image.to(torch.float32)

    # roll the local window (a copy, so the window keeps its time order)
    state.win_images = torch.roll(state.win_images, -1, 0)
    state.win_images[-1] = image
    state.win_depths = torch.roll(state.win_depths, -1, 0)
    state.win_depths[-1] = depth

    if patch_gen.startswith("grid_grad"):
        coords = generate_patches_grid_grad(
            image, draws, grid_size=int(patch_gen.split("_")[-1]),
            M=M, ht=dims.ht, wd=dims.wd)
    elif patch_gen == "random":
        coords = torch.stack([draws[0].to(torch.float32), draws[1].to(torch.float32)], -1)
    elif patch_gen == "uniform":
        coords = generate_patches_uniform(M=M, ht=dims.ht, wd=dims.wd, device=image.device)
    else:
        raise NotImplementedError(f"PATCH_GEN={patch_gen!r} is not ported")

    rows = slice(n * M, (n + 1) * M)
    disp = init_patch_depth(coords, depth)
    state.patches[rows] = torch.cat([coords, disp[:, None]], dim=-1)
    clr = patchify(image.permute(2, 0, 1)[None], (coords + 0.5)[None], 0)[0, :, :, 0, 0]
    state.colors[rows] = clr.to(torch.uint8)
    motion_model(state.poses, n, motion_damping)
    if mark_valid:
        state.patches_valid[rows] = 1.0
    state.tstamps[n] = counter
    state.intrinsics[n] = intrinsics
    return coords
