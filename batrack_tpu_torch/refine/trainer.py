"""Stage-3 optimiser loop: Adam with a cosine or linear learning-rate
schedule (counterpart of batrack_tpu/refine/trainer.py).

One Adam over the four parameter tensors, betas (0.9, 0.9): the reference
builds per-group learning rates, but its scheduler overwrites every group's
rate each step, so one schedule over all of them is its effective
behaviour. torch's Adam computes m / bc1 / (sqrt(v) / sqrt(bc2) + eps),
optax's mu_hat / (sqrt(nu_hat) + eps): the same formula. The loop runs
eagerly, one backward and one optimiser step per iteration, and reads the
loss back to the host only when verbose and at the end.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from batrack_tpu_torch.refine.refine_net import (
    RefineConfig,
    RefineData,
    RefineParams,
    total_loss,
)
from batrack_tpu_torch.utils.config import full_fp32

LR_END = 1e-6


def cosine_schedule(t: float, lr_start: float, lr_end: float) -> float:
    return lr_end + (lr_start - lr_end) * (1 + np.cos(t * np.pi)) / 2


def learning_rate(cfg: RefineConfig, it: int) -> float:
    t = it / cfg.niter
    if cfg.schedule == "cosine":
        return cosine_schedule(t, cfg.lr, LR_END)
    if cfg.schedule == "linear":
        return cfg.lr + (LR_END - cfg.lr) * t
    raise ValueError(cfg.schedule)


def global_alignment_loop(
    params: RefineParams,
    data: RefineData,
    image_hw: Tuple[int, int],
    cfg: RefineConfig,
    verbose: bool = False,
) -> Tuple[RefineParams, float]:
    """Optimise; returns (params, the loss of the last step). The returned
    params are new leaf tensors; the inputs are left as they were."""
    params = RefineParams(*(t.detach().clone().requires_grad_(True) for t in params))
    opt = torch.optim.Adam(list(params), lr=cfg.lr, betas=(0.9, 0.9), eps=1e-8)
    dtype = params.trajs_scales.dtype

    loss = torch.tensor(float("inf"))
    with full_fp32():  # se3.exp's matrix products in full float32, no TF32
        for it in range(cfg.niter):
            # the rate rounded to the params' dtype, as the JAX loop passes it
            lr_now = float(torch.tensor(learning_rate(cfg, it), dtype=dtype))
            opt.zero_grad(set_to_none=False)
            loss, parts = total_loss(params, data, image_hw, cfg)
            loss.backward()
            # frozen tensors get zero gradients, which leave Adam's moments
            # and the tensor unchanged (a tensor no enabled loss reads has none)
            for frozen, t in ((cfg.fixed_pose, params.pose_delta), (cfg.fixed_K, params.K)):
                if frozen and t.grad is not None:
                    t.grad.zero_()
            for group in opt.param_groups:
                group["lr"] = lr_now
            opt.step()
            if verbose and it % 50 == 0:
                vals = {k: float(v) for k, v in parts.items()}
                print(f"iter {it}: loss={float(loss.detach()):.5f} lr={lr_now:.2e} {vals}")
    return RefineParams(*(t.detach() for t in params)), float(loss.detach())
