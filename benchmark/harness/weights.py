"""The tracker's weights, made on the device from the seed in the type they
are served in (bf16), in one draw for all of them.

Random weights put the visibility head near 0.5, below VIS_THRESHOLD 0.9,
so no edge would reach the bundle adjustment; and random flow heads move a
track by tens of pixels per step. So the recipe sets the visibility head's
bias above the gate and damps both flow heads, as a trained tracker
behaves (the configuration's `weights` and `assumed`)."""

from __future__ import annotations

import math
from typing import Dict

import torch

NORM_ONES = ("norm.weight",)
NORM_ZEROS = ("norm.bias",)
FLOW_HEADS = ("updateformer.flow_head", "updateformer_dyn.flow_head")


def fan_in(name: str, shapes: Dict[str, tuple]) -> int:
    w = shapes[name.rsplit(".", 1)[0] + ".weight"]
    return math.prod(w[1:]) if len(w) > 1 else 1


def make_weights(shapes: Dict[str, tuple], seed: int, device, flow_head_scale: float,
                 vis_bias: float, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every weight and bias uniform in +-1/sqrt(fan_in), the recipe's
    exceptions applied."""
    names = list(shapes)
    counts = [math.prod(shapes[k]) for k in names]
    bounds = torch.tensor([1.0 / math.sqrt(fan_in(k, shapes)) for k in names], device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(sum(counts), generator=gen, device=device, dtype=dtype)
    flat = (2.0 * u - 1.0) * torch.repeat_interleave(
        bounds, torch.tensor(counts, device=device)).to(dtype)
    out = {k: v.view(shapes[k]) for k, v in zip(names, flat.split(counts))}
    for k in NORM_ONES:
        out[k].fill_(1.0)
    for k in NORM_ZEROS:
        out[k].zero_()
    for head in FLOW_HEADS:
        out[head + ".weight"].mul_(flow_head_scale)
        out[head + ".bias"].mul_(flow_head_scale)
    out["vis_predictor.0.bias"].fill_(vis_bias)
    return out
