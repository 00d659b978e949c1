"""Flax MDTracker params -> this package's state dict.

The port's MDTracker names its parameters as the reference md_tracker.pth
does, so that file loads directly. This module carries weights the other
way: a Flax parameter tree of the JAX package (as numpy arrays, the layout
batrack_tpu/tracker/convert.py produces) becomes a state dict by reference
name: conv kernels HWIO -> OIHW, Dense kernels (in, out) -> (out, in),
GroupNorm scale -> weight. The round trip through the JAX converter is
exact.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _conv(p, prefix, out):
    out[f"{prefix}.weight"] = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _dense(p, prefix, out):
    out[f"{prefix}.weight"] = np.transpose(np.asarray(p["kernel"]), (1, 0))
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _updateformer(p, prefix, out):
    _dense(p["input_transform"], f"{prefix}.input_transform", out)
    _dense(p["flow_head"], f"{prefix}.flow_head", out)
    for kind in ("time_blocks", "space_blocks"):
        i = 0
        while f"{kind}_{i}" in p:
            blk = p[f"{kind}_{i}"]
            base = f"{prefix}.{kind}.{i}"
            _dense(blk["attn"]["qkv"], f"{base}.attn.qkv", out)
            _dense(blk["attn"]["proj"], f"{base}.attn.proj", out)
            _dense(blk["mlp"]["fc1"], f"{base}.mlp.fc1", out)
            _dense(blk["mlp"]["fc2"], f"{base}.mlp.fc2", out)
            i += 1


def state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """Flax MDTracker params ({'params': ...} or the inner dict) -> state
    dict of batrack_tpu_torch.tracker.MDTracker (float32 CPU tensors)."""
    p = params.get("params", params)
    out: Dict[str, np.ndarray] = {}
    fnet = p["fnet"]
    for name in ("conv1", "conv2", "conv3"):
        _conv(fnet[name], f"fnet.{name}", out)
    for l in range(1, 5):
        for b in range(2):
            blk = fnet[f"layer{l}_{b}"]
            base = f"fnet.layer{l}.{b}"
            _conv(blk["conv1"], f"{base}.conv1", out)
            _conv(blk["conv2"], f"{base}.conv2", out)
            if "downsample" in blk:
                _conv(blk["downsample"], f"{base}.downsample.0", out)
    _updateformer(p["updateformer"], "updateformer", out)
    _updateformer(p["updateformer_dyn"], "updateformer_dyn", out)
    out["norm.weight"] = np.asarray(p["norm"]["scale"])
    out["norm.bias"] = np.asarray(p["norm"]["bias"])
    _dense(p["ffeat_updater"], "ffeat_updater.0", out)
    _dense(p["vis_predictor"], "vis_predictor.0", out)
    mlp = p["motion_label_block"]["mlp"]
    _dense(mlp["fc1"], "motion_label_block.network.mlp.fc1", out)
    _dense(mlp["fc2"], "motion_label_block.network.mlp.fc2", out)
    _conv(p["embedConv"], "embedConv", out)
    _dense(p["zeroMLPflow"], "zeroMLPflow", out)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}
