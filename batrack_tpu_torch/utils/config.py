"""Typed configuration tree for the PyTorch port, plus device and precision
helpers.

The dataclass tree is the same as the JAX package's (same groups, fields and
defaults, which mirror configs/davis_demo.yaml), so one YAML file and one set
of `key=value` overrides configure either package. It is a copy, not an
import: this package never imports the JAX package.

Two knobs keep their JAX names so that YAML files load unchanged:
`model.use_pallas_corr` selects the hand-written correlation kernel (K1,
ops/corr_kernel.py) and `model.use_flash_attention` the packed-qkv attention
kernel (K2, ops/attention.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import torch


@dataclass
class SlamConfig:
    # motion model (davis_demo.yaml:1-3)
    MOTION_DAMPING: float = 0.5
    MOTION_MODEL: str = "DAMPED_LINEAR"
    BA_mode: str = "rgbd_dual_ba"

    # windows (davis_demo.yaml:7-12)
    REMOVAL_WINDOW: int = 20
    OPTIMIZATION_WINDOW: int = 15
    # reference-compat no-op: in configs/davis_demo.yaml:9 but never read
    PATCH_LIFETIME: int = 12
    KEYFRAME_INDEX: int = 4
    KEYFRAME_THRESH: float = 10.0

    PATCHES_PER_FRAME: int = 400
    BUFFER_SIZE: int = 1024
    PATCH_GEN: str = "grid_grad_20"

    ITER: int = 4
    LOSS: str = "huber"

    USE_MAP_FILTERING: bool = True
    MAP_FILTERING_TH: float = 5.0
    MIN_TRACK_LEN: int = 3
    TRAJ_INIT: Any = False

    BOUNDARY_PADDING: int = 20
    VIS_THRESHOLD: float = 0.9
    STATIC_THRESHOLD: float = 0.1
    STATIC_QUANTILE: float = 0.0
    # reference-compat no-ops, accepted so reference YAMLs load unchanged
    CONF_THRESHOLD: float = 1.0
    CONF_QUANTILE: float = 0.8

    S_slam: int = 12
    kf_stride: int = 2
    num_init: int = 12
    backward_tracking: bool = True
    use_static_all: bool = True
    use_keyframe: bool = False
    KEYFRAME_RING_EXTRA: int = 8

    # 'slot' = dense slot-structured solver; 'flat' = general edge solver
    BA_BACKEND: str = "slot"

    mesh_devices: int = 0
    distributed: bool = False

    BA_EP: float = 10.0
    BA_LMBDA: float = 1e-4
    BA_ALPHA: float = 0.05

    @property
    def S_local(self) -> int:
        return self.S_slam * 2 - 1


@dataclass
class MotionLabelConfig:
    mode: str = "mlp_v1"
    in_dim: int = 128
    hidden_dim: int = 256
    S: int = 8


@dataclass
class ModelConfig:
    # tracker architecture (davis_demo.yaml:63-95)
    S: int = 12
    I: int = 4
    stride: int = 4
    mode: str = "md_tracker"
    sliding_window_len: int = 12
    model_stride: int = 4
    Embed3D: bool = True
    use_log_depth: bool = False
    dynamic_mask_detach: bool = True
    hidden_dim: int = 256
    latent_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 3
    disp_context_levels: int = 4
    disp_context_radius: int = 1
    add_space_attn: bool = True
    space_depth: int = 6
    time_depth: int = 6
    hidden_size: int = 384
    num_heads: int = 8
    num_virtual_tracks: int = 64
    static_iters: int = 2
    space_depth_dyn: int = 3
    time_depth_dyn: int = 3
    motion_label_block: Optional[MotionLabelConfig] = field(default_factory=MotionLabelConfig)
    use_static_mask: bool = False
    use_static: bool = False
    init_dir: str = ""
    interp_shape: Tuple[int, int] = (384, 512)
    # hand-written kernels (K1 correlation, K2 packed-qkv attention)
    use_pallas_corr: bool = True
    use_flash_attention: bool = True
    # bf16 tracker activations in production; "float32" for parity tests
    compute_dtype: str = "bfloat16"


@dataclass
class DataConfig:
    imagedir: str = ""
    depthdir: str = ""
    depthdir_gt: str = ""
    calib: str = ""
    stride: int = 1
    skip: int = 0
    end: int = -1
    max_length: int = 900
    gt_traj: str = ""
    name: str = ""
    savedir: str = ""
    traj_format: str = "davis"
    input_intrinsics: bool = False
    native_prefetch: bool = False


@dataclass
class VisualizerConfig:
    save_dir: str = "./results"
    grayscale: bool = False
    pad_value: int = 0
    fps: int = 10
    mode: str = "rainbow"
    linewidth: int = 2
    show_first_frame: int = 10
    tracks_leave_trace: int = 8


@dataclass
class RefineConfig:
    grid_size: int = 10
    lr: float = 0.01
    niter: int = 200
    schedule: str = "cosine"
    alpha: float = 0.5
    spatial_loss: float = 5.0
    inter_frame_loss: float = 0.3
    cam_smooth_vec_loss: float = 1.0
    pts_3d_loss: float = 1.0
    scale_smoothness_loss: float = 0.3
    fixed_pose: bool = False
    fixed_K: bool = True


@dataclass
class Config:
    slam: SlamConfig = field(default_factory=SlamConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    visualizer: VisualizerConfig = field(default_factory=VisualizerConfig)
    refine: RefineConfig = field(default_factory=RefineConfig)
    exp_name: str = "batrack_tpu"
    output_dir: str = ""
    save_trajectory: bool = True
    save_video: bool = False
    save_plot: bool = True
    save_results: bool = True
    viz: bool = False
    profile_dir: str = ""


def _merge(dc, data: dict):
    """Recursively apply a dict onto a dataclass instance."""
    for k, v in data.items():
        if not hasattr(dc, k):
            setattr(dc, k, v)
            continue
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _merge(cur, v)
        else:
            setattr(dc, k, v)
    return dc


def load_config(path: Optional[str] = None, overrides: Optional[list] = None) -> Config:
    """Load a YAML config (reference configs/ layout) and apply hydra-style
    `a.b.c=value` overrides."""
    import yaml

    cfg = Config()
    if path:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        _merge(cfg, data)
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, _, raw = ov.partition("=")
        try:
            val = yaml.safe_load(raw)
        except yaml.YAMLError:
            val = raw
        obj = cfg
        parts = key.lstrip("+").split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        setattr(obj, parts[-1], val)
    return cfg


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Defaults to CUDA; asking for CUDA
    on a machine without it raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def _tf32(allowed: bool):
    """Set TF32 for CUDA matmuls and cuDNN convolutions, restoring the
    previous settings on exit."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allowed
    torch.backends.cudnn.allow_tf32 = allowed
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def full_fp32():
    """Turn TF32 off for CUDA matmuls and cuDNN convolutions.

    The JAX package pins Precision.HIGHEST in geometry, BA and the
    correlation contraction; TF32 keeps about three decimal digits, so those
    stages (and float32 parity runs) execute inside this context."""
    return _tf32(False)


def allow_tf32():
    """Allow TF32 for CUDA matmuls and cuDNN convolutions: the stage-1
    networks run so."""
    return _tf32(True)
