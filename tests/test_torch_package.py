"""Package rules of batrack_tpu_torch: it stands alone (no jax, no flax, no
module of batrack_tpu), its entry points run on CUDA unless the caller asks
for the CPU, and its copies of the JAX package's jax-free helpers (config,
synthetic scene) agree with the originals."""

import dataclasses
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import batrack_tpu_torch
from batrack_tpu.geometry import se3 as jse3
from batrack_tpu.utils import config as jconfig
from batrack_tpu.utils.synth import make_scene as jmake_scene
from batrack_tpu_torch.ops import attention, corr_kernel
from batrack_tpu_torch.slam import BATrack
from batrack_tpu_torch.tracker import MDTrackerAdapter
from batrack_tpu_torch.utils import config
from batrack_tpu_torch.utils.synth import make_scene

PKG = Path(batrack_tpu_torch.__file__).parent


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], "batrack_tpu_torch."))


def test_import_leaves_jax_and_batrack_tpu_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_submodules()!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'batrack_tpu')]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 0


def test_sources_name_no_jax_flax_or_batrack_tpu():
    """No source imports jax or flax, or names a module of batrack_tpu
    (`batrack_tpu.` never matches `batrack_tpu_torch.`); file paths such as
    batrack_tpu/ops/pallas_corr.py in source notes are allowed."""
    pattern = re.compile(r"import jax|from jax|import flax|from flax|batrack_tpu\."
                         r"|import_module\(\s*[\"'](jax|flax|batrack_tpu)\b")
    offenders = [f"{f.relative_to(PKG)}:{i}: {line.strip()}"
                 for f in sorted(PKG.rglob("*")) if f.suffix in (".py", ".cu", ".cuh", ".h")
                 for i, line in enumerate(f.read_text().splitlines(), 1)
                 if pattern.search(line)]
    assert not offenders, "\n".join(offenders)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.Config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BATrack(cfg, 48, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MDTrackerAdapter(cfg.model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        config.resolve_device()
    assert config.resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_other_devices():
    """The plain versions run only for CPU tensors; any other device goes to
    the kernel's checks and raises rather than falling back."""
    qkv = torch.zeros((1, 8, 3 * 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention.fused_qkv_attention(qkv, 2, 0.25)
    pyr = corr_kernel.pack_pyramid([torch.zeros((2, 128, 8, 8), device="meta")])
    with pytest.raises(ValueError, match="unsupported device"):
        corr_kernel.corr_sample(pyr, torch.zeros((3, 2, 128), device="meta"),
                                torch.zeros((2, 3, 2), device="meta"), 1)
    assert attention.fused_qkv_attention.launches == 0
    assert corr_kernel.corr_sample.launches == 0


def test_config_copy_matches_jax_config():
    def tree(c):
        return {f.name: (tree(getattr(c, f.name)) if dataclasses.is_dataclass(getattr(c, f.name))
                         else getattr(c, f.name)) for f in dataclasses.fields(c)}

    assert tree(config.Config()) == tree(jconfig.Config())
    ov = ["slam.BUFFER_SIZE=64", "model.compute_dtype=float32", "model.interp_shape=[32,48]"]
    path = Path(__file__).parents[1] / "configs" / "davis_demo.yaml"
    assert tree(config.load_config(str(path), ov)) == tree(jconfig.load_config(str(path), ov))


def test_make_scene_matches_jax():
    import jax.numpy as jnp

    intr = np.array([60.0, 60.0, 32.0, 24.0], np.float32)
    ref = jmake_scene(6, 48, 64, intr, jse3, jnp)
    out = make_scene(6, 48, 64, intr)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-6)
