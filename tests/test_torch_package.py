"""Package rules of batrack_tpu_torch: it stands alone (no jax, no flax, no
module of batrack_tpu), its entry points run on CUDA unless the caller asks
for the CPU, and its copies of the JAX package's jax-free helpers (config,
synthetic scene) agree with the originals."""

import ast
import dataclasses
import pkgutil
import re
import shutil
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
from batrack_tpu_torch.parallel import Mesh, get_mesh, init_distributed
from batrack_tpu_torch.slam import BATrack
from batrack_tpu_torch.tracker import MDTrackerAdapter
from batrack_tpu_torch.utils import config
from batrack_tpu_torch.utils.synth import make_scene

PKG = Path(batrack_tpu_torch.__file__).parent


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], "batrack_tpu_torch."))


def test_import_leaves_jax_and_batrack_tpu_out():
    """Importing every module loads no JAX, Flax or batrack_tpu module, and
    none of the optional libraries: matplotlib, which the card's machine
    lacks, scipy, PIL and safetensors, which the port does without, and
    cv2, which it loads only inside the functions that need it."""
    assert {"batrack_tpu_torch.parallel.mesh", "batrack_tpu_torch.parallel.shard_kernels",
            "batrack_tpu_torch.parallel.sharded_slot_ba", "batrack_tpu_torch.cli.run_slam",
            "batrack_tpu_torch.cli.run_refine", "batrack_tpu_torch.cli.eval_depth",
            "batrack_tpu_torch.data.streams", "batrack_tpu_torch.data.png",
            "batrack_tpu_torch.refine.refine_net", "batrack_tpu_torch.refine.trainer",
            "batrack_tpu_torch.utils.evaluation", "batrack_tpu_torch.utils.traj",
            "batrack_tpu_torch.depth.dpt", "batrack_tpu_torch.depth.unidepth",
            "batrack_tpu_torch.depth.align",
            "batrack_tpu_torch.cli.infer_depth", "batrack_tpu_torch.cli.infer_metric_depth",
            "batrack_tpu_torch.cli.align_depth", "batrack_tpu_torch.cli.vis_results",
            "batrack_tpu_torch.utils.visualizer", "batrack_tpu_torch.utils.tensorfile",
            "batrack_tpu_torch.ba.solver", "batrack_tpu_torch.slam.keyframe",
            "batrack_tpu_torch.slam.oracle", "batrack_tpu_torch.slam.checkpoint",
            "batrack_tpu_torch.parallel.sharded_ba", "batrack_tpu_torch.geometry.so3",
            "batrack_tpu_torch.geometry.sim3",
            } <= set(_submodules())
    code = (
        "import importlib, sys\n"
        f"for m in {_submodules()!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'batrack_tpu', 'scipy', 'cv2', 'PIL', 'matplotlib', 'safetensors')]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 0


def test_sources_name_no_jax_flax_or_batrack_tpu():
    """No source of the package, chip_smoke.py, scripts/torch_*.py or the
    root's bench*_torch.py imports jax or flax, or names a module of
    batrack_tpu (`batrack_tpu.` never matches `batrack_tpu_torch.`); file
    paths such as batrack_tpu/ops/pallas_corr.py in source notes are
    allowed."""
    pattern = re.compile(r"import jax|from jax|import flax|from flax|batrack_tpu\."
                         r"|import_module\(\s*[\"'](jax|flax|batrack_tpu)\b")
    root = PKG.parent
    files = ([f for f in sorted(PKG.rglob("*")) if f.suffix in (".py", ".cu", ".cuh", ".h")]
             + [root / "chip_smoke.py"] + sorted((root / "scripts").glob("torch_*.py"))
             + sorted(root.glob("bench*_torch.py")))
    assert root / "scripts" / "torch_corr_ab.py" in files
    assert {root / f for f in ("bench_torch.py", "bench_refine_torch.py",
                               "bench_depth_torch.py", "bench_scaling_torch.py",
                               "scripts/torch_tracker_breakdown.py",
                               "scripts/torch_corr_vol_ab.py")} <= set(files)
    offenders = [f"{f.relative_to(root)}:{i}: {line.strip()}"
                 for f in files
                 for i, line in enumerate(f.read_text().splitlines(), 1)
                 if pattern.search(line)]
    assert not offenders, "\n".join(offenders)


# cv2 may be imported only inside functions of these modules, for the
# features that need it (JPEG frames, sift patches, the track video, and
# stage 1's resizes, which are cv2's in the JAX package)
CV2_MODULES = ("data/image.py", "slam/ingest.py", "utils/visualizer.py", "depth/dpt.py",
               "depth/align.py")


def _library_rule_offenders(pkg: Path, extra_files=()):
    """Imports that break the library rule in the package at `pkg` (and
    `extra_files`): scipy, PIL and safetensors anywhere; cv2 anywhere but
    inside a function of CV2_MODULES."""
    root = pkg.parent
    offenders = []
    for f in sorted(pkg.rglob("*.py")) + list(extra_files):
        tree = ast.parse(f.read_text())
        in_function = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                in_function.update(id(n) for n in ast.walk(node) if n is not node)
        rel = f.relative_to(root).as_posix()
        allowed = rel.startswith(pkg.name + "/") and rel[len(pkg.name) + 1:] in CV2_MODULES
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                libs = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                libs = {(node.module or "").split(".")[0]}
            else:
                continue
            for lib in libs & {"scipy", "PIL", "safetensors", "cv2"}:
                if lib != "cv2" or not (allowed and id(node) in in_function):
                    offenders.append(f"{rel}:{node.lineno}: import {lib}")
    return offenders


def test_sources_import_no_optional_library_at_module_level():
    """matplotlib is not on the card's machine, and safetensors is not
    promised there; cv2 (4.13.0) and PIL (12.2.0) are, but the port loads
    cv2 only for the features that need it. No module of the package, nor
    chip_smoke.py, imports one of them at module level (utils/traj.py
    imports matplotlib inside plot_trajectory, which skips the plot
    without it). None imports scipy, PIL or safetensors anywhere, and cv2
    only inside functions of data/image.py (JPEG frames), slam/ingest.py
    (sift patches), utils/visualizer.py (the track video), depth/dpt.py
    and depth/align.py (stage 1's resizes)."""
    pattern = re.compile(r"^(import|from)\s+(scipy|cv2|PIL|matplotlib|safetensors)\b")
    root = PKG.parent
    files = sorted(PKG.rglob("*.py")) + [root / "chip_smoke.py"]
    assert PKG / "cli" / "run_slam.py" in files and PKG / "refine" / "trainer.py" in files
    offenders = [f"{f.relative_to(root)}:{i}: {line}"
                 for f in files
                 for i, line in enumerate(f.read_text().splitlines(), 1)
                 if pattern.search(line)]
    assert not offenders, "\n".join(offenders)
    assert all((PKG / m).exists() for m in CV2_MODULES)
    offenders = _library_rule_offenders(PKG, [root / "chip_smoke.py"])
    assert not offenders, "\n".join(offenders)


@pytest.mark.parametrize("plant", ["module_level_cv2", "cv2_elsewhere", "pil_in_function"])
def test_library_rule_catches_a_planted_import(tmp_path, plant):
    """The rule's check on a copy of the package with one import planted: a
    module-level `import cv2` in data/image.py, cv2 inside a function of a
    module outside the allow-list, and PIL inside an allowed function."""
    pkg = tmp_path / PKG.name
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    assert not _library_rule_offenders(pkg)
    target, code = {
        "module_level_cv2": ("data/image.py", "import cv2\n"),
        "cv2_elsewhere": ("data/streams.py", "\ndef _decode(path):\n    import cv2\n"),
        "pil_in_function": ("utils/visualizer.py", "\ndef _load(p):\n    from PIL import Image\n"),
    }[plant]
    path = pkg / target
    text = path.read_text()
    path.write_text(code + text if plant == "module_level_cv2" else text + code)
    offenders = _library_rule_offenders(pkg)
    assert len(offenders) == 1 and offenders[0].startswith(f"{PKG.name}/{target}:"), offenders


def _journey_script_offenders(scripts: Path):
    """Lines of the port's journey scripts (scripts/torch_*/*.sh under
    `scripts`) that name a module of batrack_tpu, or run `python -m` on
    anything but a CLI of batrack_tpu_torch. Returns (offenders, the
    number of `python -m` lines)."""
    offenders, calls = [], 0
    for f in sorted(scripts.glob("torch_*/*.sh")):
        for i, line in enumerate(f.read_text().splitlines(), 1):
            where = f"{f.relative_to(scripts).as_posix()}:{i}: {line.strip()}"
            run = re.search(r"\bpython3?\s+-m\s+(\S+)", line)
            calls += bool(run)
            if "batrack_tpu." in line or (
                    run and not re.fullmatch(r"batrack_tpu_torch\.cli\.\w+", run.group(1))):
                offenders.append(where)
    return offenders, calls


def test_journey_scripts_call_only_the_ports_clis():
    """Every `python -m` line of scripts/torch_demo, torch_eval_sintel and
    torch_eval_shibuya names a module of batrack_tpu_torch.cli, and no line
    names batrack_tpu."""
    scripts = PKG.parent / "scripts"
    assert len(list(scripts.glob("torch_*/*.sh"))) == 9
    offenders, calls = _journey_script_offenders(scripts)
    assert not offenders, "\n".join(offenders)
    assert calls == 16


@pytest.mark.parametrize("plant", ["jax_cli", "not_a_cli", "jax_in_a_comment"])
def test_journey_script_rule_catches_a_planted_line(tmp_path, plant):
    """The scripts' check on a copy with one line planted: a JAX CLI, a
    port module that is not a CLI, and batrack_tpu named outside a call."""
    scripts = PKG.parent / "scripts"
    for d in scripts.glob("torch_*/"):
        shutil.copytree(d, tmp_path / d.name)
    assert _journey_script_offenders(tmp_path)[0] == []
    line = {"jax_cli": "python -m batrack_tpu.cli.run_slam --config x",
            "not_a_cli": "python -m batrack_tpu_torch.data.decode_worker",
            "jax_in_a_comment": "# see batrack_tpu.cli.run_refine"}[plant]
    target = tmp_path / "torch_demo" / "run_dense.sh"
    target.write_text(target.read_text() + line + "\n")
    offenders, _ = _journey_script_offenders(tmp_path)
    assert len(offenders) == 1 and offenders[0].startswith("torch_demo/run_dense.sh:"), offenders


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
    # the multi-device entry points too
    mesh = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BATrack(cfg, 48, 64, mesh=mesh)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MDTrackerAdapter(cfg.model, mesh=mesh)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_mesh(1)
    # the CLIs and the stage-3 data builder
    from batrack_tpu_torch.cli import infer_depth, infer_metric_depth, run_refine, run_slam
    from batrack_tpu_torch.refine import build_refine_data

    for cli in (run_slam, run_refine):
        args = ["--result_dir", "."] if cli is run_refine else []
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(args)
    # the stage-1 network CLIs refuse before reading their checkpoint
    for cli in (infer_depth, infer_metric_depth):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--img_dir", ".", "--out_dir", ".", "--checkpoint", "absent.pth"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_refine_data({})


def test_keyframe_flat_and_backward_options_construct(monkeypatch):
    """use_keyframe, BA_BACKEND="flat" and backward tracking, which raised
    before they were ported, construct on the CPU; the oracle tracker is an
    entry point too and refuses a missing CUDA device."""
    from batrack_tpu_torch.slam import OracleTracker
    from batrack_tpu_torch.slam.state import StaticDims

    cfg = config.Config()
    cfg.slam.use_keyframe = True
    slam = BATrack(cfg, 48, 64, device="cpu")
    assert slam.cfg.slam.BA_BACKEND == "flat" and slam.delta == {}
    cfg = config.Config()
    cfg.slam.BA_BACKEND = "flat"
    BATrack(cfg, 48, 64, device="cpu")
    small = config.ModelConfig(S=4, sliding_window_len=4, space_depth=1, time_depth=1,
                               space_depth_dyn=1, time_depth_dyn=1)
    assert MDTrackerAdapter(small, backward_tracking=True, device="cpu").backward_tracking
    dims = StaticDims.from_config(cfg, 48, 64)
    OracleTracker(np.zeros((2, 7), np.float32), np.ones(4, np.float32), dims, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OracleTracker(np.zeros((2, 7), np.float32), np.ones(4, np.float32), dims)


def test_get_mesh_needs_a_group_for_more_than_one_rank(monkeypatch):
    """Without an initialised process group only a one-rank mesh can be
    made; more ranks need torchrun and init_distributed(), which outside
    torchrun (no WORLD_SIZE) is a no-op."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not torch.distributed.is_initialized()
    init_distributed(device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        get_mesh(2, device="cpu")
    assert not torch.distributed.is_initialized()


def test_mesh_entry_points_check_the_mesh(monkeypatch):
    """A mesh on another device than the one asked for, or one that
    disagrees with slam.mesh_devices, is refused; slam.mesh_devices without
    a mesh too."""
    cfg = config.Config()
    mesh = Mesh(group=None, rank=0, size=2, device=torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="mesh"):
        MDTrackerAdapter(cfg.model, mesh=mesh)
    monkeypatch.undo()
    cfg.slam.mesh_devices = 4
    with pytest.raises(ValueError, match="mesh_devices"):
        BATrack(cfg, 48, 64, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="mesh_devices"):
        BATrack(cfg, 48, 64, device="cpu")


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
    with pytest.raises(ValueError, match="unsupported device"):
        attention.vmem_attention(*(torch.zeros((2, 8, 48), device="meta") for _ in range(3)), 0.1)
    assert attention.fused_qkv_attention.launches == 0
    assert attention.fused_qkv_attention.kv_launches == 0
    assert attention.vmem_attention.launches == 0
    assert corr_kernel.corr_sample.launches == 0


def test_kernel_options_refuse_other_devices():
    """K1's mxu and int8 variants and K4 raise on a device that is neither
    the CPU nor CUDA, and count no launch."""
    pyramid = [torch.zeros((2, 128, 8, 8), device="meta")]
    targets, coords = torch.zeros((3, 2, 128), device="meta"), torch.zeros((2, 3, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        corr_kernel.corr_sample(corr_kernel.pack_pyramid(pyramid), targets, coords, 1,
                                contract="mxu")
    with pytest.raises(ValueError, match="unsupported device"):
        corr_kernel.corr_sample(corr_kernel.pack_pyramid(pyramid, "int8"), targets, coords, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        attention.flash_attention(*(torch.zeros((2, 2, 8, 48), device="meta") for _ in range(3)),
                                  0.1)
    assert corr_kernel.corr_sample.mxu_launches == corr_kernel.corr_sample.int8_launches == 0
    assert attention.flash_attention.launches == 0


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
