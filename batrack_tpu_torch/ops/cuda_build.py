"""Build and load the hand-written CUDA kernels of this package.

Each source under batrack_tpu_torch/csrc/ has a plain C interface and is
compiled by nvcc into its own shared library for Hopper (sm_90a), then
loaded with ctypes. The build happens at first use, into build/kernels/ at
the root of the checkout (listed in .gitignore), and is reused while the
library is newer than its source. Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the GPU "
                       "machine (CUDA_HOME or /usr/local/cuda)")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return not lib.exists() or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources (csrc/<name>.cu), one nvcc process each,
    all started together. Returns each build's compiler output (register
    and shared-memory use from -Xptxas -v). Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    logs, failed = {}, []
    for name, (proc, tmp) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {status}")


def refuse_autograd(what: str, *tensors) -> None:
    """Raise when autograd would record through a kernel launch: the
    kernels have no backward, nor have their TPU kernels (the JAX package
    trains through its plain paths). None entries are skipped."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward; run it under torch.no_grad(), "
            "or take gradients through the plain version on CPU tensors")
