"""Build and load the hand-written CUDA kernels of this package.

Each source under batrack_tpu_torch/csrc/ has a plain C interface and is
compiled by nvcc into its own shared library for Hopper (sm_90a), then
loaded with ctypes. The build happens at first use, into build/kernels/ at
the root of the checkout (listed in .gitignore), and is reused while the
library is newer than its source. Nothing here runs when the module is
imported.

A source's widths are compile-time constants (`WIDTHS`): the attention
kernel's head dim, the correlation kernel's radius and channel count. With
no width given, or with a source's default widths, a source is built as it
stands into build/kernels/lib<name>.so. Any other width is its own library,
compiled once with the widths as -D flags into
build/kernels/lib<name>_<tag>.so, e.g. `load("fused_qkv_attention",
HEAD_DIM=64)` into libfused_qkv_attention_d64.so and `load("corr_sample",
RADIUS=4, C=128)` into libcorr_sample_r4_c128.so.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Tuple, Union

import torch

from batrack_tpu_torch.utils.profiling import tracer

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# per source, each width: (keyword, macro read by the source, its default,
# prefix in the library's tag)
WIDTHS = {
    "fused_qkv_attention": (("HEAD_DIM", "BT_HEAD_DIM", 48, "d"),),
    "corr_sample": (("RADIUS", "BT_CORR_RADIUS", 3, "r"), ("C", "BT_CORR_C", 128, "c")),
}

# a build: the source's name and its widths, (keyword, value) pairs in
# WIDTHS order, empty for the default build
Spec = Tuple[str, Tuple[Tuple[str, int], ...]]

_loaded: Dict[Spec, ctypes.CDLL] = {}


def spec(name: str, **widths: int) -> Spec:
    """The build of csrc/<name>.cu at the given widths. Widths left out take
    their defaults; a build whose widths are all the defaults is the
    default build (no -D flags, lib<name>.so)."""
    table = WIDTHS.get(name, ())
    known = {key for key, _, _, _ in table}
    if set(widths) - known:
        raise ValueError(f"{name}: unknown widths {sorted(set(widths) - known)} "
                         f"(it takes {sorted(known) or 'none'})")
    values = tuple((key, int(widths.get(key, default))) for key, _, default, _ in table)
    if all(v == default for (_, v), (_, _, default, _) in zip(values, table)):
        return name, ()
    return name, values


def _as_spec(item: Union[str, Spec]) -> Spec:
    return spec(item) if isinstance(item, str) else spec(item[0], **dict(item[1]))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the GPU "
                       "machine (CUDA_HOME or /usr/local/cuda)")


def lib_path(s: Spec) -> Path:
    """build/kernels/lib<name>.so, or lib<name>_<tag>.so for other widths."""
    name, values = s
    prefixes = {key: prefix for key, _, _, prefix in WIDTHS.get(name, ())}
    tag = "_".join(f"{prefixes[key]}{v}" for key, v in values)
    return BUILD_DIR / f"lib{name}{'_' + tag if tag else ''}.so"


def command(s: Spec, out: Path) -> List[str]:
    """The nvcc command that builds `s` into `out`."""
    name, values = s
    macros = {key: macro for key, macro, _, _ in WIDTHS.get(name, ())}
    defines = [f"-D{macros[key]}={v}" for key, v in values]
    return [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(out), str(CSRC / f"{name}.cu")]


def _stale(s: Spec) -> bool:
    lib = lib_path(s)
    return not lib.exists() or lib.stat().st_mtime < (CSRC / f"{s[0]}.cu").stat().st_mtime


def _label(s: Spec) -> str:
    return lib_path(s).name[3:-3]


def build(items: Iterable[Union[str, Spec]]) -> Dict[str, str]:
    """Compile the named sources (csrc/<name>.cu), each a name (the default
    build) or a `spec(...)`, one nvcc process each, all started together.
    Returns each build's compiler output (register and shared-memory use
    from -Xptxas -v), keyed by its library's name without lib and .so
    (e.g. "fused_qkv_attention_d64"). Raises if any build fails."""
    with tracer().span("setup.kernels"):
        return _build(items)


def _build(items: Iterable[Union[str, Spec]]) -> Dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for s in dict.fromkeys(_as_spec(i) for i in items):
        if not _stale(s):
            continue
        tmp = lib_path(s).with_suffix(f".so.tmp{os.getpid()}")
        procs[s] = (subprocess.Popen(command(s, tmp), stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    tracer().count("cuda_build.builds", len(procs))
    logs, failed = {}, []
    for s, (proc, tmp) in procs.items():
        logs[_label(s)] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(_label(s))
        else:
            os.replace(tmp, lib_path(s))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


# the attention source's two kernels, whose builds must neither spill nor
# serialise their wgmma (ptxas_faults)
ATTENTION_KERNELS = ("attention_bf16_wgmma_kernel", "attention_f32_wgmma_kernel")


def ptxas_lines(logs: Dict[str, str]) -> Dict[str, List[Tuple[str, str]]]:
    """From build()'s logs (ptxas -v), for each build: its register
    ("Used ..."), spill and C75xx lines, each as (the mangled name of the
    function the line is about, the line without ptxas's prefix). A C75xx
    line names its function; the others follow "Function properties for"."""
    out: Dict[str, List[Tuple[str, str]]] = {}
    for name, text in logs.items():
        fn = "?"
        for ln in text.splitlines():
            if "Function properties for" in ln:
                fn = ln.split("Function properties for ", 1)[1].strip()
            elif "spill" in ln or "Used " in ln or "C75" in ln:
                about = ln.split("function '", 1)[1].split("'")[0] if "function '" in ln else fn
                out.setdefault(name, []).append(
                    (about, ln.replace("ptxas info    :", "").strip()))
    return out


def ptxas_faults(logs: Dict[str, str], kernels: Iterable[str]) -> Dict[str, List[str]]:
    """For each build, the ptxas_lines where one of `kernels` (a part of
    its mangled name) spills, with nonzero spill bytes, or draws a C75xx
    advisory (ptxas serialised or fenced its wgmma). Builds without such a
    line are left out."""
    kernels = tuple(kernels)
    faults: Dict[str, List[str]] = {}
    for name, lines in ptxas_lines(logs).items():
        for fn, ln in lines:
            spills = "spill" in ln and (
                " 0 bytes spill stores" not in ln or " 0 bytes spill loads" not in ln)
            if (spills or "C75" in ln) and any(k in fn for k in kernels):
                faults.setdefault(name, []).append(ln[:160])
    return faults


def load(name: str, **widths: int) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu at the given widths, built
    first if needed."""
    s = spec(name, **widths)
    lib = _loaded.get(s)
    if lib is None:
        tr = tracer()
        with tr.span("setup.kernels"):
            _build([s])
            lib = ctypes.CDLL(str(lib_path(s)))
        tr.count("cuda_build.loads")
        _loaded[s] = lib
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
