"""Edited copies of K2's bf16 kernel, built side by side and timed
interleaved in one process on one NVIDIA GPU.

    python scripts/torch_attention_variants.py [--dims 48,96,128]
        [--variants nosync,box_copies,...] [--source NAME=PATH ...] [--rounds 3]

Each variant is this tree's batrack_tpu_torch/csrc/fused_qkv_attention.cu
with one edit from VARIANTS below, built at the head dims the variant
names among --dims; --source adds a whole other copy of the source (for
example the parent commit's, unpacked with `git archive` into
build/archive/parent, a directory .gitignore lists), built at every one of
--dims. This tree's own source ("this") is built at every one of --dims
too. One nvcc per build, all started together, into build/kernels/variants/;
each build's ptxas lines and SASS instruction count (cuobjdump) for the
bf16 kernel are printed.

Then, through the port's wrapper (fused_qkv_attention, with its library
swapped for each build in turn), K2 on bf16 inputs made from seed 0: at the
davis_demo rows (12, 2400) with 8 heads of each d; at d 48 with 1536 tracks
(12, 1536, 1152), the evaluation configs' shape; with the keyframe path's
key mask at (12, 4800) rows, the first 2400 keys live (chip_smoke.py phase
9), at each d; and at d 48 with 80 % of 2400 keys live at random (every key
tile mixed). Each reading is CUDA events over 30 back-to-back calls; every
build is read once a round, in an order that reverses from round to round.
Each build's first output is held against the plain version (two bf16
ulps, chip_smoke.bf16_tol).

It prints one JSON line per shape and writes every reading, the ptxas
lines and the card's name and power limit to
chiprun_out/torch_attention_variants.json.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SRC = ROOT / "batrack_tpu_torch" / "csrc" / "fused_qkv_attention.cu"
OUT = ROOT / "chiprun_out" / "torch_attention_variants.json"


def _replace(s: str, pairs) -> str:
    for a, b in pairs:
        if s.count(a) != 1:
            raise SystemExit(f"edit does not apply: {a[:80]!r}")
        s = s.replace(a, b)
    return s


FIRST_SYNC = '''  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  __nv_bfloat16* ob =
      reinterpret_cast<__nv_bfloat16*>(q_wg) + (wl * 16 + g) * kHeadDim + 2 * t;
'''


def nosync(s: str) -> str:
    """Without the warpgroup barrier before the output is staged in Q's
    boxes (only to time it: another warp may still be reading Q)."""
    return _replace(s, [(FIRST_SYNC, FIRST_SYNC.split("\n", 1)[1])])


def box_copies(s: str) -> str:
    """d % 16 == 0 with 32-byte rows (d 48): Q, K and V tiles as one TMA
    copy per 16-lane box over 3-D tensor maps (the earlier layout) instead
    of one 4-D copy per tile."""
    return _replace(s, [
        ('''    } else {
      tma_load_4d(dst, map, bar, 0, row, h * kSwBoxes, b);
    }''', '''    } else {
      for (int x = 0; x < kBoxes; ++x)
        tma_load(dst + x * rows * kRowBytes, map, bar, h * kHeadDim + x * kBox, row, b);
    }'''),
        ('''          : bf16_block_map(&mq, q, C, N, B, q_stride, 64) &&
                bf16_block_map(&mk, k, C, Nk, B, kv_stride, kTileK) &&
                bf16_block_map(&mv, v, C, Nk, B, kv_stride, kTileK);''',
         '''          : bf16_map(&mq, q, C, N, B, q_stride, kBox, 64, CU_TENSOR_MAP_SWIZZLE_32B) &&
                bf16_map(&mk, k, C, Nk, B, kv_stride, kBox, kTileK, CU_TENSOR_MAP_SWIZZLE_32B) &&
                bf16_map(&mv, v, C, Nk, B, kv_stride, kBox, kTileK, CU_TENSOR_MAP_SWIZZLE_32B);'''),
    ])


def o_apart(s: str) -> str:
    """The output staged in a region of its own past the ring (1 KB past
    its end, clear of the barriers and of a plan under 900 bytes; the
    earlier layout), with no barrier before it; shared memory grows by
    1 KB and Q's size."""
    return _replace(s, [
        (FIRST_SYNC, '''  uint8_t* const o_wg = ring + Stages * kStageBytes + 1024 + wg * 64 * kHeadDim * 2;
  __nv_bfloat16* ob =
      reinterpret_cast<__nv_bfloat16*>(o_wg) + (wl * 16 + g) * kHeadDim + 2 * t;
'''),
        ("    tma_store(&map_o, q_wg, h * kHeadDim, q0 + wg * 64, b);",
         "    tma_store(&map_o, o_wg, h * kHeadDim, q0 + wg * 64, b);"),
        ("    return 1024 + kQBytes + stages * kStageBytes + kTailBytes + plan;",
         "    return 2048 + 2 * kQBytes + stages * kStageBytes + kTailBytes + plan;"),
    ])


def parent_seq(s: str) -> str:
    """box_copies and o_apart together."""
    return o_apart(box_copies(s))


def parent_full(s: str) -> str:
    """parent_seq, with Q as one box of 128 rows per 16 lanes for both
    warpgroups (the earlier layout; d 48 only, as box_copies)."""
    return _replace(parent_seq(s), [
        ("    for (int w = 0; w < kWarpgroups; ++w)\n"
         "      load(base + w * 64 * kDPad * 2, &map_q, &tl.q_full, q0 + 64 * w, 64);",
         "    load(base, &map_q, &tl.q_full, q0, kTileQ);"),
        ("  const uint32_t q_addr = smem_u32(q_wg), ring_addr = smem_u32(ring);",
         "  const uint32_t q_addr = smem_u32(base) + wg * 64 * kSwBytes, "
         "ring_addr = smem_u32(ring);"),
        ("        s, sw_desc(q_addr + (x / kSwSteps) * 64 * kSwBytes + step, 16, 8 * kSwBytes),",
         "        s, sw_desc(q_addr + (x / kSwSteps) * kTileQ * kSwBytes + step, 16, "
         "8 * kSwBytes),"),
        ("          : bf16_map(&mq, q, C, N, B, q_stride, kBox, 64, CU_TENSOR_MAP_SWIZZLE_32B) &&",
         "          : bf16_map(&mq, q, C, N, B, q_stride, kBox, kTileQ, "
         "CU_TENSOR_MAP_SWIZZLE_32B) &&"),
    ])


def kv_apart(s: str) -> str:
    """The ring's K tiles, then its V tiles, each stage's apart (the
    earlier layout), instead of each stage's K and V side by side."""
    return _replace(s, [
        ("    load(stage, &map_k, &tl.full[st], row, kTileK);\n"
         "    load(stage + kKVTile, &map_v, &tl.full[st], row, kTileK);",
         "    load(ring + st * kKVTile, &map_k, &tl.full[st], row, kTileK);\n"
         "    load(ring + (Stages + st) * kKVTile, &map_v, &tl.full[st], row, kTileK);"),
        ("    issue_qk(s, q_addr, ring_addr + sn * kStageBytes);",
         "    issue_qk(s, q_addr, ring_addr + sn * kKVTile);"),
        ("    issue_pv(o, p, ring_addr + st * kStageBytes + kKVTile);",
         "    issue_pv(o, p, ring_addr + (Stages + st) * kKVTile);"),
        ("  issue_pv(o, p, ring_addr + ((n_walk - 1) % Stages) * kStageBytes + kKVTile);",
         "  issue_pv(o, p, ring_addr + (Stages + (n_walk - 1) % Stages) * kKVTile);"),
    ])


def init0(s: str) -> str:
    """Thread 0 initialises the barriers and the issuing thread loads Q
    after __syncthreads (the earlier prologue), instead of the issuing
    thread doing both before it."""
    return _replace(s, [
        ("  if (threadIdx.x == kIssuer<Masked>) {\n"
         "    for (int st = 0; st < Stages; ++st) {",
         "  if (threadIdx.x == 0) {\n"
         "    for (int st = 0; st < Stages; ++st) {"),
        ("    asm volatile(\"fence.mbarrier_init.release.cluster;\" ::: \"memory\");\n"
         "    mbar_arrive_expect_tx(&tl.q_full, kQBytes);\n"
         "    for (int w = 0; w < kWarpgroups; ++w)\n"
         "      load(base + w * 64 * kDPad * 2, &map_q, &tl.q_full, q0 + 64 * w, 64);\n"
         "  }\n"
         "  __syncthreads();\n",
         "    asm volatile(\"fence.mbarrier_init.release.cluster;\" ::: \"memory\");\n"
         "  }\n"
         "  __syncthreads();\n"
         "  if (threadIdx.x == kIssuer<Masked>) {\n"
         "    mbar_arrive_expect_tx(&tl.q_full, kQBytes);\n"
         "    for (int w = 0; w < kWarpgroups; ++w)\n"
         "      load(base + w * 64 * kDPad * 2, &map_q, &tl.q_full, q0 + 64 * w, 64);\n"
         "  }\n"),
    ])


def fast_ok(s: str) -> str:
    """The fast softmax's scale test hoisted out of the loop into one bool
    (the earlier form)."""
    q = "  uint8_t* const q_wg = base + wg * 64 * kDPad * 2;"
    s = _replace(s, [(q, "  const bool fast_ok = c > 0.f;\n" + q)])
    a = "(e & kFullTile) && c > 0.f"
    if s.count(a) != 2:
        raise SystemExit("edit does not apply: fast_ok")
    return s.replace(a, "fast_ok && (e & kFullTile)")


def parent_general(s: str) -> str:
    """The general softmax's key biases read as the earlier kernel read
    them, the (Nk,) mask's bytes from device memory behind a test of the
    mask pointer (null without a mask), in both instantiations."""
    a = "tile_keys<Masked>(tl, live, e, Nk, t)"
    if s.count(a) != 2:
        raise SystemExit("edit does not apply: parent_general")
    return s.replace(a, "MaskBytes{key_mask, static_cast<int>(e & ~kFullTile) * kTileK, "
                        "Nk - static_cast<int>(e & ~kFullTile) * kTileK, t}")


def parent_all(s: str) -> str:
    """parent_full and parent_general together."""
    return parent_general(parent_full(s))


def stages_arg(s: str) -> str:
    """The ring's stage count as a kernel argument (two instantiations,
    unmasked and masked, instead of three): kStages without a key mask,
    else as the launch chose (two where the plan does not fit beside
    kStages), with each walk position's stage and parity a division by it."""
    s = _replace(s, [
        ("template <int Stages, bool Masked>\n__global__", "template <bool Masked>\n__global__"),
        ("                                const uint8_t* __restrict__ key_mask, int N, int Nk,\n"
         "                                float scale) {\n"
         "  extern __shared__ uint8_t smem_raw[];\n"
         "  uint8_t* const base",
         "                                const uint8_t* __restrict__ key_mask, int N, int Nk,\n"
         "                                float scale, int ring_stages) {\n"
         "  extern __shared__ uint8_t smem_raw[];\n"
         "  uint8_t* const base"),
        ("  uint8_t* const ring = base + kQBytes;\n",
         "  uint8_t* const ring = base + kQBytes;\n"
         "  const int Stages = Masked ? ring_stages : kStages;\n"),
        ("  const auto kernel = key_mask == nullptr ? attention_bf16_wgmma_kernel<kStages, false>\n"
         "                      : full_ring         ? attention_bf16_wgmma_kernel<kStages, true>\n"
         "                                          : attention_bf16_wgmma_kernel<2, true>;",
         "  const auto kernel = key_mask == nullptr ? attention_bf16_wgmma_kernel<false>\n"
         "                                          : attention_bf16_wgmma_kernel<true>;"),
        ("      mq, mk, mv, mo, key_mask, N, Nk, scale);\n  return cudaGetLastError();\n}\n\n"
         "// float32 rows",
         "      mq, mk, mv, mo, key_mask, N, Nk, scale, full_ring ? kStages : 2);\n"
         "  return cudaGetLastError();\n}\n\n// float32 rows"),
    ])
    return s


def stages_arg_select(s: str) -> str:
    """stages_arg, with each division by the stage count a choice between
    two divisions by a constant, kStages and 2."""
    s = stages_arg(s)
    a = s.index("template <bool Masked>\n__global__")
    b = s.index("// ------------------------------------------------------------- float32")
    body = re.sub(r"(\(n_walk - 1\)|\(j \+ 1\)|\bp|\bj) ([%/]) Stages\b",
                  r"(Stages == kStages ? \1 \2 kStages : \1 \2 2)", s[a:b])
    return s[:a] + body + s[b:]


def sass_counts(lib: Path) -> dict:
    """SASS instructions of each bf16 attention kernel in `lib`
    (cuobjdump): "unmasked" and "masked" for the template's two
    instantiations, else by the end of the mangled name."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts = {}
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split()[0]
        if "attention_bf16_wgmma_kernel" in name:
            masked = re.search(r"attention_bf16_wgmma_kernelI.*?L?b([01])E", name)
            key = {"0": "unmasked", "1": "masked"}[masked.group(1)] if masked else name[-24:]
            counts[key] = len(re.findall(r"/\*[0-9a-f]{4}\*/", fn))
    return counts


def mask48prod(s: str) -> str:
    """A producer warp in the masked instantiation up to d 48 (else d 40)."""
    return _replace(s, [("constexpr bool kProducer = kHeadDim <= (Masked ? 40 : 64);",
                         "constexpr bool kProducer = kHeadDim <= (Masked ? 48 : 64);")])


def wgprod(s: str) -> str:
    """A producer warpgroup at every width, which hands its registers to
    the consumers with setmaxnreg (24 for the producer, 240 for each
    consumer)."""
    return _replace(s, [
        ("constexpr bool kProducer = kHeadDim <= (Masked ? 40 : 64);",
         "constexpr bool kProducer = true;"),
        ("constexpr int kThreads = kConsumers + (kProducer<Masked> ? 32 : 0);",
         "constexpr int kThreads = kConsumers + 128;"),
        ('''  if (kProducer<Masked> && warp == kConsumers / 32) {
    if (lane == 0)''', '''  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (warp == kConsumers / 32 && lane == 0)'''),
        ('''    return;
  }
  if (!kProducer<Masked> && threadIdx.x == kIssuer<Masked>)''', '''    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  if (!kProducer<Masked> && threadIdx.x == kIssuer<Masked>)'''),
    ])


# name: (edit, the head dims it is built at among --dims; None: all)
VARIANTS = {
    "nosync": (nosync, (48,)),
    "box_copies": (box_copies, (48,)),
    "o_apart": (o_apart, (48,)),
    "parent_seq": (parent_seq, (48,)),
    "parent_full": (parent_full, (48,)),
    "kv_apart": (kv_apart, (48,)),
    "init0": (init0, (48,)),
    "fast_ok": (fast_ok, (48,)),
    "parent_general": (parent_general, (48,)),
    "parent_all": (parent_all, (48,)),
    "mask48prod": (mask48prod, (48,)),
    "stages_arg": (stages_arg, None),
    "stages_arg_select": (stages_arg_select, None),
    "wgprod": (wgprod, None),
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dims", default="48", help="head dims, comma separated")
    parser.add_argument("--variants", default="", help=f"comma separated, of {list(VARIANTS)}")
    parser.add_argument("--source", action="append", default=[], metavar="NAME=PATH",
                        help="another copy of fused_qkv_attention.cu, built at every dim")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_attention_variants: no CUDA device", file=sys.stderr)
        return 1
    import ctypes

    import chip_smoke as cs
    from batrack_tpu_torch.ops import attention, cuda_build

    dims = [int(d) for d in args.dims.split(",")]
    text = SRC.read_text()
    sources = {"this": (text, dims)}
    for item in args.source:
        name, path = item.split("=", 1)
        sources[name] = (Path(path).read_text(), dims)
    for name in filter(None, args.variants.split(",")):
        edit, at = VARIANTS[name]
        sources[name] = (edit(text), [d for d in dims if at is None or d in at])

    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, at) in sources.items():
        path = out_dir / f"{name}.cu"
        path.write_text(src)
        for d in at:
            lib = out_dir / f"lib_{name}_d{d}.so"
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-DBT_HEAD_DIM={d}", "-o",
                   str(lib), str(path)]
            procs[(name, d)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)
    logs = {}
    for (name, d), proc in procs.items():
        logs[f"{name}_d{d}"] = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name} at d {d}:\n{logs[f'{name}_d{d}'][-3000:]}")
    ptxas = {build: [f"{fn[-14:]}: {ln[:160]}" for fn, ln in lines
                     if "attention_bf16_wgmma_kernel" in fn]
             for build, lines in cuda_build.ptxas_lines(logs).items()}
    for build, lines in ptxas.items():
        for ln in lines:
            print(f"ptxas {build} {ln}", flush=True)
    libs = {key: ctypes.CDLL(str(out_dir / f"lib_{key[0]}_d{key[1]}.so")) for key in procs}
    sass = {f"{name}_d{d}": sass_counts(out_dir / f"lib_{name}_d{d}.so") for name, d in procs}
    print(json.dumps({"sass_instructions": sass}), flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    real_load = cuda_build.load
    readings = {}

    def timed(tag, d, qkv, mask):
        names = [n for n, (_, at) in sources.items() if d in at]
        scale = d ** -0.5
        ref = attention.fused_qkv_attention_plain(qkv, cs.HEADS, scale, mask)
        res = {n: {"ms": []} for n in names}
        try:
            for rnd in range(args.rounds):
                for n in names if rnd % 2 == 0 else names[::-1]:
                    cuda_build.load = lambda *a, lib=libs[(n, d)], **w: lib
                    if rnd == 0:
                        out = attention.fused_qkv_attention(qkv, cs.HEADS, scale, mask)
                        res[n]["err_and_tol"] = [cs.max_err(out, ref), cs.bf16_tol(ref)]
                    res[n]["ms"].append(cs.cuda_ms(
                        lambda: attention.fused_qkv_attention(qkv, cs.HEADS, scale, mask),
                        reps=30))
        finally:
            cuda_build.load = real_load
        readings[tag] = res
        print(json.dumps({tag: res}), flush=True)

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    prefix = torch.arange(2 * cs.NQ, device=dev) < cs.NQ
    for d in dims:
        timed(f"d{d}", d, bf16(cs.S, cs.NQ, 3 * cs.HEADS * d), None)
        if d == 48:
            timed("d48_1536", d, bf16(cs.S, 1536, 3 * cs.HIDDEN), None)
        timed(f"d{d}_masked_prefix_4800", d, bf16(cs.S, 2 * cs.NQ, 3 * cs.HEADS * d), prefix)
        if d == 48:
            rand = torch.rand((cs.NQ,), generator=gen, device=dev) > 0.2
            timed("d48_masked_random_2400", d, bf16(cs.S, cs.NQ, 3 * cs.HIDDEN), rand)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps({"card": smi, "ptxas": ptxas, "sass_instructions": sass,
                               "readings": readings,
                               "sources": {n: at for n, (_, at) in sources.items()}}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
