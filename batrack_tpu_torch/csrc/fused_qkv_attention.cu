// K2 and K3: softmax attention for Hopper, read straight from strided q, k
// and v rows, at one head dim d per build.
//
// Replaces the TPU kernels batrack_tpu/ops/pallas_attention.py::
// _fused_qkv_kernel (K2, entry point fused_qkv_attention) and ::_attn_kernel
// (K3, entry point vmem_attention). One kernel serves every call site, since
// they differ only in where the rows of q, k and v start:
//   K2 packed   q | k | v of the (B, N, 3C) qkv projection, row stride 3C;
//   K2 kv=      queries from qkv as above, keys and values from a separate
//               (B, Nk, 2C) slim or (B, Nk, 3C) packed source (row stride
//               2C or 3C, keys at lane 0 or C, values C lanes after them)
//               with its own key count Nk and key mask (Nk,): the
//               track-sharded space attention, local queries against the
//               keys and values gathered from every rank;
//   K3          one head (C = d) of separate (B, N, d) q, k and v arrays.
// The output (B, N, C) has the heads merged. Heads are split and merged by
// addressing inside the kernel, so no (B, h, N, hd) copy is ever made in
// device memory. Keys where the optional key mask is 0 get the logit -1e30,
// as on the TPU; logits, softmax and the output sums are float32, in bf16
// and in float32 alike.
//
// The head dim d is a compile-time constant, BT_HEAD_DIM (default 48, the
// tracker's: hidden 384 over 8 heads). ops/cuda_build.py builds one library
// per d that a caller asks for (ModelConfig's hidden_size / num_heads): any
// multiple of 8 from 8 to 128. Every size below follows d: the 16-lane
// k-steps of QK^T, ceil(d / 16); the PV product, m64n{16 ceil(d / 16)}k16;
// the output accumulators and the output box (d lanes); the tiles' swizzle;
// the K/V ring's stage size and stage count; whether the block has a
// producer warp.
//
// Bound on the H100 at the davis_demo shape (12, 2400, 1152) bf16: 106 GFLOP
// of QK^T and PV (0.107 ms at the bf16 tensor-core peak) and 553 M
// exponentials (0.132 ms on the special-function units, 16 per clock per
// SM at the highest SM clock, 1.98 GHz), against 88 MB of input and output:
// bound by the exponentials, so the softmax has to run beside the products,
// not after them. K3 at (96, 2400, 48) does the same work. At d 128 the
// products bound it (0.286 ms).
//
// bf16 (the production path), laid out for Hopper: one block per (128-query
// tile, head, batch row) with two consumer warpgroups of 64 queries. Q is
// loaded once, each warpgroup's 64 rows apart; 128-key tiles of K and V
// stream through a shared-memory ring with TMA (cp.async.bulk.tensor; rows
// past N or Nk arrive as zeros and never cross into the next batch row),
// full/empty mbarriers per stage. A tile is a row of boxes as wide as the
// widest swizzle whose lanes divide d: 64 lanes (128 bytes) at d 64 and
// 128, 32 lanes (64 bytes) at d 32 and 96, else 16 (32 bytes; d 48's 96-byte
// head allows no more). TMA's time goes with the rows it copies more than
// with their bytes: a copy of this kernel whose loop only streams K and V
// took 0.61 ms at (12, 2400, 1152) with d 128 in 32-byte rows and 0.22 ms
// in 128-byte rows (NVIDIA H100 80GB HBM3, 700 W; scripts/
// torch_attention_ab.py on edited copies, PERF.md). One copy brings a
// whole Q, K or V tile: the tensor maps are 4-D, (box lanes, row, box,
// batch), with a head's boxes one after another on their own axis. Where
// d is not a multiple of
// 16 (8, 24, 40, ...) the last 16-lane box of a head would read 8 lanes of
// the next head, so q, k and v are then read a box at a time through maps
// with the head as its own axis (lanes-in-head of extent d, head, row,
// batch), whose out-of-bounds fill gives zeros past lane d: they add
// nothing to QK^T, and PV's columns past d are never stored. QK^T is wgmma
// m64n128k16 with Q and K from shared memory (K-major: a k-step is 32
// bytes of a box row); PV is wgmma m64n{16 ceil(d / 16)}k16 with P from
// registers (the QK^T accumulators repacked to bf16) and V from shared
// memory with the transpose bit (MN-major), so V is never transposed by
// hand. Each warpgroup issues tile j+1's QK^T and tile j's PV together and
// runs tile j+1's softmax while PV runs; the two warpgroups take turns at
// their exponentials (named barriers), which measured faster than letting
// them contend. The exponentials are ex2.approx.ftz with scale * log2(e)
// folded into one FMA on a tile whose 128 keys are all live. Each
// warpgroup stages its output in its own Q boxes, dead after its last
// QK^T, and writes it with one TMA store. At d 48, 2.5x its bound, what
// still limits it is open (PERF.md): clock64 phase timings of a
// development copy showed each warpgroup spending longer in its
// exponentials than the units' rate allows and waiting on the issue of its
// products.
//
// Per width: a consumer thread holds the tile's 64 logits, 32 registers of
// P and d / 2 output accumulators. Without a key mask up to d 64, with one
// (the plan's walk and bits) up to d 40, they fit in the 168 registers a
// thread of a nine-warp block may hold, so warp 8 is a producer that
// issues every copy. Beyond, they do not (ptxas spilled, and from d 88
// serialised the wgmma, C7512), so the block is the eight consumer warps,
// which may hold 255. Then warpgroup 1's first thread (thread 128) issues Q and
// the first tiles before its loop, and each later tile as soon as its
// stage is free: warpgroup 1 takes its turn at the exponentials second, so
// it frees each stage last and seldom waits for the other warpgroup. The
// ring has four stages to d 96, three from d 104. The stage count and
// whether a key mask is passed are template arguments: three
// instantiations, unmasked, masked, and masked on a two-stage ring. (The
// stage count as a kernel argument made the masked route 4-23 % slower on
// an NVIDIA H100 80GB HBM3 at 700 W, as a division or as a choice of two:
// scripts/torch_attention_variants.py, PERF.md.)
//
// Key mask: each block first reads the (Nk,) mask, 32 bytes a thread, into
// a plan in shared memory: the mask as bits, 128 a tile, laid out so that
// a thread reads its 32 keys of a tile as one word, and the walk, the
// tiles that hold a live key in order, each marked full when all 128 of
// its keys are live. The copies and the consumers follow the same walk: a
// position's stage and parity follow the position, not the tile. A dead
// tile is neither loaded nor computed, which is exact: for a row with any
// live key a masked key's weight 2^(-1e30 - m) is 0 in float32. A full tile
// takes the fast softmax; any other (a ragged last tile among them) the
// general one, with its bits from shared memory. With no live key anywhere
// every tile is walked, none full, so each query averages all Nk values;
// keys past Nk stay -inf. The plan takes 20 bytes a tile beside the ring;
// where it would not fit, the launch takes two stages (beyond about 12,500
// keys at d 120-128, 65,000 at d 88-96).
//
// float32 (parity runs, compute_dtype "float32"): the same pipeline on
// three-term bf16 products. On this card a float32-accurate product costs
// the same on either tensor-core route, 3 TF32 products at 495 TFLOP/s or
// the 6 bf16 products of term order <= 2 at 989, about 2.5x less than the
// float32 pipes (67 TFLOP/s): at the davis_demo shape 637 GFLOP of bf16
// products, 0.644 ms, beside 0.132 ms of exponentials and 0.053 ms of
// float32 rows, so the products bound it. (TF32 wgmma takes only K-major
// operands, so V would need a transpose by hand; bf16 has the transpose
// bit and K2 already repacks P.) Two launches:
//   split_terms_kernel, which replaces no TPU kernel (the TPU kernel reads
//   float32 rows straight into its matrix unit): each float32 row of q, k
//   and v, read in place through its base pointer and row stride, becomes
//   three bf16 terms t1 = bf16(x), t2 = bf16(x - t1), t3 = bf16(x - t1 -
//   t2), rounded to nearest even as csrc/corr_sample.cu splits K1's target,
//   in a (3, rows, lanes) tensor: 4 bytes read and 6 written per element,
//   bound by the bytes;
//   attention_f32_wgmma_kernel, the bf16 kernel's structure on the terms:
//   the term is an outer batch axis of the same tensor maps (3B batch
//   rows), Q's three terms stay in shared memory and each ring stage holds
//   the three term boxes of K and of V. QK^T sums the six wgmma products of
//   the term pairs (i, j) with i + j <= 2 into one float32 accumulator,
//   smallest first, so that no large partial sum swallows a small product;
//   after the online softmax the float32 probabilities are split into three
//   bf16 terms in registers (the bf16 kernel's repack of P, three times)
//   and PV runs the six products of P's and V's terms, V through the
//   transpose bit. Each key tile's PV goes into a fresh accumulator that is
//   added to the running output once per tile, so that the tensor cores'
//   own accumulation (which may round toward zero) only ever works on one
//   tile's sums. Three terms are within float32 rounding of the float32
//   result; two leave about 2^-16 of the probabilities and fail
//   tests/test_torch_kernels.py's comparison with float64 on peaked inputs.
// The float32 kernel needs more registers a thread than the bf16 one: the
// tile's logits, three P terms and two output accumulators, 168 values at
// d 128. As in the bf16 kernel a nine-warp block caps a thread at 168
// registers (ptxas keeps that budget whatever setmaxnreg asks), so from
// d 56 it has no producer warp and thread 0 issues the copies between its
// own tiles. Tiles are 64 keys (32 from d 104, where three terms of 64-key
// K and V tiles beside Q's terms no longer fit twice in shared memory),
// with as many stages as fit, up to four. It reads a key mask per key from
// device memory and walks every tile. Its output is written from
// registers (float2 per thread, whole 32-byte sectors), with no staging.

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

#ifndef BT_HEAD_DIM
#define BT_HEAD_DIM 48  // the tracker's: hidden 384 over 8 heads
#endif

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kHeadDim = BT_HEAD_DIM;
static_assert(kHeadDim >= 8 && kHeadDim <= 128 && kHeadDim % 8 == 0,
              "head dim: a multiple of 8 from 8 to 128");


// ------------------------------------------------------------- bf16, Hopper
constexpr int kWarpgroups = 2;                 // consumer warpgroups of 64 queries
constexpr int kTileQ = 64 * kWarpgroups;       // queries per block
constexpr int kTileK = 128;                    // keys per tile
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kBox = 16;                       // lanes per TMA box: one wgmma k-step
constexpr int kBoxes = (kHeadDim + kBox - 1) / kBox;  // 3 at d 48
constexpr int kDPad = kBoxes * kBox;           // PV's width: d rounded up to 16
constexpr bool kSplitHeads = kHeadDim % kBox != 0;  // 4-D tensor maps (header note)
constexpr int kRowBytes = kBox * 2;            // 32: a box row, one 32-byte swizzle row
constexpr int kAcc = kTileK / 2;               // QK^T accumulators per thread
constexpr int kOut = kDPad / 2;                // PV accumulators per thread
// A producer warp where an instantiation's consumers fit in the 168
// registers a thread of nine warps may hold, by ptxas's counts: without a
// key mask to d 64, with one to d 40 (header note); else the block is the
// eight consumer warps, which may hold 255.
template <bool Masked>
constexpr bool kProducer = kHeadDim <= (Masked ? 40 : 64);
template <bool Masked>
constexpr int kThreads = kConsumers + (kProducer<Masked> ? 32 : 0);
// the thread that issues every copy: the producer warp's lane 0, or
// warpgroup 1's first thread (warpgroup 1 takes its turns second, so it
// frees each stage last)
template <bool Masked>
constexpr int kIssuer = kProducer<Masked> ? kConsumers : 128;
// Shared memory, from a 1024-byte aligned base: Q (each warpgroup's 64 rows
// as kSwBoxes boxes; its output is staged there once its last QK^T is
// done), the K/V ring of Stages stages (a template argument: four where
// they fit, two where a key mask's plan would not fit beside them), then
// the barriers and, with a key mask, the plan. Every box has rows of one
// swizzle span (the layout TMA writes and wgmma reads).
constexpr int kSmemMax = 232448;
// The tiles' swizzle: the widest of 128, 64 and 32 bytes whose box of
// kSwLanes lanes divides d, so that TMA copies rows of that many bytes
// (header note); 32 bytes at d 48.
constexpr int kSwLanes = kHeadDim % 64 == 0 ? 64 : (kHeadDim % 32 == 0 ? 32 : kBox);
constexpr int kSwBytes = 2 * kSwLanes;         // a box row, one swizzle span
constexpr int kSwBoxes = kDPad / kSwLanes;     // boxes of a tile
constexpr int kSwSteps = kSwLanes / kBox;      // k-steps of QK^T in a box
constexpr uint64_t kSwLayout = kSwBytes == 128 ? 1 : (kSwBytes == 64 ? 2 : 3);  // wgmma's code
constexpr int kQBytes = kWarpgroups * 64 * kDPad * 2;
constexpr int kKVTile = kTileK * kDPad * 2;    // a K or V tile
constexpr int kStageBytes = 2 * kKVTile;
constexpr int kMaxStages = 4;
struct Bf16Tail {
  uint64_t full[kMaxStages], empty[kMaxStages], q_full;
  int n_walk;  // key tiles on the walk
  float fill;  // the logit of a key the plan marks (PlanBits)
};
constexpr int kTailBytes = (static_cast<int>(sizeof(Bf16Tail)) + 15) / 16 * 16;
constexpr int kPlanBytesPerTile = 16 + 4;      // 128 live bits and one walk entry
constexpr int kFitStages = (kSmemMax - 1024 - kQBytes - kTailBytes) / kStageBytes;
constexpr int kStages = kFitStages < kMaxStages ? kFitStages : kMaxStages;
static_assert(kStages >= 2, "the K/V ring needs two stages");
constexpr uint32_t kFullTile = 1u << 31;       // walk entry: tile index | kFullTile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of the given parity has completed. A phase
// that never completes (a lost arrival) traps after about two seconds
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
}

// One box of a (batch, row, lane) tensor map into shared memory, completing
// on `bar`. Rows past the tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int lane, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(lane), "r"(row), "r"(batch)
      : "memory");
}

// The same over a 4-D tensor map, at coordinates c0 (innermost) to c3: a
// (batch, row, head, lane-in-head) map, whose lanes past the head's d
// arrive as zeros too, or a (batch, 16-lane block, row, lane) map.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// One box from shared memory to a tensor map; rows past the tensor's end
// are not written. Returns once the box has been read out of shared memory.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int lane,
                                          int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(lane), "r"(row), "r"(batch)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// wgmma shared-memory descriptor of a 32-byte-swizzled operand (layout type
// 3): start address, leading and stride byte offsets, all in 16-byte units.
// K-major (Q, K): 8-row groups 256 bytes apart, the leading offset unused.
// MN-major (V): 8-key groups 256 bytes apart, 16-lane blocks `lbo` apart.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (3ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma operands across
// the asynchronous issue and wait.
template <int R>
__device__ __forceinline__ void reg_fence(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
    asm volatile("" : "+r"(r[i][0]), "+r"(r[i][1]), "+r"(r[i][2]), "+r"(r[i][3])::"memory");
}
template <int T, int R>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[T][R][4]) {
#pragma unroll
  for (int i = 0; i < T; ++i) reg_fence(r[i]);
}

// The two consumer warpgroups take turns at their exponentials (named
// barriers 3 and 4, 256 threads: one warpgroup syncs, the other arrives), so
// that the special-function units serve one warpgroup at a time while the
// other waits for its products.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(3 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(4 - wg) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128) = a (64 x 16) b^T, both K-major in shared memory; accumulate
// into d when `accumulate` is nonzero, else overwrite it
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x N) += a (64 x 16, bf16 pairs in registers, the mma.m16n8k16 A
// fragment per warp) b (16 x N, MN-major in shared memory: transpose bit
// set), for N = kDPad: N / 2 accumulators a thread, the operand lists
// spelled out per N by the table in the body. With `accumulate` 0 the
// product overwrites d.
#define BT_F8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define BT_ACC8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define BT_ACC16 BT_ACC8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define BT_ACC24 BT_ACC16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define BT_ACC32 BT_ACC24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define BT_ACC40 BT_ACC32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define BT_ACC48 BT_ACC40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define BT_ACC56 BT_ACC48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define BT_ACC64 BT_ACC56 ", %56, %57, %58, %59, %60, %61, %62, %63"
// N, its accumulator list, the operand numbers of a, desc_b and the scale
// predicate's source that follow it, then the accumulators' constraints
#define BT_WGMMA_PV(NN, ACC, A0, A1, A2, A3, B, P, ...)                                   \
  if constexpr (N == NN)                                                                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                         \
                 "wgmma.mma_async.sync.aligned.m64n" #NN "k16.f32.bf16.bf16 {" ACC "}, " \
                 "{%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B ", p, 1, 1, 1;\n}\n"     \
                 : __VA_ARGS__                                                            \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate = 1) {
  static_assert(N % 16 == 0 && N >= 16 && N <= 128, "PV width: a multiple of 16 up to 128");
  BT_WGMMA_PV(16, BT_ACC8, 8, 9, 10, 11, 12, 13, BT_F8(0))
  BT_WGMMA_PV(32, BT_ACC16, 16, 17, 18, 19, 20, 21, BT_F8(0), BT_F8(8))
  BT_WGMMA_PV(48, BT_ACC24, 24, 25, 26, 27, 28, 29, BT_F8(0), BT_F8(8), BT_F8(16))
  BT_WGMMA_PV(64, BT_ACC32, 32, 33, 34, 35, 36, 37, BT_F8(0), BT_F8(8), BT_F8(16), BT_F8(24))
  BT_WGMMA_PV(80, BT_ACC40, 40, 41, 42, 43, 44, 45, BT_F8(0), BT_F8(8), BT_F8(16), BT_F8(24),
              BT_F8(32))
  BT_WGMMA_PV(96, BT_ACC48, 48, 49, 50, 51, 52, 53, BT_F8(0), BT_F8(8), BT_F8(16), BT_F8(24),
              BT_F8(32), BT_F8(40))
  BT_WGMMA_PV(112, BT_ACC56, 56, 57, 58, 59, 60, 61, BT_F8(0), BT_F8(8), BT_F8(16), BT_F8(24),
              BT_F8(32), BT_F8(40), BT_F8(48))
  BT_WGMMA_PV(128, BT_ACC64, 64, 65, 66, 67, 68, 69, BT_F8(0), BT_F8(8), BT_F8(16), BT_F8(24),
              BT_F8(32), BT_F8(40), BT_F8(48), BT_F8(56))
}

// wgmma shared-memory descriptor of an operand with the bf16 tiles'
// swizzle (kSwLayout), fields as sw32_desc's.
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (kSwLayout << 62);
}

// S = Q K^T for one warpgroup's 64 queries (its kSwBoxes boxes of 64 rows)
// and one key tile: kBoxes k-steps, kSwSteps of 32 bytes in each box row,
// K-major with 8-row groups kSwBytes * 8 apart.
__device__ __forceinline__ void issue_qk(float (&s)[kAcc], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int x = 0; x < kBoxes; ++x) {
    const uint32_t step = (x % kSwSteps) * 32;
    wgmma_m64n128k16_ss(
        s, sw_desc(q_addr + (x / kSwSteps) * 64 * kSwBytes + step, 16, 8 * kSwBytes),
        sw_desc(k_addr + (x / kSwSteps) * kTileK * kSwBytes + step, 16, 8 * kSwBytes), x);
  }
}

// O += P V: P from registers, V (keys x kDPad lanes) with the transpose bit:
// MN-major, boxes of kSwLanes lanes kTileK rows apart, 8-key groups
// kSwBytes * 8 apart.
__device__ __forceinline__ void issue_pv(float (&o)[kOut], const uint32_t (&p)[kTileK / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk)
    wgmma_pv<kDPad>(o, p[kk], sw_desc(v_addr + kk * 16 * kSwBytes, kTileK * kSwBytes,
                                      8 * kSwBytes));
}

// The general softmax's bias of key 8i + 2t + j of a tile (the accumulator
// layout below), bias(i, j): 0 for a live key, whose scaled logit is kept,
// else the logit the key takes. MaskBytes (the float32 kernel): -inf past
// Nk (the tile's keys from `valid` on), -1e30 where the (Nk,) mask in
// device memory is 0 (nowhere without a mask). InRange (the bf16 kernel
// without a mask, on a ragged last tile): -inf past Nk. PlanBits (the bf16
// kernel with a mask): this thread's 32 keys of the tile from the plan,
// key 8i + 2t + j as bit 2i + j, 0 where the bit is set and -inf where it
// is not; a walked tile holds a live key, so a masked key's weight is 0
// either way. On the walk of a mask with no live key the bits mark the
// keys below Nk, which take `fill`, -1e30.
struct MaskBytes {
  const uint8_t* mask;
  int k0, valid, t;
  __device__ __forceinline__ float bias(int i, int j) const {
    const int k = 8 * i + 2 * t + j;
    return k >= valid ? -INFINITY : (mask == nullptr || mask[k0 + k] != 0 ? 0.f : -1e30f);
  }
};
struct InRange {
  int valid, t;
  __device__ __forceinline__ float bias(int i, int j) const {
    return 8 * i + 2 * t + j >= valid ? -INFINITY : 0.f;
  }
};
struct PlanBits {
  uint32_t w;
  float fill;
  __device__ __forceinline__ float bias(int i, int j) const {
    return (w >> (2 * i + j)) & 1u ? fill : -INFINITY;
  }
};

// Online softmax of one key tile of 2 NA keys on its NA QK^T accumulators
// (NA = kAcc in the bf16 kernel). This thread holds
// rows g and g+8 of its warp's 16 and, for i < NA/4, keys 8i + 2t and
// 8i + 2t + 1 of the tile: s[4i], s[4i+1] of row g and s[4i+2], s[4i+3] of
// row g+8. With x = logit * scale * log2(e), or the key's bias where that
// is not 0 (`keys`, above: -1e30 or -inf), s becomes 2^(x - m)
// with m the running row maximum, and corr the factor by which the earlier
// sums shrink. `fast`: every key of the tile is live and scale > 0, so the
// maximum is taken on the raw logits and the scale is folded into one FMA
// per exponential; the general path scales first, since folding -1e30 into
// an FMA would leave its product's rounding error (about 1e22) in the
// exponent of an all-masked row. The exponentials run in turns with the
// other warpgroup (`last`: this warpgroup's final turn).
template <int NA, typename Keys>
__device__ __forceinline__ void softmax_tile(float (&s)[NA], float& m_a, float& m_b, float& l_a,
                                             float& l_b, float& corr_a, float& corr_b, float c,
                                             bool fast, const Keys& keys, int wg, bool last) {
  float mx_a = -INFINITY, mx_b = -INFINITY;
  if (fast) {
    float pa[4], pb[4];  // four partial maxima per row: short dependency chains
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pa[r] = fmaxf(s[4 * r], s[4 * r + 1]);
      pb[r] = fmaxf(s[4 * r + 2], s[4 * r + 3]);
    }
#pragma unroll
    for (int i = 4; i < NA / 4; ++i) {
      pa[i % 4] = fmaxf(pa[i % 4], fmaxf(s[4 * i], s[4 * i + 1]));
      pb[i % 4] = fmaxf(pb[i % 4], fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    mx_a = fmaxf(fmaxf(pa[0], pa[1]), fmaxf(pa[2], pa[3])) * c;
    mx_b = fmaxf(fmaxf(pb[0], pb[1]), fmaxf(pb[2], pb[3])) * c;
  } else {
#pragma unroll
    for (int i = 0; i < NA / 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float bias = keys.bias(i, j);
        s[4 * i + j] = bias == 0.f ? s[4 * i + j] * c : bias;
        s[4 * i + 2 + j] = bias == 0.f ? s[4 * i + 2 + j] * c : bias;
        mx_a = fmaxf(mx_a, s[4 * i + j]);
        mx_b = fmaxf(mx_b, s[4 * i + 2 + j]);
      }
    }
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
  }
  // finite: every tile of a walk holds a live key or, with none anywhere,
  // keys below Nk at -1e30
  const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
  corr_a = ex2(m_a - mn_a);
  corr_b = ex2(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  turn_wait(wg);
  if (fast) {
#pragma unroll
    for (int i = 0; i < NA; i += 4) {
      s[i] = ex2(fmaf(s[i], c, -m_a));
      s[i + 1] = ex2(fmaf(s[i + 1], c, -m_a));
      s[i + 2] = ex2(fmaf(s[i + 2], c, -m_b));
      s[i + 3] = ex2(fmaf(s[i + 3], c, -m_b));
    }
  } else {
#pragma unroll
    for (int i = 0; i < NA; i += 4) {
      s[i] = ex2(s[i] - m_a);
      s[i + 1] = ex2(s[i + 1] - m_a);
      s[i + 2] = ex2(s[i + 2] - m_b);
      s[i + 3] = ex2(s[i + 3] - m_b);
    }
  }
  if (wg == 0 || !last) turn_pass(wg);  // warpgroup 1 passed first, so it passes once less
  float ra[4] = {0.f, 0.f, 0.f, 0.f}, rb[4] = {0.f, 0.f, 0.f, 0.f};  // partial row sums
#pragma unroll
  for (int i = 0; i < NA / 4; ++i) {
    ra[i % 4] += s[4 * i] + s[4 * i + 1];
    rb[i % 4] += s[4 * i + 2] + s[4 * i + 3];
  }
  l_a = l_a * corr_a + ((ra[0] + ra[1]) + (ra[2] + ra[3]));  // this thread's keys; summed
  l_b = l_b * corr_b + ((rb[0] + rb[1]) + (rb[2] + rb[3]));  // over t at the end
}

// The probabilities as bf16 A fragments of PV: accumulator blocks 2kk and
// 2kk+1 (keys 16kk .. 16kk+15) are the kk-th k-step.
__device__ __forceinline__ void pack_p(uint32_t (&p)[kTileK / 16][4], const float (&s)[kAcc]) {
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// The key mask's plan (header note), built by the whole block: the (Nk,)
// mask as bits, tile j's 128 in live[j], word t holding the keys thread t
// of a warp owns (PlanBits; zero past Nk), then the walk: in order, the
// index of every tile with a live key, with kFullTile where all 128 of its
// keys are live. With no live key anywhere every tile is on the walk, none
// full, with the keys below Nk marked and tl.fill -1e30, so that each
// query averages all Nk values. Returns the walk's length (tl.n_walk).
__device__ __forceinline__ int build_plan(const uint8_t* __restrict__ key_mask, int Nk,
                                          int n_tiles, uint4* live, uint32_t* walk,
                                          Bf16Tail& tl) {
  // one word a thread: 32 mask bytes, two in each 8-key group of the tile
  uint32_t* const words = reinterpret_cast<uint32_t*>(live);
  for (int c = threadIdx.x; c < 4 * n_tiles; c += blockDim.x) {
    const int k0 = (c >> 2) * kTileK + 2 * (c & 3);
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < kTileK / 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + 8 * i + j;
        if (key < Nk && key_mask[key] != 0) bits |= 1u << (2 * i + j);
      }
    words[c] = bits;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int j0 = 0; j0 < n_tiles; j0 += 32) {
      const int j = j0 + lane;
      int live_keys = 0;
      if (j < n_tiles) {
        const uint4 w = live[j];
        live_keys = __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
      }
      const uint32_t on = __ballot_sync(0xffffffffu, live_keys > 0);
      if (live_keys > 0)
        walk[n + __popc(on & ((1u << lane) - 1))] = j | (live_keys == kTileK ? kFullTile : 0u);
      n += __popc(on);
    }
    const bool none = n == 0;
    if (none) {
      for (int j = lane; j < n_tiles; j += 32) walk[j] = j;
      for (int c = lane; c < 4 * n_tiles; c += 32) {
        const int k0 = (c >> 2) * kTileK + 2 * (c & 3);
        uint32_t bits = 0;
        for (int i = 0; i < kTileK / 8; ++i)
          for (int j = 0; j < 2; ++j)
            if (k0 + 8 * i + j < Nk) bits |= 1u << (2 * i + j);
        words[c] = bits;
      }
      n = n_tiles;
    }
    if (lane == 0) {
      tl.n_walk = n;
      tl.fill = none ? -1e30f : 0.f;
    }
  }
  __syncthreads();
  return tl.n_walk;
}

// The general softmax's key biases of walk entry e's tile for thread t:
// from the plan with a key mask (every key live on a full tile), else the
// keys below Nk.
template <bool Masked>
__device__ __forceinline__ auto tile_keys(const Bf16Tail& tl, const uint4* live, uint32_t e,
                                          int Nk, int t) {
  if constexpr (Masked) {
    if (e & kFullTile) return PlanBits{~0u, 0.f};
    return PlanBits{reinterpret_cast<const uint32_t*>(live + (e & ~kFullTile))[t], tl.fill};
  } else {
    return InRange{Nk - static_cast<int>(e & ~kFullTile) * kTileK, t};
  }
}

// One block per (128-query tile, head, batch row): warps 0-7 are two
// consumer warpgroups of 64 queries each; warp 8 is the producer where the
// instantiation has one (kProducer), else thread 128 issues the copies
// between its own tiles. Q
// is loaded once; the key tiles of the walk (every tile, or with a key mask
// those of the plan) stream through the ring (full/empty mbarriers: a walk
// position's stage and parity follow the position, not the tile). Each
// consumer warpgroup issues position p+1's QK^T, then p's PV, and runs
// p+1's softmax while PV is on the tensor cores.
template <int Stages, bool Masked>
__global__ void __launch_bounds__(kThreads<Masked>, 1)
    attention_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                const __grid_constant__ CUtensorMap map_o,
                                const uint8_t* __restrict__ key_mask, int N, int Nk,
                                float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const ring = base + kQBytes;
  Bf16Tail& tl = *reinterpret_cast<Bf16Tail*>(ring + Stages * kStageBytes);
  uint4* const live = reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(&tl) + kTailBytes);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTileQ;
  const int n_tiles = (Nk + kTileK - 1) / kTileK;
  uint32_t* const walk = reinterpret_cast<uint32_t*>(live + n_tiles);

  // head h's kSwBoxes boxes of `rows` rows from `row` into dst, box after
  // box: one copy over the lane blocks' map, or one a box over the heads'
  // map when d is not a multiple of 16
  const auto load = [&](uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int row, int rows) {
    if constexpr (kSplitHeads) {
      for (int x = 0; x < kBoxes; ++x)
        tma_load_4d(dst + x * rows * kRowBytes, map, bar, x * kBox, h, row, b);
    } else {
      tma_load_4d(dst, map, bar, 0, row, h * kSwBoxes, b);
    }
  };
  // walk entry p: a tile index, with kFullTile where every key is live
  const auto entry = [&](int p) -> uint32_t {
    return Masked ? walk[p]
                  : static_cast<uint32_t>(p) | ((p + 1) * kTileK <= Nk ? kFullTile : 0u);
  };
  // K and V of walk position p into its stage
  const auto load_tile = [&](int p) {
    const int st = p % Stages, row = static_cast<int>(entry(p) & ~kFullTile) * kTileK;
    uint8_t* const stage = ring + st * kStageBytes;
    mbar_arrive_expect_tx(&tl.full[st], kStageBytes);
    load(stage, &map_k, &tl.full[st], row, kTileK);
    load(stage + kKVTile, &map_v, &tl.full[st], row, kTileK);
  };

  if (threadIdx.x == kIssuer<Masked>) {
    for (int st = 0; st < Stages; ++st) {
      mbar_init(&tl.full[st], 1);
      mbar_init(&tl.empty[st], kConsumers / 32);  // lane 0 of each consumer warp
    }
    mbar_init(&tl.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_arrive_expect_tx(&tl.q_full, kQBytes);
    for (int w = 0; w < kWarpgroups; ++w)
      load(base + w * 64 * kDPad * 2, &map_q, &tl.q_full, q0 + 64 * w, 64);
  }
  __syncthreads();
  // with a key mask, the plan, while Q arrives
  const int n_walk = Masked ? build_plan(key_mask, Nk, n_tiles, live, walk, tl) : n_tiles;

  if (kProducer<Masked> && warp == kConsumers / 32) {
    if (lane == 0)
      for (int p = 0; p < n_walk; ++p) {
        if (p >= Stages) mbar_wait(&tl.empty[p % Stages], (p / Stages - 1) & 1);
        load_tile(p);
      }
    return;
  }
  if (!kProducer<Masked> && threadIdx.x == kIssuer<Masked>)
    for (int p = 0; p < Stages && p < n_walk; ++p) load_tile(p);

  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const float c = scale * kLog2e;
  uint8_t* const q_wg = base + wg * 64 * kDPad * 2;  // this warpgroup's Q boxes
  const uint32_t q_addr = smem_u32(q_wg), ring_addr = smem_u32(ring);

  float o[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) o[i] = 0.f;
  float s[kAcc];
  uint32_t p[kTileK / 16][4];
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f, corr_a, corr_b;

  if (wg == 1) turn_pass(wg);  // warpgroup 0 takes the first turn
  mbar_wait(&tl.q_full, 0);
  mbar_wait(&tl.full[0], 0);
  wgmma_fence();
  issue_qk(s, q_addr, ring_addr);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);
  uint32_t e = entry(0);
  softmax_tile(s, m_a, m_b, l_a, l_b, corr_a, corr_b, c, (e & kFullTile) && c > 0.f,
               tile_keys<Masked>(tl, live, e, Nk, t), wg, n_walk == 1);
  pack_p(p, s);

  for (int j = 0; j + 1 < n_walk; ++j) {
    const int st = j % Stages, sn = (j + 1) % Stages;
    mbar_wait(&tl.full[sn], ((j + 1) / Stages) & 1);
    reg_fence(o);
    reg_fence(p);
    wgmma_fence();
    issue_qk(s, q_addr, ring_addr + sn * kStageBytes);
    wgmma_commit();
    issue_pv(o, p, ring_addr + st * kStageBytes + kKVTile);
    wgmma_commit();
    wgmma_wait<1>();  // QK^T of position j+1 is done; PV of j may run on
    reg_fence(s);
    e = entry(j + 1);
    softmax_tile(s, m_a, m_b, l_a, l_b, corr_a, corr_b, c, (e & kFullTile) && c > 0.f,
                 tile_keys<Masked>(tl, live, e, Nk, t), wg, j + 2 == n_walk);
    wgmma_wait<0>();
    reg_fence(o);
    reg_fence(p);
    if (lane == 0) mbar_arrive(&tl.empty[st]);  // position j's K and V are read
    if constexpr (!kProducer<Masked>) {  // both warpgroups are past position j: j + Stages
      if (threadIdx.x == kIssuer<Masked> && j + Stages < n_walk) {
        mbar_wait(&tl.empty[st], (j / Stages) & 1);
        load_tile(j + Stages);
      }
    }
#pragma unroll
    for (int i = 0; i < kOut / 4; ++i) {
      o[4 * i] *= corr_a;
      o[4 * i + 1] *= corr_a;
      o[4 * i + 2] *= corr_b;
      o[4 * i + 3] *= corr_b;
    }
    pack_p(p, s);
  }
  reg_fence(o);
  reg_fence(p);
  wgmma_fence();
  issue_pv(o, p, ring_addr + ((n_walk - 1) % Stages) * kStageBytes + kKVTile);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(o);

  // normalise, stage this warpgroup's 64 x d outputs row-major in its Q
  // boxes (dead once all four warps are past its last QK^T) and store them
  // with one TMA box (rows past N are dropped by the copy; PV's columns
  // past d are not staged)
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
  }
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  __nv_bfloat16* ob =
      reinterpret_cast<__nv_bfloat16*>(q_wg) + (wl * 16 + g) * kHeadDim + 2 * t;
#pragma unroll
  for (int i = 0; i < kHeadDim / 8; ++i) {
    *reinterpret_cast<__nv_bfloat162*>(ob + 8 * i) =
        __floats2bfloat162_rn(o[4 * i] * inv_a, o[4 * i + 1] * inv_a);
    *reinterpret_cast<__nv_bfloat162*>(ob + 8 * kHeadDim + 8 * i) =
        __floats2bfloat162_rn(o[4 * i + 2] * inv_b, o[4 * i + 3] * inv_b);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  if (wl == 0 && lane == 0 && q0 + wg * 64 < N)
    tma_store(&map_o, q_wg, h * kHeadDim, q0 + wg * 64, b);
}

// ------------------------------------------------------------- float32 as three bf16 terms
// The three-term split of a pair of floats (header note): t1 = bf16(x),
// t2 = bf16(x - t1), t3 = bf16(x - t1 - t2), each rounded to nearest even;
// both differences are exact in float32.
__device__ __forceinline__ void split3(float lo, float hi, uint32_t& t1, uint32_t& t2,
                                       uint32_t& t3) {
  const __nv_bfloat162 b1 = __floats2bfloat162_rn(lo, hi);
  const float2 f1 = __bfloat1622float2(b1);
  const float r_lo = lo - f1.x, r_hi = hi - f1.y;
  const __nv_bfloat162 b2 = __floats2bfloat162_rn(r_lo, r_hi);
  const float2 f2 = __bfloat1622float2(b2);
  const __nv_bfloat162 b3 = __floats2bfloat162_rn(r_lo - f2.x, r_hi - f2.y);
  t1 = *reinterpret_cast<const uint32_t*>(&b1);
  t2 = *reinterpret_cast<const uint32_t*>(&b2);
  t3 = *reinterpret_cast<const uint32_t*>(&b3);
}

// One split of (rows, lanes) float32 rows `stride` elements apart into the
// (3, rows, lanes) bf16 terms at dst.
struct SplitJob {
  const float* src;
  __nv_bfloat16* dst;
  long long rows, stride;
  int lanes;
};
constexpr int kSplitJobs = 3;  // q, k and v of one attention call
struct SplitJobs {
  SplitJob job[kSplitJobs];
};

// Job blockIdx.y, 8 lanes a thread per step: two 16-byte loads, three
// 16-byte stores (lanes a multiple of 8, stride of 4, 16-byte bases).
__global__ void __launch_bounds__(256) split_terms_kernel(const __grid_constant__ SplitJobs jobs) {
  const SplitJob& jb = jobs.job[blockIdx.y];
  const int vecs = jb.lanes / 8;
  const long long n = jb.rows * vecs, term = jb.rows * jb.lanes;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / vecs;
    const int c = static_cast<int>(i - r * vecs) * 8;
    const float4* src = reinterpret_cast<const float4*>(jb.src + r * jb.stride + c);
    const float4 a = __ldg(src), b = __ldg(src + 1);
    uint4 t1, t2, t3;
    split3(a.x, a.y, t1.x, t2.x, t3.x);
    split3(a.z, a.w, t1.y, t2.y, t3.y);
    split3(b.x, b.y, t1.z, t2.z, t3.z);
    split3(b.z, b.w, t1.w, t2.w, t3.w);
    __nv_bfloat16* dst = jb.dst + r * jb.lanes + c;
    *reinterpret_cast<uint4*>(dst) = t1;
    *reinterpret_cast<uint4*>(dst + term) = t2;
    *reinterpret_cast<uint4*>(dst + 2 * term) = t3;
  }
}

constexpr int kTerms = 3;
constexpr int kF32TileK = kBoxes <= 6 ? 64 : 32;   // keys per tile (header note)
constexpr int kF32Acc = kF32TileK / 2;             // QK^T accumulators per thread
constexpr int kF32Steps = kF32TileK / 16;          // k-steps of PV per tile
constexpr int kF32QTerm = kBoxes * kTileQ * kRowBytes;      // one term of Q, bytes
constexpr int kF32KVTerm = kBoxes * kF32TileK * kRowBytes;  // one term of a K or V tile
constexpr int kF32StageBytes = 2 * kTerms * kF32KVTerm;
constexpr int kF32FitStages = (kSmemMax - 2048 - kTerms * kF32QTerm) / kF32StageBytes;
constexpr int kF32Stages = kF32FitStages < 4 ? kF32FitStages : 4;
static_assert(kF32Stages >= 2, "the float32 K/V ring needs two stages");
// A producer warp where the consumers fit in the 168 registers nine warps
// leave them (up to d 48); else thread 0 issues the copies (header note),
// each tile's loads one tile after its stage is free when three stages or
// more leave room for that, so that warpgroup 0 seldom waits for the other.
constexpr bool kF32Producer = kBoxes <= 3;
constexpr int kF32Threads = kConsumers + (kF32Producer ? 32 : 0);
constexpr int kF32LoadLag = kF32Stages >= 3 ? 1 : 0;

struct __align__(1024) SmemF32 {
  __nv_bfloat16 q[kTerms][kBoxes][kTileQ * kBox];
  __nv_bfloat16 k[kF32Stages][kTerms][kBoxes][kF32TileK * kBox];
  __nv_bfloat16 v[kF32Stages][kTerms][kBoxes][kF32TileK * kBox];
  uint64_t full[kF32Stages], empty[kF32Stages], q_full;
};

// d (64 x N) (+)= a (64 x 16) b^T, both K-major in shared memory, for the
// key tile's N = kF32TileK; operand lists per N as wgmma_pv's.
#define BT_WGMMA_SS(NN, ACC, A, B, P, ...)                                                \
  if constexpr (N == NN)                                                                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                         \
                 "wgmma.mma_async.sync.aligned.m64n" #NN "k16.f32.bf16.bf16 {" ACC "}, " \
                 "%" #A ", %" #B ", p, 1, 1, 0, 0;\n}\n"                                   \
                 : __VA_ARGS__                                                            \
                 : "l"(desc_a), "l"(desc_b), "r"(accumulate));
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  static_assert(N == 32 || N == 64, "QK^T width of the float32 kernel: 32 or 64 keys");
  BT_WGMMA_SS(32, BT_ACC16, 16, 17, 18, BT_F8(0), BT_F8(8))
  BT_WGMMA_SS(64, BT_ACC32, 32, 33, 34, BT_F8(0), BT_F8(8), BT_F8(16), BT_F8(24))
}

// The term pairs (i, j), i + j <= 2, smallest products first: pair pr is
// (pair_a(pr), pair_b(pr)) = (2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0).
// The first product overwrites the accumulator, the rest add to it.
__host__ __device__ constexpr int pair_a(int pr) { return pr < 3 ? 2 - pr : (pr < 5 ? 4 - pr : 0); }
__host__ __device__ constexpr int pair_b(int pr) { return pr < 3 ? pr : (pr < 5 ? pr - 3 : 0); }

// S = sum over the pairs of Q_i K_j^T for one warpgroup's 64 queries and
// one key tile: 6 kBoxes products.
__device__ __forceinline__ void issue_qk3(float (&s)[kF32Acc], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int pr = 0; pr < 6; ++pr)
#pragma unroll
    for (int x = 0; x < kBoxes; ++x)
      wgmma_ss<kF32TileK>(
          s, sw32_desc(q_addr + pair_a(pr) * kF32QTerm + x * kTileQ * kRowBytes, 16, 8 * kRowBytes),
          sw32_desc(k_addr + pair_b(pr) * kF32KVTerm + x * kF32TileK * kRowBytes, 16,
                    8 * kRowBytes),
          pr > 0 || x > 0);
}

// O_tile = sum over the pairs of P_i V_j: P's terms from registers, V's
// (keys x kDPad lanes) with the transpose bit; 6 kF32Steps products.
__device__ __forceinline__ void issue_pv3(float (&o)[kOut],
                                          const uint32_t (&p)[kTerms][kF32Steps][4],
                                          uint32_t v_addr) {
#pragma unroll
  for (int pr = 0; pr < 6; ++pr)
#pragma unroll
    for (int kk = 0; kk < kF32Steps; ++kk)
      wgmma_pv<kDPad>(o, p[pair_a(pr)][kk],
                      sw32_desc(v_addr + pair_b(pr) * kF32KVTerm + kk * 16 * kRowBytes,
                                kF32TileK * kRowBytes, 8 * kRowBytes),
                      pr > 0 || kk > 0);
}

// The probabilities, three bf16 terms of each, as A fragments of PV (the
// layout of pack_p).
__device__ __forceinline__ void pack_p3(uint32_t (&p)[kTerms][kF32Steps][4],
                                        const float (&s)[kF32Acc]) {
#pragma unroll
  for (int kk = 0; kk < kF32Steps; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], p[0][kk][r], p[1][kk][r], p[2][kk][r]);
}

// One block per (128-query tile, head, batch row): two consumer warpgroups
// of 64 queries each and, up to d 48, a producer warp (warp 8). From d 56
// there is no producer warp, so that a thread may hold 255 registers
// (eight warps; nine cap it at 168, which the tile's logits, three P terms
// and two output accumulators then outgrow), and thread 0 issues every
// copy: Q and the first tiles before the loop, then one tile each time a
// stage is free. q, k and v are the maps over the terms (batch rows t B + b
// for term t); out is float32 (B, N) rows of o_stride elements.
__global__ void __launch_bounds__(kF32Threads, 1)
    attention_f32_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const uint8_t* __restrict__ key_mask, float* __restrict__ out,
                               int B, int N, int Nk, int o_stride, float scale) {
  extern __shared__ uint8_t smem_raw[];
  SmemF32& sm =
      *reinterpret_cast<SmemF32*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTileQ;
  const int n_tiles = (Nk + kF32TileK - 1) / kF32TileK;

  // box x (lanes 16x .. 16x + 15) of term tm of head h in `row`'s tile
  const auto load = [&](void* dst, const CUtensorMap* map, uint64_t* bar, int tm, int x,
                        int row) {
    if constexpr (kSplitHeads)
      tma_load_4d(dst, map, bar, x * kBox, h, row, tm * B + b);
    else
      tma_load(dst, map, bar, h * kHeadDim + x * kBox, row, tm * B + b);
  };
  // the three terms of K and V tile j into its stage
  const auto load_tile = [&](int j) {
    const int st = j % kF32Stages;
    mbar_arrive_expect_tx(&sm.full[st], kF32StageBytes);
    for (int tm = 0; tm < kTerms; ++tm)
      for (int x = 0; x < kBoxes; ++x) {
        load(sm.k[st][tm][x], &map_k, &sm.full[st], tm, x, j * kF32TileK);
        load(sm.v[st][tm][x], &map_v, &sm.full[st], tm, x, j * kF32TileK);
      }
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < kF32Stages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kConsumers / 32);  // lane 0 of each consumer warp
    }
    mbar_init(&sm.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == (kF32Producer ? kConsumers : 0)) {
    mbar_arrive_expect_tx(&sm.q_full, kTerms * kF32QTerm);
    for (int tm = 0; tm < kTerms; ++tm)
      for (int x = 0; x < kBoxes; ++x) load(sm.q[tm][x], &map_q, &sm.q_full, tm, x, q0);
    for (int j = 0; j < (kF32Producer ? n_tiles : kF32Stages) && j < n_tiles; ++j) {
      if (j >= kF32Stages) mbar_wait(&sm.empty[j % kF32Stages], (j / kF32Stages - 1) & 1);
      load_tile(j);
    }
  }
  if (kF32Producer && warp == kConsumers / 32) return;

  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const float c = scale * kLog2e;
  const bool fast_ok = key_mask == nullptr && c > 0.f;
  const uint32_t q_addr = smem_u32(sm.q[0][0]) + wg * 64 * kRowBytes;

  float o[kOut], ot[kOut];  // the running output; one tile's PV
#pragma unroll
  for (int i = 0; i < kOut; ++i) o[i] = ot[i] = 0.f;
  float s[kF32Acc];
  uint32_t p[kTerms][kF32Steps][4];
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f, corr_a, corr_b;

  if (wg == 1) turn_pass(wg);  // warpgroup 0 takes the first turn
  mbar_wait(&sm.q_full, 0);
  mbar_wait(&sm.full[0], 0);
  wgmma_fence();
  issue_qk3(s, q_addr, smem_u32(sm.k[0][0][0]));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);
  softmax_tile(s, m_a, m_b, l_a, l_b, corr_a, corr_b, c, fast_ok && kF32TileK <= Nk,
               MaskBytes{key_mask, 0, Nk, t}, wg, n_tiles == 1);
  pack_p3(p, s);

  for (int j = 0; j + 1 < n_tiles; ++j) {
    const int st = j % kF32Stages, sn = (j + 1) % kF32Stages;
    mbar_wait(&sm.full[sn], ((j + 1) / kF32Stages) & 1);
    reg_fence(ot);
    reg_fence(p);
    wgmma_fence();
    issue_qk3(s, q_addr, smem_u32(sm.k[sn][0][0]));
    wgmma_commit();
    issue_pv3(ot, p, smem_u32(sm.v[st][0][0]));
    wgmma_commit();
    wgmma_wait<1>();  // QK^T of tile j+1 is done; PV of tile j may run on
    reg_fence(s);
    const int k0 = (j + 1) * kF32TileK;
    softmax_tile(s, m_a, m_b, l_a, l_b, corr_a, corr_b, c, fast_ok && k0 + kF32TileK <= Nk,
                 MaskBytes{key_mask, k0, Nk - k0, t}, wg, j + 2 == n_tiles);
    wgmma_wait<0>();
    reg_fence(ot);
    reg_fence(p);
    if (lane == 0) mbar_arrive(&sm.empty[st]);  // tile j's K and V are read
    if constexpr (!kF32Producer) {
      const int jj = j - kF32LoadLag;  // both warpgroups past tile jj: tile jj + stages
      if (threadIdx.x == 0 && jj >= 0 && jj + kF32Stages < n_tiles) {
        mbar_wait(&sm.empty[jj % kF32Stages], (jj / kF32Stages) & 1);
        load_tile(jj + kF32Stages);
      }
    }
    // o holds the tiles before j at tile j's maximum: add tile j, then
    // move to tile j+1's maximum
#pragma unroll
    for (int i = 0; i < kOut / 4; ++i) {
      o[4 * i] = (o[4 * i] + ot[4 * i]) * corr_a;
      o[4 * i + 1] = (o[4 * i + 1] + ot[4 * i + 1]) * corr_a;
      o[4 * i + 2] = (o[4 * i + 2] + ot[4 * i + 2]) * corr_b;
      o[4 * i + 3] = (o[4 * i + 3] + ot[4 * i + 3]) * corr_b;
    }
    pack_p3(p, s);
  }
  reg_fence(ot);
  reg_fence(p);
  wgmma_fence();
  issue_pv3(ot, p, smem_u32(sm.v[(n_tiles - 1) % kF32Stages][0][0]));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(ot);

  // normalise and write this thread's rows g and g+8, columns 8i + 2t and
  // 8i + 2t + 1 for i < d / 8 (PV's columns past d are not written)
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
  }
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
  const int row = q0 + wg * 64 + wl * 16 + g;
  float* dst = out + ((long long)b * N + row) * o_stride + h * kHeadDim + 2 * t;
#pragma unroll
  for (int i = 0; i < kHeadDim / 8; ++i) {
    if (row < N)
      *reinterpret_cast<float2*>(dst + 8 * i) =
          make_float2((o[4 * i] + ot[4 * i]) * inv_a, (o[4 * i + 1] + ot[4 * i + 1]) * inv_a);
    if (row + 8 < N)
      *reinterpret_cast<float2*>(dst + 8LL * o_stride + 8 * i) = make_float2(
          (o[4 * i + 2] + ot[4 * i + 2]) * inv_b, (o[4 * i + 3] + ot[4 * i + 3]) * inv_b);
  }
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: looked up through the runtime's
// entry-point query, so the library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(f)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor map over (batch, rows, lanes): `lanes` lanes from `base` in
// each row, rows `stride` elements apart, boxes of box_lanes x box_rows.
// With heads > 0 the lanes are split into (heads, lanes / heads), heads
// lanes / heads elements apart, and a box covers one head.
bool bf16_map(CUtensorMap* map, const void* base, int lanes, int rows, int batch, int stride,
              int box_lanes, int box_rows, CUtensorMapSwizzle swizzle, int heads = 0) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(stride) * 2;
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  if (heads > 0) {
    const cuuint64_t d = static_cast<cuuint64_t>(lanes / heads);
    const cuuint64_t dims[4] = {d, static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(rows),
                                static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[3] = {d * 2, row_bytes, row_bytes * rows};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_lanes), 1,
                               static_cast<cuuint32_t>(box_rows), 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                  strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(lanes), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {row_bytes, row_bytes * rows};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_lanes),
                             static_cast<cuuint32_t>(box_rows), 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 tensor map over (batch, rows, lanes), lanes a multiple of
// kSwLanes, as blocks of kSwLanes lanes: dims (kSwLanes, rows, lanes /
// kSwLanes, batch), so that one box of (kSwLanes, box_rows, kSwBoxes) lands
// as kSwBoxes boxes one after another, as kSwBoxes copies of one box each
// would, with the tiles' swizzle.
bool bf16_block_map(CUtensorMap* map, const void* base, int lanes, int rows, int batch,
                    int stride, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(stride) * 2;
  const cuuint64_t dims[4] = {kSwLanes, static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(lanes / kSwLanes),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {row_bytes, kSwBytes, row_bytes * rows};
  const cuuint32_t box[4] = {kSwLanes, static_cast<cuuint32_t>(box_rows), kSwBoxes, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = kSwBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : kSwBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, const uint8_t* key_mask,
                        void* out, int B, int N, int Nk, int heads, int q_stride, int kv_stride,
                        int o_stride, float scale, cudaStream_t stream) {
  const int C = heads * kHeadDim;
  const int split = kSplitHeads ? heads : 0;  // q, k and v by head (header note)
  CUtensorMap mq, mk, mv, mo;
  const bool maps =
      kSplitHeads
          ? bf16_map(&mq, q, C, N, B, q_stride, kBox, 64, CU_TENSOR_MAP_SWIZZLE_32B, split) &&
                bf16_map(&mk, k, C, Nk, B, kv_stride, kBox, kTileK, CU_TENSOR_MAP_SWIZZLE_32B,
                         split) &&
                bf16_map(&mv, v, C, Nk, B, kv_stride, kBox, kTileK, CU_TENSOR_MAP_SWIZZLE_32B,
                         split)
          : bf16_block_map(&mq, q, C, N, B, q_stride, 64) &&
                bf16_block_map(&mk, k, C, Nk, B, kv_stride, kTileK) &&
                bf16_block_map(&mv, v, C, Nk, B, kv_stride, kTileK);
  if (!maps || !bf16_map(&mo, out, C, N, B, o_stride, kHeadDim, 64, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  // the ring's stages: kStages, two where a key mask's plan would not fit
  // beside them (header note); + 1024 bytes of alignment slack
  const int plan = key_mask != nullptr ? (Nk + kTileK - 1) / kTileK * kPlanBytesPerTile : 0;
  const auto smem_of = [&](int stages) {
    return 1024 + kQBytes + stages * kStageBytes + kTailBytes + plan;
  };
  const bool full_ring = smem_of(kStages) <= kSmemMax;
  const int smem = smem_of(full_ring ? kStages : 2);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const auto kernel = key_mask == nullptr ? attention_bf16_wgmma_kernel<kStages, false>
                      : full_ring         ? attention_bf16_wgmma_kernel<kStages, true>
                                          : attention_bf16_wgmma_kernel<2, true>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kTileQ - 1) / kTileQ, heads, B);
  kernel<<<grid, key_mask == nullptr ? kThreads<false> : kThreads<true>, smem, stream>>>(
      mq, mk, mv, mo, key_mask, N, Nk, scale);
  return cudaGetLastError();
}

// float32 rows as their three-term splits (the header note): q, k and v
// point at term 0 of bf16 copies of the rows, term t at + t B N q_stride
// (q) or + t B Nk kv_stride (k, v) elements; out is float32.
cudaError_t launch_f32(const void* q, const void* k, const void* v, const uint8_t* key_mask,
                       float* out, int B, int N, int Nk, int heads, int q_stride, int kv_stride,
                       int o_stride, float scale, cudaStream_t stream) {
  const int C = heads * kHeadDim;
  const int split = kSplitHeads ? heads : 0;  // q, k and v by head (header note)
  CUtensorMap mq, mk, mv;
  if (!bf16_map(&mq, q, C, N, kTerms * B, q_stride, kBox, kTileQ, CU_TENSOR_MAP_SWIZZLE_32B,
                split) ||
      !bf16_map(&mk, k, C, Nk, kTerms * B, kv_stride, kBox, kF32TileK, CU_TENSOR_MAP_SWIZZLE_32B,
                split) ||
      !bf16_map(&mv, v, C, Nk, kTerms * B, kv_stride, kBox, kF32TileK, CU_TENSOR_MAP_SWIZZLE_32B,
                split))
    return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(SmemF32)) + 1024;  // + alignment slack
  const cudaError_t e = cudaFuncSetAttribute(attention_f32_wgmma_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kTileQ - 1) / kTileQ, heads, B);
  attention_f32_wgmma_kernel<<<grid, kF32Threads, smem, stream>>>(mq, mk, mv, key_mask, out, B, N,
                                                                  Nk, o_stride, scale);
  return cudaGetLastError();
}

}  // namespace

// Softmax attention over `heads` heads of dim d (BT_HEAD_DIM) for B batch
// rows. q: (B, N) rows of stride q_stride; k and v: (B, Nk) rows of stride
// kv_stride; out: (B, N) rows of stride o_stride. Head h reads lanes
// h*d .. h*d+d-1 of each row from the given base pointers and writes the
// same lanes of out. key_mask: (Nk,) uint8 or null. bfloat16 (is_bf16 = 1):
// q, k, v and out are bf16. float32 (is_bf16 = 0): out is float32 and q, k
// and v point at the three-term splits of the float32 rows
// (split_terms_forward): three bf16 copies each, term t at + t B N q_stride
// elements (q) or + t B Nk kv_stride (k and v). Every q, k, v and bf16 out
// base pointer must be 16-byte aligned and their row strides a multiple of
// 8 elements (the TMA copies' rule); a float32 out 8-byte aligned with an
// even row stride. Returns cudaGetLastError() after the launch.
extern "C" int attention_forward(const void* q, const void* k, const void* v,
                                 const void* key_mask, void* out, int B, int N, int Nk,
                                 int heads, int q_stride, int kv_stride, int o_stride,
                                 float scale, int is_bf16, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  if (Nk <= 0 || heads <= 0 || heads * kHeadDim > q_stride || heads * kHeadDim > kv_stride ||
      heads * kHeadDim > o_stride)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* mask = static_cast<const uint8_t*>(key_mask);
  const auto misaligned = [](const void* p, int a) {
    return reinterpret_cast<uintptr_t>(p) % a != 0;
  };
  if (misaligned(q, 16) || misaligned(k, 16) || misaligned(v, 16) || q_stride % 8 ||
      kv_stride % 8)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    if (misaligned(out, 16) || o_stride % 8) return (int)cudaErrorInvalidValue;
    return (int)launch_bf16(q, k, v, mask, out, B, N, Nk, heads, q_stride, kv_stride, o_stride,
                            scale, st);
  }
  if (misaligned(out, 8) || o_stride % 2) return (int)cudaErrorInvalidValue;
  return (int)launch_f32(q, k, v, mask, static_cast<float*>(out), B, N, Nk, heads, q_stride,
                         kv_stride, o_stride, scale, st);
}

// The three-term split of n (at most 3) float32 row sets in one launch:
// set i is rows[i] rows of lanes[i] floats, stride[i] elements apart, from
// src[i], written as (3, rows[i], lanes[i]) bf16 terms to dst[i]. lanes a
// positive multiple of 8, strides a multiple of 4 and at least lanes, every
// pointer 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int split_terms_forward(const void* const* src, void* const* dst,
                                   const long long* rows, const long long* stride,
                                   const int* lanes, int n, void* stream) {
  if (n < 1 || n > kSplitJobs) return (int)cudaErrorInvalidValue;
  SplitJobs jobs{};
  long long most = 0;
  for (int i = 0; i < n; ++i) {
    if (lanes[i] <= 0 || lanes[i] % 8 || stride[i] % 4 || stride[i] < lanes[i] || rows[i] < 0 ||
        reinterpret_cast<uintptr_t>(src[i]) % 16 || reinterpret_cast<uintptr_t>(dst[i]) % 16)
      return (int)cudaErrorInvalidValue;
    jobs.job[i] = SplitJob{static_cast<const float*>(src[i]), static_cast<__nv_bfloat16*>(dst[i]),
                           rows[i], stride[i], lanes[i]};
    most = rows[i] * (lanes[i] / 8) > most ? rows[i] * (lanes[i] / 8) : most;
  }
  if (most == 0) return (int)cudaSuccess;
  const long long blocks = (most + 255) / 256;
  split_terms_kernel<<<dim3(blocks < 1024 ? (unsigned)blocks : 1024u, n), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(jobs);
  return (int)cudaGetLastError();
}
