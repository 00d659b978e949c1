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
// as on the TPU; logits, softmax and the output sums are float32.
//
// The head dim d is a compile-time constant, BT_HEAD_DIM (default 48, the
// tracker's: hidden 384 over 8 heads). ops/cuda_build.py builds one library
// per d that a caller asks for (ModelConfig's hidden_size / num_heads): any
// multiple of 8 from 8 to 128. Every size below follows d: the 16-lane
// k-steps of QK^T, ceil(d / 16); the PV product, m64n{16 ceil(d / 16)}k16;
// the output accumulators and the output box (d lanes); the K/V ring's
// stage size and its stage count, four where shared memory holds them
// (two at d 128, three at 96-112). When d is not a multiple of 16 (8, 24,
// 40, ...) the last 16-lane box of a head would read 8 lanes of the next
// head, so q, k and v are then read through 4-D tensor maps with the head
// as its own axis (lanes-in-head of extent d, head, row, batch), whose
// out-of-bounds fill gives zeros past lane d: they add nothing to QK^T,
// and PV's columns past d are never stored. At d 48 the tiles are those
// the note below describes.
//
// Bound on the H100 at the davis_demo shape (12, 2400, 1152) bf16: 106 GFLOP
// of QK^T and PV (0.107 ms at the bf16 tensor-core peak) and 553 M
// exponentials (0.132 ms on the special-function units, 16 per clock per
// SM at the highest SM clock, 1.98 GHz), against 88 MB of input and output:
// bound by the exponentials, so the softmax has to run beside the products,
// not after them. K3 at (96, 2400, 48) does the same work.
//
// bf16 (the production path), laid out for Hopper: one block per (128-query
// tile, head, batch row) with one producer warp and two consumer
// warpgroups of 64 queries. The producer loads Q once and streams 128-key
// tiles of K and V through a four-stage shared-memory ring with TMA
// (cp.async.bulk.tensor over 3-D tensor maps of (batch, row, lane); rows
// past N or Nk arrive as zeros and never cross into the next batch row),
// full/empty mbarriers per stage. A head of 48 lanes is 96 bytes, too narrow
// for the usual 128-byte swizzle, so every tile is three boxes of 16 lanes
// (ceil(d / 16) in general) with the 32-byte swizzle, one per k-step. QK^T is
// wgmma m64n128k16 with Q and K from shared memory; PV is wgmma m64n48k16
// (m64n{16 ceil(d / 16)}k16) with P from registers (the QK^T
// accumulators repacked to bf16) and V from shared memory with the
// transpose bit, so V is never transposed by hand. Each warpgroup issues tile
// j+1's QK^T and tile j's PV together and runs tile j+1's softmax while PV
// runs; the two warpgroups take turns at their exponentials (named
// barriers), which measured faster than letting them contend. The
// exponentials are ex2.approx.ftz with scale * log2(e) folded into one FMA
// when the tile has no masked or missing key. Each warpgroup stages its
// output in shared memory and writes it with one TMA store. At 2.5x its
// bound, what still limits it is open (PERF.md): clock64 phase timings of a
// development copy showed each warpgroup spending longer in its
// exponentials than the units' rate allows and waiting on the issue of its
// products, with neither the loads nor the tensor cores saturated. With a
// key mask every tile takes the general softmax path and loads its mask
// bytes per key: 0.54 ms at the davis_demo shape (PERF.md), which no
// davis_demo path runs (one window, no mask).
//
// float32 (parity runs): one query per thread with its q and output rows
// in registers, 32-key tiles of K and V in shared memory as float32
// (broadcast reads), on the float32 pipes. Its 2d registers of rows spill
// at large d (256 floats a thread at d 128); it stays simple.

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

// Where the rows live. Strides are in elements; q, k, v and out already
// point at lane 0 of head 0 of batch 0.
struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* key_mask;  // (Nk,) or null
  void* out;
  int N, Nk;                // queries and keys per batch row
  int q_stride, kv_stride, o_stride;
  float scale;
};

// ------------------------------------------------------------- float32
constexpr int kBQ = 128;  // queries per block, one per thread
constexpr int kBK = 32;   // keys per shared-memory tile

template <int HD>
__global__ void __launch_bounds__(kBQ) attention_f32_kernel(const AttnArgs a) {
  __shared__ __align__(16) float Ks[kBK][HD];
  __shared__ __align__(16) float Vs[kBK][HD];
  __shared__ float Kf[kBK];  // 0 live, 1 masked (-1e30), 2 past the end (-inf)

  const int b = blockIdx.z, h = blockIdx.y;
  const int qi = blockIdx.x * kBQ + threadIdx.x;
  const bool qvalid = qi < a.N;
  const float* qb = static_cast<const float*>(a.q) + (long long)b * a.N * a.q_stride + h * HD;
  const long long kvb = (long long)b * a.Nk * a.kv_stride + h * HD;
  const float* kb = static_cast<const float*>(a.k) + kvb;
  const float* vb = static_cast<const float*>(a.v) + kvb;

  float q[HD], o[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    q[c] = qvalid ? qb[(long long)qi * a.q_stride + c] : 0.f;
    o[c] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < a.Nk; k0 += kBK) {
    for (int e = threadIdx.x; e < kBK * HD; e += kBQ) {
      const int r = e / HD, c = e % HD;
      const int kr = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kr < a.Nk) {
        kv = kb[(long long)kr * a.kv_stride + c];
        vv = vb[(long long)kr * a.kv_stride + c];
      }
      Ks[r][c] = kv;
      Vs[r][c] = vv;
    }
    if (threadIdx.x < kBK) {
      const int kr = k0 + threadIdx.x;
      Kf[threadIdx.x] =
          kr >= a.Nk ? 2.f : ((a.key_mask != nullptr && a.key_mask[kr] == 0) ? 1.f : 0.f);
    }
    __syncthreads();

    if (qvalid) {
      float s[kBK];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < HD; ++c) acc = fmaf(q[c], Ks[j][c], acc);
        acc *= a.scale;
        const float f = Kf[j];
        acc = f == 0.f ? acc : (f == 1.f ? -1e30f : -INFINITY);
        s[j] = acc;
        tmax = fmaxf(tmax, acc);
      }
      const float m_new = fmaxf(m, tmax);  // finite: every tile has a key < Nk
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int c = 0; c < HD; ++c) o[c] *= corr;
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        const float p = expf(s[j] - m_new);
        l += p;
#pragma unroll
        for (int c = 0; c < HD; ++c) o[c] = fmaf(p, Vs[j][c], o[c]);
      }
      m = m_new;
    }
    __syncthreads();
  }

  if (qvalid) {
    const float inv = 1.f / l;
    float* dst = static_cast<float*>(a.out) + ((long long)b * a.N + qi) * a.o_stride + h * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) dst[c] = o[c] * inv;
  }
}

// ------------------------------------------------------------- bf16, Hopper
constexpr int kWarpgroups = 2;                 // consumer warpgroups of 64 queries
constexpr int kTileQ = 64 * kWarpgroups;       // queries per block
constexpr int kTileK = 128;                    // keys per tile
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kThreads = kConsumers + 32;      // and one producer warp
constexpr int kBox = 16;                       // lanes per TMA box: one wgmma k-step
constexpr int kBoxes = (kHeadDim + kBox - 1) / kBox;  // 3 at d 48
constexpr int kDPad = kBoxes * kBox;           // PV's width: d rounded up to 16
constexpr bool kSplitHeads = kHeadDim % kBox != 0;  // 4-D tensor maps (header note)
constexpr int kRowBytes = kBox * 2;            // 32: a box row, one 32-byte swizzle row
constexpr int kAcc = kTileK / 2;               // QK^T accumulators per thread
constexpr int kOut = kDPad / 2;                // PV accumulators per thread
// K/V tiles in the shared-memory ring: four where they fit beside Q, the
// output staging and 2 KB of barriers and alignment slack
constexpr int kSmemMax = 232448;
constexpr int kStageBytes = 2 * kBoxes * kTileK * kRowBytes;
constexpr int kFitStages =
    (kSmemMax - 2048 - kBoxes * kTileQ * kRowBytes - kWarpgroups * 64 * kHeadDim * 2) /
    kStageBytes;
constexpr int kStages = kFitStages < 4 ? kFitStages : 4;
static_assert(kStages >= 2, "the K/V ring needs two stages");

// Every tile is a set of kBoxes boxes of 16 lanes (32-byte rows, 32-byte
// swizzle, the layout TMA writes and wgmma reads), one box per k-step of
// QK^T and one 16-lane column block of V.
struct __align__(1024) SmemBf16 {
  __nv_bfloat16 q[kBoxes][kTileQ * kBox];
  __nv_bfloat16 k[kStages][kBoxes][kTileK * kBox];
  __nv_bfloat16 v[kStages][kBoxes][kTileK * kBox];
  __nv_bfloat16 o[kWarpgroups][64 * kHeadDim];  // row-major, for the TMA store
  uint64_t full[kStages], empty[kStages], q_full;
};

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

// The same over a (batch, row, head, lane-in-head) tensor map: lanes past
// the head's d arrive as zeros too.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int lane, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(lane), "r"(head), "r"(row),
      "r"(batch)
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
// spelled out per N by the table in the body.
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
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
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

// S = Q K^T for one warpgroup's 64 queries and one key tile: kBoxes k-steps.
__device__ __forceinline__ void issue_qk(float (&s)[kAcc], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int x = 0; x < kBoxes; ++x)
    wgmma_m64n128k16_ss(s, sw32_desc(q_addr + x * kTileQ * kRowBytes, 16, 8 * kRowBytes),
                        sw32_desc(k_addr + x * kTileK * kRowBytes, 16, 8 * kRowBytes), x);
}

// O += P V: P from registers, V (keys x kDPad lanes) with the transpose bit.
__device__ __forceinline__ void issue_pv(float (&o)[kOut], const uint32_t (&p)[kTileK / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk)
    wgmma_pv<kDPad>(o, p[kk], sw32_desc(v_addr + kk * 16 * kRowBytes, kTileK * kRowBytes,
                                        8 * kRowBytes));
}

// Online softmax of one key tile on its QK^T accumulators. This thread holds
// rows g and g+8 of its warp's 16 and, for i < kAcc/4, keys k0 + 8i + 2t and
// k0 + 8i + 2t + 1: s[4i], s[4i+1] of row g and s[4i+2], s[4i+3] of row g+8.
// With x = logit * scale * log2(e) (-1e30 for a masked key, -inf past Nk),
// s becomes 2^(x - m) with m the running row maximum, and corr the factor
// by which the earlier sums shrink. `fast`: every key of the tile is live
// and scale > 0, so the maximum is taken on the raw logits and the scale is
// folded into one FMA per exponential; the general path scales first, since
// folding -1e30 into an FMA would leave its product's rounding error (about
// 1e22) in the exponent of an all-masked row. The general path measured
// 16 % slower on full tiles at the davis_demo shape (PERF.md). The
// exponentials run in turns with the other warpgroup (`last`: this
// warpgroup's final turn).
__device__ __forceinline__ void softmax_tile(float (&s)[kAcc], float& m_a, float& m_b, float& l_a,
                                             float& l_b, float& corr_a, float& corr_b, float c,
                                             bool fast, int k0, int Nk,
                                             const uint8_t* __restrict__ key_mask, int t, int wg,
                                             bool last) {
  float mx_a = -INFINITY, mx_b = -INFINITY;
  if (fast) {
    float pa[4], pb[4];  // four partial maxima per row: short dependency chains
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pa[r] = fmaxf(s[4 * r], s[4 * r + 1]);
      pb[r] = fmaxf(s[4 * r + 2], s[4 * r + 3]);
    }
#pragma unroll
    for (int i = 4; i < kAcc / 4; ++i) {
      pa[i % 4] = fmaxf(pa[i % 4], fmaxf(s[4 * i], s[4 * i + 1]));
      pb[i % 4] = fmaxf(pb[i % 4], fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    mx_a = fmaxf(fmaxf(pa[0], pa[1]), fmaxf(pa[2], pa[3])) * c;
    mx_b = fmaxf(fmaxf(pb[0], pb[1]), fmaxf(pb[2], pb[3])) * c;
  } else {
#pragma unroll
    for (int i = 0; i < kAcc / 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + 8 * i + 2 * t + j;
        const float bias = key >= Nk ? -INFINITY
                                     : ((key_mask != nullptr && key_mask[key] == 0) ? -1e30f : 0.f);
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
  // finite: every tile holds a key below Nk, live (x) or masked (-1e30)
  const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
  corr_a = ex2(m_a - mn_a);
  corr_b = ex2(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  turn_wait(wg);
  if (fast) {
#pragma unroll
    for (int i = 0; i < kAcc; i += 4) {
      s[i] = ex2(fmaf(s[i], c, -m_a));
      s[i + 1] = ex2(fmaf(s[i + 1], c, -m_a));
      s[i + 2] = ex2(fmaf(s[i + 2], c, -m_b));
      s[i + 3] = ex2(fmaf(s[i + 3], c, -m_b));
    }
  } else {
#pragma unroll
    for (int i = 0; i < kAcc; i += 4) {
      s[i] = ex2(s[i] - m_a);
      s[i + 1] = ex2(s[i + 1] - m_a);
      s[i + 2] = ex2(s[i + 2] - m_b);
      s[i + 3] = ex2(s[i + 3] - m_b);
    }
  }
  if (wg == 0 || !last) turn_pass(wg);  // warpgroup 1 passed first, so it passes once less
  float ra[4] = {0.f, 0.f, 0.f, 0.f}, rb[4] = {0.f, 0.f, 0.f, 0.f};  // partial row sums
#pragma unroll
  for (int i = 0; i < kAcc / 4; ++i) {
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

// One block per (128-query tile, head, batch row): warps 0-7 are two
// consumer warpgroups of 64 queries each, warp 8 the producer. The producer
// loads Q once and streams K and V tiles through the ring (full/empty
// mbarriers). Each consumer warpgroup issues tile j+1's QK^T, then tile j's
// PV, and runs tile j+1's softmax while PV is on the tensor cores.
__global__ void __launch_bounds__(kThreads, 1)
    attention_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                const __grid_constant__ CUtensorMap map_o,
                                const uint8_t* __restrict__ key_mask, int N, int Nk,
                                float scale) {
  extern __shared__ uint8_t smem_raw[];
  SmemBf16& sm =
      *reinterpret_cast<SmemBf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTileQ;
  const int n_tiles = (Nk + kTileK - 1) / kTileK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kConsumers / 32);  // lane 0 of each consumer warp
    }
    mbar_init(&sm.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer: one thread issues every copy
    // box x (lanes 16x .. 16x + 15) of head h in `row`'s tile
    const auto load = [&](void* dst, const CUtensorMap* map, uint64_t* bar, int x, int row) {
      if constexpr (kSplitHeads)
        tma_load_4d(dst, map, bar, x * kBox, h, row, b);
      else
        tma_load(dst, map, bar, h * kHeadDim + x * kBox, row, b);
    };
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.q_full, kBoxes * kTileQ * kRowBytes);
      for (int x = 0; x < kBoxes; ++x) load(sm.q[x], &map_q, &sm.q_full, x, q0);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(&sm.empty[st], (j / kStages - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[st], kStageBytes);
        for (int x = 0; x < kBoxes; ++x) {
          load(sm.k[st][x], &map_k, &sm.full[st], x, j * kTileK);
          load(sm.v[st][x], &map_v, &sm.full[st], x, j * kTileK);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const float c = scale * kLog2e;
  const bool fast_ok = key_mask == nullptr && c > 0.f;
  const uint32_t q_addr = smem_u32(sm.q[0]) + wg * 64 * kRowBytes;

  float o[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) o[i] = 0.f;
  float s[kAcc];
  uint32_t p[kTileK / 16][4];
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f, corr_a, corr_b;

  if (wg == 1) turn_pass(wg);  // warpgroup 0 takes the first turn
  mbar_wait(&sm.q_full, 0);
  mbar_wait(&sm.full[0], 0);
  wgmma_fence();
  issue_qk(s, q_addr, smem_u32(sm.k[0][0]));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);
  softmax_tile(s, m_a, m_b, l_a, l_b, corr_a, corr_b, c, fast_ok && kTileK <= Nk, 0, Nk, key_mask,
               t, wg, n_tiles == 1);
  pack_p(p, s);

  for (int j = 0; j + 1 < n_tiles; ++j) {
    const int st = j % kStages, sn = (j + 1) % kStages;
    mbar_wait(&sm.full[sn], ((j + 1) / kStages) & 1);
    reg_fence(o);
    reg_fence(p);
    wgmma_fence();
    issue_qk(s, q_addr, smem_u32(sm.k[sn][0]));
    wgmma_commit();
    issue_pv(o, p, smem_u32(sm.v[st][0]));
    wgmma_commit();
    wgmma_wait<1>();  // QK^T of tile j+1 is done; PV of tile j may run on
    reg_fence(s);
    const int k0 = (j + 1) * kTileK;
    softmax_tile(s, m_a, m_b, l_a, l_b, corr_a, corr_b, c, fast_ok && k0 + kTileK <= Nk, k0, Nk,
                 key_mask, t, wg, j + 2 == n_tiles);
    wgmma_wait<0>();
    reg_fence(o);
    reg_fence(p);
    if (lane == 0) mbar_arrive(&sm.empty[st]);  // tile j's K and V are read
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
  issue_pv(o, p, smem_u32(sm.v[(n_tiles - 1) % kStages][0]));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(o);

  // normalise, stage this warpgroup's 64 x d outputs in shared memory and
  // store them with one TMA box (rows past N are dropped by the copy; PV's
  // columns past d are not staged)
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
  }
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
  __nv_bfloat16* ob = sm.o[wg] + (wl * 16 + g) * kHeadDim + 2 * t;
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
    tma_store(&map_o, sm.o[wg], h * kHeadDim, q0 + wg * 64, b);
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

cudaError_t launch_bf16(const void* q, const void* k, const void* v, const uint8_t* key_mask,
                        void* out, int B, int N, int Nk, int heads, int q_stride, int kv_stride,
                        int o_stride, float scale, cudaStream_t stream) {
  const int C = heads * kHeadDim;
  const int split = kSplitHeads ? heads : 0;  // q, k and v by head (header note)
  CUtensorMap mq, mk, mv, mo;
  if (!bf16_map(&mq, q, C, N, B, q_stride, kBox, kTileQ, CU_TENSOR_MAP_SWIZZLE_32B, split) ||
      !bf16_map(&mk, k, C, Nk, B, kv_stride, kBox, kTileK, CU_TENSOR_MAP_SWIZZLE_32B, split) ||
      !bf16_map(&mv, v, C, Nk, B, kv_stride, kBox, kTileK, CU_TENSOR_MAP_SWIZZLE_32B, split) ||
      !bf16_map(&mo, out, C, N, B, o_stride, kHeadDim, 64, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(SmemBf16)) + 1024;  // + alignment slack
  const cudaError_t e = cudaFuncSetAttribute(attention_bf16_wgmma_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kTileQ - 1) / kTileQ, heads, B);
  attention_bf16_wgmma_kernel<<<grid, kThreads, smem, stream>>>(mq, mk, mv, mo, key_mask, N, Nk,
                                                                scale);
  return cudaGetLastError();
}

}  // namespace

// Softmax attention over `heads` heads of dim d (BT_HEAD_DIM) for B batch
// rows. q: (B, N) rows of stride q_stride; k and v: (B, Nk) rows of stride
// kv_stride; out: (B, N) rows of stride o_stride. Head h reads lanes
// h*d .. h*d+d-1 of each row from the given base pointers and writes the
// same lanes of out. key_mask: (Nk,) uint8 or null. float32 (is_bf16 = 0)
// or bfloat16 (is_bf16 = 1) throughout; for bf16 every base pointer must be
// 16-byte aligned and every row stride a multiple of 8 elements (the TMA
// copies' rule). Returns cudaGetLastError() after the launch.
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
  if (is_bf16) {
    const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
    if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(out) || q_stride % 8 ||
        kv_stride % 8 || o_stride % 8)
      return (int)cudaErrorInvalidValue;
    return (int)launch_bf16(q, k, v, mask, out, B, N, Nk, heads, q_stride, kv_stride, o_stride,
                            scale, st);
  }
  const AttnArgs a{q, k, v, mask, out, N, Nk, q_stride, kv_stride, o_stride, scale};
  const dim3 grid((N + kBQ - 1) / kBQ, heads, B);
  attention_f32_kernel<kHeadDim><<<grid, kBQ, 0, st>>>(a);
  return (int)cudaGetLastError();
}
