// K1: correlation-window sampling over a whole feature pyramid, for Hopper.
//
// Replaces the TPU kernel batrack_tpu/ops/pallas_corr.py::_corr_kernel_multi.
// For every track n, frame s and level l it takes the zero-padded bilinear
// (2r+1)^2 window of fmap_l[s] centred at coords[s, n] * 2^-l, dots each
// window entry with targets[n, s, :] and scales by 1/sqrt(C). Output is
// track-major (N, S, L*(2r+1)^2), each window flattened transposed (index
// i*d + j reads x-offset i, y-offset j, the reference CorrBlock layout).
//
// What bounds it on the H100. Counting each byte once, about 88 MB move at
// the davis_demo shapes (bf16 pyramid (12, 128, 96, 128) over 4 levels, f32
// targets (2400, 12, 128) and output): 0.026 ms. But each window reads its
// (2r+2)^2 = 64 taps x 128 channels (16 KB) on its own, 115,200 windows per
// call: 1.89 GB of tap reads, 21x the bound's bytes, and windows of
// different tracks overlap at random, so no tile of the map serves many of
// them in order. The design moves those reads off the L2 where it can and
// keeps the rest in flight:
//
//   * resident levels (decided by the wrapper, ops/corr_kernel.py): a level
//     whose map of one frame fits in a block's shared memory (the coarse
//     levels: 24x32 and 12x16 at davis_demo) is loaded once per block by two
//     TMA boxes (64 channels x W x H each, 128-byte swizzle), and every
//     window of the block's chunk of tracks in that frame reads its taps
//     from shared memory. Their L2 traffic falls from about 944 MB to the
//     maps' copies, tens of MB;
//   * streamed levels (the fine ones): each window is two TMA boxes of a
//     4-D tensor map (C, W, H, S) per level, 64 channels x 8 x 8 x 1 each,
//     128-byte swizzle. TMA fills elements outside the map with zeros,
//     grid_sample's zero padding, so no tap is tested against the bounds.
//     One producer warp keeps the windows of the block's chunk in flight in
//     a ring of 12 slots (two per consumer warp) on full/empty mbarriers;
//   * the contraction runs on the tensor cores with the float32 target: A
//     is the window, 64 taps x 128 channels, loaded with ldmatrix from the
//     swizzled tile (4 row tiles x 8 k-steps of mma.sync.m16n8k16); B holds
//     the target split into three bf16 terms t = t1 + t2 + t3 (each the
//     rounding of what the ones before leave) in columns 0-2, so every
//     product is exact and the three column sums add up to the float32 dot
//     product within float32 rounding (about 5e-7 of the terms' size,
//     against 7e-3 for the single bf16 term of the mxu variant);
//   * the 2x2 bilinear blend and the 1/sqrt(C) scale run per warp from its
//     64 taps in shared memory, and each window's 49 outputs are stored by
//     consecutive lanes.
//
// With one block of six consumer warps per SM (the ring or a resident map
// takes most of the shared memory), each window's work is a chain of
// latencies, so the kernel keeps global loads and dependent products off
// it: a consumer loads the next window's coords and target while it
// contracts the current one; the producer reads the coords of 32 windows
// at once; the four 16-row tiles of a window accumulate side by side, k-step
// by k-step, with the next k-step's ldmatrix issued before this one's
// products.
//
// The 128-byte swizzle matters for ldmatrix: tap rows are 128 bytes (one
// 64-channel half of a pixel), so without it the 8 rows of one 8x8 matrix
// all start on bank 0. With it, the 16-byte chunk c of row r sits at chunk
// c ^ (r & 7), and 8 consecutive taps of a window row fall on 8 banks
// groups. Out-of-map taps of a resident level point ldmatrix at a zero row.
// Each block has one producer and six consumer warps. The numbers above are
// radius 3 (8x8 windows, the tracker's corr_radius) and C = 128; the widths
// are compile-time constants (below the options).
//
// The TPU kernel's two options are two more instantiations of this kernel,
// each with its own entry point and launch counter, on the same pipeline:
//   * the tensor-core contraction (contract="mxu", corr_sample_pyramid_mxu):
//     one target term instead of three. Column 0 of B is the target rounded
//     to bf16 (round to nearest even), columns 1-2 are zero. B has eight
//     columns in m16n8k16 either way, so it costs what the three terms do.
//     Same packed bf16 pyramid, same plan;
//   * int8 maps (fmap_dtype="int8", corr_sample_pyramid_int8; per-level
//     symmetric scale amax/127): a tap of 128 channels is 128 bytes, one
//     row of the 128-byte swizzle, so a streamed window is ONE box of a
//     uint8 tensor map (128 x 8 x 8 x 1, 8 KB) and a resident map one box
//     of H x W rows. At davis_demo levels 2-3 stay resident; level 1
//     (48x64x128 = 384 KB) still does not fit in 227 KB and is streamed.
//     The halved window is spent on less shared memory, not on more slots:
//     the ring keeps 12 slots (96 KB), so two blocks fit on an SM (12
//     consumer warps instead of 6, under 146 registers a thread). On the
//     H100 that beats one block per SM with the same ring, and a ring of 24
//     slots at one block per SM (scripts/torch_corr_ab.py --int8-layouts,
//     PERF.md). The contraction stays on the bf16 tensor cores with
//     the three-term float32 target: every int8 value is exact in bf16, so
//     A's fragments are converted in registers after ldmatrix (s8x4_bf16,
//     exact, no conversion instruction) and the products stay exact. The
//     level's scale (a device array, read in the kernel) is folded into
//     1/sqrt(C). ldmatrix moves 16-bit elements, so over int8 rows each
//     lane gets four channels' bytes; the channel order inside a k-step is
//     free (it is a sum), and A and B share this one (tig = lane % 4): one
//     ldmatrix.x4 over 16-byte chunks 2p and 2p+1 feeds k-steps 2p + j
//     (j = 0, 1), whose logical k 2tig+e is channel 32p + 4tig + 2j + e and
//     k 2tig+8+e channel 32p + 16 + 4tig + 2j + e (e = 0, 1).
//     What bounds it: the conversion, 11 instructions per four values,
//     adds about 700 instructions to a window's 1100 or so, and a window's
//     work is bound by instruction throughput once its bytes are halved, so
//     int8 maps are slower here than bf16 ones (PERF.md).
//
// Widths. The radius r and the channel count C are compile-time constants,
// BT_CORR_RADIUS and BT_CORR_C (defaults 3 and 128, the tracker's: the JAX
// tracker pins corr_radius 3 and latent_dim 128), and ops/cuda_build.py
// builds one library per (r, C) that a caller asks for: r 1 to 4 and C 64,
// 128 or 256, the widths the Pallas function takes as arguments. Every size
// follows them: the window side 2r + 2 and its (2r + 2)^2 taps, padded to
// whole 16-row tiles (16, 48, 64 and 112 rows for r 1-4; a padding row
// gives a tap that no output reads); the (2r + 1)^2 outputs; the 128-byte
// sections of a tap, 2C/128 for bf16 and C/128 (at least one) for int8;
// the k-steps of the product, C/16. A window's box keeps its place in a
// slot padded to whole tiles, so every box starts 1024-aligned for the
// swizzle. The ring keeps 12 slots where they fit in a block's shared
// memory, else one slot per consumer warp, and for the widest windows
// (bf16, r 4, C 256: 56 KB) three consumer warps of one slot each. int8
// maps at C = 64 fill half a 128-byte row: their boxes stay 128 channels
// wide and TMA's out-of-bounds fill gives zeros in channels 64-127, which
// the product never loads. Two blocks share an SM (the launch bound) only
// where the int8 ring leaves room for them. The numbers above the options
// are those of r 3 and C 128.

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

#ifndef BT_CORR_RADIUS
#define BT_CORR_RADIUS 3  // the tracker's corr_radius
#endif
#ifndef BT_CORR_C
#define BT_CORR_C 128  // channels, the tracker's latent width
#endif

constexpr int kMaxLevels = 8;
constexpr int kC = BT_CORR_C;
constexpr int kRadius = BT_CORR_RADIUS;
static_assert(kRadius >= 1 && kRadius <= 4, "radius: 1 to 4");
static_assert(kC == 64 || kC == 128 || kC == 256, "channels: 64, 128 or 256");

constexpr int kD = 2 * kRadius + 2;        // 8 integer taps a side at r 3
constexpr int kTaps = kD * kD;             // 64 at r 3: four 16-row tiles
constexpr int kTiles = (kTaps + 15) / 16;  // 16-row tiles of a window's taps
constexpr int kTapRows = 16 * kTiles;      // the taps padded to whole tiles
constexpr int kOut = (kD - 1) * (kD - 1);  // 49 outputs per window at r 3
constexpr int kSteps = kC / 16;            // 16-channel k-steps of a window's product
// A row of the 128-byte swizzle: a tap's 64-channel part in bf16, its 128
// channels in int8. A window's box of rows is 8 KB at r 3 (kBoxBytes, what
// TMA writes), in a slot's place of whole tiles (kBoxStride); bf16
// windows at C = 128 take two boxes.
constexpr int kRowBytes = 128;
constexpr int kBoxBytes = kTaps * kRowBytes;
constexpr int kBoxStride = kTapRows * kRowBytes;
constexpr int kSmemLimit = 232448;  // a block's most dynamic shared memory
constexpr int kSmemPerSm = 233472;  // an SM's, shared by its blocks (1 KB each reserved)
constexpr int kMaxSlots = 12;       // ring slots: two per consumer warp where they fit
// beside the map or ring: the consumers' taps, the zero row, the barriers
// and the slack that aligns the base to 1024 bytes, rounded up to 1 KB
// (corr_extra_bytes() gives it to the wrapper's residency choice): 3072 at r 3
constexpr int kExtraBytes =
    (1024 + 6 * kTapRows * 4 + kRowBytes + (2 * kMaxSlots + 1) * 8 + 1023) / 1024 * 1024;

// Sections of 128-byte rows per tap: bf16 taps are C/64 of 64 channels,
// int8 taps C/128 of 128 (one at C = 64, half of it zero fill).
__host__ __device__ constexpr int sections(bool int8) {
  return int8 ? (kC + 127) / 128 : kC / 64;
}

// A block of either map type: its consumer warps and ring (see Widths).
template <bool kInt8>
struct Layout {
  static constexpr int kWindowBytes = sections(kInt8) * kBoxStride;  // one ring slot
  static constexpr int kWarps = 6 * kWindowBytes + kExtraBytes <= kSmemLimit ? 6 : 3;
  static constexpr int kSlotsPerWarp =
      kMaxSlots * kWindowBytes + kExtraBytes <= kSmemLimit ? kMaxSlots / kWarps : 1;
  static constexpr int kSlots = kWarps * kSlotsPerWarp;
  static constexpr int kRing = kSlots * kWindowBytes;
  static constexpr int kThreads = 32 * (kWarps + 1);
  static constexpr int kMinBlocks =
      kInt8 && 2 * (kRing + kExtraBytes + 1024) <= kSmemPerSm ? 2 : 1;
  static_assert(kRing + kExtraBytes <= kSmemLimit, "the ring does not fit");
  static_assert(1024 + kWarps * kTapRows * 4 + kRowBytes + (2 * kSlots + 1) * 8 <= kExtraBytes,
                "shared-memory reserve");
};

// A level's map of one frame in shared memory, per section: H*W rows of 128
// bytes, each section starting 1024-aligned.
__host__ __device__ constexpr int resident_section_bytes(int h, int w) {
  return (h * w * kRowBytes + 1023) / 1024 * 1024;
}

// The launch-independent part: one tensor map per level (streamed: box
// 128 bytes x 8 x 8 x 1; resident: 128 bytes x W x H x 1) and the level
// shapes. Encoded once per pyramid (corr_sample_plan) and copied into every
// launch.
struct alignas(64) CorrPlan {
  CUtensorMap map[kMaxLevels];
  int h[kMaxLevels], w[kMaxLevels], resident[kMaxLevels];
  int L, S;
  int int8;    // the maps' type: 0 bf16, 1 int8
  int region;  // bytes of shared memory for the resident map or the ring
};

// Blocks of one level: resident levels take S x chunks blocks (frame, chunk
// of res_chunk tracks), streamed ones ceil(N*S / stream_chunk) blocks of
// (frame-major) windows.
struct Segment {
  int level, resident, first_block, chunks;
};

struct alignas(64) CorrArgs {
  CorrPlan plan;
  Segment seg[kMaxLevels];  // resident levels first: their blocks are the longest
  const float* targets;     // (N, S, C)
  const float* coords;      // (S, N, 2)
  const float* scales;      // int8 maps: (L,) dequantisation scales; else null
  float* out;               // (N, S, L * kOut)
  int N, res_chunk, stream_chunk;
  float inv_sqrt_c;
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

// One box of a (channel, x, y, frame) tensor map into shared memory,
// completing on `bar`; elements outside the map arrive as zeros, and the
// barrier is credited with the whole box.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c, int x, int y, int s) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(x), "r"(y), "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// D (16 x 8, f32) += A (16 x 16, bf16, row-major) B (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Where a window starts in its level and its bilinear weights.
struct Win {
  int x0, y0;
  float dx, dy;
};

__device__ __forceinline__ Win window_at(const float* coords, int N, int s, int n, int l) {
  const float sc = ldexpf(1.0f, -l);
  const float2 c = *reinterpret_cast<const float2*>(coords + ((long long)s * N + n) * 2);
  const float cx = c.x * sc, cy = c.y * sc;
  const float fx = floorf(cx), fy = floorf(cy);
  Win w;
  w.dx = cx - fx;  // weights from the unclamped coords
  w.dy = cy - fy;
  w.x0 = (int)fminf(fmaxf(fx, -1e6f), 1e6f) - kRadius;
  w.y0 = (int)fminf(fmaxf(fy, -1e6f), 1e6f) - kRadius;
  return w;
}

// Term g (0, 1 or 2) of the three-term bf16 split of a pair of floats:
// t1 = bf16(v), t2 = bf16(v - t1), t3 = bf16(v - t1 - t2); each difference
// is exact in float32.
__device__ __forceinline__ uint32_t split_term(float2 v, int g) {
  const __nv_bfloat162 t1 = __floats2bfloat162_rn(v.x, v.y);
  const float2 f1 = __bfloat1622float2(t1);
  const float2 r1 = make_float2(v.x - f1.x, v.y - f1.y);
  const __nv_bfloat162 t2 = __floats2bfloat162_rn(r1.x, r1.y);
  const float2 f2 = __bfloat1622float2(t2);
  const __nv_bfloat162 t3 = __floats2bfloat162_rn(r1.x - f2.x, r1.y - f2.y);
  const __nv_bfloat162 t = g == 0 ? t1 : (g == 1 ? t2 : t3);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// This lane's share of a target row, loaded one window ahead of its use:
// lanes g = lane / 4 < kTerms hold, for every k-step ks, the channels of
// logical k 2tig..+1 and 2tig+8..+9 (tig = lane % 4), the other lanes
// zeros. bf16 maps: channels 16ks + 2tig..+1 and 16ks + 8 + 2tig..+1; int8
// maps: the permutation of the header note.
struct TargetPart {
  float2 v[kSteps][2];
};

template <int kTerms, bool kInt8>
__device__ __forceinline__ TargetPart load_target(const float* __restrict__ target, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  TargetPart t;
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const int c0 = kInt8 ? 32 * (ks >> 1) + 4 * tig + 2 * (ks & 1) : 16 * ks + 2 * tig;
    const int c1 = kInt8 ? c0 + 16 : c0 + 8;
    t.v[ks][0] = t.v[ks][1] = make_float2(0.f, 0.f);
    if (g < kTerms) {
      t.v[ks][0] = *reinterpret_cast<const float2*>(target + c0);
      t.v[ks][1] = *reinterpret_cast<const float2*>(target + c1);
    }
  }
  return t;
}

// The A fragments of k-step ks for the kTiles row tiles: ldmatrix.x4, lane L
// giving the address of row L % 8 of matrix L / 8 (rows 0-7 | 8-15 of the
// tile, then 16-byte chunk 2(ks % 4) | 2(ks % 4) + 1 of the row), which
// yields the fragment in order. Row r of tile m is tap 16m + r. bf16 maps:
// k-step ks reads channels 16ks..16ks+15, section ks / 4. int8 maps: called
// with ks = p < kSteps / 2, it reads the chunks of k-steps 2p and 2p + 1,
// section p / 4. base[m],
// sw[m] and hs[m] are this lane's row address in tile m, its swizzle
// (row & 7) and the distance to the row's second half (bf16; 0 for the
// zero row).
__device__ __forceinline__ void load_kstep(uint32_t (&a)[kTiles][4],
                                           const uint32_t (&base)[kTiles], const int (&sw)[kTiles],
                                           const uint32_t (&hs)[kTiles], int ks, int lane) {
  const int chunk = 2 * (ks & 3) + (lane >> 4);
#pragma unroll
  for (int m = 0; m < kTiles; ++m)
    ldmatrix_x4(a[m], base[m] + (ks >> 2) * hs[m] + ((chunk ^ sw[m]) << 4));
}

// Four int8 values (one 32-bit word, lowest byte first) as two bf16 pairs,
// exactly: q + 128 placed in the low byte of the float 2^23 gives
// 2^23 + q + 128, less 2^23 + 128 leaves q, whose top 16 bits are its bf16.
__device__ __forceinline__ void s8x4_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t x = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 + i)) - 8388736.0f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// The kTaps taps of one window, each the dot product of its C channels with
// the target's kTerms bf16 terms, into taps[a * kD + b] (y offset a, x
// offset b; the padding rows past kTaps get values no output reads). mma.sync.m16n8k16 fragments (g = lane / 4, tig = lane % 4): B
// registers {k 2tig..+1, col g}, {k 2tig+8..+9, col g}; D {row g, cols 2tig,
// 2tig+1}, {row g+8, same cols}; lanes g < kTerms hold term g of the
// target. The four row tiles accumulate side by side, k-step by k-step, with
// the next k-step's fragments loaded before this one's products: four
// independent chains of eight products instead of one of 32. int8 maps load
// two k-steps' fragments at a time and convert them (s8x4_bf16).
template <bool kInt8>
__device__ __forceinline__ void window_taps(float* taps, const uint32_t (&base)[kTiles],
                                            const int (&sw)[kTiles], const uint32_t (&hs)[kTiles],
                                            const TargetPart& t, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  uint32_t b[kSteps][2];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    b[ks][0] = split_term(t.v[ks][0], g);
    b[ks][1] = split_term(t.v[ks][1], g);
  }
  float c[kTiles][4];
#pragma unroll
  for (int m = 0; m < kTiles; ++m) c[m][0] = c[m][1] = c[m][2] = c[m][3] = 0.f;
  constexpr int kLoads = kInt8 ? kSteps / 2 : kSteps;
  uint32_t a[2][kTiles][4];
  load_kstep(a[0], base, sw, hs, 0, lane);
#pragma unroll
  for (int ks = 0; ks < kLoads; ++ks) {
    if (ks + 1 < kLoads) load_kstep(a[(ks + 1) & 1], base, sw, hs, ks + 1, lane);
#pragma unroll
    for (int m = 0; m < kTiles; ++m) {
      const uint32_t(&f)[4] = a[ks & 1][m];
      if constexpr (kInt8) {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) s8x4_bf16(f[r], lo[r], hi[r]);
        mma_bf16_16816(c[m], lo[0], lo[1], lo[2], lo[3], b[2 * ks][0], b[2 * ks][1]);
        mma_bf16_16816(c[m], hi[0], hi[1], hi[2], hi[3], b[2 * ks + 1][0], b[2 * ks + 1][1]);
      } else {
        mma_bf16_16816(c[m], f[0], f[1], f[2], f[3], b[ks][0], b[ks][1]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kTiles; ++m) {
    // columns 0 and 1 are on lane tig = 0, column 2 on the lane after it
    float v0 = c[m][0] + c[m][1], v1 = c[m][2] + c[m][3];
    v0 += __shfl_down_sync(0xffffffffu, v0, 1);
    v1 += __shfl_down_sync(0xffffffffu, v1, 1);
    if (tig == 0) {
      taps[16 * m + g] = v0;
      taps[16 * m + g + 8] = v1;
    }
  }
}

// The 2x2 blend of a window's kD x kD taps (shared memory) into its
// (kD - 1)^2 outputs, scaled, in the transposed flatten.
__device__ __forceinline__ void blend_store(const float* taps, float dx, float dy, float scale,
                                            float* o, int lane) {
  const float w00 = (1.f - dy) * (1.f - dx), w01 = (1.f - dy) * dx;
  const float w10 = dy * (1.f - dx), w11 = dy * dx;
  for (int k = lane; k < kOut; k += 32) {
    const int i = k / (kD - 1);  // x offset
    const int j = k % (kD - 1);  // y offset
    const float v = w00 * taps[j * kD + i] + w01 * taps[j * kD + i + 1] +
                    w10 * taps[(j + 1) * kD + i] + w11 * taps[(j + 1) * kD + i + 1];
    o[k] = v * scale;
  }
}

// One block: warps 0-5 consume windows (0-2 in the widest layout), the
// warp after them is the producer (its lane 0 issues every TMA copy). A
// resident block loads its frame's map once and its consumers take the
// tracks of its chunk in turn; a streamed block's producer walks its chunk
// of windows in order, window j into slot (j % 6) * 2 + (j / 6) % 2 (in
// general (j % warps) * slots per warp + (j / warps) % slots per warp), so
// each slot is always read by the same consumer warp, in order. kTerms:
// bf16 terms of the target (3, or 1 for the mxu option); kInt8: int8 maps
// (two blocks fit on an SM at the tracker's widths).
template <int kTerms, bool kInt8>
__global__ void __launch_bounds__(Layout<kInt8>::kThreads, Layout<kInt8>::kMinBlocks)
    corr_sample_kernel(const __grid_constant__ CorrArgs a) {
  using L = Layout<kInt8>;
  constexpr int kSections = sections(kInt8);
  constexpr int kLanes = kInt8 ? kRowBytes : kRowBytes / 2;  // channels of a section
  constexpr int kConsumerWarps = L::kWarps, kSlotsPerWarp = L::kSlotsPerWarp;
  constexpr int kSlots = L::kSlots, kWindowBytes = L::kWindowBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const CorrPlan& p = a.plan;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* taps = reinterpret_cast<float*>(smem + p.region) + warp * kTapRows;
  uint8_t* zero = smem + p.region + kConsumerWarps * kTapRows * 4;  // one 128-byte zero row
  uint64_t* full = reinterpret_cast<uint64_t*>(zero + kRowBytes);
  uint64_t* empty = full + kSlots;
  uint64_t* map_full = empty + kSlots;

  int si = 0;
  for (int i = 1; i < p.L; ++i)
    if ((int)blockIdx.x >= a.seg[i].first_block) si = i;
  const Segment sg = a.seg[si];
  const int l = sg.level, blk = (int)blockIdx.x - sg.first_block;
  const int N = a.N, S = p.S;
  const float scale = kInt8 ? a.scales[l] * a.inv_sqrt_c : a.inv_sqrt_c;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);  // lane 0 of the slot's consumer warp
    }
    mbar_init(map_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (threadIdx.x < kRowBytes / 4) reinterpret_cast<uint32_t*>(zero)[threadIdx.x] = 0u;
  __syncthreads();

  if (sg.resident) {
    const int s = blk / sg.chunks, n0 = (blk % sg.chunks) * a.res_chunk;
    const int n1 = min(N, n0 + a.res_chunk);
    const int H = p.h[l], W = p.w[l];
    const uint32_t section = resident_section_bytes(H, W);
    if (warp == kConsumerWarps) {
      if (lane == 0) {
        mbar_arrive_expect_tx(map_full, kSections * H * W * kRowBytes);
        for (int k = 0; k < kSections; ++k)
          tma_load_4d(smem + k * section, &p.map[l], map_full, kLanes * k, 0, 0, s);
      }
      return;
    }
    int n = n0 + warp;
    if (n >= n1) return;
    // each window's coords and target are loaded while the window before it
    // is contracted (the last window's are loaded twice)
    const float* tgt = a.targets + (long long)s * kC;  // track n's row at + n * S * kC
    Win w = window_at(a.coords, N, s, n, l);
    TargetPart t = load_target<kTerms, kInt8>(tgt + (long long)n * S * kC, lane);
    mbar_wait(map_full, 0);
    const uint32_t map = smem_u32(smem), zrow = smem_u32(zero);
    const int rowsel = (lane & 7) + 8 * ((lane >> 3) & 1);  // this lane's row of a tile
    for (; n < n1; n += kConsumerWarps) {
      const int nn = min(n + kConsumerWarps, n1 - 1);
      const Win wn = window_at(a.coords, N, s, nn, l);
      const TargetPart tn = load_target<kTerms, kInt8>(tgt + (long long)nn * S * kC, lane);
      uint32_t base[kTiles], hs[kTiles];
      int sw[kTiles];
#pragma unroll
      for (int m = 0; m < kTiles; ++m) {
        const int tap = 16 * m + rowsel;  // (y, x) = (tap / kD, tap % kD) of the window
        const int yy = w.y0 + tap / kD, xx = w.x0 + tap % kD;
        const bool in = (kTaps == kTapRows || tap < kTaps) && yy >= 0 && yy < H && xx >= 0 &&
                        xx < W;
        const int row = in ? yy * W + xx : 0;
        base[m] = in ? map + row * kRowBytes : zrow;
        sw[m] = row & 7;
        hs[m] = in ? section : 0u;
      }
      window_taps<kInt8>(taps, base, sw, hs, t, lane);
      __syncwarp();
      blend_store(taps, w.dx, w.dy, scale, a.out + (((long long)n * S + s) * p.L + l) * kOut,
                  lane);
      __syncwarp();
      w = wn;
      t = tn;
    }
    return;
  }

  const long long i0 = (long long)blk * a.stream_chunk;
  const int cnt = (int)min((long long)a.stream_chunk, (long long)N * S - i0);
  if (warp == kConsumerWarps) {
    // the warp reads the coords of 32 windows at once; lane 0 issues their
    // copies in order, each after its slot's previous window is read
    for (int j0 = 0; j0 < cnt; j0 += 32) {
      int xj = 0, yj = 0, sj = 0;
      if (j0 + lane < cnt) {
        const long long i = i0 + j0 + lane;
        sj = (int)(i / N);
        const Win w = window_at(a.coords, N, sj, (int)(i % N), l);
        xj = w.x0;
        yj = w.y0;
      }
      const int m = min(32, cnt - j0);
      for (int k = 0; k < m; ++k) {
        const int xk = __shfl_sync(0xffffffffu, xj, k), yk = __shfl_sync(0xffffffffu, yj, k);
        const int sk = __shfl_sync(0xffffffffu, sj, k);
        const int j = j0 + k, cw = j % kConsumerWarps, r = j / kConsumerWarps;
        const int slot = cw * kSlotsPerWarp + r % kSlotsPerWarp;
        if (r >= kSlotsPerWarp) mbar_wait(&empty[slot], (r / kSlotsPerWarp - 1) & 1);
        if (lane == 0) {
          uint8_t* dst = smem + slot * kWindowBytes;
          mbar_arrive_expect_tx(&full[slot], kSections * kBoxBytes);
          for (int q = 0; q < kSections; ++q)
            tma_load_4d(dst + q * kBoxStride, &p.map[l], &full[slot], kLanes * q, xk, yk, sk);
        }
      }
    }
    return;
  }
  const int rowsel = (lane & 7) + 8 * ((lane >> 3) & 1);  // this lane's row of a tile
  uint32_t hs[kTiles];
  int sw[kTiles];
#pragma unroll
  for (int m = 0; m < kTiles; ++m) {
    sw[m] = lane & 7;
    hs[m] = kBoxStride;
  }
  int j = warp;
  if (j >= cnt) return;
  // as in a resident block, the next window's coords and target are loaded
  // while this one is contracted
  long long i = i0 + j;
  int s = (int)(i / N), n = (int)(i % N);
  Win w = window_at(a.coords, N, s, n, l);
  TargetPart t = load_target<kTerms, kInt8>(a.targets + ((long long)n * S + s) * kC, lane);
  for (int r = 0; j < cnt; j += kConsumerWarps, ++r) {
    i = i0 + min(j + kConsumerWarps, cnt - 1);
    const int sn = (int)(i / N), nn = (int)(i % N);
    const Win wn = window_at(a.coords, N, sn, nn, l);
    const TargetPart tn =
        load_target<kTerms, kInt8>(a.targets + ((long long)nn * S + sn) * kC, lane);
    const int slot = warp * kSlotsPerWarp + r % kSlotsPerWarp;
    uint32_t base[kTiles];
#pragma unroll
    for (int m = 0; m < kTiles; ++m)
      base[m] = smem_u32(smem + slot * kWindowBytes) + (16 * m + rowsel) * kRowBytes;
    mbar_wait(&full[slot], (r / kSlotsPerWarp) & 1);
    window_taps<kInt8>(taps, base, sw, hs, t, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);  // the slot's taps are read
    blend_store(taps, w.dx, w.dy, scale, a.out + (((long long)n * S + s) * p.L + l) * kOut,
                lane);
    __syncwarp();
    s = sn;
    n = nn;
    w = wn;
    t = tn;
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

// Up to the largest dynamic shared memory for an instantiation, and for
// int8 maps the carveout that lets two blocks share an SM.
template <int kTerms, bool kInt8>
cudaError_t allow_shared_memory() {
  cudaError_t e = cudaFuncSetAttribute(corr_sample_kernel<kTerms, kInt8>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (kInt8 && e == cudaSuccess)
    e = cudaFuncSetAttribute(corr_sample_kernel<kTerms, kInt8>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

// One launch for every level of a planned pyramid (see the entry points).
template <int kTerms, bool kInt8>
int launch(const void* plan, const void* targets, const void* coords, const void* scales,
           void* out, int N, int radius, int res_chunk, int stream_chunk, void* stream) {
  if (radius != kRadius || N < 0 || res_chunk < 1 || stream_chunk < 1)
    return (int)cudaErrorInvalidValue;
  CorrArgs a;
  memcpy(&a.plan, plan, sizeof(CorrPlan));
  const CorrPlan& p = a.plan;
  if (p.int8 != (int)kInt8 || (kInt8 && scales == nullptr)) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  long long blocks = 0;
  int ns = 0;
  for (int pass = 1; pass >= 0; --pass) {  // resident levels first
    for (int l = 0; l < p.L; ++l) {
      if (p.resident[l] != pass) continue;
      Segment& sg = a.seg[ns++];
      sg.level = l;
      sg.resident = pass;
      sg.first_block = (int)blocks;
      sg.chunks = (N + res_chunk - 1) / res_chunk;
      blocks += pass ? (long long)p.S * sg.chunks
                     : ((long long)N * p.S + stream_chunk - 1) / stream_chunk;
    }
  }
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  a.targets = static_cast<const float*>(targets);
  a.coords = static_cast<const float*>(coords);
  a.scales = static_cast<const float*>(scales);
  a.out = static_cast<float*>(out);
  a.N = N;
  a.res_chunk = res_chunk;
  a.stream_chunk = stream_chunk;
  a.inv_sqrt_c = 1.0f / sqrtf((float)kC);
  corr_sample_kernel<kTerms, kInt8><<<(unsigned)blocks, Layout<kInt8>::kThreads,
                                      p.region + kExtraBytes,
                                      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Size in bytes of the host buffer corr_sample_plan fills.
extern "C" int corr_plan_bytes() { return (int)sizeof(CorrPlan); }

// Shared memory the kernel keeps beside a resident map or the ring
// (kExtraBytes): a level is resident only if its map fits beside it.
extern "C" int corr_extra_bytes() { return kExtraBytes; }

// Encode the tensor maps of a packed pyramid into `plan` (a host buffer of
// corr_plan_bytes()), once per pyramid: pyr holds the levels concatenated,
// bf16 (int8 = 0) or int8 (int8 = 1), level l (S, H_l, W_l, C)
// channels-last at element offset level_off[l]; resident[l] != 0 keeps
// level l's map of a frame in shared memory (the wrapper decides; its map
// must fit beside kExtraBytes and measure at most 256 x 256). C must be the
// build's BT_CORR_C. Returns a cudaError_t.
extern "C" int corr_sample_plan(void* plan, const void* pyr, int S, int C, int L,
                                const long long* level_off, const int* level_h,
                                const int* level_w, const int* resident, int int8) {
  if (L < 1 || L > kMaxLevels || C != kC || S < 1 || (int8 != 0 && int8 != 1))
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorInvalidValue;
  const int elem = int8 ? 1 : 2, nsec = sections(int8 != 0);
  CorrPlan p;
  memset(&p, 0, sizeof(p));
  p.L = L;
  p.S = S;
  p.int8 = int8;
  int region = 0;
  for (int l = 0; l < L; ++l) {
    const int h = level_h[l], w = level_w[l];
    const uint8_t* base = static_cast<const uint8_t*>(pyr) + level_off[l] * elem;
    if (h < 1 || w < 1 || reinterpret_cast<uintptr_t>(base) % 16)
      return (int)cudaErrorInvalidValue;
    p.h[l] = h;
    p.w[l] = w;
    p.resident[l] = resident[l] != 0;
    const cuuint64_t dims[4] = {(cuuint64_t)kC, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)S};
    const cuuint64_t strides[3] = {(cuuint64_t)kC * elem, (cuuint64_t)kC * elem * w,
                                   (cuuint64_t)kC * elem * w * h};
    // a box row is 128 bytes: 64 bf16 channels or 128 int8 ones
    cuuint32_t box[4] = {(cuuint32_t)(kRowBytes / elem), (cuuint32_t)kD, (cuuint32_t)kD, 1};
    int need = int8 ? Layout<true>::kRing : Layout<false>::kRing;  // the ring
    if (p.resident[l]) {
      if (h > 256 || w > 256) return (int)cudaErrorInvalidValue;
      box[1] = (cuuint32_t)w;
      box[2] = (cuuint32_t)h;
      need = nsec * resident_section_bytes(h, w);
    }
    region = region > need ? region : need;
    const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
    if (encode(&p.map[l], int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
               4, const_cast<uint8_t*>(base), dims, strides, box, elem_strides,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  if (region + kExtraBytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  p.region = region;
  memcpy(plan, &p, sizeof(p));
  cudaError_t e = int8 ? allow_shared_memory<3, true>() : allow_shared_memory<3, false>();
  if (e == cudaSuccess && !int8) e = allow_shared_memory<1, false>();
  return (int)e;
}

// Blocks of the planned pyramid's kernel that fit on one SM at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on an error.
// contract: 0 the float32 target (three terms), 1 the mxu option.
extern "C" int corr_sample_blocks_per_sm(const void* plan, int contract) {
  CorrPlan p;
  memcpy(&p, plan, sizeof(CorrPlan));
  const size_t smem = (size_t)p.region + kExtraBytes;
  int n = -1;
  const cudaError_t e =
      p.int8 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, corr_sample_kernel<3, true>,
                                                             Layout<true>::kThreads, smem)
      : contract ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, corr_sample_kernel<1, false>, Layout<false>::kThreads, smem)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, corr_sample_kernel<3, false>, Layout<false>::kThreads, smem);
  return e == cudaSuccess ? n : -1;
}

// One launch for every level of a pyramid planned from bf16 maps, with the
// float32 target (the tracker's): targets f32 (N, S, C); coords f32
// (S, N, 2) at level-0 resolution; out f32 (N, S, L*(2r+1)^2). radius must
// be the build's BT_CORR_RADIUS.
// res_chunk: tracks per block of a resident level; stream_chunk: windows
// per block of a streamed level. Returns cudaGetLastError() after the
// launch.
extern "C" int corr_sample_pyramid(const void* plan, const void* targets, const void* coords,
                                   void* out, int N, int radius, int res_chunk,
                                   int stream_chunk, void* stream) {
  return launch<3, false>(plan, targets, coords, nullptr, out, N, radius, res_chunk,
                          stream_chunk, stream);
}

// The same on bf16 maps with the target rounded to bf16 (contract="mxu").
extern "C" int corr_sample_pyramid_mxu(const void* plan, const void* targets,
                                       const void* coords, void* out, int N, int radius,
                                       int res_chunk, int stream_chunk, void* stream) {
  return launch<1, false>(plan, targets, coords, nullptr, out, N, radius, res_chunk,
                          stream_chunk, stream);
}

// The same on a pyramid planned from int8 maps, with the float32 target:
// scales is a device array (L,) f32, level l's dequantisation scale,
// written on the same stream before.
extern "C" int corr_sample_pyramid_int8(const void* plan, const void* targets,
                                        const void* coords, void* out, const void* scales,
                                        int N, int radius, int res_chunk, int stream_chunk,
                                        void* stream) {
  return launch<3, true>(plan, targets, coords, scales, out, N, radius, res_chunk,
                         stream_chunk, stream);
}
