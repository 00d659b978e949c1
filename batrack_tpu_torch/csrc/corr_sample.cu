// K1: correlation-window sampling over a whole feature pyramid, for Hopper.
//
// Replaces the TPU kernel batrack_tpu/ops/pallas_corr.py::_corr_kernel_multi.
// For every track n, frame s and level l it takes the zero-padded bilinear
// (2r+1)^2 window of fmap_l[s] centred at coords[s, n] * 2^-l, dots each
// window entry with targets[n, s, :] and scales by 1/sqrt(C). Output is
// track-major (N, S, L*(2r+1)^2), each window flattened transposed (index
// i*d + j reads x-offset i, y-offset j, the reference CorrBlock layout).
//
// Bound on the H100: about 88 MB moved (bf16 pyramid, f32 targets and
// output) against about 1.9 GFLOP of f32 FMA at the davis_demo shapes, so
// memory and the f32 pipes are close to even (~0.03 ms). Design: one warp
// per (track, frame, level); each lane holds 4 of the C = 128 channels of
// the target in registers (128 is the tracker's latent width, the one C the
// kernel takes), so each of the (2r+2)^2 integer taps is one coalesced
// 256-byte bf16 read of the channels-last pyramid, followed by a warp
// reduction; the 2x2 bilinear blend runs from shared memory after.
// All levels go in one launch: unlike the TPU's VMEM, nothing here forces
// level 0 into its own call. Out-of-map taps are zero and skip their read.
//
// The TPU kernel's two options are two more kernels beside this one, each
// with its own entry point, so the bf16 kernel above carries no branch for
// them:
//   * int8 maps (fmap_dtype="int8", per-level symmetric scale amax/127):
//     the same warp per (track, frame, level); each lane reads a char4 of
//     the tap, 128 bytes per tap instead of 256, and the level's scale is
//     read from device memory and folded into 1/sqrt(C). The bytes fall
//     from about 88 MB to about 63 MB at the davis_demo shapes.
//   * the tensor-core contraction (contract="mxu"): the window's (2r+2)^2
//     = 64 taps x 128 channels are the A operand of mma.sync.m16n8k16 (bf16,
//     f32 accumulate), the target rounded to bf16 is column 0 of B (n padded
//     to 8 with zeros): 4 row tiles x 8 k-steps per window, one column of
//     eight useful. The channel order inside a k-step is free (it is a sum),
//     so each lane loads 16 contiguous bytes of a tap row and A and B take
//     the same permutation. Out-of-map taps enter the product as zero rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;
constexpr int kC = 128;  // channels: 4 per lane

struct Levels {
  long long off[kMaxLevels];  // element offset of level l in the flat buffer
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__global__ void corr_sample_kernel(const __nv_bfloat16* __restrict__ pyr,
                                   const float* __restrict__ targets,
                                   const float* __restrict__ coords,
                                   float* __restrict__ out, int N, int S,
                                   int L, int radius, Levels lv,
                                   float inv_sqrt_c) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long item = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (item >= (long long)N * S * L) return;  // warp-uniform exit
  const int l = (int)(item % L);
  const long long ns = item / L;
  const int s = (int)(ns % S);
  const long long n = ns / S;
  const int D = 2 * radius + 2;
  const int d = 2 * radius + 1;
  float* taps = smem + warp * D * D;

  // targets[n, s, :] of (N, S, C)
  const float4 t = *reinterpret_cast<const float4*>(targets + ns * kC + lane * 4);

  const float sc = ldexpf(1.0f, -l);
  const float cx = coords[((long long)s * N + n) * 2 + 0] * sc;
  const float cy = coords[((long long)s * N + n) * 2 + 1] * sc;
  const float fx = floorf(cx), fy = floorf(cy);
  const float dx = cx - fx, dy = cy - fy;  // weights from the unclamped coords
  const int x0 = (int)fminf(fmaxf(fx, -1e6f), 1e6f) - radius;
  const int y0 = (int)fminf(fmaxf(fy, -1e6f), 1e6f) - radius;
  const int H = lv.h[l], W = lv.w[l];
  const __nv_bfloat16* fm = pyr + lv.off[l] + (long long)s * H * W * kC;

  for (int a = 0; a < D; ++a) {
    const int yy = y0 + a;
    for (int b = 0; b < D; ++b) {
      const int xx = x0 + b;
      if (yy < 0 || yy >= H || xx < 0 || xx >= W) {  // warp-uniform
        if (lane == 0) taps[a * D + b] = 0.f;
        continue;
      }
      const uint2 raw = *reinterpret_cast<const uint2*>(
          fm + ((long long)yy * W + xx) * kC + lane * 4);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      float acc = lo.x * t.x;
      acc = fmaf(lo.y, t.y, acc);
      acc = fmaf(hi.x, t.z, acc);
      acc = fmaf(hi.y, t.w, acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) taps[a * D + b] = acc;
    }
  }
  __syncwarp();

  float* o = out + item * (d * d);  // (N, S, L, d*d) == (N, S, L*d*d)
  const float w00 = (1.f - dy) * (1.f - dx), w01 = (1.f - dy) * dx;
  const float w10 = dy * (1.f - dx), w11 = dy * dx;
  for (int k = lane; k < d * d; k += 32) {
    const int i = k / d;  // x offset
    const int j = k % d;  // y offset
    const float v = w00 * taps[j * D + i] + w01 * taps[j * D + i + 1] +
                    w10 * taps[(j + 1) * D + i] + w11 * taps[(j + 1) * D + i + 1];
    o[k] = v * inv_sqrt_c;
  }
}

// ---------------------------------------------------------------- variants
// One (track, frame, level) item of the two variant kernels: where its
// window starts in the level's map and the bilinear weights.
struct Window {
  long long ns;  // n * S + s: the row of targets and of out / L
  const void* level;  // the level's (H, W, C) map of frame s (bf16 or int8)
  int H, W, x0, y0, l;
  float dx, dy;
};

template <typename T>
__device__ __forceinline__ Window locate(const T* pyr, long long item, const float* coords,
                                         int N, int S, int L, int radius, const Levels& lv) {
  Window w;
  w.l = (int)(item % L);
  w.ns = item / L;
  const int s = (int)(w.ns % S);
  const long long n = w.ns / S;
  const float sc = ldexpf(1.0f, -w.l);
  const float cx = coords[((long long)s * N + n) * 2 + 0] * sc;
  const float cy = coords[((long long)s * N + n) * 2 + 1] * sc;
  const float fx = floorf(cx), fy = floorf(cy);
  w.dx = cx - fx;  // weights from the unclamped coords
  w.dy = cy - fy;
  w.x0 = (int)fminf(fmaxf(fx, -1e6f), 1e6f) - radius;
  w.y0 = (int)fminf(fmaxf(fy, -1e6f), 1e6f) - radius;
  w.H = lv.h[w.l];
  w.W = lv.w[w.l];
  w.level = pyr + lv.off[w.l] + (long long)s * w.H * w.W * kC;
  return w;
}

// The 2x2 blend of the warp's D x D taps (shared memory) into its d x d
// outputs, scaled, in the transposed flatten of the bf16 kernel.
__device__ __forceinline__ void blend_store(const float* taps, const Window& w, int radius,
                                            float scale, float* o, int lane) {
  const int D = 2 * radius + 2;
  const int d = 2 * radius + 1;
  const float w00 = (1.f - w.dy) * (1.f - w.dx), w01 = (1.f - w.dy) * w.dx;
  const float w10 = w.dy * (1.f - w.dx), w11 = w.dy * w.dx;
  for (int k = lane; k < d * d; k += 32) {
    const int i = k / d;  // x offset
    const int j = k % d;  // y offset
    const float v = w00 * taps[j * D + i] + w01 * taps[j * D + i + 1] +
                    w10 * taps[(j + 1) * D + i] + w11 * taps[(j + 1) * D + i + 1];
    o[k] = v * scale;
  }
}

// int8 maps, float32 contraction: lane k holds channels 4k..4k+3.
__global__ void corr_sample_int8_kernel(const int8_t* __restrict__ pyr,
                                        const float* __restrict__ scales,
                                        const float* __restrict__ targets,
                                        const float* __restrict__ coords,
                                        float* __restrict__ out, int N, int S, int L,
                                        int radius, Levels lv, float inv_sqrt_c) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long item = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (item >= (long long)N * S * L) return;  // warp-uniform exit
  const int D = 2 * radius + 2;
  float* taps = smem + warp * D * D;
  const Window w = locate(pyr, item, coords, N, S, L, radius, lv);
  const float4 t = *reinterpret_cast<const float4*>(targets + w.ns * kC + lane * 4);
  const int8_t* fm = static_cast<const int8_t*>(w.level);

  for (int a = 0; a < D; ++a) {
    const int yy = w.y0 + a;
    for (int b = 0; b < D; ++b) {
      const int xx = w.x0 + b;
      if (yy < 0 || yy >= w.H || xx < 0 || xx >= w.W) {  // warp-uniform
        if (lane == 0) taps[a * D + b] = 0.f;
        continue;
      }
      const char4 q = *reinterpret_cast<const char4*>(fm + ((long long)yy * w.W + xx) * kC +
                                                      lane * 4);
      float acc = (float)q.x * t.x;
      acc = fmaf((float)q.y, t.y, acc);
      acc = fmaf((float)q.z, t.z, acc);
      acc = fmaf((float)q.w, t.w, acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) taps[a * D + b] = acc;
    }
  }
  __syncwarp();
  blend_store(taps, w, radius, scales[w.l] * inv_sqrt_c, out + item * ((D - 1) * (D - 1)), lane);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
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

// Tap row r (a * D + b) of the window as this lane's A words: channels
// p * 32 + tig * 8 .. + 8 for p = 0..3, one 16-byte load each; zero for a
// tap outside the map or a row past the D * D taps.
__device__ __forceinline__ void load_tap_row(uint4 (&row)[4], const __nv_bfloat16* fm,
                                             const Window& w, int D, int r, int tig) {
  const int yy = w.y0 + r / D, xx = w.x0 + r % D;
#pragma unroll
  for (int p = 0; p < 4; ++p) row[p] = make_uint4(0, 0, 0, 0);
  if (r < D * D && yy >= 0 && yy < w.H && xx >= 0 && xx < w.W) {
    const __nv_bfloat16* src = fm + ((long long)yy * w.W + xx) * kC + tig * 8;
#pragma unroll
    for (int p = 0; p < 4; ++p) row[p] = *reinterpret_cast<const uint4*>(src + p * 32);
  }
}

// bf16 maps, tensor-core contraction of the target rounded to bf16.
// mma.sync.m16n8k16 fragments (g = lane / 4, tig = lane % 4): A registers
// {row g, k 2tig..+1}, {row g+8, same k}, {row g, k 2tig+8..+9}, {row g+8,
// same}; B registers {k 2tig..+1, col g}, {k 2tig+8..+9, col g}; D {row g,
// cols 2tig, 2tig+1}, {row g+8, same cols}. K-step 2p+j maps logical k
// 2tig+e to channel p*32 + tig*8 + 4j + e and 2tig+8+e to + 4j + 2 + e, in
// A and B alike. Only lanes 0-3 (g = 0) hold a non-zero B column; lanes
// with tig = 0 receive column 0 of D, the windows' dot products.
__global__ void corr_sample_mxu_kernel(const __nv_bfloat16* __restrict__ pyr,
                                       const float* __restrict__ targets,
                                       const float* __restrict__ coords,
                                       float* __restrict__ out, int N, int S, int L,
                                       int radius, Levels lv, float inv_sqrt_c) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long item = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (item >= (long long)N * S * L) return;  // warp-uniform exit: mma.sync needs the full warp
  const int D = 2 * radius + 2;
  const int g = lane >> 2, tig = lane & 3;
  float* taps = smem + warp * D * D;
  const Window w = locate(pyr, item, coords, N, S, L, radius, lv);
  const __nv_bfloat16* fm = static_cast<const __nv_bfloat16*>(w.level);

  uint32_t b[8][2];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (g == 0) {
      const float* t = targets + w.ns * kC + p * 32 + tig * 8;
      lo = *reinterpret_cast<const float4*>(t);
      hi = *reinterpret_cast<const float4*>(t + 4);
    }
    b[2 * p][0] = pack_bf16x2(lo.x, lo.y);
    b[2 * p][1] = pack_bf16x2(lo.z, lo.w);
    b[2 * p + 1][0] = pack_bf16x2(hi.x, hi.y);
    b[2 * p + 1][1] = pack_bf16x2(hi.z, hi.w);
  }

  for (int m = 0; m * 16 < D * D; ++m) {  // 16 tap rows per tile
    const int r0 = m * 16 + g, r1 = r0 + 8;
    uint4 a0[4], a1[4];
    load_tap_row(a0, fm, w, D, r0, tig);
    load_tap_row(a1, fm, w, D, r1, tig);
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      mma_bf16_16816(c, a0[p].x, a1[p].x, a0[p].y, a1[p].y, b[2 * p][0], b[2 * p][1]);
      mma_bf16_16816(c, a0[p].z, a1[p].z, a0[p].w, a1[p].w, b[2 * p + 1][0], b[2 * p + 1][1]);
    }
    if (tig == 0) {
      if (r0 < D * D) taps[r0] = c[0];
      if (r1 < D * D) taps[r1] = c[2];
    }
  }
  __syncwarp();
  blend_store(taps, w, radius, inv_sqrt_c, out + item * ((D - 1) * (D - 1)), lane);
}

// The host arrays of one launch as kernel arguments; false when the
// arguments are outside what the kernels take.
bool read_levels(Levels* lv, int C, int L, int radius, const long long* level_off,
                 const int* level_h, const int* level_w) {
  if (L < 1 || L > kMaxLevels || C != kC || radius < 0) return false;
  for (int l = 0; l < L; ++l) {
    lv->off[l] = level_off[l];
    lv->h[l] = level_h[l];
    lv->w[l] = level_w[l];
  }
  return true;
}

struct LaunchShape {
  dim3 grid, block;
  size_t shmem;
};

// One warp per item, kWarpsPerBlock items per block, a D x D float tap
// tile per warp in shared memory.
LaunchShape launch_shape(long long items, int radius) {
  const int D = 2 * radius + 2;
  return {dim3((unsigned)((items + kWarpsPerBlock - 1) / kWarpsPerBlock)),
          dim3(32 * kWarpsPerBlock), sizeof(float) * kWarpsPerBlock * D * D};
}

}  // namespace

// pyr: bf16, levels concatenated, level l (S, H_l, W_l, C) channels-last at
// element offset level_off[l]; targets f32 (N, S, C); coords f32 (S, N, 2)
// at level-0 resolution; out f32 (N, S, L*(2r+1)^2). C must be 128.
// level_* are host arrays. Returns cudaGetLastError() after the launch.
extern "C" int corr_sample_pyramid(const void* pyr, const void* targets,
                                   const void* coords, void* out, int N, int S,
                                   int C, int L, int radius,
                                   const long long* level_off,
                                   const int* level_h, const int* level_w,
                                   void* stream) {
  Levels lv;
  if (!read_levels(&lv, C, L, radius, level_off, level_h, level_w))
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)N * S * L;
  if (items == 0) return (int)cudaSuccess;
  const LaunchShape ls = launch_shape(items, radius);
  corr_sample_kernel<<<ls.grid, ls.block, ls.shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(pyr), static_cast<const float*>(targets),
      static_cast<const float*>(coords), static_cast<float*>(out), N, S, L, radius, lv,
      1.0f / sqrtf((float)kC));
  return (int)cudaGetLastError();
}

// As corr_sample_pyramid, on int8 maps: scales is a device array (L,) f32,
// level l's dequantisation scale, written on the same stream before.
extern "C" int corr_sample_pyramid_int8(const void* pyr, const void* targets,
                                        const void* coords, void* out, const void* scales,
                                        int N, int S, int C, int L, int radius,
                                        const long long* level_off, const int* level_h,
                                        const int* level_w, void* stream) {
  Levels lv;
  if (!read_levels(&lv, C, L, radius, level_off, level_h, level_w))
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)N * S * L;
  if (items == 0) return (int)cudaSuccess;
  const LaunchShape ls = launch_shape(items, radius);
  corr_sample_int8_kernel<<<ls.grid, ls.block, ls.shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(pyr), static_cast<const float*>(scales),
      static_cast<const float*>(targets), static_cast<const float*>(coords),
      static_cast<float*>(out), N, S, L, radius, lv, 1.0f / sqrtf((float)kC));
  return (int)cudaGetLastError();
}

// As corr_sample_pyramid, with the channel contraction on the tensor cores
// (the target rounded to bf16).
extern "C" int corr_sample_pyramid_mxu(const void* pyr, const void* targets,
                                       const void* coords, void* out, int N, int S, int C,
                                       int L, int radius, const long long* level_off,
                                       const int* level_h, const int* level_w,
                                       void* stream) {
  Levels lv;
  if (!read_levels(&lv, C, L, radius, level_off, level_h, level_w))
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)N * S * L;
  if (items == 0) return (int)cudaSuccess;
  const LaunchShape ls = launch_shape(items, radius);
  corr_sample_mxu_kernel<<<ls.grid, ls.block, ls.shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(pyr), static_cast<const float*>(targets),
      static_cast<const float*>(coords), static_cast<float*>(out), N, S, L, radius, lv,
      1.0f / sqrtf((float)kC));
  return (int)cudaGetLastError();
}
