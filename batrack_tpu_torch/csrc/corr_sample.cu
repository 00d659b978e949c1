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
  if (L < 1 || L > kMaxLevels || C != kC || radius < 0)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < L; ++l) {
    lv.off[l] = level_off[l];
    lv.h[l] = level_h[l];
    lv.w[l] = level_w[l];
  }
  const long long items = (long long)N * S * L;
  if (items == 0) return (int)cudaSuccess;
  const int D = 2 * radius + 2;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((unsigned)((items + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const size_t shmem = sizeof(float) * kWarpsPerBlock * D * D;
  corr_sample_kernel<<<grid, block, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(pyr), static_cast<const float*>(targets),
      static_cast<const float*>(coords), static_cast<float*>(out), N, S, L, radius, lv,
      1.0f / sqrtf((float)kC));
  return (int)cudaGetLastError();
}
