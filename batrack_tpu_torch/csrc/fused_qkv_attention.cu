// K2: multi-head softmax attention read straight from the packed qkv
// projection, for Hopper.
//
// Replaces the TPU kernel batrack_tpu/ops/pallas_attention.py::_fused_qkv_kernel.
// Input (B, N, 3C) holds q | k | v, each C = heads * hd wide; output
// (B, N, C) has the heads merged, ready for the output projection. Heads are
// split and merged by addressing inside the kernel, so no (B, h, N, hd) copy
// is ever made in device memory. Keys where the optional (N,) key mask is 0
// get the logit -1e30, as on the TPU; logits, softmax and the output sums
// are float32.
//
// Bound on the H100 at the davis_demo shape (12, 2400, 1152) bf16: about
// 106 GFLOP of QK^T and PV against 88 MB of input and output, so it is
// bound by operations (~0.11 ms at the bf16 tensor-core peak; the 553 M
// exponentials need ~0.14 ms of the special-function units). Design: the
// usual GPU shape, not the TPU's whole-row softmax that only fits in VMEM:
// one block per (batch, head, tile of queries), a loop over key tiles staged
// in shared memory, and an online softmax in float32.
//
// bf16 (the production path): four warps of 16 queries each, 64-key tiles,
// both products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate). Q stays in registers as A fragments; K is staged row-major
// and V transposed, both with padded rows so the fragment loads hit 32
// distinct banks; the unnormalised probabilities go from the QK^T
// accumulators straight into the A fragments of PV, cast to bf16 (the TPU
// kernel also casts p to v's type for PV) and the row sums stay float32.
// No cp.async/TMA pipelining and no wgmma yet.
//
// float32 (parity runs): one query per thread with its q and output rows
// in registers, 32-key tiles of K and V in shared memory as float32
// (broadcast reads), on the float32 pipes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------- float32
constexpr int kBQ = 128;  // queries per block, one per thread
constexpr int kBK = 32;   // keys per shared-memory tile

template <int HD>
__global__ void __launch_bounds__(kBQ)
attention_f32_kernel(const float* __restrict__ qkv,
                     const uint8_t* __restrict__ key_mask,
                     float* __restrict__ out, int N, int C, float scale) {
  __shared__ __align__(16) float Ks[kBK][HD];
  __shared__ __align__(16) float Vs[kBK][HD];
  __shared__ float Kf[kBK];  // 0 live, 1 masked (-1e30), 2 past the end (-inf)

  const int b = blockIdx.z, h = blockIdx.y;
  const int qi = blockIdx.x * kBQ + threadIdx.x;
  const bool qvalid = qi < N;
  const long long row = 3LL * C;
  const float* base = qkv + (long long)b * N * row;
  const int hoff = h * HD;

  float q[HD], o[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    q[c] = qvalid ? base[(long long)qi * row + hoff + c] : 0.f;
    o[c] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBK) {
    for (int e = threadIdx.x; e < kBK * HD; e += kBQ) {
      const int r = e / HD, c = e % HD;
      const int kr = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kr < N) {
        const float* src = base + (long long)kr * row + hoff + c;
        kv = src[C];
        vv = src[2 * C];
      }
      Ks[r][c] = kv;
      Vs[r][c] = vv;
    }
    if (threadIdx.x < kBK) {
      const int kr = k0 + threadIdx.x;
      Kf[threadIdx.x] = kr >= N ? 2.f : ((key_mask != nullptr && key_mask[kr] == 0) ? 1.f : 0.f);
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
        acc *= scale;
        const float f = Kf[j];
        acc = f == 0.f ? acc : (f == 1.f ? -1e30f : -INFINITY);
        s[j] = acc;
        tmax = fmaxf(tmax, acc);
      }
      const float m_new = fmaxf(m, tmax);  // finite: every tile has a key < N
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
    float* dst = out + ((long long)b * N + qi) * C + hoff;
#pragma unroll
    for (int c = 0; c < HD; ++c) dst[c] = o[c] * inv;
  }
}

// ------------------------------------------------------------- bf16, mma
constexpr int kWarps = 4;
constexpr int kMQ = 16 * kWarps;  // queries per block
constexpr int kMK = 64;           // keys per shared-memory tile

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4): A holds
// rows g and g+8, columns 2t, 2t+1 (+8); B holds rows 2t, 2t+1 (+8) of
// column g; the accumulator holds rows g and g+8, columns 2t and 2t+1.
template <int HD>
__global__ void __launch_bounds__(32 * kWarps)
attention_bf16_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                          const uint8_t* __restrict__ key_mask,
                          __nv_bfloat16* __restrict__ out, int N, int C,
                          float scale_log2) {
  constexpr int KSTR = HD + 8;   // padded rows: conflict-free fragment loads
  constexpr int VSTR = kMK + 8;
  constexpr int QK_STEPS = HD / 16;
  constexpr int S_TILES = kMK / 8;
  constexpr int O_TILES = HD / 8;
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks per row of one head
  __shared__ __align__(16) __nv_bfloat16 Ks[kMK][KSTR];
  __shared__ __align__(16) __nv_bfloat16 Vt[HD][VSTR];
  __shared__ float kbias[kMK];  // 0 live, -1e30 masked, -inf past the end

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const long long row = 3LL * C;
  const __nv_bfloat16* base = qkv + (long long)b * N * row + h * HD;
  const int qa = blockIdx.x * kMQ + warp * 16 + g;  // this thread's two rows
  const int qb = qa + 8;

  uint32_t qf[QK_STEPS][4];
#pragma unroll
  for (int ks = 0; ks < QK_STEPS; ++ks) {
    const int c = ks * 16 + 2 * t;
    const __nv_bfloat16* ra = base + (long long)qa * row + c;
    const __nv_bfloat16* rb = base + (long long)qb * row + c;
    qf[ks][0] = qa < N ? ld32(ra) : 0u;
    qf[ks][1] = qb < N ? ld32(rb) : 0u;
    qf[ks][2] = qa < N ? ld32(ra + 8) : 0u;
    qf[ks][3] = qb < N ? ld32(rb + 8) : 0u;
  }

  float o[O_TILES][4];
#pragma unroll
  for (int i = 0; i < O_TILES; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int k0 = 0; k0 < N; k0 += kMK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < kMK * CHUNKS; e += 32 * kWarps) {
      const int r = e / CHUNKS, c8 = (e % CHUNKS) * 8;
      const int kr = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (kr < N) {
        const __nv_bfloat16* src = base + (long long)kr * row + c8;
        kv = *reinterpret_cast<const uint4*>(src + C);
        vv = *reinterpret_cast<const uint4*>(src + 2 * C);
      }
      *reinterpret_cast<uint4*>(&Ks[r][c8]) = kv;
      const __nv_bfloat16* vp = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[c8 + j][r] = vp[j];
    }
    if (threadIdx.x < kMK) {
      const int kr = k0 + threadIdx.x;
      kbias[threadIdx.x] =
          kr >= N ? -INFINITY : ((key_mask != nullptr && key_mask[kr] == 0) ? -1e30f : 0.f);
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 queries and the tile's 64 keys
    float s[S_TILES][4];
#pragma unroll
    for (int nt = 0; nt < S_TILES; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < QK_STEPS; ++ks) {
        const __nv_bfloat16* kp = &Ks[nt * 8 + g][ks * 16 + 2 * t];
        mma_bf16(s[nt], qf[ks], ld32(kp), ld32(kp + 8));
      }
    }

    // scaled logits in the log2 domain, masks, running row maxima
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < S_TILES; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float bias = kbias[nt * 8 + 2 * t + j];
        s[nt][j] = bias == 0.f ? s[nt][j] * scale_log2 : bias;
        s[nt][2 + j] = bias == 0.f ? s[nt][2 + j] * scale_log2 : bias;
        mx_a = fmaxf(mx_a, s[nt][j]);
        mx_b = fmaxf(mx_b, s[nt][2 + j]);
      }
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);  // finite
    const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < S_TILES; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nt][j] = exp2f(s[nt][j] - m_a);
        s[nt][2 + j] = exp2f(s[nt][2 + j] - m_b);
        rs_a += s[nt][j];
        rs_b += s[nt][2 + j];
      }
    }
    l_a = l_a * corr_a + rs_a;  // this thread's columns; summed over t at the end
    l_b = l_b * corr_b + rs_b;
#pragma unroll
    for (int i = 0; i < O_TILES; ++i) {
      o[i][0] *= corr_a;
      o[i][1] *= corr_a;
      o[i][2] *= corr_b;
      o[i][3] *= corr_b;
    }

    // O += P V: the accumulators of key tiles 2kk and 2kk+1 are the A
    // fragment of the kk-th 16-key step
#pragma unroll
    for (int kk = 0; kk < kMK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int i = 0; i < O_TILES; ++i) {
        const __nv_bfloat16* vp = &Vt[i * 8 + g][kk * 16 + 2 * t];
        mma_bf16(o[i], a, ld32(vp), ld32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
  }
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
  __nv_bfloat16* dst = out + (long long)b * N * C + h * HD + 2 * t;
#pragma unroll
  for (int i = 0; i < O_TILES; ++i) {
    if (qa < N)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)qa * C + i * 8) =
          __floats2bfloat162_rn(o[i][0] * inv_a, o[i][1] * inv_a);
    if (qb < N)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)qb * C + i * 8) =
          __floats2bfloat162_rn(o[i][2] * inv_b, o[i][3] * inv_b);
  }
}

template <int HD>
void launch_hd(const void* qkv, const uint8_t* mask, void* out, int B, int N, int C,
               int heads, float scale, int is_bf16, cudaStream_t st) {
  if (is_bf16) {
    const dim3 grid((N + kMQ - 1) / kMQ, heads, B);
    attention_bf16_mma_kernel<HD><<<grid, 32 * kWarps, 0, st>>>(
        static_cast<const __nv_bfloat16*>(qkv), mask, static_cast<__nv_bfloat16*>(out), N, C,
        scale * kLog2e);
  } else {
    const dim3 grid((N + kBQ - 1) / kBQ, heads, B);
    attention_f32_kernel<HD><<<grid, kBQ, 0, st>>>(static_cast<const float*>(qkv), mask,
                                                   static_cast<float*>(out), N, C, scale);
  }
}

}  // namespace

// qkv (B, N, 3C) contiguous and 16-byte aligned, float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); key_mask: (N,) uint8 or null; out (B, N, C) of
// the input type. Head dim C / heads must be 48, the tracker's (hidden 384
// over 8 heads); other head dims are not instantiated. Returns
// cudaGetLastError() after the launch.
extern "C" int fused_qkv_attention(const void* qkv, const void* key_mask,
                                   void* out, int B, int N, int C, int heads,
                                   float scale, int is_bf16, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  if (heads <= 0 || C % heads != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* km = static_cast<const uint8_t*>(key_mask);
  if (C / heads != 48) return (int)cudaErrorInvalidValue;
  launch_hd<48>(qkv, km, out, B, N, C, heads, scale, is_bf16, st);
  return (int)cudaGetLastError();
}
