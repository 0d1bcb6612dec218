// Device code shared by the LN-LSTM layer's forward kernels
// (lstm_layer_cluster.cu, and lstm_layer.cu for H % 4 != 0) and its backward
// kernels (lstm_layer_bwd_v1.cu, lstm_layer_bwd_v2.cu).
//
// LayerNorm statistics take lstm_cell.py:_ln_stats's one-pass form,
// variance clamped at 0.  The 8-row forward multiplies with matmul_rows;
// the cluster kernels use only the element helpers here and run their
// products on the tensor cores (lstm_mma.cuh), so V2's gh_pre differs from
// the forward's by float32 rounding (3xTF32) or by summation order (bf16).
//
// Stream types.  Every kernel is a template on the element type T of its
// streams and weights, float or __nv_bfloat16, as the TPU kernels take f32
// or bf16 streams (lstm_cell.py:130-141).  Whatever T is, shared memory
// tiles, carries, LayerNorm statistics and all arithmetic are float32: a
// bf16 value is widened on load (exactly) and a result is rounded to
// nearest even once, where it is stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lstm {

using bf16 = __nv_bfloat16;

constexpr int kRows = 8;            // batch rows per CTA
constexpr int kThreads = 512;       // 4 output columns per thread per strip
constexpr int kKUnroll = 8;         // weight rows loaded ahead per thread
constexpr float kLnEps = 1e-5f;     // utils/constants.py LAYERNORM_EPS
static_assert(kRows == 8, "fma_rows reads a k step as two float4 of 4 rows");

// bf16 -> float is a 16-bit shift; lo/hi take the element in the low or
// high half of a 32-bit word (the lower address is the low half).
__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// One element through the read-only cache, as float.
__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const bf16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// Four adjacent elements through the read-only cache, as a float4: one
// 16-byte load for float, one 8-byte load for bf16 (p aligned to match).
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}

// Store one float as T, rounded to nearest even for bf16.
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v rounded to T and widened back: the value a T store of v holds.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  T t;
  put(&t, v);
  return to_f(t);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void fma_rows(float (&acc)[kRows][4], float4 w,
                                         const float* ak) {
  const float4 lo = *reinterpret_cast<const float4*>(ak);
  const float4 hi = *reinterpret_cast<const float4*>(ak + 4);
  const float av[kRows] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int b = 0; b < kRows; ++b) {
    acc[b][0] += av[b] * w.x;
    acc[b][1] += av[b] * w.y;
    acc[b][2] += av[b] * w.z;
    acc[b][3] += av[b] * w.w;
  }
}

// out (kRows, N) = a @ w for the CTA's kRows rows.  a is given k-major as
// aT (K, kRows) in shared memory, so one k step is two broadcast float4
// loads; w (K, N) is row-major in global memory, N % 4 == 0 with aligned
// rows, streamed from L2 in 4-column strips (load4).  One item is 4
// adjacent output columns, for either weight type W: a bf16 Wh moves half
// the bytes of a float one through the same number of loads and FMAs, and
// every thread still has an item (4H / 4 = 512 items at H = 512).  Products
// of bf16 values are exact in float32 and the sums are float32, the TPU's
// preferred_element_type=f32 product.
template <typename W>
__device__ __forceinline__ void matmul_rows(const float* __restrict__ aT,
                                            const W* __restrict__ w,
                                            int K, int N,
                                            float* __restrict__ out) {
  for (int col = 4 * threadIdx.x; col < N; col += 4 * kThreads) {
    float acc[kRows][4];
#pragma unroll
    for (int b = 0; b < kRows; ++b)
      acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0.f;
    const W* wcol = w + col;
    int k = 0;
    for (; k + kKUnroll <= K; k += kKUnroll) {
      float4 wv[kKUnroll];
#pragma unroll
      for (int u = 0; u < kKUnroll; ++u)
        wv[u] = load4(wcol + (size_t)(k + u) * N);
#pragma unroll
      for (int u = 0; u < kKUnroll; ++u)
        fma_rows(acc, wv[u], aT + (k + u) * kRows);
    }
    for (; k < K; ++k)
      fma_rows(acc, load4(wcol + (size_t)k * N), aT + k * kRows);
#pragma unroll
    for (int b = 0; b < kRows; ++b)
      *reinterpret_cast<float4*>(out + b * N + col) =
          make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  }
}

// One-pass LayerNorm statistics over a row spread across a warp: each lane
// adds its float4 quads with accum_quad, then finish_stats reduces the
// warp and returns (mean, rstd), var = max(E[x^2] - E[x]^2, 0).
__device__ __forceinline__ void accum_quad(float4 v, float& s, float& s2) {
  s += (v.x + v.y) + (v.z + v.w);
  s2 += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
}

__device__ __forceinline__ float2 finish_stats(float s, float s2, int G) {
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float inv = 1.0f / (float)G;
  const float m = s * inv;
  return make_float2(m, rsqrtf(fmaxf(s2 * inv - m * m, 0.f) + kLnEps));
}

}  // namespace lstm
