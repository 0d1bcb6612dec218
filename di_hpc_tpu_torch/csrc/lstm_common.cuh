// Device code shared by the LN-LSTM layer's forward kernel (lstm_layer.cu)
// and its backward kernels (lstm_layer_bwd.cu).
//
// The backward recomputes the forward's h @ Wh product and LayerNorm
// statistics with these same functions, in the same order, so the two see
// the same values (lstm_cell.py:_ln_stats's one-pass form, variance clamped
// at 0).

#pragma once

#include <cuda_runtime.h>

namespace lstm {

constexpr int kRows = 8;            // batch rows per CTA
constexpr int kThreads = 512;       // 4 output columns per thread per strip
constexpr int kKUnroll = 8;         // weight rows loaded ahead per thread
constexpr float kLnEps = 1e-5f;     // utils/constants.py LAYERNORM_EPS
static_assert(kRows == 8, "fma_rows reads a k step as two float4 of 4 rows");

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

// out (kRows, N) = a @ w for the CTA's kRows rows, split over K into
// kSplits equal slices whose partial products land at out + s*kRows*N (the
// caller sums them; kSplits = 1 writes the product itself).  a is given
// k-major as aT (K, kRows) in shared memory, so one k step is two broadcast
// float4 loads; w (K, N) is row-major in global memory, N % 4 == 0 with
// 16-byte aligned rows, streamed from L2 in float4 column strips.  One item
// is 4 adjacent output columns of one slice.  kSplits is a template
// argument so that the forward's product (kSplits = 1) carries no slice
// arithmetic.
template <int kSplits>
__device__ __forceinline__ void matmul_rows(const float* __restrict__ aT,
                                            const float* __restrict__ w,
                                            int K, int N,
                                            float* __restrict__ out) {
  const int quads = N / 4;
  const int kslice = K / kSplits;
  for (int item = threadIdx.x; item < kSplits * quads; item += kThreads) {
    const int s = kSplits == 1 ? 0 : item / quads;
    const int col = 4 * (item - s * quads);
    const int k0 = s * kslice, k1 = k0 + kslice;
    float acc[kRows][4];
#pragma unroll
    for (int b = 0; b < kRows; ++b)
      acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0.f;
    const float* wcol = w + col;
    int k = k0;
    for (; k + kKUnroll <= k1; k += kKUnroll) {
      float4 wv[kKUnroll];
#pragma unroll
      for (int u = 0; u < kKUnroll; ++u)
        wv[u] = __ldg(reinterpret_cast<const float4*>(
            wcol + (size_t)(k + u) * N));
#pragma unroll
      for (int u = 0; u < kKUnroll; ++u)
        fma_rows(acc, wv[u], aT + (k + u) * kRows);
    }
    for (; k < k1; ++k)
      fma_rows(acc,
               __ldg(reinterpret_cast<const float4*>(wcol + (size_t)k * N)),
               aT + k * kRows);
    float* o = out + (size_t)s * kRows * N;
#pragma unroll
    for (int b = 0; b < kRows; ++b)
      *reinterpret_cast<float4*>(o + b * N + col) =
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
