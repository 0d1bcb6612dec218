// First-order linear recurrence over full (T, B) coefficient planes, one
// thread per batch column: the scan core's method="pallas".
//
// Replaces di_hpc_tpu/pallas_kernels/linear_scan.py:_scan_kernel (called
// through linear_scan_reverse_pallas and linear_scan_forward_pallas):
//   reverse: y_t = a_t + b_t * y_{t+1}, t = T-1 .. 0, y_T = boundary;
//   forward: y_t = a_t + b_t * y_{t-1}, t = 0 .. T-1, y_{-1} = boundary.
// The JAX wrapper folds a non-zero boundary into a[T-1] (a[0]) and composes
// the maps by two-level chunked doubling in VMEM; a sequential walk computes
// the same function, so here the boundary is an optional (B,) vector (null
// means 0) that seeds the walk.
//
// What bounds it on an H100: memory.  Each element is read from a and b once
// and written once, for one multiply-add: 3*T*B*4 bytes, 50.3 MB at T=1024,
// B=4096 (15 us at 3.35 TB/s).
//
// Design, as csrc/rl_scans.cu: one thread owns one column and walks time in
// the recurrence's direction, so no scan tree and no cross-thread traffic;
// neighbouring threads own neighbouring columns, so every load and store is
// coalesced across the warp.  The loop loads kUnroll steps of a and b before
// it computes them, to keep enough loads in flight.  Columns past B neither
// load nor store.  At B=4096 that is only 4096 threads on 132 SMs; chunking
// over T to fill the card is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kUnroll = 16;

template <bool kReverse>
__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ boundary, float* __restrict__ y,
                   int T, int B) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= B) return;
  float carry = boundary ? __ldg(boundary + col) : 0.f;
  for (int s0 = 0; s0 < T; s0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      av[u] = 0.f;
      bv[u] = 1.f;
      if (s < T) {
        const int t = kReverse ? T - 1 - s : s;
        const size_t o = (size_t)t * B + col;
        av[u] = __ldg(a + o);
        bv[u] = __ldg(b + o);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      if (s < T) {
        const int t = kReverse ? T - 1 - s : s;
        carry = av[u] + bv[u] * carry;
        y[(size_t)t * B + col] = carry;
      }
    }
  }
}

}  // namespace

extern "C" {

// a, b (T, B) in, boundary (B,) or null (zero) in; y (T, B) out.  reverse
// non-zero walks from t = T-1 down.  Returns the launch status.
int linear_scan_f32(const float* a, const float* b, const float* boundary,
                    float* y, int T, int B, int reverse, void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  if (reverse) {
    linear_scan_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        a, b, boundary, y, T, B);
  } else {
    linear_scan_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        a, b, boundary, y, T, B);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
