// First-order linear recurrence over full (T, B) coefficient planes,
// chunked over T: the scan core's method="pallas".
//
// Replaces di_hpc_tpu/pallas_kernels/linear_scan.py:_scan_kernel (called
// through linear_scan_reverse_pallas and linear_scan_forward_pallas):
//   reverse: y_t = a_t + b_t * y_{t+1}, t = T-1 .. 0, y_T = boundary;
//   forward: y_t = a_t + b_t * y_{t-1}, t = 0 .. T-1, y_{-1} = boundary.
// The JAX wrapper folds a non-zero boundary into a[T-1] (a[0]) and composes
// the maps by two-level chunked doubling in VMEM; here the boundary is an
// optional (B,) vector (null means 0) that seeds the first carry.
//
// What bounds it on an H100: memory.  Each element is read from a and b once
// and written once, for one multiply-add: 3*T*B*4 bytes, 50.3 MB at T=1024,
// B=4096 (15 us at 3.35 TB/s).  Only loads in flight reach that rate: a
// column walked step by step by one thread waits on one round trip to
// device memory per batch of loads (64 of them at T=1024 in this kernel's
// first version, which ran 7-10x its bound).
//
// Design: csrc/vtrace.cu's chunked walk, with its shared pieces in
// csrc/chunked_scan.cuh.  A CTA owns `cols` neighbouring columns x `chunks`
// chunks of 8 steps (a super-tile) and walks the super-tiles in the
// recurrence's direction -- from the last for reverse, from the first for
// forward -- with each thread's a and b loaded one super-tile ahead (16
// loads in flight per thread, none allocating an L1 line).  Each thread
// composes its chunk's pair (A, D), the super-tile's pairs are folded in one
// fixed order from the carry, and each thread re-walks its chunk from its
// carry-in and stores y.  Steps past T load a = 0, b = 1, the identity: in
// the reverse walk they come first, and zeros (b = 0) would erase the
// boundary.  Columns past B neither load nor store; neighbouring lanes own
// neighbouring columns, so loads and stores are coalesced.  The launch
// shape (cols, chunks) is chosen by the caller
// (kernels.linear_scan_launch_shape).

#include "chunked_scan.cuh"

namespace {

using namespace chunked_scan;

// One thread's chunk: a and b at steps t0 ... t0 + kChunk - 1 of its column;
// a = 0 and b = 1 past T, before 0 or past B.
struct Steps {
  float a[kChunk], b[kChunk];
};

__device__ __forceinline__ void load_steps(Steps& s,
                                           const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           int t0, int col, int T, int B) {
  const bool in_col = col < B && t0 >= 0;
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const bool in = in_col && t0 + u < T;
    const size_t o = in ? (size_t)(t0 + u) * B + col : 0;
    s.a[u] = load_once(a + o, in, 0.f);
    s.b[u] = load_once(b + o, in, 1.f);
  }
}

template <bool kReverse>
__global__ void __launch_bounds__(kMaxThreads)
linear_scan_chunked_kernel(const float* __restrict__ a,
                           const float* __restrict__ b,
                           const float* __restrict__ boundary,
                           float* __restrict__ y, int T, int B) {
  extern __shared__ float pairs[];   // [parity][0: A, 1: D][chunk][col]
  const int cols = blockDim.x, chunks = blockDim.y;
  const int x = threadIdx.x, own = threadIdx.y;
  const int col = blockIdx.x * cols + x;
  const int plane = cols * chunks;
  const int tile = chunks * kChunk;
  const int tiles = (T + tile - 1) / tile;
  const int dir = kReverse ? -1 : 1;

  int st = kReverse ? tiles - 1 : 0;
  Steps cur, nxt;
  load_steps(cur, a, b, st * tile + own * kChunk, col, T, B);
  float carry = boundary != nullptr && col < B ? boundary[col] : 0.f;
  for (int i = 0, parity = 0; i < tiles; ++i, st += dir, parity ^= 1) {
    const int t0 = st * tile + own * kChunk;
    load_steps(nxt, a, b, t0 + dir * tile, col, T, B);

    float A, D;
    compose<kReverse>(cur.a, cur.b, A, D);
    float* pa = pairs + parity * 2 * plane;
    pa[own * cols + x] = A;
    pa[plane + own * cols + x] = D;
    __syncthreads();

    float v = fold_pairs<kReverse>(pa, plane, cols, chunks, x, own, carry);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int u = kReverse ? kChunk - 1 - k : k;
      v = cur.a[u] + cur.b[u] * v;
      if (col < B && t0 + u < T) y[(size_t)(t0 + u) * B + col] = v;
    }
    cur = nxt;
  }
}

}  // namespace

extern "C" {

// a, b (T, B) in, boundary (B,) or null (zero) in; y (T, B) out.  reverse
// non-zero walks from t = T-1 down.  One CTA per `cols` columns, `chunks`
// chunks of 8 steps to a super-tile (cols * chunks <= 512).  Returns the
// launch status.
int linear_scan_f32(const float* a, const float* b, const float* boundary,
                    float* y, int T, int B, int reverse, int cols, int chunks,
                    void* stream) {
  if (chunked_scan::bad_launch(T, B, cols, chunks))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + cols - 1) / cols), block(cols, chunks);
  const size_t smem = (size_t)4 * cols * chunks * sizeof(float);
  if (reverse) {
    linear_scan_chunked_kernel<true>
        <<<grid, block, smem, (cudaStream_t)stream>>>(a, b, boundary, y, T, B);
  } else {
    linear_scan_chunked_kernel<false>
        <<<grid, block, smem, (cudaStream_t)stream>>>(a, b, boundary, y, T, B);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
