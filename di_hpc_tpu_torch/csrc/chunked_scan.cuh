// What the scan kernels chunked over T share: the linear recurrence
// (csrc/linear_scan.cu), and GAE, the TD(lambda) returns, loss and error and
// the UPGO loss (csrc/rl_scans.cu).  Their walk is csrc/vtrace.cu's, which
// keeps its own copy of these pieces.
//
// A first-order affine recurrence, y = a_u + b_u * y taken step by step in
// the walk's direction, composes over a run of steps into one pair (A, D):
// y after the run = D + A * (y before it).  A CTA owns `cols` neighbouring
// columns (lane x) and splits time into chunks of kChunk steps (lane y),
// `chunks` of them to a super-tile, and walks the super-tiles in the
// recurrence's direction.  Per super-tile, each thread
//   1. has its chunk's streams in registers, loaded one super-tile ahead
//      with load_once;
//   2. composes its chunk's pair (compose) and writes it to shared memory,
//      into one of two buffers (one barrier per super-tile then suffices:
//      a thread can only overwrite a buffer after every thread has passed
//      the next barrier, i.e. has finished reading it);
//   3. after one barrier, folds the super-tile's pairs in one fixed order
//      (fold_pairs), starting from the carry of the super-tile before: it
//      keeps the value entering its own chunk and ends with the carry for
//      the next super-tile, the same bits in every thread;
//   4. re-walks its chunk from registers, from its carry-in.
// Steps past T must compose to the identity (a = 0, b = 1): the loads fill
// them so, and the epilogues store nothing there.

#pragma once

#include <cuda_runtime.h>

namespace chunked_scan {

constexpr int kChunk = 8;          // steps of one thread in a super-tile
constexpr int kMaxThreads = 512;   // cols * chunks

// A load of a stream that is read once: no L1 line is allocated for it
// (L1::no_allocate), since none would be read again.  `fill` where !in
// (nothing is read).
__device__ __forceinline__ float load_once(const float* p, bool in,
                                           float fill = 0.f) {
  float v;
  asm("{\n"
      "  .reg .pred q;\n"
      "  setp.ne.b32 q, %2, 0;\n"
      "  mov.f32 %0, %3;\n"
      "  @q ld.global.nc.L1::no_allocate.f32 %0, [%1];\n"
      "}\n"
      : "=f"(v)
      : "l"(p), "r"((int)in), "f"(fill));
  return v;
}

// The pair (A, D) of the kChunk steps y <- a[u] + b[u] * y, taken from the
// chunk's last step down (kReverse) or from its first up.
template <bool kReverse>
__device__ __forceinline__ void compose(const float (&a)[kChunk],
                                        const float (&b)[kChunk], float& A,
                                        float& D) {
  A = 1.f;
  D = 0.f;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const int u = kReverse ? kChunk - 1 - i : i;
    D = a[u] + b[u] * D;
    A = b[u] * A;
  }
}

// Folds a super-tile's pairs -- A of chunk q at pa[q * cols + x], D at
// pa[plane + q * cols + x] -- in the walk's order (from the last chunk down
// for kReverse, else from the first up), starting from `carry`.  Returns the
// value entering chunk `own` and leaves in `carry` the value leaving the
// super-tile; every thread of column x computes the same bits.
template <bool kReverse>
__device__ __forceinline__ float fold_pairs(const float* pa, int plane,
                                            int cols, int chunks, int x,
                                            int own, float& carry) {
  float in = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const int q = kReverse ? chunks - 1 - k : k;
    if (q == own) in = carry;
    carry = pa[plane + q * cols + x] + pa[q * cols + x] * carry;
  }
  return in;
}

// The loss kernels' epilogue: each thread's partial goes to sums[own * cols
// + x] (shared memory apart from the pair buffers); after one barrier, the
// thread of chunk 0 adds its column's partials in chunk order and stores the
// column's partial to out[col] for col < B (no float atomics).
__device__ __forceinline__ void store_column_sum(float* sums, float sum,
                                                 int cols, int chunks, int x,
                                                 int own, int col, int B,
                                                 float* out) {
  sums[own * cols + x] = sum;
  __syncthreads();
  if (own == 0 && col < B) {
    float p = 0.f;
    for (int q = 0; q < chunks; ++q) p += sums[q * cols + x];
    out[col] = p;
  }
}

// The launch check shared by the entry points: (T, B) and the tiling.
inline bool bad_launch(int T, int B, int cols, int chunks) {
  return T < 1 || B < 1 || cols < 1 || chunks < 1 ||
         cols * chunks > kMaxThreads;
}

}  // namespace chunked_scan
