// Tensor-core and thread-block-cluster pieces shared by the LN-LSTM layer
// kernels that spread their gate columns over a cluster: the forward
// (lstm_layer_cluster.cu) and the V2 backward (lstm_layer_bwd_v2.cu).
//
// - The products run on mma.sync in the swap-AB form: the A operand's rows
//   (gate columns, or units) are the M = 16 side and the batch rows of a
//   group are the n = 8 tiles, so each A fragment serves every row.  A
//   streams from L2 (global memory) straight into a ring of registers, 16
//   bytes a thread per piece where its rows are k-contiguous (AOperand),
//   one element a load down Wh's columns (AColumns, the forward's);
//   B is a k-contiguous tile in shared memory
//   whose rows are padded (operand_ld) so that a quarter-warp's 16-byte
//   loads hit distinct banks.  Within each 16-byte piece the k order is
//   permuted the same way on both sides (a sum over k does not depend on its
//   order), so every fragment is one 16-byte load.
//   bf16 streams: m16n8k16 bf16 with f32 accumulation -- products of bf16
//   values are exact in f32 and the sums are f32, the TPU's
//   preferred_element_type=f32 product.  f32 streams: 3xTF32 on m16n8k8,
//   x = big + small with big = rna_tf32(x), small = rna_tf32(x - big), and
//   big*big + big*small + small*big accumulated in f32, which keeps f32
//   accuracy (single-pass TF32 would not).
// - Tile edges are masked: K and M need not be multiples of the MMA tile (A
//   pieces past the edge load zeros; B tiles are zero past their depth).
// - Cross-CTA sums go through distributed shared memory in rank order
//   (cluster_sum), so every CTA of a cluster gets the same bits and repeated
//   runs are bitwise equal.
// - cp.async copies a step's inputs into shared memory while the CTA works
//   on the step before.

#pragma once

#include <cooperative_groups.h>

#include "lstm_common.cuh"

namespace lstm {

constexpr int kMmaThreads = 512;            // a cluster kernel's CTA
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMaxCluster = 8;              // the portable maximum
constexpr int kRingChunks = 2;              // A chunks in flight (MT = 1)
constexpr size_t kSmemLimit = 232448;       // a CTA's most on sm_90

// CTAs per cluster at hidden size H: the largest size up to 8 whose share
// of the units, U = H / C, is a multiple of 4, so that units, gate columns
// and partials move in 16-byte pieces, if that size is at least 4; else the
// largest divisor of H up to 8 (at least 4 when H % 4 == 0), and the pieces
// go one element at a time.
inline int cluster_size(int H) {
  for (int c = kMaxCluster; c >= 4; --c)
    if (H % (4 * c) == 0) return c;
  for (int c = kMaxCluster; c >= 4; --c)
    if (H % c == 0) return c;
  return 1;
}

// Elements per row of a B-operand tile of depth K: K rounded up to 128
// bytes, plus 64, so that the two 8-lane halves of a quarter-warp's 16-byte
// loads (rows g and g+1) fall in different banks.
template <typename T>
__host__ __device__ constexpr int operand_ld(int K) {
  return (int)(((K * sizeof(T) + 127) / 128 * 128 + 64) / sizeof(T));
}

// Reserve `bytes` at offset `at` of a shared-memory plan, 16-byte aligned;
// returns the tile's offset.
__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  const size_t here = at;
  at += (bytes + 15) / 16 * 16;
  return here;
}

// ------------------------------------------------------------- MMA core --

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(unsigned bits, unsigned& big,
                                           unsigned& small) {
  const float x = __uint_as_float(bits);
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Raw bits of one element, for the element-wise edge loads.
__device__ __forceinline__ unsigned raw_bits(const float* p) {
  return __float_as_uint(__ldg(p));
}
__device__ __forceinline__ unsigned raw_bits(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// The A operand: element (m, k) of an M x K matrix in global memory.  With
// kRowsMapped, row m lies at a + cmap[m]*ld and k is contiguous (Wh^T rows
// of the own gate columns); otherwise row m lies at a + m*ld and k maps to
// column cmap[k] (Wh rows restricted to the own columns).  `vec` says that
// every 16-byte piece the MMA loop asks for is aligned and contiguous.
template <typename T, bool kRowsMapped>
struct AOperand {
  const T* __restrict__ a;
  const int* cmap;
  int ld, M, K;
  bool vec;

  __device__ __forceinline__ const T* at(int m, int k) const {
    return kRowsMapped ? a + (size_t)cmap[m] * ld + k
                       : a + (size_t)m * ld + cmap[k];
  }

  // Element offsets of row m and of depth k (at(m, k) = a + row + depth),
  // -1 past the edge.
  __device__ __forceinline__ int row_off(int m) const {
    return m >= M ? -1 : kRowsMapped ? cmap[m] * ld : m * ld;
  }
  __device__ __forceinline__ int depth_off(int k) const {
    return k >= K ? -1 : kRowsMapped ? k : cmap[k];
  }

  // The 16-byte piece of row m at depth k..k+E-1 as four 32-bit words
  // (E = 4 f32 or 8 bf16 elements); zero past the edges.  The MMA loop
  // takes this path where `vec` does not hold, and else loads the piece
  // with one 16-byte load from row_off and depth_off.
  __device__ __forceinline__ void piece(int m, int k, unsigned (&w)[4]) const {
    constexpr int E = 16 / sizeof(T);
    w[0] = w[1] = w[2] = w[3] = 0u;
    if (m >= M || k >= K) return;
    if (vec) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(at(m, k)));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      return;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (k + e < K) {
        const unsigned bits = raw_bits(at(m, k + e));
        if constexpr (sizeof(T) == 4) w[e] = bits;
        else w[e / 2] |= bits << (16 * (e & 1));
      }
    }
  }
};

// The A operand read down the columns of a row-major matrix: element
// (m, k) at a + k*ld + cmap[m] -- Wh^T[own gate columns, :] read straight
// from Wh (H, 4H), with no transposed copy.  A piece is E loads, one per
// depth, each of which a warp issues as four runs of 8 adjacent columns;
// the MMA loop takes the element-wise path for it (vec is false).
template <typename T>
struct AColumns {
  const T* __restrict__ a;
  const int* cmap;
  int ld, M, K;
  static constexpr bool vec = false;

  __device__ __forceinline__ int row_off(int m) const {
    return m >= M ? -1 : cmap[m];
  }
  __device__ __forceinline__ int depth_off(int k) const {
    return k >= K ? -1 : k * ld;
  }

  __device__ __forceinline__ void piece(int m, int k, unsigned (&w)[4]) const {
    constexpr int E = 16 / sizeof(T);
    w[0] = w[1] = w[2] = w[3] = 0u;
    if (m >= M || k >= K) return;
    const T* p = a + (size_t)k * ld + cmap[m];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (k + e < K) {
        const unsigned bits = raw_bits(p + (size_t)e * ld);
        if constexpr (sizeof(T) == 4) w[e] = bits;
        else w[e / 2] |= bits << (16 * (e & 1));
      }
    }
  }
};

// One 16-byte piece of a B tile row in shared memory as four words.
template <typename T>
__device__ __forceinline__ void b_piece(const T* p, unsigned (&w)[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

// The MMAs of one chunk of depth KC = 4 pieces' worth (16 f32 or 32 bf16):
// two k steps.  A thread's piece covers the physical depths tig*E..+E-1 of
// the chunk; k step s reads its words 2s and 2s+1, which the fragments take
// as the logical columns (tf32) tig and tig+4, or (bf16) the pairs 2tig,
// 2tig+1 and 2tig+8, 2tig+9 -- on A and B alike, so the product is the sum
// over all KC depths.
// kRoundedSum (f32): each k step's three MMAs start from zero and their sum
// is added to the accumulator by an f32 add, rounded to nearest.  The
// tensor cores' own accumulation truncates, and over the K/8 k steps of a
// product that bias adds up; a recurrence carries it on (over the forward's
// 64 serving steps at H=512 it passed the 1e-4 bound against the plain
// version).
template <int MT, int NT, bool kRoundedSum = false>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][NT][4],
                                          const unsigned (&a)[MT][2][4],
                                          const unsigned (&b)[NT][4],
                                          float) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    unsigned bb[NT][2], bs[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      split_tf32(b[nt][2 * s], bb[nt][0], bs[nt][0]);
      split_tf32(b[nt][2 * s + 1], bb[nt][1], bs[nt][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      unsigned ab[4], as[4];
      split_tf32(a[i][0][2 * s], ab[0], as[0]);       // row g,   col tig
      split_tf32(a[i][1][2 * s], ab[1], as[1]);       // row g+8, col tig
      split_tf32(a[i][0][2 * s + 1], ab[2], as[2]);   // row g,   col tig+4
      split_tf32(a[i][1][2 * s + 1], ab[3], as[3]);   // row g+8, col tig+4
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if constexpr (kRoundedSum) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(d, as, bb[nt]);
          mma_tf32(d, ab, bs[nt]);
          mma_tf32(d, ab, bb[nt]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][nt][r] += d[r];
        } else {
          mma_tf32(acc[i][nt], as, bb[nt]);
          mma_tf32(acc[i][nt], ab, bs[nt]);
          mma_tf32(acc[i][nt], ab, bb[nt]);
        }
      }
    }
  }
}

template <int MT, int NT, bool kRoundedSum = false>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][NT][4],
                                          const unsigned (&a)[MT][2][4],
                                          const unsigned (&b)[NT][4],
                                          bf16) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const unsigned af[4] = {a[i][0][2 * s], a[i][1][2 * s],
                              a[i][0][2 * s + 1], a[i][1][2 * s + 1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned bf[2] = {b[nt][2 * s], b[nt][2 * s + 1]};
        mma_bf16(acc[i][nt], af, bf);
      }
    }
  }
}

// out[m*out_m + n*out_n] = sum_k A(m, k) * bs[n*ldb + k] for m < A.M and the
// 8*NT rows n, K = A.K (bs zero from K up to its padded width).  Each
// warp takes MT m-tiles of 16 at a time.  With KS = 2 the warps form two
// halves that split K: the first half's sums go to `out`, the second's to
// `out2` (the caller adds the two), so each warp multiplies MT m-tiles by
// every B fragment it loads and splits.  The A pieces stream from L2
// through a ring of kRingChunks / MT chunks in registers: a slot is refilled
// with the chunk that many ahead as soon as its chunk is multiplied, so
// that many chunks' loads are always in flight.  kRoundedSum: as in
// mma_chunk (f32 streams).
template <typename T, int NT, int MT, int KS, typename AOp,
          bool kRoundedSum = false>
__device__ __forceinline__ void warp_gemm(const AOp& A, const T* bs, int ldb,
                                          float* out, float* out2, int out_m,
                                          int out_n) {
  constexpr int E = 16 / sizeof(T);
  constexpr int KC = 4 * E;
  constexpr int D = kRingChunks / MT;
  constexpr int kSlots = kMmaWarps / KS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int slot = warp % kSlots, half = warp / kSlots;
  const int nmt = (A.M + 15) / 16;
  const int nchunks = (A.K + KC - 1) / KC;
  const int per_half = (nchunks + KS - 1) / KS;
  const int c_begin = half * per_half;
  const int c_end = min(nchunks, c_begin + per_half);
  float* dst_out = half == 0 ? out : out2;

  for (int base = slot * MT; base < nmt; base += kSlots * MT) {
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        acc[i][nt][0] = acc[i][nt][1] = acc[i][nt][2] = acc[i][nt][3] = 0.f;

    int roff[MT][2];                  // this thread's rows, -1 past M
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        roff[i][h] = A.row_off((base + i) * 16 + g + 8 * h);
    unsigned ring[D][MT][2][4];
    auto load = [&](int chunk, unsigned (&dst)[MT][2][4]) {
      const int k = chunk * KC + tig * E;
      if (A.vec) {
        const int ko = A.depth_off(k);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (ko >= 0 && roff[i][h] >= 0)
              v = __ldg(reinterpret_cast<const uint4*>(
                  A.a + (size_t)roff[i][h] + ko));
            dst[i][h][0] = v.x;
            dst[i][h][1] = v.y;
            dst[i][h][2] = v.z;
            dst[i][h][3] = v.w;
          }
        }
        return;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int m = (base + i) * 16 + g;
        A.piece(m, k, dst[i][0]);
        A.piece(m + 8, k, dst[i][1]);
      }
    };
#pragma unroll
    for (int d = 0; d < D; ++d) load(c_begin + d, ring[d]);
    for (int c0 = c_begin; c0 < c_end; c0 += D) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int c = c0 + d;
        if (c < c_end) {
          unsigned b[NT][4];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            b_piece(bs + (nt * 8 + g) * ldb + c * KC + tig * E, b[nt]);
          mma_chunk<MT, NT, kRoundedSum>(acc, ring[d], b, T());
          if (c + D < c_end) load(c + D, ring[d]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int m = (base + i) * 16 + g, n = nt * 8 + 2 * tig;
        if (m < A.M) {
          dst_out[m * out_m + n * out_n] = acc[i][nt][0];
          dst_out[m * out_m + (n + 1) * out_n] = acc[i][nt][1];
        }
        if (m + 8 < A.M) {
          dst_out[(m + 8) * out_m + n * out_n] = acc[i][nt][2];
          dst_out[(m + 8) * out_m + (n + 1) * out_n] = acc[i][nt][3];
        }
      }
    }
  }
}

// ------------------------------------------------- cluster and cp.async --

__device__ __forceinline__ void add_to(float& s, float v) { s += v; }
__device__ __forceinline__ void add_to(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// The sum over ranks 0..C-1, in rank order, of the V (float or float4) at
// `p`'s offset in each CTA of the cluster.  All C loads are issued before
// the first add, so their latencies overlap.
template <typename V>
__device__ __forceinline__ V cluster_sum(
    const cooperative_groups::cluster_group& cluster, float* p, int C) {
  V v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    v[r] = r < C ? *reinterpret_cast<const V*>(cluster.map_shared_rank(p, r))
                 : V{};
  V s{};
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < C) add_to(s, v[r]);
  return s;
}

// Four adjacent elements of T copied from global to shared memory with
// cp.async (16 bytes for f32, 8 for bf16), asynchronously: the copy lands
// while the CTA works on, and cp_async_wait_all() waits for every copy this
// thread issued.  With valid = false it writes zeros and reads nothing.
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace lstm
