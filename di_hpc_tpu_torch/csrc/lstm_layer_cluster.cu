// LN-LSTM layer forward, the whole time loop inside one kernel launch, its
// gate columns spread over a thread-block cluster and h @ Wh on the tensor
// cores.
//
// Replaces di_hpc_tpu/pallas_kernels/lstm_cell.py:_layer_kernel (called at
// :219), with f32 or bf16 streams, in both of its modes: given c_seq, the
// kernel also writes the cell state of every step for the backward; without
// it (the serving path, S = 1 included, and any forward that needs no
// gradient) that (S, B, H) write is skipped, as the TPU kernel skips it
// (lstm_cell.py:150-153).  Per step t and batch row b:
//
//   gate = LN_x(gxp_t) + bias + LN_h(h @ Wh)      (norm = 1)
//   gate = gxp_t + bias + h @ Wh                   (norm = 0)
//   i, f, o = sigmoid, u = tanh (gate order i|f|o|u)
//   c = f*c + i*u;  h = o*tanh(c);  y_t = h  [c_seq_t = c]
//
// LayerNorm statistics are one pass over the 4H row, var = max(E[x^2] -
// E[x]^2, 0), as the TPU kernel's _ln_stats; LN_x and the bias act on the
// RAW x @ Wx projection gxp, which the caller computes outside.
//
// bf16 streams (T = __nv_bfloat16), as the TPU kernel's notes at
// lstm_cell.py:130-141 set them: gxp, Wh, the five vectors, h0/c0 and every
// output are bf16; the c carry, the gate math and both LayerNorms'
// statistics stay f32.  h enters the product rounded to bf16 (:106), which
// is the value y stores, so the h tiles hold the rounded h.  y, c_seq, h_n
// and c_n are the f32 values rounded once at the store.
//
// What bounds it on an H100: the h @ Wh product, 2*S*B*H*4H operations
// (17.7 GFLOP at S=33, B=256, H=512) against ~93 MB of streams (f32).  Done
// in f32-accurate 3xTF32 on the tensor cores (495/3 TFLOP/s) that is 0.107
// ms; in bf16 at 989 TFLOP/s, 0.018 ms: operations bound.
//
// Design.
// - A cluster of C CTAs owns R batch rows for the whole loop.  CTA rank r
//   owns the U = H/C units j in [r*U, (r+1)*U) and, for each, the four gate
//   columns q*H + j (NC = 4U columns, kept in the order kk = q*U + u), and
//   reads only those columns of Wh: an eighth of it at C = 8.  C follows
//   lstm_mma.cuh:cluster_size (4-8 CTAs dividing H, 16-byte pieces where U
//   % 4 == 0).  R (fwd_rows) is the fewest of 8, 16 and 24 rows that hold
//   B, and 24 for larger B, within what fits the CTA's shared memory: at
//   B = 256, H = 512 that is 11 clusters of 8 CTAs, one wave on an H100,
//   which holds 15 such clusters at once (cudaOccupancyMaxActiveClusters).
// - Per step t, with every cross-CTA sum taken over ranks 0..C-1 in rank
//   order through distributed shared memory (lstm_mma.cuh:cluster_sum):
//     A  h_{t-1} (R x H, every CTA the full width, rounded to T) is in this
//        CTA's h tile; the raw gxp_t of the own columns was fetched with
//        cp.async during step t-1;
//     B  gh^T(own cols) = Wh^T[own cols, :] @ h^T on the tensor cores, Wh
//        read down its columns from L2 (lstm_mma.cuh:AColumns; no
//        transposed copy, so the C entry points take Wh as it is);
//     C  per-row partial (sum, sum of squares) of gh and gxp over the own
//        columns; cluster sync; every CTA adds all C partials, so all hold
//        the same LayerNorm statistics;
//     D  the gate math and the c update of the own units (their c carry
//        stays in this CTA); y [and c_seq] of the own units out, h_n and
//        c_n at t = S-1; h_t, rounded to T, stored into the h tile of every
//        CTA of the cluster; then gxp_{t+1} fetched;
//     E  cluster sync: every CTA's h tile holds h_t.
//   Two cluster syncs per step and one h tile: a peer writes a CTA's h tile
//   in D only after the sync of C, which that CTA reaches only after its
//   product has read the tile; the statistic partials are rewritten only
//   after E, which every peer reaches only after reading them.  The last
//   step's E keeps shared memory alive until the peers' last reads.
// - The product is lstm_mma.cuh:warp_gemm in the swap-AB form: the own
//   gate columns are the M = 16 side, the R rows R/8 n = 8 tiles; two
//   halves of the warps split K.  bf16: m16n8k16 with f32 accumulation.
//   f32: 3xTF32 on m16n8k8, which keeps f32 accuracy, each k step's three
//   MMAs summed from zero and added to the accumulator by a rounded f32 add
//   (lstm_mma.cuh:mma_chunk, kRoundedSum), since the recurrence carries the
//   tensor cores' truncating accumulation on from step to step.
// - No float atomics: repeated runs are bitwise equal, and the stash and
//   no-stash instantiations (one template, kStash) give the same y, h_n and
//   c_n.  Rows past B load zeros and are never written.
// - Widths: every H % 4 == 0 whose plan fits at 8 rows (far beyond the 726
//   that the 8-row kernel fits).  H % 4 != 0 goes, by shape, to the 8-row
//   kernel of lstm_layer.cu (layer_launch_shape reports the route).

#include <type_traits>

#include "lstm_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace lstm;

constexpr int kMaxRows = 24;

// Byte offsets of the shared-memory tiles of one CTA.
template <typename T>
struct FwdSmem {
  int ldh;
  size_t h, x, gh, gh2, c, par, stp, st, cmap, bytes;
  __host__ __device__ FwdSmem(int H, int C, int R) {
    const int U = H / C, NC = 4 * U;
    ldh = operand_ld<T>(H);
    size_t at = 0;
    h = take(at, sizeof(T) * R * ldh);      // (R, ldh): h_{t-1}, full width
    x = take(at, sizeof(T) * R * NC);       // (R, NC): raw gxp_t
    gh = take(at, 4 * R * NC);              // (R, NC): gh, first half of K
    gh2 = take(at, 4 * R * NC);             // (R, NC): gh, second half of K
    c = take(at, 4 * R * U);                // (R, U): c carry
    par = take(at, 4 * 5 * NC);             // (5, NC): glnx blnx gln bln bias
    stp = take(at, 4 * R * 4);              // (R, 4): statistic partials
    st = take(at, 4 * R * 4);               // (R, 4): mean_h rstd_h mean_x
                                            //   rstd_x
    cmap = take(at, 4 * NC);                // (NC,): kk -> gate column
    bytes = at;
  }
};

// V adjacent elements of T in shared memory as float (V = 4: one 16-byte
// load for f32, 8 for bf16, aligned to match).
__device__ __forceinline__ void lds(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void lds(const bf16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = bf16_lo(u.x); v[1] = bf16_hi(u.x);
  v[2] = bf16_lo(u.y); v[3] = bf16_hi(u.y);
}
template <typename T>
__device__ __forceinline__ void lds(const T* p, float (&v)[1]) {
  v[0] = to_f(*p);
}

// V floats stored as T, each rounded once (V = 4: one 16-byte store for
// f32, 8 for bf16).  p may lie in a peer's shared memory.
__device__ __forceinline__ void stv(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void stv(bf16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
template <typename T>
__device__ __forceinline__ void stv(T* p, const float (&v)[1]) {
  put(p, v[0]);
}

template <typename T, int R, bool kStash>
__global__ void __launch_bounds__(kMmaThreads, 1)
lstm_layer_cluster_kernel(const T* __restrict__ gxp,
                          const T* __restrict__ wh,
                          const T* __restrict__ glnx,
                          const T* __restrict__ blnx,
                          const T* __restrict__ gln,
                          const T* __restrict__ bln,
                          const T* __restrict__ bias,
                          const T* __restrict__ h0,
                          const T* __restrict__ c0,
                          T* __restrict__ y,
                          T* __restrict__ c_seq,          // kStash only
                          T* __restrict__ hn,
                          T* __restrict__ cn,
                          int S, int B, int H, int C, int norm) {
  constexpr int NT = R / 8;                   // the rows as n = 8 MMA tiles
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / C) * R;
  const int U = H / C, NC = 4 * U, G = 4 * H, j0 = rank * U;
  const bool uvec = U % 4 == 0;               // own units in 4-wide pieces
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float inv_g = 1.0f / (float)G;

  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const FwdSmem<T> L(H, C, R);
  T* h_s = reinterpret_cast<T*>(base + L.h);
  T* x_s = reinterpret_cast<T*>(base + L.x);
  float* gh_s = reinterpret_cast<float*>(base + L.gh);
  float* gh2_s = reinterpret_cast<float*>(base + L.gh2);
  float* c_s = reinterpret_cast<float*>(base + L.c);
  float* par_s = reinterpret_cast<float*>(base + L.par);
  float* stp_s = reinterpret_cast<float*>(base + L.stp);
  float* st_s = reinterpret_cast<float*>(base + L.st);
  int* cmap_s = reinterpret_cast<int*>(base + L.cmap);
  auto col_of = [&](int kk) { return (kk / U) * H + j0 + kk % U; };

  // What step t reads from gxp: the own columns of its R rows (zeros past
  // B), by cp.async in 4-element pieces where U % 4 == 0, else one element
  // at a time, synchronously.
  auto fetch_x = [&](int t) {
    const T* x_t = gxp + (size_t)t * B * G;
    if (!uvec) {
      for (int i = tid; i < R * NC; i += kMmaThreads) {
        const int b = i / NC, row = row0 + b;
        if (row < B) x_s[i] = x_t[(size_t)row * G + col_of(i - b * NC)];
        else put(x_s + i, 0.f);
      }
      return;
    }
    const int xq = NC / 4;
    for (int i = tid; i < R * xq; i += kMmaThreads) {
      const int b = i / xq, kk = 4 * (i - b * xq), row = row0 + b;
      cp_async4(x_s + b * NC + kk,
                row < B ? x_t + (size_t)row * G + col_of(kk) : x_t, row < B);
    }
  };
  fetch_x(0);
  cp_async_commit();

  // h0 at the full width (zero past H, and for rows past B), the own units'
  // c0, the own columns' parameters.
  for (int i = tid; i < R * L.ldh; i += kMmaThreads) {
    const int b = i / L.ldh, k = i - b * L.ldh, row = row0 + b;
    if (row < B && k < H) h_s[i] = h0[(size_t)row * H + k];
    else put(h_s + i, 0.f);
  }
  for (int i = tid; i < R * U; i += kMmaThreads) {
    const int b = i / U, row = row0 + b;
    c_s[i] = row < B ? to_f(c0[(size_t)row * H + j0 + (i - b * U)]) : 0.f;
  }
  const T* vecs[5] = {glnx, blnx, gln, bln, bias};
  for (int kk = tid; kk < NC; kk += kMmaThreads) {
    const int col = col_of(kk);
    cmap_s[kk] = col;
#pragma unroll
    for (int v = 0; v < 5; ++v) par_s[v * NC + kk] = ldf(vecs[v] + col);
  }
  __syncthreads();

  const AColumns<T> a_gh{wh, cmap_s, G, NC, H};

  // D for V adjacent own units u..u+V-1 of row b at step t.
  auto cell = [&](auto width, int t, int b, int u) {
    constexpr int V = decltype(width)::value;
    const int row = row0 + b;
    const float* st = st_s + b * 4;
    float pre[4][V];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = q * U + u;
      float xg[V], hg[V], p[5][V];
      lds(x_s + b * NC + kk, xg);
      lds(gh_s + b * NC + kk, hg);
#pragma unroll
      for (int v = 0; v < 5; ++v) lds(par_s + v * NC + kk, p[v]);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float xv = xg[e], hv = hg[e];
        if (norm) {
          xv = (xv - st[2]) * st[3] * p[0][e] + p[1][e];
          hv = (hv - st[0]) * st[1] * p[2][e] + p[3][e];
        }
        pre[q][e] = (xv + p[4][e]) + hv;
      }
    }
    float hv[V], cv[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float ig = sigmoid_f(pre[0][e]);
      const float fg = sigmoid_f(pre[1][e]);
      const float og = sigmoid_f(pre[2][e]);
      const float ug = tanhf(pre[3][e]);
      cv[e] = fg * c_s[b * U + u + e] + ig * ug;
      hv[e] = og * tanhf(cv[e]);
      c_s[b * U + u + e] = cv[e];
    }
    if (row < B) {
      const size_t o = ((size_t)t * B + row) * H + j0 + u;
      stv(y + o, hv);
      if (kStash) stv(c_seq + o, cv);
      if (t == S - 1) {
        stv(hn + (size_t)row * H + j0 + u, hv);
        stv(cn + (size_t)row * H + j0 + u, cv);
      }
    }
    if (t + 1 < S) {
      T* mine = h_s + b * L.ldh + j0 + u;
      for (int r = 0; r < C; ++r) stv(cluster.map_shared_rank(mine, r), hv);
    }
  };

  for (int t = 0; t < S; ++t) {
    // B. gh^T(own cols) = Wh^T[own cols, :] @ h_{t-1}^T; the two halves'
    //    sums land in gh_s and gh2_s and are added in C.
    warp_gemm<T, NT, 2, 2, AColumns<T>, true>(a_gh, h_s, L.ldh, gh_s, gh2_s,
                                              1, NC);
    cp_async_wait_all();                      // this step's gxp
    __syncthreads();

    // C. Per-row partial LayerNorm sums over the own columns, then the
    //    cluster's statistics in rank order.
    for (int b = warp; b < R; b += kMmaWarps) {
      float sh = 0.f, sh2 = 0.f, sx = 0.f, sx2 = 0.f;
      for (int kk = lane; kk < NC; kk += 32) {
        const float g = gh_s[b * NC + kk] + gh2_s[b * NC + kk];
        const float x = to_f(x_s[b * NC + kk]);
        gh_s[b * NC + kk] = g;
        sh += g;
        sh2 += g * g;
        sx += x;
        sx2 += x * x;
      }
      sh = warp_sum(sh);
      sh2 = warp_sum(sh2);
      sx = warp_sum(sx);
      sx2 = warp_sum(sx2);
      if (lane == 0) {
        stp_s[b * 4 + 0] = sh;
        stp_s[b * 4 + 1] = sh2;
        stp_s[b * 4 + 2] = sx;
        stp_s[b * 4 + 3] = sx2;
      }
    }
    cluster.sync();
    if (tid < R) {
      const float4 s = cluster_sum<float4>(cluster, stp_s + tid * 4, C);
      const float mh = s.x * inv_g, mx = s.z * inv_g;
      st_s[tid * 4 + 0] = mh;
      st_s[tid * 4 + 1] = rsqrtf(fmaxf(s.y * inv_g - mh * mh, 0.f) + kLnEps);
      st_s[tid * 4 + 2] = mx;
      st_s[tid * 4 + 3] = rsqrtf(fmaxf(s.w * inv_g - mx * mx, 0.f) + kLnEps);
    }
    __syncthreads();

    // D. The own units' step; h_t into every CTA's h tile.
    if (uvec) {
      const int uq = U / 4;
      for (int i = tid; i < R * uq; i += kMmaThreads)
        cell(std::integral_constant<int, 4>(), t, i / uq, 4 * (i % uq));
    } else {
      for (int i = tid; i < R * U; i += kMmaThreads)
        cell(std::integral_constant<int, 1>(), t, i / U, i % U);
    }
    __syncthreads();
    if (t + 1 < S) {
      fetch_x(t + 1);
      cp_async_commit();
    }

    // E. Every CTA's h tile holds h_t.
    cluster.sync();
  }
}

// ------------------------------------------------------------------ host --

template <typename T>
size_t fwd_smem(int H, int R) {
  return FwdSmem<T>(H, cluster_size(H), R).bytes;
}

// Batch rows per cluster at (B, H): the fewest of 8, 16, 24 that hold B,
// else the most that fit.
template <typename T>
int fwd_rows(int B, int H) {
  int most = 8;
  for (int r = 16; r <= kMaxRows; r += 8)
    if (fwd_smem<T>(H, r) <= kSmemLimit) most = r;
  for (int r = 8; r < most; r += 8)
    if (B <= r) return r;
  return most;
}

template <typename T>
using FwdKernel = decltype(&lstm_layer_cluster_kernel<T, 8, false>);

template <typename T, bool kStash>
FwdKernel<T> fwd_kernel(int R) {
  return R == 24   ? &lstm_layer_cluster_kernel<T, 24, kStash>
         : R == 16 ? &lstm_layer_cluster_kernel<T, 16, kStash>
                   : &lstm_layer_cluster_kernel<T, 8, kStash>;
}

// The instantiation for R rows (8, 16 or 24; any other R is an error) and
// the stash mode, with its shared memory allowed.
template <typename T>
int prepare_fwd(int H, int R, bool stash, FwdKernel<T>* kernel) {
  if (R != 8 && R != 16 && R != 24) return (int)cudaErrorInvalidValue;
  *kernel = stash ? fwd_kernel<T, true>(R) : fwd_kernel<T, false>(R);
  return (int)cudaFuncSetAttribute(*kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)fwd_smem<T>(H, R));
}

template <typename T>
cudaLaunchConfig_t fwd_config(int B, int H, int R, void* stream,
                              cudaLaunchAttribute* attr) {
  const int C = cluster_size(H);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + R - 1) / R * C);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = fwd_smem<T>(H, R);
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
int launch_cluster(const T* gxp, const T* wh, const T* glnx, const T* blnx,
                   const T* gln, const T* bln, const T* bias, const T* h0,
                   const T* c0, T* y, T* c_seq, T* hn, T* cn, int S, int B,
                   int H, int norm, int R, void* stream) {
  FwdKernel<T> kernel = nullptr;
  int err = prepare_fwd<T>(H, R, c_seq != nullptr, &kernel);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fwd_config<T>(B, H, R, stream, attr);
  err = (int)cudaLaunchKernelEx(&cfg, kernel, gxp, wh, glnx, blnx, gln, bln,
                                bias, h0, c0, y, c_seq, hn, cn, S, B, H,
                                cluster_size(H), norm);
  return err != 0 ? err : (int)cudaGetLastError();
}

template <typename T>
int max_active_clusters(int B, int H, int R) {
  FwdKernel<T> kernel = nullptr;
  int err = prepare_fwd<T>(H, R, false, &kernel);
  if (err != 0) return -err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fwd_config<T>(B, H, R, nullptr, attr);
  int n = 0;
  err = (int)cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err != 0 ? -err : n;
}

}  // namespace

extern "C" {

// The 8-row kernel (lstm_layer.cu), which takes H % 4 != 0.
int lstm_layer_fwd8_f32(const float*, const float*, const float*,
                        const float*, const float*, const float*,
                        const float*, const float*, const float*, float*,
                        float*, float*, float*, int, int, int, int, void*);
int lstm_layer_fwd8_bf16(const bf16*, const bf16*, const bf16*, const bf16*,
                         const bf16*, const bf16*, const bf16*, const bf16*,
                         const bf16*, bf16*, bf16*, bf16*, bf16*, int, int,
                         int, int, void*);
long long lstm_layer_fwd8_smem_bytes(int H);

// CTAs per cluster at hidden size H; 0 where H % 4 != 0, which takes the
// 8-row kernel (one CTA per 8 rows, no cluster).
int lstm_layer_fwd_cluster_size(int H) {
  return H % 4 == 0 ? cluster_size(H) : 0;
}

// Batch rows per cluster (per CTA on the 8-row route) at (B, H) for
// `item`-byte streams (4: f32, 2: bf16).
int lstm_layer_fwd_rows_per_group(int B, int H, int item) {
  if (H % 4 != 0) return kRows;
  return item == 2 ? fwd_rows<bf16>(B, H) : fwd_rows<float>(B, H);
}

// Dynamic shared memory of one CTA at hidden size H with R rows per group
// (R ignored on the 8-row route).
long long lstm_layer_fwd_smem_bytes(int H, int item, int R) {
  if (H % 4 != 0) return lstm_layer_fwd8_smem_bytes(H);
  return (long long)(item == 2 ? fwd_smem<bf16>(H, R) : fwd_smem<float>(H, R));
}

// The least shared memory a CTA of H's route needs (8 rows): what must fit
// for the forward to run at all.
long long lstm_layer_smem_bytes(int H, int item) {
  return lstm_layer_fwd_smem_bytes(H, item, 8);
}

// cudaOccupancyMaxActiveClusters for the launch at (B, H, item) with R rows
// per group: how many clusters the card holds at once; a negative value is
// a CUDA error, 0 the 8-row route.
int lstm_layer_fwd_max_active_clusters(int B, int H, int item, int R) {
  if (H % 4 != 0) return 0;
  return item == 2 ? max_active_clusters<bf16>(B, H, R)
                   : max_active_clusters<float>(B, H, R);
}

// gxp (S, B, 4H), wh (H, 4H), the five (4H,) vectors, h0/c0 (B, H) in;
// y (S, B, H), c_seq (S, B, H) or nullptr, hn/cn (B, H) out.  All of one
// type (f32 or bf16), contiguous, gxp and wh 16-byte aligned.  H % 4 == 0
// runs the cluster kernel with lstm_layer_fwd_rows_per_group rows, any
// other H the 8-row kernel.  Returns the launch status (cudaSuccess == 0).
int lstm_layer_fwd_f32(const float* gxp, const float* wh, const float* glnx,
                       const float* blnx, const float* gln, const float* bln,
                       const float* bias, const float* h0, const float* c0,
                       float* y, float* c_seq, float* hn, float* cn, int S,
                       int B, int H, int norm, void* stream) {
  if (H % 4 != 0)
    return lstm_layer_fwd8_f32(gxp, wh, glnx, blnx, gln, bln, bias, h0, c0,
                               y, c_seq, hn, cn, S, B, H, norm, stream);
  return launch_cluster(gxp, wh, glnx, blnx, gln, bln, bias, h0, c0, y,
                        c_seq, hn, cn, S, B, H, norm,
                        fwd_rows<float>(B, H), stream);
}

int lstm_layer_fwd_bf16(const bf16* gxp, const bf16* wh, const bf16* glnx,
                        const bf16* blnx, const bf16* gln, const bf16* bln,
                        const bf16* bias, const bf16* h0, const bf16* c0,
                        bf16* y, bf16* c_seq, bf16* hn, bf16* cn, int S,
                        int B, int H, int norm, void* stream) {
  if (H % 4 != 0)
    return lstm_layer_fwd8_bf16(gxp, wh, glnx, blnx, gln, bln, bias, h0, c0,
                                y, c_seq, hn, cn, S, B, H, norm, stream);
  return launch_cluster(gxp, wh, glnx, blnx, gln, bln, bias, h0, c0, y,
                        c_seq, hn, cn, S, B, H, norm, fwd_rows<bf16>(B, H),
                        stream);
}

// The cluster kernel at an explicit R (8, 16 or 24 rows per group, within
// the shared memory), for measuring the candidates; H % 4 == 0 only.
// `item` says the stream type of the pointers (4: f32, 2: bf16).
int lstm_layer_fwd_at_rows(int item, int R, const void* gxp, const void* wh,
                           const void* glnx, const void* blnx,
                           const void* gln, const void* bln, const void* bias,
                           const void* h0, const void* c0, void* y,
                           void* c_seq, void* hn, void* cn, int S, int B,
                           int H, int norm, void* stream) {
  if (H % 4 != 0) return (int)cudaErrorInvalidValue;
  if (item == 2) {
    using P = const bf16*;
    return launch_cluster((P)gxp, (P)wh, (P)glnx, (P)blnx, (P)gln, (P)bln,
                          (P)bias, (P)h0, (P)c0, (bf16*)y, (bf16*)c_seq,
                          (bf16*)hn, (bf16*)cn, S, B, H, norm, R, stream);
  }
  using P = const float*;
  return launch_cluster((P)gxp, (P)wh, (P)glnx, (P)blnx, (P)gln, (P)bln,
                        (P)bias, (P)h0, (P)c0, (float*)y, (float*)c_seq,
                        (float*)hn, (float*)cn, S, B, H, norm, R, stream);
}

}  // extern "C"
