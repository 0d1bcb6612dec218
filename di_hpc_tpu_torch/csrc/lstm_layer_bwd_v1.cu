// LN-LSTM layer backward, V1: the whole reverse time loop inside one kernel
// launch, its gate columns spread over a thread-block cluster and the dh
// carry's product dg_pre @ Wh^T on the tensor cores.  (V2, the variant for
// B >= 64, is lstm_layer_bwd_v2.cu.)
//
// Replaces di_hpc_tpu/pallas_kernels/lstm_cell.py:_bwd_kernel (B < 64; body
// at :276, pallas_call at :365).  Per step t = S-1 .. 0 and batch row b, from
// streams the caller precomputes -- the x-side gate gx = LN_x(gxp) + bias and
// gh_pre = h_{t-1} @ Wh -- and the stashed c_{t-1}, c_t, it runs
//
//   dh = dh_carry + dy_t;  dc = dc_carry + dh*o*(1 - tanh(c_t)^2)
//   dgate = [dc*u*i(1-i), dc*c_{t-1}*f(1-f), dh*tanh(c_t)*o(1-o), dc*i(1-u^2)]
//   dg_pre_t = LN_h backward of dgate
//   dh_carry = dg_pre_t @ Wh^T;  dc_carry = dc*f
//
// and writes dgate and dg_pre; at the end dh0/dc0.  The LN_x backward, dWh,
// dgamma/dbeta and dbias are the caller's (lstm_cell.py:658-706).
//
// What bounds it on an H100: its bytes and its operations are even (45.6 MB
// and 2.2 GFLOP at S=33, B=32, H=512 in f32, 0.014 ms each at 3.35 TB/s and
// the 3xTF32 rate), but the steps are sequential and B < 64 rows fill only a
// few SMs, so the least time is set by each step's critical path: one product
// with all of Wh and three exchanges across CTAs.
//
// Design.
// - A cluster of C CTAs owns R batch rows (a group) for the whole reverse
//   loop.  CTA rank r owns the U = H/C units j in [r*U, (r+1)*U) and, for
//   each, the four gate columns q*H + j (NC = 4U columns, kept in the order
//   kk = q*U + u), and reads only those columns of every stream and of Wh.
//   The route (v1_cluster, v1_rows): C = 16 CTAs (a non-portable cluster
//   size) where H % 64 == 0, else lstm_mma.cuh:cluster_size (4-8 CTAs
//   dividing H); R = 8 rows while the groups fit in one wave of kCtaBudget
//   CTAs, else 16 where that fits.  16-CTA clusters halve each CTA's slice
//   of Wh against 8, and an H100 holds 7 of them at once
//   (cudaOccupancyMaxActiveClusters), so B = 32 runs 4 clusters of 8 rows.
// - Per step, with every cross-CTA sum taken over ranks 0..C-1 in rank order
//   through distributed shared memory (cluster_sum_wide):
//     A  gh_pre_t and gx_t of the own columns, c_{t-1}, c_t and dy_t of the
//        own units are in shared memory: fetched with cp.async during step
//        t+1, each as soon as the tile it replaces was read for the last time
//        there;
//     C  per-row partial (sum, sum of squares) of gh_pre over the own
//        columns; cluster sync; every CTA adds all C partials, so all hold
//        the same LayerNorm statistics;
//     D  the cell backward of the own units; their dh/dc carries stay in this
//        CTA;
//     E  the LayerNorm-backward row means, exchanged as in C;
//     F  dgate and dg_pre of the own columns out, dg_pre (rounded to the
//        stream type) kept as the product's operand;
//     G  a partial dh (R x H) = dg_pre(own cols) @ Wh[:, own cols]^T on the
//        tensor cores (lstm_mma.cuh:warp_gemm in the swap-AB form: the H
//        units are the M = 16 side, the rows R/8 n = 8 tiles), Wh's rows read
//        directly (no transposed copy); cluster sync; each CTA adds the C
//        partials of its own units.
//   Three cluster syncs per step and no double buffer: each exchange buffer
//   is rewritten only after the next sync, which every peer reaches only
//   after its reads of that buffer.  A last sync keeps every CTA's shared
//   memory alive until its peers have read the final partials.
// - bf16 streams keep the TPU kernel's rounding points (lstm_cell.py:658-706):
//   gx, c_{t-1}, c_t, dy and Wh are bf16, gh_pre is f32; dgate, d(gh_pre),
//   dh0 and dc0 come out bf16; the dh carry is bf16(d(gh_pre)) @ Wh^T summed
//   in f32 (m16n8k16 bf16 MMAs).  f32 streams run 3xTF32 on m16n8k8, which
//   keeps f32 accuracy.  The carries, the gate math and the statistics are
//   f32.
// - No float atomics: repeated runs are bitwise equal.  Rows past B load
//   zeros for every input, so their dgate and dg_pre are exactly zero.
// - Widths: every H % 4 == 0 whose plan fits at 8 rows (with C >= 4, every
//   such H up to 724 and well beyond).  Units that are no multiple of 4, and
//   streams that are not 16-byte aligned, move one element at a time; the
//   MMA tiles are masked at their edges.

#include <cstdint>
#include <initializer_list>

#include "lstm_mma.cuh"

namespace lstm {

__device__ __forceinline__ void add_to(float2& s, const float2& v) {
  s.x += v.x;
  s.y += v.y;
}

}  // namespace lstm

namespace {

namespace cg = cooperative_groups;
using namespace lstm;

constexpr int kMaxV1Cluster = 2 * kMaxCluster;  // non-portable on sm_90
// CTAs of 16-CTA clusters that an H100 runs at once (7 clusters, one CTA per
// SM; cudaOccupancyMaxActiveClusters): 8-row groups while they fit in one
// wave of as many CTAs.
constexpr int kCtaBudget = 112;

// Byte offsets of the shared-memory tiles of one CTA.
template <typename T>
struct V1Smem {
  int ld, ldp;
  size_t dgop, x, gh, dg, dhp, dh, dc, cd, par, stp, emp, st, cmap, bytes;
  __host__ __device__ V1Smem(int H, int C, int R) {
    const int U = H / C, NC = 4 * U;
    ld = operand_ld<T>(NC);
    ldp = H + 4;                                // 4 banks apart per row
    size_t at = 0;
    dgop = take(at, sizeof(T) * R * ld);        // (R, ld): dg_pre as T
    x = take(at, sizeof(T) * R * NC);           // (R, NC): gx
    gh = take(at, 4 * R * NC);                  // (R, NC): gh_pre
    dg = take(at, 4 * R * NC);                  // (R, NC): dgate
    dhp = take(at, 4 * (size_t)R * ldp);        // (R, ldp): partial dh
    dh = take(at, 4 * R * U);                   // (R, U): dh carry
    dc = take(at, 4 * R * U);                   // (R, U): dc carry
    cd = take(at, sizeof(T) * 3 * R * U);       // (3, R, U): c_{t-1} c_t dy_t
    par = take(at, 4 * 2 * NC);                 // (2, NC): gln bln
    stp = take(at, 4 * R * 2);                  // (R, 2): statistic partials
    emp = take(at, 4 * R * 2);                  // (R, 2): LN-backward partials
    st = take(at, 4 * R * 4);                   // (R, 4): mean rstd m1 m2
    cmap = take(at, 4 * NC);                    // (NC,): kk -> gate column
    bytes = at;
  }
};

// lstm_mma.cuh:cluster_sum for clusters of up to 16 CTAs: the loads go in
// batches of up to 8 (all issued before the batch's first add), and the adds
// run over ranks 0..C-1 in rank order, so every CTA gets the same bits.
template <typename V>
__device__ __forceinline__ V cluster_sum_wide(const cg::cluster_group& cluster,
                                              float* p, int C) {
  V s{};
  for (int r0 = 0; r0 < C; r0 += kMaxCluster) {
    V v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      v[r] = r0 + r < C ? *reinterpret_cast<const V*>(
                              cluster.map_shared_rank(p, r0 + r))
                        : V{};
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r0 + r < C) add_to(s, v[r]);
  }
  return s;
}

// ----------------------------------------------------------- the kernel --

template <typename T, int R>
__global__ void __launch_bounds__(kMmaThreads, 1)
lstm_layer_bwd_v1_kernel(const T* __restrict__ gx,
                         const float* __restrict__ ghp,  // f32 for any T
                         const T* __restrict__ c_prev,
                         const T* __restrict__ c_seq,
                         const T* __restrict__ dy,
                         const T* __restrict__ wh,
                         const T* __restrict__ gln,
                         const T* __restrict__ bln,
                         const T* __restrict__ dhn,
                         const T* __restrict__ dcn,
                         T* __restrict__ dgate,
                         T* __restrict__ dgpre,
                         T* __restrict__ dh0,
                         T* __restrict__ dc0,
                         int S, int B, int H, int C, int norm, int aligned) {
  constexpr int NT = R / 8;                   // the rows as n = 8 MMA tiles
  constexpr int E = 16 / sizeof(T);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / C) * R;
  const int U = H / C, NC = 4 * U, G = 4 * H, j0 = rank * U;
  const bool u4 = U % 4 == 0;                 // own units in 4-wide pieces
  const bool uvec = u4 && aligned;            // ... also from global memory
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float inv_g = 1.0f / (float)G;

  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const V1Smem<T> L(H, C, R);
  T* dgop_s = reinterpret_cast<T*>(base + L.dgop);
  T* x_s = reinterpret_cast<T*>(base + L.x);
  float* gh_s = reinterpret_cast<float*>(base + L.gh);
  float* dg_s = reinterpret_cast<float*>(base + L.dg);
  float* dhp_s = reinterpret_cast<float*>(base + L.dhp);
  float* dh_s = reinterpret_cast<float*>(base + L.dh);
  float* dc_s = reinterpret_cast<float*>(base + L.dc);
  T* cp_s = reinterpret_cast<T*>(base + L.cd);
  T* cs_s = cp_s + R * U;
  T* dy_s = cs_s + R * U;
  float* par_s = reinterpret_cast<float*>(base + L.par);
  float* stp_s = reinterpret_cast<float*>(base + L.stp);
  float* emp_s = reinterpret_cast<float*>(base + L.emp);
  float* st_s = reinterpret_cast<float*>(base + L.st);
  int* cmap_s = reinterpret_cast<int*>(base + L.cmap);

  // The operand tile (dg_pre) is zero past its depth for the whole loop.
  {
    float4* z = reinterpret_cast<float4*>(base + L.dgop);
    const int n16 = (int)((L.x - L.dgop) / 16);
    for (int i = tid; i < n16; i += kMmaThreads)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int kk = tid; kk < NC; kk += kMmaThreads) {
    const int col = (kk / U) * H + j0 + kk % U;
    cmap_s[kk] = col;
    par_s[kk] = ldf(gln + col);
    par_s[NC + kk] = ldf(bln + col);
  }
  for (int i = tid; i < R * U; i += kMmaThreads) {
    const int b = i / U, row = row0 + b;
    const size_t o = (size_t)row * H + j0 + (i - b * U);
    dh_s[i] = row < B ? to_f(dhn[o]) : 0.f;
    dc_s[i] = row < B ? to_f(dcn[o]) : 0.f;
  }
  __syncthreads();

  // What step t reads from its inputs, fetched into shared memory with
  // cp.async as soon as the tile it replaces has been read for the last time
  // in step t+1, so that the loads overlap step t+1's work (without uvec,
  // the pieces are copied one element at a time, synchronously).  Rows past
  // B are zeros.
  auto fetch_xc = [&](int t) {                // gx_t, c_{t-1}, c_t, dy_t
    const T* x_t = gx + (size_t)t * B * G;
    const size_t so = (size_t)t * B * H;
    const T* cp_t = c_prev + so;
    const T* cs_t = c_seq + so;
    const T* dy_t = dy + so;
    if (!uvec) {
      for (int i = tid; i < R * NC; i += kMmaThreads) {
        const int b = i / NC, row = row0 + b;
        if (row < B) x_s[i] = x_t[(size_t)row * G + cmap_s[i - b * NC]];
        else put(x_s + i, 0.f);
      }
      for (int i = tid; i < R * U; i += kMmaThreads) {
        const int b = i / U, row = row0 + b;
        const size_t o = (size_t)row * H + j0 + (i - b * U);
        if (row < B) {
          cp_s[i] = cp_t[o];
          cs_s[i] = cs_t[o];
          dy_s[i] = dy_t[o];
        } else {
          put(cp_s + i, 0.f);
          put(cs_s + i, 0.f);
          put(dy_s + i, 0.f);
        }
      }
      return;
    }
    const int xq = NC / 4;
    for (int i = tid; i < R * xq; i += kMmaThreads) {
      const int b = i / xq, kk = 4 * (i - b * xq), row = row0 + b;
      cp_async4(x_s + b * NC + kk,
                row < B ? x_t + (size_t)row * G + cmap_s[kk] : x_t, row < B);
    }
    const int uq = U / 4;
    for (int i = tid; i < R * uq; i += kMmaThreads) {
      const int b = i / uq, u = 4 * (i - b * uq), row = row0 + b;
      const size_t o = row < B ? (size_t)row * H + j0 + u : 0;
      cp_async4(cp_s + b * U + u, cp_t + o, row < B);
      cp_async4(cs_s + b * U + u, cs_t + o, row < B);
      cp_async4(dy_s + b * U + u, dy_t + o, row < B);
    }
  };
  auto fetch_gh = [&](int t) {                // gh_pre_t
    const float* g_t = ghp + (size_t)t * B * G;
    if (!uvec) {
      for (int i = tid; i < R * NC; i += kMmaThreads) {
        const int b = i / NC, row = row0 + b;
        gh_s[i] = row < B ? g_t[(size_t)row * G + cmap_s[i - b * NC]] : 0.f;
      }
      return;
    }
    const int xq = NC / 4;
    for (int i = tid; i < R * xq; i += kMmaThreads) {
      const int b = i / xq, kk = 4 * (i - b * xq), row = row0 + b;
      cp_async4(gh_s + b * NC + kk,
                row < B ? g_t + (size_t)row * G + cmap_s[kk] : g_t, row < B);
    }
  };
  fetch_xc(S - 1);
  fetch_gh(S - 1);
  cp_async_commit();

  const AOperand<T, false> a_dh{wh, cmap_s, G, H, NC,
                                aligned != 0 && U % E == 0};

  for (int t = S - 1; t >= 0; --t) {
    // A. Wait for this step's inputs, fetched during the step before.
    cp_async_wait_all();
    __syncthreads();

    // C. Per-row partial LayerNorm sums of gh_pre over the own columns,
    //    then the cluster's statistics in rank order.
    if (norm) {
      for (int b = warp; b < R; b += kMmaWarps) {
        float s = 0.f, s2 = 0.f;
        for (int kk = lane; kk < NC; kk += 32) {
          const float g = gh_s[b * NC + kk];
          s += g;
          s2 += g * g;
        }
        s = warp_sum(s);
        s2 = warp_sum(s2);
        if (lane == 0) {
          stp_s[b * 2 + 0] = s;
          stp_s[b * 2 + 1] = s2;
        }
      }
    }
    cluster.sync();
    if (norm && tid < R) {
      const float2 s = cluster_sum_wide<float2>(cluster, stp_s + tid * 2, C);
      const float m = s.x * inv_g;
      st_s[tid * 4 + 0] = m;
      st_s[tid * 4 + 1] = rsqrtf(fmaxf(s.y * inv_g - m * m, 0.f) + kLnEps);
    }
    __syncthreads();

    // D. gate = gx + LN_h(gh_pre); the cell backward of the own units.
    for (int i = tid; i < R * U; i += kMmaThreads) {
      const int b = i / U, u = i - b * U;
      const float* st = st_s + b * 4;
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kk = q * U + u;
        float hg = gh_s[b * NC + kk];
        if (norm) hg = (hg - st[0]) * st[1] * par_s[kk] + par_s[NC + kk];
        pre[q] = to_f(x_s[b * NC + kk]) + hg;
      }
      const float cp = to_f(cp_s[i]);
      const float tc = tanhf(to_f(cs_s[i]));
      const float dh = dh_s[i] + to_f(dy_s[i]);
      const float si = sigmoid_f(pre[0]);
      const float sf = sigmoid_f(pre[1]);
      const float so = sigmoid_f(pre[2]);
      const float su = tanhf(pre[3]);
      const float dc = dc_s[i] + dh * so * (1.f - tc * tc);
      dg_s[b * NC + u] = (dc * su) * si * (1.f - si);
      dg_s[b * NC + U + u] = (dc * cp) * sf * (1.f - sf);
      dg_s[b * NC + 2 * U + u] = (dh * tc) * so * (1.f - so);
      dg_s[b * NC + 3 * U + u] = (dc * si) * (1.f - su * su);
      dc_s[i] = dc * sf;
    }
    __syncthreads();
    if (t > 0) {
      fetch_xc(t - 1);
      cp_async_commit();
    }

    // E. LayerNorm-backward row means, m1 = mean(dgate*gamma) and m2 =
    //    mean(dgate*gamma*xhat), exchanged as in C.
    if (norm) {
      for (int b = warp; b < R; b += kMmaWarps) {
        const float* st = st_s + b * 4;
        float s1 = 0.f, s2 = 0.f;
        for (int kk = lane; kk < NC; kk += 32) {
          const float a = dg_s[b * NC + kk] * par_s[kk];
          s1 += a;
          s2 += a * ((gh_s[b * NC + kk] - st[0]) * st[1]);
        }
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        if (lane == 0) {
          emp_s[b * 2 + 0] = s1;
          emp_s[b * 2 + 1] = s2;
        }
      }
    }
    cluster.sync();
    if (norm && tid < R) {
      const float2 s = cluster_sum_wide<float2>(cluster, emp_s + tid * 2, C);
      st_s[tid * 4 + 2] = s.x * inv_g;
      st_s[tid * 4 + 3] = s.y * inv_g;
    }
    __syncthreads();

    // F. dgate_t and dg_pre_t of the own columns out; dg_pre kept, rounded
    //    to T, as the dh product's operand.
    for (int i = tid; i < R * NC; i += kMmaThreads) {
      const int b = i / NC, kk = i - b * NC, row = row0 + b;
      const float dg = dg_s[i];
      float gp = dg;
      if (norm) {
        const float* st = st_s + b * 4;
        const float xh = (gh_s[i] - st[0]) * st[1];
        gp = st[1] * (dg * par_s[kk] - st[2] - xh * st[3]);
      }
      if (row < B) {
        const size_t o = ((size_t)t * B + row) * G + cmap_s[kk];
        put(dgate + o, dg);
        put(dgpre + o, gp);
      }
      put(dgop_s + b * L.ld + kk, gp);   // the stored value carries dh
    }
    __syncthreads();
    if (t > 0) {
      fetch_gh(t - 1);
      cp_async_commit();
    }

    // G. Partial dh^T = Wh[:, own cols] @ dg_pre^T(own cols); the cluster's
    //    partials of the own units added in rank order; dh0/dc0 at t = 0.
    //    f32: the MMAs accumulate in the tensor cores, as V2's dh product
    //    does; over 33 steps that stays within 1e-5 of max|out| of the
    //    plain version (the forward's 64 serving steps needed kRoundedSum).
    warp_gemm<T, NT, 2, 1>(a_dh, dgop_s, L.ld, dhp_s, nullptr, 1, L.ldp);
    cluster.sync();
    if (u4) {
      const int uq = U / 4;
      for (int i = tid; i < R * uq; i += kMmaThreads) {
        const int b = i / uq, u = 4 * (i - b * uq), row = row0 + b;
        const float4 d = cluster_sum_wide<float4>(
            cluster, dhp_s + b * L.ldp + j0 + u, C);
        *reinterpret_cast<float4*>(dh_s + b * U + u) = d;
        if (t == 0 && row < B) {
          const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const size_t o = (size_t)row * H + j0 + u + e;
            put(dh0 + o, dv[e]);
            put(dc0 + o, dc_s[b * U + u + e]);
          }
        }
      }
    } else {
      for (int i = tid; i < R * U; i += kMmaThreads) {
        const int b = i / U, u = i - b * U, row = row0 + b;
        const float d = cluster_sum_wide<float>(
            cluster, dhp_s + b * L.ldp + j0 + u, C);
        dh_s[i] = d;
        if (t == 0 && row < B) {
          const size_t o = (size_t)row * H + j0 + u;
          put(dh0 + o, d);
          put(dc0 + o, dc_s[i]);
        }
      }
    }
  }
  // Peers may still be reading this CTA's last dh partial.
  cluster.sync();
}

// ------------------------------------------------------------------ host --

template <typename T>
size_t v1_smem(int H, int C, int R) {
  return V1Smem<T>(H, C, R).bytes;
}

// The route's cluster size at hidden size H (see Design); 0 where H % 4 != 0.
int v1_cluster(int H) {
  if (H % 4 != 0) return 0;
  return H % 64 == 0 ? kMaxV1Cluster : cluster_size(H);
}

// Batch rows per group: 8 while the groups of B rows fit in kCtaBudget CTAs,
// else 16 where that fits.
template <typename T>
int v1_rows(int B, int H, int C) {
  const bool one_wave = (B + 7) / 8 * C <= kCtaBudget;
  return one_wave || v1_smem<T>(H, C, 16) > kSmemLimit ? 8 : 16;
}

template <typename T>
using V1Kernel = decltype(&lstm_layer_bwd_v1_kernel<T, 8>);

// The instantiation of a route, with its shared memory and cluster size
// allowed; an R other than 8 or 16, a C that does not divide H or exceeds
// 16, or a plan over the shared memory is an error.
template <typename T>
int prepare_v1(int H, int C, int R, V1Kernel<T>* kernel) {
  if ((R != 8 && R != 16) || C < 1 || C > kMaxV1Cluster || H % C != 0 ||
      v1_smem<T>(H, C, R) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  *kernel = R == 16 ? &lstm_layer_bwd_v1_kernel<T, 16>
                    : &lstm_layer_bwd_v1_kernel<T, 8>;
  int err = (int)cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)v1_smem<T>(H, C, R));
  if (err == 0 && C > kMaxCluster)
    err = (int)cudaFuncSetAttribute(
        *kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <typename T>
cudaLaunchConfig_t v1_config(int B, int H, int C, int R, void* stream,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + R - 1) / R * C);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = v1_smem<T>(H, C, R);
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

template <typename T>
int launch_v1(const T* gx, const float* ghp, const T* c_prev, const T* c_seq,
              const T* dy, const T* wh, const T* gln, const T* bln,
              const T* dhn, const T* dcn, T* dgate, T* dgpre, T* dh0, T* dc0,
              int S, int B, int H, int norm, int C, int R, void* stream) {
  V1Kernel<T> kernel = nullptr;
  int err = prepare_v1<T>(H, C, R, &kernel);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = v1_config<T>(B, H, C, R, stream, attr);
  const int aligned = aligned16({gx, ghp, c_prev, c_seq, dy, wh});
  err = (int)cudaLaunchKernelEx(&cfg, kernel, gx, ghp, c_prev, c_seq, dy, wh,
                                gln, bln, dhn, dcn, dgate, dgpre, dh0, dc0, S,
                                B, H, C, norm, aligned);
  return err != 0 ? err : (int)cudaGetLastError();
}

template <typename T>
int max_active_clusters(int B, int H, int C, int R) {
  V1Kernel<T> kernel = nullptr;
  int err = prepare_v1<T>(H, C, R, &kernel);
  if (err != 0) return -err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = v1_config<T>(B, H, C, R, nullptr, attr);
  int n = 0;
  err = (int)cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err != 0 ? -err : n;
}

}  // namespace

extern "C" {

// The route at batch B and hidden size H for `item`-byte streams (4: f32,
// 2: bf16): CTAs per cluster (0 where H % 4 != 0), and batch rows per group
// for a cluster of C.
int lstm_layer_bwd_v1_cluster_size(int H) { return v1_cluster(H); }

int lstm_layer_bwd_v1_rows_per_group(int B, int H, int item, int C) {
  return item == 2 ? v1_rows<bf16>(B, H, C) : v1_rows<float>(B, H, C);
}

// Dynamic shared memory of one CTA of the route (H, C, R).
long long lstm_layer_bwd_v1_smem_bytes(int H, int item, int C, int R) {
  return (long long)(item == 2 ? v1_smem<bf16>(H, C, R)
                               : v1_smem<float>(H, C, R));
}

// cudaOccupancyMaxActiveClusters for the route at (B, H, item): how many
// clusters the card holds at once; a negative value is a CUDA error.
int lstm_layer_bwd_v1_max_active_clusters(int B, int H, int item, int C,
                                          int R) {
  return item == 2 ? max_active_clusters<bf16>(B, H, C, R)
                   : max_active_clusters<float>(B, H, C, R);
}

// V1.  gx, gh_pre (S, B, 4H), c_prev, c_seq, dy (S, B, H), wh (H, 4H),
// gln/bln (4H,), dhn/dcn (B, H) in; dgate, dgpre (S, B, 4H), dh0/dc0 (B, H)
// out; the route (C CTAs per cluster, R rows per group) from the functions
// above.  gh_pre is f32 for either type; all else of one type (f32 or
// bf16), contiguous, H % 4 == 0.  Returns the launch status (cudaSuccess ==
// 0; cudaErrorInvalidValue for a route the kernel does not take).
int lstm_layer_bwd_v1_f32(const float* gx, const float* ghp,
                          const float* c_prev, const float* c_seq,
                          const float* dy, const float* wh, const float* gln,
                          const float* bln, const float* dhn, const float* dcn,
                          float* dgate, float* dgpre, float* dh0, float* dc0,
                          int S, int B, int H, int norm, int C, int R,
                          void* stream) {
  return launch_v1(gx, ghp, c_prev, c_seq, dy, wh, gln, bln, dhn, dcn, dgate,
                   dgpre, dh0, dc0, S, B, H, norm, C, R, stream);
}

int lstm_layer_bwd_v1_bf16(const bf16* gx, const float* ghp,
                           const bf16* c_prev, const bf16* c_seq,
                           const bf16* dy, const bf16* wh, const bf16* gln,
                           const bf16* bln, const bf16* dhn, const bf16* dcn,
                           bf16* dgate, bf16* dgpre, bf16* dh0, bf16* dc0,
                           int S, int B, int H, int norm, int C, int R,
                           void* stream) {
  return launch_v1(gx, ghp, c_prev, c_seq, dy, wh, gln, bln, dhn, dcn, dgate,
                   dgpre, dh0, dc0, S, B, H, norm, C, R, stream);
}

}  // extern "C"
