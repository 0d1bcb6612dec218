// LN-LSTM layer backward, V2: the whole reverse time loop inside one kernel
// launch, its gate columns spread over a thread-block cluster and both of
// its per-step products on the tensor cores.
//
// Replaces di_hpc_tpu/pallas_kernels/lstm_cell.py:_bwd_kernel_v2 (the train
// step at B >= 64).  Per step t = S-1 .. 0 and batch row b it recomputes the
// forward from the stashed streams -- gh_pre = h_{t-1} @ Wh (h_{t-1} =
// y_{t-1}, h0 at t = 0), both LayerNorms (LN_x on the raw gxp), the gates,
// c_t = f*c_{t-1} + i*u and tanh(c_t) -- then runs
//
//   dh = dh_carry + dy_t;  dc = dc_carry + dh*o*(1 - tanh(c_t)^2)
//   dgate = [dc*u*i(1-i), dc*c_{t-1}*f(1-f), dh*tanh(c_t)*o(1-o), dc*i(1-u^2)]
//   dgxp_t   = LN_x backward of dgate            (written out)
//   dg_pre_t = LN_h backward of dgate            (written out)
//   dh_carry = dg_pre_t @ Wh^T;  dc_carry = dc*f
//
// and sums dgamma_h = sum dgate*xhat_h, dgamma_x = sum dgate*xhat_x and
// sum dgate (dbeta_x, dbeta_h and dbias alike) over rows and steps; at the
// end it writes dh0/dc0.  dWh is left to two matrix products outside, as
// the JAX package leaves it to XLA (lstm_cell.py:642-643).
//
// What bounds it on an H100: the two products with Wh per step, 4*S*B*H*4H
// operations (35.4 GFLOP at S=33, B=256, H=512) against ~266 MB of streams.
// Done in f32-accurate 3xTF32 on the tensor cores (495/3 TFLOP/s) that is
// 0.215 ms: operations bound.
//
// Design.
// - A cluster of C CTAs owns R = kGroupRows = 24 batch rows for the whole
//   reverse loop.  CTA rank r owns the U = H/C units j in [r*U, (r+1)*U)
//   and, for each, the four gate columns q*H + j (NC = 4U columns, kept in
//   the order kk = q*U + u).  Each CTA reads only its own column slice of
//   Wh, and that slice serves both products.  24 rows, not 16: an H100
//   holds 15 clusters of 8 such CTAs at once (one per SM,
//   cudaOccupancyMaxActiveClusters), so B = 256 in groups of 16 would need
//   a second wave for its 16th cluster; in groups of 24 it is 11 clusters,
//   88 CTAs, one wave, and fewer groups stream Wh fewer times.
// - Other widths (lstm_mma.cuh:cluster_size, v2_rows): C is the largest
//   size up to 8 whose U is a multiple of 4, so that units, gate columns
//   and dh partials move in 16-byte pieces, if that size is at least 4;
//   else the largest divisor of H up to 8 (at least 4, as H % 4 == 0), and
//   the pieces go one element at a time.  Where 24 rows do not fit a CTA's
//   shared memory (H above about 520 in f32), a cluster owns
//   kSmallGroupRows = 8; with C >= 4 that fits every H up to about 950
//   (f32).
// - Per step, with every cross-CTA sum taken over ranks 0..C-1 in rank
//   order through distributed shared memory (cluster.map_shared_rank):
//     A  h_{t-1} (R x H, every CTA the full width), the raw gxp of the
//        own columns, and c_{t-1} and dy_t of the own units are in shared
//        memory: fetched with cp.async during step t+1, each as soon as the
//        tile it replaces was read for the last time there;
//     B  gh_pre^T(own cols) = Wh^T[own cols, :] @ h^T on the tensor cores;
//     C  per-row partial (sum, sum of squares) of gh_pre and gxp over the
//        own columns; cluster sync; every CTA adds all C partials, so all
//        hold the same LayerNorm statistics;
//     D  the cell backward of the own units; their dh/dc carries stay in
//        this CTA;
//     E  the LayerNorm-backward row means, exchanged as in C;
//     F  dgxp and dg_pre of the own columns out, the parameter sums of the
//        own columns added, dg_pre (rounded to the stream type) kept as the
//        next product's operand;
//     G  a partial dh (R x H) = dg_pre(own cols) @ Wh[:, own cols]^T on the
//        tensor cores; cluster sync; each CTA adds the C partials of its
//        own units (rows of the partial padded so that these reads, float4
//        a thread, are free of bank conflicts).
//   Three cluster syncs per step and no double buffer: each exchange buffer
//   is rewritten only after the next sync, which every peer reaches only
//   after its reads of that buffer.  A last sync keeps every CTA's shared
//   memory alive until its peers have read the final partials.
// - The products use mma.sync in the swap-AB form (lstm_mma.cuh:warp_gemm):
//   the gate columns (or the units) are the M = 16 side, the R batch rows
//   R/8 n = 8 tiles that reuse each A fragment.  A (Wh^T rows for B, Wh
//   rows for G) is read from L2 straight into a ring of registers; B (h, or
//   dg_pre) is a padded k-contiguous tile in shared memory.  bf16 streams
//   run m16n8k16 bf16 with f32 accumulation, f32 streams 3xTF32 on
//   m16n8k8, which keeps f32 accuracy.
// - The parameter sums stay in shared memory and are written once as this
//   CTA's columns of a (row groups, 3, 4H) f32 partial, which the caller
//   reduces with torch.sum in a fixed order: no float atomics, so repeated
//   runs are bitwise equal.  Rows past B load zeros for every input, so
//   their dgate is exactly zero and they add nothing to the sums.
// - bf16 streams keep the TPU kernel's rounding points: gh_pre is
//   recomputed from the bf16 h_{t-1} (lstm_cell.py:431-434) and c_t from the
//   bf16 c_{t-1} stash; d(gxp) and d(gh_pre) are stored as bf16, and the dh
//   carry is bf16(d(gh_pre)) @ Wh^T summed in f32 (:527-529).  The carries,
//   the gate math, the statistics and the sums are f32.
// - Tile edges are masked: H, NC and U need not be multiples of the MMA
//   tile (A pieces past the edge load zeros; the B tiles are zero-padded).

#include "lstm_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace lstm;

constexpr int kGroupRows = 24;              // batch rows per cluster
constexpr int kSmallGroupRows = 8;          // where 24 rows do not fit
static_assert(kGroupRows % 8 == 0 && kSmallGroupRows % 8 == 0,
              "the rows are whole n = 8 MMA tiles");

// Byte offsets of the shared-memory tiles of one CTA.
template <typename T>
struct V2Smem {
  int ldh, ldd, ldp;
  size_t h, dgop, x, gh, dg, dhp, dh, dc, cd, sum, stp, emp, st, cmap, bytes;
  __host__ __device__ V2Smem(int H, int C, int R) {
    const int U = H / C, NC = 4 * U;
    ldh = operand_ld<T>(H);
    ldd = operand_ld<T>(NC);
    ldp = H + 4;                                // 4 banks apart per row
    size_t at = 0;
    h = take(at, sizeof(T) * R * ldh);          // (R, ldh): h_{t-1}
    dgop = take(at, sizeof(T) * R * ldd);       // (R, ldd): dg_pre as T
    x = take(at, sizeof(T) * R * NC);           // (R, NC): raw gxp
    gh = take(at, 4 * R * NC);                  // (R, NC): gh_pre
    dg = take(at, 4 * R * NC);                  // (R, NC): dgate
    dhp = take(at, 4 * (size_t)R * ldp);        // (R, ldp): partial dh
    dh = take(at, 4 * R * U);                   // (R, U): dh carry
    dc = take(at, 4 * R * U);                   // (R, U): dc carry
    cd = take(at, sizeof(T) * 2 * R * U);       // (2, R, U): c_{t-1}, dy_t
    sum = take(at, 4 * 3 * NC);                 // (3, NC): parameter sums
    stp = take(at, 4 * R * 4);                  // (R, 4): statistic partials
    emp = take(at, 4 * R * 4);                  // (R, 4): LN-backward partials
    st = take(at, 4 * R * 8);                   // (R, 8): mean_h rstd_h mean_x
                                                //   rstd_x m1_h m2_h m1_x m2_x
    cmap = take(at, 4 * NC);                    // (NC,): kk -> gate column
    bytes = at;
  }
};

// ----------------------------------------------------------- the kernel --

template <typename T, int R>
__global__ void __launch_bounds__(kMmaThreads, 1)
lstm_layer_bwd_v2_kernel(const T* __restrict__ gxp,
                         const T* __restrict__ y,
                         const T* __restrict__ c_seq,
                         const T* __restrict__ dy,
                         const T* __restrict__ wh,
                         const T* __restrict__ whT,
                         const T* __restrict__ glnx,
                         const T* __restrict__ blnx,
                         const T* __restrict__ gln,
                         const T* __restrict__ bln,
                         const T* __restrict__ bias,
                         const T* __restrict__ h0,
                         const T* __restrict__ c0,
                         const T* __restrict__ dhn,
                         const T* __restrict__ dcn,
                         T* __restrict__ dgxp,
                         T* __restrict__ dgpre,
                         float* __restrict__ part,   // (groups, 3, 4H), f32
                         T* __restrict__ dh0,
                         T* __restrict__ dc0,
                         int S, int B, int H, int C, int norm) {
  constexpr int NT = R / 8;                   // the rows as n = 8 MMA tiles
  constexpr int E = 16 / sizeof(T);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int group = blockIdx.x / C;
  const int row0 = group * R;
  const int U = H / C, NC = 4 * U, G = 4 * H, j0 = rank * U;
  const bool uvec = U % 4 == 0;               // own units in 4-wide pieces
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float inv_g = 1.0f / (float)G;

  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const V2Smem<T> L(H, C, R);
  T* h_s = reinterpret_cast<T*>(base + L.h);
  T* dgop_s = reinterpret_cast<T*>(base + L.dgop);
  T* x_s = reinterpret_cast<T*>(base + L.x);
  float* gh_s = reinterpret_cast<float*>(base + L.gh);
  float* dg_s = reinterpret_cast<float*>(base + L.dg);
  float* dhp_s = reinterpret_cast<float*>(base + L.dhp);
  float* dh_s = reinterpret_cast<float*>(base + L.dh);
  float* dc_s = reinterpret_cast<float*>(base + L.dc);
  T* cp_s = reinterpret_cast<T*>(base + L.cd);
  T* dy_s = cp_s + R * U;
  float* sum_s = reinterpret_cast<float*>(base + L.sum);
  float* stp_s = reinterpret_cast<float*>(base + L.stp);
  float* emp_s = reinterpret_cast<float*>(base + L.emp);
  float* st_s = reinterpret_cast<float*>(base + L.st);
  int* cmap_s = reinterpret_cast<int*>(base + L.cmap);

  // The operand tiles are zero past their depth for the whole loop.
  {
    float4* z = reinterpret_cast<float4*>(base + L.h);
    const int n16 = (int)((L.x - L.h) / 16);
    for (int i = tid; i < n16; i += kMmaThreads)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int kk = tid; kk < NC; kk += kMmaThreads)
    cmap_s[kk] = (kk / U) * H + j0 + kk % U;
  for (int i = tid; i < R * U; i += kMmaThreads) {
    const int b = i / U, row = row0 + b;
    const size_t o = (size_t)row * H + j0 + (i - b * U);
    dh_s[i] = row < B ? to_f(dhn[o]) : 0.f;
    dc_s[i] = row < B ? to_f(dcn[o]) : 0.f;
  }
  for (int i = tid; i < 3 * NC; i += kMmaThreads) sum_s[i] = 0.f;
  __syncthreads();

  const AOperand<T, true> a_gh{whT, cmap_s, H, NC, H, H % E == 0};
  // F's ranges of rows: as many as give every thread an item, within R and
  // within the scratch that dhp_s holds.
  const int parts =
      max(1, min(min(kMmaThreads / NC, R), R * L.ldp / (3 * NC)));
  const AOperand<T, false> a_dh{wh, cmap_s, G, H, NC, U % E == 0};

  // What step t reads from its inputs, fetched into shared memory with
  // cp.async as soon as the tile it replaces has been read for the last time
  // in step t+1, so that the loads overlap step t+1's work (without uvec,
  // the own units' pieces are copied one element at a time, synchronously).
  // Rows past B are zeros.
  auto fetch_h = [&](int t) {                   // h_{t-1}: free after B
    const T* hp = t > 0 ? y + (size_t)(t - 1) * B * H : h0;
    const int hq = H / 4;
    for (int i = tid; i < R * hq; i += kMmaThreads) {
      const int b = i / hq, k = 4 * (i - b * hq), row = row0 + b;
      cp_async4(h_s + b * L.ldh + k, row < B ? hp + (size_t)row * H + k : hp,
                row < B);
    }
  };
  auto fetch_cd = [&](int t) {                  // c_{t-1}, dy_t: after D
    const T* cp_t = t > 0 ? c_seq + (size_t)(t - 1) * B * H : c0;
    const T* dy_t = dy + (size_t)t * B * H;
    if (!uvec) {
      for (int i = tid; i < R * U; i += kMmaThreads) {
        const int b = i / U, row = row0 + b;
        const size_t o = (size_t)row * H + j0 + (i - b * U);
        if (row < B) {
          cp_s[i] = cp_t[o];
          dy_s[i] = dy_t[o];
        } else {
          put(cp_s + i, 0.f);
          put(dy_s + i, 0.f);
        }
      }
      return;
    }
    const int uq = U / 4;
    for (int i = tid; i < R * uq; i += kMmaThreads) {
      const int b = i / uq, u = 4 * (i - b * uq), row = row0 + b;
      const size_t o = row < B ? (size_t)row * H + j0 + u : 0;
      cp_async4(cp_s + b * U + u, cp_t + o, row < B);
      cp_async4(dy_s + b * U + u, dy_t + o, row < B);
    }
  };
  auto fetch_x = [&](int t) {                   // gxp_t: after F
    const T* x_t = gxp + (size_t)t * B * G;
    if (!uvec) {
      for (int i = tid; i < R * NC; i += kMmaThreads) {
        const int b = i / NC, row = row0 + b;
        if (row < B) x_s[i] = x_t[(size_t)row * G + cmap_s[i - b * NC]];
        else put(x_s + i, 0.f);
      }
      return;
    }
    const int xq = NC / 4;
    for (int i = tid; i < R * xq; i += kMmaThreads) {
      const int b = i / xq, kk = 4 * (i - b * xq), row = row0 + b;
      cp_async4(x_s + b * NC + kk,
                row < B ? x_t + (size_t)row * G + cmap_s[kk] : x_t, row < B);
    }
  };
  fetch_h(S - 1);
  fetch_cd(S - 1);
  fetch_x(S - 1);
  cp_async_commit();

  for (int t = S - 1; t >= 0; --t) {
    // A. Wait for this step's h_{t-1}, gxp, c_{t-1} and dy_t, fetched
    //    during the step before.
    cp_async_wait_all();
    __syncthreads();

    // B. gh_pre of the own columns: gh^T = Wh^T[own cols, :] @ h^T.
    //    Two halves of the warps split K (the halves' sums land in gh_s and
    //    in dg_s, free until D, and are added in C).
    warp_gemm<T, NT, 2, 2>(a_gh, h_s, L.ldh, gh_s, dg_s, 1, NC);
    __syncthreads();
    if (t > 0) {
      fetch_h(t - 1);
      cp_async_commit();
    }

    // C. gh_pre = the two halves' sums; per-row partial LayerNorm sums
    //    over the own columns, then the cluster's statistics in rank order.
    for (int b = warp; b < R; b += kMmaWarps) {
      float sh = 0.f, sh2 = 0.f, sx = 0.f, sx2 = 0.f;
      for (int kk = lane; kk < NC; kk += 32) {
        const float g = gh_s[b * NC + kk] + dg_s[b * NC + kk];
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
      st_s[tid * 8 + 0] = mh;
      st_s[tid * 8 + 1] = rsqrtf(fmaxf(s.y * inv_g - mh * mh, 0.f) + kLnEps);
      st_s[tid * 8 + 2] = mx;
      st_s[tid * 8 + 3] = rsqrtf(fmaxf(s.w * inv_g - mx * mx, 0.f) + kLnEps);
    }
    __syncthreads();

    // D. Recompute the gates and run the cell backward of the own units.
    for (int i = tid; i < R * U; i += kMmaThreads) {
      const int b = i / U, u = i - b * U, j = j0 + u;
      const float* st = st_s + b * 8;
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kk = q * U + u, col = q * H + j;
        float xg = to_f(x_s[b * NC + kk]);
        float hg = gh_s[b * NC + kk];
        if (norm) {
          xg = (xg - st[2]) * st[3] * ldf(glnx + col) + ldf(blnx + col);
          hg = (hg - st[0]) * st[1] * ldf(gln + col) + ldf(bln + col);
        }
        pre[q] = (xg + ldf(bias + col)) + hg;
      }
      const float cp = to_f(cp_s[i]);
      const float dh = dh_s[i] + to_f(dy_s[i]);
      const float si = sigmoid_f(pre[0]);
      const float sf = sigmoid_f(pre[1]);
      const float so = sigmoid_f(pre[2]);
      const float su = tanhf(pre[3]);
      const float tc = tanhf(sf * cp + si * su);
      const float dc = dc_s[i] + dh * so * (1.f - tc * tc);
      dg_s[b * NC + u] = (dc * su) * si * (1.f - si);
      dg_s[b * NC + U + u] = (dc * cp) * sf * (1.f - sf);
      dg_s[b * NC + 2 * U + u] = (dh * tc) * so * (1.f - so);
      dg_s[b * NC + 3 * U + u] = (dc * si) * (1.f - su * su);
      dc_s[i] = dc * sf;
    }
    __syncthreads();
    if (t > 0) {
      fetch_cd(t - 1);
      cp_async_commit();
    }

    // E. LayerNorm-backward row means, m1 = mean(dgate*gamma) and m2 =
    //    mean(dgate*gamma*xhat) on both sides, exchanged as in C.
    if (norm) {
      for (int b = warp; b < R; b += kMmaWarps) {
        const float* st = st_s + b * 8;
        float s1 = 0.f, s2 = 0.f, s1x = 0.f, s2x = 0.f;
        for (int kk = lane; kk < NC; kk += 32) {
          const int col = cmap_s[kk];
          const float dg = dg_s[b * NC + kk];
          const float xh = (gh_s[b * NC + kk] - st[0]) * st[1];
          const float xx = (to_f(x_s[b * NC + kk]) - st[2]) * st[3];
          const float a = dg * ldf(gln + col), ax = dg * ldf(glnx + col);
          s1 += a;
          s2 += a * xh;
          s1x += ax;
          s2x += ax * xx;
        }
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        s1x = warp_sum(s1x);
        s2x = warp_sum(s2x);
        if (lane == 0) {
          emp_s[b * 4 + 0] = s1;
          emp_s[b * 4 + 1] = s2;
          emp_s[b * 4 + 2] = s1x;
          emp_s[b * 4 + 3] = s2x;
        }
      }
    }
    cluster.sync();
    if (norm && tid < R) {
      const float4 s = cluster_sum<float4>(cluster, emp_s + tid * 4, C);
      st_s[tid * 8 + 4] = s.x * inv_g;
      st_s[tid * 8 + 5] = s.y * inv_g;
      st_s[tid * 8 + 6] = s.z * inv_g;
      st_s[tid * 8 + 7] = s.w * inv_g;
    }
    __syncthreads();

    // F. One (own column, range of rows) per item, so that every thread
    //    has one: dgxp_t and dg_pre_t out, dg_pre kept as the dh product's
    //    operand.  Each range's parameter sums go to scratch in dhp_s (free
    //    until G) and are added to the running sums in range order.
    for (int item = tid; item < parts * NC; item += kMmaThreads) {
      const int part = item / NC, kk = item - part * NC;
      const int col = cmap_s[kk];
      const float g_h = norm ? ldf(gln + col) : 1.f;
      const float g_x = norm ? ldf(glnx + col) : 1.f;
      float a_h = 0.f, a_x = 0.f, a_s = 0.f;
      for (int b = part * R / parts; b < (part + 1) * R / parts; ++b) {
        const int row = row0 + b;
        const size_t o = ((size_t)t * B + row) * G + col;
        const float* st = st_s + b * 8;
        const float dg = dg_s[b * NC + kk];
        float gp = dg, gxo = dg;
        a_s += dg;
        if (norm) {
          const float xh = (gh_s[b * NC + kk] - st[0]) * st[1];
          const float xx = (to_f(x_s[b * NC + kk]) - st[2]) * st[3];
          gp = st[1] * (dg * g_h - st[4] - xh * st[5]);
          gxo = st[3] * (dg * g_x - st[6] - xx * st[7]);
          a_h += dg * xh;
          a_x += dg * xx;
        }
        if (row < B) {
          put(dgpre + o, gp);
          put(dgxp + o, gxo);
        }
        put(dgop_s + b * L.ldd + kk, gp);   // the stored value carries dh
      }
      float* sc = dhp_s + (size_t)part * 3 * NC;
      sc[kk] = a_h;
      sc[NC + kk] = a_x;
      sc[2 * NC + kk] = a_s;
    }
    __syncthreads();
    for (int kk = tid; kk < NC; kk += kMmaThreads) {
      float a_h = 0.f, a_x = 0.f, a_s = 0.f;
      for (int part = 0; part < parts; ++part) {
        const float* sc = dhp_s + (size_t)part * 3 * NC;
        a_h += sc[kk];
        a_x += sc[NC + kk];
        a_s += sc[2 * NC + kk];
      }
      sum_s[kk] += a_h;
      sum_s[NC + kk] += a_x;
      sum_s[2 * NC + kk] += a_s;
    }
    __syncthreads();
    if (t > 0) {
      fetch_x(t - 1);
      cp_async_commit();
    }

    // G. Partial dh^T = Wh[:, own cols] @ dg_pre^T(own cols); the cluster's
    //    partials of the own units added in rank order; dh0/dc0 at t = 0.
    warp_gemm<T, NT, 2, 1>(a_dh, dgop_s, L.ldd, dhp_s, nullptr, 1, L.ldp);
    cluster.sync();
    if (uvec) {
      const int uq = U / 4;
      for (int i = tid; i < R * uq; i += kMmaThreads) {
        const int b = i / uq, u = 4 * (i - b * uq), row = row0 + b;
        const float4 d =
            cluster_sum<float4>(cluster, dhp_s + b * L.ldp + j0 + u, C);
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
        const float d = cluster_sum<float>(cluster, dhp_s + b * L.ldp + j0 + u,
                                           C);
        dh_s[i] = d;
        if (t == 0 && row < B) {
          const size_t o = (size_t)row * H + j0 + u;
          put(dh0 + o, d);
          put(dc0 + o, dc_s[i]);
        }
      }
    }
  }

  float* out = part + (size_t)group * 3 * G;
  for (int kk = tid; kk < NC; kk += kMmaThreads) {
    const int col = cmap_s[kk];
    out[col] = sum_s[kk];
    out[G + col] = sum_s[NC + kk];
    out[2 * G + col] = sum_s[2 * NC + kk];
  }
  // Peers may still be reading this CTA's last dh partial.
  cluster.sync();
}

// ------------------------------------------------------------------ host --

// Batch rows per cluster at hidden size H (see Design).
template <typename T>
int v2_rows(int H) {
  return V2Smem<T>(H, cluster_size(H), kGroupRows).bytes <= kSmemLimit
             ? kGroupRows
             : kSmallGroupRows;
}

template <typename T>
size_t v2_smem(int H) {
  return V2Smem<T>(H, cluster_size(H), v2_rows<T>(H)).bytes;
}

template <typename T>
using V2Kernel = decltype(&lstm_layer_bwd_v2_kernel<T, kGroupRows>);

// The instantiation that runs at hidden size H, with its shared memory
// allowed.
template <typename T>
int prepare_v2(int H, V2Kernel<T>* kernel) {
  *kernel = v2_rows<T>(H) == kGroupRows
                ? &lstm_layer_bwd_v2_kernel<T, kGroupRows>
                : &lstm_layer_bwd_v2_kernel<T, kSmallGroupRows>;
  return (int)cudaFuncSetAttribute(*kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)v2_smem<T>(H));
}

template <typename T>
cudaLaunchConfig_t v2_config(int B, int H, void* stream,
                             cudaLaunchAttribute* attr) {
  const int C = cluster_size(H), R = v2_rows<T>(H);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + R - 1) / R * C);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = v2_smem<T>(H);
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
int launch_v2(const T* gxp, const T* y, const T* c_seq, const T* dy,
              const T* wh, const T* whT, const T* glnx, const T* blnx,
              const T* gln, const T* bln, const T* bias, const T* h0,
              const T* c0, const T* dhn, const T* dcn, T* dgxp, T* dgpre,
              float* part, T* dh0, T* dc0, int S, int B, int H, int norm,
              void* stream) {
  V2Kernel<T> kernel = nullptr;
  int err = prepare_v2<T>(H, &kernel);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = v2_config<T>(B, H, stream, attr);
  err = (int)cudaLaunchKernelEx(&cfg, kernel, gxp, y, c_seq, dy, wh, whT,
                                glnx, blnx, gln, bln, bias, h0, c0, dhn, dcn,
                                dgxp, dgpre, part, dh0, dc0, S, B, H,
                                cluster_size(H), norm);
  return err != 0 ? err : (int)cudaGetLastError();
}

template <typename T>
int max_active_clusters(int B, int H) {
  V2Kernel<T> kernel = nullptr;
  int err = prepare_v2<T>(H, &kernel);
  if (err != 0) return -err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = v2_config<T>(B, H, nullptr, attr);
  int n = 0;
  err = (int)cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err != 0 ? -err : n;
}

}  // namespace

extern "C" {

// Batch rows per cluster, and the cluster size (CTAs), at hidden size H
// for `item`-byte streams (4: f32, 2: bf16).
int lstm_layer_bwd_v2_rows_per_group(int H, int item) {
  return item == 2 ? v2_rows<bf16>(H) : v2_rows<float>(H);
}

int lstm_layer_bwd_v2_cluster_size(int H) { return cluster_size(H); }

// Dynamic shared memory of one CTA at hidden size H for `item`-byte
// streams.
long long lstm_layer_bwd_v2_smem_bytes(int H, int item) {
  return (long long)(item == 2 ? v2_smem<bf16>(H) : v2_smem<float>(H));
}

// cudaOccupancyMaxActiveClusters for the launch at (B, H, item): how many
// clusters the card holds at once; a negative value is a CUDA error.
int lstm_layer_bwd_v2_max_active_clusters(int B, int H, int item) {
  return item == 2 ? max_active_clusters<bf16>(B, H)
                   : max_active_clusters<float>(B, H);
}

// gxp (S, B, 4H), y, c_seq, dy (S, B, H), wh (H, 4H), whT (4H, H) its
// contiguous transpose, the five (4H,) vectors, h0/c0/dhn/dcn (B, H) in;
// dgxp, dgpre (S, B, 4H), part (ceil(B/rows), 3, 4H) f32, dh0/dc0 (B, H)
// out, rows = lstm_layer_bwd_v2_rows_per_group(H, item).
// All but part of one type (f32 or bf16), contiguous, H % 4 == 0, gxp, wh
// and whT 16-byte aligned.  Returns the launch status (cudaSuccess == 0).
int lstm_layer_bwd_v2_f32(const float* gxp, const float* y,
                          const float* c_seq, const float* dy,
                          const float* wh, const float* whT,
                          const float* glnx, const float* blnx,
                          const float* gln, const float* bln,
                          const float* bias, const float* h0, const float* c0,
                          const float* dhn, const float* dcn, float* dgxp,
                          float* dgpre, float* part, float* dh0, float* dc0,
                          int S, int B, int H, int norm, void* stream) {
  return launch_v2(gxp, y, c_seq, dy, wh, whT, glnx, blnx, gln, bln, bias, h0,
                   c0, dhn, dcn, dgxp, dgpre, part, dh0, dc0, S, B, H, norm,
                   stream);
}

int lstm_layer_bwd_v2_bf16(const bf16* gxp, const bf16* y, const bf16* c_seq,
                           const bf16* dy, const bf16* wh, const bf16* whT,
                           const bf16* glnx, const bf16* blnx,
                           const bf16* gln, const bf16* bln, const bf16* bias,
                           const bf16* h0, const bf16* c0, const bf16* dhn,
                           const bf16* dcn, bf16* dgxp, bf16* dgpre,
                           float* part, bf16* dh0, bf16* dc0, int S, int B,
                           int H, int norm, void* stream) {
  return launch_v2(gxp, y, c_seq, dy, wh, whT, glnx, blnx, gln, bln, bias, h0,
                   c0, dhn, dcn, dgxp, dgpre, part, dh0, dc0, S, B, H, norm,
                   stream);
}

}  // extern "C"
