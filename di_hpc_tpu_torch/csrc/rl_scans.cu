// Row-constant-coefficient reverse recurrences: GAE, the lambda-returns and
// the TD(lambda) loss and error.
//
// Replaces four kernels of di_hpc_tpu/pallas_kernels/rl_scans.py, which all
// run _suffix_scan with a (T, 1) coefficient:
//   - _gae_kernel: delta_t = r_t + gamma*V_{t+1} - V_t,
//     y_t = denom_t*delta_t + gamma*lambda*y_{t+1} (y_T = 0), adv_t = y_t /
//     denom_t, with denom (T,) given by the caller (ops.scan.gae_denominators,
//     so both sides divide by the same numbers): gae_chunked_kernel;
//   - _lret_kernel, _tdl_loss_kernel, _tdl_err_kernel, which share _lret_body:
//     ret_{T-1} = r_{T-1} + gamma*V_T and, below it,
//     ret_t = r_t + (gamma - gamma*lambda)*V_{t+1} + gamma*lambda*ret_{t+1}:
//     td_lambda_chunked_kernel, templated on its epilogue, writes the returns
//     plane, sums (ret_t - V_t)^2 over t (the loss) or writes e_t = ret_t -
//     V_t (the error plane, the loss's backward).
// And the two UPGO kernels, whose coefficient is a full (T, B) plane of
// binary lambdas derived from the data (_upgo_kernel, _upgo_loss_kernel),
// further below.
//
// What bounds it on an H100: memory.  Each input element is read once and
// costs under 10 f32 operations.  At T=1024, B=4096 the GAE, returns and
// error kernels move 50.3 MB each (15 us at 3.35 TB/s), the loss kernel
// 33.6 MB (10 us), each UPGO kernel 67.1 MB (20 us).
//
// One walk.  Every kernel here takes the chunked walk of csrc/vtrace.cu,
// with its pieces from csrc/chunked_scan.cuh: a CTA owns `cols` columns x
// `chunks` chunks of 8 steps, loads one super-tile ahead, composes each
// chunk's affine pair, folds the pairs in one fixed order and re-walks each
// chunk from its carry-in (the design notes at those kernels).  No kernel
// walks one column with one thread.
// Columns past B neither load nor store.  The loss kernels write one partial
// per column into a (1, B) buffer that the caller sums in a fixed order (no
// float atomics), so repeated runs are bitwise equal and a ragged B adds
// nothing to the sum.

#include "chunked_scan.cuh"

namespace {

using namespace chunked_scan;

// A thread's chunk of the TD(lambda) and GAE walks: kChunk steps of r and
// the kChunk + 1 value rows V_t0 ... V_t0+kChunk (the row past a chunk is
// the next chunk's first, read again from the L2); zeros past T, before 0
// or past B.
struct TdChunk {
  float r[kChunk], v[kChunk + 1];
};

__device__ __forceinline__ void load_td_chunk(TdChunk& c,
                                              const float* __restrict__ value,
                                              const float* __restrict__ reward,
                                              int t0, int col, int T, int B) {
  const bool in_col = col < B && t0 >= 0;
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const bool in = in_col && t0 + u < T;
    c.r[u] = load_once(reward + (in ? (size_t)(t0 + u) * B + col : 0), in);
  }
#pragma unroll
  for (int u = 0; u <= kChunk; ++u) {
    const bool in = in_col && t0 + u <= T;
    c.v[u] = load_once(value + (in ? (size_t)(t0 + u) * B + col : 0), in);
  }
}

// The TD(lambda) loss partials sum_t (ret_t - V_t)^2 (kLossSum), the error
// plane e_t = ret_t - V_t (kError) and the returns plane ret_t (kReturns),
// chunked over T.
//
// With the boundary ret_T = V_T, every step has the same pair coefficients:
// ret_t = d_t + gamma*lambda * ret_{t+1}, d_t = r_t + (gamma -
// gamma*lambda)*V_{t+1}, and the last step, r + (gamma - gamma*lambda)*V_T +
// gamma*lambda*V_T, is _lret_body's r + gamma*V_T up to one rounding.  Steps
// past T are the identity -- d = 0 (r and V load as 0 there) and coefficient
// 1, not gamma*lambda -- so that ret stays V_T above T; zeros would give
// ret = 0.  The epilogue re-walks each chunk from its carry-in.  kLossSum
// adds (ret_t - V_t)^2 for t < T to the thread's partial; the chunk partials
// of a column are summed in shared memory in lane order, and one partial per
// column goes to the (1, B) buffer.  kError stores e_t and kReturns ret_t
// for t < T and col < B (coalesced: neighbouring lanes own neighbouring
// columns); neither needs partials.  All three share every step up to the
// epilogue, so each keeps its bits whichever instances run.  The returns'
// last step, d + gamma*lambda*V_T, is _lret_body's r + gamma*V_T up to the
// one rounding above; the plain version keeps JAX's form.
enum class TdEpilogue { kLossSum, kError, kReturns };

template <TdEpilogue kEpi>
__global__ void __launch_bounds__(kMaxThreads)
td_lambda_chunked_kernel(const float* __restrict__ value,
                         const float* __restrict__ reward,
                         float* __restrict__ out, int T, int B, float gamma,
                         float gamma_lambda) {
  extern __shared__ float smem[];
  const int cols = blockDim.x, chunks = blockDim.y;
  const int x = threadIdx.x, own = threadIdx.y;
  const int col = blockIdx.x * cols + x;
  const int plane = cols * chunks;
  // pairs[parity][0: A, 1: D][chunk][col]; the loss's sums[chunk][col].
  float* pairs = smem;
  const float g_v = gamma - gamma_lambda;

  const int tile = chunks * kChunk;
  int st = (T + tile - 1) / tile - 1;            // the last super-tile
  TdChunk cur, nxt;
  load_td_chunk(cur, value, reward, st * tile + own * kChunk, col, T, B);
  float carry = col < B ? value[(size_t)T * B + col] : 0.f;   // ret_T = V_T
  float sum = 0.f;
  for (int parity = 0; st >= 0; --st, parity ^= 1) {
    const int t0 = st * tile + own * kChunk;
    load_td_chunk(nxt, value, reward, t0 - tile, col, T, B);

    float d[kChunk], c[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      d[u] = cur.r[u] + g_v * cur.v[u + 1];
      c[u] = t0 + u < T ? gamma_lambda : 1.f;
    }
    float A, D;
    compose<true>(d, c, A, D);
    float* pa = pairs + parity * 2 * plane;
    pa[own * cols + x] = A;
    pa[plane + own * cols + x] = D;
    __syncthreads();

    float ret = fold_pairs<true>(pa, plane, cols, chunks, x, own, carry);
#pragma unroll
    for (int u = kChunk - 1; u >= 0; --u) {
      ret = d[u] + c[u] * ret;
      if (col < B && t0 + u < T) {
        const float e = ret - cur.v[u];
        if constexpr (kEpi == TdEpilogue::kLossSum) {
          sum += e * e;
        } else if constexpr (kEpi == TdEpilogue::kError) {
          out[(size_t)(t0 + u) * B + col] = e;
        } else {
          out[(size_t)(t0 + u) * B + col] = ret;
        }
      }
    }
    cur = nxt;
  }

  if constexpr (kEpi == TdEpilogue::kLossSum)
    store_column_sum(smem + 4 * plane, sum, cols, chunks, x, own, col, B,
                     out);
}

// GAE, chunked over T: y_t = a_t + gamma*lambda * y_{t+1} from y_T = 0, with
// a_t = denom_t * (r_t + gamma*V_{t+1} - V_t), and adv_t = y_t / denom_t.
//
// A thread's chunk holds td_lambda_chunked_kernel's r and V rows and the
// chunk's kChunk denominators.  Those are one (T,) row that every column of
// the CTA shares; they are read with __ldg, a super-tile ahead with the
// other streams, and not staged in shared memory: the row is 4 KB at T=1024,
// stays in L1 and L2 after the first CTA's reads, and the lanes of a warp
// that share a chunk read the same address (one broadcast), so staging
// would save no device-memory bytes and cost a second barrier per super-tile.
// load_once's no-allocate hint is kept for the streams read once.  Steps
// past T compose to the identity: a = 0 (set explicitly, since V_T loads
// there and delta would be -V_T) and coefficient 1, denominator 1 (nothing
// is divided by it).  The epilogue re-walks each chunk from its carry-in and
// stores adv_t = y_t / denom_t for t < T and col < B with an IEEE divide
// (__fdiv_rn), as the plain version and JAX divide.
struct GaeChunk {
  TdChunk rv;
  float den[kChunk];
};

__device__ __forceinline__ void load_gae_chunk(GaeChunk& c,
                                               const float* __restrict__ value,
                                               const float* __restrict__ reward,
                                               const float* __restrict__ denom,
                                               int t0, int col, int T, int B) {
  load_td_chunk(c.rv, value, reward, t0, col, T, B);
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const int t = t0 + u;
    c.den[u] = t >= 0 && t < T ? __ldg(denom + t) : 1.f;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
gae_chunked_kernel(const float* __restrict__ value,
                   const float* __restrict__ reward,
                   const float* __restrict__ denom, float* __restrict__ adv,
                   int T, int B, float gamma, float gamma_lambda) {
  extern __shared__ float pairs[];   // [parity][0: A, 1: D][chunk][col]
  const int cols = blockDim.x, chunks = blockDim.y;
  const int x = threadIdx.x, own = threadIdx.y;
  const int col = blockIdx.x * cols + x;
  const int plane = cols * chunks;

  const int tile = chunks * kChunk;
  int st = (T + tile - 1) / tile - 1;            // the last super-tile
  GaeChunk cur, nxt;
  load_gae_chunk(cur, value, reward, denom, st * tile + own * kChunk, col, T,
                 B);
  float carry = 0.f;                             // y_T = 0
  for (int parity = 0; st >= 0; --st, parity ^= 1) {
    const int t0 = st * tile + own * kChunk;
    load_gae_chunk(nxt, value, reward, denom, t0 - tile, col, T, B);

    float a[kChunk], c[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const bool in = t0 + u < T;
      const float delta = cur.rv.r[u] + gamma * cur.rv.v[u + 1] -
                          cur.rv.v[u];
      a[u] = in ? cur.den[u] * delta : 0.f;
      c[u] = in ? gamma_lambda : 1.f;
    }
    float A, D;
    compose<true>(a, c, A, D);
    float* pa = pairs + parity * 2 * plane;
    pa[own * cols + x] = A;
    pa[plane + own * cols + x] = D;
    __syncthreads();

    float y = fold_pairs<true>(pa, plane, cols, chunks, x, own, carry);
#pragma unroll
    for (int u = kChunk - 1; u >= 0; --u) {
      y = a[u] + c[u] * y;
      if (col < B && t0 + u < T)
        adv[(size_t)(t0 + u) * B + col] = __fdiv_rn(y, cur.den[u]);
    }
    cur = nxt;
  }
}

// The launch of a kernel chunked over T: one CTA per `cols` columns, `chunks`
// chunks of 8 steps to a super-tile, `floats` floats of shared memory per
// thread.
template <typename Kernel, typename... Args>
int launch_chunked(Kernel kernel, int floats, int T, int B, int cols,
                   int chunks, void* stream, Args... args) {
  if (bad_launch(T, B, cols, chunks)) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + cols - 1) / cols), block(cols, chunks);
  const size_t smem = (size_t)floats * cols * chunks * sizeof(float);
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// UPGO (rl_scans.py:_upgo_kernel, _upgo_loss_kernel): the binary-lambda
// return with gamma = 1:
//   d_t   = 1[r_{t+1} + V_{t+2} >= V_{t+1}], d_{T-1} = 0 (the horizon cut);
//   a_t   = r_t + (1 - d_t) * V_{t+1};
//   ret_t = a_t + d_t * ret_{t+1};
//   adv_t = rho_t * (ret_t - V_t).
// The decision is a branch on data: r_{t+1} + V_{t+2} is one rounded add
// (__fadd_rn, never contracted into a multiply-add), as in the plain version
// and the JAX kernel, so all three take the same branch at a tie.  With d
// binary the other products are exact: a_t is r_t where d_t = 1, else the
// rounded add r_t + V_{t+1}.
//
// Two epilogues on one walk, chunked over T as td_lambda_chunked_kernel is:
// the loss partials sum_t adv_t * lp_t (kLossSum, kernel 12) and the
// advantage plane adv_t (kAdvantage, kernel 11).  Each step is the pair
// (a_t, d_t); steps past T compose to the identity (a = 0, coefficient 1),
// and d_{T-1} = 0 cuts the carry from above T, so the walk starts from carry
// 0.  A chunk's decisions read one row of r and two of V past it: the next
// chunk's first rows, read again from the L2, as TdChunk reads V.  Within a
// run of d = 1 the chunk pairs add rewards in another order than a one-step
// walk would (the sums are reassociated); integer-valued inputs still sum
// exactly.  The epilogue re-walks each chunk from its carry-in.  kLossSum
// adds adv_t * lp_t for t < T and col < B to the thread's partial, and
// store_column_sum puts one partial per column into the (1, B) buffer, as in
// td_lambda_chunked_kernel<kLossSum>.  kAdvantage stores adv_t for t < T
// and col < B (coalesced), keeps no partial and loads no lp: its chunk holds
// three streams, and its shared memory only the two buffers of pairs.
enum class UpgoEpilogue { kLossSum, kAdvantage };

template <UpgoEpilogue kEpi>
struct UpgoChunk {
  static constexpr bool kLp = kEpi == UpgoEpilogue::kLossSum;
  float rho[kChunk], lp[kLp ? kChunk : 1], r[kChunk + 1], v[kChunk + 2];
};

template <UpgoEpilogue kEpi>
__device__ __forceinline__ void load_upgo_chunk(
    UpgoChunk<kEpi>& c, const float* __restrict__ rhos,
    const float* __restrict__ lp, const float* __restrict__ reward,
    const float* __restrict__ value, int t0, int col, int T, int B) {
  const bool in_col = col < B && t0 >= 0;
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const bool in = in_col && t0 + u < T;
    const size_t o = in ? (size_t)(t0 + u) * B + col : 0;
    c.rho[u] = load_once(rhos + o, in);
    if constexpr (UpgoChunk<kEpi>::kLp) c.lp[u] = load_once(lp + o, in);
  }
#pragma unroll
  for (int u = 0; u <= kChunk; ++u) {
    const bool in = in_col && t0 + u < T;
    c.r[u] = load_once(reward + (in ? (size_t)(t0 + u) * B + col : 0), in);
  }
#pragma unroll
  for (int u = 0; u <= kChunk + 1; ++u) {
    const bool in = in_col && t0 + u <= T;
    c.v[u] = load_once(value + (in ? (size_t)(t0 + u) * B + col : 0), in);
  }
}

template <UpgoEpilogue kEpi>
__global__ void __launch_bounds__(kMaxThreads)
upgo_chunked_kernel(const float* __restrict__ rhos,
                    const float* __restrict__ lp,
                    const float* __restrict__ reward,
                    const float* __restrict__ value, float* __restrict__ out,
                    int T, int B) {
  extern __shared__ float smem[];
  const int cols = blockDim.x, chunks = blockDim.y;
  const int x = threadIdx.x, own = threadIdx.y;
  const int col = blockIdx.x * cols + x;
  const int plane = cols * chunks;
  // pairs[parity][0: A, 1: D][chunk][col]; the loss's sums[chunk][col].
  float* pairs = smem;

  const int tile = chunks * kChunk;
  int st = (T + tile - 1) / tile - 1;            // the last super-tile
  UpgoChunk<kEpi> cur, nxt;
  load_upgo_chunk(cur, rhos, lp, reward, value, st * tile + own * kChunk, col,
                  T, B);
  float carry = 0.f;                             // cut by d_{T-1} = 0
  float sum = 0.f;
  for (int parity = 0; st >= 0; --st, parity ^= 1) {
    const int t0 = st * tile + own * kChunk;
    load_upgo_chunk(nxt, rhos, lp, reward, value, t0 - tile, col, T, B);

    float a[kChunk], c[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int t = t0 + u;
      const bool d = t < T - 1 &&
                     __fadd_rn(cur.r[u + 1], cur.v[u + 2]) >= cur.v[u + 1];
      a[u] = t >= T ? 0.f : d ? cur.r[u] : __fadd_rn(cur.r[u], cur.v[u + 1]);
      c[u] = t >= T || d ? 1.f : 0.f;
    }
    float A, D;
    compose<true>(a, c, A, D);
    float* pa = pairs + parity * 2 * plane;
    pa[own * cols + x] = A;
    pa[plane + own * cols + x] = D;
    __syncthreads();

    float ret = fold_pairs<true>(pa, plane, cols, chunks, x, own, carry);
#pragma unroll
    for (int u = kChunk - 1; u >= 0; --u) {
      ret = a[u] + c[u] * ret;
      if (col < B && t0 + u < T) {
        const float adv = cur.rho[u] * (ret - cur.v[u]);
        if constexpr (kEpi == UpgoEpilogue::kLossSum)
          sum += adv * cur.lp[u];
        else
          out[(size_t)(t0 + u) * B + col] = adv;
      }
    }
    cur = nxt;
  }

  if constexpr (kEpi == UpgoEpilogue::kLossSum)
    store_column_sum(smem + 4 * plane, sum, cols, chunks, x, own, col, B,
                     out);
}

}  // namespace

extern "C" {

// value (T+1, B), reward (T, B), denom (T,) in; adv (T, B) out.  One CTA per
// `cols` columns, `chunks` chunks of 8 steps to a super-tile (cols * chunks
// <= 512).  Returns the launch status.
int gae_f32(const float* value, const float* reward, const float* denom,
            float* adv, int T, int B, float gamma, float gamma_lambda,
            int cols, int chunks, void* stream) {
  return launch_chunked(gae_chunked_kernel, 4, T, B, cols, chunks, stream,
                        value, reward, denom, adv, T, B, gamma, gamma_lambda);
}

// value (T+1, B), reward (T, B) in; the lambda-returns (T, B) out.  Tiled
// as gae_f32.
int lambda_returns_f32(const float* value, const float* reward, float* ret,
                       int T, int B, float gamma, float gamma_lambda,
                       int cols, int chunks, void* stream) {
  return launch_chunked(td_lambda_chunked_kernel<TdEpilogue::kReturns>, 4, T,
                        B, cols, chunks, stream, value, reward, ret, T, B,
                        gamma, gamma_lambda);
}

// value (T+1, B), reward (T, B) in; parts (1, B) out: sum_t (ret_t - V_t)^2
// per column.  Tiled as gae_f32.
int td_lambda_loss_f32(const float* value, const float* reward, float* parts,
                       int T, int B, float gamma, float gamma_lambda,
                       int cols, int chunks, void* stream) {
  return launch_chunked(td_lambda_chunked_kernel<TdEpilogue::kLossSum>, 5, T,
                        B, cols, chunks, stream, value, reward, parts, T, B,
                        gamma, gamma_lambda);
}

// value (T+1, B), reward (T, B) in; e = ret - V[:-1] (T, B) out.  Tiled as
// gae_f32.
int td_lambda_err_f32(const float* value, const float* reward, float* err,
                      int T, int B, float gamma, float gamma_lambda, int cols,
                      int chunks, void* stream) {
  return launch_chunked(td_lambda_chunked_kernel<TdEpilogue::kError>, 4, T, B,
                        cols, chunks, stream, value, reward, err, T, B, gamma,
                        gamma_lambda);
}

// rhos, reward (T, B), value (T+1, B) in; adv (T, B) out.  Tiled as
// gae_f32.
int upgo_advantages_f32(const float* rhos, const float* reward,
                        const float* value, float* adv, int T, int B,
                        int cols, int chunks, void* stream) {
  return launch_chunked(upgo_chunked_kernel<UpgoEpilogue::kAdvantage>, 4, T,
                        B, cols, chunks, stream, rhos,
                        static_cast<const float*>(nullptr), reward, value,
                        adv, T, B);
}

// rhos, lp, reward (T, B), value (T+1, B) in; parts (1, B) out: sum_t adv_t *
// lp_t per column.  Tiled as gae_f32.
int upgo_loss_f32(const float* rhos, const float* lp, const float* reward,
                  const float* value, float* parts, int T, int B, int cols,
                  int chunks, void* stream) {
  return launch_chunked(upgo_chunked_kernel<UpgoEpilogue::kLossSum>, 5, T, B,
                        cols, chunks, stream, rhos, lp, reward, value, parts,
                        T, B);
}

}  // extern "C"
