// Row-constant-coefficient reverse recurrences: GAE, the lambda-returns and
// the TD(lambda) loss and error, one thread per batch column.
//
// Replaces four kernels of di_hpc_tpu/pallas_kernels/rl_scans.py, which all
// run _suffix_scan with a (T, 1) coefficient:
//   - _gae_kernel: delta_t = r_t + gamma*V_{t+1} - V_t,
//     y_t = denom_t*delta_t + gamma*lambda*y_{t+1} (y_T = 0), adv_t = y_t /
//     denom_t, with denom (T,) given by the caller (ops.scan.gae_denominators,
//     so both sides divide by the same numbers);
//   - _lret_kernel, _tdl_loss_kernel, _tdl_err_kernel, which share _lret_body:
//     ret_{T-1} = r_{T-1} + gamma*V_T and, below it,
//     ret_t = r_t + (gamma - gamma*lambda)*V_{t+1} + gamma*lambda*ret_{t+1}.
//     One device loop, templated on its epilogue, serves all three: it writes
//     the returns plane, sums (ret_t - V_t)^2 over t, or writes e_t = ret_t -
//     V_t.
//
// What bounds it on an H100: memory.  Each input element is read once and
// costs under 10 f32 operations.  At T=1024, B=4096 the GAE, returns and
// error kernels move 50.3 MB each (15 us at 3.35 TB/s), the loss kernel
// 33.6 MB (10 us).
//
// Design, as csrc/vtrace.cu: one thread owns one batch column and walks time
// backwards, so the recurrence needs no scan tree and no cross-thread
// traffic; neighbouring threads own neighbouring columns, so every load and
// store is coalesced across the warp.  The loop loads kUnroll steps of every
// stream before it computes them, to keep enough loads in flight.  Columns
// past B neither load nor store.  The loss kernel writes one partial per
// column into a (1, B) buffer that the caller sums in a fixed order (no float
// atomics), so repeated runs are bitwise equal and a ragged B adds nothing to
// the sum.  At B=4096 that is only 4096 threads on 132 SMs; chunking over T
// to fill the card is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
gae_kernel(const float* __restrict__ value, const float* __restrict__ reward,
           const float* __restrict__ denom, float* __restrict__ adv, int T,
           int B, float gamma, float gamma_lambda) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  float v_next = value[(size_t)T * B + b];   // V_{t+1}, starts at V_T
  float y = 0.f;
  for (int t0 = T - 1; t0 >= 0; t0 -= kUnroll) {
    float rv[kUnroll], vv[kUnroll], dv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 - u;
      rv[u] = vv[u] = 0.f;
      dv[u] = 1.f;
      if (t >= 0) {
        const size_t o = (size_t)t * B + b;
        rv[u] = __ldg(reward + o);
        vv[u] = __ldg(value + o);
        dv[u] = __ldg(denom + t);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        const float delta = rv[u] + gamma * v_next - vv[u];
        y = dv[u] * delta + gamma_lambda * y;
        adv[(size_t)t * B + b] = y / dv[u];
        v_next = vv[u];
      }
    }
  }
}

enum class Epilogue { kReturns, kLossSum, kError };

template <Epilogue kEpi>
__global__ void __launch_bounds__(kThreads)
lambda_returns_kernel(const float* __restrict__ value,
                      const float* __restrict__ reward,
                      float* __restrict__ out, int T, int B, float gamma,
                      float gamma_lambda) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  float v_next = value[(size_t)T * B + b];   // V_{t+1}, starts at V_T
  float ret = 0.f;
  // The last step has coefficient gamma on V_T and none on the carry
  // (_lret_body's b_{T-1} = 0); every earlier step gamma - gamma*lambda and
  // gamma*lambda.
  float g_eff = gamma, carry = 0.f;
  float sum = 0.f;
  for (int t0 = T - 1; t0 >= 0; t0 -= kUnroll) {
    float rv[kUnroll], vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 - u;
      rv[u] = vv[u] = 0.f;
      if (t >= 0) {
        const size_t o = (size_t)t * B + b;
        rv[u] = __ldg(reward + o);
        vv[u] = __ldg(value + o);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        ret = rv[u] + g_eff * v_next + carry * ret;
        g_eff = gamma - gamma_lambda;
        carry = gamma_lambda;
        const float e = ret - vv[u];
        if (kEpi == Epilogue::kReturns) out[(size_t)t * B + b] = ret;
        if (kEpi == Epilogue::kError) out[(size_t)t * B + b] = e;
        if (kEpi == Epilogue::kLossSum) sum += e * e;
        v_next = vv[u];
      }
    }
  }
  if (kEpi == Epilogue::kLossSum) out[b] = sum;
}

template <Epilogue kEpi>
int launch_lambda_returns(const float* value, const float* reward, float* out,
                          int T, int B, float gamma, float gamma_lambda,
                          void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  lambda_returns_kernel<kEpi><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      value, reward, out, T, B, gamma, gamma_lambda);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// value (T+1, B), reward (T, B), denom (T,) in; adv (T, B) out.  Returns the
// launch status.
int gae_f32(const float* value, const float* reward, const float* denom,
            float* adv, int T, int B, float gamma, float gamma_lambda,
            void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  gae_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      value, reward, denom, adv, T, B, gamma, gamma_lambda);
  return (int)cudaGetLastError();
}

// value (T+1, B), reward (T, B) in; the lambda-returns (T, B) out.
int lambda_returns_f32(const float* value, const float* reward, float* ret,
                       int T, int B, float gamma, float gamma_lambda,
                       void* stream) {
  return launch_lambda_returns<Epilogue::kReturns>(value, reward, ret, T, B,
                                                   gamma, gamma_lambda,
                                                   stream);
}

// value (T+1, B), reward (T, B) in; parts (1, B) out: sum_t (ret_t - V_t)^2
// per column.
int td_lambda_loss_f32(const float* value, const float* reward, float* parts,
                       int T, int B, float gamma, float gamma_lambda,
                       void* stream) {
  return launch_lambda_returns<Epilogue::kLossSum>(value, reward, parts, T, B,
                                                   gamma, gamma_lambda,
                                                   stream);
}

// value (T+1, B), reward (T, B) in; e = ret - V[:-1] (T, B) out.
int td_lambda_err_f32(const float* value, const float* reward, float* err,
                      int T, int B, float gamma, float gamma_lambda,
                      void* stream) {
  return launch_lambda_returns<Epilogue::kError>(value, reward, err, T, B,
                                                 gamma, gamma_lambda, stream);
}

}  // extern "C"
