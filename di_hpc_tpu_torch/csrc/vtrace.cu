// V-trace reverse recurrence: the loss-fused kernel and the returns/advantage
// kernel, sharing one device loop.
//
// Replaces di_hpc_tpu/pallas_kernels/rl_scans.py:_vtrace_losses_kernel
// (per-column sums of logp*adv and (V - vs)^2) and
// rl_scans.py:_vtrace_kernel (the vs and adv planes).  For column b and
// t = T-1 ... 0, with vs_T = V_T and item_T = 0:
//
//   rho = min(IS, rho_clip), c = min(IS, c_clip), pg = min(IS, pg_clip)
//   item_t = rho*(r_t + gamma*V_{t+1} - V_t) + (gamma*lambda*c)*item_{t+1}
//   vs_t = V_t + item_t
//   adv_t = pg*(r_t + gamma*vs_{t+1} - V_t)
//
// What bounds it on an H100: memory.  Each input element is read once and
// costs under 20 f32 operations, so at T=1024, B=4096 the losses kernel moves
// 67 MB (20 us at 3.35 TB/s) and the returns kernel 84 MB (25 us).
//
// Design.  One thread owns one batch column and walks time backwards, so the
// recurrence needs no scan tree and no cross-thread traffic; neighbouring
// threads own neighbouring columns, so every load and store is coalesced
// across the warp.  The loop loads kUnroll steps of every stream before it
// computes them, to keep enough loads in flight.  Columns past B neither
// load nor store.  The losses kernel writes one partial per column into a
// (2, B) buffer; the caller sums it in a fixed order (no float atomics), so
// repeated runs are bitwise equal.  Small blocks spread the B columns over
// as many SMs as possible; at B=4096 that is still only 4096 threads, and
// chunking over T to fill the card is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kUnroll = 16;

template <bool kLosses>
__global__ void __launch_bounds__(kThreads)
vtrace_kernel(const float* __restrict__ is_w, const float* __restrict__ lp,
              const float* __restrict__ reward,
              const float* __restrict__ value, float* __restrict__ out0,
              float* __restrict__ out1, int T, int B, float gamma,
              float gamma_lambda, float rho_clip, float c_clip,
              float pg_clip) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  float v_next = value[(size_t)T * B + b];   // V_{t+1}, starts at V_T
  float vs_next = v_next;                    // vs_{t+1}, vs_T = V_T
  float item = 0.f;
  float pg_sum = 0.f, v_sum = 0.f;
  for (int t0 = T - 1; t0 >= 0; t0 -= kUnroll) {
    float isv[kUnroll], rv[kUnroll], vv[kUnroll], lpv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 - u;
      isv[u] = rv[u] = vv[u] = lpv[u] = 0.f;
      if (t >= 0) {
        const size_t o = (size_t)t * B + b;
        isv[u] = __ldg(is_w + o);
        rv[u] = __ldg(reward + o);
        vv[u] = __ldg(value + o);
        if (kLosses) lpv[u] = __ldg(lp + o);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        const float rho = fminf(isv[u], rho_clip);
        const float c = fminf(isv[u], c_clip);
        const float pg = fminf(isv[u], pg_clip);
        const float delta = rho * (rv[u] + gamma * v_next - vv[u]);
        item = delta + (gamma_lambda * c) * item;
        const float vs = vv[u] + item;
        const float adv = pg * (rv[u] + gamma * vs_next - vv[u]);
        if (kLosses) {
          const float e = vv[u] - vs;
          pg_sum += lpv[u] * adv;
          v_sum += e * e;
        } else {
          const size_t o = (size_t)t * B + b;
          out0[o] = vs;
          out1[o] = adv;
        }
        v_next = vv[u];
        vs_next = vs;
      }
    }
  }
  if (kLosses) {
    out0[b] = pg_sum;
    out1[b] = v_sum;
  }
}

}  // namespace

extern "C" {

// is_w, lp, reward (T, B), value (T+1, B) in; parts (2, B) out: row 0 is
// sum_t logp*adv, row 1 is sum_t (V - vs)^2.  Returns the launch status.
int vtrace_losses_f32(const float* is_w, const float* lp, const float* reward,
                      const float* value, float* parts, int T, int B,
                      float gamma, float gamma_lambda, float rho_clip,
                      float c_clip, float pg_clip, void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  vtrace_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      is_w, lp, reward, value, parts, parts + B, T, B, gamma, gamma_lambda,
      rho_clip, c_clip, pg_clip);
  return (int)cudaGetLastError();
}

// is_w, reward (T, B), value (T+1, B) in; ret (vs) and adv (T, B) out.
int vtrace_returns_adv_f32(const float* is_w, const float* reward,
                           const float* value, float* ret, float* adv, int T,
                           int B, float gamma, float gamma_lambda,
                           float rho_clip, float c_clip, float pg_clip,
                           void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  vtrace_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      is_w, nullptr, reward, value, ret, adv, T, B, gamma, gamma_lambda,
      rho_clip, c_clip, pg_clip);
  return (int)cudaGetLastError();
}

// Message for a status returned by the functions above.
const char* dihpc_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
