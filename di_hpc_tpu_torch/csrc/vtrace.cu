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
// 67 MB (20 us at 3.35 TB/s) and the returns kernel 84 MB (25 us).  Only
// loads in flight reach that rate: a column walked step by step by one
// thread waits on one round trip to device memory per batch of loads.
//
// Design: the recurrence is affine, item_t = delta_t + a_t*item_{t+1} with
// a_t = gamma*lambda*c_t, so a run of steps composes into one pair (A, D):
// item at the run's first step = D + A*(item past its last step).  A CTA
// owns `cols` neighbouring columns (lane x) and splits time into chunks of
// kChunk steps (lane y), `chunks` of them to a super-tile, and walks the
// super-tiles from the last to the first:
//   1. each thread loads its chunk -- kChunk steps of each stream and the
//      kChunk + 1 value rows V_t0 ... V_t0+kChunk, every load in flight at
//      once, none allocating an L1 line -- while the super-tile above it is
//      computed (a super-tile's loads are issued before the arithmetic of
//      the one above it);
//   2. it composes its chunk's (A, D) and writes them to shared memory;
//   3. after one barrier every thread folds the super-tile's pairs in the
//      same fixed order, from the last chunk down, starting from the carry
//      of the super-tile above: it keeps the value at its own chunk's end
//      (its carry-in) and ends with the carry for the super-tile below, the
//      same bits in every thread;
//   4. it walks its chunk again from the registers it loaded, with the
//      carry applied, and stores vs and adv or adds lp*adv and (V - vs)^2
//      to its partial sums.
// Each input is read from device memory once (the value row past a chunk is
// also the next chunk's first, read again from the L2).  Neighbouring lanes
// own neighbouring columns, so loads and stores are coalesced.  Steps past T
// load zeros (IS = 0 gives delta = 0, so item stays 0 above T, as item_T = 0
// says) and store nothing; columns past B neither load nor store.
// The losses kernel sums each column's chunk partials in shared memory in
// lane order and writes one partial per column into a (2, B) buffer, which
// the caller sums in a fixed order.  No float atomics anywhere, so repeated
// runs are bitwise equal.  The launch shape (cols, chunks) is chosen by the
// caller (kernels.vtrace_launch_shape): at T=1024, B=4096, 128 CTAs of 32
// columns x 16 chunks, 128-step super-tiles.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 8;          // steps of one thread in a super-tile
constexpr int kMaxThreads = 512;   // cols * chunks

struct Scalars {
  float gamma, gamma_lambda, rho_clip, c_clip, pg_clip;
};

// A load of a stream that is read once: no L1 line is allocated for it
// (L1::no_allocate), since none would be read again; on the H100 the losses
// kernel runs faster so than with __ldg.  0 where !in (nothing is read).
__device__ __forceinline__ float load_once(const float* p, bool in) {
  float v;
  asm("{\n"
      "  .reg .pred q;\n"
      "  setp.ne.b32 q, %2, 0;\n"
      "  mov.b32 %0, 0;\n"
      "  @q ld.global.nc.L1::no_allocate.f32 %0, [%1];\n"
      "}\n"
      : "=f"(v)
      : "l"(p), "r"((int)in));
  return v;
}

// One thread's chunk: steps t0 ... t0 + kChunk - 1 of its column and value
// rows t0 ... t0 + kChunk.  Entries past T (or past B, or before 0) are 0.
template <bool kLosses>
struct Chunk {
  float is[kChunk], r[kChunk], lp[kLosses ? kChunk : 1], v[kChunk + 1];
};

template <bool kLosses>
__device__ __forceinline__ void load_chunk(
    Chunk<kLosses>& c, const float* __restrict__ is_w,
    const float* __restrict__ lp, const float* __restrict__ reward,
    const float* __restrict__ value, int t0, int b, int T, int B) {
  const bool col = b < B && t0 >= 0;
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const bool in = col && t0 + u < T;
    const size_t o = in ? (size_t)(t0 + u) * B + b : 0;
    c.is[u] = load_once(is_w + o, in);
    c.r[u] = load_once(reward + o, in);
    if (kLosses) c.lp[u] = load_once(lp + o, in);
  }
#pragma unroll
  for (int u = 0; u <= kChunk; ++u) {
    const bool in = col && t0 + u <= T;
    c.v[u] = load_once(value + (in ? (size_t)(t0 + u) * B + b : 0), in);
  }
}

template <bool kLosses>
__device__ __forceinline__ float delta_at(const Chunk<kLosses>& c, int u,
                                          const Scalars& s) {
  const float rho = fminf(c.is[u], s.rho_clip);
  return rho * (c.r[u] + s.gamma * c.v[u + 1] - c.v[u]);
}

template <bool kLosses>
__global__ void __launch_bounds__(kMaxThreads)
vtrace_chunked_kernel(const float* __restrict__ is_w,
                      const float* __restrict__ lp,
                      const float* __restrict__ reward,
                      const float* __restrict__ value,
                      float* __restrict__ out0, float* __restrict__ out1,
                      int T, int B, Scalars s) {
  extern __shared__ float smem[];
  const int cols = blockDim.x, chunks = blockDim.y;
  const int x = threadIdx.x, y = threadIdx.y;
  const int b = blockIdx.x * cols + x;
  const int plane = cols * chunks;
  // pairs[parity][0: A, 1: D][chunk][col]: two buffers, so that one barrier
  // per super-tile suffices; sums[0: pg, 1: v][chunk][col].
  float* pairs = smem;
  float* sums = smem + 4 * plane;

  const int tile = chunks * kChunk;
  int st = (T + tile - 1) / tile - 1;            // the last super-tile
  Chunk<kLosses> cur, nxt;
  load_chunk(cur, is_w, lp, reward, value, st * tile + y * kChunk, b, T, B);
  float carry = 0.f;                             // item_T = 0
  float pg_sum = 0.f, v_sum = 0.f;
  for (int parity = 0; st >= 0; --st, parity ^= 1) {
    const int t0 = st * tile + y * kChunk;
    load_chunk(nxt, is_w, lp, reward, value, t0 - tile, b, T, B);

    float A = 1.f, D = 0.f;
#pragma unroll
    for (int u = kChunk - 1; u >= 0; --u) {
      const float a = s.gamma_lambda * fminf(cur.is[u], s.c_clip);
      D = delta_at(cur, u, s) + a * D;
      A = a * A;
    }
    float* pa = pairs + parity * 2 * plane;
    pa[y * cols + x] = A;
    pa[plane + y * cols + x] = D;
    __syncthreads();

    float item = 0.f;                            // item past own chunk
    for (int q = chunks - 1; q >= 0; --q) {
      if (q == y) item = carry;
      carry = pa[plane + q * cols + x] + pa[q * cols + x] * carry;
    }

    float vs_next = cur.v[kChunk] + item;
#pragma unroll
    for (int u = kChunk - 1; u >= 0; --u) {
      const float c = fminf(cur.is[u], s.c_clip);
      const float pg = fminf(cur.is[u], s.pg_clip);
      item = delta_at(cur, u, s) + (s.gamma_lambda * c) * item;
      const float vs = cur.v[u] + item;
      const float adv = pg * (cur.r[u] + s.gamma * vs_next - cur.v[u]);
      if (b < B && t0 + u < T) {
        if (kLosses) {
          const float e = cur.v[u] - vs;
          pg_sum += cur.lp[u] * adv;
          v_sum += e * e;
        } else {
          const size_t o = (size_t)(t0 + u) * B + b;
          out0[o] = vs;
          out1[o] = adv;
        }
      }
      vs_next = vs;
    }
    cur = nxt;
  }

  if (kLosses) {
    sums[y * cols + x] = pg_sum;
    sums[plane + y * cols + x] = v_sum;
    __syncthreads();
    if (y == 0 && b < B) {
      float p = 0.f, v = 0.f;
      for (int q = 0; q < chunks; ++q) {
        p += sums[q * cols + x];
        v += sums[plane + q * cols + x];
      }
      out0[b] = p;
      out1[b] = v;
    }
  }
}

template <bool kLosses>
int launch(const float* is_w, const float* lp, const float* reward,
           const float* value, float* out0, float* out1, int T, int B,
           Scalars s, int cols, int chunks, void* stream) {
  if (T < 1 || B < 1 || cols < 1 || chunks < 1 ||
      cols * chunks > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + cols - 1) / cols), block(cols, chunks);
  const size_t smem = (size_t)6 * cols * chunks * sizeof(float);
  vtrace_chunked_kernel<kLosses><<<grid, block, smem, (cudaStream_t)stream>>>(
      is_w, lp, reward, value, out0, out1, T, B, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// is_w, lp, reward (T, B), value (T+1, B) in; parts (2, B) out: row 0 is
// sum_t logp*adv, row 1 is sum_t (V - vs)^2.  One CTA per `cols` columns,
// `chunks` chunks of 8 steps to a super-tile (cols * chunks <= 512).
// Returns the launch status.
int vtrace_losses_f32(const float* is_w, const float* lp, const float* reward,
                      const float* value, float* parts, int T, int B,
                      float gamma, float gamma_lambda, float rho_clip,
                      float c_clip, float pg_clip, int cols, int chunks,
                      void* stream) {
  return launch<true>(is_w, lp, reward, value, parts, parts + B, T, B,
                      {gamma, gamma_lambda, rho_clip, c_clip, pg_clip}, cols,
                      chunks, stream);
}

// is_w, reward (T, B), value (T+1, B) in; ret (vs) and adv (T, B) out; the
// launch shape as above.
int vtrace_returns_adv_f32(const float* is_w, const float* reward,
                           const float* value, float* ret, float* adv, int T,
                           int B, float gamma, float gamma_lambda,
                           float rho_clip, float c_clip, float pg_clip,
                           int cols, int chunks, void* stream) {
  return launch<false>(is_w, nullptr, reward, value, ret, adv, T, B,
                       {gamma, gamma_lambda, rho_clip, c_clip, pg_clip}, cols,
                       chunks, stream);
}

// Message for a status returned by the functions above.
const char* dihpc_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
