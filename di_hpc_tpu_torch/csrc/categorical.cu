// The categorical head: per row of (..., N) logits, the log-prob of the
// taken action, the entropy and the log-sum-exp (forward), and the logits'
// gradient from those per-row statistics (the stash-free backward).
//
// Replaces no TPU kernel: the JAX package leaves this head to XLA fusion
// (di_hpc_tpu/ops/categorical.py:37-43 says why: Mosaic pads the minor
// dimension on block DMA, and an opaque kernel cannot join XLA's fusion).
// Neither holds on an H100, where a row of 128 float32 values is one
// coalesced 512-byte load of one warp.  It replaces the port's plain
// PyTorch body (kernels.categorical_fwd_plain / categorical_bwd_plain),
// which makes a clamped copy of the logits and runs the max, exp, sum,
// gather and product-sum as separate passes over (..., N), and whose
// backwards rebuild x - lse, exp, the clamp and an int64 one-hot as
// (..., N) temporaries.  Its arithmetic, per element, is that body's.
//
// What bounds it on an H100: memory, and close behind it the issue rate.
// The forward reads each logit once and writes three floats a row; the
// backward reads each logit once and writes its gradient once.  At T 1024,
// B 4096, N 128 float32 one plane is 2.147 GB: 0.64 ms (forward) and
// 1.28 ms (backward) at 3.35 TB/s, against which a plain read (`sum`) of
// the plane takes 0.70 ms and a copy 1.43 ms on an H100 (90 %).  The
// forward's precise expf and its reductions cost about as many issue slots
// as its bytes take time, so every instruction a logit or a row does not
// need shows in its time.
//
// Design: a warp owns `kRows` neighbouring rows, `kWarps` warps a CTA, one
// CTA per kWarps * kRows rows.  A lane reads V neighbouring logits of each
// row (V = 4: 16 bytes of float32 or 8 of bf16, where N % 4 == 0 and the
// logits are aligned to it; V = 1 otherwise), so a chunk of a row is
// 32 * V columns and a warp walks a row's chunks in order, each chunk's
// loads of all its rows issued before any arithmetic on them.  The taken
// action becomes a 32-bit column offset once per row and chunk, so a logit
// costs one integer compare to be picked.  The forward merges a row's
// chunks online: each chunk's max (one redux.sync over order-preserving
// int32 views), the running max m (the same in every lane), and per lane
// the sums s = sum e and sx = sum e * x with e = exp(x - m), rescaled by
// exp(m_old - m) when m grows.  Where the row is one chunk (N = 128
// float32) that is the plain body's max-then-sum.  The warp's rows are
// then summed across lanes together, by a transposed butterfly: 2 * kRows
// values a lane (s and sx, or s and the taken logit), each exchange
// halving the values a lane holds, 9 shuffles for 4 rows where one
// butterfly a value takes 40; lane r * 4 ends with row r's sums and writes
// its outputs.  Every reduction is a fixed order of shuffles or a redux --
// no atomics -- so a result has the same bits on every run.
//
// Measured on an H100 (T 1024, B 4096, N 128, float32, cold L2): the
// forward takes 0.77 ms (86 % of its bound), the backward 1.46 ms (89 %).
// Registers decide the forward's rate: a row of one chunk (N <= 32 * V)
// runs an instantiation that keeps no state across chunks (kOneChunk), 40
// registers against 64 and 0.84 against 0.95 ms; per-row butterflies for
// each sum, an exp more a row and 64-bit action compares took 1.29 ms.
// Keeping the next steps' loads in flight in a cp.async ring in shared
// memory, or in registers, ran slower (1.38, 1.66 ms): fewer warps an SM.
//
// Masked-logit contract (utils/constants.py, ops/categorical.py): the
// forward clamps each logit at -1e9 in registers, so a masked logit
// (-inf included) has probability exactly 0 and a masked taken action a
// finite logp; the backward reads the logits unclamped, gives the one-hot
// term only where the taken logit is >= -1e9, and floors logp at -88 in
// the entropy term, so a -inf logit gets a zero gradient.  The clamp and
// the floor keep NaN, as torch.clamp_min does.  An action outside [0, N)
// gives a NaN logp (the plain body raises on it) and no one-hot term.
//
// float32 arithmetic with expf and logf (no fast-math); the backward's
// products and sums are the plain body's, rounded one at a time
// (__fmul_rn, __fadd_rn), so none is contracted into an FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kMaskedLogit = -1e9f;   // utils/constants.py:MASKED_LOGIT
constexpr float kLogpFloor = -88.f;     // exp underflows to 0 below this
constexpr int kWarps = 8;               // warps per CTA
constexpr int kRows = 4;                // rows per warp
constexpr int kRowsPerCta = kWarps * kRows;
constexpr unsigned kFull = 0xffffffffu;

// The int32 view of a float whose order is the floats' (a NaN of sign 0
// above +inf, as torch.amax keeps it); the map is its own inverse.
__device__ __forceinline__ int ordered(int bits) {
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

// The warp's max in one redux.sync over the ordered int32 views.
__device__ __forceinline__ float warp_max(float v) {
  return __int_as_float(
      ordered(__reduce_max_sync(kFull, ordered(__float_as_int(v)))));
}

// The sums over the warp of kValues values a lane (a power of 2 up to 32):
// lane L ends with the sum of value L / (32 / kValues).  Each exchange
// sends half the values a lane still holds to its partner and keeps the
// other half; once a lane holds one value, a butterfly over the lanes
// that share it finishes the sum.
template <int kValues>
__device__ __forceinline__ float transposed_sum(const float (&v)[kValues],
                                                int lane) {
  float w[kValues];
#pragma unroll
  for (int i = 0; i < kValues; ++i) w[i] = v[i];
  int bit = 16;
#pragma unroll
  for (int held = kValues; held > 1; held >>= 1, bit >>= 1) {
    const bool upper = lane & bit;
    const int half = held / 2;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? w[i] : w[i + half];
      const float keep = upper ? w[i + half] : w[i];
      w[i] = keep + __shfl_xor_sync(kFull, send, bit);
    }
  }
  float sum = w[0];
#pragma unroll
  for (; bit > 0; bit >>= 1) sum += __shfl_xor_sync(kFull, sum, bit);
  return sum;
}

// V logits at p (aligned to V elements) as floats; bf16 widens exactly.
template <int V, typename T>
__device__ __forceinline__ void load_logits(const T* __restrict__ p,
                                            float (&x)[V]) {
  static_assert(V == 1 || V == 4, "a lane reads 1 or 4 logits");
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, float>::value) {
      x[0] = __ldg(p);
    } else {
      x[0] = __bfloat162float(__ldg(p));
    }
  } else if constexpr (std::is_same<T, float>::value) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    x[0] = __uint_as_float(q.x << 16);
    x[1] = __uint_as_float(q.x & 0xffff0000u);
    x[2] = __uint_as_float(q.y << 16);
    x[3] = __uint_as_float(q.y & 0xffff0000u);
  }
}

// V values to p (aligned to V elements), rounded to nearest even for bf16.
template <int V, typename T>
__device__ __forceinline__ void store_grad(T* __restrict__ p,
                                           const float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, float>::value) {
      *p = v[0];
    } else {
      *p = __float2bfloat16_rn(v[0]);
    }
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&lo);
    q.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = q;
  }
}

// The action of `row` as a column, or -1 outside [0, N).
__device__ __forceinline__ int action_of(const void* actions, int act64,
                                         long long row, int N) {
  const long long a =
      act64 ? __ldg(static_cast<const long long*>(actions) + row)
            : (long long)__ldg(static_cast<const int*>(actions) + row);
  return a >= 0 && a < N ? (int)a : -1;
}

// The logits of the warp's rows first .. first + kRows - 1 at the lane's
// columns j0 .. j0 + V - 1, where the columns and the row exist (V | N
// where V > 1, so a lane's V columns all exist or none).
template <int V, typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ logits,
                                          long long first, long long rows,
                                          int N, int j0,
                                          float (&x)[kRows][V]) {
  if (j0 >= N) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (first + r < rows) load_logits<V>(logits + (first + r) * N + j0, x[r]);
  }
}

// A warp's rows past `rows` are skipped by warp-uniform tests, so every
// shuffle has all 32 lanes.  kOneChunk: N <= 32 * V, the row is one chunk
// (the compiler then keeps no state across chunks: fewer registers, more
// warps an SM).
template <typename T, int V, bool kEnt, bool kOneChunk>
__global__ void __launch_bounds__(kWarps * 32)
categorical_fwd_kernel(const T* __restrict__ logits,
                       const void* __restrict__ actions, int act64,
                       long long rows, int N, float* __restrict__ logp,
                       float* __restrict__ lse, float* __restrict__ ent) {
  constexpr int kSpan = 32 * V;   // columns of one chunk
  const int lane = threadIdx.x & 31;
  const long long first =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  if (first >= rows) return;
  const int chunks = kOneChunk ? 1 : (N + kSpan - 1) / kSpan;

  int a[kRows];
  // Per row: the running max (the same in every lane), this lane's sums of
  // e and e * x (e = exp(x - max)) and its taken logit (0 where it has
  // none).
  float m[kRows], s[kRows], sx[kRows], xa[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    a[r] = action_of(actions, act64, first + r < rows ? first + r : first, N);
    m[r] = s[r] = sx[r] = xa[r] = 0.f;
  }
  for (int c = 0; c < chunks; ++c) {
    const int j0 = c * kSpan + lane * V;
    const bool has = j0 < N;
    float x[kRows][V];
    load_rows<V>(logits, first, rows, N, j0, x);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (first + r >= rows) continue;
      float cm = -INFINITY;
      if (has) {
#pragma unroll
        for (int u = 0; u < V; ++u) {
          x[r][u] = x[r][u] < kMaskedLogit ? kMaskedLogit : x[r][u];
          cm = fmaxf(cm, x[r][u]);
        }
      }
      cm = warp_max(cm);
      const float mn = c == 0 ? cm : fmaxf(m[r], cm);
      const int d = a[r] - j0;   // the taken column's place in this lane
      float es = 0.f, exs = 0.f, taken = xa[r];
      if (has) {
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float e = expf(x[r][u] - mn);
          es += e;
          if (kEnt) exs += e * x[r][u];
          taken = d == u ? x[r][u] : taken;
        }
      }
      if (c == 0) {
        s[r] = es;
        sx[r] = exs;
      } else {
        const float scale = expf(m[r] - mn);
        s[r] = s[r] * scale + es;
        if (kEnt) sx[r] = sx[r] * scale + exs;
      }
      m[r] = mn;
      xa[r] = taken;
    }
  }

  // Lane L ends with value L / 4 of (s of rows 0-3, then sx or the taken
  // logit of rows 0-3): lanes 0-15 hold row (L / 4)'s s, lanes 16-31 its
  // second value.  Summing the taken logit adds zeros to it: exact.
  constexpr int kPer = 32 / (2 * kRows);   // lanes that share a value
  float v[2 * kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    v[r] = s[r];
    v[kRows + r] = kEnt ? sx[r] : xa[r];
  }
  const float mine = transposed_sum<2 * kRows>(v, lane);
  const float other = __shfl_xor_sync(kFull, mine, 16);
  const int row_of_lane = (lane / kPer) % kRows;
  float mr = m[0], taken = 0.f;
  int ar = a[0];
#pragma unroll
  for (int r = 1; r < kRows; ++r) {
    mr = row_of_lane == r ? m[r] : mr;
    ar = row_of_lane == r ? a[r] : ar;
  }
  if (kEnt) {
    // The taken logit of each row from the lane that holds it (any lane
    // where the row has no action: NaN is written then).
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int holder = a[r] < 0 ? 0 : (a[r] % kSpan) / V;
      const float t = __shfl_sync(kFull, xa[r], holder);
      taken = row_of_lane == r ? t : taken;
    }
  } else {
    taken = other;
  }
  const long long row = first + row_of_lane;
  if (lane < 16 && lane % kPer == 0 && row < rows) {
    const float l = mr + logf(mine);
    logp[row] = (ar < 0 ? NAN : taken) - l;
    lse[row] = l;
    if (kEnt) ent[row] = l - other / mine;
  }
}

// dx = [x_a >= -1e9] onehot * glp - p * (glp + gent * (max(x - lse, -88)
// + ent)) with p = exp(x - lse); without the entropy dx = [x_a >= -1e9]
// onehot * glp - p * glp.  glp and gent are read at row * step (step 0: one
// value broadcast over every row).
template <typename T, int V, bool kEnt, bool kOneChunk>
__global__ void __launch_bounds__(kWarps * 32)
categorical_bwd_kernel(const T* __restrict__ logits,
                       const void* __restrict__ actions, int act64,
                       const float* __restrict__ lse,
                       const float* __restrict__ ent,
                       const float* __restrict__ glp, int glp_step,
                       const float* __restrict__ gent, int gent_step,
                       long long rows, int N, T* __restrict__ dx) {
  constexpr int kSpan = 32 * V;
  const int lane = threadIdx.x & 31;
  const long long first =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  if (first >= rows) return;
  const int chunks = kOneChunk ? 1 : (N + kSpan - 1) / kSpan;

  int a[kRows];
  float l[kRows], g[kRows], h[kRows], ge[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long row = first + r < rows ? first + r : first;
    a[r] = action_of(actions, act64, row, N);
    l[r] = __ldg(lse + row);
    g[r] = __ldg(glp + row * glp_step);
    h[r] = kEnt ? __ldg(ent + row) : 0.f;
    ge[r] = kEnt ? __ldg(gent + row * gent_step) : 0.f;
  }
  for (int c = 0; c < chunks; ++c) {
    const int j0 = c * kSpan + lane * V;
    if (j0 >= N) break;
    float x[kRows][V];
    load_rows<V>(logits, first, rows, N, j0, x);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (first + r >= rows) continue;
      const int d = a[r] - j0;
      float out[V];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float lp = __fsub_rn(x[r][u], l[r]);
        const float p = expf(lp);
        const float take = d == u && x[r][u] >= kMaskedLogit ? g[r] : 0.f;
        float w = g[r];
        if (kEnt) {
          const float lpc = lp < kLogpFloor ? kLogpFloor : lp;
          w = __fadd_rn(g[r], __fmul_rn(ge[r], __fadd_rn(lpc, h[r])));
        }
        out[u] = __fsub_rn(take, __fmul_rn(p, w));
      }
      store_grad<V>(dx + (first + r) * N + j0, out);
    }
  }
}

bool bad_launch(long long rows, int N, int vec) {
  return rows < 1 || N < 1 || (vec != 1 && vec != 4) ||
         (vec == 4 && N % 4 != 0) ||
         (rows + kRowsPerCta - 1) / kRowsPerCta > 0x7fffffffLL;
}

unsigned grid_for(long long rows) {
  return (unsigned)((rows + kRowsPerCta - 1) / kRowsPerCta);
}

// The instantiation for a call: 4 or 1 logits a lane, with or without the
// entropy, one chunk a row or several.
template <typename T, int V, bool kEnt>
auto fwd_kernel(bool one) {
  return one ? categorical_fwd_kernel<T, V, kEnt, true>
             : categorical_fwd_kernel<T, V, kEnt, false>;
}

template <typename T, int V, bool kEnt>
auto bwd_kernel(bool one) {
  return one ? categorical_bwd_kernel<T, V, kEnt, true>
             : categorical_bwd_kernel<T, V, kEnt, false>;
}

template <typename T>
int launch_fwd(const T* logits, const void* actions, int act64,
               long long rows, int N, int vec, float* logp, float* lse,
               float* ent, cudaStream_t stream) {
  if (bad_launch(rows, N, vec)) return (int)cudaErrorInvalidValue;
  const bool one = N <= 32 * vec;
  const auto kernel =
      vec == 4 ? (ent != nullptr ? fwd_kernel<T, 4, true>(one)
                                 : fwd_kernel<T, 4, false>(one))
               : (ent != nullptr ? fwd_kernel<T, 1, true>(one)
                                 : fwd_kernel<T, 1, false>(one));
  kernel<<<grid_for(rows), kWarps * 32, 0, stream>>>(logits, actions, act64,
                                                     rows, N, logp, lse, ent);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const T* logits, const void* actions, int act64,
               const float* lse, const float* ent, const float* glp,
               int glp_step, const float* gent, int gent_step,
               long long rows, int N, int vec, T* dx, cudaStream_t stream) {
  const bool with_ent = ent != nullptr;
  if (bad_launch(rows, N, vec) || with_ent != (gent != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool one = N <= 32 * vec;
  const auto kernel =
      vec == 4 ? (with_ent ? bwd_kernel<T, 4, true>(one)
                           : bwd_kernel<T, 4, false>(one))
               : (with_ent ? bwd_kernel<T, 1, true>(one)
                           : bwd_kernel<T, 1, false>(one));
  kernel<<<grid_for(rows), kWarps * 32, 0, stream>>>(
      logits, actions, act64, lse, ent, glp, glp_step, gent, gent_step, rows,
      N, dx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// logits (rows, N) in, actions (rows,) int32 or int64 (act64 non-zero) in;
// logp, lse and ent (null: no entropy) (rows,) float32 out.  vec 4 reads
// 4 logits a lane (N % 4 == 0, logits aligned to 4 elements), vec 1 one.
// Returns the launch status.
int categorical_fwd_f32(const float* logits, const void* actions, int act64,
                        long long rows, int N, int vec, float* logp,
                        float* lse, float* ent, void* stream) {
  return launch_fwd(logits, actions, act64, rows, N, vec, logp, lse, ent,
                    (cudaStream_t)stream);
}

int categorical_fwd_bf16(const bf16* logits, const void* actions, int act64,
                         long long rows, int N, int vec, float* logp,
                         float* lse, float* ent, void* stream) {
  return launch_fwd(logits, actions, act64, rows, N, vec, logp, lse, ent,
                    (cudaStream_t)stream);
}

// logits (rows, N), actions, lse (rows,) and glp in; ent and gent (both
// null: the gradient of logp alone) in; dx (rows, N), the logits' dtype,
// out.  glp and gent are read at row * step, step 1 or 0.
int categorical_bwd_f32(const float* logits, const void* actions, int act64,
                        const float* lse, const float* ent, const float* glp,
                        int glp_step, const float* gent, int gent_step,
                        long long rows, int N, int vec, float* dx,
                        void* stream) {
  return launch_bwd(logits, actions, act64, lse, ent, glp, glp_step, gent,
                    gent_step, rows, N, vec, dx, (cudaStream_t)stream);
}

int categorical_bwd_bf16(const bf16* logits, const void* actions, int act64,
                         const float* lse, const float* ent, const float* glp,
                         int glp_step, const float* gent, int gent_step,
                         long long rows, int N, int vec, bf16* dx,
                         void* stream) {
  return launch_bwd(logits, actions, act64, lse, ent, glp, glp_step, gent,
                    gent_step, rows, N, vec, dx, (cudaStream_t)stream);
}

}  // extern "C"
