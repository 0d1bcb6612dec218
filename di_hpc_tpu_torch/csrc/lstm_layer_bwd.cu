// LN-LSTM layer backward, V1: the whole reverse time loop inside one kernel
// launch.  (V2, the variant for B >= 64, is lstm_layer_bwd_v2.cu.)
//
// V1 replaces di_hpc_tpu/pallas_kernels/lstm_cell.py:_bwd_kernel (B < 64).
// Per step t = S-1 .. 0 and batch row b, from streams the caller precomputes
// -- the x-side gate gx = LN_x(gxp) + bias and gh_pre = h_{t-1} @ Wh -- and
// the stashed c_{t-1}, c_t, it runs
//
//   dh = dh_carry + dy_t;  dc = dc_carry + dh*o*(1 - tanh(c_t)^2)
//   dgate = [dc*u*i(1-i), dc*c_{t-1}*f(1-f), dh*tanh(c_t)*o(1-o), dc*i(1-u^2)]
//   dg_pre_t = LN_h backward of dgate
//   dh_carry = dg_pre_t @ Wh^T;  dc_carry = dc*f
//
// and writes dgate and dg_pre; at the end dh0/dc0.  The LN_x backward, dWh,
// dgamma/dbeta and dbias are the caller's (lstm_cell.py:658-706).
//
// What bounds it on an H100: the f32 product dh = dg_pre @ Wh^T on the FMA
// pipes, 2*S*B*H*4H operations.
//
// Design.  As in the forward (lstm_layer.cu), one CTA owns kRows batch rows
// for the whole reverse loop, and nothing crosses CTAs inside the loop.  Wh^T
// (the caller passes a contiguous transpose, made once per call) streams from
// L2 in float4 column strips against a k-major operand tile in shared memory,
// with the forward's own product code (lstm_common.cuh:matmul_rows).  dh =
// dg_pre @ Wh^T has only H output columns, so its K = 4H is split in four
// slices over the CTA's threads and the four partials are added in a fixed
// order.  Rows past B load zeros for every input (gx, gh_pre, c, dy and the
// carries), so their dgate is exactly zero.
//
// bf16 streams (T = __nv_bfloat16), as the TPU kernel takes them, mixed as at
// lstm_cell.py:658-706: gx, c_{t-1}, c_t, dy and Wh are bf16 but gh_pre is
// f32; dgate, d(gh_pre), dh0 and dc0 come out bf16.  The math and the dh/dc
// carries are f32, and the dh carry is bf16(d(gh_pre)) @ Wh^T summed in f32,
// so the dg_pre tile in shared memory holds the rounded values.  With bf16
// the operations are the same f32 FMAs and the bytes halve.

#include "lstm_common.cuh"

namespace {

using namespace lstm;

__host__ __device__ constexpr size_t v1_smem_floats(int H) {
  // gh (kRows, 4H) + dT (4H, kRows) + dh, dc (kRows, H) + stats (kRows, 4)
  return (size_t)kRows * (2 * 4 * H + 2 * H) + 4 * kRows;
}

__device__ __forceinline__ void load_rows8(const float* p, float (&v)[kRows]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void store_rows8(float* p, const float (&v)[kRows]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// Cell backward of one (row, unit) from the gate pre-activations, c_{t-1}
// and the stashed c_t (as the TPU kernel reads it): writes the four dgate
// entries into dT_s (k-major) and, with dgate_out, to global memory;
// returns the new dc carry.
template <typename T>
__device__ __forceinline__ float cell_backward(const float (&pre)[4], float cp,
                                               float c_stash, float dh,
                                               float dc_carry, float* dT_s,
                                               int H, int j, int b,
                                               T* dgate_out) {
  const float si = sigmoid_f(pre[0]);
  const float sf = sigmoid_f(pre[1]);
  const float so = sigmoid_f(pre[2]);
  const float su = tanhf(pre[3]);
  const float tc = tanhf(c_stash);
  const float dc = dc_carry + dh * so * (1.f - tc * tc);
  const float d[4] = {(dc * su) * si * (1.f - si), (dc * cp) * sf * (1.f - sf),
                      (dh * tc) * so * (1.f - so), (dc * si) * (1.f - su * su)};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dT_s[(q * H + j) * kRows + b] = d[q];
    if (dgate_out != nullptr) put(dgate_out + q * H, d[q]);
  }
  return dc * sf;
}

// dh carry = dg_pre @ Wh^T (four K slices into scratch, then summed in a
// fixed order); at t == 0 the carries go out as dh0/dc0.
template <typename T>
__device__ __forceinline__ void carry_dh(const float* dT_s,
                                         const T* __restrict__ whT,
                                         float* scratch, float* dh_s,
                                         const float* dc_s, T* dh0, T* dc0,
                                         int t, int B, int H, int row0) {
  matmul_rows<4>(dT_s, whT, 4 * H, H, scratch);
  __syncthreads();
  const int n = kRows * H;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float d = ((scratch[i] + scratch[n + i]) + scratch[2 * n + i]) +
                    scratch[3 * n + i];
    dh_s[i] = d;
    const int b = i / H, j = i - b * H, row = row0 + b;
    if (t == 0 && row < B) {
      put(dh0 + (size_t)row * H + j, d);
      put(dc0 + (size_t)row * H + j, dc_s[i]);
    }
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void init_carries(const T* __restrict__ dhn,
                                             const T* __restrict__ dcn,
                                             float* dh_s, float* dc_s, int B,
                                             int H, int row0) {
  for (int i = threadIdx.x; i < kRows * H; i += kThreads) {
    const int b = i / H, j = i - b * H, row = row0 + b;
    dh_s[i] = row < B ? to_f(dhn[(size_t)row * H + j]) : 0.f;
    dc_s[i] = row < B ? to_f(dcn[(size_t)row * H + j]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
lstm_layer_bwd_v1_kernel(const T* __restrict__ gx,
                         const float* __restrict__ ghp,  // f32 for any T
                         const T* __restrict__ c_prev,
                         const T* __restrict__ c_seq,
                         const T* __restrict__ dy,
                         const T* __restrict__ whT,
                         const T* __restrict__ gln,
                         const T* __restrict__ bln,
                         const T* __restrict__ dhn,
                         const T* __restrict__ dcn,
                         T* __restrict__ dgate,
                         T* __restrict__ dgpre,
                         T* __restrict__ dh0,
                         T* __restrict__ dc0,
                         int S, int B, int H, int norm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int G = 4 * H;
  float* gh_s = smem;                 // (kRows, G): gh_pre; dh scratch
  float* dT_s = gh_s + kRows * G;     // (G, kRows): dgate, then dg_pre
  float* dh_s = dT_s + G * kRows;     // (kRows, H): dh carry
  float* dc_s = dh_s + kRows * H;     // (kRows, H): dc carry
  float* st_s = dc_s + kRows * H;     // (kRows, 4): mean rstd m1 m2

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kRows;
  const float inv_g = 1.0f / (float)G;

  init_carries(dhn, dcn, dh_s, dc_s, B, H, row0);

  for (int t = S - 1; t >= 0; --t) {
    // C. One warp per row: stage gh_pre_t and take its statistics.
    if (warp < kRows) {
      const int b = warp, row = row0 + b;
      const float* src = ghp + ((size_t)t * B + row) * G;
      float sh = 0.f, sh2 = 0.f;
      for (int col = 4 * lane; col < G; col += 4 * 32) {
        const float4 g = row < B
            ? __ldg(reinterpret_cast<const float4*>(src + col))
            : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(gh_s + b * G + col) = g;
        accum_quad(g, sh, sh2);
      }
      const float2 st_h = finish_stats(sh, sh2, G);
      if (lane == 0) {
        st_s[b * 4 + 0] = st_h.x;
        st_s[b * 4 + 1] = st_h.y;
      }
    }
    __syncthreads();

    // D. gate = gx + LN_h(gh_pre); cell backward, dgate out and into dT_s.
    for (int i = tid; i < kRows * H; i += kThreads) {
      const int b = i / H, j = i - b * H, row = row0 + b;
      const bool valid = row < B;
      const float mh = st_s[b * 4 + 0], rh = st_s[b * 4 + 1];
      const size_t og = ((size_t)t * B + row) * G + j;
      const size_t oh = ((size_t)t * B + row) * H + j;
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = q * H + j;
        float hg = gh_s[b * G + col];
        if (norm) hg = (hg - mh) * rh * ldf(gln + col) + ldf(bln + col);
        pre[q] = (valid ? ldf(gx + og + q * H) : 0.f) + hg;
      }
      const float cp = valid ? to_f(c_prev[oh]) : 0.f;
      const float dh = dh_s[i] + (valid ? to_f(dy[oh]) : 0.f);
      dc_s[i] = cell_backward(pre, cp, valid ? to_f(c_seq[oh]) : 0.f, dh,
                              dc_s[i], dT_s, H, j, b,
                              valid ? dgate + og : nullptr);
    }
    __syncthreads();

    // E. LN_h backward row means (norm only), one warp per row.
    if (norm && warp < kRows) {
      const int b = warp;
      const float mh = st_s[b * 4 + 0], rh = st_s[b * 4 + 1];
      float s1 = 0.f, s2 = 0.f;
      for (int col = lane; col < G; col += 32) {
        const float a = dT_s[col * kRows + b] * ldf(gln + col);
        s1 += a;
        s2 += a * ((gh_s[b * G + col] - mh) * rh);
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        st_s[b * 4 + 2] = s1 * inv_g;
        st_s[b * 4 + 3] = s2 * inv_g;
      }
    }
    __syncthreads();

    // F. One column per item: dg_pre_t out and kept in dT_s.
    for (int col = tid; col < G; col += kThreads) {
      float dg[kRows];
      load_rows8(dT_s + col * kRows, dg);
      if (norm) {
        const float g_h = ldf(gln + col);
#pragma unroll
        for (int b = 0; b < kRows; ++b) {
          const float* st = st_s + b * 4;
          const float xh = (gh_s[b * G + col] - st[0]) * st[1];
          dg[b] = st[1] * (dg[b] * g_h - st[2] - xh * st[3]);
        }
      }
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        if (row0 + b < B) put(dgpre + ((size_t)t * B + row0 + b) * G + col,
                             dg[b]);
        dg[b] = round_to<T>(dg[b]);   // the dh product reads the stored value
      }
      store_rows8(dT_s + col * kRows, dg);
    }
    __syncthreads();

    // G. dh carry = dg_pre @ Wh^T; dh0/dc0 out at t = 0.
    carry_dh(dT_s, whT, gh_s, dh_s, dc_s, dh0, dc0, t, B, H, row0);
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch_v1(const T* gx, const float* ghp, const T* c_prev, const T* c_seq,
              const T* dy, const T* whT, const T* gln, const T* bln,
              const T* dhn, const T* dcn, T* dgate, T* dgpre, T* dh0, T* dc0,
              int S, int B, int H, int norm, void* stream) {
  const size_t smem = v1_smem_floats(H) * sizeof(float);
  const int err = set_smem(lstm_layer_bwd_v1_kernel<T>, smem);
  if (err != 0) return err;
  const dim3 grid((B + kRows - 1) / kRows);
  lstm_layer_bwd_v1_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      gx, ghp, c_prev, c_seq, dy, whT, gln, bln, dhn, dcn, dgate, dgpre, dh0,
      dc0, S, B, H, norm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs at hidden size H (the same for f32
// and bf16 streams: the tiles are f32).
long long lstm_layer_bwd_v1_smem_bytes(int H) {
  return (long long)(v1_smem_floats(H) * sizeof(float));
}

// V1.  gx, gh_pre (S, B, 4H), c_prev, c_seq, dy (S, B, H), whT (4H, H),
// gln/bln (4H,), dhn/dcn (B, H) in; dgate, dgpre (S, B, 4H), dh0/dc0 (B, H)
// out.  gh_pre is f32 for either type; all else of one type (f32 or bf16),
// contiguous, H % 4 == 0.  Returns the launch status (cudaSuccess == 0).
int lstm_layer_bwd_v1_f32(const float* gx, const float* ghp,
                          const float* c_prev, const float* c_seq,
                          const float* dy, const float* whT, const float* gln,
                          const float* bln, const float* dhn, const float* dcn,
                          float* dgate, float* dgpre, float* dh0, float* dc0,
                          int S, int B, int H, int norm, void* stream) {
  return launch_v1(gx, ghp, c_prev, c_seq, dy, whT, gln, bln, dhn, dcn, dgate,
                   dgpre, dh0, dc0, S, B, H, norm, stream);
}

int lstm_layer_bwd_v1_bf16(const bf16* gx, const float* ghp,
                           const bf16* c_prev, const bf16* c_seq,
                           const bf16* dy, const bf16* whT, const bf16* gln,
                           const bf16* bln, const bf16* dhn, const bf16* dcn,
                           bf16* dgate, bf16* dgpre, bf16* dh0, bf16* dc0,
                           int S, int B, int H, int norm, void* stream) {
  return launch_v1(gx, ghp, c_prev, c_seq, dy, whT, gln, bln, dhn, dcn, dgate,
                   dgpre, dh0, dc0, S, B, H, norm, stream);
}

}  // extern "C"
