// LN-LSTM layer forward with the whole time loop inside one kernel launch.
//
// Replaces di_hpc_tpu/pallas_kernels/lstm_cell.py:_layer_kernel (the
// forward, stash=False, f32 streams).  Per step t and batch row b:
//
//   gate = LN_x(gxp_t) + bias + LN_h(h @ Wh)      (norm = 1)
//   gate = gxp_t + bias + h @ Wh                   (norm = 0)
//   i, f, o = sigmoid, u = tanh (gate order i|f|o|u)
//   c = f*c + i*u;  h = o*tanh(c);  y_t = h
//
// LayerNorm statistics are one pass over the 4H row, var = max(E[x^2] -
// E[x]^2, 0), exactly as the TPU kernel's _ln_stats; LN_x and the bias act
// on the RAW x @ Wx projection gxp, which the caller computes outside.
//
// What bounds it on an H100: the h @ Wh product, 2*S*B*H*4H f32 operations,
// runs on the FP32 FMA pipes (67 TFLOP/s for the whole card, no tensor
// cores in this version), while HBM traffic is only the gxp/y streams.  At
// S=33, B=256, H=512 that is 17.7 GFLOP against ~93 MB: operations bound.
//
// Design.  Batch rows are independent and only time is sequential, so one
// CTA owns kRows rows and runs the whole S-step loop; the loop takes the
// place of the TPU's sequential grid axis and nothing crosses CTAs.  Wh (4.2
// MB at H=512) does not fit in shared memory, so every CTA streams it from
// L2 once per step in float4 column strips; h stays in shared memory in a
// k-major (H, kRows) layout so one k step is two broadcast float4 loads and
// kRows*4 FMAs per thread.  The (kRows, 4H) gate tile and the gxp_t rows
// stay in shared memory for the LayerNorm and the gate math.  kRows trades
// CTAs in flight against L2 traffic for Wh (each CTA reads all of Wh every
// step); splitting Wh across a thread-block cluster and moving the product
// to tensor cores are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;            // batch rows per CTA
constexpr int kThreads = 512;       // 4 gate columns per thread per strip
constexpr int kKUnroll = 8;         // Wh rows loaded ahead per thread
constexpr float kLnEps = 1e-5f;     // utils/constants.py LAYERNORM_EPS
static_assert(kRows == 8, "fma_rows reads h as two float4 of 4 rows");

__host__ __device__ constexpr size_t smem_floats(int H) {
  // gh (kRows, 4H) + gx (kRows, 4H) + hT (H, kRows) + c (kRows, H)
  // + stats (kRows, 4)
  return (size_t)kRows * (2 * 4 * H + 2 * H) + 4 * kRows;
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void fma_rows(float (&acc)[kRows][4], float4 w,
                                         const float* hk) {
  const float4 lo = *reinterpret_cast<const float4*>(hk);
  const float4 hi = *reinterpret_cast<const float4*>(hk + 4);
  const float hv[kRows] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int b = 0; b < kRows; ++b) {
    acc[b][0] += hv[b] * w.x;
    acc[b][1] += hv[b] * w.y;
    acc[b][2] += hv[b] * w.z;
    acc[b][3] += hv[b] * w.w;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
lstm_layer_fwd_kernel(const float* __restrict__ gxp,
                      const float* __restrict__ wh,
                      const float* __restrict__ glnx,
                      const float* __restrict__ blnx,
                      const float* __restrict__ gln,
                      const float* __restrict__ bln,
                      const float* __restrict__ bias,
                      const float* __restrict__ h0,
                      const float* __restrict__ c0,
                      float* __restrict__ y,
                      float* __restrict__ hn,
                      float* __restrict__ cn,
                      int S, int B, int H, int norm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int G = 4 * H;
  float* gh_s = smem;                  // (kRows, G)
  float* gx_s = gh_s + kRows * G;      // (kRows, G)
  float* hT_s = gx_s + kRows * G;      // (H, kRows)
  float* c_s = hT_s + H * kRows;       // (kRows, H)
  float* stat_s = c_s + kRows * H;     // (kRows, 4): mean_h rstd_h mean_x rstd_x

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kRows;

  // Initial state.  Rows past B compute on zeros and are never written.
  for (int i = tid; i < kRows * H; i += kThreads) {
    const int b = i / H, j = i - b * H, row = row0 + b;
    float hv = 0.f, cv = 0.f;
    if (row < B) {
      hv = h0[(size_t)row * H + j];
      cv = c0[(size_t)row * H + j];
    }
    hT_s[j * kRows + b] = hv;
    c_s[i] = cv;
  }
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    // 1. gh = h @ Wh: each thread owns 4 adjacent gate columns per strip.
    for (int col = 4 * tid; col < G; col += 4 * kThreads) {
      float acc[kRows][4];
#pragma unroll
      for (int b = 0; b < kRows; ++b)
        acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0.f;
      const float* wcol = wh + col;
      int k = 0;
      for (; k + kKUnroll <= H; k += kKUnroll) {
        float4 w[kKUnroll];
#pragma unroll
        for (int u = 0; u < kKUnroll; ++u)
          w[u] = __ldg(reinterpret_cast<const float4*>(
              wcol + (size_t)(k + u) * G));
#pragma unroll
        for (int u = 0; u < kKUnroll; ++u)
          fma_rows(acc, w[u], hT_s + (k + u) * kRows);
      }
      for (; k < H; ++k)
        fma_rows(acc,
                 __ldg(reinterpret_cast<const float4*>(wcol + (size_t)k * G)),
                 hT_s + k * kRows);
#pragma unroll
      for (int b = 0; b < kRows; ++b)
        *reinterpret_cast<float4*>(gh_s + b * G + col) =
            make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
    }
    __syncthreads();

    // 2. One warp per row: stage gxp_t into shared memory and take the
    //    one-pass LayerNorm statistics of both projections.
    if (warp < kRows) {
      const int b = warp, row = row0 + b;
      const float* src = gxp + ((size_t)t * B + row) * G;
      float sh = 0.f, sh2 = 0.f, sx = 0.f, sx2 = 0.f;
      for (int col = 4 * lane; col < G; col += 4 * 32) {
        const float4 g = *reinterpret_cast<const float4*>(gh_s + b * G + col);
        const float4 x = row < B
            ? __ldg(reinterpret_cast<const float4*>(src + col))
            : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(gx_s + b * G + col) = x;
        sh += (g.x + g.y) + (g.z + g.w);
        sh2 += (g.x * g.x + g.y * g.y) + (g.z * g.z + g.w * g.w);
        sx += (x.x + x.y) + (x.z + x.w);
        sx2 += (x.x * x.x + x.y * x.y) + (x.z * x.z + x.w * x.w);
      }
      sh = warp_sum(sh);
      sh2 = warp_sum(sh2);
      sx = warp_sum(sx);
      sx2 = warp_sum(sx2);
      if (lane == 0) {
        const float inv = 1.0f / (float)G;
        const float mh = sh * inv, mx = sx * inv;
        stat_s[b * 4 + 0] = mh;
        stat_s[b * 4 + 1] = rsqrtf(fmaxf(sh2 * inv - mh * mh, 0.f) + kLnEps);
        stat_s[b * 4 + 2] = mx;
        stat_s[b * 4 + 3] = rsqrtf(fmaxf(sx2 * inv - mx * mx, 0.f) + kLnEps);
      }
    }
    __syncthreads();

    // 3. Gate math and state update, one (row, hidden unit) per item.
    for (int i = tid; i < kRows * H; i += kThreads) {
      const int b = i / H, j = i - b * H, row = row0 + b;
      const float mh = stat_s[b * 4 + 0], rh = stat_s[b * 4 + 1];
      const float mx = stat_s[b * 4 + 2], rx = stat_s[b * 4 + 3];
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = q * H + j;
        float xg = gx_s[b * G + col];
        float hg = gh_s[b * G + col];
        if (norm) {
          xg = (xg - mx) * rx * __ldg(glnx + col) + __ldg(blnx + col);
          hg = (hg - mh) * rh * __ldg(gln + col) + __ldg(bln + col);
        }
        pre[q] = (xg + __ldg(bias + col)) + hg;
      }
      const float ig = sigmoid_f(pre[0]);
      const float fg = sigmoid_f(pre[1]);
      const float og = sigmoid_f(pre[2]);
      const float ug = tanhf(pre[3]);
      const float c = fg * c_s[i] + ig * ug;
      const float h = og * tanhf(c);
      c_s[i] = c;
      hT_s[j * kRows + b] = h;
      if (row < B) {
        y[((size_t)t * B + row) * H + j] = h;
        if (t == S - 1) {
          hn[(size_t)row * H + j] = h;
          cn[(size_t)row * H + j] = c;
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs at hidden size H, in bytes.
long long lstm_layer_smem_bytes(int H) {
  return (long long)(smem_floats(H) * sizeof(float));
}

int lstm_layer_rows_per_cta(void) { return kRows; }

// gxp (S, B, 4H), wh (H, 4H), the five (4H,) vectors, h0/c0 (B, H) in;
// y (S, B, H), hn/cn (B, H) out.  All f32, contiguous, gxp and wh 16-byte
// aligned.  Returns the launch status (cudaSuccess == 0).
int lstm_layer_fwd_f32(const float* gxp, const float* wh, const float* glnx,
                       const float* blnx, const float* gln, const float* bln,
                       const float* bias, const float* h0, const float* c0,
                       float* y, float* hn, float* cn, int S, int B, int H,
                       int norm, void* stream) {
  const size_t smem = smem_floats(H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_layer_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  lstm_layer_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      gxp, wh, glnx, blnx, gln, bln, bias, h0, c0, y, hn, cn, S, B, H, norm);
  return (int)cudaGetLastError();
}

}  // extern "C"
