// LN-LSTM layer forward with the whole time loop inside one kernel launch,
// one CTA per 8 batch rows: kernel 1's route for H % 4 != 0.
//
// Replaces di_hpc_tpu/pallas_kernels/lstm_cell.py:_layer_kernel, with f32
// or bf16 streams and its stash mode: given c_seq, the kernel also writes the
// cell state of every step for the backward; without it (the serving path
// and any forward that needs no gradient) that (S, B, H) write is skipped,
// as the TPU kernel skips it (lstm_cell.py:150-153).  Per step t and batch
// row b:
//
//   gate = LN_x(gxp_t) + bias + LN_h(h @ Wh)      (norm = 1)
//   gate = gxp_t + bias + h @ Wh                   (norm = 0)
//   i, f, o = sigmoid, u = tanh (gate order i|f|o|u)
//   c = f*c + i*u;  h = o*tanh(c);  y_t = h  [c_seq_t = c]
//
// LayerNorm statistics are one pass over the 4H row, var = max(E[x^2] -
// E[x]^2, 0), exactly as the TPU kernel's _ln_stats; LN_x and the bias act
// on the RAW x @ Wx projection gxp, which the caller computes outside.
//
// bf16 streams (T = __nv_bfloat16), as the TPU kernel's notes at
// lstm_cell.py:130-141 set them: gxp, Wh, the five vectors, h0/c0 and every
// output are bf16; the c carry, the gate math and both LayerNorms'
// statistics stay f32.  h enters the product rounded to bf16 (:106), which
// is the value y stores, so the shared h tile simply holds the rounded h:
// nothing else reads the f32 h.  y, c_seq, h_n and c_n are the f32 values
// rounded once at the store.
//
// What bounds it on an H100: the h @ Wh product, 2*S*B*H*4H f32 operations,
// runs on the FP32 FMA pipes (67 TFLOP/s for the whole card, no tensor
// cores here), while HBM traffic is only the gxp/y streams: operations
// bound.  With bf16 streams it does the same f32 FMAs and moves half the
// bytes.
//
// Design.  Batch rows are independent and only time is sequential, so one
// CTA owns kRows rows and runs the whole S-step loop; nothing crosses CTAs.
// Wh (4.2 MB at H=512) does not fit in shared memory, so every CTA streams
// it from L2 once per step in float4 column strips; h stays in shared
// memory in a k-major (H, kRows) layout so one k step is two broadcast
// float4 loads and kRows*4 FMAs per thread (lstm_common.cuh:matmul_rows).
// The (kRows, 4H) gate tile and the gxp_t rows stay in shared memory for the
// LayerNorm and the gate math.
//
// Route.  This is kernel 1's route for H % 4 != 0 only: every other width
// runs lstm_layer_cluster.cu, whose C entry points (lstm_layer_fwd_f32 and
// _bf16) send these widths here, by shape.  It takes any H whose plan,
// 320*H + 128 bytes, fits a CTA (H <= 726).

#include "lstm_common.cuh"

namespace {

using namespace lstm;

__host__ __device__ constexpr size_t smem_floats(int H) {
  // gh (kRows, 4H) + gx (kRows, 4H) + hT (H, kRows) + c (kRows, H)
  // + stats (kRows, 4)
  return (size_t)kRows * (2 * 4 * H + 2 * H) + 4 * kRows;
}

// kStash: also write c_seq; the serving path's instantiation has no store
// and no branch for it.  T: the stream type, float or bf16.
template <typename T, bool kStash>
__global__ void __launch_bounds__(kThreads, 1)
lstm_layer_fwd_kernel(const T* __restrict__ gxp,
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
      hv = to_f(h0[(size_t)row * H + j]);
      cv = to_f(c0[(size_t)row * H + j]);
    }
    hT_s[j * kRows + b] = hv;
    c_s[i] = cv;
  }
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    // 1. gh = h @ Wh.
    matmul_rows(hT_s, wh, H, G, gh_s);
    __syncthreads();

    // 2. One warp per row: stage gxp_t into shared memory and take the
    //    one-pass LayerNorm statistics of both projections.
    if (warp < kRows) {
      const int b = warp, row = row0 + b;
      const T* src = gxp + ((size_t)t * B + row) * G;
      float sh = 0.f, sh2 = 0.f, sx = 0.f, sx2 = 0.f;
      for (int col = 4 * lane; col < G; col += 4 * 32) {
        const float4 g = *reinterpret_cast<const float4*>(gh_s + b * G + col);
        const float4 x = row < B ? load4(src + col)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(gx_s + b * G + col) = x;
        accum_quad(g, sh, sh2);
        accum_quad(x, sx, sx2);
      }
      const float2 st_h = finish_stats(sh, sh2, G);
      const float2 st_x = finish_stats(sx, sx2, G);
      if (lane == 0) {
        stat_s[b * 4 + 0] = st_h.x;
        stat_s[b * 4 + 1] = st_h.y;
        stat_s[b * 4 + 2] = st_x.x;
        stat_s[b * 4 + 3] = st_x.y;
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
          xg = (xg - mx) * rx * ldf(glnx + col) + ldf(blnx + col);
          hg = (hg - mh) * rh * ldf(gln + col) + ldf(bln + col);
        }
        pre[q] = (xg + ldf(bias + col)) + hg;
      }
      const float ig = sigmoid_f(pre[0]);
      const float fg = sigmoid_f(pre[1]);
      const float og = sigmoid_f(pre[2]);
      const float ug = tanhf(pre[3]);
      const float c = fg * c_s[i] + ig * ug;
      const float h = og * tanhf(c);
      c_s[i] = c;
      hT_s[j * kRows + b] = round_to<T>(h);
      if (row < B) {
        const size_t o = ((size_t)t * B + row) * H + j;
        put(y + o, h);
        if (kStash) put(c_seq + o, c);
        if (t == S - 1) {
          put(hn + (size_t)row * H + j, h);
          put(cn + (size_t)row * H + j, c);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch_fwd(const T* gxp, const T* wh, const T* glnx, const T* blnx,
               const T* gln, const T* bln, const T* bias, const T* h0,
               const T* c0, T* y, T* c_seq, T* hn, T* cn, int S, int B,
               int H, int norm, void* stream) {
  const size_t smem = smem_floats(H) * sizeof(float);
  auto kernel = c_seq != nullptr ? lstm_layer_fwd_kernel<T, true>
                                 : lstm_layer_fwd_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      gxp, wh, glnx, blnx, gln, bln, bias, h0, c0, y, c_seq, hn, cn, S, B, H,
      norm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs at hidden size H, in bytes.
long long lstm_layer_fwd8_smem_bytes(int H) {
  return (long long)(smem_floats(H) * sizeof(float));
}

// The arguments of lstm_layer_fwd_f32 / _bf16 (lstm_layer_cluster.cu),
// which call these for H % 4 != 0: gxp (S, B, 4H), wh (H, 4H), the five
// (4H,) vectors, h0/c0 (B, H) in; y (S, B, H), c_seq (S, B, H) or nullptr,
// hn/cn (B, H) out.  Returns the launch status (cudaSuccess == 0).
int lstm_layer_fwd8_f32(const float* gxp, const float* wh, const float* glnx,
                        const float* blnx, const float* gln, const float* bln,
                        const float* bias, const float* h0, const float* c0,
                        float* y, float* c_seq, float* hn, float* cn, int S,
                        int B, int H, int norm, void* stream) {
  return launch_fwd(gxp, wh, glnx, blnx, gln, bln, bias, h0, c0, y, c_seq,
                    hn, cn, S, B, H, norm, stream);
}

int lstm_layer_fwd8_bf16(const bf16* gxp, const bf16* wh, const bf16* glnx,
                         const bf16* blnx, const bf16* gln, const bf16* bln,
                         const bf16* bias, const bf16* h0, const bf16* c0,
                         bf16* y, bf16* c_seq, bf16* hn, bf16* cn, int S,
                         int B, int H, int norm, void* stream) {
  return launch_fwd(gxp, wh, glnx, blnx, gln, bln, bias, h0, c0, y, c_seq,
                    hn, cn, S, B, H, norm, stream);
}

}  // extern "C"
