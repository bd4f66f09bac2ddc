// Fused LSTM scan, x mode, f32, for sm_90a: the no-grad forward and the
// residual-writing forward of training.
//
// Replaces vmlmf_tpu/ops/pallas_scan.py::_fwd_kernel in the variants that
// lstm_scan_fused_xin runs in x mode, low-rank on both sides, f32: the
// no-grad primal (residuals=False) and the autodiff forward with the
// saved-gates policy (residuals=True, save_gates=True). For every batch row
// b and step t:
//
//   gi[t,b]  = (x[t,b] @ Ux) @ Vx + tile4(fit(x[t,b], h)) * xdvec + bias
//   pre      = gi[t,b] + (h @ U) @ V + tile4(h) * dvec        (gates i,f,g,o)
//   c        = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h        = sigmoid(o) * tanh(c);      ys[t,b] = h
//
// and c_last = c after the last step. fit() zero-extends or truncates x to
// h features. Layouts are the unpadded public ones of the JAX function:
// x [T,B,F], Ux [F,rx], Vx [rx,4h], xdvec [4,h], bias [4h], U [h,r],
// V [r,4h], dvec [4h], h0/c0 [B,h]; all row-major and contiguous.
//
// The residual variant also writes, per step, cs[t] = c [T,B,h], the
// post-nonlinearity gates [T,B,4h] (sigmoid(i), sigmoid(f), tanh(g),
// sigmoid(o) in four blocks of h) and hu[t] = h_prev @ U [T,B,r]; then
// c_last is cs[T-1]. It also keeps the first GEMM's xu = x @ Ux [T*B,rx]
// as a residual: the backward needs it for dVx, and keeping it costs one
// [T,B,rx] buffer where the TPU kernel recomputed x @ Ux per time block.
//
// What bounds it on an H100, and what the design does about it:
// * The input projection is time-parallel. It runs first as two tiled
//   GEMM launches over all T*B rows (xu = x@Ux, then gi = xu@Vx plus the
//   elementwise x term and bias), spread over many CTAs. It writes gi
//   [T,B,4h] to device memory and the scan reads it back, a round trip the
//   TPU kernel avoided by projecting each time block inside the scan.
// * The recurrence is a serial chain: each step needs all of h before h@U
//   and all of h@U before (h@U)@V. One CTA owns kRows batch rows and walks
//   all T steps, with the (h, c) carry and h@U in shared memory. U and V
//   (about 3.9 MB f32 per layer at h=650, r=300, far over one SM's 227 KB)
//   are read from L2 on every step, so each step is bound by one SM's L2
//   read rate, and at serving batch sizes most SMs stay idle. Spreading
//   U's and V's columns over all SMs, each holding its slice in shared
//   memory, with a grid-wide barrier per half-step, is the planned redesign.
// * The residual writes are coalesced rows of the step's outputs; they add
//   (h + 4h + r) floats per row and step of device-memory traffic.
// * Every edge (B, F, h, r, rx not multiples of a tile) is masked here.

#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace {

using vmlmf::cdiv;

constexpr int kRows = 4;         // batch rows per scan CTA
constexpr int kMaxThreads = 1024;

// Epilogue of the second projection GEMM: adds the x-side elementwise term
// and the bias to column j = g*h + jj: (jj < f ? x[i, jj] : 0) * xdvec[j] + bias[j].
struct GiEpilogue {
  float* gi;
  const float* x;
  const float* xdvec;
  const float* bias;
  int f, h;
  __device__ __forceinline__ void operator()(int i, int j, float v) const {
    const int jj = j % h;
    const float xv = jj < f ? x[(size_t)i * f + jj] : 0.f;
    gi[(size_t)i * 4 * h + j] = v + xv * xdvec[j] + bias[j];
  }
};

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// One CTA per kRows batch rows; the CTA walks all t_len steps. Shared memory:
// hs [kRows,h] and cs [kRows,h] (the carry), hus [kRows,r] (h @ U of the step).
// Rows past the batch stay zero and are never written out. With Residuals,
// the per-step cs_out, gates_out and hu_out are written and c_last is not.
template <bool Residuals>
__global__ void __launch_bounds__(kMaxThreads)
scan_kernel(const float* __restrict__ gi, const float* __restrict__ u,
            const float* __restrict__ v, const float* __restrict__ dvec,
            const float* __restrict__ h0, const float* __restrict__ c0,
            float* __restrict__ ys, float* __restrict__ c_last,
            float* __restrict__ cs_out, float* __restrict__ gates_out,
            float* __restrict__ hu_out, int t_len, int batch, int h, int r) {
  extern __shared__ float smem[];
  float* hs = smem;
  float* cs = hs + kRows * h;
  float* hus = cs + kRows * h;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, batch - b0);
  const int g4 = 4 * h;

  for (int i = threadIdx.x; i < kRows * h; i += blockDim.x) {
    const bool live = i / h < rows;
    hs[i] = live ? h0[(size_t)b0 * h + i] : 0.f;
    cs[i] = live ? c0[(size_t)b0 * h + i] : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < t_len; ++t) {
    const size_t row_t = (size_t)t * batch + b0;  // first output row of this step
    // hus = hs @ U: one thread per rank column, U read down its column.
    for (int col = threadIdx.x; col < r; col += blockDim.x) {
      float acc[kRows] = {};
#pragma unroll 4
      for (int j = 0; j < h; ++j) {
        const float w = __ldg(u + (size_t)j * r + col);
#pragma unroll
        for (int row = 0; row < kRows; ++row) acc[row] = fmaf(hs[row * h + j], w, acc[row]);
      }
#pragma unroll
      for (int row = 0; row < kRows; ++row) {
        hus[row * r + col] = acc[row];
        if (Residuals && row < rows) hu_out[(row_t + row) * r + col] = acc[row];
      }
    }
    __syncthreads();

    // hus @ V, then the gates, for hidden unit j of all four gates: each
    // (row, j) of the carry is read and written by its own thread only.
    const float* gi_t = gi + row_t * g4;
    float* ys_t = ys + row_t * h;
    for (int j = threadIdx.x; j < h; j += blockDim.x) {
      float acc[4][kRows] = {};
#pragma unroll 4
      for (int k = 0; k < r; ++k) {
        const float* vk = v + (size_t)k * g4 + j;
        const float w0 = __ldg(vk), w1 = __ldg(vk + h);
        const float w2 = __ldg(vk + 2 * h), w3 = __ldg(vk + 3 * h);
#pragma unroll
        for (int row = 0; row < kRows; ++row) {
          const float hu = hus[row * r + k];
          acc[0][row] = fmaf(hu, w0, acc[0][row]);
          acc[1][row] = fmaf(hu, w1, acc[1][row]);
          acc[2][row] = fmaf(hu, w2, acc[2][row]);
          acc[3][row] = fmaf(hu, w3, acc[3][row]);
        }
      }
      const float d0 = dvec[j], d1 = dvec[h + j], d2 = dvec[2 * h + j], d3 = dvec[3 * h + j];
#pragma unroll
      for (int row = 0; row < kRows; ++row) {
        if (row < rows) {
          const float hp = hs[row * h + j];
          const float* gr = gi_t + (size_t)row * g4;
          const float si = sigmoid(gr[j] + acc[0][row] + hp * d0);
          const float sf = sigmoid(gr[h + j] + acc[1][row] + hp * d1);
          const float tg = tanhf(gr[2 * h + j] + acc[2][row] + hp * d2);
          const float so = sigmoid(gr[3 * h + j] + acc[3][row] + hp * d3);
          const float cn = sf * cs[row * h + j] + si * tg;
          const float hn = so * tanhf(cn);
          cs[row * h + j] = cn;
          hs[row * h + j] = hn;
          ys_t[(size_t)row * h + j] = hn;
          if (Residuals) {
            cs_out[(row_t + row) * h + j] = cn;
            float* gw = gates_out + (row_t + row) * g4;
            gw[j] = si;
            gw[h + j] = sf;
            gw[2 * h + j] = tg;
            gw[3 * h + j] = so;
          }
        }
      }
    }
    __syncthreads();
  }

  if (!Residuals)
    for (int i = threadIdx.x; i < rows * h; i += blockDim.x) c_last[(size_t)b0 * h + i] = cs[i];
}

// The two projection GEMMs, then the scan; returns cudaGetLastError().
template <bool Residuals>
int launch(const float* x, const float* ux, const float* vx, const float* xdvec,
           const float* bias, const float* u, const float* v, const float* dvec,
           const float* h0, const float* c0, float* xu, float* gi, float* ys,
           float* c_last, float* cs, float* gates, float* hu, int t_len, int batch,
           int f, int rx, int h, int r, cudaStream_t stream) {
  const int m = t_len * batch;
  const int g4 = 4 * h;
  cudaError_t err;

  err = vmlmf::gemm(vmlmf::RowMajor{x, f}, vmlmf::RowMajor{ux, rx}, vmlmf::Store{xu, rx},
                    m, rx, f, stream);
  if (err != cudaSuccess) return err;
  err = vmlmf::gemm(vmlmf::RowMajor{xu, rx}, vmlmf::RowMajor{vx, g4},
                    GiEpilogue{gi, x, xdvec, bias, f, h}, m, g4, rx, stream);
  if (err != cudaSuccess) return err;

  const size_t smem = sizeof(float) * (2 * kRows * h + kRows * r);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(scan_kernel<Residuals>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int span = h > r ? h : r;
  const int want = cdiv(span, 32) * 32;
  const int threads = want < kMaxThreads ? want : kMaxThreads;
  scan_kernel<Residuals><<<cdiv(batch, kRows), threads, smem, stream>>>(
      gi, u, v, dvec, h0, c0, ys, c_last, cs, gates, hu, t_len, batch, h, r);
  return cudaGetLastError();
}

}  // namespace

// No-grad forward. xu [T*B, rx] and gi [T*B, 4h] are scratch that the
// caller allocates; writes ys [T,B,h] and c_last [B,h].
extern "C" int lstm_scan_xin_fwd(
    const float* x, const float* ux, const float* vx, const float* xdvec,
    const float* bias, const float* u, const float* v, const float* dvec,
    const float* h0, const float* c0, float* xu, float* gi, float* ys,
    float* c_last, int t_len, int batch, int f, int rx, int h, int r,
    void* stream_handle) {
  return launch<false>(x, ux, vx, xdvec, bias, u, v, dvec, h0, c0, xu, gi, ys, c_last,
                       nullptr, nullptr, nullptr, t_len, batch, f, rx, h, r,
                       static_cast<cudaStream_t>(stream_handle));
}

// Residual forward of training. gi [T*B, 4h] is scratch; writes ys and the
// residuals xu [T*B, rx], cs [T,B,h], gates [T,B,4h] and hu [T,B,r].
extern "C" int lstm_scan_xin_fwd_res(
    const float* x, const float* ux, const float* vx, const float* xdvec,
    const float* bias, const float* u, const float* v, const float* dvec,
    const float* h0, const float* c0, float* xu, float* gi, float* ys,
    float* cs, float* gates, float* hu, int t_len, int batch, int f, int rx,
    int h, int r, void* stream_handle) {
  return launch<true>(x, ux, vx, xdvec, bias, u, v, dvec, h0, c0, xu, gi, ys, nullptr,
                      cs, gates, hu, t_len, batch, f, rx, h, r,
                      static_cast<cudaStream_t>(stream_handle));
}

// The message of an error code that an entry of this file returned.
extern "C" const char* lstm_scan_xin_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
