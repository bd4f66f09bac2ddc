// Fused LSTM scan, x mode, f32, for sm_90a: the no-grad forward and the
// residual-writing forward of training.
//
// Replaces vmlmf_tpu/ops/pallas_scan.py::_fwd_kernel in the variants that
// lstm_scan_fused_xin runs in x mode, f32, each side low-rank or dense: the
// no-grad primal (residuals=False) and the autodiff forward with the
// saved-gates policy (residuals=True, save_gates=True). For every batch row
// b and step t:
//
//   gi[t,b]  = x[t,b] @ Ux [@ Vx] + tile4(fit(x[t,b], h)) * xdvec + bias
//   pre      = gi[t,b] + h @ U [@ V] + tile4(h) * dvec        (gates i,f,g,o)
//   c        = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h        = sigmoid(o) * tanh(c);      ys[t,b] = h
//
// and c_last = c after the last step. fit() zero-extends or truncates x to
// h features. Layouts are the unpadded public ones of the JAX function:
// x [T,B,F], xdvec [4,h], bias [4h], dvec [4h], h0/c0 [B,h]; the x side
// low-rank Ux [F,rx], Vx [rx,4h] or dense Ux [F,4h] (Vx null, "DenseX");
// the recurrent side low-rank U [h,r], V [r,4h] or dense U [h,4h] (V null,
// "DenseRec"); all row-major and contiguous. A null Vx or V picks the dense
// form of its side.
//
// The residual variant also writes, per step, cs[t] = c [T,B,h], the
// post-nonlinearity gates [T,B,4h] (sigmoid(i), sigmoid(f), tanh(g),
// sigmoid(o) in four blocks of h) and, low-rank, hu[t] = h_prev @ U
// [T,B,r]; then c_last is cs[T-1]. A low-rank x side also keeps the first
// GEMM's xu = x @ Ux [T*B,rx] as a residual: the backward needs it for dVx,
// and keeping it costs one [T,B,rx] buffer where the TPU kernel recomputed
// x @ Ux per time block. The dense forms have no hu and no xu.
//
// What bounds it on an H100, and what the design does about it:
// * The input projection is time-parallel. It runs first as tiled GEMM
//   launches over all T*B rows, spread over many CTAs: xu = x@Ux, then gi =
//   xu@Vx plus the elementwise x term and bias; or, for a dense x side, one
//   GEMM gi = x@Ux whose epilogue adds the x term and bias. It writes gi
//   [T,B,4h] to device memory and the scan reads it back, a round trip the
//   TPU kernel avoided by projecting each time block inside the scan.
// * The recurrence is a serial chain: each step needs all of h before h@U.
//   One CTA owns kRows batch rows and walks all T steps with the (h, c)
//   carry in shared memory. The recurrent weights (U and V, about 3.9 MB
//   f32 per layer at h=650, r=300; a dense U [650, 2600], 6.8 MB; far over
//   one SM's 227 KB) are read from L2 on every step, so each step is bound
//   by one SM's L2 read rate, and at serving batch sizes most SMs stay idle.
//   Spreading their columns over all SMs, each holding its slice in shared
//   memory, with a grid-wide barrier per step, is the planned redesign.
// * Low-rank: two phases a step, h@U into shared memory (one thread per
//   rank column, U read down its column), a block barrier, then (h@U)@V and
//   the gates (one thread per hidden unit j, V's four gate columns of j
//   read along its rows: neighbouring lanes, neighbouring words), a second
//   barrier. Dense: one phase, h@U and the gates, one thread per j reading
//   U's four gate columns of j down its rows, coalesced across lanes; h is
//   double-buffered in shared memory (read one, write the other), so a
//   step needs one block barrier.
// * The residual writes are coalesced rows of the step's outputs; they add
//   (h + 4h + r) floats per row and step of device-memory traffic.
// * Every edge (B, F, h, r, rx not multiples of a tile) is masked here.

#include <cuda_runtime.h>

#include "gemm_tile.cuh"
#include "lstm_steps.cuh"

namespace {

using vmlmf::cdiv;
using vmlmf::kRows;              // batch rows per scan CTA

constexpr int kMaxThreads = 1024;

// Epilogue of the projection GEMM that yields gi (the second one, or the only
// one for a dense x side): adds the x-side elementwise term and the bias to
// column j = g*h + jj: (jj < f ? x[i, jj] : 0) * xdvec[j] + bias[j].
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

// One CTA per kRows batch rows; the CTA walks all t_len steps. Shared memory:
// hs [kRows,h] and cs [kRows,h] (the carry), then, low-rank, hus [kRows,r]
// (h @ U of the step) or, dense, a second h buffer [kRows,h]. Rows past the
// batch stay zero and are never written out. With Residuals, the per-step
// cs_out, gates_out and (low-rank) hu_out are written and c_last is not.
template <bool Residuals, bool DenseRec>
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
  float* extra = cs + kRows * h;  // hus [kRows, r], or the second h buffer
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, batch - b0);

  for (int i = threadIdx.x; i < kRows * h; i += blockDim.x) {
    const bool live = i / h < rows;
    hs[i] = live ? h0[(size_t)b0 * h + i] : 0.f;
    cs[i] = live ? c0[(size_t)b0 * h + i] : 0.f;
    if (DenseRec) extra[i] = 0.f;
  }
  __syncthreads();

  vmlmf::lstm_fwd_steps<Residuals, DenseRec>(0, t_len, gi, u, v, dvec, hs, cs, extra, batch, b0,
                                              ys, cs_out, gates_out, hu_out, rows, h, r);

  if (!Residuals)
    for (int i = threadIdx.x; i < rows * h; i += blockDim.x) c_last[(size_t)b0 * h + i] = cs[i];
}

// Launches scan_kernel<Residuals, DenseRec>; returns the launch's error.
template <bool Residuals, bool DenseRec>
cudaError_t scan(const float* gi, const float* u, const float* v, const float* dvec,
                 const float* h0, const float* c0, float* ys, float* c_last, float* cs,
                 float* gates, float* hu, int t_len, int batch, int h, int r,
                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRows * (DenseRec ? 3 * h : 2 * h + r);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(scan_kernel<Residuals, DenseRec>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int span = DenseRec || h > r ? h : r;
  const int want = cdiv(span, 32) * 32;
  const int threads = want < kMaxThreads ? want : kMaxThreads;
  scan_kernel<Residuals, DenseRec><<<cdiv(batch, kRows), threads, smem, stream>>>(
      gi, u, v, dvec, h0, c0, ys, c_last, cs, gates, hu, t_len, batch, h, r);
  return cudaGetLastError();
}

// The projection GEMMs (two, or one for a dense x side), then the scan of
// the recurrent form; returns the first error.
template <bool Residuals>
int launch(const float* x, const float* ux, const float* vx, const float* xdvec,
           const float* bias, const float* u, const float* v, const float* dvec,
           const float* h0, const float* c0, float* xu, float* gi, float* ys,
           float* c_last, float* cs, float* gates, float* hu, int t_len, int batch,
           int f, int rx, int h, int r, cudaStream_t stream) {
  const int m = t_len * batch;
  const int g4 = 4 * h;
  const GiEpilogue epi{gi, x, xdvec, bias, f, h};
  cudaError_t err;

  if (vx == nullptr) {  // dense x side: gi = x @ Ux + the x term and bias
    err = vmlmf::gemm(vmlmf::RowMajor{x, f}, vmlmf::RowMajor{ux, g4}, epi, m, g4, f, stream);
  } else {
    err = vmlmf::gemm(vmlmf::RowMajor{x, f}, vmlmf::RowMajor{ux, rx}, vmlmf::Store{xu, rx},
                      m, rx, f, stream);
    if (err != cudaSuccess) return err;
    err = vmlmf::gemm(vmlmf::RowMajor{xu, rx}, vmlmf::RowMajor{vx, g4}, epi, m, g4, rx, stream);
  }
  if (err != cudaSuccess) return err;

  if (v == nullptr)
    return scan<Residuals, true>(gi, u, v, dvec, h0, c0, ys, c_last, cs, gates, hu, t_len,
                                 batch, h, r, stream);
  return scan<Residuals, false>(gi, u, v, dvec, h0, c0, ys, c_last, cs, gates, hu, t_len,
                                batch, h, r, stream);
}

}  // namespace

// No-grad forward. xu [T*B, rx] (null for a dense x side) and gi [T*B, 4h]
// are scratch that the caller allocates; writes ys [T,B,h] and c_last [B,h].
// vx null: dense x side, rx unused; v null: dense recurrent side, r unused.
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
// residuals xu [T*B, rx] (null for a dense x side), cs [T,B,h], gates
// [T,B,4h] and hu [T,B,r] (null for a dense recurrent side).
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
