// Backward of the fused LSTM scan (x mode, f32, saved gates), for sm_90a.
//
// Replaces vmlmf_tpu/ops/pallas_scan.py::_bwd_kernel in the variant that
// lstm_scan_fused_xin's VJP runs in x mode, f32, with the saved-gates
// residual policy, each side low-rank or dense as in the forward
// (lstm_scan_xin_fwd.cu: a null V is a dense U [h,4h], "DenseRec"; a null
// Vx a dense Ux [F,4h], "DenseX"). From the residuals of the forward (entry
// lstm_scan_xin_fwd_res) and the cotangents dys [T,B,h] and dc_last [B,h],
// each of which may be absent (zeros), it computes, walking t = T-1 .. 0
// with the carry (dh, dc), dc = dc_last at the start:
//
//   dh    += dys[t];  tc = tanh(cs[t]);  (i, f, g, o) = gates[t]
//   dc    += dh * o * (1 - tc^2)
//   dpre   = [dc*g*i*(1-i), dc*c_prev*f*(1-f), dc*i*(1-g^2), dh*tc*o*(1-o)]
//   dc     = dc * f
//   low-rank:  dhu = dpre @ V^T [B, r];   dh = sum_g dpre_g * dvec_g + dhu @ U^T
//   dense:     dh = sum_g dpre_g * dvec_g + dpre @ U^T
//
// then dh0 = dh, dc0 = dc, and the gradients of the weights and of x:
//
//   low-rank:  dU = Hprev^T dHU,  dV = HU^T dPre;      dense: dU = Hprev^T dPre
//   low-rank x side:  dXU = dPre Vx^T,  dx = dXU Ux^T + fit(sum_g dPre_g * xdvec_g, F),
//                     dUx = X^T dXU,  dVx = XU^T dPre
//   dense x side:     dx = dPre Ux^T + fit(sum_g dPre_g * xdvec_g, F),  dUx = X^T dPre
//   ddvec = sum_m dPre * tile4(Hprev),  dxdvec = sum_m dPre * tile4(fit(X, h)),
//   dbias = sum_m dPre
//
// over all M = T*B rows, where Hprev row (t, b) is h0[b] at t = 0 and
// ys[t-1, b] after. Layouts as in the forward; all row-major, contiguous.
//
// What bounds it on an H100, and what the design does about it:
// * The TPU kernel runs its grid in order and sums dU, dV, ... in scratch
//   across grid steps. Here CTAs run in parallel, so the work is split:
//   1. bptt_kernel, the serial part. One CTA owns kRows batch rows and
//      walks all T steps with the (dh, dc) carry, dpre and (low-rank) dhu of
//      the step in shared memory. It reads c_prev straight from cs[t-1] or
//      c0, and writes dpre [T*B, 4h] and dhu [T*B, r] to device memory for
//      the passes below (7.3 MB of dpre per layer at B=20, T=35, h=650:
//      traffic the TPU avoided by keeping dpre in VMEM per time block). Each
//      step reads the recurrent weights through L2 (V then U, or the dense
//      U [h, 4h]), one warp per output, lanes along the weight's row, so
//      that neighbouring lanes read neighbouring words with no transposed
//      copy: dpre @ U^T reduces over U's row j, which is contiguous. It is
//      bound by one SM's L2 read rate, like the forward. The redesign across
//      SMs covers both. Block barriers: three a step low-rank, two dense.
//   2. Time-parallel passes over all M rows: tiled GEMMs (gemm_tile.cuh)
//      with transposed operand views (six low-rank, three with a dense
//      side of each kind), and one column-sum kernel. Every weight gradient
//      is summed by one CTA per output tile or column block in a fixed
//      order: deterministic, no atomics.
// * Shared memory of bptt_kernel is over 48 KB at h=650 (67 KB low-rank,
//   62 KB dense), raised through cudaFuncSetAttribute.
// * Every edge is masked: B, T*B, F, h, r, rx need not be tile multiples,
//   and fit() covers F = h, F < h and F > h.

#include <cuda_runtime.h>

#include "gemm_tile.cuh"
#include "lstm_steps.cuh"

namespace {

using vmlmf::cdiv;
using vmlmf::kRows;                // batch rows per serial CTA

constexpr int kBpttThreads = 1024;

// Serial reverse walk. Shared memory: dhs, dcs [kRows,h] (the carry), dps
// [kRows,4h] (dpre of the step), and, low-rank, dhus [kRows,r] (dhu of the
// step). Rows past the batch stay zero and are never written out.
template <bool DenseRec>
__global__ void __launch_bounds__(kBpttThreads)
bptt_kernel(const float* __restrict__ gates, const float* __restrict__ cs,
            const float* __restrict__ c0, const float* __restrict__ dys,
            const float* __restrict__ dc_last, const float* __restrict__ u,
            const float* __restrict__ v, const float* __restrict__ dvec,
            float* __restrict__ dpre, float* __restrict__ dhu,
            float* __restrict__ dh0, float* __restrict__ dc0,
            int t_len, int batch, int h, int r) {
  extern __shared__ float smem[];
  const int g4 = 4 * h;
  float* dhs = smem;
  float* dcs = dhs + kRows * h;
  float* dps = dcs + kRows * h;
  float* dhus = dps + kRows * g4;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, batch - b0);

  for (int i = threadIdx.x; i < kRows * h; i += blockDim.x) {
    const bool live = i / h < rows;
    dhs[i] = 0.f;
    dcs[i] = live && dc_last != nullptr ? dc_last[(size_t)b0 * h + i] : 0.f;
  }
  for (int i = threadIdx.x; i < kRows * (g4 + (DenseRec ? 0 : r)); i += blockDim.x) dps[i] = 0.f;
  __syncthreads();

  for (int t = t_len - 1; t >= 0; --t)
    vmlmf::lstm_bwd_step<DenseRec>(t, (size_t)t * batch + b0, batch, b0, gates, cs, c0, dys, u, v,
                                   dvec, dhs, dcs, dps, dhus, dpre, dhu, rows, h, r);

  for (int i = threadIdx.x; i < rows * h; i += blockDim.x) {
    dh0[(size_t)b0 * h + i] = dhs[i];
    dc0[(size_t)b0 * h + i] = dcs[i];
  }
}

// Launches bptt_kernel<DenseRec>; returns the launch's error.
template <bool DenseRec>
cudaError_t bptt(const float* gates, const float* cs, const float* c0, const float* dys,
                 const float* dc_last, const float* u, const float* v, const float* dvec,
                 float* dpre, float* dhu, float* dh0, float* dc0, int t_len, int batch, int h,
                 int r, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRows * (2 * h + 4 * h + (DenseRec ? 0 : r));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bptt_kernel<DenseRec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  bptt_kernel<DenseRec><<<cdiv(batch, kRows), kBpttThreads, smem, stream>>>(
      gates, cs, c0, dys, dc_last, u, v, dvec, dpre, dhu, dh0, dc0, t_len, batch, h, r);
  return cudaGetLastError();
}

// Epilogue of dx = dXU @ Ux^T (or dPre @ Ux^T for a dense x side): adds
// fit(sum_g dpre_g * xdvec_g, f) to column j.
struct DxEpilogue {
  float* dx;
  const float* dpre;
  const float* xdvec;
  int f, h;
  __device__ __forceinline__ void operator()(int i, int j, float v) const {
    if (j < h) {
      const float* dp = dpre + (size_t)i * 4 * h + j;
      v += dp[0] * xdvec[j] + dp[h] * xdvec[h + j] + dp[2 * h] * xdvec[2 * h + j]
           + dp[3 * h] * xdvec[3 * h + j];
    }
    dx[(size_t)i * f + j] = v;
  }
};

}  // namespace

// Launches the serial kernel, the GEMMs and the column sums on `stream`;
// returns the first error. dys and dc_last may be null (zeros). dpre
// [T*B, 4h], dhu [T*B, r] and dxu [T*B, rx] are scratch that the caller
// allocates (dhu null for a dense recurrent side, dxu for a dense x side);
// every other pointer after them is an output (dv and dvx null with them).
extern "C" int lstm_scan_xin_bwd(
    const float* x, const float* ux, const float* vx, const float* xdvec,
    const float* u, const float* v, const float* dvec, const float* h0,
    const float* c0, const float* ys, const float* cs, const float* gates,
    const float* hu, const float* xu, const float* dys, const float* dc_last,
    float* dpre, float* dhu, float* dxu, float* dx, float* dux, float* dvx,
    float* dxdvec, float* dbias, float* du, float* dv, float* ddvec,
    float* dh0, float* dc0, int t_len, int batch, int f, int rx, int h, int r,
    void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int m = t_len * batch;
  const int g4 = 4 * h;
  using vmlmf::RowMajor;
  using vmlmf::Store;
  using vmlmf::Transposed;
  const vmlmf::PrevRowsT hprev_t{h0, ys, batch, h};
  cudaError_t err;

  if (v == nullptr) {
    err = bptt<true>(gates, cs, c0, dys, dc_last, u, v, dvec, dpre, dhu, dh0, dc0, t_len, batch,
                     h, r, stream);
    if (err != cudaSuccess) return err;
    // dU [h, 4h] = Hprev^T dPre
    err = vmlmf::gemm(hprev_t, RowMajor{dpre, g4}, Store{du, g4}, h, g4, m, stream);
  } else {
    err = bptt<false>(gates, cs, c0, dys, dc_last, u, v, dvec, dpre, dhu, dh0, dc0, t_len,
                      batch, h, r, stream);
    if (err != cudaSuccess) return err;
    // dV [r, 4h] = HU^T dPre;  dU [h, r] = Hprev^T dHU
    err = vmlmf::gemm(Transposed{hu, r}, RowMajor{dpre, g4}, Store{dv, g4}, r, g4, m, stream);
    if (err != cudaSuccess) return err;
    err = vmlmf::gemm(hprev_t, RowMajor{dhu, r}, Store{du, r}, h, r, m, stream);
  }
  if (err != cudaSuccess) return err;

  const DxEpilogue dx_epi{dx, dpre, xdvec, f, h};
  if (vx == nullptr) {
    // dx [M, F] = dPre Ux^T + fit(sum_g dPre_g xdvec_g);  dUx [F, 4h] = X^T dPre
    err = vmlmf::gemm(RowMajor{dpre, g4}, Transposed{ux, g4}, dx_epi, m, f, g4, stream);
    if (err != cudaSuccess) return err;
    err = vmlmf::gemm(Transposed{x, f}, RowMajor{dpre, g4}, Store{dux, g4}, f, g4, m, stream);
  } else {
    // dXU [M, rx] = dPre Vx^T;  dx [M, F] = dXU Ux^T + fit(sum_g dPre_g xdvec_g)
    err = vmlmf::gemm(RowMajor{dpre, g4}, Transposed{vx, g4}, Store{dxu, rx}, m, rx, g4,
                      stream);
    if (err != cudaSuccess) return err;
    err = vmlmf::gemm(RowMajor{dxu, rx}, Transposed{ux, rx}, dx_epi, m, f, rx, stream);
    if (err != cudaSuccess) return err;
    // dUx [F, rx] = X^T dXU;  dVx [rx, 4h] = XU^T dPre
    err = vmlmf::gemm(Transposed{x, f}, RowMajor{dxu, rx}, Store{dux, rx}, f, rx, m, stream);
    if (err != cudaSuccess) return err;
    err = vmlmf::gemm(Transposed{xu, rx}, RowMajor{dpre, g4}, Store{dvx, g4}, rx, g4, m,
                      stream);
  }
  if (err != cudaSuccess) return err;

  vmlmf::colsum_kernel<<<cdiv(g4, vmlmf::kSumCols), vmlmf::kSumCols * vmlmf::kSumLanes, 0,
                         stream>>>(dpre, h0, ys, RowMajor{x, f}, ddvec, dxdvec, dbias, m, batch,
                                   f, h);
  return cudaGetLastError();
}

// The message of an error code that lstm_scan_xin_bwd returned.
extern "C" const char* lstm_scan_xin_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
