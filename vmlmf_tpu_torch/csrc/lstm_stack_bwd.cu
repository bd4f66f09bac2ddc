// Backward of the wavefront LSTM stack, for sm_90a: the reverse staircase,
// with f32 or bf16 products.
//
// Replaces vmlmf_tpu/ops/pallas_pipeline.py::_mlbwd_kernel, bf16=False and
// bf16=True. From the
// residuals of the forward (lstm_stack_fwd.cu, residual form: every layer's
// ys, cs, gates, hu and, for l > 0, xu) and the cotangents dys [T,B,h] of the
// top layer's outputs and dhlast, dclast [B,h] per layer, any of which may
// be absent (zeros), it computes per layer, from the top:
//
//   the serial reverse walk (lstm_steps.cuh, lstm_bwd_step) with dy = dys
//   for the top layer and the dy that the layer above handed down otherwise:
//   dpre [T*B,4h], dhu = dpre @ V^T [T*B,r], and the carry (dh, dc), which
//   starts at (dhlast, dclast) and ends as (dh0, dc0);
//   for l > 0, with x = ys_{l-1} * mask_l:
//     dXU = dPre Vx^T;  dx = dXU Ux^T + sum_g dPre_g * dxvec_g
//     dy_{l-1} = dx * mask_l
//     dUx = X^T dXU,  dVx = XU^T dPre,  ddxvec = sum_m dPre * tile4(X),
//     dbias = sum_m dPre;
//   dU = Hprev^T dHU,  dV = HU^T dPre,  ddvec = sum_m dPre * tile4(Hprev),
//
// with sums over all M = T*B rows; Hprev row (t, b) is h0[b] at t = 0 and
// ys[t-1, b] after. Layer 0's dpre is dgi0, the cotangent of gi0; its x
// side goes back through the caller's autograd of Cell.inp.
//
// The bf16 form rounds the operands of every product to bf16 where the TPU
// kernel's _cast rounds them (dpre, dhu, h_prev, hu, dXU, x, xu; the
// weights) and sums in f32; the dvec and dxvec terms, the column sums and
// every gradient stay f32. The entry makes bf16 copies of every layer's U
// and V once per call for the serial walks, whose dpre and dhu are rounded
// by their writers; the GEMMs read through rounding views (gemm_tile.cuh).
//
// What bounds it on an H100, and what the design does about it:
// * The reverse staircase mirrors the forward: time blocks of `block`
//   steps, and at step j = 0 .. nt+L-2 every live layer l runs its reverse
//   block nt-1-j+(L-1-l), the top layer first. One launch per step runs all
//   live layers' serial walks (grid.y = layer), one CTA per kRows batch rows,
//   the carry in device memory (dh0, dc0) between blocks. Each step reads
//   V and U through L2, bound by one SM's L2 read rate, as the single-layer
//   BPTT is; the staircase lets layer l-1's walk run beside layer l's.
// * Handoff: the TPU kernel orders the layers within a grid step so that
//   layer l reads its buffer before layer l+1 overwrites it. Here each layer
//   below the top keeps its dy in full in device memory: after the walks of
//   step j, tiled GEMM launches per live layer l > 0 turn its block's dpre
//   into dXU and dy_{l-1} (the mask and the dxvec term in the epilogue),
//   which layer l-1 reads at step j+1. They sit on the serial chain; dXU has
//   few output tiles (rx = 300 columns) and k = 4h, so it is split over k
//   (gemm_splitk) to spread over the SMs.
// * The TPU kernel sums dU, dV, ... in VMEM across its sequential grid. CTAs
//   here run in no order, so once the staircase ends the weight gradients of
//   every layer run as tiled GEMMs over all M rows with transposed and
//   masked operand views (gemm_tile.cuh) and one column-sum kernel: one CTA
//   per output tile or column block, a fixed order, no atomics, so the
//   result is deterministic. dpre, dhu and dxu are kept [T*B, ...] for them.
// * Every edge (B, h, r, rx, a ragged last block in time, the first that
//   the reverse walk meets) is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "gemm_tile.cuh"
#include "lstm_steps.cuh"

namespace {

using vmlmf::cdiv;
using vmlmf::kRows;

constexpr int kMaxLayers = 8;    // the depth of the layer table; MAX_LAYERS in cuda_stack.py
constexpr int kBpttThreads = 1024;
constexpr int kPtrs = 31;        // pointers per layer in the entry's table

// One layer's residuals, scratch and gradients, in the order of the entry's
// pointer table (BWD_FIELDS in cuda_stack.py). Layer 0 has no x side, no
// mask and no dy buffer of a layer below; its dpre is dgi0. dhlast, dclast
// and the top layer's dy may be null.
struct Layer {
  const float* u;       // [h, r]
  const float* v;       // [r, 4h]
  const float* dvec;    // [4h]
  const float* ux;      // [h, rx]
  const float* vx;      // [rx, 4h]
  const float* dxvec;   // [4h]
  const float* mask;    // [T, B, h] or null
  const float* h0;      // [B, h]
  const float* c0;
  const float* ys;      // [T, B, h]
  const float* cs;
  const float* gates;   // [T, B, 4h]
  const float* hu;      // [T, B, r]
  const float* xu;      // [T, B, rx]
  float* dy;            // [T, B, h]: the cotangent of ys
  const float* dhlast;  // [B, h]
  const float* dclast;
  float* dpre;          // [T*B, 4h]
  float* dhu;           // [T*B, r]
  float* dxu;           // [T*B, rx]
  float* du;
  float* dv;
  float* ddvec;
  float* dux;
  float* dvx;
  float* ddxvec;
  float* dbias;
  float* dh0;           // [B, h]: the carry between blocks, then the gradient
  float* dc0;
  __nv_bfloat16* u16;   // [h, r]: the bf16 copy of u (bf16 form; else null)
  __nv_bfloat16* v16;   // [r, 4h]
  int r, rx;
};

struct Stack {
  Layer layer[kMaxLayers];
};

// Epilogue of dx = dXU @ Ux^T: adds sum_g dpre_g * dxvec_g to column j and
// stores dx * mask as the cotangent of the layer below.
struct DyEpilogue {
  float* dy;
  const float* dpre;
  const float* dxvec;
  const float* mask;
  int h;
  __device__ __forceinline__ void operator()(int i, int j, float v) const {
    const float* dp = dpre + (size_t)i * 4 * h + j;
    v += dp[0] * dxvec[j] + dp[h] * dxvec[h + j] + dp[2 * h] * dxvec[2 * h + j]
         + dp[3 * h] * dxvec[3 * h + j];
    const size_t e = (size_t)i * h + j;
    dy[e] = mask != nullptr ? v * mask[e] : v;
  }
};

// Reverse wavefront step j: CTA (x, y) walks batch rows x*kRows .. of layer
// l_lo + y over its reverse block. The carry comes from dhlast/dclast at the
// layer's first block (the last in time), else from dh0/dc0, and goes back
// there. Shared memory: dhs, dcs [kRows, h], dps [kRows, 4h], dhus [kRows, rmax].
template <bool Bf16>
__global__ void __launch_bounds__(kBpttThreads)
stack_bptt_kernel(Stack st, int l_lo, int j, int n_layers, int nt, int block, int t_len,
                  int batch, int h) {
  extern __shared__ float smem[];
  const int l = l_lo + blockIdx.y;
  const Layer& ly = st.layer[l];
  const int g4 = 4 * h;
  const int kb = nt - 1 - j + (n_layers - 1 - l);
  const int t0 = kb * block;
  const int t1 = min(t_len, t0 + block);
  float* dhs = smem;
  float* dcs = dhs + kRows * h;
  float* dps = dcs + kRows * h;
  float* dhus = dps + kRows * g4;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, batch - b0);
  const bool first = kb == nt - 1;
  const float* dh_in = first ? ly.dhlast : ly.dh0;
  const float* dc_in = first ? ly.dclast : ly.dc0;

  for (int i = threadIdx.x; i < kRows * h; i += blockDim.x) {
    const bool live = i / h < rows;
    dhs[i] = live && dh_in != nullptr ? dh_in[(size_t)b0 * h + i] : 0.f;
    dcs[i] = live && dc_in != nullptr ? dc_in[(size_t)b0 * h + i] : 0.f;
  }
  for (int i = threadIdx.x; i < kRows * (g4 + ly.r); i += blockDim.x) dps[i] = 0.f;
  __syncthreads();

  for (int t = t1 - 1; t >= t0; --t) {
    if constexpr (Bf16)
      vmlmf::lstm_bwd_step<true>(t, (size_t)t * batch + b0, batch, b0, ly.gates, ly.cs, ly.c0,
                                 ly.dy, ly.u16, ly.v16, ly.dvec, dhs, dcs, dps, dhus, ly.dpre,
                                 ly.dhu, rows, h, ly.r);
    else
      vmlmf::lstm_bwd_step<false>(t, (size_t)t * batch + b0, batch, b0, ly.gates, ly.cs, ly.c0,
                                  ly.dy, ly.u, ly.v, ly.dvec, dhs, dcs, dps, dhus, ly.dpre,
                                  ly.dhu, rows, h, ly.r);
  }

  for (int i = threadIdx.x; i < rows * h; i += blockDim.x) {
    ly.dh0[(size_t)b0 * h + i] = dhs[i];
    ly.dc0[(size_t)b0 * h + i] = dcs[i];
  }
}

// The weight gradients of one layer over all m rows, once the staircase has
// ended. Returns the first error.
template <bool Bf16>
cudaError_t weight_grads(const Stack& st, int l, int m, int batch, int h, cudaStream_t stream) {
  using vmlmf::bf16_if;
  using vmlmf::RowMajor;
  using vmlmf::Store;
  using vmlmf::Transposed;
  const Layer& ly = st.layer[l];
  const int g4 = 4 * h;
  // dV [r, 4h] = HU^T dPre;  dU [h, r] = Hprev^T dHU
  cudaError_t err = vmlmf::gemm(bf16_if<Bf16>(Transposed{ly.hu, ly.r}),
                                bf16_if<Bf16>(RowMajor{ly.dpre, g4}), Store{ly.dv, g4}, ly.r, g4,
                                m, stream);
  if (err != cudaSuccess) return err;
  err = vmlmf::gemm(bf16_if<Bf16>(vmlmf::PrevRowsT{ly.h0, ly.ys, batch, h}),
                    bf16_if<Bf16>(RowMajor{ly.dhu, ly.r}), Store{ly.du, ly.r}, h, ly.r, m, stream);
  if (err != cudaSuccess) return err;
  const float* x = l > 0 ? st.layer[l - 1].ys : nullptr;
  if (l > 0) {
    // dUx [h, rx] = X^T dXU;  dVx [rx, 4h] = XU^T dPre
    err = vmlmf::gemm(bf16_if<Bf16>(vmlmf::MaskedRowsT{x, ly.mask, h}),
                      bf16_if<Bf16>(RowMajor{ly.dxu, ly.rx}), Store{ly.dux, ly.rx}, h, ly.rx, m,
                      stream);
    if (err != cudaSuccess) return err;
    err = vmlmf::gemm(bf16_if<Bf16>(Transposed{ly.xu, ly.rx}), bf16_if<Bf16>(RowMajor{ly.dpre, g4}),
                      Store{ly.dvx, g4}, ly.rx, g4, m, stream);
    if (err != cudaSuccess) return err;
  }
  // ddvec, and for l > 0 ddxvec and dbias (null for layer 0)
  vmlmf::colsum_kernel<<<cdiv(g4, vmlmf::kSumCols), vmlmf::kSumCols * vmlmf::kSumLanes, 0,
                         stream>>>(ly.dpre, ly.h0, ly.ys, vmlmf::MaskedRows{x, ly.mask, h},
                                   ly.ddvec, ly.ddxvec, ly.dbias, m, batch, h, h);
  return cudaGetLastError();
}

// The reverse staircase, then the weight gradients; in the bf16 form the
// weight copies first. Returns the first error.
template <bool Bf16>
cudaError_t reverse_staircase(const Stack& st, int n_layers, int t_len, int batch, int h,
                              int block, float* partial, size_t partial_floats,
                              cudaStream_t stream) {
  int rmax = 0;
  for (int l = 0; l < n_layers; ++l) rmax = std::max(rmax, st.layer[l].r);
  const int g4 = 4 * h;
  const size_t smem = sizeof(float) * kRows * (2 * h + g4 + rmax);
  cudaError_t err;
  if (Bf16) {
    for (int l = 0; l < n_layers; ++l) {
      const Layer& ly = st.layer[l];
      err = vmlmf::narrow(ly.u, ly.u16, (size_t)h * ly.r, stream);
      if (err != cudaSuccess) return err;
      err = vmlmf::narrow(ly.v, ly.v16, (size_t)ly.r * g4, stream);
      if (err != cudaSuccess) return err;
    }
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(stack_bptt_kernel<Bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int nt = cdiv(t_len, block);
  for (int j = 0; j < nt + n_layers - 1; ++j) {
    // layer l is live while its reverse block nt-1-j+(L-1-l) is in [0, nt)
    const int lo = std::max(0, n_layers - 1 - j);
    const int hi = std::min(n_layers - 1, nt - 1 + n_layers - 1 - j);
    stack_bptt_kernel<Bf16><<<dim3(cdiv(batch, kRows), hi - lo + 1), kBpttThreads, smem, stream>>>(
        st, lo, j, n_layers, nt, block, t_len, batch, h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    for (int l = std::max(lo, 1); l <= hi; ++l) {
      // the block's dXU and the cotangent of the layer below, read at step j + 1
      const Layer& ly = st.layer[l];
      const int t0 = (nt - 1 - j + (n_layers - 1 - l)) * block;
      const int m = (std::min(t_len, t0 + block) - t0) * batch;
      const size_t row0 = (size_t)t0 * batch;
      const float* dpre = ly.dpre + row0 * g4;
      float* dxu = ly.dxu + row0 * ly.rx;
      using vmlmf::bf16_if;
      err = vmlmf::gemm_splitk(bf16_if<Bf16>(vmlmf::RowMajor{dpre, g4}),
                               bf16_if<Bf16>(vmlmf::Transposed{ly.vx, g4}),
                               vmlmf::Store{dxu, ly.rx}, m, ly.rx, g4, partial, partial_floats,
                               stream);
      if (err != cudaSuccess) return err;
      const DyEpilogue epi{st.layer[l - 1].dy + row0 * h, dpre, ly.dxvec,
                           ly.mask != nullptr ? ly.mask + row0 * h : nullptr, h};
      err = vmlmf::gemm(bf16_if<Bf16>(vmlmf::RowMajor{dxu, ly.rx}),
                        bf16_if<Bf16>(vmlmf::Transposed{ly.ux, ly.rx}), epi, m, h, ly.rx, stream);
      if (err != cudaSuccess) return err;
    }
  }
  for (int l = 0; l < n_layers; ++l) {
    err = weight_grads<Bf16>(st, l, t_len * batch, batch, h, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// The reverse staircase and the weight gradients on the current stream.
// ptrs holds kPtrs pointers per layer in Layer's order (null where a layer
// has none, and for absent cotangents; u16 and v16, scratch for the bf16
// copies, null in f32), ranks (r, rx) per layer; partial is scratch of
// partial_floats floats for the split-k partial sums of dXU; bf16_mm 1 the
// bf16 form. Returns the first error.
extern "C" int lstm_stack_bwd(void* const* ptrs, const int* ranks, float* partial,
                              int partial_floats, int n_layers, int t_len, int batch, int h,
                              int block, int bf16_mm, void* stream_handle) {
  if (n_layers < 1 || n_layers > kMaxLayers || block < 1) return cudaErrorInvalidValue;
  Stack st{};
  for (int l = 0; l < n_layers; ++l) {
    void* const* p = ptrs + l * kPtrs;
    Layer& ly = st.layer[l];
    ly.u = static_cast<const float*>(p[0]);
    ly.v = static_cast<const float*>(p[1]);
    ly.dvec = static_cast<const float*>(p[2]);
    ly.ux = static_cast<const float*>(p[3]);
    ly.vx = static_cast<const float*>(p[4]);
    ly.dxvec = static_cast<const float*>(p[5]);
    ly.mask = static_cast<const float*>(p[6]);
    ly.h0 = static_cast<const float*>(p[7]);
    ly.c0 = static_cast<const float*>(p[8]);
    ly.ys = static_cast<const float*>(p[9]);
    ly.cs = static_cast<const float*>(p[10]);
    ly.gates = static_cast<const float*>(p[11]);
    ly.hu = static_cast<const float*>(p[12]);
    ly.xu = static_cast<const float*>(p[13]);
    ly.dy = static_cast<float*>(p[14]);
    ly.dhlast = static_cast<const float*>(p[15]);
    ly.dclast = static_cast<const float*>(p[16]);
    ly.dpre = static_cast<float*>(p[17]);
    ly.dhu = static_cast<float*>(p[18]);
    ly.dxu = static_cast<float*>(p[19]);
    ly.du = static_cast<float*>(p[20]);
    ly.dv = static_cast<float*>(p[21]);
    ly.ddvec = static_cast<float*>(p[22]);
    ly.dux = static_cast<float*>(p[23]);
    ly.dvx = static_cast<float*>(p[24]);
    ly.ddxvec = static_cast<float*>(p[25]);
    ly.dbias = static_cast<float*>(p[26]);
    ly.dh0 = static_cast<float*>(p[27]);
    ly.dc0 = static_cast<float*>(p[28]);
    ly.u16 = static_cast<__nv_bfloat16*>(p[29]);
    ly.v16 = static_cast<__nv_bfloat16*>(p[30]);
    if (bf16_mm && (ly.u16 == nullptr || ly.v16 == nullptr)) return cudaErrorInvalidValue;
    ly.r = ranks[2 * l];
    ly.rx = ranks[2 * l + 1];
  }
  const size_t room = static_cast<size_t>(partial_floats);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  return bf16_mm ? reverse_staircase<true>(st, n_layers, t_len, batch, h, block, partial, room,
                                           stream)
                 : reverse_staircase<false>(st, n_layers, t_len, batch, h, block, partial, room,
                                            stream);
}

// The message of an error code that lstm_stack_bwd returned.
extern "C" const char* lstm_stack_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
