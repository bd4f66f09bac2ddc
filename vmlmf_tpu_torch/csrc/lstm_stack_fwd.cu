// The wavefront LSTM stack, forward, for sm_90a: the no-grad forward and the
// residual-writing forward of training, with f32 or bf16 products.
//
// Replaces vmlmf_tpu/ops/pallas_pipeline.py::_mlfwd_kernel (residuals=False
// and residuals=True, bf16=False and bf16=True). For a stack of L layers, every batch row b and
// step t:
//
//   layer 0:   gi = gi0[t,b]                           (the caller's Cell.inp)
//   layer l>0: x = ys_{l-1}[t,b] * mask_l[t,b]  (mask_l null: no mask)
//              gi = x @ Ux_l @ Vx_l + tile4(x) * dxvec_l + bias_l
//   pre = gi + h @ U_l @ V_l + tile4(h) * dvec_l       (gates i,f,g,o)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
//
// ys_l[t,b] = h, and (hlast_l, clast_l) the state after the last step. The
// residual form also writes, per layer, cs [T,B,h], the gates after the
// nonlinearities [T,B,4h], hu = h_prev @ U [T,B,r] and, for l > 0, xu = x @
// Ux [T*B,rx]. The layers' ranks may differ. Layouts are the port's
// unpadded ones, all row-major and contiguous.
//
// The bf16 form rounds every product's operands to bf16 where the TPU
// kernel's _cast rounds them (x, xu, h and hu; the weights U, V, Ux, Vx)
// and sums in f32; the dvec and dxvec terms, the bias, gi0 and the gate
// arithmetic stay f32, and so do the residuals (xu and hu are the f32
// products, before any rounding). The entry makes bf16 copies of every
// layer's U and V once per call, which the serial steps read as 2-byte
// values through L2; h and hu are rounded by their writers. The projection
// GEMMs read x, Ux, xu and Vx through rounding views (gemm_tile.cuh).
//
// The schedule is the TPU kernel's block staircase: time is cut into blocks
// of `block` steps (the last one ragged when block does not divide T), and
// at wavefront step k = 0 .. nt+L-2 every live layer l runs its block k-l.
// What bounds it on an H100, and what the design does about it:
// * The recurrence is a serial chain per layer, read through L2 (3.9 MB of
//   U+V a step at LM width, far over one SM's 227 KB): one CTA per kRows
//   batch rows walks a block with the carry in shared memory, as the
//   single-layer scan does (lstm_steps.cuh). Run one layer after the other,
//   L layers take L*T such steps; in the staircase, layer l's CTAs run beside
//   layer l-1's on other SMs, so the chain is about T + (L-1)*block steps.
//   Whether two layers' CTAs share L2's rate without slowing each other is
//   what the card shows.
// * One launch per wavefront step, all live layers in it (grid.y = layer):
//   the kernel boundary is the barrier between steps that the TPU's
//   sequential grid gave. The carry goes to device memory (hlast, clast)
//   between blocks.
// * Handoff: the TPU kernel orders the layers within a grid step so that
//   layer l reads its VMEM buffer before layer l-1 overwrites it. Here the
//   layers run at once, so every layer keeps its ys in full in device memory
//   (the residual form needs it anyway): layer l reads block k-l of ys_{l-1},
//   written at step k-1, while layer l-1 writes block k-l+1.
// * Layer l > 0 projects its block before its recurrence, as tiled GEMM
//   launches over the block's rows (gemm_tile.cuh), spread over many CTAs:
//   xu = x @ Ux, then gi = xu @ Vx with the x term and bias in the epilogue,
//   x read through the masked view (the mask multiplies the handoff, not the
//   stored ys). gi is a block-sized buffer; so is xu in the no-grad form.
//   The projection sits on the serial chain between two wavefront steps. xu
//   has few output tiles (rx = 300 columns) and k = h, so it is split over
//   k (gemm_splitk) to spread over the SMs; gi has 4h columns and needs no
//   split.
// * Every edge (B, h, r, rx, a ragged last block) is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "gemm_tile.cuh"
#include "lstm_steps.cuh"

namespace {

using vmlmf::cdiv;
using vmlmf::kRows;

constexpr int kMaxLayers = 8;    // the depth of the layer table; MAX_LAYERS in cuda_stack.py
constexpr int kMaxThreads = 1024;
constexpr int kPtrs = 20;        // pointers per layer in the entry's table

// One layer's operands and outputs, in the order of the entry's pointer
// table (FWD_FIELDS in cuda_stack.py). Layer 0 has no x side and no mask,
// and its gi is gi0 [T*B, 4h]; a layer l > 0's gi is its block's
// projection [block*B, 4h]. The residual pointers are null in the no-grad
// form, where xu is block-sized scratch.
struct Layer {
  const float* u;      // [h, r]
  const float* v;      // [r, 4h]
  const float* dvec;   // [4h]
  const float* ux;     // [h, rx]
  const float* vx;     // [rx, 4h]
  const float* dxvec;  // [4h]
  const float* bias;   // [4h]
  const float* mask;   // [T, B, h] or null
  const float* h0;     // [B, h]
  const float* c0;
  float* ys;           // [T, B, h]
  float* hlast;        // [B, h]: the carry between blocks, then the final state
  float* clast;
  float* cs;           // [T, B, h]
  float* gates;        // [T, B, 4h]
  float* hu;           // [T, B, r]
  float* xu;           // [T*B, rx] (residual) or [block*B, rx]
  float* gi;
  __nv_bfloat16* u16;  // [h, r]: the bf16 copy of u (bf16 form; else null)
  __nv_bfloat16* v16;  // [r, 4h]
  int r, rx;
};

struct Stack {
  Layer layer[kMaxLayers];
};

// Epilogue of gi = xu @ Vx: adds the x term and the bias to column j,
// x(i, j % h) * dxvec[j] + bias[j], x read through the masked view.
struct GiEpilogue {
  float* gi;
  vmlmf::MaskedRows x;
  const float* dxvec;
  const float* bias;
  int h;
  __device__ __forceinline__ void operator()(int i, int j, float v) const {
    gi[(size_t)i * 4 * h + j] = v + x(i, j % h) * dxvec[j] + bias[j];
  }
};

// Wavefront step k: CTA (x, y) runs batch rows x*kRows .. of layer l_lo + y
// over its time block k - l. The carry comes from h0/c0 at the first block,
// else from hlast/clast, and goes back there. Shared memory: hs, cs [kRows,
// h], in the bf16 form hm [kRows, h] (h rounded, as the product reads it),
// and hus [kRows, rmax].
template <bool Residuals, bool Bf16>
__global__ void __launch_bounds__(kMaxThreads)
stack_step_kernel(Stack st, int l_lo, int k, int block, int t_len, int batch, int h) {
  extern __shared__ float smem[];
  const int l = l_lo + blockIdx.y;
  const Layer& ly = st.layer[l];
  const int t0 = (k - l) * block;
  const int t1 = min(t_len, t0 + block);
  float* hs = smem;
  float* cs = hs + kRows * h;
  float* hm = Bf16 ? cs + kRows * h : hs;
  float* hus = Bf16 ? hm + kRows * h : cs + kRows * h;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, batch - b0);
  const float* h_in = t0 == 0 ? ly.h0 : ly.hlast;
  const float* c_in = t0 == 0 ? ly.c0 : ly.clast;

  for (int i = threadIdx.x; i < kRows * h; i += blockDim.x) {
    const bool live = i / h < rows;
    hs[i] = live ? h_in[(size_t)b0 * h + i] : 0.f;
    cs[i] = live ? c_in[(size_t)b0 * h + i] : 0.f;
    if (Bf16) hm[i] = vmlmf::round_bf16(hs[i]);
  }
  __syncthreads();

  // the block's gi rows: gi0 from row t0*B (layer 0), or the block's projection
  const float* gi = ly.gi + (l == 0 ? (size_t)t0 * batch * 4 * h : 0);
  if constexpr (Bf16)
    vmlmf::lstm_fwd_steps<Residuals, true>(t0, t1, gi, ly.u16, ly.v16, ly.dvec, hs, cs, hus, hm,
                                           batch, b0, ly.ys, ly.cs, ly.gates, ly.hu, rows, h,
                                           ly.r);
  else
    vmlmf::lstm_fwd_steps<Residuals, false>(t0, t1, gi, ly.u, ly.v, ly.dvec, hs, cs, hus, hm,
                                            batch, b0, ly.ys, ly.cs, ly.gates, ly.hu, rows, h,
                                            ly.r);

  for (int i = threadIdx.x; i < rows * h; i += blockDim.x) {
    ly.hlast[(size_t)b0 * h + i] = hs[i];
    ly.clast[(size_t)b0 * h + i] = cs[i];
  }
}

// The staircase: per wavefront step, the projection GEMMs of the live layers
// l > 0, then one launch of all live layers' blocks; in the bf16 form the
// weight copies first. Returns the first error.
template <bool Residuals, bool Bf16>
cudaError_t staircase(const Stack& st, int n_layers, int t_len, int batch, int h, int block,
                      float* partial, size_t partial_floats, cudaStream_t stream) {
  int rmax = 0;
  for (int l = 0; l < n_layers; ++l) rmax = std::max(rmax, st.layer[l].r);
  const size_t smem = sizeof(float) * kRows * ((Bf16 ? 3 : 2) * h + rmax);
  cudaError_t err;
  if (Bf16) {
    for (int l = 0; l < n_layers; ++l) {
      const Layer& ly = st.layer[l];
      err = vmlmf::narrow(ly.u, ly.u16, (size_t)h * ly.r, stream);
      if (err != cudaSuccess) return err;
      err = vmlmf::narrow(ly.v, ly.v16, (size_t)ly.r * 4 * h, stream);
      if (err != cudaSuccess) return err;
    }
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(stack_step_kernel<Residuals, Bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = std::min(cdiv(std::max(h, rmax), 32) * 32, kMaxThreads);
  const int g4 = 4 * h;
  const int nt = cdiv(t_len, block);
  for (int k = 0; k < nt + n_layers - 1; ++k) {
    const int lo = std::max(0, k - nt + 1), hi = std::min(n_layers - 1, k);
    for (int l = std::max(lo, 1); l <= hi; ++l) {
      // block k - l of layer l's input: ys_{l-1}, written at step k - 1
      const Layer& ly = st.layer[l];
      const int t0 = (k - l) * block;
      const int m = (std::min(t_len, t0 + block) - t0) * batch;
      const size_t row0 = (size_t)t0 * batch;
      const vmlmf::MaskedRows x{st.layer[l - 1].ys + row0 * h,
                                ly.mask != nullptr ? ly.mask + row0 * h : nullptr, h};
      float* xu = ly.xu + (Residuals ? row0 * ly.rx : 0);
      using vmlmf::bf16_if;
      err = vmlmf::gemm_splitk(bf16_if<Bf16>(x), bf16_if<Bf16>(vmlmf::RowMajor{ly.ux, ly.rx}),
                               vmlmf::Store{xu, ly.rx}, m, ly.rx, h, partial, partial_floats,
                               stream);
      if (err != cudaSuccess) return err;
      err = vmlmf::gemm(bf16_if<Bf16>(vmlmf::RowMajor{xu, ly.rx}),
                        bf16_if<Bf16>(vmlmf::RowMajor{ly.vx, g4}),
                        GiEpilogue{ly.gi, x, ly.dxvec, ly.bias, h}, m, g4, ly.rx, stream);
      if (err != cudaSuccess) return err;
    }
    stack_step_kernel<Residuals, Bf16><<<dim3(cdiv(batch, kRows), hi - lo + 1), threads, smem,
                                   stream>>>(st, lo, k, block, t_len, batch, h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// The forward staircase on the current stream. ptrs holds kPtrs pointers per
// layer in Layer's order (null where a layer has none; u16 and v16, scratch
// for the bf16 copies, null in f32), ranks (r, rx) per layer; partial is
// scratch of partial_floats floats for the split-k partial sums of the
// projections; residuals 0 is the no-grad form; bf16_mm 1 the bf16 form.
// Returns the first error.
extern "C" int lstm_stack_fwd(void* const* ptrs, const int* ranks, float* partial,
                              int partial_floats, int n_layers, int t_len, int batch, int h,
                              int block, int residuals, int bf16_mm, void* stream_handle) {
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
    ly.bias = static_cast<const float*>(p[6]);
    ly.mask = static_cast<const float*>(p[7]);
    ly.h0 = static_cast<const float*>(p[8]);
    ly.c0 = static_cast<const float*>(p[9]);
    ly.ys = static_cast<float*>(p[10]);
    ly.hlast = static_cast<float*>(p[11]);
    ly.clast = static_cast<float*>(p[12]);
    ly.cs = static_cast<float*>(p[13]);
    ly.gates = static_cast<float*>(p[14]);
    ly.hu = static_cast<float*>(p[15]);
    ly.xu = static_cast<float*>(p[16]);
    ly.gi = static_cast<float*>(p[17]);
    ly.u16 = static_cast<__nv_bfloat16*>(p[18]);
    ly.v16 = static_cast<__nv_bfloat16*>(p[19]);
    if (bf16_mm && (ly.u16 == nullptr || ly.v16 == nullptr)) return cudaErrorInvalidValue;
    ly.r = ranks[2 * l];
    ly.rx = ranks[2 * l + 1];
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const size_t room = static_cast<size_t>(partial_floats);
  if (bf16_mm)
    return residuals
               ? staircase<true, true>(st, n_layers, t_len, batch, h, block, partial, room, stream)
               : staircase<false, true>(st, n_layers, t_len, batch, h, block, partial, room,
                                        stream);
  return residuals
             ? staircase<true, false>(st, n_layers, t_len, batch, h, block, partial, room, stream)
             : staircase<false, false>(st, n_layers, t_len, batch, h, block, partial, room,
                                       stream);
}

// The message of an error code that lstm_stack_fwd returned.
extern "C" const char* lstm_stack_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
