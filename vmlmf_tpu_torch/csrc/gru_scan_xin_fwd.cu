// Fused GRU scan, f32, for sm_90a: the no-grad forward and the
// residual-writing forward of training, in x mode and in gi mode.
//
// Replaces vmlmf_tpu/ops/pallas_gru.py::_fwd_kernel in every variant that
// the JAX package runs: x mode (gru_scan_fused_xin) with a low-rank or a
// dense x side, the no-grad primal (residuals=False) and the autodiff
// forward with the saved-gates policy (residuals=True, save_gates=True);
// the recompute policy's forward (save_gates=False), which writes ys alone
// and so is the no-grad entry; and gi mode (gru_scan_fused: xin=False),
// whose input is gi itself, no-grad and with residuals (gi mode always
// saves the gates). For every batch row and step, in gate order (r, z, n):
//
//   gi[t,b] = (x[t,b] @ Ux) @ Vx + bias      low-rank x side
//           = x[t,b] @ Ux + bias             dense x side (Vx null)
//           given                            gi mode
//   r, z    = sigmoid(gi_rz + (h @ Uf) @ Prz)        low-rank "pre"
//           = sigmoid(gi_rz + h @ Prz)               dense "pre" and "post"
//   n       = tanh(gi_n + ((r*h) @ Uf) @ Pn)         low-rank "pre"
//           = tanh(gi_n + (r*h) @ Pn)                dense "pre"
//           = tanh(gi_n + r * (h @ Pn))              dense "post"
//   h       = z * h + (1 - z) * n;   ys[t,b] = h
//
// Layouts are the unpadded public ones of the JAX function: x [T,B,F],
// Ux [F,rx] and Vx [rx,3h] or dense Ux [F,3h], bias [3h], h0 [B,h];
// low-rank Uf [h,r], Prz [r,2h],
// Pn [r,h]; dense Prz [h,2h], Pn [h,h]; all row-major and contiguous. The
// `form` argument picks the recurrent form (0 low-rank pre, 1 dense pre,
// 2 dense post).
//
// The residual variant also writes, per step, the post-nonlinearity gates
// [T,B,3h] (r, z, n in three blocks of h), and hu = h_prev @ Uf and rhu =
// (r*h_prev) @ Uf [T,B,r] (low-rank) or recn = h_prev @ Pn [T,B,h] (post).
// A low-rank x side keeps the first GEMM's xu = x @ Ux [T*B,rx] as a
// residual for dVx; a dense one has none.
//
// What bounds it on an H100, and what the design does about it:
// * The input projection is time-parallel: two tiled GEMM launches over all
//   T*B rows (gemm_tile.cuh), or one for a dense x side, write gi [T,B,3h],
//   which the scan reads back. gi mode takes that gi from the caller and
//   launches the scan alone.
// * The recurrence is a chain of small dependent products. At the HAR widths
//   (h=64, r=9) a step is a few thousand multiply-adds per row, so the time
//   is set by the T steps and the block barriers inside each step (four in
//   low-rank "pre", two in dense "pre" and "post"), not by bytes or flops.
//   One CTA owns kRows batch rows and walks all T steps with the carry in
//   shared memory.
// * The recurrent weights stay in shared memory for the whole scan when
//   they fit (9.2 KB low-rank, 48 KB dense at h=64): the counterpart of the
//   TPU kernel's VMEM residency. Where they do not fit (dense past h of
//   about 130, low-rank past h*r of about 14k), the kernel reads them
//   through L2 with the same code, by generic pointers and, for Uf, strides.
//   Uf is kept transposed in shared memory so that the rank-space products,
//   one warp per rank column, read neighbouring words there.
// * Every edge (B, F, h, r, rx not multiples of a tile) is masked.

#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace {

using vmlmf::cdiv;

constexpr int kRows = 4;  // batch rows per scan CTA
constexpr int kMaxThreads = 1024;
constexpr int kLowrankPre = 0, kDensePre = 1, kDensePost = 2;

// Epilogue of the projection GEMM that yields gi: gi[i, j] = v + bias[j].
struct BiasEpilogue {
  float* gi;
  const float* bias;
  int n;
  __device__ __forceinline__ void operator()(int i, int j, float v) const {
    gi[(size_t)i * n + j] = v + bias[j];
  }
};

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// out[row, k] = sum_j in[row, j] * Uf[j, k] for k < r, with Uf's element
// (j, k) read at uf[k * ks + j * js]: its transposed copy in shared memory
// (ks = h, js = 1) or Uf [h, r] itself through L2 (ks = 1, js = r). One warp
// per rank column, lanes along j. Also written to out_res rows row_t.. when
// it is given.
__device__ __forceinline__ void rank_product(const float* in, const float* uf, int ks, int js,
                                             float* out, float* out_res, size_t row_t, int rows,
                                             int h, int r) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  for (int k = warp; k < r; k += nwarps) {
    const float* col = uf + (size_t)k * ks;
    float acc[kRows] = {};
    for (int j = lane; j < h; j += 32) {
      const float w = col[(size_t)j * js];
#pragma unroll
      for (int row = 0; row < kRows; ++row) acc[row] = fmaf(in[row * h + j], w, acc[row]);
    }
#pragma unroll
    for (int row = 0; row < kRows; ++row) {
      const float s = warp_sum(acc[row]);
      if (lane == 0) {
        out[row * r + k] = s;
        if (out_res != nullptr && row < rows) out_res[(row_t + row) * r + k] = s;
      }
    }
  }
}

// Shared-memory floats of the scan's state, and of its resident weights.
__host__ __device__ inline size_t state_floats(int h, int r) {
  return (size_t)kRows * (4 * h + 2 * r);
}
__host__ __device__ inline size_t weight_floats(int form, int h, int r) {
  return form == kLowrankPre ? (size_t)4 * h * r : (size_t)3 * h * h;
}

// One CTA per kRows batch rows; the CTA walks all t_len steps. Shared memory:
// hs (the carry), rb (r*h in "pre", r in "post"), zs, recns [kRows, h]; hus,
// rhus [kRows, r]; then, when `resident`, the weights: Uf^T [r, h], Prz, Pn.
// Rows past the batch stay zero and are never written out.
template <int Form, bool Residuals>
__global__ void __launch_bounds__(kMaxThreads)
scan_kernel(const float* __restrict__ gi, const float* __restrict__ uf_g,
            const float* __restrict__ prz_g, const float* __restrict__ pn_g,
            const float* __restrict__ h0, float* __restrict__ ys, float* __restrict__ gates_out,
            float* __restrict__ hu_out, float* __restrict__ rhu_out,
            float* __restrict__ recn_out, int t_len, int batch, int h, int r, bool resident) {
  constexpr bool kLowrank = Form == kLowrankPre;
  extern __shared__ float smem[];
  float* hs = smem;
  float* rb = hs + kRows * h;
  float* zs = rb + kRows * h;
  float* recns = zs + kRows * h;
  float* hus = recns + kRows * h;
  float* rhus = hus + kRows * r;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, batch - b0);
  const int g3 = 3 * h;
  const int depth = kLowrank ? r : h;  // rows of Prz and Pn

  // The weights, in shared memory or straight from device memory (L2); Uf's
  // element (j, k) is uf[k * uks + j * ujs] either way.
  const float* uf = uf_g;
  int uks = 1, ujs = r;
  const float* prz = prz_g;
  const float* pn = pn_g;
  if (resident) {
    float* w = rhus + kRows * r;
    float* przs = w + (kLowrank ? (size_t)r * h : 0);
    float* pns = przs + (size_t)depth * 2 * h;
    if (kLowrank)
      for (int i = threadIdx.x; i < h * r; i += blockDim.x) w[(i % r) * h + i / r] = uf_g[i];
    for (int i = threadIdx.x; i < depth * 2 * h; i += blockDim.x) przs[i] = prz_g[i];
    for (int i = threadIdx.x; i < depth * h; i += blockDim.x) pns[i] = pn_g[i];
    uf = w;  // Uf^T [r, h]
    uks = h;
    ujs = 1;
    prz = przs;
    pn = pns;
  }
  for (int i = threadIdx.x; i < kRows * h; i += blockDim.x)
    hs[i] = i / h < rows ? h0[(size_t)b0 * h + i] : 0.f;
  __syncthreads();

  for (int t = 0; t < t_len; ++t) {
    const size_t row_t = (size_t)t * batch + b0;  // first output row of this step
    const float* gi_t = gi + row_t * g3;

    if (kLowrank) {  // hus = h @ Uf
      rank_product(hs, uf, uks, ujs, hus, Residuals ? hu_out : nullptr, row_t, rows, h, r);
      __syncthreads();
    }

    // Gates r and z (columns c < 2h) and, in "post", recn = h @ Pn (columns
    // 2h..3h): one thread per column, the weights read along their rows.
    const float* src = kLowrank ? hus : hs;
    const int ncols = Form == kDensePost ? g3 : 2 * h;
    for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
      const float* wc = c < 2 * h ? prz + c : pn + (c - 2 * h);
      const int ldw = c < 2 * h ? 2 * h : h;
      float acc[kRows] = {};
      for (int k = 0; k < depth; ++k) {
        const float w = wc[(size_t)k * ldw];
#pragma unroll
        for (int row = 0; row < kRows; ++row) acc[row] = fmaf(src[row * depth + k], w, acc[row]);
      }
#pragma unroll
      for (int row = 0; row < kRows; ++row) {
        const bool live = row < rows;
        if (c >= 2 * h) {  // "post": the candidate's recurrent term
          recns[row * h + c - 2 * h] = acc[row];
          if (Residuals && live) recn_out[(row_t + row) * h + c - 2 * h] = acc[row];
          continue;
        }
        const float gate = sigmoid((live ? gi_t[(size_t)row * g3 + c] : 0.f) + acc[row]);
        if (c < h)
          rb[row * h + c] = Form == kDensePost ? gate : gate * hs[row * h + c];
        else
          zs[row * h + c - h] = gate;
        if (Residuals && live) gates_out[(row_t + row) * g3 + c] = gate;
      }
    }
    __syncthreads();

    if (kLowrank) {  // rhus = (r*h) @ Uf
      rank_product(rb, uf, uks, ujs, rhus, Residuals ? rhu_out : nullptr, row_t, rows, h, r);
      __syncthreads();
    }

    // The candidate n and the update, for hidden unit j: each (row, j) of
    // the carry is read and written by its own thread only.
    float* ys_t = ys + row_t * h;
    for (int j = threadIdx.x; j < h; j += blockDim.x) {
      float acc[kRows] = {};
      if (Form != kDensePost) {  // rhu @ Pn or (r*h) @ Pn
        const float* nsrc = kLowrank ? rhus : rb;
        for (int k = 0; k < depth; ++k) {
          const float w = pn[(size_t)k * h + j];
#pragma unroll
          for (int row = 0; row < kRows; ++row) acc[row] = fmaf(nsrc[row * depth + k], w, acc[row]);
        }
      }
#pragma unroll
      for (int row = 0; row < kRows; ++row) {
        if (row < rows) {
          const float rec = Form == kDensePost ? rb[row * h + j] * recns[row * h + j] : acc[row];
          const float n = tanhf(gi_t[(size_t)row * g3 + 2 * h + j] + rec);
          const float z = zs[row * h + j];
          const float hn = z * hs[row * h + j] + (1.f - z) * n;
          hs[row * h + j] = hn;
          ys_t[(size_t)row * h + j] = hn;
          if (Residuals) gates_out[(row_t + row) * g3 + 2 * h + j] = n;
        }
      }
    }
    __syncthreads();
  }
}

// Launches scan_kernel<Form, Residuals>, its weights in shared memory when
// they fit in what a block may opt into; returns the launch's error.
template <int Form, bool Residuals>
cudaError_t scan(const float* gi, const float* uf, const float* prz, const float* pn,
                 const float* h0, float* ys, float* gates, float* hu, float* rhu, float* recn,
                 int t_len, int batch, int h, int r, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  size_t smem = sizeof(float) * state_floats(h, r);
  const size_t with_weights = smem + sizeof(float) * weight_floats(Form, h, r);
  const bool resident = with_weights <= (size_t)optin;
  if (resident) smem = with_weights;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(scan_kernel<Form, Residuals>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // enough threads for the widest phase: 2h or 3h columns, or a warp per
  // rank column (at most 32 warps)
  const int cols = Form == kDensePost ? 3 * h : 2 * h;
  const int warps = Form == kLowrankPre ? (r < 32 ? r : 32) : 1;
  const int want = cdiv(cols > 32 * warps ? cols : 32 * warps, 32) * 32;
  const int threads = want < kMaxThreads ? want : kMaxThreads;
  scan_kernel<Form, Residuals><<<cdiv(batch, kRows), threads, smem, stream>>>(
      gi, uf, prz, pn, h0, ys, gates, hu, rhu, recn, t_len, batch, h, r, resident);
  return cudaGetLastError();
}

// The scan of the given form on gi [T*B, 3h].
template <bool Residuals>
int scan_form(const float* gi, const float* uf, const float* prz, const float* pn,
              const float* h0, float* ys, float* gates, float* hu, float* rhu, float* recn,
              int t_len, int batch, int h, int r, int form, cudaStream_t stream) {
  switch (form) {
    case kLowrankPre:
      return scan<kLowrankPre, Residuals>(gi, uf, prz, pn, h0, ys, gates, hu, rhu, recn, t_len,
                                          batch, h, r, stream);
    case kDensePre:
      return scan<kDensePre, Residuals>(gi, uf, prz, pn, h0, ys, gates, hu, rhu, recn, t_len,
                                        batch, h, r, stream);
    case kDensePost:
      return scan<kDensePost, Residuals>(gi, uf, prz, pn, h0, ys, gates, hu, rhu, recn, t_len,
                                         batch, h, r, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The projection GEMMs (two, or one for a dense x side), then the scan of
// the given form.
template <bool Residuals>
int launch(const float* x, const float* ux, const float* vx, const float* bias,
           const float* uf, const float* prz, const float* pn, const float* h0, float* xu,
           float* gi, float* ys, float* gates, float* hu, float* rhu, float* recn, int t_len,
           int batch, int f, int rx, int h, int r, int form, cudaStream_t stream) {
  const int m = t_len * batch;
  const int g3 = 3 * h;
  const BiasEpilogue epi{gi, bias, g3};
  cudaError_t err;
  if (vx == nullptr) {  // dense x side: gi = x @ Ux + bias
    err = vmlmf::gemm(vmlmf::RowMajor{x, f}, vmlmf::RowMajor{ux, g3}, epi, m, g3, f, stream);
  } else {
    err = vmlmf::gemm(vmlmf::RowMajor{x, f}, vmlmf::RowMajor{ux, rx}, vmlmf::Store{xu, rx}, m,
                      rx, f, stream);
    if (err != cudaSuccess) return err;
    err = vmlmf::gemm(vmlmf::RowMajor{xu, rx}, vmlmf::RowMajor{vx, g3}, epi, m, g3, rx, stream);
  }
  if (err != cudaSuccess) return err;
  return scan_form<Residuals>(gi, uf, prz, pn, h0, ys, gates, hu, rhu, recn, t_len, batch, h, r,
                              form, stream);
}

}  // namespace

// No-grad forward. xu [T*B, rx] and gi [T*B, 3h] are scratch that the
// caller allocates; writes ys [T,B,h]. uf is null and r is 0 in the dense
// recurrent forms; vx and xu are null and rx is 0 for a dense x side.
extern "C" int gru_scan_xin_fwd(const float* x, const float* ux, const float* vx,
                                const float* bias, const float* uf, const float* prz,
                                const float* pn, const float* h0, float* xu, float* gi,
                                float* ys, int t_len, int batch, int f, int rx, int h, int r,
                                int form, void* stream_handle) {
  return launch<false>(x, ux, vx, bias, uf, prz, pn, h0, xu, gi, ys, nullptr, nullptr, nullptr,
                       nullptr, t_len, batch, f, rx, h, r, form,
                       static_cast<cudaStream_t>(stream_handle));
}

// Residual forward of training. gi [T*B, 3h] is scratch; writes ys and the
// residuals xu [T*B, rx] (low-rank x side; else null), gates [T,B,3h], hu and rhu [T,B,r] (low-rank; else
// null) and recn [T,B,h] ("post"; else null).
extern "C" int gru_scan_xin_fwd_res(const float* x, const float* ux, const float* vx,
                                    const float* bias, const float* uf, const float* prz,
                                    const float* pn, const float* h0, float* xu, float* gi,
                                    float* ys, float* gates, float* hu, float* rhu, float* recn,
                                    int t_len, int batch, int f, int rx, int h, int r, int form,
                                    void* stream_handle) {
  return launch<true>(x, ux, vx, bias, uf, prz, pn, h0, xu, gi, ys, gates, hu, rhu, recn, t_len,
                      batch, f, rx, h, r, form, static_cast<cudaStream_t>(stream_handle));
}

// gi mode, no-grad forward: the scan alone on the caller's gi [T,B,3h];
// writes ys [T,B,h].
extern "C" int gru_scan_fwd(const float* gi, const float* uf, const float* prz,
                            const float* pn, const float* h0, float* ys, int t_len, int batch,
                            int h, int r, int form, void* stream_handle) {
  return scan_form<false>(gi, uf, prz, pn, h0, ys, nullptr, nullptr, nullptr, nullptr, t_len,
                          batch, h, r, form, static_cast<cudaStream_t>(stream_handle));
}

// gi mode, residual forward: also writes gates [T,B,3h] and hu, rhu
// [T,B,r] (low-rank; else null) or recn [T,B,h] ("post"; else null).
extern "C" int gru_scan_fwd_res(const float* gi, const float* uf, const float* prz,
                                const float* pn, const float* h0, float* ys, float* gates,
                                float* hu, float* rhu, float* recn, int t_len, int batch, int h,
                                int r, int form, void* stream_handle) {
  return scan_form<true>(gi, uf, prz, pn, h0, ys, gates, hu, rhu, recn, t_len, batch, h, r, form,
                         static_cast<cudaStream_t>(stream_handle));
}

// The message of an error code that an entry of this file returned.
extern "C" const char* gru_scan_xin_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
