// Backward of the fused GRU scan (f32), for sm_90a: x mode with saved or
// recomputed gates, and gi mode.
//
// Replaces vmlmf_tpu/ops/pallas_gru.py::_bwd_kernel in every variant that
// the JAX package runs: the VJP of gru_scan_fused_xin (x mode, a low-rank or
// a dense x side (Vx null)) under the saved-gates policy and under the
// recompute policy (save_gates=False), and the VJP of gru_scan_fused (gi
// mode, which returns dgi and has no x side), in the three recurrent forms
// of the forward (gru_scan_xin_fwd.cu: 0 low-rank "pre", 1 dense "pre", 2
// dense "post"). From the forward's residuals and the cotangent dys [T,B,h]
// it walks t = T-1 .. 0 with the carry dh (zero at the start):
//
//   dh     += dys[t];   (r, z, n) = gates[t];   hp = h_prev
//   dz      = dh * (hp - n);   dn_pre = dh * (1 - z) * (1 - n^2);   dhp = dh * z
//   "post":      dr = dn_pre * recn[t];  dhp += (dn_pre * r) @ Pn^T
//   dense "pre": drh = dn_pre @ Pn^T
//   low-rank:    drhu = dn_pre @ Pn^T;   drh = drhu @ Uf^T
//   "pre":       dr = drh * hp;          dhp += drh * r
//   dr_pre = dr * r * (1 - r);   dz_pre = dz * z * (1 - z)
//   dense:       dhp += [dr_pre, dz_pre] @ Prz^T
//   low-rank:    dhu = [dr_pre, dz_pre] @ Prz^T;   dhp += dhu @ Uf^T
//   dh = dhp
//
// then dh0 = dh, and, over all M = T*B rows, with dPre = [dR, dZ, dN] the
// per-step (dr_pre, dz_pre, dn_pre), Hprev row (t, b) = h0[b] at t = 0 and
// ys[t-1, b] after, and RH = R * Hprev:
//
//   low-rank:     dUf = Hprev^T dHU + RH^T dRHU,  dPrz = HU^T [dR dZ],  dPn = RHU^T dN
//   dense "pre":  dPrz = Hprev^T [dR dZ],  dPn = RH^T dN
//   "post":       dPrz = Hprev^T [dR dZ],  dPn = Hprev^T (dN * R)
//   low-rank x side:  dXU = dPre Vx^T,  dx = dXU Ux^T,  dUx = X^T dXU,  dVx = XU^T dPre
//   dense x side:     dx = dPre Ux^T,  dUx = X^T dPre
//   dbias = sum_m dPre
//   gi mode:          dgi = dPre (no x side)
//
// The recompute policy stores only ys in the forward. Before the walk, a
// pre-pass rebuilds the residuals from x and Hprev, batched over all M rows
// in the order of pallas_gru.py:278-300, as tiled GEMMs whose epilogues
// apply the bias and the nonlinearities:
//
//   XU = X Ux  (low-rank x side);   G = XU Vx + bias  (or X Ux + bias)
//   low-rank: HU = Hprev Uf;  [R Z] = sigmoid(G_rz + HU Prz)
//             RHU = (R * Hprev) Uf;  N = tanh(G_n + RHU Pn)
//   dense "pre": [R Z] = sigmoid(G_rz + Hprev Prz);  N = tanh(G_n + (R * Hprev) Pn)
//   "post":      [R Z] = sigmoid(G_rz + Hprev Prz);  RECN = Hprev Pn;  N = tanh(G_n + R * RECN)
//
// with R * Hprev formed as the GEMM loads its operand. Each product needs
// the one before it (R before (R * Hprev) Uf, RHU before N), so these are
// up to six launches in a chain; then the walk and the GEMMs below run on
// the rebuilt residuals as they run on saved ones.
//
// What bounds it on an H100, and what the design does about it:
// * The TPU kernel sums the weight gradients in VMEM across a grid that
//   runs in order. Hopper runs CTAs in parallel, so the work is split:
//   1. bptt_kernel, the serial part. One CTA owns kRows batch rows and walks
//      all T steps with the dh carry and the step's dPre in shared memory,
//      with the recurrent weights resident there when they fit, as in the
//      forward (else read through L2). Each step is a chain of small
//      dependent products with a block barrier after each (five in low-rank
//      "pre", three in dense "pre", two in "post"): at h=64 the steps and
//      barriers, not bytes, set its time. The products that reduce over a
//      gate row go one warp per output, lanes along the row, so that
//      neighbouring lanes read neighbouring words. It writes dPre [M,3h],
//      and dHU, dRHU [M,r] in the low-rank form, for the passes below.
//   2. Time-parallel passes over all M rows: tiled GEMMs (gemm_tile.cuh)
//      with transposed operand views, and a column-sum kernel for dbias.
//      Hprev, R*Hprev and dN*R are read in place through operand views,
//      never built as copies. Every gradient is summed by one CTA per output
//      tile or column block in a fixed order: deterministic, no atomics. dUf's
//      two terms run as two GEMMs in turn on the stream, the second adding to
//      the first.
// * dx is skipped when the caller passes no dx buffer (a first layer's raw
//   input needs none). gi mode skips the whole x side and the column sums:
//   dPre is dgi.
// * Every edge is masked: B, T*B, F, h, r, rx need not be tile multiples.

#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace {

using vmlmf::cdiv;

constexpr int kRows = 4;  // batch rows per serial CTA
constexpr int kBpttThreads = 512;
constexpr int kSumCols = 32;   // columns per column-sum CTA
constexpr int kSumLanes = 8;   // row lanes per column-sum CTA
constexpr int kLowrankPre = 0, kDensePre = 1, kDensePost = 2;

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// h_prev of output row m = (t, b0 + row): h0 at t = 0, else ys[t - 1].
__device__ __forceinline__ float hprev(const float* h0, const float* ys, size_t m, int t,
                                       int batch, int b, int h, int j) {
  return t > 0 ? ys[(m - batch) * h + j] : h0[(size_t)b * h + j];
}

__host__ __device__ inline size_t state_floats(int h, int r) {
  return (size_t)kRows * (4 * h + 2 * r);
}
__host__ __device__ inline size_t weight_floats(int form, int h, int r) {
  return form == kLowrankPre ? (size_t)4 * h * r : (size_t)3 * h * h;
}

// Serial reverse walk. Shared memory: dhs [kRows,h] (the carry, then dh_prev
// of the step), dps [kRows,3h] (dr_pre, dz_pre, and dn_pre in "pre" or
// dn_pre*r in "post"), drhus, dhus [kRows,r]; then, when `resident`, Uf
// [h,r], Prz and Pn. Rows past the batch stay zero and are never written out.
template <int Form>
__global__ void __launch_bounds__(kBpttThreads)
bptt_kernel(const float* __restrict__ gates, const float* __restrict__ ys,
            const float* __restrict__ h0, const float* __restrict__ recn,
            const float* __restrict__ dys, const float* __restrict__ uf_g,
            const float* __restrict__ prz_g, const float* __restrict__ pn_g,
            float* __restrict__ dpre, float* __restrict__ dhu_out, float* __restrict__ drhu_out,
            float* __restrict__ dh0, int t_len, int batch, int h, int r, bool resident) {
  constexpr bool kLowrank = Form == kLowrankPre;
  extern __shared__ float smem[];
  const int g3 = 3 * h;
  float* dhs = smem;
  float* dps = dhs + kRows * h;
  float* drhus = dps + kRows * g3;
  float* dhus = drhus + kRows * r;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, batch - b0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const int depth = kLowrank ? r : h;

  const float* uf = uf_g;
  const float* prz = prz_g;
  const float* pn = pn_g;
  if (resident) {
    float* ufs = dhus + kRows * r;
    float* przs = ufs + (kLowrank ? (size_t)h * r : 0);
    float* pns = przs + (size_t)depth * 2 * h;
    if (kLowrank)
      for (int i = threadIdx.x; i < h * r; i += blockDim.x) ufs[i] = uf_g[i];
    for (int i = threadIdx.x; i < depth * 2 * h; i += blockDim.x) przs[i] = prz_g[i];
    for (int i = threadIdx.x; i < depth * h; i += blockDim.x) pns[i] = pn_g[i];
    uf = ufs;
    prz = przs;
    pn = pns;
  }
  for (int i = threadIdx.x; i < kRows * (4 * h + 2 * r); i += blockDim.x) smem[i] = 0.f;
  __syncthreads();

  for (int t = t_len - 1; t >= 0; --t) {
    const size_t row_t = (size_t)t * batch + b0;

    // Elementwise: dz_pre, dn_pre and dh*z; in "post" also dr_pre and
    // dn_pre*r. Each (row, j) of the carry is read and written by its own
    // thread only.
    for (int j = threadIdx.x; j < h; j += blockDim.x) {
      for (int row = 0; row < rows; ++row) {
        const size_t m = row_t + row;
        const float* gr = gates + m * g3;
        const float rg = gr[j], z = gr[h + j], n = gr[2 * h + j];
        const float hp = hprev(h0, ys, m, t, batch, b0 + row, h, j);
        const float dh = dhs[row * h + j] + dys[m * h + j];
        const float dz_pre = dh * (hp - n) * z * (1.f - z);
        const float dn_pre = dh * (1.f - z) * (1.f - n * n);
        float* ds = dps + row * g3;
        ds[h + j] = dz_pre;
        ds[2 * h + j] = Form == kDensePost ? dn_pre * rg : dn_pre;
        float* dg = dpre + m * g3;
        dg[h + j] = dz_pre;
        dg[2 * h + j] = dn_pre;
        if (Form == kDensePost) {
          const float dr_pre = dn_pre * recn[m * h + j] * rg * (1.f - rg);
          ds[j] = dr_pre;
          dg[j] = dr_pre;
        }
        dhs[row * h + j] = dh * z;
      }
    }
    __syncthreads();

    if (Form == kDensePost) {
      // dhp += [dr_pre, dz_pre, dn_pre*r] @ [Prz | Pn]^T: one warp per j
      for (int j = warp; j < h; j += nwarps) {
        float acc[kRows] = {};
        for (int c = lane; c < g3; c += 32) {
          const float w = c < 2 * h ? prz[(size_t)j * 2 * h + c] : pn[(size_t)j * h + c - 2 * h];
#pragma unroll
          for (int row = 0; row < kRows; ++row) acc[row] = fmaf(dps[row * g3 + c], w, acc[row]);
        }
#pragma unroll
        for (int row = 0; row < kRows; ++row) {
          const float s = warp_sum(acc[row]);
          if (lane == 0) dhs[row * h + j] += s;
        }
      }
      __syncthreads();
      continue;
    }

    if (kLowrank) {
      // drhu = dn_pre @ Pn^T: one warp per rank k, lanes along Pn's row k
      for (int k = warp; k < r; k += nwarps) {
        float acc[kRows] = {};
        for (int c = lane; c < h; c += 32) {
          const float w = pn[(size_t)k * h + c];
#pragma unroll
          for (int row = 0; row < kRows; ++row)
            acc[row] = fmaf(dps[row * g3 + 2 * h + c], w, acc[row]);
        }
#pragma unroll
        for (int row = 0; row < kRows; ++row) {
          const float s = warp_sum(acc[row]);
          if (lane == 0) {
            drhus[row * r + k] = s;
            if (row < rows) drhu_out[(row_t + row) * r + k] = s;
          }
        }
      }
      __syncthreads();
      // drh = drhu @ Uf^T, then dr_pre and dhp += drh * r: one thread per j
      for (int j = threadIdx.x; j < h; j += blockDim.x) {
        for (int row = 0; row < rows; ++row) {
          float drh = 0.f;
          for (int k = 0; k < r; ++k) drh = fmaf(drhus[row * r + k], uf[(size_t)j * r + k], drh);
          const size_t m = row_t + row;
          const float rg = gates[m * g3 + j];
          const float dr_pre = drh * hprev(h0, ys, m, t, batch, b0 + row, h, j) * rg * (1.f - rg);
          dps[row * g3 + j] = dr_pre;
          dpre[m * g3 + j] = dr_pre;
          dhs[row * h + j] += drh * rg;
        }
      }
    } else {
      // drh = dn_pre @ Pn^T, then dr_pre and dhp += drh * r: one warp per j
      for (int j = warp; j < h; j += nwarps) {
        float acc[kRows] = {};
        for (int c = lane; c < h; c += 32) {
          const float w = pn[(size_t)j * h + c];
#pragma unroll
          for (int row = 0; row < kRows; ++row)
            acc[row] = fmaf(dps[row * g3 + 2 * h + c], w, acc[row]);
        }
#pragma unroll
        for (int row = 0; row < kRows; ++row) {
          const float drh = warp_sum(acc[row]);
          if (lane == 0 && row < rows) {
            const size_t m = row_t + row;
            const float rg = gates[m * g3 + j];
            const float dr_pre =
                drh * hprev(h0, ys, m, t, batch, b0 + row, h, j) * rg * (1.f - rg);
            dps[row * g3 + j] = dr_pre;
            dpre[m * g3 + j] = dr_pre;
            dhs[row * h + j] += drh * rg;
          }
        }
      }
    }
    __syncthreads();

    if (kLowrank) {
      // dhu = [dr_pre, dz_pre] @ Prz^T: one warp per rank k
      for (int k = warp; k < r; k += nwarps) {
        float acc[kRows] = {};
        for (int c = lane; c < 2 * h; c += 32) {
          const float w = prz[(size_t)k * 2 * h + c];
#pragma unroll
          for (int row = 0; row < kRows; ++row) acc[row] = fmaf(dps[row * g3 + c], w, acc[row]);
        }
#pragma unroll
        for (int row = 0; row < kRows; ++row) {
          const float s = warp_sum(acc[row]);
          if (lane == 0) {
            dhus[row * r + k] = s;
            if (row < rows) dhu_out[(row_t + row) * r + k] = s;
          }
        }
      }
      __syncthreads();
      // dhp += dhu @ Uf^T: one thread per j
      for (int j = threadIdx.x; j < h; j += blockDim.x) {
        for (int row = 0; row < rows; ++row) {
          float s = 0.f;
          for (int k = 0; k < r; ++k) s = fmaf(dhus[row * r + k], uf[(size_t)j * r + k], s);
          dhs[row * h + j] += s;
        }
      }
    } else {
      // dhp += [dr_pre, dz_pre] @ Prz^T: one warp per j
      for (int j = warp; j < h; j += nwarps) {
        float acc[kRows] = {};
        for (int c = lane; c < 2 * h; c += 32) {
          const float w = prz[(size_t)j * 2 * h + c];
#pragma unroll
          for (int row = 0; row < kRows; ++row) acc[row] = fmaf(dps[row * g3 + c], w, acc[row]);
        }
#pragma unroll
        for (int row = 0; row < kRows; ++row) {
          const float s = warp_sum(acc[row]);
          if (lane == 0) dhs[row * h + j] += s;
        }
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < rows * h; i += blockDim.x) dh0[(size_t)b0 * h + i] = dhs[i];
}

// R * Hprev [M, h], element (i, j) = gates[i, j] * Hprev[i, j]: the operand
// of the recompute pre-pass's (R * Hprev) @ Uf or @ Pn, formed as it loads.
struct GatedPrev {
  const float* gates;
  const float* first;
  const float* rest;
  int nfirst;
  int ld;
  static constexpr bool kContigJ = true;
  __device__ __forceinline__ float operator()(int i, int j) const {
    const float hp = i < nfirst ? first[(size_t)i * ld + j] : rest[(size_t)(i - nfirst) * ld + j];
    return gates[(size_t)i * 3 * ld + j] * hp;
  }
};

// Epilogue of the pre-pass's gi GEMM: g[i, j] = v + bias[j], g [M, 3h].
struct BiasEpilogue {
  float* g;
  const float* bias;
  int n;
  __device__ __forceinline__ void operator()(int i, int j, float v) const {
    g[(size_t)i * n + j] = v + bias[j];
  }
};

// Epilogue of the r, z product (columns j < 2h), in place on the gi that the
// gi GEMM wrote into gates [M, 3h]: gates[i, j] = sigmoid(gi[i, j] + v).
struct RzEpilogue {
  float* gates;
  int h;
  __device__ __forceinline__ void operator()(int i, int j, float v) const {
    float* at = gates + (size_t)i * 3 * h + j;
    *at = sigmoid(*at + v);
  }
};

// Epilogue of the candidate's product in "pre" (column j < h), in place:
// gates[i, 2h + j] = tanh(gi_n[i, j] + v).
struct NEpilogue {
  float* gates;
  int h;
  __device__ __forceinline__ void operator()(int i, int j, float v) const {
    float* at = gates + (size_t)i * 3 * h + 2 * h + j;
    *at = tanhf(*at + v);
  }
};

// Epilogue of RECN = Hprev @ Pn in "post": stores recn and, in place,
// gates[i, 2h + j] = tanh(gi_n[i, j] + r[i, j] * v), r being final by then.
struct PostNEpilogue {
  float* gates;
  float* recn;
  int h;
  __device__ __forceinline__ void operator()(int i, int j, float v) const {
    recn[(size_t)i * h + j] = v;
    float* row = gates + (size_t)i * 3 * h;
    row[2 * h + j] = tanhf(row[2 * h + j] + row[j] * v);
  }
};

// The transpose of R * Hprev [M, h]: element (i, j) = gates[j, i] * Hprev[j, i],
// with R the first h columns of gates [M, 3h] and Hprev read as PrevRowsT does.
struct GatedPrevT {
  const float* gates;
  const float* first;
  const float* rest;
  int nfirst;
  int ld;
  static constexpr bool kContigJ = false;
  __device__ __forceinline__ float operator()(int i, int j) const {
    const float hp = j < nfirst ? first[(size_t)j * ld + i] : rest[(size_t)(j - nfirst) * ld + i];
    return gates[(size_t)j * 3 * ld + i] * hp;
  }
};

// Element (i, j) = a[i * ld + j] * b[i * ld + j]: the product of two row-major
// views with one stride (dN * R from dPre and gates).
struct RowProduct {
  const float* a;
  const float* b;
  int ld;
  static constexpr bool kContigJ = true;
  __device__ __forceinline__ float operator()(int i, int j) const {
    const size_t o = (size_t)i * ld + j;
    return a[o] * b[o];
  }
};

// Epilogue that adds the sum to what is there: c[i * ldc + j] += v.
struct AddTo {
  float* c;
  int ldc;
  __device__ __forceinline__ void operator()(int i, int j, float v) const {
    c[(size_t)i * ldc + j] += v;
  }
};

// dbias[n] = sum over the M rows of dpre [M, n_cols]: kSumLanes row lanes
// per column, then a fixed-order sum over the lanes.
__global__ void __launch_bounds__(kSumCols * kSumLanes)
colsum_kernel(const float* __restrict__ dpre, float* __restrict__ dbias, int m_rows,
              int n_cols) {
  __shared__ float part[kSumLanes][kSumCols];
  const int c = threadIdx.x % kSumCols, lane = threadIdx.x / kSumCols;
  const int n = blockIdx.x * kSumCols + c;
  float s = 0.f;
  if (n < n_cols)
    for (int m = lane; m < m_rows; m += kSumLanes) s += dpre[(size_t)m * n_cols + n];
  part[lane][c] = s;
  __syncthreads();
  if (lane == 0 && n < n_cols) {
    for (int l = 1; l < kSumLanes; ++l) s += part[l][c];
    dbias[n] = s;
  }
}

template <int Form>
cudaError_t bptt(const float* gates, const float* ys, const float* h0, const float* recn,
                 const float* dys, const float* uf, const float* prz, const float* pn,
                 float* dpre, float* dhu, float* drhu, float* dh0, int t_len, int batch, int h,
                 int r, cudaStream_t stream) {
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
    err = cudaFuncSetAttribute(bptt_kernel<Form>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  bptt_kernel<Form><<<cdiv(batch, kRows), kBpttThreads, smem, stream>>>(
      gates, ys, h0, recn, dys, uf, prz, pn, dpre, dhu, drhu, dh0, t_len, batch, h, r, resident);
  return cudaGetLastError();
}

// The serial walk and the recurrent side's weight gradients, from the
// residuals (saved or rebuilt); writes dpre [M, 3h] and, low-rank, dhu and
// drhu [M, r] (scratch), and duf, dprz, dpn, dh0. Returns the first error.
cudaError_t recurrent_grads(const float* uf, const float* prz, const float* pn,
                            const float* h0, const float* ys, const float* gates,
                            const float* hu, const float* rhu, const float* recn,
                            const float* dys, float* dpre, float* dhu, float* drhu, float* duf,
                            float* dprz, float* dpn, float* dh0, int t_len, int batch, int h,
                            int r, int form, cudaStream_t stream) {
  const int m = t_len * batch;
  const int g3 = 3 * h;
  using vmlmf::RowMajor;
  using vmlmf::Store;
  using vmlmf::Transposed;
  cudaError_t err;
  switch (form) {
    case kLowrankPre:
      err = bptt<kLowrankPre>(gates, ys, h0, recn, dys, uf, prz, pn, dpre, dhu, drhu, dh0, t_len,
                              batch, h, r, stream);
      break;
    case kDensePre:
      err = bptt<kDensePre>(gates, ys, h0, recn, dys, uf, prz, pn, dpre, dhu, drhu, dh0, t_len,
                            batch, h, r, stream);
      break;
    case kDensePost:
      err = bptt<kDensePost>(gates, ys, h0, recn, dys, uf, prz, pn, dpre, dhu, drhu, dh0, t_len,
                             batch, h, r, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  const vmlmf::PrevRowsT hprev_t{h0, ys, batch, h};
  if (form == kLowrankPre) {
    // dPrz [r, 2h] = HU^T [dR dZ];  dPn [r, h] = RHU^T dN
    err = vmlmf::gemm(Transposed{hu, r}, RowMajor{dpre, g3}, Store{dprz, 2 * h}, r, 2 * h, m,
                      stream);
    if (err != cudaSuccess) return err;
    err = vmlmf::gemm(Transposed{rhu, r}, RowMajor{dpre + 2 * h, g3}, Store{dpn, h}, r, h, m,
                      stream);
    if (err != cudaSuccess) return err;
    // dUf [h, r] = Hprev^T dHU, then += (R * Hprev)^T dRHU
    err = vmlmf::gemm(hprev_t, RowMajor{dhu, r}, Store{duf, r}, h, r, m, stream);
    if (err != cudaSuccess) return err;
    return vmlmf::gemm(GatedPrevT{gates, h0, ys, batch, h}, RowMajor{drhu, r}, AddTo{duf, r}, h,
                       r, m, stream);
  }
  // dPrz [h, 2h] = Hprev^T [dR dZ]
  err = vmlmf::gemm(hprev_t, RowMajor{dpre, g3}, Store{dprz, 2 * h}, h, 2 * h, m, stream);
  if (err != cudaSuccess) return err;
  if (form == kDensePre)  // dPn [h, h] = (R * Hprev)^T dN
    return vmlmf::gemm(GatedPrevT{gates, h0, ys, batch, h}, RowMajor{dpre + 2 * h, g3},
                       Store{dpn, h}, h, h, m, stream);
  // dPn [h, h] = Hprev^T (dN * R)
  return vmlmf::gemm(hprev_t, RowProduct{dpre + 2 * h, gates, g3}, Store{dpn, h}, h, h, m,
                     stream);
}

// The recompute policy's pre-pass: rebuilds gates [M, 3h], hu and rhu [M, r]
// (low-rank), recn [M, h] ("post") and xu [M, rx] (low-rank x side) from x
// and Hprev, as the header sets out. Returns the first error.
cudaError_t recompute(const float* x, const float* ux, const float* vx, const float* bias,
                      const float* uf, const float* prz, const float* pn, const float* h0,
                      const float* ys, float* gates, float* hu, float* rhu, float* recn,
                      float* xu, int t_len, int batch, int f, int rx, int h, int r, int form,
                      cudaStream_t stream) {
  const int m = t_len * batch;
  const int g3 = 3 * h;
  using vmlmf::RowMajor;
  using vmlmf::Store;
  const BiasEpilogue gi_epi{gates, bias, g3};
  cudaError_t err;
  if (vx == nullptr) {  // G = X Ux + bias
    err = vmlmf::gemm(RowMajor{x, f}, RowMajor{ux, g3}, gi_epi, m, g3, f, stream);
  } else {  // XU = X Ux;  G = XU Vx + bias
    err = vmlmf::gemm(RowMajor{x, f}, RowMajor{ux, rx}, Store{xu, rx}, m, rx, f, stream);
    if (err != cudaSuccess) return err;
    err = vmlmf::gemm(RowMajor{xu, rx}, RowMajor{vx, g3}, gi_epi, m, g3, rx, stream);
  }
  if (err != cudaSuccess) return err;

  const vmlmf::PrevRows hprev{h0, ys, batch, h};
  const GatedPrev rh{gates, h0, ys, batch, h};
  if (form == kLowrankPre) {
    // HU = Hprev Uf;  [R Z] = sigmoid(G_rz + HU Prz)
    err = vmlmf::gemm(hprev, RowMajor{uf, r}, Store{hu, r}, m, r, h, stream);
    if (err != cudaSuccess) return err;
    err = vmlmf::gemm(RowMajor{hu, r}, RowMajor{prz, 2 * h}, RzEpilogue{gates, h}, m, 2 * h, r,
                      stream);
    if (err != cudaSuccess) return err;
    // RHU = (R * Hprev) Uf;  N = tanh(G_n + RHU Pn)
    err = vmlmf::gemm(rh, RowMajor{uf, r}, Store{rhu, r}, m, r, h, stream);
    if (err != cudaSuccess) return err;
    return vmlmf::gemm(RowMajor{rhu, r}, RowMajor{pn, h}, NEpilogue{gates, h}, m, h, r, stream);
  }
  // [R Z] = sigmoid(G_rz + Hprev Prz)
  err = vmlmf::gemm(hprev, RowMajor{prz, 2 * h}, RzEpilogue{gates, h}, m, 2 * h, h, stream);
  if (err != cudaSuccess) return err;
  if (form == kDensePre)  // N = tanh(G_n + (R * Hprev) Pn)
    return vmlmf::gemm(rh, RowMajor{pn, h}, NEpilogue{gates, h}, m, h, h, stream);
  // RECN = Hprev Pn;  N = tanh(G_n + R * RECN)
  return vmlmf::gemm(hprev, RowMajor{pn, h}, PostNEpilogue{gates, recn, h}, m, h, h, stream);
}

}  // namespace

// x mode: launches the pre-pass (recompute policy), the serial kernel, the
// GEMMs and the column sums on `stream`; returns the first error. gates,
// hu, rhu, recn and xu are the residual forward's (uf, hu, rhu, duf null
// in the dense recurrent forms, recn outside "post"; vx, xu, dvx for a
// dense x side). gates null is the recompute policy: bias is then given,
// hu, rhu, recn and xu are null, and gates_w [T*B, 3h], hu_w and rhu_w
// [T*B, r] (low-rank), recn_w [T*B, h] ("post") and xu_w [T*B, rx]
// (low-rank x side) are the scratch that the pre-pass fills; they are null
// otherwise. dpre [T*B, 3h], dhu and drhu [T*B, r] (low-rank; else null)
// and dxu [T*B, rx] (low-rank x side; else null) are scratch that the
// caller allocates; every pointer after them is an output. dx may be null
// (not computed).
extern "C" int gru_scan_xin_bwd(
    const float* x, const float* ux, const float* vx, const float* uf, const float* prz,
    const float* pn, const float* h0, const float* ys, const float* gates, const float* hu,
    const float* rhu, const float* recn, const float* xu, const float* dys, const float* bias,
    float* gates_w, float* hu_w, float* rhu_w, float* recn_w, float* xu_w, float* dpre,
    float* dhu, float* drhu, float* dxu, float* dx, float* dux, float* dvx, float* dbias,
    float* duf, float* dprz, float* dpn, float* dh0, int t_len, int batch, int f, int rx, int h,
    int r, int form, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int m = t_len * batch;
  const int g3 = 3 * h;
  using vmlmf::RowMajor;
  using vmlmf::Store;
  using vmlmf::Transposed;
  cudaError_t err;

  if (gates == nullptr) {  // the recompute policy
    if (bias == nullptr || gates_w == nullptr) return cudaErrorInvalidValue;
    err = recompute(x, ux, vx, bias, uf, prz, pn, h0, ys, gates_w, hu_w, rhu_w, recn_w, xu_w,
                    t_len, batch, f, rx, h, r, form, stream);
    if (err != cudaSuccess) return err;
    gates = gates_w;
    hu = hu_w;
    rhu = rhu_w;
    recn = recn_w;
    xu = xu_w;
  }
  err = recurrent_grads(uf, prz, pn, h0, ys, gates, hu, rhu, recn, dys, dpre, dhu, drhu, duf,
                        dprz, dpn, dh0, t_len, batch, h, r, form, stream);
  if (err != cudaSuccess) return err;

  if (vx == nullptr) {
    // dense x side, dXU = dPre: dx [M, F] = dPre Ux^T;  dUx [F, 3h] = X^T dPre
    if (dx != nullptr) {
      err = vmlmf::gemm(RowMajor{dpre, g3}, Transposed{ux, g3}, Store{dx, f}, m, f, g3, stream);
      if (err != cudaSuccess) return err;
    }
    err = vmlmf::gemm(Transposed{x, f}, RowMajor{dpre, g3}, Store{dux, g3}, f, g3, m, stream);
  } else {
    // dXU [M, rx] = dPre Vx^T;  dx [M, F] = dXU Ux^T
    err = vmlmf::gemm(RowMajor{dpre, g3}, Transposed{vx, g3}, Store{dxu, rx}, m, rx, g3,
                      stream);
    if (err != cudaSuccess) return err;
    if (dx != nullptr) {
      err = vmlmf::gemm(RowMajor{dxu, rx}, Transposed{ux, rx}, Store{dx, f}, m, f, rx, stream);
      if (err != cudaSuccess) return err;
    }
    // dUx [F, rx] = X^T dXU;  dVx [rx, 3h] = XU^T dPre
    err = vmlmf::gemm(Transposed{x, f}, RowMajor{dxu, rx}, Store{dux, rx}, f, rx, m, stream);
    if (err != cudaSuccess) return err;
    err = vmlmf::gemm(Transposed{xu, rx}, RowMajor{dpre, g3}, Store{dvx, g3}, rx, g3, m,
                      stream);
  }
  if (err != cudaSuccess) return err;

  colsum_kernel<<<cdiv(g3, kSumCols), kSumCols * kSumLanes, 0, stream>>>(dpre, dbias, m, g3);
  return cudaGetLastError();
}

// gi mode: the serial kernel and the recurrent GEMMs on `stream`; returns the
// first error. The residuals as gru_scan_xin_bwd takes them (saved: gi mode
// always saves the gates); dgi [T*B, 3h] is dPre, an output; dhu and drhu
// [T*B, r] (low-rank; else null) are scratch; duf (low-rank; else null),
// dprz, dpn and dh0 are outputs.
extern "C" int gru_scan_bwd(const float* uf, const float* prz, const float* pn,
                            const float* h0, const float* ys, const float* gates,
                            const float* hu, const float* rhu, const float* recn,
                            const float* dys, float* dgi, float* dhu, float* drhu, float* duf,
                            float* dprz, float* dpn, float* dh0, int t_len, int batch, int h,
                            int r, int form, void* stream_handle) {
  return recurrent_grads(uf, prz, pn, h0, ys, gates, hu, rhu, recn, dys, dgi, dhu, drhu, duf,
                         dprz, dpn, dh0, t_len, batch, h, r, form,
                         static_cast<cudaStream_t>(stream_handle));
}

// The message of an error code that an entry of this file returned.
extern "C" const char* gru_scan_xin_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
