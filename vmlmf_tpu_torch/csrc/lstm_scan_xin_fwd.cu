// Fused LSTM scan, x mode, no-grad forward, f32, for sm_90a.
//
// Replaces vmlmf_tpu/ops/pallas_scan.py::_fwd_kernel in the variant that
// lstm_scan_fused_xin's no-grad primal runs (x mode, low-rank on both
// sides, f32, residuals=False). For every batch row b and step t:
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
// * Every edge (B, F, h, r, rx not multiples of a tile) is masked here.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;        // GEMM output tile, rows and columns
constexpr int kDepth = 16;       // GEMM k-slice staged in shared memory
constexpr int kGemmThreads = 256;
constexpr int kRows = 4;         // batch rows per scan CTA
constexpr int kMaxThreads = 1024;

int cdiv(int a, int b) { return (a + b - 1) / b; }

// c[m,n] = a[m,k] @ b[k,n]. With Epi, also adds the x-side elementwise term
// and the bias of the input projection to column n = g*h + j:
//   (j < f ? x[row, j] : 0) * xdvec[n] + bias[n]
template <bool Epi>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ c, int m, int n, int k,
            const float* __restrict__ x, int f, int h,
            const float* __restrict__ xdvec, const float* __restrict__ bias) {
  __shared__ float as[kDepth][kTile + 1];
  __shared__ float bs[kDepth][kTile];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += kDepth) {
    for (int i = threadIdx.x; i < kTile * kDepth; i += kGemmThreads) {
      const int r = i / kDepth, kk = i % kDepth;
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k) ? a[(size_t)gr * k + gk] : 0.f;
    }
    for (int i = threadIdx.x; i < kTile * kDepth; i += kGemmThreads) {
      const int kk = i / kTile, cc = i % kTile;
      const int gk = k0 + kk, gc = col0 + cc;
      bs[kk][cc] = (gk < k && gc < n) ? b[(size_t)gk * n + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = row0 + ty + 16 * i, gc = col0 + tx + 16 * j;
      if (gr >= m || gc >= n) continue;
      float val = acc[i][j];
      if (Epi) {
        const int jj = gc % h;
        const float xv = jj < f ? x[(size_t)gr * f + jj] : 0.f;
        val = val + xv * xdvec[gc] + bias[gc];
      }
      c[(size_t)gr * n + gc] = val;
    }
  }
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// One CTA per kRows batch rows; the CTA walks all t_len steps. Shared memory:
// hs [kRows,h] and cs [kRows,h] (the carry), hus [kRows,r] (h @ U of the step).
// Rows past the batch stay zero and are never written out.
__global__ void __launch_bounds__(kMaxThreads)
scan_kernel(const float* __restrict__ gi, const float* __restrict__ u,
            const float* __restrict__ v, const float* __restrict__ dvec,
            const float* __restrict__ h0, const float* __restrict__ c0,
            float* __restrict__ ys, float* __restrict__ c_last,
            int t_len, int batch, int h, int r) {
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
      for (int row = 0; row < kRows; ++row) hus[row * r + col] = acc[row];
    }
    __syncthreads();

    // hus @ V, then the gates, for hidden unit j of all four gates: each
    // (row, j) of the carry is read and written by its own thread only.
    const float* gi_t = gi + ((size_t)t * batch + b0) * g4;
    float* ys_t = ys + ((size_t)t * batch + b0) * h;
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
          const float pi = gr[j] + acc[0][row] + hp * d0;
          const float pf = gr[h + j] + acc[1][row] + hp * d1;
          const float pg = gr[2 * h + j] + acc[2][row] + hp * d2;
          const float po = gr[3 * h + j] + acc[3][row] + hp * d3;
          const float cn = sigmoid(pf) * cs[row * h + j] + sigmoid(pi) * tanhf(pg);
          const float hn = sigmoid(po) * tanhf(cn);
          cs[row * h + j] = cn;
          hs[row * h + j] = hn;
          ys_t[(size_t)row * h + j] = hn;
        }
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < rows * h; i += blockDim.x) c_last[(size_t)b0 * h + i] = cs[i];
}

}  // namespace

// Launches the three kernels on `stream` and returns cudaGetLastError().
// xu [T*B, rx] and gi [T*B, 4h] are scratch that the caller allocates.
extern "C" int lstm_scan_xin_fwd(
    const float* x, const float* ux, const float* vx, const float* xdvec,
    const float* bias, const float* u, const float* v, const float* dvec,
    const float* h0, const float* c0, float* xu, float* gi, float* ys,
    float* c_last, int t_len, int batch, int f, int rx, int h, int r,
    void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int m = t_len * batch;
  const int g4 = 4 * h;
  cudaError_t err;

  gemm_kernel<false><<<dim3(cdiv(rx, kTile), cdiv(m, kTile)), kGemmThreads, 0, stream>>>(
      x, ux, xu, m, rx, f, nullptr, 0, 1, nullptr, nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gemm_kernel<true><<<dim3(cdiv(g4, kTile), cdiv(m, kTile)), kGemmThreads, 0, stream>>>(
      xu, vx, gi, m, g4, rx, x, f, h, xdvec, bias);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem = sizeof(float) * (2 * kRows * h + kRows * r);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int span = h > r ? h : r;
  const int want = cdiv(span, 32) * 32;
  const int threads = want < kMaxThreads ? want : kMaxThreads;
  scan_kernel<<<cdiv(batch, kRows), threads, smem, stream>>>(
      gi, u, v, dvec, h0, c0, ys, c_last, t_len, batch, h, r);
  return cudaGetLastError();
}

// The message of an error code that lstm_scan_xin_fwd returned.
extern "C" const char* lstm_scan_xin_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
