// The phases of one step of a low-rank LSTM layer, forward and backward, in
// f32 or with bf16 products, for the wavefront stack kernels
// (lstm_stack_fwd.cu, lstm_stack_bwd.cu), and the column sums of the BPTT,
// which the single-layer BPTT (lstm_scan_xin_bwd.cu) shares; for sm_90a.
//
// A serial CTA owns kRows batch rows, b0 .. b0 + rows - 1, and walks steps
// with the carry in shared memory. Every thread of the CTA calls the step
// functions, and each step ends with a block barrier. Rows at and past `rows`
// (past the batch) stay zero in shared memory and are never written out.
// Row m of a [T*B, ...] buffer is step t, batch row b at m = t*B + b; row_t
// below is the CTA's first row at the step, t*B + b0. Gate order i, f, g, o.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace vmlmf {

constexpr int kRows = 4;  // batch rows per serial CTA

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// A weight element read through L2 and widened to f32: an f32 weight, or a
// bf16 copy (its 16 bits are the high half of the f32 of the same value).
__device__ __forceinline__ float ld_w(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_w(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

// Forward steps t0 .. t1-1 of a low-rank layer (U [h, r], V [r, 4h]):
//   hu = h @ U;  pre = gi[row] + hu @ V + tile4(h) * dvec
//   c = sf*c + si*tg;  h = so*tanh(c)
// gi_block holds the gi rows from step t0 on: row (t, b) at (t - t0) * batch
// + b. Shared memory: hs, cs [kRows, h] (the carry), hus [kRows, r] (h @ U of
// the step) and hm [kRows, h], the h that the product reads: hs itself in
// f32, its bf16-rounded copy in the bf16 form, written beside hs. Writes ys
// at rows t * batch + b0 + row and, with Residuals, cs_out, gates_out
// (after the nonlinearities) and hu_out (the f32 product, before any
// rounding) at the same rows.
//
// W is the weights' type: f32, or the bf16 copies of the bf16 form, whose
// products also read h and hu rounded to bf16 (by their writers) and sum
// in f32; the dvec term, gi and the gate arithmetic stay f32.
//
// Two phases a step, h@U into shared memory (one thread per rank column, U
// read down its column), a barrier, then (h@U)@V and the gates (one thread
// per hidden unit j, V's four gate columns of j read along its rows).
template <bool Residuals, bool Bf16, class W>
__device__ __forceinline__ void lstm_fwd_steps(
    int t0, int t1, const float* __restrict__ gi_block, const W* __restrict__ u,
    const W* __restrict__ v, const float* __restrict__ dvec, float* hs, float* cs, float* hus,
    float* hm, int batch, int b0, float* __restrict__ ys, float* __restrict__ cs_out,
    float* __restrict__ gates_out, float* __restrict__ hu_out, int rows, int h, int r) {
  const int g4 = 4 * h;

  for (int t = t0; t < t1; ++t) {
    const size_t row_t = (size_t)t * batch + b0;  // first output row of this step
    // hus = hm @ U: one thread per rank column, U read down its column.
    for (int col = threadIdx.x; col < r; col += blockDim.x) {
      float acc[kRows] = {};
#pragma unroll 4
      for (int j = 0; j < h; ++j) {
        const float wj = ld_w(u + (size_t)j * r + col);
#pragma unroll
        for (int row = 0; row < kRows; ++row) acc[row] = fmaf(hm[row * h + j], wj, acc[row]);
      }
#pragma unroll
      for (int row = 0; row < kRows; ++row) {
        hus[row * r + col] = exchanged<Bf16>(acc[row]);
        if (Residuals && row < rows) hu_out[(row_t + row) * r + col] = acc[row];
      }
    }
    __syncthreads();

    // hus @ V, then the gates, for hidden unit j of all four gates: each
    // (row, j) of the carry is read and written by its own thread only.
    const float* gi_t = gi_block + ((size_t)(t - t0) * batch + b0) * g4;
    float* ys_t = ys + row_t * h;
    for (int j = threadIdx.x; j < h; j += blockDim.x) {
      float acc[4][kRows] = {};
#pragma unroll 4
      for (int k = 0; k < r; ++k) {
        const W* wk = v + (size_t)k * g4 + j;
        const float w0 = ld_w(wk), w1 = ld_w(wk + h);
        const float w2 = ld_w(wk + 2 * h), w3 = ld_w(wk + 3 * h);
#pragma unroll
        for (int row = 0; row < kRows; ++row) {
          const float s = hus[row * r + k];
          acc[0][row] = fmaf(s, w0, acc[0][row]);
          acc[1][row] = fmaf(s, w1, acc[1][row]);
          acc[2][row] = fmaf(s, w2, acc[2][row]);
          acc[3][row] = fmaf(s, w3, acc[3][row]);
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
          if (Bf16) hm[row * h + j] = exchanged<Bf16>(hn);
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
}

// One reverse step of the BPTT of a low-rank layer at step t (rows row_t +
// row), from the saved gates and cs, c_prev = cs[t-1] or c0 at t = 0, and
// the cotangent dys of the step's outputs (null: zeros):
//
//   dh += dys[t];  tc = tanh(cs[t]);  dc += dh * o * (1 - tc^2)
//   dpre = [dc*g*i*(1-i), dc*c_prev*f*(1-f), dc*i*(1-g^2), dh*tc*o*(1-o)];  dc *= f
//   dhu = dpre @ V^T;  dh = sum_g dpre_g * dvec_g + dhu @ U^T
//
// Shared memory: dhs, dcs [kRows, h] (the carry), dps [kRows, 4h] (dpre of
// the step, as the product reads it) and dhus [kRows, r]. Writes dpre (f32)
// and dhu (as the products read it) at the step's rows. In the bf16 form (W
// the bf16 copies of U and V) the products read dpre and dhu rounded to
// bf16 by their writers; the dvec term takes the f32 dpre. The weights are
// read through L2, one warp per output, lanes along the weight's row: dhu @
// U^T reduces over U's row j, which is contiguous, so lanes read
// neighbouring words with no transposed copy. Three block barriers a step.
template <bool Bf16, class W>
__device__ __forceinline__ void lstm_bwd_step(
    int t, size_t row_t, int batch, int b0, const float* __restrict__ gates,
    const float* __restrict__ cs, const float* __restrict__ c0, const float* __restrict__ dys,
    const W* __restrict__ u, const W* __restrict__ v, const float* __restrict__ dvec,
    float* dhs, float* dcs, float* dps, float* dhus, float* __restrict__ dpre,
    float* __restrict__ dhu, int rows, int h, int r) {
  const int g4 = 4 * h;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  // dpre of hidden unit j of all four gates, and the dvec part of dh_prev:
  // each (row, j) of the carry is read and written by its own thread only.
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    for (int row = 0; row < rows; ++row) {
      const size_t m = row_t + row;
      const float* gr = gates + m * g4;
      const float gi = gr[j], gf = gr[h + j], gg = gr[2 * h + j], go = gr[3 * h + j];
      const float c_prev = t > 0 ? cs[(m - batch) * h + j] : c0[(size_t)(b0 + row) * h + j];
      const float dh = dhs[row * h + j] + (dys != nullptr ? dys[m * h + j] : 0.f);
      const float tc = tanhf(cs[m * h + j]);
      const float dc = dcs[row * h + j] + dh * go * (1.f - tc * tc);
      dcs[row * h + j] = dc * gf;
      const float pi = dc * gg * gi * (1.f - gi);
      const float pf = dc * c_prev * gf * (1.f - gf);
      const float pg = dc * gi * (1.f - gg * gg);
      const float po = dh * tc * go * (1.f - go);
      float* ds = dps + row * g4;
      ds[j] = exchanged<Bf16>(pi);
      ds[h + j] = exchanged<Bf16>(pf);
      ds[2 * h + j] = exchanged<Bf16>(pg);
      ds[3 * h + j] = exchanged<Bf16>(po);
      float* dg = dpre + m * g4;
      dg[j] = pi;
      dg[h + j] = pf;
      dg[2 * h + j] = pg;
      dg[3 * h + j] = po;
      dhs[row * h + j] = pi * dvec[j] + pf * dvec[h + j] + pg * dvec[2 * h + j]
                         + po * dvec[3 * h + j];
    }
  }
  __syncthreads();

  // dhu = dpre @ V^T: one warp per rank k, lanes along V's row k.
  for (int k = warp; k < r; k += nwarps) {
    const W* vk = v + (size_t)k * g4;
    float acc[kRows] = {};
    for (int n = lane; n < g4; n += 32) {
      const float w = ld_w(vk + n);
#pragma unroll
      for (int row = 0; row < kRows; ++row) acc[row] = fmaf(dps[row * g4 + n], w, acc[row]);
    }
#pragma unroll
    for (int row = 0; row < kRows; ++row) {
      const float s = exchanged<Bf16>(warp_sum(acc[row]));
      if (lane == 0) {
        dhus[row * r + k] = s;
        if (row < rows) dhu[(row_t + row) * r + k] = s;
      }
    }
  }
  __syncthreads();

  // dh_prev += dhu @ U^T (U [h, r]), one warp per hidden unit j, lanes along
  // U's row j.
  for (int j = warp; j < h; j += nwarps) {
    const W* uj = u + (size_t)j * r;
    float acc[kRows] = {};
    for (int k = lane; k < r; k += 32) {
      const float w = ld_w(uj + k);
#pragma unroll
      for (int row = 0; row < kRows; ++row) acc[row] = fmaf(dhus[row * r + k], w, acc[row]);
    }
#pragma unroll
    for (int row = 0; row < kRows; ++row) {
      const float s = warp_sum(acc[row]);
      if (lane == 0) dhs[row * h + j] += s;
    }
  }
  __syncthreads();
}

// dst[e] = src[e] rounded to bf16, for e < n: the bf16 copies of a layer's
// recurrent weights, made once per call (pallas_pipeline.py's cast_w).
__global__ void __launch_bounds__(256) narrow_kernel(const float* __restrict__ src,
                                                     __nv_bfloat16* __restrict__ dst, size_t n) {
  for (size_t e = (size_t)blockIdx.x * 256 + threadIdx.x; e < n; e += (size_t)gridDim.x * 256)
    dst[e] = __float2bfloat16_rn(src[e]);
}

inline cudaError_t narrow(const float* src, __nv_bfloat16* dst, size_t n, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(n < 264 * 256 ? (n + 255) / 256 : 264 * 4);
  narrow_kernel<<<blocks, 256, 0, stream>>>(src, dst, n);
  return cudaGetLastError();
}

constexpr int kSumCols = 32;   // columns per column-sum CTA
constexpr int kSumLanes = 8;   // row lanes per column-sum CTA

// Column sums over the M rows of dpre [M, 4h], for column n (jj = n % h):
//   ddvec[n]  = sum_m dpre[m,n] * hprev[m,jj]  (hprev row m: h0[m] for m < B, ys[m-B] after)
//   dxdvec[n] = sum_m dpre[m,n] * (jj < f ? x(m, jj) : 0)
//   dbias[n]  = sum_m dpre[m,n]
// where x is an operand view (gemm_tile.cuh); dxdvec and dbias null: only
// ddvec. kSumLanes row lanes per column, then a fixed-order sum over the
// lanes: deterministic, no atomics.
template <class X>
__global__ void __launch_bounds__(kSumCols * kSumLanes)
colsum_kernel(const float* __restrict__ dpre, const float* __restrict__ h0,
              const float* __restrict__ ys, X x, float* __restrict__ ddvec,
              float* __restrict__ dxdvec, float* __restrict__ dbias, int m_rows, int batch,
              int f, int h) {
  __shared__ float part[3][kSumLanes][kSumCols];
  const int c = threadIdx.x % kSumCols, lane = threadIdx.x / kSumCols;
  const int n = blockIdx.x * kSumCols + c;
  const int g4 = 4 * h;
  const bool xside = dxdvec != nullptr;
  float sd = 0.f, sx = 0.f, sb = 0.f;
  if (n < g4) {
    const int jj = n % h;
    for (int m = lane; m < m_rows; m += kSumLanes) {
      const float d = dpre[(size_t)m * g4 + n];
      const float hp = m < batch ? h0[(size_t)m * h + jj] : ys[(size_t)(m - batch) * h + jj];
      sd = fmaf(d, hp, sd);
      if (xside) {
        sx = fmaf(d, jj < f ? x(m, jj) : 0.f, sx);
        sb += d;
      }
    }
  }
  part[0][lane][c] = sd;
  part[1][lane][c] = sx;
  part[2][lane][c] = sb;
  __syncthreads();
  if (lane == 0 && n < g4) {
    for (int l = 1; l < kSumLanes; ++l) {
      sd += part[0][l][c];
      sx += part[1][l][c];
      sb += part[2][l][c];
    }
    ddvec[n] = sd;
    if (xside) {
      dxdvec[n] = sx;
      dbias[n] = sb;
    }
  }
}

}  // namespace vmlmf
