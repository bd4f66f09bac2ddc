// The column sums of the LSTM BPTTs (lstm_scan_xin_bwd.cu,
// lstm_stack_bwd.cu), for sm_90a: the diagonal and bias gradients, summed
// over all T*B rows of dpre once the reverse walk has ended. Row m of a
// [T*B, ...] buffer is step t, batch row b at m = t*B + b. Gate order i, f,
// g, o.

#pragma once

#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace vmlmf {

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
