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
//   1. grid_bptt_kernel, the serial part, on the layout of the forward
//      (scan_grid.cuh, ops/cuda_scan.py::scan_plan): batch groups, each
//      over `ctas` co-resident CTAs of a cooperative launch that hold their
//      slices of the recurrent weights in shared memory for the whole walk.
//      CTA q owns the hidden units j0 .. j1-1 and the rank columns
//      k0 .. k1-1. A low-rank step: (A, j-slice) dpre of the j-slice from
//      its (dh, dc) carry, the saved gates and cs (c_prev straight from
//      cs[t-1] or c0), into dpre [T*B, 4h] and the group's dpre exchange,
//      and the dvec part of the next dh; group barrier; (B, k-slice) dhu[:,
//      k] = dpre @ V[k-slice, :]^T with V's rows resident, into dhu [T*B, r]
//      and the dhu exchange; group barrier; (C, j-slice) dh[:, j] +=
//      dhu @ U[j-slice, :]^T with U's rows resident. C runs on the CTA that
//      owns the next step's A, so it needs no barrier after it: two a step.
//      Dense: no B, and C reads dpre @ U[j-slice, :]^T; one barrier a step,
//      dpre's exchange double-buffered by step parity. Each CTA reads the
//      group's whole dpre (4h floats a row) or dhu from L2 a step, with
//      16-byte cp.async.cg, never __ldg; at B=128 that read (458 KB a CTA
//      a step) sets the step. Phase A's inputs of the next step (gates, cs,
//      c_prev, dys) are copied with cp.async while phases B and C run.
//      Every sum runs inside one CTA in a fixed order: deterministic, no
//      atomics. This replaced one CTA per 4 batch rows that read all of U
//      and V from L2 a step (118-124 us a step at h=650 whatever B).
//   2. Time-parallel passes over all M rows: tiled GEMMs (gemm_tile.cuh)
//      with transposed operand views (six low-rank, three with a dense
//      side of each kind), and one column-sum kernel. The products whose k
//      is M (the weight gradients dU, dV, dUx, dVx) have few output tiles
//      (three at the HAR layer's dU [180, 6]), as do the x side's products
//      over the 4h gate columns (dXU [M, rx]: 55 tiles at the LM layer,
//      B=20; or dx [M, F] for a dense x side); so they go through
//      gemm_splitk, which cuts k into slices over about two CTAs per SM
//      and adds the slices in a fixed order. Every sum is taken in a fixed
//      order: deterministic, no atomics.
// * Every edge is masked: B, T*B, F, h, r, rx need not be tile or slice
//   multiples, and fit() covers F = h, F < h and F > h.

#include <cuda_runtime.h>

#include "gemm_tile.cuh"
#include "lstm_steps.cuh"
#include "scan_grid.cuh"

namespace {

using vmlmf::cdiv;
using vmlmf::div_up;
using vmlmf::GridPlan;
using vmlmf::round4;
using vmlmf::split_at;

// Phase A's inputs per unit and row: the four gates, cs[t], c_prev, dys[t]
constexpr int kInputs = 7;

// Floats of this kernel's shared memory, in the order of the carve below:
// the weight slices, dvec of the j-slice, the (dh, dc) carry, stage, red,
// and phase A's inputs of the step.
__host__ __device__ inline size_t bwd_smem_floats(bool dense_rec, int h, int r,
                                                  const GridPlan& p) {
  const int jwm = div_up(h, p.ctas), jwp = round4(jwm);
  const int kwp = dense_rec ? 0 : round4(div_up(r, p.ctas));
  const size_t weights = dense_rec ? (size_t)4 * h * jwp : (size_t)4 * h * kwp + (size_t)r * jwp;
  return weights + 4 * jwm + (2 + kInputs) * (size_t)jwm * p.rpad + p.stage + p.red;
}

// The serial reverse walk on plan.groups x plan.ctas co-resident CTAs.
// xchg: the dpre exchange [2][groups][4h][rpad] (step parity), then,
// low-rank, the dhu exchange [groups][r][rpad]. sync: a barrier word per group.
template <bool DenseRec>
__global__ void __launch_bounds__(vmlmf::kGridThreads, 1)
grid_bptt_kernel(const float* __restrict__ gates, const float* __restrict__ cs,
                 const float* __restrict__ c0, const float* __restrict__ dys,
                 const float* __restrict__ dc_last, const float* __restrict__ u,
                 const float* __restrict__ v, const float* __restrict__ dvec,
                 float* __restrict__ dpre, float* __restrict__ dhu,
                 float* __restrict__ dh0, float* __restrict__ dc0, float* xchg,
                 unsigned* sync, int t_len, int batch, int h, int r, GridPlan plan) {
  extern __shared__ __align__(16) float smem[];
  const int g4 = 4 * h, rpad = plan.rpad;
  const int grp = blockIdx.x / plan.ctas, q = blockIdx.x % plan.ctas;
  const int b0 = split_at(grp, batch, plan.groups);
  const int rows = split_at(grp + 1, batch, plan.groups) - b0;
  const int j0 = split_at(q, h, plan.ctas), jw = split_at(q + 1, h, plan.ctas) - j0;
  const int k0 = DenseRec ? 0 : split_at(q, r, plan.ctas);
  const int kw = DenseRec ? 0 : split_at(q + 1, r, plan.ctas) - k0;
  const int jwm = div_up(h, plan.ctas), jwp = round4(jwm);
  const int kwp = DenseRec ? 0 : round4(div_up(r, plan.ctas));
  const int depth = DenseRec ? g4 : r;  // of phase C's product

  float* wb = smem;                        // low-rank: V[k-slice, :]^T  [4h][kwp]
  float* wc = wb + (size_t)g4 * kwp;       // U[j-slice, :]^T  [depth][jwp]
  float* dv = wc + (size_t)depth * jwp;    // dvec of the j-slice [jwm][4]
  float* dhc = dv + 4 * jwm;               // the carry dh, dc: [jwm][rpad]
  float* dcc = dhc + (size_t)jwm * rpad;
  float* stage = dcc + (size_t)jwm * rpad;
  float* red = stage + plan.stage;
  float* pa = red + plan.red;              // phase A's inputs of the step [kInputs][jwm][rpad]
  const size_t dpx_par = (size_t)plan.groups * g4 * rpad;
  float* dpx = xchg + (size_t)grp * g4 * rpad;  // parity p at dpx + p * dpx_par
  float* dhux = xchg + 2 * dpx_par + (size_t)grp * r * rpad;
  unsigned* count = sync + grp;
  unsigned target = 0;

  // the weight slices, transposed, loaded once along the rows of V and U
  // (coalesced reads); columns past the slice are zero
  if constexpr (!DenseRec) {
#pragma unroll 4
    for (int e = threadIdx.x; e < kwp * g4; e += blockDim.x) {
      const int kk = e / g4, n = e % g4;
      wb[(size_t)n * kwp + kk] = kk < kw ? v[(size_t)(k0 + kk) * g4 + n] : 0.f;
    }
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < jwp * depth; e += blockDim.x) {
    const int jj = e / depth, k = e % depth;
    wc[(size_t)k * jwp + jj] = jj < jw ? u[(size_t)(j0 + jj) * depth + k] : 0.f;
  }
  for (int e = threadIdx.x; e < 4 * jwm; e += blockDim.x)
    dv[e] = e / 4 < jw ? dvec[(e % 4) * h + j0 + e / 4] : 0.f;
  for (int e = threadIdx.x; e < jwm * rpad; e += blockDim.x) {
    const int jj = e / rpad, row = e % rpad;
    const bool live = jj < jw && row < rows && dc_last != nullptr;
    dhc[e] = 0.f;
    dcc[e] = live ? dc_last[(size_t)(b0 + row) * h + j0 + jj] : 0.f;
  }

  // phase A's inputs of step t into pa, copied while the CTA works on the
  // step before it: gates, cs[t], c_prev (cs[t-1] or c0), dys[t]
  const int slab = jwm * rpad;
  auto prefetch = [&](int t) {
    const size_t m0 = (size_t)t * batch + b0;
    const int n = jw * rows, kinds = dys != nullptr ? kInputs : kInputs - 1;
    for (int e = threadIdx.x; e < kinds * n; e += blockDim.x) {
      const int k = e / n, jj = e % jw, row = (e % n) / jw, j = j0 + jj;
      const size_t m = m0 + row;
      const float* src = k < 4    ? gates + m * g4 + k * h + j
                         : k == 4 ? cs + m * h + j
                         : k == 6 ? dys + m * h + j
                         : t > 0  ? cs + (m - batch) * h + j
                                  : c0 + (size_t)(b0 + row) * h + j;
      vmlmf::cp_async4(pa + k * slab + jj * rpad + row, src);
    }
  };
  prefetch(t_len - 1);

  for (int t = t_len - 1; t >= 0; --t) {
    float* dpx_t = dpx + (t & 1) * dpx_par;
    const size_t m0 = (size_t)t * batch + b0;
    vmlmf::cp_async_wait_all();
    __syncthreads();  // pa, and the carry that phase C wrote

    // (A) dpre of the j-slice; the carry's dh becomes the dvec part of dh_prev
    for (int e = threadIdx.x; e < jw * rpad; e += blockDim.x) {
      const int jj = e % jw, row = e / jw, j = j0 + jj;
      const int at = jj * rpad + row;
      if (row >= rows) {
        for (int gg = 0; gg < 4; ++gg) dpx_t[(size_t)(gg * h + j) * rpad + row] = 0.f;
        continue;
      }
      const size_t m = m0 + row;
      const float gi = pa[at], gf = pa[slab + at], gg = pa[2 * slab + at];
      const float go = pa[3 * slab + at], c_prev = pa[5 * slab + at];
      const float dh = dhc[at] + (dys != nullptr ? pa[6 * slab + at] : 0.f);
      const float tc = tanhf(pa[4 * slab + at]);
      const float dc = dcc[at] + dh * go * (1.f - tc * tc);
      dcc[at] = dc * gf;
      const float p[4] = {dc * gg * gi * (1.f - gi), dc * c_prev * gf * (1.f - gf),
                          dc * gi * (1.f - gg * gg), dh * tc * go * (1.f - go)};
      float dhp = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dpre[m * g4 + k * h + j] = p[k];
        dpx_t[(size_t)(k * h + j) * rpad + row] = p[k];
        dhp = fmaf(p[k], dv[4 * jj + k], dhp);
      }
      dhc[at] = dhp;
    }
    vmlmf::group_sync(count, plan.ctas, target);
    if (t > 0) prefetch(t - 1);

    if (!DenseRec) {
      // (B) dhu[:, k-slice] = dpre @ V[k-slice, :]^T
      vmlmf::slice_product(dpx_t, g4, rpad, wb, kwp, round4(kw), stage, plan.stage, red,
                           plan.red, [&](int cb, int rb, float (&acc)[4][4]) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kk = 4 * cb + c;
          if (kk >= kw) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = 4 * rb + i;
            dhux[(size_t)(k0 + kk) * rpad + row] = acc[c][i];
            if (row < rows) dhu[(m0 + row) * r + k0 + kk] = acc[c][i];
          }
        }
      });
      vmlmf::group_sync(count, plan.ctas, target);
    }

    // (C) dh[:, j-slice] += src @ U[j-slice, :]^T, src = dhu or (dense) dpre
    vmlmf::slice_product(DenseRec ? dpx_t : dhux, depth, rpad, wc, jwp, round4(jw), stage,
                         plan.stage, red, plan.red, [&](int cb, int rb, float (&acc)[4][4]) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jj = 4 * cb + c;
        if (jj >= jw) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) dhc[jj * rpad + 4 * rb + i] += acc[c][i];
      }
    });
  }
  __syncthreads();

  for (int e = threadIdx.x; e < jw * rows; e += blockDim.x) {
    const int jj = e % jw, row = e / jw;
    const size_t at = (size_t)(b0 + row) * h + j0 + jj;
    dh0[at] = dhc[jj * rpad + row];
    dc0[at] = dcc[jj * rpad + row];
  }
}

// Launches grid_bptt_kernel<DenseRec>; returns the launch's error. The plan
// must hold at least the shared memory this kernel carves.
template <bool DenseRec>
cudaError_t bptt(const float* gates, const float* cs, const float* c0, const float* dys,
                 const float* dc_last, const float* u, const float* v, const float* dvec,
                 float* dpre, float* dhu, float* dh0, float* dc0, float* xchg, unsigned* sync,
                 int t_len, int batch, int h, int r, GridPlan plan, cudaStream_t stream) {
  if (sizeof(float) * bwd_smem_floats(DenseRec, h, r, plan) > (size_t)plan.smem)
    return cudaErrorInvalidValue;
  void* args[] = {&gates, &cs, &c0, &dys, &dc_last, &u, &v, &dvec, &dpre, &dhu, &dh0, &dc0,
                  &xchg, &sync, &t_len, &batch, &h, &r, &plan};
  return vmlmf::launch_grid(grid_bptt_kernel<DenseRec>, plan, sync, args, stream);
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
// allocates (dhu null for a dense recurrent side, dxu for a dense x side),
// as are xchg and sync (scan_plan sizes them) and partial, partial_floats
// floats for the split-k partial sums (bwd_partial_floats); every other
// pointer after dpre is an output (dv and dvx null with dhu and dxu). The
// last six integers are scan_plan's layout.
extern "C" int lstm_scan_xin_bwd(
    const float* x, const float* ux, const float* vx, const float* xdvec,
    const float* u, const float* v, const float* dvec, const float* h0,
    const float* c0, const float* ys, const float* cs, const float* gates,
    const float* hu, const float* xu, const float* dys, const float* dc_last,
    float* dpre, float* dhu, float* dxu, float* dx, float* dux, float* dvx,
    float* dxdvec, float* dbias, float* du, float* dv, float* ddvec,
    float* dh0, float* dc0, float* xchg, unsigned* sync, float* partial, int partial_floats,
    int t_len, int batch, int f, int rx, int h, int r, int groups, int ctas, int rpad,
    int stage, int red, int smem, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int m = t_len * batch;
  const int g4 = 4 * h;
  const size_t room = static_cast<size_t>(partial_floats);
  const GridPlan plan{groups, ctas, rpad, stage, red, smem};
  using vmlmf::RowMajor;
  using vmlmf::Store;
  using vmlmf::Transposed;
  using vmlmf::gemm_splitk;
  const vmlmf::PrevRowsT hprev_t{h0, ys, batch, h};
  cudaError_t err;

  if (v == nullptr) {
    err = bptt<true>(gates, cs, c0, dys, dc_last, u, v, dvec, dpre, dhu, dh0, dc0, xchg, sync,
                     t_len, batch, h, r, plan, stream);
    if (err != cudaSuccess) return err;
    // dU [h, 4h] = Hprev^T dPre
    err = gemm_splitk(hprev_t, RowMajor{dpre, g4}, Store{du, g4}, h, g4, m, partial, room,
                      stream);
  } else {
    err = bptt<false>(gates, cs, c0, dys, dc_last, u, v, dvec, dpre, dhu, dh0, dc0, xchg, sync,
                      t_len, batch, h, r, plan, stream);
    if (err != cudaSuccess) return err;
    // dV [r, 4h] = HU^T dPre;  dU [h, r] = Hprev^T dHU
    err = gemm_splitk(Transposed{hu, r}, RowMajor{dpre, g4}, Store{dv, g4}, r, g4, m, partial,
                      room, stream);
    if (err != cudaSuccess) return err;
    err = gemm_splitk(hprev_t, RowMajor{dhu, r}, Store{du, r}, h, r, m, partial, room, stream);
  }
  if (err != cudaSuccess) return err;

  const DxEpilogue dx_epi{dx, dpre, xdvec, f, h};
  if (vx == nullptr) {
    // dx [M, F] = dPre Ux^T + fit(sum_g dPre_g xdvec_g);  dUx [F, 4h] = X^T dPre
    err = gemm_splitk(RowMajor{dpre, g4}, Transposed{ux, g4}, dx_epi, m, f, g4, partial, room,
                      stream);
    if (err != cudaSuccess) return err;
    err = gemm_splitk(Transposed{x, f}, RowMajor{dpre, g4}, Store{dux, g4}, f, g4, m, partial,
                      room, stream);
  } else {
    // dXU [M, rx] = dPre Vx^T;  dx [M, F] = dXU Ux^T + fit(sum_g dPre_g xdvec_g)
    err = gemm_splitk(RowMajor{dpre, g4}, Transposed{vx, g4}, Store{dxu, rx}, m, rx, g4,
                      partial, room, stream);
    if (err != cudaSuccess) return err;
    err = vmlmf::gemm(RowMajor{dxu, rx}, Transposed{ux, rx}, dx_epi, m, f, rx, stream);
    if (err != cudaSuccess) return err;
    // dUx [F, rx] = X^T dXU;  dVx [rx, 4h] = XU^T dPre
    err = gemm_splitk(Transposed{x, f}, RowMajor{dxu, rx}, Store{dux, rx}, f, rx, m, partial,
                      room, stream);
    if (err != cudaSuccess) return err;
    err = gemm_splitk(Transposed{xu, rx}, RowMajor{dpre, g4}, Store{dvx, g4}, rx, g4, m,
                      partial, room, stream);
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
