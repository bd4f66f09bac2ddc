// Backward of the fused LSTM scan, x mode and gi mode, for sm_90a.
//
// Replaces vmlmf_tpu/ops/pallas_scan.py::_bwd_kernel in every variant that
// lstm_scan_fused_xin's VJP (x mode) and lstm_scan_fused's (gi mode) run,
// each side low-rank or dense as in the forward (lstm_scan_xin_fwd.cu: a
// null V is a dense U [h,4h], "DenseRec"; a null Vx a dense Ux [F,4h],
// "DenseX"): products f32 or bf16; the saved gates and hu as f32 or bf16
// residuals, widened to f32 first; or, in x mode, the recompute policy,
// which rebuilds them first. From the residuals of the forward (entries
// lstm_scan_xin_fwd_res and lstm_scan_fwd_res) and the cotangents dys
// [T,B,h] and dc_last [B,h], each of which may be absent (zeros), it
// computes, walking t = T-1 .. 0 with the carry (dh, dc), dc = dc_last at
// the start:
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
// ys[t-1, b] after. In gi mode dgi = dPre and there is no x side. Layouts
// as in the forward; all row-major, contiguous.
//
// bf16 (pallas_scan.py:583-680): each product rounds its operands to bf16
// and sums in f32, as the TPU kernel casts them: dpre and dhu in the walk
// (rounded by the CTA that writes them to the exchange, the weight slices
// bf16 in shared memory; where a group pads to 24 rows or more the walk's
// products run on the tensor cores with a bf16 exchange,
// scan_grid.cuh::Ring::mma_product), Hprev, HU, dPre, dHU, X, XU, dXU and the
// factors in the GEMMs after it (rounding operand views). dpre [T*B, 4h]
// and dhu [T*B, r] are written f32 apart from the exchange; the dvec term
// of dh, ddvec, dxdvec, dbias and the xdvec term of dx read the f32 dpre.
//
// Recompute (save_gates=False, x mode; pallas_scan.py:543-576): before the
// walk, batched GEMMs over all M rows rebuild xu = X @ Ux, gi (its
// epilogue adds the x term and bias), hu = Hprev @ U and, in the epilogue
// of pre = gi + hu @ V (dense: Hprev @ U) + Hprev * dvec, the gates, in
// place; the walk then reads them as saved gates. None of it is on the
// serial chain, and the walk's shared memory does not grow.
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
//      Where the slices do not fit in the shared memory of all SMs, the
//      rows past each slice's resident depth are streamed as in the
//      forward (ScanPlan.resident_bwd; lstm_scan_xin_fwd.cu): copied once
//      into the CTA's region of `wstream`, and phases B and C run on the
//      ring (scan_grid.cuh::Ring), in the same order of sums.
//   2. Time-parallel passes over all M rows: tensor-core GEMMs
//      (gemm_tc.cuh: wgmma fed by TMA, 3xTF32 in f32, bf16 in the bf16
//      variants, each operand staged once a call; mma.sync at the small
//      products) with transposed operand views (six low-rank, three with a dense side of
//      each kind), and one column-sum kernel. At a dense h=1500 these
//      products are 12.6 GFLOP each at B=20. The products whose k is M
//      (the weight gradients dU, dV, dUx, dVx) have few output tiles at
//      the narrow layers (three at the HAR layer's dU [180, 6]), as do the
//      x side's products over the 4h gate columns (dXU [M, rx]: 55 tiles
//      at the LM layer, B=20; or dx [M, F] for a dense x side); so they go
//      through gemm_splitk, which cuts k into slices over about two CTAs
//      per SM where a product has few tiles, added in a fixed order.
//      Every sum is taken in a fixed order: deterministic, no atomics.
// * Every edge is masked: B, T*B, F, h, r, rx need not be tile or slice
//   multiples, and fit() covers F = h, F < h and F > h.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "gemm_tc.cuh"
#include "lstm_steps.cuh"
#include "scan_grid.cuh"

namespace {

using vmlmf::bf16;
using vmlmf::cdiv;
using vmlmf::div_up;
using vmlmf::GridPlan;
using vmlmf::round4;
using vmlmf::split_at;

// Phase A's inputs per unit and row: the four gates, cs[t], c_prev, dys[t]
constexpr int kInputs = 7;
// The residual policy as the wrappers number it (ops/cuda_scan.py): saved
// f32 gates and hu, saved bf16 ones, or none (recompute).
constexpr int kPolicyF32 = 0, kPolicyBf16 = 1, kPolicyNone = 2;

// Floats of this kernel's shared memory, in the order of the carve below:
// the resident rows of the weight slices (of type W), dvec of the j-slice,
// the (dh, dc) carry, stage (or, on a streamed plan, the ring), red, and
// phase A's inputs of the step.
template <class W>
__host__ __device__ inline size_t bwd_smem_floats(bool dense_rec, int h, int r,
                                                  const GridPlan& p) {
  const int jwm = div_up(h, p.ctas), jwp = round4(jwm);
  const int kwp = dense_rec ? 0 : round4(div_up(r, p.ctas));
  const size_t weights = (size_t)(dense_rec ? 0 : p.res_a) * kwp + (size_t)p.res_b * jwp;
  return vmlmf::weight_floats<W>(weights) + 4 * jwm + (2 + kInputs) * (size_t)jwm * p.rpad +
         (p.piece ? vmlmf::ring_floats(p) : p.stage) + p.red;
}

// Floats of one CTA's region of the streamed scratch: the rows of V^T's and
// U^T's slices past their resident depths, each row padded to 16 bytes
// (ring_ld; ops/cuda_scan.py::stream_floats).
template <class W>
__host__ __device__ inline size_t bwd_stream_floats(bool dense_rec, int h, int r,
                                                    const GridPlan& p) {
  const int jwp = round4(div_up(h, p.ctas)), kwp = dense_rec ? 0 : round4(div_up(r, p.ctas));
  const int depth = dense_rec ? 4 * h : r;
  return vmlmf::weight_floats<W>(
      (size_t)(dense_rec ? 0 : 4 * h - p.res_a) * vmlmf::ring_ld<W>(kwp) +
      (size_t)(depth - p.res_b) * vmlmf::ring_ld<W>(jwp));
}

// The same for an mma plan, whose slices lie in whole blocks of 16 rows
// (scan_grid.cuh::mma_at): the resident blocks, and a CTA's streamed ones.
__host__ __device__ inline size_t bwd_mma_smem_floats(bool dense_rec, int h, int r,
                                                      const GridPlan& p) {
  const int jwm = div_up(h, p.ctas), jwp = round4(jwm);
  const int kwp = dense_rec ? 0 : round4(div_up(r, p.ctas));
  const int depth = dense_rec ? 4 * h : r;
  const size_t weights = (dense_rec ? 0 : (size_t)vmlmf::mma_resident(p.res_a, 4 * h) * kwp) +
                         (size_t)vmlmf::mma_resident(p.res_b, depth) * jwp;
  return vmlmf::weight_floats<bf16>(weights) + 4 * jwm + (2 + kInputs) * (size_t)jwm * p.rpad +
         (p.piece ? vmlmf::ring_floats(p) : p.stage) + p.red;
}
__host__ __device__ inline size_t bwd_mma_stream_floats(bool dense_rec, int h, int r,
                                                        const GridPlan& p) {
  const int jwp = round4(div_up(h, p.ctas)), kwp = dense_rec ? 0 : round4(div_up(r, p.ctas));
  const int depth = dense_rec ? 4 * h : r;
  return vmlmf::weight_floats<bf16>(
      (dense_rec ? 0
                 : (size_t)(vmlmf::round16(4 * h) - vmlmf::mma_resident(p.res_a, 4 * h)) * kwp) +
      (size_t)(vmlmf::round16(depth) - vmlmf::mma_resident(p.res_b, depth)) * jwp);
}

// The serial reverse walk on plan.groups x plan.ctas co-resident CTAs.
// xchg: the dpre exchange [2][groups][4h][rpad] (step parity), then,
// low-rank, the dhu exchange [groups][r][rpad]. sync: a barrier word per
// group. wstream: the streamed scratch, bwd_stream_floats a CTA. Streamed:
// the products run on the ring (scan_grid.cuh::Ring), kRingThreads threads
// a CTA; else slice_product on kGridThreads. Mma (an mma plan, bf16 only,
// on the ring): the products run on the tensor cores (Ring::mma_product),
// the exchange is bf16 [2][groups][4h16][xld] and [groups][r16][xld]
// (depths padded to 16, rows to mma_xld), the slices lie in blocks.
template <bool DenseRec, bool Bf16, bool Streamed, bool Mma = false>
__global__ void __launch_bounds__(Streamed ? vmlmf::kRingThreads : vmlmf::kGridThreads, 1)
grid_bptt_kernel(const float* __restrict__ gates, const float* __restrict__ cs,
                 const float* __restrict__ c0, const float* __restrict__ dys,
                 const float* __restrict__ dc_last, const float* __restrict__ u,
                 const float* __restrict__ v, const float* __restrict__ dvec,
                 float* __restrict__ dpre, float* __restrict__ dhu,
                 float* __restrict__ dh0, float* __restrict__ dc0, float* xchg,
                 unsigned* sync, float* wstream, int t_len, int batch, int h, int r,
                 GridPlan plan) {
  using W = std::conditional_t<Bf16, bf16, float>;  // weight slices
  using X = std::conditional_t<Mma, bf16, float>;   // the exchange
  static_assert(Bf16 || !Mma, "the mma product takes bf16 operands");
  static_assert(Streamed || !Mma, "the mma product runs on the ring");
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
  // resident depths: every row without Streamed
  const int resb = DenseRec ? 0 : Streamed ? plan.res_a : g4, resc = Streamed ? plan.res_b : depth;
  // an mma plan's resident rows, padded rows and exchange row (else as above)
  const int mresb = Mma ? vmlmf::mma_resident(resb, g4) : resb;
  const int mresc = Mma ? vmlmf::mma_resident(resc, depth) : resc;
  const int gdep = Mma ? vmlmf::round16(g4) : g4, rdep = Mma ? vmlmf::round16(r) : r;
  const int xld = Mma ? vmlmf::mma_xld(rpad) : rpad;

  W* wb = reinterpret_cast<W*>(smem);      // low-rank: V[k-slice, :]^T  [4h][kwp], rows < resb
  W* wc = wb + (size_t)mresb * kwp;        // U[j-slice, :]^T  [depth][jwp], rows < resc
  // dvec of the j-slice [jwm][4]
  float* dv = smem + vmlmf::weight_floats<W>((size_t)mresb * kwp + (size_t)mresc * jwp);
  // the streamed rows: V^T's past resb, then U^T's past resc
  const int ldb = vmlmf::ring_ld<W>(kwp), ldc = vmlmf::ring_ld<W>(jwp);  // their strides
  const size_t region = Mma ? bwd_mma_stream_floats(DenseRec, h, r, plan)
                            : bwd_stream_floats<W>(DenseRec, h, r, plan);
  W* sb = reinterpret_cast<W*>(wstream + blockIdx.x * region);
  W* sc = sb + (Mma ? (size_t)(DenseRec ? 0 : gdep - mresb) * kwp
                    : (size_t)(DenseRec ? 0 : g4 - resb) * ldb);
  float* dhc = dv + 4 * jwm;               // the carry dh, dc: [jwm][rpad]
  float* dcc = dhc + (size_t)jwm * rpad;
  float* stage = dcc + (size_t)jwm * rpad;
  float* red = stage + (Streamed ? vmlmf::ring_floats(plan) : plan.stage);  // stage: the ring
  float* pa = red + plan.red;              // phase A's inputs of the step [kInputs][jwm][rpad]
  const size_t dpx_par = (size_t)plan.groups * gdep * xld;
  X* dpx = reinterpret_cast<X*>(xchg) + (size_t)grp * gdep * xld;  // parity p at dpx + p * dpx_par
  X* dhux = reinterpret_cast<X*>(xchg) + 2 * dpx_par + (size_t)grp * rdep * xld;
  unsigned* count = sync + grp;
  unsigned target = 0;
  // an exchanged value, rounded to bf16 where the products take bf16
  auto put_x = [](X* at, float val) {
    if constexpr (Mma)
      *at = __float2bfloat16_rn(val);
    else
      *at = vmlmf::exchanged<Bf16>(val);
  };

  // the weight slices, transposed, loaded once along the rows of V and U
  // (coalesced reads), the resident rows into shared memory and the others
  // into the CTA's streamed region; columns past the slice are zero
  if constexpr (Mma) {  // in blocks of 16 rows, fragment order; rows past the depth zero
    if constexpr (!DenseRec) {
      for (int e = threadIdx.x; e < kwp * gdep; e += blockDim.x) {
        const int kk = e / gdep, n = e % gdep;
        const W val = vmlmf::to_elem<W>(kk < kw && n < g4 ? v[(size_t)(k0 + kk) * g4 + n] : 0.f);
        const size_t at = vmlmf::mma_at(n, kk, kwp);
        if (n < mresb)
          wb[at] = val;
        else
          sb[at - (size_t)mresb * kwp] = val;
      }
    }
    const int cdep = DenseRec ? gdep : rdep;
    for (int e = threadIdx.x; e < jwp * cdep; e += blockDim.x) {
      const int jj = e / cdep, k = e % cdep;
      const W val = vmlmf::to_elem<W>(jj < jw && k < depth ? u[(size_t)(j0 + jj) * depth + k]
                                                           : 0.f);
      const size_t at = vmlmf::mma_at(k, jj, jwp);
      if (k < mresc)
        wc[at] = val;
      else
        sc[at - (size_t)mresc * jwp] = val;
    }
    // the exchange rows past the depths, which the products read as zeros
    if (q == 0) {
      for (int e = threadIdx.x; e < (gdep - g4) * xld; e += blockDim.x) {
        dpx[(size_t)g4 * xld + e] = __float2bfloat16_rn(0.f);
        dpx[dpx_par + (size_t)g4 * xld + e] = __float2bfloat16_rn(0.f);
      }
      for (int e = threadIdx.x; e < (rdep - r) * xld; e += blockDim.x)
        dhux[(size_t)r * xld + e] = __float2bfloat16_rn(0.f);
    }
  } else {
    if constexpr (!DenseRec) {
#pragma unroll 4
      for (int e = threadIdx.x; e < kwp * g4; e += blockDim.x) {
        const int kk = e / g4, n = e % g4;
        const W val = vmlmf::to_elem<W>(kk < kw ? v[(size_t)(k0 + kk) * g4 + n] : 0.f);
        if constexpr (Streamed)
          vmlmf::slice_elem(wb, sb, resb, kwp, ldb, n, kk) = val;
        else
          wb[(size_t)n * kwp + kk] = val;
      }
    }
#pragma unroll 4
    for (int e = threadIdx.x; e < jwp * depth; e += blockDim.x) {
      const int jj = e / depth, k = e % depth;
      const W val = vmlmf::to_elem<W>(jj < jw ? u[(size_t)(j0 + jj) * depth + k] : 0.f);
      if constexpr (Streamed)
        vmlmf::slice_elem(wc, sc, resc, jwp, ldc, k, jj) = val;
      else
        wc[(size_t)k * jwp + jj] = val;
    }
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
  // the products' operands: (B) dpre @ V[k-slice, :]^T and (C) src @
  // U[j-slice, :]^T, src = dhu or (dense) dpre of parity p
  auto op_b = [&](const float* dpx_t) {
    return vmlmf::RingOperand<W>{dpx_t, wb, sb, g4, resb, kwp, round4(kw)};
  };
  auto op_c = [&](const float* dpx_t) {
    return vmlmf::RingOperand<W>{DenseRec ? dpx_t : reinterpret_cast<const float*>(dhux), wc, sc,
                                 depth, resc, jwp, round4(jw)};
  };
  auto mop_b = [&](const X* dpx_t) {
    return vmlmf::MmaOperand{reinterpret_cast<const bf16*>(dpx_t),
                             reinterpret_cast<const bf16*>(wb), reinterpret_cast<const bf16*>(sb),
                             g4, resb, kwp, round4(kw)};
  };
  auto mop_c = [&](const X* dpx_t) {
    return vmlmf::MmaOperand{reinterpret_cast<const bf16*>(DenseRec ? dpx_t : dhux),
                             reinterpret_cast<const bf16*>(wc), reinterpret_cast<const bf16*>(sc),
                             depth, resc, jwp, round4(jw)};
  };
  vmlmf::Ring ring;
  if constexpr (Streamed) {
    ring.start(stage, plan);
    if constexpr (Mma) {
      if (t_len > 0) ring.mma_preload(DenseRec ? mop_c(dpx) : mop_b(dpx));
    } else {
      if (t_len > 0)
        ring.preload(DenseRec ? op_c(reinterpret_cast<const float*>(dpx))
                              : op_b(reinterpret_cast<const float*>(dpx)));
    }
  }

  for (int t = t_len - 1; t >= 0; --t) {
    X* dpx_t = dpx + (t & 1) * dpx_par;
    const size_t m0 = (size_t)t * batch + b0;
    vmlmf::cp_async_wait_all();
    __syncthreads();  // pa, and the carry that phase C wrote

    // (A) dpre of the j-slice; the carry's dh becomes the dvec part of dh_prev
    for (int e = threadIdx.x; e < jw * rpad; e += blockDim.x) {
      const int jj = e % jw, row = e / jw, j = j0 + jj;
      const int at = jj * rpad + row;
      if (row >= rows) {
        for (int gg = 0; gg < 4; ++gg) put_x(dpx_t + (size_t)(gg * h + j) * xld + row, 0.f);
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
        put_x(dpx_t + (size_t)(k * h + j) * xld + row, p[k]);
        dhp = fmaf(p[k], dv[4 * jj + k], dhp);
      }
      dhc[at] = dhp;
    }
    vmlmf::group_sync(count, plan.ctas, target);
    if (t > 0) prefetch(t - 1);

    if (!DenseRec) {
      // (B) dhu[:, k-slice] = dpre @ V[k-slice, :]^T
      auto epi_b = [&](int cb, int rb, float (&acc)[4][4]) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kk = 4 * cb + c;
          if (kk >= kw) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = 4 * rb + i;
            put_x(dhux + (size_t)(k0 + kk) * xld + row, acc[c][i]);
            if (row < rows) dhu[(m0 + row) * r + k0 + kk] = acc[c][i];
          }
        }
      };
      if constexpr (Streamed) {
        if constexpr (Mma) {
          ring.mma_product(mop_b(dpx_t), red, epi_b);
          ring.mma_preload(mop_c(dpx_t));
        } else {
          ring.product(op_b(reinterpret_cast<const float*>(dpx_t)), red, epi_b);
          ring.preload(op_c(reinterpret_cast<const float*>(dpx_t)));
        }
      } else {
        vmlmf::slice_product(reinterpret_cast<const float*>(dpx_t), g4, rpad, wb, kwp, round4(kw),
                             stage, plan.stage, red, plan.red, epi_b);
      }
      vmlmf::group_sync(count, plan.ctas, target);
    }

    // (C) dh[:, j-slice] += src @ U[j-slice, :]^T, src = dhu or (dense) dpre
    auto epi_c = [&](int cb, int rb, float (&acc)[4][4]) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jj = 4 * cb + c;
        if (jj >= jw) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) dhc[jj * rpad + 4 * rb + i] += acc[c][i];
      }
    };
    if constexpr (Streamed) {
      if constexpr (Mma) {
        ring.mma_product(mop_c(dpx_t), red, epi_c);
        if (t > 0) {
          X* next = dpx + ((t - 1) & 1) * dpx_par;
          ring.mma_preload(DenseRec ? mop_c(next) : mop_b(next));
        }
      } else {
        ring.product(op_c(reinterpret_cast<const float*>(dpx_t)), red, epi_c);
        if (t > 0) {
          const float* next = reinterpret_cast<const float*>(dpx + ((t - 1) & 1) * dpx_par);
          ring.preload(DenseRec ? op_c(next) : op_b(next));
        }
      }
    } else {
      vmlmf::slice_product(reinterpret_cast<const float*>(DenseRec ? dpx_t : dhux), depth, rpad,
                           wc, jwp, round4(jw), stage, plan.stage, red, plan.red, epi_c);
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < jw * rows; e += blockDim.x) {
    const int jj = e % jw, row = e / jw;
    const size_t at = (size_t)(b0 + row) * h + j0 + jj;
    dh0[at] = dhc[jj * rpad + row];
    dc0[at] = dcc[jj * rpad + row];
  }
}

// Launches grid_bptt_kernel<DenseRec, Bf16, Streamed>, Streamed where the
// plan streams some weight row (and then has a ring whose stages hold a row
// of each product); returns the launch's error.
// The plan must hold at least the shared memory this kernel carves, and
// `wstream` (`wstream_floats` floats) its CTAs' streamed regions.
// The same for an mma plan (grid_bptt_kernel<DenseRec, true, true, true>,
// on the ring whether or not a row is streamed), with the checks of its
// layout: rows padded to 8, resident depths in whole blocks, the ring's
// stages holding a block of each product, `red` each product's sums.
template <bool DenseRec>
cudaError_t bptt_mma(void** args, float* wstream, size_t wstream_floats, int h, int r,
                     GridPlan plan, unsigned* sync, cudaStream_t stream) {
  const int depth = DenseRec ? 4 * h : r;
  const int jwp = round4(div_up(h, plan.ctas)), kwp = DenseRec ? 0 : round4(div_up(r, plan.ctas));
  if (!vmlmf::mma_plan_ok(plan) || !vmlmf::mma_resident_ok(plan.res_b, depth) ||
      (DenseRec ? plan.res_a != 0 : !vmlmf::mma_resident_ok(plan.res_a, 4 * h)) ||
      sizeof(float) * bwd_mma_smem_floats(DenseRec, h, r, plan) > (size_t)plan.smem ||
      plan.red < vmlmf::mma_red_floats(depth, jwp, plan.rpad) ||
      (!DenseRec && plan.red < vmlmf::mma_red_floats(4 * h, kwp, plan.rpad)))
    return cudaErrorInvalidValue;
  const size_t streamed = bwd_mma_stream_floats(DenseRec, h, r, plan);
  if (streamed * plan.groups * plan.ctas > wstream_floats || (streamed > 0 && wstream == nullptr) ||
      !vmlmf::ring_ok(plan) || !vmlmf::mma_ring_holds(plan, jwp) ||
      !vmlmf::mma_ring_holds(plan, kwp))
    return cudaErrorInvalidValue;
  return vmlmf::launch_grid(grid_bptt_kernel<DenseRec, true, true, true>, plan, sync, args,
                            stream, 0, vmlmf::kRingThreads);
}

template <bool DenseRec, bool Bf16>
cudaError_t bptt(const float* gates, const float* cs, const float* c0, const float* dys,
                 const float* dc_last, const float* u, const float* v, const float* dvec,
                 float* dpre, float* dhu, float* dh0, float* dc0, float* xchg, unsigned* sync,
                 float* wstream, size_t wstream_floats, int t_len, int batch, int h, int r,
                 GridPlan plan, cudaStream_t stream) {
  using W = std::conditional_t<Bf16, bf16, float>;
  if (plan.mma) {
    void* margs[] = {&gates, &cs, &c0, &dys, &dc_last, &u, &v, &dvec, &dpre, &dhu, &dh0, &dc0,
                     &xchg, &sync, &wstream, &t_len, &batch, &h, &r, &plan};
    if constexpr (Bf16)
      return bptt_mma<DenseRec>(margs, wstream, wstream_floats, h, r, plan, sync, stream);
    else
      return cudaErrorInvalidValue;
  }
  const int depth = DenseRec ? 4 * h : r;
  if (plan.res_b < 0 || plan.res_b > depth ||
      (DenseRec ? plan.res_a != 0 : plan.res_a < 0 || plan.res_a > 4 * h) ||
      sizeof(float) * bwd_smem_floats<W>(DenseRec, h, r, plan) > (size_t)plan.smem)
    return cudaErrorInvalidValue;
  const size_t streamed = bwd_stream_floats<W>(DenseRec, h, r, plan);
  if (streamed * plan.groups * plan.ctas > wstream_floats || (streamed > 0 && wstream == nullptr))
    return cudaErrorInvalidValue;
  const int jwp = round4(div_up(h, plan.ctas)), kwp = DenseRec ? 0 : round4(div_up(r, plan.ctas));
  if ((streamed > 0) != (plan.piece > 0) ||
      (streamed > 0 && !(vmlmf::ring_ok(plan) && vmlmf::ring_holds<W>(plan, jwp) &&
                         vmlmf::ring_holds<W>(plan, kwp))))
    return cudaErrorInvalidValue;
  void* args[] = {&gates, &cs, &c0, &dys, &dc_last, &u, &v, &dvec, &dpre, &dhu, &dh0, &dc0,
                  &xchg, &sync, &wstream, &t_len, &batch, &h, &r, &plan};
  return streamed > 0
             ? vmlmf::launch_grid(grid_bptt_kernel<DenseRec, Bf16, true>, plan, sync, args, stream,
                                  0, vmlmf::kRingThreads)
             : vmlmf::launch_grid(grid_bptt_kernel<DenseRec, Bf16, false>, plan, sync, args,
                                  stream);
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

// The tensors and sizes of one BPTT call. In gi mode x, ux, vx, xdvec,
// bias, xu, dx and the x side's gradients are null, and dpre is dgi. gates
// and hu are f32 or bf16 residuals, or null under the recompute policy;
// gates_w, hu_w and xu_w are f32 scratch for their widened or rebuilt
// copies (null where unused).
struct BwdIO {
  const float* x;
  const float* ux;
  const float* vx;
  const float* xdvec;
  const float* bias;
  const float* u;
  const float* v;
  const float* dvec;
  const float* h0;
  const float* c0;
  const float* ys;
  const float* cs;
  const void* gates;
  const void* hu;
  const float* xu;
  const float* dys;
  const float* dc_last;
  float* gates_w;
  float* hu_w;
  float* xu_w;
  float* dpre;
  float* dhu;
  float* dxu;
  float* dx;
  float* dux;
  float* dvx;
  float* dxdvec;
  float* dbias;
  float* du;
  float* dv;
  float* ddvec;
  float* dh0;
  float* dc0;
  float* xchg;
  unsigned* sync;
  float* partial;
  size_t room;
  float* wstream;
  size_t wstream_floats;
  float* stage;
  size_t stage_floats;
  int t_len, batch, f, rx, h, r;
};

// The recompute policy's pre-pass (pallas_scan.py:543-576), batched over
// all M rows on the tensor cores, operands rounded to bf16 when Bf16: xu =
// X @ Ux into xu_w; gi (the x term and bias in the epilogue) into gates_w;
// hu = Hprev @ U into hu_w; then pre = gi + hu @ V (dense: Hprev @ U) +
// Hprev * dvec and its gates, in place in gates_w. Returns the first error.
template <bool Bf16>
cudaError_t recompute(const BwdIO& io, vmlmf::tc::Staging& st, cudaStream_t stream) {
  using vmlmf::RowMajor;
  using vmlmf::tc::gemm;
  const int m = io.t_len * io.batch, g4 = 4 * io.h;
  const vmlmf::GiEpilogue gi_epi{io.gates_w, io.x, io.xdvec, io.bias, io.f, io.h};
  cudaError_t err;
  if (io.vx == nullptr) {
    err = gemm<Bf16>(st, RowMajor{io.x, io.f}, RowMajor{io.ux, g4}, gi_epi, m, g4, io.f, stream);
  } else {
    err = gemm<Bf16>(st, RowMajor{io.x, io.f}, RowMajor{io.ux, io.rx},
                     vmlmf::Store{io.xu_w, io.rx}, m, io.rx, io.f, stream);
    if (err != cudaSuccess) return err;
    err = gemm<Bf16>(st, RowMajor{io.xu_w, io.rx}, RowMajor{io.vx, g4}, gi_epi, m, g4, io.rx,
                     stream);
  }
  if (err != cudaSuccess) return err;
  const vmlmf::PrevRows hprev{io.h0, io.ys, io.batch, io.h};
  const vmlmf::GatesEpilogue gates_epi{io.gates_w, io.h0, io.ys, io.dvec, io.batch, io.h};
  if (io.v == nullptr)
    return gemm<Bf16>(st, hprev, RowMajor{io.u, g4}, gates_epi, m, g4, io.h, stream);
  err = vmlmf::tc::gemm_splitk<Bf16>(st, hprev, RowMajor{io.u, io.r},
                                     vmlmf::Store{io.hu_w, io.r}, m, io.r, io.h, io.partial,
                                     io.room, stream);
  if (err != cudaSuccess) return err;
  return gemm<Bf16>(st, RowMajor{io.hu_w, io.r}, RowMajor{io.v, g4}, gates_epi, m, g4, io.r,
                    stream);
}

// The whole BPTT: the residuals widened or rebuilt as the policy says, the
// serial walk, then the GEMMs and the column sums, operands rounded to bf16
// when Bf16; returns the first error.
template <bool Bf16>
cudaError_t bwd(const BwdIO& io, int policy, GridPlan plan, cudaStream_t stream) {
  using vmlmf::RowMajor;
  using vmlmf::Store;
  using vmlmf::Transposed;
  using vmlmf::tc::gemm_splitk;
  const int m = io.t_len * io.batch, g4 = 4 * io.h, f = io.f, rx = io.rx, r = io.r;
  const float* gates = static_cast<const float*>(io.gates);
  const float* hu = static_cast<const float*>(io.hu);
  const float* xu = io.xu;
  vmlmf::tc::Staging st(io.stage, io.stage_floats);
  cudaError_t err = cudaSuccess;
  if (policy == kPolicyBf16) {  // bf16 residuals, read widened
    err = vmlmf::widen(io.gates, io.gates_w, (size_t)m * g4, stream);
    if (err == cudaSuccess && io.v != nullptr)
      err = vmlmf::widen(io.hu, io.hu_w, (size_t)m * r, stream);
    gates = io.gates_w;
    hu = io.hu_w;
  } else if (policy == kPolicyNone) {
    if (io.x == nullptr) return cudaErrorInvalidValue;  // recompute is x mode only
    err = recompute<Bf16>(io, st, stream);
    gates = io.gates_w;
    hu = io.hu_w;
    xu = io.xu_w;
  } else if (policy != kPolicyF32) {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  const vmlmf::PrevRowsT hprev_t{io.h0, io.ys, io.batch, io.h};
  if (io.v == nullptr) {
    err = bptt<true, Bf16>(gates, io.cs, io.c0, io.dys, io.dc_last, io.u, io.v, io.dvec, io.dpre,
                           io.dhu, io.dh0, io.dc0, io.xchg, io.sync, io.wstream,
                           io.wstream_floats, io.t_len, io.batch, io.h, r, plan, stream);
    if (err != cudaSuccess) return err;
    // dU [h, 4h] = Hprev^T dPre
    err = gemm_splitk<Bf16>(st, hprev_t, RowMajor{io.dpre, g4}, Store{io.du, g4}, io.h, g4, m,
                            io.partial, io.room, stream);
  } else {
    err = bptt<false, Bf16>(gates, io.cs, io.c0, io.dys, io.dc_last, io.u, io.v, io.dvec, io.dpre,
                            io.dhu, io.dh0, io.dc0, io.xchg, io.sync, io.wstream,
                            io.wstream_floats, io.t_len, io.batch, io.h, r, plan, stream);
    if (err != cudaSuccess) return err;
    // dV [r, 4h] = HU^T dPre;  dU [h, r] = Hprev^T dHU
    err = gemm_splitk<Bf16>(st, Transposed{hu, r}, RowMajor{io.dpre, g4}, Store{io.dv, g4}, r,
                            g4, m, io.partial, io.room, stream);
    if (err != cudaSuccess) return err;
    err = gemm_splitk<Bf16>(st, hprev_t, RowMajor{io.dhu, r}, Store{io.du, r}, io.h, r, m,
                            io.partial, io.room, stream);
  }
  if (err != cudaSuccess) return err;

  if (io.x != nullptr) {  // x mode: the x side's gradients
    const DxEpilogue dx_epi{io.dx, io.dpre, io.xdvec, f, io.h};
    if (io.vx == nullptr) {
      // dx [M, F] = dPre Ux^T + fit(sum_g dPre_g xdvec_g);  dUx [F, 4h] = X^T dPre
      err = gemm_splitk<Bf16>(st, RowMajor{io.dpre, g4}, Transposed{io.ux, g4}, dx_epi, m, f, g4,
                              io.partial, io.room, stream);
      if (err != cudaSuccess) return err;
      err = gemm_splitk<Bf16>(st, Transposed{io.x, f}, RowMajor{io.dpre, g4}, Store{io.dux, g4},
                              f, g4, m, io.partial, io.room, stream);
    } else {
      // dXU [M, rx] = dPre Vx^T;  dx [M, F] = dXU Ux^T + fit(sum_g dPre_g xdvec_g)
      err = gemm_splitk<Bf16>(st, RowMajor{io.dpre, g4}, Transposed{io.vx, g4},
                              Store{io.dxu, rx}, m, rx, g4, io.partial, io.room, stream);
      if (err != cudaSuccess) return err;
      err = vmlmf::tc::gemm<Bf16>(st, RowMajor{io.dxu, rx}, Transposed{io.ux, rx}, dx_epi, m, f, rx,
                                  stream);
      if (err != cudaSuccess) return err;
      // dUx [F, rx] = X^T dXU;  dVx [rx, 4h] = XU^T dPre
      err = gemm_splitk<Bf16>(st, Transposed{io.x, f}, RowMajor{io.dxu, rx}, Store{io.dux, rx},
                              f, rx, m, io.partial, io.room, stream);
      if (err != cudaSuccess) return err;
      err = gemm_splitk<Bf16>(st, Transposed{xu, rx}, RowMajor{io.dpre, g4}, Store{io.dvx, g4},
                              rx, g4, m, io.partial, io.room, stream);
    }
    if (err != cudaSuccess) return err;
  }

  // ddvec, and in x mode dxdvec and dbias, from the f32 dpre
  vmlmf::colsum_kernel<<<cdiv(g4, vmlmf::kSumCols), vmlmf::kSumCols * vmlmf::kSumLanes, 0,
                         stream>>>(io.dpre, io.h0, io.ys, RowMajor{io.x, f}, io.ddvec, io.dxdvec,
                                   io.dbias, m, io.batch, f, io.h);
  return cudaGetLastError();
}

}  // namespace

// x mode: launches the residuals' widening or rebuilding, the serial kernel,
// the GEMMs and the column sums on `stream`; returns the first error. dys
// and dc_last may be null (zeros). gates and hu are the residual forward's
// (f32 for policy 0, bf16 for 1, null for 2, the recompute policy, which
// also takes bias and no xu). gates_w [T*B, 4h], hu_w [T*B, r] and xu_w
// [T*B, rx] are f32 scratch for policies 1 and 2 (xu_w for 2 only), null
// otherwise; dpre [T*B, 4h], dhu [T*B, r] and dxu [T*B, rx] are scratch
// too (dhu null for a dense recurrent side, dxu for a dense x side), as
// are xchg and sync (scan_plan sizes them), partial, partial_floats
// floats for the split-k partial sums (bwd_partial_floats), wstream,
// wstream_floats floats of streamed weights (stream_floats; null where the
// plan streams nothing), and tc_stage, stage_floats floats for the
// products' staged operands (tc_stage_floats); every other pointer after
// dpre is an output (dv and dvx null with dhu and dxu). The ten integers after r are
// scan_plan's layout (ScanPlan.ints; the last, mma, 1 for a plan whose
// bf16 products run on the tensor cores); bf16_mm 1 rounds every product's
// operands to bf16.
extern "C" int lstm_scan_xin_bwd(
    const float* x, const float* ux, const float* vx, const float* xdvec, const float* bias,
    const float* u, const float* v, const float* dvec, const float* h0, const float* c0,
    const float* ys, const float* cs, const void* gates, const void* hu, const float* xu,
    const float* dys, const float* dc_last, float* gates_w, float* hu_w, float* xu_w,
    float* dpre, float* dhu, float* dxu, float* dx, float* dux, float* dvx, float* dxdvec,
    float* dbias, float* du, float* dv, float* ddvec, float* dh0, float* dc0, float* xchg,
    unsigned* sync, float* partial, float* wstream, float* tc_stage, int partial_floats,
    int wstream_floats, int stage_floats, int t_len, int batch, int f, int rx, int h, int r,
    int groups, int ctas, int rpad, int stage, int red, int smem, int res_a, int res_b, int piece,
    int mma, int bf16_mm, int policy, void* stream_handle) {
  const BwdIO io{x, ux, vx, xdvec, bias, u, v, dvec, h0, c0, ys, cs, gates, hu, xu, dys,
                 dc_last, gates_w, hu_w, xu_w, dpre, dhu, dxu, dx, dux, dvx, dxdvec, dbias, du,
                 dv, ddvec, dh0, dc0, xchg, sync, partial, static_cast<size_t>(partial_floats),
                 wstream, static_cast<size_t>(wstream_floats), tc_stage,
                 static_cast<size_t>(stage_floats), t_len, batch, f, rx, h, r};
  const GridPlan plan{groups, ctas, rpad, stage, red, smem, res_a, res_b, piece, mma};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  return bf16_mm ? bwd<true>(io, policy, plan, stream) : bwd<false>(io, policy, plan, stream);
}

// gi mode (pallas_scan.py::_scan_core_bwd): the walk, whose dpre is dgi
// [T*B, 4h], then dU, dV and ddvec; no x side. policy 0 or 1 (f32 or bf16
// gates and hu; gates_w and hu_w scratch for 1); the rest, wstream and
// tc_stage too, as in lstm_scan_xin_bwd.
extern "C" int lstm_scan_bwd(
    const float* u, const float* v, const float* dvec, const float* h0, const float* c0,
    const float* ys, const float* cs, const void* gates, const void* hu, const float* dys,
    const float* dc_last, float* gates_w, float* hu_w, float* dgi, float* dhu, float* du,
    float* dv, float* ddvec, float* dh0, float* dc0, float* xchg, unsigned* sync,
    float* partial, float* wstream, float* tc_stage, int partial_floats, int wstream_floats,
    int stage_floats, int t_len, int batch, int h, int r, int groups, int ctas, int rpad,
    int stage, int red, int smem, int res_a, int res_b, int piece, int mma, int bf16_mm,
    int policy, void* stream_handle) {
  if (policy == kPolicyNone) return cudaErrorInvalidValue;
  const BwdIO io{nullptr, nullptr, nullptr, nullptr, nullptr, u, v, dvec, h0, c0, ys, cs, gates,
                 hu, nullptr, dys, dc_last, gates_w, hu_w, nullptr, dgi, dhu, nullptr, nullptr,
                 nullptr, nullptr, nullptr, nullptr, du, dv, ddvec, dh0, dc0, xchg, sync, partial,
                 static_cast<size_t>(partial_floats), wstream,
                 static_cast<size_t>(wstream_floats), tc_stage,
                 static_cast<size_t>(stage_floats), t_len, batch, 1, 0, h, r};
  const GridPlan plan{groups, ctas, rpad, stage, red, smem, res_a, res_b, piece, mma};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  return bf16_mm ? bwd<true>(io, policy, plan, stream) : bwd<false>(io, policy, plan, stream);
}

// The message of an error code that an entry of this file returned.
extern "C" const char* lstm_scan_xin_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
