// Backward of the wavefront LSTM stack, for sm_90a: the reverse walk of all
// layers in one cooperative launch, then the weight gradients, with f32 or
// bf16 products.
//
// Replaces vmlmf_tpu/ops/pallas_pipeline.py::_mlbwd_kernel, bf16=False and
// bf16=True. From the residuals of the forward (lstm_stack_fwd.cu, residual
// form: every layer's ys, cs, gates, hu and, for l > 0, xu) and the
// cotangents dys [T,B,h] of the top layer's outputs and dhlast, dclast [B,h]
// per layer, any of which may be absent (zeros), it computes per layer, from
// the top, walking t = T-1 .. 0 with the carry (dh, dc) = (dhlast, dclast)
// at the start, dy = dys for the top layer and the dy that the layer above
// hands down otherwise:
//
//   dh += dy[t];  tc = tanh(cs[t]);  (i, f, g, o) = gates[t]
//   dc += dh * o * (1 - tc^2)
//   dpre = [dc*g*i*(1-i), dc*c_prev*f*(1-f), dc*i*(1-g^2), dh*tc*o*(1-o)];  dc *= f
//   dhu = dpre @ V^T;  dh = sum_g dpre_g * dvec_g + dhu @ U^T
//   for l > 0:  dxu = dpre @ Vx^T;  dx = dxu @ Ux^T + sum_g dpre_g * dxvec_g;
//               dy_{l-1}[t] = dx * mask_l[t]
//
// then (dh0, dc0) = (dh, dc), and over all M = T*B rows, with x = ys_{l-1} *
// mask_l and Hprev row (t, b) = h0[b] at t = 0 and ys[t-1, b] after:
//
//   dU = Hprev^T dHU,  dV = HU^T dPre,  ddvec = sum_m dPre * tile4(Hprev);
//   for l > 0:  dUx = X^T dXU,  dVx = XU^T dPre,  ddxvec = sum_m dPre * tile4(X),
//               dbias = sum_m dPre.
//
// Layer 0's dpre is dgi0, the cotangent of gi0; its x side goes back through
// the caller's autograd of Cell.inp.
//
// The bf16 form rounds the operands of every product to bf16 where the TPU
// kernel's _cast rounds them (dpre, dhu, dxu, h_prev, hu, x, xu; the
// weights) and sums in f32; the dvec and dxvec terms, the column sums and
// every gradient stay f32. The walk holds its weight slices as bf16 in
// shared memory, and the CTA that writes dpre, dhu or dxu to an exchange
// rounds it (scan_grid.cuh); the weight gradients round their operands as
// gemm_tc.cuh's bf16 tiles stage or read them.
//
// What bounds it on an H100, and what the design does about it:
// * The TPU kernel runs its grid in order and sums dU, dV, ... in VMEM
//   across grid steps. Here the work is split in two:
//   1. stack_bwd_kernel, the serial part, on the layout of the forward
//      (ops/cuda_stack.py::stack_plan): batch groups, and in each a set of
//      co-resident CTAs per layer that hold the layer's slices of V^T or
//      Vx^T (a k- or kx-slice, all 4h rows; scan_grid.cuh RankSlices) and
//      of U^T and Ux^T (the j-slice) in shared memory for the whole walk.
//      A step of layer l on CTA q, two barriers of the layer a step
//      (lstm_scan_xin_bwd.cu):
//      (A, j-slice) dpre of the j-slice from the carry, the saved gates, cs,
//      c_prev and dy, into dpre [T*B, 4h] and the layer's dpre exchange; the
//      dvec part of the next dh and, l > 0, the dxvec part of dx; barrier;
//      (B, k- or kx-slice) [dhu | dxu] = dpre @ [V^T | Vx^T] into dhu
//      [T*B, r], dxu [T*B, rx] and the layer's [dhu | dxu] exchange;
//      barrier; (C, j-slice) dh += dhu @ U^T and, l > 0, dy_{l-1}[t] =
//      (dxu @ Ux^T + the dxvec part) * mask_l into the handoff buffer of the
//      layer below. C runs on the CTA that owns the next step's A, so it
//      needs no barrier of its own; the next step's first barrier (or one
//      after the last step) publishes it. The layer below waits for that
//      round of arrivals on the layer's barrier word before its step t
//      (acquire loads, with the barrier's 4 s timeout): the chain is T + L
//      - 1 steps. The handoff buffer holds every step ([T][h][rpad] per
//      group), so the layer above may run ahead. The launch is cooperative:
//      waiting across CTAs needs them co-resident.
//      Each CTA reads its group's whole dpre (4h floats a row) and [dhu |
//      dxu] from L2 a step, with 16-byte cp.async.cg, never __ldg. Phase
//      A's saved inputs of the next step (gates, cs, c_prev, and the top
//      layer's dys) are copied with cp.async while phases B and C run;
//      the handed-down dy once the layer above has published it.
//   2. Once the walk ends, the weight gradients of every layer run over
//      all M rows on the tensor cores (gemm_tc.cuh, as the single-layer
//      BPTT's do: f32 as 3xTF32, bf16 as bf16 products with f32 sums), then
//      one column-sum kernel. f32 on the CUDA cores peaks at 67 TFLOP/s,
//      and these products are most of the BPTT's operations. tc_plan picks
//      the tile by shape: the Hopper tile (wgmma fed by TMA from operands
//      staged once a layer) for products of 2^28 multiply-adds or more with
//      m, n, k >= 128 (all four at the LM stack's B=128, dV and dVx at
//      B=20), the Ampere tile (mma.sync) for the others (all at B=1). Their
//      outputs have few tiles (dU [650, 300]) and their k is M, so k is cut
//      into slices whose partial sums are added in a fixed order: no
//      atomics. dpre, dhu and dxu are kept [T*B, ...] for them; the masked
//      input X = ys_{l-1} * mask_l of a layer l > 0 is written once into the
//      staging scratch, as neither tile multiplies as it loads. Each layer
//      stages from the scratch's start, so the scratch is one layer's.
//   Every sum is taken in a fixed order: two calls give the same bits.
// * Every edge (B, h, r, rx not multiples of the slices, rows past a
//   group's batch rows) is masked. A batch too large for one plan runs its
//   walk in chunks of rows, one launch each (cuda_stack.py::stack_chunks),
//   and the weight gradients once, after the last.

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
using vmlmf::weight_floats;

constexpr int kMaxLayers = 8;  // the depth of the layer table; MAX_LAYERS in cuda_stack.py
constexpr int kPtrs = 32;      // pointers per layer in the entry's table
constexpr int kInts = 3;       // integers per layer: r, rx, ctas
// Phase A's inputs per unit and row: the four gates, cs[t], c_prev, dy[t]
constexpr int kInputs = 7;

// One layer's residuals, outputs and exchange buffers, in the order of the
// entry's pointer table (BWD_FIELDS in cuda_stack.py). Layer 0 has no x
// side and no mask; its dpre is dgi0. dhlast, dclast and dys may be null.
struct Layer {
  const float* u;       // [h, r]
  const float* v;       // [r, 4h]
  const float* dvec;    // [4h]
  const float* ux;      // [h, rx]
  const float* vx;      // [rx, 4h]
  const float* dxvec;   // [4h]
  const float* mask;    // [T, B, h]: the mask of this layer's input, or null
  const float* h0;      // [B, h]
  const float* c0;
  const float* ys;      // [T, B, h]
  const float* cs;
  const float* gates;   // [T, B, 4h]
  const float* hu;      // [T, B, r]
  const float* xu;      // [T, B, rx]
  const float* dys;     // [T, B, h]: the top layer's cotangent (null: zeros or not the top)
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
  float* dh0;           // [B, h]
  float* dc0;
  float* dpx;           // [groups][4h][rpad]: dpre of the step, as the products read it
  float* px;            // [groups][r + rx][rpad]: dhu of the step, then dxu
  float* dyx;           // [groups][T][h][rpad]: the cotangent of ys, from the layer above
  int r, rx, ctas;
};

struct Stack {
  Layer layer[kMaxLayers];
  unsigned* sync;       // [L][groups]: each layer's barrier word per group
  int n_layers, t_len, batch, h;
  int b_begin, b_count;  // the batch rows of this walk: [b_begin, b_begin + b_count)
};

// Floats of the shared memory of a CTA of a layer with ranks (r, rx) over
// `ctas` CTAs, in the order of the carve below: the weight slices (of type
// W), dvec and dxvec of the j-slice, the (dh, dc) carry, stage, red, phase
// A's inputs of the step and, l > 0, the dxvec part of dx.
template <class W>
__host__ __device__ inline size_t bwd_smem_floats(int h, int r, int rx, int ctas,
                                                  const GridPlan& p) {
  const int jwm = div_up(h, ctas), jwp = round4(jwm);
  const vmlmf::RankSlices ks(0, ctas, r, rx);
  const int kcols = ks.packed ? ks.kwp + ks.kxwp : ks.kwp > ks.kxwp ? ks.kwp : ks.kxwp;
  return weight_floats<W>((size_t)4 * h * kcols) + weight_floats<W>((size_t)r * jwp) +
         weight_floats<W>((size_t)rx * jwp) + 8 * jwm +
         (size_t)(2 + kInputs + (rx ? 1 : 0)) * jwm * p.rpad + p.stage + p.red;
}

// The reverse walk of the whole stack on plan.groups x plan.ctas
// co-resident CTAs (plan.ctas: a group's CTAs over all layers, layer 0's
// first).
template <bool Bf16>
__global__ void __launch_bounds__(vmlmf::kGridThreads, 1)
stack_bwd_kernel(const Stack st, const GridPlan plan) {
  using W = std::conditional_t<Bf16, bf16, float>;  // weight slices
  extern __shared__ __align__(16) float smem[];
  const int h = st.h, g4 = 4 * h, rpad = plan.rpad, batch = st.batch, t_len = st.t_len;
  const int grp = blockIdx.x / plan.ctas;
  int q = blockIdx.x % plan.ctas, l = 0;
  while (q >= st.layer[l].ctas) q -= st.layer[l++].ctas;
  const Layer ly = st.layer[l];
  const bool top = l == st.n_layers - 1;
  const int r = ly.r, rx = ly.rx, ctas = ly.ctas;
  const int b0 = st.b_begin + split_at(grp, st.b_count, plan.groups);
  const int rows = st.b_begin + split_at(grp + 1, st.b_count, plan.groups) - b0;
  const int j0 = split_at(q, h, ctas), jw = split_at(q + 1, h, ctas) - j0;
  const vmlmf::RankSlices ks(q, ctas, r, rx);
  const int k0 = ks.k0, kw = ks.kw, kx0 = ks.kx0, kxw = ks.kxw, kwp = ks.kr;
  const int kcols = ks.kr + ks.kxr;  // kwp rank columns, then the x rank columns
  const int jwm = div_up(h, ctas), jwp = round4(jwm);
  const int wcols = ks.packed ? ks.kwp + ks.kxwp : ks.kwp > ks.kxwp ? ks.kwp : ks.kxwp;

  // [V[k-slice, :]^T | Vx[kx-slice, :]^T]  [4h][kcols]: one of the two on a
  // CTA of a layer l > 0 (RankSlices), both on its only CTA; the region
  // fits either; then U[j-slice, :]^T [r][jwp] and Ux[j-slice, :]^T [rx][jwp]
  W* wb = reinterpret_cast<W*>(smem);
  W* wc = reinterpret_cast<W*>(smem + weight_floats<W>((size_t)g4 * wcols));
  W* wcx = reinterpret_cast<W*>(reinterpret_cast<float*>(wc) + weight_floats<W>((size_t)r * jwp));
  float* dv = reinterpret_cast<float*>(wcx) + weight_floats<W>((size_t)rx * jwp);  // [jwm][4]
  float* dxv = dv + 4 * jwm;
  float* dhc = dxv + 4 * jwm;               // the carry dh, dc: [jwm][rpad]
  float* dcc = dhc + (size_t)jwm * rpad;
  float* stage = dcc + (size_t)jwm * rpad;
  float* red = stage + plan.stage;
  float* pa = red + plan.red;               // phase A's inputs of the step [kInputs][jwm][rpad]
  const int slab = jwm * rpad;
  float* dxd = pa + kInputs * slab;         // l > 0: sum_g dpre_g * dxvec_g [jwm][rpad]

  const size_t yslab = (size_t)t_len * h * rpad;  // one group's region of a handoff buffer
  float* dpx = ly.dpx + (size_t)grp * g4 * rpad;
  float* px = ly.px + (size_t)grp * (r + rx) * rpad;
  const float* dyx = top ? nullptr : ly.dyx + grp * yslab;
  float* below = l ? st.layer[l - 1].dyx + grp * yslab : nullptr;  // written in phase C
  unsigned* count = st.sync + l * plan.groups + grp;
  const unsigned* above = top ? nullptr : st.sync + (l + 1) * plan.groups + grp;
  const unsigned above_ctas = top ? 0 : st.layer[l + 1].ctas;
  const bool has_dy = !top || ly.dys != nullptr;
  unsigned target = 0;

  // the weight slices, transposed, loaded once along the rows of V, Vx, U
  // and Ux (coalesced reads); columns past a slice are zero
#pragma unroll 4
  for (int e = threadIdx.x; e < kcols * g4; e += blockDim.x) {
    const int kk = e / g4, n = e % g4;
    float w = 0.f;
    if (kk < kwp) {
      if (kk < kw) w = ly.v[(size_t)(k0 + kk) * g4 + n];
    } else if (kk - kwp < kxw) {
      w = ly.vx[(size_t)(kx0 + kk - kwp) * g4 + n];
    }
    wb[(size_t)n * kcols + kk] = vmlmf::to_elem<W>(w);
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < jwp * r; e += blockDim.x) {
    const int jj = e / r, k = e % r;
    wc[(size_t)k * jwp + jj] = vmlmf::to_elem<W>(jj < jw ? ly.u[(size_t)(j0 + jj) * r + k] : 0.f);
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < jwp * rx; e += blockDim.x) {
    const int jj = e / rx, k = e % rx;
    wcx[(size_t)k * jwp + jj] =
        vmlmf::to_elem<W>(jj < jw ? ly.ux[(size_t)(j0 + jj) * rx + k] : 0.f);
  }
  for (int e = threadIdx.x; e < 4 * jwm; e += blockDim.x) {
    const bool live = e / 4 < jw;
    const int at = (e % 4) * h + j0 + e / 4;
    dv[e] = live ? ly.dvec[at] : 0.f;
    dxv[e] = live && l ? ly.dxvec[at] : 0.f;
  }
  for (int e = threadIdx.x; e < slab; e += blockDim.x) {
    const int jj = e / rpad, row = e % rpad;
    const bool live = jj < jw && row < rows;
    const size_t at = (size_t)(b0 + row) * h + j0 + jj;
    dhc[e] = live && ly.dhlast != nullptr ? ly.dhlast[at] : 0.f;
    dcc[e] = live && ly.dclast != nullptr ? ly.dclast[at] : 0.f;
  }

  // phase A's saved inputs of step t into pa, copied while the CTA works on
  // the step before it: gates, cs[t], c_prev (cs[t-1] or c0), and the top
  // layer's dys[t]
  auto prefetch = [&](int t) {
    const size_t m0 = (size_t)t * batch + b0;
    const int n = jw * rows, kinds = top && ly.dys != nullptr ? kInputs : kInputs - 1;
    for (int e = threadIdx.x; e < kinds * n; e += blockDim.x) {
      const int k = e / n, jj = e % jw, row = (e % n) / jw, j = j0 + jj;
      const size_t m = m0 + row;
      const float* src = k < 4    ? ly.gates + m * g4 + k * h + j
                         : k == 4 ? ly.cs + m * h + j
                         : k == 6 ? ly.dys + m * h + j
                         : t > 0  ? ly.cs + (m - batch) * h + j
                                  : ly.c0 + (size_t)(b0 + row) * h + j;
      vmlmf::cp_async4(pa + k * slab + jj * rpad + row, src);
    }
  };
  prefetch(t_len - 1);

  for (int t = t_len - 1; t >= 0; --t) {
    const size_t m0 = (size_t)t * batch + b0;
    if (!top) {
      // the layer above hands dy[t] down in phase C of its step t, which its
      // word publishes after 2s + 3 rounds of arrivals, s = T-1-t
      vmlmf::wait_count(above, above_ctas * (2u * (t_len - 1 - t) + 3u));
      const float4* src = reinterpret_cast<const float4*>(dyx + ((size_t)t * h + j0) * rpad);
      float4* dst = reinterpret_cast<float4*>(pa + 6 * slab);
      for (int i = threadIdx.x; i < jw * rpad / 4; i += blockDim.x) vmlmf::cp_async16_cg(dst + i, src + i);
    }
    vmlmf::cp_async_wait_all();
    __syncthreads();  // pa, and the carry that phase C wrote

    // (A) dpre of the j-slice; the carry's dh becomes the dvec part of
    // dh_prev, and dxd the dxvec part of dx
    for (int e = threadIdx.x; e < jw * rpad; e += blockDim.x) {
      const int jj = e % jw, row = e / jw, j = j0 + jj;
      const int at = jj * rpad + row;
      if (row >= rows) {
        for (int gg = 0; gg < 4; ++gg) dpx[(size_t)(gg * h + j) * rpad + row] = 0.f;
        continue;
      }
      const size_t m = m0 + row;
      const float gi = pa[at], gf = pa[slab + at], gg = pa[2 * slab + at];
      const float go = pa[3 * slab + at], c_prev = pa[5 * slab + at];
      const float dh = dhc[at] + (has_dy ? pa[6 * slab + at] : 0.f);
      const float tc = tanhf(pa[4 * slab + at]);
      const float dc = dcc[at] + dh * go * (1.f - tc * tc);
      dcc[at] = dc * gf;
      const float p[4] = {dc * gg * gi * (1.f - gi), dc * c_prev * gf * (1.f - gf),
                          dc * gi * (1.f - gg * gg), dh * tc * go * (1.f - go)};
      float dhp = 0.f, dxp = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ly.dpre[m * g4 + k * h + j] = p[k];
        dpx[(size_t)(k * h + j) * rpad + row] = vmlmf::exchanged<Bf16>(p[k]);
        dhp = fmaf(p[k], dv[4 * jj + k], dhp);
        dxp = fmaf(p[k], dxv[4 * jj + k], dxp);
      }
      dhc[at] = dhp;
      if (l) dxd[at] = dxp;
    }
    vmlmf::group_sync(count, ctas, target, true);
    if (t > 0) prefetch(t - 1);

    // (B) [dhu | dxu] of the k- and kx-slices = dpre @ [V^T | Vx^T]: columns
    // below kwp are rank columns k0 + c, the rest x rank columns kx0 + c - kwp
    vmlmf::slice_product(dpx, g4, rpad, wb, kcols, kcols, stage, plan.stage, red, plan.red,
                         [&](int cb, int rb, float (&acc)[4][4]) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 4 * cb + c;
        const bool xside = col >= kwp;
        const int kk = xside ? col - kwp : col;
        if (kk >= (xside ? kxw : kw)) continue;
        const int unit = xside ? r + kx0 + kk : k0 + kk;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 4 * rb + i;
          px[(size_t)unit * rpad + row] = vmlmf::exchanged<Bf16>(acc[c][i]);
          if (row < rows) {
            if (xside)
              ly.dxu[(m0 + row) * rx + kx0 + kk] = acc[c][i];
            else
              ly.dhu[(m0 + row) * r + k0 + kk] = acc[c][i];
          }
        }
      }
    });
    vmlmf::group_sync(count, ctas, target, true);

    // (C) dh[:, j-slice] += dhu @ U[j-slice, :]^T; for l > 0, dy_{l-1}[t] of
    // the j-slice = (dxu @ Ux[j-slice, :]^T + dxd) * mask_l
    vmlmf::slice_product(px, r, rpad, wc, jwp, round4(jw), stage, plan.stage, red, plan.red,
                         [&](int cb, int rb, float (&acc)[4][4]) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jj = 4 * cb + c;
        if (jj >= jw) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) dhc[jj * rpad + 4 * rb + i] += acc[c][i];
      }
    });
    if (l)
      vmlmf::slice_product(px + (size_t)r * rpad, rx, rpad, wcx, jwp, round4(jw), stage,
                           plan.stage, red, plan.red, [&](int cb, int rb, float (&acc)[4][4]) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int jj = 4 * cb + c;
          if (jj >= jw) continue;
          const int j = j0 + jj;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = 4 * rb + i;
            float dx = 0.f;
            if (row < rows) {
              const size_t e = (m0 + row) * h + j;
              dx = acc[c][i] + dxd[jj * rpad + row];
              if (ly.mask != nullptr) dx *= ly.mask[e];
            }
            below[((size_t)t * h + j) * rpad + row] = dx;
          }
        }
      });
  }
  // publishes the last step's dy to the layer below
  vmlmf::group_sync(count, ctas, target, true);

  for (int e = threadIdx.x; e < jw * rows; e += blockDim.x) {
    const int jj = e % jw, row = e / jw;
    const size_t at = (size_t)(b0 + row) * h + j0 + jj;
    ly.dh0[at] = dhc[jj * rpad + row];
    ly.dc0[at] = dcc[jj * rpad + row];
  }
}

// The weight gradients of one layer over all m rows, once the walk has
// ended, on gemm_tc.cuh's tensor-core tiles (3xTF32, or bf16 operands with
// f32 sums), their staged copies carved from the start of `stage` (the
// layer before is done with its copies: one stream orders them). Returns
// the first error.
template <bool Bf16>
cudaError_t weight_grads(const Stack& st, int l, int m, vmlmf::tc::Staging& stage, float* partial,
                         size_t room, cudaStream_t stream) {
  using vmlmf::RowMajor;
  using vmlmf::Store;
  using vmlmf::Transposed;
  using vmlmf::tc::gemm_splitk;
  const Layer& ly = st.layer[l];
  const int h = st.h, g4 = 4 * h;
  stage.reset();
  cudaError_t err = cudaSuccess;
  // for l > 0 the layer's input X = ys_{l-1} * mask_l, written once into
  // the scratch (one f32 rounding, the value MaskedRows reads in place), so
  // that both tiles read it as a plain view; without a mask, ys_{l-1}
  const float* y = l > 0 ? st.layer[l - 1].ys : nullptr;
  const float* x = y;
  if (l > 0 && ly.mask != nullptr) {
    x = stage.masked(y, ly.mask, (size_t)m * h, stream, err);
    if (err != cudaSuccess) return err;
  }
  // dV [r, 4h] = HU^T dPre;  dU [h, r] = Hprev^T dHU
  err = gemm_splitk<Bf16>(stage, Transposed{ly.hu, ly.r}, RowMajor{ly.dpre, g4},
                          Store{ly.dv, g4}, ly.r, g4, m, partial, room, stream);
  if (err != cudaSuccess) return err;
  err = gemm_splitk<Bf16>(stage, vmlmf::PrevRowsT{ly.h0, ly.ys, st.batch, h},
                          RowMajor{ly.dhu, ly.r}, Store{ly.du, ly.r}, h, ly.r, m, partial, room,
                          stream);
  if (err != cudaSuccess) return err;
  if (l > 0) {
    // dUx [h, rx] = X^T dXU;  dVx [rx, 4h] = XU^T dPre
    err = gemm_splitk<Bf16>(stage, Transposed{x, h}, RowMajor{ly.dxu, ly.rx},
                            Store{ly.dux, ly.rx}, h, ly.rx, m, partial, room, stream);
    if (err != cudaSuccess) return err;
    err = gemm_splitk<Bf16>(stage, Transposed{ly.xu, ly.rx}, RowMajor{ly.dpre, g4},
                            Store{ly.dvx, g4}, ly.rx, g4, m, partial, room, stream);
    if (err != cudaSuccess) return err;
  }
  // ddvec, and for l > 0 ddxvec and dbias (null for layer 0)
  vmlmf::colsum_kernel<<<cdiv(g4, vmlmf::kSumCols), vmlmf::kSumCols * vmlmf::kSumLanes, 0,
                         stream>>>(ly.dpre, ly.h0, ly.ys, vmlmf::MaskedRows{y, ly.mask, h},
                                   ly.ddvec, ly.ddxvec, ly.dbias, m, st.batch, h, h);
  return cudaGetLastError();
}

// The walk, then, with `grads`, the weight gradients of every layer over
// all T*B rows. The plan must hold at least the shared memory that every
// layer's CTAs carve. Returns the first error.
template <bool Bf16>
cudaError_t bwd(const Stack& st, GridPlan plan, bool grads, float* partial, size_t room,
                vmlmf::tc::Staging& stage, cudaStream_t stream) {
  using W = std::conditional_t<Bf16, bf16, float>;
  for (int l = 0; l < st.n_layers; ++l) {
    const Layer& ly = st.layer[l];
    if (sizeof(float) * bwd_smem_floats<W>(st.h, ly.r, ly.rx, ly.ctas, plan) > (size_t)plan.smem)
      return cudaErrorInvalidValue;
  }
  Stack a = st;
  void* args[] = {&a, &plan};
  cudaError_t err = vmlmf::launch_grid(stack_bwd_kernel<Bf16>, plan, st.sync, args, stream,
                                       st.n_layers * plan.groups);
  for (int l = 0; grads && l < st.n_layers && err == cudaSuccess; ++l)
    err = weight_grads<Bf16>(st, l, st.t_len * st.batch, stage, partial, room, stream);
  return err;
}

}  // namespace

// The reverse walk of the batch rows [b_begin, b_begin + b_count) of B =
// batch on the current stream, one cooperative launch, then, with grads 1,
// the weight gradients over all T*B rows (after the walks of every row).
// ptrs holds kPtrs pointers per layer in Layer's order (null where a layer
// has none, and for absent cotangents); ints kInts integers per layer, (r,
// rx, ctas), rx = 0 for layer 0; sync the [L][groups] barrier words (the
// launcher zeroes them); partial scratch of partial_floats floats for the
// split-k partial sums of the weight gradients, and tc_stage scratch of
// stage_floats floats for their staged operands and, for a layer l > 0
// with a mask, its input X (ops/cuda_stack.py::stack_partial_floats and
// stack_tc_stage_floats). groups, rpad, stage, red and smem are
// stack_plan's layout of the BPTT for b_count rows; bf16_mm 1 the bf16
// form. Returns the first error.
extern "C" int lstm_stack_bwd(void* const* ptrs, const int* ints, unsigned* sync, float* partial,
                              float* tc_stage, int partial_floats, int stage_floats, int n_layers,
                              int t_len, int batch, int b_begin, int b_count, int h, int groups,
                              int rpad, int stage, int red, int smem, int grads, int bf16_mm,
                              void* stream_handle) {
  if (n_layers < 1 || n_layers > kMaxLayers || b_begin < 0 || b_count < 1 ||
      b_begin + b_count > batch)
    return cudaErrorInvalidValue;
  Stack st{};
  int ctas = 0;
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
    ly.dys = static_cast<const float*>(p[14]);
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
    ly.dpx = static_cast<float*>(p[29]);
    ly.px = static_cast<float*>(p[30]);
    ly.dyx = static_cast<float*>(p[31]);
    ly.r = ints[kInts * l];
    ly.rx = ints[kInts * l + 1];
    ly.ctas = ints[kInts * l + 2];
    if (ly.ctas < 1 || (l > 0) != (ly.rx > 0) || (l + 1 < n_layers && ly.dyx == nullptr))
      return cudaErrorInvalidValue;
    ctas += ly.ctas;
  }
  st.sync = sync;
  st.n_layers = n_layers;
  st.t_len = t_len;
  st.batch = batch;
  st.b_begin = b_begin;
  st.b_count = b_count;
  st.h = h;
  const GridPlan plan{groups, ctas, rpad, stage, red, smem};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const size_t room = static_cast<size_t>(partial_floats);
  vmlmf::tc::Staging staging(tc_stage, static_cast<size_t>(stage_floats));
  return bf16_mm ? bwd<true>(st, plan, grads != 0, partial, room, staging, stream)
                 : bwd<false>(st, plan, grads != 0, partial, room, staging, stream);
}

// The message of an error code that lstm_stack_bwd returned.
extern "C" const char* lstm_stack_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
