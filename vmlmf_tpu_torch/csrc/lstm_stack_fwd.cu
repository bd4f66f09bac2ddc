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
// residual form also writes, per layer, ys and cs [T,B,h], the gates after
// the nonlinearities [T,B,4h], hu = h_prev @ U [T,B,r] and, for l > 0, xu =
// x @ Ux [T,B,rx] (the f32 products, before any rounding). The layers'
// ranks may differ. Layouts are the port's unpadded ones, all row-major and
// contiguous.
//
// The bf16 form rounds every product's operands to bf16 where the TPU
// kernel's _cast rounds them (x, xu, h and hu; the weights U, V, Ux, Vx)
// and sums in f32; the dvec and dxvec terms, the bias, gi0 and the gate
// arithmetic stay f32, and so do the residuals. The weight slices are held
// as bf16 in shared memory and widened for f32 FMAs; exchanged values are
// rounded by the CTA that writes them (scan_grid.cuh).
//
// What bounds it on an H100, and what the design does about it:
// * The recurrence of every layer is a serial chain: a step needs all of h
//   before h @ U. The TPU kernel keeps every layer's factors in VMEM for the
//   whole stack. Here they are split over the CTAs of one cooperative
//   launch, one per SM, each holding its slices in shared memory for the
//   whole launch, in the layout of ops/cuda_stack.py::stack_plan: batch
//   groups as in the single-layer scan (scan_grid.cuh), and within a group
//   a set of CTAs per layer, in proportion to the layer's multiply-adds per
//   row and step (a layer l > 0 has an x side of the recurrent side's shape,
//   so twice layer 0's at equal ranks: 44 and 88 of 132 SMs for the 2x650
//   LM stack, 11.7 MB of f32 factors).
// * A step of layer l is the single-layer scan's two phases with input
//   [x_t | h_{t-1}] and rank r + rx, each ending in the layer's barrier:
//   (A) hu[:, k-slice] = h @ U[:, k-slice] and, for l > 0, xu[:, kx-slice]
//   = x_t @ Ux[:, kx-slice], into the layer's [hu | xu] exchange; (B) pre =
//   [hu | xu] @ [V; Vx][:, gate columns of the j-slice] + h * dvec + (gi0,
//   or x * dxvec + bias), the gates and the c/h update of the j-slice, the
//   new h into the layer's h exchange. The x projection is thus inside the
//   step and off the chain between launches, and there is one launch per
//   call. In phase A a layer's CTAs hold either U's or Ux's rank columns
//   (scan_grid.cuh RankSlices), in proportion r : rx, so that each CTA
//   stages one operand from L2 a step and runs one product.
// * Layers pipelined step by step: layer l's step t needs only layer l-1's
//   step t, so the chain is T + L - 1 steps. A layer's barrier word counts
//   the arrivals of its CTAs (two rounds a step, after one at the start), so
//   it is also the layer's progress: before step t, layer l's CTAs wait
//   (acquire loads, the barrier's 4 s timeout) until layer l-1's word says
//   that its step t is done. Layer l-1 writes x_t for layer l in phase B of
//   its step t, masked (and rounded in bf16), into a [T][h][rpad] buffer per
//   group: every step has its own slot, so no slot is reused while a reader
//   may need it, and layer l-1 may run ahead. Waiting across CTAs is safe
//   only among co-resident CTAs, so the launch is cooperative and a grid
//   that cannot be co-resident is refused.
// * What sets a step is latency: the barriers, and each CTA's read of its
//   group's h (and x) or [hu | xu] from L2, staged into shared memory with
//   16-byte cp.async.cg (double-buffered when it does not fit whole). The
//   exchange and handoff buffers are read only through L2 (.cg), never
//   __ldg; weights, gi0, masks, h0 and c0 never change during the launch.
//   The step's gi0 (layer 0) or x (l > 0) of the j-slice is copied at the
//   start of the step, while phase A and its barrier run.
// * Ragged edges: h, r, rx and B need not divide the CTA or group counts; a
//   CTA may own no rank column, and rows past a group's batch rows are
//   padding that is computed and never written out.
// * A launch takes the batch rows [b_begin, b_begin + b_count): a batch too
//   large for one plan's staging (f32 LM stack, B > 164) is cut by the
//   wrapper into chunks of rows, one launch each (cuda_stack.py::
//   stack_chunks); rows are independent.
// * Every sum runs inside one CTA in a fixed order: two calls give the same
//   bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "gemm_tile.cuh"
#include "scan_grid.cuh"

namespace {

using vmlmf::bf16;
using vmlmf::div_up;
using vmlmf::GridPlan;
using vmlmf::round4;
using vmlmf::split_at;
using vmlmf::weight_floats;

constexpr int kMaxLayers = 8;  // the depth of the layer table; MAX_LAYERS in cuda_stack.py
constexpr int kPtrs = 21;      // pointers per layer in the entry's table
constexpr int kInts = 3;       // integers per layer: r, rx, ctas

// One layer's operands, outputs and exchange buffers, in the order of the
// entry's pointer table (FWD_FIELDS in cuda_stack.py). Layer 0 has no x
// side, no mask and no x buffers. The exchange buffers hold one region per
// batch group; a region is [units][rpad], one column per row of the group.
struct Layer {
  const float* u;      // [h, r]
  const float* v;      // [r, 4h]
  const float* dvec;   // [4h]
  const float* ux;     // [h, rx]
  const float* vx;     // [rx, 4h]
  const float* dxvec;  // [4h]
  const float* bias;   // [4h]
  const float* mask;   // [T, B, h]: the mask of this layer's input, or null
  const float* h0;     // [B, h]
  const float* c0;
  float* ys;           // [T, B, h], or null (a lower layer's, no-grad)
  float* hlast;        // [B, h] (no-grad)
  float* clast;
  float* cs;           // [T, B, h] (residual)
  float* gates;        // [T, B, 4h]
  float* hu;           // [T, B, r]
  float* xu;           // [T, B, rx]
  float* hx;           // [groups][h][rpad]: h of the step
  float* px;           // [groups][r + rx][rpad]: hu of the step, then xu
  float* xx;           // [groups][T][h][rpad]: x of each step, as the products read it
  float* xt;           // the same unrounded (bf16 form), or null (f32: xx)
  int r, rx, ctas;
};

struct Stack {
  Layer layer[kMaxLayers];
  const float* gi0;    // [T, B, 4h]
  unsigned* sync;      // [L][groups]: each layer's barrier word per group
  int n_layers, t_len, batch, h;
  int b_begin, b_count;  // the batch rows of this launch: [b_begin, b_begin + b_count)
};

// Floats of the shared memory of a CTA of a layer with ranks (r, rx) over
// `ctas` CTAs, in the order of the carve below: the weight slices (of type
// W), dvec, dxvec and bias of the j-slice, the (h, c) carry, stage, red, and
// the step's gi0 (layer 0) or x of the j-slice.
template <class W>
__host__ __device__ inline size_t fwd_smem_floats(int h, int r, int rx, int ctas,
                                                  const GridPlan& p) {
  const int jwm = div_up(h, ctas);
  const vmlmf::RankSlices ks(0, ctas, r, rx);
  const size_t u = weight_floats<W>((size_t)h * ks.kwp), ux = weight_floats<W>((size_t)h * ks.kxwp);
  return (ks.packed ? u + ux : u > ux ? u : ux) + weight_floats<W>((size_t)(r + rx) * 4 * jwm) +
         12 * jwm + (size_t)(2 + (rx ? 1 : 4)) * jwm * p.rpad + p.stage + p.red;
}

// The whole stack on plan.groups x plan.ctas co-resident CTAs (plan.ctas: a
// group's CTAs over all layers, layer 0's first). Res: also write the
// residuals.
template <bool Res, bool Bf16>
__global__ void __launch_bounds__(vmlmf::kGridThreads, 1)
stack_fwd_kernel(const Stack st, const GridPlan plan) {
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
  const int k0 = ks.k0, kw = ks.kw, kx0 = ks.kx0, kxw = ks.kxw, kwp = ks.kr, kxwp = ks.kxr;
  const int jwm = div_up(h, ctas);

  // the slices of U[:, k-slice] [h][kwp] and Ux[:, kx-slice] [h][kxwp]
  // that the CTA holds (a width of 0: none), in a region that fits either
  // kind, or both on a layer's only CTA; then [V; Vx], the gate columns of
  // the j-slice [r + rx][jwm][4]
  W* wa = reinterpret_cast<W*>(smem);
  W* wx = reinterpret_cast<W*>(smem + weight_floats<W>((size_t)h * kwp));
  const size_t u_floats = weight_floats<W>((size_t)h * ks.kwp);
  const size_t ux_floats = weight_floats<W>((size_t)h * ks.kxwp);
  W* wb = reinterpret_cast<W*>(
      smem + (ks.packed ? u_floats + ux_floats : u_floats > ux_floats ? u_floats : ux_floats));
  float* dv = reinterpret_cast<float*>(wb) + weight_floats<W>((size_t)(r + rx) * 4 * jwm);
  float* dxv = dv + 4 * jwm;  // [jwm][4] each: dvec, dxvec, bias of the j-slice
  float* bs = dxv + 4 * jwm;
  float* hc = bs + 4 * jwm;   // the carry h, c: [jwm][rpad]
  float* cc = hc + (size_t)jwm * rpad;
  float* stage = cc + (size_t)jwm * rpad;
  float* red = stage + plan.stage;
  float* gis = red + plan.red;  // layer 0: gi0 of the step [jwm][4][rpad]; l > 0: x [jwm][rpad]

  const size_t xslab = (size_t)t_len * h * rpad;  // one group's region of an x buffer
  float* hx = ly.hx + (size_t)grp * h * rpad;
  float* px = ly.px + (size_t)grp * (r + rx) * rpad;
  const float* xx = l ? ly.xx + grp * xslab : nullptr;
  const float* xt = l ? (ly.xt != nullptr ? ly.xt : ly.xx) + grp * xslab : nullptr;
  // the next layer's x buffers and mask, written here
  float* nxx = top ? nullptr : st.layer[l + 1].xx + grp * xslab;
  float* nxt = top || !Bf16 ? nullptr : st.layer[l + 1].xt + grp * xslab;
  const float* nmask = top ? nullptr : st.layer[l + 1].mask;
  unsigned* count = st.sync + l * plan.groups + grp;
  const unsigned* below = l ? st.sync + (l - 1) * plan.groups + grp : nullptr;
  const unsigned below_ctas = l ? st.layer[l - 1].ctas : 0;
  unsigned target = 0;

  // the weight slices, loaded once; columns past the slice are zero
#pragma unroll 4
  for (int e = threadIdx.x; e < h * kwp; e += blockDim.x) {
    const int d = e / kwp, kk = e % kwp;
    wa[e] = vmlmf::to_elem<W>(kk < kw ? ly.u[(size_t)d * r + k0 + kk] : 0.f);
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < h * kxwp; e += blockDim.x) {
    const int d = e / kxwp, kk = e % kxwp;
    wx[e] = vmlmf::to_elem<W>(kk < kxw ? ly.ux[(size_t)d * rx + kx0 + kk] : 0.f);
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < (r + rx) * 4 * jwm; e += blockDim.x) {
    const int d = e / (4 * jwm), jj = (e / 4) % jwm, gg = e % 4;
    const float* w = d < r ? ly.v + (size_t)d * g4 : ly.vx + (size_t)(d - r) * g4;
    wb[e] = vmlmf::to_elem<W>(jj < jw ? w[gg * h + j0 + jj] : 0.f);
  }
  for (int e = threadIdx.x; e < 4 * jwm; e += blockDim.x) {
    const bool live = e / 4 < jw;
    const int at = (e % 4) * h + j0 + e / 4;
    dv[e] = live ? ly.dvec[at] : 0.f;
    dxv[e] = live && l ? ly.dxvec[at] : 0.f;
    bs[e] = live && l ? ly.bias[at] : 0.f;
  }
  // the carry from h0, c0 (padding rows zero), and h0's j-slice into the
  // h exchange of step 0
  for (int e = threadIdx.x; e < jwm * rpad; e += blockDim.x) {
    const int jj = e / rpad, row = e % rpad;
    const bool live = jj < jw && row < rows;
    const size_t at = (size_t)(b0 + row) * h + j0 + jj;
    hc[e] = live ? ly.h0[at] : 0.f;
    cc[e] = live ? ly.c0[at] : 0.f;
    if (jj < jw) hx[(size_t)(j0 + jj) * rpad + row] = vmlmf::exchanged<Bf16>(hc[e]);
  }
  vmlmf::group_sync(count, ctas, target, true);

  for (int t = 0; t < t_len; ++t) {
    const size_t m0 = (size_t)t * batch + b0;  // the group's first row of the step
    if (l) {
      // layer l-1's step t is done once its word has 2t + 3 rounds of arrivals
      vmlmf::wait_count(below, below_ctas * (2u * t + 3u));
      const float4* src = reinterpret_cast<const float4*>(xt + ((size_t)t * h + j0) * rpad);
      float4* dst = reinterpret_cast<float4*>(gis);
      for (int i = threadIdx.x; i < jw * rpad / 4; i += blockDim.x) vmlmf::cp_async16_cg(dst + i, src + i);
    } else {
      for (int e = threadIdx.x; e < 4 * jw * rows; e += blockDim.x) {
        const int jj = e % jw, g = (e / jw) % 4, row = e / (4 * jw);
        vmlmf::cp_async4(gis + (jj * 4 + g) * rpad + row,
                         st.gi0 + (m0 + row) * g4 + g * h + j0 + jj);
      }
    }

    // (A) hu[:, k-slice] = h @ U[:, k-slice] and, for l > 0, xu[:, kx-slice]
    // = x @ Ux[:, kx-slice] into the rows of px after hu's: one of the two
    // on a CTA of a layer l > 0 (RankSlices), both on its only CTA
    vmlmf::slice_product(hx, h, rpad, wa, kwp, round4(kw), stage, plan.stage, red, plan.red,
                         [&](int cb, int rb, float (&acc)[4][4]) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kk = 4 * cb + c;
        if (kk >= kw) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 4 * rb + i;
          px[(size_t)(k0 + kk) * rpad + row] = vmlmf::exchanged<Bf16>(acc[c][i]);
          if (Res && row < rows) ly.hu[(m0 + row) * r + k0 + kk] = acc[c][i];
        }
      }
    });
    if (kxw)
      vmlmf::slice_product(xx + (size_t)t * h * rpad, h, rpad, wx, kxwp, round4(kxw), stage,
                           plan.stage, red, plan.red, [&](int cb, int rb, float (&acc)[4][4]) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kk = 4 * cb + c;
          if (kk >= kxw) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = 4 * rb + i;
            px[(size_t)(r + kx0 + kk) * rpad + row] = vmlmf::exchanged<Bf16>(acc[c][i]);
            if (Res && row < rows) ly.xu[(m0 + row) * rx + kx0 + kk] = acc[c][i];
          }
        }
      });
    vmlmf::group_sync(count, ctas, target, true);

    // (B) pre = [hu | xu] @ [V; Vx][:, gate columns of the j-slice] + h * dvec
    // + (gi0, or x * dxvec + bias); the gates and the update of the j-slice.
    // Item cb is unit j0 + cb. The product's first __syncthreads publishes
    // the copied gi0 or x.
    vmlmf::cp_async_wait_all();
    vmlmf::slice_product(px, r + rx, rpad, wb, 4 * jwm, 4 * jw, stage, plan.stage, red, plan.red,
                         [&](int cb, int rb, float (&acc)[4][4]) {
      const int j = j0 + cb;
      float gv[4][4];
      if (l) {
        const float4 x4 = *reinterpret_cast<const float4*>(gis + cb * rpad + 4 * rb);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int i = 0; i < 4; ++i) gv[g][i] = fmaf(xv[i], dxv[4 * cb + g], bs[4 * cb + g]);
      } else {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float4 q4 = *reinterpret_cast<const float4*>(gis + (cb * 4 + g) * rpad + 4 * rb);
          gv[g][0] = q4.x, gv[g][1] = q4.y, gv[g][2] = q4.z, gv[g][3] = q4.w;
        }
      }
      const float d0 = dv[4 * cb], d1 = dv[4 * cb + 1], d2 = dv[4 * cb + 2], d3 = dv[4 * cb + 3];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 4 * rb + i;
        const int e = cb * rpad + row;
        const size_t xat = ((size_t)t * h + j) * rpad + row;
        if (row >= rows) {
          hx[(size_t)j * rpad + row] = 0.f;
          if (!top) {
            nxx[xat] = 0.f;
            if (Bf16) nxt[xat] = 0.f;
          }
          continue;
        }
        const size_t m = m0 + row;
        const float hp = hc[e];
        const float si = vmlmf::gate_sigmoid(gv[0][i] + acc[0][i] + hp * d0);
        const float sf = vmlmf::gate_sigmoid(gv[1][i] + acc[1][i] + hp * d1);
        const float tg = tanhf(gv[2][i] + acc[2][i] + hp * d2);
        const float so = vmlmf::gate_sigmoid(gv[3][i] + acc[3][i] + hp * d3);
        const float cn = sf * cc[e] + si * tg;
        const float hn = so * tanhf(cn);
        cc[e] = cn;
        hc[e] = hn;
        hx[(size_t)j * rpad + row] = vmlmf::exchanged<Bf16>(hn);
        if (ly.ys != nullptr) ly.ys[m * h + j] = hn;
        if (Res) {
          ly.cs[m * h + j] = cn;
          float* gw = ly.gates + m * g4;
          gw[j] = si;
          gw[h + j] = sf;
          gw[2 * h + j] = tg;
          gw[3 * h + j] = so;
        }
        if (!top) {  // layer l+1's x of the step
          const float xv = nmask != nullptr ? hn * nmask[m * h + j] : hn;
          nxx[xat] = vmlmf::exchanged<Bf16>(xv);
          if (Bf16) nxt[xat] = xv;
        }
      }
    });
    vmlmf::group_sync(count, ctas, target, true);
  }

  if (!Res)
    for (int e = threadIdx.x; e < jw * rows; e += blockDim.x) {
      const int jj = e % jw, row = e / jw;
      const size_t at = (size_t)(b0 + row) * h + j0 + jj;
      ly.hlast[at] = hc[jj * rpad + row];
      ly.clast[at] = cc[jj * rpad + row];
    }
}

// Launches stack_fwd_kernel<Res, Bf16>; returns the launch's error. The
// plan must hold at least the shared memory that every layer's CTAs carve.
template <bool Res, bool Bf16>
cudaError_t launch(const Stack& st, GridPlan plan, cudaStream_t stream) {
  using W = std::conditional_t<Bf16, bf16, float>;
  for (int l = 0; l < st.n_layers; ++l) {
    const Layer& ly = st.layer[l];
    if (sizeof(float) * fwd_smem_floats<W>(st.h, ly.r, ly.rx, ly.ctas, plan) > (size_t)plan.smem)
      return cudaErrorInvalidValue;
  }
  Stack a = st;
  void* args[] = {&a, &plan};
  return vmlmf::launch_grid(stack_fwd_kernel<Res, Bf16>, plan, st.sync, args, stream,
                            st.n_layers * plan.groups);
}

}  // namespace

// The forward stack on the current stream, in one cooperative launch, for
// the batch rows [b_begin, b_begin + b_count) of B = batch. ptrs holds
// kPtrs pointers per layer in Layer's order (null where a layer has none);
// ints kInts integers per layer, (r, rx, ctas), rx = 0 for layer 0; gi0 is
// layer 0's input contribution [T*B, 4h]; sync the [L][groups] barrier
// words (the launcher zeroes them). groups, rpad, stage, red and smem are
// stack_plan's layout for b_count rows (a group's CTAs: the sum of the
// layers' ctas); residuals 0 is the no-grad form; bf16_mm 1 the bf16 form.
// Returns the first error.
extern "C" int lstm_stack_fwd(void* const* ptrs, const int* ints, const float* gi0,
                              unsigned* sync, int n_layers, int t_len, int batch, int b_begin,
                              int b_count, int h, int groups, int rpad, int stage, int red,
                              int smem, int residuals, int bf16_mm, void* stream_handle) {
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
    ly.hx = static_cast<float*>(p[17]);
    ly.px = static_cast<float*>(p[18]);
    ly.xx = static_cast<float*>(p[19]);
    ly.xt = static_cast<float*>(p[20]);
    ly.r = ints[kInts * l];
    ly.rx = ints[kInts * l + 1];
    ly.ctas = ints[kInts * l + 2];
    if (ly.ctas < 1 || (l > 0) != (ly.rx > 0) || (l > 0 && ly.xx == nullptr) ||
        (l > 0 && bf16_mm && ly.xt == nullptr))
      return cudaErrorInvalidValue;
    ctas += ly.ctas;
  }
  st.gi0 = gi0;
  st.sync = sync;
  st.n_layers = n_layers;
  st.t_len = t_len;
  st.batch = batch;
  st.b_begin = b_begin;
  st.b_count = b_count;
  st.h = h;
  const GridPlan plan{groups, ctas, rpad, stage, red, smem};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (bf16_mm)
    return residuals ? launch<true, true>(st, plan, stream) : launch<false, true>(st, plan, stream);
  return residuals ? launch<true, false>(st, plan, stream) : launch<false, false>(st, plan, stream);
}

// The message of an error code that lstm_stack_fwd returned.
extern "C" const char* lstm_stack_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
