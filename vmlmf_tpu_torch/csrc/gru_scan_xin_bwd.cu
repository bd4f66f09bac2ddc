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
//   1. walk_kernel, the serial part. One CTA owns `rows` batch rows
//      (ops/cuda_gru.py::gru_plan) and walks all T steps; the recurrent
//      weights are held as in the forward: each lane's share in registers
//      at the HAR widths, else in shared memory when they fit, else read
//      through L2 by the same code. Its products go through gru_tile.cuh's
//      unit groups (four lanes an output, float4 loads along the weight
//      rows, two shuffles), and lane slice s of a group does row s's
//      elementwise work, so the lane that finishes (row, j) of a product is
//      the one that owns the carry dh[row, j]: the carry needs no barrier.
//      Each step's inputs (gates, h_prev, dys, recn) are copied with
//      cp.async into shared memory one step ahead, each lane copying what
//      it will read itself, so no step waits on device memory. Barriers a
//      step: one in "post" (the two dPre buffers take turns), two in dense
//      "pre", four in low-rank "pre". It writes dPre [M,3h], and dHU, dRHU
//      [M,r] in the low-rank form, for the passes below. Where one row's
//      walk state does not fit beside weights read through L2 (a dense
//      "post" h past 3,056: 19 h floats a row), gru_plan gives one row a CTA
//      and `spill` floats of leading regions (the staged inputs first) that
//      live in the CTA's region of a device-memory scratch (`state`); the
//      kernel instance for it (Spill) stages those inputs with plain loads,
//      and __syncthreads orders them as it orders shared memory.
//   2. Time-parallel passes over all M rows: tiled GEMMs (gemm_tile.cuh)
//      with transposed operand views. Every product whose k runs over the M
//      rows (dPrz, dPn, dUf, dUx, dVx, and dbias as ones^T dPre) has an
//      output of a few tiles, so they go together through one grouped
//      split-k (gemm_splitk_group): one launch in which some 264 CTAs a
//      product each sum a slice of the rows, then one that adds each
//      output's slices in a fixed order and applies its epilogue:
//      deterministic, no atomics, two launches where there were a dozen.
//      dUf is one product over 2M rows, [Hprev | R*Hprev]^T [dHU; dRHU].
//      The caller sizes the slices' scratch (cuda_gru.py::
//      gru_bwd_partial_floats). Hprev, R*Hprev and dN*R are read in place
//      through operand views, never built as copies.
//      The recurrent products that gemm_tc.cuh's rule (wg_route: 2^28
//      multiply-adds or more, m, n and k all 128 or more; h = 1000 or
//      3200, none at a HAR width) sends to its Hopper tile run there
//      instead, in 3xTF32, each on its own before the group: wgmma fed by
//      TMA from copies staged once a call (`stage`, cuda_gru.py::
//      gru_tc_stage_floats), the composites R*Hprev, dN*R and [Hprev;
//      R*Hprev] formed as they are split into hi and lo (a gated
//      wg::Source). The group keeps its slice length, so the products that
//      stay in it keep their bits. At h=3200 the grouped split-k took
//      7.5-7.9 ms of a 20 ms BPTT on the CUDA cores. The recompute
//      pre-pass's recurrent products route alike, their epilogues (which
//      read the gates) run over the tile's raw sums in tc_sum_kernel; each
//      stages from the scratch's start, and a dense [R Z] runs as two
//      products of h columns, so that the policy needs no more staging
//      than the weight gradients, which reuse it after. dx = dXU Ux^T (k = rx
//      or 3h) joins the group, with the weight gradients' slice length so
//      that their sums do not depend on it; dXU = dPre Vx^T, which dUx and
//      dx read, is a group of its own before it, so that its k = 3h is cut
//      into slices too, where a plain tiled GEMM would walk all of it on
//      one CTA per 64 rows.
// * dx is skipped when the caller passes no dx buffer (a first layer's raw
//   input needs none). gi mode skips the whole x side and the column sums:
//   dPre is dgi.
// * Every edge is masked: B, T*B, F, h, r, rx need not be tile multiples.

#include <cuda_runtime.h>

#include "gemm_tc.cuh"
#include "gemm_tile.cuh"
#include "gru_grid.cuh"
#include "gru_tile.cuh"

namespace {

using namespace vmlmf::gru;
using vmlmf::cdiv;

struct WalkArgs {
  const float* gates;
  const float* ys;
  const float* h0;
  const float* recn;
  const float* dys;
  const float* uf;
  const float* prz;
  const float* pn;
  float* dpre;
  float* dhu;
  float* drhu;
  float* dh0;
  float* state;
  int t_len, batch, h, r, rows, rec_res, spill;
};

// Floats a row of a step's staged inputs takes: gates (3h), h_prev, dys,
// and recn in "post".
__host__ __device__ inline int stage_width(int form, int h) {
  return (form == kDensePost ? 6 : 5) * h;
}

// Float offsets of the walk's shared regions, in the order of
// ops/cuda_gru.py::_bwd_floats: the resident weights, each row-major with
// stride ldt(columns) (Uf [h, r]; Prz [depth, 2h], Pn [depth, h]); the two
// buffers of staged inputs [2][rows][stage_width]; the carry dh [rows][h];
// [dr_pre, dz_pre] [rows][q4(2h)] and dn_pre (dn_pre*r in "post")
// [rows][q4(h)], two of each in "post"; dz_pre [rows][h] ("pre"); dRHU and
// dHU [rows][q4(r)] (low-rank). Offsets below a spill plan's `spill` lie in
// the CTA's region of the device-memory scratch, the others at offset -
// spill in shared memory.
struct WalkLayout {
  size_t uf, prz, pn, stg, dhs, drz, dn, dzs, drhus, dhus, total;
};

__host__ __device__ inline WalkLayout walk_layout(int form, const WalkArgs& a) {
  const bool lowrank = form == kLowrankPre, post = form == kDensePost;
  const int h = a.h, r = a.r, depth = lowrank ? r : h, nbuf = post ? 2 : 1;
  WalkLayout L{};
  size_t at = 0;
  const bool shared = a.rec_res == kInShared;
  L.uf = take(at, shared && lowrank ? (size_t)h * ldt(r) : 0);
  L.prz = take(at, shared ? (size_t)depth * ldt(2 * h) : 0);
  L.pn = take(at, shared ? (size_t)depth * ldt(h) : 0);
  L.stg = take(at, (size_t)2 * a.rows * stage_width(form, h));
  L.dhs = take(at, (size_t)a.rows * h);
  L.drz = take(at, (size_t)nbuf * a.rows * q4(2 * h));
  L.dn = take(at, (size_t)nbuf * a.rows * q4(h));
  L.dzs = take(at, post ? 0 : (size_t)a.rows * h);
  L.drhus = take(at, lowrank ? (size_t)a.rows * q4(r) : 0);
  L.dhus = take(at, lowrank ? (size_t)a.rows * q4(r) : 0);
  L.total = at;
  return L;
}

// A lane's recurrent weights where the plan holds them in registers, as
// rows (the walk's products run along them): "post" Prz's and Pn's row j;
// dense "pre" the same, for drh and for the last product; low-rank Pn's
// and Prz's row k (for dRHU and dHU) and Uf's row j (for drh and dhp).
template <int Form>
struct WalkRegs {
  RegSlice<1, 8> prz;  // depth 2h
  RegSlice<1, 4> pn;   // depth h
};
template <>
struct WalkRegs<kLowrankPre> {
  RegSlice<1, 8> prz;
  RegSlice<1, 4> pn;
  RegSlice<1, 1> uf;  // depth r
};

// The serial reverse walk of one CTA's rows; see the header. Rows past the
// batch are never computed or written.
template <int Form, int R, bool Spill>
__global__ void __launch_bounds__(kMaxThreads) walk_kernel(const WalkArgs a) {
  constexpr bool kLowrank = Form == kLowrankPre, kPost = Form == kDensePost;
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);  // the resident weights: never spilled
  const WalkLayout L = walk_layout(Form, a);
  // the region at layout offset `off` (Spill: the leading ones in device memory)
  float* const spilled = Spill ? a.state + (size_t)blockIdx.x * a.spill : nullptr;
  auto at = [&](size_t off) -> float* {
    if constexpr (Spill) return off < (size_t)a.spill ? spilled + off : sm + (off - a.spill);
    return sm + off;
  };
  const int h = a.h, r = a.r, g3 = 3 * h, rows = a.rows, sw = stage_width(Form, h);
  const int h4 = q4(h), r4 = q4(r), rz4 = q4(2 * h), depth = kLowrank ? r : h;
  const int b0 = blockIdx.x * rows, live = min(rows, a.batch - b0);
  const Lanes ln;
  const int row = ln.slice;
  const bool own_row = row < live;

  const bool in_shared = a.rec_res == kInShared, regs = a.rec_res == kInRegisters;
  if (in_shared) {
    if (kLowrank) stage_rows(sm + L.uf, a.uf, h, r);
    stage_rows(sm + L.prz, a.prz, depth, 2 * h);
    stage_rows(sm + L.pn, a.pn, depth, h);
  }
  auto shared = [&](size_t off, bool on) { return on ? sm + off : nullptr; };
  const QuadRows uf{a.uf, shared(L.uf, in_shared && kLowrank), r, ldt(r)};
  const QuadRows prz{a.prz, shared(L.prz, in_shared), 2 * h, ldt(2 * h)};
  const QuadRows pn{a.pn, shared(L.pn, in_shared), h, ldt(h)};
  // one pass when in registers: the lane's unit (j, or k) is fixed for the walk
  const int jr = min(ln.unit, h - 1), own = kLowrank ? min(ln.unit, r - 1) : jr;
  WalkRegs<Form> wr;
  if (regs) {  // through L2 once, all loads in flight
    wr.prz.load(rz4 / 4, ln.slice, [&](int, int q) { return prz.at(own, q); });
    wr.pn.load(h4 / 4, ln.slice, [&](int, int q) { return pn.at(own, q); });
    if constexpr (kLowrank) wr.uf.load(r4 / 4, ln.slice, [&](int, int q) { return uf.at(jr, q); });
  }
  // the state starts at zero; the staged inputs are each lane's own copies
  for (size_t i = L.dhs + threadIdx.x; i < L.total; i += blockDim.x) *at(i) = 0.f;

  float* stg = at(L.stg);
  float* dhs = at(L.dhs);
  float* dzs = at(L.dzs);
  float* drhus = at(L.drhus);
  float* dhus = at(L.dhus);
  // step t's inputs of (own row, the units of this lane) into buffer buf
  auto fetch = [&](int t, int buf) {
    if (!own_row) return;
    const size_t m = (size_t)t * a.batch + b0 + row;
    float* d = stg + ((size_t)buf * rows + row) * sw;
    const float* hp = t > 0 ? a.ys + (m - a.batch) * h : a.h0 + (size_t)(b0 + row) * h;
    for (int j = ln.unit; j < h; j += ln.per_pass) {
      const float* g = a.gates + m * g3 + j;
      if constexpr (Spill) {  // the buffers in device memory: plain copies
        d[j] = __ldg(g);
        d[h + j] = __ldg(g + h);
        d[2 * h + j] = __ldg(g + 2 * h);
        d[3 * h + j] = __ldg(hp + j);
        d[4 * h + j] = __ldg(a.dys + m * h + j);
        if (kPost) d[5 * h + j] = __ldg(a.recn + m * h + j);
      } else {
        vmlmf::cp_async4(d + j, g);
        vmlmf::cp_async4(d + h + j, g + h);
        vmlmf::cp_async4(d + 2 * h + j, g + 2 * h);
        vmlmf::cp_async4(d + 3 * h + j, hp + j);
        vmlmf::cp_async4(d + 4 * h + j, a.dys + m * h + j);
        if (kPost) vmlmf::cp_async4(d + 5 * h + j, a.recn + m * h + j);
      }
    }
  };
  fetch(a.t_len - 1, 0);
  vmlmf::cp_async_wait_all();  // the weights' copies and step T-1's inputs
  __syncthreads();

  int cur = 0;
  for (int t = a.t_len - 1; t >= 0; --t) {
    if (t > 0) fetch(t - 1, cur ^ 1);  // in flight while this step computes
    const float* sg = stg + ((size_t)cur * rows + row) * sw;
    const size_t m = (size_t)t * a.batch + b0 + row;
    float* drz = at(L.drz) + (kPost ? (size_t)cur * rows * rz4 : 0);
    float* dn = at(L.dn) + (kPost ? (size_t)cur * rows * h4 : 0);

    // elementwise: dz_pre, dn_pre, dh*z; in "post" also dr_pre and dn_pre*r
    if (own_row) {
      for (int j = ln.unit; j < h; j += ln.per_pass) {
        const float rg = sg[j], z = sg[h + j], n = sg[2 * h + j];
        const float dh = dhs[row * h + j] + sg[4 * h + j];
        const float dz_pre = dh * (sg[3 * h + j] - n) * z * (1.f - z);
        const float dn_pre = dh * (1.f - z) * (1.f - n * n);
        float* dg = a.dpre + m * g3;
        dg[h + j] = dz_pre;
        dg[2 * h + j] = dn_pre;
        dhs[row * h + j] = dh * z;
        if (kPost) {
          const float dr_pre = dn_pre * sg[5 * h + j] * rg * (1.f - rg);
          dg[j] = dr_pre;
          drz[row * rz4 + j] = dr_pre;
          drz[row * rz4 + h + j] = dz_pre;
          dn[row * h4 + j] = dn_pre * rg;
        } else {
          dn[row * h4 + j] = dn_pre;
          dzs[row * h + j] = dz_pre;
        }
      }
    }
    __syncthreads();

    if constexpr (kPost) {
      // dhp += [dr_pre, dz_pre] @ Prz^T + (dn_pre*r) @ Pn^T, unit j
      for (int u0 = 0; u0 < h; u0 += ln.per_pass) {
        const int j = u0 + ln.unit, jc = min(j, h - 1);
        float acc[1][R] = {};
        if (regs) {
          wr.prz.dot(acc, drz, rz4, live, rz4 / 4, ln.slice);
          wr.pn.dot(acc, dn, h4, live, h4 / 4, ln.slice);
        } else {
          slice_dot<1>(acc, drz, rz4, live, rz4 / 4, ln.slice,
                       [&](int, int q) { return prz.at(jc, q); });
          slice_dot<1>(acc, dn, h4, live, h4 / 4, ln.slice,
                       [&](int, int q) { return pn.at(jc, q); });
        }
        slice_reduce<1>(acc, live);
        if (j < h && own_row) dhs[row * h + j] += pick(acc[0], row);
      }
    } else {
      const float* drh_src = dn;  // the rows of drh's product: dn_pre, or dRHU
      int drh_ld = h4;
      if constexpr (kLowrank) {  // drhu = dn_pre @ Pn^T, rank k
        for (int u0 = 0; u0 < r; u0 += ln.per_pass) {
          const int k = u0 + ln.unit, kc = min(k, r - 1);
          float acc[1][R] = {};
          if (regs)
            wr.pn.dot(acc, dn, h4, live, h4 / 4, ln.slice);
          else
            slice_dot<1>(acc, dn, h4, live, h4 / 4, ln.slice,
                         [&](int, int q) { return pn.at(kc, q); });
          slice_reduce<1>(acc, live);
          if (k < r && own_row) {
            const float v = pick(acc[0], row);
            drhus[row * r4 + k] = v;
            a.drhu[m * r + k] = v;
          }
        }
        __syncthreads();
        drh_src = drhus;
        drh_ld = r4;
      }
      // drh of unit j (dn_pre @ Pn^T, or drhu @ Uf^T), then dr_pre and dhp += drh * r
      for (int u0 = 0; u0 < h; u0 += ln.per_pass) {
        const int j = u0 + ln.unit, jc = min(j, h - 1);
        float acc[1][R] = {};
        if (!regs) {
          slice_dot<1>(acc, drh_src, drh_ld, live, drh_ld / 4, ln.slice, [&](int, int q) {
            return kLowrank ? uf.at(jc, q) : pn.at(jc, q);
          });
        } else if constexpr (kLowrank) {
          wr.uf.dot(acc, drh_src, drh_ld, live, drh_ld / 4, ln.slice);
        } else {
          wr.pn.dot(acc, drh_src, drh_ld, live, drh_ld / 4, ln.slice);
        }
        slice_reduce<1>(acc, live);
        if (j < h && own_row) {
          const float drh = pick(acc[0], row), rg = sg[j];
          const float dr_pre = drh * sg[3 * h + j] * rg * (1.f - rg);
          a.dpre[m * g3 + j] = dr_pre;
          drz[row * rz4 + j] = dr_pre;
          drz[row * rz4 + h + j] = dzs[row * h + j];
          dhs[row * h + j] += drh * rg;
        }
      }
      __syncthreads();
      const float* last_src = drz;  // the rows of the last product: [dr, dz], or dHU
      int last_ld = rz4;
      if constexpr (kLowrank) {  // dhu = [dr_pre, dz_pre] @ Prz^T, rank k
        for (int u0 = 0; u0 < r; u0 += ln.per_pass) {
          const int k = u0 + ln.unit, kc = min(k, r - 1);
          float acc[1][R] = {};
          if (regs)
            wr.prz.dot(acc, drz, rz4, live, rz4 / 4, ln.slice);
          else
            slice_dot<1>(acc, drz, rz4, live, rz4 / 4, ln.slice,
                         [&](int, int q) { return prz.at(kc, q); });
          slice_reduce<1>(acc, live);
          if (k < r && own_row) {
            const float v = pick(acc[0], row);
            dhus[row * r4 + k] = v;
            a.dhu[m * r + k] = v;
          }
        }
        __syncthreads();
        last_src = dhus;
        last_ld = r4;
      }
      // dhp += [dr_pre, dz_pre] @ Prz^T, or dhu @ Uf^T, unit j
      for (int u0 = 0; u0 < h; u0 += ln.per_pass) {
        const int j = u0 + ln.unit, jc = min(j, h - 1);
        float acc[1][R] = {};
        if (!regs) {
          slice_dot<1>(acc, last_src, last_ld, live, last_ld / 4, ln.slice, [&](int, int q) {
            return kLowrank ? uf.at(jc, q) : prz.at(jc, q);
          });
        } else if constexpr (kLowrank) {
          wr.uf.dot(acc, last_src, last_ld, live, last_ld / 4, ln.slice);
        } else {
          wr.prz.dot(acc, last_src, last_ld, live, last_ld / 4, ln.slice);
        }
        slice_reduce<1>(acc, live);
        if (j < h && own_row) dhs[row * h + j] += pick(acc[0], row);
      }
    }
    // No barrier closes the step: what the next step's elementwise part
    // writes (this lane's own carry, dz_pre and inputs; dn_pre, whose
    // readers passed the second barrier; in "post" the other dPre buffers)
    // is read by no lane still in this step.
    vmlmf::cp_async_wait_all();  // this lane's inputs of step t - 1
    cur ^= 1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < live * h; i += blockDim.x)
    a.dh0[(size_t)b0 * h + i] = dhs[(i / h) * h + i % h];
}

template <int Form, int R, bool Spill = false>
cudaError_t walk_rows(const WalkArgs& a, int threads, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(walk_kernel<Form, R, Spill>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  walk_kernel<Form, R, Spill><<<cdiv(a.batch, a.rows), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Launches walk_kernel<Form, row_bound(rows), spill > 0> with gru_plan's
// layout; refuses a plan whose shared bytes are not this layout's, and a
// spill that is not a region boundary of a one-row plan with the
// recurrent weights read through L2.
template <int Form>
cudaError_t walk(const WalkArgs& a, int threads, int smem, cudaStream_t stream) {
  const WalkLayout L = walk_layout(Form, a);
  const bool regs_fit = a.h <= kRegH && a.r <= kRegR && threads / kSlices >= a.h &&
                        threads / kSlices >= a.r;
  const size_t bounds[] = {L.stg, L.dhs, L.drz, L.dn, L.dzs, L.drhus, L.dhus, L.total};
  bool boundary = a.spill == 0;
  for (size_t b : bounds) boundary = boundary || (size_t)a.spill == b;
  const bool spill_ok =
      a.spill == 0 || (boundary && a.rows == 1 && a.rec_res == kInL2 && a.state != nullptr);
  if (a.spill < 0 || (size_t)a.spill > L.total || !spill_ok ||
      (L.total - a.spill) * sizeof(float) != (size_t)smem || a.rows < 1 || a.rows > kMaxRows ||
      threads < 32 || threads % 32 != 0 || threads > kMaxThreads || a.rec_res < kInL2 ||
      a.rec_res > kInRegisters || (a.rec_res == kInRegisters && !regs_fit))
    return cudaErrorInvalidValue;
  if (a.spill > 0) return walk_rows<Form, 1, true>(a, threads, smem, stream);
  switch (row_bound(a.rows)) {
    case 1:
      return walk_rows<Form, 1>(a, threads, smem, stream);
    case 2:
      return walk_rows<Form, 2>(a, threads, smem, stream);
    default:
      return walk_rows<Form, kMaxRows>(a, threads, smem, stream);
  }
}

// -- the grid walk (gru_grid.cuh; ops/cuda_gru.py::gru_grid_plan) ----------

using vmlmf::GridPlan;
using vmlmf::round4;
using vmlmf::split_at;

// The serial reverse walk on plan.groups x plan.ctas co-resident CTAs, the
// residuals and outputs of walk_kernel (WalkArgs; its row-layout fields
// unused). xchg: the dpre exchange [2][groups][3h][rpad] (step parity),
// rows (dr_pre, dz_pre, dn_pre) of each unit, dn_pre * r in "post"; then,
// low-rank, [groups][r][rpad] for drhu, which dhu reuses. A step:
//   (A) the j-slice's elementwise part from the staged inputs and the
//       carry: dz_pre, dn_pre (and dr_pre in "post") into dpre and the
//       exchange, the carry dh * z; group barrier;
//   "post": (C) dh += [dr_pre, dz_pre, dn_pre * r] @ [Prz; Pn]^T rows of
//       the j-slice;
//   "pre":  (B) drh = dn_pre @ Pn^T (dense), or drhu = dn_pre @ Pn^T of
//       the k-slice, barrier, drh = drhu @ Uf^T (low-rank); dr_pre into
//       dpre and the exchange, dh += drh * r; barrier; (C) dh += [dr_pre,
//       dz_pre] @ Prz^T (dense), or dhu = [dr_pre, dz_pre] @ Prz^T of the
//       k-slice, barrier, dh += dhu @ Uf^T (low-rank).
// C writes only the CTA's own carry, so it needs no barrier after it: one,
// two or four a step. The next step's inputs are copied with cp.async once
// the step's last reader of them has passed its barrier. OnRing
// (GridPlan::piece > 0): the products run on scan_grid.cuh's ring, as in
// the forward (grid_fwd_kernel). R: the batch rows of a product item
// (GridPlan::tile).
template <int Form, bool OnRing, int R>
__global__ void __launch_bounds__(OnRing ? vmlmf::kRingThreads : vmlmf::kGridThreads, 1)
grid_walk_kernel(const WalkArgs a, float* xchg, unsigned* sync, float* wstream,
                 const GridPlan plan) {
  constexpr bool kLowrank = Form == kLowrankPre, kPost = Form == kDensePost;
  extern __shared__ __align__(16) float gsm[];
  const int h = a.h, r = a.r, g3 = 3 * h, rpad = plan.rpad;
  const int grp = blockIdx.x / plan.ctas, q = blockIdx.x % plan.ctas;
  const int b0 = split_at(grp, a.batch, plan.groups);
  const int rows = split_at(grp + 1, a.batch, plan.groups) - b0;
  const int j0 = split_at(q, h, plan.ctas), jw = split_at(q + 1, h, plan.ctas) - j0;
  const int k0 = kLowrank ? split_at(q, r, plan.ctas) : 0;
  const int kw = kLowrank ? split_at(q + 1, r, plan.ctas) - k0 : 0;
  const vmlmf::gru::GridWidths wd(Form, h, r, plan);
  const int jwp = wd.jwp, kwp = wd.kwp, slab = jwp * rpad;
  const int da = kLowrank ? g3 : 0, db = kLowrank ? r : g3;
  // resident depths: every row without a ring
  const int resa = OnRing ? plan.res_a : da, resb = OnRing ? plan.res_b : db;

  float* wa = gsm;                      // [Prz; Pn]^T rows of the k-slice [3h][kwp], rows < resa
  float* wb = wa + (size_t)resa * kwp;  // [Prz; Pn]^T or Uf^T rows of the j-slice [db][jwp]
  float* dhc = gsm + vmlmf::weight_floats<float>((size_t)resa * kwp + (size_t)resb * jwp);
  float* pa = dhc + slab;               // staged inputs r, z, n, h_prev, dys, recn [k][jwp][rpad]
  float* stage = pa + (kPost ? 6 : 5) * slab;  // on a ring, the ring
  float* red = stage + (OnRing ? vmlmf::ring_floats(plan) : (size_t)plan.stage);
  float* sa = wstream + (OnRing ? blockIdx.x * vmlmf::gru::grid_stream_floats(
                                                  Form, h, r, plan, true)
                                : 0);
  const vmlmf::gru::GridSlice sla{wa, sa, da, resa, kwp, kwp};
  const vmlmf::gru::GridSlice slb{wb, sa + (size_t)(da - resa) * kwp, db, resb, jwp, jwp};
  const size_t dpar = (size_t)plan.groups * g3 * rpad;
  float* dpx = xchg + (size_t)grp * g3 * rpad;  // parity p at dpx + p * dpar
  float* ux = xchg + 2 * dpar + (size_t)grp * r * rpad;
  unsigned* count = sync + grp;
  unsigned target = 0;

  // the slices, loaded once along the rows of Prz, Pn and Uf (coalesced):
  // element (d, c) of a slice is row c of the weight, column d
  if constexpr (kLowrank) {
#pragma unroll 4
    for (int e = threadIdx.x; e < kwp * g3; e += blockDim.x) {
      const int kk = e / g3, d = e % g3, k = k0 + kk;
      const float v = kk >= kw ? 0.f
                      : d < 2 * h ? a.prz[(size_t)k * 2 * h + d]
                                  : a.pn[(size_t)k * h + d - 2 * h];
      sla.store(d, kk, v);
    }
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < jwp * db; e += blockDim.x) {
    const int jj = e / db, d = e % db, j = j0 + jj;
    float v = 0.f;
    if (jj < jw) {
      if constexpr (kLowrank)
        v = a.uf[(size_t)j * r + d];
      else
        v = d < 2 * h ? a.prz[(size_t)j * 2 * h + d] : a.pn[(size_t)j * h + d - 2 * h];
    }
    slb.store(d, jj, v);
  }
  for (int e = threadIdx.x; e < slab; e += blockDim.x) dhc[e] = 0.f;

  // step t's inputs of the j-slice's live rows into pa
  auto prefetch = [&](int t) {
    const size_t m0 = (size_t)t * a.batch + b0;
    const int n = jw * rows, kinds = kPost ? 6 : 5;
    for (int e = threadIdx.x; e < kinds * n; e += blockDim.x) {
      const int k = e / n, jj = e % jw, row = (e % n) / jw, j = j0 + jj;
      const size_t m = m0 + row;
      const float* src = k < 3   ? a.gates + m * g3 + k * h + j
                         : k == 3 ? (t > 0 ? a.ys + (m - a.batch) * h + j
                                           : a.h0 + (size_t)(b0 + row) * h + j)
                         : k == 4 ? a.dys + m * h + j
                                  : a.recn + m * h + j;
      vmlmf::cp_async4(pa + (size_t)(k * jwp + jj) * rpad + row, src);
    }
  };
  prefetch(a.t_len - 1);

  // the products' operands, from the exchange rows at src: (B) dn_pre @
  // Pn^T of the k-slice (low-rank) or j-slice (dense "pre"); (C) [dr_pre,
  // dz_pre(, dn_pre * r)] @ [Prz(; Pn)]^T; drhu or dhu @ Uf^T
  auto op_b = [&](const float* src) {
    return kLowrank ? sla.rows(src, 2 * h, h, 0, kwp) : slb.rows(src, 2 * h, h, 0, jwp);
  };
  auto op_c = [&](const float* src) {
    return kLowrank ? sla.rows(src, 0, 2 * h, 0, kwp)
                    : slb.rows(src, 0, kPost ? g3 : 2 * h, 0, jwp);
  };
  auto op_uf = [&](const float* src) { return slb.rows(src, 0, r, 0, jwp); };
  vmlmf::Ring ring;
  auto product = [&](const vmlmf::RingOperand<float>& op, auto epi) {
    vmlmf::gru::grid_product<OnRing, R>(ring, op, plan, stage, red, epi);
  };
  auto preload = [&](const vmlmf::RingOperand<float>& op) {
    if constexpr (OnRing) ring.preload<R>(op);
  };
  // the first product of a step, whose exchange (A) is of parity t
  auto first_op = [&](int t) {
    const float* dpx_t = dpx + (t & 1) * dpar;
    return kPost ? op_c(dpx_t) : op_b(dpx_t + (size_t)2 * h * rpad);
  };
  if constexpr (OnRing) {
    ring.start(stage, plan);
    if (a.t_len > 0) preload(first_op(a.t_len - 1));
  }

  // epilogues: dh += the product (C); a rank product into the exchange and
  // its dpre-side output (drhu, dhu); drh's (B)
  auto add_carry = [&](int cb, int rb, float (&acc)[4][R]) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jj = 4 * cb + c;
      if (jj >= jw) continue;
#pragma unroll
      for (int i = 0; i < R; ++i) dhc[jj * rpad + R * rb + i] += acc[c][i];
    }
  };
  for (int t = a.t_len - 1; t >= 0; --t) {
    float* dpx_t = dpx + (t & 1) * dpar;
    const size_t m0 = (size_t)t * a.batch + b0;
    auto rank_out = [&](float* out) {
      return [&, out](int cb, int rb, float (&acc)[4][R]) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kk = 4 * cb + c;
          if (kk >= kw) continue;
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const int row = R * rb + i;
            ux[(size_t)(k0 + kk) * rpad + row] = acc[c][i];
            if (row < rows) out[(m0 + row) * r + k0 + kk] = acc[c][i];
          }
        }
      };
    };
    auto drh_out = [&](int cb, int rb, float (&acc)[4][R]) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jj = 4 * cb + c;
        if (jj >= jw) continue;
        const int j = j0 + jj;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int row = R * rb + i, at = jj * rpad + row;
          if (row >= rows) continue;
          const float drh = acc[c][i], rg = pa[at];
          const float dr_pre = drh * pa[3 * slab + at] * rg * (1.f - rg);
          a.dpre[(m0 + row) * g3 + j] = dr_pre;
          dpx_t[(size_t)j * rpad + row] = dr_pre;
          dhc[at] += drh * rg;
        }
      }
    };
    vmlmf::cp_async_wait_all();
    __syncthreads();  // pa, and the carry that C wrote

    // (A) the elementwise part of the j-slice
    for (int e = threadIdx.x; e < jw * rpad; e += blockDim.x) {
      const int jj = e % jw, row = e / jw, j = j0 + jj, at = jj * rpad + row;
      if (row >= rows) {
        for (int g = 0; g < 3; ++g) dpx_t[(size_t)(g * h + j) * rpad + row] = 0.f;
        continue;
      }
      const float rg = pa[at], z = pa[slab + at], n = pa[2 * slab + at];
      const float dh = dhc[at] + pa[4 * slab + at];
      const float dz_pre = dh * (pa[3 * slab + at] - n) * z * (1.f - z);
      const float dn_pre = dh * (1.f - z) * (1.f - n * n);
      float* dg = a.dpre + (m0 + row) * g3;
      dg[h + j] = dz_pre;
      dg[2 * h + j] = dn_pre;
      dhc[at] = dh * z;
      dpx_t[(size_t)(h + j) * rpad + row] = dz_pre;
      if (kPost) {
        const float dr_pre = dn_pre * pa[5 * slab + at] * rg * (1.f - rg);
        dg[j] = dr_pre;
        dpx_t[(size_t)j * rpad + row] = dr_pre;
        dpx_t[(size_t)(2 * h + j) * rpad + row] = dn_pre * rg;
      } else {
        dpx_t[(size_t)(2 * h + j) * rpad + row] = dn_pre;
      }
    }
    vmlmf::group_sync(count, plan.ctas, target);

    if constexpr (kPost) {
      if (t > 0) prefetch(t - 1);
      product(op_c(dpx_t), add_carry);
    } else {
      const float* dn_rows = dpx_t + (size_t)2 * h * rpad;
      if constexpr (kLowrank) {  // drhu = dn_pre @ Pn^T, then drh = drhu @ Uf^T
        product(op_b(dn_rows), rank_out(a.drhu));
        preload(op_uf(ux));
        vmlmf::group_sync(count, plan.ctas, target);
        product(op_uf(ux), drh_out);
      } else {  // drh = dn_pre @ Pn^T
        product(op_b(dn_rows), drh_out);
      }
      preload(op_c(dpx_t));
      vmlmf::group_sync(count, plan.ctas, target);
      if (t > 0) prefetch(t - 1);
      if constexpr (kLowrank) {  // dhu = [dr_pre, dz_pre] @ Prz^T, then dh += dhu @ Uf^T
        product(op_c(dpx_t), rank_out(a.dhu));
        preload(op_uf(ux));
        vmlmf::group_sync(count, plan.ctas, target);
        product(op_uf(ux), add_carry);
      } else {  // dh += [dr_pre, dz_pre] @ Prz^T
        product(op_c(dpx_t), add_carry);
      }
    }
    if (t > 0) preload(first_op(t - 1));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < jw * rows; e += blockDim.x) {
    const int jj = e % jw, row = e / jw;
    a.dh0[(size_t)(b0 + row) * h + j0 + jj] = dhc[jj * rpad + row];
  }
}

// The launch of the grid walk with items of R rows (`args` as
// grid_walk_kernel takes them), on the ring where the plan has one.
template <int Form, int R>
cudaError_t launch_walk_tile(const GridPlan& plan, unsigned* sync, void** args,
                             cudaStream_t stream) {
  return plan.piece ? vmlmf::launch_grid(grid_walk_kernel<Form, true, R>, plan, sync, args,
                                         stream, 0, vmlmf::kRingThreads)
                    : vmlmf::launch_grid(grid_walk_kernel<Form, false, R>, plan, sync, args,
                                         stream);
}

template <int Form>
cudaError_t grid_walk(const WalkArgs& io, float* xchg, unsigned* sync, float* wstream,
                      size_t wstream_floats, GridPlan plan, cudaStream_t stream) {
  using vmlmf::gru::grid_smem_floats;
  using vmlmf::gru::grid_stream_floats;
  if (!vmlmf::gru::grid_resident_ok(Form, io.h, io.r, plan, true) ||
      !vmlmf::gru::grid_ring_ok(Form, io.h, io.r, plan, true) ||
      sizeof(float) * grid_smem_floats(Form, io.h, io.r, plan, true) > (size_t)plan.smem ||
      plan.groups > io.batch || xchg == nullptr || sync == nullptr)
    return cudaErrorInvalidValue;
  const size_t streamed = grid_stream_floats(Form, io.h, io.r, plan, true);
  if (streamed * plan.groups * plan.ctas > wstream_floats || (streamed > 0 && wstream == nullptr))
    return cudaErrorInvalidValue;
  WalkArgs a = io;
  void* args[] = {&a, &xchg, &sync, &wstream, &plan};
  switch (plan.tile) {
    case 4:
      return launch_walk_tile<Form, 4>(plan, sync, args, stream);
    case 8:
      return launch_walk_tile<Form, 8>(plan, sync, args, stream);
    default:
      return launch_walk_tile<Form, 12>(plan, sync, args, stream);
  }
}

cudaError_t grid_walk_form(const WalkArgs& a, int form, float* xchg, unsigned* sync,
                           float* wstream, size_t wstream_floats, GridPlan plan,
                           cudaStream_t stream) {
  switch (form) {
    case kLowrankPre:
      return grid_walk<kLowrankPre>(a, xchg, sync, wstream, wstream_floats, plan, stream);
    case kDensePre:
      return grid_walk<kDensePre>(a, xchg, sync, wstream, wstream_floats, plan, stream);
    case kDensePost:
      return grid_walk<kDensePost>(a, xchg, sync, wstream, wstream_floats, plan, stream);
    default:
      return cudaErrorInvalidValue;
  }
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

// dbias = ones^T dPre: the column sums as a product with k = M.
struct Ones {
  static constexpr bool kContigJ = true;
  __device__ __forceinline__ float operator()(int, int) const { return 1.f; }
};

// [A1 | A2] along k: element (i, kk) = A1(i, kk) for kk < k1, else
// A2(i, kk - k1); dUf's two terms as one product over 2M rows.
template <class A1, class A2>
struct ConcatK {
  A1 a1;
  A2 a2;
  int k1;
  static constexpr bool kContigJ = A1::kContigJ;
  __device__ __forceinline__ float operator()(int i, int kk) const {
    return kk < k1 ? a1(i, kk) : a2(i, kk - k1);
  }
};

// [B1; B2] along k: element (kk, j) = B1(kk, j) for kk < k1, else B2(kk - k1, j).
template <class B1, class B2>
struct ConcatRows {
  B1 b1;
  B2 b2;
  int k1;
  static constexpr bool kContigJ = B1::kContigJ;
  __device__ __forceinline__ float operator()(int kk, int j) const {
    return kk < k1 ? b1(kk, j) : b2(kk - k1, j);
  }
};

// The sources under the composites, for the Hopper tile's staging
// (gemm_tc.cuh::Source, found by argument-dependent lookup): R * Hprev and
// its transpose gate Hprev's rows by the first h columns of the gates' rows;
// dN * R gates dPre's n columns by them; [Hprev; R * Hprev] along k stacks
// Hprev's rows over the gated ones; [dHU; dRHU] is two row blocks.
vmlmf::tc::wg::Source source_of(const GatedPrev& v) {
  return {v.first, v.rest, v.nfirst, v.ld, v.gates, 3 * v.ld, 0};
}
vmlmf::tc::wg::Source source_of(const GatedPrevT& v) {
  return {v.first, v.rest, v.nfirst, v.ld, v.gates, 3 * v.ld, 0};
}
vmlmf::tc::wg::Source source_of(const RowProduct& v) {
  return {v.a, nullptr, INT_MAX, v.ld, v.b, v.ld, 0};
}
vmlmf::tc::wg::Source source_of(const ConcatK<vmlmf::PrevRowsT, GatedPrevT>& v) {
  return {v.a1.first, v.a1.rest, v.a1.nfirst, v.a1.ld, v.a2.gates, 3 * v.a1.ld, v.k1};
}
vmlmf::tc::wg::Source source_of(const ConcatRows<vmlmf::RowMajor, vmlmf::RowMajor>& v) {
  return {v.b1.p, v.b2.p, v.k1, v.b1.ld};
}

// The serial walk of the given form; returns the launch's error.
cudaError_t walk_form(const WalkArgs& a, int form, int threads, int smem, cudaStream_t stream) {
  switch (form) {
    case kLowrankPre:
      return walk<kLowrankPre>(a, threads, smem, stream);
    case kDensePre:
      return walk<kDensePre>(a, threads, smem, stream);
    case kDensePost:
      return walk<kDensePost>(a, threads, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The x side's products, appended to the recurrent ones: none in gi mode
// (x null); dUx = X^T dXU (dXU = dPre for a dense x side), dVx = XU^T dPre
// (low-rank), dbias = ones^T dPre, and, when dx is given, dx = dXU Ux^T.
struct XSide {
  const float* x;
  const float* ux;
  const float* vx;
  const float* xu;
  const float* dpre;
  const float* dxu;
  float* dx;
  float* dux;
  float* dvx;
  float* dbias;
  int f, rx, h, m;
};

// Where the BPTT's products run: the Hopper tile's staged copies (st), and
// the split-k scratch that its products and the group share in turn.
struct Tc {
  vmlmf::tc::Staging* st;
  float* partial;
  size_t partial_floats;
  cudaStream_t stream;
};

// Runs product p on gemm_tc.cuh's Hopper tile where wg_route sends it, with
// as many k slices as the scratch holds of its plan, and takes it out of the
// group (m = 0: no CTA, no output); else leaves it there.
template <class P>
cudaError_t take_routed(P& p, const Tc& tc) {
  if (p.m <= 0 || !vmlmf::tc::wg_route(p.m, p.n, p.k)) return cudaSuccess;
  const size_t room = tc.partial_floats / ((size_t)p.m * p.n);
  const vmlmf::tc::Plan plan = vmlmf::tc::wg_plan(p.m, p.n, p.k, room, false);
  const cudaError_t err = vmlmf::tc::run_wg<false>(*tc.st, p.a, p.b, p.epi, p.m, p.n, p.k, plan,
                                                   tc.partial, tc.stream);
  p.m = 0;
  return err;
}

// The recurrent products `rec` (routed first, take_routed) and the others in
// one grouped split-k with the slice length `kslice`, which the caller takes
// over every weight gradient, the routed ones too, so that the products
// left in the group keep the slices, and the bits, they had with them.
template <class Others, class... R>
cudaError_t group_rest(const Tc& tc, int kslice, Others others, R... rec) {
  cudaError_t err = cudaSuccess;
  ((err = err != cudaSuccess ? err : take_routed(rec, tc)), ...);
  if (err != cudaSuccess) return err;
  return others(kslice, rec...);
}

// The weight gradients' group, with dx in it when asked for; the slice
// length is the weight gradients' own, so their sums do not depend on dx.
template <class... R>
cudaError_t with_dx(const XSide& xs, const Tc& tc, int kslice, R... products) {
  using vmlmf::RowMajor;
  using vmlmf::Store;
  using vmlmf::Transposed;
  if (xs.dx == nullptr)
    return vmlmf::gemm_splitk_group(tc.partial, tc.partial_floats, kslice, tc.stream,
                                    products...);
  const int kx = xs.vx == nullptr ? 3 * xs.h : xs.rx;  // dx [M, F] = dXU Ux^T
  return vmlmf::gemm_splitk_group(
      tc.partial, tc.partial_floats, kslice, tc.stream, products...,
      vmlmf::split_product(RowMajor{xs.vx == nullptr ? xs.dpre : xs.dxu, kx},
                           Transposed{xs.ux, kx}, Store{xs.dx, xs.f}, xs.m, xs.f, kx));
}

template <class... R>
cudaError_t weight_grads(const XSide& xs, const Tc& tc, R... rec) {
  using vmlmf::RowMajor;
  using vmlmf::split_product;
  using vmlmf::Store;
  using vmlmf::Transposed;
  if (xs.x == nullptr)
    return group_rest(tc, vmlmf::group_kslice(rec...),
                      [&](int kslice, auto... left) {
                        return vmlmf::gemm_splitk_group(tc.partial, tc.partial_floats, kslice,
                                                        tc.stream, left...);
                      },
                      rec...);
  const int g3 = 3 * xs.h, f = xs.f, rx = xs.rx, m = xs.m;
  const auto dbias = split_product(Ones{}, RowMajor{xs.dpre, g3}, Store{xs.dbias, g3}, 1, g3, m);
  if (xs.vx == nullptr) {
    const auto dux =
        split_product(Transposed{xs.x, f}, RowMajor{xs.dpre, g3}, Store{xs.dux, g3}, f, g3, m);
    return group_rest(tc, vmlmf::group_kslice(rec..., dux, dbias),
                      [&](int kslice, auto... left) {
                        return with_dx(xs, tc, kslice, left..., dux, dbias);
                      },
                      rec...);
  }
  const auto dux =
      split_product(Transposed{xs.x, f}, RowMajor{xs.dxu, rx}, Store{xs.dux, rx}, f, rx, m);
  const auto dvx =
      split_product(Transposed{xs.xu, rx}, RowMajor{xs.dpre, g3}, Store{xs.dvx, g3}, rx, g3, m);
  return group_rest(tc, vmlmf::group_kslice(rec..., dux, dvx, dbias),
                    [&](int kslice, auto... left) {
                      return with_dx(xs, tc, kslice, left..., dux, dvx, dbias);
                    },
                    rec...);
}

// Every weight gradient whose k runs over the M rows: the recurrent side's,
// from the residuals (saved or rebuilt), dpre and, low-rank, dhu and drhu,
// each on the Hopper tile where wg_route sends it; then the x side's (xs)
// and the recurrent ones left, in one grouped split-k. Writes duf, dprz,
// dpn (and dux, dvx, dbias). Returns the first error.
cudaError_t grouped_grads(const float* h0, const float* ys, const float* gates, const float* hu,
                          const float* rhu, const float* dpre, const float* dhu,
                          const float* drhu, float* duf, float* dprz, float* dpn,
                          const XSide& xs, const Tc& tc, int t_len, int batch, int h, int r,
                          int form) {
  using vmlmf::RowMajor;
  using vmlmf::split_product;
  using vmlmf::Store;
  using vmlmf::Transposed;
  const int m = t_len * batch, g3 = 3 * h;
  const vmlmf::PrevRowsT hprev_t{h0, ys, batch, h};
  const GatedPrevT rh_t{gates, h0, ys, batch, h};
  // dPrz = Hprev^T [dR dZ] (dense) or HU^T [dR dZ] (low-rank)
  const auto dprz_dense =
      split_product(hprev_t, RowMajor{dpre, g3}, Store{dprz, 2 * h}, h, 2 * h, m);
  switch (form) {
    case kLowrankPre:  // dPn [r, h] = RHU^T dN;  dUf [h, r] = [Hprev | RH]^T [dHU; dRHU]
      return weight_grads(
          xs, tc,
          split_product(Transposed{hu, r}, RowMajor{dpre, g3}, Store{dprz, 2 * h}, r, 2 * h, m),
          split_product(Transposed{rhu, r}, RowMajor{dpre + 2 * h, g3}, Store{dpn, h}, r, h, m),
          split_product(ConcatK<vmlmf::PrevRowsT, GatedPrevT>{hprev_t, rh_t, m},
                        ConcatRows<RowMajor, RowMajor>{RowMajor{dhu, r}, RowMajor{drhu, r}, m},
                        Store{duf, r}, h, r, 2 * m));
    case kDensePre:  // dPn [h, h] = (R * Hprev)^T dN
      return weight_grads(
          xs, tc, dprz_dense,
          split_product(rh_t, RowMajor{dpre + 2 * h, g3}, Store{dpn, h}, h, h, m));
    case kDensePost:  // dPn [h, h] = Hprev^T (dN * R)
      return weight_grads(
          xs, tc, dprz_dense,
          split_product(hprev_t, RowProduct{dpre + 2 * h, gates, g3}, Store{dpn, h}, h, h, m));
    default:
      return cudaErrorInvalidValue;
  }
}

// c = epi(A @ B): on the Hopper tile where wg_route sends it (unsplit),
// staging its copies from the scratch's start (each pre-pass product is done
// with the one before's copies and raw sums), else on gemm_tile.cuh's tile
// as before.
template <class A, class B, class Epi>
cudaError_t routed_gemm(vmlmf::tc::Staging& st, A a, B b, Epi epi, int m, int n, int k,
                        cudaStream_t stream) {
  if (vmlmf::tc::wg_route(m, n, k)) {
    st.reset();
    return vmlmf::tc::run_wg<false>(st, a, b, epi, m, n, k, vmlmf::tc::wg_plan(m, n, k, 0, false),
                                    nullptr, stream);
  }
  return vmlmf::gemm(a, b, epi, m, n, k, stream);
}

// The recompute policy's pre-pass: rebuilds gates [M, 3h], hu and rhu [M, r]
// (low-rank), recn [M, h] ("post") and xu [M, rx] (low-rank x side) from x
// and Hprev, as the header sets out; its recurrent products on the Hopper
// tile where wg_route sends them (routed_gemm), the x side's projection on
// gemm_tile.cuh as the forward runs it. Returns the first error.
cudaError_t recompute(const float* x, const float* ux, const float* vx, const float* bias,
                      const float* uf, const float* prz, const float* pn, const float* h0,
                      const float* ys, float* gates, float* hu, float* rhu, float* recn,
                      float* xu, int t_len, int batch, int f, int rx, int h, int r, int form,
                      vmlmf::tc::Staging& st, cudaStream_t stream) {
  const int m = t_len * batch;
  using vmlmf::RowMajor;
  using vmlmf::Store;
  // G = X Ux + bias, or XU = X Ux;  G = XU Vx + bias
  cudaError_t err = project(x, ux, vx, bias, xu, gates, m, f, rx, h, stream);
  if (err != cudaSuccess) return err;

  const vmlmf::PrevRows hprev{h0, ys, batch, h};
  const GatedPrev rh{gates, h0, ys, batch, h};
  if (form == kLowrankPre) {
    // HU = Hprev Uf;  [R Z] = sigmoid(G_rz + HU Prz)
    err = routed_gemm(st, hprev, RowMajor{uf, r}, Store{hu, r}, m, r, h, stream);
    if (err != cudaSuccess) return err;
    err = routed_gemm(st, RowMajor{hu, r}, RowMajor{prz, 2 * h}, RzEpilogue{gates, h}, m, 2 * h, r,
                      stream);
    if (err != cudaSuccess) return err;
    // RHU = (R * Hprev) Uf;  N = tanh(G_n + RHU Pn)
    err = routed_gemm(st, rh, RowMajor{uf, r}, Store{rhu, r}, m, r, h, stream);
    if (err != cudaSuccess) return err;
    return routed_gemm(st, RowMajor{rhu, r}, RowMajor{pn, h}, NEpilogue{gates, h}, m, h, r, stream);
  }
  // [R Z] = sigmoid(G_rz + Hprev Prz); where the Hopper tile takes a half,
  // as two products of h columns, so that one product's copies (half of
  // Prz's) need no more room than the weight gradients' (the policy is
  // there to save memory; ops/cuda_gru.py::gru_tc_stage_floats)
  if (vmlmf::tc::wg_route(m, h, h)) {
    err = routed_gemm(st, hprev, RowMajor{prz, 2 * h}, RzEpilogue{gates, h}, m, h, h, stream);
    if (err == cudaSuccess)
      err = routed_gemm(st, hprev, RowMajor{prz + h, 2 * h}, RzEpilogue{gates + h, h}, m, h, h,
                        stream);
  } else {
    err = routed_gemm(st, hprev, RowMajor{prz, 2 * h}, RzEpilogue{gates, h}, m, 2 * h, h, stream);
  }
  if (err != cudaSuccess) return err;
  if (form == kDensePre)  // N = tanh(G_n + (R * Hprev) Pn)
    return routed_gemm(st, rh, RowMajor{pn, h}, NEpilogue{gates, h}, m, h, h, stream);
  // RECN = Hprev Pn;  N = tanh(G_n + R * RECN)
  return routed_gemm(st, hprev, RowMajor{pn, h}, PostNEpilogue{gates, recn, h}, m, h, h, stream);
}

// The whole BPTT once the residuals are there or rebuilt: `walk` (the row
// walk or the grid walk, a callable on WalkArgs returning a cudaError_t),
// then in x mode dXU = dPre Vx^T (low-rank x side) and the grouped split-k
// of every gradient whose k runs over the M rows. gates null is the
// recompute policy (x mode only), whose pre-pass fills the *_w scratch
// first. Returns the first error.
template <class Walk>
cudaError_t bptt(const float* x, const float* ux, const float* vx, const float* uf,
                 const float* prz, const float* pn, const float* h0, const float* ys,
                 const float* gates, const float* hu, const float* rhu, const float* recn,
                 const float* xu, const float* dys, const float* bias, float* gates_w,
                 float* hu_w, float* rhu_w, float* recn_w, float* xu_w, float* dpre, float* dhu,
                 float* drhu, float* dxu, float* partial, float* dx, float* dux, float* dvx,
                 float* dbias, float* duf, float* dprz, float* dpn, float* dh0, float* staged,
                 int t_len, int batch, int f, int rx, int h, int r, int form, int partial_floats,
                 int staged_floats, cudaStream_t stream, Walk walk) {
  const int m = t_len * batch;
  const int g3 = 3 * h;
  using vmlmf::RowMajor;
  using vmlmf::Store;
  using vmlmf::Transposed;
  cudaError_t err;
  vmlmf::tc::Staging st(staged, staged == nullptr ? 0 : static_cast<size_t>(staged_floats));

  if (gates == nullptr) {  // the recompute policy
    if (x == nullptr || bias == nullptr || gates_w == nullptr) return cudaErrorInvalidValue;
    err = recompute(x, ux, vx, bias, uf, prz, pn, h0, ys, gates_w, hu_w, rhu_w, recn_w, xu_w,
                    t_len, batch, f, rx, h, r, form, st, stream);
    if (err != cudaSuccess) return err;
    gates = gates_w;
    hu = hu_w;
    rhu = rhu_w;
    recn = recn_w;
    xu = xu_w;
  }
  const WalkArgs wa{gates, ys, h0, recn, dys, uf, prz, pn, dpre, dhu, drhu, dh0, nullptr,
                    t_len, batch, h, r, 0, 0, 0};
  err = walk(wa);
  if (err != cudaSuccess) return err;
  if (x != nullptr && vx != nullptr) {  // dXU [M, rx] = dPre Vx^T, which dUx and dx read
    const auto dxu_p =
        vmlmf::split_product(RowMajor{dpre, g3}, Transposed{vx, g3}, Store{dxu, rx}, m, rx, g3);
    err = vmlmf::gemm_splitk_group(partial, partial_floats, vmlmf::group_kslice(dxu_p), stream,
                                   dxu_p);
    if (err != cudaSuccess) return err;
  }
  st.reset();  // the pre-pass's copies are done with
  const XSide xs = x == nullptr ? XSide{}
                                : XSide{x, ux, vx, xu, dpre, dxu, dx, dux, dvx, dbias, f, rx, h, m};
  return grouped_grads(h0, ys, gates, hu, rhu, dpre, dhu, drhu, duf, dprz, dpn, xs,
                       Tc{&st, partial, static_cast<size_t>(partial_floats), stream}, t_len,
                       batch, h, r, form);
}

// The row walk of gru_plan's layout: rows, threads, rec_res, smem, spill.
struct RowWalk {
  float* state;
  int form, rows, threads, rec_res, smem, spill;
  cudaStream_t stream;
  cudaError_t operator()(WalkArgs a) const {
    a.state = state;
    a.rows = rows;
    a.rec_res = rec_res;
    a.spill = spill;
    return walk_form(a, form, threads, smem, stream);
  }
};

// The grid walk of gru_grid_plan's layout.
struct GridWalk {
  float* xchg;
  unsigned* sync;
  float* wstream;
  size_t wstream_floats;
  int form;
  GridPlan plan;
  cudaStream_t stream;
  cudaError_t operator()(const WalkArgs& a) const {
    return grid_walk_form(a, form, xchg, sync, wstream, wstream_floats, plan, stream);
  }
};

}  // namespace

// The row-layout entries take, after the sizes and the form, the split-k's
// scratch size (floats of `partial`, ops/cuda_gru.py::gru_bwd_partial_floats),
// the Hopper tile's (floats of `staged`) and the walk's plan from
// ops/cuda_gru.py::gru_plan: rows, threads, rec_res,
// smem (bytes), spill (floats a CTA of `state`, the walk's device-memory
// scratch of a spill plan, which the caller allocates,
// cuda_gru.py::state_floats; null when 0).

// x mode: launches the pre-pass (recompute policy), the walk, the GEMMs
// and the column sums on `stream`; returns the first error. gates, hu,
// rhu, recn and xu are the residual forward's (uf, hu, rhu, duf null in the
// dense recurrent forms, recn outside "post"; vx, xu, dvx for a dense x
// side). gates null is the recompute policy: bias is then given, hu, rhu,
// recn and xu are null, and gates_w [T*B, 3h], hu_w and rhu_w [T*B, r]
// (low-rank), recn_w [T*B, h] ("post") and xu_w [T*B, rx] (low-rank x
// side) are the scratch that the pre-pass fills; they are null otherwise.
// dpre [T*B, 3h], dhu and drhu [T*B, r] (low-rank; else null), dxu
// [T*B, rx] (low-rank x side; else null), partial and staged (staged_floats
// floats: the Hopper tile's copies, ops/cuda_gru.py::gru_tc_stage_floats;
// null where no product takes that tile) are scratch that the caller
// allocates; every pointer after them is an output. dx may be null (not
// computed).
extern "C" int gru_scan_xin_bwd(
    const float* x, const float* ux, const float* vx, const float* uf, const float* prz,
    const float* pn, const float* h0, const float* ys, const float* gates, const float* hu,
    const float* rhu, const float* recn, const float* xu, const float* dys, const float* bias,
    float* gates_w, float* hu_w, float* rhu_w, float* recn_w, float* xu_w, float* dpre,
    float* dhu, float* drhu, float* dxu, float* partial, float* staged, float* dx, float* dux,
    float* dvx, float* dbias, float* duf, float* dprz, float* dpn, float* dh0, float* state,
    int t_len, int batch, int f, int rx, int h, int r, int form, int partial_floats,
    int staged_floats, int rows, int threads, int rec_res, int smem, int spill,
    void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (x == nullptr) return cudaErrorInvalidValue;
  return bptt(x, ux, vx, uf, prz, pn, h0, ys, gates, hu, rhu, recn, xu, dys, bias, gates_w, hu_w,
              rhu_w, recn_w, xu_w, dpre, dhu, drhu, dxu, partial, dx, dux, dvx, dbias, duf, dprz,
              dpn, dh0, staged, t_len, batch, f, rx, h, r, form, partial_floats, staged_floats,
              stream, RowWalk{state, form, rows, threads, rec_res, smem, spill, stream});
}

// gi mode: the walk and the recurrent weight gradients on `stream`; returns
// the first error. The residuals as gru_scan_xin_bwd takes them (saved: gi
// mode always saves the gates); dgi [T*B, 3h] is dPre, an output; dhu and
// drhu [T*B, r] (low-rank; else null), partial and staged are scratch; duf
// (low-rank; else null), dprz, dpn and dh0 are outputs.
extern "C" int gru_scan_bwd(const float* uf, const float* prz, const float* pn,
                            const float* h0, const float* ys, const float* gates,
                            const float* hu, const float* rhu, const float* recn,
                            const float* dys, float* dgi, float* dhu, float* drhu, float* partial,
                            float* staged, float* duf, float* dprz, float* dpn, float* dh0,
                            float* state, int t_len, int batch, int h, int r, int form,
                            int partial_floats, int staged_floats, int rows, int threads,
                            int rec_res, int smem, int spill, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (gates == nullptr) return cudaErrorInvalidValue;
  return bptt(nullptr, nullptr, nullptr, uf, prz, pn, h0, ys, gates, hu, rhu, recn, nullptr, dys,
              nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, dgi, dhu, drhu, nullptr,
              partial, nullptr, nullptr, nullptr, nullptr, duf, dprz, dpn, dh0, staged, t_len,
              batch, 0, 0, h, r, form, partial_floats, staged_floats, stream,
              RowWalk{state, form, rows, threads, rec_res, smem, spill, stream});
}

// The grid layout of both BPTTs (ops/cuda_gru.py::gru_grid_plan): x mode
// when x is given, with gru_scan_xin_bwd's tensors; gi mode when x is null,
// with gru_scan_bwd's (dpre is then dgi, an output, and gates must be
// given). xchg, sync (a barrier word a group) and wstream (wstream_floats
// floats; null where the plan streams nothing) are the grid walk's scratch;
// the ten integers after partial_floats, staged_floats and wstream_floats
// are the plan's layout (GRUGridPlan.ints).
extern "C" int gru_grid_bwd(
    const float* x, const float* ux, const float* vx, const float* uf, const float* prz,
    const float* pn, const float* h0, const float* ys, const float* gates, const float* hu,
    const float* rhu, const float* recn, const float* xu, const float* dys, const float* bias,
    float* gates_w, float* hu_w, float* rhu_w, float* recn_w, float* xu_w, float* dpre,
    float* dhu, float* drhu, float* dxu, float* partial, float* staged, float* dx, float* dux,
    float* dvx, float* dbias, float* duf, float* dprz, float* dpn, float* dh0, float* xchg,
    unsigned* sync, float* wstream, int t_len, int batch, int f, int rx, int h, int r, int form,
    int partial_floats, int staged_floats, int wstream_floats, int groups, int ctas, int rpad,
    int stage, int red, int smem, int res_a, int res_b, int piece, int tile,
    void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (x == nullptr && gates == nullptr) return cudaErrorInvalidValue;
  const GridPlan plan{groups, ctas, rpad, stage, red, smem, res_a, res_b, piece, 0, tile};
  return bptt(x, ux, vx, uf, prz, pn, h0, ys, gates, hu, rhu, recn, xu, dys, bias, gates_w, hu_w,
              rhu_w, recn_w, xu_w, dpre, dhu, drhu, dxu, partial, dx, dux, dvx, dbias, duf, dprz,
              dpn, dh0, staged, t_len, batch, f, rx, h, r, form, partial_floats, staged_floats,
              stream, GridWalk{xchg, sync, wstream, static_cast<size_t>(wstream_floats), form,
                               plan, stream});
}

// A check of the BPTT's products on their own (ops/tc_check.py::
// gru_product), on no model's path: c = the product `product` from the
// residuals and dPre, as grouped_grads and recompute form it, on the Hopper
// tile (tile 0: 3xTF32, split by its own plan within `partial`, operands
// staged in `staged`) or on gemm_tile.cuh (tile 1: the product alone in a
// grouped split-k, the slices it would take in a group of its own).
// product: 0 dPrz = Hprev^T [dR dZ]; 1 dPn = (R * Hprev)^T dN ("pre"); 2
// dPn = Hprev^T (dN * R) ("post"); 3 dPrz = HU^T [dR dZ]; 4 dPn = RHU^T dN
// (low-rank); 5 dUf = [Hprev | R * Hprev]^T [dHU; dRHU]; 6 (R * Hprev) @ w
// (w [h, n], the recompute pre-pass's RHU or "pre" n product).
extern "C" int gru_tc_check(const float* h0, const float* ys, const float* gates,
                            const float* dpre, const float* hu, const float* rhu,
                            const float* dhu, const float* drhu, const float* w, float* c,
                            float* partial, float* staged, int product, int tile, int t_len,
                            int batch, int h, int r, int n, int partial_floats, int staged_floats,
                            void* stream_handle) {
  using vmlmf::RowMajor;
  using vmlmf::split_product;
  using vmlmf::Store;
  using vmlmf::Transposed;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (tile < 0 || tile > 1) return cudaErrorInvalidValue;
  const int m = t_len * batch, g3 = 3 * h;
  const vmlmf::PrevRowsT hprev_t{h0, ys, batch, h};
  const GatedPrevT rh_t{gates, h0, ys, batch, h};
  vmlmf::tc::Staging st(staged, staged == nullptr ? 0 : static_cast<size_t>(staged_floats));
  const Tc tc{&st, partial, partial == nullptr ? 0 : static_cast<size_t>(partial_floats), stream};
  auto run = [&](auto p) -> cudaError_t {
    if (tile == 0) {
      if (p.k < 1) return cudaErrorInvalidValue;
      const size_t room = tc.partial_floats / ((size_t)p.m * p.n);
      return vmlmf::tc::run_wg<false>(st, p.a, p.b, p.epi, p.m, p.n, p.k,
                                      vmlmf::tc::wg_plan(p.m, p.n, p.k, room, false), partial,
                                      stream);
    }
    return vmlmf::gemm_splitk_group(partial, tc.partial_floats, vmlmf::group_kslice(p), stream,
                                    p);
  };
  switch (product) {
    case 0:
      return run(split_product(hprev_t, RowMajor{dpre, g3}, Store{c, 2 * h}, h, 2 * h, m));
    case 1:
      return run(split_product(rh_t, RowMajor{dpre + 2 * h, g3}, Store{c, h}, h, h, m));
    case 2:
      return run(split_product(hprev_t, RowProduct{dpre + 2 * h, gates, g3}, Store{c, h}, h, h,
                               m));
    case 3:
      return run(split_product(Transposed{hu, r}, RowMajor{dpre, g3}, Store{c, 2 * h}, r, 2 * h,
                               m));
    case 4:
      return run(split_product(Transposed{rhu, r}, RowMajor{dpre + 2 * h, g3}, Store{c, h}, r, h,
                               m));
    case 5:
      return run(split_product(ConcatK<vmlmf::PrevRowsT, GatedPrevT>{hprev_t, rh_t, m},
                               ConcatRows<RowMajor, RowMajor>{RowMajor{dhu, r}, RowMajor{drhu, r},
                                                              m},
                               Store{c, r}, h, r, 2 * m));
    case 6:
      return run(split_product(GatedPrev{gates, h0, ys, batch, h}, RowMajor{w, n}, Store{c, n}, m,
                               n, h));
    default:
      return cudaErrorInvalidValue;
  }
}

// The message of an error code that an entry of this file returned.
extern "C" const char* gru_scan_xin_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
