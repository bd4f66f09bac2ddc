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
// low-rank Uf [h,r], Prz [r,2h], Pn [r,h]; dense Prz [h,2h], Pn [h,h]; all
// row-major and contiguous. The `form` argument picks the recurrent form
// (0 low-rank pre, 1 dense pre, 2 dense post).
//
// The residual variant also writes, per step, the post-nonlinearity gates
// [T,B,3h] (r, z, n in three blocks of h), and hu = h_prev @ Uf and rhu =
// (r*h_prev) @ Uf [T,B,r] (low-rank) or recn = h_prev @ Pn [T,B,h] (post).
// A low-rank x side keeps xu = x @ Ux [T*B,rx] as a residual for dVx; a
// dense one has none.
//
// What bounds it on an H100, and what the design does about it:
// * The recurrence is a chain of small dependent products: at the HAR
//   widths (h=64, r=9) a step is a few thousand multiply-adds a row, so the
//   time is set by the T steps' latency, not by bytes or flops. One launch
//   does the whole call. Each CTA owns `rows` batch rows (ops/cuda_gru.py::
//   gru_plan: few, so that the batch spreads over the SMs) and walks all T
//   steps with the carry in shared memory. The kernel is compiled for a row
//   bound R of 1, 2 or 4 and launched with the one the plan's rows need:
//   a row loop guarded by a run-time count would execute every row's
//   instructions, predicated off or not.
// * The input projection is time-parallel and runs inside the kernel, as
//   in the TPU kernel: each CTA stages its rows' x for a block of `tblock`
//   steps and projects them into a shared gi block (writing xu where the
//   residual forward keeps it); gi mode copies the caller's gi block
//   instead. No step then reads its input from device memory: the serial
//   chain touches shared memory and registers only, and its stores (ys and
//   the residuals) are never waited on.
// * A step's products go through gru_tile.cuh's unit groups: four lanes per
//   output unit, each summing a quarter of the depth with float4 loads,
//   added by two shuffles. In "post" the group of hidden unit j computes
//   its three columns (r, z and the candidate's h @ Pn) and the update in
//   one pass, so a step has one barrier, with the carry in two buffers
//   that take turns. "pre" needs r*h whole before its product: two
//   barriers (dense), four (low-rank: h @ Uf, the gates, (r*h) @ Uf, n).
// * A step reads every recurrent weight once. From shared memory that is
//   bound by its 128 bytes a cycle (48 KB a step in dense "post" at h=64),
//   so where each lane's share is small (h <= 64, r <= 16: at most 12
//   float4s) gru_plan keeps it in registers for the whole scan, loaded once
//   through L2, and a step reads only the rows from shared memory. Wider
//   weights stay in shared memory when they fit (the recurrent ones first,
//   then the x side's, then a shorter time block), quad-interleaved so that
//   a lane's float4 holds four depth elements of its column, else they are
//   read through L2 by the same code; the sums run in the same order on
//   every path.
// * Past the widths whose state fits beside weights read through L2 (one
//   row's gi block, x, carry, r*h and z: at h = 8,192 a dense "pre" CTA
//   needs 230 KB), gru_plan gives one row a CTA and `spill` floats of
//   leading regions (the gi block first, then x, xu and the carry) that
//   live in a per-CTA region of a device-memory scratch (`state`) instead
//   of shared memory. The kernel instance for it (Spill) maps each region
//   to its place and stages its inputs with plain loads where cp.async
//   cannot write; within a CTA, __syncthreads orders global memory as it
//   orders shared, so the order of work is the same.
// * Every edge (B, F, h, r, rx not multiples of anything) is masked.

#include <cuda_runtime.h>

#include "gru_grid.cuh"
#include "gru_tile.cuh"

namespace {

using namespace vmlmf::gru;
using vmlmf::cdiv;

constexpr int kGiMode = 0, kLowrankX = 1, kDenseX = 2;  // the input side

struct FwdArgs {
  const float* x;
  const float* ux;
  const float* vx;
  const float* bias;
  const float* gi;
  const float* uf;
  const float* prz;
  const float* pn;
  const float* h0;
  float* ys;
  float* gates;
  float* hu;
  float* rhu;
  float* recn;
  float* xu;
  float* state;
  int t_len, batch, f, rx, h, r;
  int rows, tblock, rec_res, x_res, spill;
};

// Float offsets of the shared regions, in the order of
// ops/cuda_gru.py::_fwd_floats: the resident weights (recurrent, then x
// side), the time block (gi, x, xu), the state (the carry's two buffers,
// r*h, hu, rhu, z). Offsets below a spill plan's `spill` lie in the CTA's
// region of the device-memory scratch, the others at offset - spill in
// shared memory.
struct FwdLayout {
  size_t uf, prz, pn, ux, vx, gib, xs, xub, hbuf, rh, hus, rhus, zs, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int form, int xside, const FwdArgs& a) {
  const bool lowrank = form == kLowrankPre, pre = form != kDensePost;
  const int h = a.h, g3 = 3 * a.h, depth4 = lowrank ? q4(a.r) : q4(a.h);
  const size_t mb = (size_t)a.tblock * a.rows;
  FwdLayout L{};
  size_t at = 0;
  const bool shared = a.rec_res == kInShared;
  L.uf = take(at, shared && lowrank ? (size_t)q4(h) * a.r : 0);
  L.prz = take(at, shared ? (size_t)depth4 * 2 * h : 0);
  L.pn = take(at, shared ? (size_t)depth4 * h : 0);
  L.ux = take(at, a.x_res && xside != kGiMode
                      ? (size_t)q4(a.f) * (xside == kLowrankX ? a.rx : g3) : 0);
  L.vx = take(at, a.x_res && xside == kLowrankX ? (size_t)q4(a.rx) * g3 : 0);
  L.gib = take(at, mb * g3);
  L.xs = take(at, xside != kGiMode ? mb * q4(a.f) : 0);
  L.xub = take(at, xside == kLowrankX ? mb * q4(a.rx) : 0);
  L.hbuf = take(at, (size_t)2 * a.rows * q4(h));
  L.rh = take(at, pre ? (size_t)a.rows * q4(h) : 0);
  L.hus = take(at, lowrank ? (size_t)a.rows * q4(a.r) : 0);
  L.rhus = take(at, lowrank ? (size_t)a.rows * q4(a.r) : 0);
  L.zs = take(at, pre ? (size_t)a.rows * h : 0);
  L.total = at;
  return L;
}

// out(m, c) = epi(m, c, sum_k a[m, k] * W[k, c]) for m < mrows, c < n: the
// time block's projection, all threads, four rows a thread; a is shared
// with row stride lda (a multiple of 4, zero past the depth).
template <class Epi>
__device__ __forceinline__ void block_gemm(const float* a, int lda, int mrows, const QuadCols& w,
                                           int n, Epi epi) {
  const int nq = lda / 4, mq = (mrows + 3) / 4;
  for (int item = threadIdx.x; item < mq * n; item += blockDim.x) {
    const int c = item % n, m0 = (item / n) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < nq; ++q) {
      const float4 wv = w.at(q, c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (m0 + i < mrows)
          acc[i] = dot4(reinterpret_cast<const float4*>(a + (size_t)(m0 + i) * lda)[q], wv,
                        acc[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (m0 + i < mrows) epi(m0 + i, c, acc[i]);
  }
}

// A lane's recurrent weights where the plan holds them in registers: the
// columns of its hidden unit j (Prz's r and z columns, Pn's) and, low-rank,
// Uf's column of its rank k; at most four quads of depth h a slice, one of
// depth r.
template <int Form>
struct FwdRegs {
  RegSlice<3, 4> rzn;  // "post": r, z and h @ Pn in one pass
};
template <>
struct FwdRegs<kDensePre> {
  RegSlice<2, 4> rz;
  RegSlice<1, 4> n;
};
template <>
struct FwdRegs<kLowrankPre> {
  RegSlice<1, 4> uf;
  RegSlice<2, 1> rz;
  RegSlice<1, 1> n;
};

template <int Form, int XSide, bool Residuals, int R, bool Spill>
__global__ void __launch_bounds__(kMaxThreads) fwd_kernel(const FwdArgs a) {
  constexpr bool kLowrank = Form == kLowrankPre;
  extern __shared__ float4 smem4[];
  float* const smem_base = reinterpret_cast<float*>(smem4);
  const FwdLayout L = fwd_layout(Form, XSide, a);
  // the region at layout offset `off` (Spill: the leading ones in device memory)
  float* const spilled = Spill ? a.state + (size_t)blockIdx.x * a.spill : nullptr;
  auto at = [&](size_t off) -> float* {
    if constexpr (Spill) return off < (size_t)a.spill ? spilled + off : smem_base + (off - a.spill);
    return smem_base + off;
  };
  // a staged input element: cp.async into shared memory, a plain copy where
  // the region may be in device memory
  auto stage4 = [](float* dst, const float* src) {
    if constexpr (Spill)
      *dst = __ldg(src);
    else
      vmlmf::cp_async4(dst, src);
  };
  float* const sm = smem_base;  // the resident weights: never spilled
  const int h = a.h, r = a.r, g3 = 3 * h, h4 = q4(h), r4 = q4(r), rows = a.rows;
  const int b0 = blockIdx.x * rows, live = min(rows, a.batch - b0);
  const Lanes ln;
  const int depth = kLowrank ? r : h, dq = (kLowrank ? r4 : h4) / 4;

  const bool shared = a.rec_res == kInShared, regs = a.rec_res == kInRegisters;
  if (shared) {
    if (kLowrank) stage_cols(sm + L.uf, a.uf, h, r);
    stage_cols(sm + L.prz, a.prz, depth, 2 * h);
    stage_cols(sm + L.pn, a.pn, depth, h);
  }
  auto shared4 = [&](size_t off, bool on) {
    return on ? reinterpret_cast<const float4*>(sm + off) : nullptr;
  };
  const QuadCols uf{a.uf, shared4(L.uf, shared && kLowrank), h, r};
  const QuadCols prz{a.prz, shared4(L.prz, shared), depth, 2 * h};
  const QuadCols pn{a.pn, shared4(L.pn, shared), depth, h};
  // one pass when in registers: the lane's unit is fixed for the scan
  const int jr = min(ln.unit, h - 1), kr = kLowrank ? min(ln.unit, r - 1) : 0;
  FwdRegs<Form> wr;
  if (regs) {  // through L2 once, all loads in flight
    if constexpr (Form == kDensePost) {
      wr.rzn.load(dq, ln.slice, [&](int i, int q) {
        return i == 0 ? prz.at(q, jr) : i == 1 ? prz.at(q, h + jr) : pn.at(q, jr);
      });
    } else {
      if constexpr (kLowrank)
        wr.uf.load(h4 / 4, ln.slice, [&](int, int q) { return uf.at(q, kr); });
      wr.rz.load(dq, ln.slice, [&](int i, int q) { return prz.at(q, i == 0 ? jr : h + jr); });
      wr.n.load(dq, ln.slice, [&](int, int q) { return pn.at(q, jr); });
    }
  }
  QuadCols ux{}, vx{};
  if constexpr (XSide != kGiMode) {
    const int nux = XSide == kLowrankX ? a.rx : g3;
    if (a.x_res) {
      stage_cols(sm + L.ux, a.ux, a.f, nux);
      if (XSide == kLowrankX) stage_cols(sm + L.vx, a.vx, a.rx, g3);
    }
    ux = QuadCols{a.ux, shared4(L.ux, a.x_res), a.f, nux};
    vx = QuadCols{a.vx, shared4(L.vx, a.x_res && XSide == kLowrankX), a.rx, g3};
  }
  // xu's padding and the state start at zero, but for the carry's h0. The
  // weights' copies land by the first block's barrier.
  for (size_t i = L.xub + threadIdx.x; i < L.total; i += blockDim.x) {
    const size_t e = i - L.hbuf;
    const int row = static_cast<int>(e / h4), j = static_cast<int>(e % h4);
    *at(i) = i >= L.hbuf && row < live && j < h ? a.h0[(size_t)(b0 + row) * h + j] : 0.f;
  }
  float* hbuf = at(L.hbuf);

  float* gib = at(L.gib);
  float* rh = at(L.rh);
  float* zs = at(L.zs);
  float* hus = at(L.hus);
  float* rhus = at(L.rhus);
  int cur = 0;
  for (int t0 = 0; t0 < a.t_len; t0 += a.tblock) {
    const int nb = min(a.tblock, a.t_len - t0);
    // -- the time block's input: gi [nb][rows][3h] in shared memory, copied
    // (gi mode) or projected from x, with cp.async copies all in flight
    if constexpr (XSide == kGiMode) {
      const int n = live * g3;
      for (int i = threadIdx.x; i < nb * n; i += blockDim.x) {
        const int tt = i / n, e = i % n;
        stage4(gib + (size_t)tt * rows * g3 + e,
               a.gi + ((size_t)(t0 + tt) * a.batch + b0) * g3 + e);
      }
      vmlmf::cp_async_wait_all();
    } else {
      const int f4 = q4(a.f), mb = nb * rows;
      float* xs = at(L.xs);
      for (int i = threadIdx.x; i < mb * f4; i += blockDim.x) {
        const int m = i / f4, k = i % f4, row = m % rows;
        if (k < a.f && row < live)
          stage4(xs + i, a.x + ((size_t)(t0 + m / rows) * a.batch + b0 + row) * a.f + k);
        else
          xs[i] = 0.f;
      }
      vmlmf::cp_async_wait_all();
      __syncthreads();
      const float* bias = a.bias;
      if constexpr (XSide == kDenseX) {
        block_gemm(xs, f4, mb, ux, g3,
                   [&](int m, int c, float v) { gib[(size_t)m * g3 + c] = v + bias[c]; });
      } else {
        const int rx = a.rx, rx4 = q4(rx);
        float* xub = at(L.xub);
        block_gemm(xs, f4, mb, ux, rx, [&](int m, int c, float v) {
          xub[m * rx4 + c] = v;
          if (Residuals && m % rows < live)
            a.xu[((size_t)(t0 + m / rows) * a.batch + b0 + m % rows) * rx + c] = v;
        });
        __syncthreads();
        block_gemm(xub, rx4, mb, vx, g3,
                   [&](int m, int c, float v) { gib[(size_t)m * g3 + c] = v + bias[c]; });
      }
    }
    __syncthreads();

    // -- the steps of the block
    for (int tt = 0; tt < nb; ++tt) {
      const float* gstep = gib + (size_t)tt * rows * g3;
      const size_t m0 = (size_t)(t0 + tt) * a.batch + b0;  // output row of the CTA's row 0
      const float* hc = hbuf + cur * rows * h4;
      float* hn = hbuf + (cur ^ 1) * rows * h4;
      const int row = ln.slice;
      const bool own_row = row < live;

      if constexpr (Form == kDensePost) {
        // r, z and recn = h @ Pn of unit j, then its update: one barrier
        for (int u0 = 0; u0 < h; u0 += ln.per_pass) {
          const int j = u0 + ln.unit, jc = min(j, h - 1);
          float acc[3][R] = {};
          if (regs)
            wr.rzn.dot(acc, hc, h4, live, dq, ln.slice);
          else
            slice_dot<3>(acc, hc, h4, live, dq, ln.slice, [&](int i, int q) {
              return i == 0 ? prz.at(q, jc) : i == 1 ? prz.at(q, h + jc) : pn.at(q, jc);
            });
          slice_reduce<3>(acc, live);
          if (j < h && own_row) {
            const float* g = gstep + row * g3;
            const float rg = sigmoid(g[j] + pick(acc[0], row));
            const float z = sigmoid(g[h + j] + pick(acc[1], row));
            const float rec = pick(acc[2], row);
            const float n = tanhf(g[2 * h + j] + rg * rec);
            const float hv = z * hc[row * h4 + j] + (1.f - z) * n;
            hn[row * h4 + j] = hv;
            a.ys[(m0 + row) * h + j] = hv;
            if (Residuals) {
              float* gs = a.gates + (m0 + row) * g3;
              gs[j] = rg;
              gs[h + j] = z;
              gs[2 * h + j] = n;
              a.recn[(m0 + row) * h + j] = rec;
            }
          }
        }
        __syncthreads();
      } else {
        const float* src = hc;  // the rows of the gates' product: h, or hu
        int lds = h4;
        if constexpr (kLowrank) {  // hu = h @ Uf, rank column k
          for (int u0 = 0; u0 < r; u0 += ln.per_pass) {
            const int k = u0 + ln.unit, kc = min(k, r - 1);
            float acc[1][R] = {};
            if constexpr (kLowrank) {
              if (regs) wr.uf.dot(acc, hc, h4, live, h4 / 4, ln.slice);
            }
            if (!regs)
              slice_dot<1>(acc, hc, h4, live, h4 / 4, ln.slice,
                           [&](int, int q) { return uf.at(q, kc); });
            slice_reduce<1>(acc, live);
            if (k < r && own_row) {
              const float v = pick(acc[0], row);
              hus[row * r4 + k] = v;
              if (Residuals) a.hu[(m0 + row) * r + k] = v;
            }
          }
          __syncthreads();
          src = hus;
          lds = r4;
        }
        // r and z of unit j; r*h and z kept for the candidate
        for (int u0 = 0; u0 < h; u0 += ln.per_pass) {
          const int j = u0 + ln.unit, jc = min(j, h - 1);
          float acc[2][R] = {};
          if (regs)
            wr.rz.dot(acc, src, lds, live, dq, ln.slice);
          else
            slice_dot<2>(acc, src, lds, live, dq, ln.slice,
                         [&](int i, int q) { return prz.at(q, i == 0 ? jc : h + jc); });
          slice_reduce<2>(acc, live);
          if (j < h && own_row) {
            const float* g = gstep + row * g3;
            const float rg = sigmoid(g[j] + pick(acc[0], row));
            const float z = sigmoid(g[h + j] + pick(acc[1], row));
            rh[row * h4 + j] = rg * hc[row * h4 + j];
            zs[row * h + j] = z;
            if (Residuals) {
              float* gs = a.gates + (m0 + row) * g3;
              gs[j] = rg;
              gs[h + j] = z;
            }
          }
        }
        __syncthreads();
        const float* nsrc = rh;
        if constexpr (kLowrank) {  // rhu = (r*h) @ Uf
          for (int u0 = 0; u0 < r; u0 += ln.per_pass) {
            const int k = u0 + ln.unit, kc = min(k, r - 1);
            float acc[1][R] = {};
            if constexpr (kLowrank) {
              if (regs) wr.uf.dot(acc, rh, h4, live, h4 / 4, ln.slice);
            }
            if (!regs)
              slice_dot<1>(acc, rh, h4, live, h4 / 4, ln.slice,
                           [&](int, int q) { return uf.at(q, kc); });
            slice_reduce<1>(acc, live);
            if (k < r && own_row) {
              const float v = pick(acc[0], row);
              rhus[row * r4 + k] = v;
              if (Residuals) a.rhu[(m0 + row) * r + k] = v;
            }
          }
          __syncthreads();
          nsrc = rhus;
        }
        // the candidate n of unit j and the update
        for (int u0 = 0; u0 < h; u0 += ln.per_pass) {
          const int j = u0 + ln.unit, jc = min(j, h - 1);
          float acc[1][R] = {};
          if (regs)
            wr.n.dot(acc, nsrc, lds, live, dq, ln.slice);
          else
            slice_dot<1>(acc, nsrc, lds, live, dq, ln.slice,
                         [&](int, int q) { return pn.at(q, jc); });
          slice_reduce<1>(acc, live);
          if (j < h && own_row) {
            const float n = tanhf(gstep[row * g3 + 2 * h + j] + pick(acc[0], row));
            const float z = zs[row * h + j];
            const float hv = z * hc[row * h4 + j] + (1.f - z) * n;
            hn[row * h4 + j] = hv;
            a.ys[(m0 + row) * h + j] = hv;
            if (Residuals) a.gates[(m0 + row) * g3 + 2 * h + j] = n;
          }
        }
        __syncthreads();
      }
      cur ^= 1;
    }
  }
}

template <int Form, int XSide, bool Residuals, int R, bool Spill = false>
cudaError_t launch_rows(const FwdArgs& a, int threads, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<Form, XSide, Residuals, R, Spill>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fwd_kernel<Form, XSide, Residuals, R, Spill><<<cdiv(a.batch, a.rows), threads, smem, stream>>>(
      a);
  return cudaGetLastError();
}

// Launches fwd_kernel<Form, XSide, Residuals, row_bound(rows), spill > 0>
// with gru_plan's layout; refuses a plan whose shared bytes are not this
// layout's, and a spill that is not a region boundary of a one-row plan
// with every weight read through L2.
template <int Form, int XSide, bool Residuals>
cudaError_t launch(const FwdArgs& a, int threads, int smem, cudaStream_t stream) {
  const FwdLayout L = fwd_layout(Form, XSide, a);
  const bool regs_fit = a.h <= kRegH && a.r <= kRegR && threads / kSlices >= a.h &&
                        threads / kSlices >= a.r;
  const size_t bounds[] = {L.gib, L.xs, L.xub, L.hbuf, L.rh, L.hus, L.rhus, L.zs, L.total};
  bool boundary = a.spill == 0;
  for (size_t b : bounds) boundary = boundary || (size_t)a.spill == b;
  const bool spill_ok = a.spill == 0 || (boundary && a.rows == 1 && a.rec_res == kInL2 &&
                                         !a.x_res && a.tblock == 1 && a.state != nullptr);
  if (a.spill < 0 || (size_t)a.spill > L.total || !spill_ok ||
      (L.total - a.spill) * sizeof(float) != (size_t)smem || a.rows < 1 || a.rows > kMaxRows ||
      a.tblock < 1 || threads < 32 || threads % 32 != 0 || threads > kMaxThreads ||
      a.rec_res < kInL2 || a.rec_res > kInRegisters || (a.rec_res == kInRegisters && !regs_fit))
    return cudaErrorInvalidValue;
  if (a.spill > 0) return launch_rows<Form, XSide, Residuals, 1, true>(a, threads, smem, stream);
  switch (row_bound(a.rows)) {
    case 1:
      return launch_rows<Form, XSide, Residuals, 1>(a, threads, smem, stream);
    case 2:
      return launch_rows<Form, XSide, Residuals, 2>(a, threads, smem, stream);
    default:
      return launch_rows<Form, XSide, Residuals, kMaxRows>(a, threads, smem, stream);
  }
}

template <int XSide, bool Residuals>
int launch_form(const FwdArgs& a, int form, int threads, int smem, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  switch (form) {
    case kLowrankPre:
      return launch<kLowrankPre, XSide, Residuals>(a, threads, smem, stream);
    case kDensePre:
      return launch<kDensePre, XSide, Residuals>(a, threads, smem, stream);
    case kDensePost:
      return launch<kDensePost, XSide, Residuals>(a, threads, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool Residuals>
int launch_x(const FwdArgs& a, int form, int threads, int smem, void* stream) {
  return a.vx == nullptr ? launch_form<kDenseX, Residuals>(a, form, threads, smem, stream)
                         : launch_form<kLowrankX, Residuals>(a, form, threads, smem, stream);
}

// -- the grid layout (gru_grid.cuh; ops/cuda_gru.py::gru_grid_plan) ---------

using vmlmf::GridPlan;
using vmlmf::round4;
using vmlmf::split_at;

// The tensors and sizes of one grid launch. gi is the input contribution
// [T*B, 3h]: the caller's in gi mode, else the projection's output.
struct GridFwdArgs {
  const float* gi;
  const float* uf;
  const float* prz;
  const float* pn;
  const float* h0;
  float* ys;
  float* gates;
  float* hu;
  float* rhu;
  float* recn;
  float* xchg;
  unsigned* sync;
  float* wstream;
  int t_len, batch, h, r;
};

// The scan over all t_len steps on plan.groups x plan.ctas co-resident
// CTAs, from gi. xchg: the h exchange [2][groups][h][rpad] (step parity),
// then r*h [groups][h][rpad] ("pre"), then hu, which rhu reuses,
// [groups][r][rpad] (low-rank). A step's products, each followed by a
// group barrier: "post" h @ [Prz_r | Prz_z | Pn] (one); dense "pre" h @
// [Prz_r | Prz_z], then (r*h) @ Pn (two); low-rank h @ Uf, hu @ [Prz_r |
// Prz_z], (r*h) @ Uf, rhu @ Pn (four). OnRing (GridPlan::piece > 0): the
// products run on scan_grid.cuh's ring, kRingThreads threads a CTA, the
// producer issuing each next product's streamed rows before the barrier
// that publishes its exchange; else slice_product on kGridThreads, every
// row resident. R: the batch rows of a product item (GridPlan::tile).
template <int Form, bool Residuals, bool OnRing, int R>
__global__ void __launch_bounds__(OnRing ? vmlmf::kRingThreads : vmlmf::kGridThreads, 1)
grid_fwd_kernel(const GridFwdArgs a, const GridPlan plan) {
  constexpr bool kLowrank = Form == kLowrankPre, kPost = Form == kDensePost;
  constexpr int kConsumers = vmlmf::kGridThreads;
  extern __shared__ __align__(16) float gsm[];
  const int h = a.h, r = a.r, g3 = 3 * h, rpad = plan.rpad;
  const int grp = blockIdx.x / plan.ctas, q = blockIdx.x % plan.ctas;
  const int b0 = split_at(grp, a.batch, plan.groups);
  const int rows = split_at(grp + 1, a.batch, plan.groups) - b0;
  const int j0 = split_at(q, h, plan.ctas), jw = split_at(q + 1, h, plan.ctas) - j0;
  const int k0 = kLowrank ? split_at(q, r, plan.ctas) : 0;
  const int kw = kLowrank ? split_at(q + 1, r, plan.ctas) - k0 : 0;
  const vmlmf::gru::SliceShapes shp(Form, h, r, plan, false);
  const int jwp = shp.cb / 3, kwp = shp.ca, ldb = shp.cb, slab = jwp * rpad;
  const int depth = shp.db;
  // resident depths: every row without a ring
  const int resa = OnRing ? plan.res_a : shp.da, resb = OnRing ? plan.res_b : depth;

  float* wa = gsm;                        // Uf[:, k-slice] [h][kwp], rows < resa
  float* wb = wa + (size_t)resa * kwp;    // [Prz_r | Prz_z | Pn] j-columns [depth][3 jwp]
  float* hc = gsm + vmlmf::weight_floats<float>((size_t)resa * kwp + (size_t)resb * ldb);
  float* gis = hc + slab;                 // the step's gi of the j-slice [3][jwp][rpad]
  float* zs = gis + 3 * slab;             // "pre": z [jwp][rpad]; "post": the sums [3][jwp][rpad]
  float* stage = zs + (kPost ? 3 : 1) * slab;  // on a ring, the ring
  float* red = stage + (OnRing ? vmlmf::ring_floats(plan) : (size_t)plan.stage);
  float* sa = a.wstream + (OnRing ? blockIdx.x * vmlmf::gru::grid_stream_floats(
                                                    Form, h, r, plan, false)
                                  : 0);
  const vmlmf::gru::GridSlice sla{wa, sa, shp.da, resa, kwp, kwp};
  const vmlmf::gru::GridSlice slb{wb, sa + (size_t)(shp.da - resa) * kwp, depth, resb, ldb,
                                  shp.split_b};
  const size_t hpar = (size_t)plan.groups * h * rpad;
  float* hx = a.xchg + (size_t)grp * h * rpad;  // parity p at hx + p * hpar
  float* rhx = a.xchg + 2 * hpar + (size_t)grp * h * rpad;
  float* ux = a.xchg + (kPost ? 2 : 3) * hpar + (size_t)grp * r * rpad;
  unsigned* count = a.sync + grp;
  unsigned target = 0;

  // the slices, loaded once: resident rows into shared memory, the others
  // into the CTA's streamed region; columns past the CTA's own are zero
  if constexpr (kLowrank) {
#pragma unroll 4
    for (int e = threadIdx.x; e < h * kwp; e += blockDim.x) {
      const int d = e / kwp, kk = e % kwp;
      sla.store(d, kk, kk < kw ? a.uf[(size_t)d * r + k0 + kk] : 0.f);
    }
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < depth * ldb; e += blockDim.x) {
    const int d = e / ldb, c = e % ldb, g = c / jwp, jj = c % jwp;
    const float v = jj >= jw ? 0.f
                    : g < 2  ? a.prz[(size_t)d * 2 * h + g * h + j0 + jj]
                             : a.pn[(size_t)d * h + j0 + jj];
    slb.store(d, c, v);
  }
  // the carry from h0 (padding zero), and h0's j-slice into the exchange of step 0
  for (int e = threadIdx.x; e < slab; e += blockDim.x) {
    const int jj = e / rpad, row = e % rpad;
    hc[e] = jj < jw && row < rows ? a.h0[(size_t)(b0 + row) * h + j0 + jj] : 0.f;
    if (jj < jw) hx[(size_t)(j0 + jj) * rpad + row] = hc[e];
  }
  // the products' operands: h or hu, and r*h or rhu, against the slices
  auto op_hu = [&](const float* src) { return sla.rows(src, 0, h, 0, kwp); };
  auto op_gates = [&](const float* src) {
    return slb.rows(src, 0, depth, 0, kPost ? ldb : 2 * jwp);
  };
  auto op_n = [&](const float* src) { return slb.rows(src, 0, depth, 2 * jwp, jwp); };
  vmlmf::Ring ring;
  auto product = [&](const vmlmf::RingOperand<float>& op, auto epi) {
    vmlmf::gru::grid_product<OnRing, R>(ring, op, plan, stage, red, epi);
  };
  if constexpr (OnRing) {
    ring.start(stage, plan);
    if (a.t_len > 0) ring.preload<R>(kLowrank ? op_hu(hx) : op_gates(hx));
  }
  vmlmf::group_sync(count, plan.ctas, target);

  for (int t = 0; t < a.t_len; ++t) {
    const float* hin = hx + (t & 1) * hpar;
    float* hout = hx + ((t + 1) & 1) * hpar;
    const size_t m0 = (size_t)t * a.batch + b0;  // the group's first row of the step
    // the step's gi of the j-slice, copied while the first product runs (by
    // the consumers, who read it in the epilogues)
    if (!OnRing || threadIdx.x < kConsumers)
      for (int e = threadIdx.x; e < 3 * jw * rows; e += kConsumers) {
        const int jj = e % jw, g = (e / jw) % 3, row = e / (3 * jw);
        vmlmf::cp_async4(gis + (size_t)(g * jwp + jj) * rpad + row,
                         a.gi + (m0 + row) * g3 + g * h + j0 + jj);
      }
    // the next product's streamed rows, issued before the barrier
    auto preload = [&](const vmlmf::RingOperand<float>& op) {
      if constexpr (OnRing) ring.preload<R>(op);
    };
    auto preload_next_step = [&]() {
      if (t + 1 < a.t_len) preload(kLowrank ? op_hu(hout) : op_gates(hout));
    };
    // an epilogue of a product over rank columns: the group's hu or rhu
    auto rank_out = [&](float* res) {
      return [&, res](int cb, int rb, float (&acc)[4][R]) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kk = 4 * cb + c;
          if (kk >= kw) continue;
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const int row = R * rb + i;
            ux[(size_t)(k0 + kk) * rpad + row] = acc[c][i];
            if (Residuals && row < rows) res[(m0 + row) * r + k0 + kk] = acc[c][i];
          }
        }
      };
    };

    if constexpr (kPost) {
      // r, z and recn = h @ Pn of the j-slice, then the update
      vmlmf::cp_async_wait_all();
      product(op_gates(hin), [&](int cb, int rb, float (&acc)[4][R]) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int i = 0; i < R; ++i) zs[(size_t)(4 * cb + c) * rpad + R * rb + i] = acc[c][i];
      });
      preload_next_step();
      __syncthreads();
      for (int e = threadIdx.x; e < jw * rpad; e += blockDim.x) {
        const int jj = e % jw, row = e / jw, j = j0 + jj, at = jj * rpad + row;
        if (row >= rows) {
          hout[(size_t)j * rpad + row] = 0.f;
          continue;
        }
        const size_t m = m0 + row;
        const float rg = vmlmf::gru::sigmoid(gis[at] + zs[at]);
        const float z = vmlmf::gru::sigmoid(gis[slab + at] + zs[slab + at]);
        const float rec = zs[2 * slab + at];
        const float n = tanhf(gis[2 * slab + at] + rg * rec);
        const float hv = z * hc[at] + (1.f - z) * n;
        hc[at] = hv;
        hout[(size_t)j * rpad + row] = hv;
        a.ys[m * h + j] = hv;
        if (Residuals) {
          float* gs = a.gates + m * g3;
          gs[j] = rg;
          gs[h + j] = z;
          gs[2 * h + j] = n;
          a.recn[m * h + j] = rec;
        }
      }
      vmlmf::group_sync(count, plan.ctas, target);
    } else {
      const float* src = hin;  // the rows of the gates' product: h, or hu
      if constexpr (kLowrank) {  // hu = h @ Uf[:, k-slice]
        product(op_hu(hin), rank_out(a.hu));
        preload(op_gates(ux));
        vmlmf::group_sync(count, plan.ctas, target);
        src = ux;
      }
      // r and z of the j-slice: r*h into the exchange, z kept
      vmlmf::cp_async_wait_all();
      product(op_gates(src), [&](int cb, int rb, float (&acc)[4][R]) {
        const int g = (4 * cb) / jwp;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int jj = 4 * cb + c - g * jwp;
          if (jj >= jw) continue;
          const int j = j0 + jj;
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const int row = R * rb + i, at = jj * rpad + row;
            if (row >= rows) {
              if (g == 0) rhx[(size_t)j * rpad + row] = 0.f;
              continue;
            }
            const float v = vmlmf::gru::sigmoid(gis[g * slab + at] + acc[c][i]);
            if (g == 0)
              rhx[(size_t)j * rpad + row] = v * hc[at];
            else
              zs[at] = v;
            if (Residuals) a.gates[(m0 + row) * g3 + g * h + j] = v;
          }
        }
      });
      preload(kLowrank ? op_hu(rhx) : op_n(rhx));
      vmlmf::group_sync(count, plan.ctas, target);
      const float* nsrc = rhx;
      if constexpr (kLowrank) {  // rhu = (r*h) @ Uf[:, k-slice]
        product(op_hu(rhx), rank_out(a.rhu));
        preload(op_n(ux));
        vmlmf::group_sync(count, plan.ctas, target);
        nsrc = ux;
      }
      // the candidate n of the j-slice and the update
      product(op_n(nsrc), [&](int cb, int rb, float (&acc)[4][R]) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int jj = 4 * cb + c;
          if (jj >= jw) continue;
          const int j = j0 + jj;
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const int row = R * rb + i, at = jj * rpad + row;
            if (row >= rows) {
              hout[(size_t)j * rpad + row] = 0.f;
              continue;
            }
            const size_t m = m0 + row;
            const float n = tanhf(gis[2 * slab + at] + acc[c][i]);
            const float z = zs[at];
            const float hv = z * hc[at] + (1.f - z) * n;
            hc[at] = hv;
            hout[(size_t)j * rpad + row] = hv;
            a.ys[m * h + j] = hv;
            if (Residuals) a.gates[m * g3 + 2 * h + j] = n;
          }
        }
      });
      preload_next_step();
      vmlmf::group_sync(count, plan.ctas, target);
    }
  }
}

// The launch of the grid forward with items of R rows (`args` as
// grid_fwd_kernel takes them), on the ring where the plan has one.
template <int Form, bool Residuals, int R>
cudaError_t launch_tile(const GridPlan& plan, unsigned* sync, void** args, cudaStream_t stream) {
  return plan.piece ? vmlmf::launch_grid(grid_fwd_kernel<Form, Residuals, true, R>, plan, sync,
                                         args, stream, 0, vmlmf::kRingThreads)
                    : vmlmf::launch_grid(grid_fwd_kernel<Form, Residuals, false, R>, plan, sync,
                                         args, stream);
}

template <int Form, bool Residuals>
cudaError_t grid_scan(const GridFwdArgs& io, size_t wstream_floats, GridPlan plan,
                      cudaStream_t stream) {
  using vmlmf::gru::grid_smem_floats;
  using vmlmf::gru::grid_stream_floats;
  if (!vmlmf::gru::grid_resident_ok(Form, io.h, io.r, plan, false) ||
      !vmlmf::gru::grid_ring_ok(Form, io.h, io.r, plan, false) ||
      sizeof(float) * grid_smem_floats(Form, io.h, io.r, plan, false) > (size_t)plan.smem ||
      plan.groups > io.batch || io.xchg == nullptr || io.sync == nullptr)
    return cudaErrorInvalidValue;
  const size_t streamed = grid_stream_floats(Form, io.h, io.r, plan, false);
  if (streamed * plan.groups * plan.ctas > wstream_floats || (streamed > 0 && io.wstream == nullptr))
    return cudaErrorInvalidValue;
  GridFwdArgs a = io;
  void* args[] = {&a, &plan};
  switch (plan.tile) {
    case 4:
      return launch_tile<Form, Residuals, 4>(plan, a.sync, args, stream);
    case 8:
      return launch_tile<Form, Residuals, 8>(plan, a.sync, args, stream);
    default:
      return launch_tile<Form, Residuals, 12>(plan, a.sync, args, stream);
  }
}

template <bool Residuals>
cudaError_t grid_form(const GridFwdArgs& io, int form, size_t wstream_floats, GridPlan plan,
                      cudaStream_t stream) {
  switch (form) {
    case kLowrankPre:
      return grid_scan<kLowrankPre, Residuals>(io, wstream_floats, plan, stream);
    case kDensePre:
      return grid_scan<kDensePre, Residuals>(io, wstream_floats, plan, stream);
    case kDensePost:
      return grid_scan<kDensePost, Residuals>(io, wstream_floats, plan, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Every entry takes the plan of ops/cuda_gru.py::gru_plan as its last
// integers: rows, threads, tblock, rec_res, x_res, smem (bytes), spill
// (floats a CTA of `state`, the device-memory scratch of a spill plan,
// which the caller allocates, cuda_gru.py::state_floats; null when 0).

// No-grad forward: writes ys [T,B,h]. uf is null and r is 0 in the dense
// recurrent forms; vx is null and rx is 0 for a dense x side.
extern "C" int gru_scan_xin_fwd(const float* x, const float* ux, const float* vx,
                                const float* bias, const float* uf, const float* prz,
                                const float* pn, const float* h0, float* ys, float* state,
                                int t_len, int batch, int f, int rx, int h, int r, int form,
                                int rows, int threads, int tblock, int rec_res, int x_res,
                                int smem, int spill, void* stream_handle) {
  const FwdArgs a{x, ux, vx, bias, nullptr, uf, prz, pn, h0, ys, nullptr, nullptr, nullptr,
                  nullptr, nullptr, state, t_len, batch, f, rx, h, r, rows, tblock, rec_res,
                  x_res, spill};
  return launch_x<false>(a, form, threads, smem, stream_handle);
}

// Residual forward of training: also writes the residuals xu [T*B, rx]
// (low-rank x side; else null), gates [T,B,3h], hu and rhu [T,B,r]
// (low-rank; else null) and recn [T,B,h] ("post"; else null).
extern "C" int gru_scan_xin_fwd_res(const float* x, const float* ux, const float* vx,
                                    const float* bias, const float* uf, const float* prz,
                                    const float* pn, const float* h0, float* xu, float* ys,
                                    float* gates, float* hu, float* rhu, float* recn,
                                    float* state, int t_len, int batch, int f, int rx, int h,
                                    int r, int form, int rows, int threads, int tblock,
                                    int rec_res, int x_res, int smem, int spill,
                                    void* stream_handle) {
  const FwdArgs a{x, ux, vx, bias, nullptr, uf, prz, pn, h0, ys, gates, hu, rhu,
                  recn, xu, state, t_len, batch, f, rx, h, r, rows, tblock, rec_res, x_res,
                  spill};
  return launch_x<true>(a, form, threads, smem, stream_handle);
}

// gi mode, no-grad forward: the scan on the caller's gi [T,B,3h]; writes
// ys [T,B,h].
extern "C" int gru_scan_fwd(const float* gi, const float* uf, const float* prz,
                            const float* pn, const float* h0, float* ys, float* state,
                            int t_len, int batch, int h, int r, int form, int rows, int threads,
                            int tblock, int rec_res, int x_res, int smem, int spill,
                            void* stream_handle) {
  const FwdArgs a{nullptr, nullptr, nullptr, nullptr, gi, uf, prz, pn, h0,
                  ys, nullptr, nullptr, nullptr, nullptr, nullptr, state, t_len, batch, 0,
                  0, h, r, rows, tblock, rec_res, x_res, spill};
  return launch_form<kGiMode, false>(a, form, threads, smem, stream_handle);
}

// gi mode, residual forward: also writes gates [T,B,3h] and hu, rhu
// [T,B,r] (low-rank; else null) or recn [T,B,h] ("post"; else null).
extern "C" int gru_scan_fwd_res(const float* gi, const float* uf, const float* prz,
                                const float* pn, const float* h0, float* ys, float* gates,
                                float* hu, float* rhu, float* recn, float* state, int t_len,
                                int batch, int h, int r, int form, int rows, int threads,
                                int tblock, int rec_res, int x_res, int smem, int spill,
                                void* stream_handle) {
  const FwdArgs a{nullptr, nullptr, nullptr, nullptr, gi, uf, prz, pn, h0, ys, gates, hu, rhu,
                  recn, nullptr, state, t_len, batch, 0, 0, h, r, rows, tblock, rec_res, x_res,
                  spill};
  return launch_form<kGiMode, true>(a, form, threads, smem, stream_handle);
}

// The grid layout of every forward entry (ops/cuda_gru.py::gru_grid_plan):
// x mode when x is given, whose projection writes gi [T*B, 3h] (scratch)
// and xu [T*B, rx] (low-rank x side: the residual, or scratch; else null)
// before the scan; gi mode when x is null, gi then being the input. Writes
// ys and, with `residuals` 1, gates, hu and rhu (low-rank) or recn ("post").
// xchg, sync (a barrier word a group) and wstream (wstream_floats floats;
// null where the plan streams nothing) are scratch that gru_grid_plan
// sizes; the ten integers after the form are its layout (GRUGridPlan.ints).
extern "C" int gru_grid_fwd(const float* x, const float* ux, const float* vx,
                            const float* bias, float* gi, const float* uf, const float* prz,
                            const float* pn, const float* h0, float* xu, float* ys,
                            float* gates, float* hu, float* rhu, float* recn, float* xchg,
                            unsigned* sync, float* wstream, int wstream_floats, int t_len,
                            int batch, int f, int rx, int h, int r, int form, int groups,
                            int ctas, int rpad, int stage, int red, int smem, int res_a,
                            int res_b, int piece, int tile, int residuals, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (gi == nullptr || (residuals && gates == nullptr)) return cudaErrorInvalidValue;
  if (x != nullptr) {
    const cudaError_t err = project(x, ux, vx, bias, xu, gi, t_len * batch, f, rx, h, stream);
    if (err != cudaSuccess) return err;
  }
  const GridFwdArgs a{gi, uf, prz, pn, h0, ys, gates, hu, rhu, recn, xchg, sync, wstream,
                      t_len, batch, h, r};
  const GridPlan plan{groups, ctas, rpad, stage, red, smem, res_a, res_b, piece, 0, tile};
  const size_t nstream = static_cast<size_t>(wstream_floats);
  return residuals ? grid_form<true>(a, form, nstream, plan, stream)
                   : grid_form<false>(a, form, nstream, plan, stream);
}

// The message of an error code that an entry of this file returned.
extern "C" const char* gru_scan_xin_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
