// Fused LSTM scan for sm_90a: the no-grad forward and the residual-writing
// forward of training, in x mode and in gi mode.
//
// Replaces vmlmf_tpu/ops/pallas_scan.py::_fwd_kernel in every variant that
// lstm_scan_fused_xin (x mode) and lstm_scan_fused (gi mode) run, each side
// low-rank or dense: the no-grad primal (residuals=False) and the autodiff
// forward (residuals=True) with the saved-gates policy, residuals f32 or
// bf16, or the recompute policy (save_gates=False, x mode: only ys and cs
// written); products f32 or bf16 (precision "bf16"). For every batch row b
// and step t:
//
//   gi[t,b]  = x[t,b] @ Ux [@ Vx] + tile4(fit(x[t,b], h)) * xdvec + bias   (x mode)
//   pre      = gi[t,b] + h @ U [@ V] + tile4(h) * dvec        (gates i,f,g,o)
//   c        = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h        = sigmoid(o) * tanh(c);      ys[t,b] = h
//
// and c_last = c after the last step. fit() zero-extends or truncates x to
// h features. In gi mode gi [T,B,4h] is given. Layouts are the unpadded
// public ones of the JAX functions: x [T,B,F], xdvec [4,h], bias [4h], dvec
// [4h], h0/c0 [B,h]; the x side low-rank Ux [F,rx], Vx [rx,4h] or dense Ux
// [F,4h] (Vx null, "DenseX"); the recurrent side low-rank U [h,r], V
// [r,4h] or dense U [h,4h] (V null, "DenseRec"); all row-major and
// contiguous. A null Vx or V picks the dense form of its side.
//
// The residual variants also write, per step, cs[t] = c [T,B,h] and, with
// saved gates, the post-nonlinearity gates [T,B,4h] (sigmoid(i), sigmoid(f),
// tanh(g), sigmoid(o) in four blocks of h) and, low-rank, hu[t] = h_prev @
// U [T,B,r] (the f32 product, before any rounding), as f32 or bf16; then
// c_last is cs[T-1]. A low-rank x side also keeps the first GEMM's xu =
// x @ Ux [T*B,rx] as a residual: the backward needs it for dVx, and keeping
// it costs one [T,B,rx] buffer where the TPU kernel recomputed x @ Ux per
// time block (under recompute it is scratch). The dense forms have no hu
// and no xu.
//
// bf16 (pallas_scan.py:297-317): every product takes bf16-rounded operands
// and sums in f32: x, Ux, xu and Vx in the projection GEMMs (bf16 mma,
// gemm_tc.cuh), h, U, hu and V in the scan (bf16 weight
// slices in shared memory, exchanged h and hu rounded by their writer,
// scan_grid.cuh). The x term, the h * dvec term (h from the f32 carry), the
// bias and the gate arithmetic stay f32, as in the TPU kernel.
//
// What bounds it on an H100, and what the design does about it:
// * The input projection is time-parallel. It runs first as tensor-core
//   GEMM launches (gemm_tc.cuh: 3xTF32 in f32, bf16 mma in the bf16
//   variants) over all T*B rows, spread over many CTAs: xu = x@Ux, then gi =
//   xu@Vx plus the elementwise x term and bias; or, for a dense x side, one
//   GEMM gi = x@Ux whose epilogue adds the x term and bias. It writes gi
//   [T,B,4h] to device memory and the scan reads it back, a round trip the
//   TPU kernel avoided by projecting each time block inside the scan.
// * The recurrence is a serial chain: each step needs all of h before h@U.
//   The TPU kernel keeps U, V, dvec and the carry in VMEM for the whole
//   scan. The recurrent weights (U and V, 3.9 MB f32 at h=650, r=300; a
//   dense U [650, 2600], 6.8 MB) are 17-30 times one SM's 227 KB, so here
//   they are split over the CTAs of a cooperative launch, one per SM, each
//   holding its slice in shared memory for the whole scan (scan_grid.cuh;
//   the layout is ops/cuda_scan.py::scan_plan's, which halves the slices'
//   bytes for the bf16 variants). The batch is cut into groups, each with a
//   full copy of the weights over its CTAs, as many groups as the copies
//   that fit: a group's CTAs exchange only its own rows, and groups never
//   wait for each other.
// * Low-rank step, two phases on CTA q of a group: (A) hu[:, k-slice] =
//   h @ U[:, k-slice] into the group's hu exchange buffer; group barrier;
//   (B) pre = gi + hu @ V[:, gate columns of the j-slice] + h * dvec, the
//   gates and the c/h update of the j-slice, the new h into the other h
//   exchange buffer (double-buffered by step parity); group barrier. Dense
//   step: one phase, pre = gi + h @ U[:, j-cols] + h * dvec; one barrier.
//   The carry (h and c of the j-slice) stays in the CTA's shared memory.
// * What sets a step is latency, not bytes or operations: the barriers (a
//   fence, an atomic and a spin on one L2 word per CTA) and each CTA's read
//   of the group's whole h (or hu) from L2, staged into shared memory with
//   16-byte cp.async.cg, double-buffered when it does not fit whole (at
//   B=128). The exchange is read only through L2 (.cg), never __ldg, so no
//   CTA sees a value from before the barrier; weights, gi, h0 and c0 never
//   change during the launch. The step's gi of the j-slice is copied with
//   cp.async at the start of the step, so that its load overlaps phase A
//   and the barrier.
// * Past the width whose weights fit in the shared memory of all SMs (a
//   dense h of about 1,050 in f32: the PTB "large" LM's 1500 x 6000 U is
//   36 MB against 30 MB), scan_plan takes one group over all SMs and keeps
//   as many depth rows of each slice in shared memory as fit beside the
//   slabs, stage and red (ScanPlan.resident_fwd). The prologue copies each
//   CTA's remaining rows, in its slice's layout and type, into its own
//   region of a device-memory scratch (`wstream`), and every step reads them
//   from there through L2 (scan_grid.cuh::slice_product): no CTA reads
//   another's region, so this needs no launch or barrier of its own, and a
//   row's place does not change the order of the sums.
// * Co-residency: every CTA of a group must be resident for its barrier,
//   so the launch is cooperative, one CTA per SM at most; a grid that
//   cannot be co-resident is refused and the wrapper raises.
// * Ragged edges: h, r and B need not divide the CTA or group counts; a
//   CTA may own no rank column (r < ctas), and rows past a group's batch
//   rows are padding that is computed and never written out.
// * The residual writes are coalesced across the j (or k) of a CTA; they
//   add (h + 4h + r) elements per row and step of device-memory traffic
//   (the gates and hu at 2 bytes under bf16 residuals, none under
//   recompute).
// * Every edge of the projection GEMMs (B, F, h, r, rx not multiples of a
//   tile) is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "gemm_tc.cuh"
#include "scan_grid.cuh"

namespace {

using vmlmf::bf16;
using vmlmf::div_up;
using vmlmf::GridPlan;
using vmlmf::round4;
using vmlmf::split_at;

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// What a launch stores besides ys: the no-grad primal c_last only; the
// recompute policy's cs; or cs, the gates and hu, as f32 or bf16.
constexpr int kNoGrad = 0, kCs = 1, kResF32 = 2, kResBf16 = 3;
// The residual policy as the wrappers number it (ops/cuda_scan.py).
constexpr int kPolicyF32 = 0, kPolicyBf16 = 1, kPolicyNone = 2;

// The tensors and sizes of one scan launch, the kernel's arguments in their
// order. gates and hu are f32 or bf16.
struct ScanIO {
  const float* gi;
  const float* u;
  const float* v;
  const float* dvec;
  const float* h0;
  const float* c0;
  float* ys;
  float* c_last;
  float* cs;
  void* gates;
  void* hu;
  float* xchg;
  unsigned* sync;
  float* wstream;
  size_t wstream_floats;
  int t_len, batch, h, r;
};

// Floats of this kernel's shared memory, in the order of the carve below:
// the resident rows of the weight slices (of type W), dvec of the j-slice,
// the (h, c) carry, stage, red, and the step's gi of the j-slice.
template <class W>
__host__ __device__ inline size_t fwd_smem_floats(bool dense_rec, int h, int r,
                                                  const GridPlan& p) {
  const int jwm = div_up(h, p.ctas), kwp = dense_rec ? 0 : round4(div_up(r, p.ctas));
  const size_t weights = (size_t)(dense_rec ? 0 : p.res_a) * kwp + (size_t)p.res_b * 4 * jwm;
  return vmlmf::weight_floats<W>(weights) + 4 * jwm + 6 * (size_t)jwm * p.rpad + p.stage + p.red;
}

// Floats of one CTA's region of the streamed scratch: the rows of its two
// slices past their resident depths (ops/cuda_scan.py::stream_floats).
template <class W>
__host__ __device__ inline size_t fwd_stream_floats(bool dense_rec, int h, int r,
                                                    const GridPlan& p) {
  const int jwm = div_up(h, p.ctas), kwp = dense_rec ? 0 : round4(div_up(r, p.ctas));
  const int depth = dense_rec ? h : r;
  return vmlmf::weight_floats<W>((size_t)(dense_rec ? 0 : h - p.res_a) * kwp +
                                 (size_t)(depth - p.res_b) * 4 * jwm);
}

// Whether a plan's resident depths are ones this kernel takes.
inline bool resident_ok(bool dense_rec, int h, int r, const GridPlan& p) {
  const int depth = dense_rec ? h : r;
  return p.res_b >= 0 && p.res_b <= depth &&
         (dense_rec ? p.res_a == 0 : p.res_a >= 0 && p.res_a <= h);
}

// The scan over all t_len steps, on plan.groups x plan.ctas co-resident CTAs.
// xchg: the h exchange [2][groups][h][rpad] (step parity), then, low-rank,
// the hu exchange [groups][r][rpad]. sync: one barrier word per group.
// wstream: the streamed scratch, fwd_stream_floats a CTA (null when the
// plan streams nothing).
template <int Res, bool DenseRec, bool Bf16, bool Streamed>
__global__ void __launch_bounds__(vmlmf::kGridThreads, 1)
grid_scan_kernel(const float* __restrict__ gi, const float* __restrict__ u,
                 const float* __restrict__ v, const float* __restrict__ dvec,
                 const float* __restrict__ h0, const float* __restrict__ c0,
                 float* __restrict__ ys, float* __restrict__ c_last,
                 float* __restrict__ cs_out, void* __restrict__ gates_res,
                 void* __restrict__ hu_res, float* xchg, unsigned* sync, float* wstream,
                 int t_len, int batch, int h, int r, GridPlan plan) {
  using W = std::conditional_t<Bf16, bf16, float>;        // weight slices
  using R = std::conditional_t<Res == kResBf16, bf16, float>;  // gates, hu
  extern __shared__ __align__(16) float smem[];
  R* gates_out = static_cast<R*>(gates_res);
  R* hu_out = static_cast<R*>(hu_res);
  const int g4 = 4 * h, rpad = plan.rpad;
  const int grp = blockIdx.x / plan.ctas, q = blockIdx.x % plan.ctas;
  const int b0 = split_at(grp, batch, plan.groups);
  const int rows = split_at(grp + 1, batch, plan.groups) - b0;
  const int j0 = split_at(q, h, plan.ctas), jw = split_at(q + 1, h, plan.ctas) - j0;
  const int k0 = DenseRec ? 0 : split_at(q, r, plan.ctas);
  const int kw = DenseRec ? 0 : split_at(q + 1, r, plan.ctas) - k0;
  const int jwm = div_up(h, plan.ctas), kwp = DenseRec ? 0 : round4(div_up(r, plan.ctas));
  const int depth = DenseRec ? h : r;  // of the gate phase's product
  // resident depths: every row without Streamed
  const int resa = DenseRec ? 0 : Streamed ? plan.res_a : h, resb = Streamed ? plan.res_b : depth;

  W* wa = reinterpret_cast<W*>(smem);  // low-rank: U[:, k-slice]  [h][kwp], rows < resa
  W* wb = wa + (size_t)resa * kwp;     // V or dense U, gate columns of the j-slice [depth][jwm][4]
  float* dv = smem + vmlmf::weight_floats<W>((size_t)resa * kwp + (size_t)resb * 4 * jwm);
  // the streamed rows: U's past resa, then V's (or dense U's) past resb
  W* sa = reinterpret_cast<W*>(wstream + blockIdx.x * fwd_stream_floats<W>(DenseRec, h, r, plan));
  W* sb = sa + (size_t)(DenseRec ? 0 : h - resa) * kwp;
  float* hc = dv + 4 * jwm;                // the carry h, c: [jwm][rpad]
  float* cc = hc + (size_t)jwm * rpad;
  float* stage = cc + (size_t)jwm * rpad;
  float* red = stage + plan.stage;
  float* gis = red + plan.red;             // gi of the step, j-slice [jwm][4][rpad]
  float* hx = xchg + (size_t)grp * h * rpad;  // parity p at hx + p * groups*h*rpad
  const size_t hx_par = (size_t)plan.groups * h * rpad;
  float* hux = xchg + 2 * hx_par + (size_t)grp * r * rpad;
  unsigned* count = sync + grp;
  unsigned target = 0;

  // the weight slices, loaded once, the resident rows into shared memory and
  // the others into the CTA's streamed region; columns past the slice are zero
  if constexpr (!DenseRec) {
#pragma unroll 4
    for (int e = threadIdx.x; e < h * kwp; e += blockDim.x) {
      const int d = e / kwp, kk = e % kwp;
      const W val = vmlmf::to_elem<W>(kk < kw ? u[(size_t)d * r + k0 + kk] : 0.f);
      if constexpr (Streamed)
        vmlmf::slice_elem(wa, sa, resa, kwp, d, kk) = val;
      else
        wa[e] = val;
    }
  }
  const float* w = DenseRec ? u : v;
#pragma unroll 4
  for (int e = threadIdx.x; e < depth * 4 * jwm; e += blockDim.x) {
    const int d = e / (4 * jwm), jj = (e / 4) % jwm, gg = e % 4;
    const W val = vmlmf::to_elem<W>(jj < jw ? w[(size_t)d * g4 + gg * h + j0 + jj] : 0.f);
    if constexpr (Streamed)
      vmlmf::slice_elem(wb, sb, resb, 4 * jwm, d, e % (4 * jwm)) = val;
    else
      wb[e] = val;
  }
  for (int e = threadIdx.x; e < 4 * jwm; e += blockDim.x)
    dv[e] = e / 4 < jw ? dvec[(e % 4) * h + j0 + e / 4] : 0.f;
  // the carry from h0, c0 (padding rows zero), and h0's j-slice into the
  // exchange of step 0
  for (int e = threadIdx.x; e < jwm * rpad; e += blockDim.x) {
    const int jj = e / rpad, row = e % rpad;
    const bool live = jj < jw && row < rows;
    const size_t at = (size_t)(b0 + row) * h + j0 + jj;
    hc[e] = live ? h0[at] : 0.f;
    cc[e] = live ? c0[at] : 0.f;
    if (jj < jw) hx[(size_t)(j0 + jj) * rpad + row] = vmlmf::exchanged<Bf16>(hc[e]);
  }
  vmlmf::group_sync(count, plan.ctas, target);

  for (int t = 0; t < t_len; ++t) {
    const float* hin = hx + (t & 1) * hx_par;
    float* hout = hx + ((t + 1) & 1) * hx_par;
    const size_t m0 = (size_t)t * batch + b0;  // the group's first row of the step
    // the step's gi of the j-slice, copied while phase A and its barrier run
    for (int e = threadIdx.x; e < 4 * jw * rows; e += blockDim.x) {
      const int jj = e % jw, g = (e / jw) % 4, row = e / (4 * jw);
      vmlmf::cp_async4(gis + (jj * 4 + g) * rpad + row, gi + (m0 + row) * g4 + g * h + j0 + jj);
    }

    if (!DenseRec) {
      // (A) hu[:, k-slice] = h @ U[:, k-slice]
      vmlmf::slice_product<Streamed>(hin, h, rpad, wa, sa, resa, kwp, round4(kw), stage,
                                     plan.stage, red, plan.red,
                                     [&](int cb, int rb, float (&acc)[4][4]) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kk = 4 * cb + c;
          if (kk >= kw) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = 4 * rb + i;
            hux[(size_t)(k0 + kk) * rpad + row] = vmlmf::exchanged<Bf16>(acc[c][i]);
            if (Res >= kResF32 && row < rows)
              hu_out[(m0 + row) * r + k0 + kk] = vmlmf::to_elem<R>(acc[c][i]);
          }
        }
      });
      vmlmf::group_sync(count, plan.ctas, target);
    }

    // (B) pre = gi + src @ W[:, gate columns of the j-slice] + h * dvec; the
    // gates and the update of the j-slice. Item cb is unit j0 + cb. The
    // product's first __syncthreads publishes the copied gi.
    vmlmf::cp_async_wait_all();
    vmlmf::slice_product<Streamed>(DenseRec ? hin : hux, depth, rpad, wb, sb, resb, 4 * jwm,
                                   4 * jw, stage, plan.stage, red, plan.red,
                                   [&](int cb, int rb, float (&acc)[4][4]) {
      const int j = j0 + cb;
      const float d0 = dv[4 * cb], d1 = dv[4 * cb + 1], d2 = dv[4 * cb + 2], d3 = dv[4 * cb + 3];
      float gv[4][4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 q4 = *reinterpret_cast<const float4*>(gis + (cb * 4 + g) * rpad + 4 * rb);
        gv[g][0] = q4.x, gv[g][1] = q4.y, gv[g][2] = q4.z, gv[g][3] = q4.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 4 * rb + i;
        const int e = cb * rpad + row;
        if (row >= rows) {
          hout[(size_t)j * rpad + row] = 0.f;
          continue;
        }
        const size_t m = m0 + row;
        const float hp = hc[e];
        const float si = sigmoid(gv[0][i] + acc[0][i] + hp * d0);
        const float sf = sigmoid(gv[1][i] + acc[1][i] + hp * d1);
        const float tg = tanhf(gv[2][i] + acc[2][i] + hp * d2);
        const float so = sigmoid(gv[3][i] + acc[3][i] + hp * d3);
        const float cn = sf * cc[e] + si * tg;
        const float hn = so * tanhf(cn);
        cc[e] = cn;
        hc[e] = hn;
        hout[(size_t)j * rpad + row] = vmlmf::exchanged<Bf16>(hn);
        ys[m * h + j] = hn;
        if (Res >= kCs) cs_out[m * h + j] = cn;
        if (Res >= kResF32) {
          R* gw = gates_out + m * g4;
          gw[j] = vmlmf::to_elem<R>(si);
          gw[h + j] = vmlmf::to_elem<R>(sf);
          gw[2 * h + j] = vmlmf::to_elem<R>(tg);
          gw[3 * h + j] = vmlmf::to_elem<R>(so);
        }
      }
    });
    vmlmf::group_sync(count, plan.ctas, target);
  }

  if (Res == kNoGrad)
    for (int e = threadIdx.x; e < jw * rows; e += blockDim.x) {
      const int jj = e % jw, row = e / jw;
      c_last[(size_t)(b0 + row) * h + j0 + jj] = cc[jj * rpad + row];
    }
}

// Launches grid_scan_kernel<Res, DenseRec, Bf16, Streamed>, Streamed where
// the plan streams some weight row; returns the launch's error. The plan
// must hold at least the shared memory this kernel carves, and the
// streamed scratch its CTAs' regions.
template <int Res, bool DenseRec, bool Bf16>
cudaError_t scan(const ScanIO& io, GridPlan plan, cudaStream_t stream) {
  using W = std::conditional_t<Bf16, bf16, float>;
  if (!resident_ok(DenseRec, io.h, io.r, plan) ||
      sizeof(float) * fwd_smem_floats<W>(DenseRec, io.h, io.r, plan) > (size_t)plan.smem)
    return cudaErrorInvalidValue;
  const size_t streamed = fwd_stream_floats<W>(DenseRec, io.h, io.r, plan);
  if (streamed * plan.groups * plan.ctas > io.wstream_floats ||
      (streamed > 0 && io.wstream == nullptr))
    return cudaErrorInvalidValue;
  ScanIO a = io;
  void* args[] = {&a.gi, &a.u, &a.v, &a.dvec, &a.h0, &a.c0, &a.ys, &a.c_last, &a.cs, &a.gates,
                  &a.hu, &a.xchg, &a.sync, &a.wstream, &a.t_len, &a.batch, &a.h, &a.r, &plan};
  return streamed > 0
             ? vmlmf::launch_grid(grid_scan_kernel<Res, DenseRec, Bf16, true>, plan, io.sync,
                                  args, stream)
             : vmlmf::launch_grid(grid_scan_kernel<Res, DenseRec, Bf16, false>, plan, io.sync,
                                  args, stream);
}

// The scan in the form and variant of a launch: the recurrent side's form
// (v null: dense), the precision and what it stores.
template <int Res>
cudaError_t scan_variant(const ScanIO& io, bool bf16_mm, GridPlan plan, cudaStream_t stream) {
  const bool dense_rec = io.v == nullptr;
  if (bf16_mm)
    return dense_rec ? scan<Res, true, true>(io, plan, stream)
                     : scan<Res, false, true>(io, plan, stream);
  return dense_rec ? scan<Res, true, false>(io, plan, stream)
                   : scan<Res, false, false>(io, plan, stream);
}

cudaError_t scan_any(const ScanIO& io, int res, bool bf16_mm, GridPlan plan,
                     cudaStream_t stream) {
  switch (res) {
    case kNoGrad: return scan_variant<kNoGrad>(io, bf16_mm, plan, stream);
    case kCs: return scan_variant<kCs>(io, bf16_mm, plan, stream);
    case kResF32: return scan_variant<kResF32>(io, bf16_mm, plan, stream);
    case kResBf16: return scan_variant<kResBf16>(io, bf16_mm, plan, stream);
    default: return cudaErrorInvalidValue;
  }
}

// What a residual forward stores, from the wrappers' residual policy.
int res_kind(int policy) {
  return policy == kPolicyF32 ? kResF32 : policy == kPolicyBf16 ? kResBf16
                                        : policy == kPolicyNone ? kCs : -1;
}

// The projection GEMMs of x mode (two, or one for a dense x side) on the
// tensor cores (gemm_tc.cuh), with bf16-rounded operands when Bf16, else in
// 3xTF32; returns the first error.
template <bool Bf16>
cudaError_t project(const float* x, const float* ux, const float* vx, const float* xdvec,
                    const float* bias, float* xu, float* gi, int m, int f, int rx, int h,
                    cudaStream_t stream) {
  using vmlmf::RowMajor;
  using vmlmf::tc::gemm;
  const int g4 = 4 * h;
  const vmlmf::GiEpilogue epi{gi, x, xdvec, bias, f, h};
  if (vx == nullptr)  // dense x side: gi = x @ Ux + the x term and bias
    return gemm<Bf16>(RowMajor{x, f}, RowMajor{ux, g4}, epi, m, g4, f, stream);
  cudaError_t err = gemm<Bf16>(RowMajor{x, f}, RowMajor{ux, rx}, vmlmf::Store{xu, rx}, m, rx, f,
                               stream);
  if (err != cudaSuccess) return err;
  return gemm<Bf16>(RowMajor{xu, rx}, RowMajor{vx, g4}, epi, m, g4, rx, stream);
}

// x mode: the projection, then the scan; returns the first error.
int launch_xin(const float* x, const float* ux, const float* vx, const float* xdvec,
               const float* bias, float* xu, const ScanIO& io, int f, int rx, int res,
               int bf16_mm, GridPlan plan, cudaStream_t stream) {
  const int m = io.t_len * io.batch;
  float* gi = const_cast<float*>(io.gi);
  cudaError_t err = bf16_mm ? project<true>(x, ux, vx, xdvec, bias, xu, gi, m, f, rx, io.h, stream)
                            : project<false>(x, ux, vx, xdvec, bias, xu, gi, m, f, rx, io.h,
                                             stream);
  if (err != cudaSuccess) return err;
  return scan_any(io, res, bf16_mm != 0, plan, stream);
}

}  // namespace

// No-grad forward, x mode. xu [T*B, rx] (null for a dense x side) and gi
// [T*B, 4h] are scratch that the caller allocates, as are the exchange
// buffers xchg, the barrier words sync and the streamed weights wstream of
// wstream_floats floats (scan_plan sizes them; wstream null where the plan
// streams nothing); writes ys [T,B,h] and c_last [B,h]. vx null: dense x
// side, rx unused; v null: dense recurrent side, r unused. The eight
// integers after r are scan_plan's layout (ScanPlan.ints); bf16_mm 1 rounds
// every product's operands to bf16.
extern "C" int lstm_scan_xin_fwd(
    const float* x, const float* ux, const float* vx, const float* xdvec,
    const float* bias, const float* u, const float* v, const float* dvec,
    const float* h0, const float* c0, float* xu, float* gi, float* ys,
    float* c_last, float* xchg, unsigned* sync, float* wstream, int wstream_floats, int t_len,
    int batch, int f, int rx, int h, int r, int groups, int ctas, int rpad, int stage, int red,
    int smem, int res_a, int res_b, int bf16_mm, void* stream_handle) {
  const ScanIO io{gi, u, v, dvec, h0, c0, ys, c_last, nullptr, nullptr, nullptr, xchg, sync,
                  wstream, static_cast<size_t>(wstream_floats), t_len, batch, h, r};
  return launch_xin(x, ux, vx, xdvec, bias, xu, io, f, rx, kNoGrad, bf16_mm,
                    GridPlan{groups, ctas, rpad, stage, red, smem, res_a, res_b},
                    static_cast<cudaStream_t>(stream_handle));
}

// Residual forward of training, x mode. gi [T*B, 4h], xchg and sync are
// scratch; writes ys, cs [T,B,h] and xu [T*B, rx] (null for a dense x
// side). policy 0 or 1 (saved gates, f32 or bf16 residuals) also writes the
// gates [T,B,4h] and hu [T,B,r] (null for a dense recurrent side) in that
// type; policy 2 (recompute) writes neither (both null), and xu is scratch.
extern "C" int lstm_scan_xin_fwd_res(
    const float* x, const float* ux, const float* vx, const float* xdvec,
    const float* bias, const float* u, const float* v, const float* dvec,
    const float* h0, const float* c0, float* xu, float* gi, float* ys,
    float* cs, void* gates, void* hu, float* xchg, unsigned* sync, float* wstream,
    int wstream_floats, int t_len, int batch, int f, int rx, int h, int r, int groups, int ctas,
    int rpad, int stage, int red, int smem, int res_a, int res_b, int bf16_mm, int policy,
    void* stream_handle) {
  const ScanIO io{gi, u, v, dvec, h0, c0, ys, nullptr, cs, gates, hu, xchg, sync,
                  wstream, static_cast<size_t>(wstream_floats), t_len, batch, h, r};
  return launch_xin(x, ux, vx, xdvec, bias, xu, io, f, rx, res_kind(policy), bf16_mm,
                    GridPlan{groups, ctas, rpad, stage, red, smem, res_a, res_b},
                    static_cast<cudaStream_t>(stream_handle));
}

// No-grad forward, gi mode (pallas_scan.py::lstm_scan_fused): the scan of
// the given gi [T*B, 4h]; writes ys and c_last.
extern "C" int lstm_scan_fwd(
    const float* gi, const float* u, const float* v, const float* dvec, const float* h0,
    const float* c0, float* ys, float* c_last, float* xchg, unsigned* sync, float* wstream,
    int wstream_floats, int t_len, int batch, int h, int r, int groups, int ctas, int rpad,
    int stage, int red, int smem, int res_a, int res_b, int bf16_mm, void* stream_handle) {
  const ScanIO io{gi, u, v, dvec, h0, c0, ys, c_last, nullptr, nullptr, nullptr, xchg, sync,
                  wstream, static_cast<size_t>(wstream_floats), t_len, batch, h, r};
  return scan_any(io, kNoGrad, bf16_mm != 0,
                  GridPlan{groups, ctas, rpad, stage, red, smem, res_a, res_b},
                  static_cast<cudaStream_t>(stream_handle));
}

// Residual forward, gi mode: writes ys, cs, the gates and hu (policy 0:
// f32, 1: bf16; gi mode always saves the gates).
extern "C" int lstm_scan_fwd_res(
    const float* gi, const float* u, const float* v, const float* dvec, const float* h0,
    const float* c0, float* ys, float* cs, void* gates, void* hu, float* xchg, unsigned* sync,
    float* wstream, int wstream_floats, int t_len, int batch, int h, int r, int groups,
    int ctas, int rpad, int stage, int red, int smem, int res_a, int res_b, int bf16_mm,
    int policy, void* stream_handle) {
  if (policy == kPolicyNone) return cudaErrorInvalidValue;
  const ScanIO io{gi, u, v, dvec, h0, c0, ys, nullptr, cs, gates, hu, xchg, sync,
                  wstream, static_cast<size_t>(wstream_floats), t_len, batch, h, r};
  return scan_any(io, res_kind(policy), bf16_mm != 0,
                  GridPlan{groups, ctas, rpad, stage, red, smem, res_a, res_b},
                  static_cast<cudaStream_t>(stream_handle));
}

// The message of an error code that an entry of this file returned.
extern "C" const char* lstm_scan_xin_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
