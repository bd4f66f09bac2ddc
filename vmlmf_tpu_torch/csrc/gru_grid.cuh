// The grid layout of the GRU scan kernels (gru_scan_xin_fwd.cu's
// grid_fwd_kernel, gru_scan_xin_bwd.cu's grid_walk_kernel), for sm_90a: the
// layout that ops/cuda_gru.py::gru_grid_plan decides, for layers whose
// recurrent weights do not fit in one CTA's shared memory.
//
// It is the LSTM scans' model (scan_grid.cuh): one cooperative launch cut
// into `groups` batch groups of consecutive rows, each on `ctas` CTAs. CTA q
// of a group owns the hidden units j0 .. j1-1 and, low-rank, the rank
// columns k0 .. k1-1 (split_at), and holds two weight slices in shared
// memory for the whole scan:
//
//   forward  A = Uf[:, k-slice]                    [h][kwp]       (low-rank)
//            B = [Prz_r | Prz_z | Pn][:, j-slice]  [depth][3 jwp]  (depth r or h)
//   walk     A = [Prz; Pn]^T rows of the k-slice   [3h][kwp]      (low-rank)
//            B = [Prz; Pn]^T rows of the j-slice   [3h][jwp]      (dense)
//              = Uf^T rows of the j-slice          [r][jwp]       (low-rank)
//
// jwp = round4(ceil(h / ctas)) and kwp = round4(ceil(r / ctas)); columns past
// a CTA's own are zero. A product of the step reads the group's exchange
// buffer [depth][rpad] (h, r*h, hu, rhu, or the walk's dpre, drhu, dhu)
// through L2 and multiplies it with a range of rows and columns of one slice
// (rows_product). Where the slices do not fit in the shared memory of all
// SMs, a slice keeps its first `res` depth rows resident and the CTA streams
// the rest from its own region of a device-memory scratch every step
// (GridPlan::res_a / res_b), in the same order of sums.

#pragma once

#include "gru_tile.cuh"

namespace vmlmf {
namespace gru {

// The widths of a CTA's slices: jwp units and kwp rank columns (0 dense).
struct GridWidths {
  int jwp, kwp;
  __host__ __device__ GridWidths(int form, int h, int r, const GridPlan& p)
      : jwp(round4(div_up(h, p.ctas))),
        kwp(form == kLowrankPre ? round4(div_up(r, p.ctas)) : 0) {}
};

// (depth, columns) of slice A and slice B of the forward (walk = false) or
// the walk; A's depth is 0 in the dense forms.
struct SliceShapes {
  int da, ca, db, cb;
  __host__ __device__ SliceShapes(int form, int h, int r, const GridPlan& p, bool walk) {
    const GridWidths w(form, h, r, p);
    const bool lowrank = form == kLowrankPre;
    da = lowrank ? (walk ? 3 * h : h) : 0;
    ca = w.kwp;
    db = walk ? (lowrank ? r : 3 * h) : (lowrank ? r : h);
    cb = walk ? w.jwp : 3 * w.jwp;
  }
};

// [units][rpad] buffers of each kernel: the forward's carry, the step's gi
// (3) and z ("pre") or the product's sums (3, "post"); the walk's carry and
// its staged inputs r, z, n, h_prev, dys (and recn in "post").
__host__ __device__ inline int grid_slabs(int form, bool walk) {
  if (walk) return form == kDensePost ? 7 : 6;
  return form == kDensePost ? 7 : 5;
}

// Floats of a kernel's shared memory, in the order of its carve: the
// resident rows of slices A and B, the slabs, stage and red.
__host__ __device__ inline size_t grid_smem_floats(int form, int h, int r, const GridPlan& p,
                                                   bool walk) {
  const SliceShapes s(form, h, r, p, walk);
  const size_t weights = (size_t)p.res_a * s.ca + (size_t)p.res_b * s.cb;
  return weight_floats<float>(weights) +
         (size_t)grid_slabs(form, walk) * GridWidths(form, h, r, p).jwp * p.rpad + p.stage + p.red;
}

// Floats of one CTA's region of the streamed scratch: the rows of its two
// slices past their resident depths.
__host__ __device__ inline size_t grid_stream_floats(int form, int h, int r, const GridPlan& p,
                                                     bool walk) {
  const SliceShapes s(form, h, r, p, walk);
  return weight_floats<float>((size_t)(s.da - p.res_a) * s.ca + (size_t)(s.db - p.res_b) * s.cb);
}

// Whether a plan's resident depths are ones the kernels take.
__host__ __device__ inline bool grid_resident_ok(int form, int h, int r, const GridPlan& p,
                                                 bool walk) {
  const SliceShapes s(form, h, r, p, walk);
  return p.res_a >= 0 && p.res_a <= s.da && p.res_b >= 0 && p.res_b <= s.db &&
         p.groups >= 1 && p.ctas >= 1 && p.rpad >= 4 && p.rpad % 4 == 0 && p.stage >= 0 &&
         p.red >= 0;
}

// Streamed weight rows a thread loads before their FMAs (slice_product's
// Batch): a step of a streamed plan walks thousands of rows a thread, and
// four loads in flight left it waiting on device memory.
constexpr int kStreamBatch = 8;

// scan_grid.cuh::slice_product on rows d0 .. d0 + depth and columns col0 ..
// col0 + ncols of a slice of row stride ldw whose first `resident` rows lie
// in shared memory at w and the rest in the streamed region at ws; `a` is
// the exchange buffer [depth][rpad] of the product's rows.
template <bool Streamed, class Epi>
__device__ __forceinline__ void rows_product(const float* a, int d0, int depth, int rpad,
                                             const float* w, const float* ws, int resident,
                                             int ldw, int col0, int ncols, float* stage,
                                             int stage_floats, float* red, int red_floats,
                                             Epi epi) {
  const int res = min(depth, max(0, resident - d0));
  const float* wr = w + (size_t)d0 * ldw + col0;
  const float* wsr = Streamed ? ws + (size_t)max(0, d0 - resident) * ldw + col0 : nullptr;
  slice_product<Streamed, kStreamBatch>(a, depth, rpad, wr, wsr, res, ldw, ncols, stage,
                                        stage_floats, red, red_floats, epi);
}

// Stores the value of element (d, c) of a slice of row stride ldw: into
// shared memory for d < resident, else into the CTA's streamed region.
template <bool Streamed>
__device__ __forceinline__ void slice_store(float* w, float* ws, int resident, int ldw, int d,
                                            int c, float v) {
  if constexpr (Streamed)
    slice_elem(w, ws, resident, ldw, d, c) = v;
  else
    w[(size_t)d * ldw + c] = v;
}

}  // namespace gru
}  // namespace vmlmf
