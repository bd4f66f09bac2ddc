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
// (GridSlice::rows, grid_product). Where the slices do not fit in the
// shared memory of all SMs, a slice keeps its first `res` depth rows
// resident and the CTA streams the rest from its own region of a
// device-memory scratch every step (GridPlan::res_a / res_b), in the same
// order of sums.
//
// A plan that streams rows runs its products on the ring of scan_grid.cuh
// (GridPlan::piece > 0; kRingThreads threads, the 17th warp the
// producer): TMA bulk copies bring the exchange and the streamed rows a
// piece at a time into two stages in shared memory, where slice_product
// copied the exchange in halves of `stage` with cp.async and loaded each
// streamed row inside its FMA loop. The order of sums stays
// slice_product's (its items, slices, chunks of `stage` / 2 rows and the
// fixed-order reduction in `red`), so the bits are the plan's without the
// ring. A product streams only the columns it reads: the forward's slice
// B of the "pre" forms, whose products read its columns [0, 2 jwp) (r, z)
// and [2 jwp, 3 jwp) (n) apart, keeps its streamed rows as two blocks,
// [rows][2 jwp] then [rows][jwp] (SliceShapes::split_b). Every width is a
// multiple of 4 floats, so each streamed row is a whole number of 16-byte
// units (scan_grid.cuh::ring_ld) and each run of rows one bulk copy. Where
// no row streams (the HAR widths, h = 180, h = 1000) the products run
// slice_product on kGridThreads as before. (The kernels also take a ring on
// a plan whose rows are all resident, which the checks force; at h=1000,
// B=256, whose exchange the staging buffer takes in chunks, a ring in its
// room ran slower than the staging buffer, so no plan asks for one.)
//
// An item of a product, the sums one consumer thread keeps, is 4 columns
// of the slice by R batch rows (GridPlan::tile, R in 4, 8, 12; rpad a
// multiple of R), which ops/cuda_gru.py::grid_tiles chooses for each
// kernel: a depth row costs the thread one float4 of W and R/4 float4 of
// the exchange for 4R FMAs, so a taller item feeds more FMAs from each
// shared-memory load (at R = 4, 16 FMAs for two LDS.128, which bound the
// loop at h=3200). The weights' side (jwp, kwp, the column splits, the
// streamed blocks, the ring's pieces) is the same for every R; the items,
// and with them the slices and `red`, are cut by R, and the slices'
// partials meet in `red` in R/4 passes of 16 sums, so `red` is 16 x items
// x slices floats at every R. R = 4 is the LSTM scans' item, their order
// of sums; a plan with another R has other slices, so other bits. The
// kernels are built for every R on both paths; the plan takes a taller
// item only where it measured faster without spilling more (PERF.md).

#pragma once

#include "gru_tile.cuh"

namespace vmlmf {
namespace gru {

// Whether the grid kernels are built for items of `tile` batch rows.
__host__ __device__ inline bool grid_tile_ok(int tile) {
  return tile == 4 || tile == 8 || tile == 12;
}

// The widths of a CTA's slices: jwp units and kwp rank columns (0 dense).
struct GridWidths {
  int jwp, kwp;
  __host__ __device__ GridWidths(int form, int h, int r, const GridPlan& p)
      : jwp(round4(div_up(h, p.ctas))),
        kwp(form == kLowrankPre ? round4(div_up(r, p.ctas)) : 0) {}
};

// (depth, columns) of slice A and slice B of the forward (walk = false) or
// the walk; A's depth is 0 in the dense forms. split_b: the columns of the
// first block of slice B's streamed rows (cb: one block; the forward's
// "pre" forms 2 jwp, the r and z columns, before the n columns).
struct SliceShapes {
  int da, ca, db, cb, split_b;
  __host__ __device__ SliceShapes(int form, int h, int r, const GridPlan& p, bool walk) {
    const GridWidths w(form, h, r, p);
    const bool lowrank = form == kLowrankPre;
    da = lowrank ? (walk ? 3 * h : h) : 0;
    ca = w.kwp;
    db = walk ? (lowrank ? r : 3 * h) : (lowrank ? r : h);
    cb = walk ? w.jwp : 3 * w.jwp;
    split_b = !walk && form != kDensePost ? 2 * w.jwp : cb;
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
// resident rows of slices A and B, the slabs, stage (on a ring plan, the
// ring: scan_grid.cuh::ring_floats) and red.
__host__ __device__ inline size_t grid_smem_floats(int form, int h, int r, const GridPlan& p,
                                                   bool walk) {
  const SliceShapes s(form, h, r, p, walk);
  const size_t weights = (size_t)p.res_a * s.ca + (size_t)p.res_b * s.cb;
  return weight_floats<float>(weights) +
         (size_t)grid_slabs(form, walk) * GridWidths(form, h, r, p).jwp * p.rpad +
         (p.piece ? ring_floats(p) : (size_t)p.stage) + p.red;
}

// Floats of one CTA's region of the streamed scratch: the rows of its two
// slices past their resident depths (slice B's in its blocks, split_b).
__host__ __device__ inline size_t grid_stream_floats(int form, int h, int r, const GridPlan& p,
                                                     bool walk) {
  const SliceShapes s(form, h, r, p, walk);
  return weight_floats<float>((size_t)(s.da - p.res_a) * s.ca + (size_t)(s.db - p.res_b) * s.cb);
}

// Whether a plan's ring is one the kernels take: a plan without a ring
// streams nothing; a ring's stages hold one depth row of A and, where rows
// stream, its rpad exchange floats and a streamed row of the widest block
// (scan_grid.cuh::ring_holds).
inline bool grid_ring_ok(int form, int h, int r, const GridPlan& p, bool walk) {
  const SliceShapes s(form, h, r, p, walk);
  const bool streams = p.res_a < s.da || p.res_b < s.db;
  if (!p.piece) return !streams;
  return ring_ok(p) && p.piece >= p.rpad &&
         (!streams || ring_holds<float>(p, s.ca > s.split_b ? s.ca : s.split_b));
}

// Whether a plan's resident depths and item rows are ones the kernels take.
__host__ __device__ inline bool grid_resident_ok(int form, int h, int r, const GridPlan& p,
                                                 bool walk) {
  const SliceShapes s(form, h, r, p, walk);
  return p.res_a >= 0 && p.res_a <= s.da && p.res_b >= 0 && p.res_b <= s.db &&
         p.groups >= 1 && p.ctas >= 1 && grid_tile_ok(p.tile) && p.rpad >= p.tile &&
         p.rpad % p.tile == 0 && p.stage >= 0 && p.red >= 0;
}

// One weight slice of a CTA: its first `resident` of `depth` rows at w in
// shared memory, [resident][ldw], and the others at ws in the CTA's
// streamed region, in column blocks: [depth - resident][split], then
// [depth - resident][ldw - split] (split = ldw: one block).
struct GridSlice {
  float* w;
  float* ws;
  int depth, resident, ldw, split;

  // The store of element (d, c), the prologue's.
  __device__ __forceinline__ void store(int d, int c, float v) const {
    if (d < resident) {
      w[(size_t)d * ldw + c] = v;
      return;
    }
    const size_t rows = depth - resident, at = d - resident;
    if (c < split)
      ws[at * split + c] = v;
    else
      ws[rows * split + at * (ldw - split) + c - split] = v;
  }

  // The ring's operand of the product over rows d0 .. d0 + n and columns
  // col0 .. col0 + ncols (col0 0 or `split`: a whole block), from the
  // exchange rows at `a`.
  __device__ __forceinline__ RingOperand<float> rows(const float* a, int d0, int n, int col0,
                                                     int ncols) const {
    const int width = col0 < split ? split : ldw - split;
    const float* block = col0 < split ? ws : ws + (size_t)(depth - resident) * split;
    return RingOperand<float>{a,
                              w + (size_t)d0 * ldw + col0,
                              block + (size_t)max(0, d0 - resident) * width,
                              n,
                              min(n, max(0, resident - d0)),
                              ldw,
                              ncols,
                              width};
  }
};

// A product of the grid kernels in items of R rows: on the ring where the
// plan has one (OnRing), else scan_grid.cuh::slice_product over the
// operand's rows, all resident; epi as both call it.
template <bool OnRing, int R, class Epi>
__device__ __forceinline__ void grid_product(Ring& ring, const RingOperand<float>& op,
                                             const GridPlan& p, float* stage, float* red,
                                             Epi epi) {
  if constexpr (OnRing)
    ring.product<R>(op, red, epi);
  else
    slice_product<R>(op.a, op.depth, p.rpad, op.w, op.ldw, op.ncols, stage, p.stage, red, p.red,
                     epi);
}

}  // namespace gru
}  // namespace vmlmf
