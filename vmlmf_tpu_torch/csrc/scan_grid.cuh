// The pieces of the LSTM scan kernels that spread a step over many CTAs
// (lstm_scan_xin_fwd.cu, lstm_scan_xin_bwd.cu; and, one set of CTAs per
// layer, the wavefront stack's lstm_stack_fwd.cu, lstm_stack_bwd.cu), for
// sm_90a: the layout that ops/cuda_scan.py::scan_plan (cuda_stack.py::
// stack_plan) decides, the barrier of a batch group, the wait on another
// group's progress, and the product of one CTA's weight slice with a
// group's rows.
//
// The batch is cut into `groups` groups of consecutive rows; each group has
// `ctas` CTAs, each of which holds one slice of the recurrent weights in
// shared memory for the whole scan. CTA q of a group owns the hidden units
// j0 .. j1-1 (all four gate columns of each) and the rank columns k0 .. k1-1,
// split as evenly as integers allow: [q*n/ctas, (q+1)*n/ctas). Groups never
// wait for each other. Inside a group, CTAs exchange the step's h (or dpre,
// hu, dhu) through global buffers laid out [depth][rpad]: one column per
// batch row of the group, padded to rpad (a multiple of 4) rows.
//
// The bf16 variants (precision "bf16" of pallas_scan.py) hold the weight
// slices in shared memory as bf16. Where a group pads its rows to fewer than
// 24 (the plan's `mma` unset: the HAR layer, the PTB LM layer up to B=128,
// the stack) they widen them for f32 FMAs: a bf16 product summed in f32 is
// exactly the f32 FMA of the two bf16-rounded operands; the exchange buffers
// stay f32, but the CTA that writes an exchanged value rounds it to bf16
// first, since a product is its only reader. The LSTM scans' plans with 24
// padded rows or more (`mma`) run each product on the tensor cores instead
// (Ring::mma_product below): bf16 exchange buffers, weight slices in the
// order of the mma's fragments.
// Either way the carry, the diagonal terms and the gates stay f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace vmlmf {

using bf16 = __nv_bfloat16;

constexpr int kGridThreads = 512;  // threads per CTA of the grid kernels
constexpr int kMaxSlices = 32;     // depth slices of one product item
constexpr int kMinSliceDepth = 8;  // depth rows a slice takes at least

// The layout of a launch, from scan_plan: groups x ctas CTAs; rpad padded
// rows per group; stage and red: floats of the staging buffer and of the
// slice partials in shared memory; smem: the bytes the plan sized. The
// per-layer scans also take res_a and res_b, the depth rows of their two
// weight slices that stay in shared memory (ScanPlan.resident_fwd / _bwd):
// the rows past them are streamed, read every step through L2 from the
// CTA's own region of a device-memory scratch. The stack leaves them 0.
// The LSTM scans' streamed plans also take piece: the floats of each of
// the kRingStages stages of the ring that feeds their products (0: a plan
// that streams nothing, with the staging buffer of `stage` floats).
// `mma` (the LSTM scans' bf16 plans whose groups pad to 24 rows or more):
// the products run on the tensor cores, on the ring whether or not a row is
// streamed, the exchange is bf16 and rpad a multiple of 8
// (Ring::mma_product). `tile`: the batch rows R of a product item (4, 8 or
// 12; rpad a multiple of it), which the GRU grid's plans choose
// (ops/cuda_gru.py::grid_tiles); the LSTM scans and the stack keep 4.
struct GridPlan {
  int groups, ctas, rpad, stage, red, smem;
  int res_a = 0, res_b = 0;
  int piece = 0;
  int mma = 0;
  int tile = 4;
};

inline __host__ __device__ int split_at(int q, int n, int parts) {
  return static_cast<int>(static_cast<long long>(q) * n / parts);
}
inline __host__ __device__ int div_up(int a, int b) { return (a + b - 1) / b; }
inline __host__ __device__ int round4(int n) { return div_up(n, 4) * 4; }

// A barrier that waits this long has lost a CTA: the launch traps (an
// error the wrapper raises) rather than hang the card.
constexpr unsigned long long kBarrierTimeoutNs = 4000000000ull;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

// Waits until the global word `count` has reached `target` (a wrapping
// difference): thread 0 spins on acquire loads and traps after
// kBarrierTimeoutNs, and the CTA's other threads wait at the closing
// __syncthreads, which passes the acquire on to them. The wavefront stack
// also waits so on the word of another layer's barrier, which counts that
// layer's progress.
__device__ __forceinline__ void wait_count(const unsigned* count, unsigned target) {
  if (threadIdx.x == 0) {
    const unsigned long long start = global_ns();
    for (;;) {
      unsigned seen;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(count) : "memory");
      if (static_cast<int>(seen - target) >= 0) break;
      if (global_ns() - start > kBarrierTimeoutNs) __trap();
    }
  }
  __syncthreads();
}

// Barrier of the `n` CTAs of one group: a generation count in a global word
// that the launcher zeroes. `target` lives in thread 0 and grows by n a
// call. After __syncthreads, thread 0's acq_rel fence releases every write
// the CTA made before the barrier, its relaxed add arrives, and its acquire
// loads wait for the group (wait_count). Exchange buffers are then read
// with cp.async.cg (L2, coherent), never through the non-coherent path. A
// group of one CTA skips the word, unless `progress`: then every round
// arrives, so that the word counts the group's progress (the stack's layers).
__device__ __forceinline__ void group_sync(unsigned* count, int n, unsigned& target,
                                           bool progress = false) {
  __syncthreads();
  if (n == 1 && !progress) {
    __syncthreads();
    return;
  }
  if (threadIdx.x == 0) {
    target += n;
    asm volatile("fence.acq_rel.gpu;\n\tred.relaxed.gpu.global.add.u32 [%0], 1;"
                 :: "l"(count) : "memory");
  }
  wait_count(count, target);
}

// An asynchronous 4-byte copy from global to shared memory (cp.async), so a
// step's inputs load while the CTA computes or waits at a barrier; wait for
// all of a thread's copies with cp_async_wait_all, then __syncthreads.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
// The 16-byte form through L2 only (.cg: coherent with the other SMs'
// writes before a barrier), committed as a group, and the wait for all
// groups but the newest.
__device__ __forceinline__ void cp_async16_cg(float4* dst, const float4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// An element of type T (f32, or bf16 rounded to nearest even) from an f32
// value; and four weight elements (8 or 16 aligned bytes) widened to f32.
template <class W>
__device__ __forceinline__ W to_elem(float v);
template <>
__device__ __forceinline__ float to_elem<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 to_elem<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 widen4(uint2 raw) {
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  return widen4(*reinterpret_cast<const uint2*>(p));
}
// Floats of shared memory that `elems` weight elements of type W take,
// rounded up to 16 bytes so that the f32 regions after them stay aligned.
template <class W>
__host__ __device__ inline size_t weight_floats(size_t elems) {
  return (elems * sizeof(W) + 15) / 16 * 4;
}

// The element of a weight slice's row d at `at`, where the first `resident`
// rows [resident][ldw] lie in shared memory at `w` and the rest [depth -
// resident][ldws] in the CTA's streamed region at `ws`: the prologue's
// store. The LSTM's ring pads the streamed rows to 16 bytes (ring_ld).
template <class W>
__device__ __forceinline__ W& slice_elem(W* w, W* ws, int resident, int ldw, int ldws, int d,
                                         int at) {
  return d < resident ? w[(size_t)d * ldw + at] : ws[(size_t)(d - resident) * ldws + at];
}

// out(col, row) = sum over d < depth of A[d][row] * W[d][col], for col <
// ncols (a multiple of 4) and row < rpad. A is a global exchange buffer
// [depth][rpad], copied into shared memory with 16-byte cp.async.cg: whole
// when it fits in `stage`, else in chunks of stage / 2 floats, the next
// chunk copying into one half while the CTA multiplies the other. W is
// this CTA's weight slice in shared memory, [depth][ldw], f32 or bf16 (ldw
// a multiple of 4); a plan that streams weight rows runs Ring::product
// below instead, in this order of sums. An item is 4 columns x R rows (4R
// sums in registers; a depth row loads R/4 float4 of A and four elements
// of W, widened, for 4R FMAs; R a multiple of 4 that divides rpad). With
// fewer items than threads, each item's depth is cut into `slices`
// interleaved parts; their partial sums meet in `red` and one thread per
// output adds them in slice order: deterministic, no atomics; 16 sums of
// an item at a time, in R/4 passes, so that `red` holds 16 x items x
// slices floats whatever R. Calls epi(cb, rb, acc) once per item, acc[c][i]
// the sum of column 4cb+c, row R*rb+i. The partials lie [slice][16][items],
// so that neighbouring threads (neighbouring items) touch neighbouring
// banks. Every thread of the CTA must call it.
template <int R = 4, class W, class Epi>
__device__ __forceinline__ void slice_product(const float* a, int depth, int rpad, const W* w,
                                              int ldw, int ncols, float* stage, int stage_floats,
                                              float* red, int red_floats, Epi epi) {
  static_assert(R % 4 == 0, "an item's rows are whole float4 of the exchange");
  constexpr int kQ = R / 4;          // float4 of A an item reads a depth row
  constexpr int kUnroll = 4 / kQ;    // depth rows of the loop's body: 4, 2, 1
  const int cbs = ncols / 4, rbs = rpad / R, r4 = rpad / 4;
  const int items = cbs * rbs;
  if (items == 0) return;
  int slices = items >= kGridThreads ? 1 : min(kMaxSlices, kGridThreads / items);
  slices = max(1, min(min(slices, depth / kMinSliceDepth), red_floats / (16 * items)));
  const int units = items * slices;
  const bool whole = depth * rpad <= stage_floats;
  const int chunk = whole ? depth : stage_floats / 2 / rpad;
  const int chunks = div_up(depth, chunk);
  const float4* a4 = reinterpret_cast<const float4*>(a);
  // chunk c into half c % 2 of the staging buffer, as one cp.async group
  auto copy = [&](int c) {
    float4* dst = reinterpret_cast<float4*>(stage) + (c & 1) * (chunk * r4);
    const float4* src = a4 + (size_t)c * chunk * r4;
    const int n4 = min(chunk, depth - c * chunk) * r4;
    for (int i = threadIdx.x; i < n4; i += kGridThreads) cp_async16_cg(dst + i, src + i);
    cp_async_commit();
  };

  for (int base = 0; base < units; base += kGridThreads) {
    const int unit = base + threadIdx.x;
    const bool live = unit < units;
    const int item = unit % items, s = unit / items;
    const int cb = item % cbs, rb = item / cbs;
    float acc[4][R] = {};
    copy(0);
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) {
        copy(c + 1);
        cp_async_wait_but_newest();
      } else {
        cp_async_wait_all();
      }
      __syncthreads();
      if (live) {
        const int d0 = c * chunk, dn = min(chunk, depth - d0);
        const float4* s4 = reinterpret_cast<const float4*>(stage) + (c & 1) * (chunk * r4);
        const W* wd = w + (size_t)d0 * ldw + 4 * cb;
#pragma unroll (kUnroll)
        for (int d = s; d < dn; d += slices) {
          float ar[R];
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const float4 av = s4[d * r4 + rb * kQ + q];
            ar[4 * q] = av.x, ar[4 * q + 1] = av.y, ar[4 * q + 2] = av.z, ar[4 * q + 3] = av.w;
          }
          const float4 wv = load4(wd + (size_t)d * ldw);
          const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int i = 0; i < R; ++i) acc[k][i] = fmaf(ar[i], wc[k], acc[k][i]);
        }
      }
      __syncthreads();
    }
    if (slices > 1) {  // one pass: units <= threads
#pragma unroll
      for (int q = 0; q < kQ; ++q) {  // rows 4q .. 4q + 3 of the items
        if (q > 0) __syncthreads();   // the last pass's reads of red
        if (live) {
          float* p = red + (size_t)s * 16 * items + item;
#pragma unroll
          for (int e = 0; e < 16; ++e) p[e * items] = acc[e / 4][4 * q + e % 4];
        }
        __syncthreads();
        for (int o = threadIdx.x; o < items * 16; o += kGridThreads) {
          float v = red[o];
          for (int z = 1; z < slices; ++z) v += red[(size_t)z * items * 16 + o];
          red[o] = v;
        }
        __syncthreads();
        if (live && s == 0) {
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[e / 4][4 * q + e % 4] = red[e * items + item];
        }
      }
    }
    if (live && s == 0) epi(cb, rb, acc);
  }
}

// ---------------------------------------------------------------------------
// The ring of the LSTM scans' streamed plans (lstm_scan_xin_fwd.cu,
// lstm_scan_xin_bwd.cu where ScanPlan.ring > 0), and of the GRU grid's
// plans that stream rows (gru_grid.cuh).
//
// A streamed plan's products read two things from L2 a step: the group's
// exchange buffer A [depth][rpad], which every CTA reads whole, and the
// CTA's streamed weight rows. slice_product copies A in two halves with
// one in flight, two __syncthreads and a full L2 round trip per chunk, and
// loads each streamed row inside its FMA loop. Here a ring of kRingStages
// stages of `piece` floats each in shared memory holds pieces of the walk:
// a stage holds A's rows [e0, e1) and the CTA's streamed rows among them,
// each copied by one TMA bulk copy (cp.async.bulk) that reports its bytes
// to the stage's `full` mbarrier. One producer warp (the block's 17th; one
// lane issues) keeps kRingStages pieces in flight; the 16 consumer warps
// wait on `full`, run their FMAs and release the stage on its `empty`
// mbarrier. The weight rows never change, so the producer issues the next
// product's first stages of them before the CTA waits at the group barrier
// (preload) and their A rows right after it.
//
// The order of sums is slice_product's: thread s of an item walks the rows
// d0 + s, d0 + s + slices, ... of each chunk [d0, d0 + chunk) that
// slice_product stages (chunk = stage / 2 / rpad, or the whole depth where
// it fits in `stage`), accumulating across chunks, with the same `slices`
// and the same fixed-order reduction in `red`. The pieces cut the depth
// into runs of as many rows as a stage holds, across chunk bounds: over
// the resident rows a stage holds A alone, past them A and the streamed
// rows. The thread carries its next row from piece to piece, and moves to
// d0 + s of the next chunk where one ends. So where the CTA count is the
// parent's, the bits are. The item's rows R are a template argument of
// walk, preload, product and consume, as of slice_product (4 by default).
// ---------------------------------------------------------------------------

constexpr int kRingThreads = kGridThreads + 32;  // 16 consumer warps, one producer warp
constexpr int kConsumerWarps = kGridThreads / 32;
// Stages of the ring: more ran no faster (tools/ring_sweep.py, PERF.md),
// and the shared memory they take holds resident rows instead.
constexpr int kRingStages = 2;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// The 16 consumer warps alone (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kGridThreads) : "memory");
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// One arrival that also expects `bytes` of copies to complete on the barrier.
__device__ __forceinline__ void mbar_arm(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Waits until the barrier's phase of parity `parity` has completed; traps
// after kBarrierTimeoutNs, as group_sync does.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  auto ready = [&]() {
    unsigned done;
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}" : "=r"(done) : "r"(a), "r"(parity) : "memory");
    return done != 0;
  };
  if (ready()) return;
  const unsigned long long start = global_ns();
  while (!ready())
    if (global_ns() - start > kBarrierTimeoutNs) __trap();
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_u32(bar)) : "memory");
}
// Generic-proxy writes to device memory (the prologue's streamed rows, the
// exchange that a barrier published) made visible to the bulk copies.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}
// A bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from device memory into this CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1], %2, [%3];"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Elements of a streamed row in the CTA's region: the slice's row stride
// rounded up to 16 bytes, so that every run of rows is one bulk copy.
template <class W>
__host__ __device__ inline int ring_ld(int ldw) {
  return div_up(ldw * (int)sizeof(W), 16) * 16 / (int)sizeof(W);
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core product of the LSTM scans' `mma` plans.
//
// out(col, row) = sum over d < depth of W[d][col] * A[d][row], with W the
// CTA's bf16 weight slice (`cols` columns, a multiple of 4) and A the
// group's bf16 exchange, as mma.sync m16n8k16 tiles: M the slice's columns
// (16 a tile, columns past `cols` zero), N the group's rows (8 a tile; rpad
// a multiple of 8), K the depth in blocks of kMmaK = 16 rows, padded to
// whole blocks (zero weights, and exchange rows that the group zeroes).
// * Weights in fragment order: block kb of a slice is [cols][16] bf16, a
//   column's 16 depth rows in the order 2t, 2t+1, 2t+8, 2t+9 for t = 0..3
//   (mma_pos), so that lane (g, t) reads its A fragment of columns g and
//   g + 8 as two 8-byte loads (no bank conflict), and a run of blocks is
//   one bulk copy. The prologue writes them so, the resident blocks into
//   shared memory and the others into the CTA's streamed region.
// * The exchange [depth16][xld] bf16 in device memory, a row per depth row,
//   xld = rpad made 8 mod 16 (mma_xld) so that the eight 16-byte rows of an
//   ldmatrix lie in distinct banks; B fragments come from its rows in a
//   ring stage by ldmatrix.trans. Half the bytes of the f32 exchange, and
//   the values the FMA plans round to bf16.
// * Every mma plan runs its products on the ring (Ring::mma_product), whose
//   TMA stages bring the exchange (and the streamed blocks) a piece of
//   whole blocks at a time, also where every block is resident: two large
//   stages keep far more bytes in flight than a staging buffer beside the
//   resident weights, and the mmas leave the walk to its reads.
// * The order of sums depends on depth, cols and rpad alone (MmaSplit): a
//   warp takes one m-tile by up to kMmaTiles n-tiles (its A fragment read
//   once a block, each n-tile's B fragment once), the warp tiles spread
//   over the 16 warps and, with fewer of them than warps, the k16 blocks
//   over kw k-groups too, k-group j taking the blocks kb = j (mod kw). The
//   mmas of kMmaFlush consecutive blocks of a warp's walk sum in the
//   tensor cores and join the warp's f32 sum by a rounded f32 add, in
//   block order (an mma adds to its accumulator rounding toward zero, a
//   bias that would grow with the depth: gemm_tc.cuh); the k-groups' sums
//   meet in `red`, added in k-group order, no atomics. Neither where a row
//   lies (resident or streamed) nor how the ring cuts the depth changes a
//   sum. A warp loads its next block's fragments while its mmas run, and
//   runs no predicated instruction in its loop. More warp tiles than warps
//   run in passes over the depth.
// * What bounds it on the H100: the consumers' mmas. At dense h=1500,
//   B=128 a forward step is 1128 m16n8k16 mma.sync a sub-partition, about
//   12 µs: one every 16 cycles or so, far below wgmma's rate; then the
//   exchange's L2 reads (tools/scan_phases.py, PERF.md).
// ---------------------------------------------------------------------------

constexpr int kMmaK = 16;      // depth rows of a block (the mma's k)
constexpr int kMmaTiles = 4;   // 16x8 output tiles a warp holds at once
constexpr int kMmaGroups = 4;  // k-groups at most
constexpr int kMmaFlush = 4;   // blocks a warp sums in the tensor cores between f32 adds

__host__ __device__ inline int round16(int n) { return div_up(n, kMmaK) * kMmaK; }
// bf16 elements of an exchange row: rpad made 8 mod 16
__host__ __device__ inline int mma_xld(int rpad) { return rpad % 16 ? rpad : rpad + 8; }
// the place of depth row k (of a block's 16) within a column
__host__ __device__ inline int mma_pos(int k) {
  return k < 8 ? 4 * (k >> 1) + (k & 1) : 4 * ((k - 8) >> 1) + 2 + (k & 1);
}
// the element of depth row d, column col of a slice of `cols` columns
__host__ __device__ inline size_t mma_at(int d, int col, int cols) {
  return ((size_t)(d / kMmaK) * cols + col) * kMmaK + mma_pos(d % kMmaK);
}
// the depth rows of a slice held in shared memory, in whole blocks: a
// plan's resident depth is a multiple of 16 or the whole depth
__host__ __device__ inline int mma_resident(int resident, int depth) {
  return resident >= depth ? round16(depth) : resident;
}

// How a product's work lies on the 16 warps (ops/cuda_scan.py::mma_split):
// its blocks, m-tiles (16 columns) and n-tiles (8 rows); a warp's tiles,
// one m-tile by up to kMmaTiles n-tiles (its A fragment loaded once a
// block), nper of them, the n-tiles cut into nbs runs of as even a length;
// tws = mts * nbs such warp tiles, on tw warps in `passes` passes; and, with
// fewer warp tiles than warps, the blocks over kw k-groups too (at most
// kMmaGroups). The k-groups' sums meet in `out` in as many rounds.
struct MmaSplit {
  int blocks, mts, nts, nbs, nper, tws, kw, tw, passes;
  __host__ __device__ MmaSplit(int depth, int cols, int rpad) {
    blocks = div_up(depth, kMmaK);
    mts = div_up(cols, 16);
    nts = rpad / 8;
    nbs = div_up(nts, kMmaTiles);
    nper = div_up(nts, nbs);
    tws = mts * nbs;
    if (tws >= kConsumerWarps) {
      kw = 1;
      tw = kConsumerWarps;
    } else {
      tw = tws;
      kw = kConsumerWarps / tws;
      kw = kw > kMmaGroups ? kMmaGroups : kw;
      kw = kw > blocks ? blocks : kw;
    }
    passes = div_up(tws, tw);
  }
};

// The row stride of a product's sums `out` [rpad][ldo] in `red`: the
// columns made 4 mod 8, so that a lane's stores (8 columns by 4 row pairs)
// and the epilogue's float4 reads along a row fall in distinct banks.
__host__ __device__ inline int mma_ldo(int cols) { return cols % 8 ? cols : cols + 4; }
// Floats of `red` a product takes: its sums.
__host__ __device__ inline int mma_red_floats(int depth, int cols, int rpad) {
  return rpad * mma_ldo(cols);
}

// Two B fragments (k 0..7 and 8..15 of two n-tiles) from 16-byte rows of
// the exchange: lanes 0..15 give rows 0..15 of the first n-tile, lanes
// 16..31 those of the second.
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&b0)[2], unsigned (&b1)[2],
                                              const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1]) : "r"(smem_u32(p)));
}
// d += a b
__device__ __forceinline__ void mma_bf16_acc(float (&d)[4], const unsigned (&a)[4],
                                             const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's tiles of one pass: m-tile mt by the n-tiles nt0 .. nt0 + n - 1
// (warp tile i + tw * pass, n = 0: the warp rests), and its k-group j. The
// warp runs kMmaTiles tiles every block, those past n on its last n-tile's
// data (their sums are never read), so that no instruction of the loop is
// predicated. Each block's mmas add to `part` in the tensor cores, which
// joins `acc` by a rounded f32 add every kMmaFlush blocks of the warp's
// walk (an mma adds to its accumulator rounding toward zero, a bias that
// would grow with the depth: gemm_tc.cuh), counted across pieces.
struct MmaTiles {
  static_assert(kMmaTiles == 4, "the B fragments load as two ldmatrix.x4, a pair of tiles each");
  float acc[kMmaTiles][4], part[kMmaTiles][4];
  int mt, nt0, n, j, cnt;
  int a_off;        // this lane's A fragment in a block (elements), columns g and g + 8
  bool a_lo, a_hi;  // whether those columns lie in the slice
  int b_off[2];     // this lane's ldmatrix.x4 rows of tiles (0, 1) and (2, 3) (elements)

  __device__ __forceinline__ MmaTiles(const MmaSplit& s, int warp, int pass, int cols,
                                      int xld) {
    j = warp / s.tw;
    const int wt = warp % s.tw + s.tw * pass;
    mt = wt / s.nbs;
    nt0 = wt % s.nbs * s.nper;
    n = j < s.kw && wt < s.tws ? min(s.nper, s.nts - nt0) : 0;
    cnt = 0;
    const int lane = threadIdx.x % 32, c0 = mt * 16 + lane / 4;
    a_off = c0 * kMmaK + 4 * (lane % 4);
    a_lo = c0 < cols;
    a_hi = c0 + 8 < cols;
    const int last = max(n - 1, 0);
#pragma unroll
    for (int p = 0; p < 2; ++p)
      b_off[p] = (lane & 15) * xld + (nt0 + min(2 * p + (lane >> 4), last)) * 8;
#pragma unroll
    for (int x = 0; x < kMmaTiles; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[x][e] = part[x][e] = 0.f;
  }

  // The warp's first block at or after kb0.
  __device__ __forceinline__ int first(int kb0, int kw) const {
    return kb0 + ((j - kb0 % kw) % kw + kw) % kw;
  }

  // A block's fragments: the warp's m-tile of W (A) and its n-tiles of
  // the exchange (B).
  struct Frags {
    unsigned a[4];
    unsigned b[kMmaTiles][2];
  };

  // The fragments of W's block at w ([cols][16] in fragment order) and of
  // A's 16 rows at x (xld apart), both in shared memory.
  __device__ __forceinline__ void load(Frags& f, const bf16* w, const bf16* x) const {
    const uint2 lo = a_lo ? *reinterpret_cast<const uint2*>(w + a_off) : make_uint2(0u, 0u);
    const uint2 hi = a_hi ? *reinterpret_cast<const uint2*>(w + a_off + 8 * kMmaK)
                          : make_uint2(0u, 0u);
    f.a[0] = lo.x, f.a[1] = hi.x, f.a[2] = lo.y, f.a[3] = hi.y;
    ldsm_x4_trans(f.b[0], f.b[1], x + b_off[0]);
    ldsm_x4_trans(f.b[2], f.b[3], x + b_off[1]);
  }

  // One block's products, added to `part`; every kMmaFlush blocks, `part`
  // into `acc`.
  __device__ __forceinline__ void multiply(const Frags& f) {
#pragma unroll
    for (int x = 0; x < kMmaTiles; ++x) mma_bf16_acc(part[x], f.a, f.b[x]);
    if (++cnt == kMmaFlush) flush();
  }

  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int x = 0; x < kMmaTiles; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[x][e] += part[x][e];
        part[x][e] = 0.f;
      }
    cnt = 0;
  }

  // `count` of the warp's blocks, in order: the first's W at w and A at x
  // in shared memory, each next one wstep and xstep elements on. The next
  // block's fragments load while the mmas of one run.
  __device__ __forceinline__ void walk(int count, const bf16* w, int wstep, const bf16* x,
                                       int xstep) {
    if (n == 0 || count <= 0) return;
    Frags f0, f1;  // two by name, so that both stay in registers
    load(f0, w, x);
    for (;;) {
      if (--count > 0) load(f1, w += wstep, x += xstep);
      multiply(f0);
      if (count == 0) break;
      if (--count > 0) load(f0, w += wstep, x += xstep);
      multiply(f1);
      if (count == 0) break;
    }
  }

  // The pass's sums into out [rpad][ldo] at red, k-group by k-group: the
  // first stores its sums, each next one adds its own, after `sync`, the
  // barrier of the threads that run the product (each of which calls
  // this); the caller syncs again before `out` is read.
  template <class Sync>
  __device__ __forceinline__ void gather(const MmaSplit& s, int cols, int rpad, float* red,
                                         Sync sync) const {
    const int lane = threadIdx.x % 32, ldo = mma_ldo(cols);
    const int c = mt * 16 + lane / 4, row0 = nt0 * 8 + 2 * (lane % 4);
    for (int z = 0; z < s.kw; ++z) {
      if (z > 0) sync();
      if (j != z || n == 0) continue;
#pragma unroll
      for (int x = 0; x < kMmaTiles; ++x) {
        if (x >= n) continue;
        float* o = red + (size_t)(row0 + 8 * x) * ldo + c;
        if (z == 0) {
          if (c < cols) o[0] = acc[x][0], o[ldo] = acc[x][1];
          if (c + 8 < cols) o[8] = acc[x][2], o[ldo + 8] = acc[x][3];
        } else {
          if (c < cols) o[0] += acc[x][0], o[ldo] += acc[x][1];
          if (c + 8 < cols) o[8] += acc[x][2], o[ldo + 8] += acc[x][3];
        }
      }
    }
  }
};

// epi(cb, rb, acc) for each 4-column, 4-row item of the sums at out
// [rpad][mma_ldo(cols)], acc[c][i] the sum of column 4cb+c, row 4rb+i,
// for the ncols first columns.
template <class Epi>
__device__ __forceinline__ void mma_epilogue(const float* out, int cols, int ncols, int rpad,
                                             Epi epi) {
  const int cbs = ncols / 4, items = cbs * (rpad / 4), ldo = mma_ldo(cols);
  for (int o = threadIdx.x; o < items; o += kGridThreads) {
    const int cb = o % cbs, rb = o / cbs;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(out + (size_t)(4 * rb + i) * ldo + 4 * cb);
      acc[0][i] = v.x, acc[1][i] = v.y, acc[2][i] = v.z, acc[3][i] = v.w;
    }
    epi(cb, rb, acc);
  }
}

// One product's operands for Ring::mma_product: A, the exchange [depth16]
// [xld] bf16 in device memory; W's blocks below the resident depth at w in
// shared memory and the others at ws in the CTA's streamed region, both in
// fragment order, `cols` columns; ncols output columns.
struct MmaOperand {
  const bf16* a;
  const bf16* w;
  const bf16* ws;
  int depth, resident, cols, ncols;
};

// An mma product's walk on the ring: the exchange row, the padded and the
// resident depth, the rows of a piece past the resident ones (A and a
// streamed block each 16) and over them (A alone), the passes.
struct MmaWalk {
  int xld, d16, res, rows, rows_a, passes;
};

// One product's operands for Ring::product: A, the exchange buffer
// [depth][rpad] in device memory; W's rows d < resident at w [resident][ldw]
// in shared memory and the others at ws [depth - resident][ldws] in the
// CTA's streamed region; ncols output columns (a multiple of 4, <= ldw).
// ldws 0 is ring_ld(ldw), the LSTM scans' streamed rows. A product over a
// range of a slice's rows or columns (the GRU's grid, gru_grid.cuh) points
// w and ws at its first row and column, and streams rows of its own width
// ldws (a multiple of 16 bytes), so that it copies no column it does not
// read.
template <class W>
struct RingOperand {
  const float* a;
  const W* w;
  const W* ws;
  int depth, resident, ldw, ncols;
  int ldws = 0;
};

// Elements of a streamed row of the operand, in its region and in a stage.
template <class W>
__device__ __forceinline__ int stream_ld(const RingOperand<W>& op) {
  return op.ldws ? op.ldws : ring_ld<W>(op.ldw);
}

// A product's walk: slice_product's items (of R rows), slices and chunk;
// the rows of a piece past the resident rows (A and a streamed row each)
// and over them (A alone); the passes over the depth.
struct RingWalk {
  int items, slices, units, chunk, rows, rows_a, passes;
};

struct Ring {
  float* buf;                   // kRingStages x piece floats
  unsigned long long* full;     // [kRingStages]
  unsigned long long* empty;    // [kRingStages]
  int piece, rpad, stage_floats, red_floats;
  unsigned it;  // pieces through the ring so far; every thread keeps the count
  int ahead;    // the producer's: pieces of the next product whose weights are issued

  // Carves the ring at `at` (kRingStages * piece floats, then two barriers
  // a stage), and initialises the barriers; every thread of the CTA calls
  // it, after the prologue has written the streamed rows.
  __device__ __forceinline__ void start(float* at, const GridPlan& p) {
    buf = at;
    piece = p.piece;
    rpad = p.rpad;
    stage_floats = p.stage;
    red_floats = p.red;
    it = 0;
    ahead = 0;
    full = reinterpret_cast<unsigned long long*>(at + (size_t)kRingStages * p.piece);
    empty = full + kRingStages;
    fence_proxy_async_global();
    if (threadIdx.x == kGridThreads) {
      for (int i = 0; i < kRingStages; ++i) {
        mbar_init(full + i, 1);
        mbar_init(empty + i, kConsumerWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  template <int R = 4, class W>
  __device__ __forceinline__ RingWalk walk(const RingOperand<W>& op) const {
    RingWalk k;
    const int rbs = rpad / R;
    k.items = op.ncols / 4 * rbs;
    const int most = k.items >= kGridThreads ? 1 : min(kMaxSlices, kGridThreads / max(1, k.items));
    k.slices = max(1, min(min(most, op.depth / kMinSliceDepth),
                          red_floats / (16 * max(1, k.items))));
    k.units = k.items * k.slices;
    k.chunk = op.depth * rpad <= stage_floats ? op.depth : stage_floats / 2 / rpad;
    k.rows = piece * 4 / (rpad * 4 + stream_ld(op) * (int)sizeof(W));
    k.rows_a = piece / rpad;
    k.passes = max(1, div_up((op.ldws ? op.ldws : op.ldw) / 4 * rbs, kGridThreads));
    return k;
  }

  // The end of the piece that starts at row e0.
  __device__ __forceinline__ static int piece_end(int e0, int depth, int resident,
                                                  const RingWalk& k) {
    return e0 < resident ? min(resident, e0 + k.rows_a) : min(depth, e0 + k.rows);
  }

  // Calls f(e0, e1) for each piece [e0, e1) of the depth, pass by pass,
  // while it returns true.
  template <class F>
  __device__ __forceinline__ static void pieces(int depth, int resident, const RingWalk& k,
                                                F f) {
    for (int pass = 0; pass < k.passes; ++pass)
      for (int e0 = 0, e1; e0 < depth; e0 = e1) {
        e1 = piece_end(e0, depth, resident, k);
        if (!f(e0, e1)) return;
      }
  }

  __device__ __forceinline__ float* stage_at(unsigned idx) const {
    return buf + (size_t)(idx % kRingStages) * piece;
  }

  // The producer: waits until stage idx is free, arms its full barrier for
  // the piece's A and weight bytes, and copies the piece's streamed rows.
  template <class W>
  __device__ __forceinline__ void issue_weights(const RingOperand<W>& op, const RingWalk& k,
                                                unsigned idx, int e0, int e1) {
    const unsigned st = idx % kRingStages;
    mbar_wait(empty + st, ((idx / kRingStages) & 1) ^ 1);
    const int ldws = stream_ld(op), es = max(e0, op.resident);
    const unsigned wbytes = e1 > es ? (unsigned)((e1 - es) * ldws * sizeof(W)) : 0u;
    mbar_arm(full + st, (unsigned)((e1 - e0) * rpad * 4) + wbytes);
    if (wbytes)
      bulk_load(stage_at(idx) + k.rows * rpad, op.ws + (size_t)(es - op.resident) * ldws, wbytes,
                full + st);
  }

  // The producer: the piece's A rows.
  __device__ __forceinline__ void issue_a(const float* a, unsigned idx, int e0, int e1) const {
    bulk_load(stage_at(idx), a + (size_t)e0 * rpad, (unsigned)((e1 - e0) * rpad * 4),
              full + idx % kRingStages);
  }

  // The weights of the next product's first stages, issued before the
  // group barrier that publishes its A. Every thread calls it.
  template <int R = 4, class W>
  __device__ __forceinline__ void preload(const RingOperand<W>& op) {
    if (threadIdx.x != kGridThreads) return;
    fence_proxy_async_global();
    const RingWalk k = walk<R>(op);
    int i = 0;
    pieces(op.depth, op.resident, k, [&](int e0, int e1) {
      if (i == kRingStages) return false;
      issue_weights(op, k, it + i, e0, e1);
      ++i;
      return true;
    });
    ahead = i;
  }

  // out(col, row) = sum over d < depth of A[d][row] * W[d][col], as
  // slice_product computes it, and epi(cb, rb, acc) once per item. Every
  // thread of the CTA calls it. The consumers wait for their own cp.async
  // copies (cp_async_wait_all) before the epilogue.
  template <int R = 4, class W, class Epi>
  __device__ __forceinline__ void product(const RingOperand<W>& op, float* red, Epi epi) {
    const RingWalk k = walk<R>(op);
    const unsigned first = it;
    int n = 0;
    pieces(op.depth, op.resident, k, [&](int, int) { ++n; return true; });
    if (threadIdx.x == kGridThreads) {
      fence_proxy_async_global();  // the exchange that the barrier published
      int i = 0;
      pieces(op.depth, op.resident, k, [&](int e0, int e1) {
        if (i >= ahead) issue_weights(op, k, first + i, e0, e1);
        issue_a(op.a, first + i, e0, e1);
        ++i;
        return true;
      });
    } else if (threadIdx.x < kGridThreads) {
      consume<R>(op, k, first, red, epi);
    }
    it = first + n;
    ahead = 0;
  }

  template <int R = 4, class W, class Epi>
  __device__ __forceinline__ void consume(const RingOperand<W>& op, const RingWalk& k,
                                          unsigned idx, float* red, Epi epi) {
    constexpr int kQ = R / 4;  // float4 of A an item reads a depth row
    const int r4 = rpad / 4, cbs = op.ncols / 4, ldws = stream_ld(op);
    const int lane = threadIdx.x % 32;
    for (int pass = 0; pass < k.passes; ++pass) {
      const int unit = pass * kGridThreads + threadIdx.x;
      const bool live = unit < k.units;
      const int item = live ? unit % k.items : 0, s = live ? unit / k.items : 0;
      const int cb = live ? item % cbs : 0, rb = live ? item / cbs : 0;
      float acc[4][R] = {};
      // the thread's next row d of chunk [c0, c0 + chunk), carried from
      // piece to piece: rows c0 + s, c0 + s + slices, ... of each chunk in
      // turn. Where slices divide the chunk, those are the rows s, s +
      // slices, ... of the whole depth: one chunk.
      const int chunk = k.chunk % k.slices == 0 ? op.depth : k.chunk;
      int c0 = 0, d = s;
      for (int e0 = 0, e1; e0 < op.depth; e0 = e1, ++idx) {
        e1 = piece_end(e0, op.depth, op.resident, k);
        mbar_wait(full + idx % kRingStages, (idx / kRingStages) & 1);
        if (live) {
          const float* sp = stage_at(idx);
          if constexpr (R == 4) {  // the LSTM scans' loop
            auto fma_row = [&](float4 av, float4 wv) {
              const float ar[4] = {av.x, av.y, av.z, av.w};
              const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
              for (int c = 0; c < 4; ++c)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[c][i] = fmaf(ar[i], wc[c], acc[c][i]);
            };
            const float4* s4 = reinterpret_cast<const float4*>(sp) + rb;
            const int es = max(e0, op.resident);
            const W* sw = reinterpret_cast<const W*>(sp + k.rows * rpad) + 4 * cb;  // row es
            const W* wr = op.w + 4 * cb;
            for (;;) {  // the piece's part of each chunk it meets
              const int b = min(e1, c0 + chunk), dr = min(b, op.resident);
#pragma unroll 4
              for (; d < dr; d += k.slices)  // resident rows
                fma_row(s4[(d - e0) * r4], load4(wr + (size_t)d * op.ldw));
#pragma unroll 4
              for (; d < b; d += k.slices)  // streamed rows, from the stage
                fma_row(s4[(d - e0) * r4], load4(sw + (size_t)(d - es) * ldws));
              if (b < c0 + chunk) break;  // the piece ends inside the chunk
              c0 += chunk;                // the chunk ends: the next one's first row
              d = c0 + s;
              if (c0 >= e1) break;
            }
          } else {
            // A piece lies over resident rows or past them, never both: its
            // W rows at wp, row w0 first, wld apart. A depth row loads W,
            // then A a float4 at a time, each feeding 16 FMAs, so that few
            // loaded values are live beside the 4R sums.
            const float4* s4 = reinterpret_cast<const float4*>(sp) + rb * kQ;
            const bool held = e0 < op.resident;
            const W* wp = (held ? op.w : reinterpret_cast<const W*>(sp + k.rows * rpad)) + 4 * cb;
            const int wld = held ? op.ldw : ldws, w0 = held ? 0 : e0;
            for (;;) {  // the piece's part of each chunk it meets
              const int b = min(e1, c0 + chunk);
#pragma unroll 1
              for (; d < b; d += k.slices) {
                const float4 wv = load4(wp + (size_t)(d - w0) * wld);
                const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
                const float4* av = s4 + (d - e0) * r4;
#pragma unroll
                for (int q = 0; q < kQ; ++q) {
                  const float4 v = av[q];
                  const float ar[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                  for (int c = 0; c < 4; ++c)
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                      acc[c][4 * q + i] = fmaf(ar[i], wc[c], acc[c][4 * q + i]);
                }
              }
              if (b < c0 + chunk) break;
              c0 += chunk;
              d = c0 + s;
              if (c0 >= e1) break;
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + idx % kRingStages);
      }
      cp_async_wait_all();
      consumers_sync();
      if (k.slices > 1 && pass * kGridThreads < k.units) {  // one pass: units <= threads
#pragma unroll
        for (int q = 0; q < kQ; ++q) {  // rows 4q .. 4q + 3 of the items
          if (q > 0) consumers_sync();  // the last pass's reads of red
          if (live) {
            float* p = red + (size_t)s * 16 * k.items + item;
#pragma unroll
            for (int e = 0; e < 16; ++e) p[e * k.items] = acc[e / 4][4 * q + e % 4];
          }
          consumers_sync();
          for (int o = threadIdx.x; o < k.items * 16; o += kGridThreads) {
            float v = red[o];
            for (int z = 1; z < k.slices; ++z) v += red[(size_t)z * k.items * 16 + o];
            red[o] = v;
          }
          consumers_sync();
          if (live && s == 0) {
#pragma unroll
            for (int e = 0; e < 16; ++e) acc[e / 4][4 * q + e % 4] = red[e * k.items + item];
          }
        }
      }
      if (live && s == 0) epi(cb, rb, acc);
    }
  }

  // ---- the mma product (ScanPlan.mma): the same ring, pieces of whole
  // blocks; a stage holds A's rows [e0, e1) as bf16 and, past the resident
  // depth, the streamed blocks among them after `rows` rows of A.
  __device__ __forceinline__ MmaWalk mma_walk(const MmaOperand& op) const {
    MmaWalk k;
    k.xld = mma_xld(rpad);
    k.d16 = round16(op.depth);
    k.res = mma_resident(op.resident, op.depth);
    k.rows = kMmaK * (piece * 4 / (2 * kMmaK * (k.xld + op.cols)));
    k.rows_a = kMmaK * (piece * 4 / (2 * kMmaK * k.xld));
    k.passes = MmaSplit(op.depth, op.cols, rpad).passes;
    return k;
  }

  __device__ __forceinline__ static int mma_piece_end(int e0, const MmaWalk& k) {
    return e0 < k.res ? min(k.res, e0 + k.rows_a) : min(k.d16, e0 + k.rows);
  }

  template <class F>
  __device__ __forceinline__ static void mma_pieces(const MmaWalk& k, F f) {
    for (int pass = 0; pass < k.passes; ++pass)
      for (int e0 = 0, e1; e0 < k.d16; e0 = e1) {
        e1 = mma_piece_end(e0, k);
        if (!f(e0, e1)) return;
      }
  }

  __device__ __forceinline__ void mma_issue_weights(const MmaOperand& op, const MmaWalk& k,
                                                    unsigned idx, int e0, int e1) {
    const unsigned st = idx % kRingStages;
    mbar_wait(empty + st, ((idx / kRingStages) & 1) ^ 1);
    const int es = max(e0, k.res);
    const unsigned wbytes = e1 > es ? (unsigned)((e1 - es) * op.cols * sizeof(bf16)) : 0u;
    mbar_arm(full + st, (unsigned)((e1 - e0) * k.xld * sizeof(bf16)) + wbytes);
    if (wbytes)
      bulk_load(reinterpret_cast<bf16*>(stage_at(idx)) + (size_t)k.rows * k.xld,
                op.ws + (size_t)(es - k.res) * op.cols, wbytes, full + st);
  }

  __device__ __forceinline__ void mma_issue_a(const bf16* a, const MmaWalk& k, unsigned idx,
                                              int e0, int e1) const {
    bulk_load(stage_at(idx), a + (size_t)e0 * k.xld, (unsigned)((e1 - e0) * k.xld * sizeof(bf16)),
              full + idx % kRingStages);
  }

  // preload, for an mma product
  __device__ __forceinline__ void mma_preload(const MmaOperand& op) {
    if (threadIdx.x != kGridThreads) return;
    fence_proxy_async_global();
    const MmaWalk k = mma_walk(op);
    int i = 0;
    mma_pieces(k, [&](int e0, int e1) {
      if (i == kRingStages) return false;
      mma_issue_weights(op, k, it + i, e0, e1);
      ++i;
      return true;
    });
    ahead = i;
  }

  // out(col, row) = sum over d < depth of W[d][col] * A[d][row] in the
  // order of MmaSplit, and epi as mma_epilogue calls it. Every thread of the CTA calls it. The
  // consumers wait for their own cp.async copies (cp_async_wait_all)
  // before the epilogue.
  template <class Epi>
  __device__ __forceinline__ void mma_product(const MmaOperand& op, float* red, Epi epi) {
    const MmaWalk k = mma_walk(op);
    const unsigned first = it;
    int n = 0;
    mma_pieces(k, [&](int, int) { ++n; return true; });
    if (threadIdx.x == kGridThreads) {
      fence_proxy_async_global();  // the exchange that the barrier published
      int i = 0;
      mma_pieces(k, [&](int e0, int e1) {
        if (i >= ahead) mma_issue_weights(op, k, first + i, e0, e1);
        mma_issue_a(op.a, k, first + i, e0, e1);
        ++i;
        return true;
      });
    } else if (threadIdx.x < kGridThreads) {
      mma_consume(op, k, first, red, epi);
    }
    it = first + n;
    ahead = 0;
  }

  template <class Epi>
  __device__ __forceinline__ void mma_consume(const MmaOperand& op, const MmaWalk& k,
                                              unsigned idx, float* red, Epi epi) {
    const MmaSplit s(op.depth, op.cols, rpad);
    const int lane = threadIdx.x % 32;
    for (int pass = 0; pass < s.passes; ++pass) {
      MmaTiles m(s, threadIdx.x / 32, pass, op.cols, k.xld);
      for (int e0 = 0, e1; e0 < k.d16; e0 = e1, ++idx) {
        e1 = mma_piece_end(e0, k);
        mbar_wait(full + idx % kRingStages, (idx / kRingStages) & 1);
        {
          // a piece lies over resident blocks or past them, never both
          const bf16* sp = reinterpret_cast<const bf16*>(stage_at(idx));
          const int kb = m.first(e0 / kMmaK, s.kw), d = kb * kMmaK;
          const bf16* w = e0 < k.res ? op.w + (size_t)d * op.cols
                                     : sp + (size_t)k.rows * k.xld + (size_t)(d - e0) * op.cols;
          m.walk(div_up(e1 / kMmaK - kb, s.kw), w, s.kw * kMmaK * op.cols,
                 sp + (size_t)(d - e0) * k.xld, s.kw * kMmaK * k.xld);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + idx % kRingStages);
      }
      m.flush();
      m.gather(s, op.cols, rpad, red, [] { consumers_sync(); });
    }
    cp_async_wait_all();
    consumers_sync();
    mma_epilogue(red, op.cols, op.ncols, rpad, epi);
  }
};

// Floats of shared memory a ring takes: its stages and its barriers.
__host__ __device__ inline size_t ring_floats(const GridPlan& p) {
  return (size_t)kRingStages * (p.piece + 4);
}

// Whether a plan's ring is one the kernels take: stages of whole 16-byte
// units.
inline bool ring_ok(const GridPlan& p) { return p.piece > 0 && p.piece % 4 == 0; }
// Whether a stage holds one depth row of a product: its rpad floats of A
// and a streamed row of a slice of width ldw.
template <class W>
inline bool ring_holds(const GridPlan& p, int ldw) {
  return (size_t)p.piece * 4 >= (size_t)p.rpad * 4 + (size_t)ring_ld<W>(ldw) * sizeof(W);
}

// Whether an mma plan's ring stage holds a block of a product: its 16 rows
// of A and a streamed block of `cols` columns.
inline bool mma_ring_holds(const GridPlan& p, int cols) {
  return (size_t)p.piece * 4 >= (size_t)2 * kMmaK * (mma_xld(p.rpad) + cols);
}
// Whether an mma plan's layout is one the kernels take: rows padded to 8,
// `red` holding each product's sums, resident depths in whole blocks.
inline bool mma_plan_ok(const GridPlan& p) {
  return p.rpad >= 8 && p.rpad % 8 == 0;
}
inline bool mma_resident_ok(int resident, int depth) {
  return resident >= 0 && resident <= depth && (resident == depth || resident % kMmaK == 0);
}

// The rank columns of CTA q of a wavefront-stack layer on c CTAs, with
// ranks r and rx (rx = 0: layer 0, no x side), as ops/cuda_stack.py::
// _rank_split lays them out. Layer 0, and a layer on one CTA, split r (and
// rx) over all its CTAs. A layer l > 0 on c >= 2 CTAs gives its first `ua`
// CTAs (in proportion r : rx) the r columns of U (V forward, V^T in the
// BPTT) and the others the rx columns of Ux (Vx^T), so that each CTA runs
// one product where it would run two. kr and kxr: the padded widths of the
// CTA's slices of each kind (0: none); `packed`: whether one CTA holds both.
struct RankSlices {
  int ua, kwp, kxwp, k0, kw, kx0, kxw, kr, kxr;
  bool packed;
  __host__ __device__ RankSlices(int q, int c, int r, int rx) {
    packed = rx == 0 || c == 1;
    const int share = (c * r + (r + rx) / 2) / (r + rx);
    ua = packed ? c : (share < 1 ? 1 : share > c - 1 ? c - 1 : share);
    const int cx = packed ? 1 : c - ua, qx = packed ? 0 : q - ua;
    kwp = round4(div_up(r, ua));
    kxwp = rx ? round4(div_up(rx, cx)) : 0;
    const bool u_side = q < ua, x_side = rx > 0 && (packed || q >= ua);
    k0 = u_side ? split_at(q, r, ua) : 0;
    kw = u_side ? split_at(q + 1, r, ua) - k0 : 0;
    kx0 = x_side ? split_at(qx, rx, cx) : 0;
    kxw = x_side ? split_at(qx + 1, rx, cx) - kx0 : 0;
    kr = u_side ? kwp : 0;
    kxr = x_side ? kxwp : 0;
  }
};

__device__ __forceinline__ float gate_sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// Epilogue of the projection GEMM that yields gi (the second one, or the only
// one for a dense x side): adds the x-side elementwise term and the bias to
// column j = g*h + jj: (jj < f ? x[i, jj] : 0) * xdvec[j] + bias[j]. The x
// term reads x unrounded in every variant.
struct GiEpilogue {
  float* gi;
  const float* x;
  const float* xdvec;
  const float* bias;
  int f, h;
  __device__ __forceinline__ void operator()(int i, int j, float v) const {
    const int jj = j % h;
    const float xv = jj < f ? x[(size_t)i * f + jj] : 0.f;
    gi[(size_t)i * 4 * h + j] = v + xv * xdvec[j] + bias[j];
  }
};

// Epilogue of the recompute policy's last pre-pass GEMM, in place on the
// gi that the GEMM before it wrote: pre = gi + v + hprev * dvec (hprev row
// i: h0 for i < batch, then ys[i - batch]), then the gate's nonlinearity,
// tanh for the g block and the sigmoid for the others
// (pallas_scan.py::_bwd_kernel's recompute).
struct GatesEpilogue {
  float* gates;
  const float* h0;
  const float* ys;
  const float* dvec;
  int batch, h;
  __device__ __forceinline__ void operator()(int i, int j, float v) const {
    const int jj = j % h;
    const float hp = i < batch ? h0[(size_t)i * h + jj] : ys[(size_t)(i - batch) * h + jj];
    float* at = gates + (size_t)i * 4 * h + j;
    const float pre = *at + v + hp * dvec[j];
    *at = j / h == 2 ? tanhf(pre) : gate_sigmoid(pre);
  }
};

// dst[e] = src[e] widened, for e < n: a bf16 residual read back as f32.
__global__ void __launch_bounds__(256) widen_kernel(const bf16* __restrict__ src,
                                                    float* __restrict__ dst, size_t n) {
  for (size_t e = (size_t)blockIdx.x * 256 + threadIdx.x; e < n; e += (size_t)gridDim.x * 256)
    dst[e] = __bfloat162float(src[e]);
}

inline cudaError_t widen(const void* src, float* dst, size_t n, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(n < 264 * 256 ? (n + 255) / 256 : 264 * 4);
  widen_kernel<<<blocks, 256, 0, stream>>>(static_cast<const bf16*>(src), dst, n);
  return cudaGetLastError();
}

// Launches `kernel` cooperatively on plan.groups * plan.ctas CTAs of
// `threads` threads with plan.smem bytes of shared memory, after zeroing
// the barrier words (`sync_words` of them; 0: one per group); `args` as
// cudaLaunchCooperativeKernel takes them. A grid that cannot be
// co-resident is refused with cudaErrorCooperativeLaunchTooLarge, never run.
template <class Kernel>
cudaError_t launch_grid(Kernel kernel, const GridPlan& plan, unsigned* sync, void** args,
                        cudaStream_t stream, int sync_words = 0, int threads = kGridThreads) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         plan.smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, plan.smem);
  if (err != cudaSuccess) return err;
  const int grid = plan.groups * plan.ctas;
  if (grid > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(sync, 0, sizeof(unsigned) * (sync_words ? sync_words : plan.groups),
                        stream);
  if (err != cudaSuccess) return err;
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                     dim3(threads), args, static_cast<size_t>(plan.smem), stream);
}

}  // namespace vmlmf
