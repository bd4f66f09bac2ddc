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
// slices in shared memory as bf16 and widen them for f32 FMAs: a bf16
// product summed in f32 is exactly the f32 FMA of the two bf16-rounded
// operands. The exchange buffers stay f32, but the CTA that writes an
// exchanged value rounds it to bf16 first, since a product is its only
// reader; the carry, the diagonal terms and the gates stay f32.

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
struct GridPlan {
  int groups, ctas, rpad, stage, red, smem;
  int res_a = 0, res_b = 0;
  int piece = 0;
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
// The same from a streamed weight row in device memory, which the CTA
// wrote itself in its prologue: a plain load (coherent within the CTA
// after a __syncthreads), never the non-coherent path.
__device__ __forceinline__ float4 load4_global(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4_global(const bf16* p) {
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
// store. The GRU's streamed rows keep the slice's stride (ldws = ldw); the
// LSTM's ring pads it to 16 bytes (ring_ld).
template <class W>
__device__ __forceinline__ W& slice_elem(W* w, W* ws, int resident, int ldw, int ldws, int d,
                                         int at) {
  return d < resident ? w[(size_t)d * ldw + at] : ws[(size_t)(d - resident) * ldws + at];
}
template <class W>
__device__ __forceinline__ W& slice_elem(W* w, W* ws, int resident, int ldw, int d, int at) {
  return slice_elem(w, ws, resident, ldw, ldw, d, at);
}

// out(col, row) = sum over d < depth of A[d][row] * W[d][col], for col <
// ncols (a multiple of 4) and row < rpad. A is a global exchange buffer
// [depth][rpad], copied into shared memory with 16-byte cp.async.cg: whole
// when it fits in `stage`, else in chunks of stage / 2 floats, the next
// chunk copying into one half while the CTA multiplies the other. W is
// this CTA's weight slice, [depth][ldw], f32 or bf16 (ldw a multiple of
// 4). With Streamed (the GRU's grid; the LSTM scans' streamed plans run
// Ring::product below), rows d < `resident` lie in shared memory at `w` and
// the rest in device memory at `ws` [depth - resident][ldw]; each thread
// walks its rows in one order wherever they lie, so the sums do not depend
// on `resident`. Without it (a plan that streams nothing) every row is in
// shared memory and `ws`, `resident` are unused: the kernels are built for
// both, so a resident plan runs the code it ran before any row could be
// streamed. With Batch > 1 a thread issues the loads of Batch streamed rows
// before their FMAs (more loads in flight; the same sums in the same
// order). An item is 4 columns x 4 rows (16 sums in registers,
// float4 loads of A and four-element loads of W, widened). With
// fewer items than threads, each item's depth is cut into `slices`
// interleaved parts; their partial sums meet in `red` and one thread per
// output adds them in slice order: deterministic, no atomics. Calls
// epi(cb, rb, acc) once per item, acc[c][r] the sum of column 4cb+c, row
// 4rb+r. The partials lie [slice][16][items], so that neighbouring threads
// (neighbouring items) touch neighbouring banks. Every thread of the CTA
// must call it.
template <bool Streamed, int Batch = 1, class W, class Epi>
__device__ __forceinline__ void slice_product(const float* a, int depth, int rpad,
                                              const W* w, const W* ws, int resident, int ldw,
                                              int ncols, float* stage, int stage_floats,
                                              float* red, int red_floats, Epi epi) {
  const int cbs = ncols / 4, rbs = rpad / 4;
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
    float4* dst = reinterpret_cast<float4*>(stage) + (c & 1) * (chunk * rbs);
    const float4* src = a4 + (size_t)c * chunk * rbs;
    const int n4 = min(chunk, depth - c * chunk) * rbs;
    for (int i = threadIdx.x; i < n4; i += kGridThreads) cp_async16_cg(dst + i, src + i);
    cp_async_commit();
  };

  for (int base = 0; base < units; base += kGridThreads) {
    const int unit = base + threadIdx.x;
    const bool live = unit < units;
    const int item = unit % items, s = unit / items;
    const int cb = item % cbs, rb = item / cbs;
    float acc[4][4] = {};
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
        const float4* s4 = reinterpret_cast<const float4*>(stage) + (c & 1) * (chunk * rbs);
        const W* wd = w + (size_t)d0 * ldw + 4 * cb;
        if constexpr (!Streamed) {
#pragma unroll 4
          for (int d = s; d < dn; d += slices) {
            const float4 av = s4[d * rbs + rb];
            const float4 wv = load4(wd + (size_t)d * ldw);
            const float ar[4] = {av.x, av.y, av.z, av.w};
            const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[k][i] = fmaf(ar[i], wc[k], acc[k][i]);
          }
        } else {
          auto fma_row = [&](float4 av, float4 wv) {
            const float ar[4] = {av.x, av.y, av.z, av.w};
            const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[k][i] = fmaf(ar[i], wc[k], acc[k][i]);
          };
          const int dr = min(dn, max(0, resident - d0));  // the chunk's rows in shared memory
          const W* sd = ws + 4 * cb;
          int d = s;
#pragma unroll 4
          for (; d < dr; d += slices) fma_row(s4[d * rbs + rb], load4(wd + (size_t)d * ldw));
          if constexpr (Batch > 1) {
            for (; d + (Batch - 1) * slices < dn; d += Batch * slices) {
              float4 wv[Batch];
#pragma unroll
              for (int k = 0; k < Batch; ++k)
                wv[k] = load4_global(sd + (size_t)(d0 + d + k * slices - resident) * ldw);
#pragma unroll
              for (int k = 0; k < Batch; ++k) fma_row(s4[(d + k * slices) * rbs + rb], wv[k]);
            }
          }
#pragma unroll 4
          for (; d < dn; d += slices)  // the streamed rows d0 + d >= resident
            fma_row(s4[d * rbs + rb], load4_global(sd + (size_t)(d0 + d - resident) * ldw));
        }
      }
      __syncthreads();
    }
    if (slices > 1) {  // one pass: units <= threads
      if (live) {
        float* p = red + (size_t)s * 16 * items + item;
#pragma unroll
        for (int e = 0; e < 16; ++e) p[e * items] = acc[e / 4][e % 4];
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
        for (int e = 0; e < 16; ++e) acc[e / 4][e % 4] = red[e * items + item];
      }
    }
    if (live && s == 0) epi(cb, rb, acc);
  }
}

// slice_product of a slice held whole in shared memory (the stack kernels).
template <class W, class Epi>
__device__ __forceinline__ void slice_product(const float* a, int depth, int rpad,
                                              const W* w, int ldw, int ncols,
                                              float* stage, int stage_floats, float* red,
                                              int red_floats, Epi epi) {
  slice_product<false>(a, depth, rpad, w, static_cast<const W*>(nullptr), depth, ldw, ncols,
                       stage, stage_floats, red, red_floats, epi);
}

// ---------------------------------------------------------------------------
// The ring of the LSTM scans' streamed plans (lstm_scan_xin_fwd.cu,
// lstm_scan_xin_bwd.cu where ScanPlan.ring > 0).
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
// rows. In each chunk a piece meets, the thread starts at its first row
// d >= e0 with d - d0 = s (mod slices). So where the CTA count is the
// parent's, the bits are.
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

// One product's operands for Ring::product: A, the exchange buffer
// [depth][rpad] in device memory; W's rows d < resident at w [resident][ldw]
// in shared memory and the others at ws [depth - resident][ldws] in the
// CTA's streamed region; ncols output columns (a multiple of 4, <= ldw).
template <class W>
struct RingOperand {
  const float* a;
  const W* w;
  const W* ws;
  int depth, resident, ldw, ncols;
};

// A product's walk: slice_product's items, slices and chunk; the rows of a
// piece past the resident rows (A and a streamed row each) and over them
// (A alone); the passes over the depth.
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

  template <class W>
  __device__ __forceinline__ RingWalk walk(const RingOperand<W>& op) const {
    RingWalk k;
    const int rbs = rpad / 4;
    k.items = op.ncols / 4 * rbs;
    const int most = k.items >= kGridThreads ? 1 : min(kMaxSlices, kGridThreads / max(1, k.items));
    k.slices = max(1, min(min(most, op.depth / kMinSliceDepth),
                          red_floats / (16 * max(1, k.items))));
    k.units = k.items * k.slices;
    k.chunk = op.depth * rpad <= stage_floats ? op.depth : stage_floats / 2 / rpad;
    k.rows = piece * 4 / (rpad * 4 + ring_ld<W>(op.ldw) * (int)sizeof(W));
    k.rows_a = piece / rpad;
    k.passes = max(1, div_up(op.ldw / 4 * rbs, kGridThreads));
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
    const int ldws = ring_ld<W>(op.ldw), es = max(e0, op.resident);
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
  template <class W>
  __device__ __forceinline__ void preload(const RingOperand<W>& op) {
    if (threadIdx.x != kGridThreads) return;
    fence_proxy_async_global();
    const RingWalk k = walk(op);
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
  template <class W, class Epi>
  __device__ __forceinline__ void product(const RingOperand<W>& op, float* red, Epi epi) {
    const RingWalk k = walk(op);
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
      consume(op, k, first, red, epi);
    }
    it = first + n;
    ahead = 0;
  }

  template <class W, class Epi>
  __device__ __forceinline__ void consume(const RingOperand<W>& op, const RingWalk& k,
                                          unsigned idx, float* red, Epi epi) {
    const int rbs = rpad / 4, cbs = op.ncols / 4, ldws = ring_ld<W>(op.ldw);
    const int lane = threadIdx.x % 32;
    for (int pass = 0; pass < k.passes; ++pass) {
      const int unit = pass * kGridThreads + threadIdx.x;
      const bool live = unit < k.units;
      const int item = live ? unit % k.items : 0, s = live ? unit / k.items : 0;
      const int cb = live ? item % cbs : 0, rb = live ? item / cbs : 0;
      float acc[4][4] = {};
      auto fma_row = [&](float4 av, float4 wv) {
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[c][i] = fmaf(ar[i], wc[c], acc[c][i]);
      };
      for (int e0 = 0, e1; e0 < op.depth; e0 = e1, ++idx) {
        e1 = piece_end(e0, op.depth, op.resident, k);
        mbar_wait(full + idx % kRingStages, (idx / kRingStages) & 1);
        if (live) {
          const float* sp = stage_at(idx);
          const float4* s4 = reinterpret_cast<const float4*>(sp) + rb;
          const int es = max(e0, op.resident);
          const W* sw = reinterpret_cast<const W*>(sp + k.rows * rpad) + 4 * cb;  // row es
          const W* wr = op.w + 4 * cb;
          // the piece's part of each chunk [c0, c0 + chunk) it meets
          for (int c0 = e0 - e0 % k.chunk; c0 < e1; c0 += k.chunk) {
            const int a = max(e0, c0), b = min(e1, c0 + k.chunk), dr = min(b, op.resident);
            int d = a + (s - (a - c0) % k.slices + k.slices) % k.slices;
#pragma unroll 4
            for (; d < dr; d += k.slices)  // resident rows
              fma_row(s4[(d - e0) * rbs], load4(wr + (size_t)d * op.ldw));
#pragma unroll 4
            for (; d < b; d += k.slices)  // streamed rows, from the stage
              fma_row(s4[(d - e0) * rbs], load4(sw + (size_t)(d - es) * ldws));
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + idx % kRingStages);
      }
      cp_async_wait_all();
      consumers_sync();
      if (k.slices > 1 && pass * kGridThreads < k.units) {  // one pass: units <= threads
        if (live) {
          float* p = red + (size_t)s * 16 * k.items + item;
#pragma unroll
          for (int e = 0; e < 16; ++e) p[e * k.items] = acc[e / 4][e % 4];
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
          for (int e = 0; e < 16; ++e) acc[e / 4][e % 4] = red[e * k.items + item];
        }
      }
      if (live && s == 0) epi(cb, rb, acc);
    }
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
