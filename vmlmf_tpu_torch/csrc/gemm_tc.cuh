// Tensor-core GEMMs of the scan kernels' time-parallel products, for
// sm_90a.
//
//   c(i, j) = epilogue(i, j, sum_k A(i, k) * B(k, j))
//
// Replaces, in lstm_scan_xin_fwd.cu, lstm_scan_xin_bwd.cu and
// lstm_stack_bwd.cu (the wavefront stack's weight gradients), the CUDA-core
// tile of gemm_tile.cuh, and in gru_scan_xin_bwd.cu that tile's large
// products: the GRU BPTT's recurrent weight gradients and its recompute
// pre-pass where wg_route sends them to the Hopper tile (the GRU's other
// products stay on gemm_tile.cuh). It takes the same operand views
// (RowMajor, Transposed, PrevRows, PrevRowsT; the GRU's composites stage
// through a gated wg::Source, the stack's masked layer input is written
// once by Staging::masked) and the same epilogue functors (Store,
// GiEpilogue, GatesEpilogue, DxEpilogue, Partial), and its products are
// those of the scans' x-side projection, the recompute pre-pass and the
// BPTTs' weight and x-side gradients: products with thousands of output
// tiles (at a dense h=1500) or a few tiles and a long k (the HAR layer's
// dU [180, 6] over k = 1944).
//
// What bounds these products on an H100 is arithmetic: each operand element
// is used by a whole tile row or column, and f32 on the CUDA cores peaks at
// 67 TFLOP/s. So they run on the tensor cores:
// * f32 as error-compensated 3xTF32: each operand value a splits into hi =
//   tf32(a) and lo = tf32(a - hi) (round to nearest), and a product is
//   lo*hi + hi*lo + hi*hi, each a TF32 product with f32 sums, the small
//   terms first. The lost lo*lo term and lo's rounding are below 2^-21 of a
//   term, so a product keeps about f32's precision at three TF32 passes.
//   The tensor core adds to its accumulator rounding toward zero, a bias
//   that would grow with k (about 1e-5 of the output at k = 1500, measured),
//   so sums are taken in two levels: a chunk of k from zero on the tensor
//   core, then an f32 add, rounded to nearest, into the running sum.
// * bf16 (the bf16 variants, whose products take bf16-rounded operands and
//   sum in f32): bf16 products with f32 sums. Each operand is rounded to
//   nearest even, as gemm_tile.cuh's round_bf16 rounds; only the
//   order of the sums differs.
// Two tiles, chosen by the shape alone (tc_plan; ops/cuda_scan.py mirrors
// it): the Hopper tile (`wg`, below) for products of kWgMinWork
// multiply-adds or more with m, n and k all kWgMinDim or more, wgmma fed by
// TMA from operands staged once a call (bf16 copies, or 3xTF32's hi and
// lo); and, for the others (the HAR layer's, those at B=1), the Ampere
// tile: mma.sync fed by cp.async straight from the views, which stages
// nothing.
// The Ampere tile: a ring of kStages k-slices of A and B in shared memory,
// filled with cp.async while the warps work on the slice before. Each
// operand is staged along its view's contiguous index, so neighbouring
// threads copy neighbouring addresses: runs of four elements, one 16-byte
// copy where the run is 16-byte aligned (a partial run at an edge copies
// only its valid bytes and zero-fills the rest), else four 4-byte copies
// (rows of odd length, as at h=650). A run never straddles the seam of a
// PrevRows view, which lies between rows. Element (mn, kk) of a stage sits
// at mn * ld + kk along k or kk * ld + mn along m/n, with ld padded so that
// the fragment loads of a warp fall in distinct banks (ld = 4 or 8 mod 32,
// by layout and precision). m16n8k8 TF32 and m16n8k16 bf16 mmas; the bf16
// operands rounded as a fragment is read (3xTF32: each k8 step's three
// mmas, from zero, join the running sum; bf16: every fourth stage's).
// A CTA of 8 warps computes 128x128 outputs (warps of 64x32), or one of 4
// warps 64x64 (warps of 32x32), whichever gives the busiest SM the least
// work (mma_plan): the large tile at the large products unless its last
// wave runs mostly empty. A small-tile product with fewer than
// kSplitTarget tiles cuts k into slices of whole kK steps until tiles
// times slices come near kSplitTarget CTAs, bounded by the scratch it is
// given.
// Either tile's split k writes a partial sum a slice and a second kernel
// adds the slices in a fixed order through the epilogue (ops/cuda_scan.py::
// tc_splitk_floats mirrors the slices). Every sum is taken in a fixed
// order, with no atomics, so two equal calls give equal bits. The Ampere
// tile's epilogue reads the tile back from shared memory along rows, so
// its stores are coalesced. Every edge is masked: no dimension needs to be
// a multiple of a tile.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "gemm_tile.cuh"

namespace vmlmf {
namespace tc {

constexpr int kK = 32;        // k-slice of a stage
constexpr int kStages = 3;    // stages of the ring
constexpr int kWave = 132;    // the H100's SMs

// Output tile kBM x kBN on warps of kWM x kWN.
template <int BM, int BN, int WM, int WN>
struct Shape {
  static constexpr int kBM = BM, kBN = BN, kWM = WM, kWN = WN;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = 32 * (BM / WM) * (BN / WN);
  static constexpr int kMt = WM / 16, kNt = WN / 8;  // mma tiles of a warp
};
using BigTile = Shape<128, 128, 64, 32>;
using SmallTile = Shape<64, 64, 32, 32>;

// The address of element (i, j) of a view.
__device__ __forceinline__ const float* elem(const RowMajor& v, int i, int j) {
  return v.p + (size_t)i * v.ld + j;
}
__device__ __forceinline__ const float* elem(const Transposed& v, int i, int j) {
  return v.p + (size_t)j * v.ld + i;
}
__device__ __forceinline__ const float* elem(const PrevRows& v, int i, int j) {
  return i < v.nfirst ? v.first + (size_t)i * v.ld + j
                      : v.rest + (size_t)(i - v.nfirst) * v.ld + j;
}
__device__ __forceinline__ const float* elem(const PrevRowsT& v, int i, int j) {
  return j < v.nfirst ? v.first + (size_t)j * v.ld + i
                      : v.rest + (size_t)(j - v.nfirst) * v.ld + i;
}

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// `bytes` (0..16) of a 16-byte aligned run, the rest of the 16 zero-filled.
__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One operand's stage: MN rows or columns of the tile by kK, stored along
// the view's contiguous index (KContig: along k).
template <bool KContig, int MN, bool Bf16>
struct Operand {
  static constexpr int kLd = KContig ? kK + (Bf16 ? 8 : 4) : MN + (Bf16 ? 4 : 8);
  static constexpr int kFloats = (KContig ? MN : kK) * kLd;

  __device__ __forceinline__ static float at(const float* s, int mn, int kk) {
    return KContig ? s[mn * kLd + kk] : s[kk * kLd + mn];
  }
  // elements (mn, kk) and (mn, kk + 1), kk even
  __device__ __forceinline__ static float2 pair(const float* s, int mn, int kk) {
    if constexpr (KContig) return *reinterpret_cast<const float2*>(s + mn * kLd + kk);
    return make_float2(s[kk * kLd + mn], s[(kk + 1) * kLd + mn]);
  }

  // The slice [mn0, mn0 + MN) x [k0, k0 + kK) of the operand into stage s,
  // zeros past mn_end and ke; ptr(mn, kk) is the address of an element.
  template <int Threads, class Ptr>
  __device__ __forceinline__ static void load(float* s, const Ptr& ptr, int mn0, int mn_end,
                                              int k0, int ke) {
    constexpr int kRuns = KContig ? MN * (kK / 4) : kK * (MN / 4);
#pragma unroll
    for (int c = threadIdx.x; c < kRuns; c += Threads) {
      int mn, kk, valid;
      if constexpr (KContig) {
        mn = c / (kK / 4), kk = (c % (kK / 4)) * 4;
        valid = mn0 + mn < mn_end ? min(4, max(0, ke - (k0 + kk))) : 0;
      } else {
        kk = c / (MN / 4), mn = (c % (MN / 4)) * 4;
        valid = k0 + kk < ke ? min(4, max(0, mn_end - (mn0 + mn))) : 0;
      }
      float* dst = KContig ? s + mn * kLd + kk : s + kk * kLd + mn;
      if (valid == 0) {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        continue;
      }
      const float* src = ptr(mn0 + mn, k0 + kk);
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        cp16(dst, src, 4 * valid);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < valid)
          cp4(dst + e, src + e);
        else
          dst[e] = 0.f;
      }
    }
  }
};

__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

__device__ __forceinline__ unsigned bf16_pair(float2 v) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(v.x, v.y);  // .x in the low half
  return *reinterpret_cast<const unsigned*>(&p);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b, from a zero accumulator
__device__ __forceinline__ void mma_tf32_new(float (&d)[4], const unsigned (&a)[4],
                                             const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One stage's kK steps of a warp's tile: lane (g, t) = (lane / 4, lane % 4)
// holds the fragments of the PTX ISA's m16n8k8 (tf32) and m16n8k16 (bf16)
// layouts, rows wm0 + 16 mt + g (+8) of A and columns wn0 + 8 nt + g of B.
// The stage holds kvalid rows of k before its zeros: the steps past them
// would add only zeros (a product of k = 8, rx at the HAR layer, runs one).
template <class S, class OpA, class OpB>
__device__ __forceinline__ void stage_3xtf32(const float* as, const float* bs, int wm0, int wn0,
                                             int g, int t, int kvalid,
                                             float (&acc)[S::kMt][S::kNt][4]) {
#pragma unroll
  for (int kk = 0; kk < kK; kk += 8) {
    if (kk >= kvalid) break;
    unsigned ahi[S::kMt][4], alo[S::kMt][4], bhi[S::kNt][2], blo[S::kNt][2];
#pragma unroll
    for (int mt = 0; mt < S::kMt; ++mt) {
      const int r = wm0 + 16 * mt + g;
      split_tf32(OpA::at(as, r, kk + t), ahi[mt][0], alo[mt][0]);
      split_tf32(OpA::at(as, r + 8, kk + t), ahi[mt][1], alo[mt][1]);
      split_tf32(OpA::at(as, r, kk + t + 4), ahi[mt][2], alo[mt][2]);
      split_tf32(OpA::at(as, r + 8, kk + t + 4), ahi[mt][3], alo[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < S::kNt; ++nt) {
      const int c = wn0 + 8 * nt + g;
      split_tf32(OpB::at(bs, c, kk + t), bhi[nt][0], blo[nt][0]);
      split_tf32(OpB::at(bs, c, kk + t + 4), bhi[nt][1], blo[nt][1]);
    }
    // three passes over the warp's tiles, so that neighbouring mmas are
    // independent (an mma waiting on the one before stalls the warp); the
    // step's sum starts from zero and joins acc by an f32 add
    float d[S::kMt][S::kNt][4];
#pragma unroll
    for (int mt = 0; mt < S::kMt; ++mt)
#pragma unroll
      for (int nt = 0; nt < S::kNt; ++nt) mma_tf32_new(d[mt][nt], alo[mt], bhi[nt]);
#pragma unroll
    for (int mt = 0; mt < S::kMt; ++mt)
#pragma unroll
      for (int nt = 0; nt < S::kNt; ++nt) mma_tf32(d[mt][nt], ahi[mt], blo[nt]);
#pragma unroll
    for (int mt = 0; mt < S::kMt; ++mt)
#pragma unroll
      for (int nt = 0; nt < S::kNt; ++nt) {
        mma_tf32(d[mt][nt], ahi[mt], bhi[nt]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += d[mt][nt][e];
      }
  }
}

template <class S, class OpA, class OpB>
__device__ __forceinline__ void stage_bf16(const float* as, const float* bs, int wm0, int wn0,
                                           int g, int t, int kvalid,
                                           float (&acc)[S::kMt][S::kNt][4]) {
#pragma unroll
  for (int kk = 0; kk < kK; kk += 16) {
    if (kk >= kvalid) break;
    unsigned af[S::kMt][4], bf[S::kNt][2];
#pragma unroll
    for (int mt = 0; mt < S::kMt; ++mt) {
      const int r = wm0 + 16 * mt + g;
      af[mt][0] = bf16_pair(OpA::pair(as, r, kk + 2 * t));
      af[mt][1] = bf16_pair(OpA::pair(as, r + 8, kk + 2 * t));
      af[mt][2] = bf16_pair(OpA::pair(as, r, kk + 2 * t + 8));
      af[mt][3] = bf16_pair(OpA::pair(as, r + 8, kk + 2 * t + 8));
    }
#pragma unroll
    for (int nt = 0; nt < S::kNt; ++nt) {
      const int c = wn0 + 8 * nt + g;
      bf[nt][0] = bf16_pair(OpB::pair(bs, c, kk + 2 * t));
      bf[nt][1] = bf16_pair(OpB::pair(bs, c, kk + 2 * t + 8));
    }
#pragma unroll
    for (int mt = 0; mt < S::kMt; ++mt)
#pragma unroll
      for (int nt = 0; nt < S::kNt; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
  }
}

template <class S, bool Bf16, class A, class B>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) * kStages *
         (Operand<A::kContigJ, S::kBM, Bf16>::kFloats + Operand<!B::kContigJ, S::kBN, Bf16>::kFloats);
}

// Output tile (blockIdx.y, blockIdx.x) over the k slice [z * kslice, (z + 1)
// * kslice) of z = blockIdx.z (kslice = k: all of k), through epi.
template <class S, bool Bf16, class A, class B, class Epi>
__global__ void __launch_bounds__(S::kThreads)
tc_gemm_kernel(A a, B b, Epi epi, int m, int n, int k, int kslice) {
  using OpA = Operand<A::kContigJ, S::kBM, Bf16>;
  using OpB = Operand<!B::kContigJ, S::kBN, Bf16>;
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;
  float* sb = smem + kStages * OpA::kFloats;
  const int kb = blockIdx.z * kslice, ke = min(k, kb + kslice);
  const int row0 = blockIdx.y * S::kBM, col0 = blockIdx.x * S::kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wm0 = (warp / S::kWarpsN) * S::kWM, wn0 = (warp % S::kWarpsN) * S::kWN;
  const auto pa = [&](int i, int kk) { return elem(a, i, kk); };
  const auto pb = [&](int j, int kk) { return elem(b, kk, j); };
  const int nk = ke > kb ? (ke - kb + kK - 1) / kK : 0;
  const auto load = [&](int kt) {
    const int s = kt % kStages, k0 = kb + kt * kK;
    OpA::template load<S::kThreads>(sa + s * OpA::kFloats, pa, row0, m, k0, ke);
    OpB::template load<S::kThreads>(sb + s * OpB::kFloats, pb, col0, n, k0, ke);
  };

  // an mma rounds the sums it adds to its accumulator toward zero, an error
  // that would grow with acc: 3xTF32 adds each k8 step's three mmas, from
  // zero, to acc by an f32 add (round to nearest); bf16, with a quarter of
  // the mmas a stage, every fourth stage's, summed from zero in part
  constexpr int kFlush = 4;
  float acc[S::kMt][S::kNt][4] = {}, part[S::kMt][S::kNt][4] = {};
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < nk) load(kt);
    commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    wait_pending<kStages - 2>();  // slice kt has landed
    __syncthreads();              // and every warp is done with slice kt - 1
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    commit();
    const float* as = sa + (kt % kStages) * OpA::kFloats;
    const float* bs = sb + (kt % kStages) * OpB::kFloats;
    const int kvalid = ke - (kb + kt * kK);
    if constexpr (!Bf16) {
      stage_3xtf32<S, OpA, OpB>(as, bs, wm0, wn0, g, t, kvalid, acc);
    } else {
      stage_bf16<S, OpA, OpB>(as, bs, wm0, wn0, g, t, kvalid, part);
      if ((kt + 1) % kFlush == 0 || kt + 1 == nk) {
#pragma unroll
        for (int mt = 0; mt < S::kMt; ++mt)
#pragma unroll
          for (int nt = 0; nt < S::kNt; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[mt][nt][e] += part[mt][nt][e];
              part[mt][nt][e] = 0.f;
            }
      }
    }
  }

  // the tile through shared memory (the ring's, free now), so that the
  // epilogue runs along rows: neighbouring threads store, and read what the
  // epilogue reads, at neighbouring j; an mma fragment holds two columns
  // of eight rows. kLdc = 8 mod 32: a half-warp's float2 writes hit
  // distinct banks.
  constexpr int kLdc = S::kBN + 8;
  static_assert(S::kBM * kLdc <= kStages * (OpA::kFloats + OpB::kFloats), "tile > ring");
  wait_pending<0>();
  __syncthreads();
  float* cs = smem;
#pragma unroll
  for (int mt = 0; mt < S::kMt; ++mt)
#pragma unroll
    for (int nt = 0; nt < S::kNt; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(cs + (wm0 + 16 * mt + g + 8 * h) * kLdc + wn0 + 8 * nt +
                                   2 * t) = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  __syncthreads();
  for (int e = threadIdx.x; e < S::kBM * S::kBN; e += S::kThreads) {
    const int r = e / S::kBN, c = e % S::kBN, i = row0 + r, j = col0 + c;
    if (i < m && j < n) epi(i, j, cs[r * kLdc + c]);
  }
}

// c(i, j) = epi(i, j, sum over z of partial[z, i, j]), z in order: row i
// = blockIdx.x, columns j = (blockIdx.y * cols + q) * blockDim.x +
// threadIdx.x for q < cols <= 4 (no division by n, which at 64 bits would
// cost more than the sum). A thread's sums are read before any epilogue
// runs: an epilogue that reads waits on its loads, and its store keeps
// the next one's loads behind it, so the sums' loads go first, together.
template <class Epi>
__global__ void __launch_bounds__(256)
tc_sum_kernel(const float* __restrict__ partial, Epi epi, int m, int n, int splits,
              int cols) {
  const int i = blockIdx.x, j0 = blockIdx.y * cols * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)m * n;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = j0 + q * blockDim.x;
    if (q == cols || j >= n) break;
    const float* at = partial + (size_t)i * n + j;
    int z = 0;
    for (; z + 4 <= splits; z += 4) {  // four loads in flight, added in order
      const float a0 = at[z * mn], a1 = at[(z + 1) * mn], a2 = at[(z + 2) * mn],
                  a3 = at[(z + 3) * mn];
      v[q] += a0;
      v[q] += a1;
      v[q] += a2;
      v[q] += a3;
    }
    for (; z < splits; ++z) v[q] += at[z * mn];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = j0 + q * blockDim.x;
    if (q == cols || j >= n) break;
    epi(i, j, v[q]);
  }
}

// tc_sum_kernel over c [m, n] on `stream`: a block a row, or a row's
// pieces; four columns a thread in rows of 1024 or more (a reading
// epilogue's pass over a wide product), else one, so that narrow products
// keep a thread a sum.
template <class Epi>
cudaError_t sum_slices(const float* partial, Epi epi, int m, int n, int splits,
                       cudaStream_t stream) {
  const int cols = n >= 1024 ? 4 : 1;
  const int threads = std::min(256, (cdiv(n, cols) + 31) / 32 * 32);
  tc_sum_kernel<<<dim3(m, cdiv(n, cols * threads)), threads, 0, stream>>>(partial, epi, m, n,
                                                                          splits, cols);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The Hopper tile: wgmma fed by TMA.
//
// Operands come from staged copies in device memory (`Staging`): bf16, each
// value rounded to nearest even once, in its source's own layout (rows
// padded to 8 elements, 16 bytes); or, for 3xTF32, hi = tf32(a) and lo =
// tf32(a - hi) (cvt.rna, the values split_tf32 gives) in K-major layout
// (rows padded to 4 floats), since tf32 wgmma reads K-major tiles alone.
// A CTA of three warpgroups computes 128x128 outputs: warpgroup 0's first
// thread is the producer, which keeps kStages stages of 128-byte-wide
// boxes in flight with cp.async.bulk.tensor (128-byte swizzle, out-of-bounds
// elements zero), each reporting to its stage's `full` mbarrier; warpgroups
// 1 and 2 each run wgmma m64n128 on their 64 rows, reading both operands
// from shared memory (bf16: K-major or MN-major by the descriptor's
// transpose bit, so a transposed view needs no copy), and free the stage on
// its `empty` mbarrier when their wgmmas on it are done. setmaxnreg moves
// registers from the producer to the consumers. The grid is persistent:
// one CTA an SM walks the work units (tile, k slice) in a fixed order,
// the tiles in groups of kGroupM tile rows.
// Order of sums: the tensor core rounds what it adds to its accumulator
// toward zero, so sums are taken in two levels, a chunk from zero (scale-d
// 0 on its first wgmma), then an f32 add (round to nearest) into the
// running sum. 3xTF32 sums each k8 step's lo*hi, hi*lo, hi*hi alone, as
// the Ampere tile does, into one of two sums in turn, so that a step's add
// waits for no wgmma: chunks of 4 stages were within 1.0e-6 of float64
// but biased each product toward zero enough that the lr-1 large LM's
// losses parted from cuBLAS's 10 times faster than a one-ulp nudge of its
// weights (PERF.md). bf16 sums chunks of kFlush stages, the second
// warpgroup's half a chunk later, so that the two do not wait at once.
// Epilogue: each thread stores its accumulators from registers, four
// threads a 32-byte run of a row. An epilogue that reads (GiEpilogue,
// GatesEpilogue, DxEpilogue) would wait on its loads element by element
// (its stores keep the compiler from moving the next element's loads
// ahead), which on one CTA an SM stalls the tensor cores for longer than a
// tile's k loop at k = 1500; so those products store their raw sums and
// tc_sum_kernel runs the epilogue over all of them (run_wg).
// What bounds it: at 128x128 outputs a bf16 stage of 64 k brings 32 KB
// from L2 for 2.1 MFLOP, so at the card's bf16 peak the 132 SMs would read
// L2 at about 15 TB/s, well above what L2 gives (3xTF32: 64 KB for 3.1
// MFLOP at half the rate). Larger tiles would need the accumulators of
// both sum levels in more registers than a thread has; the next step is a
// cluster of two CTAs sharing B by TMA multicast.
namespace wg {

constexpr int kBM = 128, kBN = 128;  // the CTA's tile; 64 rows a consumer warpgroup
constexpr int kThreads = 384;        // the producer's warpgroup and two consumers
constexpr int kBoxBytes = 128;       // a box's row: one 128-byte swizzle row
constexpr int kMinSliceStages = 4;   // stages a k slice takes at least
constexpr int kMaxSplits = 32;       // k slices a product takes at most

// Per precision: k a stage (one 128-byte box row of the staged type), the
// ring's stages, the boxes of a stage (bf16 A and B; f32 A hi, A lo, B hi,
// B lo; 16 KB each) and k a flush (kFlush stages).
template <bool Bf16>
struct Cfg {
  static constexpr int kBK = Bf16 ? 64 : 32;
  static constexpr int kStages = Bf16 ? 6 : 3;
  static constexpr int kOperands = Bf16 ? 2 : 4;
  static constexpr int kOperandBytes = kBM * kBoxBytes;  // kBM == kBN
  static constexpr int kStageBytes = kOperands * kOperandBytes;
  static constexpr int kFlush = 4;  // bf16; 3xTF32 sums each k8 step alone
  // the ring and its 2 kStages barriers, after 1024-byte alignment (the
  // swizzle's period) of the dynamic shared memory
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;
};
static_assert(Cfg<true>::kSmemBytes <= 232448 && Cfg<false>::kSmemBytes <= 232448,
              "shared memory");

// The tensor maps of a product's operands (lo unused in bf16).
struct Maps {
  CUtensorMap a, b, a_lo, b_lo;
};

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned long long clock_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem(bar)) : "memory");
}
// Waits for the phase of parity `parity` to complete; traps after two
// seconds, so that a fault ends the launch instead of hanging the card.
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = smem(bar);
  auto ready = [&]() {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    return done != 0;
  };
  if (ready()) return;
  const unsigned long long start = clock_ns();
  while (!ready())
    if (clock_ns() - start > 2000000000ull) __trap();
}
// The box of `map` at (c0, c1), innermost first, into shared memory at dst.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst,
                                         unsigned long long* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A shared-memory matrix descriptor with 128-byte swizzle: start address,
// leading and stride byte offsets (bits 0-13, 16-29, 32-45, in 16 bytes),
// layout type 1 (bits 62-63). K-major: rows of 128 bytes, 8-row groups
// 1024 bytes apart (sbo); MN-major: 128-byte rows along k, 8-k groups
// 1024 bytes apart (sbo), 64-element blocks of M or N lbo apart.
__device__ __forceinline__ unsigned long long desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) |
         ((unsigned long long)(lbo >> 4) << 16) | ((unsigned long long)(sbo >> 4) << 32) |
         (1ull << 62);
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmmas that write them; only where none is in flight (else
// the compiler waits for them here).
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

#define VMLMF_WG_D8(i)                                                               \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),        \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define VMLMF_WG_D64                                                                 \
  VMLMF_WG_D8(0), VMLMF_WG_D8(8), VMLMF_WG_D8(16), VMLMF_WG_D8(24), VMLMF_WG_D8(32), \
      VMLMF_WG_D8(40), VMLMF_WG_D8(48), VMLMF_WG_D8(56)
#define VMLMF_WG_REGS                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A B over k = 16, A [64, 16] and B [16, 128] bf16 from shared
// memory; TA, TB: 1 for an MN-major operand. scale_d 0: d = A B.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], unsigned long long da,
                                           unsigned long long db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VMLMF_WG_REGS
      ", %64, %65, p, 1, 1, %67, %68;\n\t}"
      : VMLMF_WG_D64
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}
// The same over k = 8 in tf32 (K-major operands alone).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], unsigned long long da,
                                           unsigned long long db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " VMLMF_WG_REGS
      ", %64, %65, p, 1, 1;\n\t}"
      : VMLMF_WG_D64
      : "l"(da), "l"(db), "r"(scale_d));
}
#undef VMLMF_WG_REGS
#undef VMLMF_WG_D64
#undef VMLMF_WG_D8

__device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Where a unit's results go: the epilogue, or a k slice's partial sums.
template <class Epi>
struct Direct {
  Epi epi;
  __device__ __forceinline__ Epi at(int) const { return epi; }
};
struct Slices {
  float* partial;
  int m, n;
  __device__ __forceinline__ SlicePartial at(int z) const { return SlicePartial{partial, m, n, z}; }
};

// One operand's boxes of a stage: K-major, one box of 64 (bf16) or 32
// (f32) k by 128 rows at (k0, mn0); MN-major (bf16), two boxes of 64
// columns by 64 k at (mn0, k0) and (mn0 + 64, k0), 8 KB apart.
template <bool KMajor>
__device__ __forceinline__ void load_operand(const CUtensorMap* map, unsigned char* dst,
                                             unsigned long long* bar, int k0, int mn0) {
  if constexpr (KMajor) {
    tma_load(map, dst, bar, k0, mn0);
  } else {
    tma_load(map, dst, bar, mn0, k0);
    tma_load(map, dst + 64 * kBoxBytes, bar, mn0 + 64, k0);
  }
}

// The descriptor of a consumer's 64 rows (or all 128 columns of B) at k
// step kk of a stage's operand at addr.
template <bool KMajor, int KBytes>
__device__ __forceinline__ unsigned long long operand_desc(unsigned addr, int kk) {
  if constexpr (KMajor) return desc(addr + kk * KBytes, 16, 1024);
  return desc(addr + kk * 16 * kBoxBytes, 64 * kBoxBytes, 1024);
}

// The origin (m0, n0) of output tile t, in groups of kGroupM tile rows
// walked column by column, so that the CTAs at work at once share their
// operands' panels in L2.
constexpr int kGroupM = 16;
__device__ __forceinline__ void tile_at(int t, int tiles_m, int tiles_n, int& m0, int& n0) {
  const int per_group = kGroupM * tiles_n, first = t / per_group * kGroupM;
  const int rows = min(kGroupM, tiles_m - first), in = t % per_group;
  m0 = (first + in % rows) * kBM;
  n0 = in / rows * kBN;
}

// c = sink(A B) over the units (tile, k slice) of a product c [m, n] over
// k, A [m, k] and B [k, n] from `maps` (KA / KB: K-major; f32 always).
// The sink is Store-like (it reads nothing): each thread stores its
// accumulators straight from registers, four threads a 32-byte run of a
// row, so the epilogue waits on no load and the tile needs no shared
// memory; the epilogues that read (run_wg) run in tc_sum_kernel after.
template <bool Bf16, bool KA, bool KB, class Sink>
__global__ void __launch_bounds__(kThreads, 1)
wg_gemm_kernel(const __grid_constant__ Maps maps, Sink sink, int m, int n, int k, int kslice,
               int splits, int flush) {
  using C = Cfg<Bf16>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem(smem_raw) & 1023)) & 1023);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + C::kStages * C::kStageBytes);
  unsigned long long* empty = full + C::kStages;
  const int tiles_m = ceil_div(m, kBM), tiles_n = ceil_div(n, kBN), tiles = tiles_m * tiles_n,
            units = tiles * splits;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer's warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int m0, n0;
        tile_at(u % tiles, tiles_m, tiles_n, m0, n0);
        const int kb = u / tiles * kslice, nk = ceil_div(min(k, kb + kslice) - kb, C::kBK);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % C::kStages, k0 = kb + kt * C::kBK;
          bar_wait(empty + s, ((it / C::kStages) & 1) ^ 1);
          bar_expect(full + s, C::kStageBytes);
          unsigned char* st = ring + s * C::kStageBytes;
          if constexpr (Bf16) {
            load_operand<KA>(&maps.a, st, full + s, k0, m0);
            load_operand<KB>(&maps.b, st + C::kOperandBytes, full + s, k0, n0);
          } else {
            tma_load(&maps.a, st, full + s, k0, m0);
            tma_load(&maps.a_lo, st + C::kOperandBytes, full + s, k0, m0);
            tma_load(&maps.b, st + 2 * C::kOperandBytes, full + s, k0, n0);
            tma_load(&maps.b_lo, st + 3 * C::kOperandBytes, full + s, k0, n0);
          }
        }
      }
    }
  } else {  // the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
    const bool leader = threadIdx.x % 128 == 0;
    const unsigned ring_at = smem(ring);
    constexpr int kKBytes = 32;  // a k step along a K-major row: 16 bf16 or 8 tf32
    // bf16: part, a chunk's sum; f32: part and part2 in turn, a k8 step's
    float acc[64], part[64], part2[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = part2[i] = 0.f;
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int z = u / tiles;
      int m0, n0;
      tile_at(u % tiles, tiles_m, tiles_n, m0, n0);
      const int kb = z * kslice, nk = ceil_div(min(k, kb + kslice) - kb, C::kBK);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      int held = -1;  // a stage whose wgmmas may still be reading it
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % C::kStages;
        bar_wait(full + s, (it / C::kStages) & 1);
        const unsigned st = ring_at + s * C::kStageBytes;
        if constexpr (Bf16) {
          // the warpgroups' chunks are half a chunk apart, so that one keeps
          // the tensor cores busy while the other waits for its chunk's sum
          const int at = (kt + wg * (flush / 2)) % flush;
          const int first = kt == 0 ? 0 : at;  // 0: a chunk's first stage
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < C::kBK / 16; ++kk)
            wgmma_bf16<KA ? 0 : 1, KB ? 0 : 1>(
                part, operand_desc<KA, kKBytes>(st + wg * 64 * kBoxBytes, kk),
                operand_desc<KB, kKBytes>(st + C::kOperandBytes, kk), first | kk);
          wgmma_commit();
          if (at == flush - 1 || kt + 1 == nk) {
            wgmma_wait<0>();
            fence_regs(part);
            if (leader) {
              if (held >= 0) bar_arrive(empty + held);
              bar_arrive(empty + s);
            }
            held = -1;
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] += part[i];
          } else {
            wgmma_wait<1>();
            if (leader && held >= 0) bar_arrive(empty + held);
            held = s;
          }
        } else {
          // each k8 step's three terms from zero into part or part2 in turn
          // (as the Ampere tile sums them); a step's sum joins acc once the
          // next step's wgmmas are issued, so the tensor cores never wait
          const unsigned a = st + wg * 64 * kBoxBytes;
          const auto step = [&](float(&p)[64], float(&q)[64], int kk) {
            const unsigned long long ahi = operand_desc<true, kKBytes>(a, kk),
                                     alo = operand_desc<true, kKBytes>(a + C::kOperandBytes, kk),
                                     bhi = operand_desc<true, kKBytes>(st + 2 * C::kOperandBytes,
                                                                       kk),
                                     blo = operand_desc<true, kKBytes>(st + 3 * C::kOperandBytes,
                                                                       kk);
            wgmma_fence();
            wgmma_tf32(p, alo, bhi, 0);
            wgmma_tf32(p, ahi, blo, 1);
            wgmma_tf32(p, ahi, bhi, 1);
            wgmma_commit();
            if (kt > 0 || kk > 0) {
              wgmma_wait<1>();  // q's step, and every stage before this one
              fence_regs(q);
#pragma unroll
              for (int i = 0; i < 64; ++i) acc[i] += q[i];
              if (kk == 0 && leader && held >= 0) bar_arrive(empty + held);
            }
          };
          static_assert(C::kBK / 8 == 4, "four k8 steps a stage, two a sum");
          step(part, part2, 0);
          step(part2, part, 1);
          step(part, part2, 2);
          step(part2, part, 3);
          held = s;
          if (kt + 1 == nk) {
            wgmma_wait<0>();
            fence_regs(part2);  // the last step's
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] += part2[i];
            if (leader) bar_arrive(empty + held);
            held = -1;
          }
        }
      }
      wgmma_wait<0>();  // none in flight: the last stage waited for all

      // accumulator i of thread (warp, g, t4): row 16 warp + g (+ 8 for i %
      // 4 >= 2), column 8 (i / 4) + 2 t4 (+ 1 for odd i) of the warpgroup's 64
      const auto out = sink.at(z);
      const int i0 = m0 + wg * 64 + warp * 16 + g;
#pragma unroll
      for (int q = 0; q < 64; ++q) {
        const int i = i0 + 8 * ((q / 2) % 2), j = n0 + 8 * (q / 4) + 2 * t4 + q % 2;
        if (i < m && j < n) out(i, j, acc[q]);
      }
    }
  }
}

// The storage under a view, as rows: row i is first[i] for i < nfirst and
// rest[i - nfirst] after (PrevRows' seam), each ld floats apart. A gated
// source (gate set) forms a product of two views as it is staged: its row
// i is the plain row i for i < gated_from, and row i' = i - gated_from
// times gate's row i' (gate_ld floats apart) after; gated_from 0 gates
// every row (the GRU's R * Hprev and dN * R), gated_from M stacks the
// plain rows over the gated ones ([Hprev; R * Hprev] of the GRU's dUf).
struct Source {
  const float* first;
  const float* rest;
  int nfirst, ld;
  const float* gate = nullptr;
  int gate_ld = 0, gated_from = 0;
  __device__ __forceinline__ const float* row(int i) const {
    return i < nfirst ? first + (size_t)i * ld : rest + (size_t)(i - nfirst) * ld;
  }
  __device__ __forceinline__ float at(int i, int j) const {
    if (gate == nullptr || i < gated_from) return row(i)[j];
    const int g = i - gated_from;
    return row(g)[j] * gate[(size_t)g * gate_ld + j];
  }
};

// dst [rows, ld] bf16 = the source's rows [rows, cols], rounded to nearest
// even (the value bf16_pair gives), zeros in the padding up to ld (a
// multiple of 8): eight elements a thread; a plain source (Staging takes
// no gated one in bf16).

__global__ void __launch_bounds__(256)
cast_bf16_kernel(Source src, __nv_bfloat16* __restrict__ dst, int rows, int cols, int ld) {
  const int per_row = ld / 8;
  for (size_t e = (size_t)blockIdx.x * 256 + threadIdx.x; e < (size_t)rows * per_row;
       e += (size_t)gridDim.x * 256) {
    const int i = static_cast<int>(e / per_row), j = static_cast<int>(e % per_row) * 8;
    const float* p = src.row(i) + j;
    float v[8];
    if (j + 8 <= cols && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      const float4 lo = *reinterpret_cast<const float4*>(p),
                   hi = *reinterpret_cast<const float4*>(p + 4);
      v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w, v[4] = hi.x, v[5] = hi.y, v[6] = hi.z,
      v[7] = hi.w;
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = j + q < cols ? p[q] : 0.f;
    }
    uint4 out;
    unsigned* w = reinterpret_cast<unsigned*>(&out);
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = bf16_pair(make_float2(v[2 * q], v[2 * q + 1]));
    *reinterpret_cast<uint4*>(dst + (size_t)i * ld + j) = out;
  }
}

// out = y * mask, element by element, in f32 (one rounding each).
template <class T>
__global__ void __launch_bounds__(256)
mul_kernel(const T* __restrict__ y, const T* __restrict__ mask, T* __restrict__ out, size_t n) {
  for (size_t e = (size_t)blockIdx.x * 256 + threadIdx.x; e < n; e += (size_t)gridDim.x * 256)
    out[e] = y[e] * mask[e];
}

// hi and lo [rows, ld] (ld a multiple of 4) = split_tf32 of the source's
// rows [rows, cols] (Transpose: of its transpose, the source [cols, rows]),
// zeros in the padding: through a 32x32 tile of shared memory, so that
// both the reads and the writes run along rows.
template <bool Transpose>
__global__ void __launch_bounds__(256)
split_tf32_kernel(Source src, float* __restrict__ hi, float* __restrict__ lo, int rows, int cols,
                  int ld) {
  __shared__ float tile[32][33];
  const int i0 = blockIdx.y * 32, j0 = blockIdx.x * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  if constexpr (Transpose) {
    // read source rows j0.. (our columns), columns i0.. (our rows)
#pragma unroll
    for (int q = ty; q < 32; q += 8) {
      const int sr = j0 + q, sc = i0 + tx;
      tile[q][tx] = sr < cols && sc < rows ? src.at(sr, sc) : 0.f;
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = ty; q < 32; q += 8) {
    const int i = i0 + q, j = j0 + tx;
    if (i >= rows || j >= ld) continue;
    float v;
    if constexpr (Transpose)
      v = tile[tx][q];
    else
      v = j < cols ? src.at(i, j) : 0.f;
    unsigned h, l;
    split_tf32(v, h, l);
    hi[(size_t)i * ld + j] = __uint_as_float(h);
    lo[(size_t)i * ld + j] = __uint_as_float(l);
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// Host side of the Hopper tile: the staged copies, the tensor maps, the
// plan and the launch.

// The storage under a view: rows [0, nfirst) of `first`, then rows of
// `rest` (PrevRows' seam), each ld floats apart.
// A view of another file stages through a source_of of its own, found by
// argument-dependent lookup (gru_scan_xin_bwd.cu's composites).
inline wg::Source source_of(const RowMajor& v) { return {v.p, nullptr, INT_MAX, v.ld}; }
inline wg::Source source_of(const Transposed& v) { return {v.p, nullptr, INT_MAX, v.ld}; }
inline wg::Source source_of(const PrevRows& v) { return {v.first, v.rest, v.nfirst, v.ld}; }
inline wg::Source source_of(const PrevRowsT& v) { return {v.first, v.rest, v.nfirst, v.ld}; }

constexpr size_t kStageAlign = 256;  // bytes; each staged copy starts aligned
inline size_t align_up(size_t bytes) {
  return (bytes + kStageAlign - 1) / kStageAlign * kStageAlign;
}
inline int round_to(int v, int q) { return (v + q - 1) / q * q; }

// The staged copies of one call's products, carved in order from scratch
// that the wrapper allocates (ops/cuda_scan.py::tc_stage_floats mirrors the
// bytes): each source is staged once a call (or once between resets) in
// each form that a product reads, at the first product that reads it (its
// content is final by then: the scans never write a buffer after a product
// has read it).
struct Staging {
  enum Form { kBf16 = 0, kSplit = 1, kSplitT = 2 };  // bf16; hi and lo as stored; transposed
  struct Copy {
    const float* first;
    const float* rest;
    const float* gate;
    int gated_from, form;
    const void* hi;
    const void* lo;
    int rows, cols, ld;  // of the copy
  };
  unsigned char* base;
  size_t bytes, used;
  Copy copies[24];
  int count;

  Staging(float* scratch, size_t floats)
      : base(reinterpret_cast<unsigned char*>(scratch)), bytes(floats * 4), used(0), count(0) {}

  // The copy of the source's rows [rows, cols] in `form` (kSplitT: of its
  // transpose), staging it on `stream` if this call has not (a gated source
  // is keyed by its gate too); null hi on error (`err`).
  Copy get(wg::Source src, int rows, int cols, int form, cudaStream_t stream, cudaError_t& err) {
    for (int i = 0; i < count; ++i) {
      const Copy& c = copies[i];
      if (c.first == src.first && c.rest == src.rest && c.gate == src.gate &&
          (src.gate == nullptr || c.gated_from == src.gated_from) && c.form == form &&
          (form == kSplitT ? c.cols == rows && c.rows == cols : c.rows == rows && c.cols == cols))
        return c;
    }
    if (form == kBf16 && src.gate != nullptr) {  // the gated sources are f32 products'
      err = cudaErrorInvalidValue;
      return Copy{};
    }
    Copy c{src.first, src.rest, src.gate, src.gated_from, form, nullptr, nullptr, 0, 0, 0};
    c.rows = form == kSplitT ? cols : rows;
    c.cols = form == kSplitT ? rows : cols;
    c.ld = round_to(c.cols, form == kBf16 ? 8 : 4);  // 16-byte rows
    const size_t one = align_up((size_t)c.rows * c.ld * (form == kBf16 ? 2 : 4));
    const size_t need = form == kBf16 ? one : 2 * one;
    if (count == 24 || used + need > bytes) {
      err = cudaErrorInvalidValue;
      return c;
    }
    c.hi = base + used;
    c.lo = form == kBf16 ? nullptr : base + used + one;
    used += need;
    if (form == kBf16) {
      const size_t work = (size_t)c.rows * (c.ld / 8);
      const unsigned blocks = static_cast<unsigned>(std::min<size_t>((work + 255) / 256, 8192));
      wg::cast_bf16_kernel<<<blocks, 256, 0, stream>>>(
          src, static_cast<__nv_bfloat16*>(const_cast<void*>(c.hi)), c.rows, c.cols, c.ld);
    } else {
      const dim3 grid(cdiv(c.ld, 32), cdiv(c.rows, 32));
      float* hi = static_cast<float*>(const_cast<void*>(c.hi));
      float* lo = static_cast<float*>(const_cast<void*>(c.lo));
      if (form == kSplit)
        wg::split_tf32_kernel<false><<<grid, 256, 0, stream>>>(src, hi, lo, c.rows, c.cols, c.ld);
      else
        wg::split_tf32_kernel<true><<<grid, 256, 0, stream>>>(src, hi, lo, c.rows, c.cols, c.ld);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return c;
    copies[count++] = c;
    return c;
  }

  // `floats` of scratch for a product's raw sums (null on error, `err`).
  float* raw(size_t floats, cudaError_t& err) {
    const size_t need = align_up(floats * 4);
    if (used + need > bytes) {
      err = cudaErrorInvalidValue;
      return nullptr;
    }
    float* p = reinterpret_cast<float*>(base + used);
    used += need;
    return p;
  }

  // `elems` floats of scratch holding y * mask (the wavefront stack's
  // layer input: the output of the layer below times its dropout mask),
  // written by one f32 pass, the value gemm_tile.cuh's MaskedRows reads in
  // place: the tiles then read it as a plain view (the Ampere tile's
  // cp.async copies cannot multiply, and a bf16 copy takes no gated
  // source). Null on error (`err`). A member template (T is float), so that
  // a library that never calls it builds no kernel for it.
  template <class T>
  T* masked(const T* y, const T* mask, size_t elems, cudaStream_t stream, cudaError_t& err) {
    static_assert(std::is_same_v<T, float>, "the layer input is f32");
    T* x = raw(elems, err);
    if (x == nullptr) return nullptr;
    const unsigned blocks = static_cast<unsigned>(std::min<size_t>((elems + 255) / 256, 8192));
    wg::mul_kernel<<<blocks, 256, 0, stream>>>(y, mask, x, elems);
    err = cudaGetLastError();
    return err == cudaSuccess ? x : nullptr;
  }

  // Forgets every copy and raw sum, so that the next product stages from
  // the scratch's start: for a caller whose earlier products are done with
  // theirs (one stream orders the reads before the next writes).
  void reset() {
    used = 0;
    count = 0;
  }
};

// Epilogues that read nothing, which the Hopper tile runs from registers.
template <class Epi>
struct ReadsNothing : std::false_type {};
template <>
struct ReadsNothing<Store> : std::true_type {};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime uses (nothing links
// libcuda); static: one lookup a library.
static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

// A map over a staged copy [rows, cols] (row stride ld) with boxes of
// box_cols (128 bytes) by box_rows, 128-byte swizzle, zeros out of bounds.
inline cudaError_t make_map(CUtensorMap* map, const void* p, bool bf16, int rows, int cols,
                            int ld, int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInvalidValue;
  const size_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * es};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<void*>(p), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of one operand: bf16 staged in its source's layout, K-major
// (boxes 64 k by 128 rows) or MN-major (boxes 64 columns by 64 k); f32
// split K-major (boxes 32 k by 128 rows), hi and lo.
inline cudaError_t operand_maps(const Staging::Copy& c, bool bf16, bool kmajor, CUtensorMap* hi,
                                CUtensorMap* lo) {
  if (bf16)
    return make_map(hi, c.hi, true, c.rows, c.cols, c.ld, 64, kmajor ? wg::kBM : 64);
  cudaError_t err = make_map(hi, c.hi, false, c.rows, c.cols, c.ld, 32, wg::kBM);
  return err != cudaSuccess ? err : make_map(lo, c.lo, false, c.rows, c.cols, c.ld, 32, wg::kBM);
}

// The SMs of the current device: the persistent grid's size.
inline int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return kWave;
  return sms;
}

// static, as `launch` is: the shared-memory attribute once a device.
template <bool Bf16, bool KA, bool KB, class Sink>
static cudaError_t launch_wg(const wg::Maps& maps, Sink sink, int m, int n, int k, int kslice,
                             int splits, int flush, cudaStream_t stream) {
  constexpr int smem = wg::Cfg<Bf16>::kSmemBytes;
  static std::atomic<unsigned long long> set_on{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(set_on.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(wg::wg_gemm_kernel<Bf16, KA, KB, Sink>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    set_on.fetch_or(bit, std::memory_order_release);
  }
  const int units = cdiv(m, wg::kBM) * cdiv(n, wg::kBN) * splits;
  wg::wg_gemm_kernel<Bf16, KA, KB, Sink>
      <<<std::min(units, device_sms()), wg::kThreads, smem, stream>>>(maps, sink, m, n, k, kslice,
                                                                       splits, flush);
  return cudaGetLastError();
}


// The route, tile and k slices of a product c [m, n] over k, given room
// for `room` slices of partial sums (ops/cuda_scan.py::tc_plan mirrors it):
// wg, the Hopper tile (128x128, `big` set); else the Ampere tile, big
// (128x128) or small (64x64).
struct Plan {
  bool wg, big;
  int splits, kslice;
};

// The Hopper tile runs a product of at least kWgMinWork multiply-adds
// whose m, n and k are all kWgMinDim or more (a whole tile each way, two
// bf16 stages); the Ampere tile, which stages nothing, the others: the
// HAR layer's, and those of a batch row or two (m or k = T at B=1). The
// card measured it as fast or faster there (PERF.md, "the rule").
constexpr long long kWgMinWork = 1ll << 28;
constexpr int kWgMinDim = 128;

inline bool wg_route(int m, int n, int k) {
  return std::min(std::min(m, n), k) >= kWgMinDim && (long long)m * n * k >= kWgMinWork;
}

// The Ampere tile's plan: the tile that gives the busiest SM the least
// work (a 128x128 CTA does four 64x64 ones' work, 1.16 times as fast at
// dense h=1500), and a small-tile product with fewer than kSplitTarget
// tiles cuts k into slices of whole kK steps near kSplitTarget CTAs.
inline Plan mma_plan(int m, int n, int k, size_t room) {
  const int big = cdiv(m, BigTile::kBM) * cdiv(n, BigTile::kBN);
  const int small = cdiv(m, SmallTile::kBM) * cdiv(n, SmallTile::kBN);
  if (400 * cdiv(big, kWave) < 116 * cdiv(small, kWave)) return Plan{false, true, 1, k};
  if (k <= 0) return Plan{false, false, 1, k};
  int splits = cdiv(kSplitTarget, small);
  if ((size_t)splits > room) splits = static_cast<int>(room);
  const int kslice = cdiv(cdiv(k, splits > 1 ? splits : 1), kK) * kK;
  splits = cdiv(k, kslice);
  return splits > 1 ? Plan{false, false, splits, kslice} : Plan{false, false, 1, k};
}

// The Hopper tile's plan: where the tiles fill less than a wave of kWave
// persistent CTAs, k cut into the slices (whole stages, at least
// kMinSliceStages each, at most kMaxSplits, within room, tiles times
// slices within a wave) that give the busiest CTA the least work, the
// fewest on a tie.
inline Plan wg_plan(int m, int n, int k, size_t room, bool bf16) {
  const int bk = bf16 ? wg::Cfg<true>::kBK : wg::Cfg<false>::kBK;
  const long long tiles = (long long)cdiv(m, wg::kBM) * cdiv(n, wg::kBN);
  const long long most = std::min<long long>(
      std::min<long long>(std::min<long long>(wg::kMaxSplits, (kWave + tiles - 1) / tiles),
                          (long long)std::min<size_t>(room, 1 << 20)),
      k / (bk * wg::kMinSliceStages));
  long long best = 1;
  for (long long s = 2; s <= most; ++s)
    if ((tiles * s + kWave - 1) / kWave * best < (tiles * best + kWave - 1) / kWave * s) best = s;
  const int kslice = cdiv(cdiv(k, static_cast<int>(best)), bk) * bk;
  const int splits = cdiv(k, kslice);
  return splits > 1 ? Plan{true, true, splits, kslice} : Plan{true, true, 1, k};
}

inline Plan tc_plan(int m, int n, int k, size_t room, bool bf16) {
  return wg_route(m, n, k) ? wg_plan(m, n, k, room, bf16) : mma_plan(m, n, k, room);
}

// static: the flags below must have internal linkage. A function-local
// static of an external template is one object for every library of the
// process that instantiates it, and each library has its own kernel.
template <class S, bool Bf16, class A, class B, class Epi>
static cudaError_t launch(A a, B b, Epi epi, int m, int n, int k, int kslice, int splits,
                          cudaStream_t stream) {
  constexpr int smem = smem_bytes<S, Bf16, A, B>();
  // the shared-memory attribute holds for the kernel on the device that was
  // current when it was set: set once a device (a bit each, the first 64)
  static std::atomic<unsigned long long> set_on{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(set_on.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(tc_gemm_kernel<S, Bf16, A, B, Epi>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    set_on.fetch_or(bit, std::memory_order_release);
  }
  tc_gemm_kernel<S, Bf16, A, B, Epi>
      <<<dim3(cdiv(n, S::kBN), cdiv(m, S::kBM), splits), S::kThreads, smem, stream>>>(
          a, b, epi, m, n, k, kslice);
  return cudaGetLastError();
}

// The Hopper tile on plan p: A and B staged (once a call each, `st`), their
// maps, then the launch, and the split-k sum where p splits k.
// flush: stages a chunk of the two-level sum (the plan's, kFlush; other
// values for the checks that measure the chunk's error).
template <bool Bf16, class A, class B, class Epi>
cudaError_t run_wg(Staging& st, A a, B b, Epi epi, int m, int n, int k, const Plan& p,
                   float* partial, cudaStream_t stream, int flush = wg::Cfg<Bf16>::kFlush) {
  // the storage of A [m, k] is [m][k] where A runs along k, else [k][m];
  // of B [k, n], [n][k] where B runs along k, else [k][n]
  constexpr bool ka = A::kContigJ, kb = !B::kContigJ;
  using S = Staging;
  cudaError_t err = cudaSuccess;
  const S::Copy ca = st.get(source_of(a), ka ? m : k, ka ? k : m,
                            Bf16 ? S::kBf16 : ka ? S::kSplit : S::kSplitT, stream, err);
  if (err != cudaSuccess) return err;
  const S::Copy cb = st.get(source_of(b), kb ? n : k, kb ? k : n,
                            Bf16 ? S::kBf16 : kb ? S::kSplit : S::kSplitT, stream, err);
  if (err != cudaSuccess) return err;
  wg::Maps maps;
  err = operand_maps(ca, Bf16, !Bf16 || ka, &maps.a, &maps.a_lo);
  if (err == cudaSuccess) err = operand_maps(cb, Bf16, !Bf16 || kb, &maps.b, &maps.b_lo);
  if (err != cudaSuccess) return err;
  constexpr bool KA = !Bf16 || ka, KB = !Bf16 || kb;  // f32 copies are K-major
  int splits = p.splits;
  if (splits > 1) {
    err = launch_wg<Bf16, KA, KB>(maps, wg::Slices{partial, m, n}, m, n, k, p.kslice, splits,
                                  flush, stream);
  } else if constexpr (ReadsNothing<Epi>::value) {
    return launch_wg<Bf16, KA, KB>(maps, wg::Direct<Epi>{epi}, m, n, k, k, 1, flush, stream);
  } else {
    // an epilogue that reads (the x term, the gates, dx's xdvec term) waits
    // on its loads element by element; on one CTA an SM that would stall
    // the tensor cores, so the tile stores its raw sums and the epilogue
    // runs over all of them in one more pass
    partial = st.raw((size_t)m * n, err);
    if (err != cudaSuccess) return err;
    err = launch_wg<Bf16, KA, KB>(maps, wg::Direct<Store>{Store{partial, n}}, m, n, k, k, 1,
                                  flush, stream);
  }
  if (err != cudaSuccess) return err;
  return sum_slices(partial, epi, m, n, splits, stream);
}

// c = epi(A @ B) with A [m, k] and B [k, n] on `stream`, operands rounded
// to bf16 when Bf16, else in 3xTF32, on the tile of tc_plan; `st` holds
// the call's staged copies (the Hopper tile's operands), `partial`,
// `partial_floats` floats of scratch, lets a product with few tiles split
// k (null: it does not). Returns the first error.
template <bool Bf16, class A, class B, class Epi>
cudaError_t gemm_splitk(Staging& st, A a, B b, Epi epi, int m, int n, int k, float* partial,
                        size_t partial_floats, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  const size_t room = partial != nullptr ? partial_floats / ((size_t)m * n) : 0;
  const Plan p = tc_plan(m, n, k, room, Bf16);
  if (p.wg) return run_wg<Bf16>(st, a, b, epi, m, n, k, p, partial, stream);
  if (p.big) return launch<BigTile, Bf16>(a, b, epi, m, n, k, k, 1, stream);
  if (p.splits == 1) return launch<SmallTile, Bf16>(a, b, epi, m, n, k, k, 1, stream);
  cudaError_t err = launch<SmallTile, Bf16>(a, b, Partial{partial, m, n}, m, n, k, p.kslice,
                                            p.splits, stream);
  if (err != cudaSuccess) return err;
  return sum_slices(partial, epi, m, n, p.splits, stream);
}

template <bool Bf16, class A, class B, class Epi>
cudaError_t gemm(Staging& st, A a, B b, Epi epi, int m, int n, int k, cudaStream_t stream) {
  return gemm_splitk<Bf16>(st, a, b, epi, m, n, k, nullptr, 0, stream);
}

}  // namespace tc
}  // namespace vmlmf
