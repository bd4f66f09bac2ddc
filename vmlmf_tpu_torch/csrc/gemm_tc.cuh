// Tensor-core GEMM of the LSTM scan kernels' time-parallel products, for
// sm_90a.
//
//   c(i, j) = epilogue(i, j, sum_k A(i, k) * B(k, j))
//
// Replaces, in lstm_scan_xin_fwd.cu and lstm_scan_xin_bwd.cu, the CUDA-core
// tile of gemm_tile.cuh (which the GRU and stack kernels keep). It takes the
// same operand views (RowMajor, Transposed, PrevRows, PrevRowsT) and the same
// epilogue functors (Store, GiEpilogue, GatesEpilogue, DxEpilogue, Partial),
// and its products are those of the scans' x-side projection, the recompute
// pre-pass and the BPTT's weight and x-side gradients: products with
// thousands of output tiles (at a dense h=1500) or a few tiles and a long k
// (the HAR layer's dU [180, 6] over k = 1944).
//
// What bounds these products on an H100 is arithmetic: each operand element
// is used by a whole tile row or column, and f32 on the CUDA cores peaks at
// 67 TFLOP/s. So they run on the tensor cores with mma.sync:
// * f32 as error-compensated 3xTF32: each operand value a splits into hi =
//   tf32(a) and lo = tf32(a - hi) (round to nearest), and a product is
//   lo*hi + hi*lo + hi*hi, each an m16n8k8 TF32 mma with f32 sums, the small
//   terms first. The lost lo*lo term and lo's rounding are below 2^-21 of a
//   term, so a product keeps about f32's precision at three TF32 passes.
//   The mma adds to its accumulator rounding toward zero, a bias that would
//   grow with k (about 1e-5 of the output at k = 1500, measured), so each
//   k-step's three mmas sum from zero and join the running sum by an f32
//   add, rounded to nearest (bf16: the sum of every fourth stage's mmas).
// * bf16 (the bf16 variants, whose products take bf16-rounded operands and
//   sum in f32): one m16n8k16 bf16 mma with f32 sums. The operands are
//   rounded to nearest even as a fragment is read from shared memory, the
//   value that gemm_tile.cuh's bf16_if gives; only the order of the sums
//   differs.
// Staging: a ring of kStages k-slices of A and B in shared memory, filled
// with cp.async while the warps work on the slice before. Each operand is
// staged along its view's contiguous index, so neighbouring threads copy
// neighbouring addresses: runs of four elements, one 16-byte copy where the
// run is 16-byte aligned (a partial run at an edge copies only its valid
// bytes and zero-fills the rest), else four 4-byte copies (rows of odd
// length, as at h=650). A run never straddles the seam of a PrevRows view,
// which lies between rows. Element (mn, kk) of a stage sits at mn * ld + kk
// along k or kk * ld + mn along m/n, with ld padded so that the fragment
// loads of a warp fall in distinct banks (ld = 4 or 8 mod 32, by layout and
// precision).
// Tiles: a CTA of 8 warps computes 128x128 outputs (warps of 64x32), or
// one of 4 warps 64x64 (warps of 32x32), whichever gives the busiest SM
// the least work (tc_plan): the large tile at the large products unless
// its last wave runs mostly empty. A small-tile product with fewer than
// kSplitTarget tiles cuts k into slices of whole kK steps until tiles times
// slices come near kSplitTarget CTAs, bounded by the scratch it is given;
// each slice writes a partial sum and a second kernel adds the slices in a
// fixed order through the epilogue (ops/cuda_scan.py::_splitk_floats
// mirrors the slices). Every sum is taken in a fixed order, with no
// atomics, so two equal calls give equal bits. The epilogue reads the tile
// back from shared memory along rows, so its stores are coalesced. Every
// edge is masked: no dimension needs to be a multiple of a tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

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

// c(i, j) = epi(i, j, sum over z of partial[z, i, j]), z in order.
template <class Epi>
__global__ void __launch_bounds__(256)
tc_sum_kernel(const float* __restrict__ partial, Epi epi, int m, int n, int splits) {
  const size_t e = (size_t)blockIdx.x * 256 + threadIdx.x;
  const size_t mn = (size_t)m * n;
  if (e >= mn) return;
  const float* at = partial + e;
  float v = 0.f;
  int z = 0;
  for (; z + 4 <= splits; z += 4) {  // four loads in flight, added in order
    const float a0 = at[z * mn], a1 = at[(z + 1) * mn], a2 = at[(z + 2) * mn],
                a3 = at[(z + 3) * mn];
    v += a0;
    v += a1;
    v += a2;
    v += a3;
  }
  for (; z < splits; ++z) v += at[z * mn];
  epi(static_cast<int>(e / n), static_cast<int>(e % n), v);
}

// The tile and k slices of a product c [m, n] over k, given room for
// `room` slices of partial sums (ops/cuda_scan.py::_splitk_floats).
struct Plan {
  bool big;
  int splits, kslice;
};

inline Plan tc_plan(int m, int n, int k, size_t room) {
  // the tile that gives the busiest SM the least work: a 128x128 CTA does
  // four 64x64 ones' work, 1.16 times as fast (at dense h=1500 on the H100)
  const int big = cdiv(m, BigTile::kBM) * cdiv(n, BigTile::kBN);
  const int small = cdiv(m, SmallTile::kBM) * cdiv(n, SmallTile::kBN);
  if (400 * cdiv(big, kWave) < 116 * cdiv(small, kWave)) return Plan{true, 1, k};
  if (k <= 0) return Plan{false, 1, k};
  int splits = cdiv(kSplitTarget, small);
  if ((size_t)splits > room) splits = static_cast<int>(room);
  const int kslice = cdiv(cdiv(k, splits > 1 ? splits : 1), kK) * kK;
  splits = cdiv(k, kslice);
  return splits > 1 ? Plan{false, splits, kslice} : Plan{false, 1, k};
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

// c = epi(A @ B) with A [m, k] and B [k, n] on `stream`, operands rounded
// to bf16 when Bf16, else in 3xTF32; `partial`, `partial_floats` floats of
// scratch, lets a product with few tiles split k (null: it does not).
// Returns the first error.
template <bool Bf16, class A, class B, class Epi>
cudaError_t gemm_splitk(A a, B b, Epi epi, int m, int n, int k, float* partial,
                        size_t partial_floats, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  const size_t room = partial != nullptr ? partial_floats / ((size_t)m * n) : 0;
  const Plan p = tc_plan(m, n, k, room);
  if (p.big) return launch<BigTile, Bf16>(a, b, epi, m, n, k, k, 1, stream);
  if (p.splits == 1) return launch<SmallTile, Bf16>(a, b, epi, m, n, k, k, 1, stream);
  cudaError_t err = launch<SmallTile, Bf16>(a, b, Partial{partial, m, n}, m, n, k, p.kslice,
                                            p.splits, stream);
  if (err != cudaSuccess) return err;
  const size_t mn = (size_t)m * n;
  tc_sum_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(partial, epi, m, n,
                                                                             p.splits);
  return cudaGetLastError();
}

template <bool Bf16, class A, class B, class Epi>
cudaError_t gemm(A a, B b, Epi epi, int m, int n, int k, cudaStream_t stream) {
  return gemm_splitk<Bf16>(a, b, epi, m, n, k, nullptr, 0, stream);
}

}  // namespace tc
}  // namespace vmlmf
