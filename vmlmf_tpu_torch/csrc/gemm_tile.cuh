// Tiled f32 GEMM shared by the scan kernels, for sm_90a.
//
//   c(i, j) = epilogue(i, j, sum_k A(i, k) * B(k, j))
//
// A and B are operand views: small structs that return one element of a
// logical matrix and say which of its two indices runs along memory. The
// views cover plain row-major operands, transposed ones (so a product with
// W^T needs no transposed copy of W), and the "previous rows" view of the
// backward pass, which reads row m of [h0; ys[0..T-2]] straight from h0 and
// ys. The tile loads pick the thread-to-element map that keeps neighbouring
// threads on neighbouring addresses for either layout. The masked views read
// a layer input of the wavefront stack, y times its dropout mask, in place.
// `bf16_if<true>` wraps a view so that it rounds each element to bf16 as it
// loads it: the operands of the bf16 variants' products, which sum in f32.
//
// Each CTA computes one 64x64 output tile with 256 threads, 4x4 outputs per
// thread, staging 16-deep slices of A and B in shared memory. Every edge is
// masked, so no dimension needs to be a multiple of a tile. `gemm` does not
// split k: a weight gradient, whose k runs over all T*B rows, is summed by
// one CTA per output tile in a fixed order, so it is deterministic.
// `gemm_splitk` cuts k into slices for a product with few output tiles and
// a long k (the wavefront stack's block projections, which sit on its
// serial chain): one CTA per tile and slice writes a partial sum, then a
// second kernel adds the slices in a fixed order and applies the epilogue,
// so it is deterministic too. This is CUDA-core f32 (no tensor cores),
// simple first.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vmlmf {

// v rounded to the nearest bf16 (ties to even) and widened back to f32, as
// jnp's astype(bfloat16) and torch's .bfloat16() round.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A value written to a buffer whose only readers are products (the scans'
// exchange buffers, the stack's shared operands): rounded to bf16 in the
// bf16 variants, as itself in f32.
template <bool Bf16>
__device__ __forceinline__ float exchanged(float v) {
  if constexpr (Bf16) return round_bf16(v);
  return v;
}

constexpr int kTile = 64;        // output tile, rows and columns
constexpr int kDepth = 16;       // k-slice staged in shared memory
constexpr int kGemmThreads = 256;

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Element (i, j) = p[i * ld + j]: contiguous along j.
struct RowMajor {
  const float* p;
  int ld;
  static constexpr bool kContigJ = true;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return p[(size_t)i * ld + j];
  }
};

// Element (i, j) = p[j * ld + i]: the transpose of a row-major matrix,
// contiguous along i.
struct Transposed {
  const float* p;
  int ld;
  static constexpr bool kContigJ = false;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return p[(size_t)j * ld + i];
  }
};

// The "previous rows" matrix P [M, ld], whose row m is first[m] for m <
// nfirst and rest[m - nfirst] after: with first = h0 [B, h] and rest = ys
// [T, B, h] it is h_prev over all T*B rows, read in place. Contiguous along j.
struct PrevRows {
  const float* first;
  const float* rest;
  int nfirst;
  int ld;
  static constexpr bool kContigJ = true;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return i < nfirst ? first[(size_t)i * ld + j] : rest[(size_t)(i - nfirst) * ld + j];
  }
};

// The transpose of the "previous rows" matrix P [M, ld], whose row m is
// first[m] for m < nfirst and rest[m - nfirst] after: element (i, j) =
// P[j, i]. With first = h0 [B, h] and rest = ys [T, B, h] it is h_prev^T
// over all T*B rows, read in place.
struct PrevRowsT {
  const float* first;
  const float* rest;
  int nfirst;
  int ld;
  static constexpr bool kContigJ = false;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return j < nfirst ? first[(size_t)j * ld + i] : rest[(size_t)(j - nfirst) * ld + i];
  }
};

// Element (i, j) = y[i * ld + j] * mask[i * ld + j], or y[...] when mask is
// null: the wavefront stack's layer input, the output of the layer below
// times its dropout mask, read in place. Contiguous along j.
struct MaskedRows {
  const float* y;
  const float* mask;
  int ld;
  static constexpr bool kContigJ = true;
  __device__ __forceinline__ float operator()(int i, int j) const {
    const size_t e = (size_t)i * ld + j;
    return mask != nullptr ? y[e] * mask[e] : y[e];
  }
};

// The transpose of MaskedRows: element (i, j) = y[j * ld + i] * mask[...].
struct MaskedRowsT {
  const float* y;
  const float* mask;
  int ld;
  static constexpr bool kContigJ = false;
  __device__ __forceinline__ float operator()(int i, int j) const {
    const size_t e = (size_t)j * ld + i;
    return mask != nullptr ? y[e] * mask[e] : y[e];
  }
};

// A view whose elements are those of V rounded to bf16.
template <class V>
struct Bf16Rounded {
  V v;
  static constexpr bool kContigJ = V::kContigJ;
  __device__ __forceinline__ float operator()(int i, int j) const { return round_bf16(v(i, j)); }
};

// The view V, rounded to bf16 on load when On.
template <bool On, class V>
inline auto bf16_if(V v) {
  if constexpr (On) {
    return Bf16Rounded<V>{v};
  } else {
    return v;
  }
}

// Epilogue that stores the sum: c[i * ldc + j] = v.
struct Store {
  float* c;
  int ldc;
  __device__ __forceinline__ void operator()(int i, int j, float v) const {
    c[(size_t)i * ldc + j] = v;
  }
};

// Epilogue of a split-k slice: the partial sum of slice blockIdx.z goes to
// partial[(z * m + i) * n + j].
struct Partial {
  float* partial;
  int m, n;
  __device__ __forceinline__ void operator()(int i, int j, float v) const {
    partial[((size_t)blockIdx.z * m + i) * n + j] = v;
  }
};

// Output tile (blockIdx.y, blockIdx.x) over the k slice [z * kslice, (z +
// 1) * kslice) of z = blockIdx.z (kslice = k: all of k).
template <class A, class B, class Epi>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(A a, B b, Epi epi, int m, int n, int k, int kslice) {
  __shared__ float as[kDepth][kTile + 1];
  __shared__ float bs[kDepth][kTile + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const int kb = blockIdx.z * kslice, ke = min(k, kb + kslice);
  float acc[4][4] = {};
  for (int k0 = kb; k0 < ke; k0 += kDepth) {
    for (int e = threadIdx.x; e < kTile * kDepth; e += kGemmThreads) {
      const int r = A::kContigJ ? e / kDepth : e % kTile;
      const int kk = A::kContigJ ? e % kDepth : e / kTile;
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < ke) ? a(gr, gk) : 0.f;
    }
    for (int e = threadIdx.x; e < kTile * kDepth; e += kGemmThreads) {
      const int kk = B::kContigJ ? e / kTile : e % kDepth;
      const int cc = B::kContigJ ? e % kTile : e / kDepth;
      const int gk = k0 + kk, gc = col0 + cc;
      bs[kk][cc] = (gk < ke && gc < n) ? b(gk, gc) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = row0 + ty + 16 * i, gc = col0 + tx + 16 * j;
      if (gr < m && gc < n) epi(gr, gc, acc[i][j]);
    }
  }
}

// c(i, j) = epi(i, j, sum over z of partial[z, i, j]), z in order.
template <class Epi>
__global__ void __launch_bounds__(kGemmThreads)
splitk_sum_kernel(const float* __restrict__ partial, Epi epi, int m, int n, int splits) {
  const size_t e = (size_t)blockIdx.x * kGemmThreads + threadIdx.x;
  const size_t mn = (size_t)m * n;
  if (e >= mn) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += partial[z * mn + e];
  epi(static_cast<int>(e / n), static_cast<int>(e % n), v);
}

// Launches c = epi(A @ B) with A [m, k] and B [k, n] on `stream`; returns
// cudaGetLastError().
template <class A, class B, class Epi>
cudaError_t gemm(A a, B b, Epi epi, int m, int n, int k, cudaStream_t stream) {
  gemm_kernel<<<dim3(cdiv(n, kTile), cdiv(m, kTile)), kGemmThreads, 0, stream>>>(
      a, b, epi, m, n, k, k);
  return cudaGetLastError();
}

constexpr int kSplitTarget = 264;  // CTAs a split-k product aims at: two per SM

// `gemm` with k cut into slices of whole kDepth steps, so that the tiles
// times the slices come near kSplitTarget CTAs; `partial` is scratch of
// `partial_floats` floats, which bounds the slices at partial_floats / (m n).
// With one slice it is `gemm`. Returns the first error.
template <class A, class B, class Epi>
cudaError_t gemm_splitk(A a, B b, Epi epi, int m, int n, int k, float* partial,
                        size_t partial_floats, cudaStream_t stream) {
  const int tiles = cdiv(n, kTile) * cdiv(m, kTile);
  const size_t room = partial_floats / ((size_t)m * n);
  int splits = cdiv(kSplitTarget, tiles);
  if ((size_t)splits > room) splits = static_cast<int>(room);
  const int kslice = cdiv(cdiv(k, splits > 1 ? splits : 1), kDepth) * kDepth;
  splits = cdiv(k, kslice);
  if (splits <= 1) return gemm(a, b, epi, m, n, k, stream);
  gemm_kernel<<<dim3(cdiv(n, kTile), cdiv(m, kTile), splits), kGemmThreads, 0, stream>>>(
      a, b, Partial{partial, m, n}, m, n, k, kslice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t mn = (size_t)m * n;
  splitk_sum_kernel<<<static_cast<unsigned>((mn + kGemmThreads - 1) / kGemmThreads),
                      kGemmThreads, 0, stream>>>(partial, epi, m, n, splits);
  return cudaGetLastError();
}

}  // namespace vmlmf
