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
// threads on neighbouring addresses for either layout. `MaskedRows` reads a
// layer input of the wavefront stack, y times its dropout mask, in place.
//
// Each CTA computes one 64x64 output tile with 256 threads, 4x4 outputs per
// thread, staging 16-deep slices of A and B in shared memory. Every edge is
// masked, so no dimension needs to be a multiple of a tile. `gemm` does not
// split k: a product is summed by one CTA per output tile in a fixed order,
// so it is deterministic. `gemm_splitk_group` cuts k into slices for
// several independent products in two launches, with one slice length for
// all (the GRU BPTT's gradients): one CTA per tile and slice writes a
// partial sum, then a second kernel adds the slices in a fixed order and
// applies the epilogue, so it is deterministic too. This is CUDA-core f32
// (no tensor cores), simple first.

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

// Epilogue of a slice of a grouped split-k product: the partial sum of
// slice z goes to partial[(z * m + i) * n + j].
struct SlicePartial {
  float* partial;
  int m, n, z;
  __device__ __forceinline__ void operator()(int i, int j, float v) const {
    partial[((size_t)z * m + i) * n + j] = v;
  }
};

// The output tile at (row0, col0) of A @ B over k in [kb, ke), staged
// through the CTA's as and bs.
template <class A, class B, class Epi>
__device__ __forceinline__ void tile_product(const A& a, const B& b, const Epi& epi, int m,
                                             int n, int kb, int ke, int row0, int col0,
                                             float (*as)[kTile + 1], float (*bs)[kTile + 1]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
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

// Output tile (blockIdx.y, blockIdx.x) over the k slice [z * kslice, (z +
// 1) * kslice) of z = blockIdx.z (kslice = k: all of k).
template <class A, class B, class Epi>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(A a, B b, Epi epi, int m, int n, int k, int kslice) {
  __shared__ float as[kDepth][kTile + 1];
  __shared__ float bs[kDepth][kTile + 1];
  const int kb = blockIdx.z * kslice;
  tile_product(a, b, epi, m, n, kb, min(k, kb + kslice), blockIdx.y * kTile, blockIdx.x * kTile,
               as, bs);
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

// One product of a grouped split-k: c = epi(A @ B), A [m, k], B [k, n];
// gemm_splitk_group sets its slices and its region of the scratch.
template <class A, class B, class Epi>
struct SplitProduct {
  A a;
  B b;
  Epi epi;
  int m, n, k;
  int splits, kslice;
  float* partial;
};

template <class A, class B, class Epi>
SplitProduct<A, B, Epi> split_product(A a, B b, Epi epi, int m, int n, int k) {
  return SplitProduct<A, B, Epi>{a, b, epi, m, n, k, 1, k, nullptr};
}

// Runs CTA `cta` of product p's tiles times slices if it is p's, else
// counts p's CTAs off `cta`; true when it ran.
template <class P>
__device__ __forceinline__ bool group_partial(const P& p, int& cta, float (*as)[kTile + 1],
                                              float (*bs)[kTile + 1]) {
  const int tiles_n = (p.n + kTile - 1) / kTile;
  const int tiles = tiles_n * ((p.m + kTile - 1) / kTile);
  if (cta >= tiles * p.splits) {
    cta -= tiles * p.splits;
    return false;
  }
  const int z = cta / tiles, tile = cta % tiles, kb = z * p.kslice;
  tile_product(p.a, p.b, SlicePartial{p.partial, p.m, p.n, z}, p.m, p.n, kb,
               min(p.k, kb + p.kslice), (tile / tiles_n) * kTile, (tile % tiles_n) * kTile, as,
               bs);
  return true;
}

// Output element e of product p, the sum of its slices in order, through
// its epilogue; else counts p's elements off e.
template <class P>
__device__ __forceinline__ bool group_sum(const P& p, size_t& e) {
  const size_t mn = (size_t)p.m * p.n;
  if (e >= mn) {
    e -= mn;
    return false;
  }
  // four loads in flight at a time, added in slice order
  const float* at = p.partial + e;
  float v = 0.f;
  int z = 0;
  for (; z + 4 <= p.splits; z += 4) {
    const float a0 = at[z * mn], a1 = at[(z + 1) * mn], a2 = at[(z + 2) * mn],
                a3 = at[(z + 3) * mn];
    v += a0;
    v += a1;
    v += a2;
    v += a3;
  }
  for (; z < p.splits; ++z) v += at[z * mn];
  p.epi(static_cast<int>(e / p.n), static_cast<int>(e % p.n), v);
  return true;
}

template <class... P>
__global__ void __launch_bounds__(kGemmThreads) group_partial_kernel(P... ps) {
  __shared__ float as[kDepth][kTile + 1];
  __shared__ float bs[kDepth][kTile + 1];
  int cta = blockIdx.x;
  (group_partial(ps, cta, as, bs) || ...);
}

template <class... P>
__global__ void __launch_bounds__(kGemmThreads) group_sum_kernel(P... ps) {
  size_t e = (size_t)blockIdx.x * kGemmThreads + threadIdx.x;
  (group_sum(ps, e) || ...);
}

constexpr int kGroupTarget = 2 * kSplitTarget;  // CTAs a grouped split-k aims at

template <class P>
int product_tiles(const P& p) {
  return cdiv(p.n, kTile) * cdiv(p.m, kTile);
}

// The slice length of a grouped split-k over these products: one length
// for all, whole kDepth steps, so that their tiles times slices come near
// kGroupTarget CTAs (a CTA's time is its k-loop).
template <class... P>
int group_kslice(const P&... ps) {
  size_t work = 0;
  ((work += (size_t)product_tiles(ps) * ps.k), ...);
  const size_t per_cta = (work + kGroupTarget - 1) / kGroupTarget;
  return static_cast<int>((per_cta + kDepth - 1) / kDepth) * kDepth;
}

// Several independent products in two launches: every slice of every
// product, each cut into slices of `kslice` rows of k (group_kslice),
// then every output's sum of its slices in a fixed order through its
// epilogue; deterministic, no atomics. Each product takes the next region
// of `partial`, splits * m * n floats, so the group needs the sum of its
// regions (ops/cuda_gru.py::gru_bwd_partial_floats): less is refused.
// Returns the first error.
template <class... P>
cudaError_t gemm_splitk_group(float* partial, size_t partial_floats, int kslice,
                              cudaStream_t stream, P... ps) {
  size_t used = 0, outs = 0;
  int ctas = 0;
  auto plan = [&](auto& p) {
    p.kslice = kslice;
    p.splits = cdiv(p.k, kslice);
    p.partial = partial + used;
    used += (size_t)p.splits * p.m * p.n;
    outs += (size_t)p.m * p.n;
    ctas += product_tiles(p) * p.splits;
  };
  (plan(ps), ...);
  if (used > partial_floats) return cudaErrorInvalidValue;
  if (ctas == 0) return cudaSuccess;  // every product taken elsewhere (m = 0)
  group_partial_kernel<<<ctas, kGemmThreads, 0, stream>>>(ps...);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  group_sum_kernel<<<static_cast<unsigned>((outs + kGemmThreads - 1) / kGemmThreads),
                     kGemmThreads, 0, stream>>>(ps...);
  return cudaGetLastError();
}

}  // namespace vmlmf
