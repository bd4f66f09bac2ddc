// Pieces shared by the GRU scan kernels (gru_scan_xin_fwd.cu and
// gru_scan_xin_bwd.cu), for sm_90a: the layout that
// ops/cuda_gru.py::gru_plan decides, the thread map of a step, the weight
// views, and the product of a CTA's rows with a weight matrix split over
// the depth.
//
// One CTA owns `rows` (at most kMaxRows) consecutive batch rows and walks
// all T steps. Its threads form groups of kSlices lanes, one group per
// output unit of a product (a hidden unit j, or a rank column k): lane
// l of warp w serves unit w * 8 + l % 8 of a pass and depth slice l / 8,
// so that the eight lanes of a quarter warp, which share a slice, read
// eight neighbouring float4s of a weight and one broadcast float4 of the
// rows. Each lane sums its slice of the depth in a fixed order, and two
// xor shuffles add the four slices; every lane of the group then holds the
// whole sum of every row, bit for bit the same (a + b == b + a). Lane
// slice s then does the gate arithmetic of row s, so a step's elementwise
// work runs on as many lanes as a product's. A width past the threads'
// units takes more passes.
//
// The weights of the products are held, each lane's share, in registers
// (RegSlice) at the HAR widths; else in shared memory when they fit, else
// read through L2 by the same code: each view returns four depth elements
// of one output unit as a float4, from the shared copy (zero-padded to a
// multiple of four) or from the row-major original in device memory
// (masked at the edge).

#pragma once

#include <cuda_runtime.h>

#include "scan_grid.cuh"

namespace vmlmf {
namespace gru {

constexpr int kSlices = 4;      // depth slices of a unit's product (lanes 8 apart)
constexpr int kMaxRows = 4;     // batch rows of a CTA: one slice lane each in the gate arithmetic

// The kernels' row bound R for a CTA of `rows` rows: 1, 2, or kMaxRows.
__host__ __device__ inline int row_bound(int rows) { return rows <= 2 ? rows : kMaxRows; }
constexpr int kMaxThreads = 512;
constexpr int kLowrankPre = 0, kDensePre = 1, kDensePost = 2;

// n rounded up to a multiple of four floats (one float4)
__host__ __device__ inline int q4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ inline size_t q4s(size_t n) { return (n + 3) / 4 * 4; }

// The row stride of a weight held for products along its rows: a multiple
// of four floats and an odd number of float4s, so that the eight lanes of
// a quarter warp, on eight neighbouring rows, read eight different banks.
__host__ __device__ inline int ldt(int n) {
  const int q = (n + 3) / 4;
  return 4 * (q + 1 - q % 2);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float dot4(float4 a, float4 w, float acc) {
  acc = fmaf(a.x, w.x, acc);
  acc = fmaf(a.y, w.y, acc);
  acc = fmaf(a.z, w.z, acc);
  return fmaf(a.w, w.w, acc);
}

// This thread's place in the unit groups: its unit in a pass, its depth
// slice, and the units a pass covers.
struct Lanes {
  int unit, slice, per_pass;
  __device__ Lanes()
      : unit((threadIdx.x >> 5) * 8 + (threadIdx.x & 7)),
        slice((threadIdx.x & 31) >> 3),
        per_pass(blockDim.x / kSlices) {}
};

// W [k, n] as columns: at(q, c) = W[4q .. 4q+3, c]. The shared copy is
// quad-interleaved, float4 (q, c) at s[q * n + c]; the original is
// row-major in device memory.
struct QuadCols {
  const float* g;
  const float4* s;
  int k, n;
  __device__ __forceinline__ float4 at(int q, int c) const {
    if (s != nullptr) return s[(size_t)q * n + c];
    const int k0 = 4 * q;
    const float* p = g + (size_t)k0 * n + c;
    return make_float4(k0 < k ? __ldg(p) : 0.f, k0 + 1 < k ? __ldg(p + n) : 0.f,
                       k0 + 2 < k ? __ldg(p + 2 * (size_t)n) : 0.f,
                       k0 + 3 < k ? __ldg(p + 3 * (size_t)n) : 0.f);
  }
};

// Copies W [k, n] into its quad-interleaved shared form, rows k .. q4(k)
// zero. The copies are cp.async, all in flight at once (a loop of loads
// would wait on each): the caller waits with cp_async_wait_all, then
// __syncthreads.
__device__ __forceinline__ void stage_cols(float* dst, const float* src, int k, int n) {
  const int total = q4(k) * n;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int kk = i / n, c = i % n;
    float* d = dst + ((size_t)(kk >> 2) * n + c) * 4 + (kk & 3);
    if (kk < k)
      cp_async4(d, src + i);
    else
      *d = 0.f;
  }
}

// W [o, n] as rows: at(o, q) = W[o, 4q .. 4q+3]. The shared copy has row
// stride ld = ldt(n), zero past n; the original is row-major.
struct QuadRows {
  const float* g;
  const float* s;
  int n, ld;
  __device__ __forceinline__ float4 at(int o, int q) const {
    if (s != nullptr) return *reinterpret_cast<const float4*>(s + (size_t)o * ld + 4 * q);
    const int c0 = 4 * q;
    const float* p = g + (size_t)o * n + c0;
    return make_float4(c0 < n ? __ldg(p) : 0.f, c0 + 1 < n ? __ldg(p + 1) : 0.f,
                       c0 + 2 < n ? __ldg(p + 2) : 0.f, c0 + 3 < n ? __ldg(p + 3) : 0.f);
  }
};

// Copies W [o, n] into shared rows of stride ldt(n), zero past n; with
// cp.async, as stage_cols.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int o, int n) {
  const int ld = ldt(n);
  for (int i = threadIdx.x; i < o * ld; i += blockDim.x) {
    const int c = i % ld;
    if (c < n)
      cp_async4(dst + i, src + (size_t)(i / ld) * n + c);
    else
      dst[i] = 0.f;
  }
}

// acc[i][row] += this lane's slice of sum_q src[row, 4q .. 4q+3] . w(i, q)
// over the depth quads q = slice, slice + kSlices, .. < nq, for the CTA's
// live rows; src is shared, row stride lds (a multiple of 4, zero past the
// depth). Warp-uniform: every lane runs it. R, the rows a CTA may hold
// (1, 2 or kMaxRows), is a template argument of the kernels: a row loop
// guarded by a runtime count would execute every row's instructions.
template <int N, int R, class W>
__device__ __forceinline__ void slice_dot(float (&acc)[N][R], const float* src, int lds,
                                          int rows, int nq, int slice, W w) {
  for (int q = slice; q < nq; q += kSlices) {
    float4 wv[N];
#pragma unroll
    for (int i = 0; i < N; ++i) wv[i] = w(i, q);
#pragma unroll
    for (int row = 0; row < R; ++row) {
      if (row < rows) {
        const float4 a = reinterpret_cast<const float4*>(src + (size_t)row * lds)[q];
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i][row] = dot4(a, wv[i], acc[i][row]);
      }
    }
  }
}

// A lane's share of a product's weights, held in registers for the whole
// scan: for each of its N columns (or rows) i, the float4s w(i, q) of its
// depth slice's quads q = slice + kSlices * e, e < Q (zero past nq).
// dot() adds to acc what slice_dot would, in the same order, so the sums
// are bit for bit the same; it reads only the rows from shared memory.
template <int N, int Q>
struct RegSlice {
  float4 w[N][Q];
  template <class W>
  __device__ __forceinline__ void load(int nq, int slice, W at) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int e = 0; e < Q; ++e) {
        const int q = slice + kSlices * e;
        w[i][e] = q < nq ? at(i, q) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
  }
  template <int R>
  __device__ __forceinline__ void dot(float (&acc)[N][R], const float* src, int lds, int rows,
                                      int nq, int slice) const {
#pragma unroll
    for (int e = 0; e < Q; ++e) {
      const int q = slice + kSlices * e;
      if (q < nq) {
#pragma unroll
        for (int row = 0; row < R; ++row) {
          if (row < rows) {
            const float4 a = reinterpret_cast<const float4*>(src + (size_t)row * lds)[q];
#pragma unroll
            for (int i = 0; i < N; ++i) acc[i][row] = dot4(a, w[i][e], acc[i][row]);
          }
        }
      }
    }
  }
};

// Where a kernel keeps its recurrent weights (ops/cuda_gru.py::gru_plan):
// read through L2, staged in shared memory, or each lane's share in
// registers (RegSlice), which the plan takes where h <= kRegH and r <=
// kRegR: then every product has one pass and at most four quads of depth
// h (eight of 2h, one of r) a slice.
constexpr int kInL2 = 0, kInShared = 1, kInRegisters = 2;
constexpr int kRegH = 64, kRegR = 16;

// Adds the kSlices slices of each sum: afterwards every lane of the group
// holds the whole sums, identical in all four.
template <int N, int R>
__device__ __forceinline__ void slice_reduce(float (&acc)[N][R], int rows) {
#pragma unroll
  for (int row = 0; row < R; ++row) {
    if (row < rows) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float v = acc[i][row];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[i][row] = v;
      }
    }
  }
}

// a[i] for a runtime i < R, without indexing registers.
template <int R>
__device__ __forceinline__ float pick(const float (&a)[R], int i) {
  float v = a[0];
#pragma unroll
  for (int k = 1; k < R; ++k)
    if (i == k) v = a[k];
  return v;
}

// Epilogue of the x side's last projection GEMM: g[i, j] = v + bias[j],
// g [M, n].
struct BiasEpilogue {
  float* g;
  const float* bias;
  int n;
  __device__ __forceinline__ void operator()(int i, int j, float v) const {
    g[(size_t)i * n + j] = v + bias[j];
  }
};

// The x side's input projection over all M rows, as tiled f32 GEMMs
// (gemm_tile.cuh): xu = x @ Ux (low-rank x side, vx given) and gi = xu @ Vx
// + bias, or gi = x @ Ux + bias; gi [M, 3h]. Returns the first error.
inline cudaError_t project(const float* x, const float* ux, const float* vx, const float* bias,
                           float* xu, float* gi, int m, int f, int rx, int h,
                           cudaStream_t stream) {
  using vmlmf::RowMajor;
  const int g3 = 3 * h;
  const BiasEpilogue epi{gi, bias, g3};
  if (vx == nullptr) return vmlmf::gemm(RowMajor{x, f}, RowMajor{ux, g3}, epi, m, g3, f, stream);
  const cudaError_t err =
      vmlmf::gemm(RowMajor{x, f}, RowMajor{ux, rx}, vmlmf::Store{xu, rx}, m, rx, f, stream);
  if (err != cudaSuccess) return err;
  return vmlmf::gemm(RowMajor{xu, rx}, RowMajor{vx, g3}, epi, m, g3, rx, stream);
}

// A region of `n` floats at the running offset `at`, rounded to a float4.
__host__ __device__ inline size_t take(size_t& at, size_t n) {
  const size_t start = at;
  at += q4s(n);
  return start;
}

}  // namespace gru
}  // namespace vmlmf
