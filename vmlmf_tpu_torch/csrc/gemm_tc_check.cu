// A check of gemm_tc.cuh on its own, for the tests: c = A @ B through the
// tensor-core tile at each operand view the LSTM scan kernels give it, so a
// test can hold the tile to a float64 product without a scan around it.
// Replaces no TPU kernel.
//
// a_kind selects A's view: 0 RowMajor (a0 [m, lda]), 1 Transposed (a0
// [k, lda] read as its transpose), 2 PrevRows (rows of a0 [nfirst, lda]
// then of a1), 3 PrevRowsT (the transpose of that); b_kind 0 RowMajor (b0
// [k, ldb]) or 1 Transposed (b0 [n, ldb]). bf16 1 takes the bf16 mma,
// else 3xTF32. partial, partial_floats floats (null: none) lets a product
// with few tiles split k, as in the scans. tile 0 takes the plan's tile
// (tc_plan); 1 forces the 128x128 tile and 2 the 64x64 one, unsplit.

#include <cuda_runtime.h>

#include "gemm_tc.cuh"

namespace {

using vmlmf::PrevRows;
using vmlmf::PrevRowsT;
using vmlmf::RowMajor;
using vmlmf::Store;
using vmlmf::Transposed;

// The arguments after the views, as gemm_tc_check takes them.
struct Call {
  float* c;
  int m, n, k;
  float* partial;
  size_t room;
  int tile;
  cudaStream_t stream;
};

template <bool Bf16, class A, class B>
cudaError_t run(A a, B b, const Call& x) {
  float* c = x.c;
  const int m = x.m, n = x.n, k = x.k;
  cudaStream_t stream = x.stream;
  if (x.tile == 1)
    return vmlmf::tc::launch<vmlmf::tc::BigTile, Bf16>(a, b, Store{c, n}, m, n, k, k, 1, stream);
  if (x.tile == 2)
    return vmlmf::tc::launch<vmlmf::tc::SmallTile, Bf16>(a, b, Store{c, n}, m, n, k, k, 1,
                                                         stream);
  return vmlmf::tc::gemm_splitk<Bf16>(a, b, Store{c, n}, m, n, k, x.partial, x.room, stream);
}

template <bool Bf16, class A>
cudaError_t with_b(A a, int b_kind, const float* b0, int ldb, const Call& x) {
  if (b_kind == 0) return run<Bf16>(a, RowMajor{b0, ldb}, x);
  if (b_kind == 1) return run<Bf16>(a, Transposed{b0, ldb}, x);
  return cudaErrorInvalidValue;
}

template <bool Bf16>
cudaError_t check(int a_kind, int b_kind, const float* a0, const float* a1, int nfirst, int lda,
                  const float* b0, int ldb, const Call& x) {
  if (a_kind == 0) return with_b<Bf16>(RowMajor{a0, lda}, b_kind, b0, ldb, x);
  if (b_kind != 0) return cudaErrorInvalidValue;  // as in the scans' weight gradients
  switch (a_kind) {
    case 1: return run<Bf16>(Transposed{a0, lda}, RowMajor{b0, ldb}, x);
    case 2: return run<Bf16>(PrevRows{a0, a1, nfirst, lda}, RowMajor{b0, ldb}, x);
    case 3: return run<Bf16>(PrevRowsT{a0, a1, nfirst, lda}, RowMajor{b0, ldb}, x);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int gemm_tc_check(int a_kind, int b_kind, const float* a0, const float* a1, int nfirst,
                             int lda, const float* b0, int ldb, float* c, int m, int n, int k,
                             float* partial, int partial_floats, int bf16, int tile,
                             void* stream_handle) {
  if (tile < 0 || tile > 2 || m <= 0 || n <= 0) return cudaErrorInvalidValue;
  const Call x{c, m, n, k, partial, static_cast<size_t>(partial_floats), tile,
               static_cast<cudaStream_t>(stream_handle)};
  return bf16 ? check<true>(a_kind, b_kind, a0, a1, nfirst, lda, b0, ldb, x)
              : check<false>(a_kind, b_kind, a0, a1, nfirst, lda, b0, ldb, x);
}

// The message of an error code that gemm_tc_check returned.
extern "C" const char* gemm_tc_check_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
