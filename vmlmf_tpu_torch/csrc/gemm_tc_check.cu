// A check of gemm_tc.cuh on its own, for the tests: c = A @ B through the
// tensor-core tiles at each operand view the LSTM scan kernels give them,
// so a test can hold a tile to a float64 product without a scan around it;
// and the bf16 cast pass of the Hopper tile's staged copies on its own.
// Replaces no TPU kernel.
//
// a_kind selects A's view: 0 RowMajor (a0 [m, lda]), 1 Transposed (a0
// [k, lda] read as its transpose), 2 PrevRows (rows of a0 [nfirst, lda]
// then of a1), 3 PrevRowsT (the transpose of that), 4 the wavefront
// stack's masked layer input read as its transpose: X = a0 * a1 (y and its
// mask, [k, lda] each), written into the start of the stage by
// Staging::masked as lstm_stack_bwd.cu's weight gradients write it, then
// read as Transposed{X, lda} by either tile; b_kind 0 RowMajor (b0 [k,
// ldb]) or 1 Transposed (b0 [n, ldb]). bf16 1 takes bf16 products,
// else 3xTF32. partial, partial_floats floats (null: none) lets a product
// with few tiles split k, as in the scans; stage, stage_floats floats hold
// the Hopper tile's staged operands. tile 0 takes the plan's tile
// (tc_plan); 1 forces the Ampere 128x128 tile and 2 its 64x64 one,
// unsplit; 3 forces the Hopper tile, split by its own plan (wg_plan); 4
// the Ampere tile, split by its own plan (mma_plan). flush > 0 sets the
// Hopper tile's stages a chunk of its bf16 two-level sum (0: kFlush).

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
  size_t partial_floats;
  float* stage;
  size_t stage_floats;
  int tile, flush;
  cudaStream_t stream;
};

template <bool Bf16, class A, class B>
cudaError_t run(A a, B b, const Call& x) {
  float* c = x.c;
  const int m = x.m, n = x.n, k = x.k;
  cudaStream_t stream = x.stream;
  vmlmf::tc::Staging st(x.stage, x.stage_floats);
  if (x.tile == 1)
    return vmlmf::tc::launch<vmlmf::tc::BigTile, Bf16>(a, b, Store{c, n}, m, n, k, k, 1, stream);
  if (x.tile == 2)
    return vmlmf::tc::launch<vmlmf::tc::SmallTile, Bf16>(a, b, Store{c, n}, m, n, k, k, 1,
                                                         stream);
  if (x.tile == 4) {  // the Ampere tile by its own plan, split-k and all
    const size_t room = x.partial != nullptr ? x.partial_floats / ((size_t)m * n) : 0;
    const vmlmf::tc::Plan p = vmlmf::tc::mma_plan(m, n, k, room);
    if (p.big) return vmlmf::tc::launch<vmlmf::tc::BigTile, Bf16>(a, b, Store{c, n}, m, n, k, k,
                                                                  1, stream);
    if (p.splits == 1)
      return vmlmf::tc::launch<vmlmf::tc::SmallTile, Bf16>(a, b, Store{c, n}, m, n, k, k, 1,
                                                           stream);
    cudaError_t err = vmlmf::tc::launch<vmlmf::tc::SmallTile, Bf16>(
        a, b, vmlmf::Partial{x.partial, m, n}, m, n, k, p.kslice, p.splits, stream);
    if (err != cudaSuccess) return err;
    return vmlmf::tc::sum_slices(x.partial, Store{c, n}, m, n, p.splits, stream);
  }
  if (x.tile == 3) {
    if (k <= 0) return cudaErrorInvalidValue;
    const size_t room = x.partial != nullptr ? x.partial_floats / ((size_t)m * n) : 0;
    return vmlmf::tc::run_wg<Bf16>(st, a, b, Store{c, n}, m, n, k,
                                   vmlmf::tc::wg_plan(m, n, k, room, Bf16), x.partial, stream,
                                   x.flush > 0 ? x.flush : vmlmf::tc::wg::Cfg<Bf16>::kFlush);
  }
  return vmlmf::tc::gemm_splitk<Bf16>(st, a, b, Store{c, n}, m, n, k, x.partial,
                                      x.partial_floats, stream);
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
    case 4: {
      vmlmf::tc::Staging st(x.stage, x.stage_floats);
      cudaError_t err = cudaSuccess;
      const float* xm = st.masked(a0, a1, (size_t)x.k * lda, x.stream, err);
      if (err != cudaSuccess) return err;
      Call rest = x;  // the product stages after X, as in the stack
      rest.stage += st.used / sizeof(float);
      rest.stage_floats -= st.used / sizeof(float);
      return run<Bf16>(Transposed{xm, lda}, RowMajor{b0, ldb}, rest);
    }
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int gemm_tc_check(int a_kind, int b_kind, const float* a0, const float* a1, int nfirst,
                             int lda, const float* b0, int ldb, float* c, int m, int n, int k,
                             float* partial, float* stage, int partial_floats, int stage_floats,
                             int bf16, int tile, int flush, void* stream_handle) {
  if (tile < 0 || tile > 4 || m <= 0 || n <= 0) return cudaErrorInvalidValue;
  const Call x{c, m, n, k, partial, static_cast<size_t>(partial_floats), stage,
               static_cast<size_t>(stage_floats), tile, flush,
               static_cast<cudaStream_t>(stream_handle)};
  return bf16 ? check<true>(a_kind, b_kind, a0, a1, nfirst, lda, b0, ldb, x)
              : check<false>(a_kind, b_kind, a0, a1, nfirst, lda, b0, ldb, x);
}

// dst [rows, ld] (bf16, ld a multiple of 8) = the rows [rows, cols] of src
// (row stride src_ld) rounded by the Hopper tile's cast pass.
extern "C" int gemm_tc_cast_check(const float* src, int src_ld, void* dst, int rows, int cols,
                                  int ld, void* stream_handle) {
  if (rows <= 0 || cols <= 0 || ld < cols || ld % 8) return cudaErrorInvalidValue;
  const size_t work = (size_t)rows * (ld / 8);
  vmlmf::tc::wg::cast_bf16_kernel<<<static_cast<unsigned>(std::min<size_t>((work + 255) / 256,
                                                                            8192)),
                                    256, 0, static_cast<cudaStream_t>(stream_handle)>>>(
      vmlmf::tc::wg::Source{src, nullptr, INT_MAX, src_ld}, static_cast<__nv_bfloat16*>(dst), rows,
      cols, ld);
  return cudaGetLastError();
}

// out[0..3] = tc_plan(m, n, k, room, bf16): wg, big, splits, kslice.
extern "C" int gemm_tc_plan(int m, int n, int k, int room, int bf16, int* out) {
  if (m <= 0 || n <= 0 || room < 0) return cudaErrorInvalidValue;
  const vmlmf::tc::Plan p = vmlmf::tc::tc_plan(m, n, k, static_cast<size_t>(room), bf16 != 0);
  out[0] = p.wg, out[1] = p.big, out[2] = p.splits, out[3] = p.kslice;
  return 0;
}

// The message of an error code that gemm_tc_check returned.
extern "C" const char* gemm_tc_check_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
