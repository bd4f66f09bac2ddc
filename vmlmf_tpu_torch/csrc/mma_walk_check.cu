// A check of scan_grid.cuh's bf16 tensor-core product on its own, for the
// tests: out [cols][rpad] = W^T A for W [depth][cols] and A [depth][rpad]
// (f32, rounded to bf16 as the scans' bf16 plans round them), on one CTA
// and its ring, the blocks past `resident` streamed from device memory
// through stages of `piece` floats, so that a test can hold the product to
// a float64 one, and one resident depth and stage size to another, without
// a scan around it; `reps` runs the product that many times over (the same
// sums each time), so that a timing can tell one product from the launch
// and the prologue. Replaces no TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scan_grid.cuh"

namespace {

using vmlmf::bf16;
using vmlmf::GridPlan;

__global__ void __launch_bounds__(vmlmf::kRingThreads, 1)
check_kernel(const float* __restrict__ w, const float* __restrict__ a, float* __restrict__ out,
             bf16* xchg, bf16* wstream, int depth, int cols, int ncols, int reps, GridPlan plan) {
  extern __shared__ __align__(16) float smem[];
  const int rpad = plan.rpad, xld = vmlmf::mma_xld(rpad), d16 = vmlmf::round16(depth);
  const int res = vmlmf::mma_resident(plan.res_b, depth);
  bf16* wres = reinterpret_cast<bf16*>(smem);  // the resident blocks
  float* stage = smem + vmlmf::weight_floats<bf16>((size_t)res * cols);
  float* red = stage + vmlmf::ring_floats(plan);
  for (int e = threadIdx.x; e < d16 * cols; e += blockDim.x) {
    const int d = e / cols, c = e % cols;
    const bf16 v = __float2bfloat16_rn(d < depth ? w[(size_t)d * cols + c] : 0.f);
    const size_t at = vmlmf::mma_at(d, c, cols);
    if (d < res)
      wres[at] = v;
    else
      wstream[at - (size_t)res * cols] = v;
  }
  for (int e = threadIdx.x; e < d16 * xld; e += blockDim.x) {
    const int d = e / xld, row = e % xld;
    xchg[e] = __float2bfloat16_rn(d < depth && row < rpad ? a[(size_t)d * rpad + row] : 0.f);
  }
  __threadfence();
  __syncthreads();
  auto epi = [&](int cb, int rb, float (&acc)[4][4]) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) out[(size_t)(4 * cb + c) * rpad + 4 * rb + i] = acc[c][i];
  };
  vmlmf::Ring ring;
  ring.start(stage, plan);
  for (int rep = 0; rep < reps; ++rep) {
    ring.mma_product(vmlmf::MmaOperand{xchg, wres, wstream, depth, plan.res_b, cols, ncols}, red,
                     epi);
    __syncthreads();
  }
}

}  // namespace

// out [cols][rpad] = W^T A on one CTA: W [depth][cols], A [depth][rpad]
// f32 (rounded to bf16); the ncols first columns of out written. xchg:
// scratch of round16(depth) * mma_xld(rpad) bf16; wstream: scratch of the
// blocks past `resident` rows (a multiple of 16, or the whole depth:
// none, and wstream may be null). piece (a ring stage) and red: floats, as
// scan_plan sizes them; reps >= 1 products in a row.
extern "C" int mma_walk_check(const float* w, const float* a, float* out, void* xchg,
                              void* wstream, int depth, int cols, int ncols, int rpad,
                              int resident, int piece, int red, int reps, void* stream_handle) {
  GridPlan plan{1, 1, rpad, 0, red, 0, 0, resident, piece, 1};
  if (depth < 1 || cols % 4 || ncols % 4 || ncols < 4 || ncols > cols || reps < 1 ||
      !vmlmf::mma_plan_ok(plan) || red < vmlmf::mma_red_floats(depth, cols, rpad) ||
      !vmlmf::ring_ok(plan) || !vmlmf::mma_ring_holds(plan, cols) ||
      !vmlmf::mma_resident_ok(resident, depth) || (resident < depth && wstream == nullptr))
    return cudaErrorInvalidValue;
  const size_t floats = vmlmf::weight_floats<bf16>(
                            (size_t)vmlmf::mma_resident(resident, depth) * cols) +
                        vmlmf::ring_floats(plan) + red;
  if (floats * sizeof(float) > 232448) return cudaErrorInvalidValue;
  plan.smem = static_cast<int>(floats * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         plan.smem);
  if (err != cudaSuccess) return err;
  check_kernel<<<1, vmlmf::kRingThreads, plan.smem, static_cast<cudaStream_t>(stream_handle)>>>(
      w, a, out, static_cast<bf16*>(xchg), static_cast<bf16*>(wstream), depth, cols, ncols, reps,
      plan);
  return cudaGetLastError();
}

// The message of an error code that mma_walk_check returned.
extern "C" const char* mma_walk_check_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
