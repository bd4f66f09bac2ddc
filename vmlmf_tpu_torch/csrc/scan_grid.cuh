// The pieces of the single-layer LSTM scan kernels that spread a step over
// many CTAs (lstm_scan_xin_fwd.cu, lstm_scan_xin_bwd.cu), for sm_90a: the
// layout that ops/cuda_scan.py::scan_plan decides, the barrier of a batch
// group, and the product of one CTA's weight slice with a group's rows.
//
// The batch is cut into `groups` groups of consecutive rows; each group has
// `ctas` CTAs, each of which holds one slice of the recurrent weights in
// shared memory for the whole scan. CTA q of a group owns the hidden units
// j0 .. j1-1 (all four gate columns of each) and the rank columns k0 .. k1-1,
// split as evenly as integers allow: [q*n/ctas, (q+1)*n/ctas). Groups never
// wait for each other. Inside a group, CTAs exchange the step's h (or dpre,
// hu, dhu) through global buffers laid out [depth][rpad]: one column per
// batch row of the group, padded to rpad (a multiple of 4) rows.

#pragma once

#include <cuda_runtime.h>

namespace vmlmf {

constexpr int kGridThreads = 512;  // threads per CTA of the grid kernels
constexpr int kMaxSlices = 32;     // depth slices of one product item
constexpr int kMinSliceDepth = 8;  // depth rows a slice takes at least

// The layout of a launch, from scan_plan: groups x ctas CTAs; rpad padded
// rows per group; stage and red: floats of the staging buffer and of the
// slice partials in shared memory; smem: the bytes the plan sized.
struct GridPlan {
  int groups, ctas, rpad, stage, red, smem;
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

// Barrier of the `n` CTAs of one group: a generation count in a global word
// that the launcher zeroes. `target` lives in thread 0 and grows by n a
// call. After __syncthreads, thread 0's acq_rel fence releases every write
// the CTA made before the barrier, its relaxed add arrives, and its acquire
// loads wait for the group; the closing __syncthreads passes that order on
// to the CTA's other threads. Exchange buffers are then read with
// cp.async.cg (L2, coherent), never through the non-coherent path.
__device__ __forceinline__ void group_sync(unsigned* count, int n, unsigned& target) {
  __syncthreads();
  if (n > 1 && threadIdx.x == 0) {
    target += n;
    asm volatile("fence.acq_rel.gpu;\n\tred.relaxed.gpu.global.add.u32 [%0], 1;"
                 :: "l"(count) : "memory");
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

// out(col, row) = sum over d < depth of A[d][row] * W[d][col], for col <
// ncols (a multiple of 4) and row < rpad. A is a global exchange buffer
// [depth][rpad], copied into shared memory with 16-byte cp.async.cg: whole
// when it fits in `stage`, else in chunks of stage / 2 floats, the next
// chunk copying into one half while the CTA multiplies the other. W is
// this CTA's weight slice in shared memory, [depth][ldw]. An item is 4
// columns x 4 rows (16 sums in registers, float4 loads of A and W). With
// fewer items than threads, each item's depth is cut into `slices`
// interleaved parts; their partial sums meet in `red` and one thread per
// output adds them in slice order: deterministic, no atomics. Calls
// epi(cb, rb, acc) once per item, acc[c][r] the sum of column 4cb+c, row
// 4rb+r. The partials lie [slice][16][items], so that neighbouring threads
// (neighbouring items) touch neighbouring banks. Every thread of the CTA
// must call it.
template <class Epi>
__device__ __forceinline__ void slice_product(const float* a, int depth, int rpad,
                                              const float* w, int ldw, int ncols,
                                              float* stage, int stage_floats, float* red,
                                              int red_floats, Epi epi) {
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
        const float* wd = w + (size_t)d0 * ldw + 4 * cb;
#pragma unroll 4
        for (int d = s; d < dn; d += slices) {
          const float4 av = s4[d * rbs + rb];
          const float4 wv = *reinterpret_cast<const float4*>(wd + (size_t)d * ldw);
          const float ar[4] = {av.x, av.y, av.z, av.w};
          const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[k][i] = fmaf(ar[i], wc[k], acc[k][i]);
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

// Launches `kernel` cooperatively on plan.groups * plan.ctas CTAs of
// kGridThreads threads with plan.smem bytes of shared memory, after zeroing
// the groups' barrier words; `args` as cudaLaunchCooperativeKernel takes
// them. A grid that cannot be co-resident is refused with
// cudaErrorCooperativeLaunchTooLarge, never run.
template <class Kernel>
cudaError_t launch_grid(Kernel kernel, const GridPlan& plan, unsigned* sync, void** args,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         plan.smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGridThreads, plan.smem);
  if (err != cudaSuccess) return err;
  const int grid = plan.groups * plan.ctas;
  if (grid > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(sync, 0, sizeof(unsigned) * plan.groups, stream);
  if (err != cudaSuccess) return err;
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                     dim3(kGridThreads), args, static_cast<size_t>(plan.smem),
                                     stream);
}

}  // namespace vmlmf
