// Shared helpers of the hand-written Hopper kernels of arpack_ng_tpu_torch.
//
// Storage/accumulation pairs every kernel is instantiated for (the dtype
// code passed through the C interface):
//   0: float storage,          float accumulation
//   1: __nv_bfloat16 storage,  float accumulation
//   2: double storage,         double accumulation
//
// Reductions are trees with a fixed shape (warp shuffles, then the warps
// in order, then the last block over the per-block partials; passes.cuh),
// so every sum is deterministic from run to run and rounds like a
// pairwise sum: the 8*log2(n)*eps noise model of the selective
// reorthogonalization (arpack_ng_tpu/core/arnoldi.py:773-801) assumes
// exactly that.  No floating-point atomics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace atpt {

template <typename A, typename T>
__device__ __forceinline__ A to_acc(T x) {
  return static_cast<A>(x);
}
template <>
__device__ __forceinline__ float to_acc<float, __nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, typename A>
__device__ __forceinline__ T to_store(A x) {
  return static_cast<T>(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_store<__nv_bfloat16, float>(float x) {
  return __float2bfloat16(x);
}

// Product rounded on its own, never contracted into an FMA with a following
// add: the sparse kernels then round exactly as their twins' separate
// multiply and add.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
// The same for a sum, a difference, a quotient (IEEE) and a fused product.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Progress words (always in shared memory, addressed as such: a generic
// strong load would take the slow path on every poll): a block-scope
// release store publishes; a reader polls with relaxed loads and, once the
// value it waits for is there, takes one acquire fence (a fence per poll
// would cost one per pass of the column warps' loop).
__device__ __forceinline__ unsigned smem_addr(const int* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(smem_addr(p)), "r"(v) : "memory");
}
__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.cta.shared.b32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}
__device__ __forceinline__ void fence_acquire() {
  asm volatile("fence.acq_rel.cta;" ::: "memory");
}
// One thread waits until *p >= want; returns the value it saw.
__device__ __forceinline__ int wait_geq(const int* p, int want) {
  int v;
  while ((v = ld_relaxed(p)) < want) {
  }
  fence_acquire();
  return v;
}
// A warp polls a progress word: lane 0 reads it (relaxed) and hands it to
// the lanes; where it exceeds `seen`, lane 0 takes the acquire fence and the
// warp's later reads are ordered after it.  Returns max(seen, value).
__device__ __forceinline__ int warp_poll(const int* p, int seen, int lane) {
  int v = lane == 0 ? ld_relaxed(p) : 0;
  v = __shfl_sync(0xffffffffu, v, 0);
  if (v > seen) {
    if (lane == 0) fence_acquire();
    __syncwarp();
    return v;
  }
  return seen;
}

// ---- helpers of the reduced-space kernels (realnonsym_cycle.cu, cplx_cycle.cu)

// The SM's clock, read once a shared word is read (ptxas moves a bare
// clock read, which has no inputs, above the barrier before it; a read
// predicated on a loaded value waits for the load, which stays after the
// barrier).
__device__ __forceinline__ long long clock_after(const int* word) {
  long long t;
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.s32 p, %1, -1;\n\t@p mov.u64 %0, %%clock64;\n\t"
      "@!p mov.u64 %0, 0;\n\t}"
      : "=l"(t)
      : "r"(ld_relaxed(word))
      : "memory");
  return t;
}

// The largest v over the block (every thread passes its partial; all return
// the maximum).  `red`: 33 doubles of shared memory.
__device__ inline double block_max(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmax(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double m = red[0];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) m = fmax(m, red[w]);
    red[32] = m;
  }
  __syncthreads();
  const double out = red[32];
  __syncthreads();
  return out;
}

// Does key j come before key i in the stable ascending order (NaN last)?
__device__ __forceinline__ bool before(double kj, int j, double ki, int i) {
  const bool nj = isnan(kj), ni = isnan(ki);
  if (nj != ni) return ni;
  if (nj) return j < i;
  return kj < ki || (kj == ki && j < i);
}

__device__ __forceinline__ int stable_rank(const double* key, int n, int i) {
  const double ki = key[i];
  int r = 0;
  for (int j = 0; j < n; ++j) r += before(key[j], j, ki, i);
  return r;
}

}  // namespace atpt
