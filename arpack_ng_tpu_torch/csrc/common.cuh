// Shared helpers of the hand-written Hopper kernels of arpack_ng_tpu_torch.
//
// Storage/accumulation pairs every kernel is instantiated for (the dtype
// code passed through the C interface):
//   0: float storage,          float accumulation
//   1: __nv_bfloat16 storage,  float accumulation
//   2: double storage,         double accumulation
//
// Reductions are trees with a fixed shape (warp shuffles, then one warp
// over the per-warp sums, then a second pass over per-block partials),
// so every sum is deterministic from run to run and rounds like a
// pairwise sum: the 8*log2(n)*eps noise model of the selective
// reorthogonalization (arpack_ng_tpu/core/arnoldi.py:773-801) assumes
// exactly that.  No atomics.
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

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over a block of BLOCK threads (BLOCK a multiple of 32, at most
// 1024).  The result is valid in thread 0.  `smem` holds BLOCK/32 values;
// it may be reused as soon as the call returns.
template <typename A, int BLOCK>
__device__ __forceinline__ A block_sum(A v, A* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = (threadIdx.x < BLOCK / 32) ? smem[lane] : A(0);
  if (warp == 0) v = warp_sum(v);
  __syncthreads();
  return v;
}

// Kernels defined in headers have internal linkage, so two sources that
// instantiate the same one link without clashing.
namespace {

// Second pass: out[k] = sum over b < nblk of partial[k * nblk + b], one
// block per k.
template <typename A, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
reduce_partials_kernel(const A* __restrict__ partial, int nblk, A* __restrict__ out) {
  __shared__ A smem[BLOCK / 32];
  const A* p = partial + static_cast<int64_t>(blockIdx.x) * nblk;
  A acc = A(0);
  for (int b = threadIdx.x; b < nblk; b += BLOCK) acc += p[b];
  acc = block_sum<A, BLOCK>(acc, smem);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

}  // namespace
}  // namespace atpt
