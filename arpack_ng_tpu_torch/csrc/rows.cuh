// Row-streaming projection and update passes over the Lanczos basis, used
// by the eta-subset event (sel.cu: K rows picked by index).
//
//   proj:    s[k] = <V[row(k)], x>                     k < K
//   update:  r = w - sum_k s[k] * V[row(k)]   (+ ||r||^2)
// row(k) = idx[k] when an index array is given, else k.  `r` may alias `w`
// (the in-place event update) or not.
//
// Bound: device-memory bandwidth.  A call streams K basis rows of n values
// (plus x, or w and r); the arithmetic is one FMA per element read.  Every
// byte is read once:
// * a block owns a chunk of ROW_CHUNK columns; its threads hold the chunk of
//   x (proj) or w (update) in registers and stream the K rows over it,
//   reading the row indices (and coefficients) from device memory, so the
//   host never gathers rows;
// * the K partial dots (proj) or the partial ||r||^2 (update) are written
//   per block and summed by a second small pass (common.cuh), a fixed tree:
//   deterministic, and pairwise-like rounding for the omega noise model;
// * a row whose coefficient is zero is skipped, so masked rows are exact
//   no-ops.
#pragma once

#include "common.cuh"

namespace atpt {
namespace {

constexpr int ROW_BLOCK = 256;
constexpr int ROW_ITEMS = 16;
constexpr int ROW_CHUNK = ROW_BLOCK * ROW_ITEMS;  // columns per block
constexpr int ROW_MAX_K = 256;

inline int row_blocks(int64_t n) {
  return static_cast<int>((n + ROW_CHUNK - 1) / ROW_CHUNK);
}

template <typename T, typename A>
__global__ void __launch_bounds__(ROW_BLOCK)
row_proj_partial_kernel(const int* __restrict__ idx, int K, const T* __restrict__ V,
                        int64_t ld, const A* __restrict__ x, int64_t n,
                        A* __restrict__ partial) {
  __shared__ A smem[ROW_BLOCK / 32];
  __shared__ int rows[ROW_MAX_K];
  if (threadIdx.x < K) rows[threadIdx.x] = idx != nullptr ? idx[threadIdx.x] : threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * ROW_CHUNK + threadIdx.x;
  A b[ROW_ITEMS];
#pragma unroll
  for (int it = 0; it < ROW_ITEMS; ++it) {
    const int64_t c = base + static_cast<int64_t>(it) * ROW_BLOCK;
    b[it] = c < n ? x[c] : A(0);
  }
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    const T* row = V + static_cast<int64_t>(rows[k]) * ld;
    A acc = A(0);
#pragma unroll
    for (int it = 0; it < ROW_ITEMS; ++it) {
      const int64_t c = base + static_cast<int64_t>(it) * ROW_BLOCK;
      if (c < n) acc += to_acc<A>(row[c]) * b[it];
    }
    acc = block_sum<A, ROW_BLOCK>(acc, smem);
    if (threadIdx.x == 0) partial[static_cast<int64_t>(k) * gridDim.x + blockIdx.x] = acc;
  }
}

template <typename T, typename A, bool NORM>
__global__ void __launch_bounds__(ROW_BLOCK)
row_update_kernel(const int* __restrict__ idx, const A* __restrict__ s, int K,
                  const T* __restrict__ V, int64_t ld, const A* w, A* r, int64_t n,
                  A* __restrict__ partial) {
  __shared__ A smem[ROW_BLOCK / 32];
  __shared__ int rows[ROW_MAX_K];
  __shared__ A coef[ROW_MAX_K];
  if (threadIdx.x < K) {
    rows[threadIdx.x] = idx != nullptr ? idx[threadIdx.x] : threadIdx.x;
    coef[threadIdx.x] = s[threadIdx.x];
  }
  const int64_t base = static_cast<int64_t>(blockIdx.x) * ROW_CHUNK + threadIdx.x;
  A acc[ROW_ITEMS];
#pragma unroll
  for (int it = 0; it < ROW_ITEMS; ++it) {
    const int64_t c = base + static_cast<int64_t>(it) * ROW_BLOCK;
    acc[it] = c < n ? w[c] : A(0);
  }
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    const A sk = coef[k];
    if (sk == A(0)) continue;  // masked row: exact no-op
    const T* row = V + static_cast<int64_t>(rows[k]) * ld;
#pragma unroll
    for (int it = 0; it < ROW_ITEMS; ++it) {
      const int64_t c = base + static_cast<int64_t>(it) * ROW_BLOCK;
      if (c < n) acc[it] -= sk * to_acc<A>(row[c]);
    }
  }
  A ss = A(0);
#pragma unroll
  for (int it = 0; it < ROW_ITEMS; ++it) {
    const int64_t c = base + static_cast<int64_t>(it) * ROW_BLOCK;
    if (c < n) {
      r[c] = acc[it];
      if (NORM) ss += acc[it] * acc[it];
    }
  }
  if (NORM) {
    ss = block_sum<A, ROW_BLOCK>(ss, smem);
    if (threadIdx.x == 0) partial[blockIdx.x] = ss;
  }
}

// s[k] = <V[row(k)], x>; `partial` holds K * row_blocks(n) values.
template <typename T, typename A>
int launch_row_proj(const void* idx, int K, const void* V, int64_t ld, const void* x,
                    int64_t n, void* partial, void* out, cudaStream_t st) {
  if (K < 1 || K > ROW_MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = row_blocks(n);
  row_proj_partial_kernel<T, A><<<nblk, ROW_BLOCK, 0, st>>>(
      static_cast<const int*>(idx), K, static_cast<const T*>(V), ld,
      static_cast<const A*>(x), n, static_cast<A*>(partial));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials_kernel<A, ROW_BLOCK><<<K, ROW_BLOCK, 0, st>>>(
      static_cast<const A*>(partial), nblk, static_cast<A*>(out));
  return static_cast<int>(cudaGetLastError());
}

// r = w - sum_k s[k] V[row(k)]; with norm_out != NULL also norm_out[0] =
// ||r||^2 (`partial` holds row_blocks(n) values).
template <typename T, typename A>
int launch_row_update(const void* idx, const void* s, int K, const void* V, int64_t ld,
                      const void* w, void* r, int64_t n, void* partial, void* norm_out,
                      cudaStream_t st) {
  if (K < 1 || K > ROW_MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = row_blocks(n);
  if (norm_out != nullptr) {
    row_update_kernel<T, A, true><<<nblk, ROW_BLOCK, 0, st>>>(
        static_cast<const int*>(idx), static_cast<const A*>(s), K,
        static_cast<const T*>(V), ld, static_cast<const A*>(w), static_cast<A*>(r), n,
        static_cast<A*>(partial));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    reduce_partials_kernel<A, ROW_BLOCK><<<1, ROW_BLOCK, 0, st>>>(
        static_cast<const A*>(partial), nblk, static_cast<A*>(norm_out));
  } else {
    row_update_kernel<T, A, false><<<nblk, ROW_BLOCK, 0, st>>>(
        static_cast<const int*>(idx), static_cast<const A*>(s), K,
        static_cast<const T*>(V), ld, static_cast<const A*>(w), static_cast<A*>(r), n,
        nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace atpt
