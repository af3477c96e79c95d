// Eta-subset reorthogonalization event kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels arpack_ng_tpu/ops/pallas_sel.py:
//   make_sel_proj   (:90)   s[k] = <V[idx[k]], br>
//   make_sel_update (:141)  r <- r - sum_k s[k] * V[idx[k]]  (+ ||r'||^2)
// One selective-reorthogonalization event of the Lanczos step
// (arpack_ng_tpu/core/arnoldi.py:936-962) is one call of each.
//
// Bound: device-memory bandwidth.  A call streams K basis rows of n values
// (plus br or r); the arithmetic is one FMA per element read.  The design
// keeps every byte read exactly once:
// * a block owns a chunk of SEL_CHUNK columns; its threads hold the chunk
//   of br (proj) or r (update) in registers and stream the K selected rows
//   over it, reading the row indices (and coefficients) from device memory
//   so the host never gathers rows;
// * the K partial dots (proj) or the partial ||r'||^2 (update) are written
//   per block and summed by a second small pass (common.cuh), a fixed tree:
//   deterministic, and pairwise-like rounding for the omega noise model;
// * a row whose coefficient is zero is skipped, so masked rows are exact
//   no-ops (the caller's valid-mask contract of the TPU kernel).
#include "common.cuh"

namespace atpt {

constexpr int SEL_BLOCK = 256;
constexpr int SEL_ITEMS = 16;
constexpr int SEL_CHUNK = SEL_BLOCK * SEL_ITEMS;  // columns per block
constexpr int SEL_MAX_K = 256;

template <typename T, typename A>
__global__ void __launch_bounds__(SEL_BLOCK)
sel_proj_partial_kernel(const int* __restrict__ idx, int K, const T* __restrict__ V,
                        int64_t ld, const A* __restrict__ br, int64_t n,
                        A* __restrict__ partial) {
  __shared__ A smem[SEL_BLOCK / 32];
  __shared__ int rows[SEL_MAX_K];
  if (threadIdx.x < K) rows[threadIdx.x] = idx[threadIdx.x];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * SEL_CHUNK + threadIdx.x;
  A b[SEL_ITEMS];
#pragma unroll
  for (int it = 0; it < SEL_ITEMS; ++it) {
    const int64_t c = base + static_cast<int64_t>(it) * SEL_BLOCK;
    b[it] = c < n ? br[c] : A(0);
  }
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    const T* row = V + static_cast<int64_t>(rows[k]) * ld;
    A acc = A(0);
#pragma unroll
    for (int it = 0; it < SEL_ITEMS; ++it) {
      const int64_t c = base + static_cast<int64_t>(it) * SEL_BLOCK;
      if (c < n) acc += to_acc<A>(row[c]) * b[it];
    }
    acc = block_sum<A, SEL_BLOCK>(acc, smem);
    if (threadIdx.x == 0) partial[static_cast<int64_t>(k) * gridDim.x + blockIdx.x] = acc;
  }
}

template <typename T, typename A, bool NORM>
__global__ void __launch_bounds__(SEL_BLOCK)
sel_update_kernel(const int* __restrict__ idx, const A* __restrict__ s, int K,
                  const T* __restrict__ V, int64_t ld, A* __restrict__ r, int64_t n,
                  A* __restrict__ partial) {
  __shared__ A smem[SEL_BLOCK / 32];
  __shared__ int rows[SEL_MAX_K];
  __shared__ A coef[SEL_MAX_K];
  if (threadIdx.x < K) {
    rows[threadIdx.x] = idx[threadIdx.x];
    coef[threadIdx.x] = s[threadIdx.x];
  }
  const int64_t base = static_cast<int64_t>(blockIdx.x) * SEL_CHUNK + threadIdx.x;
  A acc[SEL_ITEMS];
#pragma unroll
  for (int it = 0; it < SEL_ITEMS; ++it) {
    const int64_t c = base + static_cast<int64_t>(it) * SEL_BLOCK;
    acc[it] = c < n ? r[c] : A(0);
  }
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    const A sk = coef[k];
    if (sk == A(0)) continue;  // masked row: exact no-op
    const T* row = V + static_cast<int64_t>(rows[k]) * ld;
#pragma unroll
    for (int it = 0; it < SEL_ITEMS; ++it) {
      const int64_t c = base + static_cast<int64_t>(it) * SEL_BLOCK;
      if (c < n) acc[it] -= sk * to_acc<A>(row[c]);
    }
  }
  A ss = A(0);
#pragma unroll
  for (int it = 0; it < SEL_ITEMS; ++it) {
    const int64_t c = base + static_cast<int64_t>(it) * SEL_BLOCK;
    if (c < n) {
      r[c] = acc[it];
      if (NORM) ss += acc[it] * acc[it];
    }
  }
  if (NORM) {
    ss = block_sum<A, SEL_BLOCK>(ss, smem);
    if (threadIdx.x == 0) partial[blockIdx.x] = ss;
  }
}

inline int sel_blocks(int64_t n) {
  return static_cast<int>((n + SEL_CHUNK - 1) / SEL_CHUNK);
}

template <typename T, typename A>
int launch_sel_proj(const void* idx, int K, const void* V, int64_t ld, const void* br,
                    int64_t n, void* partial, void* out, cudaStream_t st) {
  const int nblk = sel_blocks(n);
  sel_proj_partial_kernel<T, A><<<nblk, SEL_BLOCK, 0, st>>>(
      static_cast<const int*>(idx), K, static_cast<const T*>(V), ld,
      static_cast<const A*>(br), n, static_cast<A*>(partial));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials_kernel<A, SEL_BLOCK><<<K, SEL_BLOCK, 0, st>>>(
      static_cast<const A*>(partial), nblk, static_cast<A*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int launch_sel_update(const void* idx, const void* s, int K, const void* V, int64_t ld,
                      void* r, int64_t n, void* partial, void* norm_out,
                      cudaStream_t st) {
  const int nblk = sel_blocks(n);
  if (norm_out != nullptr) {
    sel_update_kernel<T, A, true><<<nblk, SEL_BLOCK, 0, st>>>(
        static_cast<const int*>(idx), static_cast<const A*>(s), K,
        static_cast<const T*>(V), ld, static_cast<A*>(r), n, static_cast<A*>(partial));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    reduce_partials_kernel<A, SEL_BLOCK><<<1, SEL_BLOCK, 0, st>>>(
        static_cast<const A*>(partial), nblk, static_cast<A*>(norm_out));
  } else {
    sel_update_kernel<T, A, false><<<nblk, SEL_BLOCK, 0, st>>>(
        static_cast<const int*>(idx), static_cast<const A*>(s), K,
        static_cast<const T*>(V), ld, static_cast<A*>(r), n, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace atpt

extern "C" {

const char* atpt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Number of per-block partials the caller must allocate per row.
int atpt_sel_blocks(long long n) { return atpt::sel_blocks(n); }

// s[k] = <V[idx[k]], br> for k < K.  V: (rows, ld) storage; br, s and the
// (K * atpt_sel_blocks(n)) partials buffer in the accumulation type.
int atpt_sel_proj(int code, const void* idx, int K, const void* V, long long ld,
                  const void* br, long long n, void* partial, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0: return atpt::launch_sel_proj<float, float>(idx, K, V, ld, br, n, partial, out, st);
    case 1: return atpt::launch_sel_proj<__nv_bfloat16, float>(idx, K, V, ld, br, n, partial, out, st);
    case 2: return atpt::launch_sel_proj<double, double>(idx, K, V, ld, br, n, partial, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// r <- r - sum_k s[k] * V[idx[k]] in place; with norm_out != NULL also
// norm_out[0] = ||r'||^2 (partials buffer of atpt_sel_blocks(n) values).
int atpt_sel_update(int code, const void* idx, const void* s, int K, const void* V,
                    long long ld, void* r, long long n, void* partial, void* norm_out,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0: return atpt::launch_sel_update<float, float>(idx, s, K, V, ld, r, n, partial, norm_out, st);
    case 1: return atpt::launch_sel_update<__nv_bfloat16, float>(idx, s, K, V, ld, r, n, partial, norm_out, st);
    case 2: return atpt::launch_sel_update<double, double>(idx, s, K, V, ld, r, n, partial, norm_out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
