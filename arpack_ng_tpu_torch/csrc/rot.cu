// In-place restart rotation of the Lanczos basis for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels arpack_ng_tpu/ops/pallas_rot.py:
//   make_rotate_rows (:91)  V[:rows] <- Q[:, :rows]^T V, rows >= `rows` untouched
//   make_rotate      (:44)  the full rotation V <- Q^T V, served here as rows = ncv
// called by the implicit restart (arpack_ng_tpu/core/arnoldi.py:197-220,
// from arpack_ng_tpu/core/device_sym.py:309): the dsapps kev-column update
// (SRC/dsapps.f:445-481).
//
// Bound: device-memory bandwidth.  The pass reads the ncv rows of V once and
// writes `rows` of them once; Q is a few KB.  Design:
// * a block owns a slab of ROT_W columns across all ncv rows: it loads the
//   whole (ncv, ROT_W) slab of V and Q[:, :rows] into shared memory
//   (ncv = 32, float: 32 KB + 4 KB), synchronises, and only then writes
//   the `rows` outputs of its own columns back into V.  Slabs are disjoint
//   and each block reads its slab before any of its writes, so the update
//   is safe in place without a second copy of V;
// * each thread owns one column and forms its outputs with FMAs in the
//   accumulation type, ROT_OB outputs at a time in registers, the Q values
//   read as shared-memory broadcasts.
#include "common.cuh"

namespace atpt {

constexpr int ROT_W = 256;  // columns per block = threads per block
constexpr int ROT_OB = 8;   // outputs accumulated per register block

inline int round_up8(int x) { return (x + 7) / 8 * 8; }

template <typename T, typename A>
__global__ void __launch_bounds__(ROT_W)
rotate_rows_kernel(const A* __restrict__ Q, int ldq, int ncv, int rows, T* V, int64_t ld,
                   int64_t n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows8 = (rows + 7) / 8 * 8;
  A* qs = reinterpret_cast<A*>(smem_raw);  // (ncv, rows8), zero-padded
  T* vs = reinterpret_cast<T*>(qs + static_cast<int64_t>(ncv) * rows8);  // (ncv, ROT_W)
  const int t = threadIdx.x;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * ROT_W + t;
  for (int e = t; e < ncv * rows8; e += ROT_W) {
    const int i = e / rows8, o = e - i * rows8;
    qs[e] = o < rows ? Q[static_cast<int64_t>(i) * ldq + o] : A(0);
  }
  for (int i = 0; i < ncv; ++i)
    vs[i * ROT_W + t] = c < n ? V[static_cast<int64_t>(i) * ld + c] : to_store<T, A>(A(0));
  __syncthreads();
  if (c >= n) return;
  for (int o0 = 0; o0 < rows; o0 += ROT_OB) {
    A acc[ROT_OB];
#pragma unroll
    for (int u = 0; u < ROT_OB; ++u) acc[u] = A(0);
    for (int i = 0; i < ncv; ++i) {
      const A v = to_acc<A>(vs[i * ROT_W + t]);
      const A* q = qs + i * rows8 + o0;
#pragma unroll
      for (int u = 0; u < ROT_OB; ++u) acc[u] += q[u] * v;
    }
#pragma unroll
    for (int u = 0; u < ROT_OB; ++u)
      if (o0 + u < rows) V[static_cast<int64_t>(o0 + u) * ld + c] = to_store<T, A>(acc[u]);
  }
}

template <typename T, typename A>
size_t rot_smem_bytes(int ncv, int rows) {
  return static_cast<size_t>(ncv) * round_up8(rows) * sizeof(A) +
         static_cast<size_t>(ncv) * ROT_W * sizeof(T);
}

template <typename T, typename A>
int launch_rotate_rows(const void* Q, int ldq, int ncv, int rows, void* V, int64_t ld,
                       int64_t n, cudaStream_t st) {
  const size_t smem = rot_smem_bytes<T, A>(ncv, rows);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rotate_rows_kernel<T, A>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t nblk = (n + ROT_W - 1) / ROT_W;
  rotate_rows_kernel<T, A><<<static_cast<unsigned>(nblk), ROT_W, smem, st>>>(
      static_cast<const A*>(Q), ldq, ncv, rows, static_cast<T*>(V), ld, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace atpt

extern "C" {

// Shared memory one block needs for (ncv, rows); the wrapper refuses
// shapes above the card's 227 KB per block.
long long atpt_rot_smem_bytes(int code, int ncv, int rows) {
  switch (code) {
    case 0: return static_cast<long long>(atpt::rot_smem_bytes<float, float>(ncv, rows));
    case 1: return static_cast<long long>(atpt::rot_smem_bytes<__nv_bfloat16, float>(ncv, rows));
    case 2: return static_cast<long long>(atpt::rot_smem_bytes<double, double>(ncv, rows));
    default: return -1;
  }
}

// V[:rows] <- Q[:, :rows]^T V in place.  Q: (ncv, ldq) in the accumulation
// type, ldq >= rows; V: (ncv, ld) storage, n columns used.
int atpt_rotate_rows(int code, const void* Q, int ldq, int ncv, int rows, void* V,
                     long long ld, long long n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0: return atpt::launch_rotate_rows<float, float>(Q, ldq, ncv, rows, V, ld, n, st);
    case 1: return atpt::launch_rotate_rows<__nv_bfloat16, float>(Q, ldq, ncv, rows, V, ld, n, st);
    case 2: return atpt::launch_rotate_rows<double, double>(Q, ldq, ncv, rows, V, ld, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
