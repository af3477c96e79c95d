// DIA (diagonal-set) sparse matrix-vector product for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel arpack_ng_tpu/ops/pallas_dia.py:47
// make_pallas_dia_matvec, the hand-scheduled form of the DIA operator of
// arpack_ng_tpu/ops/sparse.py:92-115 (dia_matvec_fn):
//   y[i] = sum_k dtab[k, i] * x[i + off_k]   for i < n, x read as zero
//          outside [0, n);  y[n:n_pad] = 0.
// It is the matvec of every operator that from_scipy imports as DIA
// (banded matrices, stencils, RCM-banded meshes).
//
// Bound: device-memory bandwidth.  The table of nd diagonals (nd x n_pad
// values) is read once and dominates; x and y are one vector each.  One
// thread owns one output row: the warp's reads of dtab[k, i] and of
// x[i + off_k] are both contiguous, so x is fetched from device memory about
// once and then served from L1/L2 to the other diagonals.  The TPU kernel's
// halo and lane-roll scheme existed only because its vector memory takes
// aligned loads; here x[i + off_k] is loaded directly.  The diagonals are
// summed in the order of `offsets` with the product rounded on its own, the
// twin's order and rounding, and no atomics: the result is deterministic.
#include "common.cuh"

namespace atpt {
namespace {

constexpr int DIA_BLOCK = 256;

template <typename A>
__global__ void __launch_bounds__(DIA_BLOCK)
dia_kernel(const long long* __restrict__ offsets, int nd, const A* __restrict__ dtab,
           int64_t ld, const A* __restrict__ x, int64_t n, int64_t n_pad, A* __restrict__ y) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * DIA_BLOCK + threadIdx.x;
  if (i >= n_pad) return;
  A acc = A(0);
  if (i < n) {
    for (int k = 0; k < nd; ++k) {
      const int64_t j = i + offsets[k];
      if (j >= 0 && j < n) acc = acc + mul_rn(dtab[static_cast<int64_t>(k) * ld + i], x[j]);
    }
  }
  y[i] = acc;
}

template <typename A>
int launch_dia(const void* offsets, int nd, const void* dtab, int64_t ld, const void* x,
               int64_t n, int64_t n_pad, void* y, cudaStream_t st) {
  if (nd < 1 || n < 0 || n > n_pad || ld < n_pad) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nblk = (n_pad + DIA_BLOCK - 1) / DIA_BLOCK;
  dia_kernel<A><<<static_cast<unsigned>(nblk), DIA_BLOCK, 0, st>>>(
      static_cast<const long long*>(offsets), nd, static_cast<const A*>(dtab), ld,
      static_cast<const A*>(x), n, n_pad, static_cast<A*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace atpt

extern "C" {

// y = DIA(offsets, dtab) x.  offsets: nd int64 on the device; dtab: (nd, ld)
// row-aligned diagonals (dtab[k, i] = A[i, i + offsets[k]]); x, y: n_pad.
int atpt_dia_matvec(int code, const void* offsets, int nd, const void* dtab, long long ld,
                    const void* x, long long n, long long n_pad, void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0: return atpt::launch_dia<float>(offsets, nd, dtab, ld, x, n, n_pad, y, st);
    case 2: return atpt::launch_dia<double>(offsets, nd, dtab, ld, x, n, n_pad, y, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
