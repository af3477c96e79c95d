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
//
// The block form (dia_block_kernel) is the product over b vectors at once,
// Y = A X with X, Y row-major (b, n_pad): the apply_block of the block
// Lanczos solver (arpack_ng_tpu/core/block.py, through
// arpack_ng_tpu/ops/sparse.py:118-183 dia_block_matvec_fn).  Its point is
// that the table, the bytes that dominate, is read once per block and not
// once per vector: one thread owns output row i, loads dtab[k, i] once per
// diagonal and applies it to the block's columns, whose sums it keeps in a
// register array of at most DIA_COLS values; a larger block is taken in
// chunks of DIA_COLS columns (gridDim.y), so the table is read once per
// chunk.  Column c sums in dia_kernel's order and rounding, so it equals the
// single product of X[c] bit for bit.  The TPU form's (G, b, 128) lane
// interleave fixed that chip's sublane occupancy; here the warp's loads of
// each column are contiguous as they stand, and nothing is interleaved.
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

constexpr int DIA_COLS = 8;

// Chunk blockIdx.y holds columns [CB * blockIdx.y, CB * blockIdx.y + cols);
// CB is b for b <= DIA_COLS (cols == CB), else DIA_COLS.
template <typename A, int CB>
__global__ void __launch_bounds__(DIA_BLOCK)
dia_block_kernel(const long long* __restrict__ offsets, int nd, const A* __restrict__ dtab,
                 int64_t ld, const A* __restrict__ x, int64_t ldx, int b, int64_t n,
                 int64_t n_pad, A* __restrict__ y, int64_t ldy) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * DIA_BLOCK + threadIdx.x;
  if (i >= n_pad) return;
  const int c0 = blockIdx.y * CB;
  const int cols = min(CB, b - c0);
  const A* xc = x + static_cast<int64_t>(c0) * ldx;
  A acc[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) acc[c] = A(0);
  if (i < n) {
    for (int k = 0; k < nd; ++k) {
      const int64_t j = i + offsets[k];
      if (j < 0 || j >= n) continue;
      const A d = dtab[static_cast<int64_t>(k) * ld + i];
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c < cols) acc[c] = acc[c] + mul_rn(d, xc[static_cast<int64_t>(c) * ldx + j]);
    }
  }
  A* yc = y + static_cast<int64_t>(c0) * ldy;
#pragma unroll
  for (int c = 0; c < CB; ++c)
    if (c < cols) yc[static_cast<int64_t>(c) * ldy + i] = acc[c];
}

template <typename A, int CB>
int launch_block_cb(const void* offsets, int nd, const void* dtab, int64_t ld, const void* x,
                    int64_t ldx, int b, int64_t n, int64_t n_pad, void* y, int64_t ldy,
                    cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((n_pad + DIA_BLOCK - 1) / DIA_BLOCK),
                  static_cast<unsigned>((b + CB - 1) / CB));
  dia_block_kernel<A, CB><<<grid, DIA_BLOCK, 0, st>>>(
      static_cast<const long long*>(offsets), nd, static_cast<const A*>(dtab), ld,
      static_cast<const A*>(x), ldx, b, n, n_pad, static_cast<A*>(y), ldy);
  return static_cast<int>(cudaGetLastError());
}

template <typename A>
int launch_dia_block(const void* offsets, int nd, const void* dtab, int64_t ld, const void* x,
                     int64_t ldx, int b, int64_t n, int64_t n_pad, void* y, int64_t ldy,
                     cudaStream_t st) {
  if (nd < 1 || b < 1 || n < 0 || n > n_pad || ld < n_pad || ldx < n_pad || ldy < n_pad ||
      (b + DIA_COLS - 1) / DIA_COLS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
#define ATPT_DIA_BLOCK_CASE(CB) \
  case CB:                      \
    return launch_block_cb<A, CB>(offsets, nd, dtab, ld, x, ldx, b, n, n_pad, y, ldy, st);
  switch (b < DIA_COLS ? b : DIA_COLS) {
    ATPT_DIA_BLOCK_CASE(1)
    ATPT_DIA_BLOCK_CASE(2)
    ATPT_DIA_BLOCK_CASE(3)
    ATPT_DIA_BLOCK_CASE(4)
    ATPT_DIA_BLOCK_CASE(5)
    ATPT_DIA_BLOCK_CASE(6)
    ATPT_DIA_BLOCK_CASE(7)
    ATPT_DIA_BLOCK_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ATPT_DIA_BLOCK_CASE
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

// Y = DIA(offsets, dtab) X for a block of b vectors.  X: (b, ldx) and
// Y: (b, ldy) row-major, the first n_pad values of each row used; offsets
// and dtab as atpt_dia_matvec's.
int atpt_dia_block_matvec(int code, const void* offsets, int nd, const void* dtab, long long ld,
                          const void* x, long long ldx, int b, long long n, long long n_pad,
                          void* y, long long ldy, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0:
      return atpt::launch_dia_block<float>(offsets, nd, dtab, ld, x, ldx, b, n, n_pad, y, ldy,
                                           st);
    case 2:
      return atpt::launch_dia_block<double>(offsets, nd, dtab, ld, x, ldx, b, n, n_pad, y, ldy,
                                            st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
