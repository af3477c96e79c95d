// Classical Gram-Schmidt pass kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels arpack_ng_tpu/ops/pallas_cgs.py:
//   make_proj   (:58)   h = V[:rows] w
//   make_update (:116)  r = w - h[:rows] V[:rows]  (+ ||r||^2, with_norm)
// the two GEMVs of the bucketed CGS step and of its DGKS refinement passes
// (SRC/dsaitr.f:570-583, 656-781; arpack_ng_tpu/core/arnoldi.py:505-567),
// opted into with cgs_kernel='pallas', for row buckets of 8, 16 and 24.
//
// Bound: device-memory bandwidth.  proj reads `rows` basis rows and w once;
// update reads them and w once and writes r once.  These are the
// contiguous-row case of the event kernels, so both run the row-streaming
// passes of rows.cuh with no index array: a block holds its column chunk of
// w in registers and streams the rows over it; the dot products and the
// fused norm are summed per block and then by a fixed second-pass tree
// (deterministic; the rounding the 8*log2(n)*eps omega model assumes).
// The update is out of place: w is left untouched, as in the TPU kernel.
#include "rows.cuh"

extern "C" {

// h[k] = <V[k], w> for k < rows.  V: (>= rows, ld) storage; w, h and the
// (rows * atpt_row_blocks(n)) partials buffer in the accumulation type.
int atpt_cgs_proj(int code, int rows, const void* V, long long ld, const void* w,
                  long long n, void* partial, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0: return atpt::launch_row_proj<float, float>(nullptr, rows, V, ld, w, n, partial, out, st);
    case 1: return atpt::launch_row_proj<__nv_bfloat16, float>(nullptr, rows, V, ld, w, n, partial, out, st);
    case 2: return atpt::launch_row_proj<double, double>(nullptr, rows, V, ld, w, n, partial, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// r = w - sum_{k < rows} h[k] V[k], out of place; with norm_out != NULL
// also norm_out[0] = ||r||^2 (partials buffer of atpt_row_blocks(n) values).
int atpt_cgs_update(int code, const void* h, int rows, const void* V, long long ld,
                    const void* w, void* r, long long n, void* partial, void* norm_out,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0: return atpt::launch_row_update<float, float>(nullptr, h, rows, V, ld, w, r, n, partial, norm_out, st);
    case 1: return atpt::launch_row_update<__nv_bfloat16, float>(nullptr, h, rows, V, ld, w, r, n, partial, norm_out, st);
    case 2: return atpt::launch_row_update<double, double>(nullptr, h, rows, V, ld, w, r, n, partial, norm_out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
