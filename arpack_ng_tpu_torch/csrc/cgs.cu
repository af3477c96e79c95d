// Classical Gram-Schmidt pass kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels arpack_ng_tpu/ops/pallas_cgs.py:
//   make_proj   (:58)   h = V[:rows] w
//   make_update (:116)  r = w - h[:rows] V[:rows]  (+ ||r||^2, with_norm)
// the two GEMVs of the bucketed CGS step and of its DGKS refinement passes
// (SRC/dsaitr.f:570-583, 656-781; arpack_ng_tpu/core/arnoldi.py:505-567),
// opted into with cgs_kernel='pallas', for row buckets of 8, 16 and 24.
//
// Bound: device-memory bandwidth.  The passes of passes.cuh over the rows
// 0..rows (IDX off): compile-time row buckets streamed through registers,
// a fixed grid from the host plan, one launch whose last block sums the
// per-block partials in a fixed order.  The update is out of place; w is
// never written.
#include "passes.cuh"

extern "C" {

// h[k] = <V[k], w> for k < rows, in one launch.  V: (>= rows, ld) storage;
// w and h in the accumulation type; `partial` holds rows * grid values of
// it and `ticket` one zeroed unsigned int, both reused from call to call on
// one stream.  (bucket, vect, grid) is the host plan.
int atpt_cgs_proj(int code, int bucket, int vect, int grid, int rows, const void* V,
                  long long ld, const void* w, long long n, void* partial, void* ticket,
                  void* out, void* stream) {
  return atpt::proj_code(code, atpt::Plan{bucket, vect, grid}, rows, V, ld, w, n, partial,
                         ticket, out, static_cast<cudaStream_t>(stream));
}

// r = w - sum_{k < rows} h[k] V[k], out of place, in one launch; with
// norm_out != NULL also norm_out[0] = ||r||^2 (`partial` then holds grid
// values).
int atpt_cgs_update(int code, int bucket, int vect, int grid, const void* h, int rows,
                    const void* V, long long ld, const void* w, void* r, long long n,
                    void* partial, void* ticket, void* norm_out, void* stream) {
  return atpt::update_code(code, atpt::Plan{bucket, vect, grid}, h, rows, V, ld, w, r, n,
                           partial, ticket, norm_out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
