// Eta-subset reorthogonalization event kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels arpack_ng_tpu/ops/pallas_sel.py:
//   make_sel_proj   (:90)   s[k] = <V[idx[k]], br>
//   make_sel_update (:141)  r <- r - sum_k s[k] * V[idx[k]]  (+ ||r'||^2)
// One selective-reorthogonalization event of the Lanczos step
// (arpack_ng_tpu/core/arnoldi.py:936-962) is one call of each.
//
// Bound: device-memory bandwidth; the row-streaming passes of rows.cuh
// (shared with the CGS kernels of cgs.cu) read every byte once.  Here the
// rows are picked by index: the block loads `idx` (and the coefficients)
// from device memory, so the host never gathers rows, and a zero
// coefficient skips its row (the caller's valid-mask contract of the TPU
// kernel).  The update is in place.
#include "rows.cuh"

extern "C" {

const char* atpt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Number of per-block partials the caller of a row pass (sel or cgs) must
// allocate per row.
int atpt_row_blocks(long long n) { return atpt::row_blocks(n); }

// s[k] = <V[idx[k]], br> for k < K.  V: (rows, ld) storage; br, s and the
// (K * atpt_row_blocks(n)) partials buffer in the accumulation type.
int atpt_sel_proj(int code, const void* idx, int K, const void* V, long long ld,
                  const void* br, long long n, void* partial, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0: return atpt::launch_row_proj<float, float>(idx, K, V, ld, br, n, partial, out, st);
    case 1: return atpt::launch_row_proj<__nv_bfloat16, float>(idx, K, V, ld, br, n, partial, out, st);
    case 2: return atpt::launch_row_proj<double, double>(idx, K, V, ld, br, n, partial, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// r <- r - sum_k s[k] * V[idx[k]] in place; with norm_out != NULL also
// norm_out[0] = ||r'||^2 (partials buffer of atpt_row_blocks(n) values).
int atpt_sel_update(int code, const void* idx, const void* s, int K, const void* V,
                    long long ld, void* r, long long n, void* partial, void* norm_out,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0: return atpt::launch_row_update<float, float>(idx, s, K, V, ld, r, r, n, partial, norm_out, st);
    case 1: return atpt::launch_row_update<__nv_bfloat16, float>(idx, s, K, V, ld, r, r, n, partial, norm_out, st);
    case 2: return atpt::launch_row_update<double, double>(idx, s, K, V, ld, r, r, n, partial, norm_out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
