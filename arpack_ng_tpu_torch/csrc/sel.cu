// Eta-subset reorthogonalization event kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels arpack_ng_tpu/ops/pallas_sel.py:
//   make_sel_proj   (:90)   s[k] = <V[idx[k]], br>
//   make_sel_update (:141)  r <- r - sum_k s[k] * V[idx[k]]  (+ ||r'||^2)
// One selective-reorthogonalization event of the Lanczos step
// (arpack_ng_tpu/core/arnoldi.py:936-962) is one call of each.
//
// Bound: device-memory bandwidth.  The passes of passes.cuh with the rows
// picked by index (IDX on): each block copies idx to shared memory once,
// so the host never gathers rows; K buckets 8/16/24/32 are compile-time,
// every selected row's 16-byte loads are in flight before the first FMA;
// a fixed grid from the host plan; one launch, whose last block sums the
// per-block partials in a fixed order (two calls are bit-equal).  A zero
// coefficient skips its row (the caller's valid-mask contract of the TPU
// kernel): an all-zero s returns r bit for bit.  The update is in place.
// K is read from device memory (a word of 0 is no event), so that the
// selective step decides its events with no host read.
#include "passes.cuh"

extern "C" {

const char* atpt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// s[k] = <V[idx[k]], br> for k < K, in one launch, K = min(*word, nidx):
// `word` points to one int32, 0 for "no event" (s is all zero) or K in
// [1, nidx]; idx holds nidx >= K rows, of which the first K are used; s
// (nidx values) is zero at and past K.  V: (rows, ld) storage; br and s in
// the accumulation type; `partial` holds nidx * grid values of it and
// `ticket` one zeroed unsigned int, both reused from call to call on one
// stream.  (vect, grid) is the host plan of nidx rows, whose grid and
// vector width do not depend on the row count.
int atpt_sel_proj(int code, int vect, int grid, const void* idx, int nidx, const void* word,
                  const void* V, long long ld, const void* br, long long n, void* partial,
                  void* ticket, void* out, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0: return atpt::proj_word_typed<float, float>(vect, grid, idx, nidx, word, V, ld, br, n, partial, ticket, out, st);
    case 1: return atpt::proj_word_typed<__nv_bfloat16, float>(vect, grid, idx, nidx, word, V, ld, br, n, partial, ticket, out, st);
    case 2: return atpt::proj_word_typed<double, double>(vect, grid, idx, nidx, word, V, ld, br, n, partial, ticket, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// r <- r - sum_{k < K} s[k] * V[idx[k]] in place, in one launch, K as above
// (0 leaves r and the norm untouched); with norm_out != NULL also
// norm_out[0] = ||r'||^2 (`partial` then holds grid values).
int atpt_sel_update(int code, int vect, int grid, const void* idx, const void* s, int nidx,
                    const void* word, const void* V, long long ld, void* r, long long n,
                    void* partial, void* ticket, void* norm_out, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0: return atpt::update_word_typed<float, float>(vect, grid, idx, s, nidx, word, V, ld, r, n, partial, ticket, norm_out, st);
    case 1: return atpt::update_word_typed<__nv_bfloat16, float>(vect, grid, idx, s, nidx, word, V, ld, r, n, partial, ticket, norm_out, st);
    case 2: return atpt::update_word_typed<double, double>(vect, grid, idx, s, nidx, word, V, ld, r, n, partial, ticket, norm_out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
