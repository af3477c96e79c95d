// The inner Krylov solves (CG, BiCGSTAB) of matrix-free shift-invert as
// CUDA-graph while loops: the loop test, the fused in-place vector updates
// that end each iteration with it, and the capture helpers that open a
// conditional WHILE node on a capturing stream and capture its body on a
// stream of its own (arpack_ng_tpu_torch/ops/cuda_krylov_loop.py binds them).
//
// The loop test replaces the condition of the reference's lax.while_loop
// around cg and bicgstab (arpack_ng_tpu/ops/solvers.py:58-60 and :90-92; the
// loops at :74 and :110), which XLA keeps on the device, so that a whole
// inner solve runs inside the outer jitted cycle.  It is no Pallas kernel:
// the reference leaves the loop to XLA.  The host loop (ops/solvers._cg,
// _bicgstab) reads the decision back once per iteration; on the card it is
// taken with the host's comparison (IEEE, no fast math: a nan |r.r| stops
// the loop as it does on the host):
//
//     go = it < maxiter && |r.r| > atol2,   atol2 = (tol*||b||)^2,
//
// and handed to the node with cudaGraphSetConditional.  It runs before the
// node (krylov_test_kernel, it = 0) and at the end of the body, which first
// bumps the iteration counter, so the test runs before every iteration as
// lax.while_loop's cond does.  When it ends the loop it appends (node,
// iterations) to a log in mapped host memory, which the host reads after its
// next synchronisation, never per solve.
//
// The body's test is no launch of its own (one thread after the body's
// torch ops was launch-bound: 0.0059 ms for 24 bytes, PERF.md row 14): it
// runs in the body's last kernel, one of the fused update kernels below,
// which replace the torch ops between the iteration's dot products (the
// dots stay cuBLAS's: their bits fix every iteration count).  Each updates
// the loop's buffers in place, where the torch ops wrote new vectors that
// the loop then copied back:
//
//   CG        cg_xr      alpha = rz / (p.Ap);  x += alpha p;  r -= alpha Ap
//             cg_p_test  beta = rz' / rz;  p = z + beta p;  rz = rz'; the test
//   BiCGSTAB  bicg_p     the restart's selects (rho == 0 last iteration);
//                        beta = (rho' / rho)(alpha / omega);
//                        p = r + beta (p - omega v)
//             bicg_s     alpha = rho' / (rhat.v');  s = r - alpha v';  v = v'
//             bicg_r     omega = (t.s) / (t.t);  r = s - omega t
//             bicg_x_test  x = x + alpha ph + omega sh;  rho' == 0: rhat = r
//                        (the restart), the flag for bicg_p; the test
//
// Every value rounds as the torch ops it replaces round (ops/solvers.cg_step,
// bicgstab_step; the twins in ops/cuda_krylov_loop.py): each product, sum
// and quotient on its own in torch's order, written out (__dmul_rn,
// __dadd_rn, IEEE division) so that no contraction depends on the code
// around it.  torch computes a + b as a + alpha b and a - b as a + (-alpha)
// b with alpha = 1 (in a complex dtype 1 + 0i, whose zero imaginary part
// still meets b's); complex products and quotients are c10::complex's
// (the quotient numpy's Smith division), contracted as torch's build
// contracts them (tools/complex_rounding_probe.py checks that against torch
// on the card); |r.r| of a complex dot is hypot(re, im), as
// torch.abs takes it.  A scalar the kernel reads and one it writes are never
// the same word: CG keeps rz's previous value beside it (cg_xr copies it),
// BiCGSTAB's state scalars are written by the kernels that do not read them.
//
// Bound: device memory.  The update kernels move (reads + writes, vectors):
// cg_xr 4 + 2, cg_p_test 2 + 1 (z is r without a preconditioner), bicg_p 3 +
// 1, bicg_s 2 + 2, bicg_r 2 + 1, bicg_x_test 3 + 1, each a grid-stride pass
// of 8-byte (float64) words, neighbouring threads on neighbouring values.
// The test: one thread, a few scalars.
//
// Needs CUDA 12.4 or later (runtime and driver): conditional nodes,
// cudaStreamBeginCaptureToGraph.  Built with an older toolkit the entry
// points return cudaErrorNotSupported where asked to set a condition, and
// atpt_krylov_versions says why.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#if CUDART_VERSION >= 12040
#define ATPT_WHILE 1
#else
#define ATPT_WHILE 0
typedef unsigned long long cudaGraphConditionalHandle;
#endif

namespace atpt {

// The loop test's arguments (ctypes' LoopTestArgs in ops/cuda_krylov_loop.py,
// field for field).  set_cond: give the decision to the node `handle`;
// atol2: 0-d of the real type; it: the device iteration counter; log:
// [count, (node, iterations) * cap] in mapped host memory (or nullptr); go:
// the decision written out (or nullptr: the host loop on a card reads it).
struct LoopTestArgs {
  unsigned long long handle;
  int set_cond;
  int maxiter;
  const void* atol2;
  int* it;
  int* log;
  int cap;
  int node;
  int* go;
};

// Row 14's test on |r.r| = rr: bump (1 at the end of the body: count the
// iteration just run; 0 before the node), decide, hand the decision on,
// log a loop that ends.
template <typename R>
__device__ void loop_test(const LoopTestArgs& t, R rr, int bump) {
  int i = *t.it;
  if (bump) {
    i += 1;
    *t.it = i;
  }
  const bool go = i < t.maxiter && rr > *static_cast<const R*>(t.atol2);
#if ATPT_WHILE
  if (t.set_cond)
    cudaGraphSetConditional(static_cast<cudaGraphConditionalHandle>(t.handle), go ? 1u : 0u);
#endif
  volatile int* log = t.log;
  if (!go && log != nullptr) {
    const int c = log[0];
    if (c < t.cap) {
      log[1 + 2 * c] = t.node;
      log[2 + 2 * c] = i;
    }
    log[0] = c + 1;
  }
  if (t.go != nullptr) *t.go = go ? 1 : 0;
}

// The test alone, before the node: rr, atol2 0-d of the real type R; rho
// (nullptr for CG): BiCGSTAB's 0-d rho, rho_parts values of R (2 for a
// complex rho), whose exact zero sets *brk.
template <typename R>
__global__ void krylov_test_kernel(LoopTestArgs t, const R* rr, int bump, const R* rho,
                                   int rho_parts, bool* brk) {
  loop_test<R>(t, *rr, bump);
  if (rho != nullptr) {
    bool zero = rho[0] == R(0);
    if (rho_parts == 2) zero = zero && rho[1] == R(0);
    *brk = zero;
  }
}

// ---- values as torch rounds them ------------------------------------------

// A complex value, torch's layout.
template <typename R>
struct alignas(2 * sizeof(R)) cx {
  R re, im;
};
template <typename T>
struct real_of {
  using type = T;
};
template <typename R>
struct real_of<cx<R>> {
  using type = R;
};

__device__ __forceinline__ float v_mul(float a, float b) { return mul_rn(a, b); }
__device__ __forceinline__ double v_mul(double a, double b) { return mul_rn(a, b); }
__device__ __forceinline__ float v_add(float a, float b) { return add_rn(a, b); }
__device__ __forceinline__ double v_add(double a, double b) { return add_rn(a, b); }
__device__ __forceinline__ float v_sub(float a, float b) { return sub_rn(a, b); }
__device__ __forceinline__ double v_sub(double a, double b) { return sub_rn(a, b); }
__device__ __forceinline__ float v_div(float a, float b) { return div_rn(a, b); }
__device__ __forceinline__ double v_div(double a, double b) { return div_rn(a, b); }
__device__ __forceinline__ float v_abs(float a) { return fabsf(a); }
__device__ __forceinline__ double v_abs(double a) { return fabs(a); }
__device__ __forceinline__ bool v_is_zero(float a) { return a == 0.0f; }
__device__ __forceinline__ bool v_is_zero(double a) { return a == 0.0; }
template <typename T>
__device__ __forceinline__ T v_one() {
  return T(1);
}

// c10::complex's product as torch's CUDA build compiles it: the first
// product of each part fused into its sum (a.re c.re - a.im c.im, a.re c.im
// + a.im c.re)
template <typename R>
__device__ __forceinline__ cx<R> v_mul(cx<R> a, cx<R> c) {
  return {fma_rn(a.re, c.re, -mul_rn(a.im, c.im)), fma_rn(a.re, c.im, mul_rn(a.im, c.re))};
}
// a + b = a + (1 + 0i) b: 1 b.re - 0 b.im, 1 b.im + 0 b.re (exact but for a
// zero's sign, and nan where b holds an infinity)
template <typename R>
__device__ __forceinline__ cx<R> v_add(cx<R> a, cx<R> b) {
  return {add_rn(a.re, sub_rn(b.re, mul_rn(R(0), b.im))),
          add_rn(a.im, add_rn(b.im, mul_rn(R(0), b.re)))};
}
// a - b = a + (-1 + 0i) b
template <typename R>
__device__ __forceinline__ cx<R> v_sub(cx<R> a, cx<R> b) {
  return {add_rn(a.re, sub_rn(-b.re, mul_rn(R(0), b.im))),
          add_rn(a.im, add_rn(-b.im, mul_rn(R(0), b.re)))};
}
// c10::complex's quotient (numpy's Smith division) as torch's CUDA build
// compiles it: each of its three multiply-adds fused
template <typename R>
__device__ cx<R> v_div(cx<R> x, cx<R> y) {
  const R a = x.re, b = x.im, c = y.re, d = y.im;
  const R abs_c = fabs(c), abs_d = fabs(d);
  if (abs_c >= abs_d) {
    if (abs_c == R(0) && abs_d == R(0)) return {div_rn(a, abs_c), div_rn(b, abs_d)};
    const R rat = div_rn(d, c);
    const R scl = div_rn(R(1), fma_rn(d, rat, c));
    return {mul_rn(fma_rn(b, rat, a), scl), mul_rn(fma_rn(-a, rat, b), scl)};
  }
  const R rat = div_rn(c, d);
  const R scl = div_rn(R(1), fma_rn(c, rat, d));
  return {mul_rn(fma_rn(a, rat, b), scl), mul_rn(fma_rn(b, rat, -a), scl)};
}
__device__ __forceinline__ float v_abs(cx<float> a) { return hypotf(a.re, a.im); }
__device__ __forceinline__ double v_abs(cx<double> a) { return hypot(a.re, a.im); }
template <typename R>
__device__ __forceinline__ bool v_is_zero(cx<R> a) {
  return a.re == R(0) && a.im == R(0);
}
template <>
__device__ __forceinline__ cx<float> v_one<cx<float>>() {
  return {1.0f, 0.0f};
}
template <>
__device__ __forceinline__ cx<double> v_one<cx<double>>() {
  return {1.0, 0.0};
}

// ---- the fused updates --------------------------------------------------------

constexpr int UPD_BLOCK = 256;
constexpr int UPD_MAX_BLOCKS = 2048;

__device__ __forceinline__ int64_t upd_first() {
  return static_cast<int64_t>(blockIdx.x) * UPD_BLOCK + threadIdx.x;
}
__device__ __forceinline__ int64_t upd_stride() {
  return static_cast<int64_t>(gridDim.x) * UPD_BLOCK;
}
__device__ __forceinline__ bool upd_lead() { return blockIdx.x == 0 && threadIdx.x == 0; }

// alpha = rz / pap; x += alpha p; r -= alpha ap; rz_prev = rz (cg_p_test's
// divisor, beside rz, which cg_p_test overwrites)
template <typename T>
__global__ void __launch_bounds__(UPD_BLOCK)
cg_xr_kernel(int64_t n, const T* rz, const T* pap, T* x, T* r, const T* p, const T* ap,
             T* rz_prev) {
  const T alpha = v_div(*rz, *pap);
  for (int64_t i = upd_first(); i < n; i += upd_stride()) {
    x[i] = v_add(x[i], v_mul(alpha, p[i]));
    r[i] = v_sub(r[i], v_mul(alpha, ap[i]));
  }
  if (upd_lead()) *rz_prev = *rz;
}

// beta = rzn / rz_prev; p = z + beta p; rz = rzn; the test on |rr|
template <typename T>
__global__ void __launch_bounds__(UPD_BLOCK)
cg_p_kernel(int64_t n, const T* rzn, const T* rz_prev, const T* z, T* p, T* rz, const T* rr,
            LoopTestArgs t, int test) {
  const T beta = v_div(*rzn, *rz_prev);
  for (int64_t i = upd_first(); i < n; i += upd_stride()) p[i] = v_add(z[i], v_mul(beta, p[i]));
  if (upd_lead()) {
    *rz = *rzn;
    if (test) loop_test<typename real_of<T>::type>(t, v_abs(*rr), 1);
  }
}

// The restart's selects where *brk (rho came out 0 last iteration: rho,
// alpha, omega taken as 1, p and v as 0), then beta = (rho_new / rho)
// (alpha / omega); p = r + beta (p - omega v)
template <typename T>
__global__ void __launch_bounds__(UPD_BLOCK)
bicg_p_kernel(int64_t n, const bool* brk, const T* rho_new, const T* rho, const T* alpha,
              const T* omega, const T* r, T* p, const T* v) {
  const bool b = *brk;
  const T one = v_one<T>(), zero = T();
  const T rh = b ? one : *rho, al = b ? one : *alpha, om = b ? one : *omega;
  const T beta = v_mul(v_div(*rho_new, rh), v_div(al, om));
  for (int64_t i = upd_first(); i < n; i += upd_stride()) {
    const T pv = b ? zero : p[i], vv = b ? zero : v[i];
    p[i] = v_add(r[i], v_mul(beta, v_sub(pv, v_mul(om, vv))));
  }
}

// alpha = rho_new / rv; s = r - alpha vn; v = vn; the state's alpha and rho
template <typename T>
__global__ void __launch_bounds__(UPD_BLOCK)
bicg_s_kernel(int64_t n, const T* rho_new, const T* rv, const T* r, const T* vn, T* s, T* v,
              T* rho, T* alpha) {
  const T al = v_div(*rho_new, *rv);
  for (int64_t i = upd_first(); i < n; i += upd_stride()) {
    const T vi = vn[i];
    s[i] = v_sub(r[i], v_mul(al, vi));
    v[i] = vi;
  }
  if (upd_lead()) {
    *alpha = al;
    *rho = *rho_new;
  }
}

// omega = ts / tt; r = s - omega t; the state's omega
template <typename T>
__global__ void __launch_bounds__(UPD_BLOCK)
bicg_r_kernel(int64_t n, const T* ts, const T* tt, const T* s, const T* t, T* r, T* omega) {
  const T om = v_div(*ts, *tt);
  for (int64_t i = upd_first(); i < n; i += upd_stride()) r[i] = v_sub(s[i], v_mul(om, t[i]));
  if (upd_lead()) *omega = om;
}

// x = x + alpha ph + omega sh; where rho (this iteration's) is 0, rhat = r
// (the next iteration's restart) and the flag bicg_p reads; the test on
// |rr|
template <typename T>
__global__ void __launch_bounds__(UPD_BLOCK)
bicg_x_kernel(int64_t n, const T* alpha, const T* omega, T* x, const T* ph, const T* sh,
              const T* rho, T* rhat, const T* r, bool* brk, const T* rr, LoopTestArgs t,
              int test) {
  const T al = *alpha, om = *omega;
  const bool b = v_is_zero(*rho);
  for (int64_t i = upd_first(); i < n; i += upd_stride()) {
    x[i] = v_add(v_add(x[i], v_mul(al, ph[i])), v_mul(om, sh[i]));
    if (b) rhat[i] = r[i];
  }
  if (upd_lead()) {
    *brk = b;
    if (test) loop_test<typename real_of<T>::type>(t, v_abs(*rr), 1);
  }
}

inline unsigned upd_blocks(int64_t n) {
  const int64_t b = (n + UPD_BLOCK - 1) / UPD_BLOCK;
  return static_cast<unsigned>(b < 1 ? 1 : (b > UPD_MAX_BLOCKS ? UPD_MAX_BLOCKS : b));
}

// A test argument block: the caller's, or none.
inline int test_of(const LoopTestArgs* p, LoopTestArgs* t) {
  if (p == nullptr) {
    *t = LoopTestArgs{};
    return 0;
  }
  *t = *p;
  return 1;
}

template <typename T>
int launch_cg_xr(int64_t n, const void* rz, const void* pap, void* x, void* r, const void* p,
                 const void* ap, void* rz_prev, cudaStream_t st) {
  cg_xr_kernel<T><<<upd_blocks(n), UPD_BLOCK, 0, st>>>(
      n, static_cast<const T*>(rz), static_cast<const T*>(pap), static_cast<T*>(x),
      static_cast<T*>(r), static_cast<const T*>(p), static_cast<const T*>(ap),
      static_cast<T*>(rz_prev));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cg_p(int64_t n, const void* rzn, const void* rz_prev, const void* z, void* p,
                void* rz, const void* rr, const LoopTestArgs* test, cudaStream_t st) {
  LoopTestArgs t;
  const int has = test_of(test, &t);
  cg_p_kernel<T><<<upd_blocks(n), UPD_BLOCK, 0, st>>>(
      n, static_cast<const T*>(rzn), static_cast<const T*>(rz_prev), static_cast<const T*>(z),
      static_cast<T*>(p), static_cast<T*>(rz), static_cast<const T*>(rr), t, has);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bicg_p(int64_t n, const void* brk, const void* rho_new, const void* rho,
                  const void* alpha, const void* omega, const void* r, void* p, const void* v,
                  cudaStream_t st) {
  bicg_p_kernel<T><<<upd_blocks(n), UPD_BLOCK, 0, st>>>(
      n, static_cast<const bool*>(brk), static_cast<const T*>(rho_new),
      static_cast<const T*>(rho), static_cast<const T*>(alpha), static_cast<const T*>(omega),
      static_cast<const T*>(r), static_cast<T*>(p), static_cast<const T*>(v));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bicg_s(int64_t n, const void* rho_new, const void* rv, const void* r, const void* vn,
                  void* s, void* v, void* rho, void* alpha, cudaStream_t st) {
  bicg_s_kernel<T><<<upd_blocks(n), UPD_BLOCK, 0, st>>>(
      n, static_cast<const T*>(rho_new), static_cast<const T*>(rv), static_cast<const T*>(r),
      static_cast<const T*>(vn), static_cast<T*>(s), static_cast<T*>(v), static_cast<T*>(rho),
      static_cast<T*>(alpha));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bicg_r(int64_t n, const void* ts, const void* tt, const void* s, const void* t,
                  void* r, void* omega, cudaStream_t st) {
  bicg_r_kernel<T><<<upd_blocks(n), UPD_BLOCK, 0, st>>>(
      n, static_cast<const T*>(ts), static_cast<const T*>(tt), static_cast<const T*>(s),
      static_cast<const T*>(t), static_cast<T*>(r), static_cast<T*>(omega));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bicg_x(int64_t n, const void* alpha, const void* omega, void* x, const void* ph,
                  const void* sh, const void* rho, void* rhat, const void* r, void* brk,
                  const void* rr, const LoopTestArgs* test, cudaStream_t st) {
  LoopTestArgs t;
  const int has = test_of(test, &t);
  bicg_x_kernel<T><<<upd_blocks(n), UPD_BLOCK, 0, st>>>(
      n, static_cast<const T*>(alpha), static_cast<const T*>(omega), static_cast<T*>(x),
      static_cast<const T*>(ph), static_cast<const T*>(sh), static_cast<const T*>(rho),
      static_cast<T*>(rhat), static_cast<const T*>(r), static_cast<bool*>(brk),
      static_cast<const T*>(rr), t, has);
  return static_cast<int>(cudaGetLastError());
}

// A test block that asks for a condition where the build cannot set one.
inline bool unsupported(const LoopTestArgs* test) {
  return !ATPT_WHILE && test != nullptr && test->set_cond;
}

}  // namespace atpt

// The update kernels' dtype codes: 0 float, 2 double, 3 complex64, 4
// complex128.
#define ATPT_UPDATE_DISPATCH(code, fn, ...)                              \
  switch (code) {                                                        \
    case 0: return atpt::fn<float>(__VA_ARGS__);                         \
    case 2: return atpt::fn<double>(__VA_ARGS__);                        \
    case 3: return atpt::fn<atpt::cx<float>>(__VA_ARGS__);               \
    case 4: return atpt::fn<atpt::cx<double>>(__VA_ARGS__);              \
    default: return static_cast<int>(cudaErrorInvalidValue);            \
  }

extern "C" {

// The toolkit this library was built with, the runtime and the driver
// (CUDA's version numbers, 12040 = 12.4).
int atpt_krylov_versions(int* built, int* runtime, int* driver) {
  *built = CUDART_VERSION;
  cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err == cudaSuccess) err = cudaDriverGetVersion(driver);
  return static_cast<int>(err);
}

// One launch of the loop test on `stream`.  real_code: 0 float, 2 double
// (the DTYPE_CODES of the accumulation type); test: the test's arguments
// (handle 0 with set_cond 0 outside a graph).
int atpt_krylov_test(int real_code, const atpt::LoopTestArgs* test, const void* rr, int bump,
                     const void* rho, int rho_parts, void* brk, void* stream) {
  if (test == nullptr || (rho != nullptr && brk == nullptr) ||
      (rho_parts != 1 && rho_parts != 2) || (test->log != nullptr && test->cap < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (atpt::unsupported(test)) return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool* bp = static_cast<bool*>(brk);
  if (real_code == 2)
    atpt::krylov_test_kernel<double><<<1, 1, 0, st>>>(*test, static_cast<const double*>(rr), bump,
                                                      static_cast<const double*>(rho), rho_parts,
                                                      bp);
  else if (real_code == 0)
    atpt::krylov_test_kernel<float><<<1, 1, 0, st>>>(*test, static_cast<const float*>(rr), bump,
                                                     static_cast<const float*>(rho), rho_parts,
                                                     bp);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The fused updates (see the file's head), n values a vector, on `stream`;
// code as ATPT_UPDATE_DISPATCH's; test: the loop test's arguments (nullptr:
// no test: an iteration run without it).
int atpt_cg_xr(int code, long long n, const void* rz, const void* pap, void* x, void* r,
               const void* p, const void* ap, void* rz_prev, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ATPT_UPDATE_DISPATCH(code, launch_cg_xr, n, rz, pap, x, r, p, ap, rz_prev, st)
}

int atpt_cg_p_test(int code, long long n, const void* rzn, const void* rz_prev, const void* z,
                   void* p, void* rz, const void* rr, const atpt::LoopTestArgs* test,
                   void* stream) {
  if (atpt::unsupported(test)) return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ATPT_UPDATE_DISPATCH(code, launch_cg_p, n, rzn, rz_prev, z, p, rz, rr, test, st)
}

int atpt_bicg_p(int code, long long n, const void* brk, const void* rho_new, const void* rho,
                const void* alpha, const void* omega, const void* r, void* p, const void* v,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ATPT_UPDATE_DISPATCH(code, launch_bicg_p, n, brk, rho_new, rho, alpha, omega, r, p, v, st)
}

int atpt_bicg_s(int code, long long n, const void* rho_new, const void* rv, const void* r,
                const void* vn, void* s, void* v, void* rho, void* alpha, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ATPT_UPDATE_DISPATCH(code, launch_bicg_s, n, rho_new, rv, r, vn, s, v, rho, alpha, st)
}

int atpt_bicg_r(int code, long long n, const void* ts, const void* tt, const void* s,
                const void* t, void* r, void* omega, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ATPT_UPDATE_DISPATCH(code, launch_bicg_r, n, ts, tt, s, t, r, omega, st)
}

int atpt_bicg_x_test(int code, long long n, const void* alpha, const void* omega, void* x,
                     const void* ph, const void* sh, const void* rho, void* rhat, const void* r,
                     void* brk, const void* rr, const atpt::LoopTestArgs* test, void* stream) {
  if (atpt::unsupported(test)) return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ATPT_UPDATE_DISPATCH(code, launch_bicg_x, n, alpha, omega, x, ph, sh, rho, rhat, r, brk, rr,
                       test, st)
}

// A log of `ints` int32 in mapped, zeroed host memory: *host for the host,
// *dev for kernels.
int atpt_krylov_log_alloc(long long ints, void** host, void** dev) {
  cudaError_t err = cudaHostAlloc(host, static_cast<size_t>(ints) * sizeof(int),
                                  cudaHostAllocMapped);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (long long i = 0; i < ints; ++i) static_cast<int*>(*host)[i] = 0;
  return static_cast<int>(cudaHostGetDevicePointer(dev, *host, 0));
}

// Free a log.  During a capture cudaFreeHost fails (it synchronises): the
// error is returned and cleared, and the caller frees it later.
int atpt_krylov_log_free(void* host) {
  const cudaError_t err = cudaFreeHost(host);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// A conditional handle in the graph that `outer` is capturing into (the
// handle the test kernel before the node is given).
int atpt_while_handle(void* outer, unsigned long long* handle) {
#if ATPT_WHILE
  cudaStream_t so = static_cast<cudaStream_t>(outer);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(so, &status, nullptr, &graph, nullptr, nullptr,
                                             nullptr);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(so, &status, nullptr, &graph, nullptr, nullptr);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive)
    return static_cast<int>(cudaErrorStreamCaptureImplicit);
  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  *handle = static_cast<unsigned long long>(h);
  return static_cast<int>(err);
#else
  (void)outer;
  (void)handle;
  return static_cast<int>(cudaErrorNotSupported);
#endif
}

// Add a WHILE node on `handle` at the capture point of `outer` (after what
// it captured so far), make it the point later work on `outer` depends
// on, and begin capturing `body` (a stream not capturing) into the node's
// body graph.
int atpt_while_open(void* outer, void* body, unsigned long long handle) {
#if ATPT_WHILE
  cudaStream_t so = static_cast<cudaStream_t>(outer);
  cudaStream_t sb = static_cast<cudaStream_t>(body);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = static_cast<cudaGraphConditionalHandle>(handle);
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  const cudaGraphEdgeData* edges = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(so, &status, nullptr, &graph, &deps, &edges, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive)
    return static_cast<int>(cudaErrorStreamCaptureImplicit);
  err = cudaGraphAddNode(&node, graph, deps, edges, ndeps, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(so, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(so, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive)
    return static_cast<int>(cudaErrorStreamCaptureImplicit);
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(so, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(sb, p.conditional.phGraph_out[0], nullptr,
                                                        nullptr, 0, cudaStreamCaptureModeGlobal));
#else
  (void)outer;
  (void)body;
  (void)handle;
  return static_cast<int>(cudaErrorNotSupported);
#endif
}

// End the capture of a body that atpt_while_open began.  A body that
// failed leaves its error as the runtime's last one, which every later
// launch check here would read: it is returned and cleared.
int atpt_while_close(void* body) {
#if ATPT_WHILE
  cudaGraph_t g;
  const cudaError_t err = cudaStreamEndCapture(static_cast<cudaStream_t>(body), &g);
  cudaGetLastError();
  return static_cast<int>(err);
#else
  (void)body;
  return static_cast<int>(cudaErrorNotSupported);
#endif
}

}  // extern "C"
