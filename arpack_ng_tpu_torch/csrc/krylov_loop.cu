// The inner Krylov solves (CG, BiCGSTAB) of matrix-free shift-invert as
// CUDA-graph while loops: the loop test as a one-thread kernel, and the
// capture helpers that open a conditional WHILE node on a capturing stream
// and capture its body on a stream of its own
// (arpack_ng_tpu_torch/ops/cuda_krylov_loop.py binds them).
//
// krylov_test_kernel replaces the condition of the reference's
// lax.while_loop around cg and bicgstab (arpack_ng_tpu/ops/solvers.py:58-60
// and :90-92; the loops at :74 and :110), which XLA keeps on the device, so
// that a whole inner solve runs inside the outer jitted cycle.  It is no
// Pallas kernel: the reference leaves the loop to XLA.  Here the host loop
// (ops/solvers._cg, _bicgstab) reads |r.r| back once per iteration; the
// kernel takes that decision on the card instead, with the host's
// comparison (IEEE, no fast math: a nan |r.r| stops the loop as it does on
// the host):
//
//     go = it < maxiter && |r.r| > atol2,   atol2 = (tol*||b||)^2,
//
// and hands it to the node with cudaGraphSetConditional.  It runs once
// before the node (it = 0) and once at the end of the body, which first
// bumps the iteration counter, so the test runs before every iteration as
// lax.while_loop's cond does.  |r.r| is the 0-d value torch.abs(torch.vdot
// (r, r)) that the body (or the code before the node) wrote: the host
// loop's own dot.  For BiCGSTAB it also writes the rho == 0 flag that the
// next iteration's restart selects read.  When it ends the loop it appends
// (node, iterations) to a log in mapped host memory, which the host reads
// after its next synchronisation, never per solve.
//
// Bound: one launch, a few scalars (tens of bytes): the launch latency,
// which the graph's node scheduling replaces by a device-side step.  What
// a CG iteration costs is its products and vector passes (PERF.md row 14).
//
// Needs CUDA 12.4 or later (runtime and driver): conditional nodes,
// cudaStreamBeginCaptureToGraph.  Built with an older toolkit the entry
// points return cudaErrorNotSupported and atpt_krylov_versions says why.

#include <cuda_runtime.h>
#include <stdint.h>

#if CUDART_VERSION >= 12040
#define ATPT_WHILE 1
#else
#define ATPT_WHILE 0
typedef unsigned long long cudaGraphConditionalHandle;
#endif

namespace atpt {

// The loop test of one solve.  rr, atol2: 0-d of the real type R; it: the
// device iteration counter; bump: 1 at the end of the body (count the
// iteration just run), 0 before the node.  set_cond: give the decision to
// the node `handle`.  rho (nullptr for CG): BiCGSTAB's 0-d rho, rho_parts
// values of R (2 for a complex rho), whose exact zero sets *brk.  log:
// [count, (node, iterations) * cap], volatile (mapped host memory).
// go_out (optional): the decision, for the kernel's checks.
template <typename R>
__global__ void krylov_test_kernel(cudaGraphConditionalHandle handle, int set_cond, const R* rr,
                                   const R* atol2, int* it, int maxiter, int bump, const R* rho,
                                   int rho_parts, bool* brk, volatile int* log, int cap, int node,
                                   int* go_out) {
  int i = *it;
  if (bump) {
    i += 1;
    *it = i;
  }
  const bool go = i < maxiter && *rr > *atol2;
#if ATPT_WHILE
  if (set_cond) cudaGraphSetConditional(handle, go ? 1u : 0u);
#endif
  if (rho != nullptr) {
    bool zero = rho[0] == R(0);
    if (rho_parts == 2) zero = zero && rho[1] == R(0);
    *brk = zero;
  }
  if (!go && log != nullptr) {
    const int c = log[0];
    if (c < cap) {
      log[1 + 2 * c] = node;
      log[2 + 2 * c] = i;
    }
    log[0] = c + 1;
  }
  if (go_out != nullptr) *go_out = go ? 1 : 0;
}

}  // namespace atpt

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
// (the DTYPE_CODES of the accumulation type); handle 0 with set_cond 0
// outside a graph.
int atpt_krylov_test(int real_code, unsigned long long handle, int set_cond, const void* rr,
                     const void* atol2, void* it, int maxiter, int bump, const void* rho,
                     int rho_parts, void* brk, void* log, int cap, int node, void* go_out,
                     void* stream) {
  if ((rho != nullptr && brk == nullptr) || (rho_parts != 1 && rho_parts != 2) ||
      (log != nullptr && cap < 1))
    return static_cast<int>(cudaErrorInvalidValue);
#if !ATPT_WHILE
  if (set_cond) return static_cast<int>(cudaErrorNotSupported);
#endif
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaGraphConditionalHandle h = static_cast<cudaGraphConditionalHandle>(handle);
  int* itp = static_cast<int*>(it);
  bool* bp = static_cast<bool*>(brk);
  volatile int* lp = static_cast<volatile int*>(log);
  int* gp = static_cast<int*>(go_out);
  if (real_code == 2)
    atpt::krylov_test_kernel<double><<<1, 1, 0, st>>>(
        h, set_cond, static_cast<const double*>(rr), static_cast<const double*>(atol2), itp,
        maxiter, bump, static_cast<const double*>(rho), rho_parts, bp, lp, cap, node, gp);
  else if (real_code == 0)
    atpt::krylov_test_kernel<float><<<1, 1, 0, st>>>(
        h, set_cond, static_cast<const float*>(rr), static_cast<const float*>(atol2), itp, maxiter,
        bump, static_cast<const float*>(rho), rho_parts, bp, lp, cap, node, gp);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
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
