// Gather kernels for NVIDIA Hopper (sm_90a): the two Pallas probes of
// benchmarks/bench_gather_primitives.py, and an empty kernel whose time is
// the launch floor of the timing harness (arpack_ng_tpu_torch/bench/timing.py).
//
// take_flat replaces pl_take (bench_gather_primitives.py:118, its
// pallas_call at :123):  out.flat[i] = x.flat[cols.flat[i]].  On the TPU, x
// (1 MiB at the probe's shape) sat in VMEM and the kernel gathered from
// there.  Here x stays in device memory and is read through the read-only
// path (ld.global.nc): 1 MiB lives in the 50 MB L2 after its first touch.
// Bound: bytes, the int32 indices read once, the output written once and x
// once (17.8 MB for 2^21 elements of 2^18 values).  What limits it is the
// rate of random 4-byte reads: each moves a 32-byte sector, and the L1/L2
// path serves them about as fast for this kernel as for torch's
// index_select.  Each thread loads 4 indices with one 16-byte load, issues
// its 4 independent loads of x, then stores 16 bytes; neighbouring threads
// touch neighbouring 16-byte words of cols and out; a thread past the last
// whole word takes one value of the tail.  Measured against it on the card
// and slower at the probe's shape (PERF.md section 6): x split over the
// shared memory of a thread-block cluster and read per index through
// distributed shared memory (a random remote read costs more than an L2
// sector); the same split with the indices bucketed by owner block and
// exchanged in bulk; the same split with index tiles multicast by TMA and
// each block writing the outputs whose values it holds; a persistent grid
// with 4 index words per thread; 2 words per thread; an L2 prefetch of x;
// loads that bypass L1.
//
// take_lanes replaces pl_tal (bench_gather_primitives.py:139, call at
// :143):  out[r, l] = X[r, lidx[r, l]] for rows of 128 values (the TPU's
// lane gather).  Bound: bytes, 3 x 4 bytes per element.  One warp owns one
// row: each lane loads 4 consecutive values of the row (one 16-byte load)
// and its 4 indices (one 16-byte load), and gets each wanted value from the
// lane that holds it with __shfl_sync: 4 shuffles (one per component) and 3
// selects per output.  A shuffle's source lane wraps mod 32, so an index
// out of range still reads inside the row.  Measured against it on the card
// (PERF.md section 6): the row staged in shared memory and read by index,
// equal within the run-to-run spread at 2048 and 16384 rows and able to
// read outside its stage on an unchecked index; several rows per warp with
// every load issued before the first selection, on a persistent grid,
// slower.
//
// Neither kernel checks an index: the wrapper (ops/cuda_gather.py) does,
// unless the caller turns the check off.
#include <cuda_runtime.h>
#include <stdint.h>

namespace atpt {
namespace {

constexpr int GATHER_THREADS = 256;
constexpr int LANES_WIDTH = 128;
constexpr int LANES_WARPS = GATHER_THREADS / 32;

template <int VEC>
__global__ void __launch_bounds__(GATHER_THREADS)
take_flat_kernel(const float* __restrict__ x, const int* __restrict__ cols,
                 float* __restrict__ out, int64_t nel) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * GATHER_THREADS + threadIdx.x;
  const int64_t nvec = nel / VEC;
  if (t < nvec) {
    if constexpr (VEC == 4) {
      const int4 c = __ldcs(reinterpret_cast<const int4*>(cols) + t);
      float4 o;
      o.x = __ldg(x + c.x);
      o.y = __ldg(x + c.y);
      o.z = __ldg(x + c.z);
      o.w = __ldg(x + c.w);
      __stcs(reinterpret_cast<float4*>(out) + t, o);
    } else {
      out[t] = __ldg(x + __ldg(cols + t));
    }
    return;
  }
  // the tail past the last whole vector, one value per thread
  const int64_t i = nvec * VEC + (t - nvec);
  if (i < nel) out[i] = __ldg(x + __ldg(cols + i));
}

__global__ void __launch_bounds__(GATHER_THREADS)
take_lanes_kernel(const float* __restrict__ X, const int* __restrict__ lidx,
                  float* __restrict__ out, int64_t rows) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * LANES_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;  // a whole warp leaves together
  const int64_t base = r * LANES_WIDTH + 4 * lane;
  const float4 row = __ldcs(reinterpret_cast<const float4*>(X + base));
  const int4 j = __ldcs(reinterpret_cast<const int4*>(lidx + base));
  const int want[4] = {j.x, j.y, j.z, j.w};
  float got[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int src = want[k] >> 2;
    const float a = __shfl_sync(0xffffffffu, row.x, src);
    const float b = __shfl_sync(0xffffffffu, row.y, src);
    const float c = __shfl_sync(0xffffffffu, row.z, src);
    const float d = __shfl_sync(0xffffffffu, row.w, src);
    const int sub = want[k] & 3;
    got[k] = sub == 0 ? a : sub == 1 ? b : sub == 2 ? c : d;
  }
  __stcs(reinterpret_cast<float4*>(out + base), make_float4(got[0], got[1], got[2], got[3]));
}

__global__ void noop_kernel() {}

}  // namespace
}  // namespace atpt

extern "C" {

// out[i] = x[cols[i]], i < nel; float32 values, int32 indices in [0, len(x)).
// vec = 4: cols and out 16-byte aligned; vec = 1: any alignment.
int atpt_take_flat(int vec, const void* x, const void* cols, long long nel, void* out,
                   void* stream) {
  if (nel < 0 || (vec != 1 && vec != 4)) return static_cast<int>(cudaErrorInvalidValue);
  if (nel == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one thread per vector, plus one per tail value
  const int64_t threads = nel / vec + nel % vec;
  const unsigned grid = static_cast<unsigned>((threads + atpt::GATHER_THREADS - 1) /
                                              atpt::GATHER_THREADS);
  const float* xf = static_cast<const float*>(x);
  const int* ci = static_cast<const int*>(cols);
  float* of = static_cast<float*>(out);
  if (vec == 4)
    atpt::take_flat_kernel<4><<<grid, atpt::GATHER_THREADS, 0, st>>>(xf, ci, of, nel);
  else
    atpt::take_flat_kernel<1><<<grid, atpt::GATHER_THREADS, 0, st>>>(xf, ci, of, nel);
  return static_cast<int>(cudaGetLastError());
}

// out[r, l] = X[r, lidx[r, l]] for rows x 128 float32 values, int32 lidx in
// [0, 128); X, lidx and out contiguous and 16-byte aligned.
int atpt_take_lanes(const void* X, const void* lidx, long long rows, void* out, void* stream) {
  if (rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((rows + atpt::LANES_WARPS - 1) / atpt::LANES_WARPS);
  atpt::take_lanes_kernel<<<grid, atpt::GATHER_THREADS, 0, st>>>(
      static_cast<const float*>(X), static_cast<const int*>(lidx), static_cast<float*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

// One empty block on `stream`: the launch floor of a timing harness.
int atpt_noop(void* stream) {
  atpt::noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
