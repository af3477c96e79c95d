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
// writes `rows` of them once (268 MB at ncv = rows = 32, n = 1M, float32:
// 0.080 ms at 3.35 TB/s); its 2 ncv rows n flops take 0.032 ms at the
// 67 TFLOP/s float32 peak, so the FMAs must overlap the stream, not follow
// it.  The first port staged a (ncv, 256) slab of V in shared memory behind a
// barrier and re-read it for every 8 FMAs: load, barrier and compute ran in
// sequence, and shared-memory loads set the pace (0.135 ms at rows 32).
// The design:
// * V through registers: each thread owns one word of W consecutive columns
//   and loads all ncv rows of it before its first FMA.  It reads every row
//   of its columns before it writes any, and words are disjoint across
//   threads, so the in-place update needs no barrier and no second copy of
//   V.  The host plan picks W: 8-byte words for float (W = 2) and bfloat16
//   (W = 4), 16-byte for double (W = 2), narrower where the pointer or the
//   row stride allows no wider word.  Measured against 4- and 16-byte words
//   on the card (float32, rows 8-32), 8-byte words won at every row count:
//   at ~125 registers two blocks fit on an SM, and their 16 warps overlap
//   one word's FMAs with another's loads better than 8 warps of 16-byte
//   words at ~200 registers (the 16-byte float kernel went after that);
// * ncv is a compile-time bucket (16, 24, 32); below it the missing rows are
//   zeros in registers and in the Q table, so the unrolled FMA loop has no
//   branch (one with a branch per row ran 3-5% slower in float32 and 16% in
//   bfloat16).  The outputs are formed OB at a time (8 float, 4 double)
//   from Q[:, :rows] in shared memory, read as 16-byte broadcasts: one load
//   feeds 16 / sizeof(A) x W FMAs.  (Q as a kernel parameter in the
//   constant bank would need it on the host; the caller holds it on the
//   device.);
// * a fixed grid from the host plan (ops/cuda_rot.py: plan), one wave of
//   resident blocks striding over the words; the n % W columns past the
//   last word are rotated one by one by the first threads of the grid;
// * each output's chain is acc = 0; acc = fma(Q[i, o], V[i, c], acc) for
//   i = 0 .. ncv - 1 (then + 0 for the zero rows up to the bucket), the
//   order of the first port's kernel, so the bits are the same;
// * ncv above 32 takes rot_slab: a block stages the ncv rows of a 32-column
//   slab in shared memory (one row per warp at a time), synchronises, and
//   each warp forms outputs o = warp, warp + 8, ... with the same FMA chain.
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): float32,
// ncv = 32, n = 1M, rows 8/16/24/32 at 78-85% of the bound, ahead of
// Q[:, :rows]^T V at every row count.
#include "common.cuh"

namespace atpt {
namespace {

constexpr int ROT_THREADS = 256;
constexpr int ROT_SLAB = 32;  // columns per slab of the shared-memory path

// The W values of T one thread moves as one load or store.
template <typename T, int W> struct Word;
template <> struct Word<float, 1> { using type = unsigned; };
template <> struct Word<float, 2> { using type = uint2; };
template <> struct Word<__nv_bfloat16, 1> { using type = unsigned short; };
template <> struct Word<__nv_bfloat16, 2> { using type = unsigned; };
template <> struct Word<__nv_bfloat16, 4> { using type = uint2; };
template <> struct Word<double, 1> { using type = unsigned long long; };
template <> struct Word<double, 2> { using type = uint4; };

template <typename T, int W>
using WordT = typename Word<T, W>::type;

template <typename T, typename A, int W>
__device__ __forceinline__ void widen(const WordT<T, W>& w, A (&o)[W]) {
  const T* p = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int j = 0; j < W; ++j) o[j] = to_acc<A>(p[j]);
}

template <typename T, typename A, int W>
__device__ __forceinline__ WordT<T, W> narrow(const A (&a)[W]) {
  WordT<T, W> w;
  T* p = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int j = 0; j < W; ++j) p[j] = to_store<T, A>(a[j]);
  return w;
}

// Outputs formed at a time: two 16-byte Q broadcasts per basis row.
template <typename A>
struct OutBlock {
  static constexpr int value = 32 / static_cast<int>(sizeof(A));
};

// Blocks of ROT_THREADS the register kernel is compiled to fit on one SM
// (1 or 2), from an estimate of its registers: the V words as the compiler
// keeps them (bfloat16 widened to float), the accumulators and 40 more.
// ops/cuda_rot.py: blocks_per_sm mirrors it for the grid.
template <typename T, typename A, int NB, int W>
struct RotMinBlocks {
  static constexpr int regs = NB * W * static_cast<int>(sizeof(A)) / 4 +
                              OutBlock<A>::value * W * static_cast<int>(sizeof(A)) / 4 + 40;
  static constexpr int fit = 65536 / (ROT_THREADS * regs);
  static constexpr int value = fit < 1 ? 1 : (fit > 2 ? 2 : fit);
};

// V[o, c .. c + W) for o < rows, from all ncv rows of those columns.
template <typename T, typename A, int NB, int W>
__device__ __forceinline__ void rotate_word(const A* qs, int ncv, int rows, T* v0, int64_t ld) {
  constexpr int OB = OutBlock<A>::value;
  constexpr int QV = 16 / static_cast<int>(sizeof(A));  // Q values per 16-byte broadcast
  WordT<T, W> v[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i)
    v[i] = i < ncv ? *reinterpret_cast<const WordT<T, W>*>(v0 + i * ld) : WordT<T, W>{};
  for (int o0 = 0; o0 < rows; o0 += OB) {
    A acc[OB][W];
#pragma unroll
    for (int u = 0; u < OB; ++u)
#pragma unroll
      for (int j = 0; j < W; ++j) acc[u][j] = A(0);
    // no branch on ncv here: rows from ncv on hold zeros in v and qs and add
    // +0, so the unrolled loop is one block the compiler can schedule
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      A x[W];
      widen<T, A, W>(v[i], x);
      A q[OB];
#pragma unroll
      for (int b = 0; b < OB / QV; ++b) {
        const uint4 raw = reinterpret_cast<const uint4*>(qs + i * NB + o0)[b];
        const A* qa = reinterpret_cast<const A*>(&raw);
#pragma unroll
        for (int k = 0; k < QV; ++k) q[b * QV + k] = qa[k];
      }
#pragma unroll
      for (int u = 0; u < OB; ++u)
#pragma unroll
        for (int j = 0; j < W; ++j) acc[u][j] = fma(q[u], x[j], acc[u][j]);
    }
#pragma unroll
    for (int u = 0; u < OB; ++u)
      if (o0 + u < rows)
        *reinterpret_cast<WordT<T, W>*>(v0 + (o0 + u) * ld) = narrow<T, A, W>(acc[u]);
  }
}

// ncv <= NB: the register path.
template <typename T, typename A, int NB, int W>
__global__ void __launch_bounds__(ROT_THREADS, (RotMinBlocks<T, A, NB, W>::value))
rot_regs(const A* __restrict__ Q, int ldq, int ncv, int rows, T* V, int64_t ld, int64_t n) {
  __shared__ __align__(16) A qs[NB * NB];  // qs[i * NB + o] = Q[i, o], zero past ncv and rows
  for (int e = threadIdx.x; e < NB * NB; e += ROT_THREADS) {
    const int i = e / NB, o = e - i * NB;
    qs[e] = (i < ncv && o < rows) ? Q[static_cast<int64_t>(i) * ldq + o] : A(0);
  }
  __syncthreads();
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * ROT_THREADS + threadIdx.x;
  const int64_t nw = n / W;
  const int64_t step = static_cast<int64_t>(gridDim.x) * ROT_THREADS;
  for (int64_t g = tid; g < nw; g += step) rotate_word<T, A, NB, W>(qs, ncv, rows, V + g * W, ld);
  if constexpr (W > 1) {
    const int64_t c = nw * W + tid;
    if (c < n) rotate_word<T, A, NB, 1>(qs, ncv, rows, V + c, ld);
  }
}

// ncv > 32: slabs of ROT_SLAB columns staged in shared memory.
template <typename T, typename A>
__global__ void __launch_bounds__(ROT_THREADS)
rot_slab(const A* __restrict__ Q, int ldq, int ncv, int rows, T* V, int64_t ld, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vs = reinterpret_cast<T*>(smem_raw);  // (ncv, ROT_SLAB)
  constexpr int NWARP = ROT_THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t s0 = static_cast<int64_t>(blockIdx.x) * ROT_SLAB; s0 < n;
       s0 += static_cast<int64_t>(gridDim.x) * ROT_SLAB) {
    const int64_t c = s0 + lane;
    const bool ok = c < n;
    for (int i = warp; i < ncv; i += NWARP)
      vs[i * ROT_SLAB + lane] = ok ? V[i * ld + c] : to_store<T, A>(A(0));
    __syncthreads();
    if (ok) {
      for (int o = warp; o < rows; o += NWARP) {
        A acc = A(0);
        for (int i = 0; i < ncv; ++i)
          acc = fma(__ldg(Q + static_cast<int64_t>(i) * ldq + o), to_acc<A>(vs[i * ROT_SLAB + lane]),
                    acc);
        V[o * ld + c] = to_store<T, A>(acc);
      }
    }
    __syncthreads();
  }
}

// The launch the host plan chose (ops/cuda_rot.py: plan).
struct RotPlan {
  int bucket;  // 16, 24, 32: the register path; 0: the slab path
  int vec;     // W, columns per word
  int grid;
};

// W per storage type: 1 or 2, and 4 for bfloat16 (its 8-byte word)
template <typename T>
bool vec_ok(int vec) {
  return vec == 1 || vec == 2 || (vec == 4 && sizeof(T) == 2);
}

template <typename T>
size_t slab_smem(int ncv) {
  return static_cast<size_t>(ncv) * ROT_SLAB * sizeof(T);
}

// Refuse a plan the kernels cannot run safely.
template <typename T>
bool plan_ok(const RotPlan& p, int ldq, int ncv, int rows, const void* V, int64_t ld, int64_t n) {
  if (ncv < 1 || rows < 1 || rows > ncv || ldq < rows || n < 1 || ld < n || p.grid < 1) return false;
  if (p.bucket == 0) return p.vec == 1 && ncv > 32 && slab_smem<T>(ncv) <= 227 * 1024;
  if (p.bucket != 16 && p.bucket != 24 && p.bucket != 32) return false;
  if (ncv > p.bucket || !vec_ok<T>(p.vec)) return false;
  const int64_t word = static_cast<int64_t>(p.vec) * sizeof(T);
  return reinterpret_cast<uintptr_t>(V) % word == 0 &&
         (ld * static_cast<int64_t>(sizeof(T))) % word == 0;
}

template <typename T, typename A, int NB>
int launch_bucket(const RotPlan& p, const A* Q, int ldq, int ncv, int rows, T* V, int64_t ld,
                  int64_t n, cudaStream_t st) {
  switch (p.vec) {
    case 1: rot_regs<T, A, NB, 1><<<p.grid, ROT_THREADS, 0, st>>>(Q, ldq, ncv, rows, V, ld, n); break;
    case 2: rot_regs<T, A, NB, 2><<<p.grid, ROT_THREADS, 0, st>>>(Q, ldq, ncv, rows, V, ld, n); break;
    default:
      if constexpr (sizeof(T) == 2)
        rot_regs<T, A, NB, 4><<<p.grid, ROT_THREADS, 0, st>>>(Q, ldq, ncv, rows, V, ld, n);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int launch_rotate(const RotPlan& p, const void* Qv, int ldq, int ncv, int rows, void* Vv, int64_t ld,
                  int64_t n, cudaStream_t st) {
  if (!plan_ok<T>(p, ldq, ncv, rows, Vv, ld, n)) return static_cast<int>(cudaErrorInvalidValue);
  auto Q = static_cast<const A*>(Qv);
  auto V = static_cast<T*>(Vv);
  switch (p.bucket) {
    case 16: return launch_bucket<T, A, 16>(p, Q, ldq, ncv, rows, V, ld, n, st);
    case 24: return launch_bucket<T, A, 24>(p, Q, ldq, ncv, rows, V, ld, n, st);
    case 32: return launch_bucket<T, A, 32>(p, Q, ldq, ncv, rows, V, ld, n, st);
    default: break;
  }
  const size_t smem = slab_smem<T>(ncv);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rot_slab<T, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rot_slab<T, A><<<p.grid, ROT_THREADS, smem, st>>>(Q, ldq, ncv, rows, V, ld, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace atpt

extern "C" {

// V[:rows] <- Q[:, :rows]^T V in place.  Q: (ncv, ldq) in the accumulation
// type, ldq >= rows; V: (ncv, ld) storage, n columns used.  (bucket, vec,
// grid) is the host plan; a plan the kernels cannot run is refused.
int atpt_rotate_rows(int code, int bucket, int vec, int grid, const void* Q, int ldq, int ncv,
                     int rows, void* V, long long ld, long long n, void* stream) {
  const atpt::RotPlan p{bucket, vec, grid};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0: return atpt::launch_rotate<float, float>(p, Q, ldq, ncv, rows, V, ld, n, st);
    case 1: return atpt::launch_rotate<__nv_bfloat16, float>(p, Q, ldq, ncv, rows, V, ld, n, st);
    case 2: return atpt::launch_rotate<double, double>(p, Q, ldq, ncv, rows, V, ld, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
