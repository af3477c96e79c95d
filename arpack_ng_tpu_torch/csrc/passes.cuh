// Projection and update passes over basis rows for NVIDIA Hopper (sm_90a),
// shared by the classical Gram-Schmidt kernels (cgs.cu: rows 0..rows) and
// the eta-subset event kernels (sel.cu: rows idx[0..K), picked by index):
//
//   proj:    h[k] = <V[row(k)], w>                        k < rows
//   update:  r = w - sum_k h[k] V[row(k)]   (+ ||r||^2)
//
// row(k) = idx[k] when the compile-time flag IDX is set, else k.  The CGS
// update is out of place (w is never written); the event update is in
// place (w == r).
//
// Bound: device-memory bandwidth.  A pass reads `rows` basis rows and w
// once (the update also writes r once): 2 flops per 4-byte value, far under
// the card's ridge, so the only aim is to keep HBM busy.  At n ~ 1M and 3.35
// TB/s, Little's law asks for ~32 KB in flight on each of the 132 SMs.
// The design:
// * the bucket (8, 16, 24, 32 rows) is a template parameter: every row of
//   a column group is loaded before any arithmetic, and no block barrier
//   sits inside the column loop.  A smaller row count is masked inside its
//   bucket; more than 32 rows loop over groups of 32.  Rows picked by index
//   come from a shared-memory copy of idx that each block loads once;
// * streaming through registers: each of 256 threads issues 16-byte loads
//   of all R rows of 1-4 column vectors (R x cols = 16-32 loads, 64-128 KB
//   in flight per SM), then does the FMAs.  (A ring of 1-D bulk copies into
//   shared memory behind a producer warp was measured against it and was
//   no faster beyond the spread between runs; PERF.md section 6);
// * a fixed persistent grid (the host plan, ops/cuda_cgs.py: >= 132
//   blocks, and enough blocks that no thread adds more than PASS_RUN
//   vectors into one sum; a plan that breaks this is refused), each block
//   walking its column tiles in a fixed order: results are bit-identical
//   run to run;
// * one launch per call: each block writes its partial dots (or partial
//   ||r||^2), and the last block to finish (a __threadfence and an integer
//   ticket, which it resets) sums them in a fixed tree order.  No
//   floating-point atomics; each thread's sequential run is at most 32
//   vector sums, so the rounding stays tree-like, as the 8*log2(n)*eps
//   omega noise model assumes (common.cuh);
// * a zero coefficient skips its row's bytes entirely (a branch uniform
//   across the block, since h is): a zero h returns w bit for bit;
// * in place, r is read and then written by the same thread, so the event
//   update takes r without __restrict__ and reads it through the coherent
//   path, never __ldg;
// * a misaligned pointer or a row stride that is not a multiple of 16
//   bytes takes the scalar instantiation (vec = 1); the n % vec values past
//   the last whole vector are added by one thread of the last block.
#pragma once

#include "common.cuh"

#include <type_traits>

namespace atpt {
namespace {

constexpr int PASS_THREADS = 256;  // threads per block
constexpr int PASS_RUN = 32;       // most vectors one thread adds into a sum
constexpr int PASS_MAX_ROWS = 256;
constexpr int PASS_MAX_WARPS = PASS_THREADS / 32;

// ---- 16-byte vectors ------------------------------------------------------

// The raw bits of VEC consecutive values of T: one 16-byte word, or one
// scalar on the scalar path.
template <typename T> struct Bits;
template <> struct Bits<float> { using type = unsigned; };
template <> struct Bits<__nv_bfloat16> { using type = unsigned short; };
template <> struct Bits<double> { using type = unsigned long long; };

template <typename T, bool VECT>
using Raw = typename std::conditional<VECT, uint4, typename Bits<T>::type>::type;

template <typename T, bool VECT>
struct Lanes {
  static constexpr int VEC = VECT ? 16 / static_cast<int>(sizeof(T)) : 1;
};

template <typename T, bool VECT>
__device__ __forceinline__ Raw<T, VECT> load_raw(const T* p) {
  return __ldg(reinterpret_cast<const Raw<T, VECT>*>(p));
}

// Raw bits -> VEC values of the accumulation type.
__device__ __forceinline__ void widen(unsigned u, float* o) { o[0] = __uint_as_float(u); }
__device__ __forceinline__ void widen(unsigned short u, float* o) {
  o[0] = __uint_as_float(static_cast<unsigned>(u) << 16);
}
__device__ __forceinline__ void widen(unsigned long long u, double* o) {
  o[0] = __longlong_as_double(static_cast<long long>(u));
}
template <typename T>
__device__ __forceinline__ void widen16(uint4 u, float* o);
template <>
__device__ __forceinline__ void widen16<float>(uint4 u, float* o) {
  o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void widen16<__nv_bfloat16>(uint4 u, float* o) {
  const unsigned q[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(q[i] << 16);
    o[2 * i + 1] = __uint_as_float(q[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen16d(uint4 u, double* o) {
  o[0] = __hiloint2double(static_cast<int>(u.y), static_cast<int>(u.x));
  o[1] = __hiloint2double(static_cast<int>(u.w), static_cast<int>(u.z));
}

// One 16-byte word of the accumulation type.
__device__ __forceinline__ void unpack(uint4 u, float* o) { widen16<float>(u, o); }
__device__ __forceinline__ void unpack(uint4 u, double* o) { widen16d(u, o); }

template <typename T, typename A, bool VECT>
__device__ __forceinline__ void widen_raw(Raw<T, VECT> r, A* o) {
  if constexpr (!VECT) {
    widen(r, o);
  } else if constexpr (std::is_same<A, double>::value) {
    widen16d(r, o);
  } else {
    widen16<T>(r, o);
  }
}

// N values of the accumulation type from p (16-byte words when VECT),
// through the read-only path when NC (p is not written by the kernel).
template <typename A, int N, bool VECT, bool NC>
__device__ __forceinline__ void load_acc(const A* p, A* o) {
  if constexpr (!VECT) {
    o[0] = NC ? __ldg(p) : p[0];
  } else {
    constexpr int PER = 16 / static_cast<int>(sizeof(A));
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int j = 0; j < N / PER; ++j) unpack(NC ? __ldg(q + j) : q[j], o + j * PER);
  }
}

template <typename A, int N, bool VECT>
__device__ __forceinline__ void store_acc(A* p, const A* v) {
  if constexpr (!VECT) {
    p[0] = v[0];
  } else if constexpr (std::is_same<A, double>::value) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j)
      reinterpret_cast<double2*>(p)[j] = make_double2(v[2 * j], v[2 * j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      reinterpret_cast<float4*>(p)[j] =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  }
}

// Pairwise sum of N (a power of two) values.
template <int N, typename A>
__device__ __forceinline__ A tree_sum(A* x) {
#pragma unroll
  for (int s = N / 2; s > 0; s /= 2) {
#pragma unroll
    for (int i = 0; i < s; ++i) x[i] += x[i + s];
  }
  return x[0];
}

// Row k of the pass: V[rs[k]] (rows picked by index), else V[k].
template <bool IDX, typename T>
__device__ __forceinline__ const T* row_ptr(const T* V, const int* rs, int k, int64_t ld) {
  return V + static_cast<int64_t>(IDX ? rs[k] : k) * ld;
}

// The block's copy of idx[0..rows), read once (the caller syncs).
template <bool IDX>
__device__ __forceinline__ void load_rows(const int* idx, int rows, int* rs) {
  if constexpr (IDX)
    for (int k = threadIdx.x; k < rows; k += PASS_THREADS) rs[k] = idx[k];
}

// ---- the cross-block sums -------------------------------------------------

// Sum of v[k] over the block for k < live, written to dst[k * stride]:
// warp trees, then the warps in order.  Every thread calls it.
template <typename A, int R>
__device__ __forceinline__ void block_rows_sum(A (&v)[R], A (*red)[R], A* dst,
                                               int64_t stride, int live) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const A s = warp_sum(v[k]);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < live) {
    A s = A(0);
    for (int w = 0; w < nwarp; ++w) s += red[w][threadIdx.x];
    dst[threadIdx.x * stride] = s;
  }
  __syncthreads();
}

// True in every thread of the last block to finish.  Each block's partials
// are fenced before its ticket is taken.
__device__ __forceinline__ bool last_block(unsigned* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  return last;
}

// out[k] = sum over the grid's partials of row k, k < rows, in a fixed
// order: warp w takes rows w, w + nwarp, ...; each lane a strided run of
// the blocks, then the warp tree.  Resets the ticket for the next call.
template <typename A>
__device__ __forceinline__ void sum_partials(const A* partial, int rows, A* out,
                                             unsigned* ticket) {
  __threadfence();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5, grid = gridDim.x;
  for (int k = warp; k < rows; k += nwarp) {
    A s = A(0);
    for (int b = lane; b < grid; b += 32) s += __ldcg(partial + static_cast<int64_t>(k) * grid + b);
    s = warp_sum(s);
    if (lane == 0) out[k] = s;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// ---- the passes -----------------------------------------------------------

// Column vectors per thread per step: R * COLS loads in flight.
template <int R>
struct Cols {
  static constexpr int value = R <= 8 ? 4 : R <= 16 ? 2 : 1;
};

// The indexed projection takes half as many at R = 8 and one from R = 16,
// which ran faster on the card there (the update did not gain); the CGS
// projection keeps its own, so that it rounds as before.
template <int R, bool IDX>
struct ProjCols {
  static constexpr int value = IDX ? (R <= 8 ? 2 : 1) : Cols<R>::value;
};

// h[k] = <V[row(k)], w>, k < rows.
template <typename T, typename A, int R, bool VECT, bool IDX>
__device__ __forceinline__ void proj_pass(const int* idx, int rows, const T* V, int64_t ld,
                                          const A* w, int64_t n, A* partial, unsigned* ticket,
                                          A* out) {
  constexpr int VEC = Lanes<T, VECT>::VEC, COLS = ProjCols<R, IDX>::value;
  __shared__ A red[PASS_MAX_WARPS][R];
  __shared__ int rs[IDX ? PASS_MAX_ROWS : 1];
  load_rows<IDX>(idx, rows, rs);
  if constexpr (IDX) __syncthreads();
  const int64_t nv = n / VEC;
  const int64_t step = static_cast<int64_t>(gridDim.x) * COLS * PASS_THREADS;
  const int tail = static_cast<int>(n - nv * VEC);
  const bool tail_thread = tail > 0 && blockIdx.x == gridDim.x - 1 && threadIdx.x == 0;
  for (int r0 = 0; r0 < rows; r0 += R) {
    const int live = min(R, rows - r0);
    A acc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k] = A(0);
    for (int64_t c0 = static_cast<int64_t>(blockIdx.x) * COLS * PASS_THREADS + threadIdx.x;
         c0 < nv; c0 += step) {
      Raw<T, VECT> v[COLS][R];
      A x[COLS][VEC];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int64_t col = c0 + c * PASS_THREADS;
        const bool ok = col < nv;
        if (ok) {
          load_acc<A, VEC, VECT, true>(w + col * VEC, x[c]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) x[c][i] = A(0);
        }
#pragma unroll
        for (int k = 0; k < R; ++k)
          v[c][k] = (ok && k < live)
                        ? load_raw<T, VECT>(row_ptr<IDX>(V, rs, r0 + k, ld) + col * VEC)
                        : Raw<T, VECT>{};
      }
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          A e[VEC];
          widen_raw<T, A, VECT>(v[c][k], e);
#pragma unroll
          for (int i = 0; i < VEC; ++i) e[i] *= x[c][i];
          acc[k] += tree_sum<VEC>(e);
        }
      }
    }
    if (tail_thread) {
      const int64_t c = nv * VEC;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (k < live) {
          const T* Vk = row_ptr<IDX>(V, rs, r0 + k, ld);
          A s = A(0);
          for (int i = 0; i < tail; ++i) s += to_acc<A>(Vk[c + i]) * w[c + i];
          acc[k] += s;
        }
      }
    }
    block_rows_sum<A, R>(acc, red, partial + static_cast<int64_t>(r0) * gridDim.x + blockIdx.x,
                         gridDim.x, live);
  }
  if (last_block(ticket)) sum_partials(partial, rows, out, ticket);
}

// r = w - sum_{k < rows} h[k] V[row(k)] (+ ||r||^2 into norm_out[0]).  With
// IDX the pass is in place (w == r): w is read through the coherent path.
template <typename T, typename A, int R, bool VECT, bool NORM, bool IDX>
__device__ __forceinline__ void update_pass(const int* idx, const A* h, int rows, const T* V,
                                            int64_t ld, const A* w, A* r, int64_t n,
                                            A* partial, unsigned* ticket, A* norm_out) {
  constexpr int VEC = Lanes<T, VECT>::VEC, COLS = Cols<R>::value;
  __shared__ A hs[PASS_MAX_ROWS];
  __shared__ int rs[IDX ? PASS_MAX_ROWS : 1];
  __shared__ A red[PASS_MAX_WARPS][1];
  for (int k = threadIdx.x; k < rows; k += PASS_THREADS) hs[k] = h[k];
  load_rows<IDX>(idx, rows, rs);
  __syncthreads();
  const int64_t nv = n / VEC;
  const int64_t step = static_cast<int64_t>(gridDim.x) * COLS * PASS_THREADS;
  A ss[1] = {A(0)};
  for (int64_t c0 = static_cast<int64_t>(blockIdx.x) * COLS * PASS_THREADS + threadIdx.x;
       c0 < nv; c0 += step) {
    A x[COLS][VEC];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int64_t col = c0 + c * PASS_THREADS;
      if (col < nv) {
        load_acc<A, VEC, VECT, !IDX>(w + col * VEC, x[c]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) x[c][i] = A(0);
      }
    }
    for (int r0 = 0; r0 < rows; r0 += R) {
      A hk[R];
      Raw<T, VECT> v[COLS][R];
#pragma unroll
      for (int k = 0; k < R; ++k) hk[k] = k < rows - r0 ? hs[r0 + k] : A(0);
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int64_t col = c0 + c * PASS_THREADS;
#pragma unroll
        for (int k = 0; k < R; ++k)
          v[c][k] = (col < nv && hk[k] != A(0))
                        ? load_raw<T, VECT>(row_ptr<IDX>(V, rs, r0 + k, ld) + col * VEC)
                        : Raw<T, VECT>{};
      }
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          if (hk[k] != A(0)) {
            A e[VEC];
            widen_raw<T, A, VECT>(v[c][k], e);
#pragma unroll
            for (int i = 0; i < VEC; ++i) x[c][i] = fma(-hk[k], e[i], x[c][i]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int64_t col = c0 + c * PASS_THREADS;
      if (col < nv) {
        store_acc<A, VEC, VECT>(r + col * VEC, x[c]);
        if (NORM) {
          A e[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) e[i] = x[c][i] * x[c][i];
          ss[0] += tree_sum<VEC>(e);
        }
      }
    }
  }
  const int tail = static_cast<int>(n - nv * VEC);
  if (tail > 0 && blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    A s = A(0);
    for (int i = 0; i < tail; ++i) {
      const int64_t c = nv * VEC + i;
      A a = w[c];
      for (int k = 0; k < rows; ++k)
        if (hs[k] != A(0)) a = fma(-hs[k], to_acc<A>(row_ptr<IDX>(V, rs, k, ld)[c]), a);
      r[c] = a;
      s += a * a;
    }
    ss[0] += s;
  }
  if (!NORM) return;
  block_rows_sum<A, 1>(ss, red, partial + blockIdx.x, 0, 1);
  if (last_block(ticket)) sum_partials(partial, 1, norm_out, ticket);
}

// ---- the kernels ----------------------------------------------------------

template <typename T, typename A, int R, bool VECT>
__global__ void __launch_bounds__(PASS_THREADS, 1)
cgs_proj_regs(int rows, const T* __restrict__ V, int64_t ld, const A* __restrict__ w,
              int64_t n, A* __restrict__ partial, unsigned* __restrict__ ticket,
              A* __restrict__ out) {
  proj_pass<T, A, R, VECT, false>(nullptr, rows, V, ld, w, n, partial, ticket, out);
}

template <typename T, typename A, int R, bool VECT>
__global__ void __launch_bounds__(PASS_THREADS, 1)
sel_proj_regs(const int* __restrict__ idx, int rows, const T* __restrict__ V, int64_t ld,
              const A* __restrict__ w, int64_t n, A* __restrict__ partial,
              unsigned* __restrict__ ticket, A* __restrict__ out) {
  proj_pass<T, A, R, VECT, true>(idx, rows, V, ld, w, n, partial, ticket, out);
}

template <typename T, typename A, int R, bool VECT, bool NORM>
__global__ void __launch_bounds__(PASS_THREADS, 1)
cgs_update_regs(const A* __restrict__ h, int rows, const T* __restrict__ V, int64_t ld,
                const A* __restrict__ w, A* __restrict__ r, int64_t n,
                A* __restrict__ partial, unsigned* __restrict__ ticket,
                A* __restrict__ norm_out) {
  update_pass<T, A, R, VECT, NORM, false>(nullptr, h, rows, V, ld, w, r, n, partial, ticket,
                                          norm_out);
}

// In place: r is both w and the output, so it carries no __restrict__.
template <typename T, typename A, int R, bool VECT, bool NORM>
__global__ void __launch_bounds__(PASS_THREADS, 1)
sel_update_regs(const int* __restrict__ idx, const A* __restrict__ s, int rows,
                const T* __restrict__ V, int64_t ld, A* r, int64_t n,
                A* __restrict__ partial, unsigned* __restrict__ ticket,
                A* __restrict__ norm_out) {
  update_pass<T, A, R, VECT, NORM, true>(idx, s, rows, V, ld, r, r, n, partial, ticket,
                                         norm_out);
}

// ---- launches ---------------------------------------------------------------

// The launch arguments the host plan chose (ops/cuda_cgs.py: plan).
struct Plan {
  int bucket;  // 8, 16, 24 or 32
  int vect;    // 1: 16-byte vectors, 0: the scalar path
  int grid;
};

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Refuse a plan the kernels cannot run safely, or whose grid would leave a
// thread more than PASS_RUN vectors to add into one sum.
template <typename T>
bool plan_ok(const Plan& p, int rows, const void* V, int64_t ld, const void* w, const void* r,
             int64_t n) {
  if (p.bucket != 8 && p.bucket != 16 && p.bucket != 24 && p.bucket != 32) return false;
  if (rows < 1 || rows > PASS_MAX_ROWS || (rows > p.bucket && p.bucket != 32)) return false;
  if (p.grid < 1 || (p.vect != 0 && p.vect != 1) || n < 1) return false;
  if (p.vect && !(aligned16(V) && aligned16(w) && (r == nullptr || aligned16(r)) &&
                  (ld * static_cast<int64_t>(sizeof(T))) % 16 == 0))
    return false;
  const int64_t nv = n / (p.vect ? Lanes<T, true>::VEC : 1);
  return static_cast<int64_t>(p.grid) * PASS_THREADS * PASS_RUN >= nv;
}

template <typename T, typename A, int R, bool VECT, bool IDX>
void proj_launch(const Plan& p, const int* idx, int rows, const T* V, int64_t ld, const A* w,
                 int64_t n, A* partial, unsigned* ticket, A* out, cudaStream_t st) {
  if constexpr (IDX) {
    sel_proj_regs<T, A, R, VECT><<<p.grid, PASS_THREADS, 0, st>>>(idx, rows, V, ld, w, n,
                                                                  partial, ticket, out);
  } else {
    cgs_proj_regs<T, A, R, VECT><<<p.grid, PASS_THREADS, 0, st>>>(rows, V, ld, w, n, partial,
                                                                  ticket, out);
  }
}

template <typename T, typename A, int R, bool IDX>
int proj_bucket(const Plan& p, const int* idx, int rows, const T* V, int64_t ld, const A* w,
                int64_t n, A* partial, unsigned* ticket, A* out, cudaStream_t st) {
  if (p.vect) {
    proj_launch<T, A, R, true, IDX>(p, idx, rows, V, ld, w, n, partial, ticket, out, st);
  } else {
    proj_launch<T, A, R, false, IDX>(p, idx, rows, V, ld, w, n, partial, ticket, out, st);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A, bool IDX>
int proj_typed(const Plan& p, const void* idx, int rows, const void* V, int64_t ld,
               const void* w, int64_t n, void* partial, void* ticket, void* out,
               cudaStream_t st) {
  if (!plan_ok<T>(p, rows, V, ld, w, nullptr, n) || (IDX && idx == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto it = static_cast<const int*>(idx);
  auto Vt = static_cast<const T*>(V);
  auto wt = static_cast<const A*>(w);
  auto pt = static_cast<A*>(partial);
  auto tk = static_cast<unsigned*>(ticket);
  auto ot = static_cast<A*>(out);
  switch (p.bucket) {
    case 8: return proj_bucket<T, A, 8, IDX>(p, it, rows, Vt, ld, wt, n, pt, tk, ot, st);
    case 16: return proj_bucket<T, A, 16, IDX>(p, it, rows, Vt, ld, wt, n, pt, tk, ot, st);
    case 24: return proj_bucket<T, A, 24, IDX>(p, it, rows, Vt, ld, wt, n, pt, tk, ot, st);
    default: return proj_bucket<T, A, 32, IDX>(p, it, rows, Vt, ld, wt, n, pt, tk, ot, st);
  }
}

template <typename T, typename A, int R, bool VECT, bool NORM, bool IDX>
void update_launch(const Plan& p, const int* idx, const A* h, int rows, const T* V, int64_t ld,
                   const A* w, A* r, int64_t n, A* partial, unsigned* ticket, A* norm_out,
                   cudaStream_t st) {
  if constexpr (IDX) {
    sel_update_regs<T, A, R, VECT, NORM><<<p.grid, PASS_THREADS, 0, st>>>(
        idx, h, rows, V, ld, r, n, partial, ticket, norm_out);
  } else {
    cgs_update_regs<T, A, R, VECT, NORM><<<p.grid, PASS_THREADS, 0, st>>>(
        h, rows, V, ld, w, r, n, partial, ticket, norm_out);
  }
}

template <typename T, typename A, int R, bool NORM, bool IDX>
int update_bucket(const Plan& p, const int* idx, const A* h, int rows, const T* V, int64_t ld,
                  const A* w, A* r, int64_t n, A* partial, unsigned* ticket, A* norm_out,
                  cudaStream_t st) {
  if (p.vect) {
    update_launch<T, A, R, true, NORM, IDX>(p, idx, h, rows, V, ld, w, r, n, partial, ticket,
                                            norm_out, st);
  } else {
    update_launch<T, A, R, false, NORM, IDX>(p, idx, h, rows, V, ld, w, r, n, partial, ticket,
                                             norm_out, st);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A, bool NORM, bool IDX>
int update_norm(const Plan& p, const int* idx, const A* h, int rows, const T* V, int64_t ld,
                const A* w, A* r, int64_t n, A* partial, unsigned* ticket, A* norm_out,
                cudaStream_t st) {
  switch (p.bucket) {
    case 8: return update_bucket<T, A, 8, NORM, IDX>(p, idx, h, rows, V, ld, w, r, n, partial, ticket, norm_out, st);
    case 16: return update_bucket<T, A, 16, NORM, IDX>(p, idx, h, rows, V, ld, w, r, n, partial, ticket, norm_out, st);
    case 24: return update_bucket<T, A, 24, NORM, IDX>(p, idx, h, rows, V, ld, w, r, n, partial, ticket, norm_out, st);
    default: return update_bucket<T, A, 32, NORM, IDX>(p, idx, h, rows, V, ld, w, r, n, partial, ticket, norm_out, st);
  }
}

template <typename T, typename A, bool IDX>
int update_typed(const Plan& p, const void* idx, const void* h, int rows, const void* V,
                 int64_t ld, const void* w, void* r, int64_t n, void* partial, void* ticket,
                 void* norm_out, cudaStream_t st) {
  if (!plan_ok<T>(p, rows, V, ld, w, r, n) || (IDX && idx == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto args = [&](auto norm) {
    return update_norm<T, A, decltype(norm)::value, IDX>(
        p, static_cast<const int*>(idx), static_cast<const A*>(h), rows,
        static_cast<const T*>(V), ld, static_cast<const A*>(w), static_cast<A*>(r), n,
        static_cast<A*>(partial), static_cast<unsigned*>(ticket), static_cast<A*>(norm_out),
        st);
  };
  return norm_out != nullptr ? args(std::true_type{}) : args(std::false_type{});
}

// The dtype code of the C interface (common.cuh) -> the typed pass.
template <bool IDX>
int proj_code(int code, const Plan& p, const void* idx, int rows, const void* V, int64_t ld,
              const void* w, int64_t n, void* partial, void* ticket, void* out,
              cudaStream_t st) {
  switch (code) {
    case 0: return proj_typed<float, float, IDX>(p, idx, rows, V, ld, w, n, partial, ticket, out, st);
    case 1: return proj_typed<__nv_bfloat16, float, IDX>(p, idx, rows, V, ld, w, n, partial, ticket, out, st);
    case 2: return proj_typed<double, double, IDX>(p, idx, rows, V, ld, w, n, partial, ticket, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool IDX>
int update_code(int code, const Plan& p, const void* idx, const void* h, int rows,
                const void* V, int64_t ld, const void* w, void* r, int64_t n, void* partial,
                void* ticket, void* norm_out, cudaStream_t st) {
  switch (code) {
    case 0: return update_typed<float, float, IDX>(p, idx, h, rows, V, ld, w, r, n, partial, ticket, norm_out, st);
    case 1: return update_typed<__nv_bfloat16, float, IDX>(p, idx, h, rows, V, ld, w, r, n, partial, ticket, norm_out, st);
    case 2: return update_typed<double, double, IDX>(p, idx, h, rows, V, ld, w, r, n, partial, ticket, norm_out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace atpt
