// DIA (diagonal-set) sparse matrix-vector product for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel arpack_ng_tpu/ops/pallas_dia.py:47
// make_pallas_dia_matvec, the hand-scheduled form of the DIA operator of
// arpack_ng_tpu/ops/sparse.py:92-115 (dia_matvec_fn):
//   y[i] = sum_k dtab[k, i] * x[i + off_k]   for i < n, x read as zero
//          outside [0, n);  y[n:n_pad] = 0.
// It is the matvec of every operator that from_scipy imports as DIA
// (banded matrices, stencils, RCM-banded meshes).  Its epilogue forms
// (atpt_dia_matvec_sub) fold the subtraction and scaling of each IC(0) /
// ILU(0) Neumann sweep into the same launch (see dia_kernel).
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
// arpack_ng_tpu/ops/sparse.py:118-183 dia_block_matvec_fn).  Bound: device
// memory, (nd + 2b) n_pad values (the table once per chunk of DIA_COLS
// columns, X read and Y written once).  A thread that walks the diagonals
// and loads X[c, i + off_k] for each of them (this kernel's first form) is
// bound instead by the L1 pipe: b unaligned warp loads per diagonal.  Here
// X goes through shared memory:
//  * the plan: each block copies the offsets into shared memory once and
//    cuts them, in their order, into runs of consecutive diagonals whose
//    offsets span at most S = W - T (offsets with |off| >= n add nothing
//    and are left out); past PLAN_CAP offsets each diagonal is a run.  The
//    host sizes the launch from nd, b and the dtype alone: no offset is
//    read back.
//  * persistent blocks walk items (a tile of T rows and a chunk of
//    columns, one run): for each item the block copies the window
//    X[c, i0 + lo : i0 + hi + T] of each column into one of two stages
//    with cp.async, 16 bytes a copy where shared and global addresses can
//    share their alignment (one value a copy at the window's ends, or for
//    an ldx that is no multiple of 16 bytes), the next item's window while
//    it sums the current one's.
//  * thread t owns rows i0 + t + 256 r (4 rows, T = 1024; float64 past 4
//    columns 2, T = 512): a warp's reads of the window are 32 neighbouring
//    words at any offset (no bank conflict) and its table loads are
//    coalesced.  The table, the bytes that dominate, streams from device
//    memory straight into registers, each group of 4 diagonals (float64
//    with 4 rows: 2) loading while the group before it sums, across runs,
//    items and the block's barriers.
//  * the sums stay in registers across a tile's runs, so each row adds its
//    terms in the order of `offsets`, each product rounded on its own, from
//    0, and skips (never zero-fills) a term whose column falls outside
//    [0, n): column c equals dia_kernel's product of X[c] bit for bit.
// Each X value comes from L2 once per run instead of once per diagonal.
// What remains: the shared reads (nd b words a row), overlapped with the
// stream, and on few, far-apart diagonals (the 5-point stencil) items of a
// few diagonals each, whose window and table latencies the two stages and
// one group of prefetch do not cover.
#include <algorithm>

#include "common.cuh"

namespace atpt {
namespace {

constexpr int DIA_BLOCK = 256;

// The product's epilogue: what row i writes from its sum acc.  DIA_PLAIN is
// the product; the other forms are the Neumann sweeps of the IC(0) / ILU(0)
// preconditioners (ops/solvers.ilu0_preconditioner), each the pair of torch
// ops it replaces, the difference and the scaling rounded on their own:
//   DIA_SUB         out = e - A x            (rn - L z)
//   DIA_SCALE_SUB   out = d * (e - A x)      (dinv * (rn - L z), the last L sweep)
//   DIA_SUB_SCALED  out = e - d * (A x)      (y0 - dinv * (U y), ILU(0)'s U sweeps)
// A sweep's pair of ops moved 2 + nd vectors for the product and 3 (4 with
// the scaling) for the rest; the epilogue form moves 2 + nd + 1 (+1 for d).
constexpr int DIA_PLAIN = -1;
constexpr int DIA_SUB = 0;
constexpr int DIA_SCALE_SUB = 1;
constexpr int DIA_SUB_SCALED = 2;

template <typename A, int FORM>
__global__ void __launch_bounds__(DIA_BLOCK)
dia_kernel(const long long* __restrict__ offsets, int nd, const A* __restrict__ dtab,
           int64_t ld, const A* __restrict__ x, int64_t n, int64_t n_pad, A* __restrict__ y,
           const A* e, const A* d) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * DIA_BLOCK + threadIdx.x;
  if (i >= n_pad) return;
  A acc = A(0);
  if (i < n) {
    for (int k = 0; k < nd; ++k) {
      const int64_t j = i + offsets[k];
      if (j >= 0 && j < n) acc = acc + mul_rn(dtab[static_cast<int64_t>(k) * ld + i], x[j]);
    }
  }
  if constexpr (FORM == DIA_PLAIN)
    y[i] = acc;
  else if constexpr (FORM == DIA_SUB)
    y[i] = sub_rn(e[i], acc);
  else if constexpr (FORM == DIA_SCALE_SUB)
    y[i] = mul_rn(d[i], sub_rn(e[i], acc));
  else
    y[i] = sub_rn(e[i], mul_rn(d[i], acc));
}

template <typename A, int FORM>
int launch_dia(const void* offsets, int nd, const void* dtab, int64_t ld, const void* x,
               int64_t n, int64_t n_pad, void* y, const void* e, const void* d, cudaStream_t st) {
  if (nd < 1 || n < 0 || n > n_pad || ld < n_pad) return static_cast<int>(cudaErrorInvalidValue);
  if (FORM != DIA_PLAIN && (e == nullptr || (FORM != DIA_SUB && d == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nblk = (n_pad + DIA_BLOCK - 1) / DIA_BLOCK;
  dia_kernel<A, FORM><<<static_cast<unsigned>(nblk), DIA_BLOCK, 0, st>>>(
      static_cast<const long long*>(offsets), nd, static_cast<const A*>(dtab), ld,
      static_cast<const A*>(x), n, n_pad, static_cast<A*>(y), static_cast<const A*>(e),
      static_cast<const A*>(d));
  return static_cast<int>(cudaGetLastError());
}

template <typename A>
int launch_dia_form(int form, const void* offsets, int nd, const void* dtab, int64_t ld,
                    const void* x, int64_t n, int64_t n_pad, void* y, const void* e,
                    const void* d, cudaStream_t st) {
  switch (form) {
    case DIA_PLAIN:
      return launch_dia<A, DIA_PLAIN>(offsets, nd, dtab, ld, x, n, n_pad, y, e, d, st);
    case DIA_SUB: return launch_dia<A, DIA_SUB>(offsets, nd, dtab, ld, x, n, n_pad, y, e, d, st);
    case DIA_SCALE_SUB:
      return launch_dia<A, DIA_SCALE_SUB>(offsets, nd, dtab, ld, x, n, n_pad, y, e, d, st);
    case DIA_SUB_SCALED:
      return launch_dia<A, DIA_SUB_SCALED>(offsets, nd, dtab, ld, x, n, n_pad, y, e, d, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

constexpr int DIA_COLS = 8;          // columns of one chunk (one item)
constexpr int BLK_THREADS = 256;
constexpr int BLK_UNROLL = 4;        // diagonals whose table values load together
constexpr int WINDOW_BYTES = 96 * 1024;  // both stages of a block's X windows
constexpr int PLAN_CAP = 512;        // offsets planned in shared memory

// Rows a thread owns (4; float64 past 4 columns 2, for its registers) and
// the diagonals a group loads at once (4; float64 with 4 rows 2).
template <typename A, int CB>
__host__ __device__ constexpr int blk_rows() { return sizeof(A) == 4 || CB <= 4 ? 4 : 2; }
template <typename A, int CB>
__host__ __device__ constexpr int blk_unroll() {
  return sizeof(A) == 8 && CB <= 4 ? BLK_UNROLL / 2 : BLK_UNROLL;
}
template <typename A, int CB>
__host__ __device__ constexpr int blk_tile() { return BLK_THREADS * blk_rows<A, CB>(); }
// Window capacity of one column of one stage, in values: T + S, a multiple
// of 4, at most 5 T.  A column's stride is W + BLK_PAD: room to shift its
// copy so that shared and global addresses share their 16-byte alignment.
constexpr int BLK_PAD = 4;
template <typename A, int CB>
__host__ __device__ constexpr int blk_window() {
  return WINDOW_BYTES / (2 * CB * static_cast<int>(sizeof(A))) / 4 * 4 < 5 * blk_tile<A, CB>()
             ? WINDOW_BYTES / (2 * CB * static_cast<int>(sizeof(A))) / 4 * 4
             : 5 * blk_tile<A, CB>();
}
// Shared bytes of the plan: the offsets, and per run its lowest offset,
// span and diagonal range.
inline size_t blk_plan_bytes(int nd) {
  return nd <= PLAN_CAP ? static_cast<size_t>(nd) * 28 : 0;
}

template <typename A>
__device__ __forceinline__ void cp_async_value(A* dst, const A* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src),
               "n"(static_cast<int>(sizeof(A)))
               : "memory");
}
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Tile-chunks q = tile + ntiles * chunk; chunk holds columns [CB * chunk,
// CB * chunk + cols), CB = min(b, DIA_COLS).  Block blockIdx.x takes
// tile-chunks blockIdx.x, + gridDim.x, ..., each one item per run of the
// plan, in order.  Registers are capped for 4 blocks an SM at CB <= 2 and
// 2 above (the windows' shared memory holds no more).
template <typename A, int CB>
__global__ void __launch_bounds__(BLK_THREADS, CB <= 2 ? 4 : 2)
dia_block_kernel(const long long* __restrict__ offsets, int nd, const A* __restrict__ dtab,
                 int64_t ld, const A* __restrict__ x, int64_t ldx, int b, int64_t n,
                 int64_t n_pad, A* __restrict__ y, int64_t ldy) {
  constexpr int R = blk_rows<A, CB>(), T = blk_tile<A, CB>(), W = blk_window<A, CB>(), S = W - T;
  constexpr int U = blk_unroll<A, CB>(), WS = W + BLK_PAD, VEC = 16 / sizeof(A);
  static_assert(S > 0, "a window holds the tile and a span");
  extern __shared__ __align__(16) unsigned char smem[];
  A* const stages = reinterpret_cast<A*>(smem);  // [2][CB][WS]
  long long* const s_off = reinterpret_cast<long long*>(stages + 2 * CB * WS);
  long long* const s_lo = s_off + nd;
  int* const s_span = reinterpret_cast<int*>(s_lo + nd);
  int* const s_beg = s_span + nd;
  int* const s_end = s_beg + nd;
  __shared__ int s_nruns;
  const int tid = threadIdx.x;
  const bool planned = nd <= PLAN_CAP;
  const int64_t ntiles = (n_pad + T - 1) / T;
  const int64_t nq = ntiles * ((b + CB - 1) / CB);  // tile-chunks
  if (planned) {
    for (int k = tid; k < nd; k += BLK_THREADS) s_off[k] = offsets[k];
    __syncthreads();
    if (tid == 0) {
      int r = -1;
      long long lo = 0, hi = 0;
      for (int k = 0; k < nd; ++k) {
        const long long o = s_off[k];
        if (o >= n || o <= -n) continue;
        if (r >= 0 && max(hi, o) - min(lo, o) <= S) {
          lo = min(lo, o);
          hi = max(hi, o);
          continue;
        }
        if (r >= 0) {
          s_lo[r] = lo;
          s_span[r] = static_cast<int>(hi - lo);
          s_end[r] = k;
        }
        s_beg[++r] = k;
        lo = hi = o;
      }
      if (r >= 0) {
        s_lo[r] = lo;
        s_span[r] = static_cast<int>(hi - lo);
        s_end[r] = nd;
      }
      s_nruns = r + 1;
    }
    __syncthreads();
  }
  const int nruns = planned ? s_nruns : nd;
  const int nr = max(nruns, 1);
  // 16-byte copies where every column shares the alignment of X's base
  const bool vec = ldx % VEC == 0;
  const int64_t xv = static_cast<int64_t>(reinterpret_cast<uintptr_t>(x) / sizeof(A));
  // Item q's run r: tile rows [i0, i0 + T), columns [c0, c0 + cols),
  // diagonals [beg, end) with offsets in [lo, lo + span] (span < 0: no
  // window: no run, or a left-out offset on its own).  X[c0 + c, i0 + lo +
  // p] sits at index p + m of column c of a stage.  Term (row i0 + ii,
  // offset o) exists iff ii < rowlim and p = ii + o - lo lies in [pmin,
  // pmax), i.e. 0 <= i0 + ii + o < n.
  struct Item {
    int64_t i0;
    long long lo;
    int c0, cols, beg, end, span, rowend, rowlim, pmin, pmax, m;
  };
  auto item = [&](int64_t q, int r) {
    Item it;
    if (nruns == 0) {
      it.beg = it.end = 0;
      it.lo = 0;
      it.span = -1;
    } else if (planned) {
      it.beg = s_beg[r];
      it.end = s_end[r];
      it.lo = s_lo[r];
      it.span = s_span[r];
    } else {
      it.beg = r;
      it.end = r + 1;
      it.lo = offsets[r];
      it.span = it.lo >= n || it.lo <= -n ? -1 : 0;
    }
    it.i0 = (q % ntiles) * T;
    it.c0 = static_cast<int>(q / ntiles) * CB;
    it.cols = min(CB, b - it.c0);
    it.rowend = static_cast<int>(min(n_pad - it.i0, int64_t(T)));
    it.rowlim = static_cast<int>(max(min(n - it.i0, int64_t(T)), int64_t(0)));
    const int64_t jw = it.i0 + it.lo;
    it.pmin = static_cast<int>(min(max(-jw, int64_t(0)), int64_t(W)));
    it.pmax = static_cast<int>(min(max(n - jw, int64_t(0)), int64_t(W)));
    it.m = vec ? static_cast<int>((xv + jw) & (VEC - 1)) : 0;
    return it;
  };
  // the item's window of X into stage s: values up to the first 16-byte
  // boundary and after the last one one by one, the rest 16 bytes a copy
  auto prefetch = [&](const Item& it, int s) {
    if (it.span < 0 || it.pmin >= min(it.pmax, T + it.span)) return;
    const int len = min(it.pmax, T + it.span) - it.pmin;
    const int head = vec ? min(len, (VEC - ((it.m + it.pmin) & (VEC - 1))) & (VEC - 1)) : len;
    const int body = (len - head) / VEC * VEC;
    const int64_t j0 = it.i0 + it.lo + it.pmin;
    A* const st = stages + s * CB * WS + it.m + it.pmin;
    for (int c = 0; c < it.cols; ++c) {
      const A* const xc = x + static_cast<int64_t>(it.c0 + c) * ldx + j0;
      A* const sc = st + c * WS;
      for (int e = tid; e < head; e += BLK_THREADS) cp_async_value(sc + e, xc + e);
      for (int e = head + tid * VEC; e < head + body; e += BLK_THREADS * VEC)
        cp_async_16(sc + e, xc + e);
      for (int e = head + body + tid; e < len; e += BLK_THREADS) cp_async_value(sc + e, xc + e);
    }
  };
  // offset of diagonal kk relative to lo, or -1 past the run or for a
  // left-out offset inside it
  auto rel = [&](const Item& it, int kk) {
    if (it.span < 0 || kk >= it.end) return -1;
    const long long o = planned ? s_off[kk] : it.lo;
    return static_cast<unsigned long long>(o - it.lo) <= static_cast<unsigned>(it.span)
               ? static_cast<int>(o - it.lo)
               : -1;
  };
  // the table values of diagonals k .. k + U - 1 for the tile's rows
  // (rows in [n, n_pad) are read, never used)
  auto load = [&](const Item& it, int k, A(&d)[U][R]) {
    const A* const tb = dtab + it.i0 + tid;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = rel(it, k + u) >= 0;
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
        d[u][rr] = in && tid + rr * BLK_THREADS < it.rowend
                       ? __ldcs(tb + static_cast<int64_t>(k + u) * ld + rr * BLK_THREADS)
                       : A(0);
    }
  };

  A acc[R][CB];
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[rr][c] = A(0);
  auto sum = [&](const Item& it, int k, const A(&d)[U][R], const A* st) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ro = rel(it, k + u);
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int ii = tid + rr * BLK_THREADS, pp = ii + ro;
        if (ro >= 0 && ii < it.rowlim && pp >= it.pmin && pp < it.pmax) {
          const A* const xs = st + it.m + pp;
#pragma unroll
          for (int c = 0; c < CB; ++c) acc[rr][c] = acc[rr][c] + mul_rn(d[u][rr], xs[c * WS]);
        }
      }
    }
  };

  int64_t q = blockIdx.x;
  if (q >= nq) return;
  int r = 0, s = 0;
  Item cur = item(q, r);
  prefetch(cur, s);
  cp_async_commit();
  // dn: the table values of the next group of U diagonals, loaded while
  // the group before them sums, across runs and items
  A dn[U][R];
  load(cur, cur.beg, dn);
  for (;;) {
    int64_t qn = q;
    int rn = r + 1;
    if (rn == nr) {
      rn = 0;
      qn += gridDim.x;
    }
    const bool more = qn < nq;
    Item nxt = cur;
    if (more) {
      nxt = item(qn, rn);
      prefetch(nxt, s ^ 1);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const A* const st = stages + s * CB * WS;
    for (int k = cur.beg;; k += U) {
      A d[U][R];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int rr = 0; rr < R; ++rr) d[u][rr] = dn[u][rr];
      const bool last = k + U >= cur.end;
      if (!last)
        load(cur, k + U, dn);
      else if (more)
        load(nxt, nxt.beg, dn);
      sum(cur, k, d, st);
      if (last) break;
    }
    if (r == nr - 1) {
      // the item's last run: its rows are summed (rows >= n hold 0)
      A* const yt = y + static_cast<int64_t>(cur.c0) * ldy + cur.i0 + tid;
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          if (c < cur.cols && tid + rr * BLK_THREADS < cur.rowend)
            __stcs(yt + static_cast<int64_t>(c) * ldy + rr * BLK_THREADS, acc[rr][c]);
          acc[rr][c] = A(0);
        }
    }
    if (!more) break;
    __syncthreads();
    cur = nxt;
    q = qn;
    r = rn;
    s ^= 1;
  }
}

// The launch of dia_block_kernel<A, CB>: dynamic shared memory (two stages
// and the plan), blocks per SM and the persistent grid.  out (if given):
// tile rows, window values per column, shared bytes, blocks per SM, grid,
// whether the offsets are planned, columns per chunk.
template <typename A, int CB>
int block_setup(int nd, int b, int64_t n_pad, size_t* smem, int* grid, long long* out) {
  auto kern = dia_block_kernel<A, CB>;
  *smem = 2 * static_cast<size_t>(CB) * (blk_window<A, CB>() + BLK_PAD) * sizeof(A) +
          blk_plan_bytes(nd);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(*smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, BLK_THREADS, *smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t nq = (n_pad + blk_tile<A, CB>() - 1) / blk_tile<A, CB>() * ((b + CB - 1) / CB);
  *grid = static_cast<int>(std::min(nq, static_cast<int64_t>(per_sm) * sms));
  if (out != nullptr) {
    const long long v[7] = {blk_tile<A, CB>(), blk_window<A, CB>(), static_cast<long long>(*smem),
                            per_sm, *grid, nd <= PLAN_CAP, CB};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
  }
  return 0;
}

template <typename A, int CB>
int launch_block_cb(const void* offsets, int nd, const void* dtab, int64_t ld, const void* x,
                    int64_t ldx, int b, int64_t n, int64_t n_pad, void* y, int64_t ldy,
                    cudaStream_t st, long long* config) {
  size_t smem = 0;
  int grid = 0;
  const int err = block_setup<A, CB>(nd, b, n_pad, &smem, &grid, config);
  if (err != 0 || config != nullptr || grid == 0) return err;
  dia_block_kernel<A, CB><<<grid, BLK_THREADS, smem, st>>>(
      static_cast<const long long*>(offsets), nd, static_cast<const A*>(dtab), ld,
      static_cast<const A*>(x), ldx, b, n, n_pad, static_cast<A*>(y), ldy);
  return static_cast<int>(cudaGetLastError());
}

// config == nullptr: launch; else fill config (block_setup's out) and launch
// nothing.
template <typename A>
int launch_dia_block(const void* offsets, int nd, const void* dtab, int64_t ld, const void* x,
                     int64_t ldx, int b, int64_t n, int64_t n_pad, void* y, int64_t ldy,
                     cudaStream_t st, long long* config) {
  if (nd < 1 || b < 1 || n < 0 || n > n_pad || ld < n_pad || ldx < n_pad || ldy < n_pad)
    return static_cast<int>(cudaErrorInvalidValue);
#define ATPT_DIA_BLOCK_CASE(CB)                                                           \
  case CB:                                                                                \
    return launch_block_cb<A, CB>(offsets, nd, dtab, ld, x, ldx, b, n, n_pad, y, ldy, st, \
                                  config);
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

// y = DIA(offsets, dtab) x with an epilogue: form -1 y = A x, 0 y = e - A
// x, 1 y = d (e - A x), 2 y = e - d (A x).  offsets: nd int64 on the
// device; dtab: (nd, ld) row-aligned diagonals (dtab[k, i] = A[i, i +
// offsets[k]]); x, y, e, d: n_pad values (e unused by form -1, d by forms
// -1 and 0).  y must not overlap x.
int atpt_dia_matvec_sub(int code, int form, const void* offsets, int nd, const void* dtab,
                        long long ld, const void* x, const void* e, const void* d, long long n,
                        long long n_pad, void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0:
      return atpt::launch_dia_form<float>(form, offsets, nd, dtab, ld, x, n, n_pad, y, e, d, st);
    case 2:
      return atpt::launch_dia_form<double>(form, offsets, nd, dtab, ld, x, n, n_pad, y, e, d, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Y = DIA(offsets, dtab) X for a block of b vectors.  X: (b, ldx) and
// Y: (b, ldy) row-major, the first n_pad values of each row used; offsets
// and dtab as atpt_dia_matvec_sub's.
int atpt_dia_block_matvec(int code, const void* offsets, int nd, const void* dtab, long long ld,
                          const void* x, long long ldx, int b, long long n, long long n_pad,
                          void* y, long long ldy, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0:
      return atpt::launch_dia_block<float>(offsets, nd, dtab, ld, x, ldx, b, n, n_pad, y, ldy,
                                           st, nullptr);
    case 2:
      return atpt::launch_dia_block<double>(offsets, nd, dtab, ld, x, ldx, b, n, n_pad, y, ldy,
                                            st, nullptr);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch atpt_dia_block_matvec makes for (nd, b, n_pad) on the current
// device, into out[7]: tile rows T, window values per column W (runs span
// at most W - T), dynamic shared bytes per block, blocks per SM, grid,
// whether the offsets are planned in shared memory (nd <= 512), columns per
// chunk.  Launches nothing.
int atpt_dia_block_config(int code, int nd, int b, long long n_pad, long long* out) {
  switch (code) {
    case 0:
      return atpt::launch_dia_block<float>(nullptr, nd, nullptr, n_pad, nullptr, n_pad, b, 0,
                                           n_pad, nullptr, n_pad, nullptr, out);
    case 2:
      return atpt::launch_dia_block<double>(nullptr, nd, nullptr, n_pad, nullptr, n_pad, b, 0,
                                            n_pad, nullptr, n_pad, nullptr, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
