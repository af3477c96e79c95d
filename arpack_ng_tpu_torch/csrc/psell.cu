// PSELL (panel-tiled sliced-ELL) sparse matrix-vector product for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel arpack_ng_tpu/ops/pallas_psell.py:262
// make_psell_matvec, the matvec of from_scipy(format='psell').  Each tile
// holds 1024 entries of one (1024-row chunk, 16384-column panel) group: a
// value and one int32 `sub<<21 | lane_o<<14 | sr<<7 | lane`; the entry reads
// x[panel*16384 + sr*128 + lane] and adds into y[chunk*1024 + sub*128 +
// lane_o].  Tiles are sorted by chunk; tile_ptr[c]..tile_ptr[c+1] are chunk
// c's tiles, which serves both packings (pack_psell's chunk-sorted list
// and pack_psell_uniform's W tiles per chunk).  tile_len[t] is one past the
// last nonzero slot of tile t (0 for an all-zero tile), from the host.
//
// Bound: device-memory bandwidth: 8 (float) or 12 (double) bytes per
// nonzero slot of value and metadata, read once, plus tile_len, x and y
// (x is a few MB and stays in L2: each slot gathers its x directly; the TPU
// kernel's one-hot MXU contractions existed only because Mosaic has no
// gather).  The first port walked each tile behind two barriers while one
// thread per run of equal rows added the run from shared memory: the
// memory system idled during every walk, and it read the zero padding
// (a fifth of the slots of an RCM-ordered FEM matrix).  The design:
// * one block of 256 threads per chunk (4 blocks per SM, at most 64
//   registers: 1024 FEM chunks run in 1.94 waves of 528); the chunk's 1024
//   outputs stay in shared memory across its tiles, so no output leaves the
//   block before it is complete and no atomics are used;
// * each thread owns 4 consecutive slots of a tile, loaded as 16-byte
//   vectors of metadata and values; the next tile's loads are issued before
//   the current tile is summed (a register double buffer), and the tile
//   lengths two tiles ahead.  Slots from tile_len on are never loaded, and
//   an all-zero tile is skipped whole;
// * each product v * x[col] is rounded on its own; the runs of equal rows
//   (the packers keep each tile in CSR row order, so a row has one run per
//   tile; the wrapper checks that on the host) are summed by a segmented
//   scan: in order within a thread, a Kogge-Stone scan with head flags over
//   the warp's lanes (warp shuffles), and a carry across warps, in warp
//   order, from one slot per warp in shared memory behind the tile's one
//   barrier (double-buffered, so one barrier per tile suffices).  The
//   thread that holds a run's last slot adds the run's total into its row:
//   only run tails touch the accumulator, and every output is summed in a
//   fixed order, tile after tile: deterministic.
// Measured: PERF.md section 6.
#include "common.cuh"

namespace atpt {
namespace {

constexpr int PS_LANE = 128;
constexpr int PS_PANEL = 128 * PS_LANE;  // x elements per panel
constexpr int PS_CHUNK = 8 * PS_LANE;    // y elements per chunk
constexpr int PS_TILE = 1024;            // entries per tile
constexpr int PS_BLOCK = 256;
constexpr int PS_SLOTS = PS_TILE / PS_BLOCK;  // consecutive slots per thread
constexpr int PS_WARPS = PS_BLOCK / 32;
constexpr int PS_MIN_BLOCKS = 4;
constexpr unsigned FULL = 0xffffffffu;

// One thread's PS_SLOTS slots of one tile, as loaded.
template <typename A>
struct Group {
  uint4 meta;
  uint4 val[sizeof(A) / 4];  // PS_SLOTS values: one (float) or two (double) words
};

template <typename A>
__device__ __forceinline__ Group<A> load_group(const A* vals, const int* meta, int64_t t, int len) {
  Group<A> g{};
  const int e = threadIdx.x * PS_SLOTS;
  if (e < len) {
    const int64_t base = t * PS_TILE + e;
    g.meta = __ldcs(reinterpret_cast<const uint4*>(meta + base));
#pragma unroll
    for (int k = 0; k < static_cast<int>(sizeof(A) / 4); ++k)
      g.val[k] = __ldcs(reinterpret_cast<const uint4*>(vals + base) + k);
  }
  return g;
}

// What a warp leaves for the later warps of its tile: its first and last
// rows and the sum of its last run up to its last slot.
template <typename A>
struct Agg {
  int rf, rl;
  A tail;
};

// Adds one tile (len > 0 live slots) into the chunk's accumulator.  Every
// thread calls it: it holds the tile's one barrier.
template <typename A>
__device__ __forceinline__ void tile_pass(const Group<A>& g, int len, int64_t panel,
                                          const A* __restrict__ x, int64_t nx, A* acc,
                                          Agg<A>* agg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e0 = threadIdx.x * PS_SLOTS;
  const unsigned mw[PS_SLOTS] = {g.meta.x, g.meta.y, g.meta.z, g.meta.w};
  const A* v = reinterpret_cast<const A*>(g.val);
  int r[PS_SLOTS];  // row within the chunk; -1 past the tile's last nonzero slot
  A p[PS_SLOTS];
#pragma unroll
  for (int k = 0; k < PS_SLOTS; ++k) {
    const unsigned m = mw[k];
    const int64_t col = panel + ((m >> 7) & 0x7F) * PS_LANE + (m & 0x7F);
    const bool on = e0 + k < len;
    r[k] = on ? static_cast<int>(((m >> 21) & 0x7) * PS_LANE + ((m >> 14) & 0x7F)) : -1;
    p[k] = (on && col < nx) ? mul_rn(v[k], __ldg(x + col)) : A(0);
  }
  // s[k]: the sum of slot k's run over this thread's slots up to k
  A s[PS_SLOTS];
  s[0] = p[0];
#pragma unroll
  for (int k = 1; k < PS_SLOTS; ++k) s[k] = r[k] == r[k - 1] ? s[k - 1] + p[k] : p[k];
  // c: the run through slot 3, summed over the warp's lanes up to this one
  // (inclusive segmented scan; f marks a lane where that run starts)
  const int prev_r3 = __shfl_up_sync(FULL, r[PS_SLOTS - 1], 1);
  const bool cont = lane > 0 && r[0] == prev_r3;  // slot 0 continues the lane before
  int f = !(cont && r[0] == r[PS_SLOTS - 1]);
  A c = s[PS_SLOTS - 1];
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const A cu = __shfl_up_sync(FULL, c, d);
    const int fu = __shfl_up_sync(FULL, f, d);
    if (lane >= d) {
      if (!f) c = cu + c;
      f |= fu;
    }
  }
  const A c_prev = __shfl_up_sync(FULL, c, 1);
  const int next_r0 = __shfl_down_sync(FULL, r[0], 1);
  const int rf = __shfl_sync(FULL, r[0], 0);
  if (lane == 31) agg[warp] = Agg<A>{rf, r[PS_SLOTS - 1], c};
  __syncthreads();
  // the part of this warp's first run held by earlier warps, in warp order
  const bool wcont = warp > 0 && rf >= 0 && agg[warp - 1].rl == rf;
  A cw = A(0);
  if (wcont) {
    int w0 = warp - 1;
    while (w0 > 0 && agg[w0].rf == rf && agg[w0 - 1].rl == rf) --w0;
    cw = agg[w0].tail;
    for (int u = w0 + 1; u < warp; ++u) cw = cw + agg[u].tail;
  }
  // the row of the slot after this thread's last one
  const int after = lane < 31 ? next_r0 : (warp + 1 < PS_WARPS ? agg[warp + 1].rf : -1);
  bool head = true;  // slot k is in the run of slot 0
#pragma unroll
  for (int k = 0; k < PS_SLOTS; ++k) {
    if (k > 0 && r[k] != r[k - 1]) head = false;
    const bool ends = k + 1 < PS_SLOTS ? r[k + 1] != r[k] : after != r[k];
    if (ends && r[k] >= 0) {
      A sum = (head && cont) ? c_prev + s[k] : s[k];
      if (wcont && r[k] == rf) sum = cw + sum;
      acc[r[k]] += sum;
    }
  }
}

template <typename A>
__global__ void __launch_bounds__(PS_BLOCK, PS_MIN_BLOCKS)
psell_kernel(const A* __restrict__ vals, const int* __restrict__ meta,
             const int* __restrict__ p_idx, const int* __restrict__ tile_ptr,
             const int* __restrict__ tile_len, const A* __restrict__ x, int64_t nx,
             A* __restrict__ y) {
  __shared__ A acc[PS_CHUNK];
  __shared__ Agg<A> agg[2][PS_WARPS];
  const int c = blockIdx.x;
  for (int e = threadIdx.x; e < PS_CHUNK; e += PS_BLOCK) acc[e] = A(0);
  const int t0 = __ldg(tile_ptr + c), t1 = __ldg(tile_ptr + c + 1);
  int len = t0 < t1 ? __ldg(tile_len + t0) : 0;
  int pan = t0 < t1 ? __ldg(p_idx + t0) : 0;
  int len_n = t0 + 1 < t1 ? __ldg(tile_len + t0 + 1) : 0;
  int pan_n = t0 + 1 < t1 ? __ldg(p_idx + t0 + 1) : 0;
  Group<A> cur = load_group(vals, meta, t0, len);
  int buf = 0;
  for (int t = t0; t < t1; ++t) {
    const int len_nn = t + 2 < t1 ? __ldg(tile_len + t + 2) : 0;
    const int pan_nn = t + 2 < t1 ? __ldg(p_idx + t + 2) : 0;
    const Group<A> nxt = load_group(vals, meta, t + 1, len_n);
    if (len > 0) {  // uniform across the block
      tile_pass<A>(cur, len, static_cast<int64_t>(pan) * PS_PANEL, x, nx, acc, agg[buf]);
      buf ^= 1;
    }
    cur = nxt;
    len = len_n;
    pan = pan_n;
    len_n = len_nn;
    pan_n = pan_nn;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < PS_CHUNK; e += PS_BLOCK)
    y[static_cast<int64_t>(c) * PS_CHUNK + e] = acc[e];
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename A>
int launch_psell(const void* vals, const void* meta, const void* p_idx, const void* tile_ptr,
                 const void* tile_len, int nchunks, const void* x, int64_t nx, void* y,
                 cudaStream_t st) {
  if (nchunks < 1 || !aligned16(vals) || !aligned16(meta))
    return static_cast<int>(cudaErrorInvalidValue);
  psell_kernel<A><<<nchunks, PS_BLOCK, 0, st>>>(
      static_cast<const A*>(vals), static_cast<const int*>(meta),
      static_cast<const int*>(p_idx), static_cast<const int*>(tile_ptr),
      static_cast<const int*>(tile_len), static_cast<const A*>(x), nx, static_cast<A*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace atpt

extern "C" {

// y[:nchunks*1024] = PSELL x.  vals: (ntiles, 1024) values; meta: (ntiles,
// 1024) int32, both 16-byte aligned; p_idx: (ntiles,) int32 panels;
// tile_ptr: (nchunks + 1,) int32 chunk offsets into the tile list;
// tile_len: (ntiles,) int32 one past each tile's last nonzero slot; x: nx
// values.
int atpt_psell_matvec(int code, const void* vals, const void* meta, const void* p_idx,
                      const void* tile_ptr, const void* tile_len, int nchunks, const void* x,
                      long long nx, void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0:
      return atpt::launch_psell<float>(vals, meta, p_idx, tile_ptr, tile_len, nchunks, x, nx, y, st);
    case 2:
      return atpt::launch_psell<double>(vals, meta, p_idx, tile_ptr, tile_len, nchunks, x, nx, y, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
