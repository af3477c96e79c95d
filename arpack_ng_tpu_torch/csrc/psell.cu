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
// and pack_psell_uniform's W tiles per chunk).
//
// Bound: device-memory bandwidth: 8 (float) or 12 (double) bytes per slot
// of metadata and value, read once, plus x and y.  The TPU kernel's one-hot
// MXU contractions existed only because Mosaic has no gather; here each
// thread gathers x directly (x is a few MB and stays in L2).  One block owns
// one chunk and keeps its 1024 outputs in shared memory across the chunk's
// tiles, so no output leaves the block before it is complete and no atomics
// are used.  Per tile:
// 1. every thread decodes its slots and forms value * x (rounded on its own)
//    into shared memory;
// 2. the first slot of each run of equal rows adds the run's products to
//    its row in slot order.
// The packers keep each tile in CSR row order, so a row has one run per
// tile apart from the all-zero padding slots (value 0, row 0 of the chunk),
// which add nothing and are skipped; the wrapper checks that property on
// the host before the first launch.  Every output is therefore summed
// sequentially in tile-list order, the twin's index_add order: deterministic.
// The padding fills the end of a tile (a fifth of the slots of an
// RCM-ordered FEM matrix) and would form one long run of row 0, walked by
// one thread: step 2 stops at the tile's last nonzero slot instead.
#include "common.cuh"

namespace atpt {
namespace {

constexpr int PS_LANE = 128;
constexpr int PS_PANEL = 128 * PS_LANE;  // x elements per panel
constexpr int PS_CHUNK = 8 * PS_LANE;    // y elements per chunk
constexpr int PS_TILE = 1024;            // entries per tile
constexpr int PS_BLOCK = 256;
constexpr int PS_ITEMS = PS_TILE / PS_BLOCK;

template <typename A>
__global__ void __launch_bounds__(PS_BLOCK)
psell_kernel(const A* __restrict__ vals, const int* __restrict__ meta,
             const int* __restrict__ p_idx, const int* __restrict__ tile_ptr,
             const A* __restrict__ x, int64_t nx, A* __restrict__ y) {
  __shared__ A acc[PS_CHUNK];
  __shared__ A prod[PS_TILE];
  __shared__ short row[PS_TILE];
  __shared__ unsigned char live[PS_TILE];
  // one past the last nonzero slot of the tile, for even and odd tiles:
  // the buffer of the next tile is cleared while this one's is read
  __shared__ int tile_end[2];
  const int c = blockIdx.x;
  for (int e = threadIdx.x; e < PS_CHUNK; e += PS_BLOCK) acc[e] = A(0);
  if (threadIdx.x == 0) tile_end[0] = tile_end[1] = 0;
  const int t0 = tile_ptr[c], t1 = tile_ptr[c + 1];
  for (int t = t0; t < t1; ++t) {
    const int64_t panel = static_cast<int64_t>(p_idx[t]) * PS_PANEL;
    const int64_t tb = static_cast<int64_t>(t) * PS_TILE;
    const int buf = (t - t0) & 1;
    __syncthreads();  // the previous tile's runs are added
    // the previous tile's buffer was read before the barrier above
    if (threadIdx.x == 0) tile_end[buf ^ 1] = 0;
    int end = 0;
#pragma unroll
    for (int u = 0; u < PS_ITEMS; ++u) {
      const int e = threadIdx.x + u * PS_BLOCK;
      const int m = meta[tb + e];
      const A v = vals[tb + e];
      const int64_t col = panel + ((m >> 7) & 0x7F) * PS_LANE + (m & 0x7F);
      const bool on = v != A(0);
      row[e] = static_cast<short>(((m >> 21) & 0x7) * PS_LANE + ((m >> 14) & 0x7F));
      live[e] = on;
      prod[e] = (on && col < nx) ? mul_rn(v, x[col]) : A(0);
      if (on) end = e + 1;
    }
    if (end > 0) atomicMax(&tile_end[buf], end);  // an integer maximum: exact
    __syncthreads();
    const int last = tile_end[buf];
#pragma unroll
    for (int u = 0; u < PS_ITEMS; ++u) {
      const int e = threadIdx.x + u * PS_BLOCK;
      if (e >= last) continue;
      const int rw = row[e];
      if (e > 0 && row[e - 1] == rw) continue;  // not the first slot of its run
      A a = A(0);
      bool any = false;
      for (int k = e; k < last && row[k] == rw; ++k) {
        if (!live[k]) continue;
        if (!any) a = acc[rw];
        a = a + prod[k];
        any = true;
      }
      if (any) acc[rw] = a;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < PS_CHUNK; e += PS_BLOCK)
    y[static_cast<int64_t>(c) * PS_CHUNK + e] = acc[e];
}

template <typename A>
int launch_psell(const void* vals, const void* meta, const void* p_idx, const void* tile_ptr,
                 int nchunks, const void* x, int64_t nx, void* y, cudaStream_t st) {
  if (nchunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  psell_kernel<A><<<nchunks, PS_BLOCK, 0, st>>>(
      static_cast<const A*>(vals), static_cast<const int*>(meta),
      static_cast<const int*>(p_idx), static_cast<const int*>(tile_ptr),
      static_cast<const A*>(x), nx, static_cast<A*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace atpt

extern "C" {

// y[:nchunks*1024] = PSELL x.  vals: (ntiles, 1024) values; meta: (ntiles,
// 1024) int32; p_idx: (ntiles,) int32 panels; tile_ptr: (nchunks + 1,) int32
// chunk offsets into the tile list; x: nx values.
int atpt_psell_matvec(int code, const void* vals, const void* meta, const void* p_idx,
                      const void* tile_ptr, int nchunks, const void* x, long long nx,
                      void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0: return atpt::launch_psell<float>(vals, meta, p_idx, tile_ptr, nchunks, x, nx, y, st);
    case 2: return atpt::launch_psell<double>(vals, meta, p_idx, tile_ptr, nchunks, x, nx, y, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
