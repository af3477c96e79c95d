"""PSELL (panel-tiled sliced-ELL) host packing: the port's own copy of the
host half of ``arpack_ng_tpu/ops/pallas_psell.py`` (``:48-220``), numpy and
scipy only, so both packages pack a matrix into the same arrays.

* x is viewed as PANELS of 16384 elements (128 sub-rows x 128 lanes);
  y as CHUNKS of 1024 elements (8 x 128).
* nonzeros are grouped by (chunk, panel) and padded to tiles of TILE = 1024
  entries; tiles are sorted by chunk.
* per entry: the value and ONE packed int32
  ``sub(3) | lane_o(7) | sr(7) | lane(7)``: the entry reads
  ``x[panel, sr, lane]`` and accumulates into ``y[chunk, sub, lane_o]``.

:func:`pack_psell` gives the chunk-sorted tile list with ``c_idx`` and
``first``; :func:`pack_psell_uniform` the production packing of W tiles per
chunk.  The matvec over either is ``ops/cuda_psell.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

LANE = 128
#: x panel: PANEL_SUB x LANE elements
PANEL_SUB = 128
PANEL = PANEL_SUB * LANE           # 16384
#: y chunk: CHUNK_SUB x LANE elements
CHUNK_SUB = 8
CHUNK = CHUNK_SUB * LANE           # 1024
#: entries per tile (one (8, 128) metadata block)
TILE = 1024


class PSell(NamedTuple):
    """Packed panel-tiled sliced-ELL matrix (host arrays)."""

    vals: np.ndarray      # (ntiles, 8, 128) float32/float64 values
    meta: np.ndarray      # (ntiles, 8, 128) int32 packed coordinates
    p_idx: np.ndarray     # (ntiles,) int32 x-panel index per tile
    c_idx: np.ndarray     # (ntiles,) int32 y-chunk index per tile
    first: np.ndarray     # (ntiles,) int32 1 = first tile of its chunk
    n: int                # logical dimension
    n_pad: int            # padded dimension (multiple of CHUNK)
    nnz: int              # true nonzero count


def pack_psell(a, n_pad: int = 0) -> PSell:
    """Pack a scipy sparse matrix into PSELL tiles (see module doc)."""
    import scipy.sparse as sp

    csr = sp.csr_matrix(a)
    n = csr.shape[0]
    if n_pad == 0:
        n_pad = -(-n // CHUNK) * CHUNK
    if n_pad % CHUNK:
        raise ValueError(f"n_pad must be a multiple of {CHUNK}")
    coo = csr.tocoo()
    r = coo.row.astype(np.int64)
    c = coo.col.astype(np.int64)
    v = coo.data
    g = r // CHUNK
    q = c // PANEL
    sub = (r % CHUNK) // LANE
    lane_o = r % LANE
    sr = (c % PANEL) // LANE
    lane = c % LANE
    meta_e = ((sub.astype(np.int64) << 21) | (lane_o << 14) | (sr << 7)
              | lane).astype(np.int32)

    # sort entries by (chunk, panel); pad each group to TILE multiples
    order = np.lexsort((q, g))
    g, q, v, meta_e = g[order], q[order], v[order], meta_e[order]
    gq = g * (n_pad // PANEL + 1) + q
    _, group_start = np.unique(gq, return_index=True)
    group_start = np.sort(group_start)
    group_sizes = np.diff(np.append(group_start, len(gq)))
    tiles_per_group = -(-group_sizes // TILE)

    n_chunks = n_pad // CHUNK
    # empty chunks need one zero tile so every output block is written
    chunks_with = np.unique(g)
    empty_chunks = np.setdiff1d(np.arange(n_chunks), chunks_with)
    ntiles = int(tiles_per_group.sum()) + len(empty_chunks)

    vals = np.zeros((ntiles, TILE), dtype=v.dtype)
    meta = np.zeros((ntiles, TILE), dtype=np.int32)
    p_idx = np.zeros(ntiles, np.int32)
    c_idx = np.zeros(ntiles, np.int32)
    first = np.zeros(ntiles, np.int32)

    t = 0
    prev_chunk = -1
    for gs, sz, tg in zip(group_start, group_sizes, tiles_per_group):
        chunk = int(g[gs])
        panel = int(q[gs])
        for j in range(tg):
            lo = gs + j * TILE
            hi = min(gs + (j + 1) * TILE, gs + sz)
            m = hi - lo
            vals[t, :m] = v[lo:hi]
            meta[t, :m] = meta_e[lo:hi]
            p_idx[t] = panel
            c_idx[t] = chunk
            first[t] = 1 if chunk != prev_chunk else 0
            prev_chunk = chunk
            t += 1
    for ch in empty_chunks:
        c_idx[t] = ch
        first[t] = 1
        # p_idx 0, vals 0: a no-op tile that zero-initializes the chunk
        t += 1
    assert t == ntiles
    # order tiles by chunk so output blocks are revisited consecutively
    # (empty-chunk tiles were appended; re-sort and recompute `first`)
    ordt = np.argsort(c_idx, kind="stable")
    vals, meta = vals[ordt], meta[ordt]
    p_idx, c_idx = p_idx[ordt], c_idx[ordt]
    first = np.zeros(ntiles, np.int32)
    first[np.unique(c_idx, return_index=True)[1]] = 1
    return PSell(vals=vals.reshape(ntiles, CHUNK_SUB * 1, TILE // CHUNK_SUB
                                   ).reshape(ntiles, 8, 128),
                 meta=meta.reshape(ntiles, 8, 128),
                 p_idx=p_idx, c_idx=c_idx, first=first,
                 n=n, n_pad=n_pad, nnz=int(csr.nnz))


class PSellU(NamedTuple):
    """Uniform-W PSELL packing: a dense (chunks, W) grid of tiles; chunk
    c owns tiles ``c*W .. (c+1)*W`` (all-zero tiles fill a chunk that
    needs fewer).  The production packing of ``from_scipy(format='psell')``.
    """

    vals: np.ndarray      # (C*W, TILE)
    meta: np.ndarray      # (C*W, TILE) int32 packed (see pack_psell)
    p_idx: np.ndarray     # (C*W,) int32 x-panel per tile
    W: int
    n: int
    n_pad: int            # multiple of CHUNK
    nnz: int


def pack_psell_uniform(a, n_pad: int = 0) -> PSellU:
    """Pack into the uniform-W (chunks x W tiles) grid (see PSellU)."""
    import scipy.sparse as sp

    csr = sp.csr_matrix(a)
    n = csr.shape[0]
    if n_pad == 0:
        n_pad = -(-n // CHUNK) * CHUNK
    if n_pad % CHUNK:
        raise ValueError(f"n_pad must be a multiple of {CHUNK}")
    coo = csr.tocoo()
    r = coo.row.astype(np.int64)
    c = coo.col.astype(np.int64)
    v = coo.data
    g = r // CHUNK
    q = c // PANEL
    meta_e = ((((r % CHUNK) // LANE) << 21) | ((r % LANE) << 14)
              | (((c % PANEL) // LANE) << 7) | (c % LANE)).astype(np.int32)
    order = np.lexsort((q, g))
    g, q, v, meta_e = g[order], q[order], v[order], meta_e[order]
    nch = n_pad // CHUNK
    qwidth = n_pad // PANEL + 2
    gq = g * qwidth + q
    uq, start = np.unique(gq, return_index=True)
    start = np.sort(start)
    sizes = np.diff(np.append(start, len(gq)))
    tpg = -(-sizes // TILE)
    tiles_per_chunk = np.zeros(nch, np.int64)
    np.add.at(tiles_per_chunk, (gq[start] // qwidth), tpg)
    W = max(int(tiles_per_chunk.max()), 1)
    vals = np.zeros((nch * W, TILE), dtype=v.dtype)
    meta = np.zeros((nch * W, TILE), dtype=np.int32)
    p_idx = np.zeros(nch * W, np.int32)
    slot = np.zeros(nch, np.int64)
    for gs, sz in zip(start, sizes):
        chunk = int(g[gs])
        panel = int(q[gs])
        for j in range(-(-sz // TILE)):
            lo = gs + j * TILE
            m = min(TILE, gs + sz - lo)
            t = chunk * W + slot[chunk]
            vals[t, :m] = v[lo:lo + m]
            meta[t, :m] = meta_e[lo:lo + m]
            p_idx[t] = panel
            slot[chunk] += 1
    return PSellU(vals=vals, meta=meta, p_idx=p_idx, W=W, n=n,
                  n_pad=n_pad, nnz=int(csr.nnz))
