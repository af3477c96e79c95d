"""PSELL sparse matrix-vector product (port of
``arpack_ng_tpu/ops/pallas_psell.py:262`` ``make_psell_matvec``; kernel
in ``csrc/psell.cu``).

:func:`psell_tiles` moves a packing of ``ops/psell.py`` (:class:`PSell` or
:class:`PSellU`) to a device as one chunk-sorted tile list with per-chunk
tile offsets and per-tile live lengths (one past the last nonzero slot, 0
for an all-zero tile: the kernel reads no slot from there on), after
checking on the host what the kernel relies on; :func:`psell_matvec`
computes ``y = A x`` over it.

The wrapper runs its plain twin (:func:`psell_matvec_plain`: decode the
metadata, then ``index_add`` in tile order) for tensors on the CPU and
launches the CUDA kernel for tensors on a CUDA device; ``launches`` counts
the kernel launches.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import cuda_lib
from .psell import CHUNK, LANE, PANEL, TILE


class PSellTiles(NamedTuple):
    """A PSELL packing on a device: tiles of chunk ``c`` are
    ``tile_ptr[c] .. tile_ptr[c + 1]``."""

    vals: torch.Tensor      # (ntiles, TILE) values
    meta: torch.Tensor      # (ntiles, TILE) int32 packed coordinates
    p_idx: torch.Tensor     # (ntiles,) int32 x panel of each tile
    tile_ptr: torch.Tensor  # (nchunks + 1,) int32 chunk offsets
    tile_len: torch.Tensor  # (ntiles,) int32 one past the last nonzero slot
    n: int                  # logical dimension
    n_pad: int              # nchunks * CHUNK, the length of y
    nnz: int


def _decode(meta: np.ndarray, p_idx: np.ndarray):
    """(row within the chunk, column) of every slot."""
    meta = meta.astype(np.int64)
    row = ((meta >> 21) & 0x7) * LANE + ((meta >> 14) & 0x7F)
    col = (p_idx.astype(np.int64)[:, None] * PANEL
           + ((meta >> 7) & 0x7F) * LANE + (meta & 0x7F))
    return row, col


def tile_lengths(vals: np.ndarray) -> np.ndarray:
    """One past the last nonzero slot of every tile; 0 for an all-zero
    tile."""
    live = vals != 0
    last = TILE - np.argmax(live[:, ::-1], axis=1)
    return np.where(live.any(axis=1), last, 0).astype(np.int32)


def _check_tiles(meta: np.ndarray, p_idx: np.ndarray, tile_len: np.ndarray,
                 n: int) -> None:
    """Raise unless every slot before its tile's length reads a column
    below ``n`` and, in every tile, the slots of one row before that length
    form one run of consecutive slots, as the packers' CSR order gives: the
    kernel adds each run to its row once, from the thread holding its last
    slot."""
    row, col = _decode(meta, p_idx)
    on = np.arange(TILE)[None, :] < tile_len[:, None]
    if np.any(col[on] >= n):
        raise ValueError("a PSELL entry addresses a column >= n")
    head = np.ones(row.shape, bool)
    head[:, 1:] = row[:, 1:] != row[:, :-1]
    heads = np.flatnonzero((head & on).ravel())
    key = (heads // TILE) * CHUNK + row.ravel()[heads]
    if np.unique(key).size != key.size:
        raise ValueError("a PSELL tile holds one row in two separate runs "
                         "of entries; pack with pack_psell or "
                         "pack_psell_uniform")


def psell_tiles(pk, device) -> PSellTiles:
    """Move a :class:`PSell` or :class:`PSellU` packing to ``device``."""
    vals = np.ascontiguousarray(np.asarray(pk.vals).reshape(-1, TILE))
    meta = np.ascontiguousarray(np.asarray(pk.meta).reshape(-1, TILE))
    p_idx = np.asarray(pk.p_idx, np.int32)
    nchunks = pk.n_pad // CHUNK
    if hasattr(pk, "W"):
        tile_ptr = np.arange(nchunks + 1, dtype=np.int64) * pk.W
    else:
        c_idx = np.asarray(pk.c_idx)
        if np.any(np.diff(c_idx) < 0):
            raise ValueError("PSELL tiles must be sorted by chunk")
        tile_ptr = np.searchsorted(c_idx, np.arange(nchunks + 1))
    if tile_ptr[-1] != vals.shape[0] or p_idx.shape != (vals.shape[0],):
        raise ValueError("PSELL tile list and chunk offsets disagree")
    tile_len = tile_lengths(vals)
    _check_tiles(meta, p_idx, tile_len, pk.n)
    dev = torch.device(device)
    return PSellTiles(
        vals=torch.from_numpy(vals).to(dev),
        meta=torch.from_numpy(meta.astype(np.int32)).to(dev),
        p_idx=torch.from_numpy(p_idx).to(dev),
        tile_ptr=torch.from_numpy(tile_ptr.astype(np.int32)).to(dev),
        tile_len=torch.from_numpy(tile_len).to(dev),
        n=int(pk.n), n_pad=int(pk.n_pad), nnz=int(pk.nnz))


def psell_matvec_plain(t: PSellTiles, x: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`psell_matvec`: decode every slot, multiply, and
    ``index_add`` the products in tile order."""
    m = t.meta.long()
    chunk = torch.repeat_interleave(
        torch.arange(t.tile_ptr.shape[0] - 1, device=m.device),
        torch.diff(t.tile_ptr.long()))
    row = (chunk[:, None] * CHUNK + ((m >> 21) & 0x7) * LANE
           + ((m >> 14) & 0x7F))
    col = (t.p_idx.long()[:, None] * PANEL + ((m >> 7) & 0x7F) * LANE
           + (m & 0x7F)).clamp_(max=x.shape[0] - 1)
    prod = t.vals * x[col]
    y = torch.zeros(t.n_pad, dtype=x.dtype, device=x.device)
    return y.index_add_(0, row.reshape(-1), prod.reshape(-1))


def psell_matvec(t: PSellTiles, x: torch.Tensor) -> torch.Tensor:
    """``y = A x``; ``x`` has at least ``t.n`` entries (zero past ``n``),
    ``y`` has ``t.n_pad``."""
    if x.dim() != 1 or x.shape[0] < t.n or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous vector of length >= {t.n}")
    if x.dtype != t.vals.dtype or x.device != t.vals.device:
        raise ValueError("x must match the tiles' dtype and device")
    if x.device.type == "cpu":
        return psell_matvec_plain(t, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    code = cuda_lib.dtype_code(x.dtype, x.dtype)
    if t.vals.data_ptr() % 16 or t.meta.data_ptr() % 16:
        raise ValueError("the tiles' values and metadata must be 16-byte "
                         "aligned")
    lib = cuda_lib.load()
    y = torch.empty(t.n_pad, dtype=x.dtype, device=x.device)
    err = lib.atpt_psell_matvec(code, t.vals.data_ptr(), t.meta.data_ptr(),
                                t.p_idx.data_ptr(), t.tile_ptr.data_ptr(),
                                t.tile_len.data_ptr(), t.n_pad // CHUNK,
                                x.data_ptr(), x.shape[0], y.data_ptr(),
                                cuda_lib.stream_handle(x.device))
    cuda_lib.check(lib, err, "psell_matvec")
    psell_matvec.launches += 1
    return y


psell_matvec.launches = 0
