"""Sparse operators on a torch device (port of
``arpack_ng_tpu/ops/sparse.py``): :func:`from_scipy` imports a scipy
sparse matrix through the reference package's structure-first decision
tree, with the same host code, so both packages pick the same format and
permutation and build the same host arrays.

* dense for small n;
* DIA (the kernel of ``csrc/dia.cu`` on the card) when the structural
  diagonal count is bounded, directly or after Reverse-Cuthill-McKee
  reordering (the permutation is carried on the Operator and unwound on
  extraction); a DIA operator also carries ``apply_block``, the block
  product of the same table;
* otherwise gather-ELL, or hybrid ELL + COO for hub rows (Bell & Garland),
  as plain torch gathers and ``index_add_``: the reference's choice on
  every backend but the TPU, where it took PSELL because gathers are
  serial there.  ``format='auto'`` follows that non-TPU branch on every
  device.

``format=`` may also name ``'dia'``, ``'ell'``, ``'hyb'``, ``'psell'`` (the
PSELL kernel of ``csrc/psell.cu`` over the uniform-W packing) or ``'coo'``.

A complex matrix takes the same decision tree; its DIA product is the DIA
kernel's plain twin (torch ops), and its ELL, HYB and COO products are
the same torch ops as a real matrix's.  The DIA and PSELL kernels are
real-only, as the reference package's Pallas paths are; ``format='psell'``
refuses a complex matrix.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..config import pad_dim
from ..utils import dtypes as _dt
from ..utils.device import DEFAULT, require
from . import psell as ps
from .cuda_dia import (SUB, dia_block_matvec, dia_block_matvec_plain,
                       dia_matvec, dia_matvec_plain, dia_matvec_sub,
                       dia_matvec_sub_plain, sub_epilogue)
from .cuda_psell import psell_matvec, psell_tiles
from .operator import Operator, from_dense


def _to_ell(a: sp.spmatrix, n_pad: int, width: int = 0
            ) -> Tuple[np.ndarray, np.ndarray, sp.coo_matrix]:
    """Convert to ELLPACK (cols, vals) with per-row padding, vectorized.

    Padded slots point at column ``n_pad-1`` with value 0 (the pad region is
    identically zero in every solver vector, so no masking is needed in the
    inner loop).  ``width`` caps the per-row slot count: entries beyond it
    (hub-row overflow) are returned as a COO remainder — the hybrid
    ELL+COO split (HYB of Bell & Garland's SpMV taxonomy) that keeps
    power-law matrices from padding every row to the hub degree."""
    csr = a.tocsr()
    n = csr.shape[0]
    nnz_per_row = np.diff(csr.indptr)
    wmax = int(nnz_per_row.max()) if n > 0 else 0
    width = min(width, wmax) if width else wmax
    width = max(width, 1)
    # position of each nonzero within its row
    pos = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], nnz_per_row)
    rows_of = np.repeat(np.arange(n), nnz_per_row)
    in_ell = pos < width
    cols = np.full((n_pad, width), n_pad - 1, dtype=np.int32)
    vals = np.zeros((n_pad, width), dtype=csr.dtype)
    cols[rows_of[in_ell], pos[in_ell]] = csr.indices[in_ell]
    vals[rows_of[in_ell], pos[in_ell]] = csr.data[in_ell]
    ov = ~in_ell
    tail = sp.coo_matrix(
        (csr.data[ov], (rows_of[ov], csr.indices[ov].astype(np.int64))),
        shape=(n, n))
    return cols, vals, tail


def ell_matvec(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor
               ) -> torch.Tensor:
    """y_i = sum_k vals[i,k] * x[cols[i,k]] — gather + dense reduction."""
    return (vals * x[cols]).sum(dim=1)


def coo_matvec(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
               x: torch.Tensor, n_out: int) -> torch.Tensor:
    """Scatter-add SpMV (fallback for pathological row distributions)."""
    y = torch.zeros(n_out, dtype=x.dtype, device=x.device)
    return y.index_add_(0, rows, vals * x[cols])


#: structural-diagonal count up to which the DIA fast path is preferred
DIA_MAX_DIAGONALS = 192
#: below this dimension a dense operator is cheapest
DENSE_MAX_N = 2048
#: switch ELL -> hybrid ELL+COO when the max row length exceeds this
#: multiple of the 95th-percentile row length (plain ELL pads every row to
#: the hub degree)
HYB_WASTE_FACTOR = 3


def _to_dia(a: sp.spmatrix):
    """(offsets, row-aligned diagonal arrays) from a sparse matrix."""
    coo = a.tocoo()
    n = a.shape[0]
    d = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    offsets = np.unique(d)
    diags = []
    for off in offsets:
        arr = np.zeros(n, a.dtype)
        m = d == off
        arr[coo.row[m]] = coo.data[m]
        diags.append(arr)
    return [int(o) for o in offsets], diags


def _dia_tab(diags, n: int, n_pad: int, dtype) -> np.ndarray:
    """The ``(nd, n_pad)`` table of row-aligned diagonals, zero past ``n``."""
    dtab = np.zeros((len(diags), n_pad), dtype)
    for k, diag in enumerate(diags):
        dtab[k, :n] = diag[:n]
    return dtab


def dia_table(a: sp.spmatrix, n_pad: int):
    """``(offsets, dtab)``: the int64 offsets of :func:`_to_dia` and its
    diagonals as one ``(nd, n_pad)`` table, zero past ``n``, the operands
    of :func:`~arpack_ng_tpu_torch.ops.cuda_dia.dia_matvec`."""
    offsets, diags = _to_dia(a)
    return (np.asarray(offsets, np.int64),
            _dia_tab(diags, a.shape[0], n_pad, a.dtype))


def _dia_products(offsets, diags, n: int, n_pad: int, device):
    """``(matvec, apply_block, sub)`` over one device copy of the table:
    the products of :func:`dia_matvec_fn`, :func:`dia_block_matvec_fn` and
    :func:`dia_sub_fn`."""
    device = require(device)
    dtype = np.result_type(*diags) if len(diags) else np.float64
    if not len(offsets):
        def sub(x, y, d=None, form=SUB, out=None):
            res = sub_epilogue(torch.zeros_like(x), y, d, form)
            return res if out is None else out.copy_(res)

        return torch.zeros_like, torch.zeros_like, sub
    dtab_d = torch.from_numpy(_dia_tab(diags, n, n_pad, dtype)).to(device)
    offs = torch.from_numpy(np.asarray(offsets, np.int64))
    if _dt.is_complex(dtype):
        # the twins read their offsets on the host: no device read, so a
        # CUDA graph can hold the product
        def matvec(x):
            return dia_matvec_plain(offs, dtab_d, x, n)

        def apply_block(X):
            return dia_block_matvec_plain(offs, dtab_d, X, n)

        def sub(x, y, d=None, form=SUB, out=None):
            res = dia_matvec_sub_plain(offs, dtab_d, x, n, y, d, form)
            return res if out is None else out.copy_(res)
    else:
        offs_d = offs.to(device)

        def matvec(x):
            return dia_matvec(offs_d, dtab_d, x, n)

        def apply_block(X):
            return dia_block_matvec(offs_d, dtab_d, X, n)

        def sub(x, y, d=None, form=SUB, out=None):
            return dia_matvec_sub(offs_d, dtab_d, x, n, y, d, form, out)

    return matvec, apply_block, sub


def dia_matvec_fn(offsets, diags, n: int, n_pad: int, device=DEFAULT):
    """The DIA matvec ``x -> A x`` of ``diags[k][i] = A[i, i + offsets[k]]``
    on ``device`` (port of ``arpack_ng_tpu/ops/sparse.py:92-115``): ``x``
    and the result have length ``n_pad``, the result is zero past ``n``.
    The offsets and the ``(nd, n_pad)`` table live on the device and the
    diagonals are summed in the order of ``offsets``; an offset with
    ``|d| >= n`` adds nothing.  A real table runs
    :func:`~arpack_ng_tpu_torch.ops.cuda_dia.dia_matvec` (the kernel on the
    card, its twin on the CPU); a complex one the twin with host offsets,
    as ``from_scipy`` does; no diagonal at all gives zero."""
    return _dia_products(offsets, diags, n, n_pad, device)[0]


def dia_sub_fn(offsets, diags, n: int, n_pad: int, device=DEFAULT):
    """The DIA product with an epilogue, ``(x, y, d=None, form=SUB,
    out=None) -> y - A x`` (``form`` ``cuda_dia.SUB``), ``d * (y - A x)``
    (``SCALE_SUB``) or ``y - d * (A x)`` (``SUB_SCALED``), over the table
    of :func:`dia_matvec_fn`: a real table runs
    :func:`~arpack_ng_tpu_torch.ops.cuda_dia.dia_matvec_sub` (one launch on
    the card, its twin on the CPU), a complex one the twin with host
    offsets; each rounds as :func:`dia_matvec_fn`'s product and the torch
    ops of the epilogue.  ``out``: where to write (not ``x``)."""
    return _dia_products(offsets, diags, n, n_pad, device)[2]


def dia_block_matvec_fn(offsets, diags, n: int, n_pad: int, device=DEFAULT):
    """The block DIA product ``X -> A X`` over ``(b, n_pad)`` rows on
    ``device`` (port of ``arpack_ng_tpu/ops/sparse.py:118-183``): a real
    table runs :func:`~arpack_ng_tpu_torch.ops.cuda_dia.dia_block_matvec`
    (each diagonal read once per block on the card), a complex one its
    twin with host offsets; row ``c`` of the result is
    :func:`dia_matvec_fn`'s product of ``X[c]``.  ``n_pad`` must be a
    multiple of 128, as in the reference."""
    if n_pad % 128:
        raise ValueError("n_pad must be a multiple of 128")
    return _dia_products(offsets, diags, n, n_pad, device)[1]


def structural_diagonals(a: sp.spmatrix) -> int:
    coo = a.tocoo()
    return int(np.unique(coo.col.astype(np.int64)
                         - coo.row.astype(np.int64)).size)


def _psell_groups(a: sp.spmatrix) -> int:
    """Number of (output-chunk, column-panel) groups a PSELL packing of
    ``a`` would touch — the x-panel fetch count per matvec."""
    coo = a.tocoo()
    g = coo.row.astype(np.int64) // ps.CHUNK
    q = coo.col.astype(np.int64) // ps.PANEL
    return int(np.unique(g * (a.shape[1] // ps.PANEL + 2) + q).size)


def _psell_uniform_tiles(a: sp.spmatrix) -> int:
    """Total tile count of a uniform-W PSELL packing of ``a`` (chunks x
    max tiles-per-chunk) — the slot-padding cost orderings minimize."""
    coo = a.tocoo()
    n = a.shape[0]
    g = coo.row.astype(np.int64) // ps.CHUNK
    q = coo.col.astype(np.int64) // ps.PANEL
    qw = a.shape[1] // ps.PANEL + 2
    gq = g * qw + q
    uq, cnt = np.unique(gq, return_counts=True)
    tpg = -(-cnt // ps.TILE)
    nch = -(-n // ps.CHUNK)
    tpc = np.zeros(nch, np.int64)
    np.add.at(tpc, uq // qw, tpg)
    return int(nch * max(tpc.max(), 1))


def _deal_perm(a: sp.spmatrix) -> np.ndarray:
    """Degree-balanced 'deal' permutation: rows sorted by degree and
    dealt round-robin across output chunks, so hub rows spread evenly
    over the chunks of a uniform-W PSELL packing."""
    n = a.shape[0]
    deg = np.diff(a.tocsr().indptr)
    nch = -(-n // ps.CHUNK)
    order = np.argsort(-deg, kind="stable")
    pos = (np.arange(n) % nch) * ps.CHUNK + (np.arange(n) // nch)
    new_index = np.empty(n, np.int64)
    new_index[order] = pos[:n]
    return np.argsort(new_index)


def _hyb_width(a: sp.csr_matrix) -> int:
    """Row width of the ELL body of a hybrid split: the 95th percentile
    of the row lengths."""
    return max(int(np.ceil(np.percentile(np.diff(a.indptr), 95))), 1)


def choose_format(a: sp.csr_matrix, hermitian: bool = False):
    """``format='auto'``: ``(format, a, perm)`` for a canonical CSR matrix
    of dimension above :data:`DENSE_MAX_N`: DIA, then RCM + DIA (``a``
    permuted, ``perm`` set), then ELL or, for hub rows, HYB."""
    if structural_diagonals(a) <= DIA_MAX_DIAGONALS:
        return "dia", a, None
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    p = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=hermitian))
    ap = a[p][:, p]
    if structural_diagonals(ap) <= DIA_MAX_DIAGONALS:
        return "dia", ap.tocsr(), p
    nnz_row = np.diff(a.indptr)
    if int(nnz_row.max()) > HYB_WASTE_FACTOR * _hyb_width(a):
        return "hyb", a, None
    return "ell", a, None


def from_scipy(a: sp.spmatrix, dtype=None, *, hermitian: bool = False,
               n_pad: int = 0, format: str = "auto", device=DEFAULT
               ) -> Operator:
    """Import a scipy sparse matrix as a mode-1 operator on ``device``
    (the card unless told otherwise).

    ``format='auto'``: dense for ``n <= DENSE_MAX_N``, else
    :func:`choose_format`.  The chosen structure is recorded on
    ``Operator.format`` and an RCM permutation on ``Operator.perm``.
    ``n_pad`` defaults to ``n`` rounded up to whole 1024-row chunks."""
    device = require(device)
    a = a.tocsr().copy()   # own the buffers: canonicalization below must
    a.sum_duplicates()     # never mutate the caller's matrix
    if dtype is not None:
        a = a.astype(dtype)
    cplx = _dt.is_complex(a.dtype)
    n = a.shape[0]
    n_pad = n_pad or pad_dim(n, ps.CHUNK)
    perm = None

    if format == "auto":
        if n <= DENSE_MAX_N:
            return from_dense(a.toarray(), n_pad=n_pad, hermitian=hermitian,
                              device=device)
        format, a, perm = choose_format(a, hermitian)

    blk = None
    if format == "dia":
        matvec, blk, _ = _dia_products(*_to_dia(a), n, n_pad, device)
        if n_pad % 128:
            blk = None
    elif format in ("ell", "hyb"):
        width = _hyb_width(a) if format == "hyb" else 0
        cols_np, vals_np, tail = _to_ell(a, n_pad, width=width)
        cols = torch.from_numpy(cols_np).long().to(device)
        vals = torch.from_numpy(vals_np).to(device)
        if format == "ell":
            def matvec(x):
                return ell_matvec(cols, vals, x)
        else:
            trows = torch.from_numpy(tail.row.astype(np.int64)).to(device)
            tcols = torch.from_numpy(tail.col.astype(np.int64)).to(device)
            tvals = torch.from_numpy(tail.data).to(device)

            def matvec(x):
                y = ell_matvec(cols, vals, x)
                return y.index_add_(0, trows, tvals * x[tcols])
    elif format == "psell":
        if cplx:
            raise ValueError("format='psell' takes real matrices (the PSELL "
                             "kernel is real-only)")
        psell_pad = -(-n_pad // ps.CHUNK) * ps.CHUNK
        tiles = psell_tiles(ps.pack_psell_uniform(a, n_pad=psell_pad),
                            device)

        def matvec(x):
            return psell_matvec(tiles, x)[:n_pad]
    elif format == "coo":
        coo = a.tocoo()
        rows = torch.from_numpy(coo.row.astype(np.int64)).to(device)
        ccols = torch.from_numpy(coo.col.astype(np.int64)).to(device)
        cvals = torch.from_numpy(coo.data).to(device)

        def matvec(x):
            return coo_matvec(rows, ccols, cvals, x, n_pad)
    else:
        raise ValueError(f"unknown sparse format {format!r}")

    def apply(v, bv):
        w = matvec(v)
        return w, w

    return Operator(n=n, dtype=a.dtype, apply=apply, bmat="I", mode=1,
                    a_apply=matvec, n_pad=n_pad, hermitian=hermitian,
                    perm=perm, format=format, device=device, capturable=True,
                    apply_block=blk)
