"""MatrixMarket I/O (port of ``arpack_ng_tpu/io/matrix_market.py``): the
ingestion path of the reference's C++ solver layer
(``arpackSolver::createMatrix`` reading ``.mtx`` coordinate files,
EXAMPLES/MATRIX_MARKET/arpackSolver.hpp:176-215,361) and of its only
matrix-file-driven Fortran test (TESTS/dnsimp.f + TESTS/mmio.f).

Reading delegates to scipy.io (coordinate/array, real/complex/integer/
pattern, general/symmetric/skew-symmetric/hermitian) with the reference's
lenient fallback for its non-standard files; :func:`load_operator` turns a
file into an operator on the card (or the device named).
"""
from __future__ import annotations

import re
from typing import Optional

import numpy as np
import scipy.io as sio
import scipy.sparse as sp

from ..ops.operator import Operator, from_dense
from ..ops.sparse import from_scipy
from ..utils.device import DEFAULT

_CPLX = re.compile(r"\(\s*([^,\s]+)\s*,\s*([^)\s]+)\s*\)")


def read_matrix(path) -> sp.csr_matrix:
    """Read a .mtx file into a CSR matrix (dense array files included).

    Standard MatrixMarket goes through scipy; on a scipy parse failure the
    reader falls back to the lenient rules of the reference's own reader
    (arpackSolver.hpp:360-414), which its shipped matrices need: skip
    ``%``/blank lines, first data line ``n m [nnz]``, body ``i j value``
    with ``value`` real or an ``(re, im)`` pair, 1-based indices detected
    by ``max(index) == n`` and shifted down."""
    try:
        m = sio.mmread(path)
    except ValueError:
        return _read_lenient(path)
    if not sp.issparse(m):
        m = sp.csr_matrix(m)
    return m.tocsr()


def _read_lenient(path) -> sp.csr_matrix:
    n = m = None
    rows, cols, vals = [], [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("%"):
                continue
            if n is None:
                parts = line.split()
                n, m = int(parts[0]), int(parts[1])
                continue
            cm = _CPLX.search(line)
            if cm:
                ij = line[: cm.start()].split()
                rows.append(int(ij[0]))
                cols.append(int(ij[1]))
                vals.append(complex(float(cm.group(1)),
                                    float(cm.group(2))))
            else:
                i, j, v = line.split()
                rows.append(int(i))
                cols.append(int(j))
                vals.append(float(v))
    if n is None:
        raise ValueError(f"{path}: no size header found")
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    dtype = (np.complex128 if any(isinstance(v, complex) for v in vals)
             else np.float64)
    data = np.asarray(vals, dtype)
    if len(rows) and (rows.max() == n or cols.max() == m):
        rows -= 1                       # 1-based (reference detection rule)
        cols -= 1
    return sp.csr_matrix((data, (rows, cols)), shape=(n, m))


def write_matrix(path, a) -> None:
    """Write a dense or sparse matrix as a MatrixMarket coordinate file."""
    sio.mmwrite(path, sp.coo_matrix(a))


def is_hermitian(a: sp.spmatrix) -> bool:
    """The reference's structural test (the ``.mtx`` header is not
    trusted): ``A - A^H`` has no entry above ``1e-12 max(1, max|a_ij|)``
    (``A^H`` as ``conj().T``: sparse arrays have no ``getH``)."""
    d = ((a - a.conj().T) if np.iscomplexobj(a.data) else (a - a.T)).tocoo()
    return bool(len(d.data) == 0 or np.max(np.abs(d.data))
                <= 1e-12 * max(1.0, np.max(np.abs(a.data))))


def load_operator(path, *, dtype=None, dense: bool = False,
                  hermitian: Optional[bool] = None,
                  device=DEFAULT) -> Operator:
    """File -> operator on ``device``, the card unless told otherwise
    (arpackmm's --A / --dense flags, EXAMPLES/MATRIX_MARKET/
    arpackmm.cpp:104-150): ``from_scipy`` (its ``format='auto'`` choice)
    or, with ``dense``, ``from_dense``; ``hermitian`` None runs
    :func:`is_hermitian`."""
    a = read_matrix(path)
    if hermitian is None:
        hermitian = is_hermitian(a)
    if dense:
        arr = a.toarray()
        if dtype is not None:
            arr = arr.astype(dtype)
        return from_dense(arr, hermitian=bool(hermitian), device=device)
    return from_scipy(a, dtype=dtype, hermitian=bool(hermitian),
                      device=device)
