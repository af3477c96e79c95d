"""DIA (diagonal-set) sparse matrix-vector product (port of
``arpack_ng_tpu/ops/pallas_dia.py``; kernel in ``csrc/dia.cu``).

:func:`dia_matvec` computes ``y[i] = sum_k dtab[k, i] * x[i + off_k]`` for
``i < n``, with ``x`` read as zero outside ``[0, n)``, and ``y[n:] = 0``:
the matvec of the DIA operators of ``ops/sparse.from_scipy``.  ``dtab``
is the ``(nd, n_pad)`` table of row-aligned diagonals
(``dtab[k, i] = A[i, i + offsets[k]]``), ``offsets`` an int64 tensor of
``nd`` offsets on the same device; the diagonals are summed in that order.

:func:`dia_block_matvec` is the same product over a block of ``b``
vectors, ``Y = A X`` with ``X`` and ``Y`` row-major ``(b, n_pad)``: the
block apply of ``core/block`` (port of
``arpack_ng_tpu/ops/sparse.py:118-183``).
Its kernel reads each diagonal once per block (per 8 columns past 8),
takes X through shared memory in windows, one per run of diagonals whose
offsets lie close together (:func:`block_plan` gives the runs and the
launch's shape), and column ``c`` of ``Y`` equals ``dia_matvec(offsets,
dtab, X[c], n)`` bit for bit.

:func:`dia_matvec_sub` is the product with an epilogue, the Neumann
sweeps of ``ops/solvers.ilu0_preconditioner`` in one launch each: ``out =
y - A x`` (:data:`SUB`), ``d * (y - A x)`` (:data:`SCALE_SUB`) or ``y - d
* (A x)`` (:data:`SUB_SCALED`), each row's sum exactly :func:`dia_matvec`'s
and the rest rounded as the torch ops it replaces
(:func:`dia_matvec_sub_plain`).

Each wrapper runs its plain twin (:func:`dia_matvec_plain`, the
shift-multiply of ``arpack_ng_tpu/ops/sparse.py:100-113``,
:func:`dia_matvec_sub_plain` and :func:`dia_block_matvec_plain`) for
tensors on the CPU and launches its CUDA kernel for tensors on a CUDA
device; ``launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib


def dia_matvec_plain(offsets, dtab, x, n):
    """Plain twin of :func:`dia_matvec`: one shifted multiply-add per
    diagonal, in the order of ``offsets`` (:func:`dia_block_matvec_plain`
    of the one-row block)."""
    return dia_block_matvec_plain(offsets, dtab, x[None], n)[0]


def dia_matvec(offsets: torch.Tensor, dtab: torch.Tensor, x: torch.Tensor,
               n: int) -> torch.Tensor:
    """``y = A x`` for the DIA matrix ``(offsets, dtab)`` of logical size
    ``n``; ``x`` and the returned ``y`` have length ``dtab.shape[1]``."""
    y = _product(offsets, dtab, x, n, None, None, PLAIN, None)
    if y.device.type == "cuda":
        dia_matvec.launches += 1
    return y


dia_matvec.launches = 0

#: the forms of ``csrc/dia.cu``'s kernel: the product (:func:`dia_matvec`)
#: and the epilogues of :func:`dia_matvec_sub`
PLAIN, SUB, SCALE_SUB, SUB_SCALED = -1, 0, 1, 2


def sub_epilogue(ax, y, d, form):
    """The torch ops of an epilogue ``form`` on a product ``ax`` (the pair
    of ops each Neumann sweep ran)."""
    if form == SUB:
        return y - ax
    if form == SCALE_SUB:
        return d * (y - ax)
    return y - d * ax


def dia_matvec_sub_plain(offsets, dtab, x, n, y, d=None, form=SUB):
    """Plain twin of :func:`dia_matvec_sub`: the product's twin, then
    :func:`sub_epilogue`."""
    return sub_epilogue(dia_matvec_plain(offsets, dtab, x, n), y, d, form)


def dia_matvec_sub(offsets: torch.Tensor, dtab: torch.Tensor,
                   x: torch.Tensor, n: int, y: torch.Tensor, d=None,
                   form: int = SUB, out=None) -> torch.Tensor:
    """``y - A x`` (``form`` :data:`SUB`), ``d * (y - A x)``
    (:data:`SCALE_SUB`) or ``y - d * (A x)`` (:data:`SUB_SCALED`) for the
    DIA matrix of :func:`dia_matvec`; ``y``, ``d`` and the result have
    ``x``'s length and dtype.  ``out``: the vector to write (must not
    overlap ``x``); returns it, or a new vector."""
    if form not in (SUB, SCALE_SUB, SUB_SCALED):
        raise ValueError(f"unknown form {form}")
    res = _product(offsets, dtab, x, n, y, d, form, out)
    if res.device.type == "cuda":
        dia_matvec_sub.launches += 1
    return res


dia_matvec_sub.launches = 0


def _product(offsets, dtab, x, n, y, d, form, out):
    """The checks and the launch (the twin on the CPU) of
    :func:`dia_matvec` (``form`` :data:`PLAIN`, no ``y``, ``d``, ``out``)
    and :func:`dia_matvec_sub`."""
    if dtab.dim() != 2 or not dtab.is_contiguous():
        raise ValueError("dtab must be a contiguous (nd, n_pad) table")
    nd, n_pad = dtab.shape
    if offsets.shape != (nd,) or offsets.dtype != torch.int64 \
            or not offsets.is_contiguous():
        raise ValueError(f"offsets must be a contiguous int64 tensor of "
                         f"{nd} offsets")
    vecs = [x] + ([y] if form != PLAIN else []) \
        + ([d] if form in (SCALE_SUB, SUB_SCALED) else []) \
        + ([out] if out is not None else [])
    if any(v is None or v.shape != (n_pad,) or v.dtype != dtab.dtype
           or not v.is_contiguous() for v in vecs):
        raise ValueError(f"x, y, d and out must be contiguous {dtab.dtype} "
                         f"vectors of length {n_pad}")
    if not 0 <= n <= n_pad or nd < 1:
        raise ValueError(f"n={n} outside [0, {n_pad}] or no diagonal")
    if any(v.device != x.device for v in vecs + [dtab, offsets]):
        raise ValueError("offsets, dtab and the vectors must share one "
                         "device")
    if out is not None and out.data_ptr() < x.data_ptr() + x.nbytes \
            and x.data_ptr() < out.data_ptr() + out.nbytes:
        raise ValueError("out must not overlap x")
    if x.device.type == "cpu":
        res = dia_matvec_plain(offsets, dtab, x, n) if form == PLAIN \
            else dia_matvec_sub_plain(offsets, dtab, x, n, y, d, form)
        return res if out is None else out.copy_(res)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    code = cuda_lib.dtype_code(x.dtype, x.dtype)
    lib = cuda_lib.load()
    if out is None:
        out = torch.empty_like(x)
    err = lib.atpt_dia_matvec_sub(
        code, form, offsets.data_ptr(), nd, dtab.data_ptr(), dtab.stride(0),
        x.data_ptr(), None if y is None else y.data_ptr(),
        None if d is None else d.data_ptr(), n, n_pad, out.data_ptr(),
        cuda_lib.stream_handle(x.device))
    cuda_lib.check(lib, err,
                   "dia_matvec" if form == PLAIN else "dia_matvec_sub")
    return out


#: the block kernel's shape (``csrc/dia.cu``): threads per block, columns
#: per chunk, bytes of a block's two stages of X windows, the values a
#: window column's stride holds past the window, the most offsets it plans
#: in shared memory
BLOCK_THREADS, DIA_COLS, WINDOW_BYTES, BLOCK_PAD, PLAN_CAP = \
    256, 8, 96 * 1024, 4, 512


def block_plan(offsets, n: int, b: int, dtype) -> dict:
    """The plan ``dia_block_kernel`` derives on the card for host
    ``offsets`` (a sequence of ints), ``n`` and ``b`` columns of
    ``dtype``: ``tile`` rows T per item, ``window`` values W per column of
    a stage, ``span`` S = W - T (the widest run), ``smem`` dynamic shared
    bytes per block and ``runs``, the ``(first, end, lo, hi)`` diagonal
    ranges whose offsets span at most S, in the order of ``offsets``
    (each run copies a window of T + span values a column).  Offsets with
    ``|off| >= n`` add nothing and are left out; past
    PLAN_CAP offsets each kept offset is a run of its own."""
    isz = torch.empty((), dtype=dtype).element_size()
    cb = min(b, DIA_COLS)
    tile = BLOCK_THREADS * (4 if isz == 4 or cb <= 4 else 2)
    window = min(WINDOW_BYTES // (2 * cb * isz) // 4 * 4, 5 * tile)
    span = window - tile
    offs = [int(o) for o in offsets]
    planned = len(offs) <= PLAN_CAP
    runs = []
    for k, o in enumerate(offs):
        if abs(o) >= n:
            continue
        if planned and runs and max(runs[-1][3], o) - min(runs[-1][2], o) \
                <= span:
            first, _, lo, hi = runs[-1]
            runs[-1] = (first, k + 1, min(lo, o), max(hi, o))
        else:
            runs.append((k, k + 1, o, o))
    if planned and runs:
        # a run ends where the next begins (left-out offsets between add
        # nothing), the last at nd
        runs = [(f, e, lo, hi) for (f, _, lo, hi), e in
                zip(runs, [r[0] for r in runs[1:]] + [len(offs)])]
    return {"tile": tile, "window": window, "span": span, "runs": runs,
            "smem": 2 * cb * (window + BLOCK_PAD) * isz
            + (28 * len(offs) if planned else 0)}


def block_config(nd: int, b: int, n_pad: int, dtype,
                 device=None) -> dict:
    """The launch ``dia_block_matvec`` makes on the card for ``nd``
    diagonals, ``b`` columns and ``n_pad`` rows of ``dtype`` (the kernel
    library's own answer; it reads no offsets): ``tile``, ``window``,
    ``smem``, ``blocks_per_sm``, ``grid``, ``planned``, ``cols``."""
    lib = cuda_lib.load()
    out = (ctypes.c_longlong * 7)()
    with torch.cuda.device(device):
        err = lib.atpt_dia_block_config(cuda_lib.dtype_code(dtype, dtype),
                                        nd, b, n_pad, out)
    cuda_lib.check(lib, err, "dia_block_config")
    keys = ("tile", "window", "smem", "blocks_per_sm", "grid", "planned",
            "cols")
    return dict(zip(keys, (int(v) for v in out)))


def dia_block_matvec_plain(offsets, dtab, X, n):
    """Plain twin of :func:`dia_block_matvec`: the shift-multiply of
    :func:`dia_matvec_plain` over the ``(b, n)`` rows at once, so each
    column rounds as the single product does.  The reference package's
    lane-major ``(G, b, 128)`` interleave (``arpack_ng_tpu/ops/sparse.py:
    131-152``) answered the TPU's layout and is not carried over."""
    Xs = X[:, :n]
    Y = torch.zeros((X.shape[0], n), dtype=X.dtype, device=X.device)
    for k, d in enumerate(offsets.tolist()):
        if abs(d) >= n:
            continue
        diag = dtab[k, :n]
        if d == 0:
            Y = Y + diag * Xs
        elif d > 0:
            Y[:, : n - d] += diag[: n - d] * Xs[:, d:]
        else:
            Y[:, -d:] += diag[-d:] * Xs[:, : n + d]
    out = torch.zeros(X.shape, dtype=X.dtype, device=X.device)
    out[:, :n] = Y
    return out


def dia_block_matvec(offsets: torch.Tensor, dtab: torch.Tensor,
                     X: torch.Tensor, n: int) -> torch.Tensor:
    """``Y = A X`` for the DIA matrix ``(offsets, dtab)`` of logical size
    ``n`` and a contiguous block ``X`` of ``b`` rows of length
    ``dtab.shape[1]``; returns ``Y`` of ``X``'s shape."""
    if dtab.dim() != 2 or not dtab.is_contiguous():
        raise ValueError("dtab must be a contiguous (nd, n_pad) table")
    nd, n_pad = dtab.shape
    if offsets.shape != (nd,) or offsets.dtype != torch.int64 \
            or not offsets.is_contiguous():
        raise ValueError(f"offsets must be a contiguous int64 tensor of "
                         f"{nd} offsets")
    if X.dim() != 2 or X.shape[1] != n_pad or X.shape[0] < 1 \
            or X.dtype != dtab.dtype or not X.is_contiguous():
        raise ValueError(f"X must be a contiguous {dtab.dtype} block of "
                         f"shape (b, {n_pad}), b >= 1")
    if not 0 <= n <= n_pad or nd < 1:
        raise ValueError(f"n={n} outside [0, {n_pad}] or no diagonal")
    if not (offsets.device == dtab.device == X.device):
        raise ValueError("offsets, dtab and X must share one device")
    if X.device.type == "cpu":
        return dia_block_matvec_plain(offsets, dtab, X, n)
    if X.device.type != "cuda":
        raise ValueError(f"no kernel for device {X.device}")
    code = cuda_lib.dtype_code(X.dtype, X.dtype)
    lib = cuda_lib.load()
    Y = torch.empty_like(X)
    err = lib.atpt_dia_block_matvec(
        code, offsets.data_ptr(), nd, dtab.data_ptr(), dtab.stride(0),
        X.data_ptr(), X.stride(0), X.shape[0], n, n_pad, Y.data_ptr(),
        Y.stride(0), cuda_lib.stream_handle(X.device))
    cuda_lib.check(lib, err, "dia_block_matvec")
    dia_block_matvec.launches += 1
    return Y


dia_block_matvec.launches = 0
