"""User-facing solver API (port of ``arpack_ng_tpu/api.py``): ``eigsh``,
the dsaupd/dseupd driver pair, and ``eigs``, the dnaupd/dneupd pair for
real non-symmetric problems.

Both take the reference package's arguments plus ``device`` (the CUDA
card unless the caller asks for ``device="cpu"``).  The options outside
this package's current slice raise ``NotImplementedError`` rather than
run a different algorithm: spectral transforms (``M``, ``sigma``,
``mode``), ``mesh``, ``shift_fn``, ``restart='thick'``, ``validate``,
``select``, the hybrid and complex fused strategies and complex dtypes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import IRAMConfig, default_ncv, pad_dim
from .core.extract import EigenResult, extract
from .ops import operator as op_mod
from .ops.operator import Operator
from .utils.device import DEFAULT
from .utils.device import same as same_device


def _as_operator(A, dtype=None, hermitian=False, device=None) -> Operator:
    """Coerce a user input (Operator | dense array | scipy sparse) into an
    Operator on ``device`` (default: the operator's own device, else the
    card)."""
    if isinstance(A, Operator):
        if device is not None and not same_device(device, A.device):
            raise ValueError(f"operator lives on {A.device}, not {device}")
        return A
    device = DEFAULT if device is None else device
    if hasattr(A, "tocsr"):  # scipy sparse
        from .ops.sparse import from_scipy
        return from_scipy(A, dtype=dtype, hermitian=hermitian, device=device)
    a = np.asarray(A)
    if a.ndim == 2:
        if dtype is not None:
            a = a.astype(dtype)
        return op_mod.from_dense(a, n_pad=pad_dim(a.shape[0]),
                                 hermitian=hermitian, device=device)
    raise TypeError(f"cannot build an Operator from {type(A)!r}")


def _resolve_storage(storage_dtype, dtype, tol, pro_active=False):
    """Resolve ``storage_dtype='auto'``: bfloat16 basis storage for real
    float32 problems with ``tol >= 1e-2`` when the full-CGS path runs;
    full precision under partial reorthogonalization."""
    if not (isinstance(storage_dtype, str) and storage_dtype == "auto"):
        return storage_dtype
    if pro_active or np.dtype(dtype) != np.dtype(np.float32):
        return None
    if tol is not None and tol >= 1e-2:
        return torch.bfloat16
    return None


def _resolve_sym_reorth(reorth: str) -> str:
    """``reorth='auto'`` is partial reorthogonalization ('selective') on
    the symmetric path, as in the reference package."""
    if reorth == "auto":
        return "selective"
    return reorth


def _refuse(**options) -> None:
    """Raise ``NotImplementedError`` for an option outside the slice."""
    for name, val in options.items():
        if val is not None:
            raise NotImplementedError(f"{name}= is not ported yet")


class ArpackError(RuntimeError):
    """Solver error with the reference's info-code catalog
    (SRC/dsaupd.f:247-276)."""

    _CODES = {
        -1: "n must be positive",
        -2: "nev must be positive",
        -3: "ncv out of range (need nev < ncv <= n)",
        -4: "max_iter must be positive",
        -5: "invalid which",
        -6: "invalid bmat",
        -7: "work array too small (not applicable)",
        -8: "reduced-space eigensolver failed",
        -9: "starting vector is zero",
        -9999: "could not build an Arnoldi factorization",
        -13: "nev and which='BE' incompatible",
        -14: "did not find enough converged eigenvalues on extraction",
    }

    def __init__(self, info: int):
        self.info = info
        super().__init__(
            f"ARPACK error {info}: {self._CODES.get(info, 'unknown')}")


class ArpackNoConvergence(ArpackError):
    """Max restarts reached with fewer than nev converged (info = 1)."""

    def __init__(self, partial: EigenResult, cfg: IRAMConfig):
        self.eigenvalues = partial.values
        self.eigenvectors = partial.vectors
        self.info = 1
        RuntimeError.__init__(
            self,
            f"ARPACK error 1: no convergence ({partial.nconv}/{cfg.nev} "
            f"eigenvalues converged in {cfg.max_iter} restart iterations)")


def eigsh(
    A,
    k: int = 6,
    *,
    M=None,
    sigma: Optional[float] = None,
    which: str = "LM",
    v0=None,
    ncv: Optional[int] = None,
    maxiter: Optional[int] = None,
    tol: float = 0.0,
    mode: str = "normal",
    return_eigenvectors: bool = True,
    return_stats: bool = False,
    dtype=None,
    seed: int = 0,
    mesh=None,
    strategy: str = "auto",
    storage_dtype="auto",
    cgs_kernel: str = "auto",
    restart: str = "implicit",
    reorth: str = "auto",
    select=None,
    shift_fn=None,
    validate=None,
    device=None,
):
    """Symmetric eigensolver (dsaupd/dseupd equivalent), mode 1 (and
    mode 2 through a ``from_dense(a, m)`` operator).

    ``A``: an :class:`Operator` (its device is the solve's device), a
    dense symmetric matrix or a scipy sparse matrix (imported by
    :func:`~arpack_ng_tpu_torch.ops.sparse.from_scipy`), moved to
    ``device`` (default: the CUDA card; ``device="cpu"`` for the CPU).
    Returns ``values`` or ``(values, vectors)`` (and the
    :class:`EigenResult` with ``return_stats``), as the reference package
    does.
    """
    if sigma is not None or mode != "normal" or M is not None:
        raise NotImplementedError("spectral transforms (M, sigma, mode) "
                                  "are not ported yet")
    _refuse(mesh=mesh, shift_fn=shift_fn, validate=validate, select=select)
    if strategy not in ("auto", "fused"):
        raise NotImplementedError(f"strategy={strategy!r} is not ported "
                                  "yet")
    if restart != "implicit":
        raise NotImplementedError(f"restart={restart!r} is not ported yet")
    op = _as_operator(A, dtype=dtype, hermitian=True, device=device)
    if np.issubdtype(op.dtype, np.complexfloating):
        raise NotImplementedError("complex (Hermitian) problems are not "
                                  "ported yet")
    n = op.n
    ncv = ncv if ncv is not None else default_ncv(n, k, symmetric=True)
    reorth = _resolve_sym_reorth(reorth)
    pro_active = reorth == "selective" and restart == "implicit"
    storage_dtype = _resolve_storage(storage_dtype, op.dtype, tol,
                                     pro_active=pro_active)
    cfg = IRAMConfig(
        n=n, nev=k, ncv=min(ncv, n), which=which, bmat=op.bmat,
        mode=op.mode, tol=tol,
        max_iter=maxiter if maxiter is not None else 10 * n,
        symmetric=True, dtype=np.dtype(op.dtype), n_pad=op.n_pad, seed=seed,
        exact_shifts=True, storage_dtype=storage_dtype,
        cgs_kernel=cgs_kernel, restart=restart, reorth=reorth)
    from .core.device_sym import FusedSymSolver
    res = FusedSymSolver(op, cfg).solve(v0=v0)
    if res.info < 0:
        raise ArpackError(res.info)
    out = extract(op, cfg, res, rvec=return_eigenvectors)
    if res.info in (1, 2) and out.nconv < cfg.nev:
        raise ArpackNoConvergence(out, cfg)
    ret = (out.values, out.vectors) if return_eigenvectors else out.values
    if return_stats:
        return ret + (out,) if return_eigenvectors else (ret, out)
    return ret


def eigs(
    A,
    k: int = 6,
    *,
    M=None,
    sigma: Optional[complex] = None,
    which: str = "LM",
    v0=None,
    ncv: Optional[int] = None,
    maxiter: Optional[int] = None,
    tol: float = 0.0,
    return_eigenvectors: bool = True,
    return_stats: bool = False,
    return_schur: bool = False,
    dtype=None,
    seed: int = 0,
    mesh=None,
    strategy: str = "auto",
    cgs_kernel: str = "auto",
    reorth: str = "auto",
    select=None,
    validate=None,
    device=None,
):
    """Real non-symmetric eigensolver (dnaupd/dneupd equivalent), mode 1.

    ``A``: an :class:`Operator`, a dense matrix or a scipy sparse matrix
    (imported by :func:`~arpack_ng_tpu_torch.ops.sparse.from_scipy` with
    ``hermitian=False``), moved to ``device`` (default: the CUDA card).
    ``strategy='auto'`` is the reference's default for real dtypes,
    ``'fused_real'``: the restart cycle of
    :mod:`~arpack_ng_tpu_torch.core.device_realnonsym` with its reduced
    space in the problem dtype.  ``reorth='auto'`` is ``'dgks'``: the
    semi-orthogonality argument behind ``'selective'`` is a Lanczos result.
    Values come wanted first; a conjugate pair is never split, so k + 1
    values may come back.  ``return_schur`` returns the Schur vectors of
    the wanted invariant subspace in place of the eigenvectors.

    Not ported yet (``NotImplementedError``): ``sigma``, ``M``, ``select``,
    ``validate``, ``mesh``, ``strategy='fused'`` and ``'hybrid'``, complex
    dtypes.  ``validate`` raises even under ``return_schur``, where the
    reference skips it without a word.
    """
    if sigma is not None or M is not None:
        raise NotImplementedError("spectral transforms (M, sigma) are not "
                                  "ported yet")
    _refuse(mesh=mesh, select=select, validate=validate)
    if strategy not in ("auto", "fused_real"):
        raise NotImplementedError(f"strategy={strategy!r} is not ported "
                                  "yet")
    op = _as_operator(A, dtype=dtype, hermitian=False, device=device)
    if np.issubdtype(op.dtype, np.complexfloating):
        raise NotImplementedError("complex problems are not ported yet")
    n = op.n
    ncv = ncv if ncv is not None else default_ncv(n, k, symmetric=False)
    cfg = IRAMConfig(
        n=n, nev=k, ncv=min(ncv, n), which=which, bmat=op.bmat,
        mode=op.mode, tol=tol,
        max_iter=maxiter if maxiter is not None else 10 * n,
        symmetric=False, dtype=np.dtype(op.dtype), n_pad=op.n_pad, seed=seed,
        cgs_kernel=cgs_kernel, reorth="dgks" if reorth == "auto" else reorth)
    from .core.device_realnonsym import FusedRealNonsymSolver
    res = FusedRealNonsymSolver(op, cfg).solve(v0=v0)
    if res.info < 0:
        raise ArpackError(res.info)
    rvec = return_eigenvectors or return_schur
    out = extract(op, cfg, res, rvec=rvec,
                  howmny="P" if return_schur else "A")
    if res.info in (1, 2) and out.nconv < cfg.nev:
        raise ArpackNoConvergence(out, cfg)
    ret = (out.values, out.vectors) if rvec else out.values
    if return_stats:
        return ret + (out,) if rvec else (ret, out)
    return ret
