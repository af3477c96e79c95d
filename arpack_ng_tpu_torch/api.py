"""User-facing solver API (port of ``arpack_ng_tpu/api.py``): ``eigsh``,
the dsaupd/dseupd driver pair (symmetric and Hermitian), and ``eigs``,
the dnaupd/dneupd and znaupd/zneupd pairs (real and complex
non-symmetric), with ``validate=`` (the float64 re-check of the converged
pairs, :class:`F64Validation`).

Both take the reference package's arguments plus ``device`` (the CUDA
card unless the caller asks for ``device="cpu"``), spectral transforms
(``M``, ``sigma``, ``mode``: modes 2-5 through
:mod:`~arpack_ng_tpu_torch.ops.transforms`) included.  ``mesh`` (the
row-partitioned solve) is not ported yet and raises
``NotImplementedError`` rather than run a different algorithm.  Where the
reference package silently does something else, the port raises
``ValueError``: ``restart='thick'`` with ``strategy='hybrid'`` (the
reference runs the implicit restart), ``eigs(validate=...,
return_schur=True)`` (the reference skips the validation) and
``validate='f64'`` with a matrix-free ``M`` (the reference makes an object
array of it).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from .config import IRAMConfig, default_ncv, pad_dim
from .core.extract import EigenResult, extract
from .core.iram import IRAMSolver
from .ops import operator as op_mod
from .ops.operator import Operator
from .utils import dtypes as _dt
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


def _make_solver(op, cfg, strategy, shift_fn=None):
    """``eigsh``'s driver: 'fused' (and 'auto') the symmetric cycle of
    ``core/device_sym`` (the selective loop on the device), 'hybrid' the
    host float64 reduced space of ``core/iram``; either with the caller's
    shifts."""
    if strategy in ("auto", "fused"):
        from .core.device_sym import FusedSymSolver
        return FusedSymSolver(op, cfg, shift_fn=shift_fn)
    return IRAMSolver(op, cfg, shift_fn=shift_fn)


def _check_validate(validate, raw_A, raw_M=None) -> None:
    """The reference's checks of ``validate`` (``api._solve``), made before
    the solve: 'f64' needs a concrete matrix ``raw_A``, and a concrete
    ``raw_M`` where one is given."""
    if validate is None or callable(validate):
        return
    if not (isinstance(validate, str) and validate == "f64"):
        raise ValueError("validate must be None, 'f64', or a float64 matvec "
                         "callable")
    if raw_A is None:
        raise ValueError(
            "validate='f64' needs a concrete matrix input; for a "
            "matrix-free Operator pass validate=<f64 matvec callable> "
            "instead")
    if raw_M is not None and (isinstance(raw_M, Operator)
                              or callable(raw_M)):
        raise ValueError(
            "validate='f64' needs a concrete matrix M (dense or scipy "
            "sparse), not a matrix-free one")


class PseudospectrumWarning(UserWarning):
    """Single-precision non-normal eigenproblem caveat: residual-converged
    Ritz values of a non-normal operator solved in float32 may lie in the
    operator's eps_f32-pseudospectrum, up to ~``eta*||A||`` outside the
    true spectrum, while meeting their residual bound (the reference's
    snaupd shares the property)."""


@dataclasses.dataclass
class F64Validation:
    """Report of ``validate='f64'``: the converged pairs re-applied through
    a float64 (complex128) operator."""

    residuals: np.ndarray      # ||A v - lambda v||_2 / ||v||_2 per pair
    rel_residuals: np.ndarray  # scaled by max(eps23, |lambda|) (dsconv)
    tol_bar: float             # the solve's effective tolerance
    passed: bool               # all rel_residuals <= tol_bar
    nonnormality: float        # probe estimate of ||(A*A'-A'*A)z||/||A'Az||


def _f64_validate(A_raw, M_raw, out, cfg, matvec64=None):
    """Re-apply the converged pairs of ``out`` through a float64
    (complex128) operator, ``A V - M V Lambda`` (``M = I`` where
    ``M_raw`` is None), and estimate the non-normality (reference
    ``arpack_ng_tpu/api.py:_f64_validate``).
    ``matvec64``: a caller's float64 matvec for matrix-free problems (the
    non-normality is then nan: no transpose).  Warns with
    :class:`PseudospectrumWarning` where the pairs miss the tolerance, or
    where a single-precision solve met a detectably non-normal operator."""
    vals = np.asarray(out.values)
    vecs = out.vectors
    if vecs is None or out.nconv == 0:
        return None
    cplx = np.iscomplexobj(vals) or np.iscomplexobj(vecs)
    wdt = np.complex128 if cplx else np.float64
    V = np.asarray(vecs, dtype=wdt)
    if matvec64 is not None:
        AV = np.stack([np.asarray(matvec64(V[:, j]), dtype=wdt)
                       for j in range(V.shape[1])], axis=1)
        nonnorm = float("nan")
    else:
        if hasattr(A_raw, "tocsr"):
            A64 = A_raw.tocsr().astype(wdt)
        else:
            A64 = np.asarray(A_raw, dtype=wdt)
        AV = A64 @ V
        # stochastic non-normality probe: z -> ||(A A^H - A^H A) z|| /
        # ||A^H A z|| over a few unit probes (exactly 0 for normal A)
        rng = np.random.default_rng(0)
        nonnorm = 0.0
        AH = A64.conj().T
        for _ in range(3):
            z = rng.standard_normal(V.shape[0])
            if cplx:
                z = z + 1j * rng.standard_normal(V.shape[0])
            z = z.astype(wdt) / np.linalg.norm(z)
            aaz = AH @ (A64 @ z)
            num = np.linalg.norm(A64 @ (AH @ z) - aaz)
            den = max(np.linalg.norm(aaz), 1e-300)
            nonnorm = max(nonnorm, float(num / den))
    if M_raw is not None:
        M64 = M_raw.tocsr().astype(wdt) if hasattr(M_raw, "tocsr") \
            else np.asarray(M_raw, dtype=wdt)
        R = AV - (M64 @ V) * vals[None, :].astype(wdt)
    else:
        R = AV - V * vals[None, :].astype(wdt)
    res = np.linalg.norm(R, axis=0) / np.maximum(
        np.linalg.norm(V, axis=0), 1e-300)
    rel = res / np.maximum(np.abs(vals), cfg.eps23)
    tol_bar = cfg.tol_effective
    passed = bool(np.all(rel <= tol_bar))
    rep = F64Validation(residuals=res, rel_residuals=rel,
                        tol_bar=float(tol_bar), passed=passed,
                        nonnormality=nonnorm)
    # the solve's real width (the reference tests the values' kind
    # instead, so a float64 solve with complex values counts as single)
    single = np.dtype(_dt.real_dtype(cfg.dtype)).itemsize <= 4
    if not passed:
        warnings.warn(
            "f64 validation: converged pairs do not meet the requested "
            f"tolerance under a float64 operator (max relative residual "
            f"{float(np.max(rel)):.3e} > tol {tol_bar:.1e}); the f32 "
            "matvec's backward error placed them in the operator's "
            "eps_f32-pseudospectrum: re-solve with an f64 operator",
            PseudospectrumWarning, stacklevel=4)
    elif single and not (nonnorm != nonnorm) and nonnorm > 1e-6:
        warnings.warn(
            "operator is non-normal (probe "
            f"{nonnorm:.2e}) and was solved in single precision: "
            "residual-converged Ritz values may lie up to ~eta*||A|| "
            "OUTSIDE the spectrum (eps_f32-pseudospectrum; max f64 "
            f"relative residual {float(np.max(rel)):.3e}).  Interpret "
            "f32 results as pseudospectral or re-solve with an f64 "
            "operator", PseudospectrumWarning, stacklevel=4)
    return rep


def _finish(op, cfg, res, return_eigenvectors, return_stats, validate,
            raw_A, raw_M=None, howmny="A", select=None):
    """Extraction, validation, the no-convergence error (none with a
    ``select`` mask) and the return tuple (reference ``api._solve``)."""
    if res.info < 0:
        raise ArpackError(res.info)
    rvec = return_eigenvectors or howmny == "P"
    out = extract(op, cfg, res, rvec=rvec or validate is not None,
                  howmny=howmny, select=select)
    if validate is not None:
        out.validation = (
            _f64_validate(None, None, out, cfg, matvec64=validate)
            if callable(validate) else _f64_validate(raw_A, raw_M, out, cfg))
        if not rvec:
            out.vectors = None
    if res.info in (1, 2) and select is None and out.nconv < cfg.nev:
        raise ArpackNoConvergence(out, cfg)
    ret = (out.values, out.vectors) if rvec else out.values
    if return_stats:
        return ret + (out,) if rvec else (ret, out)
    return ret


def _refuse_mesh(mesh) -> None:
    """``mesh=`` (the row-partitioned solve) is outside the slice."""
    if mesh is not None:
        raise NotImplementedError("mesh= is not ported yet")


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
    """Symmetric / Hermitian eigensolver (dsaupd/dseupd equivalent).

    Modes (reference iparam(7), SRC/dsaupd.f:30-48), built from dense or
    scipy sparse ``A`` and ``M`` by
    :func:`~arpack_ng_tpu_torch.ops.transforms.build_sym_operator` (the
    shifted matrix factored on the host, its inverse applied on the
    device as one product):

    * ``sigma is None, M is None``   -> mode 1 (regular)
    * ``sigma is None, M given``     -> mode 2 (regular inverse: inv(M)*A)
    * ``sigma, mode='normal'``       -> mode 3 (shift-invert)
    * ``sigma, mode='buckling'``     -> mode 4
    * ``sigma, mode='cayley'``       -> mode 5

    A matrix-free transform is an operator of
    :func:`~arpack_ng_tpu_torch.ops.transforms.shift_invert_operator`.

    ``A``: an :class:`Operator` (its device is the solve's device), a
    dense symmetric (Hermitian) matrix or a scipy sparse matrix (imported
    by :func:`~arpack_ng_tpu_torch.ops.sparse.from_scipy`), moved to
    ``device`` (default: the CUDA card; ``device="cpu"`` for the CPU).
    ``strategy='auto'`` or ``'fused'`` runs the symmetric cycle of
    :mod:`~arpack_ng_tpu_torch.core.device_sym`; ``'hybrid'`` the host
    float64 reduced space of :mod:`~arpack_ng_tpu_torch.core.iram`.
    Values are real, also for a complex Hermitian problem.
    ``validate='f64'`` (a concrete matrix ``A``) or a float64 matvec
    callable attaches an :class:`F64Validation` report (``return_stats``);
    with ``M`` it checks ``A v - lambda M v``.

    ``restart='thick'`` (the fused driver only, not with ``which='BE'``):
    the re-tridiagonalizing thick restart of
    :func:`~arpack_ng_tpu_torch.core.device_sym.thick_restart` in place of
    the implicit shifts.  ``shift_fn(ritz_unwanted, bounds_unwanted) ->
    shifts``: the caller's shifts (the reference's ishift=0 / ido=3
    protocol, SRC/dsaup2.f:700-724), with no nev inflation, through either
    driver; not with ``restart='thick'``.  ``select``: a length-ncv
    boolean mask over the Ritz values of the final factorization in their
    exit order (the documented ``howmny='S'`` of SRC/dseupd.f:62-66): only
    flagged values that converged come back, with their vectors, and no
    :class:`ArpackNoConvergence` is raised.  The fused driver runs thick
    and ``shift_fn`` solves on its host restart loop.

    Returns ``values`` or ``(values, vectors)`` (and the
    :class:`EigenResult` with ``return_stats``), as the reference package
    does.
    """
    _refuse_mesh(mesh)
    if strategy not in ("auto", "fused", "hybrid"):
        raise ValueError(f"strategy must be 'auto', 'fused' or 'hybrid', "
                         f"not {strategy!r}")
    if shift_fn is not None and restart == "thick":
        raise ValueError("shift_fn requires restart='implicit' "
                         "(a thick restart applies no shifts)")
    if restart != "implicit" and strategy == "hybrid":
        raise ValueError("strategy='hybrid' runs the implicit restart "
                         "only; restart='thick' needs the fused driver")
    raw_A = None if isinstance(A, Operator) else A
    _check_validate(validate, raw_A, M)
    if sigma is not None or mode != "normal" or M is not None:
        from .ops import transforms
        A = transforms.build_sym_operator(
            A, M=M, sigma=sigma, mode=mode, dtype=dtype,
            device=DEFAULT if device is None else device)
    op = _as_operator(A, dtype=dtype, hermitian=True, device=device)
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
        exact_shifts=shift_fn is None, storage_dtype=storage_dtype,
        cgs_kernel=cgs_kernel, restart=restart, reorth=reorth)
    res = _make_solver(op, cfg, strategy, shift_fn).solve(v0=v0)
    return _finish(op, cfg, res, return_eigenvectors, return_stats,
                   validate, raw_A, M, howmny="S" if select is not None
                   else "A", select=select)


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
    """Non-symmetric eigensolver (dnaupd/dneupd and znaupd/zneupd
    equivalents).  ``M`` (mode 2) and ``sigma`` (mode 3: shift-invert;
    for a real problem with a complex shift the real part of the complex
    inverse, its values recovered as Rayleigh quotients, dndrv5) build the
    transformed operator from dense or scipy sparse input by
    :func:`~arpack_ng_tpu_torch.ops.transforms.build_nonsym_operator`.

    ``A``: an :class:`Operator`, a dense matrix or a scipy sparse matrix
    (imported by :func:`~arpack_ng_tpu_torch.ops.sparse.from_scipy` with
    ``hermitian=False``), moved to ``device`` (default: the CUDA card).
    ``strategy='auto'`` is the reference's default: ``'fused_real'`` for
    real dtypes (the restart cycle of
    :mod:`~arpack_ng_tpu_torch.core.device_realnonsym` with its reduced
    space in the problem dtype) and ``'hybrid'`` for complex ones (the host
    float64 / complex128 reduced space of
    :mod:`~arpack_ng_tpu_torch.core.iram`, which real dtypes may ask for
    too).  ``'fused'`` runs the complex cycle of
    :mod:`~arpack_ng_tpu_torch.core.device_nonsym` (its reduced space in
    the problem's complex dtype); a real operator is complexified (two real
    matvecs per complex one) and its values and vectors come back complex,
    as the reference returns them.  ``'fused_real'`` on a complex dtype
    raises ``ValueError``.
    ``reorth='auto'`` is ``'dgks'``: the semi-orthogonality argument behind
    ``'selective'`` is a Lanczos result.  Values come wanted first; for a
    real problem a conjugate pair is never split, so k + 1 values may come
    back.  ``return_schur`` returns the Schur vectors of the wanted
    invariant subspace in place of the eigenvectors.  ``validate='f64'``
    or a float64 matvec callable attaches an :class:`F64Validation` report
    and warns (:class:`PseudospectrumWarning`) where a single-precision
    solve met a non-normal operator.  ``select``: as in :func:`eigsh`
    (SRC/dneupd.f:60-66); in real arithmetic a selected member of a
    conjugate pair brings its partner.  ``return_schur`` takes precedence.

    Not ported yet (``NotImplementedError``): ``mesh``.  ``validate`` under
    ``return_schur`` raises ``ValueError``, where the reference skips it
    without a word.
    """
    _refuse_mesh(mesh)
    if strategy not in ("auto", "fused_real", "hybrid", "fused"):
        raise ValueError(f"strategy must be 'auto', 'fused', 'fused_real' "
                         f"or 'hybrid', not {strategy!r}")
    if validate is not None and return_schur:
        raise ValueError("validate= checks eigenpairs; return_schur=True "
                         "returns Schur vectors, which it cannot check")
    raw_A = None if isinstance(A, Operator) else A
    _check_validate(validate, raw_A, M)
    if sigma is not None or M is not None:
        from .ops import transforms
        A = transforms.build_nonsym_operator(
            A, M=M, sigma=sigma, dtype=dtype,
            device=DEFAULT if device is None else device)
    op = _as_operator(A, dtype=dtype, hermitian=False, device=device)
    cplx = np.issubdtype(op.dtype, np.complexfloating)
    if strategy == "auto":
        # complex dtypes keep the reference-faithful hybrid by default
        strategy = "hybrid" if cplx else "fused_real"
    if strategy == "fused_real" and cplx:
        raise ValueError("strategy='fused_real' is for real problems; use "
                         "strategy='fused' for complex dtypes")
    n = op.n
    ncv = ncv if ncv is not None else default_ncv(n, k, symmetric=False)
    cfg = IRAMConfig(
        n=n, nev=k, ncv=min(ncv, n), which=which, bmat=op.bmat,
        mode=op.mode, tol=tol,
        max_iter=maxiter if maxiter is not None else 10 * n,
        symmetric=False, dtype=np.dtype(op.dtype), n_pad=op.n_pad, seed=seed,
        cgs_kernel=cgs_kernel, reorth="dgks" if reorth == "auto" else reorth)
    if strategy == "fused":
        from .core.device_nonsym import (FusedNonsymSolver,
                                         complexify_operator)
        op = complexify_operator(op)
        # every config field kept (cgs_kernel too, which the extension then
        # vets for the complex dtype)
        cfg = dataclasses.replace(cfg, dtype=np.dtype(op.dtype))
        solver = FusedNonsymSolver(op, cfg)
    elif strategy == "hybrid":
        solver = IRAMSolver(op, cfg)
    else:
        from .core.device_realnonsym import FusedRealNonsymSolver
        solver = FusedRealNonsymSolver(op, cfg)
    res = solver.solve(v0=v0)
    howmny = "P" if return_schur else ("S" if select is not None else "A")
    return _finish(op, cfg, res, return_eigenvectors, return_stats,
                   validate, raw_A, M, howmny=howmny, select=select)
