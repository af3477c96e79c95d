"""Eigenpair extraction: the dseupd / dneupd / zneupd equivalent (port of
``arpack_ng_tpu/core/extract.py`` for modes 1-2).

* re-derive the reduced eigensystem from the final H on the host in
  float64, complex128 for complex dtypes (the tridiagonal solve, real for
  a Hermitian problem, or LAPACK geev of the Hessenberg) and re-apply the
  eps^(2/3)
  convergence test (dseupd re-solves at :536; a count mismatch with the
  iteration phase is reference info = -14);
* select the converged wanted subset per ``which``; for real
  non-symmetric problems a conjugate pair is never split at the boundary,
  so nev+1 values may come back (dneupd);
* form Ritz vectors on the basis' device with one GEMM: ``S^T V`` (complex
  for a complex basis), or for complex Ritz vectors of a real basis the
  stacked ``[Re; Im]`` GEMM; or, with ``howmny='P'``, the Schur vectors of
  the wanted invariant subspace (a sorted real or complex Schur form from
  ``scipy.linalg.schur`` on the host);
* output order: ascending (symmetric; Hermitian values are real, their
  vectors complex), wanted first (non-symmetric);
* ``howmny='S'``: values and vectors only for the flagged Ritz values of
  a ``select`` mask that converged (see :func:`_select`);
* untransform mode 1 and 2 (the identity).  The spectral-transform modes
  3-5 and purification are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.linalg as sla
import torch

from ..config import IRAMConfig
from ..ops.operator import Operator
from ..utils import dtypes as _dt
from . import reduced
from .iram import IRAMResult


@dataclasses.dataclass
class EigenResult:
    """User-facing solve output (dseupd outputs d, z + iparam info)."""

    values: np.ndarray             # (nconv,) eigenvalues, ascending
    vectors: Optional[np.ndarray]  # (n, nconv) or None if rvec=False
    nconv: int
    info: int
    bounds: np.ndarray             # Ritz estimates
    n_iter: int
    stats: object
    validation: object = None      # the F64Validation report of
    #   ``validate=``, attached by the API


def extract(op: Operator, cfg: IRAMConfig, result: IRAMResult,
            rvec: bool = True, howmny: str = "A",
            select: Optional[np.ndarray] = None) -> EigenResult:
    if op.mode not in (1, 2):
        raise NotImplementedError(f"mode {op.mode} (spectral transforms) is "
                                  "not ported yet")
    if howmny not in ("A", "P", "S"):
        raise ValueError(f"howmny must be 'A', 'P' or 'S', not {howmny!r}")
    sym = cfg.symmetric
    is_cplx = _dt.is_complex(cfg.dtype)
    host_dtype = _dt.host_dtype(cfg.dtype)
    state = result.state
    tol, eps23 = cfg.tol_effective, cfg.eps23
    rnorm = float(state.rnorm)
    info = result.info if result.info in (1, 2) else 0

    H = np.asarray(state.H).astype(host_dtype)
    if sym and cfg.restart == "thick":
        # the projected matrix from the upper triangle: the dgks extension
        # writes whole projection columns there after a thick restart (the
        # subdiagonal holds the recurrence's beta writes)
        T = np.triu(H.real) + np.triu(H.real, 1).T
        theta_all, S = np.linalg.eigh(T)
        bounds_all = np.abs(rnorm * S[-1, :])
    elif sym:
        alpha = np.diag(H).real.copy()
        beta = np.diag(H, -1).real.copy()
        theta_all, bounds_all, S = reduced.sym_eigt(alpha, beta, rnorm)
    else:
        theta_all, bounds_all, S = reduced.nonsym_eigt(H, rnorm)

    # ---- converged subset (dseupd re-test; mismatch -> info=-14) ----
    idx_conv = np.where(reduced.conv_mask(theta_all, bounds_all, tol,
                                          eps23))[0]
    nconv = result.nconv
    if len(idx_conv) < nconv:
        info = -14
        nconv = len(idx_conv)
    if nconv == 0:
        return EigenResult(values=np.zeros(0, host_dtype), vectors=None,
                           nconv=0,
                           info=info, bounds=np.zeros(0),
                           n_iter=result.n_iter, stats=result.stats)

    real_pairs = (not sym) and (not is_cplx)
    if howmny == "S":
        sel = _select(select, result.ritz, theta_all, idx_conv, eps23,
                      real_pairs)
        nconv = len(sel)
        if nconv == 0:
            return EigenResult(values=np.zeros(0, host_dtype), vectors=None,
                               nconv=0, info=info, bounds=np.zeros(0),
                               n_iter=result.n_iter, stats=result.stats)
    elif sym and cfg.which == "BE":
        # nconv//2 from the low end, the rest from the high end
        # (dsgets.f:166-171)
        order = np.argsort(theta_all[idx_conv], kind="stable")
        half_lo = nconv // 2
        half_hi = nconv - half_lo
        pick = np.concatenate([order[:half_lo],
                               order[len(order) - half_hi:]])
    else:
        key = reduced.sort_key(cfg.which, theta_all[idx_conv], real_pairs)
        pick = np.argsort(key, kind="stable")[len(idx_conv) - nconv:]
    if howmny != "S":
        sel = idx_conv[np.sort(pick)]
        if real_pairs:
            # dneupd may return nev+1 values rather than split a conjugate
            # pair at the selection boundary (scipy allocates k+1 slots)
            selset = set(sel.tolist())
            for i in sel:
                ti = theta_all[i]
                if ti.imag == 0:
                    continue
                partner = np.where(
                    np.isclose(theta_all[idx_conv], np.conj(ti)))[0]
                if len(partner) and idx_conv[partner[0]] not in selset:
                    sel = np.sort(np.append(sel, idx_conv[partner[0]]))
                    nconv += 1
                    break

    lam = theta_all[sel].copy()
    lam_bounds = bounds_all[sel].copy()
    # output order: ascending for symmetric problems (dseupd's final dsortr
    # 'LA', :697-707), wanted first for non-symmetric ones (dneupd)
    if sym:
        order_out = np.argsort(lam, kind="stable")
    else:
        order_out = np.argsort(
            -reduced.sort_key(cfg.which, lam, real_pairs), kind="stable")
    lam, lam_bounds, sel = lam[order_out], lam_bounds[order_out], \
        sel[order_out]

    vectors = None
    if rvec:
        if howmny == "P" and not sym:
            # Schur basis of the wanted invariant subspace (dneupd
            # howmny='P'): reorder the real Schur form of H so the selected
            # values lead and take the first nconv Schur vectors
            wanted_vals = theta_all[sel]

            def _sort(w_r, w_i=None):
                w = complex(w_r) if w_i is None else complex(w_r) \
                    + 1j * complex(w_i)
                return bool(np.min(np.abs(wanted_vals - w))
                            < 1e-8 * max(1.0, abs(w)))

            _, QQ, _ = sla.schur(H, output="complex" if is_cplx else "real",
                                 sort=_sort)
            Scols = QQ[:, :nconv]
        else:
            Scols = S[:, sel]
            if not sym:
                # unit 2-norm Ritz vectors in the small system (the basis
                # is orthonormal, so Z inherits it; dneupd via dtrevc)
                Scols = Scols / np.linalg.norm(Scols, axis=0, keepdims=True)
        Z = _basis_product(Scols, state.V, cfg.dtype)
        vectors = Z[:, : cfg.n].T  # (n, nconv)
        if op.perm is not None:
            # internal row i holds logical coordinate perm[i]
            unperm = np.empty_like(vectors)
            unperm[np.asarray(op.perm)] = vectors
            vectors = unperm

    return EigenResult(values=lam, vectors=vectors, nconv=nconv, info=info,
                       bounds=lam_bounds, n_iter=result.n_iter,
                       stats=result.stats)


def _select(select, ritz_iter, theta_all, idx_conv, eps23, real_pairs
            ) -> np.ndarray:
    """The re-solved spectrum's indices for ``howmny='S'`` (the documented
    SELECT semantics of SRC/dseupd.f:62-66 and dneupd.f:60-66, which the
    Fortran library leaves unimplemented): ``select[j]`` flags the j-th
    Ritz value of the final factorization in the exit order
    (``ritz_iter``).  Each flagged value maps to the nearest converged
    value of ``theta_all`` within ``max(sqrt(eps23), 1e-8)`` relative, each
    taken once; flags on unconverged values are dropped.  In real
    arithmetic a selected member of a conjugate pair brings its partner
    (real storage holds both halves).  Returns the sorted indices."""
    if select is None:
        raise ValueError("howmny='S' requires a select mask")
    select_m = np.asarray(select, bool).ravel()
    ritz_iter = np.asarray(ritz_iter)
    if select_m.shape[0] != len(ritz_iter):
        raise ValueError(
            f"select must have length ncv={len(ritz_iter)} "
            "(one flag per Ritz value of the final factorization)")
    gate = max(np.sqrt(eps23), 1e-8)
    avail = list(idx_conv)
    sel_list = []
    for w in ritz_iter[select_m]:
        if not avail:
            break
        j = min(avail, key=lambda t: abs(theta_all[t] - w))
        if abs(theta_all[j] - w) <= gate * max(1.0, abs(w)):
            sel_list.append(j)
            avail.remove(j)
    if real_pairs:
        for j in list(sel_list):
            tj = theta_all[j]
            if tj.imag == 0:
                continue
            have = any(np.isclose(theta_all[p], np.conj(tj))
                       for p in sel_list if p != j)
            if not have:
                cand = [p for p in avail
                        if np.isclose(theta_all[p], np.conj(tj))]
                if cand:
                    sel_list.append(cand[0])
                    avail.remove(cand[0])
    return np.sort(np.array(sel_list, dtype=int))


def _basis_product(Scols: np.ndarray, V: torch.Tensor, dtype) -> np.ndarray:
    """``Scols^T V`` on the basis' device, one GEMM in the compute dtype,
    returned on the host as ``(m, n_pad)``: float64; complex128 for a
    complex basis (a complex GEMM) or for complex ``Scols`` of a real basis
    (the real GEMM of the stacked ``[Re; Im]`` coefficients, dneupd's packed
    pair storage)."""
    tdt = _dt.torch_dtype(dtype)
    m = Scols.shape[1]
    if _dt.is_complex(dtype):
        s_dev = torch.from_numpy(np.ascontiguousarray(
            Scols.T.astype(dtype))).to(V.device)
        return (s_dev @ V).cpu().numpy().astype(np.complex128)
    cplx = np.iscomplexobj(Scols)
    coef = np.concatenate([Scols.real.T, Scols.imag.T]) if cplx else Scols.T
    s_dev = torch.from_numpy(np.ascontiguousarray(coef.astype(dtype))).to(
        V.device)
    z = (s_dev @ V.to(tdt)).cpu().numpy().astype(np.float64)
    return z[:m] + 1j * z[m:] if cplx else z
