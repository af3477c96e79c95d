"""Host-side reduced-space (NCV-sized) kernels; port of
``arpack_ng_tpu/core/reduced.py``.

The reference keeps every NCV-sized quantity replicated and computes on
it redundantly (SRC/dsaupd.f:331-348).  This package keeps the split: O(n)
work on the device, the tiny dense subproblem here in numpy.

* :func:`sym_eigt`       — dseigt + dstqrb (tridiagonal eig + bounds)
* :func:`nonsym_eigt`    — dneigh (Hessenberg eig + bounds)
* :func:`sym_gets`       — dsgets (wanted/unwanted split + exact shifts)
* :func:`nonsym_gets`    — dngets (with conjugate-pair keeping)
* :func:`conv_mask`      — dsconv / dnconv (eps^(2/3)-floored test)
* :func:`sym_shift_q`    — dsapps (implicit-shift QR, accumulated Q)
* :func:`nonsym_shift_q` — dnapps (single real shifts, double shifts for
  conjugate pairs)
* :func:`exit_sort`      — the exit ordering of dsaup2.f:524-667
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.linalg as sla

from .. import native as _native


def sort_key(which: str, vals: np.ndarray, real_pairs: bool) -> np.ndarray:
    """Ascending-sort key putting the *wanted* end LAST (dsortr/dsortc,
    SRC/dsgets.f:180-186)."""
    w = which.upper()
    if w == "LM":
        return np.abs(vals)
    if w == "SM":
        return -np.abs(vals)
    if w == "LA" or w == "LR":
        return vals.real
    if w == "SA" or w == "SR":
        return -vals.real
    if w == "LI":
        return np.abs(vals.imag) if real_pairs else vals.imag
    if w == "SI":
        return -np.abs(vals.imag) if real_pairs else -vals.imag
    raise ValueError(f"bad which={which!r}")


def _stable_order(key: np.ndarray) -> np.ndarray:
    return np.argsort(key, kind="stable")


def sortc_order(which: str, vals: np.ndarray, real_pairs: bool) -> np.ndarray:
    """Permutation of dngets' two-stage sort that keeps conjugate pairs
    adjacent (SRC/dngets.f:147-170): a stable lexsort with the pair key
    secondary, the member with +imag first (dsortc's swap convention)."""
    primary = sort_key(which, vals, real_pairs)
    if real_pairs:
        return np.lexsort((-vals.imag, primary))
    return _stable_order(primary)


def sym_eigt(alpha: np.ndarray, beta: np.ndarray, rnorm: float,
             need_vectors: bool = True
             ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Eigenvalues of the tridiagonal T and Ritz-estimate bounds
    ``rnorm * |last eigenvector component|`` (SRC/dseigt.f:155).

    Returns (ritz ascending, bounds, S or None when need_vectors=False).
    """
    k = alpha.shape[0]
    if k == 1:
        return alpha.copy(), np.array([abs(rnorm)]), np.ones((1, 1))
    if _native.available():
        # the native QL can hit its sweep cap on pathological
        # tridiagonals; LAPACK's solver below handles those
        try:
            if need_vectors:
                ritz, S = _native.steqr(np.asarray(alpha, np.float64),
                                        np.asarray(beta, np.float64))
                return ritz, np.abs(rnorm * S[-1, :]), S
            ritz, bounds = _native.stqrb(np.asarray(alpha, np.float64),
                                         np.asarray(beta, np.float64),
                                         rnorm)
            return ritz, bounds, None
        except RuntimeError:
            pass
    ritz, S = sla.eigh_tridiagonal(alpha, beta[: k - 1])
    bounds = np.abs(rnorm * S[-1, :])
    return ritz, bounds, (S if need_vectors else None)


def nonsym_eigt(H: np.ndarray, rnorm: float
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Eigenvalues of the Hessenberg H and Ritz-estimate bounds
    ``rnorm * |last component of the unit eigenvector|`` (dneigh,
    SRC/dneigh.f:194-213); LAPACK geev normalizes the eigenvectors.

    Returns (ritz complex, bounds real, Y eigenvector matrix complex).
    """
    ritz, Y = sla.eig(H)
    bounds = np.abs(rnorm) * np.abs(Y[-1, :])
    return ritz, bounds, Y


def sym_gets(which: str, kev: int, np_: int, ritz: np.ndarray,
             bounds: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """dsgets: order (ritz, bounds) so the kev wanted values are LAST; the
    first np_ entries are the exact shifts, largest bounds first
    (SRC/dsgets.f:186-197).

    Returns (ritz_sorted, bounds_sorted, shifts).
    """
    k = kev + np_
    if ritz.shape[0] != k:
        raise ValueError(f"expected {k} Ritz values, got {ritz.shape[0]}")
    if which == "BE":
        order = np.argsort(ritz, kind="stable")
        r, b = ritz[order], bounds[order]
        # wanted: kev//2 from the low end, kev-kev//2 from the high end
        # (dsgets.f:166-171); the unwanted middle block becomes the shifts
        kevd2 = kev // 2
        lo = np.arange(0, kevd2)
        hi = np.arange(k - (kev - kevd2), k)
        mid = np.arange(kevd2, k - (kev - kevd2))
        perm = np.concatenate([mid, lo, hi])
        r, b = r[perm], b[perm]
    else:
        order = _stable_order(sort_key(which, ritz, real_pairs=False))
        r, b = ritz[order], bounds[order]
    shifts = r[:np_].copy()
    if np_ > 0:
        so = np.argsort(-np.abs(b[:np_]), kind="stable")
        shifts = shifts[so]
    return r, b, shifts


def nonsym_gets(which: str, kev: int, np_: int, ritz: np.ndarray,
                bounds: np.ndarray, real_pairs: bool
                ) -> Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]:
    """dngets: sort so the wanted values are last; for real problems keep
    conjugate pairs together, growing kev by one where the boundary would
    split a pair (SRC/dngets.f:165-176).  The shifts come largest bound
    first (SRC/dngets.f:180-187).

    Returns (kev, np_, ritz_sorted, bounds_sorted, shifts).
    """
    k = kev + np_
    order = sortc_order(which, ritz, real_pairs)
    r, b = ritz[order], bounds[order]
    if real_pairs and 0 < np_ < k:
        if (r[np_ - 1] == np.conj(r[np_])) and r[np_ - 1].imag != 0:
            np_ -= 1
            kev += 1
    shifts = r[:np_].copy()
    if np_ > 0:
        so = np.argsort(-b[:np_].real, kind="stable")
        shifts = shifts[so]
    return kev, np_, r, b, shifts


def conv_mask(ritz: np.ndarray, bounds: np.ndarray, tol: float,
              eps23: float) -> np.ndarray:
    """``bounds_i <= tol * max(eps23, |ritz_i|)`` (SRC/dsconv.f:123)."""
    return bounds <= tol * np.maximum(eps23, np.abs(ritz))


def conv_count(ritz, bounds, tol, eps23) -> int:
    return int(np.count_nonzero(conv_mask(ritz, bounds, tol, eps23)))


def _deflate_sym(alpha: np.ndarray, beta: np.ndarray, eps_m: float) -> None:
    """Zero negligible subdiagonals (SRC/dsapps.f:430-443)."""
    big = np.abs(alpha[:-1]) + np.abs(alpha[1:])
    beta[np.abs(beta) <= eps_m * big] = 0.0


def sym_shift_q(alpha: np.ndarray, beta: np.ndarray, shifts: np.ndarray,
                eps_m: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Apply the np exact shifts to the tridiagonal T, accumulating Q
    (dsapps as explicit QR steps, then the deflation sweep and the
    subdiagonal sign normalization, SRC/dsapps.f:396-443).

    Returns (alpha', beta', Q) with beta' >= 0.
    """
    k = alpha.shape[0]
    if _native.available():
        return _native.sym_shift_q(np.asarray(alpha, np.float64),
                                   np.asarray(beta, np.float64),
                                   np.asarray(shifts, np.float64))
    T = np.diag(alpha.astype(np.float64))
    if k > 1:
        T += np.diag(beta[: k - 1].astype(np.float64), 1)
        T += np.diag(beta[: k - 1].astype(np.float64), -1)
    Q = np.eye(k)
    eye = np.eye(k)
    for mu in np.asarray(shifts, np.float64):
        q, _ = np.linalg.qr(T - mu * eye)
        T = q.T @ T @ q
        d = np.diag(T).copy()
        e = 0.5 * (np.diag(T, -1) + np.diag(T, 1))
        T = np.diag(d)
        if k > 1:
            T += np.diag(e, 1) + np.diag(e, -1)
        Q = Q @ q
    d = np.diag(T).copy()
    e = np.diag(T, -1).copy() if k > 1 else np.zeros(0)
    if k > 1:
        _deflate_sym(d, e, eps_m)
    phi = np.ones(k)
    for i in range(k - 1):
        s = 1.0 if e[i] >= 0 else -1.0
        phi[i + 1] = phi[i] * s
        e[i] = abs(e[i])
    Q = Q * phi[None, :]
    beta_out = np.zeros_like(beta, dtype=np.float64)
    beta_out[: k - 1] = e
    return d, beta_out, Q


def _deflate_hess(H: np.ndarray, eps_m: float, smlnum: float) -> None:
    """dnapps deflation: ``|h(i+1,i)| <= max(ulp*(|h(i,i)|+|h(i+1,i+1)|),
    smlnum)`` -> zero (SRC/dnapps.f:328-336)."""
    k = H.shape[0]
    for i in range(k - 1):
        tst1 = abs(H[i, i]) + abs(H[i + 1, i + 1])
        if tst1 == 0.0:
            tst1 = np.abs(np.diag(H)).sum()
        if abs(H[i + 1, i]) <= max(eps_m * tst1, smlnum):
            H[i + 1, i] = 0.0


def _truncate_hessenberg(H: np.ndarray) -> np.ndarray:
    return np.triu(H, -1)


def nonsym_shift_q(H: np.ndarray, shifts: np.ndarray, eps_m: float,
                   smlnum: float, real_arith: bool
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Apply the shifts to the Hessenberg H, accumulating the orthogonal
    (unitary) Q, each as an explicit QR of the shifted matrix (dnapps /
    znapps as explicit steps):

    * real shift mu:            QR(H - mu I)
    * conjugate pair (mu,~mu):  QR(H^2 - 2 Re(mu) H + |mu|^2 I)  [real Q]
    * complex shift (complex arithmetic): QR(H - mu I)           [unitary Q]

    Returns (H', Q).
    """
    k = H.shape[0]
    work_dtype = np.complex128 if np.iscomplexobj(H) else np.float64
    Hc = H.astype(work_dtype)
    Q = np.eye(k, dtype=work_dtype)
    eye = np.eye(k, dtype=work_dtype)

    shifts = np.asarray(shifts)
    used = np.zeros(len(shifts), dtype=bool)
    for i, mu in enumerate(shifts):
        if used[i]:
            continue
        used[i] = True
        if real_arith and mu.imag != 0.0:
            # consume the conjugate partner (dngets keeps pairs in the
            # shift set, SRC/dngets.f:165-176)
            for jj in range(i + 1, len(shifts)):
                if not used[jj] and np.isclose(shifts[jj], np.conj(mu)):
                    used[jj] = True
                    break
            M = Hc @ Hc - 2.0 * mu.real * Hc + (abs(mu) ** 2) * eye
            q, _ = np.linalg.qr(M.real.astype(np.float64))
            q = q.astype(work_dtype)
        else:
            mu_use = mu.real if (real_arith and not np.iscomplexobj(Hc)) \
                else mu
            q, _ = np.linalg.qr(Hc - mu_use * eye)
        Hc = q.conj().T @ Hc @ q
        Hc = _truncate_hessenberg(Hc)
        _deflate_hess(Hc, eps_m, smlnum)
        Q = Q @ q
    return Hc, Q


def exit_sort(which: str, nev0: int, nconv: int, ritz: np.ndarray,
              bounds: np.ndarray, eps23: float, symmetric: bool,
              real_pairs: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Exit ordering of the restart loop: wanted first, converged pushed
    forward by the scaled-bound sort, then the converged set ordered by
    ``which`` (SRC/dsaup2.f:536-638)."""
    k = ritz.shape[0]
    if symmetric and which == "BE":
        order = np.argsort(-ritz, kind="stable")
        r, b = ritz[order], bounds[order]
        nevd2 = nev0 // 2
        nevm2 = nev0 - nevd2
        np_ = k - nev0
        m = min(nevd2, np_)
        if nev0 > 1 and m > 0:
            lo_idx = np.arange(nevm2, nevm2 + m)
            hi_start = max(k - nevd2, k - np_)
            hi_idx = np.arange(hi_start, hi_start + m)
            r[lo_idx], r[hi_idx] = r[hi_idx].copy(), r[lo_idx].copy()
            b[lo_idx], b[hi_idx] = b[hi_idx].copy(), b[lo_idx].copy()
    else:
        key = sort_key(which, ritz, real_pairs)
        order = _stable_order(-key) if not real_pairs else \
            np.lexsort((-ritz.imag, -key))
        r, b = ritz[order], bounds[order]
    nev0 = min(nev0, k)
    scale = np.maximum(eps23, np.abs(r[:nev0]))
    so = np.argsort(b[:nev0] / scale, kind="stable")
    r[:nev0], b[:nev0] = r[:nev0][so], b[:nev0][so]
    if nconv > 0:
        if symmetric and which == "BE":
            so2 = np.argsort(r[:nconv], kind="stable")
        else:
            so2 = _stable_order(sort_key(which, r[:nconv], real_pairs))
        r[:nconv], b[:nconv] = r[:nconv][so2], b[:nconv][so2]
    return r, b
