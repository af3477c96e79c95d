"""The reduced space of one real non-symmetric restart cycle: dneigh (the
real Schur form, the block eigenvalues and dtrevc's Ritz bounds), dngets
(the which-sort with conjugate pairs adjacent and the straddle rule),
dnconv, the zero-bound removal, nev inflation and dnapps' shifts with
accumulated Q, for the ``ncv x ncv`` Hessenberg of the dgks Arnoldi loop
(the ops the reference package runs on its device,
``arpack_ng_tpu/core/device_realnonsym.py:115, 172, 201, 377-503``;
kernel in ``csrc/realnonsym_cycle.cu``, one launch of one block per
cycle).

:func:`realnonsym_cycle` reads the Hessenberg ``H``, the residual norm
and the extension's breakdown step, pair-rule flag and counters from
device memory and writes:

* ``Q`` ``(ncv, ncv)``: the accumulated shifts' orthogonal matrix; ``sk
  = (sigmak, betak) = (Q[ncv-1, nev_eff-1], Hc[nev_eff, nev_eff-1])``,
  what the restart rotation and residual update read;
* ``H``: the shifted Hessenberg ``Hc``, in place;
* ``packet`` (float64): what the host reads once per cycle, laid out by
  the ``P_*`` offsets below: the header of ``cuda_sym_cycle`` (exit flag,
  nconv, nev_eff, np_eff, info, breakdown word, pair-rule flag, rnorm,
  the 4 counters), whether the shifts were applied again by implicit
  bulge chases, the which-sorted Ritz values' real and imaginary parts
  and their bounds (wanted last), then ``H`` as the cycle leaves it
  (row-major), which an exit hands back as the state's.

A cycle that ends the solve (``done`` or ``is_last``) and an extension
that stopped short (``brk`` not -1) leave ``H``, ``Q`` and ``sk``
untouched.

The arithmetic runs in float64 whatever the problem dtype, and the
results are rounded to it; the thresholds (the deflation and convergence
tests, dtrevc's clamps, the chase's guard) are the problem dtype's.  The
plain twin, :func:`realnonsym_cycle_plain`, is the numpy code the host
loop ran (``np.linalg.qr`` per sweep and per shift, dtrevc's
back-substitution vectorized over the eigenvalues), in float64, on CPU
tensors; in a float64 problem it is the reference's order of operations.
The kernel's QR follows LAPACK's conventions (dlarfg's ``beta =
-sign(alpha) dlapy2(alpha, |x|)``), so Q's column signs and sigmak agree
with the twin's.  The wrapper launches the kernel for CUDA tensors of
every ``ncv`` (its workspace in shared memory up to :func:`max_shared_ncv`,
else in a global buffer the wrapper allocates) and runs the twin for CPU
tensors; ``launches`` counts the kernel launches.  A caller may pass
``clocks``, an int64 tensor of :func:`clock_size` values on H's device,
for the kernel's stamps (``clock64()``, SM cycles): the :data:`CLOCKS`
phase ends, then the cycles summed over the Schur sweeps and the chase's
shifts of the :data:`LAPS`, then the :data:`COUNTS`; the twin ignores it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import cuda_lib, reduced_space
from .cuda_sym_cycle import (P_BRK, P_CNT, P_DONE, P_FORCE,  # noqa: F401
                             P_INFO, P_NCONV, P_NEV, P_NP, P_RNORM)
from .reduced_space import SWEEPS_PER_EV, WHICH  # noqa: F401

#: packet offsets past the shared header: the implicit-chase flag, then the
#: sorted real parts, imaginary parts and bounds (ncv each), then H
P_IMPL = 12
P_HEAD = 13
#: the kernel's workspace (csrc/realnonsym_cycle.cu), in doubles: six ncv x
#: ncv matrices (H0, the working T or Hc, Q, the QR's M, its q, a product)
#: and VECTORS ncv-length vectors
MATRICES = 6
VECTORS = 18
#: the kernel's phase stamps (a cycle that exits early stamps its exit in
#: every later one), its per-sweep parts summed over the sweeps and shifts
#: (the shift choice and shifted matrix, the reflector chain, the tail of q
#: and the new T's columns behind it, the step's end), and its counts of
#: Schur sweeps and chase shifts
CLOCKS = ("entry", "schur", "trevc", "gets", "chase", "guard", "redo", "exit")
LAPS = ("shift", "qr", "tail", "post")
COUNTS = ("sweeps", "shifts")


class Params(NamedTuple):
    which: str
    nev: int
    tol: float      # tol_effective, rounded to the problem dtype
    eps23: float    # the convergence floor and the chase's guard
    eps_m: float    # machine eps of the problem dtype (the deflations)
    safmin: float   # its safe minimum (dtrevc's norm floor)


def packet_size(ncv: int) -> int:
    return P_HEAD + 3 * ncv + ncv * ncv


def clock_size(ncv: int) -> int:
    """Length of the kernel's optional stamp buffer (any ncv)."""
    return reduced_space.clock_size(CLOCKS, LAPS, COUNTS)


def work_bytes(ncv: int) -> int:
    """The kernel's whole workspace, in bytes."""
    return (MATRICES * ncv * ncv + VECTORS * ncv) * 8


def fits_shared(ncv: int) -> bool:
    """Whether the workspace fits in one block's shared memory."""
    return reduced_space.fits_shared(work_bytes, ncv)


def max_shared_ncv() -> int:
    """The largest ncv whose workspace fits in shared memory (68)."""
    return reduced_space.max_shared_ncv(work_bytes)


# ---- the host loop's numpy reduced space --------------------------------

def which_key_real(which: str, wr, wi):
    """Sort key on (wr, wi) pairs; ascending puts the WANTED values last.
    LI/SI use |wi| (dsortc's real-problem semantics); conjugate partners
    tie exactly on every key, so a stable sort keeps them adjacent, +wi
    first (block extraction emits +wi first)."""
    if which == "LM":
        return np.hypot(wr, wi)
    if which == "SM":
        return -np.hypot(wr, wi)
    if which == "LR":
        return wr
    if which == "SR":
        return -wr
    if which == "LI":
        return np.abs(wi)
    if which == "SI":
        return -np.abs(wi)
    raise ValueError(f"bad which={which!r}")


def deflate_real(T, eps):
    """Zero negligible subdiagonals (the dnapps.f:328-336 test); returns
    ``(T', keep)``, ``keep[i]`` for each subdiagonal that stays."""
    sub = np.diag(T, -1)
    d = np.diag(T)
    big = np.abs(d[:-1]) + np.abs(d[1:])
    big = np.where(big == 0, np.ones_like(big), big)
    keep = np.abs(sub) > eps * big
    sub2 = np.where(keep, sub, np.zeros_like(sub))
    return np.triu(T, 0) + np.diag(sub2, -1), keep


def block_disc(T):
    """Per subdiagonal position i: the discriminant of the (i, i+1) block,
    ``((a-d)/2)^2 + b*c``; negative <=> complex conjugate eigenvalues."""
    d0 = np.diag(T)
    b = np.diag(T, 1)
    c = np.diag(T, -1)
    half = (d0[:-1] - d0[1:]) / 2.0
    return half * half + b * c


def make_real_schur(k: int, rdt, sweeps: int, eps=None):
    """Real Schur form ``schur(H) -> (T, Q)``, ``H = Q T Q^T``, T
    quasi-upper-triangular, in the dtype ``rdt``; ``eps``: the deflation
    threshold (default ``rdt``'s machine eps).  A sweep with no active
    block changes nothing, so the loop stops at the first one."""
    rdt = np.dtype(rdt)
    eps = rdt.type(np.finfo(rdt).eps if eps is None else eps)
    eye = np.eye(k, dtype=rdt)
    idx1 = np.arange(k - 1)

    def schur(H):
        T, Q = H.astype(rdt), eye
        for _ in range(sweeps):
            T, keep = deflate_real(T, eps)
            disc = block_disc(T)
            # converged complex 2x2: outer couplings gone, disc < 0
            left0 = np.concatenate([np.ones(1, bool), ~keep[:-1]])
            right0 = np.concatenate([~keep[1:], np.ones(1, bool)])
            conv2 = keep & left0 & right0 & (disc < 0)
            active = keep & ~conv2
            if not active.any():
                break
            m = max(int(np.max(np.where(active, idx1, -1))), 0)
            a11, a12 = T[m, m], T[m, m + 1]
            a21, a22 = T[m + 1, m], T[m + 1, m + 1]
            s = a11 + a22
            p = a11 * a22 - a12 * a21
            dsc = s * s / 4.0 - p
            if dsc >= 0:
                r = np.sqrt(np.maximum(dsc, rdt.type(0)))
                mu1, mu2 = s / 2.0 + r, s / 2.0 - r
                mu = mu1 if np.abs(mu1 - a22) < np.abs(mu2 - a22) else mu2
                q, _ = np.linalg.qr(T - mu * eye)
            else:
                M = T @ T - s * T + p * eye
                q, _ = np.linalg.qr(M)
            T, Q = np.triu(q.T @ T @ q, -1), Q @ q
        T, _ = deflate_real(T, eps)
        return T, Q

    return schur


def real_block_eigs(T):
    """Eigenvalues ``(wr, wi)`` of the quasi-triangular T from its 1x1/2x2
    diagonal blocks (dlanv2's role), and the pair-start and pair-second
    masks.  Conjugate partners are exact mirrors (same block formula)."""
    sub = np.diag(T, -1)
    pstart = np.concatenate([sub != 0, np.zeros(1, bool)])
    psecond = np.concatenate([np.zeros(1, bool), sub != 0])
    d0 = np.diag(T)
    zero = np.zeros_like(d0)
    disc = np.concatenate([block_disc(T), np.zeros(1, T.dtype)])
    mean = (d0 + np.concatenate([d0[1:], d0[-1:]])) / 2.0
    r_real = np.sqrt(np.maximum(disc, 0.0))
    r_imag = np.sqrt(np.maximum(-disc, 0.0))
    wr_ps = np.where(disc < 0, mean, mean + r_real)
    wi_ps = np.where(disc < 0, r_imag, zero)
    # pair-second entries: the values of the block starting one row up
    mean_m = np.concatenate([mean[-1:], mean[:-1]])
    disc_m = np.concatenate([disc[-1:], disc[:-1]])
    rr_m = np.sqrt(np.maximum(disc_m, 0.0))
    ri_m = np.sqrt(np.maximum(-disc_m, 0.0))
    wr_sec = np.where(disc_m < 0, mean_m, mean_m - rr_m)
    wi_sec = np.where(disc_m < 0, -ri_m, zero)
    wr = np.where(pstart, wr_ps, np.where(psecond, wr_sec, d0))
    wi = np.where(pstart, wi_ps, np.where(psecond, wi_sec, zero))
    return wr, wi, pstart, psecond


def make_real_last_components(k: int, rdt, eps=None, tiny=None):
    """``last_comps(T, Q) -> (lc, wr, wi, pstart, psecond)``: |last
    component of the unit eigenvector of H| for every eigenvalue of the
    real Schur pair (T, Q), by dtrevc's quasi-triangular back-substitution
    in (re, im) pair arithmetic, in the dtype ``rdt``; ``eps`` and
    ``tiny``: its clamps' machine eps and norm floor (default ``rdt``'s).
    All k eigenvectors are solved together, one row l of T at a time from
    the bottom (the reference vmaps the per-eigenvalue scan).  Conjugate
    partners get equal values, so later stable sorts never split a
    pair."""
    rdt = np.dtype(rdt)
    R = rdt.type
    eps = R(np.finfo(rdt).eps if eps is None else eps)
    tiny = R(np.finfo(rdt).tiny if tiny is None else tiny)
    iota = np.arange(k)

    def last_comps(T, Q):
        tnorm = np.maximum(np.max(np.abs(T)), R(1))
        small = eps * tnorm
        small2 = small * small
        wr, wi, pstart, psecond = real_block_eigs(T)
        sub = np.diag(T, -1)
        # bottom-of-block flag per row l: rows (l-1, l) coupled
        bottom = np.concatenate([np.zeros(1, bool), sub != 0])
        qlast = Q[k - 1, :]
        zero = np.zeros(k, rdt)
        # per eigen-index i: block start s and end e, the +wi branch
        s = np.where(psecond, iota - 1, iota)
        is_pair = pstart[s]
        e = s + np.where(is_pair, 1, 0)
        s1 = np.minimum(s + 1, k - 1)
        lr, li = wr, np.abs(wi)
        # seeds: 1x1 -> u[s] = 1; 2x2 -> a null vector of the block
        a = T[s, s]
        b = np.where(is_pair, T[s, s1], zero)
        c = np.where(is_pair, T[s1, s], zero)
        d = T[s1, s1]
        use_b = np.abs(b) >= np.abs(c)
        seed_s_r = np.where(is_pair, np.where(use_b, b, lr - d), R(1))
        seed_s_i = np.where(is_pair & ~use_b, li, zero)
        seed_e_r = np.where(use_b, lr - a, c)
        seed_e_i = np.where(use_b, li, zero)

        ur = np.zeros((k, k), rdt)   # row i: eigenvector of eigen-index i
        ui = np.zeros((k, k), rdt)
        skip = np.zeros(k, bool)
        for l in range(k - 1, -1, -1):
            mgt = iota > l
            row = T[l, :]
            cr = np.sum(np.where(mgt, row * ur, R(0)), axis=1)
            ci = np.sum(np.where(mgt, row * ui, R(0)), axis=1)
            solve = (l < s) & ~skip
            nur, nui = ur.copy(), ui.copy()
            if bottom[l]:
                # rows (l-1, l) coupled: solve the complex 2x2 jointly
                lm1 = max(l - 1, 0)
                rowm = T[lm1, :]
                crm = np.sum(np.where(mgt, rowm * ur, R(0)), axis=1)
                cim = np.sum(np.where(mgt, rowm * ui, R(0)), axis=1)
                a11r, a11i = T[lm1, lm1] - lr, -li
                a12 = T[lm1, l]
                a21 = T[l, lm1]
                a22r, a22i = T[l, l] - lr, -li
                detr = a11r * a22r - a11i * a22i - a12 * a21
                deti = a11r * a22i + a11i * a22r
                dmag2 = detr * detr + deti * deti
                ok = dmag2 >= small2
                detr = np.where(ok, detr, small)
                deti = np.where(ok, deti, R(0))
                dmag2 = np.where(ok, dmag2, small2)
                # rhs = -(c_{l-1}, c_l); x = A^{-1} rhs
                b1r, b1i = -crm, -cim
                b2r, b2i = -cr, -ci
                x1r_n = a22r * b1r - a22i * b1i - a12 * b2r
                x1i_n = a22r * b1i + a22i * b1r - a12 * b2i
                x2r_n = a11r * b2r - a11i * b2i - a21 * b1r
                x2i_n = a11r * b2i + a11i * b2r - a21 * b1i
                nur[:, lm1] = np.where(solve, (x1r_n * detr + x1i_n * deti)
                                       / dmag2, ur[:, lm1])
                nui[:, lm1] = np.where(solve, (x1i_n * detr - x1r_n * deti)
                                       / dmag2, ui[:, lm1])
                nur[:, l] = np.where(solve, (x2r_n * detr + x2i_n * deti)
                                     / dmag2, ur[:, l])
                nui[:, l] = np.where(solve, (x2i_n * detr - x2r_n * deti)
                                     / dmag2, ui[:, l])
                solved_skip = True
            else:
                denr, deni = T[l, l] - lr, -li
                dmag2 = denr * denr + deni * deni
                ok = dmag2 >= small2
                denr = np.where(ok, denr, small)
                deni = np.where(ok, deni, R(0))
                dmag2 = np.where(ok, dmag2, small2)
                nur[:, l] = np.where(solve, (-cr * denr - ci * deni) / dmag2,
                                     ur[:, l])
                nui[:, l] = np.where(solve, (-ci * denr + cr * deni) / dmag2,
                                     ui[:, l])
                solved_skip = False
            # the other eigen-indices seed their block at its end row e, or
            # skip the row after a seeded pair or a joint solve
            at_e = ~solve & (l == e) & ~skip
            rows = np.nonzero(at_e)[0]
            nur[rows, e[rows]] = seed_e_r[rows]
            nui[rows, e[rows]] = seed_e_i[rows]
            pr_ = rows[is_pair[rows]]
            nur[pr_, s[pr_]] = seed_s_r[pr_]
            nui[pr_, s[pr_]] = seed_s_i[pr_]
            sg = rows[~is_pair[rows]]
            nur[sg, s[sg]] = seed_s_r[sg]
            skip = np.where(solve, solved_skip, at_e & is_pair)
            ur, ui = nur, nui
        unorm = np.sqrt(np.sum(ur * ur + ui * ui, axis=1))
        unorm = np.maximum(unorm, tiny)
        pr = np.sum(qlast * ur, axis=1)
        pi = np.sum(qlast * ui, axis=1)
        out = np.hypot(pr, pi) / unorm
        # symmetrize across pairs: the partner gets the pair start's value
        out = np.where(psecond, np.concatenate([out[-1:], out[:-1]]), out)
        return out, wr, wi, pstart, psecond

    return last_comps


def straddle(wr_s, wi_s, boundary: int) -> bool:
    """Whether a conjugate pair straddles index ``boundary`` (sorted order
    keeps pairs adjacent, +wi first)."""
    if not 1 <= boundary <= wr_s.shape[0] - 1:
        return False
    bm1, bb = boundary - 1, boundary
    return bool(wi_s[bm1] > 0 and wi_s[bb] < 0
                and wr_s[bm1] == wr_s[bb] and wi_s[bm1] == -wi_s[bb])


class Head(NamedTuple):
    """dneigh + dngets + dnconv + inflation of one Hessenberg matrix."""

    wr_s: np.ndarray     # (ncv,) which-sorted Ritz real parts, wanted last
    wi_s: np.ndarray     # imaginary parts
    b_s: np.ndarray      # bounds
    nconv: int
    done: bool
    nev_eff: int         # after the straddle, zero-bound removal and
    np_eff: int          #   inflation


def head_plain(H, rnorm, p: Params) -> Head:
    """dnaup2's reduced work on ``H`` (float64) from dneigh through the
    shift count (the real Schur form, the Ritz values and bounds, dngets,
    dnconv, the zero-bound shift removal, nev inflation and the pair
    re-check), in numpy, in float64."""
    ncv, nev0 = H.shape[0], p.nev
    np0 = ncv - nev0
    R = np.float64
    iota = np.arange(ncv)
    T, Qs = make_real_schur(ncv, R, SWEEPS_PER_EV * ncv, p.eps_m)(H)
    lc, wr, wi, _, _ = make_real_last_components(ncv, R, p.eps_m,
                                                 p.safmin)(T, Qs)
    bounds = rnorm * lc
    # ---- dngets: wanted last, pairs adjacent ----
    order = np.argsort(which_key_real(p.which, wr, wi), kind="stable")
    wr_s, wi_s, b_s = wr[order], wi[order], bounds[order]
    # a pair split at the nev0 cut grows kev by one (dngets.f:165-176)
    str0 = int(straddle(wr_s, wi_s, np0))
    np1, nev1 = np0 - str0, nev0 + str0
    # ---- dnconv over the wanted set ----
    conv = b_s <= R(p.tol) * np.maximum(R(p.eps23), np.hypot(wr_s, wi_s))
    nconv = int(np.sum(conv & (iota >= np1)))
    # ---- zero-bound unwanted values cannot be shifted away ----
    nz = int(np.sum((b_s == 0) & (iota < np1)))
    np_eff, nev_eff = np1 - nz, nev1 + nz
    done = nconv >= nev0 or np_eff == 0
    # ---- nev inflation (dnaup2.f:673-693) ----
    nev_inf = nev_eff + min(nconv, np_eff // 2)
    if nev_inf == 1 and ncv >= 6:
        nev_inf = ncv // 2
    elif nev_inf == 1 and ncv > 3:
        nev_inf = 2
    nev_eff = min(nev_inf, ncv - 1)
    np_eff = ncv - nev_eff
    # re-check the moved boundary for a split pair: grow kev, or, when
    # that would leave nothing to shift, take both members as shifts
    if straddle(wr_s, wi_s, np_eff):
        step = 1 if np_eff > 1 else -1
        np_eff, nev_eff = np_eff - step, nev_eff + step
    return Head(wr_s=wr_s, wi_s=wi_s, b_s=b_s, nconv=nconv, done=done,
                nev_eff=nev_eff, np_eff=np_eff)


def _shift_q(H, mur, mui):
    """Q of the explicit QR of ``H - mu I`` (real shift) or of ``H^2 -
    2 Re(mu) H + |mu|^2 I`` (conjugate pair, mui > 0)."""
    eye = np.eye(H.shape[0])
    if mui > 0:
        M = H @ H - (2.0 * mur) * H + (mur * mur + mui * mui) * eye
    else:
        M = H - mur * eye
    return np.linalg.qr(M)[0]


def _implicit_q(H, mur, mui):
    """Q of the same shift applied as dnapps applies it: an implicit bulge
    chase of Householder reflectors of order 2 (real shift) or 3
    (conjugate pair), which keeps the Hessenberg form by construction."""
    ncv = H.shape[0]
    nb = 3 if mui > 0 else 2
    if mui > 0:
        x = np.array([H[0, 0] * H[0, 0] + H[0, 1] * H[1, 0]
                      - (2.0 * mur) * H[0, 0] + (mur * mur + mui * mui),
                      H[1, 0] * (H[0, 0] + H[1, 1] - 2.0 * mur),
                      H[1, 0] * H[2, 1]])
    else:
        x = np.array([H[0, 0] - mur, H[1, 0]])
    Hc, q = H.copy(), np.eye(ncv)
    for j in range(ncv - 1):
        if j > 0:
            x = Hc[j:j + nb, j - 1].copy()
        m = x.shape[0]
        v = x.copy()
        v[0] += np.copysign(np.sqrt(np.sum(x * x)), x[0])
        vv = np.sum(v * v)
        if vv == 0:
            continue
        beta = 2.0 / vv
        Hc[j:j + m, :] -= beta * np.outer(v, v @ Hc[j:j + m, :])
        Hc[:, j:j + m] -= beta * np.outer(Hc[:, j:j + m] @ v, v)
        q[:, j:j + m] -= beta * np.outer(q[:, j:j + m] @ v, v)
    return q


def shift_pool(h: Head, nev0: int):
    """The shifts dnapps applies, in order: the np_eff least-wanted values
    (dsaup2.f:516-521), largest bound first (dngets.f:180-187); pair
    members tie on their bounds, so the stable sort keeps them adjacent,
    +wi first, and a pair's second member is applied with the first."""
    ncv = h.wr_s.shape[0]
    np0 = ncv - nev0
    active = (np.arange(ncv) < h.np_eff)[:np0]
    skey = np.where(active, -np.abs(h.b_s[:np0]), np.inf)
    sperm = np.argsort(skey, kind="stable")
    s_wr, s_wi = h.wr_s[:np0][sperm], h.wi_s[:np0][sperm]
    return [(mur, mui) for mur, mui, act in zip(s_wr, s_wi, active)
            if act and mui >= 0]


def _chase(H0, shifts, step, eps_m):
    """Apply the shifts in turn, each by ``step(H, mur, mui) -> q``: ``H <-
    triu(q^T H q, -1)`` deflated, ``Q <- Q q``."""
    H, Q = H0, np.eye(H0.shape[0])
    for mur, mui in shifts:
        q = step(H, mur, mui)
        H, _ = deflate_real(np.triu(q.T @ H @ q, -1), eps_m)
        Q = Q @ q
    return H, Q


def explicit_chase(H0, h: Head, p: Params):
    """dnapps' explicit chase on ``H0`` (float64) with the shifts of
    :func:`shift_pool`: an explicit QR per real shift, one double shift per
    conjugate pair, deflation after each.  Returns ``(Hc, Q, lost,
    limit)``: the chase's loss in the columns the restart keeps,
    ``max|(Q^T H0 Q - Hc)[:, :nev_eff]|``, and the guard's limit on it,
    ``eps23 max|H0|``: rounding leaves O(eps); above eps^(2/3), the
    convergence test's floor, it would perturb H by more than any
    tolerance the test can certify."""
    Hc, Q = _chase(H0, shift_pool(h, p.nev), _shift_q, np.float64(p.eps_m))
    k = h.nev_eff
    lost = np.max(np.abs((Q.T @ H0 @ Q)[:, :k] - Hc[:, :k]))
    return Hc, Q, lost, np.float64(p.eps23) * np.max(np.abs(H0))


def shifts_plain(H0, h: Head, p: Params):
    """dnapps on ``H0`` (float64): :func:`explicit_chase`, or, where it
    lost the Hessenberg form in the columns the restart keeps (its loss
    past the guard's limit), the shifts again by implicit bulge chases.
    Returns ``(Hc, Q, implicit)``."""
    Hc, Q, lost, limit = explicit_chase(H0, h, p)
    implicit = bool(lost > limit)
    if implicit:
        # an explicit step lost the Hessenberg form where the restart
        # keeps it (forward instability of an explicit QR with a near-zero
        # pivot before its last row, e.g. after an exact shift left a tiny
        # coupling) and the truncation broke the Arnoldi relation, as it
        # does in the reference package.  Apply the shifts as dnapps does,
        # by implicit bulge chases.
        Hc, Q = _chase(H0, shift_pool(h, p.nev), _implicit_q,
                       np.float64(p.eps_m))
    return Hc, Q, implicit


def _check(H, rnorm, brk, force, cnt, Q, sk, packet):
    reduced_space.check_buffers(
        H, rnorm, brk, force, cnt, Q, sk, packet,
        dtypes=(torch.float32, torch.float64), rnorm_dtype=H.dtype,
        min_ncv=3, packet_size=packet_size(H.shape[0] if H.dim() else 0),
        what="real reduced-space")


def realnonsym_cycle_plain(H, rnorm, brk, force, cnt, Q, sk, packet,
                           p: Params, is_last: bool) -> None:
    """Plain twin of :func:`realnonsym_cycle` on CPU tensors: the numpy code
    of the host loop (:func:`head_plain`, :func:`shifts_plain`)."""
    ncv = H.shape[0]
    pk = np.zeros(packet_size(ncv))
    pk[P_BRK], pk[P_FORCE] = int(brk), int(force)
    pk[P_RNORM] = float(rnorm)
    pk[P_CNT:P_CNT + 4] = cnt.numpy()
    if pk[P_BRK] == -1:
        H0 = H.numpy().astype(np.float64)
        h = head_plain(H0, np.float64(rnorm.numpy()[()]), p)
        pk[P_DONE], pk[P_NCONV] = h.done, h.nconv
        pk[P_NEV], pk[P_NP] = h.nev_eff, h.np_eff
        pk[P_HEAD:P_HEAD + ncv] = h.wr_s
        pk[P_HEAD + ncv:P_HEAD + 2 * ncv] = h.wi_s
        pk[P_HEAD + 2 * ncv:P_HEAD + 3 * ncv] = h.b_s
        if not (h.done or is_last):
            Hc, Qn, implicit = shifts_plain(H0, h, p)
            k = h.nev_eff
            H.copy_(torch.from_numpy(Hc))
            Q.copy_(torch.from_numpy(Qn))
            sk.copy_(torch.tensor([Qn[ncv - 1, k - 1], Hc[k, k - 1]]))
            pk[P_IMPL] = implicit
        pk[P_HEAD + 3 * ncv:] = H.numpy().astype(np.float64).ravel()
    packet.copy_(torch.from_numpy(pk))


def realnonsym_cycle(H, rnorm, brk, force, cnt, Q, sk, packet, p: Params,
                     is_last: bool, clocks=None) -> None:
    """One cycle's reduced space (see the module note); on a CUDA device
    one kernel launch on the current stream, nothing read back."""
    _check(H, rnorm, brk, force, cnt, Q, sk, packet)
    ncv = H.shape[0]
    reduced_space.check_call(H, p.which, clocks, clock_size(ncv))
    if H.device.type == "cpu":
        return realnonsym_cycle_plain(H, rnorm, brk, force, cnt, Q, sk,
                                      packet, p, is_last)
    if H.device.type != "cuda":
        raise ValueError(f"no kernel for device {H.device}")
    work = None
    if not fits_shared(ncv):
        work = torch.empty(work_bytes(ncv), dtype=torch.uint8,
                           device=H.device)
    lib = cuda_lib.load()
    err = lib.atpt_realnonsym_cycle(
        cuda_lib.dtype_code(H.dtype, H.dtype), ncv, p.nev, WHICH[p.which],
        int(is_last), SWEEPS_PER_EV * ncv, p.tol, p.eps23, p.eps_m, p.safmin,
        H.data_ptr(), rnorm.data_ptr(), brk.data_ptr(), force.data_ptr(),
        cnt.data_ptr(), Q.data_ptr(), sk.data_ptr(), packet.data_ptr(),
        None if work is None else work.data_ptr(),
        None if clocks is None else clocks.data_ptr(),
        cuda_lib.stream_handle(H.device))
    cuda_lib.check(lib, err, "realnonsym_cycle")
    realnonsym_cycle.launches += 1


realnonsym_cycle.launches = 0
