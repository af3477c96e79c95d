"""Real non-symmetric restart cycle driven from the host (port of
``arpack_ng_tpu/core/device_realnonsym.py``): the dnaupd/dnaup2 major
iteration in real arithmetic.

* Extension by the CGS + DGKS Arnoldi step of ``core/arnoldi.py`` on the
  operator's device.
* **Real Schur form** of the (ncv, ncv) Hessenberg by explicit QR sweeps
  (dlahqr's role, SRC/dneigh.f:194): the trailing active 2x2 gives either
  a real Wilkinson shift (QR of ``H - mu I``) or a conjugate pair applied
  as one double shift (QR of ``H^2 - s H + p I``); converged complex 2x2
  blocks are left alone.
* **Eigenvalues** from the 1x1/2x2 diagonal blocks (dlanv2's role),
  exact conjugates by construction.
* **Ritz bounds** = rnorm * |last component of the unit eigenvector of
  H| (dneigh.f:213): dtrevc's quasi-triangular back-substitution in
  explicit (re, im) pair arithmetic, with its smallnum clamping.
* **Shift selection** (dngets): which-keyed stable sort with conjugate
  pairs adjacent (+imag first), the kev+1 boundary adjustment when the cut
  would split a pair (dngets.f:165-176) and the re-check after nev
  inflation.
* **Shift application** (dnapps): an explicit single-shift QR per real
  shift, one double shift per conjugate pair, deflation after each step
  (dnapps.f:328-336); then the kev-row basis rotation (the kernel of
  ``csrc/rot.cu`` on the card) and the residual update.  Where the
  explicit chase loses the Hessenberg form in the columns the restart
  keeps (forward instability of an explicit QR with a near-zero pivot),
  the shifts are applied again by dnapps' implicit bulge chases; the
  reference package keeps the broken chase and loses the Arnoldi relation
  there.

The reference package runs this cycle (``make_realnonsym_cycle``) inside
one device computation in the problem dtype; here it is
``tail(head(state), is_last)``, its reduced-space steps in numpy in the
same dtype and the same order of operations, the O(n) work on the
operator's device, and the restart loop on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..config import IRAMConfig
from ..ops.operator import Operator
from ..utils import dtypes as _dt
from ..utils.debug import debug, trace
from . import reduced
from .arnoldi import (FactorizationState, make_bnorm, make_extend,
                      restart_tail)
from .iram import HostLoopSolver

#: QR sweeps of the real Schur form per Ritz value (a double shift
#: retires a whole conjugate pair, so this is generous)
_SWEEPS_PER_EV = 4


def _which_key_real(which: str, wr, wi):
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


def _deflate_real(T, eps):
    """Zero negligible subdiagonals (the dnapps.f:328-336 test); returns
    ``(T', keep)``, ``keep[i]`` for each subdiagonal that stays."""
    sub = np.diag(T, -1)
    d = np.diag(T)
    big = np.abs(d[:-1]) + np.abs(d[1:])
    big = np.where(big == 0, np.ones_like(big), big)
    keep = np.abs(sub) > eps * big
    sub2 = np.where(keep, sub, np.zeros_like(sub))
    return np.triu(T, 0) + np.diag(sub2, -1), keep


def _block_disc(T):
    """Per subdiagonal position i: the discriminant of the (i, i+1) block,
    ``((a-d)/2)^2 + b*c``; negative <=> complex conjugate eigenvalues."""
    d0 = np.diag(T)
    b = np.diag(T, 1)
    c = np.diag(T, -1)
    half = (d0[:-1] - d0[1:]) / 2.0
    return half * half + b * c


def make_real_schur(k: int, rdt, sweeps: int):
    """Real Schur form ``schur(H) -> (T, Q)``, ``H = Q T Q^T``, T
    quasi-upper-triangular.  A sweep with no active block changes
    nothing, so the loop stops at the first one."""
    rdt = np.dtype(rdt)
    eps = rdt.type(_dt.eps(rdt))
    eye = np.eye(k, dtype=rdt)
    idx1 = np.arange(k - 1)

    def schur(H):
        T, Q = H.astype(rdt), eye
        for _ in range(sweeps):
            T, keep = _deflate_real(T, eps)
            disc = _block_disc(T)
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
        T, _ = _deflate_real(T, eps)
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
    disc = np.concatenate([_block_disc(T), np.zeros(1, T.dtype)])
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


def make_real_last_components(k: int, rdt):
    """``last_comps(T, Q) -> (lc, wr, wi, pstart, psecond)``: |last
    component of the unit eigenvector of H| for every eigenvalue of the
    real Schur pair (T, Q), by dtrevc's quasi-triangular back-substitution
    in (re, im) pair arithmetic.  All k eigenvectors are solved together,
    one row l of T at a time from the bottom (the reference vmaps the
    per-eigenvalue scan).  Conjugate partners get equal values, so later
    stable sorts never split a pair."""
    rdt = np.dtype(rdt)
    R = rdt.type
    eps = R(_dt.eps(rdt))
    tiny = R(_dt.safmin(rdt))
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


class RealCycleOut(NamedTuple):
    state: FactorizationState
    done: bool
    nconv: int
    wr_s: np.ndarray      # (ncv,) which-sorted Ritz real parts, wanted last
    wi_s: np.ndarray      # (ncv,) imaginary parts
    bounds_s: np.ndarray  # (ncv,)


class RealHeadOut(NamedTuple):
    """What the restart tail needs from the first half of a cycle
    (extension, dneigh, dngets, dnconv, nev inflation)."""

    state: FactorizationState
    wr_s: np.ndarray
    wi_s: np.ndarray
    b_s: np.ndarray
    nconv: int
    done: bool
    nev_eff: int
    np_eff: int


def make_realnonsym_head(op: Operator, cfg: IRAMConfig):
    """Build ``head(state) -> RealHeadOut``: dnaup2 from the extension
    through the shift count (dnaitr, dneigh, dngets, dnconv, the
    zero-bound shift removal, nev inflation and the pair re-check)."""
    if cfg.symmetric:
        raise ValueError("use device_sym for symmetric problems")
    if _dt.is_complex(cfg.dtype):
        raise ValueError("the real cycle is for real dtypes")
    ncv, nev0 = cfg.ncv, cfg.nev
    np0 = ncv - nev0
    rdt = _dt.real_dtype(cfg.dtype)
    tol = rdt.type(cfg.tol_effective)
    eps23 = rdt.type(cfg.eps23)
    extend = make_extend(op, cfg)
    iota = np.arange(ncv)
    schur = make_real_schur(ncv, rdt, sweeps=_SWEEPS_PER_EV * ncv)
    last_comps = make_real_last_components(ncv, rdt)

    def _straddle(wr_s, wi_s, boundary) -> bool:
        """Whether a conjugate pair straddles index ``boundary`` (sorted
        order keeps pairs adjacent, +wi first)."""
        if not 1 <= boundary <= ncv - 1:
            return False
        bm1, bb = boundary - 1, boundary
        return bool(wi_s[bm1] > 0 and wi_s[bb] < 0
                    and wr_s[bm1] == wr_s[bb] and wi_s[bm1] == -wi_s[bb])

    def head(state: FactorizationState) -> RealHeadOut:
        state = extend(state, ncv)
        # ---- dneigh: real Schur, Ritz values, bounds ----
        T, Qs = schur(state.H.astype(rdt))
        lc, wr, wi, _, _ = last_comps(T, Qs)
        bounds = (state.rnorm * lc).astype(rdt)
        # ---- dngets: wanted last, pairs adjacent ----
        order = np.argsort(_which_key_real(cfg.which, wr, wi), kind="stable")
        wr_s, wi_s, b_s = wr[order], wi[order], bounds[order]
        # a pair split at the nev0 cut grows kev by one (dngets.f:165-176)
        str0 = int(_straddle(wr_s, wi_s, np0))
        np1, nev1 = np0 - str0, nev0 + str0
        # ---- dnconv over the wanted set ----
        conv = b_s <= tol * np.maximum(eps23, np.hypot(wr_s, wi_s))
        nconv = int(np.sum(conv & (iota >= np1)))
        # ---- zero-bound unwanted values cannot be shifted away ----
        nz = int(np.sum((b_s == 0) & (iota < np1)))
        np_eff, nev_eff = np1 - nz, nev1 + nz
        done = nconv >= nev0 or np_eff == 0
        trace(debug.maup2, 0, "_realnonsym_cycle: iter {i}: nconv={nc} "
              "rnorm={rn}", i=state.iter, nc=nconv, rn=state.rnorm)
        trace(debug.maup2, 1, "_realnonsym_cycle: ritz Re (wanted last) {wr}"
              "\n _realnonsym_cycle: ritz Im {wi}\n _realnonsym_cycle: "
              "bounds {b}", wr=wr_s, wi=wi_s, b=b_s)
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
        if _straddle(wr_s, wi_s, np_eff):
            step = 1 if np_eff > 1 else -1
            np_eff, nev_eff = np_eff - step, nev_eff + step
        return RealHeadOut(state=state, wr_s=wr_s, wi_s=wi_s, b_s=b_s,
                           nconv=nconv, done=done, nev_eff=nev_eff,
                           np_eff=np_eff)

    return head


def make_realnonsym_tail(op: Operator, cfg: IRAMConfig):
    """Build the exact-shift restart tail ``tail(h, is_last) ->
    RealCycleOut`` (dnapps with the shifts from dngets)."""
    ncv, nev0 = cfg.ncv, cfg.nev
    np0 = ncv - nev0
    rdt = _dt.real_dtype(cfg.dtype)
    R = rdt.type
    eps_m = R(_dt.eps(rdt))
    iota = np.arange(ncv)
    eyek = np.eye(ncv, dtype=rdt)
    bnorm = make_bnorm(op, cfg)

    # the chase's loss in the columns the restart keeps, relative to
    # max|H|, above which the explicit chase is redone implicitly: rounding
    # leaves O(eps); above eps^(2/3), the convergence test's floor, it
    # would perturb H by more than any tolerance the test can certify
    guard = R(cfg.eps23)

    def _shift_q(H, mur, mui):
        """Q of the explicit QR of ``H - mu I`` (real shift) or of
        ``H^2 - 2 Re(mu) H + |mu|^2 I`` (conjugate pair, mui > 0)."""
        if mui > 0:
            M = H @ H - (2.0 * mur) * H + (mur * mur + mui * mui) * eyek
        else:
            M = H - mur * eyek
        return np.linalg.qr(M)[0]

    def _implicit_q(H, mur, mui):
        """Q of the same shift applied as dnapps applies it: an implicit
        bulge chase of Householder reflectors of order 2 (real shift) or 3
        (conjugate pair), which keeps the Hessenberg form by
        construction."""
        nb = 3 if mui > 0 else 2
        if mui > 0:
            x = np.array([H[0, 0] * H[0, 0] + H[0, 1] * H[1, 0]
                          - (2.0 * mur) * H[0, 0] + (mur * mur + mui * mui),
                          H[1, 0] * (H[0, 0] + H[1, 1] - 2.0 * mur),
                          H[1, 0] * H[2, 1]], rdt)
        else:
            x = np.array([H[0, 0] - mur, H[1, 0]], rdt)
        Hc, q = H.copy(), eyek.copy()
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

    def _chase(H, shifts, step):
        """Apply the shifts in turn, each by ``step(H, mur, mui) -> q``:
        ``H <- triu(q^T H q, -1)`` deflated, ``Q <- Q q``."""
        Q = eyek
        for mur, mui in shifts:
            q = step(H, mur, mui)
            H, _ = _deflate_real(np.triu(q.T @ H @ q, -1), eps_m)
            Q = Q @ q
        return H, Q

    def apply_shifts(h: RealHeadOut) -> FactorizationState:
        state, nev_eff, np_eff = h.state, h.nev_eff, h.np_eff
        # shift pool: the np_eff least-wanted values (dsaup2.f:516-521),
        # largest bound first (dngets.f:180-187); pair members tie on their
        # bounds, so the stable sort keeps them adjacent, +wi first
        active = (iota < np_eff)[:np0]
        skey = np.where(active, -np.abs(h.b_s[:np0]), R(np.inf))
        sperm = np.argsort(skey, kind="stable")
        s_wr, s_wi = h.wr_s[:np0][sperm], h.wi_s[:np0][sperm]
        shifts = [(mur, mui) for mur, mui, act in zip(s_wr, s_wi, active)
                  if act and mui >= 0]  # a pair's partner is applied with it
        H0 = state.H.astype(rdt)
        Hc, Q = _chase(H0, shifts, _shift_q)
        lost = np.max(np.abs((Q.T @ H0 @ Q)[:, :nev_eff] - Hc[:, :nev_eff]))
        if lost > guard * np.max(np.abs(H0)):
            # an explicit step lost the Hessenberg form where the restart
            # keeps it (forward instability of an explicit QR with a
            # near-zero pivot before its last row, e.g. after an exact
            # shift left a tiny coupling) and the truncation broke the
            # Arnoldi relation, as it does in the reference package.
            # Apply the shifts as dnapps does, by implicit bulge chases.
            Hc, Q = _chase(H0, shifts, _implicit_q)
        sigmak = Q[ncv - 1, nev_eff - 1]
        betak = Hc[nev_eff, nev_eff - 1]
        # dnapps-parity kev-row update of the basis (rows 0..nev_eff of
        # Q^T V survive the restart)
        return restart_tail(op, cfg, bnorm, state, Q, Hc, sigmak, betak,
                            nev_eff)

    def tail(h: RealHeadOut, is_last: bool) -> RealCycleOut:
        if h.done or is_last:
            # exit before dnapps: keep the full factorization
            state = h.state.replace(iter=h.state.iter + 1)
        else:
            state = apply_shifts(h)
        return RealCycleOut(state=state, done=h.done, nconv=h.nconv,
                            wr_s=h.wr_s, wi_s=h.wi_s, bounds_s=h.b_s)

    return tail


class FusedRealNonsymSolver(HostLoopSolver):
    """dnaupd-equivalent driver over the real non-symmetric cycle, with the
    name of the reference package's driver.  The restart loop runs on the
    host.  ``mesh``: see :class:`HostLoopSolver`."""

    def __init__(self, op: Operator, cfg: IRAMConfig, mesh=None):
        if _dt.is_complex(cfg.dtype):
            raise ValueError("FusedRealNonsymSolver is for real dtypes")
        if cfg.symmetric:
            raise ValueError("use FusedSymSolver for symmetric problems")
        if not cfg.exact_shifts:
            raise ValueError("the fused path requires exact shifts")
        super().__init__(op, cfg, make_realnonsym_head, make_realnonsym_tail,
                         mesh)

    def _start(self, state: FactorizationState) -> RealCycleOut:
        z = np.zeros(self.cfg.ncv, _dt.real_dtype(self.cfg.dtype))
        return RealCycleOut(state=state, done=False, nconv=0, wr_s=z,
                            wi_s=z, bounds_s=z)

    def _exit(self, out: RealCycleOut):
        cfg = self.cfg
        r_s = (np.asarray(out.wr_s, np.float64)
               + 1j * np.asarray(out.wi_s, np.float64))
        b_s = np.asarray(out.bounds_s, np.float64)
        r_x, b_x = reduced.exit_sort(cfg.which, cfg.nev, out.nconv,
                                     r_s.copy(), b_s.copy(), cfg.eps23,
                                     False, True)
        info = 1 if (out.state.iter >= cfg.max_iter
                     and out.nconv < cfg.nev) else 0
        return r_x, b_x, info
