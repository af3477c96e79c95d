"""Symmetric and Hermitian restart cycle (port of
``arpack_ng_tpu/core/device_sym.py``).  A Hermitian problem keeps a real
tridiagonal T and a real Q over its complex basis: the reduced space and
its kernel are those of the real case, the basis rotation runs the
rotation kernel on the complex basis' real view, and a complex event is a
pair of masked GEMVs (``core/arnoldi.py``).

One major iteration of dsaup2: factorization extension (dsaitr), the
tridiagonal eigensolve (dseigt), shift selection (dsgets), the convergence
count (dsconv), nev inflation, the implicit exact-shift QR with
accumulated Q (dsapps), the kev-row basis rotation and the residual
update.

:class:`FusedSymSolver` runs the selective loop (``reorth='selective'``,
the default) on the operator's device, the counterpart of the reference's
on-device ``make_sym_multi_cycle``: each cycle is the restart rotation and
residual update of the previous cycle plus the Lanczos extension, with no
device-to-host read (on a CUDA card, one CUDA graph per start ``k``), then
the reduced space as one kernel (``ops/cuda_sym_cycle.py``), then one read
of a small packet; the dgks loop (``reorth='dgks'``) is the same loop over
the read-free CGS + DGKS extension.  The loop (``core/loop``:
:class:`DeviceLoopSolver`, ``_DeviceLoop``) is shared with the real
non-symmetric driver (``core/device_realnonsym.py``) and the hybrid
(``core/iram.py``), which give it their own reduce steps and exits.
``make_sym_head`` / ``make_sym_tail``
keep the host loop, its reduced space in numpy, which the mid-solve
hand-over drives cycle by cycle, and so do the re-tridiagonalizing thick
restart (``restart='thick'``, :func:`thick_restart`) and caller-supplied
shifts (``shift_fn``, the ido=3 protocol).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import IRAMConfig
from ..ops import cuda_sym_cycle
from ..ops.cuda_sym_cycle import (P_CNT, P_DONE, P_HEAD, P_NCONV, P_RNORM,
                                  Params, head_of, head_plain, packet_size,
                                  shifts_plain, sym_cycle, which_key)
from ..ops.operator import Operator
from ..utils import dtypes as _dt
from ..utils.debug import debug, trace
from . import reduced
from .arnoldi import (FactorizationState, make_bnorm, make_extend,
                      restart_tail, rotate_basis_kev)
from .loop import DeviceLoopSolver


class CycleOut(NamedTuple):
    state: FactorizationState
    done: bool          # exit condition fired (excl. maxiter)
    nconv: int
    ritz_s: np.ndarray  # (ncv,) which-sorted Ritz values (wanted last)
    bounds_s: np.ndarray


class HeadOut(NamedTuple):
    """What the restart tail needs from the first half of a cycle
    (extend + dseigt + dsgets + dsconv + nev inflation)."""

    state: FactorizationState
    T: np.ndarray        # (ncv, ncv) projected matrix
    evals: np.ndarray    # ascending eigenvalues of T
    S: np.ndarray        # eigenvectors of T (columns, matching evals)
    r_s: np.ndarray      # which-sorted Ritz values, nev0 arrangement
    b_s: np.ndarray      # matching bounds
    r_si: np.ndarray     # which-sorted with the INFLATED nev (differs
    b_si: np.ndarray     #   from r_s/b_s only for which='BE')
    nconv: int
    done: bool
    nev_eff: int         # after zero-bound removal + inflation
    np_eff: int


def _params(cfg: IRAMConfig, inflate: bool = True) -> Params:
    if cfg.which not in cuda_sym_cycle.WHICH:
        raise ValueError(f"device path does not support which={cfg.which!r}")
    rdt = _dt.real_dtype(cfg.dtype)
    return Params(which=cfg.which, nev=cfg.nev,
                  tol=float(rdt.type(cfg.tol_effective)),
                  eps23=float(rdt.type(cfg.eps23)),
                  eps_m=float(rdt.type(_dt.eps(cfg.dtype))), inflate=inflate)


def make_sym_head(op: Operator, cfg: IRAMConfig, inflate: bool = True):
    """Build ``head(state) -> HeadOut``: dsaup2 from the extension through
    shift-count fixing (dsaitr, dseigt, dsgets, dsconv, the zero-bound
    shift removal and the stagnation nev inflation, dsaup2.f:368-693),
    the reduced space on the host.  ``inflate=False`` skips the inflation,
    as the reference does for caller-supplied shifts (the guard ``nconv <
    nev .and. ishift == 1`` at dsaup2.f:673).  A thick restart's T is the
    full upper triangle of H (the extension's projections; the
    subdiagonal holds the recurrence's beta writes), and its reduced space
    runs in float64 (see :func:`thick_restart`)."""
    if not cfg.symmetric:
        raise ValueError("the symmetric cycle is for symmetric problems")
    thick = cfg.restart == "thick"
    if thick and cfg.which == "BE":
        raise ValueError("restart='thick' does not support which='BE'; "
                         "use the implicit restart")
    ncv = cfg.ncv
    rdt = _dt.real_dtype(cfg.dtype)
    p = _params(cfg, inflate)
    extend = make_extend(op, cfg)

    def head(state: FactorizationState) -> HeadOut:
        state = extend(state, ncv)
        if thick:
            Hf = state.H.real.astype(np.float64)
            h = head_of(np.triu(Hf) + np.triu(Hf, 1).T, state.rnorm, p)
        else:
            d = np.diag(state.H).real.astype(rdt)
            e = np.diag(state.H, -1).real.astype(rdt)
            h = head_plain(d, e, state.rnorm, p)
        trace(debug.maup2, 0, "_sym_cycle: iter {i}: nconv={nc} rnorm={rn}",
              i=state.iter, nc=h.nconv, rn=state.rnorm)
        trace(debug.maup2, 1, "_sym_cycle: ritz (wanted last) {r}\n"
              " _sym_cycle: bounds {b}", r=h.r_s, b=h.b_s)
        trace(debug.meigt, 0, "_sym_cycle: eigenvalues of T {e}", e=h.evals)
        return HeadOut(state=state, T=h.T, evals=h.evals, S=h.S, r_s=h.r_s,
                       b_s=h.b_s, r_si=h.r_si, b_si=h.b_si, nconv=h.nconv,
                       done=h.done, nev_eff=h.nev_eff, np_eff=h.np_eff)

    return head


def _retridiagonalize(theta, c, kk: int):
    """Orthogonal ``P`` with ``P^T diag(theta) P`` tridiagonal and ``c^T P
    = ||c|| e_{kk-1}^T``: the Krylov-Schur-to-Lanczos conversion that
    removes the thick restart's arrowhead, so the three-term recurrence
    (and the selective omega model) resumes (reference
    ``arpack_ng_tpu/core/device_sym.py:323-398``).

    ``kk`` steps of Lanczos on the diagonal matrix theta from ``c/||c||``
    with two full reorthogonalization passes per step.  An exact breakdown
    (c orthogonal to an invariant subspace) splices in the least
    represented coordinate with a true zero coupling, which splits the
    tridiagonal.  Reversing the active window puts the coupling on the
    LAST kept vector, where the resumed recurrence expects it.  Returns
    ``(P, a_rev, b_rev, cnorm)``; only the leading ``kk`` columns / entries
    are meaningful.  In float64 (see :func:`thick_restart`)."""
    rdt = np.dtype(np.float64)
    R = rdt.type
    theta, c = theta.astype(rdt), c.astype(rdt)
    ncv = theta.shape[0]
    iota = np.arange(ncv)
    m = iota < kk
    zero = R(0)
    thet = np.where(m, theta, zero)
    cnorm = np.sqrt(np.sum(np.where(m, c * c, zero)))
    tiny = R(_dt.safmin(rdt))
    q1 = np.where(m, c, zero) / np.maximum(cnorm, tiny)
    scale = np.max(np.abs(thet))
    brk = R(8 * ncv * _dt.eps(rdt)) * np.maximum(scale, tiny)

    Q = np.zeros((ncv, ncv), rdt)
    a = np.zeros(ncv, rdt)
    b = np.zeros(ncv, rdt)
    q_cur, q_prev, beta_prev = q1, np.zeros(ncv, rdt), zero
    for i in range(kk):
        Q[:, i] = q_cur

        def reorth(w):
            s = np.where(iota <= i, Q.T @ w, zero)
            return w - Q @ s

        w = thet * q_cur
        alpha = np.sum(q_cur * w)
        w = w - alpha * q_cur - beta_prev * q_prev
        w = reorth(reorth(w))
        beta = np.sqrt(np.sum(w * w))
        if beta <= brk:
            # the least represented active coordinate, orthogonalized
            rowsq = np.sum(np.where(iota[None, :] <= i, Q * Q, zero), axis=1)
            t = int(np.argmax(np.where(m, R(1) - rowsq, R(-np.inf))))
            e = np.zeros(ncv, rdt)
            e[t] = 1
            w2 = reorth(reorth(e))
            nw = np.sqrt(np.sum(w2 * w2))
            q_next, beta_out = w2 / np.maximum(nw, tiny), zero
        else:
            q_next, beta_out = w / np.maximum(beta, tiny), beta
        a[i], b[i] = alpha, beta_out
        q_prev, q_cur, beta_prev = q_cur, q_next, beta_out
    # reverse the active window: j <- kk - 1 - j
    rev = np.where(m, np.maximum(kk - 1 - iota, 0), iota)
    P = np.where(m[None, :], Q[:, rev], zero)
    a_rev = np.where(m, a[rev], zero)
    b_rev = np.where(iota < kk - 1, b[np.maximum(kk - 2 - iota, 0)], zero)
    return P, a_rev, b_rev, cnorm


def make_sym_tail(op: Operator, cfg: IRAMConfig, shift_fn=None):
    """Build the restart tail ``tail(h, is_last) -> CycleOut``: dsapps with
    the exact shifts from dsgets, or with ``shift_fn`` the ido=3 protocol
    (SRC/dsaup2.f:700-724): ``shift_fn(ritz, bounds)`` gets the np_eff
    unwanted Ritz values and bounds and returns at least np_eff shifts, of
    which the leading np_eff are applied in the given order; or, for
    ``restart='thick'``, :func:`thick_restart`, which applies no shifts."""
    thick = cfg.restart == "thick"
    if thick and shift_fn is not None:
        raise ValueError("user shifts require restart='implicit' "
                         "(a thick restart applies no shifts)")
    p = _params(cfg)
    np0 = cfg.ncv - cfg.nev
    rdt = _dt.real_dtype(cfg.dtype)
    bnorm = make_bnorm(op, cfg)

    def user_shifts(h: HeadOut):
        np_eff = h.np_eff
        shifts = np.asarray(shift_fn(
            np.asarray(h.r_si[:np_eff], np.float64).copy(),
            np.asarray(h.b_si[:np_eff], np.float64).copy()))
        if shifts.shape[0] < np_eff:
            raise ValueError(
                f"shift_fn returned {shifts.shape[0]} shifts; {np_eff} "
                "required (reference ido=3 contract)")
        sh = np.zeros((np0,), np.float64)
        sh[:np_eff] = shifts[:np_eff].real
        return sh.astype(rdt)

    def apply_shifts(h: HeadOut) -> FactorizationState:
        state = h.state
        shifts = None if shift_fn is None else user_shifts(h)
        Q, dn, en, sigmak, betak = shifts_plain(
            h.T, h.r_si, h.b_si, h.nev_eff, h.np_eff, p, shifts=shifts)
        H_new = (np.diag(dn) + np.diag(en, 1)
                 + np.diag(en, -1)).astype(cfg.dtype)
        # dsapps-parity kev-row update of the basis (SRC/dsapps.f:445-481);
        # Q is real, also for a complex (Hermitian) basis
        return restart_tail(op, cfg, bnorm, state, Q, H_new, sigmak, betak,
                            h.nev_eff)

    restart = (lambda h: thick_restart(op, cfg, h)) if thick \
        else apply_shifts

    def tail(h: HeadOut, is_last: bool) -> CycleOut:
        if h.done or is_last:
            # exit before dsapps: keep the full factorization
            state = h.state.replace(iter=h.state.iter + 1)
        else:
            state = restart(h)
        return CycleOut(state=state, done=h.done, nconv=h.nconv,
                        ritz_s=h.r_s, bounds_s=h.b_s)

    return tail


def thick_restart(op: Operator, cfg: IRAMConfig, h: HeadOut
                  ) -> FactorizationState:
    """The re-tridiagonalizing thick restart (reference
    ``arpack_ng_tpu/core/device_sym.py:400-441``): keep the nev_eff wanted
    Ritz vectors, rotated by :func:`_retridiagonalize`'s P so that H is
    tridiagonal again with the residual's coupling on the last kept vector:
    ``A V' = V' T' + (||c|| r) e_kev^T`` is a Lanczos factorization.  The
    rotation ``R = S_kept P`` of the basis is one kev-row pass (the
    rotation kernel on the card); the residual keeps its direction and its
    length scales by ``||c||``.

    The reduced space (T's eigenvectors, P and R) is formed in float64
    and R rounded to the problem's dtype, for float32 problems too, where
    the reference forms it in float32: on a clustered spectrum the float32
    Lanczos on diag(theta) declares breakdowns whenever a coupling falls
    below ``8 ncv eps |theta|`` (2.4e-4 on the flagship, whose top values
    lie 2.8e-5 apart), and its zero couplings give kept vectors zero
    bounds: the solve then stalls and converges to a set without the top
    values (``PERF.md`` section 6).  For float64 problems the
    arithmetic is the reference's."""
    ncv = cfg.ncv
    rdt = _dt.real_dtype(cfg.dtype)
    iota = np.arange(ncv)
    state, nev_eff = h.state, h.nev_eff
    # the kept (wanted) eigen-indices first: positions >= np_eff of the
    # which-order, in ascending order
    order = np.argsort(which_key(cfg.which, h.evals), kind="stable")
    src = order[np.argsort(iota < h.np_eff, kind="stable")]
    # the coupling row: c_i = S[ncv-1, kept_i] (A W = W Theta + r c^T for
    # W = V S_kept, r the current residual)
    P, a_rev, b_rev, cnorm = _retridiagonalize(h.evals[src],
                                               h.S[ncv - 1, src], nev_eff)
    Sk = np.where((iota < nev_eff)[None, :], h.S[:, src], 0.0)
    R = torch.from_numpy(np.ascontiguousarray((Sk @ P).astype(rdt))).to(
        op.device)
    V, _, rots = rotate_basis_kev(R, state.V, nev_eff, need_next=False)
    H_new = (np.diag(a_rev) + np.diag(b_rev[:-1], 1)
             + np.diag(b_rev[:-1], -1)).astype(cfg.dtype)
    scale = float(cnorm)
    resid = state.resid * scale
    b_resid = state.b_resid * scale if op.bmat == "G" else resid
    return state.replace(V=V, H=H_new, resid=resid, b_resid=b_resid,
                         rnorm=rdt.type(state.rnorm * cnorm), k=nev_eff,
                         nev_cur=nev_eff, iter=state.iter + 1,
                         counts=state.counts.add(nrotr=rots))


class FusedSymSolver(DeviceLoopSolver):
    """dsaupd-equivalent driver over the symmetric cycle, with the name of
    the reference package's driver.

    ``reorth='selective'`` (``'auto'``) and ``reorth='dgks'`` with the
    implicit restart and exact shifts run the restart loop on the
    operator's device (:class:`DeviceLoopSolver`): per cycle, the restart
    rotation and residual update of the previous cycle and the Lanczos
    extension from ``k`` with no device-to-host read (a dgks step whose
    first refinement fails, or a breakdown, sends the extension to the
    host, ``Extension.recover``, and a second packet is read), the
    reduced space as one kernel launch, and one read of a small packet
    (exit test, next ``k``, counters; ``ops/cuda_sym_cycle.py``).  On a
    CUDA card, for an operator that declares itself ``capturable``, the
    rotation and extension from each ``k`` are captured once as a CUDA
    graph (all in one memory pool, on the solver's stream) and replayed;
    the first cycle runs eagerly on that stream, which warms it up.  A
    capture that fails raises.

    ``restart='thick'`` and caller-supplied shifts (``shift_fn``, with
    ``cfg.exact_shifts`` False) keep the host loop (:class:`HostLoopSolver`
    over ``make_sym_head``/``make_sym_tail``); the extension stays
    read-free there, one read at its end.

    ``mesh``: the row mesh of a distributed solve (see
    :class:`~arpack_ng_tpu_torch.core.iram.HostLoopSolver`).  The device
    loop then runs on each rank's rows with its collectives in the
    extension; it is captured where the mesh's transport is
    (``RowMesh.capturable``: NCCL) and runs eagerly otherwise."""

    def __init__(self, op: Operator, cfg: IRAMConfig, shift_fn=None,
                 mesh=None):
        if cfg.exact_shifts and shift_fn is not None:
            raise ValueError("shift_fn requires exact_shifts=False "
                             "(reference iparam(1)=0, ishift=0)")
        if not cfg.exact_shifts and shift_fn is None:
            raise ValueError("exact_shifts=False requires a shift_fn")
        user = shift_fn is not None
        super().__init__(
            op, cfg, lambda o, c: make_sym_head(o, c, inflate=not user),
            lambda o, c: make_sym_tail(o, c, shift_fn=shift_fn), mesh)
        self._ext = make_extend(self.op, cfg)
        self._host_loop = (not self._ext.read_free or user
                           or cfg.restart == "thick")
        self._p = _params(cfg)

    def _start(self, state: FactorizationState) -> CycleOut:
        z = np.zeros(self.cfg.ncv, _dt.real_dtype(self.cfg.dtype))
        return CycleOut(state=state, done=False, nconv=0, ritz_s=z,
                        bounds_s=z)

    def _exit(self, out: CycleOut):
        cfg = self.cfg
        nconv = out.nconv
        r_s = np.asarray(out.ritz_s, np.float64)
        b_s = np.asarray(out.bounds_s, np.float64)
        r_x, b_x = reduced.exit_sort(cfg.which, cfg.nev, nconv, r_s.copy(),
                                     b_s.copy(), cfg.eps23, True, False)
        info = 0
        if out.state.iter >= cfg.max_iter and nconv < cfg.nev:
            info = 1
        np_rem = int(np.count_nonzero(b_s[: cfg.ncv - cfg.nev] == 0))
        if (cfg.ncv - cfg.nev - np_rem) == 0 and nconv < cfg.nev:
            info = 2
        return r_x, b_x, info

    # ---- the reduce step of the device loop (ops/cuda_sym_cycle.py) ----
    def _packet_size(self) -> int:
        return packet_size(self.cfg.ncv)

    def _reduce(self, ds, Q, sk, packet, is_last: bool) -> None:
        sym_cycle(ds.a, ds.b, ds.rnorm, ds.brk, ds.force, ds.cnt, Q, sk,
                  packet, self._p, is_last)

    @staticmethod
    def _tridiagonal(a, b):
        return np.diag(a) + np.diag(b, 1) + np.diag(b, -1)

    def _packet_fields(self, pk):
        ncv = self.cfg.ncv
        return (self._tridiagonal(pk[P_HEAD:P_HEAD + ncv],
                                  pk[P_HEAD + ncv:P_HEAD + 2 * ncv - 1]),
                pk[P_RNORM], pk[P_CNT:P_CNT + 4])

    def _read_fields(self, ds):
        ncv = self.cfg.ncv
        back = torch.cat([ds.a.double(), ds.b.double(),
                          ds.rnorm.double().reshape(1),
                          ds.cnt.double()]).cpu().numpy()
        return (self._tridiagonal(back[:ncv], back[ncv:2 * ncv - 1]),
                back[2 * ncv], back[2 * ncv + 1:])

    def _cycle_out(self, state: FactorizationState, pk) -> CycleOut:
        if pk is None:
            return self._start(state)
        ncv = self.cfg.ncv
        rdt = _dt.real_dtype(self.cfg.dtype)
        ritz = pk[P_HEAD + 2 * ncv:P_HEAD + 3 * ncv]
        return CycleOut(state=state, done=bool(pk[P_DONE]),
                        nconv=int(pk[P_NCONV]), ritz_s=ritz.astype(rdt),
                        bounds_s=pk[P_HEAD + 3 * ncv:].astype(rdt))

    def _trace_packet(self, pk, it: int) -> None:
        """The host loop's per-cycle trace (``make_sym_head``), from the
        packet already read."""
        if debug.maup2 > 0:
            ncv = self.cfg.ncv
            trace(debug.maup2, 0, "_sym_cycle: iter {i}: nconv={nc} "
                  "rnorm={rn}", i=it, nc=int(pk[P_NCONV]), rn=pk[P_RNORM])
            trace(debug.maup2, 1, "_sym_cycle: ritz (wanted last) {r}\n"
                  " _sym_cycle: bounds {b}",
                  r=pk[P_HEAD + 2 * ncv:P_HEAD + 3 * ncv],
                  b=pk[P_HEAD + 3 * ncv:])
