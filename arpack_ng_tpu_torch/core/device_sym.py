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
the read-free CGS + DGKS extension.  The loop (:class:`DeviceLoopSolver`,
:class:`_DeviceLoop`) is shared with the real non-symmetric driver
(``core/device_realnonsym.py``), which gives it its own reduce step and
exit.  ``make_sym_head`` / ``make_sym_tail``
keep the host loop, its reduced space in numpy, which the mid-solve
hand-over drives cycle by cycle, and so do the re-tridiagonalizing thick
restart (``restart='thick'``, :func:`thick_restart`) and caller-supplied
shifts (``shift_fn``, the ido=3 protocol).
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import IRAMConfig
from ..ops import (cuda_cgs, cuda_dia, cuda_psell, cuda_rot, cuda_sel,
                   cuda_sym_cycle)
from ..ops.cuda_sym_cycle import (P_BRK, P_CNT, P_DONE, P_FORCE, P_HEAD,
                                  P_INFO, P_NCONV, P_NEV, P_RNORM, Params,
                                  head_of, head_plain, packet_size,
                                  shifts_plain, sym_cycle, which_key)
from ..ops.operator import Operator
from ..utils import dtypes as _dt
from ..utils.debug import debug, trace
from ..utils.stats import Timers
from . import reduced
from .arnoldi import (FactorizationState, kev_rows, make_bnorm, make_extend,
                      restart_tail, rotate_basis_kev)
from .iram import HostLoopSolver, IRAMResult

#: the kernel wrappers whose launches a captured graph holds: on each
#: replay the solver adds the launches its capture counted
GRAPH_KERNELS = (cuda_sel.sel_proj, cuda_sel.sel_update,
                 cuda_cgs.cgs_proj, cuda_cgs.cgs_update,
                 cuda_rot.rotate_rows, cuda_dia.dia_matvec,
                 cuda_psell.psell_matvec)


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


class DeviceLoopSolver(HostLoopSolver):
    """A cycle driver whose restart loop runs on the operator's device
    (:class:`_DeviceLoop`) where its extension is read-free and the driver
    does not ask for the host loop (``_host_loop``).  The driver gives the
    loop its reduce step: the packet's size (:meth:`_packet_size`), the
    reduced-space kernel's launch (:meth:`_reduce`), the factorization's
    host fields from a packet or from one read of the device buffers
    (:meth:`_packet_fields`, :meth:`_read_fields`), the cycle output
    (:meth:`_cycle_out`) and the per-cycle trace (:meth:`_trace_packet`);
    its exit is :meth:`_exit`, as on the host loop.  The rest of the loop
    is shared: the deferred restart (the kev-row rotation by
    ``csrc/rot.cu``, the residual update from ``sk``, the B-norm), the CUDA
    graph per start ``k`` on a capturable operator, the first cycle run
    eagerly, the host's rerun after a breakdown or a failed refinement
    (``Extension.recover``, then the kernel again) and the mesh's
    collectives.

    The reference runs up to ``cycles_per_dispatch`` cycles in one
    ``lax.while_loop``; here the unit of dispatch is one cycle, because the
    next extension's start ``k = nev_eff`` picks the graph to replay and is
    known only from the cycle's packet.  :meth:`multi` bounds a run
    instead: at most ``n_cycles`` cycles, then the state at the cycle
    boundary, which ``io/checkpoint`` can dump and a fresh solver's
    :meth:`solve` resumes.  The loop defers each cycle's restart (the
    kev-row rotation and the residual update) to the start of the next
    cycle; a boundary applies it first, so the state handed back is the one
    the host loop holds there."""

    _host_loop = True

    def _packet_size(self) -> int:
        raise NotImplementedError

    def _reduce(self, ds, Q, sk, packet, is_last: bool) -> None:
        raise NotImplementedError

    def _packet_fields(self, pk):
        """``(H, rnorm, counters)`` of the factorization from a packet."""
        raise NotImplementedError

    def _read_fields(self, ds):
        """``(H, rnorm, counters)`` from one read of the device buffers."""
        raise NotImplementedError

    def _cycle_out(self, state: FactorizationState, pk):
        """The cycle output with ``state``; ``pk`` None before any cycle
        ended (no Ritz values)."""
        raise NotImplementedError

    def _trace_packet(self, pk, it: int) -> None:
        pass

    def _open(self, out) -> bool:
        """Whether a run that handed back ``out`` stopped at a boundary
        (the exit test has not fired, cycles and no error remain)."""
        st = out.state
        return not out.done and st.iter < self.cfg.max_iter and st.info == 0

    def multi(self, state: FactorizationState, n_cycles: int):
        """At most ``n_cycles`` restart cycles from ``state`` (reference
        ``make_sym_multi_cycle``, ``make_realnonsym_multi_cycle``).  A run
        that stops at the bound hands back the restarted state (``k =
        nev_eff``; ``done`` False), which :meth:`solve` resumes here or in
        a fresh solver; a run that exits hands back the exit's state as
        :meth:`solve` does.  The state's basis is updated in place."""
        out = self._start(state)
        if n_cycles < 1 or not self._open(out):
            return out
        if not self._host_loop:
            return _DeviceLoop(self, state).run(n_cycles)
        for _ in range(n_cycles):
            st = out.state
            out = self._tail(self._head(st), st.iter + 1 >= self.cfg.max_iter)
            if not self._open(out):
                break
        return out

    def solve(self, gen=None, v0=None, state=None) -> IRAMResult:
        if self._host_loop:
            return super().solve(gen=gen, v0=v0, state=state)
        timers = Timers()
        self._c0 = None if self.mesh is None else self.mesh.snapshot()
        t0 = time.perf_counter()
        if state is None:
            with timers.timed("tgetv0", self.op.device):
                state = self.init_state(gen=gen, v0=v0)
        if state.info < 0:
            z = np.zeros(self.cfg.ncv)
            return self._result(state, z, z, 0, state.info, 0, timers)
        loop = _DeviceLoop(self, state)
        out = loop.run()
        timers.taupd = time.perf_counter() - t0
        timers.taitr, timers.tapps = loop.times()
        state = out.state
        if state.info != 0:
            z = np.zeros(self.cfg.ncv)
            res = self._result(state, z, z, 0, -9999 if state.info > 0
                               else state.info, state.iter, timers)
        else:
            ritz, bounds, info = self._exit(out)
            res = self._result(state, ritz, bounds, out.nconv, info,
                               state.iter, timers)
        loop.record(res.stats)
        if debug.maupd > 0:
            print(res.stats.summary())
        return res


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


class _DeviceLoop:
    """One solve of the restart loop on the operator's device, over the
    selective or the dgks extension, with the driver's reduce step (see
    :class:`DeviceLoopSolver`): its buffers, graphs, stream and packet."""

    def __init__(self, solver: DeviceLoopSolver, state: FactorizationState):
        op, cfg = solver.op, solver.cfg
        self.solver = solver
        self.op, self.cfg, self.ext = op, cfg, solver._ext
        self.state = state
        self.ncv = ncv = cfg.ncv
        dev = op.device
        self.cuda = dev.type == "cuda"
        rtd = _dt.torch_dtype(_dt.real_dtype(cfg.dtype))
        self.tdt = _dt.torch_dtype(cfg.dtype)
        self.is_g = op.bmat == "G"
        self.bnorm = make_bnorm(op, cfg)
        self.ds = self.ext.load(state)
        self.Q = torch.zeros((ncv, ncv), dtype=rtd, device=dev)
        self.sk = torch.zeros(2, dtype=rtd, device=dev)
        self.packet = torch.zeros(solver._packet_size(), dtype=torch.float64,
                                  device=dev)
        self.mesh = op.mesh
        # a mesh's collectives are captured where its transport allows
        self.capture = self.cuda and op.capturable and (
            self.mesh is None or self.mesh.capturable)
        self.graphs = {}          # k -> (graph, launches, collectives)
        self.replays = 0
        self.packets = 0
        self.events = []
        if self.cuda:
            self.stream = torch.cuda.Stream(device=dev)
            self.pool = torch.cuda.graph_pool_handle()
            self.pk_host = torch.empty(solver._packet_size(),
                                       dtype=torch.float64, pin_memory=True)
            self.done_evt = torch.cuda.Event()
        self.t_ext = self.t_red = 0.0

    # ---- one cycle's pieces --------------------------------------------
    def _prefix(self, k: int) -> int:
        """The previous cycle's restart: the kev-row rotation by Q and the
        residual update from the device sigmak/betak (dsapps.f:445-481),
        then its B-norm.  Returns the rotated row count."""
        ds, tdt = self.ds, self.tdt
        rows = kev_rows(self.ncv, k)
        cuda_rot.rotate_rows(self.Q, ds.V, rows)
        resid = self.sk[0] * ds.resid + self.sk[1] * ds.V[k].to(tdt)
        ds.resid.copy_(resid)
        if self.is_g:
            ds.b_resid.copy_(self.op.b_apply(ds.resid))
        ds.rnorm.copy_(self.bnorm(ds.resid, ds.b_resid))
        return rows

    def _cycle_body(self, k: int) -> None:
        self._prefix(k)
        self.ext.run(self.ds, k, self.ncv)

    def _replay(self, k: int) -> None:
        """The cycle's rotation and extension from ``k`` as a CUDA graph,
        captured on first use.  A kernel wrapper counts its launch when the
        capture records it, and a mesh its collectives; the capture's counts
        are taken back and added again on every replay."""
        mesh = self.mesh
        entry = self.graphs.get(k)
        if entry is None:
            before = [f.launches for f in GRAPH_KERNELS]
            c0 = None if mesh is None else mesh.snapshot()
            g = torch.cuda.CUDAGraph()
            g.capture_begin(pool=self.pool)
            try:
                self._cycle_body(k)
            finally:
                g.capture_end()
            delta = [f.launches - b for f, b in zip(GRAPH_KERNELS, before)]
            for f, d in zip(GRAPH_KERNELS, delta):
                f.launches -= d
            coll = None
            if mesh is not None:
                coll = mesh.snapshot()
                coll.subtract(c0)
                mesh.counts.subtract(coll)
            entry = self.graphs[k] = (g, delta, coll)
        g, delta, coll = entry
        g.replay()
        for f, d in zip(GRAPH_KERNELS, delta):
            f.launches += d
        if coll is not None:
            mesh.counts.update(coll)
        self.replays += 1

    def _reduce(self, is_last: bool) -> np.ndarray:
        """The cycle's reduced space and its packet, read once."""
        self.packets += 1
        self.solver._reduce(self.ds, self.Q, self.sk, self.packet, is_last)
        if not self.cuda:
            return self.packet.numpy().copy()
        self.pk_host.copy_(self.packet, non_blocking=True)
        self.done_evt.record()
        self.done_evt.synchronize()
        return self.pk_host.numpy().copy()

    # ---- the loop ------------------------------------------------------
    def run(self, n_cycles=None):
        """The restart loop from the state, to its exit or, with
        ``n_cycles``, to the boundary after that many cycles."""
        if not self.cuda:
            return self._loop(n_cycles)
        cur = torch.cuda.current_stream(self.op.device)
        self.stream.wait_stream(cur)
        try:
            with torch.cuda.stream(self.stream):
                return self._loop(n_cycles)
        finally:
            cur.wait_stream(self.stream)

    def _timed(self, fn, *args):
        if not self.cuda:
            t0 = time.perf_counter()
            out = fn(*args)
            return out, time.perf_counter() - t0
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = fn(*args)
        e1.record()
        self.events.append((e0, e1))
        return out, None

    def _loop(self, n_cycles=None):
        cfg, ext, ncv = self.cfg, self.ext, self.ncv
        st = self.state
        counts, it, info, k = st.counts, st.iter, st.info, st.k
        nev_cur = st.nev_cur
        pk = None
        first = True
        ran = 0
        while it < cfg.max_iter and info == 0:
            if n_cycles is not None and ran == n_cycles:
                return self._boundary(pk, counts, it, k)
            ran += 1
            is_last = it + 1 >= cfg.max_iter
            k0 = k
            if first:
                _, dt = self._timed(ext.run, self.ds, k, ncv)
                first = False
            else:
                counts = counts.add(nbx=int(self.is_g),
                                    nrotr=kev_rows(ncv, k))
                body = self._replay if self.capture else self._cycle_body
                _, dt = self._timed(body, k)
            self.t_ext += dt or 0.0
            pk, dt = self._timed(self._reduce, is_last)
            self.t_red += dt or 0.0
            brk = int(pk[P_BRK])
            if brk != -1:
                counts, info, k = ext.recover(self.ds, brk, k0, ncv, st.gen,
                                              counts, info, int(pk[P_FORCE]))
                if info != 0:
                    it += 1
                    break
                pk = self._reduce(is_last)
            else:
                counts = ext.static_counts(counts, ncv - k0)
            self.solver._trace_packet(pk, it)
            it += 1
            if int(pk[P_INFO]) != 0:
                info = int(pk[P_INFO])
                break
            if pk[P_DONE] or is_last:
                k = ncv
                break
            k = nev_cur = int(pk[P_NEV])
        return self._out(pk, counts, it, info, k, nev_cur)

    def _boundary(self, pk, counts, it, k):
        """The state between cycles: the restart the next cycle would begin
        with (:meth:`_prefix`: the kev-row rotation, the residual update
        and its norm; T is already the restarted one), applied now, then
        the state from one read."""
        counts = counts.add(nbx=int(self.is_g), nrotr=self._prefix(k))
        return self._out(pk, counts, it, 0, k, k, read=True)

    def _out(self, pk, counts, it, info, k, nev_cur, read=False):
        """The state's host fields from the last packet (the factorization
        before its shifts: every exit skips them), or, after a failed
        restart vector or at a boundary (``read``), from one read."""
        ds, cfg, solver = self.ds, self.cfg, self.solver
        if pk is None or info > 0 or read:
            H, rn, ev = solver._read_fields(ds)
        else:
            H, rn, ev = solver._packet_fields(pk)
        ev = np.asarray(ev).astype(np.int64)
        counts = counts.add(nrorth=ev[0], nitref=ev[1], nbx=ev[2],
                            nrorthr=ev[3])
        rdt = _dt.real_dtype(cfg.dtype)
        state = self.state.replace(
            V=ds.V, H=np.asarray(H).astype(cfg.dtype), resid=ds.resid,
            b_resid=ds.b_resid, rnorm=rdt.type(rn), k=k, nev_cur=nev_cur,
            iter=it, info=info, counts=counts)
        return solver._cycle_out(state, None if pk is None or info > 0
                                 else pk)

    def times(self):
        """Seconds of the extensions (with the restart rotations) and of
        the reduced spaces: CUDA-event device time on a card."""
        if self.cuda:
            torch.cuda.synchronize(self.op.device)
            ms = [e0.elapsed_time(e1) for e0, e1 in self.events]
            self.t_ext = sum(ms[0::2]) / 1e3
            self.t_red = sum(ms[1::2]) / 1e3
        return self.t_ext, self.t_red

    def record(self, stats) -> None:
        """The dispatch counters in the solve's statistics."""
        stats.packets = self.packets
        stats.graphs_captured = len(self.graphs)
        stats.graph_replays = self.replays
        stats.replay_launches = {
            k: {f.__name__: d for f, d in zip(GRAPH_KERNELS, delta) if d}
            for k, (_, delta, _) in sorted(self.graphs.items())}
