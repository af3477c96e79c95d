"""Implicitly-restarted Arnoldi/Lanczos driver (port of
``arpack_ng_tpu/core/iram.py``): the hybrid driver ``IRAMSolver``, the
dsaupd+dsaup2 / dnaupd+dnaup2 / znaupd+znaup2 equivalent.  The output of
the iteration phase (``IRAMResult``) and the host restart loop the cycle
drivers share (``HostLoopSolver``) live in ``core/loop`` and are
importable here.

The hybrid driver splits each cycle as the reference package's
``IRAMSolver.iterate`` does: the extension to ncv steps on the operator's
device, then one read of the projected matrix and the residual norm, the
reduced space on the host in float64 (complex128 for complex dtypes) with
``core/reduced`` (:func:`make_iram_reduce`: Ritz values and bounds, shift
selection, the convergence count, the zero-bound rule, the exit test, nev
inflation, the shifted QR), then the device tail: the kev-row basis
rotation, the residual update ``r <- sigma_k r + beta_k v_next`` and its
B-norm.  :class:`IRAMSolver` runs these cycles on the device loop
(``core/loop._DeviceLoop``): the tail and the next extension with no read
(one CUDA graph per start ``k`` on a capturable operator), then one read
of a packet (the breakdown word, rnorm, the event counters and H) for the
host's reduce step, whose Q, ``(sigmak, betak)`` and restarted H go back
into the loop's buffers through pinned staging.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import IRAMConfig
from ..ops.cuda_sym_cycle import (P_BRK, P_CNT, P_DONE, P_FORCE, P_HEAD,
                                  P_INFO, P_NCONV, P_NEV, P_NP, P_RNORM)
from ..ops.operator import Operator
from ..utils import dtypes as _dt
from ..utils.debug import debug, trace
from . import reduced
from .arnoldi import FactorizationState, make_bnorm, make_extend, restart_tail
from .loop import DeviceLoopSolver, HostLoopSolver, IRAMResult  # noqa: F401


class IRAMCycleOut(NamedTuple):
    """One hybrid cycle: the state after it and, when the exit test fired,
    the exit-ordered Ritz values and bounds with the info code."""

    state: FactorizationState
    done: bool
    nconv: int
    ritz: np.ndarray
    bounds: np.ndarray
    info: int


class IRAMReduced(NamedTuple):
    """The host part of one hybrid cycle (:func:`make_iram_reduce`): the
    exit's Ritz values, bounds and info code when ``done``, else the
    restart: ``Q``, the shifted ``H_new``, ``sigmak``, ``betak`` and the
    next length ``nev``."""

    done: bool
    nconv: int
    ritz: Optional[np.ndarray] = None
    bounds: Optional[np.ndarray] = None
    info: int = 0
    Q: Optional[np.ndarray] = None
    H_new: Optional[np.ndarray] = None
    sigmak: complex = 0.0
    betak: complex = 0.0
    nev: int = 0


def make_iram_head(op: Operator, cfg: IRAMConfig):
    """``head(state)``: the extension to ncv steps (dsaitr / dnaitr) with
    the event kernels allowed, as the reference's unsharded hybrid builds
    it (``pallas_sel_ok=True``)."""
    extend = make_extend(op, cfg)
    return lambda state: extend(state, cfg.ncv)


def make_iram_reduce(cfg: IRAMConfig, shift_fn=None):
    """``reduce(H, rnorm, cur_iter, is_last) -> IRAMReduced``: the reduced
    space of one cycle on the host (reference ``IRAMSolver.iterate``,
    ``arpack_ng_tpu/core/iram.py:209-306``), from the projected matrix
    ``H`` (host, float64 or complex128) and the residual norm.  With
    ``cfg.exact_shifts`` False the caller's ``shift_fn(ritz, bounds)``
    gives the shifts (the ido=3 protocol, SRC/dsaup2.f:700-724): it gets
    the np unwanted Ritz values and bounds, its leading np shifts are
    applied in the given order, and nev is not inflated (dsaup2.f:673)."""
    kplusp, nev0 = cfg.ncv, cfg.nev
    np0 = kplusp - nev0
    sym = cfg.symmetric
    cplx = _dt.is_complex(cfg.dtype)
    tol, eps23 = cfg.tol_effective, cfg.eps23
    eps_m = _dt.eps(np.float64)      # the host reduced space is float64
    smlnum = _dt.safmin(np.float64) * (kplusp / eps_m)
    real_pairs = (not sym) and (not cplx)

    def reduce(H, rnorm: float, cur_iter: int, is_last: bool
               ) -> IRAMReduced:
        # ---- Ritz values + bounds (dseigt / dneigh) ----
        if sym:
            alpha = np.diag(H).real.copy()
            beta = np.zeros(kplusp)
            if kplusp > 1:
                beta[: kplusp - 1] = np.diag(H, -1).real
            ritz, bounds, _ = reduced.sym_eigt(
                alpha, beta[: kplusp - 1], rnorm, need_vectors=False)
        else:
            ritz, bounds, _ = reduced.nonsym_eigt(H, rnorm)
        trace(debug.maup2, 1, "_aup2: eigenvalues of H {r}", r=ritz)

        # ---- shift selection (dsgets / dngets) ----
        nev, np_ = nev0, np0
        if sym:
            r_s, b_s, shifts = reduced.sym_gets(cfg.which, nev, np_, ritz,
                                                bounds)
        else:
            nev, np_, r_s, b_s, shifts = reduced.nonsym_gets(
                cfg.which, nev, np_, ritz, bounds, real_pairs)

        # ---- convergence count on the nev0 wanted values ----
        nconv = reduced.conv_count(r_s[kplusp - nev0:], b_s[kplusp - nev0:],
                                   tol, eps23)
        trace(debug.maup2, 0, "_aup2: iter {i}: nconv={nc}, rnorm={rn:.3e}",
              i=cur_iter, nc=nconv, rn=rnorm)

        # ---- unremovable (zero-bound) unwanted values (dsaup2.f:500-516)
        nz = int(np.count_nonzero(b_s[:np_] == 0.0))
        np_ -= nz
        nev += nz

        # ---- exit test (dsaup2.f:519-667) ----
        if nconv >= nev0 or is_last or np_ == 0:
            r_x, b_x = reduced.exit_sort(cfg.which, nev0, nconv, r_s.copy(),
                                         b_s.copy(), eps23, sym, real_pairs)
            info = 0
            if is_last and nconv < nev0:
                info = 1
            if np_ == 0 and nconv < nev0:
                info = 2
            return IRAMReduced(True, nconv, r_x, b_x, info)

        # ---- stagnation guard: inflate nev (dsaup2.f:673-693) ----
        if nconv < nev0 and cfg.exact_shifts:
            nevbef = nev
            nev = nev + min(nconv, np_ // 2)
            if nev == 1 and kplusp >= 6:
                nev = kplusp // 2
            elif nev == 1 and kplusp > 3:
                nev = 2
            np_ = kplusp - nev
            if nevbef < nev:
                if sym:
                    r_s, b_s, shifts = reduced.sym_gets(
                        cfg.which, nev, np_, ritz, bounds)
                else:
                    nev, np_, r_s, b_s, shifts = reduced.nonsym_gets(
                        cfg.which, nev, np_, ritz, bounds, real_pairs)
        if not cfg.exact_shifts:
            shifts = np.asarray(shift_fn(r_s[:np_].copy(),
                                         b_s[:np_].copy()))[:np_]
        trace(debug.mgets, 2, "_aup2: shifts selected {s}", s=shifts[:np_])

        # ---- the shifted QR on the host (dsapps / dnapps / znapps) ----
        if sym:
            alpha2, beta2, Q = reduced.sym_shift_q(
                alpha, beta[: kplusp - 1], shifts[:np_], eps_m)
            betak = float(beta2[nev - 1]) if nev < kplusp else 0.0
            H_new = (np.diag(alpha2) + np.diag(beta2[: kplusp - 1], -1)
                     + np.diag(beta2[: kplusp - 1], 1))
        else:
            H_new, Q = reduced.nonsym_shift_q(H, shifts[:np_], eps_m,
                                              smlnum, real_pairs)
            betak = H_new[nev, nev - 1] if nev < kplusp else 0.0
        return IRAMReduced(False, nconv, Q=Q, H_new=H_new,
                           sigmak=Q[kplusp - 1, nev - 1], betak=betak,
                           nev=nev)

    return reduce


def make_iram_tail(op: Operator, cfg: IRAMConfig, shift_fn=None):
    """``tail(state, is_last) -> IRAMCycleOut``: the host loop's end of a
    cycle (reference ``IRAMSolver.iterate``,
    ``arpack_ng_tpu/core/iram.py:167-306``, from the read-back on): the
    reduced space (:func:`make_iram_reduce`), then the device tail
    (``arnoldi.restart_tail``, one read of the new rnorm)."""
    host = _dt.host_dtype(cfg.dtype)
    reduce = make_iram_reduce(cfg, shift_fn)
    bnorm = make_bnorm(op, cfg)
    zero = np.zeros(cfg.ncv)

    def tail(state: FactorizationState, is_last: bool) -> IRAMCycleOut:
        if state.info != 0:
            # no kplusp-step factorization even after random restarts: the
            # reference maps this to -9999 (SRC/dsaup2.f:434-443)
            return IRAMCycleOut(state, True, 0, zero, zero,
                                -9999 if state.info > 0 else state.info)
        r = reduce(np.asarray(state.H).astype(host), float(state.rnorm),
                   state.iter + 1, is_last)
        if r.done:
            return IRAMCycleOut(state, True, r.nconv, r.ritz, r.bounds,
                                r.info)
        state = restart_tail(op, cfg, bnorm, state, r.Q, r.H_new, r.sigmak,
                             r.betak, r.nev)
        return IRAMCycleOut(state, False, r.nconv, zero, zero, 0)

    return tail


class IRAMSolver(DeviceLoopSolver):
    """The hybrid driver (reference ``arpack_ng_tpu.core.iram.IRAMSolver``)
    for symmetric (Hermitian) and non-symmetric, real and complex problems:
    the device loop (``core/loop._DeviceLoop``; every extension
    ``make_extend`` builds is read-free) with :func:`make_iram_reduce` as
    its reduce step on the host.  Per cycle the device runs the previous
    cycle's restart (the kev-row rotation by the host's Q: the rotation
    kernel for a real Q, a GEMM with ``Q^T`` for the complex Arnoldi
    restart) and the extension with no read, on a CUDA card for a
    capturable operator as one graph per start ``k`` (eagerly otherwise:
    a caller's matvec, an iterative solve, a C callback, a gloo mesh);
    then one packet read (the breakdown word, the pair-rule flag, rnorm,
    the event counters and H: T's diagonals for the selective step, the
    whole Hessenberg for dgks) and the host's reduced space, whose Q,
    ``(sigmak, betak)`` and restarted H go into the loop's buffers from
    pinned staging before the next replay.  The same kernels run in the
    same order as on the host loop (:meth:`iterate`, ``make_iram_head`` /
    :func:`make_iram_tail`), which ``_host_loop = True`` runs instead.

    :meth:`iterate` runs one cycle on the host loop; :meth:`multi` at most
    n cycles on the device loop.  ``shift_fn``: the caller's shifts (see
    :func:`make_iram_reduce`), for a config with ``exact_shifts`` False.
    ``mesh``: see :class:`HostLoopSolver`."""

    _exit_counts = False

    def __init__(self, op: Operator, cfg: IRAMConfig, shift_fn=None,
                 mesh=None):
        if op.n != cfg.n:
            raise ValueError("operator/config dimension mismatch")
        if op.bmat != cfg.bmat:
            raise ValueError("operator/config bmat mismatch")
        if not cfg.exact_shifts and shift_fn is None:
            raise ValueError("exact_shifts=False requires a shift_fn")
        if cfg.restart != "implicit":
            # the reference's hybrid driver never reads cfg.restart and
            # runs the implicit restart instead (arpack_ng_tpu/api.py:132)
            raise ValueError("the hybrid driver runs the implicit restart "
                             "only; restart='thick' needs strategy='fused'")
        super().__init__(op, cfg, make_iram_head,
                         lambda o, c: make_iram_tail(o, c, shift_fn), mesh)
        self._ext = make_extend(self.op, cfg)
        self._host_loop = not self._ext.read_free
        self._host_reduce = make_iram_reduce(cfg, shift_fn)
        self._cplx = _dt.is_complex(cfg.dtype)
        # the selective step leaves T's diagonals, dgks whole columns of H
        self._tridiagonal = self._ext.selective
        # the complex Arnoldi restart's Q is complex; a Hermitian one real
        self._q_np = (np.dtype(cfg.dtype) if self._cplx and not cfg.symmetric
                      else _dt.real_dtype(cfg.dtype))

    def _start(self, state: FactorizationState) -> IRAMCycleOut:
        z = np.zeros(self.cfg.ncv)
        return IRAMCycleOut(state, False, 0, z, z, 0)

    def _exit(self, out: IRAMCycleOut):
        return out.ritz, out.bounds, out.info

    def _n_iter(self, out: IRAMCycleOut) -> int:
        # an exit hands back the last cycle's factorization before its
        # shifts with ``iter`` at the cycles before it, as the reference's
        # hybrid driver does: a dump of it resumes by taking that cycle up
        # again under its own number (a run stopped at max_iter continues
        # as the unbroken solve does); the exit cycle counts in n_iter
        return out.state.iter + int(out.done)

    def solve(self, gen: Optional[torch.Generator] = None, v0=None,
              state: Optional[FactorizationState] = None) -> IRAMResult:
        res = super().solve(gen=gen, v0=v0, state=state)
        if self._host_loop and debug.maupd > 0:
            print(res.stats.summary())
        return res

    def iterate(self, state: FactorizationState) -> IRAMCycleOut:
        """One major iteration (the dsaup2 1000-loop body) on the host
        loop."""
        return self._tail(self._head(state),
                          state.iter + 1 >= self.cfg.max_iter)

    # ---- the reduce step of the device loop: on the host ----------------
    # The packet: the header of ``ops/cuda_sym_cycle`` (the device fills
    # the breakdown word, the pair-rule flag, rnorm and the counters; the
    # host step the exit flag, nconv, the next k and np_eff), then H: T's
    # diagonal and subdiagonal, or the whole matrix (real and imaginary
    # parts interleaved for a complex one).  The host step appends the
    # exit's Ritz values (real and imaginary parts), bounds and info code.
    def _h_size(self) -> int:
        ncv = self.cfg.ncv
        if self._tridiagonal:
            return 2 * ncv
        return ncv * ncv * (2 if self._cplx else 1)

    def _packet_size(self) -> int:
        return P_HEAD + self._h_size()

    def _q_dtype(self) -> torch.dtype:
        return _dt.torch_dtype(self._q_np)

    def _reduce(self, ds, Q, sk, packet, is_last: bool) -> None:
        ncv = self.cfg.ncv
        packet[P_BRK].copy_(ds.brk)
        packet[P_FORCE].copy_(ds.force)
        packet[P_RNORM].copy_(ds.rnorm)
        packet[P_CNT:P_CNT + 4].copy_(ds.cnt)
        h = packet[P_HEAD:P_HEAD + self._h_size()]
        if self._tridiagonal:
            h[:ncv].copy_(ds.a)
            h[ncv:].copy_(ds.b)
        else:
            h.view(ds.H.shape + ((2,) if self._cplx else ())).copy_(
                torch.view_as_real(ds.H) if self._cplx else ds.H)

    def _host_step(self, loop, pk, is_last: bool, it: int):
        if pk[P_BRK] != -1:
            return pk        # the host finishes the extension first
        cfg, ncv = self.cfg, self.cfg.ncv
        H, rnorm, _ = self._packet_fields(pk)
        r = self._host_reduce(H.astype(_dt.host_dtype(cfg.dtype)),
                              float(rnorm), it + 1, is_last)
        pk[P_DONE], pk[P_NCONV], pk[P_INFO] = r.done, r.nconv, 0
        ritz = bounds = np.zeros(ncv)
        if r.done:
            ritz, bounds = np.asarray(r.ritz), np.asarray(r.bounds)
        else:
            pk[P_NEV], pk[P_NP] = r.nev, ncv - r.nev
            loop.stage(loop.Q, np.asarray(r.Q).astype(self._q_np))
            loop.stage(loop.sk,
                       np.array([r.sigmak, r.betak]).astype(self._q_np))
            self._ext.put_h(loop.ds, np.asarray(r.H_new).astype(cfg.dtype),
                            loop.stage)
        return np.concatenate([pk, np.real(ritz), np.imag(ritz), bounds,
                               [r.info]])

    def _packet_fields(self, pk):
        cfg, ncv = self.cfg, self.cfg.ncv
        h = pk[P_HEAD:P_HEAD + self._h_size()]
        if self._tridiagonal:
            a, b = h[:ncv], h[ncv:2 * ncv - 1]
            H = np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
        elif self._cplx:
            H = h.reshape(ncv, ncv, 2).view(np.complex128)[..., 0]
        else:
            H = h.reshape(ncv, ncv)
        return H.astype(cfg.dtype), pk[P_RNORM], pk[P_CNT:P_CNT + 4]

    def _read_fields(self, ds):
        packet = torch.zeros(self._packet_size(), dtype=torch.float64,
                             device=ds.V.device)
        self._reduce(ds, None, None, packet, False)
        return self._packet_fields(packet.cpu().numpy())

    def _cycle_out(self, state: FactorizationState, pk) -> IRAMCycleOut:
        ncv = self.cfg.ncv
        z = np.zeros(ncv)
        if pk is None:
            # no cycle ended, or a failed restart vector (-9999 as on the
            # host loop, SRC/dsaup2.f:434-443)
            return IRAMCycleOut(state, state.info != 0, 0, z, z,
                                -9999 if state.info > 0 else state.info)
        if not pk[P_DONE]:
            return IRAMCycleOut(state, False, int(pk[P_NCONV]), z, z, 0)
        x = P_HEAD + self._h_size()
        re, im, bounds = pk[x:x + ncv], pk[x + ncv:x + 2 * ncv], \
            pk[x + 2 * ncv:x + 3 * ncv]
        if self.cfg.symmetric:
            ritz = re.copy()
        else:
            ritz = np.empty(ncv, np.complex128)
            ritz.real, ritz.imag = re, im
        return IRAMCycleOut(state, True, int(pk[P_NCONV]), ritz,
                            bounds.copy(), int(pk[x + 3 * ncv]))
