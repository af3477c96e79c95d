"""The restart loops the cycle drivers share: the output of the iteration
phase (``IRAMResult``), the host loop (``HostLoopSolver``), and the loop
on the operator's device (``DeviceLoopSolver``, ``_DeviceLoop``), which
the symmetric (``core/device_sym``), real non-symmetric
(``core/device_realnonsym``) and hybrid (``core/iram``) drivers run with
their own reduce steps.  ``CapturedGraph``: one CUDA graph with the kernel
launches and collectives its capture counted, added again on every
replay (the device loop's per start ``k``, the block Lanczos cycle's),
and those of its inner solves' while loops, read back after a sync.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..ops import (cuda_cgs, cuda_dia, cuda_krylov_loop, cuda_psell,
                   cuda_rot, cuda_sel)
from ..ops.cuda_sym_cycle import P_BRK, P_DONE, P_FORCE, P_INFO, P_NEV
from ..parallel.sharding import check_solver, mesh_operator
from ..utils import dtypes as _dt
from ..utils.debug import debug
from ..utils.stats import SolverStats, Timers
from .arnoldi import (FactorizationState, kev_rows, make_bnorm, make_init,
                      restart_update)

#: the kernel wrappers whose launches a captured graph holds: on each
#: replay the solver adds the launches its capture counted (those of a
#: while loop's body when its log is read, times its iterations)
GRAPH_KERNELS = (cuda_sel.sel_proj, cuda_sel.sel_update,
                 cuda_cgs.cgs_proj, cuda_cgs.cgs_update,
                 cuda_rot.rotate_rows, cuda_dia.dia_matvec,
                 cuda_dia.dia_matvec_sub, cuda_dia.dia_block_matvec,
                 cuda_psell.psell_matvec, cuda_krylov_loop.krylov_test,
                 *cuda_krylov_loop.UPDATES)


class CapturedGraph:
    """``fn()`` captured once as a CUDA graph on the current stream (which
    must not be the default one), in the memory pool ``pool``.  A kernel
    wrapper counts its launch when the capture records it, and a mesh its
    collectives; the capture's counts are taken back and added again on
    every :meth:`replay`, so they stay counts of real launches.  The
    inner solves' WHILE nodes (``ops/cuda_krylov_loop.run_while``) run
    their bodies a number of times the device decides: a replay marks
    their solvers pending, and ``cuda_krylov_loop.settle_pending``, after
    a synchronisation, reads their iterations and adds their bodies'
    launches.  ``out``: what ``fn`` returned, tensors the replays write.
    A capture that fails raises."""

    def __init__(self, fn, pool, mesh=None):
        before = [f.launches for f in GRAPH_KERNELS]
        c0 = None if mesh is None else mesh.snapshot()
        self.graph = torch.cuda.CUDAGraph()
        with cuda_krylov_loop.capture_scope() as self.solves:
            self.graph.capture_begin(pool=pool)
            try:
                self.out = fn()
            finally:
                try:
                    self.graph.capture_end()
                except Exception:
                    _stop_routing(pool)
                    raise
        self.delta = [f.launches - b for f, b in zip(GRAPH_KERNELS, before)]
        for f, d in zip(GRAPH_KERNELS, self.delta):
            f.launches -= d
        self.mesh, self.coll = mesh, None
        if mesh is not None:
            self.coll = mesh.snapshot()
            self.coll.subtract(c0)
            mesh.counts.subtract(self.coll)

    def replay(self):
        self.graph.replay()
        for f, d in zip(GRAPH_KERNELS, self.delta):
            f.launches += d
        if self.coll is not None:
            self.mesh.counts.update(self.coll)
        cuda_krylov_loop.pend(self.solves)
        return self.out

    def launches(self) -> dict:
        """Each kernel's launches per replay (those it launches), those
        of while-loop bodies left out."""
        return {f.__name__: d for f, d in zip(GRAPH_KERNELS, self.delta)
                if d}


def _stop_routing(pool) -> None:
    """After a failed ``capture_end``: torch ends the capture before it
    stops routing allocations to the graph's pool, so a failed end leaves
    the allocator believing a capture is under way, and every later pool
    it frees (a ``torch.cuda.MemPool`` going away) then aborts the
    process.  Stop the routing to ``pool`` (a no-op where torch did)."""
    try:
        torch._C._cuda_endAllocateToPool(torch.cuda.current_device(), pool)
    except RuntimeError:
        pass


@dataclasses.dataclass
class IRAMResult:
    """Output of the iteration phase (input to extraction, cf. dseupd)."""

    ritz: np.ndarray        # (ncv,) exit-ordered Ritz values (conv. first)
    bounds: np.ndarray      # (ncv,) matching Ritz estimates
    nconv: int              # iparam(5)
    info: int               # dsaupd info code (0, 1=maxiter, 2=no shifts,
    #                         <0 errors; SRC/dsaupd.f:247-276)
    n_iter: int             # iparam(3)
    state: FactorizationState
    stats: SolverStats


class HostLoopSolver:
    """The restart loop of a cycle driver, on the host: the start vector
    (dgetv0), ``tail(head(state), is_last)`` until the exit test fires,
    ``max_iter`` cycles have run or the state records an error, then the
    result.  A driver gives the builders of ``head`` and ``tail``, the
    loop's output before its first cycle (:meth:`_start`) and the exit
    ordering and info code (:meth:`_exit`).  ``mesh``: the row mesh of a
    distributed solve (``parallel/sharding``); the operator is lifted onto
    it unless it was built for it."""

    def __init__(self, op, cfg, make_head, make_tail, mesh=None):
        op = mesh_operator(op, mesh)
        check_solver(op, cfg)
        self.op, self.cfg, self.mesh = op, cfg, op.mesh
        self._c0 = None     # the mesh's counters when a solve began
        self._init = make_init(op, cfg)
        self._head = make_head(op, cfg)
        self._tail = make_tail(op, cfg)

    def _start(self, state: FactorizationState):
        raise NotImplementedError

    def _exit(self, out):
        """``(ritz, bounds, info)`` of the last cycle's output ``out``."""
        raise NotImplementedError

    def init_state(self, gen: Optional[torch.Generator] = None, v0=None
                   ) -> FactorizationState:
        if v0 is None:
            return self._init(gen, None)
        v0 = np.asarray(v0)
        if self.op.perm is not None and v0.shape[0] == self.cfg.n:
            v0 = v0[np.asarray(self.op.perm)]
        if v0.shape[0] == self.cfg.n and self.cfg.n_pad != self.cfg.n:
            v0p = np.zeros((self.cfg.n_pad,), v0.dtype)
            v0p[: self.cfg.n] = v0
            v0 = v0p
        return self._init(gen, v0.astype(self.cfg.dtype))

    def solve(self, gen: Optional[torch.Generator] = None, v0=None,
              state: Optional[FactorizationState] = None) -> IRAMResult:
        cfg = self.cfg
        ncv = cfg.ncv
        dev = self.op.device
        timers = Timers()
        self._c0 = None if self.mesh is None else self.mesh.snapshot()
        with timers.timed("taupd", dev):
            if state is None:
                with timers.timed("tgetv0", dev):
                    state = self.init_state(gen=gen, v0=v0)
            if state.info < 0:
                z = np.zeros(ncv)
                return self._result(state, z, z, 0, state.info, 0, timers)
            out = self._start(state)
            while (not out.done and out.state.iter < cfg.max_iter
                   and out.state.info == 0):
                is_last = out.state.iter + 1 >= cfg.max_iter
                with timers.timed("taitr", dev):
                    h = self._head(out.state)
                with timers.timed("tapps", dev):
                    out = self._tail(h, is_last)
        state = out.state
        it, info = self._n_iter(out), state.info
        if info != 0:
            z = np.zeros(ncv)
            return self._result(state, z, z, 0,
                                -9999 if info > 0 else info, it, timers)
        ritz, bounds, info = self._exit(out)
        return self._result(state, ritz, bounds, out.nconv, info, it, timers)

    def _n_iter(self, out) -> int:
        """The cycles run (iparam(3)) when the loop handed back ``out``."""
        return out.state.iter

    def _result(self, state, ritz, bounds, nconv, info, n_iter, timers
                ) -> IRAMResult:
        stats = SolverStats(n_iter=n_iter, n_conv=nconv, timers=timers)
        stats.absorb_counts(state.counts)
        if self._c0 is not None:
            c = self.mesh.snapshot()
            c.subtract(self._c0)
            stats.collectives = dict(c)
        return IRAMResult(ritz=ritz, bounds=bounds, nconv=nconv, info=info,
                          n_iter=n_iter, state=state, stats=stats)


class DeviceLoopSolver(HostLoopSolver):
    """A cycle driver whose restart loop runs on the operator's device
    (:class:`_DeviceLoop`) where its extension is read-free and the driver
    does not ask for the host loop (``_host_loop``).  The driver gives the
    loop its reduce step: the packet's size (:meth:`_packet_size`), the
    reduce step's device part (:meth:`_reduce`: the reduced-space kernel's
    launch, or the gather of what the host reduces), its host part
    (:meth:`_host_step`, on the packet read; none for a kernel), the
    restart matrix's dtype (:meth:`_q_dtype`), the factorization's host
    fields from a packet or from one read of the device buffers
    (:meth:`_packet_fields`, :meth:`_read_fields`), the cycle output
    (:meth:`_cycle_out`) and the per-cycle trace (:meth:`_trace_packet`);
    its exit is :meth:`_exit`, as on the host loop.  The rest of the loop
    is shared: the deferred restart (``arnoldi.restart_update``: the
    kev-row rotation by ``csrc/rot.cu`` or, for a complex Q, a GEMM, the
    residual update from ``sk``, the B-norm), the CUDA graph per start
    ``k`` on a capturable operator, the first cycle run eagerly, the host's
    rerun after a breakdown or a failed refinement (``Extension.recover``,
    then the reduce step again) and the mesh's collectives.

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
    #: whether the state an exit hands back counts the exit's cycle in
    #: ``iter`` (the fused drivers), or keeps the cycles before it (the
    #: hybrid, as the reference's ``IRAMSolver``: see ``_n_iter``)
    _exit_counts = True

    def _packet_size(self) -> int:
        raise NotImplementedError

    def _reduce(self, ds, Q, sk, packet, is_last: bool) -> None:
        raise NotImplementedError

    def _host_step(self, loop, pk, is_last: bool, it: int):
        """The reduce step's host part on the packet ``pk`` just read, in
        cycle ``it + 1``: the packet the loop goes on with.  A driver that
        reduces on the host computes the restart here and hands ``Q``,
        ``sk`` and the restarted projected matrix to ``loop.stage``."""
        return pk

    def _q_dtype(self) -> torch.dtype:
        """The dtype of the restart's Q and ``sk`` on the device."""
        return _dt.torch_dtype(_dt.real_dtype(self.cfg.dtype))

    def _packet_fields(self, pk):
        """``(H, rnorm, counters)`` of the factorization from a packet."""
        raise NotImplementedError

    def _read_fields(self, ds):
        """``(H, rnorm, counters)`` from one read of the device buffers."""
        raise NotImplementedError

    def _cycle_out(self, state: FactorizationState, pk):
        """The cycle output with ``state``; ``pk`` None before any cycle
        ended (no Ritz values) or after a failed restart vector."""
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
        z = np.zeros(self.cfg.ncv)
        if state.info != 0:
            # as the host loop: no cycle runs from a state with an error
            return self._result(state, z, z, 0, -9999 if state.info > 0
                                else state.info,
                                state.iter if state.info > 0 else 0, timers)
        loop = _DeviceLoop(self, state)
        out = loop.run()
        timers.taupd = time.perf_counter() - t0
        timers.taitr, timers.tapps = loop.times()
        state = out.state
        if state.info != 0:
            res = self._result(state, z, z, 0, -9999 if state.info > 0
                               else state.info, self._n_iter(out), timers)
        else:
            ritz, bounds, info = self._exit(out)
            res = self._result(state, ritz, bounds, out.nconv, info,
                               self._n_iter(out), timers)
        loop.record(res.stats)
        if debug.maupd > 0:
            print(res.stats.summary())
        return res


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
        qdt = solver._q_dtype()
        self.is_g = op.bmat == "G"
        self.bnorm = make_bnorm(op, cfg)
        self.ds = self.ext.load(state)
        self.Q = torch.zeros((ncv, ncv), dtype=qdt, device=dev)
        self.sk = torch.zeros(2, dtype=qdt, device=dev)
        self.packet = torch.zeros(solver._packet_size(), dtype=torch.float64,
                                  device=dev)
        self.mesh = op.mesh
        # a mesh's collectives are captured where its transport allows
        self.capture = self.cuda and op.capturable and (
            self.mesh is None or self.mesh.capturable)
        self.graphs = {}          # k -> CapturedGraph
        self.replays = 0
        self.packets = 0
        self.events = []
        self.pinned = {}          # device buffer -> its pinned staging
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
        ds = self.ds
        resid, b_resid, rnorm, rows = restart_update(
            self.op, self.bnorm, ds.V, ds.resid, self.Q, self.sk[0],
            self.sk[1], k)
        ds.resid.copy_(resid)
        if self.is_g:
            ds.b_resid.copy_(b_resid)
        ds.rnorm.copy_(rnorm)
        return rows

    def _cycle_body(self, k: int) -> None:
        self._prefix(k)
        self.ext.run(self.ds, k, self.ncv)

    def _replay(self, k: int) -> None:
        """The cycle's rotation and extension from ``k`` as a CUDA graph,
        captured on first use (:class:`CapturedGraph`)."""
        g = self.graphs.get(k)
        if g is None:
            g = self.graphs[k] = CapturedGraph(lambda: self._cycle_body(k),
                                               self.pool, self.mesh)
        g.replay()
        self.replays += 1

    def stage(self, dst: torch.Tensor, arr) -> None:
        """The host array ``arr`` into the device buffer ``dst``, in place:
        on a card through a pinned copy of it, on the loop's stream,
        ahead of the next replay (the pinned buffer is written again only
        after the next packet's read, which waits for the copy)."""
        src = torch.from_numpy(np.ascontiguousarray(arr)).reshape(dst.shape)
        if not self.cuda:
            dst.copy_(src)
            return
        pin = self.pinned.get(dst)
        if pin is None:
            pin = self.pinned[dst] = torch.empty(dst.shape, dtype=dst.dtype,
                                                 pin_memory=True)
        pin.copy_(src)
        dst.copy_(pin, non_blocking=True)

    def _reduce(self, is_last: bool, it: int):
        """The cycle's reduce step: its device part and packet, read once,
        then its host part."""
        self.packets += 1
        self.solver._reduce(self.ds, self.Q, self.sk, self.packet, is_last)
        if not self.cuda:
            pk = self.packet.numpy().copy()
        else:
            self.pk_host.copy_(self.packet, non_blocking=True)
            self.done_evt.record()
            self.done_evt.synchronize()
            pk = self.pk_host.numpy().copy()
            cuda_krylov_loop.settle_pending()
        return self.solver._host_step(self, pk, is_last, it)

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
            pk, dt = self._timed(self._reduce, is_last, it)
            self.t_red += dt or 0.0
            brk = int(pk[P_BRK])
            if brk != -1:
                counts, info, k = ext.recover(self.ds, brk, k0, ncv, st.gen,
                                              counts, info, int(pk[P_FORCE]))
                if info != 0:
                    it += 1
                    break
                pk = self._reduce(is_last, it)
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
        # every exit of a loop that ran a cycle is one of the breaks above
        if pk is not None and not self.solver._exit_counts:
            it -= 1
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
        stats.replay_launches = {k: g.launches()
                                 for k, g in sorted(self.graphs.items())}
