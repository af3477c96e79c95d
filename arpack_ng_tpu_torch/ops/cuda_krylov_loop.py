"""The inner Krylov solves as CUDA-graph while loops (port of the
reference's ``lax.while_loop`` around ``cg`` and ``bicgstab``,
``arpack_ng_tpu/ops/solvers.py:58-60, 74, 90-92, 110``; kernel and capture
helpers in ``csrc/krylov_loop.cu``).

:func:`run_while` runs one solve's loop, ``while test(): body()``, where
the test is the reference's (``it < maxiter`` and ``|r.r| > atol2``,
before every iteration):

* on a CUDA stream that is capturing a graph, as one conditional WHILE
  node: the test kernel (:func:`krylov_test`) sets the node's condition
  once before the node and once at the end of the body, which the helpers
  capture into the node's body graph on a stream of their own
  (:func:`body_stream`), its allocations routed to a memory pool that the
  caller keeps as long as the graph (a ``torch.cuda.MemPool`` made outside
  any capture: torch's allocator may not free a pool while a capture is
  under way).  No host read per iteration or per solve;
* on CPU tensors, as a Python loop over the same body and the test
  kernel's plain twin (:func:`krylov_test_plain`): the CPU form of the
  node, which the tests hold against the host loop bit for bit.

A CUDA tensor outside a capture raises: there the solver runs its host
loop (``ops/solvers._cg``, ``_bicgstab``), the plain version.

Each solve's iteration count goes to an :class:`IterationLog`, in mapped
host memory on a card, which the test kernel appends to when it ends a
loop and the host reads after a synchronisation it makes anyway (the
device loop's packet, or the solve's ``iterations``).  A graph adds the
kernel launches its capture counted on every replay
(``core/loop.CapturedGraph``); a body's run once per iteration, so
:func:`run_while` takes the body's launches out of the capture's count
and the log adds them back, times the iterations, when it is read.

Needs CUDA 12.4 or later, runtime and driver (:func:`require`).
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, Optional

import numpy as np
import torch

from . import cuda_lib

#: the CUDA version conditional nodes need here (runtime and driver)
MIN_CUDA = 12040
#: solves one log holds between two reads
LOG_CAP = 4096

_bound = False
_streams = {}               # device index -> body stream
_scopes = []                # solvers of the open captures, innermost last
_unfreed = []               # logs dropped during a capture, freed later
_pending = []               # solvers whose logs may hold unread counts


def _bind(lib) -> None:
    global _bound
    if _bound:
        return
    vp, i32, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    lib.atpt_krylov_versions.argtypes = [ctypes.POINTER(i32)] * 3
    lib.atpt_krylov_versions.restype = i32
    lib.atpt_krylov_test.argtypes = [i32, u64, i32, vp, vp, vp, i32, i32, vp,
                                     i32, vp, vp, i32, i32, vp, vp]
    lib.atpt_krylov_test.restype = i32
    lib.atpt_krylov_log_alloc.argtypes = [ctypes.c_longlong,
                                          ctypes.POINTER(vp),
                                          ctypes.POINTER(vp)]
    lib.atpt_krylov_log_alloc.restype = i32
    lib.atpt_krylov_log_free.argtypes = [vp]
    lib.atpt_krylov_log_free.restype = i32
    lib.atpt_while_handle.argtypes = [vp, ctypes.POINTER(u64)]
    lib.atpt_while_handle.restype = i32
    lib.atpt_while_open.argtypes = [vp, vp, u64]
    lib.atpt_while_open.restype = i32
    lib.atpt_while_close.argtypes = [vp]
    lib.atpt_while_close.restype = i32
    _bound = True


def _lib():
    lib = cuda_lib.load()
    _bind(lib)
    return lib


def versions() -> dict:
    """The CUDA versions the loops depend on: the toolkit the kernels were
    built with, the runtime and the driver (``12040`` is 12.4)."""
    lib = _lib()
    v = [ctypes.c_int() for _ in range(3)]
    cuda_lib.check(lib, lib.atpt_krylov_versions(*map(ctypes.byref, v)),
                   "krylov_versions")
    return dict(zip(("built", "runtime", "driver"), (x.value for x in v)))


def require(device: torch.device) -> None:
    """Raise unless graphs on ``device`` can hold conditional WHILE nodes
    (CUDA 12.4 or later in the build, the runtime and the driver); an
    operator declared capturable checks this when it is built."""
    if device.type != "cuda":
        raise ValueError(f"no while-node graphs on {device}")
    v = versions()
    if min(v.values()) < MIN_CUDA:
        raise RuntimeError(
            f"CUDA-graph while loops need CUDA {MIN_CUDA // 1000}."
            f"{MIN_CUDA % 1000 // 10} or later (build, runtime and driver), "
            f"found {v}: declare the operator capturable=False")


class IterationLog:
    """The iteration counts of one solver's loops.  ``array``: ``[count,
    (node, iterations) * cap]`` int32, in mapped host memory on a card
    (``ptr`` its device address) and in plain host memory for the CPU
    form.  Each node (one captured loop) has the body's kernel launches per iteration,
    which :meth:`drain` adds to the wrappers' counts times the
    iterations."""

    def __init__(self, device: torch.device, cap: int = LOG_CAP):
        self.device, self.cap = device, cap
        self.nodes = []             # per node: launches per iteration
        self._host = None
        ints = 1 + 2 * cap
        if device.type == "cuda":
            lib = _lib()
            while _unfreed and lib.atpt_krylov_log_free(_unfreed[-1]) == 0:
                _unfreed.pop()
            host, dev = ctypes.c_void_p(), ctypes.c_void_p()
            cuda_lib.check(lib, lib.atpt_krylov_log_alloc(
                ints, ctypes.byref(host), ctypes.byref(dev)),
                "krylov_log_alloc")
            self._host = host.value
            self._free = lib.atpt_krylov_log_free
            self.ptr = dev.value
            self.array = np.ctypeslib.as_array(
                ctypes.cast(host, ctypes.POINTER(ctypes.c_int32)),
                shape=(ints,))
        else:
            self.ptr = 0
            self.array = np.zeros(ints, np.int32)

    def __del__(self):
        if self._host is not None and self._free(self._host) != 0:
            _unfreed.append(self._host)
        self._host = None

    def add_node(self, delta) -> int:
        self.nodes.append(list(delta))
        return len(self.nodes) - 1

    def drain(self) -> list:
        """The iteration counts of the loops that ended since the last
        read, in the order they ran.  The caller has synchronised with the
        device since those loops ran."""
        from ..core.loop import GRAPH_KERNELS

        a = self.array
        count = int(a[0])
        if count > self.cap:
            raise RuntimeError(f"{count} solves since the iteration log was "
                               f"last read, past its {self.cap} entries")
        pairs = a[1:1 + 2 * count].reshape(count, 2).tolist()
        a[0] = 0
        out = []
        for node, its in pairs:
            for f, d in zip(GRAPH_KERNELS, self.nodes[node]):
                f.launches += d * its
            out.append(its)
        return out


def krylov_test_plain(rr, atol2, it, maxiter: int, bump: int, rho=None,
                      brk=None, log: Optional[IterationLog] = None,
                      node: int = 0) -> bool:
    """Plain twin of :func:`krylov_test` on CPU tensors: the decision."""
    i = int(it) + bump
    it.fill_(i)
    go = i < maxiter and bool(rr > atol2)
    if rho is not None:
        brk.fill_(bool(rho == 0))
    if not go and log is not None:
        a, c = log.array, int(log.array[0])
        if c < log.cap:
            a[1 + 2 * c:3 + 2 * c] = (node, i)
        a[0] = c + 1
    return go


def krylov_test(rr: torch.Tensor, atol2: torch.Tensor, it: torch.Tensor,
                maxiter: int, *, bump: int, handle: int = 0, rho=None,
                brk=None, log: Optional[IterationLog] = None, node: int = 0,
                go: Optional[torch.Tensor] = None):
    """The loop test ``it' < maxiter and rr > atol2`` with ``it' = it +
    bump`` written back to ``it``: ``rr`` (``|r.r|``) and ``atol2`` 0-d
    float32 or float64, ``it`` 0-d int32; with ``rho`` (0-d, real or
    complex of that precision) also ``brk = (rho == 0)``, 0-d bool; a loop
    that ends appends ``(node, it')`` to ``log``.  On a card the kernel
    gives the decision to the WHILE node ``handle`` (0: none) and, with
    ``go`` (0-d int32), writes it there; returns None.  On CPU tensors the
    plain twin returns it."""
    real = (torch.float32, torch.float64)
    if rr.shape != () or atol2.shape != () or rr.dtype not in real \
            or atol2.dtype != rr.dtype:
        raise ValueError("rr and atol2 must be 0-d float32/float64 of one "
                         "dtype")
    if it.shape != () or it.dtype != torch.int32:
        raise ValueError("it must be a 0-d int32 tensor")
    parts = 1
    if rho is not None:
        if rho.shape != () or brk is None or brk.shape != () \
                or brk.dtype != torch.bool \
                or torch.empty((), dtype=rho.dtype).real.dtype != rr.dtype:
            raise ValueError("rho must be 0-d of rr's precision, with a 0-d "
                             "bool brk")
        parts = 2 if rho.is_complex() else 1
    tensors = [t for t in (rr, atol2, it, rho, brk, go) if t is not None]
    if any(t.device != rr.device for t in tensors):
        raise ValueError("the test's tensors must share one device")
    if rr.device.type == "cpu":
        out = krylov_test_plain(rr, atol2, it, maxiter, bump, rho, brk, log,
                                node)
        if go is not None:
            go.fill_(int(out))
        return out
    if rr.device.type != "cuda":
        raise ValueError(f"no kernel for device {rr.device}")
    if go is not None and (go.shape != () or go.dtype != torch.int32):
        raise ValueError("go must be a 0-d int32 tensor")
    lib = _lib()
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = lib.atpt_krylov_test(
        cuda_lib.dtype_code(rr.dtype, rr.dtype), handle, int(handle != 0),
        rr.data_ptr(), atol2.data_ptr(), it.data_ptr(), maxiter, bump,
        ptr(rho), parts, ptr(brk), log.ptr if log is not None else None,
        log.cap if log is not None else 0, node, ptr(go),
        cuda_lib.stream_handle(rr.device))
    cuda_lib.check(lib, err, "krylov_test")
    krylov_test.launches += 1
    return None


krylov_test.launches = 0


def body_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream the bodies on ``device`` are captured on, made once,
    outside any capture; its cuBLAS workspace is made then too, so that no
    capture allocates it."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    s = _streams.get(idx)
    if s is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the body stream is made outside a capture: "
                               "bind the solve (or call body_stream) first")
        s = torch.cuda.Stream(device=idx)
        with torch.cuda.stream(s):
            one = torch.ones(1, dtype=torch.float64, device=device)
            torch.vdot(one, one)
        s.synchronize()
        _streams[idx] = s
    return s


def _add(solves, to) -> None:
    for solve in solves:
        if all(s is not solve for s in to):
            to.append(solve)


def note(solve) -> None:
    """Record in the open scope that ``solve`` (with a ``settle()``) put
    a loop into the graph being captured."""
    if _scopes:
        _add([solve], _scopes[-1])


def pend(solves) -> None:
    """A graph holding loops of ``solves`` was replayed: read their logs
    at the next :func:`settle_pending`."""
    _add(solves, _pending)


def settle_pending() -> None:
    """After a synchronisation with the replays: every pending solver's
    counts read from its log (``settle()``), and its body launches
    added."""
    while _pending:
        _pending.pop(0).settle()


@contextlib.contextmanager
def capture_scope():
    """Open around a graph's capture (``core/loop.CapturedGraph``): the
    loops captured inside :func:`note` their solvers in the list it
    yields, whose logs the graph's replays write."""
    scope = []
    _scopes.append(scope)
    try:
        yield scope
    finally:
        _scopes.pop()


def run_while(rr: torch.Tensor, atol2: torch.Tensor, it: torch.Tensor,
              maxiter: int, body: Callable[[], torch.Tensor], *,
              log: IterationLog, pool=None, rho=None, brk=None) -> None:
    """``while test(rr): rr = body()`` for one solve (see the module
    docstring): ``rr`` the test's ``|r.r|`` before the first iteration,
    ``body`` one iteration, updating the loop's state in place and
    returning the new ``|r.r|``; ``rho``/``brk`` BiCGSTAB's (read after
    each test, by the next iteration).  The count goes to ``log``.  On a
    card, ``pool``: the ``torch.cuda.MemPool`` the body allocates from,
    kept by the caller as long as the graph (graphs that share it must
    replay one after another, as the device loop's do)."""
    if rr.device.type == "cpu":
        if not log.nodes:
            log.add_node([])        # node 0: no kernel launches
        go = krylov_test(rr, atol2, it, maxiter, bump=0, rho=rho, brk=brk,
                         log=log)
        while go:
            go = krylov_test(body(), atol2, it, maxiter, bump=1, rho=rho,
                             brk=brk, log=log)
        return
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("run_while on a card runs inside a graph capture "
                           "(the host loop is the solver's plain version)")
    if pool is None:
        raise ValueError("a loop on a card needs the pool its body "
                         "allocates from")
    from ..core.loop import GRAPH_KERNELS

    lib = _lib()
    dev = rr.device
    outer = cuda_lib.stream_handle(dev)
    side = body_stream(dev)
    h = ctypes.c_ulonglong()
    cuda_lib.check(lib, lib.atpt_while_handle(outer, ctypes.byref(h)),
                   "while_handle")
    node = len(log.nodes)
    krylov_test(rr, atol2, it, maxiter, bump=0, handle=h.value, rho=rho,
                brk=brk, log=log, node=node)
    pre = [f.launches for f in GRAPH_KERNELS]
    cuda_lib.check(lib, lib.atpt_while_open(outer, side.cuda_stream, h.value),
                   "while_open")
    try:
        with torch.cuda.stream(side), torch.cuda.use_mem_pool(pool, dev):
            krylov_test(body(), atol2, it, maxiter, bump=1, handle=h.value,
                        rho=rho, brk=brk, log=log, node=node)
    finally:
        err = lib.atpt_while_close(side.cuda_stream)
    cuda_lib.check(lib, err, "while_close")
    delta = [f.launches - p for f, p in zip(GRAPH_KERNELS, pre)]
    for f, d in zip(GRAPH_KERNELS, delta):
        f.launches -= d
    log.add_node(delta)
