"""The inner Krylov solves as CUDA-graph while loops (port of the
reference's ``lax.while_loop`` around ``cg`` and ``bicgstab``,
``arpack_ng_tpu/ops/solvers.py:58-60, 74, 90-92, 110``; kernels and capture
helpers in ``csrc/krylov_loop.cu``).

:func:`run_while` runs one solve's loop, ``while test(): body()``, where
the test is the reference's (``it < maxiter`` and ``|r.r| > atol2``,
before every iteration):

* on a CUDA stream that is capturing a graph, as one conditional WHILE
  node: the test kernel (:func:`krylov_test`) sets the node's condition
  once before the node, and the body's last kernel, one of the fused
  update kernels below, at the end of each iteration; the helpers capture
  the body into the node's body graph on a stream of their own
  (:func:`body_stream`), its allocations routed to a memory pool that the
  caller keeps as long as the graph (a ``torch.cuda.MemPool`` made outside
  any capture: torch's allocator may not free a pool while a capture is
  under way).  No host read per iteration or per solve;
* on CPU tensors, as a Python loop over the same body, the kernels' plain
  twins deciding: the CPU form of the node, which the tests hold against
  the host loop bit for bit.

A CUDA tensor outside a capture raises: there the solver runs its host
loop (``ops/solvers._cg``, ``_bicgstab``), which reads each decision back.

The fused update kernels (row 14 of ``PERF.md``'s kernel table since its
redesign) are the vector passes of an iteration between its dot products,
each updating the loop's buffers in place and rounding as the torch ops
it replaces (its plain twin, ``*_plain``, is those ops):
:func:`cg_xr` and :func:`cg_p_test` for CG, :func:`bicg_p`,
:func:`bicg_s`, :func:`bicg_r` and :func:`bicg_x_test` for BiCGSTAB.  A
``*_test`` kernel ends the iteration with the loop test (a
:class:`LoopTest`).  They take float32, float64, complex64 and complex128
tensors; a CUDA tensor of another dtype raises.

Each solve's iteration count goes to an :class:`IterationLog`, in mapped
host memory on a card, which the test appends to when it ends a loop and
the host reads after a synchronisation it makes anyway (the device loop's
packet, or the solve's ``iterations``).  A graph adds the kernel launches
its capture counted on every replay (``core/loop.CapturedGraph``); a body
runs once per iteration, so :func:`run_while` takes the body's launches
out of the capture's count and the log adds them back, times the
iterations, when it is read.

Needs CUDA 12.4 or later, runtime and driver (:func:`require`).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
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


class LoopTestArgs(ctypes.Structure):
    """``atpt::LoopTestArgs`` of ``csrc/krylov_loop.cu``, field for field."""
    _fields_ = [("handle", ctypes.c_ulonglong), ("set_cond", ctypes.c_int),
                ("maxiter", ctypes.c_int), ("atol2", ctypes.c_void_p),
                ("it", ctypes.c_void_p), ("log", ctypes.c_void_p),
                ("cap", ctypes.c_int), ("node", ctypes.c_int),
                ("go", ctypes.c_void_p)]


def _bind(lib) -> None:
    global _bound
    if _bound:
        return
    vp, i32, u64, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong,
                         ctypes.c_longlong)
    args = ctypes.POINTER(LoopTestArgs)
    lib.atpt_krylov_versions.argtypes = [ctypes.POINTER(i32)] * 3
    lib.atpt_krylov_versions.restype = i32
    lib.atpt_krylov_test.argtypes = [i32, args, vp, i32, vp, i32, vp, vp]
    lib.atpt_krylov_test.restype = i32
    for name, n_ptr, test in (("cg_xr", 7, False), ("cg_p_test", 6, True),
                              ("bicg_p", 8, False), ("bicg_s", 8, False),
                              ("bicg_r", 6, False),
                              ("bicg_x_test", 10, True)):
        fn = getattr(lib, f"atpt_{name}")
        fn.argtypes = [i32, i64] + [vp] * n_ptr + ([args] if test else []) \
            + [vp]
        fn.restype = i32
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


@dataclasses.dataclass
class LoopTest:
    """The loop test one iteration ends with (a ``*_test`` update kernel):
    ``atol2`` 0-d of the problem's real dtype, ``it`` the 0-d int32
    iteration counter, which the test bumps; ``log``/``node``: where a loop
    that ends appends its count; ``handle``: the WHILE node the decision
    goes to (0: none); ``go``: a 0-d int32 the decision is written to (the
    host loop on a card reads it)."""
    atol2: torch.Tensor
    it: torch.Tensor
    maxiter: int
    log: Optional["IterationLog"] = None
    node: int = 0
    handle: int = 0
    go: Optional[torch.Tensor] = None

    def args(self) -> LoopTestArgs:
        ptr = (lambda t: None if t is None else t.data_ptr())
        log = self.log
        return LoopTestArgs(self.handle, int(self.handle != 0),
                            self.maxiter, self.atol2.data_ptr(),
                            self.it.data_ptr(),
                            log.ptr if log is not None else None,
                            log.cap if log is not None else 0, self.node,
                            ptr(self.go))


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


def _test_plain(rr, test: LoopTest) -> bool:
    """The end-of-body test of a ``*_test`` kernel's twin: ``|rr|`` (the
    raw dot, torch's ``abs``) against ``test``, the counter bumped."""
    go = krylov_test_plain(torch.abs(rr), test.atol2, test.it, test.maxiter,
                           1, log=test.log, node=test.node)
    if test.go is not None:
        test.go.fill_(int(go))
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
    plain twin returns it.  The loop runs it once, before the node; each
    iteration's test is its last update kernel's."""
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
    args = LoopTest(atol2, it, maxiter, log, node, handle, go).args()
    err = lib.atpt_krylov_test(
        cuda_lib.dtype_code(rr.dtype, rr.dtype), ctypes.byref(args),
        rr.data_ptr(), bump, None if rho is None else rho.data_ptr(), parts,
        None if brk is None else brk.data_ptr(),
        cuda_lib.stream_handle(rr.device))
    cuda_lib.check(lib, err, "krylov_test")
    krylov_test.launches += 1
    return None


krylov_test.launches = 0

#: the update kernels' dtype codes (``ATPT_UPDATE_DISPATCH``)
UPDATE_CODES = {torch.float32: 0, torch.float64: 2, torch.complex64: 3,
                torch.complex128: 4}


def _checked(name, vectors, scalars, test=None, rr=None):
    """The update kernels' checks: ``vectors`` contiguous 1-d of one length
    and dtype, ``scalars`` 0-d of that dtype, one device; with ``test``,
    ``rr`` 0-d of the dtype and the test's tensors on that device.
    Returns ``(device, code or None, n)``: no code on the CPU."""
    v0 = vectors[0]
    dt, dev, n = v0.dtype, v0.device, v0.shape[0] if v0.dim() == 1 else -1
    for v in vectors:
        if v.dim() != 1 or v.shape[0] != n or v.dtype != dt \
                or not v.is_contiguous():
            raise ValueError(f"{name}: vectors must be contiguous 1-d "
                             f"{dt} of one length")
    for s in scalars + ([rr] if test is not None else []):
        if s is None or s.shape != () or s.dtype != dt:
            raise ValueError(f"{name}: scalars must be 0-d {dt}")
    if test is not None:
        rdt = torch.empty((), dtype=dt).real.dtype
        if test.atol2.shape != () or test.atol2.dtype != rdt \
                or test.it.shape != () or test.it.dtype != torch.int32:
            raise ValueError(f"{name}: the test takes a 0-d {rdt} atol2 and "
                             "a 0-d int32 counter")
        if test.go is not None and (test.go.shape != ()
                                    or test.go.dtype != torch.int32):
            raise ValueError(f"{name}: go must be a 0-d int32 tensor")
    tensors = vectors + scalars
    if test is not None:
        tensors += [t for t in (rr, test.atol2, test.it, test.go)
                    if t is not None]
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: the tensors must share one device")
    if dev.type == "cpu":
        return dev, None, n
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if dt not in UPDATE_CODES:
        raise TypeError(f"{name}: no CUDA kernel for {dt}; supported: "
                        f"{sorted(map(str, UPDATE_CODES))}")
    return dev, UPDATE_CODES[dt], n


def _launch(fn, code, n, ptrs, dev, *extra) -> None:
    """Launch ``atpt_<fn>`` on the current stream of ``dev``: ``ptrs``
    the tensors (None: a null pointer), ``extra`` the test's argument
    block where the kernel takes one."""
    lib = _lib()
    err = getattr(lib, f"atpt_{fn.__name__}")(
        code, n, *(None if t is None else t.data_ptr() for t in ptrs),
        *extra, cuda_lib.stream_handle(dev))
    cuda_lib.check(lib, err, fn.__name__)
    fn.launches += 1


def _test_arg(test: Optional[LoopTest]):
    return None if test is None else ctypes.byref(test.args())


def cg_xr_plain(rz, pap, x, r, p, ap):
    """Plain twin of :func:`cg_xr`: ``(x + alpha p, r - alpha ap)`` with
    ``alpha = rz / pap``, new tensors (``solvers.cg_step``'s torch ops)."""
    alpha = rz / pap
    return x + alpha * p, r - alpha * ap


def cg_xr_inplace_plain(rz, pap, x, r, p, ap, rz_prev) -> None:
    """:func:`cg_xr` by its twin's torch ops, in place (the CPU's path)."""
    xn, rn = cg_xr_plain(rz, pap, x, r, p, ap)
    x.copy_(xn)
    r.copy_(rn)
    rz_prev.copy_(rz)


def cg_xr(rz, pap, x, r, p, ap, rz_prev) -> None:
    """CG's first update, in place: ``alpha = rz / pap`` (``pap`` the dot
    ``p.Ap``), ``x += alpha p``, ``r -= alpha ap``, and ``rz_prev = rz``
    (:func:`cg_p_test`'s divisor: that kernel overwrites ``rz``)."""
    dev, code, n = _checked("cg_xr", [x, r, p, ap], [rz, pap, rz_prev])
    if code is None:
        cg_xr_inplace_plain(rz, pap, x, r, p, ap, rz_prev)
        return
    _launch(cg_xr, code, n, (rz, pap, x, r, p, ap, rz_prev), dev)


cg_xr.launches = 0


def cg_p_plain(rzn, rz, z, p):
    """Plain twin of :func:`cg_p_test`'s update: ``z + (rzn / rz) p``."""
    beta = rzn / rz
    return z + beta * p


def cg_p_inplace_plain(rzn, rz_prev, z, p, rz) -> None:
    """:func:`cg_p_test`'s update by its twin's torch ops, in place (the
    CPU's path, without the test)."""
    p.copy_(cg_p_plain(rzn, rz_prev, z, p))
    rz.copy_(rzn)


def cg_p_test(rzn, rz_prev, z, p, rz, *, rr=None,
              test: Optional[LoopTest] = None):
    """CG's last update, in place: ``beta = rzn / rz_prev`` (``rzn`` the
    dot ``r.z``), ``p = z + beta p``, ``rz = rzn``; with ``test``, the loop
    test on ``|rr|`` (``rr`` the dot ``r.r``).  ``z`` may be ``r`` itself.
    Returns the decision on CPU tensors (None without a test), else
    None."""
    dev, code, n = _checked("cg_p_test", [z, p], [rzn, rz_prev, rz],
                            test, rr)
    if code is None:
        cg_p_inplace_plain(rzn, rz_prev, z, p, rz)
        return None if test is None else _test_plain(rr, test)
    _launch(cg_p_test, code, n, (rzn, rz_prev, z, p, rz, rr), dev,
            _test_arg(test))
    return None


cg_p_test.launches = 0


def bicg_p_plain(brk, rho_new, rho, alpha, omega, r, p, v):
    """Plain twin of :func:`bicg_p`: the restart's selects where ``brk``,
    then ``r + beta (p - omega v)``, ``beta = (rho_new / rho) (alpha /
    omega)`` (``solvers.bicgstab_step``'s torch ops)."""
    rho, alpha, omega = (torch.where(brk, 1.0, s) for s in (rho, alpha,
                                                             omega))
    v, p = torch.where(brk, 0.0, v), torch.where(brk, 0.0, p)
    beta = (rho_new / rho) * (alpha / omega)
    return r + beta * (p - omega * v)


def bicg_p(brk, rho_new, rho, alpha, omega, r, p, v) -> None:
    """BiCGSTAB's first update, in place on ``p``: where ``brk`` (0-d
    bool: the last iteration's ``rho`` came out 0) the restart's ``rho =
    alpha = omega = 1``, ``p = v = 0``; then ``p = r + beta (p - omega
    v)``, ``beta = (rho_new / rho) (alpha / omega)``."""
    dev, code, n = _checked("bicg_p", [r, p, v],
                            [rho_new, rho, alpha, omega])
    if brk.shape != () or brk.dtype != torch.bool or brk.device != dev:
        raise ValueError("bicg_p: brk must be a 0-d bool on the vectors' "
                         "device")
    if code is None:
        p.copy_(bicg_p_plain(brk, rho_new, rho, alpha, omega, r, p, v))
        return
    _launch(bicg_p, code, n, (brk, rho_new, rho, alpha, omega, r, p, v),
            dev)


bicg_p.launches = 0


def bicg_s_plain(rho_new, rv, r, v):
    """Plain twin of :func:`bicg_s`: ``(alpha, r - alpha v)``, ``alpha =
    rho_new / rv``."""
    alpha = rho_new / rv
    return alpha, r - alpha * v


def bicg_s(rho_new, rv, r, vn, v, rho, alpha) -> torch.Tensor:
    """BiCGSTAB's second update: ``alpha = rho_new / rv`` (``rv`` the dot
    ``rhat.vn``, ``vn = A ph``), returns ``s = r - alpha vn`` (a new
    vector) and writes the state: ``v = vn``, ``alpha``, ``rho =
    rho_new``."""
    dev, code, n = _checked("bicg_s", [r, vn, v],
                            [rho_new, rv, rho, alpha])
    if code is None:
        al, s = bicg_s_plain(rho_new, rv, r, vn)
        v.copy_(vn)
        alpha.copy_(al)
        rho.copy_(rho_new)
        return s
    s = torch.empty_like(r)
    _launch(bicg_s, code, n, (rho_new, rv, r, vn, s, v, rho, alpha), dev)
    return s


bicg_s.launches = 0


def bicg_r_plain(ts, tt, s, t):
    """Plain twin of :func:`bicg_r`: ``(omega, s - omega t)``, ``omega =
    ts / tt``."""
    omega = ts / tt
    return omega, s - omega * t


def bicg_r(ts, tt, s, t, r, omega) -> None:
    """BiCGSTAB's third update, in place: ``omega = ts / tt`` (the dots
    ``t.s``, ``t.t``), ``r = s - omega t``, the state's ``omega``."""
    dev, code, n = _checked("bicg_r", [s, t, r], [ts, tt, omega])
    if code is None:
        om, rn = bicg_r_plain(ts, tt, s, t)
        r.copy_(rn)
        omega.copy_(om)
        return
    _launch(bicg_r, code, n, (ts, tt, s, t, r, omega), dev)


bicg_r.launches = 0


def bicg_x_plain(alpha, omega, x, ph, sh):
    """Plain twin of :func:`bicg_x_test`'s update: ``x + alpha ph + omega
    sh``."""
    return x + alpha * ph + omega * sh


def bicg_x_test(alpha, omega, x, ph, sh, rho, rhat, r, brk, *, rr=None,
                test: Optional[LoopTest] = None):
    """BiCGSTAB's last update, in place: ``x = x + alpha ph + omega sh``;
    ``brk = (rho == 0)`` (``rho`` this iteration's) and, where it holds,
    ``rhat = r`` (the next iteration's restart; :func:`bicg_p` takes the
    rest); with ``test``, the loop test on ``|rr|``.  Returns the decision
    on CPU tensors (None without a test), else None."""
    dev, code, n = _checked("bicg_x_test", [x, ph, sh, rhat, r],
                            [alpha, omega, rho], test, rr)
    if brk.shape != () or brk.dtype != torch.bool or brk.device != dev:
        raise ValueError("bicg_x_test: brk must be a 0-d bool on the "
                         "vectors' device")
    if code is None:
        x.copy_(bicg_x_plain(alpha, omega, x, ph, sh))
        brk.copy_(rho == 0)
        rhat.copy_(torch.where(brk, r, rhat))
        return None if test is None else _test_plain(rr, test)
    _launch(bicg_x_test, code, n,
            (alpha, omega, x, ph, sh, rho, rhat, r, brk, rr), dev,
            _test_arg(test))
    return None


bicg_x_test.launches = 0

#: the update kernels' wrappers
UPDATES = (cg_xr, cg_p_test, bicg_p, bicg_s, bicg_r, bicg_x_test)


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
              maxiter: int, body: Callable[[LoopTest], Optional[bool]], *,
              log: IterationLog, pool=None, rho=None, brk=None) -> None:
    """``while test(): body(test)`` for one solve (see the module
    docstring): ``rr`` the test's ``|r.r|`` before the first iteration,
    ``body`` one iteration, updating the loop's state in place and ending
    with a kernel that runs ``test`` (a :class:`LoopTest`: a ``*_test``
    update kernel, or :func:`krylov_test` with ``bump=1``), which returns
    the decision on CPU tensors; ``rho``/``brk`` BiCGSTAB's, for the test
    before the node.  The count goes to ``log``.  On a card, ``pool``: the
    ``torch.cuda.MemPool`` the body allocates from, kept by the caller as
    long as the graph (graphs that share it must replay one after another,
    as the device loop's do)."""
    if rr.device.type == "cpu":
        if not log.nodes:
            log.add_node([])        # node 0: no kernel launches
        go = krylov_test(rr, atol2, it, maxiter, bump=0, rho=rho, brk=brk,
                         log=log)
        test = LoopTest(atol2, it, maxiter, log)
        while go:
            go = body(test)
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
            body(LoopTest(atol2, it, maxiter, log, node, h.value))
    finally:
        err = lib.atpt_while_close(side.cuda_stream)
    cuda_lib.check(lib, err, "while_close")
    delta = [f.launches - p for f, p in zip(GRAPH_KERNELS, pre)]
    for f, d in zip(GRAPH_KERNELS, delta):
        f.launches -= d
    log.add_node(delta)
