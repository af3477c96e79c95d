"""Protocol layer between the C ABI (``native/src/capi.cc``) and the
solver; port of ``arpack_ng_tpu/native_bridge.py``.

The C library embeds CPython and calls a module of this name with raw
memoryviews and a JSON option string (the protocol ``capi.cc`` fixes):
:func:`solve`, :func:`solve_matvec`, :func:`mm_query`, :func:`mm_read`,
:func:`check_eigvec`, :func:`get_stats` (31 values in stat_c.h order),
:func:`stats_reset`, :func:`set_debug` and :func:`device_count`.
``arpack_ng_tpu_torch.native_capi`` builds the unchanged ``capi.cc``
against this module (``csrc/capi_select.h`` redirects its import).

The device: ``capi.cc`` writes the options itself and passes no device,
so every entry point runs on the device ``$ARPACK_TPU_TORCH_DEVICE``
names (default ``cuda``; the tests set ``cpu``), the counterpart of the
reference's ``$JAX_PLATFORMS``.  Without CUDA and without the variable an
entry point raises, and the C call returns its error code; nothing runs
on the CPU unasked.  Called from Python, the entry points also take a
keyword ``device=``.

The solves run the hybrid driver (``core/iram.IRAMSolver``) with the
reference bridge's config (``reorth='dgks'``), so a solve through either
bridge from the same start vector takes the same path.  The distributed
entry points (``n_devices``, the PARPACK communicator) run on the world of
``torch.distributed`` processes, one rank per process (see
:func:`device_count`).
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import re
import time

import numpy as np
import torch
import torch.distributed as dist

from .utils.device import DEFAULT, require

#: the environment variable naming the bridge's device
DEVICE_ENV = "ARPACK_TPU_TORCH_DEVICE"

_DTYPES = {"s": np.float32, "d": np.float64,
           "c": np.complex64, "z": np.complex128}

#: stats of the most recent solve (the /timing/ common analog: module
#: state, as the reference's common block is)
_last_stats = None
_last_sym = True
_last_complex = False
#: sub-mesh process groups by size (every rank makes them in one order)
_groups = {}


def _device(device=None) -> torch.device:
    """The bridge's device: ``device``, else ``$ARPACK_TPU_TORCH_DEVICE``,
    else the card; raises when it is the card and there is no CUDA."""
    return require(device or os.environ.get(DEVICE_ENV) or DEFAULT)


def _np_from_buffer(buf, dtype, count=None):
    a = np.frombuffer(buf, dtype=dtype)
    return a if count is None else a[:count]


def _info_of(err: ValueError) -> int:
    """The reference info code a config error carries ("reference info =
    -3"), else -9999."""
    m = re.search(r"info\s*=\s*(-\d+)", str(err))
    return int(m.group(1)) if m else -9999


def device_count(device=None) -> int:
    """The MPI_Comm_size analog (``atpu_device_count``): the size of the
    ``torch.distributed`` world, 1 where none is initialized.  A process
    started by a launcher (``$WORLD_SIZE`` > 1, as torchrun sets it, also
    for a C program under ``torchrun --no-python``) joins the world from
    ``env://`` at first use: NCCL on the card, gloo on the CPU."""
    dev = _device(device)
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1") or 1) <= 1:
            return 1
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return dist.get_world_size()


def _mesh(n_devices: int, dev):
    """``(mesh or None, result or None)`` for the ``n_devices`` option: 1,
    and 0 in a world of one, mean no mesh; 0 otherwise the world; 1 < k
    <= world a sub-mesh of the first k ranks (every rank makes the group;
    a rank outside it gets the result ``info 0, nconv 0``); anything else
    the result ``info -9998``."""
    world = device_count(dev)
    if n_devices == 0:
        n_devices = world
    if n_devices == 1:
        return None, None
    if n_devices < 0 or n_devices > world:
        return None, {"info": -9998, "nconv": 0}
    from .parallel.sharding import make_mesh
    group = None
    if n_devices < world:
        if n_devices not in _groups:
            _groups[n_devices] = dist.new_group(list(range(n_devices)))
        group = _groups[n_devices]
        if dist.get_rank() >= n_devices:
            return None, {"info": 0, "nconv": 0}
    return make_mesh(group, device=dev), None


def _out_bytes(vals, vecs, rdt) -> dict:
    """Values as separate re/im blocks in the real scalar type; vectors
    (``(n, nconv)``) as column blocks, vector j at offset j*n, the
    reference's z(ldz, nev) layout (``capi.cc`` interleaves them for the
    complex dtypes)."""
    vals = np.atleast_1d(np.asarray(vals))
    ret = {"vals_re": np.ascontiguousarray(vals.real, rdt).tobytes(),
           "vals_im": np.ascontiguousarray(np.imag(vals), rdt).tobytes()}
    if vecs is not None:
        z = np.asarray(vecs)
        ret["vecs_re"] = np.ascontiguousarray(z.real.T, rdt).tobytes()
        ret["vecs_im"] = np.ascontiguousarray(np.imag(z).T, rdt).tobytes()
    return ret


def solve(options: str, buf_a=None, buf_p=None, buf_i=None, buf_v=None,
          buf_m=None, buf_mp=None, buf_mi=None, buf_mv=None, *,
          device=None):
    """Run one eigensolve.  Returns a dict of plain-Python/bytes values.

    ``options`` (JSON): dtype ('s'|'d'|'c'|'z'), symmetric, n, k, which,
    ncv (0 = auto), maxiter (0 = auto), tol, sigma_re, sigma_im,
    has_sigma, schur, rvec, dump (path|''), restart (path|''), seed,
    n_devices, iwidth, select ('0'/'1' string: howmny 'S').

    Dense input: ``buf_a`` (and ``buf_m``) row-major n*n scalars of the
    dtype.  CSR input: ``buf_p`` (indptr, n+1), ``buf_i`` (indices) of
    ``iwidth``-bit integers, ``buf_v`` (scalars); ``buf_mp/mi/mv``
    likewise for M.  A resid-only checkpoint as ``restart`` seeds a fresh
    solve with its vector (the reference's info != 0 protocol)."""
    global _last_stats, _last_sym, _last_complex
    import scipy.sparse as sp

    from .config import IRAMConfig, default_ncv, pad_dim
    from .core.extract import extract
    from .core.iram import IRAMSolver
    from .io import checkpoint as ckpt
    from .ops import transforms
    from .ops.operator import from_dense
    from .ops.sparse import from_scipy

    dev = _device(device)
    opt = json.loads(options)
    idt = np.int32 if int(opt.get("iwidth", 64)) == 32 else np.int64
    dt = np.dtype(_DTYPES[opt["dtype"]])
    rdt = np.float32 if dt in (np.float32, np.complex64) else np.float64
    n = int(opt["n"])
    sym = bool(opt.get("symmetric", True))
    is_cplx = np.issubdtype(dt, np.complexfloating)

    def csr(bp, bi, bv):
        return sp.csr_matrix(
            (_np_from_buffer(bv, dt).copy(),
             _np_from_buffer(bi, idt).astype(np.int64),
             _np_from_buffer(bp, idt, n + 1).astype(np.int64)),
            shape=(n, n))

    if buf_a is not None:
        a_in = _np_from_buffer(buf_a, dt, n * n).reshape(n, n).copy()
    else:
        a_in = csr(buf_p, buf_i, buf_v)
    m_in = None
    if buf_m is not None:
        m_in = _np_from_buffer(buf_m, dt, n * n).reshape(n, n).copy()
    elif buf_mp is not None:
        m_in = csr(buf_mp, buf_mi, buf_mv)

    sigma = None
    if opt.get("has_sigma"):
        sigma = complex(opt.get("sigma_re", 0.0), opt.get("sigma_im", 0.0))
        if sym and not is_cplx:
            sigma = sigma.real

    k = int(opt["k"])
    ncv = int(opt.get("ncv", 0)) or default_ncv(n, k, sym)
    maxiter = int(opt.get("maxiter", 0)) or max(10 * n, 300)

    # the mesh (the parpack comm argument, ICB/parpack.h:10-39); the row
    # partition needs n_pad % size == 0 (and 128-row tiles)
    mesh, early = _mesh(int(opt.get("n_devices", 1)), dev)
    if early is not None:
        return early
    n_pad = 0
    if mesh is not None:
        n_pad = pad_dim(n, 128 * mesh.size // math.gcd(128, mesh.size))
    if sigma is not None or m_in is not None:
        build = transforms.build_sym_operator if sym \
            else transforms.build_nonsym_operator
        op = build(a_in, M=m_in, sigma=sigma, dtype=dt, n_pad=n_pad,
                   device=dev)
    elif sp.issparse(a_in):
        op = from_scipy(a_in, hermitian=sym, n_pad=n_pad, device=dev)
    else:
        op = from_dense(a_in, hermitian=sym, n_pad=n_pad, device=dev)

    try:
        cfg = IRAMConfig(n=op.n, nev=k, ncv=min(ncv, op.n),
                         which=opt.get("which", "LM"), bmat=op.bmat,
                         mode=op.mode, tol=float(opt.get("tol", 0.0)),
                         max_iter=maxiter, symmetric=sym,
                         dtype=np.dtype(op.dtype), n_pad=op.n_pad,
                         seed=int(opt.get("seed", 0)))
    except ValueError as e:
        return {"info": _info_of(e), "nconv": 0}
    solver = IRAMSolver(op, cfg, mesh=mesh)

    state = v0 = None
    if opt.get("restart"):
        state, meta = ckpt.load_state(opt["restart"], device=dev, mesh=mesh)
        if state is None:
            v0 = meta["resid"]
    res = solver.solve(v0=v0, state=state)
    if opt.get("dump"):
        ckpt.save_state(opt["dump"], res.state, cfg, mesh=mesh)

    _last_stats = res.stats
    _last_sym = sym and not is_cplx
    _last_complex = is_cplx
    if res.info < 0:
        return {"info": int(res.info), "nconv": 0}

    rvec = bool(opt.get("rvec", True))
    # howmny='S' (atpu_set_select): positional over the final
    # factorization's Ritz values
    sel_s = opt.get("select") or ""
    select = None
    if sel_s:
        select = np.zeros(cfg.ncv, dtype=bool)
        m_len = min(len(sel_s), cfg.ncv)
        select[:m_len] = np.frombuffer(
            sel_s[:m_len].encode(), dtype=np.uint8) == ord("1")
    out = extract(solver.op, cfg, res, rvec=rvec,
                  howmny="P" if opt.get("schur")
                  else ("S" if select is not None else "A"),
                  select=select)
    return {"info": int(out.info), "nconv": int(out.nconv),
            **_out_bytes(out.values, out.vectors if rvec else None, rdt)}


def callback_type(dtype: str, iwidth: int):
    """The ctypes type of the caller's ``void fn(atpu_int n, const T *x,
    T *y, void *ctx)``: ``atpu_int`` is 32 or 64 bits wide as the library
    was built (``iwidth``), T float ('s') or double ('d')."""
    cint = ctypes.c_int32 if int(iwidth) == 32 else ctypes.c_int64
    cscalar = ctypes.c_float if dtype == "s" else ctypes.c_double
    return ctypes.CFUNCTYPE(None, cint, ctypes.POINTER(cscalar),
                            ctypes.POINTER(cscalar), ctypes.c_void_p)


def solve_matvec(options: str, fn_addr: int, ctx_addr: int, *,
                 device=None):
    """Matrix-free eigensolve driven by a C function pointer, the RCI
    (ido-loop) capability of the reference's C surface (ICB/arpack.h:10-21;
    the ido contract SRC/dsaupd.f:68-97), as ``atpu_eigsh_matvec_*`` /
    ``atpu_eigs_matvec_*``.

    ``fn_addr``: address of ``void fn(atpu_int n, const T *x, T *y, void
    *ctx)`` computing ``y = A @ x`` (:func:`callback_type`); ``ctx_addr``:
    the caller's context, passed through.  Real dtypes only ('s'/'d');
    complex ones return info -9997.

    The solve runs on the bridge's device like every other entry point.
    Each ``OP*x`` copies the vector to a pinned host buffer, calls ``fn``
    and copies its result back from a second one (both allocated once per
    solve); the operator is never captured in a CUDA graph.  The round
    trips' host time is the stats' ``tmvopx``."""
    global _last_stats, _last_sym, _last_complex
    from .config import IRAMConfig, default_ncv, pad_dim
    from .core.extract import extract
    from .core.iram import IRAMSolver
    from .ops.operator import from_matvec
    from .utils import dtypes as _dt

    dev = _device(device)
    opt = json.loads(options)
    dt = np.dtype(_DTYPES[opt["dtype"]])
    if np.issubdtype(dt, np.complexfloating):
        return {"info": -9997, "nconv": 0}   # real dtypes only
    n = int(opt["n"])
    sym = bool(opt.get("symmetric", True))
    cfunc_t = callback_type(opt["dtype"], opt.get("iwidth", 64))
    cfn = cfunc_t(int(fn_addr))
    cptr = cfunc_t._argtypes_[1]
    ctx = ctypes.c_void_p(int(ctx_addr) or None)

    n_pad = pad_dim(n)
    tdt = _dt.torch_dtype(dt)
    pin = dev.type == "cuda"
    x_h = torch.empty(n, dtype=tdt, pin_memory=pin)
    y_h = torch.empty(n, dtype=tdt, pin_memory=pin)
    xp = ctypes.cast(x_h.data_ptr(), cptr)
    yp = ctypes.cast(y_h.data_ptr(), cptr)
    spent = [0.0]

    def matvec(v):
        t0 = time.perf_counter()
        x_h.copy_(v[:n])
        cfn(n, xp, yp, ctx)
        out = torch.zeros(n_pad, dtype=tdt, device=dev)
        out[:n].copy_(y_h)
        spent[0] += time.perf_counter() - t0
        return out

    op = from_matvec(matvec, n, dt, n_pad=n_pad, hermitian=sym, device=dev)
    k = int(opt["k"])
    ncv = int(opt.get("ncv", 0)) or default_ncv(n, k, sym)
    maxiter = int(opt.get("maxiter", 0)) or max(10 * n, 300)
    try:
        cfg = IRAMConfig(n=n, nev=k, ncv=min(ncv, n),
                         which=opt.get("which", "LM"),
                         tol=float(opt.get("tol", 0.0)), max_iter=maxiter,
                         symmetric=sym, dtype=dt, n_pad=n_pad,
                         seed=int(opt.get("seed", 0)))
    except ValueError as e:
        return {"info": _info_of(e), "nconv": 0}
    res = IRAMSolver(op, cfg).solve()
    res.stats.timers.tmvopx = spent[0]
    _last_stats = res.stats
    _last_sym = sym
    _last_complex = False
    if res.info < 0:
        return {"info": int(res.info), "nconv": 0}
    rvec = bool(opt.get("rvec", True))
    out = extract(op, cfg, res, rvec=rvec, howmny="A")
    rdt = np.float32 if dt == np.float32 else np.float64
    return {"info": int(out.info), "nconv": int(out.nconv),
            **_out_bytes(out.values, out.vectors if rvec else None, rdt)}


def mm_query(path: str):
    """MatrixMarket probe (arpackSolver createMatrix phase 1,
    arpackSolver.hpp:176-215): ``[n_rows, n_cols, nnz, is_complex]``, nnz
    counted after symmetric storage is expanded (what :func:`mm_read`
    delivers in CSR)."""
    from .io.matrix_market import read_matrix
    a = read_matrix(path).tocsr()
    return [int(a.shape[0]), int(a.shape[1]), int(a.nnz),
            1 if np.iscomplexobj(a.data) else 0]


def mm_read(path: str, want_complex: int, iwidth: int = 64):
    """MatrixMarket CSR payload: a dict of bytes (indptr, indices, data).
    Real data as float64; complex as interleaved (re, im) float64 pairs
    (the C99 double _Complex layout)."""
    from .io.matrix_market import read_matrix
    a = read_matrix(path).tocsr()
    idt = np.int32 if int(iwidth) == 32 else np.int64
    data = a.data.astype(np.complex128 if want_complex else np.float64)
    return {"indptr": a.indptr.astype(idt).tobytes(),
            "indices": a.indices.astype(idt).tobytes(),
            "data": data.tobytes()}


def check_eigvec(options: str, buf_p=None, buf_i=None, buf_v=None,
                 buf_mp=None, buf_mi=None, buf_mv=None,
                 buf_valr=None, buf_vali=None, buf_vecr=None,
                 buf_veci=None):
    """Residual verifier (arpackSolver::checkEigVec,
    arpackSolver.hpp:297-323): max_i ||A v_i - lambda_i B v_i|| /
    max(|lambda_i| ||v_i||, tiny) over the supplied pairs, on the host.

    ``options`` (JSON): dtype 'd'|'z', n, nnz, m_nnz (0: B = I), nconv,
    diff_tol, dense (buf_v/buf_mv hold row-major n*n), iwidth.  Real
    dtype: values and vectors as split re/im arrays; complex: buf_valr and
    buf_vecr interleaved, the im buffers None.  Returns ``{"max_res":
    float, "ok": 0|1}``."""
    import scipy.sparse as sp

    opt = json.loads(options)
    dt = np.complex128 if opt["dtype"] == "z" else np.float64
    idt = np.int32 if int(opt.get("iwidth", 64)) == 32 else np.int64
    n = int(opt["n"])
    nconv = int(opt["nconv"])
    dense = bool(opt.get("dense", False))

    def load_mat(bp, bi, bv, nnz):
        if bv is None:
            return None
        if dense or bp is None:
            return _np_from_buffer(bv, dt, n * n).reshape(n, n)
        indptr = _np_from_buffer(bp, idt, n + 1).astype(np.int64)
        indices = _np_from_buffer(bi, idt, nnz).astype(np.int64)
        return sp.csr_matrix((_np_from_buffer(bv, dt, nnz), indices,
                              indptr), shape=(n, n))

    a = load_mat(buf_p, buf_i, buf_v, int(opt["nnz"]))
    m_nnz = int(opt.get("m_nnz", 0))
    m = load_mat(buf_mp, buf_mi, buf_mv, m_nnz) \
        if m_nnz or (dense and buf_mv is not None) else None

    if opt["dtype"] == "z":
        vals = _np_from_buffer(buf_valr, np.complex128, nconv)
        vecs = _np_from_buffer(buf_vecr, np.complex128,
                               n * nconv).reshape(nconv, n)
    else:
        vals = _np_from_buffer(buf_valr, np.float64, nconv).astype(complex)
        if buf_vali is not None:
            vals = vals + 1j * _np_from_buffer(buf_vali, np.float64, nconv)
        vecs = _np_from_buffer(buf_vecr, np.float64,
                               n * nconv).reshape(nconv, n).astype(complex)
        if buf_veci is not None:
            vecs = vecs + 1j * _np_from_buffer(
                buf_veci, np.float64, n * nconv).reshape(nconv, n)

    max_res = 0.0
    for i in range(nconv):
        v = vecs[i]
        bv = m @ v if m is not None else v
        num = np.linalg.norm(a @ v - vals[i] * bv)
        den = max(abs(vals[i]) * np.linalg.norm(v), 1e-300)
        max_res = max(max_res, float(num / den))
    tol = float(opt.get("diff_tol", 1e-6))
    return {"max_res": max_res, "ok": 1 if max_res <= tol else 0}


def get_stats():
    """stat_c() analog: 5 counters and 26 timer slots in stat_c.h:12-16
    order.  The timers of the last solve fill the family of its kind
    (s*/n*/c*); the others stay zero, as in the reference, where only the
    family that ran is nonzero."""
    s = _last_stats
    if s is None:
        return [0] * 5 + [0.0] * 26
    t = s.timers
    fam = [t.taupd, 0.0, t.taitr, t.teigt, t.tgets, t.tapps, t.tconv]
    zeros = [0.0] * 7
    if _last_complex:
        fams = zeros + zeros + fam
    elif _last_sym:
        fams = fam + zeros + zeros
    else:
        fams = zeros + fam + zeros
    mv = [t.tmvopx, t.tmvbx, t.tgetv0, t.titref, t.trvec]
    return ([int(s.nopx), int(s.nbx), int(s.nrorth), int(s.nitref),
             int(s.nrstrt)] + [float(x) for x in fams + mv])


def stats_reset():
    """sstats_c/sstatn_c/cstatn_c analog."""
    global _last_stats
    _last_stats = None


def set_debug(logfil: int, ndigit: int, mgetv0: int, maupd: int,
              maup2: int, maitr: int, meigt: int, mapps: int,
              mgets: int, meupd: int):
    """debug_c() analog.  The reference takes one level per routine per
    dtype family (debug_c.h:6-9); the drivers are dtype-parametric, so
    each level applies to every dtype (pass the max of a family's levels
    when porting a debug_c call).  ``logfil`` is accepted and unused, as
    in the reference bridge."""
    from .utils.debug import debug
    debug.ndigit = int(ndigit) or debug.ndigit
    for name, val in [("mgetv0", mgetv0), ("maupd", maupd),
                      ("maup2", maup2), ("maitr", maitr),
                      ("meigt", meigt), ("mapps", mapps),
                      ("mgets", mgets), ("meupd", meupd)]:
        setattr(debug, name, int(val))
    return 0

