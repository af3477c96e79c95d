"""The port's C-ABI bridge (``arpack_ng_tpu_torch.native_bridge``) against
the reference's (``arpack_ng_tpu.native_bridge``), in process, on the
cases of tests/test_native_bridge.py with the same seeded numpy inputs;
the port's runs on the CPU (``$ARPACK_TPU_TORCH_DEVICE=cpu``).

The packages draw different random start vectors, so each solve starts
from one vector written as a resid-only checkpoint (the protocol's
``restart``, the reference's info != 0 start) and handed to both bridges.
Values agree within 1e-10*|lambda| in float64 / complex128 and 1e-4*|lambda|
in float32 / complex64; in float64 the five counters of ``get_stats`` are
equal.  ``solve_matvec`` has no ``restart`` in its protocol: there the
values are held, not the counters.  Also: a checkpoint written by either
bridge resumes in the other to the unbroken solve, the ``n_devices``
option in a world of one, the device rule (``$ARPACK_TPU_TORCH_DEVICE``),
and the mesh entry points on a gloo world of 3 processes
(``tests/torch_mp_worker.py``)."""
import ctypes
import json

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from arpack_ng_tpu import native_bridge as jb  # noqa: E402
from arpack_ng_tpu_torch import native_bridge as pb  # noqa: E402

from torch_mp_worker import run_world  # noqa: E402

REL = {"s": 1e-4, "c": 1e-4, "d": 1e-10, "z": 1e-10}
RDT = {"s": np.float32, "c": np.float32, "d": np.float64, "z": np.float64}
CDT = {"s": np.float32, "d": np.float64, "c": np.complex64,
       "z": np.complex128}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv(pb.DEVICE_ENV, "cpu")


def _start(tmp_path, n, dtype, seed=0):
    """A resid-only checkpoint holding a seeded start vector."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, n)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        v = v + 1j * rng.uniform(-1, 1, n)
    path = str(tmp_path / f"start{seed}.npz")
    meta = dict(version=1, n=n, resid_only=True)
    np.savez(path, __meta__=json.dumps(meta),
             resid=v.astype(dtype), rnorm=np.float64(1.0),
             key=np.array([0, seed], np.uint32))
    return path


def _both(opt, **bufs):
    """The same call through both bridges: ``(reference, port)`` results
    with each one's ``get_stats`` under ``"stats"``."""
    out = []
    for nb in (jb, pb):
        r = nb.solve(json.dumps(opt), **bufs)
        r["stats"] = nb.get_stats()
        out.append(r)
    return out


def _vals(r, code):
    rdt = RDT[code]
    return (np.frombuffer(r["vals_re"], rdt)
            + 1j * np.frombuffer(r["vals_im"], rdt))[:r["nconv"]]


def _vecs(r, code, n):
    rdt = RDT[code]
    z = np.frombuffer(r["vecs_re"], rdt).reshape(-1, n)
    if "vecs_im" in r:
        z = z + 1j * np.frombuffer(r["vecs_im"], rdt).reshape(-1, n)
    return z[:r["nconv"]]


def _same(rj, rp, code, counters=None):
    """Equal info and nconv, values within the dtype's tolerance, and in
    float64 (or with ``counters``) equal counters."""
    assert rp["info"] == rj["info"] and rp["nconv"] == rj["nconv"]
    vj, vp = _vals(rj, code), _vals(rp, code)
    scale = np.abs(vj).max() if len(vj) else 1.0
    np.testing.assert_allclose(vp, vj, rtol=0, atol=REL[code] * scale)
    if counters if counters is not None else code in "dz":
        assert rp["stats"][:5] == rj["stats"][:5]
    return vp


def _diag_problem(n, dtype):
    a = np.diag(np.arange(1.0, n + 1)).astype(dtype)
    a[0, 1] = a[1, 0] = 0.5
    return a


def _nonsym(n, dtype, seed=42):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) / np.sqrt(n)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        a = a + 1j * rng.standard_normal((n, n)) / np.sqrt(n)
    return (a + np.diag(np.arange(1.0, n + 1))).astype(dtype)


def _csr_bufs(a, iwidth=64):
    idt = np.int32 if iwidth == 32 else np.int64
    return dict(buf_p=memoryview(a.indptr.astype(idt).tobytes()),
                buf_i=memoryview(a.indices.astype(idt).tobytes()),
                buf_v=memoryview(np.ascontiguousarray(a.data).tobytes()))


def _residual(a, vals, vecs, m=None):
    return max(np.linalg.norm(a @ v - lam * (v if m is None else m @ v))
               / max(abs(lam), 1e-300) for lam, v in zip(vals, vecs))


# ---- dtypes, dense and CSR ------------------------------------------------

DENSE = [("d", True, 60, "LA", 1e-10), ("s", True, 60, "LA", 1e-5),
         ("z", False, 50, "LM", 1e-10), ("c", False, 50, "LM", 1e-4)]


@pytest.mark.parametrize("code,sym,n,which,tol", DENSE,
                         ids=[c[0] for c in DENSE])
def test_dense_dtypes(tmp_path, code, sym, n, which, tol):
    dt = CDT[code]
    a = _diag_problem(n, dt) if sym else _nonsym(n, dt)
    k = 4 if sym else 3
    rj, rp = _both(dict(dtype=code, symmetric=sym, n=n, k=k, which=which,
                        tol=tol, restart=_start(tmp_path, n, dt)),
                   buf_a=memoryview(a.tobytes()))
    assert rp["info"] == 0 and rp["nconv"] >= k
    vals = _same(rj, rp, code)
    res = _residual(a.astype(np.complex128), vals, _vecs(rp, code, n))
    assert res < (1e-8 if code in "dz" else 1e-3)


def _tridiag(n):
    return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()


CSR = [("d", True, 200, "LA", 1e-10), ("s", True, 200, "LA", 1e-5),
       ("z", False, 150, "LM", 1e-10), ("c", False, 150, "LM", 1e-4)]


@pytest.mark.parametrize("code,sym,n,which,tol", CSR,
                         ids=[c[0] for c in CSR])
def test_csr_dtypes(tmp_path, code, sym, n, which, tol):
    dt = CDT[code]
    if sym:
        a = _tridiag(n).astype(dt)
    else:
        a = sp.csr_matrix(_nonsym(n, dt) * (np.abs(
            np.subtract.outer(np.arange(n), np.arange(n))) <= 2))
    rj, rp = _both(dict(dtype=code, symmetric=sym, n=n, k=3, which=which,
                        tol=tol, ncv=20, restart=_start(tmp_path, n, dt)),
                   **_csr_bufs(a))
    assert rp["info"] == 0 and rp["nconv"] >= 3
    vals = _same(rj, rp, code)
    res = _residual(a.astype(np.complex128), vals, _vecs(rp, code, n))
    assert res < (1e-8 if code in "dz" else 1e-3)


def test_iwidth32_csr(tmp_path):
    # ILP32 clients send 32-bit indptr / indices
    n = 80
    a = _tridiag(n)
    rj, rp = _both(dict(dtype="d", symmetric=True, n=n, k=3, which="LA",
                        tol=1e-10, iwidth=32,
                        restart=_start(tmp_path, n, np.float64)),
                   **_csr_bufs(a, 32))
    vals = _same(rj, rp, "d").real
    exact = 2.0 - 2.0 * np.cos(np.pi * np.arange(n, n - 3, -1) / (n + 1))
    np.testing.assert_allclose(np.sort(vals), np.sort(exact), rtol=1e-8)


# ---- spectral transforms --------------------------------------------------

def test_generalized_dense(tmp_path):
    n = 80
    a = np.diag(np.arange(1.0, n + 1))
    m = np.eye(n) * 2.0
    rj, rp = _both(dict(dtype="d", symmetric=True, n=n, k=3, which="LA",
                        tol=1e-10, restart=_start(tmp_path, n, np.float64)),
                   buf_a=memoryview(a.tobytes()),
                   buf_m=memoryview(m.tobytes()))
    vals = _same(rj, rp, "d").real
    assert vals[-1] == pytest.approx(n / 2.0, abs=1e-8)


def test_shift_invert(tmp_path):
    n = 120
    a = _tridiag(n).toarray()
    rj, rp = _both(dict(dtype="d", symmetric=True, n=n, k=2, which="LM",
                        tol=1e-10, has_sigma=True, sigma_re=1.0,
                        restart=_start(tmp_path, n, np.float64)),
                   buf_a=memoryview(a.tobytes()))
    vals = _same(rj, rp, "d").real
    assert np.all(np.abs(vals - 1.0) < 0.1)
    assert _residual(a, vals, _vecs(rp, "d", n)) < 1e-8


# ---- control: stats, debug, checkpoints, Schur, select, info --------------

def test_stats_family_slots(tmp_path):
    n = 40
    a = _diag_problem(n, np.float64)
    start = _start(tmp_path, n, np.float64)
    rj, rp = _both(dict(dtype="d", symmetric=True, n=n, k=3, which="LA",
                        tol=1e-8, restart=start),
                   buf_a=memoryview(a.tobytes()))
    _same(rj, rp, "d")
    st = rp["stats"]
    assert len(st) == 31 and all(isinstance(x, int) for x in st[:5])
    assert st[0] > 0 and st[5] > 0.0 and st[12] == 0.0
    rj, rp = _both(dict(dtype="d", symmetric=False, n=n, k=3, which="LM",
                        tol=1e-8, restart=start),
                   buf_a=memoryview(a.tobytes()))
    _same(rj, rp, "d")
    st = rp["stats"]
    assert st[12] > 0.0 and st[5] == 0.0
    pb.stats_reset()
    assert pb.get_stats() == [0] * 5 + [0.0] * 26


def test_debug_setter():
    from arpack_ng_tpu.utils.debug import debug as jdebug
    from arpack_ng_tpu_torch.utils.debug import debug as pdebug
    try:
        for nb in (jb, pb):
            assert nb.set_debug(6, 4, 1, 2, 0, 3, 0, 0, 0, 5) == 0
        for f in ("ndigit", "mgetv0", "maupd", "maup2", "maitr", "meigt",
                  "mapps", "mgets", "meupd"):
            assert getattr(pdebug, f) == getattr(jdebug, f), f
        assert (pdebug.ndigit, pdebug.maitr, pdebug.meupd) == (4, 3, 5)
    finally:
        for nb in (jb, pb):
            nb.set_debug(6, 6, 0, 0, 0, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref"),
                                           ("port", "port")])
def test_checkpoint_across_bridges(tmp_path, writer, reader):
    # a solve stopped at maxiter = 3 dumps its state; the other bridge
    # restarts from the file with the full maxiter and ends as the
    # unbroken solve from the same start: values and counters
    n = 300
    a = np.diag(np.linspace(1.0, 50.0, n))
    start = _start(tmp_path, n, np.float64)
    base = dict(dtype="d", symmetric=True, n=n, k=4, which="LA", ncv=12,
                tol=1e-12, maxiter=500)
    buf = memoryview(a.tobytes())
    want = pb.solve(json.dumps(dict(base, restart=start)), buf_a=buf)
    want_st = pb.get_stats()
    nb_w, nb_r = ({"ref": jb, "port": pb}[x] for x in (writer, reader))
    ck = str(tmp_path / "cut.npz")
    cut = nb_w.solve(json.dumps(dict(base, maxiter=3, restart=start,
                                     dump=ck)), buf_a=buf)
    assert cut["info"] == 1
    got = nb_r.solve(json.dumps(dict(base, restart=ck)), buf_a=buf)
    got["stats"], want["stats"] = nb_r.get_stats(), want_st
    _same(want, got, "d", counters=True)


def test_schur_option(tmp_path):
    n = 60
    rng = np.random.default_rng(42)
    a = rng.standard_normal((n, n)) * 0.2 + np.diag(np.arange(1.0, n + 1))
    rj, rp = _both(dict(dtype="d", symmetric=False, n=n, k=3, which="LM",
                        tol=1e-8, schur=True,
                        restart=_start(tmp_path, n, np.float64)),
                   buf_a=memoryview(a.tobytes()))
    _same(rj, rp, "d")
    zj, zp = _vecs(rj, "d", n).real.T, _vecs(rp, "d", n).real.T
    # the same invariant subspace, an orthonormal basis of it
    np.testing.assert_allclose(zp.T @ zp, np.eye(zp.shape[1]), atol=1e-10)
    assert np.linalg.norm(zj - zp @ (zp.T @ zj)) < 1e-8


def test_select_mask(tmp_path):
    n = 200
    a = _diag_problem(n, np.float64)
    rj, rp = _both(dict(dtype="d", symmetric=True, n=n, k=4, which="LA",
                        tol=1e-10, ncv=20, select="10100000000000000000",
                        restart=_start(tmp_path, n, np.float64)),
                   buf_a=memoryview(a.tobytes()))
    vals = _same(rj, rp, "d").real
    assert rp["nconv"] == 2 and abs(vals[0] - vals[1]) > 0.5
    assert _residual(a, vals, _vecs(rp, "d", n)) < 1e-10


@pytest.mark.parametrize("k,ncv,info", [(10, 11, -3), (3, 3, -3)])
def test_error_info_code(k, ncv, info):
    n = 10
    a = np.eye(n)
    rj, rp = _both(dict(dtype="d", symmetric=True, n=n, k=k, ncv=ncv,
                        which="LA", tol=1e-8), buf_a=memoryview(a.tobytes()))
    assert rp["info"] == rj["info"] == info and rp["nconv"] == 0


# ---- MatrixMarket and the residual verifier -------------------------------

def _write_mtx(tmp_path, n=40):
    a = sp.diags([-np.ones(n - 1), 2.0 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1]).tocoo()
    path = str(tmp_path / "a.mtx")
    sio.mmwrite(path, a, symmetry="symmetric")
    return path, a.tocsr()


@pytest.mark.parametrize("iwidth", [64, 32])
def test_mm_query_read(tmp_path, iwidth):
    path, a = _write_mtx(tmp_path)
    assert pb.mm_query(path) == jb.mm_query(path) == [40, 40, a.nnz, 0]
    for cplx in (0, 1):
        assert pb.mm_read(path, cplx, iwidth) == jb.mm_read(path, cplx,
                                                            iwidth)


def test_check_eigvec(tmp_path):
    path, a = _write_mtx(tmp_path)
    vals, vecs = np.linalg.eigh(a.toarray())
    k = 3
    opts = json.dumps(dict(dtype="d", n=40, nnz=a.nnz, m_nnz=0, nconv=k,
                           diff_tol=1e-10))
    for shift in (0.0, 0.3):
        vr = np.ascontiguousarray(vals[-k:])
        vr[0] += shift
        bufs = dict(buf_valr=memoryview(vr.tobytes()),
                    buf_vecr=memoryview(np.ascontiguousarray(
                        vecs[:, -k:].T).tobytes()),
                    **_csr_bufs(a))
        rj, rp = jb.check_eigvec(opts, **bufs), pb.check_eigvec(opts, **bufs)
        assert rp["ok"] == rj["ok"] == (1 if shift == 0.0 else 0)
        np.testing.assert_allclose(rp["max_res"], rj["max_res"], rtol=1e-12,
                                   atol=1e-300)


def test_check_eigvec_complex_generalized_dense(rng):
    import scipy.linalg as sla
    n, k = 30, 3
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a = (a + a.conj().T) / 2
    m = np.eye(n) * 2.0
    vals, vecs = sla.eigh(a, m)
    opts = json.dumps(dict(dtype="z", n=n, nnz=0, m_nnz=0, nconv=k,
                           diff_tol=1e-9, dense=True))
    bufs = dict(
        buf_v=memoryview(a.astype(np.complex128).tobytes()),
        buf_mv=memoryview(m.astype(np.complex128).tobytes()),
        buf_valr=memoryview(vals[-k:].astype(np.complex128).tobytes()),
        buf_vecr=memoryview(np.ascontiguousarray(
            vecs[:, -k:].T.astype(np.complex128)).tobytes()))
    rj, rp = jb.check_eigvec(opts, **bufs), pb.check_eigvec(opts, **bufs)
    assert rp["ok"] == rj["ok"] == 1
    np.testing.assert_allclose(rp["max_res"], rj["max_res"], rtol=1e-12)


# ---- the matrix-free entry point -------------------------------------------

def _callback(code, iwidth, fn):
    """A C function pointer (ctypes) of the protocol's type calling
    ``fn(x, y)`` on numpy views."""
    cb = pb.callback_type(code, iwidth)(
        lambda nn, xp, yp, ctx: fn(np.ctypeslib.as_array(xp, shape=(nn,)),
                                   np.ctypeslib.as_array(yp, shape=(nn,))))
    return cb, ctypes.cast(cb, ctypes.c_void_p).value


def _lap1d(x, y, c=0.0):
    y[:] = 2.0 * x
    y[:-1] += (-1.0 + c) * x[1:]
    y[1:] += (-1.0 - c) * x[:-1]


@pytest.mark.parametrize("iwidth", [64, 32])
def test_matvec_sym_d(iwidth):
    n, k = 300, 4
    cb, addr = _callback("d", iwidth, _lap1d)
    opt = json.dumps(dict(dtype="d", symmetric=True, n=n, k=k, which="LA",
                          ncv=20, maxiter=2000, tol=1e-10, rvec=True,
                          iwidth=iwidth))
    rj = jb.solve_matvec(opt, addr, 0)
    rp = pb.solve_matvec(opt, addr, 0)
    assert rp["info"] == rj["info"] == 0 and rp["nconv"] >= k
    vp = np.sort(_vals(rp, "d").real)[-k:]
    np.testing.assert_allclose(vp, np.sort(_vals(rj, "d").real)[-k:],
                               rtol=0, atol=1e-10 * 4.0)
    exact = 2.0 - 2.0 * np.cos(np.pi * np.arange(n - k + 1, n + 1)
                               / (n + 1))
    np.testing.assert_allclose(vp, exact, rtol=1e-10)
    a = _tridiag(n)
    assert _residual(a, _vals(rp, "d").real, _vecs(rp, "d", n).real) < 1e-9
    st = pb.get_stats()
    assert st[0] > 0 and st[26] > 0.0       # nopx; tmvopx: the round trips


def test_matvec_nonsym_s():
    n, k = 200, 3
    cb, addr = _callback("s", 64, lambda x, y: _lap1d(x, y, 0.2))
    opt = json.dumps(dict(dtype="s", symmetric=False, n=n, k=k, which="LM",
                          ncv=20, maxiter=2000, tol=1e-4, rvec=False))
    rj, rp = jb.solve_matvec(opt, addr, 0), pb.solve_matvec(opt, addr, 0)
    assert rp["info"] == rj["info"] == 0 and rp["nconv"] >= k
    assert "vecs_re" not in rp
    # a non-normal float32 operator: values in its pseudospectrum, held
    # to tests/test_native_bridge.py's bound
    top = 2 + 2 * np.sqrt(1 - 0.04) * np.cos(np.pi / (n + 1))
    for r in (rj, rp):
        assert abs(np.abs(_vals(r, "s")).max() - top) < 2e-2


def test_matvec_complex_rejected():
    opt = json.dumps({"dtype": "z", "n": 10, "k": 2})
    assert pb.solve_matvec(opt, 0, 0) == jb.solve_matvec(opt, 0, 0) == {
        "info": -9997, "nconv": 0}


def test_callback_type_width():
    # the callback's atpu_int is the library's: 32 bits under ILP32 (the
    # reference hardcodes c_longlong)
    assert pb.callback_type("d", 32)._argtypes_[0] is ctypes.c_int32
    assert pb.callback_type("s", 64)._argtypes_[0] is ctypes.c_int64
    assert pb.callback_type("s", 32)._argtypes_[1]._type_ is ctypes.c_float
    assert pb.callback_type("d", 64)._argtypes_[2]._type_ is ctypes.c_double


# ---- the device rule and n_devices in a world of one ----------------------

def test_device_rule(monkeypatch):
    n = 40
    a = _diag_problem(n, np.float64)
    opt = json.dumps(dict(dtype="d", symmetric=True, n=n, k=3, which="LA",
                          tol=1e-8))
    monkeypatch.delenv(pb.DEVICE_ENV)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pb.solve(opt, buf_a=memoryview(a.tobytes()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pb.device_count()
    r = pb.solve(opt, buf_a=memoryview(a.tobytes()), device="cpu")
    assert r["info"] == 0 and r["nconv"] >= 3


def test_n_devices_in_a_world_of_one(tmp_path):
    n = 300
    a = _diag_problem(n, np.float64)
    assert pb.device_count() == 1
    opt = dict(dtype="d", symmetric=True, n=n, k=4, which="LM", tol=1e-10,
               restart=_start(tmp_path, n, np.float64))
    seq = pb.solve(json.dumps(dict(opt, n_devices=1)),
                   buf_a=memoryview(a.tobytes()))
    world = pb.solve(json.dumps(dict(opt, n_devices=0)),
                     buf_a=memoryview(a.tobytes()))
    assert world["info"] == 0 and world["vals_re"] == seq["vals_re"]
    for nd in (2, -1):
        r = pb.solve(json.dumps(dict(opt, n_devices=nd)),
                     buf_a=memoryview(a.tobytes()))
        assert r == {"info": -9998, "nconv": 0}


# ---- n_devices on a gloo world of 3 ----------------------------------------

def test_n_devices_world_of_three(tmp_path):
    n = 300
    a = _diag_problem(n, np.float64)
    out = run_world(3, ["bridge_mesh"], tmp_path,
                    {"bridge_mesh": (a, _start(tmp_path, n, np.float64))}
                    )["bridge_mesh"]
    for r in out:
        assert "error" not in r, r.get("error")
        assert r["device_count"] == 3
    seq = _vals(out[0]["nd1"], "d").real
    ref = np.sort(np.linalg.eigvalsh(a))[-4:]
    np.testing.assert_allclose(np.sort(seq[-4:]), ref, rtol=0,
                               atol=1e-10 * ref.max())
    for rank, r in enumerate(out):
        for nd in ("nd0", "nd1", "nd3") + (("nd2",) if rank < 2 else ()):
            got = r[nd]
            assert got["info"] == 0 and got["nconv"] >= 4, (rank, nd)
            np.testing.assert_allclose(_vals(got, "d").real, seq, rtol=0,
                                       atol=1e-10 * ref.max())
            z = _vecs(got, "d", n).real
            assert _residual(a, _vals(got, "d").real, z) < 1e-9
        assert r["nd4"] == {"info": -9998, "nconv": 0}
    # rank 2 is outside the sub-mesh of the first two ranks
    assert out[2]["nd2"] == {"info": 0, "nconv": 0}
