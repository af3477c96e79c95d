"""The selective restart loop on the device (arpack_ng_tpu_torch/core/
device_sym.FusedSymSolver) and its reduced space (ops/cuda_sym_cycle.py),
on the CPU, against the reference package on the same numpy inputs.

* one selective extension reads nothing back (a TorchFunctionMode that
  raises on every device-to-host conversion);
* the reduced space's plain twin against the reference's make_sym_head /
  make_sym_tail for each ``which``, float64, on the tridiagonals of random
  Lanczos runs and on a mid-solve T: Ritz values and bounds to 1e-12 of T's scale, the new T
  to 1e-8 of it, Q's kept columns and the new residual to 1e-6 (a sweep of
  close exact shifts amplifies the two QRs' rounding), the counts (nconv,
  nev_eff, done) equal;
* the device loop equals the host loop (``make_sym_head``/``make_sym_tail``)
  bit for bit;
* where the kernel keeps its workspace (``fits_shared``);
* a doubtful event: flagged by the read-free extension and run again by
  the host, equal to the host's decision from the start;
* the read-free step under the safe norms and the 'clean' pair rule
  against the reference's extension."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import arpack_ng_tpu as at  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.config import IRAMConfig as JConfig  # noqa: E402
from arpack_ng_tpu.core import device_sym as jsym  # noqa: E402
from arpack_ng_tpu.core.arnoldi import FactorizationState as JState  # noqa
from arpack_ng_tpu.utils.stats import OpCounts as JCounts  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402
from arpack_ng_tpu_torch.config import IRAMConfig as PConfig  # noqa: E402
from arpack_ng_tpu_torch.core import arnoldi as parn  # noqa: E402
from arpack_ng_tpu_torch.core import device_sym as psym  # noqa: E402
from arpack_ng_tpu_torch.core.iram import HostLoopSolver  # noqa: E402
from arpack_ng_tpu_torch.ops import cuda_sym_cycle as csc  # noqa: E402

WHICH = ["LA", "SA", "LM", "SM", "BE"]


class _NoReadBack(torch.overrides.TorchFunctionMode):
    """Raises on every way a tensor's values reach the host."""

    BANNED = {torch.Tensor.item, torch.Tensor.cpu, torch.Tensor.tolist,
              torch.Tensor.numpy, torch.Tensor.__bool__,
              torch.Tensor.__float__, torch.Tensor.__int__}

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls += 1
        if func in self.BANNED:
            raise AssertionError(f"device-to-host read: {func.__name__}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["geo", "lap2d"])
def test_selective_extension_reads_nothing_back(name, dtype):
    # a whole extension from a fresh start vector, events included, under
    # a mode that raises on any read; the same extension through the
    # reading entry point gives the same factorization
    if name == "geo":
        op = pt.from_diagonal(np.geomspace(1.0, 1e4, 300).astype(dtype),
                              n_pad=pt.pad_dim(300), device="cpu")
        ncv = 48
    else:
        op, _ = pmodels.laplacian_2d(16, dtype, device="cpu")
        ncv = 24
    cfg = PConfig(n=op.n, nev=4, ncv=ncv, which="LA", symmetric=True,
                  dtype=np.dtype(dtype), n_pad=op.n_pad, reorth="selective")
    st = parn.make_init(op, cfg)(None, None)
    ext = parn.make_extend(op, cfg)
    assert ext.read_free
    ds = ext.load(st)
    guard = _NoReadBack()
    with guard:
        ext.run(ds, 0, ncv)
    assert guard.calls > 100 * ncv  # the mode saw the step's ops
    assert int(ds.brk) == -1
    ref = ext(st, ncv)
    assert torch.equal(ds.resid, ref.resid)
    np.testing.assert_array_equal(ds.a.numpy(), np.diag(ref.H))
    assert int(ds.cnt[0]) == ref.counts.nrorth
    if name == "geo":  # the event path ran under the guard
        assert ref.counts.nrorth > 0


def _ref_cycle(T, rnorm, which, nev, tol):
    """The reference's head and exact-shift tail on a full factorization
    whose projected matrix is T: V = [I, 0] and resid = e_{n_pad-1}, so
    the rotated rows give Q's columns and the new residual sigmak and
    betak * Q[:, kev]."""
    ncv = T.shape[0]
    n_pad = 128
    op = at.from_diagonal(np.linspace(1.0, 2.0, n_pad))
    cfg = JConfig(n=n_pad, nev=nev, ncv=ncv, which=which, symmetric=True,
                  dtype=np.dtype(np.float64), n_pad=n_pad, tol=tol,
                  reorth="selective")
    V = np.zeros((ncv, n_pad))
    V[:, :ncv] = np.eye(ncv)
    resid = np.zeros(n_pad)
    resid[-1] = 1.0
    st = JState(V=jnp.asarray(V.reshape(ncv, -1, 128)), H=jnp.asarray(T),
                resid=jnp.asarray(resid), b_resid=jnp.asarray(resid),
                rnorm=jnp.asarray(np.float64(rnorm)), k=jnp.int32(ncv),
                nev_cur=jnp.int32(nev), iter=jnp.int32(0),
                info=jnp.int32(0), key=jax.random.key(0),
                counts=JCounts(*(jnp.int32(0) for _ in JCounts._fields)))
    h = jax.jit(jsym.make_sym_head(op, cfg))(st)
    tail = jsym.make_sym_tail(op, cfg)
    out = jax.jit(lambda h: tail(h, jnp.bool_(False)))(h)
    return jax.device_get(h), jax.device_get(out)


def _port_cycle(T, rnorm, which, nev, tol):
    ncv = T.shape[0]
    a = torch.from_numpy(np.diag(T).copy())
    b = torch.zeros(ncv, dtype=torch.float64)
    b[:-1] = torch.from_numpy(np.diag(T, -1).copy())
    Q = torch.zeros(ncv, ncv, dtype=torch.float64)
    sk = torch.zeros(2, dtype=torch.float64)
    pk = torch.zeros(csc.packet_size(ncv), dtype=torch.float64)
    p = csc.Params(which=which, nev=nev, tol=tol,
                   eps23=float(np.finfo(np.float64).eps ** (2 / 3)),
                   eps_m=float(np.finfo(np.float64).eps))
    csc.sym_cycle(a, b, torch.tensor(rnorm, dtype=torch.float64),
                  torch.tensor(-1, dtype=torch.int32),
                  torch.tensor(0, dtype=torch.int32),
                  torch.zeros(4, dtype=torch.int64), Q, sk, pk, p, False)
    return a.numpy(), b.numpy(), Q.numpy(), sk.numpy(), pk.numpy()


def _check_cycle(T, rnorm, which, nev=5, tol=1e-14):
    h, out = _ref_cycle(T, rnorm, which, nev, tol)
    a, b, Q, sk, pk = _port_cycle(T, rnorm, which, nev, tol)
    ncv = T.shape[0]
    scale = np.abs(T).max()
    assert int(pk[csc.P_NCONV]) == int(h.nconv)
    assert bool(pk[csc.P_DONE]) == bool(h.done)
    assert int(pk[csc.P_NEV]) == int(h.nev_eff)
    r_s = pk[csc.P_HEAD + 2 * ncv:csc.P_HEAD + 3 * ncv]
    b_s = pk[csc.P_HEAD + 3 * ncv:]
    np.testing.assert_allclose(r_s, h.r_s, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(b_s, h.b_s, rtol=0, atol=1e-12 * scale)
    if bool(h.done):
        return
    k = int(out.state.k)
    Hn = np.diag(a) + np.diag(b[:-1], 1) + np.diag(b[:-1], -1)
    np.testing.assert_allclose(Hn[:k, :k], np.asarray(out.state.H)[:k, :k],
                               rtol=0, atol=1e-8 * scale)
    # the kept columns of Q; the columns past them belong to the deflated
    # block of the exact shifts and are not determined (Queue 3 of
    # ROADMAP.md): only betak * Q[:, k], the residual's new part, is
    # (to 1e-6: LAPACK's QR and XLA's round apart, and a sweep of close
    # exact shifts amplifies it)
    Vn = np.asarray(out.state.V).reshape(ncv, -1)
    np.testing.assert_allclose(Vn[:k, :ncv].T, Q[:, :k], rtol=0, atol=1e-6)
    resid = np.asarray(out.state.resid)
    np.testing.assert_allclose(resid[-1], sk[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(resid[:ncv], sk[1] * Q[:, k], rtol=0,
                               atol=1e-6)


def _lanczos_T(seed, ncv=20, n=300):
    """T and rnorm of ncv Lanczos steps (full reorthogonalization, float64)
    on a random diagonal from a random start: the tridiagonals a restart
    meets.  (A random T with a spread diagonal has localized eigenvectors,
    and a QR step with such an exact shift is forward unstable: two
    backward-stable QRs then give far-apart new T.)"""
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.0, 1.0, n)
    V = np.zeros((ncv + 1, n))
    v = rng.uniform(-1, 1, n)
    V[0] = v / np.linalg.norm(v)
    d, e = np.zeros(ncv), np.zeros(ncv)
    for j in range(ncv):
        w = lam * V[j]
        for _ in range(2):
            w -= V[:j + 1].T @ (V[:j + 1] @ w)
        d[j] = V[j] @ (lam * V[j])
        e[j] = np.linalg.norm(w)
        V[j + 1] = w / e[j]
    return np.diag(d) + np.diag(e[:-1], 1) + np.diag(e[:-1], -1), e[-1]


@pytest.mark.parametrize("which", WHICH)
@pytest.mark.parametrize("seed", [0, 1])
def test_reduced_twin_matches_reference_random(which, seed):
    T, rnorm = _lanczos_T(seed)
    _check_cycle(T, rnorm, which)


@pytest.mark.parametrize("which", WHICH)
def test_reduced_twin_matches_reference_mid_solve(which):
    # T and rnorm of the reference's third extension on the 2-D Laplacian
    # (its first two cycles restart with the same which)
    opj, _ = jmodels.laplacian_2d(16, dtype=np.float64)
    cfg = JConfig(n=opj.n, nev=5, ncv=20, which=which, symmetric=True,
                  dtype=np.dtype(np.float64), n_pad=opj.n_pad, tol=1e-14,
                  max_iter=50, reorth="selective")
    solver = jsym.FusedSymSolver(opj, cfg)
    v0 = np.random.default_rng(0).uniform(-1, 1, opj.n)
    out = solver._multi(solver.init_state(key=jax.random.key(0), v0=v0),
                        jnp.int32(2), jnp.int32(50))
    h = jax.device_get(jax.jit(jsym.make_sym_head(opj, cfg))(out.state))
    _check_cycle(np.asarray(h.T), float(h.state.rnorm), which)


def _solve(op, cfg, loop):
    solver = psym.FusedSymSolver(op, cfg)
    if loop == "host":
        return HostLoopSolver.solve(solver)
    return solver.solve()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("which", ["LA", "SA", "BE"])
def test_device_loop_equals_host_loop(which, dtype):
    # the device loop's steps, reduced space (the numpy twin on the CPU)
    # and restart are the host loop's, so everything is equal
    op, _ = pmodels.laplacian_2d(16, dtype, device="cpu")
    cfg = PConfig(n=op.n, nev=4, ncv=20, which=which, symmetric=True,
                  dtype=np.dtype(dtype), n_pad=op.n_pad,
                  tol=1e-10 if dtype == np.float64 else 1e-5, max_iter=300,
                  reorth="selective")
    host, dev = _solve(op, cfg, "host"), _solve(op, cfg, "device")
    assert dev.n_iter == host.n_iter and dev.info == host.info
    assert dev.nconv == host.nconv
    np.testing.assert_array_equal(dev.ritz, host.ritz)
    np.testing.assert_array_equal(dev.bounds, host.bounds)
    for f in ("nopx", "nbx", "nrorth", "nitref", "nrotr", "nrorthr"):
        assert getattr(dev.stats, f) == getattr(host.stats, f), f
    np.testing.assert_array_equal(dev.state.H, host.state.H)
    assert torch.equal(dev.state.V, host.state.V)
    assert dev.stats.packets == dev.n_iter
    assert dev.stats.graphs_captured == 0  # no card, no graph


def test_device_loop_maxiter_and_breakdown():
    # max_iter ends on a cycle without shifts, as the host loop does; an
    # invariant subspace mid-extension is finished on the host
    op, _ = pmodels.laplacian_2d(16, np.float64, device="cpu")
    cfg = PConfig(n=op.n, nev=4, ncv=12, which="LA", symmetric=True,
                  dtype=np.dtype(np.float64), n_pad=op.n_pad, tol=1e-14,
                  max_iter=3, reorth="selective")
    host, dev = _solve(op, cfg, "host"), _solve(op, cfg, "device")
    assert dev.n_iter == host.n_iter == 3 and dev.info == host.info == 1
    np.testing.assert_array_equal(dev.ritz, host.ritz)
    d = np.linspace(1.0, 10.0, 60)
    v0 = np.zeros(60)
    v0[0] = 1.0
    opd = pt.from_diagonal(d, n_pad=pt.pad_dim(60), device="cpu")
    cfg = PConfig(n=60, nev=2, ncv=10, which="LA", symmetric=True,
                  dtype=np.dtype(np.float64), n_pad=opd.n_pad, tol=1e-10,
                  max_iter=300, reorth="selective")
    solver = psym.FusedSymSolver(opd, cfg)
    st = solver.init_state(v0=v0)
    res = solver.solve(state=st)
    host = HostLoopSolver.solve(psym.FusedSymSolver(opd, cfg),
                                state=solver.init_state(v0=v0))
    assert res.stats.nrstrt == host.stats.nrstrt == 1
    assert res.stats.packets == res.n_iter + 1  # one more after the rerun
    np.testing.assert_array_equal(res.ritz, host.ritz)
    assert (res.stats.nopx, res.n_iter) == (host.stats.nopx, host.n_iter)


@pytest.mark.parametrize("itemsize,top", [(4, 111), (8, 78)])
def test_kernel_shape_rule(itemsize, top):
    # the kernel's workspace has two parts, which claim one block's shared
    # memory in order: 19 double and 19 compute-dtype vectors (the QL's, a
    # ring of 8 shifts' reflectors; the head's, a ring of 5 tridiagonals),
    # and the matrices (a packed upper-Hessenberg q for each of 4 column
    # warps, Q and its product); both fit up to top, the vectors up to
    # top1, and the parts that do not fit go to one global buffer (every
    # ncv runs on the card)
    assert (csc.VECTORS, csc.DVECTORS, csc.SWEEP_PAIRS) == (19, 19, 4)
    top1 = {4: 1018, 8: 763}[itemsize]
    assert csc.fits_shared(top, itemsize)
    assert not csc.fits_shared(top + 1, itemsize)
    assert csc.smem_parts(top + 1, itemsize) == 1
    assert csc.smem_parts(top1, itemsize) == 1
    assert csc.smem_parts(top1 + 1, itemsize) == 0

    def parts(n):
        # column c of a packed q holds rows 0..min(c + 3, n - 1)
        q = sum(min(c + 4, n) for c in range(n))
        return ((19 * 8 + 19 * itemsize) * n,
                (4 * q + 2 * n * n) * itemsize)

    for n in (2, 3, 4, 5, 32, top, top + 1, top1 + 1, 1200):
        assert csc.part_bytes(n, itemsize) == parts(n)
        k = csc.smem_parts(n, itemsize)
        assert sum(parts(n)[:k]) <= csc.MAX_SMEM
        assert k == 2 or sum(parts(n)[:k + 1]) > csc.MAX_SMEM
        assert csc.global_bytes(n, itemsize) == sum(parts(n)[k:])
        assert csc.work_bytes(n, itemsize) == sum(parts(n))
    assert csc.global_bytes(top, itemsize) == 0
    assert csc.work_bytes(256, 8) == 2_203_456


def test_reduced_wrapper_refuses_bad_buffers():
    a = torch.zeros(8, dtype=torch.float64)
    args = [a, a.clone(), torch.tensor(1.0, dtype=torch.float64),
            torch.tensor(-1, dtype=torch.int32),
            torch.tensor(0, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int64),
            torch.zeros(8, 8, dtype=torch.float64),
            torch.zeros(2, dtype=torch.float64),
            torch.zeros(csc.packet_size(8), dtype=torch.float64)]
    p = csc.Params("LA", 3, 1e-10, 1e-10, 2.2e-16)
    for i, bad in ((3, torch.tensor(-1, dtype=torch.int64)),
                   (6, torch.zeros(8, 7, dtype=torch.float64)),
                   (8, torch.zeros(5, dtype=torch.float64))):
        with pytest.raises(ValueError):
            csc.sym_cycle(*args[:i], bad, *args[i + 1:], p, False)


def _doubtful_problem():
    # 290 float32 values within 1e-6 and 10 spread ones: events after
    # which the norm stays collapsed (the doubtful case), none in span
    d = np.concatenate([np.linspace(1.0, 1.0 + 1e-6, 290),
                        np.linspace(2.0, 3.0, 10)]).astype(np.float32)
    op = pt.from_diagonal(d, n_pad=pt.pad_dim(300), device="cpu")
    cfg = PConfig(n=300, nev=4, ncv=24, which="LA", symmetric=True,
                  dtype=np.dtype(np.float32), n_pad=op.n_pad, tol=1e-5,
                  max_iter=40, reorth="selective")
    v0 = np.zeros(op.n_pad, np.float32)
    v0[:300] = np.random.default_rng(0).uniform(-1, 1, 300)
    return op, cfg, v0


def test_doubtful_event_redo_equals_host_decided_run():
    # the read-free extension only flags a doubtful event (brk = REDO);
    # the host restores the extension's entry and runs it again, each
    # doubtful pass on the host: the same as running every step with the
    # host's decision from the start, bit for bit, and the counts PR 6's
    # host-stepped loop gave (4 passes of 18 events, 408 rows)
    op, cfg, v0 = _doubtful_problem()
    ext = parn.make_extend(op, cfg)
    init = parn.make_init(op, cfg)
    ds = ext.load(init(None, v0))
    ext.run(ds, 0, 24)
    assert int(ds.brk) == parn.REDO
    got = ext(init(None, v0), 24)
    ds2 = ext.load(init(None, v0))
    ext.run(ds2, 0, 24, host_doubt=True)
    assert int(ds2.brk) == -1
    assert torch.equal(got.resid, ds2.resid) and torch.equal(got.V, ds2.V)
    np.testing.assert_array_equal(np.diag(got.H), ds2.a.numpy())
    np.testing.assert_array_equal(np.diag(got.H, -1), ds2.b.numpy()[:-1])
    assert [got.counts.nrorth, got.counts.nitref, got.counts.nbx,
            got.counts.nrorthr] == ds2.cnt.tolist() == [18, 4, 0, 408]


def test_device_loop_redo_equals_host_loop():
    # whole solves with doubtful events: the device loop (a second packet
    # after each host rerun) equals the host loop
    op, cfg, v0 = _doubtful_problem()
    dev = psym.FusedSymSolver(op, cfg).solve(v0=v0)
    host = HostLoopSolver.solve(psym.FusedSymSolver(op, cfg), v0=v0)
    assert dev.stats.nitref == host.stats.nitref > 0
    assert dev.stats.packets > dev.n_iter == host.n_iter
    np.testing.assert_array_equal(dev.ritz, host.ritz)
    for f in ("nopx", "nbx", "nrorth", "nrotr", "nrorthr"):
        assert getattr(dev.stats, f) == getattr(host.stats, f), f
    assert torch.equal(dev.state.V, host.state.V)


def test_from_matvec_is_not_capturable_unless_declared():
    def mv(x):
        return 2 * x
    assert not pt.from_matvec(mv, 10, np.float64, device="cpu").capturable
    assert pt.from_matvec(mv, 10, np.float64, device="cpu",
                          capturable=True).capturable
    op, _ = pmodels.laplacian_2d(8, np.float64, device="cpu")
    assert op.capturable
    assert pt.from_diagonal(np.ones(5), device="cpu").capturable


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("option", [dict(safe_norms=True),
                                    dict(pair_rule="clean")])
def test_extension_options_match_reference(option, dtype):
    # the read-free step under the overflow-safe norms (no fused norm: the
    # event's B-norm is its own pass) and the 'clean' pair rule, against
    # the reference's extension from the same start vector: H to 1e-12
    # (float64) / 1e-4 (float32) of its scale, the counters equal
    from arpack_ng_tpu.core import arnoldi as jarn

    d = np.geomspace(1.0, 1e4, 300).astype(dtype)
    n_pad = at.pad_dim(300)
    opj = at.from_diagonal(d, n_pad=n_pad)
    opp = pt.from_diagonal(d, n_pad=n_pad, device="cpu")
    kw = dict(n=300, nev=4, ncv=48, which="LA", symmetric=True,
              dtype=np.dtype(dtype), n_pad=n_pad, reorth="selective",
              **option)
    v0 = np.zeros(n_pad)
    v0[:300] = np.random.default_rng(0).uniform(-1, 1, 300)
    v0 = v0.astype(dtype)
    cj, cp = JConfig(**kw), PConfig(**kw)
    stj = jarn.make_init(opj, cj)(jax.random.key(0), jnp.asarray(v0))
    ext = jarn.make_extend(opj, cj)
    stj = jax.device_get(jax.jit(lambda s: ext(s, jnp.int32(48)))(stj))
    stp = parn.make_extend(opp, cp)(parn.make_init(opp, cp)(None, v0), 48)
    tol = 1e-12 if dtype == np.float64 else 1e-4
    Hj = np.asarray(stj.H, np.float64)
    assert np.max(np.abs(stp.H - Hj)) <= tol * np.max(np.abs(Hj))
    fields = ("nopx", "nbx", "nrorth", "nitref", "nrstrt", "nrorthr")
    assert {f: getattr(stp.counts, f) for f in fields} == \
        {f: int(getattr(stj.counts, f)) for f in fields}
    assert stp.counts.nrorth > 0
