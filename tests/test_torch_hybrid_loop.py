"""The hybrid driver on the device loop (``core/iram.IRAMSolver``: the
shared ``core/loop._DeviceLoop``, its reduce step on the host), on the
CPU, where the loop runs eagerly:

* against its host-loop twin (``_host_loop = True``: ``make_iram_head``
  and ``make_iram_tail``, the extension's ``load``/``run``/``finish`` and
  ``restart_tail`` every cycle): the same kernels' twins in the same
  order, so the values, bounds, vectors, the whole exit state and every
  counter are equal (``torch.equal`` / ``np.array_equal``), over real
  symmetric selective and dgks, real non-symmetric, complex Hermitian,
  complex non-symmetric, ``bmat='G'`` and caller shifts;
* against the reference package's ``IRAMSolver`` in float64 (complex128)
  on the same start vector: equal cycles, ``nopx`` and ``nrorth``, values
  to 1e-10 relative as sets (the O(n) sums run in another order);
* one cycle's device part (the restart and the extension) reads nothing
  back, and each cycle reads one packet;
* a run stopped at ``max_iter`` or at a ``multi`` boundary, resumed, is
  the unbroken solve."""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.config import IRAMConfig as JConfig  # noqa: E402
from arpack_ng_tpu.core.iram import IRAMSolver as JIRAMSolver  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402
from arpack_ng_tpu_torch.config import IRAMConfig as PConfig  # noqa: E402
from arpack_ng_tpu_torch.core import loop as ploop  # noqa: E402
from arpack_ng_tpu_torch.core.extract import extract  # noqa: E402
from arpack_ng_tpu_torch.core.iram import IRAMSolver  # noqa: E402
from arpack_ng_tpu_torch.ops import transforms  # noqa: E402

from test_torch_device_loop import _NoReadBack  # noqa: E402

COUNTERS = ("n_iter", "nopx", "nbx", "nrorth", "nitref", "nrstrt", "nrotr",
            "nrorthr")


def _hermitian(n=160, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return (h + h.conj().T) / 2


def _problem(case):
    """``(operator, config keywords)`` of a small case, on the CPU."""
    if case in ("sym selective", "sym dgks", "sym float32"):
        dt = np.float32 if case == "sym float32" else np.float64
        op, _ = pmodels.laplacian_2d(14, dt, device="cpu")
        reorth = "dgks" if case == "sym dgks" else "selective"
        return op, dict(which="BE" if case == "sym dgks" else "LA",
                        symmetric=True, reorth=reorth)
    if case == "nonsym":
        op, _ = pmodels.convection_diffusion_2d(12, dtype=np.float64,
                                                device="cpu")
        return op, dict(which="LM", symmetric=False, reorth="dgks")
    if case in ("hermitian selective", "hermitian dgks"):
        op = pt.from_dense(_hermitian().astype(np.complex64), hermitian=True,
                           device="cpu")
        return op, dict(which="LA", symmetric=True,
                        reorth=case.split()[1])
    if case == "complex nonsym":
        op, _ = pmodels.convection_diffusion_2d(10, dtype=np.complex128,
                                                device="cpu")
        return op, dict(which="LM", symmetric=False, reorth="dgks")
    if case == "generalized":
        n = 240
        K = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()
        M = (sp.diags([1.0, 4.0, 1.0], [-1, 0, 1], shape=(n, n)) / 6).tocsr()
        op = transforms.build_sym_operator(K, M=M, sigma=None,
                                           dtype=np.float64, device="cpu")
        assert op.bmat == "G"
        return op, dict(which="LM", symmetric=True, reorth="selective")
    raise KeyError(case)


def _cfg(op, ncv=16, nev=4, tol=1e-8, max_iter=200, **kw):
    return PConfig(n=op.n, nev=nev, ncv=ncv, dtype=np.dtype(op.dtype),
                   n_pad=op.n_pad, tol=tol, max_iter=max_iter, bmat=op.bmat,
                   mode=op.mode, **kw)


def _solvers(op, cfg, **kw):
    dev = IRAMSolver(op, cfg, **kw)
    host = IRAMSolver(op, cfg, **kw)
    host._host_loop = True
    assert not dev._host_loop
    return dev, host


def _assert_same(got, want):
    for f in COUNTERS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert (got.n_iter, got.nconv, got.info) == (want.n_iter, want.nconv,
                                                 want.info)
    np.testing.assert_array_equal(got.ritz, want.ritz)
    np.testing.assert_array_equal(got.bounds, want.bounds)
    a, b = got.state, want.state
    assert (a.k, a.nev_cur, a.iter, a.info) == (b.k, b.nev_cur, b.iter,
                                                b.info)
    assert a.rnorm == b.rnorm
    np.testing.assert_array_equal(a.H, b.H)
    for f in ("V", "resid", "b_resid"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


CASES = ["sym selective", "sym dgks", "sym float32", "nonsym",
         "hermitian selective", "hermitian dgks", "complex nonsym",
         "generalized"]


@pytest.mark.parametrize("case", CASES)
def test_device_loop_equals_host_loop(case):
    # the device loop's restructured cycle (the restart deferred into the
    # next cycle's prefix, one packet, the host's reduce step, the restart
    # staged into fixed buffers) gives the host loop bit for bit: values,
    # bounds, vectors, the exit state and every counter
    op, kw = _problem(case)
    cfg = _cfg(op, **kw)
    dev, host = _solvers(op, cfg)
    got, want = dev.solve(), host.solve()
    _assert_same(got, want)
    assert got.stats.packets == got.n_iter
    assert want.stats.packets == 0
    if case == "complex nonsym":
        assert dev._q_dtype() == torch.complex128   # the complex restart
    ex_got = extract(dev.op, cfg, got)
    ex_want = extract(host.op, cfg, want)
    np.testing.assert_array_equal(ex_got.values, ex_want.values)
    np.testing.assert_array_equal(ex_got.vectors, ex_want.vectors)


def test_user_shifts_on_the_device_loop():
    # caller shifts (the ido=3 protocol) run in the host's reduce step of
    # the device loop: equal to the host loop
    op, kw = _problem("sym selective")
    cfg = _cfg(op, exact_shifts=False, **kw)
    calls = []

    def shifts(ritz, bounds):
        calls.append(len(ritz))
        return ritz[np.argsort(-bounds)]

    dev, host = _solvers(op, cfg, shift_fn=shifts)
    got = dev.solve()
    n_dev = len(calls)
    _assert_same(got, host.solve())
    assert n_dev == len(calls) - n_dev > 0


REF_CASES = ["sym selective", "nonsym", "complex nonsym"]


@pytest.mark.parametrize("case", REF_CASES)
def test_device_loop_matches_reference(case):
    # the reference's IRAMSolver on the same float64 problem and start
    # vector: equal cycles, nopx and nrorth, values to 1e-10 relative
    op, kw = _problem(case)
    cfg = _cfg(op, tol=1e-10, **kw)
    if case.startswith("sym"):
        jop, _ = jmodels.laplacian_2d(14, dtype=np.float64)
    else:
        jop, _ = jmodels.convection_diffusion_2d(
            12 if case == "nonsym" else 10,
            dtype=np.float64 if case == "nonsym" else np.complex128)
    jcfg = JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(JConfig)
                      if hasattr(cfg, f.name)})
    v0 = np.random.default_rng(1).standard_normal(op.n)
    if np.issubdtype(op.dtype, np.complexfloating):
        v0 = v0 + 1j * np.random.default_rng(2).standard_normal(op.n)
    want = JIRAMSolver(jop, jcfg).solve(v0=v0)
    got = IRAMSolver(op, cfg).solve(v0=v0)
    assert got.stats.packets == got.n_iter
    assert (got.n_iter, got.stats.nopx, got.stats.nrorth) == (
        want.n_iter, int(want.stats.nopx), int(want.stats.nrorth))
    assert got.nconv == want.nconv >= cfg.nev
    # as sets: a conjugate pair's members tie in modulus, and the sort
    # breaks the tie by their last bits
    g, w = got.ritz[:cfg.nev], np.asarray(want.ritz)[:cfg.nev]
    gap = np.abs(g[:, None] - w[None, :])
    assert np.all(gap.min(1) <= 1e-10 * np.abs(g))
    assert np.all(gap.min(0) <= 1e-10 * np.abs(w))


class _CountReads(_NoReadBack):
    """Counts the device-to-host reads, and raises on one while ``strict``
    is set."""

    def __init__(self):
        super().__init__()
        self.reads, self.strict = 0, False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.BANNED:
            if self.strict:
                raise AssertionError(f"device-to-host read: {func.__name__}")
            self.reads += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["sym selective", "sym dgks",
                                  "complex nonsym", "generalized"])
def test_cycle_device_part_reads_nothing(case, monkeypatch):
    # every cycle's restart (rotation, residual update, B-norm) and
    # extension run under a mode that raises on any read; the whole loop
    # reads one packet a cycle
    op, kw = _problem(case)
    cfg = _cfg(op, **kw)
    solver = IRAMSolver(op, cfg)
    st = solver.init_state()
    guard = _CountReads()
    bodies = []
    real_body, real_run = ploop._DeviceLoop._cycle_body, solver._ext.run

    def strict(fn):
        def wrapped(*a):
            guard.strict = True
            try:
                return fn(*a)
            finally:
                guard.strict = False
        return wrapped

    def body(self, k):
        bodies.append(k)
        strict(real_body)(self, k)

    monkeypatch.setattr(ploop._DeviceLoop, "_cycle_body", body)
    monkeypatch.setattr(solver._ext, "run", strict(real_run))
    with guard:
        res = solver.solve(state=st)
    assert res.n_iter > 2 and len(bodies) == res.n_iter - 1
    assert guard.reads == res.stats.packets == res.n_iter


@pytest.mark.parametrize("stop", ["max_iter", "multi"])
@pytest.mark.parametrize("case", ["sym selective", "nonsym"])
def test_stopped_run_resumes_the_unbroken_solve(case, stop):
    # a run stopped by max_iter (the exit cycle's factorization under the
    # cycles before it) or at a multi boundary (the restarted state),
    # resumed by a fresh solver, gives the unbroken solve; the stopped
    # states equal the host loop's
    op, kw = _problem(case)
    cfg = _cfg(op, **kw)
    v0 = np.random.default_rng(5).standard_normal(op.n)
    want = IRAMSolver(op, cfg).solve(v0=v0)
    assert want.n_iter > 4
    if stop == "max_iter":
        cut = dataclasses.replace(cfg, max_iter=3)
        dev, host = _solvers(op, cut)
        res, twin = dev.solve(v0=v0), host.solve(v0=v0)
        _assert_same(res, twin)
        assert res.info == 1 and res.n_iter == 3 and res.state.iter == 2
        st = res.state
    else:
        dev, host = _solvers(op, cfg)
        out = dev.multi(dev.init_state(v0=v0), 3)
        twin = host.multi(host.init_state(v0=v0), 3)
        assert not out.done and out.state.iter == twin.state.iter == 3
        assert out.state.k == twin.state.k < cfg.ncv
        assert torch.equal(out.state.V, twin.state.V)
        assert torch.equal(out.state.resid, twin.state.resid)
        np.testing.assert_array_equal(out.state.H, twin.state.H)
        assert out.state.rnorm == twin.state.rnorm
        assert out.state.counts == twin.state.counts
        st = out.state
    got = IRAMSolver(op, cfg).solve(state=st)
    assert (got.n_iter, got.nconv, got.info) == (want.n_iter, want.nconv,
                                                 want.info)
    for f in COUNTERS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    np.testing.assert_array_equal(got.ritz, want.ritz)
