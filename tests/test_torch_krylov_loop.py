"""The inner Krylov solves as while loops (``arpack_ng_tpu_torch/ops/
cuda_krylov_loop.py``, the graph form of ``ops/solvers.cg`` and
``bicgstab``) on the CPU, in float64 on seeded numpy inputs:

* the CPU form of the WHILE node (``solvers._loop``: the body one
  in-place iteration on the loop's buffers, the update kernels' twins,
  the last of which runs the loop test's plain twin; the test kernel's
  twin before the first) equals the host loop ``_cg`` /
  ``_bicgstab`` bit for bit, with equal iteration counts, plain and with
  Jacobi and IC(0) / ILU(0); both within 1e-10 relative of the
  reference's ``cg`` / ``bicgstab``;
* BiCGSTAB's restart selects at ``rho == 0`` equal the branch they
  replace, bit for bit;
* the test's twin on edge inputs (``|r.r|`` equal to ``atol2``, one ulp
  either side, nan, ``it = maxiter - 1``, ``maxiter = 0``, ``b = 0``), the
  iteration log, ``solve.iterations`` and the launch accounting of a
  body (launches per iteration times iterations);
* ``eigsh`` / ``eigs`` shift-invert declared ``capturable`` equal the
  undeclared operator bit for bit on the CPU, and the reference's values
  within 1e-9.

The WHILE node itself needs a card: ``tests/test_torch_gpu.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import arpack_ng_tpu as at  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.ops import solvers as js  # noqa: E402
from arpack_ng_tpu.ops import sparse as jsparse  # noqa: E402
from arpack_ng_tpu.ops import transforms as jtransforms  # noqa: E402
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402
from arpack_ng_tpu_torch.core import loop  # noqa: E402
from arpack_ng_tpu_torch.ops import cuda_dia  # noqa: E402
from arpack_ng_tpu_torch.ops import cuda_krylov_loop as kl  # noqa: E402
from arpack_ng_tpu_torch.ops import solvers as ps  # noqa: E402
from arpack_ng_tpu_torch.ops import sparse as psparse  # noqa: E402
from arpack_ng_tpu_torch.ops import transforms as ptransforms  # noqa: E402

CPU = torch.device("cpu")


def _lap2d(nx):
    eye = sp.eye(nx)
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    return (sp.kron(eye, t) + sp.kron(t, eye)).tocsr().astype(np.float64)


def _convdiff2d(nx, rho=10.0):
    h = 1.0 / (nx + 1)
    c = rho * h / 2
    t = sp.diags([-1.0 - c, 4.0, -1.0 + c], [-1, 0, 1], shape=(nx, nx))
    s = sp.diags([-1.0, -1.0], [-1, 1], shape=(nx, nx))
    return (sp.kron(sp.eye(nx), t) + sp.kron(s, sp.eye(nx))).tocsr()


def _pair(a):
    n = a.shape[0]
    off, diags = jsparse._to_dia(a)
    return (jsparse.dia_matvec_fn(off, diags, n, n),
            psparse.dia_matvec_fn(off, diags, n, n, device="cpu"))


def _preconds(a, kind, symmetric):
    if kind == "jacobi":
        return (js.jacobi_preconditioner(jnp.asarray(a.diagonal())),
                ps.jacobi_preconditioner(torch.from_numpy(a.diagonal())))
    if kind == "ilu":
        return (js.ilu0_preconditioner(a, symmetric=symmetric),
                ps.ilu0_preconditioner(a, symmetric=symmetric,
                                       device="cpu"))
    return None, None


def _node(matvec, b, *, symmetric, tol, maxiter, precond=None):
    """One solve through the CPU form of the WHILE node: ``(x, count)``."""
    solve = ps.IterativeSolve(matvec, symmetric, tol, maxiter, precond)
    log = kl.IterationLog(CPU)
    x = ps._loop(solve._start, solve._step, b, tol, maxiter, log,
                 not symmetric)
    its = log.drain()
    assert len(its) == 1
    return x, its[0]


def _rel(x, ref):
    return np.linalg.norm(np.asarray(x) - np.asarray(ref)) \
        / np.linalg.norm(np.asarray(ref))


class TestNodeForm:
    @pytest.mark.parametrize("precond", [None, "jacobi", "ilu"])
    @pytest.mark.parametrize("symmetric", [True, False])
    def test_equals_host_loop_and_reference(self, rng, symmetric, precond):
        a = _lap2d(14) if symmetric else _convdiff2d(14)
        b = rng.standard_normal(a.shape[0])
        jmv, pmv = _pair(a)
        pcj, pcp = _preconds(a, precond, symmetric)
        kw = dict(tol=1e-12, maxiter=500)
        bt = torch.from_numpy(b)
        host = ps._cg if symmetric else ps._bicgstab
        x_host, it_host = host(pmv, bt, None, kw["tol"], kw["maxiter"], pcp)
        x_node, it_node = _node(pmv, bt, symmetric=symmetric, precond=pcp,
                                **kw)
        assert torch.equal(x_node, x_host) and it_node == it_host
        assert 0 < it_node < kw["maxiter"]
        ref = (js.cg if symmetric else js.bicgstab)(
            jmv, jnp.asarray(b), precond=pcj, **kw)
        assert _rel(x_node, ref) < 1e-10

    @pytest.mark.parametrize("symmetric", [True, False])
    def test_maxiter_and_zero_rhs(self, rng, symmetric):
        a = _lap2d(10)
        _, pmv = _pair(a)
        b = torch.from_numpy(rng.standard_normal(a.shape[0]))
        host = ps._cg if symmetric else ps._bicgstab
        for rhs, maxiter in ((b, 3), (b, 0), (torch.zeros_like(b), 50)):
            x_host, it_host = host(pmv, rhs, None, 1e-14, maxiter, None)
            x_node, it_node = _node(pmv, rhs, symmetric=symmetric,
                                    tol=1e-14, maxiter=maxiter)
            assert torch.equal(x_node, x_host) and it_node == it_host
        assert it_node == 0 and not x_node.any()

    def test_complex_bicgstab(self, rng):
        a = (_convdiff2d(10) + 0.3j * sp.eye(100)).tocsr()
        b = rng.standard_normal(100) + 1j * rng.standard_normal(100)
        jmv, pmv = _pair(a)
        bt = torch.from_numpy(b)
        x_host, it_host = ps._bicgstab(pmv, bt, None, 1e-12, 500, None)
        x_node, it_node = _node(pmv, bt, symmetric=False, tol=1e-12,
                                maxiter=500)
        assert torch.equal(x_node, x_host) and it_node == it_host
        ref = js.bicgstab(jmv, jnp.asarray(b), tol=1e-12, maxiter=500)
        assert _rel(x_node, ref) < 1e-10


def _branch_step(matvec, c, precond=None):
    """BiCGSTAB's iteration with the restart as a host branch (the form
    the selects replace)."""
    x, r, rhat, rho, alpha, omega, v, p = c
    if bool(rho == 0):
        one = torch.ones((), dtype=rho.dtype)
        rhat, rho, alpha, omega = r, one, one, one
        v = p = torch.zeros_like(r)
    rho_new = torch.vdot(rhat, r)
    beta = (rho_new / rho) * (alpha / omega)
    p = r + beta * (p - omega * v)
    ph = precond(p) if precond is not None else p
    v = matvec(ph)
    alpha = rho_new / torch.vdot(rhat, v)
    s = r - alpha * v
    sh = precond(s) if precond is not None else s
    t = matvec(sh)
    omega = torch.vdot(t, s) / torch.vdot(t, t)
    return (x + alpha * ph + omega * sh, s - omega * t, rhat, rho_new,
            alpha, omega, v, p)


@pytest.mark.parametrize("zero", [0.0, -0.0, 0j, None])
def test_restart_selects_equal_branch(rng, zero):
    # a state four iterations in, its rho forced to an exact zero (None:
    # left as it is): the selects give the branch's bits
    cplx = isinstance(zero, complex)
    a = _convdiff2d(10) + (0.2j * sp.eye(100) if cplx else 0)
    _, pmv = _pair(a.tocsr())
    b = rng.standard_normal(100) + (1j * rng.standard_normal(100) if cplx
                                    else 0)
    c, _ = ps.bicgstab_start(pmv, torch.from_numpy(b))
    for _ in range(4):
        c = ps.bicgstab_step(pmv, c)
    if zero is not None:
        c = (*c[:3], torch.tensor(zero, dtype=c[3].dtype), *c[4:])
    got = ps.bicgstab_step(pmv, c)
    brk = torch.tensor(zero is not None)
    flagged = ps.bicgstab_step(pmv, c, brk=brk)
    want = _branch_step(pmv, c)
    for g, f, w in zip(got, flagged, want):
        assert torch.equal(g, w) and torch.equal(f, w)


class TestTestKernelTwin:
    @staticmethod
    def _decide(rr, atol2, it0, maxiter, dtype=torch.float64):
        it = torch.tensor(it0, dtype=torch.int32)
        go = torch.zeros((), dtype=torch.int32)
        out = kl.krylov_test(torch.tensor(rr, dtype=dtype),
                             torch.tensor(atol2, dtype=dtype), it, maxiter,
                             bump=0, go=go)
        assert int(go) == int(out)
        return out

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_edge_inputs(self, dtype):
        npd = np.float32 if dtype == torch.float32 else np.float64
        one = npd(1.0)
        up, down = np.nextafter(one, npd(2)), np.nextafter(one, npd(0))
        cases = [((one, one, 0, 5), False), ((up, one, 0, 5), True),
                 ((down, one, 0, 5), False), ((np.nan, one, 0, 5), False),
                 ((2.0, one, 4, 5), True), ((2.0, one, 5, 5), False),
                 ((2.0, one, 0, 0), False), ((0.0, 0.0, 0, 5), False)]
        for args, want in cases:
            assert self._decide(*args, dtype=dtype) is want, args
            # the host loop's own comparison
            host = args[2] < args[3] and bool(
                torch.tensor(args[0], dtype=dtype)
                > torch.tensor(args[1], dtype=dtype))
            assert host is want

    def test_bump_flag_and_log(self):
        log = kl.IterationLog(CPU, cap=2)
        for _ in range(4):
            log.add_node([0] * len(loop.GRAPH_KERNELS))
        it = torch.zeros((), dtype=torch.int32)
        rr, atol2 = (torch.tensor(x, dtype=torch.float64) for x in (2, 1))
        brk = torch.ones((), dtype=torch.bool)
        for rho, want in ((1.0, False), (-0.0, True), (0j, True),
                          (1e-300j, False)):
            kl.krylov_test(rr, atol2, it, 9, bump=1,
                           rho=torch.tensor(rho, dtype=(
                               torch.complex128 if isinstance(rho, complex)
                               else torch.float64)), brk=brk, log=log)
            assert bool(brk) is want
        assert int(it) == 4 and log.array[0] == 0
        for node, maxiter in ((3, 4), (1, 6)):
            assert not kl.krylov_test(rr, atol2, it, maxiter, bump=1,
                                      log=log, node=node)
        assert log.array[:5].tolist() == [2, 3, 5, 1, 6]
        assert log.drain() == [5, 6] and log.drain() == []
        for _ in range(3):
            kl.krylov_test(rr, atol2, it, 0, bump=0, log=log)
        with pytest.raises(RuntimeError, match="past its 2 entries"):
            log.drain()

    def test_checks(self):
        it = torch.zeros((), dtype=torch.int32)
        one = torch.tensor(1.0, dtype=torch.float64)
        with pytest.raises(ValueError, match="0-d float32/float64"):
            kl.krylov_test(one, one.float(), it, 3, bump=0)
        with pytest.raises(ValueError, match="0-d int32"):
            kl.krylov_test(one, one, it.long(), 3, bump=0)
        with pytest.raises(ValueError, match="bool brk"):
            kl.krylov_test(one, one, it, 3, bump=0, rho=one)
        with pytest.raises(ValueError, match="bool brk"):
            kl.krylov_test(one, one, it, 3, bump=0, rho=one.float(),
                           brk=torch.zeros((), dtype=torch.bool))
        with pytest.raises(ValueError, match="no while-node graphs"):
            kl.require(CPU)


def test_launch_accounting_of_a_body():
    # a node whose body launched an IC(0)-CG iteration's kernels (the
    # product, six sweeps of the DIA kernel's epilogue form, cg_xr and
    # cg_p_test, which runs the loop test: no test launch of its own):
    # the log adds them times each loop's iterations
    log = kl.IterationLog(CPU)
    names = [f.__name__ for f in loop.GRAPH_KERNELS]
    per = {"dia_matvec": 1, "dia_matvec_sub": 6, "cg_xr": 1,
           "cg_p_test": 1}
    delta = [per.get(k, 0) for k in names]
    assert log.add_node([0] * len(names)) == 0
    assert log.add_node(delta) == 1
    for node, its in ((1, 12), (0, 5), (1, 30)):
        c = int(log.array[0])
        log.array[1 + 2 * c:3 + 2 * c] = (node, its)
        log.array[0] = c + 1
    before = [f.launches for f in loop.GRAPH_KERNELS]
    try:
        assert log.drain() == [12, 5, 30]
        got = {f.__name__: f.launches - b
               for f, b in zip(loop.GRAPH_KERNELS, before)}
        assert got == {k: 42 * per.get(k, 0) for k in names}
        assert kl.krylov_test.launches == before[names.index("krylov_test")]
        assert cuda_dia.dia_matvec.launches - before[
            names.index("dia_matvec")] == 42
    finally:
        for f, b in zip(loop.GRAPH_KERNELS, before):
            f.launches = b


def test_iterations_bookkeeping(rng):
    # host-loop calls append at once; a graph's loops come from the log
    # when it is read, in the order they ran, before a later call's
    a = _lap2d(8)
    _, pmv = _pair(a)
    solve = ps.make_iterative_solve(pmv, symmetric=True, tol=1e-12,
                                    maxiter=200)
    b = torch.from_numpy(rng.standard_normal(64))
    solve(b)
    first = solve.iterations[0]
    log = solve._log = kl.IterationLog(CPU)
    log.add_node([0] * len(loop.GRAPH_KERNELS))
    log.array[:5] = (2, 0, 11, 0, 13)
    solve.settle()
    solve(b)
    assert solve.iterations == [first, 11, 13, first]
    assert solve.on_graph == [False, True, True, False]


def _v0(n):
    return np.random.default_rng(0).uniform(-1, 1, n)


@pytest.mark.parametrize("kind", ["cg", "bicgstab"])
def test_capturable_operator_on_cpu(kind):
    # declared capturable or not, the CPU runs the same host loops: equal
    # bits, counts and counters; the reference's values within 1e-9
    n = 120
    sym = kind == "cg"
    if sym:
        opj, a = jmodels.laplacian_1d(n, dtype=np.float64)
        opp, _ = pmodels.laplacian_1d(n, dtype=np.float64, device="cpu")
        pcj = js.ilu0_preconditioner(a, symmetric=True)
        pcp = ps.ilu0_preconditioner(a, symmetric=True, device="cpu")
        sigma = 0.0
    else:
        opj, a = jmodels.convection_diffusion_1d(n, rho=10.0,
                                                 dtype=np.float64)
        opp, _ = pmodels.convection_diffusion_1d(n, rho=10.0,
                                                 dtype=np.float64,
                                                 device="cpu")
        pcj = pcp = None
        sigma = 0.5

    def shifted_of(op):
        return lambda v: op.a_apply(v) - sigma * v

    kw = dict(k=3, which="LM", tol=1e-9, maxiter=300, v0=_v0(n),
              return_stats=True)
    runs, solves = [], []
    for capt in (True, False):
        solve = ps.make_iterative_solve(shifted_of(opp), symmetric=sym,
                                        tol=1e-12, maxiter=2000,
                                        precond=pcp)
        op = ptransforms.shift_invert_operator(
            n, np.float64, solve, sigma=sigma, mode=3, n_pad=opp.n_pad,
            hermitian=sym, a_apply=opp.a_apply, device="cpu",
            capturable=capt)
        assert op.capturable is capt and op.while_loops
        runs.append((pt.eigsh if sym else pt.eigs)(op, **kw))
        solves.append(solve)
    (v1, x1, o1), (v0, x0, o0) = runs
    assert np.array_equal(v1, v0) and np.array_equal(x1, x0)
    assert solves[0].iterations == solves[1].iterations
    s1, s0 = o1.stats, o0.stats
    assert (s1.n_iter, s1.nopx, s1.nrorth, s1.nrorthr) \
        == (s0.n_iter, s0.nopx, s0.nrorth, s0.nrorthr)
    jsolve = js.make_iterative_solve(shifted_of(opj), symmetric=sym,
                                     tol=1e-12, maxiter=2000, precond=pcj)
    jop = jtransforms.shift_invert_operator(
        n, np.float64, jsolve, sigma=sigma, mode=3, n_pad=opj.n_pad,
        hermitian=sym, a_apply=opj.a_apply)
    ref = (at.eigsh if sym else at.eigs)(jop, **kw)[0]
    got = np.sort_complex(np.asarray(v1, complex))
    want = np.sort_complex(np.asarray(ref, complex))
    assert np.all(np.abs(got - want) <= 1e-9 * np.maximum(1, np.abs(want)))


def test_mesh_lifts_while_loop_operator_uncaptured():
    # a mesh lifts an operator whose solves become while loops without
    # its capturable declaration (NCCL beside a conditional body is
    # unverified); any other capturable operator keeps it
    from arpack_ng_tpu_torch.parallel.sharding import RowMesh, mesh_operator
    mesh = object.__new__(RowMesh)
    mesh.rank, mesh.size, mesh.device = 0, 1, CPU
    mesh.gather = lambda v: v
    opp, _ = pmodels.laplacian_1d(64, dtype=np.float64, device="cpu")
    solve = ps.make_iterative_solve(opp.a_apply, symmetric=True)
    si = ptransforms.shift_invert_operator(
        64, np.float64, solve, sigma=0.0, n_pad=opp.n_pad, hermitian=True,
        a_apply=opp.a_apply, device="cpu", capturable=True)
    assert si.capturable and si.while_loops and opp.capturable
    assert not mesh_operator(si, mesh).capturable
    assert mesh_operator(opp, mesh).capturable
