"""The inner solves' fused update kernels and the DIA kernel's epilogue
form (``arpack_ng_tpu_torch/ops/cuda_krylov_loop.py``, ``ops/cuda_dia.
dia_matvec_sub``) on the CPU, where each wrapper runs its plain twin:

* ``cg_step`` / ``bicgstab_step``, now composed of the update kernels'
  twins, bit for bit the torch ops they replaced (copied below as
  ``_old_cg_step``, ``_old_bicgstab_step``), in float32, float64,
  complex64 and complex128, with and without a preconditioner (``z`` is
  ``r``), on a nan, and through BiCGSTAB's ``rho == 0`` restart; the
  in-place iterations (``_cg_iteration``, ``_bicg_iteration``: the
  wrappers on the loop's buffers) bit for bit those steps; the wrappers
  against their twins on edge inputs (``chip_smoke.
  krylov_update_faults``), the loop test they end with against the
  host's, ``maxiter`` edges of the node's CPU form against the host loop;
* ``dia_matvec_sub``'s three forms bit for bit ``y - A x``, ``d (y - A
  x)`` and ``y - d (A x)`` of ``dia_matvec_plain`` on the tables of
  ``tests/torch_dia_cases.py``, into ``out`` or a new vector, and its
  checks;
* ``ilu0_preconditioner`` (IC(0) and ILU(0), 1-4 sweeps, padded, into
  ``out``, a complex table) bit for bit its form before the epilogue
  kernel (``_old_apply``: a DIA product, then the subtraction and the
  scaling as torch ops), and within 1e-12 relative of the reference's
  ``ilu0_preconditioner`` (float64);
* ``cg`` / ``bicgstab`` with IC(0) / ILU(0) within 1e-10 relative of the
  reference's (the tolerance of ``tests/test_torch_solvers.py::
  TestKrylov``).

The kernels against their twins on a card: ``tests/test_torch_gpu.py``
(``test_update_kernels_match_twins_on_card``,
``test_fused_loop_test_edge_inputs_on_card``,
``test_dia_matvec_sub_matches_twin_on_card``)."""
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import chip_smoke  # noqa: E402
import torch_dia_cases as dia_cases  # noqa: E402
from arpack_ng_tpu.ops import solvers as js  # noqa: E402
from arpack_ng_tpu.ops import sparse as jsparse  # noqa: E402
from arpack_ng_tpu_torch.ops import cuda_dia  # noqa: E402
from arpack_ng_tpu_torch.ops import cuda_krylov_loop as kl  # noqa: E402
from arpack_ng_tpu_torch.ops import solvers as ps  # noqa: E402
from arpack_ng_tpu_torch.ops import sparse as psparse  # noqa: E402

CPU = torch.device("cpu")
DTYPES = ["float32", "float64", "complex64", "complex128"]


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


def _old_cg_step(matvec, c, precond=None):
    """``solvers.cg_step`` before the update kernels."""
    x, r, z, p, rz = c
    ap = matvec(p)
    alpha = rz / torch.vdot(p, ap)
    x = x + alpha * p
    r = r - alpha * ap
    z = precond(r) if precond is not None else r
    rz_new = torch.vdot(r, z)
    beta = rz_new / rz
    p = z + beta * p
    return (x, r, z, p, rz_new)


def _old_bicgstab_step(matvec, c, precond=None):
    """``solvers.bicgstab_step`` before the update kernels."""
    x, r, rhat, rho, alpha, omega, v, p = c
    brk = rho == 0
    rhat = torch.where(brk, r, rhat)
    rho, alpha, omega = (torch.where(brk, 1.0, s) for s in (rho, alpha,
                                                             omega))
    v, p = torch.where(brk, 0.0, v), torch.where(brk, 0.0, p)
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
    x = x + alpha * ph + omega * sh
    r = s - omega * t
    return (x, r, rhat, rho_new, alpha, omega, v, p)


def _same(a, b):
    return chip_smoke._bit_faults(torch, a, b) == 0


def _problem(dtype, symmetric, nx=8):
    """A seeded system of ``dtype``: the matvec (a DIA product), a
    Jacobi preconditioner and a right-hand side."""
    a = _lap2d(nx) if symmetric else _convdiff2d(nx)
    if dtype.is_complex:
        a = (a + (0.0 if symmetric else 0.2j) * sp.eye(a.shape[0])).tocsr()
    npd = {torch.float32: np.float32, torch.float64: np.float64,
           torch.complex64: np.complex64,
           torch.complex128: np.complex128}[dtype]
    a = a.astype(npd)
    n = a.shape[0]
    off, diags = psparse._to_dia(a)
    mv = psparse.dia_matvec_fn(off, diags, n, n, device="cpu")
    rng = np.random.default_rng(5)
    b = rng.standard_normal(n)
    if dtype.is_complex:
        b = b + 1j * rng.standard_normal(n)
    jac = ps.jacobi_preconditioner(torch.from_numpy(a.diagonal()))
    return mv, jac, torch.from_numpy(b.astype(npd))


class TestUpdateTwins:
    @pytest.mark.parametrize("precond", [False, True])
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_cg_step_equals_old_ops_and_in_place(self, dtype, precond):
        dt = getattr(torch, dtype)
        mv, jac, b = _problem(dt, True)
        pc = jac if precond else None
        c, _ = ps.cg_start(mv, b, None, 1e-8, pc)
        old = c
        carry = ps._cg_carry([t.clone() for t in c], pc)
        assert (carry[2] is carry[1]) is not precond
        for _ in range(6):
            c = ps.cg_step(mv, c, pc)
            old = _old_cg_step(mv, old, pc)
            ps._cg_iteration(mv, carry, pc)
            for i in range(5):
                assert _same(c[i], old[i]) and _same(carry[i], c[i]), i

    @pytest.mark.parametrize("precond", [False, True])
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_bicgstab_step_equals_old_ops_and_in_place(self, dtype,
                                                       precond):
        dt = getattr(torch, dtype)
        mv, jac, b = _problem(dt, False)
        pc = jac if precond else None
        c, _ = ps.bicgstab_start(mv, b)
        old = c
        carry = ps._bicg_carry([t.clone() for t in c])
        for k in range(6):
            if k == 3:
                # an exact zero rho: the next iteration restarts
                zero = torch.zeros((), dtype=dt)
                c = (*c[:3], zero, *c[4:])
                old = (*old[:3], zero, *old[4:])
                carry[3].zero_()
                carry[8].fill_(True)
                carry[2].copy_(carry[1])      # the last kernel's rhat = r
            c = ps.bicgstab_step(mv, c, pc)
            old = _old_bicgstab_step(mv, old, pc)
            ps._bicg_iteration(mv, carry, pc)
            for i in range(8):
                assert _same(c[i], old[i]) and _same(carry[i], c[i]), (k, i)

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_wrappers_equal_twins_on_edge_inputs(self, dtype):
        faults, err = chip_smoke.krylov_update_faults(
            torch, CPU, getattr(torch, dtype), 257)
        assert faults == [] and not any(err.values())

    def test_nan_stops_both_loops(self):
        # a nan in b makes |r.r| nan: the test fails before any iteration,
        # in the host loop and the node's CPU form alike
        mv, _, b = _problem(torch.float64, True)
        b = b.clone()
        b[3] = float("nan")
        for symmetric in (True, False):
            host = ps._cg if symmetric else ps._bicgstab
            x_host, it_host = host(mv, b, None, 1e-10, 50, None)
            solve = ps.IterativeSolve(mv, symmetric, 1e-10, 50, None)
            log = kl.IterationLog(CPU)
            x_node = ps._loop(solve._start, solve._step, b, 1e-10, 50, log,
                              not symmetric)
            assert it_host == 0 and log.drain() == [0]
            assert _same(x_node, x_host)

    @pytest.mark.parametrize("maxiter", [0, 1, 2, 7])
    @pytest.mark.parametrize("symmetric", [True, False])
    def test_maxiter_edges(self, symmetric, maxiter):
        mv, jac, b = _problem(torch.float64, symmetric)
        host = ps._cg if symmetric else ps._bicgstab
        x_host, it_host = host(mv, b, None, 1e-14, maxiter, jac)
        solve = ps.IterativeSolve(mv, symmetric, 1e-14, maxiter, jac)
        log = kl.IterationLog(CPU)
        x_node = ps._loop(solve._start, solve._step, b, 1e-14, maxiter, log,
                          not symmetric)
        assert log.drain() == [it_host] == [maxiter]
        assert _same(x_node, x_host)

    def test_fused_loop_test_twin(self):
        assert chip_smoke.fused_test_faults(torch, CPU) == []

    def test_checks(self):
        v = [torch.ones(5, dtype=torch.float64) for _ in range(4)]
        s = [torch.ones((), dtype=torch.float64) for _ in range(3)]
        with pytest.raises(ValueError, match="one length"):
            kl.cg_xr(s[0], s[1], v[0], v[1], v[2],
                     torch.ones(4, dtype=torch.float64), s[2])
        with pytest.raises(ValueError, match="scalars must be 0-d"):
            kl.cg_xr(s[0].float(), s[1], *v, s[2])
        with pytest.raises(ValueError, match="0-d bool"):
            kl.bicg_p(s[0], *s, s[0], *v[:3])
        test = kl.LoopTest(s[0].float(), torch.zeros((), dtype=torch.int32),
                           3)
        with pytest.raises(ValueError, match="atol2"):
            kl.cg_p_test(s[0], s[1], v[0], v[1], s[2], rr=s[0], test=test)
        with pytest.raises(ValueError, match="no kernel for device"):
            kl.cg_xr(*(t.to("meta") for t in (s[0], s[1], *v, s[2])))


class TestDiaSub:
    @pytest.mark.parametrize("case", sorted(dia_cases.CASES))
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_forms_equal_product_and_ops(self, dtype, case):
        offsets, dtab, X, n = dia_cases.make(case, dtype, 3)
        offs, tab = torch.from_numpy(offsets), torch.from_numpy(dtab)
        x, y, d = (torch.from_numpy(X[i]) for i in range(3))
        ax = cuda_dia.dia_matvec_plain(offs, tab, x, n)
        want = {cuda_dia.SUB: y - ax, cuda_dia.SCALE_SUB: d * (y - ax),
                cuda_dia.SUB_SCALED: y - d * ax}
        for form, w in want.items():
            assert _same(cuda_dia.dia_matvec_sub_plain(offs, tab, x, n, y,
                                                       d, form), w)
            out = torch.empty_like(x)
            got = cuda_dia.dia_matvec_sub(offs, tab, x, n, y, d, form,
                                          out=out)
            assert got is out and _same(out, w)
            assert _same(cuda_dia.dia_matvec_sub(offs, tab, x, n, y, d,
                                                 form), w)

    def test_checks(self):
        offsets, dtab, X, n = dia_cases.make("odd_pad", np.float64, 3)
        offs, tab = torch.from_numpy(offsets), torch.from_numpy(dtab)
        x, y = torch.from_numpy(X[0]), torch.from_numpy(X[1])
        with pytest.raises(ValueError, match="overlap"):
            cuda_dia.dia_matvec_sub(offs, tab, x, n, y, out=x)
        with pytest.raises(ValueError, match="unknown form"):
            cuda_dia.dia_matvec_sub(offs, tab, x, n, y, form=3)
        with pytest.raises(ValueError, match="vectors of length"):
            cuda_dia.dia_matvec_sub(offs, tab, x, n, y,
                                    form=cuda_dia.SCALE_SUB)
        with pytest.raises(ValueError, match="vectors of length"):
            cuda_dia.dia_matvec_sub(offs, tab, x, n, y.float())

    @pytest.mark.parametrize("kind", ["real", "complex", "empty"])
    def test_dia_sub_fn(self, kind):
        rng = np.random.default_rng(9)
        n, n_pad = 300, 384
        if kind == "empty":
            off, diags = [], []
        else:
            off = [-17, -1, 2]
            diags = [rng.standard_normal(n) for _ in off]
            if kind == "complex":
                diags = [d + 1j * rng.standard_normal(n) for d in diags]
        dt = np.complex128 if kind == "complex" else np.float64
        mv = psparse.dia_matvec_fn(off, diags, n, n_pad, device="cpu")
        sub = psparse.dia_sub_fn(off, diags, n, n_pad, device="cpu")
        x, y, d = (torch.from_numpy(rng.standard_normal(n_pad).astype(dt))
                   for _ in range(3))
        ax = mv(x)
        assert _same(sub(x, y), y - ax)
        assert _same(sub(x, y, d, cuda_dia.SCALE_SUB), d * (y - ax))
        out = torch.empty_like(x)
        assert sub(x, y, d, cuda_dia.SUB_SCALED, out=out) is out
        assert _same(out, y - d * ax)


def _recorded(a, **kw):
    """``ps.ilu0_preconditioner(a, **kw)`` on the CPU and its pre-PR
    application, built from the tables and ``dinv`` it handed to
    ``dia_sub_fn``: each sweep a DIA product, then the subtraction and
    the scaling as separate torch ops."""
    tables, seen_d, real = [], [], psparse.dia_sub_fn

    def rec(off, diags, n, n_pad, device):
        tables.append((off, diags, n, n_pad))
        sub = real(off, diags, n, n_pad, device=device)

        def wrapped(x, y, d=None, form=cuda_dia.SUB, out=None):
            if d is not None:
                seen_d.append(d)
            return sub(x, y, d, form, out)

        return wrapped

    with mock.patch.object(psparse, "dia_sub_fn", rec):
        pc = ps.ilu0_preconditioner(a, device="cpu", **kw)
    lmv, tmv = (psparse.dia_matvec_fn(*t, device="cpu") for t in tables)
    n, sweeps = a.shape[0], kw.get("sweeps", 3)
    symmetric = kw.get("symmetric", False)

    def old_apply(r):
        if not seen_d:            # dinv: the scaling the sweeps are given
            pc(r)
        dinv = seen_d[0]
        rn = r[:n].contiguous()
        z = rn
        for _ in range(sweeps):
            z = rn - lmv(z)
        v = dinv * z
        y = v
        for _ in range(sweeps):
            y = v - tmv(y) if symmetric else v - dinv * tmv(y)
        if r.shape[0] == n:
            return y
        out = torch.zeros(r.shape, dtype=y.dtype)
        out[:n] = y
        return out

    return pc, old_apply


class TestPreconditioner:
    @pytest.mark.parametrize("n_pad", [0, 640])
    @pytest.mark.parametrize("sweeps", [1, 2, 3, 4])
    @pytest.mark.parametrize("symmetric", [True, False])
    def test_equals_old_form_and_reference(self, symmetric, sweeps, n_pad):
        a = _lap2d(24) if symmetric else _convdiff2d(24)
        n = a.shape[0]
        pc, old = _recorded(a, symmetric=symmetric, sweeps=sweeps,
                            n_pad=n_pad)
        rng = np.random.default_rng(sweeps)
        r = rng.standard_normal(n_pad or n)
        r[n:] = 0
        rt = torch.from_numpy(r)
        z = pc(rt)
        assert _same(z, old(rt))
        out = torch.full_like(rt, float("nan"))
        assert pc(rt, out=out) is out and _same(out, z)
        if n_pad:
            assert not z[n:].any()
        zj = np.asarray(js.ilu0_preconditioner(
            a, symmetric=symmetric, sweeps=sweeps, n_pad=n_pad)(
            jnp.asarray(r)))
        assert np.linalg.norm(z.numpy() - zj) <= 1e-12 * np.linalg.norm(zj)

    def test_complex_table_keeps_twin_path(self):
        a = (_convdiff2d(12) + 0.3j * sp.eye(144)).tocsr()
        pc, old = _recorded(a)
        rng = np.random.default_rng(3)
        r = torch.from_numpy(rng.standard_normal(144)
                             + 1j * rng.standard_normal(144))
        assert _same(pc(r), old(r))
        before = cuda_dia.dia_matvec_sub.launches
        pc(r)
        assert cuda_dia.dia_matvec_sub.launches == before


class TestSolvesAgainstReference:
    @pytest.mark.parametrize("symmetric", [True, False])
    def test_solves_match_reference(self, rng, symmetric):
        a = _lap2d(16) if symmetric else _convdiff2d(16)
        n = a.shape[0]
        b = rng.standard_normal(n)
        off, diags = jsparse._to_dia(a)
        jmv = jsparse.dia_matvec_fn(off, diags, n, n)
        pmv = psparse.dia_matvec_fn(off, diags, n, n, device="cpu")
        pcj = js.ilu0_preconditioner(a, symmetric=symmetric)
        pcp = ps.ilu0_preconditioner(a, symmetric=symmetric, device="cpu")
        kw = dict(tol=1e-12, maxiter=500)
        ref = (js.cg if symmetric else js.bicgstab)(
            jmv, jnp.asarray(b), precond=pcj, **kw)
        got = (ps.cg if symmetric else ps.bicgstab)(
            pmv, torch.from_numpy(b), precond=pcp, **kw)
        assert np.linalg.norm(got.numpy() - np.asarray(ref)) \
            <= 1e-10 * np.linalg.norm(np.asarray(ref))
