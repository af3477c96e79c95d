"""The linear solvers of ``arpack_ng_tpu_torch.ops.solvers`` and the DIA
product ``ops.sparse.dia_matvec_fn`` against the reference package's
(``arpack_ng_tpu/ops/solvers.py``, ``ops/sparse.py``), on the same seeded
numpy inputs in float64:

* CG and BiCGSTAB, plain and with Jacobi and ILU(0) preconditioning:
  solutions within 1e-10 relative of the reference's, and the reference's
  loop test (``maxiter``, no iteration for a zero right-hand side);
* ``make_direct_inverse`` (every kind, padding, sparse SuperLU): within
  1e-12 of the reference's, with the same ``ValueError``s
  (tests/test_sweep_cli.py::TestDirectMenu);
* ``ilu0_preconditioner``: applications within 1e-12 (IC(0) and ILU(0)
  forms), its quality (tests/test_ilu.py::TestILU0) and the Jacobi
  fallbacks with their warnings (indefinite, zero diagonal, more than 128
  diagonals);
* ``dia_matvec_fn``: within 1e-14 of the reference's, strict triangles
  and offsets past ``n`` included."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import scipy.sparse.linalg as spla  # noqa: E402

from arpack_ng_tpu.ops import solvers as js  # noqa: E402
from arpack_ng_tpu.ops import sparse as jsparse  # noqa: E402
from arpack_ng_tpu_torch.ops import solvers as ps  # noqa: E402
from arpack_ng_tpu_torch.ops import sparse as psparse  # noqa: E402


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
    """The same DIA matvec in both packages, on length-n vectors."""
    n = a.shape[0]
    off, diags = jsparse._to_dia(a)
    return (jsparse.dia_matvec_fn(off, diags, n, n),
            psparse.dia_matvec_fn(off, diags, n, n, device="cpu"))


def _rel(x, ref):
    return np.linalg.norm(np.asarray(x) - np.asarray(ref)) \
        / np.linalg.norm(np.asarray(ref))


class TestKrylov:
    @pytest.mark.parametrize("precond", [None, "jacobi", "ilu"])
    def test_cg_matches_reference(self, rng, precond):
        a = _lap2d(16)
        b = rng.standard_normal(a.shape[0])
        jmv, pmv = _pair(a)
        pcj = pcp = None
        if precond == "jacobi":
            pcj = js.jacobi_preconditioner(jnp.asarray(a.diagonal()))
            pcp = ps.jacobi_preconditioner(torch.from_numpy(a.diagonal()))
        elif precond == "ilu":
            pcj = js.ilu0_preconditioner(a, symmetric=True)
            pcp = ps.ilu0_preconditioner(a, symmetric=True, device="cpu")
        kw = dict(tol=1e-12, maxiter=500)
        xj = js.cg(jmv, jnp.asarray(b), precond=pcj, **kw)
        xp = ps.cg(pmv, torch.from_numpy(b), precond=pcp, **kw)
        assert _rel(xp, xj) < 1e-10
        assert np.linalg.norm(a @ xp.numpy() - b) <= 1e-12 * \
            np.linalg.norm(b)
        solve = ps.make_iterative_solve(pmv, symmetric=True, precond=pcp,
                                        **kw)
        assert torch.equal(solve(torch.from_numpy(b)), xp)
        assert 0 < solve.iterations[0] < 500

    @pytest.mark.parametrize("precond", [None, "jacobi", "ilu"])
    def test_bicgstab_matches_reference(self, rng, precond):
        a = _convdiff2d(16)
        b = rng.standard_normal(a.shape[0])
        jmv, pmv = _pair(a)
        pcj = pcp = None
        if precond == "jacobi":
            pcj = js.jacobi_preconditioner(jnp.asarray(a.diagonal()))
            pcp = ps.jacobi_preconditioner(torch.from_numpy(a.diagonal()))
        elif precond == "ilu":
            pcj = js.ilu0_preconditioner(a)
            pcp = ps.ilu0_preconditioner(a, device="cpu")
        kw = dict(tol=1e-12, maxiter=500)
        xj = js.bicgstab(jmv, jnp.asarray(b), precond=pcj, **kw)
        xp = ps.bicgstab(pmv, torch.from_numpy(b), precond=pcp, **kw)
        assert _rel(xp, xj) < 1e-10
        assert np.linalg.norm(a @ xp.numpy() - b) <= 1e-12 * \
            np.linalg.norm(b)

    @pytest.mark.parametrize("solver", ["cg", "bicgstab"])
    def test_maxiter_and_zero_rhs(self, rng, solver):
        # the loop test: never more than maxiter iterations, none for b = 0
        a = _lap2d(16)
        _, pmv = _pair(a)
        solve = ps.make_iterative_solve(pmv, symmetric=solver == "cg",
                                        tol=1e-14, maxiter=3)
        solve(torch.from_numpy(rng.standard_normal(a.shape[0])))
        x = solve(torch.zeros(a.shape[0], dtype=torch.float64))
        assert solve.iterations == [3, 0] and not x.any()

    def test_complex_bicgstab_matches_reference(self, rng):
        a = (_convdiff2d(12) + 0.3j * sp.eye(144)).tocsr()
        b = rng.standard_normal(144) + 1j * rng.standard_normal(144)
        jmv, pmv = _pair(a)
        xj = js.bicgstab(jmv, jnp.asarray(b), tol=1e-12, maxiter=500)
        xp = ps.bicgstab(pmv, torch.from_numpy(b), tol=1e-12, maxiter=500)
        assert _rel(xp, xj) < 1e-10


class TestDirectMenu:
    """tests/test_sweep_cli.py::TestDirectMenu on the port, each inverse
    within 1e-12 of the reference's."""

    @staticmethod
    def _spd(n=24, seed=0):
        rng = np.random.default_rng(seed)
        q = rng.standard_normal((n, n)) * 0.1
        return np.eye(n) + q @ q.T

    @pytest.mark.parametrize("kind", ["LU", "QR", "LLT", "LDLT"])
    def test_make_direct_inverse_all_kinds(self, kind):
        a = self._spd()
        inv = ps.make_direct_inverse(a, kind)
        np.testing.assert_allclose(inv, js.make_direct_inverse(a, kind),
                                   rtol=0, atol=1e-12)
        assert np.allclose(inv @ a, np.eye(a.shape[0]), atol=1e-8)

    def test_sparse_superlu_and_padding(self):
        a = sp.csr_matrix(self._spd(300))
        inv = ps.make_direct_inverse(a, "LU", n_pad=384)
        np.testing.assert_allclose(
            inv, js.make_direct_inverse(a, "LU", n_pad=384), rtol=0,
            atol=1e-12)
        assert np.allclose(inv[300:, 300:], np.eye(84))

    def test_llt_rejects_indefinite(self):
        a = np.diag(np.array([1.0, -2.0, 3.0]))
        for mod in (js, ps):
            with pytest.raises(ValueError, match="SPD"):
                mod.make_direct_inverse(a, "LLT")
        np.testing.assert_allclose(ps.make_direct_inverse(a, "LDLT"),
                                   js.make_direct_inverse(a, "LDLT"),
                                   rtol=0, atol=1e-12)

    def test_qr_pivot_threshold_rank_test(self):
        a = np.diag(np.array([1.0, 1.0, 1e-9]))
        for mod in (js, ps):
            with pytest.raises(ValueError, match="rank"):
                mod.make_direct_inverse(a, "QR", pivot=1e-6)
        inv = ps.make_direct_inverse(a, "QR", pivot=1e-12)
        np.testing.assert_allclose(
            inv, js.make_direct_inverse(a, "QR", pivot=1e-12), rtol=1e-12)

    def test_llt_offset_scale(self):
        s = np.diag(np.array([1.0, -0.5, 2.0]))
        inv = ps.make_direct_inverse(s, "LLT", offset=1.0, scale=1.0)
        np.testing.assert_allclose(
            inv, js.make_direct_inverse(s, "LLT", offset=1.0, scale=1.0),
            rtol=0, atol=1e-12)
        assert np.allclose(inv @ (s + np.eye(3)), np.eye(3), atol=1e-10)

    def test_ldlt_complex_hermitian(self):
        rng = np.random.default_rng(3)
        a = rng.standard_normal((12, 12)) + 1j * rng.standard_normal((12, 12))
        h = (a + a.conj().T) / 2
        inv = ps.make_direct_inverse(h, "LDLT")
        np.testing.assert_allclose(inv, js.make_direct_inverse(h, "LDLT"),
                                   rtol=0, atol=1e-12)

    def test_padding_is_identity(self):
        a = self._spd(10)
        inv = ps.make_direct_inverse(a, "QR", n_pad=16)
        assert inv.shape == (16, 16)
        assert np.allclose(inv[10:, 10:], np.eye(6))

    @pytest.mark.parametrize("case", ["singular", "kind"])
    def test_errors(self, case):
        a = np.diag(np.array([1.0, 0.0, 2.0]))
        kind, match = ("LU", "singular") if case == "singular" else \
            ("XYZ", "unknown direct solver")
        for mod in (js, ps):
            with pytest.raises(ValueError, match=match):
                mod.make_direct_inverse(a, kind)


class TestILU0:
    """tests/test_ilu.py::TestILU0 on the port, applications within 1e-12
    of the reference's."""

    @pytest.mark.parametrize("symmetric", [False, True])
    @pytest.mark.parametrize("n_pad", [0, 1664])
    def test_application_matches_reference(self, rng, symmetric, n_pad):
        a = _lap2d(40)
        n = a.shape[0]
        r = np.zeros(n_pad or n)
        r[:n] = rng.standard_normal(n)
        pcj = js.ilu0_preconditioner(a, sweeps=4, symmetric=symmetric)
        pcp = ps.ilu0_preconditioner(a, sweeps=4, symmetric=symmetric,
                                     device="cpu")
        zj = np.asarray(pcj(jnp.asarray(r)))
        zp = pcp(torch.from_numpy(r)).numpy()
        assert zp.shape == r.shape and not zp[n:].any()
        np.testing.assert_allclose(zp, zj, rtol=0,
                                   atol=1e-12 * np.abs(zj).max())

    def test_matches_exact_triangular_solve_quality(self, rng):
        a = _lap2d(40)
        r = rng.standard_normal(a.shape[0])
        ilu = spla.spilu(a.tocsc(), drop_tol=0.0, fill_factor=1.0,
                         permc_spec="NATURAL", diag_pivot_thresh=0.0)
        q_exact = np.linalg.norm(r - a @ ilu.solve(r)) / np.linalg.norm(r)
        z = ps.ilu0_preconditioner(a, sweeps=4, device="cpu")(
            torch.from_numpy(r)).numpy()
        q_trunc = np.linalg.norm(r - a @ z) / np.linalg.norm(r)
        assert abs(q_trunc - q_exact) < 0.02

    def test_indefinite_amplification_falls_back(self, rng):
        n = 300
        t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
        m = sp.diags([1 / 6, 4 / 6, 1 / 6], [-1, 0, 1], shape=(n, n))
        s = (t - 0.5 * m).tocsr()
        with pytest.warns(UserWarning, match="quality probe"):
            pc = ps.ilu0_preconditioner(s, device="cpu")
        r = rng.standard_normal(n)
        z = pc(torch.from_numpy(r)).numpy()
        assert np.allclose(z, r / s.diagonal())
        with pytest.warns(UserWarning, match="quality probe"):
            zj = np.asarray(js.ilu0_preconditioner(s)(jnp.asarray(r)))
        np.testing.assert_allclose(z, zj, rtol=1e-15)

    def test_zero_diagonal_falls_back(self):
        a = sp.csr_matrix(np.array([[0.0, 1.0], [1.0, 0.0]]))
        with pytest.warns(UserWarning) as got:
            pc = ps.ilu0_preconditioner(a, device="cpu")
        with pytest.warns(UserWarning) as want:
            js.ilu0_preconditioner(a)
        assert [str(w.message) for w in got] == \
            [str(w.message) for w in want]
        # the Jacobi fallback takes a zero diagonal entry as 1
        r = torch.tensor([3.0, 4.0], dtype=torch.float64)
        assert torch.equal(pc(r), r)

    def test_many_diagonals_fall_back(self, rng):
        # a diagonally dominant matrix with nonzeros on hundreds of
        # distinct diagonals: the DIA form of its factor would be huge
        n = 600
        rows = rng.integers(0, n, 3000)
        cols = rng.integers(0, n, 3000)
        off = sp.coo_matrix((rng.uniform(-1, 1, 3000), (rows, cols)),
                            shape=(n, n)).tocsr()
        a = (off + off.T + 20.0 * sp.eye(n)).tocsr()
        with pytest.warns(UserWarning, match="distinct diagonals"):
            pc = ps.ilu0_preconditioner(a, n_pad=640, device="cpu")
        r = np.zeros(640)
        r[:n] = rng.standard_normal(n)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            zj = np.asarray(js.ilu0_preconditioner(a, n_pad=640)(
                jnp.asarray(r)))
        np.testing.assert_allclose(pc(torch.from_numpy(r)).numpy(), zj,
                                   rtol=1e-15)


class TestDiaMatvecFn:
    @pytest.mark.parametrize("case", ["full", "lower", "upper"])
    def test_matches_reference(self, rng, case):
        # strict triangles hold offsets of one sign
        n, n_pad = 500, 640
        if case == "full":
            a = _convdiff2d(10)
            n = a.shape[0]
            off, diags = jsparse._to_dia(a)
        else:
            off = [-7, -3, -1] if case == "lower" else [1, 2, 40]
            diags = [rng.standard_normal(n) for _ in off]
        x = np.zeros(n_pad)
        x[:n] = rng.standard_normal(n)
        yj = np.asarray(jsparse.dia_matvec_fn(off, diags, n, n_pad)(
            jnp.asarray(x)))
        yp = psparse.dia_matvec_fn(off, diags, n, n_pad, device="cpu")(
            torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(yp, yj, rtol=0,
                                   atol=1e-14 * np.abs(yj).max())
        assert yp.shape == (n_pad,) and not yp[n:].any()

    def test_offsets_past_n_add_nothing(self, rng):
        # |d| >= n selects no entry: the product equals the one without
        # those offsets bit for bit (the reference's slicing cannot take
        # them) and scipy's
        n, n_pad = 500, 512
        off = [-n - 5, -n, -1, 1, n, n + 3]
        diags = [rng.standard_normal(n) for _ in off]
        x = torch.zeros(n_pad, dtype=torch.float64)
        x[:n] = torch.from_numpy(rng.standard_normal(n))
        y = psparse.dia_matvec_fn(off, diags, n, n_pad, device="cpu")(x)
        near = psparse.dia_matvec_fn(off[2:4], diags[2:4], n, n_pad,
                                     device="cpu")(x)
        assert torch.equal(y, near)
        a = sp.diags([diags[2][1:], diags[3][:-1]], [-1, 1], shape=(n, n))
        np.testing.assert_allclose(y[:n].numpy(), a @ x[:n].numpy(),
                                   rtol=1e-14)

    def test_no_diagonal_is_zero(self):
        mv = psparse.dia_matvec_fn([], [], 8, 8, device="cpu")
        assert not mv(torch.ones(8, dtype=torch.float64)).any()
