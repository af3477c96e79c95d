"""The thick restart (``restart='thick'``) and caller-supplied shifts
(``shift_fn``, the ido=3 protocol) of the port's symmetric drivers,
against the reference package on the same inputs and start vector;
mirrors tests/test_fused.py:77-116 and tests/test_regression.py:49-99.

Tolerances: in float64 the counters (restart cycles, nopx, nrorth,
nitref, nrotr) equal the reference's on spectra without multiple
eigenvalues, and the values agree within 1e-10 relative (thick: with the
selective and the dgks extension; shift_fn: through both drivers).  On the
2-D Laplacian, whose spectrum has double eigenvalues, which copy of a
double value the Krylov space picks up first follows rounding, so there
the values are held to the reference's and the implicit restart's at the
reference test's 1e-9 and the residuals at 1e-8, and the counters are not
compared.  Float32 keeps the reference test's basis-defect bound
``64 sqrt(eps)``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import scipy.sparse as sp  # noqa: E402

import arpack_ng_tpu as at  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.config import IRAMConfig as JConfig  # noqa: E402
from arpack_ng_tpu.core.device_sym import \
    FusedSymSolver as JFusedSymSolver  # noqa: E402
from arpack_ng_tpu.core.iram import IRAMSolver as JIRAMSolver  # noqa: E402
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402
from arpack_ng_tpu_torch.config import IRAMConfig  # noqa: E402
from arpack_ng_tpu_torch.core.device_sym import FusedSymSolver  # noqa: E402
from arpack_ng_tpu_torch.core.extract import extract  # noqa: E402
from arpack_ng_tpu_torch.core.iram import IRAMSolver  # noqa: E402

from conftest import residual  # noqa: E402

COUNTERS = ("nopx", "nrorth", "nitref", "nrotr")


def _counts(out):
    return (out.n_iter,) + tuple(getattr(out.stats, c) for c in COUNTERS)


def _v0(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, n)


def _diag_ops(d):
    n = d.shape[0]
    return (at.from_diagonal(d, n_pad=at.pad_dim(n)),
            pt.from_diagonal(d, n_pad=at.pad_dim(n), device="cpu"))


def _same(rj, rp, rtol=1e-10):
    """Equal counters and values within ``rtol`` relative (float64)."""
    (vj, _, oj), (vp, xp, op_) = rj, rp
    assert _counts(op_) == _counts(oj)
    np.testing.assert_allclose(vp, vj, rtol=rtol)
    return vp, xp


def _exact_shifts(ritz_unwanted, bounds_unwanted):
    """The shifts dsgets would pick: largest bound first."""
    return ritz_unwanted[np.argsort(-np.abs(bounds_unwanted),
                                    kind="stable")]


class TestThick:
    @pytest.mark.parametrize("which", ["LA", "SA", "LM"])
    def test_thick_matches_implicit_and_reference(self, which):
        # tests/test_fused.py::test_thick_restart_matches_implicit
        opj, a = jmodels.laplacian_2d(30, dtype=np.float64)
        opp, _ = pmodels.laplacian_2d(30, dtype=np.float64, device="cpu")
        kw = dict(k=4, which=which, ncv=20, tol=1e-10, maxiter=3000,
                  v0=_v0(opj.n))
        v_t, V_t = pt.eigsh(opp, restart="thick", **kw)
        v_i, _ = pt.eigsh(opp, restart="implicit", **kw)
        v_j = at.eigsh(opj, restart="thick", return_eigenvectors=False,
                       **kw)
        np.testing.assert_allclose(np.sort(v_t), np.sort(v_i), rtol=1e-9)
        np.testing.assert_allclose(np.sort(v_t), np.sort(v_j), rtol=1e-9)
        assert residual(a, v_t, V_t).max() < 1e-8

    @pytest.mark.parametrize("reorth", ["selective", "dgks"])
    @pytest.mark.parametrize("which", ["LA", "SA", "LM", "SM"])
    def test_thick_counters_match_reference(self, which, reorth):
        rng = np.random.default_rng(3)
        d = np.sort(rng.uniform(0.5, 80.0, 300))
        opj, opp = _diag_ops(d)
        kw = dict(k=4, which=which, ncv=16, tol=1e-10, maxiter=600,
                  v0=_v0(300), restart="thick", reorth=reorth,
                  return_stats=True)
        vals, vecs = _same(at.eigsh(opj, **kw), pt.eigsh(opp, **kw))
        key = {"LA": d, "SA": -d, "LM": np.abs(d), "SM": -np.abs(d)}[which]
        np.testing.assert_allclose(np.sort(vals),
                                   np.sort(d[np.argsort(key)][-4:]),
                                   rtol=1e-9)

    def test_thick_hermitian(self):
        # a complex Hermitian tridiagonal: T from H.real, the real rotation
        # on the complex basis
        n = 300
        rng = np.random.default_rng(4)
        off = rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1)
        a = (sp.diags(np.linspace(1.0, 30.0, n)) + sp.diags(off, 1)
             + sp.diags(off.conj(), -1)).toarray()
        kw = dict(k=4, which="LA", ncv=20, tol=1e-10, maxiter=600,
                  v0=_v0(n) + 0j, restart="thick", return_stats=True)
        vals, vecs = _same(at.eigsh(a, **kw),
                           pt.eigsh(a, device="cpu", **kw))
        np.testing.assert_allclose(vals, np.linalg.eigvalsh(a)[-4:],
                                   rtol=1e-9)
        assert residual(a, vals, vecs).max() < 1e-8

    def test_thick_generalized_mode2(self):
        # tests/test_fused.py::test_thick_restart_generalized through a
        # from_dense(a, m) operator (mode 2, bmat 'G': the residual and its
        # B-product scale together)
        rng = np.random.default_rng(3)
        n = 500
        a = sp.diags([np.ones(n - 1), 4.0 + rng.random(n), np.ones(n - 1)],
                     [-1, 0, 1]).toarray()
        m = np.diag(1.0 + rng.random(n))
        op = pt.from_dense(a, m, device="cpu")
        kw = dict(k=4, which="LA", ncv=20, tol=1e-10, maxiter=3000)
        v_t, V_t = pt.eigsh(op, restart="thick", **kw)
        v_i = pt.eigsh(op, restart="implicit", return_eigenvectors=False,
                       **kw)
        v_j = at.eigsh(a, M=m, restart="thick", return_eigenvectors=False,
                       dtype=np.float64, **kw)
        np.testing.assert_allclose(np.sort(v_t), np.sort(v_i), rtol=1e-8)
        np.testing.assert_allclose(np.sort(v_t), np.sort(v_j), rtol=1e-8)
        for i in range(4):
            r = np.linalg.norm(a @ V_t[:, i] - v_t[i] * (m @ V_t[:, i]))
            assert r < 1e-8

    @pytest.mark.parametrize("kwargs", [
        dict(which="BE"), dict(which="BE", strategy="fused"),
        dict(strategy="hybrid"), dict(shift_fn=_exact_shifts)])
    def test_thick_refusals(self, kwargs):
        # 'BE' and shift_fn are the reference's ValueErrors; the hybrid
        # driver refuses thick, which the reference runs as implicit
        op = pt.from_diagonal(np.arange(1.0, 101.0), device="cpu")
        with pytest.raises(ValueError):
            pt.eigsh(op, k=4, restart="thick", **kwargs)
        if "strategy" not in kwargs or kwargs["strategy"] != "hybrid":
            with pytest.raises(ValueError):
                at.eigsh(at.from_diagonal(np.arange(1.0, 101.0)), k=4,
                         restart="thick", **kwargs)

    def test_thick_selective_event_rate_stays_low(self):
        # the re-tridiagonalization keeps the selective schedule: a thick
        # solve does not reorthogonalize on every step
        nx = 16
        op, _ = pmodels.laplacian_2d(nx, dtype=np.float64, device="cpu")
        rates = {}
        for restart in ("implicit", "thick"):
            cfg = IRAMConfig(n=nx * nx, nev=4, ncv=20, which="LA",
                             symmetric=True, dtype=np.dtype(np.float64),
                             n_pad=op.n_pad, tol=1e-10, max_iter=500,
                             reorth="selective", restart=restart)
            res = FusedSymSolver(op, cfg).solve()
            assert res.nconv >= 4
            rates[restart] = res.stats.nrorth / max(res.stats.nopx, 1)
        assert rates["thick"] < 0.9
        assert rates["thick"] <= rates["implicit"] * 2.0 + 0.2

    def test_thick_float32_clustered_keeps_the_top(self):
        # the flagship's clustered top (its 2000 largest values, 2.8e-5
        # apart, some double) over a spread bulk, in float32: with the
        # reference's float32 re-tridiagonalization the thick solve stalls
        # (~800 cycles) and converges without the top value (2.2e-4 below
        # it); the float64 reduced space finds the top within the solve's
        # tol, as the implicit restart does
        nx = 1024
        g = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
        lam = np.sort((g[:, None] + g[None, :]).ravel())
        d = np.concatenate([lam[-2000:], np.linspace(0, lam[-2001], 20000)])
        op = pt.from_diagonal(d.astype(np.float32), device="cpu")
        vals, vecs, out = pt.eigsh(op, k=8, ncv=32, which="LA", tol=1e-5,
                                   maxiter=600, restart="thick",
                                   v0=_v0(len(d)), return_stats=True)
        assert lam[-1] - vals.max() <= 1e-5 * lam[-1]
        assert residual(sp.diags(d), vals, vecs).max() < 1e-3

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_thick_selective_basis_defect_bounded(self, dtype):
        nx = 16
        op, _ = pmodels.laplacian_2d(nx, dtype=dtype, device="cpu")
        cfg = IRAMConfig(n=nx * nx, nev=4, ncv=24, which="LA",
                         symmetric=True, dtype=np.dtype(dtype),
                         n_pad=op.n_pad, tol=1e-30, max_iter=30,
                         reorth="selective", restart="thick")
        res = FusedSymSolver(op, cfg).solve()
        V = res.state.V.double().numpy()
        defect = np.max(np.abs(V @ V.T - np.eye(cfg.ncv)))
        assert defect < 64 * np.sqrt(np.finfo(dtype).eps)


class TestUserShifts:
    def _problem(self, n=200):
        d = np.linspace(1, 60, n)
        return d, _diag_ops(d)

    def _cfgs(self, opj, **kw):
        kw = dict(n=opj.n, nev=4, ncv=14, which="LA", symmetric=True,
                  dtype=np.dtype(np.float64), n_pad=opj.n_pad, tol=1e-10,
                  max_iter=500, exact_shifts=False, **kw)
        return JConfig(**kw), IRAMConfig(**kw)

    @pytest.mark.parametrize("driver", ["hybrid", "fused"])
    def test_shift_callback_matches_reference(self, driver):
        # tests/test_regression.py::test_exact_shift_callback_matches_builtin
        # and ::test_fused_driver_user_shifts: the callback runs once per
        # restart, and counters and values equal the reference's
        d, (opj, opp) = self._problem()
        cfgj, cfgp = self._cfgs(opj)
        calls = {"j": [], "p": []}

        def make(tag):
            def shift_fn(ritz_unwanted, bounds_unwanted):
                calls[tag].append(len(ritz_unwanted))
                return _exact_shifts(ritz_unwanted, bounds_unwanted)
            return shift_fn

        J, P = ((JIRAMSolver, IRAMSolver) if driver == "hybrid"
                else (JFusedSymSolver, FusedSymSolver))
        v0 = _v0(200)
        resj = J(opj, cfgj, shift_fn=make("j")).solve(v0=v0)
        res = P(opp, cfgp, shift_fn=make("p")).solve(v0=v0)
        assert res.nconv >= 4 and calls["p"] == calls["j"]
        # one call per restart: every cycle but the last restarts
        assert len(calls["p"]) == res.n_iter - 1 >= 1
        assert (res.n_iter,) + tuple(getattr(res.stats, c) for c in
                                     COUNTERS) == \
            (resj.n_iter,) + tuple(getattr(resj.stats, c) for c in COUNTERS)
        out = extract(opp, cfgp, res)
        np.testing.assert_allclose(np.sort(out.values), np.sort(d)[-4:],
                                   rtol=1e-9)

    @pytest.mark.parametrize("strategy", ["auto", "hybrid"])
    def test_eigsh_shift_fn_matches_reference(self, strategy):
        # tests/test_regression.py::test_eigsh_shift_fn_runs_fused, and the
        # hybrid driver through the API
        n = 150
        d = np.linspace(2, 30, n)
        opj, opp = _diag_ops(d)

        def shift_fn(ritz_unwanted, bounds_unwanted):
            return ritz_unwanted

        kw = dict(k=3, which="LA", ncv=12, tol=1e-8, maxiter=400,
                  shift_fn=shift_fn, strategy=strategy, v0=_v0(n),
                  return_stats=True)
        vals, _ = _same(at.eigsh(opj, **kw), pt.eigsh(opp, **kw))
        np.testing.assert_allclose(np.sort(vals), np.sort(d)[-3:],
                                   rtol=1e-7)

    def test_requires_shift_fn(self):
        d, (opj, opp) = self._problem(100)
        _, cfgp = self._cfgs(opp)
        for solver in (IRAMSolver, FusedSymSolver):
            with pytest.raises(ValueError, match="shift_fn"):
                solver(opp, cfgp)

    def test_fused_exact_shifts_reject_shift_fn(self):
        op = pt.from_diagonal(np.arange(1.0, 101.0), device="cpu")
        cfg = IRAMConfig(n=100, nev=3, ncv=10, which="LA", symmetric=True,
                         dtype=np.dtype(np.float64), n_pad=op.n_pad)
        with pytest.raises(ValueError, match="exact_shifts"):
            FusedSymSolver(op, cfg, shift_fn=lambda r, b: r)

    def test_too_few_shifts_raise(self):
        # the fused driver's ido=3 contract: at least np shifts
        op = pt.from_diagonal(np.linspace(1, 60, 200), device="cpu")
        with pytest.raises(ValueError, match="shifts"):
            pt.eigsh(op, k=4, which="LA", ncv=14, tol=1e-10,
                     shift_fn=lambda r, b: r[:2])

    def test_float32_user_shifts(self):
        # the flagship's configuration at a CPU size, shifts by callback:
        # values within 1e-4*|lambda| of the spectrum, residuals <= 1e-3
        op, a = pmodels.laplacian_2d(32, dtype=np.float32, device="cpu")
        calls = []

        def shift_fn(ritz_unwanted, bounds_unwanted):
            calls.append(1)
            return _exact_shifts(ritz_unwanted, bounds_unwanted)

        vals, vecs, out = pt.eigsh(op, k=8, which="LA", ncv=32, tol=1e-5,
                                   maxiter=500, shift_fn=shift_fn,
                                   return_stats=True)
        lam = np.sort(np.linalg.eigvalsh(a.toarray()))
        for v in vals:
            assert np.min(np.abs(lam - v)) <= 1e-4 * abs(v)
        assert residual(a, vals, vecs).max() < 1e-3
        assert len(calls) == out.n_iter - 1
