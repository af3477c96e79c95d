"""``arpack_ng_tpu_torch.eigs`` and its real non-symmetric driver
(``core/device_realnonsym.py``) against the reference package's
``fused_real`` driver, on the same numpy inputs and start vector.

Mirrors tests/test_fused_realnonsym.py and tests/test_eigs.py
(TestConvectionDiffusion, TestSchur).  In float64 the counters (restart
cycles, nopx, nrorth, nitref, nrotr) are equal and the values agree
within 1e-9 relative: the reduced space runs the same operations in the
same dtype, so only summation order in the O(n) work differs.  Float32
cases pass the reference tests' residual gates; the scipy oracles keep
the reference tests' tolerances."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import scipy.sparse.linalg as sla  # noqa: E402

import arpack_ng_tpu as at  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.config import IRAMConfig as JConfig  # noqa: E402
from arpack_ng_tpu.core import device_realnonsym as jdrn  # noqa: E402
from arpack_ng_tpu.core.extract import extract as jextract  # noqa: E402
from arpack_ng_tpu.ops import sparse as jsparse  # noqa: E402
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402
from arpack_ng_tpu_torch.config import IRAMConfig as PConfig  # noqa: E402
from arpack_ng_tpu_torch.core import device_realnonsym as pdrn  # noqa: E402
from arpack_ng_tpu_torch.core.extract import extract as pextract  # noqa: E402

from conftest import residual  # noqa: E402

COUNTERS = ("nopx", "nrorth", "nitref", "nrotr")


def _banded_nonsym(rng, n=600):
    """tests/test_fused_realnonsym.py: random-diagonal non-symmetric band,
    well-separated extremes, conjugate pairs in the interior."""
    return (sp.diags(2.0 + rng.standard_normal(n))
            + sp.diags(-1.5 * np.ones(n - 1), 1)
            + sp.diags(-0.5 * np.ones(n - 1), -1)).tocsr()


def _rotation_blocks(rng, nb=150):
    """tests/test_fused_realnonsym.py: 2x2 rotation blocks, spectrum
    a_i +- i b_i with spread imaginary parts."""
    blocks = []
    for i in range(nb):
        a = rng.standard_normal() * 0.3
        b = (i + 1) / nb * 3.0 + 0.1 * rng.standard_normal()
        blocks.append(np.array([[a, b], [-b, a]]))
    return sp.block_diag(blocks).tocsr()


def _v0(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, n)


def _counts(out):
    return (out.n_iter,) + tuple(getattr(out.stats, c) for c in COUNTERS)


def _assert_same(vj, oj, vp, op_):
    """Equal counters and values within 1e-9 relative (float64)."""
    assert _counts(op_) == _counts(oj)
    assert len(vp) == len(vj)
    np.testing.assert_allclose(np.sort_complex(vp), np.sort_complex(vj),
                               rtol=1e-9, atol=0)


def _solve_both(a, nev, ncv, which, tol, max_iter):
    """The driver of each package plus its extraction, DIA operators from
    the same CSR matrix, float64, the same start vector."""
    opj = jsparse.from_scipy(a, hermitian=False, format="dia")
    opp = pt.from_scipy(a, hermitian=False, format="dia", device="cpu")
    kw = dict(n=opj.n, nev=nev, ncv=ncv, which=which, symmetric=False,
              dtype=np.dtype(np.float64), n_pad=opj.n_pad, tol=tol,
              max_iter=max_iter)
    v0 = _v0(opj.n)
    cj, cp = JConfig(**kw), PConfig(**kw)
    rj = jdrn.FusedRealNonsymSolver(opj, cj).solve(v0=v0)
    rp = pdrn.FusedRealNonsymSolver(opp, cp).solve(v0=v0)
    return jextract(opj, cj, rj), pextract(opp, cp, rp)


class TestRealSchurMachinery:
    def _hessenberg(self, rng, k=12):
        H = np.triu(rng.standard_normal((k, k)), -1)
        sub = np.abs(H[np.arange(1, k), np.arange(k - 1)])
        H[np.arange(1, k), np.arange(k - 1)] = sub
        return H

    def test_schur_eigs_lastcomps_vs_lapack(self, rng):
        # tests/test_fused_realnonsym.py::test_schur_eigs_lastcomps_vs_lapack
        k = 12
        H = self._hessenberg(rng, k)
        T, Q = pdrn.make_real_schur(k, np.float64, sweeps=8 * k)(H)
        assert np.abs(Q.T @ Q - np.eye(k)).max() < 1e-12
        assert np.abs(Q @ T @ Q.T - H).max() < 1e-10 * np.abs(H).max()
        assert np.abs(np.tril(T, -2)).max() < 1e-10      # quasi-triangular
        subT = np.diag(T, -1)
        assert not np.any((np.abs(subT[:-1]) > 1e-12)
                          & (np.abs(subT[1:]) > 1e-12))  # blocks 2x2 max
        wr, wi, _, _ = pdrn.real_block_eigs(T)
        np.testing.assert_allclose(
            np.sort_complex(wr + 1j * wi),
            np.sort_complex(np.linalg.eigvals(H)), atol=1e-10)
        lc, wr2, wi2, _, _ = pdrn.make_real_last_components(k, np.float64)(
            T, Q)
        w_ref, Y = np.linalg.eig(H)
        lam = wr2 + 1j * wi2
        for i in range(k):
            j = int(np.argmin(np.abs(w_ref - lam[i])))
            ref = abs(Y[-1, j]) / np.linalg.norm(Y[:, j])
            assert abs(lc[i] - ref) < 1e-8

    @pytest.mark.parametrize("k", [6, 12, 24])
    def test_schur_and_lastcomps_match_reference(self, k):
        # the same H through both packages.  A converged complex 2x2 block
        # is left in whatever rotation the sweeps reached (neither package
        # standardizes it as dlanv2 does), so T and Q depend on rounding;
        # their invariants, the eigenvalues and the last components, agree
        # to 1e-10
        H = self._hessenberg(np.random.default_rng(k), k)
        Tj, Qj = jdrn.make_real_schur(k, jnp.float64, sweeps=4 * k)(
            jnp.asarray(H))
        lj, wrj, wij = (np.asarray(v) for v in jdrn.make_real_last_components(
            k, jnp.float64)(Tj, Qj)[:3])
        Tp, Qp = pdrn.make_real_schur(k, np.float64, sweeps=4 * k)(H)
        lp, wrp, wip = pdrn.make_real_last_components(k, np.float64)(
            Tp, Qp)[:3]
        oj = np.argsort(wrj + 1j * wij)
        op_ = np.argsort(wrp + 1j * wip)
        np.testing.assert_allclose((wrp + 1j * wip)[op_],
                                   (wrj + 1j * wij)[oj], atol=1e-10)
        np.testing.assert_allclose(lp[op_], lj[oj], rtol=1e-8, atol=1e-12)
        # the same (T, Q) into both back-substitutions: equal to rounding
        Tj, Qj = np.asarray(Tj), np.asarray(Qj)
        lj2 = np.asarray(jdrn.make_real_last_components(k, jnp.float64)(
            jnp.asarray(Tj), jnp.asarray(Qj))[0])
        lp2 = pdrn.make_real_last_components(k, np.float64)(Tj, Qj)[0]
        np.testing.assert_allclose(lp2, lj2, rtol=1e-10, atol=1e-14)

    def test_block_eigs_and_deflation_equal_reference(self):
        # elementwise IEEE arithmetic on the same T: equal bit for bit
        rng = np.random.default_rng(3)
        T = np.triu(rng.standard_normal((10, 10)))
        T[[2, 5, 8], [1, 4, 7]] = [0.7, -1e-20, 2.0]
        for a, b in zip(pdrn.real_block_eigs(T),
                        jdrn.real_block_eigs(jnp.asarray(T))):
            np.testing.assert_array_equal(a, np.asarray(b))
        for a, b in zip(pdrn._deflate_real(T, 1e-16),
                        jdrn._deflate_real(jnp.asarray(T), 1e-16)):
            np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(
            pdrn._block_disc(T), np.asarray(jdrn._block_disc(jnp.asarray(T))))

    @pytest.mark.parametrize("which", ["LM", "SM", "LR", "SR", "LI", "SI"])
    def test_which_key_equal_reference(self, which):
        rng = np.random.default_rng(4)
        wr, wi = rng.standard_normal(16), rng.standard_normal(16)
        # XLA's hypot (LM/SM) is not numpy's correctly rounded one: 1 ulp
        np.testing.assert_allclose(
            pdrn._which_key_real(which, wr, wi),
            np.asarray(jdrn._which_key_real(which, jnp.asarray(wr),
                                            jnp.asarray(wi))),
            rtol=4e-16, atol=0)


class TestFusedRealNonsym:
    @pytest.mark.parametrize("which", ["LM", "LR", "SR"])
    def test_banded_matches_reference_and_scipy(self, which, rng):
        a = _banded_nonsym(rng)
        oj, out = _solve_both(a, 6, 30, which, 1e-10, 1500)
        assert out.nconv >= 6
        vals, vecs = out.values, out.vectors
        for i in range(6):
            r = np.linalg.norm(a @ vecs[:, i] - vals[i] * vecs[:, i])
            assert r < 1e-8 * max(abs(vals[i]), 1.0)
        sv = sla.eigs(a, k=6, which=which, ncv=30,
                      return_eigenvectors=False, maxiter=8000)
        np.testing.assert_allclose(np.sort_complex(np.round(vals[:6], 6)),
                                   np.sort_complex(np.round(sv, 6)),
                                   atol=1e-4)
        _assert_same(oj.values, oj, vals, out)

    def test_li_conjugate_pairs(self, rng):
        a = _rotation_blocks(rng)
        oj, out = _solve_both(a, 6, 30, "LI", 1e-10, 1500)
        assert out.nconv >= 6
        vals = out.values[:6]
        assert np.allclose(np.sort_complex(vals),
                           np.sort_complex(np.conj(vals)), atol=1e-6)
        for i in range(6):
            r = np.linalg.norm(a @ out.vectors[:, i]
                               - vals[i] * out.vectors[:, i])
            assert r < 1e-6 * max(abs(vals[i]), 1.0)
        _assert_same(oj.values, oj, out.values, out)

    def test_api_strategy_fused_real(self, rng):
        a = _banded_nonsym(rng, n=400)
        kw = dict(k=4, which="LM", ncv=24, tol=1e-10, maxiter=1500,
                  strategy="fused_real", dtype=np.float64, v0=_v0(400),
                  return_stats=True)
        vj, _, oj = at.eigs(a, **kw)
        vals, vecs, out = pt.eigs(a, device="cpu", **kw)
        for i in range(4):
            r = np.linalg.norm(a @ vecs[:, i] - vals[i] * vecs[:, i])
            assert r < 1e-8 * max(abs(vals[i]), 1.0)
        _assert_same(vj, oj, vals, out)

    def test_f32(self, rng):
        a = _banded_nonsym(rng, n=500).astype(np.float32)
        vals, vecs = pt.eigs(a, k=4, which="LM", ncv=24, tol=1e-4,
                             maxiter=2000, strategy="fused_real",
                             device="cpu")
        for i in range(4):
            r = np.linalg.norm(a @ vecs[:, i] - vals[i] * vecs[:, i])
            assert r < 1e-2 * max(abs(vals[i]), 1.0)

    def test_conv_diffusion_lm(self):
        opj, a = jmodels.convection_diffusion_2d(14, dtype=np.float64)
        opp, _ = pmodels.convection_diffusion_2d(14, dtype=np.float64,
                                                 device="cpu")
        kw = dict(n=opj.n, nev=6, ncv=24, which="LM", symmetric=False,
                  dtype=np.dtype(np.float64), n_pad=opj.n_pad, tol=1e-10,
                  max_iter=500)
        cj, cp = JConfig(**kw), PConfig(**kw)
        oj = jextract(opj, cj, jdrn.FusedRealNonsymSolver(opj, cj).solve(
            v0=_v0(opj.n)))
        out = pextract(opp, cp, pdrn.FusedRealNonsymSolver(opp, cp).solve(
            v0=_v0(opj.n)))
        assert out.nconv >= 6
        for i in range(6):
            r = np.linalg.norm(a @ out.vectors[:, i]
                               - out.values[i] * out.vectors[:, i])
            assert r < 1e-8 * max(abs(out.values[i]), 1.0)
        _assert_same(oj.values, oj, out.values, out)

    def test_rejects_complex(self, rng):
        # the reference's ValueError (arpack_ng_tpu/api.py:447-451), in
        # both packages
        a = (rng.standard_normal((50, 50))
             + 1j * rng.standard_normal((50, 50)))
        with pytest.raises(ValueError, match="fused_real"):
            pt.eigs(a.astype(np.complex128), k=3, strategy="fused_real",
                    device="cpu")
        with pytest.raises(ValueError, match="fused_real"):
            at.eigs(a.astype(np.complex128), k=3, strategy="fused_real")


class TestConvectionDiffusion:
    """tests/test_eigs.py::TestConvectionDiffusion: dnsimp and dndrv1
    classes, scipy's ARPACK as the value oracle, the reference's counters."""

    def test_dnsimp_lm(self):
        opj, a_sp = jmodels.convection_diffusion_2d(10, rho=100.0,
                                                    dtype=np.float64)
        opp, _ = pmodels.convection_diffusion_2d(10, rho=100.0,
                                                 dtype=np.float64,
                                                 device="cpu")
        kw = dict(k=4, which="LM", ncv=20, tol=1e-10, maxiter=500,
                  v0=_v0(100), return_stats=True)
        vj, _, oj = at.eigs(opj, **kw)
        vals, vecs, out = pt.eigs(opp, **kw)
        ref = sla.eigs(a_sp, k=4, which="LM", tol=1e-12,
                       return_eigenvectors=False)
        np.testing.assert_allclose(
            np.sort_complex(vals), np.sort_complex(ref), rtol=1e-6)
        assert residual(a_sp, vals, vecs).max() < 1e-8
        _assert_same(vj, oj, vals, out)

    @pytest.mark.parametrize("which", ["LM", "LR", "SR"])
    def test_which_1d(self, which):
        opj, a_sp = jmodels.convection_diffusion_1d(150, rho=40.0,
                                                    dtype=np.float64)
        opp, _ = pmodels.convection_diffusion_1d(150, rho=40.0,
                                                 dtype=np.float64,
                                                 device="cpu")
        kw = dict(k=5, which=which, ncv=25, tol=1e-10, maxiter=800,
                  v0=_v0(150), return_stats=True)
        vj, _, oj = at.eigs(opj, **kw)
        vals, vecs, out = pt.eigs(opp, **kw)
        ref = sla.eigs(a_sp, k=5, which=which, tol=1e-12, ncv=25,
                       maxiter=3000, return_eigenvectors=False)
        np.testing.assert_allclose(
            np.sort_complex(np.round(vals, 8)),
            np.sort_complex(np.round(ref, 8)), rtol=1e-5, atol=1e-8)
        assert residual(a_sp, vals, vecs).max() < 1e-7
        # a non-normal operator: its values move ~1e-6 relative with the
        # summation order, so they are held to the reference test's scipy
        # tolerance
        assert _counts(out) == _counts(oj)
        np.testing.assert_allclose(np.sort_complex(vals),
                                   np.sort_complex(vj), rtol=1e-5, atol=1e-8)

    def test_which_li_real_matrix(self, rng):
        n = 120
        a = rng.standard_normal((n, n)) / np.sqrt(n)
        kw = dict(k=4, which="LI", ncv=24, tol=1e-10, maxiter=800,
                  v0=_v0(n), return_stats=True)
        vj, _, oj = at.eigs(a, **kw)
        vals, vecs, out = pt.eigs(a, device="cpu", **kw)
        w = np.linalg.eigvals(a)
        top = np.sort(np.abs(w.imag))[-4:]
        np.testing.assert_allclose(np.sort(np.abs(vals.imag)), top,
                                   rtol=1e-6)
        assert residual(a, vals, vecs).max() < 1e-7
        _assert_same(vj, oj, vals, out)

    def test_complex_pairs_residual(self, rng):
        n = 120
        a = rng.standard_normal((n, n)) / np.sqrt(n)
        kw = dict(k=6, which="LM", ncv=24, tol=1e-10, maxiter=800,
                  v0=_v0(n), return_stats=True)
        vj, _, oj = at.eigs(a, **kw)
        vals, vecs, out = pt.eigs(a, device="cpu", **kw)
        assert residual(a, vals, vecs).max() < 1e-8
        # k or k+1 values: a conjugate pair is never split
        assert len(vals) in (6, 7)
        nonreal = vals[np.abs(vals.imag) > 1e-10]
        for v in nonreal:
            assert np.min(np.abs(nonreal - np.conj(v))) < 1e-8
        _assert_same(vj, oj, vals, out)

    def test_wanted_first_unit_vectors(self, rng):
        # dneupd's output order: wanted first; unit-norm Ritz vectors
        a = rng.standard_normal((90, 90)) / np.sqrt(90)
        vals, vecs = pt.eigs(a, k=5, which="LR", ncv=24, tol=1e-10,
                             maxiter=800, device="cpu", v0=_v0(90))
        assert np.all(np.diff(vals.real) <= 1e-12)
        np.testing.assert_allclose(np.linalg.norm(vecs, axis=0), 1.0,
                                   rtol=1e-10)


class TestSchur:
    def test_schur_basis(self, rng):
        n = 80
        a = rng.standard_normal((n, n)) / np.sqrt(n)
        kw = dict(k=4, which="LM", ncv=20, tol=1e-10, maxiter=800,
                  return_eigenvectors=False, return_schur=True, v0=_v0(n),
                  return_stats=True)
        vj, _, oj = at.eigs(a, **kw)
        vals, Q, out = pt.eigs(a, device="cpu", **kw)
        # Q spans an invariant subspace: ||A Q - Q (Q^T A Q)|| small
        aq = a @ Q
        proj = Q @ (Q.T @ aq)
        assert np.linalg.norm(aq - proj) < 1e-7
        np.testing.assert_allclose(Q.T @ Q, np.eye(Q.shape[1]), atol=1e-8)
        _assert_same(vj, oj, vals, out)


def test_step_the_reference_breaks():
    # conv-diff nx = 10, LR: an exact shift leaves a tiny coupling and the
    # next explicit double-shift QR has a near-zero pivot mid-matrix; the
    # reference keeps the non-Hessenberg result, loses the Arnoldi
    # relation and returns values with residuals of 1e-1 at tol 1e-10.
    # The port applies those shifts by implicit bulge chases.
    opj, a = jmodels.convection_diffusion_2d(10, dtype=np.float64)
    opp, _ = pmodels.convection_diffusion_2d(10, dtype=np.float64,
                                             device="cpu")
    kw = dict(k=6, which="LR", ncv=24, tol=1e-10, maxiter=500, v0=_v0(100))
    vj, xj = at.eigs(opj, **kw)
    vals, vecs = pt.eigs(opp, **kw)
    assert residual(a, vj, xj).max() > 1e-3
    r = np.linalg.norm(a @ vecs - vecs * vals[None, :], axis=0)
    assert r.max() < 1e-8 * np.abs(vals).max()


def test_eigs_scipy_input_imports_dia(rng):
    # eigs(A_csr) imports a non-symmetric banded matrix above the dense
    # limit as DIA (the kernel of csrc/dia.cu on the card) and matches the
    # reference's eigs(A_csr)
    _, stencil = pmodels.convection_diffusion_2d(64, device="cpu")
    op = pt.from_scipy(stencil, hermitian=False, device="cpu")
    assert op.format == "dia" and op.perm is None
    a = _banded_nonsym(rng, n=3000)
    op = pt.from_scipy(a, hermitian=False, device="cpu")
    assert op.format == "dia" and op.perm is None
    kw = dict(k=4, which="LM", ncv=20, tol=1e-10, maxiter=500, v0=_v0(3000),
              return_stats=True)
    vj, _, oj = at.eigs(a, **kw)
    vals, vecs, out = pt.eigs(a, device="cpu", **kw)
    assert residual(a, vals, vecs).max() < 1e-8
    _assert_same(vj, oj, vals, out)


def test_cgs_kernel_pallas_float32_matches_reference(rng):
    # cgs_kernel='pallas' on the non-symmetric path: the CGS kernels' twins
    # here, Pallas in interpret mode in the reference.  float32: values
    # within 10*tol*|lambda| and residuals within 100*tol, as for eigsh
    a = _banded_nonsym(rng).astype(np.float32)
    opj = jsparse.from_scipy(a, hermitian=False, format="dia")
    opp = pt.from_scipy(a, hermitian=False, format="dia", device="cpu")
    kw = dict(k=4, which="LM", ncv=24, tol=1e-5, maxiter=500,
              v0=_v0(600).astype(np.float32), cgs_kernel="pallas")
    vj, _ = at.eigs(opj, **kw)
    vals, vecs = pt.eigs(opp, **kw)
    assert residual(a, vals, vecs).max() < 1e-3
    np.testing.assert_allclose(np.sort_complex(vals), np.sort_complex(vj),
                               rtol=1e-4)


def test_f32_convection_diffusion_residual_gate():
    # the phase-9 configuration at a CPU size: float32, k = 8, ncv = 32,
    # LM; pairs converged by residual (they may lie in the
    # pseudospectrum), conjugate-closed, 8 or 9 values
    op, a = pmodels.convection_diffusion_2d(48, dtype=np.float32,
                                            device="cpu")
    vals, vecs = pt.eigs(op, k=8, ncv=32, which="LM", tol=1e-5,
                         maxiter=300)
    assert len(vals) in (8, 9)
    for v in vals[vals.imag != 0]:
        assert np.min(np.abs(vals - np.conj(v))) <= 1e-12 * abs(v)
    assert residual(a, vals, vecs).max() < 1e-3


def test_no_convergence_raises_with_partial_results():
    op, _ = pmodels.convection_diffusion_2d(12, dtype=np.float64,
                                            device="cpu")
    with pytest.raises(pt.ArpackNoConvergence) as ei:
        pt.eigs(op, k=4, which="LM", ncv=10, tol=1e-14, maxiter=2)
    assert ei.value.info == 1


def test_values_only_and_stats():
    op, _ = pmodels.convection_diffusion_1d(100, dtype=np.float64,
                                            device="cpu")
    vals, out = pt.eigs(op, k=3, ncv=16, tol=1e-10, maxiter=500,
                        return_eigenvectors=False, return_stats=True)
    assert vals.shape == (3,) and out.vectors is None
    assert out.stats.nopx > 0 and out.n_iter > 0


@pytest.mark.parametrize("kwargs", [
    dict(sigma=1.0), dict(M=np.eye(64)), dict(mesh=object()),
    dict(select=np.ones(20, bool)), dict(validate="f64"),
    dict(validate="f64", return_schur=True), dict(strategy="fused"),
    dict(strategy="hybrid", cgs_kernel="pallas")])
def test_outside_the_slice_raises(kwargs):
    # mesh is outside the slice (NotImplementedError); select= and
    # strategy='fused' are ported and solve to the reference's values from
    # the same start vector (within 1e-8: the complexified solve's values
    # carry imaginary parts of 1e-9 from rounding, the solve's tol 1e-10);
    # ported options raise ValueError: sigma and M on an operator (the
    # built-in transforms take matrices, as in the reference;
    # tests/test_torch_modes.py), validate='f64' on a matrix-free operator
    # (the reference's own error), validate= under return_schur (which the
    # reference skips without a word, arpack_ng_tpu/api.py:463) and the
    # hybrid driver's CGS kernels on float64 (the reference's)
    op, _ = pmodels.convection_diffusion_1d(64, dtype=np.float64,
                                            device="cpu")
    if "select" in kwargs or kwargs.get("strategy") == "fused":
        opj, _ = jmodels.convection_diffusion_1d(64, dtype=np.float64)
        kw = dict(k=2, tol=1e-10, return_eigenvectors=False, v0=_v0(64),
                  **kwargs)
        np.testing.assert_allclose(pt.eigs(op, **kw), at.eigs(opj, **kw),
                                   rtol=1e-8)
        return
    transform = "sigma" in kwargs or "M" in kwargs
    exc = ValueError if ("validate" in kwargs or "cgs_kernel" in kwargs
                         or transform) else NotImplementedError
    with pytest.raises(exc):
        pt.eigs(op, k=2, **kwargs)
    if transform:
        opj, _ = jmodels.convection_diffusion_1d(64, dtype=np.float64)
        with pytest.raises(ValueError):
            at.eigs(opj, k=2, **kwargs)


def test_complex_inputs_raise():
    # complex inputs are ported: under 'auto' the hybrid driver solves
    # them (tests/test_torch_complex.py), and strategy='fused' the complex
    # cycle of core/device_nonsym; 'fused_real' refuses them, as the
    # reference does
    for a in (np.diag(np.arange(1.0, 51.0)).astype(np.complex128),
              sp.diags(np.arange(1.0, 51.0)).tocsr().astype(np.complex128)):
        for strategy in ("auto", "fused"):
            vals = pt.eigs(a, k=2, tol=1e-10, return_eigenvectors=False,
                           strategy=strategy, device="cpu")
            np.testing.assert_allclose(vals, [50, 49], rtol=1e-10)
        with pytest.raises(ValueError, match="fused_real"):
            pt.eigs(a, k=2, strategy="fused_real", device="cpu")


@pytest.mark.parametrize("solver", ["eigsh", "eigs"])
def test_device_spelled_with_an_index(solver):
    # an operator built on "cpu" is accepted when the solve asks for
    # "cpu:0" (on the card: "cuda" against "cuda:0"); another device is
    # still refused
    if solver == "eigsh":
        op, _ = pmodels.laplacian_1d(64, dtype=np.float64, device="cpu")
        kw = dict(which="LA")
    else:
        op, _ = pmodels.convection_diffusion_1d(64, dtype=np.float64,
                                                device="cpu")
        kw = {}
    fn = getattr(pt, solver)
    a = fn(op, k=2, tol=1e-8, return_eigenvectors=False, device="cpu", **kw)
    b = fn(op, k=2, tol=1e-8, return_eigenvectors=False, device="cpu:0",
           **kw)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="operator lives on"):
        fn(op, k=2, device="meta", **kw)


def test_device_normal_form():
    from arpack_ng_tpu_torch.utils import device
    assert device.same("cpu", "cpu:0")
    assert device.same(torch.device("cpu"), "cpu")
    assert not device.same("cpu", "meta")
    if not torch.cuda.is_available():
        assert device.normalized("cuda") == ("cuda", 0)
    assert device.normalized("cuda:1") == ("cuda", 1)
