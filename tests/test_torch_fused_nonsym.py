"""The port's fused complex driver (``arpack_ng_tpu_torch.core.device_nonsym``,
``eigs(strategy='fused')``) against the reference package's
``FusedNonsymSolver`` on the same numpy inputs and start vector; mirrors
the fused side of tests/test_fused_nonsym.py, its distributed case on a
gloo world of 2 processes (``tests/torch_mp_worker.py``): the reference's
residual gate, both ranks' values bit-equal.

Tolerances: the Schur sweeps and last components in complex128 agree
with LAPACK and with the reference's to 1e-12 / 1e-9; whole solves in
complex128 (real float64 input complexified, or complex128 input) give
equal counters (restart cycles, nopx, nrorth, nitref, nrotr) and values
within 1e-10 relative: the reduced space runs the same operations in the
same dtype, and only the summation order of the O(n) work differs.
Float32 input passes the residual oracle at 1e-3."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import scipy.linalg as sla  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import scipy.sparse.linalg as ssla  # noqa: E402

import arpack_ng_tpu as at  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.core import device_nonsym as jdn  # noqa: E402
from arpack_ng_tpu.core.reduced import sort_key  # noqa: E402
from arpack_ng_tpu.ops import sparse as jsparse  # noqa: E402
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402
from arpack_ng_tpu_torch.core import device_nonsym as pdn  # noqa: E402

from conftest import residual  # noqa: E402

COUNTERS = ("nopx", "nrorth", "nitref", "nrotr")


def _counts(out):
    return (out.n_iter,) + tuple(getattr(out.stats, c) for c in COUNTERS)


def _hessenberg(rng, k):
    return np.triu(rng.standard_normal((k, k))
                   + 1j * rng.standard_normal((k, k)), -1
                   ).astype(np.complex128)


def _both(opj, opp, **kw):
    """``eigs(strategy='fused')`` of each package with its extraction."""
    kw = dict(strategy="fused", return_stats=True, **kw)
    return at.eigs(opj, **kw), pt.eigs(opp, **kw)


def _assert_same(rj, rp):
    """Equal counters, values within 1e-10 relative (complex128)."""
    (vj, _, oj), (vp, xp, op_) = rj, rp
    assert _counts(op_) == _counts(oj)
    assert len(vp) == len(vj)
    np.testing.assert_allclose(vp, vj, rtol=1e-10, atol=0)
    return vp, xp


class TestSchur:
    @pytest.mark.parametrize("k", [4, 12, 24])
    def test_matches_lapack_and_reference(self, k, rng):
        H = _hessenberg(rng, k)
        T, Q = pdn.make_hessenberg_schur(k, np.complex128, 4 * k)(H)
        assert np.abs(Q.conj().T @ Q - np.eye(k)).max() < 1e-12
        assert np.abs(Q.conj().T @ H @ Q - T).max() < 1e-12
        assert np.abs(np.tril(T, -1)).max() < 1e-12
        np.testing.assert_allclose(
            np.sort_complex(np.diag(T)),
            np.sort_complex(np.linalg.eigvals(H)), atol=1e-11)
        schur = jax.jit(jdn.make_hessenberg_schur(k, jnp.complex128, 4 * k))
        Tj, _ = map(np.asarray, schur(jnp.asarray(H)))
        np.testing.assert_allclose(np.diag(T), np.diag(Tj), atol=1e-12)

    def test_last_components(self, rng):
        k = 16
        H = _hessenberg(rng, k)
        T, Q = pdn.make_hessenberg_schur(k, np.complex128, 4 * k)(H)
        comp = pdn.make_last_components(k, np.complex128)(T, Q)
        w2, Y = sla.eig(H)
        lam = np.diag(T)
        for i in range(k):
            j = np.argmin(np.abs(w2 - lam[i]))
            assert abs(comp[i] - abs(Y[-1, j])) < 1e-9
        # the reference's masked solves on the same Schur pair
        ref = np.asarray(jax.jit(jdn.make_last_components(
            k, jnp.complex128))(jnp.asarray(T), jnp.asarray(Q)))
        np.testing.assert_allclose(comp, ref, rtol=1e-10)

    def test_degenerate_diagonal_is_clamped(self):
        # equal eigenvalues: the clamp keeps the triangular solve finite
        k = 6
        T = np.diag(np.array([2, 2, 2, 1, 1, 3], np.complex128))
        T[0, 1] = T[1, 2] = 0.5
        comp = pdn.make_last_components(k, np.complex128)(T, np.eye(k))
        assert np.all(np.isfinite(comp))


class TestFusedStrategy:
    def test_complex_fused_matches_reference_and_hybrid(self, rng):
        n = 100
        a = ((rng.standard_normal((n, n))
              + 1j * rng.standard_normal((n, n))) / np.sqrt(n)
             ).astype(np.complex128)
        v0 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        kw = dict(k=4, which="LM", ncv=20, tol=1e-10, maxiter=400, v0=v0)
        rj = at.eigs(a, strategy="fused", return_stats=True, **kw)
        rp = pt.eigs(a, strategy="fused", return_stats=True, device="cpu",
                     **kw)
        vp, xp = _assert_same(rj, rp)
        assert residual(a, vp, xp).max() < 1e-8
        vh = pt.eigs(a, strategy="hybrid", return_eigenvectors=False,
                     device="cpu", **kw)
        np.testing.assert_allclose(np.sort(np.abs(vp)), np.sort(np.abs(vh)),
                                   rtol=1e-8)

    def test_real_via_complexification(self):
        opj, a_sp = jmodels.convection_diffusion_2d(10, rho=100.0,
                                                    dtype=np.float64)
        opp, _ = pmodels.convection_diffusion_2d(10, rho=100.0,
                                                 dtype=np.float64,
                                                 device="cpu")
        v0 = np.random.default_rng(0).uniform(-1, 1, opj.n)
        vals, vecs = _assert_same(*_both(opj, opp, k=4, which="LM", ncv=20,
                                         tol=1e-10, maxiter=400, v0=v0))
        assert np.iscomplexobj(vals) and np.iscomplexobj(vecs)
        assert residual(a_sp, vals, vecs).max() < 1e-8
        ref = ssla.eigs(a_sp, k=4, which="LM", tol=1e-12,
                        return_eigenvectors=False)
        np.testing.assert_allclose(np.sort(np.abs(vals))[:4],
                                   np.sort(np.abs(ref)), rtol=1e-8)

    @pytest.mark.parametrize("which", ["LM", "LR", "SR", "LI"])
    def test_which_selectors(self, which, rng):
        n = 120
        d = (rng.uniform(0.5, 4, n) * np.exp(2j * np.pi * rng.uniform(
            size=n))).astype(np.complex128)
        opj = at.from_diagonal(d, n_pad=at.pad_dim(n))
        opp = pt.from_diagonal(d, n_pad=at.pad_dim(n), device="cpu")
        v0 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        vals, _ = _assert_same(*_both(opj, opp, k=3, which=which, ncv=18,
                                      tol=1e-10, maxiter=600, v0=v0))
        ref = d[np.argsort(sort_key(which, d, real_pairs=False))][-3:]
        np.testing.assert_allclose(np.sort_complex(np.round(vals, 9)),
                                   np.sort_complex(np.round(ref, 9)),
                                   rtol=1e-7)

    def test_dia_input_carried(self):
        # a banded real matrix imported as DIA, complexified: the lifted
        # operator keeps the importer's format, padding and device
        n = 600
        rng = np.random.default_rng(2)
        a = (sp.diags(2.0 + rng.standard_normal(n))
             + sp.diags(-1.5 * np.ones(n - 1), 1)
             + sp.diags(-0.5 * np.ones(n - 1), -1)).tocsr()
        opp = pt.from_scipy(a, hermitian=False, format="dia", device="cpu")
        opc = pdn.complexify_operator(opp)
        assert (opc.format, opc.n_pad, opc.perm, opc.capturable) == \
            (opp.format, opp.n_pad, opp.perm, opp.capturable)
        assert opc.device == opp.device and opc.dtype == np.complex128
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        np.testing.assert_allclose(opc.matvec(x), a @ x, rtol=1e-13)
        opj = jsparse.from_scipy(a, hermitian=False, format="dia")
        vals, vecs = _assert_same(*_both(opj, opp, k=4, which="LR", ncv=20,
                                         tol=1e-10, maxiter=500,
                                         v0=rng.uniform(-1, 1, n)))
        assert residual(a, vals, vecs).max() < 1e-8

    def test_float32_residual_gate(self):
        # float32 input runs the complex64 cycle: residual-converged pairs
        op, a = pmodels.convection_diffusion_2d(24, dtype=np.float32,
                                                device="cpu")
        vals, vecs, out = pt.eigs(op, k=6, ncv=24, which="LM", tol=1e-5,
                                  maxiter=300, strategy="fused",
                                  return_stats=True)
        assert vals.dtype == np.complex128 and len(vals) == out.nconv
        assert 1 <= len(vals) <= 6
        assert residual(a, vals, vecs).max() < 1e-3

    def test_pallas_cgs_on_complexified_raises(self):
        # the complexified float32 problem computes in complex64, where the
        # CGS kernels (real float32) do not apply: both packages refuse it
        opj, _ = jmodels.convection_diffusion_2d(12, dtype=np.float32)
        opp, _ = pmodels.convection_diffusion_2d(12, dtype=np.float32,
                                                 device="cpu")
        with pytest.raises(ValueError, match="cgs_kernel"):
            at.eigs(opj, k=3, strategy="fused", cgs_kernel="pallas")
        with pytest.raises(ValueError, match="cgs_kernel"):
            pt.eigs(opp, k=3, strategy="fused", cgs_kernel="pallas")

    def test_fused_distributed(self, tmp_path):
        # mesh= (the row-partitioned solve) on 2 gloo ranks, the
        # reference's case (rho = 40: a strongly non-normal operator whose
        # float64 values move with the order of a sum, so the residual and
        # the ranks' agreement are held, as tests/test_fused_nonsym.py
        # holds its mesh solve)
        from torch_mp_worker import run_world
        v0 = np.random.default_rng(0).uniform(-1, 1, 144)
        out = run_world(2, ["fused_nonsym"], tmp_path,
                        {"fused_nonsym": v0})["fused_nonsym"]
        for r in out:
            assert "error" not in r, r.get("error")
        np.testing.assert_array_equal(out[0]["vals"], out[1]["vals"])
        np.testing.assert_array_equal(out[0]["vecs"], out[1]["vecs"])
        _, a = jmodels.convection_diffusion_2d(12, rho=40.0,
                                               dtype=np.float64)
        assert residual(a, out[0]["vals"], out[0]["vecs"]).max() < 1e-7
        assert out[0]["collectives"]["all_reduce"] > 0

    def test_solver_refuses_real_dtype(self):
        from arpack_ng_tpu_torch.config import IRAMConfig
        op, _ = pmodels.convection_diffusion_2d(8, dtype=np.float64,
                                                device="cpu")
        cfg = IRAMConfig(n=op.n, nev=3, ncv=12, which="LM", symmetric=False,
                         dtype=np.dtype(np.float64), n_pad=op.n_pad)
        with pytest.raises(ValueError, match="complex dtype"):
            pdn.FusedNonsymSolver(op, cfg)
