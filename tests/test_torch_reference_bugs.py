"""Regressions of the Fortran library's TESTS/ tier that the port meets
as the reference package does (tests/test_reference_bugs.py):

* bug_1315 (TESTS/bug_1315_single.c): the single-precision non-symmetric
  solve of diag(1..1000), nev = 9 'LM', ncv = 19, tol = 0 (float32 machine
  eps) converges to 992..1000 at float32 accuracy (2e-5 relative, residual
  below 1e-3), as the reference package's test holds it;
* bug_79 (TESTS/bug_79_double_complex.f): the start vector is used as
  given; seeded with the exact dominant eigenvector of zndrv1's complex
  convection-diffusion operator, ``eigs`` converges within two cycles (to
  1e-8 relative), and an all-ones start converges (residual below 1e-8),
  through the hybrid driver ('auto' for complex input) and the fused
  complex one;
* bug_58 (TESTS/bug_58_double.f): shift-invert about sigma = -1 of a
  singular 9x9 (identity with a(0,0) = 0, a(0,8) = 1), nev = 4: finite
  values and vectors after purification, residuals below 1e-8, the
  singular value 0 among them, through every ``eigs`` driver;
* ``validate='f64'`` with ``M`` (the reference's ``A V - M V Lambda``):
  the port's report equal field for field (1e-12 relative) to the
  reference's ``_f64_validate`` on the same output; a matrix-free ``M``
  (an Operator or a callable) under ``validate='f64'`` raises
  ``ValueError`` (the reference makes an object array of it).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import scipy.sparse as sp  # noqa: E402

import arpack_ng_tpu as at  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu import api as japi  # noqa: E402

from conftest import residual  # noqa: E402


def test_bug_1315_f32_nonsym_diag_converges():
    n = 1000
    d = np.arange(1.0, n + 1, dtype=np.float32)
    op = pt.from_diagonal(d, n_pad=pt.pad_dim(n), device="cpu")
    vals, vecs = pt.eigs(op, k=9, which="LM", ncv=19, tol=0.0,
                         maxiter=10 * n)
    np.testing.assert_allclose(np.sort(vals.real), np.arange(992.0, 1001.0),
                               rtol=2e-5)
    assert residual(np.diag(d.astype(np.float64)), vals, vecs).max() < 1e-3


def _conv_diff(nx=10, rho=100.0):
    """zndrv1's complex convection-diffusion block operator, dense."""
    h = 1.0 / (nx + 1)
    dd, dl, du = 4.0 / h, -1.0 / h - rho / 2.0, -1.0 / h + rho / 2.0
    t = sp.diags([dl, dd, du], [-1, 0, 1], shape=(nx, nx))
    eye = sp.eye(nx)
    a = (sp.kron(eye, t) + sp.kron(sp.diags([-1.0 / h, -1.0 / h], [-1, 1],
                                            shape=(nx, nx)), eye)).tocsr()
    return a.astype(np.complex128).toarray()


@pytest.mark.parametrize("strategy", ["auto", "fused"])
def test_bug_79_v0_used_as_given(strategy):
    a = _conv_diff()
    w, v = np.linalg.eig(a)
    j = np.argmax(np.abs(w))
    vals, vecs, out = pt.eigs(a, k=1, which="LM", tol=1e-10, v0=v[:, j],
                              maxiter=50, strategy=strategy,
                              return_stats=True, device="cpu")
    assert np.abs(vals[0] - w[j]) < 1e-8 * abs(w[j])
    assert out.stats.n_iter <= 2


@pytest.mark.parametrize("strategy", ["auto", "fused"])
def test_bug_79_all_ones_v0_converges(strategy):
    a = _conv_diff()
    vals, vecs = pt.eigs(a, k=4, which="LM", tol=1e-10,
                         v0=np.ones(a.shape[0], np.complex128), maxiter=500,
                         strategy=strategy, device="cpu")
    assert residual(a, vals, vecs).max() < 1e-8


@pytest.mark.parametrize("strategy", ["auto", "hybrid", "fused"])
def test_bug_58_singular_shift_invert_no_nans(strategy):
    n = 9
    a = np.eye(n)
    a[0, 0] = 0.0
    a[0, n - 1] = 1.0
    vals, vecs = pt.eigs(a, k=4, sigma=-1.0, which="LM", tol=1e-12,
                         maxiter=300, strategy=strategy, device="cpu")
    assert np.all(np.isfinite(vecs)) and np.all(np.isfinite(vals))
    assert residual(a, vals, vecs).max() < 1e-8
    assert np.min(np.abs(vals)) < 1e-8


def _pencil(n=120):
    k = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1]).toarray()
    m = (sp.diags([np.ones(n - 1), 4 * np.ones(n), np.ones(n - 1)],
                  [-1, 0, 1]) / 6.0).toarray()
    return k, m


@pytest.mark.parametrize("case", ["mode2", "shift-invert", "buckling",
                                  "eigs"])
def test_validate_f64_with_m_matches_reference(case):
    k, m = _pencil()
    kw = dict(k=3, M=m, which="LM", tol=1e-10, validate="f64",
              return_stats=True, device="cpu")
    if case == "eigs":
        vals, vecs, out = pt.eigs(k, sigma=0.5, **kw)
    else:
        extra = {} if case == "mode2" else dict(
            sigma=1.0, mode="normal" if case == "shift-invert"
            else "buckling")
        vals, vecs, out = pt.eigsh(k, maxiter=600, **extra, **kw)
    rep = out.validation
    assert rep.passed
    ckw = dict(n=120, nev=3, ncv=20, which="LM", tol=1e-10,
               dtype=np.dtype(np.float64))
    ref = japi._f64_validate(k, m, out, at.IRAMConfig(**ckw))
    for f in ("residuals", "rel_residuals", "tol_bar", "nonnormality"):
        np.testing.assert_allclose(getattr(rep, f), getattr(ref, f),
                                   rtol=1e-12)
    assert rep.passed == ref.passed
    # against the pencil itself: A v - lambda M v
    r = np.linalg.norm(k @ vecs - (m @ vecs) * vals, axis=0)
    np.testing.assert_allclose(rep.residuals, r / np.linalg.norm(
        vecs, axis=0), rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize("solver", ["eigsh", "eigs"])
@pytest.mark.parametrize("kind", ["operator", "callable"])
def test_validate_f64_refuses_matrix_free_m(solver, kind):
    k, m = _pencil(40)
    mf = pt.from_dense(m, device="cpu") if kind == "operator" else \
        (lambda v: m @ v)
    with pytest.raises(ValueError, match="matrix-free"):
        getattr(pt, solver)(k, k=2, M=mf, sigma=0.5, validate="f64",
                            device="cpu")
