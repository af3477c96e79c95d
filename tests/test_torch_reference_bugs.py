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
  complex one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import scipy.sparse as sp  # noqa: E402

import arpack_ng_tpu_torch as pt  # noqa: E402

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
