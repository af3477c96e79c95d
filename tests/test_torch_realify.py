"""The port's realification (``arpack_ng_tpu_torch.ops.realify``): complex
problems through the real drivers, mirroring tests/test_realify.py whole,
with the realified operators held against the reference package's on the
same inputs.

Tolerances: the realified matrices and matvecs equal the reference's (the
same host arrays; the products to 1e-13 relative); the solves keep the
reference tests' gates (values within 1e-7-1e-8 of LAPACK, residuals
below 1e-7 in float64)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import scipy.sparse as sp  # noqa: E402
import scipy.sparse.linalg as spla  # noqa: E402

import arpack_ng_tpu.ops.realify as jrf  # noqa: E402
import arpack_ng_tpu_torch.ops.realify as rf  # noqa: E402
from arpack_ng_tpu_torch.ops.realify import (eigs_realified,  # noqa: E402
                                             realify_dense, realify_matvec,
                                             realify_sparse)

CPU = dict(device="cpu")


def _band(rng, n=800):
    d0 = 3.0 + rng.standard_normal(n) + 1j * rng.standard_normal(n)
    d1 = rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1)
    return (sp.diags(d0) + sp.diags(d1, 1)
            + sp.diags(0.5 * d1.conj(), -1)).tocsr()


def test_general_complex(rng):
    n = 90
    a = (rng.standard_normal((n, n))
         + 1j * rng.standard_normal((n, n))) / np.sqrt(n)
    vals, vecs = eigs_realified(a.astype(np.complex128), k=4, which="LM",
                                tol=1e-10, maxiter=1000, **CPU)
    assert len(vals) == 4
    w = np.linalg.eigvals(a)
    wtop = np.sort(np.abs(w))[-4:]
    np.testing.assert_allclose(np.sort(np.abs(vals)), wtop, rtol=1e-7)
    for i in range(4):
        r = np.linalg.norm(a @ vecs[:, i] - vals[i] * vecs[:, i])
        assert r < 1e-7


def test_hermitian_routes_symmetric(rng):
    n = 100
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a = ((a + a.conj().T) / 2).astype(np.complex128)
    op = realify_dense(a, **CPU)
    assert op.hermitian
    vals, vecs = eigs_realified(a, k=3, which="LA", tol=1e-10, **CPU)
    w = np.linalg.eigvalsh(a)
    np.testing.assert_allclose(np.sort(vals.real), w[-3:], rtol=1e-8)
    for i in range(3):
        r = np.linalg.norm(a @ vecs[:, i] - vals[i] * vecs[:, i])
        assert r < 1e-7


def test_rejects_real_input(rng):
    with pytest.raises(ValueError, match="complex"):
        realify_dense(rng.standard_normal((10, 10)), **CPU)
    with pytest.raises(ValueError, match="complex"):
        realify_sparse(sp.identity(10, format="csr"), **CPU)
    with pytest.raises(ValueError, match="sparse"):
        realify_sparse(np.eye(10, dtype=np.complex128), **CPU)


def test_sparse_general_complex(rng):
    """A complex SPARSE matrix through the real drivers: the realified
    [[Ar, -Ai], [Ai, Ar]] block matrix takes the sparse importer (DIA for a
    banded input)."""
    a = _band(rng)
    vals, vecs = eigs_realified(a, k=4, which="LM", tol=1e-10,
                                maxiter=3000, **CPU)
    assert len(vals) == 4
    for i in range(4):
        r = np.linalg.norm(a @ vecs[:, i] - vals[i] * vecs[:, i])
        assert r < 1e-8
    sv = spla.eigs(a, k=4, which="LM", return_eigenvectors=False,
                   maxiter=8000)
    np.testing.assert_allclose(np.sort_complex(np.round(vals, 6)),
                               np.sort_complex(np.round(sv, 6)), atol=1e-4)


def test_sparse_hermitian_complex(rng):
    n = 800
    h1 = rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1)
    a = (sp.diags(h1, 1) + sp.diags(h1.conj(), -1)
         + sp.diags(4.0 + rng.standard_normal(n))).tocsr()
    vals, vecs = eigs_realified(a, k=3, which="LM", tol=1e-10,
                                maxiter=3000, **CPU)
    assert len(vals) == 3
    assert np.max(np.abs(np.imag(vals))) < 1e-8  # Hermitian: real spectrum
    for i in range(3):
        r = np.linalg.norm(a @ vecs[:, i] - vals[i] * vecs[:, i])
        assert r < 1e-7


def test_exact_k_delivery_real_spectrum(rng):
    # a complex matrix with a real spectrum: each eigenvalue's realified
    # conjugate copy coincides with it, so 2k values hold only k distinct
    # ones; the dedup and retry must still deliver exactly k pairs
    n = 40
    q, _ = np.linalg.qr(rng.standard_normal((n, n))
                        + 1j * rng.standard_normal((n, n)))
    lam = np.linspace(1.0, 5.0, n)
    a = np.asarray((q * lam) @ q.conj().T, np.complex128)
    vals, vecs = eigs_realified(a, k=4, which="LM", tol=1e-10,
                                maxiter=2000, **CPU)
    assert len(vals) == 4
    res = [np.linalg.norm(a @ vecs[:, i] - vals[i] * vecs[:, i])
           for i in range(4)]
    assert max(res) < 1e-7


def test_under_delivery_retry_one_sided_selector(rng):
    # an asymmetric spectrum and 'LI': the conjugate copies of the most
    # negative-imaginary eigenvalues rank top and are rejected, so the
    # solver widens the subspace and still delivers k pairs
    n = 30
    lam = (rng.standard_normal(n) + 1j * (-np.abs(rng.standard_normal(n))
                                          - 0.5))
    q, _ = np.linalg.qr(rng.standard_normal((n, n))
                        + 1j * rng.standard_normal((n, n)))
    a = (q * lam) @ np.linalg.inv(q)
    vals, vecs = eigs_realified(a, k=3, which="LI", tol=1e-8,
                                maxiter=3000, **CPU)
    assert len(vals) == 3
    for i in range(3):
        assert np.min(np.abs(lam - vals[i])) < 1e-5
        assert np.linalg.norm(a @ vecs[:, i] - vals[i] * vecs[:, i]) \
            < 1e-5


def test_under_delivery_warns_instead_of_silent_short_return(monkeypatch):
    monkeypatch.setattr(
        rf, "_recover",
        lambda vals, vecs, a, n, half, k, tol=0.0:
        (np.array([]), np.zeros((a.shape[0], 0), complex)))
    a = np.diag(np.array([1.0 + 1.0j, 2.0 - 0.5j, 3.0 + 0.2j]))
    with pytest.warns(UserWarning, match="recovered 0 of 2"):
        vals, vecs = rf.eigs_realified(a, k=2, which="LM", tol=1e-10,
                                       **CPU)
    assert len(vals) == 0 and vecs.shape == (3, 0)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_operators_match_reference(dtype, rng):
    # the same block matrix as the reference builds, dense and sparse, with
    # its format, padding and symmetry flag; the products agree
    import jax.numpy as jnp
    a = _band(rng, 300).astype(dtype)
    x = rng.standard_normal(2 * 1024).astype(np.dtype(dtype).type(0).real
                                             .dtype)
    for build, jbuild, arg in ((realify_sparse, jrf.realify_sparse, a),
                               (realify_dense, jrf.realify_dense,
                                a.toarray())):
        op, opj = build(arg, **CPU), jbuild(arg)
        assert (op.n, op.n_pad, op.hermitian, op.dtype) == \
            (opj.n, opj.n_pad, opj.hermitian, opj.dtype)
        xp = x[:op.n_pad]
        y = op.a_apply(torch.from_numpy(xp)).numpy()
        yj = np.asarray(opj.a_apply(jnp.asarray(xp)))
        np.testing.assert_allclose(y, yj, rtol=1e-5 if dtype == np.complex64
                                   else 1e-13, atol=1e-6)


def test_banded_realifies_to_dia(rng):
    # past the dense size the banded block matrix is imported as DIA (the
    # DIA kernel on the card), as in the reference
    a = _band(rng, 3000)
    op, opj = realify_sparse(a, **CPU), jrf.realify_sparse(a)
    assert op.format == opj.format == "dia"
    x = rng.standard_normal(op.n_pad)
    np.testing.assert_allclose(op.matvec(x), opj.matvec(x), rtol=1e-13,
                               atol=1e-13)


def test_realify_matvec_stacks_halves(rng):
    n, n2 = 5, 16
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a_t = torch.from_numpy(a)
    mv = realify_matvec(lambda z: a_t @ z, n, n2)
    u = torch.from_numpy(rng.standard_normal(n2))
    out = mv(u).numpy()
    z = a @ (u[:n].numpy() + 1j * u[8:8 + n].numpy())
    np.testing.assert_allclose(out[:n], z.real, rtol=1e-14)
    np.testing.assert_allclose(out[8:8 + n], z.imag, rtol=1e-14)
    assert not out[n:8].any() and not out[8 + n:].any()


def test_mesh_matches_single(rng, tmp_path):
    # mesh= on 2 gloo ranks (tests/torch_mp_worker.py): the realified solve
    # row-partitioned, the recovery on the whole vectors; both ranks equal
    # bit for bit, the values those of the single-device solve (1e-10) and
    # of LAPACK (1e-8), residuals below 1e-8
    from torch_mp_worker import run_world
    n = 64
    a = (rng.standard_normal((n, n))
         + 1j * rng.standard_normal((n, n))) / np.sqrt(n)
    out = run_world(2, ["realify"], tmp_path, {"realify": a})["realify"]
    for r in out:
        assert "error" not in r, r.get("error")
    np.testing.assert_array_equal(out[0]["vals"], out[1]["vals"])
    vals, vecs = out[0]["vals"], out[0]["vecs"]
    assert len(vals) == 3
    key = np.argsort(-np.abs(vals))
    np.testing.assert_allclose(vals[key],
                               out[0]["single"][np.argsort(
                                   -np.abs(out[0]["single"]))], rtol=1e-10)
    ev = np.linalg.eigvals(a)
    top = ev[np.argsort(-np.abs(ev))[:3]]
    for v in vals:
        assert np.min(np.abs(top - v)) < 1e-8 * np.abs(v)
    for i in range(3):
        assert np.linalg.norm(a @ vecs[:, i] - vals[i] * vecs[:, i]) < 1e-8


def test_mesh_type_checked():
    with pytest.raises(TypeError, match="RowMesh"):
        eigs_realified(np.eye(4, dtype=np.complex128), k=1, mesh=object(),
                       **CPU)
