"""``arpack_ng_tpu_torch.svds`` against ``arpack_ng_tpu.svds`` and numpy's
dense SVD (tests/test_svd.py without its mesh test, and
tests/test_hermitian.py::test_svds_complex_hermitian_route).

Both packages take the same seeded numpy matrix.  In float64 the singular
values agree with the reference's within 1e-10 relative and with numpy's
within 1e-8, and the triplet residuals ``||A v - s u||`` and
``||A^H u - s v||`` meet the reference test's bounds; the float32 case
holds the augmented method's accuracy against the normal one's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import arpack_ng_tpu as at  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402


def _both(a, **kw):
    return at.svds(a, **kw), pt.svds(a, device="cpu", **kw)


def _same_s(s_ref, s):
    np.testing.assert_allclose(s, s_ref, rtol=1e-10)


class TestSvds:
    @pytest.mark.parametrize("method", ["normal", "augmented"])
    def test_tall_matrix(self, rng, method):
        m, n = 300, 80
        a = rng.standard_normal((m, n))
        (_, sj, _), (u, s, vh) = _both(a.astype(np.float64), k=5, tol=1e-10,
                                       method=method)
        _same_s(sj, s)
        s_ref = np.linalg.svd(a, compute_uv=False)
        np.testing.assert_allclose(s, np.sort(s_ref[:5]), rtol=1e-8)
        for i in range(5):
            assert np.linalg.norm(a @ vh[i] - s[i] * u[:, i]) < 1e-7
            assert np.linalg.norm(a.T @ u[:, i] - s[i] * vh[i]) < 1e-7

    def test_wide_matrix(self, rng):
        m, n = 60, 200
        a = rng.standard_normal((m, n))
        (_, sj, _), (u, s, vh) = _both(a.astype(np.float64), k=4,
                                       tol=1e-10)
        _same_s(sj, s)
        s_ref = np.linalg.svd(a, compute_uv=False)
        np.testing.assert_allclose(s, np.sort(s_ref[:4]), rtol=1e-8)
        for i in range(4):
            assert np.linalg.norm(a @ vh[i] - s[i] * u[:, i]) < 1e-7

    @pytest.mark.parametrize("method,shape", [("normal", (150, 60)),
                                              ("augmented", (90, 40))])
    def test_complex(self, rng, method, shape):
        # the complex Gram (or cyclic) operator is Hermitian: it runs the
        # Hermitian Lanczos driver (tests/test_hermitian.py
        # ::test_svds_complex_hermitian_route)
        a = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
        (_, sj, _), (u, s, vh) = _both(a.astype(np.complex128), k=3,
                                       tol=1e-10, method=method)
        _same_s(sj, s)
        s_ref = np.linalg.svd(a, compute_uv=False)
        np.testing.assert_allclose(s, np.sort(s_ref[:3]), rtol=1e-8)
        for i in range(3):
            assert np.linalg.norm(a @ vh[i].conj() - s[i] * u[:, i]) < 1e-6

    def test_values_only(self, rng):
        a = rng.standard_normal((100, 50)).astype(np.float64)
        sj, s = _both(a, k=3, tol=1e-10, return_singular_vectors=False)
        _same_s(sj, s)
        np.testing.assert_allclose(
            s, np.sort(np.linalg.svd(a, compute_uv=False)[:3]), rtol=1e-8)

    def test_augmented_beats_normal_in_f32(self, rng):
        # kappa(A) = 1e4: the Gram operator's small eigenvalues sigma^2 sit
        # below float32 resolution, the cyclic operator keeps them at sigma
        m, n, k = 50, 8, 6
        s_true = np.logspace(0, -4, n)
        qu, _ = np.linalg.qr(rng.standard_normal((m, n)))
        qv, _ = np.linalg.qr(rng.standard_normal((n, n)))
        a = (qu * s_true) @ qv.T
        want = np.sort(s_true)[-k:]
        kw = dict(k=k, dtype=np.float32, return_singular_vectors=False,
                  maxiter=2000, device="cpu")
        s_aug = pt.svds(a, method="augmented", **kw)
        s_nrm = pt.svds(a, method="normal", **kw)
        err_aug = np.max(np.abs(s_aug - want) / want)
        err_nrm = np.max(np.abs(s_nrm - want) / want)
        assert err_aug < 1e-3
        # the ordering only means something where the normal path
        # struggles; both at the float32 floor are rounding luck
        assert err_aug < err_nrm or err_nrm < 5e-6

    def test_smallest(self, rng):
        a = rng.standard_normal((80, 40)).astype(np.float64)
        sj, s = _both(a, k=3, which="SM", tol=1e-10,
                      return_singular_vectors=False, maxiter=3000, ncv=30)
        _same_s(sj, s)
        s_ref = np.sort(np.linalg.svd(a, compute_uv=False))
        np.testing.assert_allclose(np.sort(s), s_ref[:3], rtol=1e-6)

    def test_matvec_pair(self, rng):
        # a caller's products (not capturable) give the dense input's
        # triplets
        a = rng.standard_normal((120, 50))
        at_ = torch.from_numpy(a)
        u, s, vh = pt.svds(matvec=lambda x: at_ @ x,
                           rmatvec=lambda y: at_.T @ y, shape=a.shape, k=3,
                           tol=1e-10, dtype=np.float64, device="cpu")
        _, s0, _ = pt.svds(a, k=3, tol=1e-10, device="cpu")
        np.testing.assert_allclose(s, s0, rtol=1e-12)
        for i in range(3):
            assert np.linalg.norm(a @ vh[i] - s[i] * u[:, i]) < 1e-7

    @pytest.mark.parametrize("method", ["normal", "augmented"])
    def test_tensor_input(self, rng, method):
        # a torch tensor is used where it lies (its adjoint a view, so the
        # products round in another order): the numpy input's values within
        # 1e-12 relative, and the triplets' residuals
        a = rng.standard_normal((120, 50))
        kw = dict(k=3, tol=1e-10, method=method, device="cpu")
        u, s, vh = pt.svds(torch.from_numpy(a), **kw)
        s0 = pt.svds(a, return_singular_vectors=False, **kw)
        np.testing.assert_allclose(s, s0, rtol=1e-12)
        for i in range(3):
            assert np.linalg.norm(a @ vh[i] - s[i] * u[:, i]) < 1e-7
            assert np.linalg.norm(a.T @ u[:, i] - s[i] * vh[i]) < 1e-7

    @pytest.mark.parametrize("kw", [dict(mesh=object()),
                                    dict(method="qr"),
                                    dict(method="augmented", which="SM"),
                                    dict(which="LA")])
    def test_refusals(self, rng, kw):
        a = rng.standard_normal((30, 20))
        exc = NotImplementedError if "mesh" in kw else ValueError
        with pytest.raises(exc):
            pt.svds(a, k=2, device="cpu", **kw)
        if "mesh" not in kw:
            with pytest.raises(ValueError):
                at.svds(a, k=2, **kw)
