"""Banded operators and drivers of ``arpack_ng_tpu_torch.ops.banded``
against ``arpack_ng_tpu/ops/banded.py`` (the classes of tests/test_banded.py
and the drivers of tests/test_bandsolve.py:130-205), on the same seeded
numpy inputs in float64:

* the band matvec against scipy within 1e-12 on random NON-symmetric
  bands (a negative diagonal arrives column-aligned and must be moved to
  the DIA table's rows) and against the reference's within 1e-14;
* ``eigsh_banded`` in modes 1-5 and ``eigs_banded`` (real shift, complex
  shift realified for either part, dense routes), through the dense
  inverse and through block cyclic reduction, with the reference's start
  vector: values within 1e-10*|lambda| of the reference's, the restart and
  operator counts equal, and the port's residuals (``conftest.residual``)
  within the reference test's bound."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import scipy.sparse as sp  # noqa: E402

import arpack_ng_tpu as at  # noqa: E402
from arpack_ng_tpu.ops import banded as jbd  # noqa: E402
from arpack_ng_tpu_torch.ops import banded as pbd  # noqa: E402

from conftest import residual  # noqa: E402

#: float64 values: port against reference, relative to max(1, |lambda|)
REL = 1e-10


def _toeplitz_band(n, diags):
    kl = -min(diags)
    ku = max(diags)
    ab = np.zeros((kl + ku + 1, n))
    for d, v in diags.items():
        if d >= 0:
            ab[ku - d, d:] = v
        else:
            ab[ku - d, : n + d] = v
    return ab, kl, ku


def _lap(n):
    return _toeplitz_band(n, {-1: -1.0, 0: 2.0, 1: -1.0})


def _mass(n):
    return _toeplitz_band(n, {-1: 1 / 6, 0: 4 / 6, 1: 1 / 6})[0]


def _penta(n, seed=42):
    """Random symmetric pentadiagonal (kl = ku = 2), as test_banded.py."""
    rng = np.random.default_rng(seed)
    d0 = rng.uniform(4, 6, n)
    d1 = rng.uniform(-1, 1, n - 1)
    d2 = rng.uniform(-0.5, 0.5, n - 2)
    ab = np.zeros((5, n))
    ab[0, 2:] = d2
    ab[1, 1:] = d1
    ab[2, :] = d0
    ab[3, :-1] = d1
    ab[4, :-2] = d2
    return ab, 2, 2


def _convdiff(n, rho=10.0):
    h = 1.0 / (n + 1)
    return _toeplitz_band(
        n, {-1: -1.0 / h - rho / 2, 0: 2.0 / h, 1: -1.0 / h + rho / 2})


def _v0(n):
    return np.random.default_rng(0).uniform(-1, 1, n)


def _agree(ref, got):
    (vj, _, oj), (vp, _, op_) = ref, got
    assert vp.shape == vj.shape
    for v in vp:
        assert np.min(np.abs(vj - v)) <= REL * max(1.0, abs(v)), (vp, vj)
    for v in vj:
        assert np.min(np.abs(vp - v)) <= REL * max(1.0, abs(v)), (vp, vj)
    assert (op_.n_iter, op_.stats.nopx) == (oj.n_iter, oj.stats.nopx)


class TestBandedMatvec:
    @pytest.mark.parametrize("kl,ku", [(2, 3), (3, 0), (0, 2), (1, 1)])
    def test_nonsymmetric_band_matches_scipy(self, kl, ku, rng):
        n, n_pad = 300, 384
        ab = rng.standard_normal((kl + ku + 1, n))
        a = sp.csr_matrix(
            sum(sp.diags(ab[ku - d, max(d, 0): n + min(d, 0)], d,
                         shape=(n, n)) for d in range(-kl, ku + 1)))
        x = np.zeros(n_pad)
        x[:n] = rng.standard_normal(n)
        mv = pbd.banded_matvec_fn(ab, kl, ku, n, n_pad, device="cpu")
        y = mv(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(y[:n], a @ x[:n], rtol=1e-12, atol=1e-12)
        assert not y[n:].any()
        yj = np.asarray(jbd.banded_matvec_fn(ab, kl, ku, n, n_pad)(x))
        np.testing.assert_allclose(y, yj, rtol=1e-14, atol=1e-14)
        # the host sparse form is the reference's
        assert abs(pbd._ab_to_sparse(ab, kl, ku, n)
                   - jbd._ab_to_sparse(ab, kl, ku, n)).max() == 0
        assert abs(pbd._ab_to_sparse(ab, kl, ku, n) - a).max() == 0

    def test_unpadded_matvec(self, rng):
        n = 257
        ab, kl, ku = _penta(n)
        mv = pbd.banded_matvec_fn(ab, kl, ku, n, n, device="cpu")
        x = rng.standard_normal(n)
        np.testing.assert_allclose(
            mv(torch.from_numpy(x)).numpy(),
            pbd._ab_to_sparse(ab, kl, ku, n) @ x, rtol=1e-12, atol=1e-12)

    def test_banded_operator(self, rng):
        n = 200
        ab, kl, ku = _convdiff(n)
        op = pbd.banded_operator(ab, kl, ku, device="cpu")
        assert (op.n, op.n_pad, op.mode, op.capturable) == (n, 256, 1, True)
        x = rng.standard_normal(n)
        np.testing.assert_allclose(op.matvec(x),
                                   pbd._ab_to_sparse(ab, kl, ku, n) @ x,
                                   rtol=1e-12)


# (name, band, kwargs of eigsh_banded, residual bound with M?)
SYM_CASES = {
    "mode1": (lambda: _lap(120), dict(k=4, which="LA", tol=1e-10)),
    "shift_invert_dense": (lambda: _lap(150),
                           dict(k=3, sigma=0.0, tol=1e-10)),
    "generalized_dense": (lambda: _penta(100),
                          dict(k=3, mb="mass", sigma=1.0, tol=1e-9)),
    "shift_invert_cr": (lambda: _lap(3000), dict(k=4, sigma=0.5, tol=1e-10)),
    "generalized_cr": (lambda: _lap(3000),
                       dict(k=4, mb="mass", sigma=0.7, tol=1e-10)),
    "buckling_cr": (lambda: _lap(2000),
                    dict(k=4, mb="mass", sigma=0.7, mode="buckling",
                         tol=1e-10)),
    "cayley_cr": (lambda: _lap(2000),
                  dict(k=4, mb="mass", sigma=0.7, mode="cayley", tol=1e-10)),
    "mode2_cr": (lambda: _lap(1100),
                 dict(k=4, mb="mass", tol=1e-8, ncv=32, maxiter=3000,
                      solver="cr")),
    "lu_fallback": (lambda: _lap(3000), dict(k=4, sigma=2.0, tol=1e-10)),
}


class TestEigshBanded:
    @pytest.mark.parametrize("case", list(SYM_CASES))
    def test_matches_reference(self, case):
        band, kw = SYM_CASES[case]
        ab, kl, ku = band()
        n = ab.shape[1]
        kw = dict(kw)
        if kw.get("mb") == "mass":
            kw["mb"] = _mass(n) if kl == 1 else \
                np.pad(_mass(n), ((1, 1), (0, 0)))
        mode_num = {"normal": 3, "buckling": 4, "cayley": 5}[
            kw.get("mode", "normal")]
        jop = jbd._banded_spectral_op(ab, kw.get("mb"), kl, ku,
                                      kw.get("sigma"), mode_num, True, None,
                                      solver=kw.get("solver", "auto"))
        ref = at.eigsh(jop, k=kw["k"], which=kw.get("which", "LM"),
                       ncv=kw.get("ncv"), tol=kw["tol"],
                       maxiter=kw.get("maxiter", 500), v0=_v0(n),
                       return_stats=True)
        got = pbd.eigsh_banded(ab, kl, ku, v0=_v0(n), return_stats=True,
                               device="cpu", **kw)
        _agree(ref, got)
        a = pbd._ab_to_sparse(ab, kl, ku, n)
        m = None if kw.get("mb") is None else \
            pbd._ab_to_sparse(kw["mb"], kl, ku, n)
        assert residual(a, got[0], got[1], m).max() < \
            (1e-6 if case == "mode2_cr" else 1e-7)

    def test_generalized_dense_matches_lapack(self):
        # tests/test_banded.py::test_generalized_banded on the port
        import scipy.linalg as sla
        n = 100
        ab, kl, ku = _penta(n)
        mb = np.pad(_mass(n), ((1, 1), (0, 0)))
        vals, vecs = pbd.eigsh_banded(ab, kl, ku, k=3, mb=mb, sigma=1.0,
                                      which="LM", tol=1e-9, dtype=np.float64,
                                      device="cpu")
        a = pbd._ab_to_sparse(ab, kl, ku, n)
        m = pbd._ab_to_sparse(mb, kl, ku, n)
        w = sla.eigh(a.toarray(), m.toarray(), eigvals_only=True)
        close = w[np.argsort(np.abs(w - 1.0))][:3]
        np.testing.assert_allclose(np.sort(vals), np.sort(close), rtol=1e-7)

    def test_capturable_unless_lu(self):
        n = 3000
        ab, kl, ku = _lap(n)
        ops = {s: pbd._banded_spectral_op(ab, None, kl, ku, s, 3, True, None,
                                          device="cpu")
               for s in (0.5, 2.0)}
        assert ops[0.5].capturable and not ops[2.0].capturable
        dense = pbd._banded_spectral_op(_lap(200)[0], None, 1, 1, 0.5, 3,
                                        True, None, device="cpu")
        assert dense.capturable

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        ab, kl, ku = _lap(3000)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pbd.eigsh_banded(ab, kl, ku, k=4, sigma=0.5)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pbd.eigs_banded(ab, kl, ku, k=4, sigma=0.5)


NONSYM_CASES = {
    "mode1": (lambda: _convdiff(120), dict(k=4, tol=1e-10)),
    "shift_invert_dense": (lambda: _convdiff(200), dict(k=4, sigma=1.0,
                                                        tol=1e-10)),
    "shift_invert_cr": (lambda: _convdiff(3000), dict(k=4, sigma=1.0,
                                                      tol=1e-10)),
    "complex_shift_real_part": (lambda: _convdiff(3000),
                                dict(k=4, sigma=1.0 + 5.0j, tol=1e-10,
                                     part="real")),
    "complex_shift_imag_part": (lambda: _convdiff(2000),
                                dict(k=4, sigma=1.0 + 5.0j, tol=1e-10,
                                     part="imag")),
}


class TestEigsBanded:
    @pytest.mark.parametrize("case", list(NONSYM_CASES))
    def test_matches_reference(self, case):
        band, kw = NONSYM_CASES[case]
        ab, kl, ku = band()
        n = ab.shape[1]
        jop = jbd._banded_spectral_op(ab, None, kl, ku, kw.get("sigma"), 3,
                                      False, None,
                                      part=kw.get("part", "real"))
        ref = at.eigs(jop, k=kw["k"], which="LM", tol=kw["tol"],
                      maxiter=500, v0=_v0(n), return_stats=True)
        got = pbd.eigs_banded(ab, kl, ku, v0=_v0(n), return_stats=True,
                              device="cpu", **kw)
        _agree(ref, got)
        # mode 4 (the imaginary part, no reference test of its own): the
        # reference's values, whose Rayleigh-quotient residuals reach 1.6e-7
        bound = 1e-6 if kw.get("part") == "imag" else 1e-7
        assert residual(pbd._ab_to_sparse(ab, kl, ku, n), got[0],
                        got[1]).max() < bound
