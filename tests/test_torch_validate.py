"""``validate=`` in the port (``F64Validation``, ``PseudospectrumWarning``)
against the reference package: tests/test_eigsh.py::TestEigshValidate and
tests/test_eigs.py::TestF64Validation on the port, the report's fields
equal to the reference's ``_f64_validate`` on the same output, and the
``ValueError``s the port raises where the reference goes on silently.

Tolerances: the reports are computed from the same float64 arrays by the
same numpy code, so their fields agree to 1e-12 relative (nonnormality
and residuals) and their flags exactly."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import arpack_ng_tpu as at  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu import api as japi  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu_torch import api as papi  # noqa: E402
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402

FIELDS = ("residuals", "rel_residuals", "tol_bar", "passed", "nonnormality")


class TestEigshValidate:
    """tests/test_eigsh.py::TestEigshValidate on the port."""

    @pytest.mark.parametrize("strategy", ["auto", "hybrid"])
    def test_f64_report(self, strategy):
        rng = np.random.default_rng(0)
        a = rng.standard_normal((200, 200)).astype(np.float32)
        a = a + a.T
        vals, vecs, out = pt.eigsh(a, k=4, which="LA", tol=1e-4,
                                   validate="f64", return_stats=True,
                                   strategy=strategy, device="cpu")
        rep = out.validation
        assert isinstance(rep, pt.F64Validation) and rep.passed
        assert rep.nonnormality < 1e-5   # symmetric => normal
        assert rep.residuals.shape == (len(vals),)

    def test_matrix_free_needs_callable(self):
        op = pt.from_diagonal(np.arange(1.0, 65.0), device="cpu")
        with pytest.raises(ValueError, match="matrix-free"):
            pt.eigsh(op, k=3, tol=1e-8, validate="f64")
        d64 = np.arange(1.0, 65.0)
        vals, _, out = pt.eigsh(op, k=3, which="LM", tol=1e-8,
                                validate=lambda v: d64 * v,
                                return_stats=True)
        assert out.validation.passed
        assert np.isnan(out.validation.nonnormality)

    def test_hermitian_report(self):
        # a complex Hermitian matrix: complex128 residuals, normal operator
        rng = np.random.default_rng(2)
        a = rng.standard_normal((120, 120)) + 1j * rng.standard_normal(
            (120, 120))
        a = ((a + a.conj().T) / 2).astype(np.complex64)
        vals, out = pt.eigsh(a, k=3, which="LA", tol=1e-4, validate="f64",
                             return_stats=True, return_eigenvectors=False,
                             device="cpu")
        assert out.vectors is None and np.isrealobj(vals)
        assert out.validation.passed
        assert out.validation.nonnormality < 1e-5


class TestF64Validation:
    """tests/test_eigs.py::TestF64Validation on the port."""

    def test_warns_on_nonnormal_f32(self):
        # strongly convective operator in float32: detectably non-normal,
        # PseudospectrumWarning fires and the report is attached
        _, a_sp = pmodels.convection_diffusion_2d(16, rho=400.0,
                                                  device="cpu")
        a32 = a_sp.astype(np.float32)
        with pytest.warns(pt.PseudospectrumWarning):
            vals, vecs, out = pt.eigs(a32, k=4, which="LM", ncv=20,
                                      tol=1e-4, maxiter=500, validate="f64",
                                      return_stats=True, device="cpu")
        rep = out.validation
        assert rep is not None
        assert rep.nonnormality > 1e-6
        assert rep.residuals.shape == vals.shape
        assert np.all(np.isfinite(rep.rel_residuals))

    @pytest.mark.parametrize("strategy", ["auto", "hybrid"])
    def test_no_warning_on_normal_f64(self, strategy):
        rng = np.random.default_rng(0)
        a = rng.standard_normal((60, 60))
        a = (a + a.T).astype(np.float64)
        with warnings.catch_warnings():
            warnings.simplefilter("error", pt.PseudospectrumWarning)
            vals, vecs, out = pt.eigs(a, k=4, which="LM", tol=1e-10,
                                      validate="f64", return_stats=True,
                                      strategy=strategy, device="cpu")
        assert out.validation.passed
        assert out.validation.nonnormality < 1e-10

    @pytest.mark.parametrize("strategy", ["auto", "hybrid"])
    def test_no_warning_on_nonnormal_f64(self, strategy):
        # the same non-normal operator solved in float64: its values are
        # complex, but the solve is not single precision, so no warning
        # (the reference warns here: it reads the width off the values)
        _, a_sp = pmodels.convection_diffusion_2d(16, rho=400.0,
                                                  device="cpu")
        a64 = a_sp.astype(np.float64)
        with warnings.catch_warnings():
            warnings.simplefilter("error", pt.PseudospectrumWarning)
            vals, vecs, out = pt.eigs(a64, k=4, which="LM", ncv=20,
                                      tol=1e-10, maxiter=500,
                                      validate="f64", return_stats=True,
                                      strategy=strategy, device="cpu")
        assert np.iscomplexobj(vals)
        assert out.validation.passed
        assert out.validation.nonnormality > 1e-6

    def test_matrix_free_requires_callable(self):
        op, a_sp = pmodels.convection_diffusion_1d(96, rho=10.0,
                                                   dtype=np.float64,
                                                   device="cpu")
        with pytest.raises(ValueError, match="matrix-free"):
            pt.eigs(op, k=3, which="LM", tol=1e-8, validate="f64")
        a64 = a_sp.astype(np.float64)
        vals, _, out = pt.eigs(op, k=3, which="LM", tol=1e-8,
                               validate=lambda v: a64 @ v,
                               return_stats=True)
        assert out.validation is not None and out.validation.passed
        assert np.isnan(out.validation.nonnormality)

    def test_complex_report(self):
        # complex eigs (the hybrid driver): a complex128 report
        _, a = pmodels.convection_diffusion_2d(10, dtype=np.complex128,
                                               device="cpu")
        a = a.astype(np.complex128)
        vals, vecs, out = pt.eigs(a, k=3, which="LM", tol=1e-10,
                                  validate="f64", return_stats=True,
                                  device="cpu")
        assert out.validation.passed
        assert out.validation.residuals.dtype == np.float64


def _same_report(rp, rj):
    for f in FIELDS:
        got, want = getattr(rp, f), getattr(rj, f)
        if f == "passed":
            assert got == want
        elif np.all(np.isnan(want)):
            assert np.all(np.isnan(got))
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("case", ["real-f32", "real-f64", "complex",
                                  "callable"])
def test_report_fields_equal_reference(case):
    # one port solve, its output through both packages' _f64_validate:
    # every field of F64Validation the same
    if case == "complex":
        _, a = pmodels.convection_diffusion_2d(8, dtype=np.complex64,
                                               device="cpu")
        a = a.astype(np.complex64)
    else:
        _, a = pmodels.convection_diffusion_2d(
            8, rho=400.0, dtype=np.float64, device="cpu")
        a = a.astype(np.float32 if case == "real-f32" else np.float64)
    tol = 1e-10 if a.dtype == np.float64 else 1e-4
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", pt.PseudospectrumWarning)
        vals, vecs, out = pt.eigs(a, k=3, which="LM", ncv=16, tol=tol,
                                  maxiter=500, return_stats=True,
                                  device="cpu")
    ckw = dict(n=a.shape[0], nev=3, ncv=16, which="LM", tol=tol,
               dtype=np.dtype(a.dtype))
    a64 = a.astype(np.complex128 if case == "complex" else np.float64)
    mv = (lambda v: a64 @ v) if case == "callable" else None
    with warnings.catch_warnings(record=True) as wp:
        warnings.simplefilter("always")
        rp = papi._f64_validate(None if mv else a, out,
                                pt.IRAMConfig(**ckw), matvec64=mv)
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        rj = japi._f64_validate(None if mv else a, None, out,
                                at.IRAMConfig(**ckw), matvec64=mv)
    _same_report(rp, rj)
    got = [w.category.__name__ for w in wp]
    want = [w.category.__name__ for w in wj]
    if case == "real-f64":
        # a float64 solve with complex values: the reference reads the
        # solve's width off the values and warns of single precision; the
        # port reads it off the dtype (ROADMAP Queue 3)
        assert want == ["PseudospectrumWarning"] and got == []
    else:
        assert got == want


@pytest.mark.parametrize("solver", ["eigsh", "eigs"])
def test_bad_validate_value_raises_like_reference(solver):
    a = np.diag(np.arange(1.0, 41.0))
    for fn in (getattr(pt, solver), getattr(at, solver)):
        kw = dict(device="cpu") if fn is getattr(pt, solver) else {}
        with pytest.raises(ValueError, match="validate must be"):
            fn(a, k=2, tol=1e-8, validate="f32", **kw)


def test_validate_under_return_schur_raises():
    # the reference skips validate= under return_schur without a word
    # (arpack_ng_tpu/api.py:463); the port refuses
    _, a = pmodels.convection_diffusion_2d(8, dtype=np.float64, device="cpu")
    with pytest.raises(ValueError, match="return_schur"):
        pt.eigs(a, k=3, tol=1e-8, validate="f64", return_schur=True,
                device="cpu")
    # the reference returns Schur vectors and no report
    _, Q, out = at.eigs(a, k=3, tol=1e-8, validate="f64", return_schur=True,
                        return_stats=True)
    assert out.validation is None


def test_matrix_free_operator_raises_like_reference():
    # validate='f64' on an Operator: the reference's own ValueError
    opj, _ = jmodels.laplacian_1d(64, dtype=np.float64)
    opp, _ = pmodels.laplacian_1d(64, dtype=np.float64, device="cpu")
    with pytest.raises(ValueError, match="matrix-free"):
        at.eigsh(opj, k=2, which="LA", validate="f64")
    with pytest.raises(ValueError, match="matrix-free"):
        pt.eigsh(opp, k=2, which="LA", validate="f64")
