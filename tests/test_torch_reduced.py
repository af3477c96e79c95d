"""The port's host reduced-space code (arpack_ng_tpu_torch/core/reduced.py)
against the reference package's on the same arrays: results must be
equal, with the native library and with the numpy/scipy branch."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from arpack_ng_tpu import native as jnative  # noqa: E402
from arpack_ng_tpu.core import reduced as jred  # noqa: E402
from arpack_ng_tpu_torch import native as pnative  # noqa: E402
from arpack_ng_tpu_torch.core import reduced as pred  # noqa: E402

WHICH = ["LA", "SA", "LM", "SM", "BE"]


@pytest.fixture(params=["native", "numpy"])
def backend(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(pnative, "available", lambda: False)
    return request.param


def _tridiag(k, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(k), np.abs(rng.standard_normal(k))


def _ritz(k, seed):
    rng = np.random.default_rng(seed)
    ritz = np.sort(rng.standard_normal(k))
    bounds = np.abs(rng.standard_normal(k)) * 1e-3
    bounds[::5] = 0.0
    return ritz, bounds


@pytest.mark.parametrize("k", [1, 7, 20])
def test_sym_eigt_equal(backend, k):
    alpha, beta = _tridiag(k, k)
    for need in (True, False):
        rj = jred.sym_eigt(alpha, beta, 0.37, need_vectors=need)
        rp = pred.sym_eigt(alpha, beta, 0.37, need_vectors=need)
        for a, b in zip(rj, rp):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", WHICH)
def test_sort_key_and_sym_gets_equal(which):
    ritz, bounds = _ritz(20, 3)
    if which != "BE":
        np.testing.assert_array_equal(jred.sort_key(which, ritz, False),
                                      pred.sort_key(which, ritz, False))
    for kev in (5, 6):
        rj = jred.sym_gets(which, kev, 20 - kev, ritz, bounds)
        rp = pred.sym_gets(which, kev, 20 - kev, ritz, bounds)
        for a, b in zip(rj, rp):
            np.testing.assert_array_equal(a, b)


def test_conv_mask_and_count_equal():
    ritz, bounds = _ritz(24, 4)
    for tol in (1e-3, 1e-6):
        np.testing.assert_array_equal(
            jred.conv_mask(ritz, bounds, tol, 1e-10),
            pred.conv_mask(ritz, bounds, tol, 1e-10))
        assert jred.conv_count(ritz, bounds, tol, 1e-10) == \
            pred.conv_count(ritz, bounds, tol, 1e-10)


def test_sym_shift_q_equal(backend):
    alpha, beta = _tridiag(16, 5)
    beta[6] = 1e-20  # a negligible coupling for the deflation sweep
    shifts = np.random.default_rng(6).standard_normal(9)
    rj = jred.sym_shift_q(alpha, beta, shifts, np.finfo(np.float64).eps)
    rp = pred.sym_shift_q(alpha, beta, shifts, np.finfo(np.float64).eps)
    for a, b in zip(rj, rp):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", WHICH)
@pytest.mark.parametrize("nconv", [0, 3, 7])
def test_exit_sort_equal(which, nconv):
    ritz, bounds = _ritz(20, 7)
    rj = jred.exit_sort(which, 7, nconv, ritz.copy(), bounds.copy(), 1e-10,
                        True, False)
    rp = pred.exit_sort(which, 7, nconv, ritz.copy(), bounds.copy(), 1e-10,
                        True, False)
    for a, b in zip(rj, rp):
        np.testing.assert_array_equal(a, b)
