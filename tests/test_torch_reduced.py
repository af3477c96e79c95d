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


NONSYM_WHICH = ["LM", "SM", "LR", "SR", "LI", "SI"]


def _hessenberg(k, seed):
    rng = np.random.default_rng(seed)
    return np.triu(rng.standard_normal((k, k)), -1)


def _conj_ritz(k, seed):
    """Ritz values of a real problem (conjugate pairs, +imag first, some
    real) with bounds equal across each pair."""
    rng = np.random.default_rng(seed)
    vals, bnds = [], []
    while len(vals) < k:
        if len(vals) < k - 1 and rng.random() < 0.6:
            z = complex(rng.standard_normal(), abs(rng.standard_normal()))
            b = abs(rng.standard_normal()) * 1e-3
            vals += [z, z.conjugate()]
            bnds += [b, b]
        else:
            vals.append(complex(rng.standard_normal(), 0.0))
            bnds.append(abs(rng.standard_normal()) * 1e-3)
    perm = rng.permutation(k)
    return np.array(vals)[perm], np.array(bnds)[perm]


@pytest.mark.parametrize("real_pairs", [True, False])
@pytest.mark.parametrize("which", NONSYM_WHICH)
def test_sortc_order_equal(which, real_pairs):
    ritz, _ = _conj_ritz(20, 8)
    np.testing.assert_array_equal(jred.sortc_order(which, ritz, real_pairs),
                                  pred.sortc_order(which, ritz, real_pairs))


@pytest.mark.parametrize("k", [2, 9, 24])
def test_nonsym_eigt_equal(k):
    H = _hessenberg(k, k)
    for a, b in zip(jred.nonsym_eigt(H, 0.37), pred.nonsym_eigt(H, 0.37)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", NONSYM_WHICH)
def test_nonsym_gets_equal(which):
    # kev from 4 to 9: some cut splits a conjugate pair (kev grows by one)
    ritz, bounds = _conj_ritz(20, 9)
    grew = False
    for kev in range(4, 10):
        rj = jred.nonsym_gets(which, kev, 20 - kev, ritz, bounds, True)
        rp = pred.nonsym_gets(which, kev, 20 - kev, ritz, bounds, True)
        assert rj[:2] == rp[:2]
        grew |= rp[0] == kev + 1
        for a, b in zip(rj[2:], rp[2:]):
            np.testing.assert_array_equal(a, b)
    assert grew


def test_deflate_hess_equal():
    H = _hessenberg(12, 10)
    H[4, 3], H[8, 7] = 1e-20, 0.0
    H[9, 9] = H[10, 10] = 0.0
    Hj, Hp = H.copy(), H.copy()
    jred._deflate_hess(Hj, np.finfo(np.float64).eps, 1e-300)
    pred._deflate_hess(Hp, np.finfo(np.float64).eps, 1e-300)
    np.testing.assert_array_equal(Hj, Hp)
    assert Hp[4, 3] == 0.0
    np.testing.assert_array_equal(jred._truncate_hessenberg(H),
                                  pred._truncate_hessenberg(H))


@pytest.mark.parametrize("real_arith", [True, False])
def test_nonsym_shift_q_equal(real_arith):
    H = _hessenberg(16, 11)
    ritz, _ = _conj_ritz(7, 12)
    shifts = ritz if real_arith else ritz.real
    rj = jred.nonsym_shift_q(H, shifts, np.finfo(np.float64).eps, 1e-300,
                             real_arith)
    rp = pred.nonsym_shift_q(H, shifts, np.finfo(np.float64).eps, 1e-300,
                             real_arith)
    for a, b in zip(rj, rp):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", NONSYM_WHICH)
@pytest.mark.parametrize("nconv", [0, 3, 7])
def test_exit_sort_nonsym_equal(which, nconv):
    ritz, bounds = _conj_ritz(20, 13)
    rj = jred.exit_sort(which, 7, nconv, ritz.copy(), bounds.copy(), 1e-10,
                        False, True)
    rp = pred.exit_sort(which, 7, nconv, ritz.copy(), bounds.copy(), 1e-10,
                        False, True)
    for a, b in zip(rj, rp):
        np.testing.assert_array_equal(a, b)
