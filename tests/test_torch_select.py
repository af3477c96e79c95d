"""``howmny='S'`` (``select=``) in the port's extraction and API, mirroring
tests/test_select.py: the mask is positional over the ncv Ritz values of
the final factorization in their exit order (``IRAMResult.ritz``), only
converged entries yield vectors, and in real arithmetic a conjugate
partner is brought along.  Each case also runs the reference package's
extraction on its own solve of the same input and start vector.

Tolerances: in float64 the selected values equal the reference's within
1e-10 relative and the flagged exit-order Ritz values within 1e-8 (the
reference test's gate); residuals (``conftest.residual``) below 1e-8,
1e-6 when every Ritz value is flagged and below 1e-7 for the conjugate
pair, as in the reference tests."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import arpack_ng_tpu as at  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu.config import IRAMConfig as JConfig  # noqa: E402
from arpack_ng_tpu.core.extract import extract as jextract  # noqa: E402
from arpack_ng_tpu.core.iram import IRAMSolver as JIRAMSolver  # noqa: E402
from arpack_ng_tpu.ops import operator as jop  # noqa: E402
from arpack_ng_tpu_torch.config import IRAMConfig  # noqa: E402
from arpack_ng_tpu_torch.core.extract import extract  # noqa: E402
from arpack_ng_tpu_torch.core.iram import IRAMSolver  # noqa: E402
from arpack_ng_tpu_torch.ops import operator as op_mod  # noqa: E402

from conftest import residual  # noqa: E402


def _sym_problem(n=120, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.linspace(1.0, n, n)) @ q.T
    return (a + a.T) / 2


def _solve_both(a, hermitian, **cfg_kw):
    """The hybrid driver of each package on the dense matrix ``a`` from the
    same start vector: ``(op, cfg, res)`` of the port, then the
    reference's."""
    v0 = np.random.default_rng(7).uniform(-1, 1, a.shape[0])
    op = op_mod.from_dense(a, hermitian=hermitian, device="cpu")
    opj = jop.from_dense(a, hermitian=hermitian)
    kw = dict(n=op.n, dtype=np.dtype(a.dtype), n_pad=op.n_pad,
              symmetric=hermitian, **cfg_kw)
    cfg, cfgj = IRAMConfig(**kw), JConfig(**kw)
    res = IRAMSolver(op, cfg).solve(v0=v0)
    resj = JIRAMSolver(opj, cfgj).solve(v0=v0)
    return (op, cfg, res), (opj, cfgj, resj)


def _extract_both(port, ref, select):
    out = extract(*port, rvec=True, howmny="S", select=select)
    outj = jextract(*ref, rvec=True, howmny="S", select=select)
    assert out.nconv == outj.nconv
    np.testing.assert_allclose(out.values, outj.values, rtol=1e-10)
    return out


class TestSelectSymmetric:
    def test_select_subset_of_converged(self):
        a = _sym_problem()
        port, ref = _solve_both(a, True, nev=6, ncv=20, which="LA",
                                tol=1e-10, max_iter=500)
        res = port[2]
        assert res.nconv >= 6
        # Ritz values #1 and #3 of the exit ordering
        select = np.zeros(20, bool)
        select[1] = select[3] = True
        out = _extract_both(port, ref, select)
        assert out.nconv == 2
        expect = np.sort(np.asarray(res.ritz)[[1, 3]])
        assert np.allclose(np.sort(out.values), expect, rtol=1e-8)
        assert residual(a, out.values, out.vectors).max() < 1e-8

    def test_select_unconverged_dropped(self):
        a = _sym_problem()
        port, ref = _solve_both(a, True, nev=4, ncv=12, which="LA",
                                tol=1e-10, max_iter=500)
        # everything flagged: only converged Ritz values come back
        out = _extract_both(port, ref, np.ones(12, bool))
        assert out.nconv <= 12
        assert residual(a, out.values, out.vectors).max() < 1e-6

    def test_select_requires_mask_and_length(self):
        a = _sym_problem(40)
        port, _ = _solve_both(a, True, nev=3, ncv=10, which="LA", tol=1e-8,
                              max_iter=300)
        with pytest.raises(ValueError, match="select"):
            extract(*port, howmny="S", select=None)
        with pytest.raises(ValueError, match="length ncv"):
            extract(*port, howmny="S", select=np.ones(3, bool))

    @pytest.mark.parametrize("strategy", ["auto", "hybrid"])
    def test_api_level_select(self, strategy):
        a = _sym_problem()
        select = np.array([True] * 2 + [False] * 18)
        kw = dict(k=6, which="LA", ncv=20, tol=1e-10, strategy=strategy,
                  v0=np.random.default_rng(1).uniform(-1, 1, 120),
                  select=select)
        vals, vecs = pt.eigsh(a, device="cpu", **kw)
        vj, _ = at.eigsh(a, **kw)
        assert len(vals) <= 2 and len(vals) == len(vj)
        np.testing.assert_allclose(vals, vj, rtol=1e-10)
        assert residual(a, vals, vecs).max() < 1e-8

    def test_no_convergence_error_with_select(self):
        # with select=, a solve that stops at maxiter returns what
        # converged instead of raising (reference api.py:479)
        a = _sym_problem()
        kw = dict(k=6, which="LA", ncv=12, tol=1e-14, maxiter=2,
                  device="cpu")
        with pytest.raises(pt.ArpackNoConvergence):
            pt.eigsh(a, **kw)
        vals, vecs = pt.eigsh(a, select=np.ones(12, bool), **kw)
        assert len(vals) < 6
        assert vecs is None or residual(a, vals, vecs).max() < 1e-6


class TestSelectNonsym:
    def test_conjugate_pair_completion(self):
        # a real matrix with a complex spectrum: selecting one member of a
        # pair brings its partner (real packed storage needs both)
        rng = np.random.default_rng(5)
        n = 80
        a = rng.standard_normal((n, n)) * 0.3 + np.diag(np.arange(1.0, n + 1))
        a[1, 0] += 8.0
        a[0, 1] -= 8.0          # a strong rotation block: a complex pair
        port, ref = _solve_both(a, False, nev=6, ncv=24, which="LI",
                                tol=1e-10, max_iter=800)
        ritz = np.asarray(port[2].ritz)
        cplx = [j for j in range(len(ritz)) if ritz[j].imag > 1e-8][:1]
        assert cplx, "no complex Ritz value converged"
        select = np.zeros(24, bool)
        select[cplx[0]] = True
        out = _extract_both(port, ref, select)
        assert out.nconv == 2           # the partner completed
        assert np.allclose(np.sort(out.values.imag),
                           np.sort([-out.values[0].imag,
                                    out.values[0].imag]))
        assert residual(a, out.values, out.vectors).max() < 1e-7

    @pytest.mark.parametrize("strategy", ["fused_real", "hybrid", "fused"])
    def test_api_level_select_eigs(self, strategy):
        # eigs(select=) on every driver: the flagged converged values (and
        # in real arithmetic their partners), the reference's, with their
        # vectors.  The complexified real problem ('fused') computes each
        # member of a conjugate pair apart, so the exit order of the two,
        # tied on 'LR' but for rounding, may differ from the reference's:
        # there the values are compared up to conjugation
        rng = np.random.default_rng(3)
        n = 90
        a = rng.standard_normal((n, n)) / np.sqrt(n) \
            + np.diag(np.linspace(1.0, 3.0, n))
        select = np.zeros(20, bool)
        select[[0, 2]] = True
        kw = dict(k=5, which="LR", ncv=20, tol=1e-10, maxiter=500,
                  strategy=strategy, select=select,
                  v0=rng.uniform(-1, 1, n))
        vals, vecs = pt.eigs(a, device="cpu", **kw)
        vj, _ = at.eigs(a, **kw)
        assert 1 <= len(vals) <= 4 and len(vals) == len(vj)
        if strategy == "fused":
            vals_c, vj_c = vals.real + 1j * np.abs(vals.imag), \
                vj.real + 1j * np.abs(vj.imag)
            np.testing.assert_allclose(vals_c, vj_c, rtol=1e-10)
        else:
            np.testing.assert_allclose(vals, vj, rtol=1e-10)
        assert residual(a, vals, vecs).max() < 1e-8
