"""Spectral-transform modes of ``arpack_ng_tpu_torch`` against
``arpack_ng_tpu`` (every class of tests/test_modes.py): shift-invert,
generalized, buckling and Cayley (dsdrv2-6), non-symmetric real and
complex shifts (dndrv2-6), complex shift-invert and generalized problems
(zndrv2-4), and the matrix-free CG / BiCGSTAB solves.

The same numpy inputs and start vector go through both packages; each
test runs the port's drivers 'auto' and 'hybrid' (and ``eigs`` also
'fused') beside the reference's same strategy.  Values agree within
1e-9*max(1, |lambda|), each port residual (``conftest.residual``) meets
the reference test's bound, and in float64 the restart count and the
operator count (``n_iter``, ``nopx``) are equal: every spectrum here is
simple."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import scipy.sparse as sp  # noqa: E402

import arpack_ng_tpu as at  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.ops import solvers as jsolvers  # noqa: E402
from arpack_ng_tpu.ops import transforms as jtransforms  # noqa: E402
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402
from arpack_ng_tpu_torch.ops import solvers as psolvers  # noqa: E402
from arpack_ng_tpu_torch.ops import transforms as ptransforms  # noqa: E402

from conftest import residual  # noqa: E402

SYM = ["auto", "hybrid"]
NONSYM = ["auto", "hybrid", "fused"]


def _lap1d(n):
    return sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                    [-1, 0, 1], format="csr").astype(np.float64)


def _mass1d(n):
    """Tridiagonal mass matrix (1,4,1)/6 (the dsdrv3 M)."""
    return (sp.diags([np.ones(n - 1), 4 * np.ones(n), np.ones(n - 1)],
                     [-1, 0, 1], format="csr") / 6.0).astype(np.float64)


def _v0(n, cplx=False):
    rng = np.random.default_rng(0)
    v = rng.uniform(-1, 1, n)
    return v + 1j * rng.uniform(-1, 1, n) if cplx else v


def _both(fn, A, jA=None, **kw):
    """The reference's and the port's solve of the same problem:
    ``((vals, vecs, out), (vals, vecs, out))``."""
    jfn, pfn = getattr(at, fn), getattr(pt, fn)
    ref = jfn(A if jA is None else jA, return_stats=True, **kw)
    dev = {} if isinstance(A, pt.Operator) else dict(device="cpu")
    got = pfn(A, return_stats=True, **kw, **dev)
    return ref, got


def _agree(ref, got, counters=True):
    (vj, _, oj), (vp, _, op_) = ref, got
    assert vp.shape == vj.shape
    for v in vp:   # nearest reference value, each within 1e-9*max(1,|v|)
        assert np.min(np.abs(vj - v)) <= 1e-9 * max(1.0, abs(v)), (vp, vj)
    for v in vj:
        assert np.min(np.abs(vp - v)) <= 1e-9 * max(1.0, abs(v)), (vp, vj)
    if counters:
        assert (op_.n_iter, op_.stats.nopx) == (oj.n_iter, oj.stats.nopx)


class TestSymShiftInvert:
    """dsdrv2: standard shift-invert, eigenvalues closest to sigma."""

    @pytest.mark.parametrize("strategy", SYM)
    def test_mode3_standard(self, strategy):
        n = 200
        a = _lap1d(n)
        ref, got = _both("eigsh", a.toarray(), k=4, sigma=1.013,
                         which="LM", tol=1e-10, maxiter=300, v0=_v0(n),
                         strategy=strategy)
        _agree(ref, got)
        assert residual(a, got[0], got[1]).max() < 1e-8

    @pytest.mark.parametrize("strategy", SYM)
    def test_mode3_smallest_via_shift(self, strategy):
        n = 300
        a = _lap1d(n)
        ref, got = _both("eigsh", a.toarray(), k=5, sigma=0.0, which="LM",
                         tol=1e-10, v0=_v0(n), strategy=strategy)
        _agree(ref, got)
        exact = 2.0 - 2.0 * np.cos(np.pi * np.arange(1, 6) / (n + 1))
        np.testing.assert_allclose(np.sort(got[0]), exact, rtol=1e-8)
        assert residual(a, got[0], got[1]).max() < 1e-8


class TestSymGeneralized:
    """dsdrv3 (mode 2), dsdrv4 (mode 3 generalized), dsdrv5 (buckling) and
    dsdrv6 (Cayley)."""

    @pytest.mark.parametrize("strategy", SYM)
    def test_mode2(self, strategy):
        n = 150
        a, m = _lap1d(n), _mass1d(n)
        ref, got = _both("eigsh", a.toarray(), k=4, M=m.toarray(),
                         which="LM", tol=1e-10, maxiter=600, v0=_v0(n),
                         strategy=strategy)
        _agree(ref, got)
        assert residual(a, got[0], got[1], m).max() < 1e-7

    @pytest.mark.parametrize("mode", ["normal", "buckling", "cayley"])
    @pytest.mark.parametrize("strategy", SYM)
    def test_shifted_modes(self, strategy, mode):
        # mode 3 at n = 150, k = 4; buckling and Cayley at n = 120, k = 3
        n, k, tol = (150, 4, 1e-10) if mode == "normal" else (120, 3, 1e-9)
        a, m = _lap1d(n), _mass1d(n)
        ref, got = _both("eigsh", a.toarray(), k=k, M=m.toarray(),
                         sigma=1.0, mode=mode, which="LM", tol=tol,
                         maxiter=600, v0=_v0(n), strategy=strategy)
        _agree(ref, got)
        assert got[2].info == 0
        assert residual(a, got[0], got[1], m).max() < \
            (1e-8 if mode == "normal" else 1e-6)


    def test_cayley_stiff_pencil(self):
        # dsdrv6's pencil K = tridiag(-1, 2, -1)/h, M = tridiag(1, 4, 1)h/6
        # at n = 2048, sigma between its two lowest values: the port applies
        # the Cayley operator as v + 2 sigma inv(K - sigma M) M v and meets
        # the closed form; the reference's inv(K - sigma M)(K v + sigma M v)
        # feeds the solve stiff components it returns with large errors,
        # and from this start vector its selective Lanczos returns values
        # off the spectrum
        n = 2048
        h = 1.0 / (n + 1)
        k = (_lap1d(n) / h).toarray()
        m = (_mass1d(n) * h).toarray()
        jj = np.arange(1, n + 1) * np.pi * h
        lam = np.sort(6 / h ** 2 * (1 - np.cos(jj)) / (2 + np.cos(jj)))
        v0 = np.random.default_rng(0).uniform(-1, 1, n)
        kw = dict(k=4, M=m, sigma=25.0, mode="cayley", which="LM",
                  tol=1e-10, v0=v0)
        vals, vecs = pt.eigsh(k, device="cpu", **kw)
        np.testing.assert_allclose(vals, lam[:4], rtol=1e-9)
        assert residual(k, vals, vecs, m).max() < 1e-8
        ref = at.eigsh(k, return_eigenvectors=False, **kw)
        assert np.max(np.abs(np.sort(ref) - lam[:4]) / lam[:4]) > 1e-3


class TestNonsymShiftInvert:
    """dndrv2 (real shift), dndrv5 (complex shift, real part, values by
    Rayleigh quotients) and dndrv6 (imaginary part, mode 4)."""

    @pytest.mark.parametrize("strategy", NONSYM)
    def test_mode3_real_shift(self, strategy):
        n = 150
        _, a = jmodels.convection_diffusion_1d(n, rho=10.0, dtype=np.float64)
        ref, got = _both("eigs", a.toarray(), k=4, sigma=1.0, which="LM",
                         tol=1e-10, v0=_v0(n), strategy=strategy)
        _agree(ref, got)
        assert residual(a, got[0], got[1]).max() < 1e-8

    @pytest.mark.parametrize("strategy", NONSYM)
    def test_mode3_complex_shift_real_problem(self, strategy):
        n = 150
        _, a = jmodels.convection_diffusion_1d(n, rho=10.0, dtype=np.float64)
        ref, got = _both("eigs", a.toarray(), k=4, sigma=1.0 + 0.05j,
                         which="LM", tol=1e-10, v0=_v0(n),
                         strategy=strategy)
        _agree(ref, got)
        assert residual(a, got[0], got[1]).max() < 1e-8

    @pytest.mark.parametrize("strategy", NONSYM)
    def test_mode4_imag_part(self, strategy):
        n = 150
        _, a = jmodels.convection_diffusion_1d(n, rho=10.0, dtype=np.float64)
        eye = np.eye(n)
        kw = dict(M=eye, sigma=1.0 + 0.05j, part="imag")
        opj = jtransforms.build_nonsym_operator(a.toarray(), **kw)
        opp = ptransforms.build_nonsym_operator(a.toarray(), device="cpu",
                                                **kw)
        assert (opp.mode, opp.bmat, opp.sigma) == (4, "G", 1.0 + 0.05j)
        ref, got = _both("eigs", opp, jA=opj, k=4, which="LM", tol=1e-10,
                         v0=_v0(n), strategy=strategy)
        _agree(ref, got)
        assert residual(a, got[0], got[1]).max() < 1e-8


class TestComplexShiftInvert:
    """zndrv2: complex shift-invert."""

    @pytest.mark.parametrize("strategy", NONSYM)
    def test_mode3_complex(self, rng, strategy):
        n = 120
        a = ((rng.standard_normal((n, n))
              + 1j * rng.standard_normal((n, n))) / np.sqrt(n)
             ).astype(np.complex128)
        sigma = 0.3 + 0.2j
        ref, got = _both("eigs", a, k=4, sigma=sigma, which="LM", tol=1e-10,
                         v0=_v0(n, True), strategy=strategy)
        _agree(ref, got)
        w = np.linalg.eigvals(a)
        close = w[np.argsort(np.abs(w - sigma))][:4]
        np.testing.assert_allclose(np.sort(np.abs(got[0] - sigma)),
                                   np.sort(np.abs(close - sigma)), rtol=1e-7)
        assert residual(a, got[0], got[1]).max() < 1e-8


class TestIterativeSolve:
    """Matrix-free shift-invert through the CG and BiCGSTAB solves (the
    arpackmm ``--slv CG|BiCG`` path): operators that read the device every
    iteration, not capturable, the same counters through the device loop
    ('auto') and the host loop ('hybrid') as the reference's."""

    @pytest.mark.parametrize("precond", [None, "ilu"])
    @pytest.mark.parametrize("strategy", SYM)
    def test_cg_shift_invert(self, strategy, precond):
        n = 200
        opj, a = jmodels.laplacian_1d(n, dtype=np.float64)
        opp, _ = pmodels.laplacian_1d(n, dtype=np.float64, device="cpu")
        pcj = pcp = None
        if precond:
            pcj = jsolvers.ilu0_preconditioner(a, symmetric=True)
            pcp = psolvers.ilu0_preconditioner(a, symmetric=True,
                                               device="cpu")
        ops = []
        for op, solvers, tr, pc in ((opj, jsolvers, jtransforms, pcj),
                                    (opp, psolvers, ptransforms, pcp)):
            solve = solvers.make_iterative_solve(
                op.a_apply, symmetric=True, tol=1e-12, maxiter=2000,
                precond=pc)
            dev = {} if tr is jtransforms else dict(device="cpu")
            ops.append(tr.shift_invert_operator(
                n, np.float64, solve, sigma=0.0, mode=3, n_pad=op.n_pad,
                hermitian=True, a_apply=op.a_apply, **dev))
        assert not ops[1].capturable
        ref, got = _both("eigsh", ops[1], jA=ops[0], k=3, which="LM",
                         tol=1e-9, maxiter=300, v0=_v0(n),
                         strategy=strategy)
        _agree(ref, got)
        exact = 2.0 - 2.0 * np.cos(np.pi * np.arange(1, 4) / (n + 1))
        np.testing.assert_allclose(np.sort(got[0]), exact, rtol=1e-7)
        assert residual(a, got[0], got[1]).max() < 1e-7

    @pytest.mark.parametrize("strategy", NONSYM)
    def test_bicgstab_nonsym(self, strategy):
        n = 150
        opj, a = jmodels.convection_diffusion_1d(n, rho=10.0,
                                                 dtype=np.float64)
        opp, _ = pmodels.convection_diffusion_1d(n, rho=10.0,
                                                 dtype=np.float64,
                                                 device="cpu")
        sigma = 0.5
        ops = []
        for op, solvers, tr in ((opj, jsolvers, jtransforms),
                                (opp, psolvers, ptransforms)):
            def shifted(v, op=op):
                return op.a_apply(v) - sigma * v

            solve = solvers.make_iterative_solve(
                shifted, symmetric=False, tol=1e-12, maxiter=4000)
            dev = {} if tr is jtransforms else dict(device="cpu")
            ops.append(tr.shift_invert_operator(
                n, np.float64, solve, sigma=sigma, mode=3, n_pad=op.n_pad,
                a_apply=op.a_apply, **dev))
        ref, got = _both("eigs", ops[1], jA=ops[0], k=3, which="LM",
                         tol=1e-8, maxiter=300, v0=_v0(n),
                         strategy=strategy)
        # the inner solves stop at 1e-12 of ||b||: values to 1e-9, but
        # their rounding may move a counter
        _agree(ref, got, counters=False)
        assert residual(a, got[0], got[1]).max() < 1e-6


class TestComplexGeneralized:
    """zndrv3/zndrv4-class: complex mode 2 and complex shift-invert with a
    mass matrix."""

    @staticmethod
    def _pencil(rng, n=100):
        a = ((rng.standard_normal((n, n))
              + 1j * rng.standard_normal((n, n))) / np.sqrt(n)
             ).astype(np.complex128)
        m = (np.eye(n) + 0.1 * sp.diags(
            [np.ones(n - 1), np.ones(n - 1)], [-1, 1]).toarray()
        ).astype(np.complex128)
        return a, m

    @pytest.mark.parametrize("strategy", ["hybrid", "fused"])
    def test_complex_gen_mode2(self, rng, strategy):
        a, m = self._pencil(rng)
        ref, got = _both("eigs", a, k=4, M=m, which="LM", tol=1e-10,
                         maxiter=800, v0=_v0(100, True), strategy=strategy)
        _agree(ref, got)
        assert residual(a, got[0], got[1], m).max() < 1e-7

    @pytest.mark.parametrize("strategy", ["hybrid", "fused"])
    def test_complex_gen_shift_invert(self, rng, strategy):
        a, m = self._pencil(rng)
        sigma = 0.2 - 0.1j
        ref, got = _both("eigs", a, k=3, M=m, sigma=sigma, which="LM",
                         tol=1e-10, v0=_v0(100, True), strategy=strategy)
        _agree(ref, got)
        assert residual(a, got[0], got[1], m).max() < 1e-7
        import scipy.linalg
        w = scipy.linalg.eig(a, m, right=False)
        closest = w[np.argmin(np.abs(w - sigma))]
        assert np.min(np.abs(got[0] - closest)) < 1e-7


class TestOperators:
    """The transformed operators' fields: the shift, the mode, B, and
    ``capturable`` (the package's own products are, a caller's solve is
    not unless it says so); the shift survives complexification."""

    def test_builders_capturable_and_shift(self):
        from arpack_ng_tpu_torch.core.device_nonsym import \
            complexify_operator
        a, m = _lap1d(40).toarray(), _mass1d(40).toarray()
        for mode, num in (("normal", 3), ("buckling", 4), ("cayley", 5)):
            op = ptransforms.build_sym_operator(a, M=m, sigma=0.5, mode=mode,
                                                device="cpu")
            assert (op.mode, op.bmat, op.sigma, op.capturable) == \
                (num, "G", 0.5, True)
        op = ptransforms.build_nonsym_operator(a, sigma=0.5 + 0.1j,
                                               device="cpu")
        assert (op.mode, op.bmat, op.capturable) == (3, "I", True)
        assert complexify_operator(op).sigma == 0.5 + 0.1j
        assert pt.from_dense(a, device="cpu").sigma == 0.0

    def test_caller_solve_not_capturable(self):
        a = torch.from_numpy(_lap1d(40).toarray())
        kw = dict(sigma=0.0, n_pad=40, device="cpu")
        op = ptransforms.shift_invert_operator(
            40, np.float64, lambda b: torch.linalg.solve(a, b), **kw)
        assert not op.capturable
        op = ptransforms.shift_invert_operator(
            40, np.float64, lambda b: torch.linalg.solve(a, b),
            capturable=True, **kw)
        assert op.capturable

    @pytest.mark.parametrize("kw,match", [
        (dict(mode=4), "buckling"), (dict(mode=5), "Cayley"),
        (dict(mode=6), "bad transform mode")])
    def test_mode_arguments_refused(self, kw, match):
        for tr in (jtransforms, ptransforms):
            dev = {} if tr is jtransforms else dict(device="cpu")
            with pytest.raises(ValueError, match=match):
                tr.shift_invert_operator(8, np.float64, lambda b: b,
                                         sigma=1.0, **kw, **dev)

    def test_operator_input_with_shift_refused(self):
        opj, _ = jmodels.laplacian_1d(40, dtype=np.float64)
        opp, _ = pmodels.laplacian_1d(40, dtype=np.float64, device="cpu")
        for fn, op in ((at.eigsh, opj), (pt.eigsh, opp), (at.eigs, opj),
                       (pt.eigs, opp)):
            with pytest.raises(ValueError, match="spectral transforms"):
                fn(op, k=2, sigma=0.5)
