"""The port's hybrid driver (``arpack_ng_tpu_torch.core.iram.IRAMSolver``,
``strategy='hybrid'``) against the reference package's ``IRAMSolver`` on
the same numpy inputs and start vector, and against the port's own fused
drivers.

Tolerances: in float64 the counters (restart cycles, nopx, nrorth) are
equal and the values agree to 1e-10 relative: both reduced spaces run the
same float64 numpy code, only the summation order of the O(n) work
differs.  Float32 and bfloat16-storage cases pass the reference tests'
value gates (1e-4 absolute; 3 eps(bfloat16) relative) and the residual
oracle (``conftest.residual``) at 100*tol."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import arpack_ng_tpu as at  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.config import IRAMConfig as JConfig  # noqa: E402
from arpack_ng_tpu.core.iram import IRAMSolver as JIRAMSolver  # noqa: E402
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402
from arpack_ng_tpu_torch.config import IRAMConfig as PConfig  # noqa: E402
from arpack_ng_tpu_torch.core.iram import IRAMSolver  # noqa: E402

from conftest import residual  # noqa: E402

def _counters(out):
    return (out.n_iter, out.stats.nopx, out.stats.nrorth)


def _v0(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, n)


def _banded_nonsym(n=600):
    """tests/test_fused_realnonsym.py: random-diagonal non-symmetric
    band, well-separated extremes."""
    rng = np.random.default_rng(0)
    return (sp.diags(2.0 + rng.standard_normal(n))
            + sp.diags(-1.5 * np.ones(n - 1), 1)
            + sp.diags(-0.5 * np.ones(n - 1), -1)).tocsr()


def _rotation_blocks(nb=150):
    """tests/test_fused_realnonsym.py: 2x2 rotation blocks, spectrum
    a_i +- i b_i with spread imaginary parts."""
    rng = np.random.default_rng(1)
    blocks = []
    for i in range(nb):
        a = rng.standard_normal() * 0.3
        b = (i + 1) / nb * 3.0 + 0.1 * rng.standard_normal()
        blocks.append(np.array([[a, b], [-b, a]]))
    return sp.block_diag(blocks).tocsr()


@pytest.mark.parametrize("reorth", ["selective", "dgks"])
@pytest.mark.parametrize("which", ["LA", "SA", "LM", "BE"])
def test_eigsh_hybrid_matches_reference(which, reorth):
    # the dssimp problem (2-D Laplacian, nx = 16) in float64
    opj, a = jmodels.laplacian_2d(16, dtype=np.float64)
    opp, _ = pmodels.laplacian_2d(16, dtype=np.float64, device="cpu")
    kw = dict(k=4, which=which, ncv=20, tol=1e-10, v0=_v0(opj.n),
              maxiter=500, strategy="hybrid", reorth=reorth,
              return_stats=True)
    vj, _, oj = at.eigsh(opj, **kw)
    vp, xp, op_ = pt.eigsh(opp, **kw)
    np.testing.assert_allclose(vp, vj, rtol=1e-10)
    assert _counters(op_) == _counters(oj)
    assert residual(a, vp, xp).max() < 1e-8


@pytest.mark.parametrize("which", ["LM", "SR", "LR", "LI"])
def test_eigs_hybrid_matches_reference(which):
    # real non-symmetric, float64, dense (n <= 2048): LM/SR/LR on the
    # random-diagonal band, LI on the rotation blocks
    a = _rotation_blocks() if which == "LI" else _banded_nonsym()
    kw = dict(k=4, which=which, ncv=20, tol=1e-10, v0=_v0(a.shape[0]),
              maxiter=500, strategy="hybrid", return_stats=True)
    vj, _, oj = at.eigs(a.toarray(), **kw)
    vp, xp, op_ = pt.eigs(a.toarray(), device="cpu", **kw)
    np.testing.assert_allclose(vp, vj, rtol=1e-10)
    assert _counters(op_) == _counters(oj)
    assert residual(a, vp, xp).max() < 1e-8


def test_eigs_hybrid_stencil_matches_reference():
    # the dnsimp model (convection-diffusion, nx = 10) through operators
    opj, a = jmodels.convection_diffusion_2d(10, dtype=np.float64)
    opp, _ = pmodels.convection_diffusion_2d(10, dtype=np.float64,
                                             device="cpu")
    kw = dict(k=4, which="LM", ncv=20, tol=1e-10, v0=_v0(opj.n),
              maxiter=500, strategy="hybrid", return_stats=True)
    vj, _, oj = at.eigs(opj, **kw)
    vp, xp, op_ = pt.eigs(opp, **kw)
    np.testing.assert_allclose(vp, vj, rtol=1e-10)
    assert _counters(op_) == _counters(oj)
    assert residual(a, vp, xp).max() < 1e-8


@pytest.mark.parametrize("which", ["LA", "SA", "LM", "SM"])
def test_fused_matches_hybrid(which):
    # tests/test_fused.py::test_fused_matches_hybrid on the port: the
    # device loop and the hybrid driver agree to 1e-9 relative
    n = 200
    rng = np.random.default_rng(3)
    d = np.sort(rng.uniform(0.5, 80.0, n))
    op = pt.from_diagonal(d, n_pad=pt.pad_dim(n), device="cpu")
    kw = dict(k=4, which=which, ncv=16, tol=1e-10, maxiter=600,
              v0=rng.standard_normal(n), return_eigenvectors=False)
    vf = pt.eigsh(op, strategy="fused", **kw)
    vh = pt.eigsh(op, strategy="hybrid", **kw)
    np.testing.assert_allclose(np.sort(vf), np.sort(vh), rtol=1e-9)


def test_counters_parity_fused_vs_hybrid():
    # tests/test_regression.py::test_counters_parity_fused_vs_hybrid: the
    # same trajectory through both drivers, equal nopx and cycles
    n = 150
    op = pt.from_diagonal(np.linspace(1, 40, n), n_pad=pt.pad_dim(n),
                          device="cpu")
    kw = dict(k=3, which="LA", ncv=12, tol=1e-10, maxiter=400,
              v0=np.ones(n), return_stats=True, return_eigenvectors=False)
    _, s_f = pt.eigsh(op, strategy="fused", **kw)
    _, s_h = pt.eigsh(op, strategy="hybrid", **kw)
    assert s_f.stats.nopx == s_h.stats.nopx
    assert s_f.stats.n_iter == s_h.stats.n_iter


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_hybrid_narrow_storage(storage):
    # tests/test_mixed_precision.py::test_hybrid_strategy_mixed: float32
    # storage under float64 compute (values within 1e-4), and bfloat16
    # storage under float32 compute at tol 5e-3 (within 3 eps(bfloat16) of
    # the largest value), each beside the reference
    n = 400
    d = np.linspace(1.0, 100.0, n)
    if storage == "float32":
        dj, sj, sp_, tol, k = d, jnp.float32, torch.float32, 1e-5, 3
    else:
        dj, sj, sp_, tol, k = (d.astype(np.float32), jnp.bfloat16,
                               torch.bfloat16, 5e-3, 4)
    kw = dict(k=k, which="LA", tol=tol, maxiter=500, strategy="hybrid",
              return_eigenvectors=False, v0=_v0(n))
    vj = at.eigsh(at.from_diagonal(dj, n_pad=512), storage_dtype=sj, **kw)
    vp = pt.eigsh(pt.from_diagonal(dj, n_pad=512, device="cpu"),
                  storage_dtype=sp_, **kw)
    want = np.sort(d)[-k:]
    if storage == "float32":
        assert np.abs(np.sort(vp) - want).max() < 1e-4
        assert np.abs(np.sort(vj) - want).max() < 1e-4
    else:
        eps = float(torch.finfo(torch.bfloat16).eps)
        assert np.abs(np.sort(vp) - want).max() / d.max() < 3 * eps
        assert np.abs(np.sort(vj) - want).max() / d.max() < 3 * eps


@pytest.mark.parametrize("solver", ["eigsh", "eigs"])
def test_hybrid_float32_residuals(solver):
    # float32 through the hybrid driver: the residual oracle at 100*tol,
    # and the reference's values within 10*tol*|lambda|
    tol = 1e-5
    if solver == "eigsh":
        # 1-D: the 2-D Laplacian's degenerate pairs come back once or twice
        opj, a = jmodels.laplacian_1d(200, dtype=np.float32)
        opp, _ = pmodels.laplacian_1d(200, dtype=np.float32, device="cpu")
        kw = dict(which="LA")
    else:
        opj, a = jmodels.convection_diffusion_2d(12, dtype=np.float32)
        opp, _ = pmodels.convection_diffusion_2d(12, dtype=np.float32,
                                                 device="cpu")
        kw = dict(which="LM")
    fn_j, fn_p = getattr(at, solver), getattr(pt, solver)
    kw.update(k=4, ncv=20, tol=tol, maxiter=500, v0=_v0(opj.n),
              strategy="hybrid")
    vj, _ = fn_j(opj, **kw)
    vp, xp = fn_p(opp, **kw)
    assert residual(a, vp, xp).max() < 100 * tol
    key = np.argsort(np.abs(vj))
    np.testing.assert_allclose(vp[np.argsort(np.abs(vp))], vj[key],
                               rtol=10 * tol, atol=10 * tol)


def test_iterate_cycle_by_cycle_matches_reference():
    # the reference's IRAMSolver.iterate and the port's, cycle by cycle,
    # from the same start vector: the same exit cycle and counters, the
    # same residual norms (1e-10 relative) until then
    opj, _ = jmodels.convection_diffusion_2d(10, dtype=np.float64)
    opp, _ = pmodels.convection_diffusion_2d(10, dtype=np.float64,
                                             device="cpu")
    kw = dict(n=opj.n, nev=4, ncv=20, which="LM", symmetric=False,
              dtype=np.dtype(np.float64), n_pad=opj.n_pad, tol=1e-10,
              max_iter=500)
    from arpack_ng_tpu.utils.stats import Timers
    sj, sp_ = JIRAMSolver(opj, JConfig(**kw)), IRAMSolver(opp, PConfig(**kw))
    v0 = _v0(opj.n)
    stj, stp = sj.init_state(v0=v0), sp_.init_state(v0=v0)
    timers = Timers()
    for _ in range(500):
        stj, rj = sj.iterate(stj, timers)
        out = sp_.iterate(stp)
        stp = out.state
        assert out.done == (rj is not None)
        if rj is not None:
            break
        np.testing.assert_allclose(stp.rnorm, float(stj.rnorm), rtol=1e-10)
        assert stp.counts.nopx == int(stj.counts.nopx)
    # the exit state holds the cycles before the exit cycle, as the
    # reference's does
    assert (out.nconv, out.info, stp.iter) == (rj.nconv, rj.info,
                                               int(stj.iter))
    assert stp.iter + 1 == rj.n_iter
    np.testing.assert_allclose(out.ritz[:4], rj.ritz[:4], rtol=1e-10)


def test_hybrid_max_iter_raises_with_partial_results():
    op, _ = pmodels.laplacian_2d(16, dtype=np.float64, device="cpu")
    with pytest.raises(pt.ArpackNoConvergence) as ei:
        pt.eigsh(op, k=4, which="LA", ncv=9, tol=1e-14, maxiter=2,
                 strategy="hybrid")
    assert ei.value.info == 1


def test_hybrid_refuses_thick_restart():
    # the reference's hybrid driver never reads cfg.restart and silently
    # runs the implicit restart (arpack_ng_tpu/api.py:132); the port
    # refuses, through the API and the solver alike
    op, _ = pmodels.laplacian_1d(64, dtype=np.float64, device="cpu")
    with pytest.raises(ValueError, match="implicit"):
        pt.eigsh(op, k=2, which="LA", strategy="hybrid", restart="thick")
    cfg = PConfig(n=op.n, nev=2, ncv=10, which="LA", symmetric=True,
                  dtype=np.dtype(np.float64), n_pad=op.n_pad,
                  restart="thick")
    with pytest.raises(ValueError, match="implicit"):
        IRAMSolver(op, cfg)


def test_hybrid_cgs_kernel_pallas_matches_reference():
    # eigs through the hybrid driver with the CGS kernels' twins (float32,
    # the reference's Pallas kernels in interpret mode): residuals at
    # 100*tol, values within 10*tol*|lambda|
    tol = 1e-5
    opj, a = jmodels.convection_diffusion_2d(8, dtype=np.float32)
    opp, _ = pmodels.convection_diffusion_2d(8, dtype=np.float32,
                                             device="cpu")
    kw = dict(k=3, which="LM", ncv=16, tol=tol, maxiter=300, v0=_v0(opj.n),
              strategy="hybrid", cgs_kernel="pallas")
    vj, _ = at.eigs(opj, **kw)
    vp, xp = pt.eigs(opp, **kw)
    assert residual(a, vp, xp).max() < 100 * tol
    np.testing.assert_allclose(np.sort(np.abs(vp)), np.sort(np.abs(vj)),
                               rtol=10 * tol)
