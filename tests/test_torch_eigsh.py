"""``arpack_ng_tpu_torch.eigsh`` against ``arpack_ng_tpu.eigsh`` with the
same start vector, and against the independent residual oracle
(``conftest.residual``, the bound tests/test_reorth.py uses: 100*tol).

Values agree within 10*tol*max(1, |lambda|); in float64 the matvec count
and the number of restart cycles are equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import arpack_ng_tpu as at  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402
from arpack_ng_tpu_torch.utils.stats import SolverStats  # noqa: E402

from conftest import residual  # noqa: E402

TOL = {np.float64: 1e-10, np.float32: 1e-5}


def _problem(name, dtype):
    if name == "lap2d":
        opj, a = jmodels.laplacian_2d(16, dtype=dtype)
        opp, _ = pmodels.laplacian_2d(16, dtype=dtype, device="cpu")
    else:
        opj, a = jmodels.laplacian_1d(200, dtype=dtype)
        opp, _ = pmodels.laplacian_1d(200, dtype=dtype, device="cpu")
    return opj, opp, a


@pytest.mark.parametrize("which", ["LA", "SA", "BE"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["lap2d", "lap1d"])
def test_eigsh_matches_reference(name, dtype, which):
    opj, opp, a = _problem(name, dtype)
    tol = TOL[dtype]
    v0 = np.random.default_rng(0).uniform(-1, 1, opj.n)
    kw = dict(k=4, which=which, ncv=20, tol=tol, v0=v0, maxiter=500,
              return_stats=True)
    vj, _, oj = at.eigsh(opj, **kw)
    vp, xp, op_ = pt.eigsh(opp, **kw)
    assert vp.shape == vj.shape == (4,)
    np.testing.assert_allclose(
        np.sort(vp), np.sort(vj), rtol=0,
        atol=10 * tol * max(1.0, float(np.max(np.abs(vj)))))
    assert residual(a, vp, xp).max() < 100 * tol
    if dtype == np.float64:
        assert op_.stats.nopx == oj.stats.nopx
        assert op_.n_iter == oj.n_iter


@pytest.mark.parametrize("which", ["LA", "LM"])
@pytest.mark.parametrize("reorth", ["selective", "dgks"])
def test_dense_input_matches_numpy(reorth, which):
    a = np.random.default_rng(42).standard_normal((120, 120))
    a = (a + a.T) / 2
    vals, vecs = pt.eigsh(a, k=5, which=which, tol=1e-10, reorth=reorth,
                          device="cpu")
    ev = np.linalg.eigvalsh(a)
    ref = np.sort(ev[np.argsort(ev if which == "LA" else np.abs(ev))[-5:]])
    np.testing.assert_allclose(vals, ref, rtol=1e-9, atol=1e-9)
    assert residual(a, vals, vecs).max() < 1e-8


@pytest.mark.parametrize("reorth", ["selective", "dgks"])
def test_generalized_mode2_matches_reference(reorth):
    # bmat='G' (OP = inv(M) A): B-inner products, B-norms and nbx counts
    n = 150
    a = (np.diag(2 * np.ones(n)) - np.diag(np.ones(n - 1), 1)
         - np.diag(np.ones(n - 1), -1))
    m = (np.diag(4 * np.ones(n)) + np.diag(np.ones(n - 1), 1)
         + np.diag(np.ones(n - 1), -1)) / 6.0
    v0 = np.random.default_rng(1).uniform(-1, 1, n)
    kw = dict(k=4, which="LM", tol=1e-10, v0=v0, maxiter=600,
              reorth=reorth, return_stats=True)
    vj, _, oj = at.eigsh(at.from_dense(a, m, n_pad=at.pad_dim(n)), **kw)
    vp, xp, op_ = pt.eigsh(
        pt.from_dense(a, m, n_pad=pt.pad_dim(n), device="cpu"), **kw)
    np.testing.assert_allclose(np.sort(vp), np.sort(vj), rtol=1e-9)
    assert residual(a, vp, xp, m).max() < 1e-7
    assert (op_.stats.nopx, op_.stats.nbx) == (oj.stats.nopx, oj.stats.nbx)


@pytest.mark.parametrize("reorth", ["selective", "dgks"])
def test_single_bucket_ncv_matches_reference(reorth):
    # ncv <= 8: every CGS pass, event and rotation is one bucket of ncv rows
    opj, a = jmodels.laplacian_1d(200, dtype=np.float64)
    opp, _ = pmodels.laplacian_1d(200, dtype=np.float64, device="cpu")
    kw = dict(k=3, which="LA", ncv=8, tol=1e-8, maxiter=3000, reorth=reorth,
              v0=np.random.default_rng(0).uniform(-1, 1, 200),
              return_stats=True)
    vj, _, oj = at.eigsh(opj, **kw)
    vp, xp, op_ = pt.eigsh(opp, **kw)
    np.testing.assert_allclose(vp, vj, rtol=1e-12)
    assert residual(a, vp, xp).max() < 1e-6
    assert (op_.stats.nopx, op_.n_iter) == (oj.stats.nopx, oj.n_iter)


@pytest.mark.parametrize("reorth", ["selective", "dgks"])
def test_invariant_subspace_restart(reorth):
    # an eigenvector as v0 makes the first residual exactly zero: both
    # packages draw one restart vector (from their own generators, so the
    # later counts may differ) and still converge to the same values
    d = np.linspace(1.0, 10.0, 60)
    v0 = np.zeros(60)
    v0[0] = 1.0
    kw = dict(k=2, which="LA", ncv=10, tol=1e-10, v0=v0, reorth=reorth,
              maxiter=300, return_stats=True)
    vj, _, oj = at.eigsh(at.from_diagonal(d, n_pad=at.pad_dim(60)), **kw)
    vp, xp, op_ = pt.eigsh(
        pt.from_diagonal(d, n_pad=pt.pad_dim(60), device="cpu"), **kw)
    np.testing.assert_allclose(vp, d[-2:], rtol=1e-10)
    np.testing.assert_allclose(vp, vj, rtol=1e-10)
    assert op_.stats.nrstrt == oj.stats.nrstrt == 1
    assert residual(np.diag(d), vp, xp).max() < 1e-8


def test_stats_summary_format():
    # mirrors tests/test_regression.py::test_stats_summary_format
    op, _ = pmodels.laplacian_2d(8, dtype=np.float64, device="cpu")
    vals, vecs, out = pt.eigsh(op, k=3, ncv=12, which="LA", tol=1e-8,
                               maxiter=300, return_stats=True)
    s = out.stats.summary()
    for key in ("OP*x operations", "reorthogonalization",
                "update iterations", "restart steps"):
        assert key in s
    assert out.stats.nopx > 0
    assert isinstance(out.stats, SolverStats)
    assert s.count("\n") == at.utils.stats.SolverStats().summary().count(
        "\n")


def test_no_convergence_raises_with_partial_results():
    op, _ = pmodels.laplacian_2d(16, dtype=np.float64, device="cpu")
    with pytest.raises(pt.ArpackNoConvergence) as ei:
        pt.eigsh(op, k=4, which="LA", ncv=9, tol=1e-14, maxiter=2)
    assert ei.value.info == 1


@pytest.mark.parametrize("solver", ["eigsh", "eigs", "sigma", "eigs_sigma",
                                    "svds"])
def test_solve_pins_full_precision_matmuls(solver):
    # every driver builds through make_init, which pins full-precision
    # float32 matmuls whatever the caller set, before the first product: the
    # spectral transforms' explicit inverse, svds's Gram products and the
    # products after the solve (purification, Rayleigh quotients, svds's
    # u = A v / s) run pinned too
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        if solver == "eigsh":
            op, _ = pmodels.laplacian_1d(64, dtype=np.float32, device="cpu")
            pt.eigsh(op, k=2, which="LA", tol=1e-4,
                     return_eigenvectors=False)
        elif solver == "sigma":
            a = np.diag(np.arange(1.0, 65.0, dtype=np.float32))
            pt.eigsh(a, M=np.eye(64, dtype=np.float32), sigma=0.5, k=2,
                     tol=1e-4, device="cpu")
        elif solver == "eigs_sigma":
            a = np.diag(np.arange(1.0, 65.0, dtype=np.float32))
            a[0, 1] = 0.5
            pt.eigs(a, sigma=0.5 + 0.1j, k=2, tol=1e-4, device="cpu")
        elif solver == "svds":
            a = np.random.default_rng(0).standard_normal((80, 40))
            pt.svds(a.astype(np.float32), k=2, tol=1e-4, device="cpu")
        else:
            op, _ = pmodels.convection_diffusion_1d(64, dtype=np.float32,
                                                    device="cpu")
            pt.eigs(op, k=2, tol=1e-4, return_eigenvectors=False)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.set_float32_matmul_precision("highest")


@pytest.mark.parametrize("kwargs", [
    dict(sigma=1.0), dict(mesh=object()), dict(shift_fn=lambda r, b: r),
    dict(restart="thick"), dict(validate="f64"),
    dict(strategy="hybrid", restart="thick"), dict(cgs_kernel="pallas")])
def test_outside_the_slice_raises(kwargs):
    # mesh is outside the slice (NotImplementedError); shift_fn and
    # restart='thick' are ported and solve to the reference's values from
    # the same start vector; ported options raise ValueError where the
    # reference does: sigma on an operator (the built-in transforms take
    # matrices; tests/test_torch_modes.py), cgs_kernel='pallas' on float64
    # (real float32 compute only) and validate='f64' on a matrix-free
    # operator (tests/test_torch_validate.py); the hybrid driver refuses
    # restart='thick', which the reference's silently runs as the implicit
    # restart (arpack_ng_tpu/api.py:132)
    op, _ = pmodels.laplacian_1d(64, dtype=np.float64, device="cpu")
    if "shift_fn" in kwargs or kwargs == dict(restart="thick"):
        opj, _ = jmodels.laplacian_1d(64, dtype=np.float64)
        kw = dict(k=2, which="LA", tol=1e-10, return_eigenvectors=False,
                  v0=np.random.default_rng(0).uniform(-1, 1, 64), **kwargs)
        np.testing.assert_allclose(pt.eigsh(op, **kw), at.eigsh(opj, **kw),
                                   rtol=1e-10)
        return
    ported = "cgs_kernel" in kwargs or "validate" in kwargs \
        or "sigma" in kwargs
    exc = ValueError if ported or "strategy" in kwargs \
        else NotImplementedError
    with pytest.raises(exc):
        pt.eigsh(op, k=2, which="LA", **kwargs)
    if ported:
        opj, _ = jmodels.laplacian_1d(64, dtype=np.float64)
        with pytest.raises(ValueError):
            at.eigsh(opj, k=2, which="LA", **kwargs)


def test_complex_and_sparse_inputs_raise():
    # complex inputs, sparse or dense, are ported (tests/test_torch_complex
    # .py): a Hermitian identity solves to real values; with the CGS
    # kernels (real float32 only) or narrow storage (real only) they raise
    # the reference's ValueError
    import scipy.sparse as sp
    for a in (sp.identity(50, format="csr", dtype=np.complex128),
              np.eye(50, dtype=np.complex128)):
        vals = pt.eigsh(a, k=2, which="LA", tol=1e-10,
                        return_eigenvectors=False, device="cpu")
        assert np.isrealobj(vals)
        np.testing.assert_allclose(vals, 1.0, rtol=1e-12)
        for kw in (dict(cgs_kernel="pallas", reorth="dgks"),
                   dict(storage_dtype=torch.bfloat16)):
            with pytest.raises(ValueError):
                pt.eigsh(a, k=2, device="cpu", **kw)


@pytest.mark.parametrize("storage,tol", [(None, 1e-5), ("bfloat16", 1e-2)])
def test_dgks_cgs_kernels_match_reference(storage, tol):
    # reorth='dgks' with cgs_kernel='pallas': the 8/16/24-row buckets run
    # the CGS kernels (their twins here, Pallas in interpret mode in the
    # reference), the 32-row bucket a GEMV.  Values within 10*tol*|lambda|
    # and equal counters, in float32 compute with float32 or bfloat16
    # basis storage (bfloat16 at the tolerance where 'auto' picks it)
    opj, a = jmodels.laplacian_2d(24, dtype=np.float32)
    opp, _ = pmodels.laplacian_2d(24, dtype=np.float32, device="cpu")
    v0 = np.random.default_rng(3).uniform(-1, 1, opj.n)
    kw = dict(k=4, which="LA", ncv=32, tol=tol, v0=v0, maxiter=500,
              reorth="dgks", cgs_kernel="pallas", return_stats=True)
    vj, _, oj = at.eigsh(opj, storage_dtype=storage, **kw)
    vp, xp, op_ = pt.eigsh(
        opp, storage_dtype=torch.bfloat16 if storage else None, **kw)
    np.testing.assert_allclose(vp, vj, rtol=0,
                               atol=10 * tol * np.abs(vj).max())
    assert residual(a, vp, xp).max() < 100 * tol
    assert (op_.stats.nopx, op_.stats.nrorth, op_.n_iter) == \
        (oj.stats.nopx, oj.stats.nrorth, oj.n_iter)


def test_default_device_is_the_card():
    # no device= means the CUDA card: the constructor records it, and a
    # solve (or a constructor that moves data) on a machine without CUDA
    # raises instead of running on the CPU
    import scipy.sparse as sp
    op, _ = pmodels.laplacian_2d(8, dtype=np.float64)
    assert op.device.type == "cuda"
    if torch.cuda.is_available():
        assert pt.from_scipy(sp.identity(3000, format="csr")).device.type \
            == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.eigsh(op, k=2, which="LA")
    for build in (lambda: pt.eigsh(sp.identity(3000, format="csr"), k=2),
                  lambda: pt.from_dense(np.eye(8)),
                  lambda: pt.from_diagonal(np.ones(8)),
                  lambda: pt.state_from_numpy({})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
