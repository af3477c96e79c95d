"""Complex dtypes in the port against the reference package, on the same
numpy inputs and start vectors: the complex Lanczos/Arnoldi engine, the
Hermitian ``eigsh`` through both drivers (tests/test_hermitian.py), the
complex ``eigs`` through the hybrid driver (tests/test_fused_nonsym.py,
its hybrid side), complex ``from_scipy`` and stencil operators, and a
complex state handed over mid-solve.

Tolerances: complex128 extensions agree to 1e-12 of max|H| with equal
counters; complex128 solves to 1e-10 relative with equal counters (the
reduced spaces run the same complex128 / float64 numpy code);
complex64 matvecs to 1e-5 of max|y|, complex128 ones to 1e-12.  The
Hermitian cases keep tests/test_hermitian.py's oracles (numpy eigvalsh at
rtol 1e-8, residual < 1e-7, values real)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import scipy.sparse as sp  # noqa: E402

import arpack_ng_tpu as at  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.config import IRAMConfig as JConfig  # noqa: E402
from arpack_ng_tpu.core import arnoldi as jarn  # noqa: E402
from arpack_ng_tpu.core.iram import IRAMSolver as JIRAMSolver  # noqa: E402
from arpack_ng_tpu.ops import sparse as jsparse  # noqa: E402
from arpack_ng_tpu.utils.stats import Timers as JTimers  # noqa: E402
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402
from arpack_ng_tpu_torch.config import IRAMConfig as PConfig  # noqa: E402
from arpack_ng_tpu_torch.core import arnoldi as parn  # noqa: E402
from arpack_ng_tpu_torch.core.iram import IRAMSolver  # noqa: E402

COUNTS = ("nopx", "nbx", "nrorth", "nitref", "nrstrt", "nrorthr")


def _herm(rng, n):
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return (a + a.conj().T) / 2


def _cv0(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)


def _counters(out):
    return (out.n_iter, out.stats.nopx, out.stats.nrorth)


@pytest.mark.parametrize("strategy", ["fused", "hybrid"])
@pytest.mark.parametrize("which", ["LA", "SA", "LM"])
def test_hermitian_eigsh(strategy, which, rng):
    # tests/test_hermitian.py::test_hermitian_eigsh through the port, with
    # the reference beside it on the same start vector
    n = 140
    a = _herm(rng, n)
    kw = dict(k=4, which=which, tol=1e-10, maxiter=800, strategy=strategy,
              ncv=20, v0=_cv0(n), return_stats=True)
    vals, vecs, out = pt.eigsh(a.astype(np.complex128), device="cpu", **kw)
    w = np.linalg.eigvalsh(a)
    if which == "LA":
        ref = w[-4:]
    elif which == "SA":
        ref = w[:4]
    else:
        ref = w[np.argsort(np.abs(w))][-4:]
    np.testing.assert_allclose(np.sort(vals), np.sort(ref), rtol=1e-8,
                               atol=1e-10)
    for i in range(4):
        assert np.linalg.norm(a @ vecs[:, i] - vals[i] * vecs[:, i]) < 1e-7
    assert np.isrealobj(vals) and np.iscomplexobj(vecs)
    vj, _, oj = at.eigsh(a.astype(np.complex128), **kw)
    np.testing.assert_allclose(vals, vj, rtol=1e-10)
    assert _counters(out) == _counters(oj)


def test_hermitian_vs_general_complex(rng):
    # tests/test_hermitian.py::test_hermitian_vs_general_complex: the
    # Hermitian path agrees with the general complex (hybrid) driver
    n = 120
    a = _herm(rng, n).astype(np.complex128)
    kw = dict(k=3, tol=1e-10, return_eigenvectors=False, ncv=16,
              device="cpu")
    vh = pt.eigsh(a, which="LA", **kw)
    vg = pt.eigs(a, which="LR", **kw)
    np.testing.assert_allclose(np.sort(vh), np.sort(vg.real), rtol=1e-8)


def _complex_problem(name):
    """(reference operator, port operator, ncv) of a complex problem."""
    if name == "herm":
        a = _herm(np.random.default_rng(5), 300).astype(np.complex128)
        return (at.from_dense(a, n_pad=at.pad_dim(300)),
                pt.from_dense(a, n_pad=pt.pad_dim(300), device="cpu"), 24)
    # a Hermitian diagonal whose geometric spread fires selective events
    d = np.geomspace(1.0, 1e4, 300).astype(np.complex128)
    n_pad = at.pad_dim(300)
    return (at.from_diagonal(d, n_pad=n_pad),
            pt.from_diagonal(d, n_pad=n_pad, device="cpu"), 48)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("reorth", ["selective", "dgks"])
@pytest.mark.parametrize("name", ["herm", "geo"])
def test_complex_extend_matches_reference(name, reorth, symmetric):
    # the complex Lanczos (symmetric: Hermitian, real tridiagonal) and
    # Arnoldi steps from the same complex128 start vector: H to 1e-12 of
    # max|H|, V to 1e-9, equal counters
    opj, opp, ncv = _complex_problem(name)
    kw = dict(n=opj.n, nev=4, ncv=ncv, which="LA" if symmetric else "LM",
              symmetric=symmetric, dtype=np.dtype(np.complex128),
              n_pad=opj.n_pad, reorth=reorth)
    v0 = np.zeros(opj.n_pad, np.complex128)
    v0[: opj.n] = _cv0(opj.n)
    cj, cp = JConfig(**kw), PConfig(**kw)
    stj = jarn.make_init(opj, cj)(jax.random.key(0), jnp.asarray(v0))
    ext = jarn.make_extend(opj, cj)
    stj = jax.device_get(jax.jit(lambda s: ext(s, jnp.int32(ncv)))(stj))
    stp = parn.make_extend(opp, cp)(parn.make_init(opp, cp)(None, v0), ncv)
    Hj = np.asarray(stj.H)
    assert np.max(np.abs(stp.H - Hj)) <= 1e-12 * np.max(np.abs(Hj))
    np.testing.assert_allclose(float(stp.rnorm), float(stj.rnorm),
                               rtol=1e-9)
    np.testing.assert_allclose(parn.v_matrix(stp.V), jarn.v_matrix(stj.V),
                               rtol=0, atol=1e-9)
    got = {f: getattr(stp.counts, f) for f in COUNTS}
    assert got == {f: int(getattr(stj.counts, f)) for f in COUNTS}
    if name == "geo" and reorth == "selective" and symmetric:
        assert stp.counts.nrorthr > 0   # the complex events ran


def test_complex_random_start_and_bnorm():
    # a complex start vector draws real and imaginary parts (dlarnv on
    # both, reference arnoldi.py:266-280) and is zero on the pad; the norm
    # is sqrt(|<r, r>|) of the conjugated dot
    op = pt.from_diagonal(np.arange(1.0, 101.0).astype(np.complex64),
                          n_pad=128, device="cpu")
    v = parn._random_vector(torch.Generator().manual_seed(0), 128, 100,
                            np.complex64, "cpu")
    assert v.dtype == torch.complex64
    assert v.imag[:100].abs().min() > 0 and v[100:].abs().max() == 0
    assert v.real.abs().max() <= 1 and v.imag.abs().max() <= 1
    cfg = PConfig(n=100, nev=2, ncv=8, which="LM",
                  dtype=np.dtype(np.complex64), n_pad=128)
    nrm = parn.make_bnorm(op, cfg)(v, v)
    assert not nrm.is_complex()
    np.testing.assert_allclose(float(nrm), np.linalg.norm(v.numpy()),
                               rtol=1e-6)
    vals = pt.eigs(op, k=2, ncv=8, tol=1e-6, return_eigenvectors=False)
    np.testing.assert_allclose(np.sort(np.abs(vals)), [99, 100], rtol=1e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(cgs_kernel="pallas"), "float32"),
    (dict(storage_dtype="bfloat16"), "real")])
def test_complex_refusals_match_reference(kw, match):
    # the CGS kernels and narrow storage are for real dtypes: both packages
    # raise the same ValueError
    d = np.arange(1.0, 101.0).astype(np.complex64)
    base = dict(n=100, nev=2, ncv=8, which="LM",
                dtype=np.dtype(np.complex64), n_pad=128)
    jkw = {k: (jnp.bfloat16 if v == "bfloat16" else v)
           for k, v in kw.items()}
    pkw = {k: (torch.bfloat16 if v == "bfloat16" else v)
           for k, v in kw.items()}
    with pytest.raises(ValueError, match=match):
        jarn.make_extend(at.from_diagonal(d, n_pad=128),
                         JConfig(**base, **jkw))
    with pytest.raises(ValueError, match=match):
        parn.make_extend(pt.from_diagonal(d, n_pad=128, device="cpu"),
                         PConfig(**base, **pkw))


def test_complex_eigs_matches_reference(rng):
    # tests/test_fused_nonsym.py::test_complex_fused_matches_hybrid, its
    # hybrid side: a random complex matrix, complex128, 'auto' (= hybrid)
    n = 100
    a = ((rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
         / np.sqrt(n)).astype(np.complex128)
    kw = dict(k=4, which="LM", ncv=20, tol=1e-10, maxiter=400, v0=_cv0(n),
              return_stats=True)
    vj, _, oj = at.eigs(a, **kw)
    vp, xp, op_ = pt.eigs(a, device="cpu", **kw)
    assert vp.dtype == np.complex128 and xp.dtype == np.complex128
    np.testing.assert_allclose(vp, vj, rtol=1e-10)
    assert _counters(op_) == _counters(oj)
    assert np.linalg.norm(a @ xp - xp * vp, axis=0).max() < 1e-8


@pytest.mark.parametrize("which", ["LM", "LR", "SR", "LI"])
def test_which_selectors_complex(which, rng):
    # tests/test_fused_nonsym.py::test_which_selectors_fused through the
    # hybrid driver: a complex diagonal, the wanted three by the
    # reference's sort key, and the reference's values and counters
    n = 120
    d = (rng.uniform(0.5, 4, n) * np.exp(2j * np.pi * rng.uniform(size=n))
         ).astype(np.complex128)
    kw = dict(k=3, which=which, ncv=18, tol=1e-10, maxiter=600, v0=_cv0(n),
              return_stats=True)
    vals, _, out = pt.eigs(
        pt.from_diagonal(d, n_pad=pt.pad_dim(n), device="cpu"), **kw)
    from arpack_ng_tpu.core.reduced import sort_key
    ref = d[np.argsort(sort_key(which, d, real_pairs=False))][-3:]
    np.testing.assert_allclose(np.sort_complex(np.round(vals, 9)),
                               np.sort_complex(np.round(ref, 9)), rtol=1e-7)
    vj, _, oj = at.eigs(at.from_diagonal(d, n_pad=at.pad_dim(n)), **kw)
    np.testing.assert_allclose(vals, vj, rtol=1e-10)
    assert _counters(out) == _counters(oj)


def test_complex_schur_vectors():
    # return_schur on a complex problem: orthonormal Schur vectors spanning
    # the reference's invariant subspace (complex Schur form on the host)
    opj, a = jmodels.convection_diffusion_2d(10, dtype=np.complex128)
    opp, _ = pmodels.convection_diffusion_2d(10, dtype=np.complex128,
                                             device="cpu")
    kw = dict(k=4, which="LM", ncv=20, tol=1e-10, maxiter=500,
              v0=_cv0(opj.n), return_schur=True)
    _, Qj = at.eigs(opj, **kw)
    _, Qp = pt.eigs(opp, **kw)
    assert np.iscomplexobj(Qp)
    np.testing.assert_allclose(Qp.conj().T @ Qp, np.eye(Qp.shape[1]),
                               atol=1e-10)
    aq = a @ Qp
    assert np.linalg.norm(aq - Qp @ (Qp.conj().T @ aq)) < 1e-7
    # the same subspace: the projector difference vanishes
    Pj, Pp = Qj @ Qj.conj().T, Qp @ Qp.conj().T
    assert np.abs(Pj - Pp).max() < 1e-8


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_complex_convection_diffusion_stencil(dtype):
    # convection_diffusion_2d(nx, dtype=complex): the zndrv1-class operator,
    # the reference's matvec and the scipy oracle's
    nx = 12
    opj, a = jmodels.convection_diffusion_2d(nx, dtype=dtype)
    opp, _ = pmodels.convection_diffusion_2d(nx, dtype=dtype, device="cpu")
    x = _cv0(nx * nx, 3).astype(dtype)
    yp = opp.matvec(x)
    assert yp.dtype == np.dtype(dtype)
    tol = 1e-5 if dtype == np.complex64 else 1e-12
    yj = np.asarray(opj.matvec(x))
    scale = np.abs(yj).max()
    assert np.abs(yp - yj).max() <= tol * scale
    assert np.abs(yp - a @ x).max() <= tol * scale


def _herm_sparse(n, bands, seed=0):
    """A complex Hermitian band matrix with ``bands`` off-diagonals."""
    rng = np.random.default_rng(seed)
    a = sp.diags(rng.uniform(1, 4, n))
    for k in range(1, bands + 1):
        off = rng.standard_normal(n - k) + 1j * rng.standard_normal(n - k)
        a = a + sp.diags(off, k) + sp.diags(off.conj(), -k)
    return a.tocsr()


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("fmt", ["auto-dense", "auto-dia", "auto-rcm", "ell",
                                 "hyb", "coo", "dia"])
def test_complex_from_scipy_matches_reference(fmt, dtype):
    # the reference's decision tree on a complex matrix: the same format
    # and permutation, and the same matvec (1e-5 / 1e-12 of max|y|)
    if fmt == "auto-dense":
        a = _herm_sparse(300, 3)
    elif fmt == "auto-rcm":
        # a banded matrix under a random symmetric permutation: RCM + DIA
        b = _herm_sparse(3000, 2)
        p = np.random.default_rng(1).permutation(3000)
        a = b[p][:, p].tocsr()
    else:
        a = _herm_sparse(3000, 3)
    fmt_arg = "auto" if fmt.startswith("auto") else fmt
    opj = jsparse.from_scipy(a, dtype=dtype, hermitian=True, format=fmt_arg)
    opp = pt.from_scipy(a, dtype=dtype, hermitian=True, format=fmt_arg,
                        device="cpu")
    assert opp.format == opj.format and opp.dtype == np.dtype(dtype)
    if fmt != "auto-dense":
        assert opp.format == {"auto-dia": "dia", "auto-rcm": "dia"}.get(
            fmt, fmt)
    if opj.perm is None:
        assert opp.perm is None
    else:
        np.testing.assert_array_equal(opp.perm, np.asarray(opj.perm))
    x = _cv0(a.shape[0], 2).astype(dtype)
    yp, yj = opp.matvec(x), np.asarray(opj.matvec(x))
    tol = 1e-5 if dtype == np.complex64 else 1e-12
    assert np.abs(yp - yj).max() <= tol * np.abs(yj).max()


def test_complex_psell_refused():
    with pytest.raises(ValueError, match="real"):
        pt.from_scipy(_herm_sparse(3000, 3), dtype=np.complex64,
                      format="psell", device="cpu")


def test_complex_sparse_eigsh_both_strategies():
    # a complex Hermitian DIA operator from scipy through eigsh, both
    # drivers, complex128: the same values, real, residuals < 1e-8
    a = _herm_sparse(3000, 2, seed=4).astype(np.complex128)
    kw = dict(k=4, which="LA", ncv=20, tol=1e-10, maxiter=800,
              v0=_cv0(3000), device="cpu")
    vf, xf = pt.eigsh(a, strategy="auto", **kw)
    vh, xh = pt.eigsh(a, strategy="hybrid", **kw)
    assert np.isrealobj(vf) and np.isrealobj(vh)
    np.testing.assert_allclose(vf, vh, rtol=1e-9)
    for vals, vecs in ((vf, xf), (vh, xh)):
        r = np.linalg.norm(a @ vecs - vecs * vals, axis=0)
        assert r.max() < 1e-8


def test_complex_eigs_default_is_hybrid():
    # eigs on a complex64 stencil under 'auto' runs the hybrid driver:
    # residuals <= 1e-3 relative (float64 oracle), values within 1e-4 of
    # the complex128 solve's
    op64, a = pmodels.convection_diffusion_2d(12, dtype=np.complex128,
                                              device="cpu")
    op32, _ = pmodels.convection_diffusion_2d(12, dtype=np.complex64,
                                              device="cpu")
    kw = dict(k=4, which="LM", ncv=20, maxiter=500, v0=_cv0(144))
    v32, x32 = pt.eigs(op32, tol=1e-5, **kw)
    v64 = pt.eigs(op64, tol=1e-10, return_eigenvectors=False, **kw)
    assert v32.dtype == np.complex128
    r = np.linalg.norm(a @ x32 - x32 * v32, axis=0) / np.abs(v32)
    assert r.max() <= 1e-3
    np.testing.assert_allclose(v32, v64, rtol=1e-4)


def test_complex_state_handover_mid_solve():
    # the reference's hybrid driver runs two cycles of a complex eigs, its
    # state goes to the port (state_from_numpy) and both run the rest: the
    # same exit cycle, counters and values (1e-10 relative); each cycle's
    # residual norm agrees to 1e-10
    opj, _ = jmodels.convection_diffusion_2d(10, dtype=np.complex128)
    opp, _ = pmodels.convection_diffusion_2d(10, dtype=np.complex128,
                                             device="cpu")
    kw = dict(n=opj.n, nev=4, ncv=20, which="LM", symmetric=False,
              dtype=np.dtype(np.complex128), n_pad=opj.n_pad, tol=1e-10,
              max_iter=500)
    sj, sp_ = JIRAMSolver(opj, JConfig(**kw)), IRAMSolver(opp, PConfig(**kw))
    timers = JTimers()
    stj = sj.init_state(v0=_cv0(opj.n))
    for _ in range(2):
        stj, res = sj.iterate(stj, timers)
        assert res is None
    d = {f: np.array(getattr(stj, f)) for f in (
        "V", "H", "resid", "b_resid", "rnorm", "k", "nev_cur", "iter",
        "info")}
    d["counts"] = {f: int(v) for f, v in stj.counts._asdict().items()}
    stp = pt.state_from_numpy(d, device="cpu")
    assert stp.V.dtype == torch.complex128 and stp.iter == 2
    back = pt.state_to_numpy(stp)
    np.testing.assert_array_equal(back["V"], d["V"].reshape(20, -1))
    while True:
        stj, res = sj.iterate(stj, timers)
        out = sp_.iterate(stp)
        stp = out.state
        assert out.done == (res is not None)
        if res is not None:
            break
        np.testing.assert_allclose(stp.rnorm, float(stj.rnorm), rtol=1e-10)
    # the exit state holds the cycles before the exit cycle, as the
    # reference's does
    assert (out.nconv, out.info, stp.iter) == (res.nconv, res.info,
                                               int(stj.iter))
    assert stp.iter + 1 == res.n_iter
    assert stp.counts.nopx == int(stj.counts.nopx)
    np.testing.assert_allclose(out.ritz[:4], res.ritz[:4], rtol=1e-10)
