"""The port's scipy-sparse entry (``arpack_ng_tpu_torch/ops/sparse.py``,
``models/corpus.py``) against the reference package's, on the matrices of
tests/test_sparse_auto.py and tests/test_corpus.py.

Both packages run the same host code on the same scipy matrix, so the
chosen format, the permutation and every host array must be equal bit for
bit.  The operators' matvecs agree with each other and with scipy in
float64 to rtol 1e-12; ``eigsh(A_csr, device="cpu")`` agrees with the
reference's ``eigsh`` on values (within 10*tol*|lambda|) and, in float64,
on the matvec and reorthogonalization counts.  On the CPU the DIA and
PSELL operators run their kernels' plain twins."""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import arpack_ng_tpu as at  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu.models import corpus as jcorpus  # noqa: E402
from arpack_ng_tpu.ops import pallas_psell as jps  # noqa: E402
from arpack_ng_tpu.ops import sparse as jsparse  # noqa: E402
from arpack_ng_tpu_torch.models import corpus as pcorpus  # noqa: E402
from arpack_ng_tpu_torch.ops import psell as pps  # noqa: E402
from arpack_ng_tpu_torch.ops import sparse as psparse  # noqa: E402

from conftest import residual  # noqa: E402


def _lap2d(nx):
    t = sp.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)],
                 [-1, 0, 1])
    eye = sp.identity(nx)
    return (sp.kron(eye, t) + sp.kron(t, eye)).tocsr().astype(np.float64)


def _scrambled(nx, seed=0):
    a = _lap2d(nx)
    p = np.random.default_rng(seed).permutation(a.shape[0])
    return a[p][:, p].tocsr()


#: name -> (build with the reference's corpus, with the port's corpus)
_BUILD = {
    "small": (lambda c: _lap2d(10)),        # n = 100: dense
    "lap2d": (lambda c: _lap2d(60)),        # 5 diagonals: DIA
    "scrambled": (lambda c: _scrambled(60)),  # RCM recovers DIA
    "fem": (lambda c: c.fem_triangulation(3000)),  # ELL
    "powerlaw": (lambda c: c.powerlaw_graph(3000)),  # hub rows: HYB
    "saddle": (lambda c: c.saddle_point(40)),  # KKT, n = 3200: DIA
}
FORMATS = {"small": "dense", "lap2d": "dia", "scrambled": "dia",
           "fem": "ell", "powerlaw": "hyb", "saddle": "dia"}
_CACHE = {}


def matrix(name):
    if name not in _CACHE:
        _CACHE[name] = _BUILD[name](pcorpus)
    return _CACHE[name]


def _same_csr(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("name", ["fem", "powerlaw", "saddle"])
def test_corpus_copy_builds_the_reference_matrices(name):
    _same_csr(_BUILD[name](jcorpus), matrix(name))


@pytest.mark.parametrize("name", sorted(_BUILD))
def test_auto_format_and_perm_match_reference(name):
    a = matrix(name)
    jop = jsparse.from_scipy(a, hermitian=True)
    pop = pt.from_scipy(a, hermitian=True, device="cpu")
    assert pop.format == jop.format == FORMATS[name]
    assert (pop.n, pop.n_pad) == (jop.n, jop.n_pad)
    if jop.perm is None:
        assert pop.perm is None
    else:
        np.testing.assert_array_equal(pop.perm, jop.perm)
    assert (name == "scrambled") == (pop.perm is not None)


@pytest.mark.parametrize("name", ["lap2d", "scrambled", "fem", "powerlaw",
                                  "saddle"])
def test_host_arrays_match_reference(name):
    a = matrix(name)
    n_pad = at.pad_dim(a.shape[0], 1024)
    for fn in ("structural_diagonals", "_psell_groups",
               "_psell_uniform_tiles"):
        assert getattr(psparse, fn)(a) == getattr(jsparse, fn)(a)
    np.testing.assert_array_equal(psparse._deal_perm(a),
                                  jsparse._deal_perm(a))
    if FORMATS[name] == "dia":
        src = a
        if name == "scrambled":  # the RCM-permuted matrix goes to DIA
            p = jsparse.from_scipy(a, hermitian=True).perm
            src = a[p][:, p].tocsr()
        (jo, jd), (po, pd) = jsparse._to_dia(src), psparse._to_dia(src)
        assert po == jo
        for x, y in zip(pd, jd):
            np.testing.assert_array_equal(x, y)
    w95 = psparse._hyb_width(a)
    for width in (0, w95):
        jc, jv, jt = jsparse._to_ell(a, n_pad, width=width)
        pc, pv, ptail = psparse._to_ell(a, n_pad, width=width)
        np.testing.assert_array_equal(pc, jc)
        np.testing.assert_array_equal(pv, jv)
        for f in ("row", "col", "data"):
            np.testing.assert_array_equal(getattr(ptail, f), getattr(jt, f))


@pytest.mark.parametrize("name,fmt", [
    ("lap2d", "dia"), ("saddle", "dia"), ("scrambled", "ell"),
    ("fem", "ell"), ("fem", "hyb"), ("fem", "psell"), ("fem", "coo"),
    ("powerlaw", "hyb"), ("powerlaw", "psell"), ("powerlaw", "coo")])
def test_operator_matvec_matches_reference_and_scipy(name, fmt):
    a = matrix(name)
    jop = jsparse.from_scipy(a, hermitian=True, format=fmt)
    pop = pt.from_scipy(a, hermitian=True, format=fmt, device="cpu")
    assert pop.format == jop.format == fmt
    x = np.random.default_rng(1).standard_normal(a.shape[0])
    y = pop.matvec(x)
    np.testing.assert_allclose(y, a @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y, jop.matvec(x), rtol=1e-12, atol=1e-12)
    # zero padding maps to zero padding
    xp = torch.zeros(pop.n_pad, dtype=torch.float64)
    xp[: pop.n] = torch.from_numpy(x)
    assert not pop.a_apply(xp)[pop.n:].any()


@pytest.mark.parametrize("name,reorth", [
    ("lap2d", "selective"), ("lap2d", "dgks"), ("scrambled", "selective"),
    ("fem", "selective"), ("saddle", "dgks")])
def test_eigsh_sparse_matches_reference(name, reorth):
    a = matrix(name)
    tol = 1e-10
    v0 = np.random.default_rng(2).uniform(-1, 1, a.shape[0])
    kw = dict(k=3, which="LA", ncv=20, tol=tol, v0=v0, maxiter=2000,
              reorth=reorth, return_stats=True)
    vj, _, oj = at.eigsh(a, **kw)
    vp, xp, op_ = pt.eigsh(a, device="cpu", **kw)
    np.testing.assert_allclose(vp, vj, rtol=0,
                               atol=10 * tol * np.abs(vj).max())
    assert residual(a, vp, xp).max() < 100 * tol
    assert (op_.stats.nopx, op_.stats.nrorth, op_.n_iter) == \
        (oj.stats.nopx, oj.stats.nrorth, oj.n_iter)


def test_v0_with_permutation():
    # v0 is given in the caller's order: both packages permute it in and
    # the eigenvectors out (the residual is taken with the caller's
    # matrix), and agree on values.  The low end holds a degenerate pair,
    # so the counts are not compared (tests/test_sparse_auto.py asserts
    # the same on the reference alone)
    a = matrix("scrambled")
    v0 = np.random.default_rng(3).standard_normal(a.shape[0])
    kw = dict(k=3, which="SA", tol=1e-10, v0=v0)
    vj = at.eigsh(a, return_eigenvectors=False, **kw)
    vp, xp = pt.eigsh(a, device="cpu", **kw)
    np.testing.assert_allclose(vp, vj, rtol=1e-9)
    assert residual(a, vp, xp).max() < 1e-8
    # the same start vector repeats the solve exactly
    np.testing.assert_array_equal(
        pt.eigsh(a, device="cpu", return_eigenvectors=False, **kw), vp)


def test_float32_dia_solve_matches_reference():
    a = matrix("lap2d")
    v0 = np.random.default_rng(4).uniform(-1, 1, a.shape[0])
    kw = dict(k=4, which="LA", ncv=20, tol=1e-5, v0=v0, dtype=np.float32,
              return_stats=True)
    vj, _, oj = at.eigsh(a, **kw)
    vp, xp, op_ = pt.eigsh(a, device="cpu", **kw)
    np.testing.assert_allclose(vp, vj, rtol=0, atol=1e-4 * 8)
    assert residual(a, vp, xp).max() < 1e-3


def test_complex_matrix_raises():
    # complex matrices are ported (tests/test_torch_complex.py): they take
    # the reference's decision tree (DIA here, the kernel's torch twin);
    # only format='psell' raises, the PSELL kernel being real-only
    a = sp.identity(3000, format="csr", dtype=np.complex128)
    op = pt.from_scipy(a, device="cpu")
    assert op.format == jsparse.from_scipy(a).format == "dia"
    x = np.arange(3000) * (1 + 1j)
    np.testing.assert_array_equal(op.matvec(x), x)
    op = pt.from_scipy(_lap2d(60), dtype=np.complex64, device="cpu")
    assert op.dtype == np.complex64 and op.format == "dia"
    with pytest.raises(ValueError, match="real"):
        pt.from_scipy(_lap2d(60), dtype=np.complex64, format="psell",
                      device="cpu")


def test_unknown_format_raises():
    with pytest.raises(ValueError, match="unknown sparse format"):
        pt.from_scipy(_lap2d(60), format="csr", device="cpu")


def test_from_scipy_leaves_the_input_untouched():
    a = _lap2d(60).tocoo()
    a = sp.coo_matrix((np.concatenate([a.data, [1.0]]),
                       (np.concatenate([a.row, [0]]),
                        np.concatenate([a.col, [0]]))),
                      shape=a.shape).tocsr(copy=False)
    a.has_canonical_format = False
    before = a.data.copy()
    op = pt.from_scipy(a, device="cpu", format="dia")
    np.testing.assert_array_equal(a.data, before)
    x = np.random.default_rng(5).standard_normal(a.shape[0])
    np.testing.assert_allclose(op.matvec(x), a @ x, rtol=1e-12)


def test_psell_import_uses_the_reference_packing():
    a = matrix("fem")
    n_pad = at.pad_dim(a.shape[0], 1024)
    jpk = jps.pack_psell_uniform(sp.csr_matrix(a), n_pad=n_pad)
    ppk = pps.pack_psell_uniform(sp.csr_matrix(a), n_pad=n_pad)
    for f in jpk._fields:
        np.testing.assert_array_equal(getattr(ppk, f), getattr(jpk, f))
