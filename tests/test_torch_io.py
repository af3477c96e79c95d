"""The port's file entry points against the reference package on the same
inputs (CPU, float64 unless stated):

* MatrixMarket: ``read_matrix`` gives CSR arrays bit-equal to the
  reference's on scipy-written files (real, complex, symmetric, Hermitian,
  pattern, array) and on hand-written lenient ones (spaced banner, 0- and
  1-based, no nnz, ``(re, im)`` pairs); ``load_operator`` gives the same
  format, ``hermitian`` and ``n_pad``, matvecs within 1e-12;
* checkpoints both ways: a reference ``IRAMSolver`` state resumes in the
  port's and a port state in the reference's, values within 1e-10 and
  counters equal to the writer's own uninterrupted resume; a reference
  ``FusedSymSolver._multi`` dump resumes on the port's device loop; the
  device loop's own cycle boundary resumes under another chunking equal to
  an unbroken solve; resid-only files both ways; the config mismatch
  check; the meta keys and array names;
* the ``/debug/`` block: ``set_all`` sets the reference's fields, and
  level 1 prints the per-cycle trace of both drivers."""
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import arpack_ng_tpu as at  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.config import IRAMConfig as JConfig  # noqa: E402
from arpack_ng_tpu.core import device_sym as jsym  # noqa: E402
from arpack_ng_tpu.core.iram import IRAMSolver as JSolver  # noqa: E402
from arpack_ng_tpu.io import checkpoint as jck  # noqa: E402
from arpack_ng_tpu.io import matrix_market as jmm  # noqa: E402
from arpack_ng_tpu.utils import debug as jdebug  # noqa: E402
from arpack_ng_tpu.utils.stats import Timers as JTimers  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402
from arpack_ng_tpu_torch.core import device_sym as psym  # noqa: E402
from arpack_ng_tpu_torch.io import checkpoint as pck  # noqa: E402
from arpack_ng_tpu_torch.io import matrix_market as pmm  # noqa: E402
from arpack_ng_tpu_torch.utils import debug as pdebug  # noqa: E402

COUNTERS = ("nopx", "nbx", "nrorth", "nitref", "nrstrt", "nrotr",
            "nrorthr")


# ---------------------------------------------------------------------------
# MatrixMarket
# ---------------------------------------------------------------------------

def _scipy_files(tmp):
    rng = np.random.default_rng(0)
    a = sp.random(40, 40, density=0.2, random_state=7, format="csr")
    b = sp.random(40, 40, density=0.2, random_state=8, format="csr")
    c = (a + 1j * b).tocsr()
    out = {}

    def put(name, m, **kw):
        out[name] = tmp / f"{name}.mtx"
        sio.mmwrite(out[name], m, **kw)

    put("real", a)
    put("complex", c)
    put("symmetric", (a + a.T).tocsr(), symmetry="symmetric")
    put("hermitian", (c + c.conj().T).tocsr(), symmetry="hermitian")
    put("pattern", a, field="pattern")
    put("integer", sp.csr_matrix(np.arange(16).reshape(4, 4) % 3))
    put("array", rng.standard_normal((12, 12)))
    return out


LENIENT = {
    "spaced_banner_1based": "%% MatrixMarket matrix coordinate real "
                            "general\n4 4 5\n1 1 2.0\n2 2 3.0\n4 4 1.5\n"
                            "1 4 -1\n3 2 0.5\n",
    "zero_based_no_nnz": "% a comment\n\n4 4\n0 0 2.0\n1 1 3.0\n3 3 1.5\n"
                         "2 1 0.5\n",
    "complex_pairs": "%% MatrixMarket matrix coordinate complex general\n"
                     "3 3 4\n1 1 (1.0, 2.0)\n2 3 (0.5,-1)\n3 3 (2, 0)\n"
                     "3 1 ( -1.5 , 0.25 )\n",
    "both_triangles": "%%MatrixMarket matrix coordinate real symmetric \n"
                      "3 3\n1 1 4\n1 2 -1\n2 1 -1\n2 2 4\n3 3 4\n",
}


def _same_csr(p, j):
    assert p.shape == j.shape and p.dtype == j.dtype
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f))


@pytest.mark.parametrize("name", ["real", "complex", "symmetric",
                                  "hermitian", "pattern", "integer",
                                  "array"])
def test_read_matrix_scipy_files(tmp_path, name):
    path = _scipy_files(tmp_path)[name]
    _same_csr(pmm.read_matrix(path), jmm.read_matrix(path))


@pytest.mark.parametrize("name", sorted(LENIENT))
def test_read_matrix_lenient_files(tmp_path, name):
    path = tmp_path / f"{name}.mtx"
    path.write_text(LENIENT[name])
    got = pmm.read_matrix(path)
    _same_csr(got, jmm.read_matrix(path))
    assert got.nnz > 0


def test_write_matrix_roundtrip(tmp_path):
    a = sp.random(30, 30, density=0.2, random_state=3, format="csr")
    pmm.write_matrix(tmp_path / "p.mtx", a)
    jmm.write_matrix(tmp_path / "j.mtx", a)
    assert (tmp_path / "p.mtx").read_text() == \
        (tmp_path / "j.mtx").read_text()
    assert (pmm.read_matrix(tmp_path / "p.mtx") != a).nnz == 0


def _load_cases(tmp):
    _, lap = jmodels.laplacian_2d(48, dtype=np.float64)      # DIA
    rng = np.random.default_rng(1)
    r = sp.random(2300, 2300, density=0.003, random_state=2, format="csr")
    r = (r + r.T + sp.eye(2300)).tocsr()                      # RCM / ELL
    c = sp.random(60, 60, density=0.1, random_state=4, format="csr")
    h = (c + 1j * sp.random(60, 60, density=0.1, random_state=5,
                            format="csr")).tocsr()
    h = (h + h.conj().T).tocsr()                              # Hermitian
    n = (c + sp.diags(rng.standard_normal(60))).tocsr()       # general
    files = {}
    for name, m in (("lap", lap), ("rcm", r), ("herm", h), ("nonsym", n)):
        files[name] = tmp / f"{name}.mtx"
        sio.mmwrite(files[name], m)
    return files


@pytest.mark.parametrize("name,dense", [("lap", False), ("rcm", False),
                                        ("herm", False), ("nonsym", False),
                                        ("nonsym", True), ("herm", True)])
def test_load_operator_matches_reference(tmp_path, name, dense):
    path = _load_cases(tmp_path)[name]
    pop = pmm.load_operator(path, dense=dense, device="cpu")
    jop = jmm.load_operator(path, dense=dense)
    assert pop.format == jop.format
    assert pop.hermitian == jop.hermitian
    assert pop.hermitian == (name in ("lap", "rcm", "herm"))
    assert pop.n_pad == jop.n_pad and pop.n == jop.n
    assert (pop.perm is None) == (jop.perm is None)
    if pop.perm is not None:
        np.testing.assert_array_equal(pop.perm, np.asarray(jop.perm))
    rng = np.random.default_rng(2)
    x = rng.standard_normal(pop.n)
    if np.iscomplexobj(np.zeros(1, pop.dtype)):
        x = x + 1j * rng.standard_normal(pop.n)
    yp, yj = pop.matvec(x), jop.matvec(x)
    assert np.max(np.abs(yp - yj)) <= 1e-12 * max(1.0, np.max(np.abs(yj)))


def test_load_operator_dtype_and_device(tmp_path):
    path = _load_cases(tmp_path)["lap"]
    op = pmm.load_operator(path, dtype=np.float32, device="cpu")
    assert op.dtype == np.float32 and op.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pmm.load_operator(path)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _diag_problem(n=300, nev=4, ncv=12, tol=1e-12, max_iter=500, **kw):
    d = np.linspace(1, 50, n)
    jop = at.from_diagonal(d, n_pad=at.pad_dim(n))
    pop = pt.from_diagonal(d, n_pad=pt.pad_dim(n), device="cpu")
    args = dict(n=n, nev=nev, ncv=ncv, which="LA", symmetric=True,
                dtype=np.float64, n_pad=jop.n_pad, tol=tol,
                max_iter=max_iter, **kw)
    return jop, pop, JConfig(**args), pt.IRAMConfig(**args), d


def _counts(res):
    return tuple(int(getattr(res.stats, f)) for f in COUNTERS)


def _same_result(got, want, nev, rtol=1e-10):
    assert got.n_iter == want.n_iter and got.info == want.info
    assert got.nconv == want.nconv
    np.testing.assert_allclose(got.ritz[:nev], want.ritz[:nev], rtol=rtol)
    assert _counts(got) == _counts(want)


def test_reference_checkpoint_resumes_in_port(tmp_path):
    jop, pop, jcfg, pcfg, _ = _diag_problem()
    js = JSolver(jop, jcfg)
    st = js.init_state()
    for _ in range(3):
        st, res = js.iterate(st, JTimers())
        assert res is None
    path = tmp_path / "ref.npz"
    jck.save_state(path, st, jcfg)
    want = js.solve(state=st)        # the writer's uninterrupted resume
    pst, meta = pck.load_state(path, cfg=pcfg, device="cpu")
    assert pst.iter == 3 and meta["version"] == 1
    got = pt.IRAMSolver(pop, pcfg).solve(state=pst)
    _same_result(got, want, jcfg.nev)


def test_port_checkpoint_resumes_in_reference(tmp_path):
    jop, pop, jcfg, pcfg, _ = _diag_problem()
    ps = pt.IRAMSolver(pop, pcfg)
    st = ps.init_state()
    for _ in range(3):
        st = ps.iterate(st).state
    path = tmp_path / "port.npz"
    pck.save_state(path, st, pcfg)
    want = ps.solve(state=st)
    jst, _ = jck.load_state(path, cfg=jcfg)
    assert jst.V.shape == (12, jcfg.n_pad // 128, 128)   # v_is_3d
    got = JSolver(jop, jcfg).solve(state=jst)
    _same_result(got, want, jcfg.nev)


def test_reference_fused_dump_resumes_on_device_loop(tmp_path):
    # the reference's fused loop dumps at a dispatch boundary (2 cycles);
    # the port's device loop resumes the file as the reference's resumes
    # its own state
    jop, pop, jcfg, pcfg, d = _diag_problem(reorth="selective")
    js = jsym.FusedSymSolver(jop, jcfg, cycles_per_dispatch=2)
    st = js.init_state()
    out = js._multi(st, jnp.int32(2), jnp.int32(jcfg.max_iter))
    assert int(out.state.iter) == 2 and not bool(out.done)
    path = tmp_path / "fused.npz"
    jck.save_state(path, out.state, jcfg)
    want = js.solve(state=out.state)
    pst, _ = pck.load_state(path, cfg=pcfg, device="cpu")
    got = psym.FusedSymSolver(pop, pcfg).solve(state=pst)
    assert got.stats.packets == got.n_iter - 2   # the device loop ran it
    _same_result(got, want, jcfg.nev)
    np.testing.assert_allclose(np.sort(got.ritz[:4]), np.sort(d)[-4:],
                               rtol=1e-10)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_maxiter_exit_state_resumes_the_unbroken_solve(tmp_path, writer):
    # a solve stopped by max_iter hands back the exit cycle's factorization
    # under the cycles before it, in either package: saved as it is, it
    # resumes in either package to the unbroken solve's values and counters
    jop, pop, jcfg, pcfg, _ = _diag_problem()
    jcut, pcut = (dataclasses.replace(c, max_iter=3) for c in (jcfg, pcfg))
    v0 = np.random.default_rng(3).standard_normal(jcfg.n)
    want = JSolver(jop, jcfg).solve(v0=v0)
    assert want.n_iter > 3
    path = tmp_path / "cut.npz"
    if writer == "reference":
        res = JSolver(jop, jcut).solve(v0=v0)
        jck.save_state(path, res.state, jcut)
    else:
        res = pt.IRAMSolver(pop, pcut).solve(v0=v0)
        pck.save_state(path, res.state, pcut)
    assert res.info == 1 and res.n_iter == 3 and int(res.state.iter) == 2
    jst, _ = jck.load_state(path, cfg=jcfg)
    _same_result(JSolver(jop, jcfg).solve(state=jst), want, jcfg.nev)
    pst, _ = pck.load_state(path, cfg=pcfg, device="cpu")
    _same_result(pt.IRAMSolver(pop, pcfg).solve(state=pst), want, jcfg.nev)


def _pencil_operator(n=120):
    k = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).toarray()
    m = sp.diags([1.0, 4.0, 1.0], [-1, 0, 1], shape=(n, n)).toarray() / 6
    return pt.from_dense(k, m, n_pad=pt.pad_dim(n), hermitian=True,
                         device="cpu")


@pytest.mark.parametrize("bmat", ["I", "G"])
def test_device_loop_boundary_resumes_under_other_chunking(tmp_path, bmat):
    # the port's own boundary: 2 cycles, dumped, loaded into a fresh solver
    # that runs 3 cycles per run, each dumped and loaded into the next, the
    # rest in one solve; equal to the unbroken solve
    if bmat == "I":
        op, _ = pmodels.laplacian_2d(16, np.float64, device="cpu")
        which = "LA"
    else:
        op = _pencil_operator()
        which = "LM"
    cfg = pt.IRAMConfig(n=op.n, nev=4, ncv=14, which=which, symmetric=True,
                        bmat=bmat, mode=1 if bmat == "I" else 2,
                        dtype=np.dtype(np.float64), n_pad=op.n_pad,
                        tol=1e-10, max_iter=300, reorth="selective")
    want = psym.FusedSymSolver(op, cfg).solve()
    assert want.stats.packets == want.n_iter     # one packet per cycle
    assert want.n_iter > 8
    path = tmp_path / "boundary.npz"
    st, ran = psym.FusedSymSolver(op, cfg).init_state(), 0
    for chunk in (2, 3, 3):
        out = psym.FusedSymSolver(op, cfg).multi(st, chunk)
        ran += chunk
        assert out.state.iter == ran and not out.done
        assert out.state.k == out.state.nev_cur < cfg.ncv   # restarted
        pck.save_state(path, out.state, cfg)
        st, _ = pck.load_state(path, cfg=cfg, device="cpu")
    got = psym.FusedSymSolver(op, cfg).solve(state=st)
    assert got.stats.packets == got.n_iter - ran
    _same_result(got, want, cfg.nev, rtol=1e-12)
    np.testing.assert_array_equal(got.ritz, want.ritz)


def test_boundary_state_is_the_host_loops(tmp_path):
    # the boundary applies the deferred restart: its state is the host
    # loop's after the same cycles
    op, _ = pmodels.laplacian_2d(16, np.float64, device="cpu")
    cfg = pt.IRAMConfig(n=op.n, nev=4, ncv=14, which="LA", symmetric=True,
                        dtype=np.dtype(np.float64), n_pad=op.n_pad,
                        tol=1e-10, max_iter=300, reorth="selective")
    dev = psym.FusedSymSolver(op, cfg)
    host = psym.FusedSymSolver(op, cfg)
    host._host_loop = True                   # the same cycles on the host
    a = dev.multi(dev.init_state(), 3).state
    b = host.multi(host.init_state(), 3).state
    assert (a.k, a.nev_cur, a.iter, a.info) == (b.k, b.nev_cur, b.iter,
                                                b.info)
    assert a.counts == b.counts
    k = a.k
    np.testing.assert_allclose(a.H[:k, :k], b.H[:k, :k], rtol=0,
                               atol=1e-12 * np.abs(b.H).max())
    assert float(a.rnorm) == pytest.approx(float(b.rnorm), rel=1e-12)
    assert torch.allclose(a.V[:k + 1], b.V[:k + 1], rtol=0, atol=1e-12)
    assert torch.allclose(a.resid, b.resid, rtol=0, atol=1e-12)


def test_multi_stops_at_exit(tmp_path):
    # a bound past the solve's end hands back the exit (k = ncv), as solve
    op, _ = pmodels.laplacian_2d(12, np.float64, device="cpu")
    cfg = pt.IRAMConfig(n=op.n, nev=3, ncv=12, which="LA", symmetric=True,
                        dtype=np.dtype(np.float64), n_pad=op.n_pad,
                        tol=1e-10, max_iter=300, reorth="selective")
    s = psym.FusedSymSolver(op, cfg)
    full = s.solve()
    out = s.multi(s.init_state(), 10_000)
    assert out.done and out.state.iter == full.n_iter
    assert out.state.k == cfg.ncv
    st = s.init_state()
    none = s.multi(st, 0)                    # no cycle: the state as given
    assert none.state is st and not none.done


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_resid_only_both_ways(tmp_path, writer):
    jop, pop, jcfg, pcfg, _ = _diag_problem(n=200, nev=3, ncv=10,
                                            tol=1e-10, max_iter=400)
    path = tmp_path / "resid.npz"
    if writer == "reference":
        res = JSolver(jop, jcfg).solve()
        jck.save_state(path, res.state, jcfg, save_resid_only=True)
        want = np.asarray(res.state.resid)
    else:
        res = pt.IRAMSolver(pop, pcfg).solve()
        pck.save_state(path, res.state, pcfg, save_resid_only=True)
        want = res.state.resid.numpy()
    pst, pmeta = pck.load_state(path, device="cpu")
    jst, jmeta = jck.load_state(path)
    assert pst is None and jst is None
    np.testing.assert_array_equal(pmeta["resid"], want)
    np.testing.assert_array_equal(jmeta["resid"], want)
    got = pt.IRAMSolver(pop, pcfg).solve(v0=pmeta["resid"])
    ref = JSolver(jop, jcfg).solve(v0=jmeta["resid"])
    _same_result(got, ref, 3)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_config_mismatch_rejected(tmp_path, writer):
    jop, pop, jcfg, pcfg, _ = _diag_problem(n=100, nev=3, ncv=10)
    path = tmp_path / "ck.npz"
    if writer == "reference":
        jck.save_state(path, JSolver(jop, jcfg).init_state(), jcfg)
    else:
        pck.save_state(path, pt.IRAMSolver(pop, pcfg).init_state(), pcfg)
    bad = pt.IRAMConfig(n=100, nev=5, ncv=12, which="LA", symmetric=True,
                        dtype=np.float64, n_pad=pcfg.n_pad)
    with pytest.raises(ValueError, match="mismatch"):
        pck.load_state(path, cfg=bad, device="cpu")
    st, _ = pck.load_state(path, cfg=pcfg, device="cpu")
    assert st is not None


@pytest.mark.parametrize("cgs_kernel,n", [("auto", 300), ("pallas", 300),
                                          ("auto", 100)])
def test_file_layout_matches_reference(tmp_path, cgs_kernel, n):
    # the same meta, array names, dtypes and shapes (V's layout by the
    # reference's v_is_3d rule), both ways
    d = np.linspace(1, 50, n, dtype=np.float32)
    jop = at.from_diagonal(d, n_pad=at.pad_dim(n) if n == 300 else 0)
    pop = pt.from_diagonal(d, n_pad=jop.n_pad, device="cpu")
    # float32: the reference's Pallas CGS kernels take nothing else
    args = dict(n=n, nev=4, ncv=12, which="LA", symmetric=True,
                dtype=np.float32, n_pad=jop.n_pad, cgs_kernel=cgs_kernel)
    jcfg, pcfg = JConfig(**args), pt.IRAMConfig(**args)
    jck.save_state(tmp_path / "j.npz", JSolver(jop, jcfg).init_state(), jcfg)
    pck.save_state(tmp_path / "p.npz", pt.IRAMSolver(pop, pcfg).init_state(),
                   pcfg)
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "p.npz") as zp:
        assert sorted(zj.files) == sorted(zp.files)
        assert json.loads(str(zj["__meta__"])) == \
            json.loads(str(zp["__meta__"]))
        for f in zj.files:
            assert zj[f].shape == zp[f].shape, f
            assert zj[f].dtype == zp[f].dtype, f
        np.testing.assert_array_equal(zj["counts"], zp["counts"])
    assert pck.v_is_3d(pcfg) == (cgs_kernel == "auto" and n == 300)


def test_key_and_short_counts(tmp_path):
    # the key's words round-trip to the generator's seed; any other key
    # seeds deterministically; a file with fewer counters resumes the
    # missing ones from zero
    g = torch.Generator().manual_seed((5 << 32) | 9)
    key = pck.key_of(g)
    assert key.tolist() == [5, 9] and pck.seed_of(key) == (5 << 32) | 9
    np.testing.assert_array_equal(
        pck.key_of(torch.Generator().manual_seed(7)),
        np.asarray(jax.random.key_data(jax.random.key(7))))
    k4 = np.arange(4, dtype=np.uint32)
    assert pck.seed_of(k4) == pck.seed_of(k4.copy())
    assert pck.seed_of(k4) != pck.seed_of(k4[::-1].copy())
    jop, pop, jcfg, pcfg, _ = _diag_problem(n=100, nev=3, ncv=10)
    path = tmp_path / "ck.npz"
    pck.save_state(path, pt.IRAMSolver(pop, pcfg).init_state(), pcfg)
    with np.load(path) as z:
        arrays = {f: z[f] for f in z.files}
    arrays["counts"] = arrays["counts"][:5] + 3
    np.savez(tmp_path / "short.npz", **arrays)
    st, _ = pck.load_state(tmp_path / "short.npz", device="cpu")
    assert st.counts.nrotr == 0 and st.counts.nrorthr == 0
    assert st.counts.nopx == 4
    assert st.gen.initial_seed() == 0
    jst, _ = jck.load_state(tmp_path / "short.npz")
    assert int(jst.counts.nrotr) == 0 and int(jst.counts.nopx) == 4


def test_save_copies_and_bfloat16_roundtrip(tmp_path):
    # the file holds the values at the call, not a view of the basis; a
    # bfloat16 basis goes out as the reference's two-byte values and back
    op, _ = pmodels.laplacian_2d(16, np.float32, device="cpu")
    cfg = pt.IRAMConfig(n=op.n, nev=4, ncv=12, which="LA", symmetric=True,
                        dtype=np.dtype(np.float32), n_pad=op.n_pad,
                        storage_dtype=torch.bfloat16)
    s = pt.IRAMSolver(op, cfg)
    st = s.iterate(s.init_state()).state
    v_before = st.V.clone()
    pck.save_state(tmp_path / "bf.npz", st, cfg)
    st.V.zero_()
    got, _ = pck.load_state(tmp_path / "bf.npz", device="cpu")
    assert got.V.dtype == torch.bfloat16
    assert torch.equal(got.V, v_before)
    with np.load(tmp_path / "bf.npz") as z:
        assert z["V"].dtype == np.dtype("V2")


# ---------------------------------------------------------------------------
# the /debug/ block
# ---------------------------------------------------------------------------

def test_debug_fields_and_set_all_match_reference():
    pf = [f.name for f in dataclasses.fields(pdebug.DebugConfig)]
    jf = [f.name for f in dataclasses.fields(jdebug.DebugConfig)]
    assert pf == jf
    p, j = pdebug.DebugConfig(), jdebug.DebugConfig()
    p.set_all(3)
    j.set_all(3)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert p.maup2 == p.meupd == 3 and p.ndigit == 6


def test_printers_match_reference():
    for mod in (pdebug, jdebug):
        mod.debug.logfil = io.StringIO()
    try:
        outs = []
        for mod in (pdebug, jdebug):
            mod.ivout("iv", [1, 2, 3])
            mod.dvout("dv", np.array([1.5, -2.25]))
            mod.dmout("dm", np.eye(2))
            outs.append(mod.debug.logfil.getvalue())
        assert outs[0] == outs[1] and "iv" in outs[0]
    finally:
        for mod in (pdebug, jdebug):
            mod.debug.logfil = None


@pytest.mark.parametrize("driver", ["hybrid", "device loop"])
def test_debug_level_one_traces_each_cycle(driver):
    op, _ = pmodels.laplacian_2d(12, np.float64, device="cpu")
    cfg = pt.IRAMConfig(n=op.n, nev=3, ncv=12, which="LA", symmetric=True,
                        dtype=np.dtype(np.float64), n_pad=op.n_pad,
                        tol=1e-10, max_iter=300, reorth="selective")
    solver = pt.IRAMSolver(op, cfg) if driver == "hybrid" \
        else psym.FusedSymSolver(op, cfg)
    log = io.StringIO()
    pdebug.debug.logfil = log
    try:
        pdebug.debug.set_all(1)
        res = solver.solve()
    finally:
        pdebug.debug.set_all(0)
        pdebug.debug.logfil = None
    lines = [ln for ln in log.getvalue().splitlines() if "nconv=" in ln]
    assert len(lines) == res.n_iter
    assert "iter 1" in lines[0].replace("iter 0", "iter 1")
