"""The read-free dgks extension (``reorth='dgks'``,
arpack_ng_tpu_torch/core/arnoldi.py) and the symmetric dgks solve on the
device restart loop (core/device_sym.FusedSymSolver), on the CPU, against
the host's step (``Extension.stepwise``: the same torch operations, each
decision read back) and against the JAX package on the same numpy inputs.

Tolerances: against the JAX package, float64 H within 1e-12*max|H| and V
within 1e-9, float32 both within 1e-4, solve values within 1e-10*|lambda|
(float64); the op counters equal.  Against the host's step and the host
loop, everything bit for bit.

* one dgks extension reads nothing back (a TorchFunctionMode that raises
  on every device-to-host conversion);
* the extension against the reference's ``make_extend``: symmetric and
  non-symmetric, real and complex, generalized (``bmat='G'``) and the
  overflow-safe norms;
* a refinement that fails (``REDO``) and a breakdown (rnorm = 0), each
  finished by the host: the host step's state and counters exactly;
* ``FusedSymSolver(reorth='dgks')`` on the device loop against the host
  loop with the host's step, and against the reference's fused solve;
* a dgks solve stopped at a ``multi`` boundary resumes in the reference,
  and a reference dump resumes in the port;
* a gloo world of 2 runs the dgks device loop and equals the unsharded
  solve."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import arpack_ng_tpu as at  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.config import IRAMConfig as JConfig  # noqa: E402
from arpack_ng_tpu.core import arnoldi as jarn  # noqa: E402
from arpack_ng_tpu.core import device_sym as jsym  # noqa: E402
from arpack_ng_tpu.io import checkpoint as jck  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402
from arpack_ng_tpu_torch.config import IRAMConfig as PConfig  # noqa: E402
from arpack_ng_tpu_torch.core import arnoldi as parn  # noqa: E402
from arpack_ng_tpu_torch.core import device_sym as psym  # noqa: E402
from arpack_ng_tpu_torch.io import checkpoint as pck  # noqa: E402

from torch_mp_worker import run_world  # noqa: E402

COUNTS = ("nopx", "nbx", "nrorth", "nitref", "nrstrt", "nrorthr")
SOLVE_COUNTS = COUNTS + ("nrotr",)


class _NoReadBack(torch.overrides.TorchFunctionMode):
    """Raises on every way a tensor's values reach the host."""

    BANNED = {torch.Tensor.item, torch.Tensor.cpu, torch.Tensor.tolist,
              torch.Tensor.numpy, torch.Tensor.__bool__,
              torch.Tensor.__float__, torch.Tensor.__int__}

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls += 1
        if func in self.BANNED:
            raise AssertionError(f"device-to-host read: {func.__name__}")
        return func(*args, **(kwargs or {}))


def _herm(rng, n):
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return (a + a.conj().T) / 2


def _pencil(n=150):
    a = (np.diag(2 * np.ones(n)) - np.diag(np.ones(n - 1), 1)
         - np.diag(np.ones(n - 1), -1))
    m = (np.diag(4 * np.ones(n)) + np.diag(np.ones(n - 1), 1)
         + np.diag(np.ones(n - 1), -1)) / 6.0
    return a, m


def _problem(name, dtype):
    """(reference operator, port operator, config keywords, ncv)."""
    cplx = name in ("herm", "cnonsym")
    if cplx:
        dtype = np.complex128 if dtype == np.float64 else np.complex64
    kw = dict(symmetric=name not in ("nonsym", "cnonsym"))
    if name in ("sym", "safe"):
        opj = jmodels.laplacian_2d(16, dtype)[0]
        opp = pmodels.laplacian_2d(16, dtype, device="cpu")[0]
        if name == "safe":
            kw["safe_norms"] = True
    elif name == "nonsym":
        opj = jmodels.convection_diffusion_2d(14, dtype=dtype)[0]
        opp = pmodels.convection_diffusion_2d(14, dtype=dtype,
                                              device="cpu")[0]
    elif name == "gen":
        a, m = _pencil()
        opj = at.from_dense(a.astype(dtype), m.astype(dtype),
                            n_pad=at.pad_dim(150))
        opp = pt.from_dense(a.astype(dtype), m.astype(dtype),
                            n_pad=pt.pad_dim(150), device="cpu")
        kw.update(bmat="G", mode=2)
    else:
        rng = np.random.default_rng(5)
        a = _herm(rng, 200) if name == "herm" else (
            rng.standard_normal((200, 200))
            + 1j * rng.standard_normal((200, 200))) / np.sqrt(200)
        a = a.astype(dtype)
        opj = at.from_dense(a, n_pad=at.pad_dim(200))
        opp = pt.from_dense(a, n_pad=pt.pad_dim(200), device="cpu")
    kw.update(n=opj.n, nev=4, which="LA" if kw["symmetric"] else "LM",
              dtype=np.dtype(dtype), n_pad=opj.n_pad, reorth="dgks")
    return opj, opp, kw, 24


def _v0(n_pad, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    v0 = np.zeros(n_pad, dtype)
    v0[:n] = rng.uniform(-1, 1, n)
    if np.iscomplexobj(v0):
        v0[:n] += 1j * rng.uniform(-1, 1, n)
    return v0


def _assert_same_state(got, want):
    """Two states of the port bit for bit."""
    np.testing.assert_array_equal(got.H, want.H)
    assert torch.equal(got.V, want.V)
    assert torch.equal(got.resid, want.resid)
    assert got.rnorm == want.rnorm and got.k == want.k
    assert got.info == want.info and got.counts == want.counts


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["sym", "nonsym"])
def test_dgks_extension_reads_nothing_back(name, dtype):
    # a whole extension from a fresh start vector under a mode that raises
    # on any read; it gives the host step's factorization bit for bit
    _, op, kw, ncv = _problem(name, dtype)
    cfg = PConfig(ncv=ncv, **kw)
    init = parn.make_init(op, cfg)
    ext = parn.make_extend(op, cfg)
    assert ext.read_free
    ds = ext.load(init(None, None))
    guard = _NoReadBack()
    with guard:
        ext.run(ds, 0, ncv)
    assert guard.calls > 20 * ncv  # the mode saw the steps' ops
    assert int(ds.brk) == -1
    want = ext.stepwise(init(None, None), ncv)
    np.testing.assert_array_equal(ds.H.numpy(), want.H)
    assert torch.equal(ds.resid, want.resid)
    assert float(ds.rnorm) == want.rnorm
    assert ds.cnt.tolist() == [want.counts.nrorth, 0, 0, 0]
    assert want.counts.nrorth > 0        # the refinement pass ran
    if kw["symmetric"]:
        np.testing.assert_array_equal(ds.a.numpy(), np.diag(want.H))
        np.testing.assert_array_equal(ds.b.numpy()[:-1],
                                      np.diag(want.H, -1))
        assert float(ds.b[-1]) == want.rnorm
    _assert_same_state(ext(init(None, None), ncv), want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["sym", "nonsym", "herm", "cnonsym", "gen",
                                  "safe"])
def test_dgks_extension_matches_reference(name, dtype):
    # the read-free extension against the reference's make_extend from the
    # same start vector (H to 1e-12 of max|H| and V to 1e-9 in float64,
    # 1e-4 in float32, counters equal) and against the host's step (bit
    # for bit)
    opj, opp, kw, ncv = _problem(name, dtype)
    cj, cp = JConfig(ncv=ncv, **kw), PConfig(ncv=ncv, **kw)
    v0 = _v0(opj.n_pad, opj.n, kw["dtype"])
    stj = jarn.make_init(opj, cj)(jax.random.key(0), jnp.asarray(v0))
    jext = jarn.make_extend(opj, cj)
    stj = jax.device_get(jax.jit(lambda s: jext(s, jnp.int32(ncv)))(stj))
    init = parn.make_init(opp, cp)
    ext = parn.make_extend(opp, cp)
    assert ext.read_free
    stp = ext(init(None, v0), ncv)
    _assert_same_state(stp, ext.stepwise(init(None, v0), ncv))
    double = kw["dtype"] in (np.float64, np.complex128)
    tol_h, tol_v = (1e-12, 1e-9) if double else (1e-4, 1e-4)
    Hj = np.asarray(stj.H)
    assert np.max(np.abs(stp.H - Hj)) <= tol_h * np.max(np.abs(Hj))
    np.testing.assert_allclose(parn.v_matrix(stp.V), jarn.v_matrix(stj.V),
                               rtol=0, atol=tol_v)
    got = {f: getattr(stp.counts, f) for f in COUNTS}
    assert got == {f: int(getattr(stj.counts, f)) for f in COUNTS}
    # the refinement is needed on these steps (the random complex matrix's
    # Arnoldi vectors keep their norms: there it only runs zeroed)
    assert (stp.counts.nrorth > 0) == (name != "cnonsym")
    assert stp.k == int(stj.k) == ncv and stp.info == int(stj.info) == 0


def _eigvec_start():
    # v0 = e_0 on a diagonal: the first step's residual is exactly 0, so
    # both refinement passes fail (the residual is declared in span and
    # zeroed) and the next step draws a restart vector on the host
    d = np.linspace(1.0, 10.0, 60)
    op = pt.from_diagonal(d, n_pad=pt.pad_dim(60), device="cpu")
    cfg = PConfig(n=60, nev=2, ncv=10, which="LA", symmetric=True,
                  dtype=np.dtype(np.float64), n_pad=op.n_pad, reorth="dgks")
    v0 = np.zeros(op.n_pad)
    v0[0] = 1.0
    return op, cfg, v0


def test_failed_refinement_redo_equals_host_step():
    # the read-free extension only flags the failed refinement (brk =
    # REDO); the host restores the entry and runs the extension again:
    # the host step's state and counters exactly
    op, cfg, v0 = _eigvec_start()
    ext, init = parn.make_extend(op, cfg), parn.make_init(op, cfg)
    ds = ext.load(init(None, v0))
    ext.run(ds, 0, cfg.ncv)
    assert int(ds.brk) == parn.REDO
    want = ext.stepwise(init(None, v0), cfg.ncv)
    assert want.counts.nitref == 2 and want.counts.nrstrt == 1
    _assert_same_state(ext(init(None, v0), cfg.ncv), want)


def test_breakdown_equals_host_step():
    # an extension entering with rnorm = 0 flags the breakdown at its
    # first step; the host draws the restart vector on its generator and
    # finishes: the host step's state and counters exactly
    op, cfg, v0 = _eigvec_start()
    ext, init = parn.make_extend(op, cfg), parn.make_init(op, cfg)

    def entry():
        st = ext.stepwise(init(None, v0), 1)
        assert st.rnorm == 0 and st.k == 1
        return st

    ds = ext.load(entry())
    ext.run(ds, 1, cfg.ncv)
    assert int(ds.brk) == 1
    want = ext.stepwise(entry(), cfg.ncv)
    assert want.counts.nrstrt == 1
    _assert_same_state(ext(entry(), cfg.ncv), want)


def _stepwise_host_solver(op, cfg):
    """FusedSymSolver on the host loop with the host's dgks step (the
    path the dgks solve took before it ran on the device loop)."""
    real = psym.make_extend

    def host_extend(o, c):
        return parn.Extension(real(o, c).stepwise)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(psym, "make_extend", host_extend)
        solver = psym.FusedSymSolver(op, cfg)
    assert solver._host_loop
    return solver


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("which", ["LA", "SA", "BE"])
def test_dgks_device_loop_equals_host_loop(which, dtype):
    # the device loop's read-free steps, reduced space (the numpy twin on
    # the CPU) and restart against the host loop with the host's step:
    # everything equal
    op, _ = pmodels.laplacian_2d(16, dtype, device="cpu")
    cfg = PConfig(n=op.n, nev=4, ncv=20, which=which, symmetric=True,
                  dtype=np.dtype(dtype), n_pad=op.n_pad,
                  tol=1e-10 if dtype == np.float64 else 1e-5, max_iter=300,
                  reorth="dgks")
    solver = psym.FusedSymSolver(op, cfg)
    assert not solver._host_loop
    dev = solver.solve()
    host = _stepwise_host_solver(op, cfg).solve()
    assert dev.n_iter == host.n_iter and dev.info == host.info
    assert dev.nconv == host.nconv
    np.testing.assert_array_equal(dev.ritz, host.ritz)
    np.testing.assert_array_equal(dev.bounds, host.bounds)
    for f in SOLVE_COUNTS:
        assert getattr(dev.stats, f) == getattr(host.stats, f), f
    assert dev.stats.nrorth > 0
    # the device loop carries T; the host's H also holds the projections
    # above the diagonal, which the symmetric cycle never reads
    for off in (0, -1):
        np.testing.assert_array_equal(np.diag(dev.state.H, off),
                                      np.diag(host.state.H, off))
    assert torch.equal(dev.state.V, host.state.V)
    assert dev.stats.packets == dev.n_iter
    assert dev.stats.graphs_captured == 0  # no card, no graph


def test_dgks_device_loop_redo_and_restart():
    # a solve whose first extension fails its refinement and draws a
    # restart vector: the device loop reads a second packet after the
    # host's rerun and equals the host loop
    op, cfg, v0 = _eigvec_start()
    cfg = dataclasses.replace(cfg, tol=1e-10, max_iter=300)
    dev = psym.FusedSymSolver(op, cfg).solve(v0=v0)
    host = _stepwise_host_solver(op, cfg).solve(v0=v0)
    assert dev.stats.nrstrt == host.stats.nrstrt == 1
    assert dev.stats.packets == dev.n_iter + 1
    np.testing.assert_array_equal(dev.ritz, host.ritz)
    for f in SOLVE_COUNTS:
        assert getattr(dev.stats, f) == getattr(host.stats, f), f


def _diag_problem(which="LA", max_iter=500):
    d = np.linspace(1, 50, 300)
    jop = at.from_diagonal(d, n_pad=at.pad_dim(300))
    pop = pt.from_diagonal(d, n_pad=pt.pad_dim(300), device="cpu")
    args = dict(n=300, nev=4, ncv=12, which=which, symmetric=True,
                dtype=np.float64, n_pad=jop.n_pad, tol=1e-12,
                max_iter=max_iter, reorth="dgks")
    return jop, pop, JConfig(**args), PConfig(**args), d


def _same_result(got, want, nev, rtol=1e-10):
    assert got.n_iter == want.n_iter and got.info == want.info
    assert got.nconv == want.nconv
    np.testing.assert_allclose(got.ritz[:nev], want.ritz[:nev], rtol=rtol)
    for f in SOLVE_COUNTS:
        assert int(getattr(got.stats, f)) == int(getattr(want.stats, f)), f


@pytest.mark.parametrize("which", ["LA", "SA", "BE"])
def test_fused_dgks_matches_reference(which):
    # the port's dgks device loop against the reference's fused dgks solve
    # from the same start vector, float64: values within 1e-10*|lambda|,
    # counters equal
    jop, pop, jcfg, pcfg, _ = _diag_problem(which)
    v0 = np.random.default_rng(3).uniform(-1, 1, 300)
    want = jsym.FusedSymSolver(jop, jcfg).solve(v0=v0)
    solver = psym.FusedSymSolver(pop, pcfg)
    got = solver.solve(v0=v0)
    assert got.stats.packets == got.n_iter > 1
    _same_result(got, want, jcfg.nev)


def test_dgks_boundary_resumes_in_reference(tmp_path):
    # the port's dgks device loop stopped at a multi boundary (the deferred
    # restart applied), dumped; the reference resumes the file to the
    # port's unbroken solve
    jop, pop, jcfg, pcfg, _ = _diag_problem()
    want = psym.FusedSymSolver(pop, pcfg).solve()
    s = psym.FusedSymSolver(pop, pcfg)
    out = s.multi(s.init_state(), 2)
    assert out.state.iter == 2 and not out.done
    assert out.state.k == out.state.nev_cur < pcfg.ncv
    path = tmp_path / "boundary.npz"
    pck.save_state(path, out.state, pcfg)
    jst, _ = jck.load_state(path, cfg=jcfg)
    got = jsym.FusedSymSolver(jop, jcfg).solve(state=jst)
    _same_result(got, want, pcfg.nev)


def test_reference_dgks_dump_resumes_on_device_loop(tmp_path):
    # the reference's fused dgks loop dumps at a dispatch boundary (2
    # cycles); the port's dgks device loop resumes the file as the
    # reference resumes its own state
    jop, pop, jcfg, pcfg, d = _diag_problem()
    js = jsym.FusedSymSolver(jop, jcfg, cycles_per_dispatch=2)
    out = js._multi(js.init_state(), jnp.int32(2), jnp.int32(jcfg.max_iter))
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


def test_dgks_device_loop_on_two_ranks(tmp_path):
    # a gloo world of 2: the dgks device loop on each rank's rows equals
    # the unsharded solve (counters exactly, values within 1e-10), the
    # ranks agree bit for bit, and the pass that now runs on every step
    # keeps the all-reduces per step bounded
    rng = np.random.default_rng(11)
    d = np.sort(rng.uniform(1.0, 100.0, 600))
    v0 = rng.standard_normal(600)
    out = run_world(2, ["dgks_loop"], tmp_path,
                    {"dgks_loop": (d, v0)})["dgks_loop"]
    for r in out:
        assert "error" not in r, r.get("error")
        m, s = r["mesh"], r["single"]
        assert not m["host_loop"] and m["packets"] == m["n_iter"]
        assert m["counts"] == s["counts"] and m["n_iter"] == s["n_iter"]
        assert m["nconv"] == s["nconv"] >= 4
        np.testing.assert_allclose(m["ritz"], s["ritz"], rtol=1e-10)
        steps = m["counts"][0] - 1
        assert steps < m["collectives"]["all_reduce"] <= 8 * steps
    np.testing.assert_array_equal(out[0]["mesh"]["ritz"],
                                  out[1]["mesh"]["ritz"])
    np.testing.assert_allclose(np.sort(out[0]["mesh"]["ritz"][:4]),
                               np.sort(d)[-4:], rtol=1e-10)
