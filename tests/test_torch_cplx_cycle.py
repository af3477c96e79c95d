"""The complex reduced space as one kernel launch
(``ops/cuda_cplx_cycle.py``; its plain twin here, the kernel of
``csrc/cplx_cycle.cu`` on the card) and ``FusedNonsymSolver``
(``eigs(strategy='fused')``) on the shared device restart loop
(``core/loop._DeviceLoop``), on the CPU, against the numpy code the host
loop ran before, the host loop's head and tail, and the JAX package on
the same numpy inputs.

Tolerances: in complex128 the twin equals the former host code bit for
bit (the same numpy operations in the same order) and the host head and
tail everything equal (a check of the packet's layout and the restart's
bookkeeping, in complex64 too); against the JAX package's
``make_cplx_cycle`` the counts equal and the gaps of ``chip_smoke.
_cx_gaps`` within ``CX_LIMITS['torch.complex128']`` (two QR
implementations of the same sweeps: the sorted values within 1e-12 of
their largest, each within one place of its sorted position, where a
conjugate pair ties up to rounding); solves against the JAX package's
driver in complex128: the counters equal and the values within
1e-10 |lambda|; against the host loop, bit for bit, in complex64 and
complex128.

* (a) one cycle's reduced space on Hessenberg matrices of ncv 4-20 (a
  complex matrix, the convection-diffusion matrix from a complex and
  from a real start, a uniformly random Hessenberg, zero-bound unwanted
  values, a done cycle, a last cycle);
* (b) the device loop against the host loop and the JAX package's driver;
* (c) ``multi`` for n cycles, then a resume, equals the unbroken solve;
* (d) a failed refinement (``REDO``) and a breakdown equal the host loop;
* (e) the packet's layout, the shared-memory rule, the wrapper's
  checks."""
import dataclasses
import functools
import sys
from pathlib import Path

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
from arpack_ng_tpu.core import device_nonsym as jdn  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402
from arpack_ng_tpu_torch.config import IRAMConfig as PConfig  # noqa: E402
from arpack_ng_tpu_torch.core import arnoldi as parn  # noqa: E402
from arpack_ng_tpu_torch.core import device_nonsym as pdn  # noqa: E402
from arpack_ng_tpu_torch.core.iram import HostLoopSolver  # noqa: E402
from arpack_ng_tpu_torch.ops import cuda_cplx_cycle as ccc  # noqa: E402
from arpack_ng_tpu_torch.utils.stats import OpCounts  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (its Hessenbergs and gaps)

COUNTS = ("nopx", "nbx", "nrorth", "nitref", "nrstrt", "nrotr")
N = 64           # the carrier operator's dimension (ncv <= 20 < N)
EPS = float(np.finfo(np.float64).eps)
EPS23 = EPS ** (2 / 3)


# ---- (a) one cycle's reduced space -----------------------------------------

def _params(which, nev, tol, dtype=np.complex128):
    return chip_smoke._cx_params(
        ccc, "torch.complex64" if dtype == np.complex64
        else "torch.complex128", which, nev, tol=tol)


def _twin(H, rnorm, p, is_last, dtype=np.complex128):
    """The kernel's wrapper on CPU tensors (the twin): ``(H, Q, sk,
    packet)`` in complex128 / float64."""
    dt = torch.complex64 if dtype == np.complex64 else torch.complex128
    return chip_smoke._cx_run(torch, ccc, H, rnorm, dt, torch.device("cpu"),
                              p, is_last)


def _former(H, rnorm, which, nev, tol, is_last):
    """The host loop's reduced space as it ran before the kernel (the
    parent's ``make_cplx_head`` / ``make_cplx_tail`` in complex128, their
    numpy operations in their order, less the extension and the basis
    rotation): ``(r_s, b_s, nconv, done, nev_eff, np_eff, Hc, Q)``, Hc
    and Q None for an exit."""
    ncv = H.shape[0]
    np0 = ncv - nev
    cdt, rdt = np.dtype(np.complex128), np.dtype(np.float64)
    tol, eps23 = rdt.type(tol), rdt.type(EPS23)
    T, Qs = ccc.make_hessenberg_schur(ncv, cdt, sweeps=4 * ncv)(H)
    lam = np.diag(T)
    bounds = (rdt.type(rnorm) * ccc.make_last_components(ncv, cdt)(T, Qs)
              ).astype(rdt)
    order = np.argsort(ccc.which_key(which, lam), kind="stable")
    r_s, b_s = lam[order], bounds[order]
    wanted, wb = r_s[np0:], b_s[np0:]
    nconv = int(np.sum(wb <= tol * np.maximum(eps23, np.abs(wanted))))
    nz = int(np.sum(b_s[:np0] == 0))
    np_eff, nev_eff = np0 - nz, nev + nz
    done = nconv >= nev or np_eff == 0
    nev_inf = nev_eff + min(nconv, np_eff // 2)
    if nev_inf == 1 and ncv >= 6:
        nev_inf = ncv // 2
    elif nev_inf == 1 and ncv > 3:
        nev_inf = 2
    nev_eff = min(nev_inf, ncv - 1)
    np_eff = ncv - nev_eff
    head = (r_s, b_s, nconv, done, nev_eff, np_eff)
    if done or is_last:
        return head + (None, None)
    iota = np.arange(ncv)
    eyek = np.eye(ncv, dtype=cdt)
    active = (iota < np_eff)[:np0]
    skey = np.where(active, -np.abs(b_s[:np0]), rdt.type(np.inf))
    shifts = r_s[:np0][np.argsort(skey, kind="stable")]
    Hc, Q = H.astype(cdt), eyek
    for mu, act in zip(shifts, active):
        if not act:
            continue
        q, _ = np.linalg.qr(Hc - mu * eyek)
        Hc, _ = ccc.deflate(np.triu(q.conj().T @ Hc @ q, -1), rdt.type(EPS))
        Q = Q @ q
    return head + (Hc, Q)


def _random_hessenberg(ncv, seed):
    rng = np.random.default_rng(seed)
    H = np.triu(rng.standard_normal((ncv, ncv))
                + 1j * rng.standard_normal((ncv, ncv)), -1)
    i = np.arange(1, ncv)
    H[i, i - 1] = np.abs(H[i, i - 1])
    return H


def _case(name):
    """(H, rnorm, which, nev, tol, is_last, what the packet must show)."""
    if name.startswith("arnoldi"):
        _, source, ncv, which, seed = name.split("-")
        H, rn = chip_smoke._cx_hessenberg(int(ncv), int(seed), source, nx=10)
        return H, rn, which, max(2, int(ncv) // 4), 1e-10, False, {}
    if name.startswith("uniform"):
        _, ncv, which = name.split("-")
        return (_random_hessenberg(int(ncv), int(ncv)), 0.5, which,
                max(2, int(ncv) // 4), 1e-10, False, {})
    if name == "zero-bounds":
        # H split after row 3: its top block's values (the least wanted
        # under LM) have bounds exactly 0 and cannot be shifted
        rng = np.random.default_rng(4)
        H = np.zeros((12, 12), np.complex128)
        H[:3, :3] = np.triu(0.1 * _random_hessenberg(3, 5), -1)
        H[3:, 3:] = np.triu(_random_hessenberg(9, 6), -1) + 5 * np.eye(9)
        H[:3, 3:] = rng.standard_normal((3, 9))
        return H, 1.0, "LM", 4, 1e-14, False, dict(zeros=3)
    if name == "done":
        H, rn = chip_smoke._cx_hessenberg(16, 3, "convdiff", nx=10)
        return H, rn, "LR", 4, 0.5, False, dict(done=1)
    if name == "last":
        H, rn = chip_smoke._cx_hessenberg(16, 5, "realified", nx=10)
        return H, rn, "SR", 4, 1e-10, True, dict(done=0)
    raise KeyError(name)


CASES = ["arnoldi-complex-12-LM-1", "arnoldi-convdiff-16-SR-2",
         "arnoldi-realified-20-LI-3", "arnoldi-complex-8-SM-4",
         "arnoldi-convdiff-10-LR-5", "arnoldi-realified-12-SI-6",
         "uniform-4-LM", "uniform-14-LR", "zero-bounds", "done", "last"]


@pytest.mark.parametrize("name", CASES)
def test_twin_equals_former_host_code(name):
    # complex128: the twin runs the former host loop's numpy operations in
    # their order, so every output is bit for bit the same
    H, rn, which, nev, tol, is_last, want = _case(name)
    ncv = H.shape[0]
    t = _twin(H, rn, _params(which, nev, tol), is_last)
    pk, P = t[3], ccc.P_HEAD
    r_s, b_s, nconv, done, nev_eff, np_eff, Hc, Q = _former(
        H, rn, which, nev, tol, is_last)
    assert (bool(pk[ccc.P_DONE]), int(pk[ccc.P_NCONV]), int(pk[ccc.P_NEV]),
            int(pk[ccc.P_NP])) == (done, nconv, nev_eff, np_eff)
    np.testing.assert_array_equal(pk[P:P + ncv], r_s.real)
    np.testing.assert_array_equal(pk[P + ncv:P + 2 * ncv], r_s.imag)
    np.testing.assert_array_equal(pk[P + 2 * ncv:P + 3 * ncv], b_s)
    if "zeros" in want:
        assert np.count_nonzero(b_s[:ncv - nev] == 0) == want["zeros"]
        assert (nev_eff, np_eff) == (nev + 3, ncv - nev - 3)
    if "done" in want:
        assert done == bool(want["done"])
    if Hc is None:
        # no shifts: H, Q and sk untouched, the packet's H the input's
        np.testing.assert_array_equal(t[0], H)
        assert not t[1].any() and not t[2].any()
        np.testing.assert_array_equal(
            pk[P + 3 * ncv:], np.stack([H.real, H.imag], -1).ravel())
        return
    np.testing.assert_array_equal(t[0], Hc)
    np.testing.assert_array_equal(t[1], Q)
    np.testing.assert_array_equal(
        t[2], [Q[ncv - 1, nev_eff - 1], Hc[nev_eff, nev_eff - 1]])
    np.testing.assert_array_equal(
        pk[P + 3 * ncv:], np.stack([Hc.real, Hc.imag], -1).ravel())


def _carrier(ncv, nev, which, tol, dtype):
    """A port operator and config of N rows for a state whose H is given
    (the extension then has nothing to do), and the identity-padded basis:
    the restart writes Q^T into its first ncv columns."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    op = pt.from_dense(a.astype(dtype), n_pad=pt.pad_dim(N), device="cpu")
    cfg = PConfig(n=N, nev=nev, ncv=ncv, which=which, symmetric=False,
                  dtype=np.dtype(dtype), n_pad=op.n_pad, tol=tol)
    V = np.zeros((ncv, op.n_pad), dtype)
    V[np.arange(ncv), np.arange(ncv)] = 1.0
    r = np.zeros(op.n_pad, dtype)
    r[ncv] = 1.0
    return a, op, cfg, V, r


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("name", ["arnoldi-convdiff-16-LM-1",
                                  "arnoldi-realified-12-SR-2", "done",
                                  "last"])
def test_twin_matches_host_head_tail(name, dtype):
    # the packet's layout and the restart's bookkeeping: the twin's packet,
    # H, Q and sk against what the host head and tail leave in the
    # solver's state (both run the same numpy arithmetic in complex128;
    # complex64 rounds H, Q and sk alike)
    H, rn, which, nev, tol, is_last, _ = _case(name)
    H = H.astype(dtype)
    rn = np.finfo(dtype).dtype.type(rn)
    ncv = H.shape[0]
    t = _twin(H, rn, _params(which, nev, tol, dtype), is_last, dtype)
    pk, P = t[3], ccc.P_HEAD
    _, op, cfg, V, r = _carrier(ncv, nev, which, tol, dtype)
    resid = torch.tensor(r)
    st = parn.FactorizationState(
        V=torch.tensor(V), H=H.copy(), resid=resid, b_resid=resid,
        rnorm=rn, k=ncv, nev_cur=nev, iter=0, info=0,
        gen=torch.Generator(), counts=OpCounts())
    h = pdn.make_cplx_head(op, cfg)(st)
    out = pdn.make_cplx_tail(op, cfg)(h, is_last)
    assert list(pk[ccc.P_CNT:ccc.P_CNT + 4]) == [3, 1, 2, 0]
    assert pk[ccc.P_BRK] == -1 and pk[ccc.P_RNORM] == rn
    assert (bool(pk[ccc.P_DONE]), int(pk[ccc.P_NCONV]), int(pk[ccc.P_NEV]),
            int(pk[ccc.P_NP])) == (h.done, h.nconv, h.nev_eff, h.np_eff)
    np.testing.assert_array_equal(pk[P:P + ncv] + 1j * pk[P + ncv:P + 2 * ncv],
                                  h.r_s)
    np.testing.assert_array_equal(pk[P + 2 * ncv:P + 3 * ncv], h.b_s)
    if h.done or is_last:
        np.testing.assert_array_equal(t[0], H)
        assert out.state.k == ncv and out.state.iter == 1
        return
    k = h.nev_eff
    assert out.state.k == k
    rows = parn.kev_rows(ncv, k)
    np.testing.assert_array_equal(out.state.V.numpy()[:rows, :ncv].T,
                                  t[1][:, :rows])
    np.testing.assert_array_equal(out.state.H, t[0])
    np.testing.assert_array_equal(
        pk[P + 3 * ncv:], np.stack([t[0].real, t[0].imag], -1).ravel())
    assert t[2][0] == t[1][ncv - 1, k - 1] == out.state.resid[ncv]
    assert t[2][1] == t[0][k, k - 1]
    tol_u = 1e-12 if dtype == np.complex128 else 1e-6
    np.testing.assert_allclose(t[1].conj().T @ t[1], np.eye(ncv), atol=tol_u)


@functools.lru_cache(maxsize=None)
def _reference_cycle(ncv, nev, which, tol):
    """The JAX package's cycle for the carrier of one configuration, jitted
    once (the cases share it), and a start state to fill."""
    a = _carrier(ncv, nev, which, tol, np.complex128)[0]
    opj = at.from_dense(a, n_pad=at.pad_dim(N))
    cj = JConfig(n=N, nev=nev, ncv=ncv, which=which, symmetric=False,
                 dtype=np.dtype(np.complex128), n_pad=opj.n_pad, tol=tol)
    return (jarn.make_init(opj, cj)(jax.random.key(0), None),
            jax.jit(jdn.make_cplx_cycle(opj, cj)))


def _reference(H, rnorm, which, nev, tol, is_last):
    """The JAX package's cycle on a state with k = ncv, as the kernel's
    ``(H, Q, sk, packet)``."""
    ncv = H.shape[0]
    _, _, _, V, r = _carrier(ncv, nev, which, tol, np.complex128)
    st, cycle = _reference_cycle(ncv, nev, which, tol)
    st = st._replace(V=jnp.asarray(V.reshape(st.V.shape)), H=jnp.asarray(H),
                     resid=jnp.asarray(r), b_resid=jnp.asarray(r),
                     rnorm=jnp.float64(rnorm), k=jnp.int32(ncv),
                     nev_cur=jnp.int32(nev))
    out = jax.device_get(cycle(st, jnp.bool_(is_last)))
    k = int(out.state.k)
    P = ccc.P_HEAD
    pk = np.zeros(ccc.packet_size(ncv))
    pk[ccc.P_DONE], pk[ccc.P_NCONV] = bool(out.done), int(out.nconv)
    pk[ccc.P_NEV], pk[ccc.P_NP] = k, ncv - k
    pk[P:P + ncv] = np.real(out.ritz_s)
    pk[P + ncv:P + 2 * ncv] = np.imag(out.ritz_s)
    pk[P + 2 * ncv:P + 3 * ncv] = out.bounds_s
    Hr = np.asarray(out.state.H)
    Q = np.zeros((ncv, ncv), np.complex128)
    if k < ncv:
        Vr = np.asarray(out.state.V).reshape(ncv, -1)
        rows = parn.kev_rows(ncv, k)
        Q[:, :rows] = Vr[:rows, :ncv].T
    return [Hr, Q, np.array([Q[ncv - 1, k - 1], Hr[min(k, ncv - 1), k - 1]]),
            pk]


@pytest.mark.parametrize("name", ["arnoldi-complex-12-LM-1",
                                  "arnoldi-realified-12-LM-3"])
def test_twin_matches_reference_cycle(name):
    # complex128: the twin against the JAX package's make_cplx_cycle on
    # the same H (one configuration, so one compile), with chip_smoke's
    # gaps: the counts equal, every gap within CX_LIMITS and none exempt
    # (these inputs are well conditioned), the restart's Arnoldi relation
    # kept, the kept block's values the kept Ritz values (the exits are
    # held against the host code in the tests above)
    H, rn, which, nev, tol, is_last, _ = _case(name)
    t = _twin(H, rn, _params(which, nev, tol), is_last)
    ref = _reference(H, rn, which, nev, tol, is_last)
    p = _params(which, nev, tol)
    g = chip_smoke._cx_gaps(ccc, t, ref, H, p)
    assert g.pop("counts_equal")
    g.pop("same_order")
    lim = chip_smoke.CX_LIMITS["torch.complex128"]
    faults, _, exempt = chip_smoke._cx_faults(g, lim, chip_smoke._cx_cond(H))
    assert not faults and not exempt, (faults, exempt, g)
    assert g["relation"] <= 1e-12 and g["twin_relation"] <= 1e-12
    assert g["kept"] <= lim["kept"] and g["twin_kept"] <= lim["kept"]


# ---- (b) the device loop ----------------------------------------------------

def _v0(n, seed=0, cplx=False):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, n)
    return v + 1j * rng.uniform(-1, 1, n) if cplx else v


def _problem(name, dtype=np.complex128):
    """(port operator, JAX operator or None, scipy matrix) of a small
    complex problem: the complexified real conv-diff, the complex conv-diff
    stencil, or a dense random complex matrix."""
    if name == "realified":
        real = np.float64 if dtype == np.complex128 else np.float32
        op, a = pmodels.convection_diffusion_2d(10, rho=100.0, dtype=real,
                                                device="cpu")
        opj = None
        if dtype == np.complex128:
            opj = jdn.complexify_operator(jmodels.convection_diffusion_2d(
                10, rho=100.0, dtype=np.float64)[0])
        return pdn.complexify_operator(op), opj, a
    if name == "stencil":
        op, a = pmodels.convection_diffusion_2d(10, dtype=dtype, device="cpu")
        return op, None, a
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((80, 80)) + 1j * rng.standard_normal((80, 80))
         ) / np.sqrt(80)
    op = pt.from_dense(a.astype(dtype), n_pad=pt.pad_dim(80), device="cpu")
    return op, at.from_dense(a, n_pad=at.pad_dim(80)), a


def _cfg(op, nev, ncv, which, tol, cls=PConfig, max_iter=400):
    return cls(n=op.n, nev=nev, ncv=ncv, which=which, symmetric=False,
               dtype=np.dtype(op.dtype), n_pad=op.n_pad, tol=tol,
               max_iter=max_iter)


def _same_as_host(got, host):
    np.testing.assert_array_equal(got.ritz, host.ritz)
    np.testing.assert_array_equal(got.bounds, host.bounds)
    assert got.n_iter == host.n_iter and got.nconv == host.nconv
    for f in COUNTS:
        assert getattr(got.stats, f) == getattr(host.stats, f), f
    np.testing.assert_array_equal(got.state.H, host.state.H)
    assert torch.equal(got.state.V, host.state.V)
    assert torch.equal(got.state.resid, host.state.resid)


@pytest.mark.parametrize("problem,which,reference", [
    ("realified", "LM", True), ("stencil", "LM", False),
    ("dense", "LI", True)])
def test_device_loop_matches_reference_and_host_loop(problem, which,
                                                     reference):
    # complex128: the device loop (the twin's reduced space on the CPU)
    # against the host loop over the numpy head and tail (the witness) bit
    # for bit, and against the JAX package's fused driver from the same
    # start vector: counters equal, the wanted values within 1e-10 |lambda|
    # as sets (the members of a conjugate pair tie up to rounding, so their
    # exit order follows the last bits; tests/test_torch_fused_nonsym.py
    # holds the stencil's kind against the reference through eigs)
    op, opj, _ = _problem(problem)
    cp = _cfg(op, 4, 20, which, 1e-10)
    v0 = _v0(op.n, cplx=problem != "realified")
    s = pdn.FusedNonsymSolver(op, cp)
    assert not s._host_loop
    got = s.solve(v0=v0)
    assert got.stats.packets == got.n_iter > 1
    assert got.stats.graphs_captured == 0   # no card, no graph
    assert ccc.cplx_cycle.launches == 0
    host = HostLoopSolver.solve(pdn.FusedNonsymSolver(op, cp), v0=v0)
    assert host.stats.packets == 0
    _same_as_host(got, host)
    if not reference:
        return
    want = jdn.FusedNonsymSolver(opj, _cfg(opj, 4, 20, which, 1e-10,
                                           JConfig)).solve(v0=v0)
    assert got.n_iter == want.n_iter and got.info == want.info
    assert got.nconv == want.nconv >= 4
    for f in COUNTS:
        assert int(getattr(got.stats, f)) == int(getattr(want.stats, f)), f
    lam = np.asarray(got.ritz[:4])
    gap = np.abs(lam[:, None] - np.asarray(want.ritz[:4])[None, :])
    assert gap.min(axis=1).max() <= 1e-10 * np.max(np.abs(lam))


@pytest.mark.parametrize("problem", ["realified", "stencil"])
def test_complex64_device_loop_equals_host_loop(problem):
    # complex64 (float32 input complexified, the complex64 stencil): the
    # device loop and the host loop run the same complex128 reduced space
    # and round H, Q and sk alike, so they agree bit for bit; residuals of
    # the extracted pairs under 1e-3
    op, _, a = _problem(problem, np.complex64)
    cp = _cfg(op, 4, 16, "LM", 1e-5)
    v0 = _v0(op.n, cplx=problem == "stencil")
    got = pdn.FusedNonsymSolver(op, cp).solve(v0=v0)
    assert got.stats.packets == got.n_iter > 1
    host = HostLoopSolver.solve(pdn.FusedNonsymSolver(op, cp), v0=v0)
    _same_as_host(got, host)
    vals, vecs = pt.eigs(a.astype(np.float32 if problem == "realified"
                                  else np.complex64), k=4, ncv=16, tol=1e-5,
                         strategy="fused", v0=v0, device="cpu")
    r = np.linalg.norm(a @ vecs - vecs * vals, axis=0) / np.abs(vals)
    assert len(vals) == 4 and r.max() < 1e-3


# ---- (c) multi and resume ---------------------------------------------------

@pytest.mark.parametrize("cut", [1, 3])
def test_multi_then_resume_equals_unbroken(cut):
    # n cycles through multi (the deferred restart applied at the
    # boundary), then a fresh solver resumes the state: the unbroken
    # solve's counters, values and basis bit for bit
    op, _, _ = _problem("stencil")
    cp = _cfg(op, 4, 14, "LM", 1e-10)
    v0 = _v0(op.n, cplx=True)
    want = pdn.FusedNonsymSolver(op, cp).solve(v0=v0)
    s = pdn.FusedNonsymSolver(op, cp)
    out = s.multi(s.init_state(v0=v0), cut)
    st = out.state
    assert st.iter == cut and not out.done and st.k == st.nev_cur < cp.ncv
    got = pdn.FusedNonsymSolver(op, cp).solve(state=st)
    assert got.stats.packets == got.n_iter - cut
    assert got.n_iter == want.n_iter and got.nconv == want.nconv
    np.testing.assert_array_equal(got.ritz, want.ritz)
    for f in COUNTS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert torch.equal(got.state.V, want.state.V)


def test_multi_to_the_exit_and_config_checks():
    # a multi run that reaches the exit hands back the exit's state as
    # solve does; multi(0) hands back the start; the driver refuses real
    # dtypes and caller shifts
    op, _, _ = _problem("dense")
    cp = _cfg(op, 3, 12, "LR", 1e-8)
    v0 = _v0(op.n, cplx=True)
    want = pdn.FusedNonsymSolver(op, cp).solve(v0=v0)
    s = pdn.FusedNonsymSolver(op, cp)
    st = s.init_state(v0=v0)
    assert s.multi(st, 0).state is st
    out = s.multi(st, 10_000)
    assert out.done and out.state.iter == want.n_iter
    assert out.state.k == cp.ncv and out.nconv == want.nconv
    np.testing.assert_array_equal(out.state.H, want.state.H)
    for bad in (dict(dtype=np.dtype(np.float64)), dict(exact_shifts=False)):
        with pytest.raises(ValueError):
            pdn.FusedNonsymSolver(op, dataclasses.replace(cp, **bad))


# ---- (d) a failed refinement and a breakdown --------------------------------

def _eigvec_problem():
    d = np.linspace(1.0, 10.0, 60) * np.exp(0.3j)
    op = pt.from_diagonal(d, n_pad=pt.pad_dim(60), device="cpu")
    cfg = PConfig(n=60, nev=2, ncv=10, which="LM", symmetric=False,
                  dtype=np.dtype(np.complex128), n_pad=op.n_pad, tol=1e-10,
                  max_iter=300)
    v0 = np.zeros(op.n_pad, np.complex128)
    v0[0] = 1.0
    return op, cfg, v0


def test_redo_and_breakdown_equal_host_loop():
    # v0 = e_0 on a diagonal operator: the first step's residual is exactly
    # 0, both refinement passes fail (REDO) and the host reruns the
    # extension, drawing a restart vector; then a state whose residual is
    # 0 after its first step (a breakdown at step 1): in both the device
    # loop reads one more packet and equals the host loop
    op, cfg, v0 = _eigvec_problem()
    parn.reruns.update(redo=0, breakdown=0)
    dev = pdn.FusedNonsymSolver(op, cfg).solve(v0=v0)
    reruns = dict(parn.reruns)
    assert reruns["redo"] >= 1
    host = HostLoopSolver.solve(pdn.FusedNonsymSolver(op, cfg), v0=v0)
    assert dev.stats.nrstrt == host.stats.nrstrt == 1
    assert dev.stats.packets == dev.n_iter + sum(reruns.values())
    np.testing.assert_array_equal(dev.ritz, host.ritz)
    for f in COUNTS:
        assert getattr(dev.stats, f) == getattr(host.stats, f), f

    def entry(solver):
        st = solver._ext.stepwise(solver.init_state(v0=v0), 1)
        assert st.rnorm == 0 and st.k == 1
        return st

    s = pdn.FusedNonsymSolver(op, cfg)
    parn.reruns.update(redo=0, breakdown=0)
    dev = s.solve(state=entry(s))
    assert dict(parn.reruns) == {"redo": 0, "breakdown": 1}
    s = pdn.FusedNonsymSolver(op, cfg)
    host = HostLoopSolver.solve(s, state=entry(s))
    assert dev.stats.packets == dev.n_iter + 1
    np.testing.assert_array_equal(dev.ritz, host.ritz)
    for f in COUNTS:
        assert getattr(dev.stats, f) == getattr(host.stats, f), f


# ---- (e) the packet, the shared-memory rule, the wrapper's checks -----------

def test_packet_layout_and_shared_memory_rule():
    # the packet: the symmetric header, the sorted values' real and
    # imaginary parts and bounds, then H's (re, im) pairs; the workspace
    # of five complex ncv x ncv matrices, their rows ncv | 1 entries apart,
    # and 24 doubles per row fits one block's shared memory to ncv 52
    assert ccc.P_HEAD == 12
    assert ccc.packet_size(32) == 12 + 96 + 2048
    assert ccc.work_bytes(32) == (10 * 32 * 33 + 24 * 32) * 8
    assert ccc.work_bytes(53) == (10 * 53 * 53 + 24 * 53) * 8
    assert ccc.max_shared_ncv() == 52
    assert ccc.fits_shared(52) and not ccc.fits_shared(53)
    assert ccc.WHICH == {"LM": 0, "SM": 1, "LR": 2, "SR": 3, "LI": 4,
                         "SI": 5}


def test_wrapper_refuses_bad_buffers_and_leaves_a_breakdown():
    c = dict(dtype=torch.complex128)
    args = [torch.eye(8, **c), torch.tensor(1.0, dtype=torch.float64),
            torch.tensor(-1, dtype=torch.int32),
            torch.tensor(0, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int64), torch.zeros(8, 8, **c),
            torch.zeros(2, **c),
            torch.zeros(ccc.packet_size(8), dtype=torch.float64)]
    p = _params("LM", 3, 1e-10)
    for i, bad in ((0, torch.eye(8, dtype=torch.float64)),
                   (1, torch.tensor(1.0, dtype=torch.float32)),
                   (2, torch.tensor(-1, dtype=torch.int64)),
                   (5, torch.zeros(8, 8, dtype=torch.complex64)),
                   (6, torch.zeros(3, **c)),
                   (7, torch.zeros(5, dtype=torch.float64))):
        with pytest.raises((ValueError, TypeError)):
            ccc.cplx_cycle(*args[:i], bad, *args[i + 1:], p, False)
    for badp in (p._replace(which="LA"), p._replace(nev=8)):
        with pytest.raises(ValueError):
            ccc.cplx_cycle(*args, badp, False)
    with pytest.raises(ValueError, match="device"):
        ccc.cplx_cycle(*[a.to("meta") for a in args], p, False)
    # an extension that stopped short: only the header is written
    args[2] = torch.tensor(5, dtype=torch.int32)
    args[3] = torch.tensor(1, dtype=torch.int32)
    ccc.cplx_cycle(*args, p, False)
    pk = args[7].numpy()
    assert (pk[ccc.P_BRK], pk[ccc.P_FORCE], pk[ccc.P_RNORM]) == (5, 1, 1)
    assert not pk[ccc.P_HEAD:].any() and not args[5].any()
    assert torch.equal(args[0], torch.eye(8, **c))


def test_clocks_argument_checked_and_ignored_by_the_twin():
    # the optional stamp buffer: an int64 vector of clock_size(ncv) on H's
    # device, refused otherwise; the twin (CPU tensors) leaves it as it was
    # and writes what it writes without it
    H, rn = chip_smoke._cx_hessenberg(12, 0, "convdiff", nx=10)
    p = _params("LM", 3, 1e-10)
    size = ccc.clock_size(12)
    assert size == len(ccc.CLOCKS) + len(ccc.LAPS) + len(ccc.COUNTS) == 11
    assert ccc.LAPS == ("shift", "chain", "tail")

    def bufs():
        return chip_smoke._cx_buffers(torch, ccc, H, rn, torch.complex128,
                                      torch.device("cpu"))

    for bad in (torch.zeros(size + 1, dtype=torch.int64),
                torch.zeros(size, dtype=torch.int32),
                torch.zeros(size, dtype=torch.int64, device="meta")):
        with pytest.raises(ValueError, match="clocks"):
            ccc.cplx_cycle(*bufs(), p, False, clocks=bad)
    plain, stamped = bufs(), bufs()
    clk = torch.full((size,), 7, dtype=torch.int64)
    ccc.cplx_cycle(*plain, p, False)
    ccc.cplx_cycle(*stamped, p, False, clocks=clk)
    for a, b in zip(plain, stamped):
        assert torch.equal(a, b)
    assert torch.equal(clk, torch.full((size,), 7, dtype=torch.int64))


def test_compare_tool_cases_straddle_the_shared_memory_rule():
    # tools/cplx_cycle_compare.py holds the kernel at the last ncv whose
    # workspace fits one block's shared memory and the first past it, as
    # work_bytes gives them, beside 3, 8, 32, 48 and 100; every which, both
    # dtypes, every source of chip_smoke._cx_hessenberg, each early exit,
    # tiny complex128 inputs (the library's square root) and ncv 130 (past
    # the chain's registers)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import cplx_cycle_compare as tool
    m = max(n for n in range(2, 200)
            if ccc.work_bytes(n) <= ccc.reduced_space.MAX_SMEM)
    assert m == ccc.max_shared_ncv()
    assert tool.sizes() == tuple(sorted({3, 8, 32, 48, m, m + 1, 100}))
    assert {m, m + 1, 32} <= set(tool.timed())
    cases = tool._cases(tool.sizes())
    assert len({c[0] for c in cases}) == len(cases)
    assert {c[2] for c in cases} == {"complex64", "complex128"}
    assert {c[3] for c in cases} == set(ccc.WHICH)
    kinds = {c[0].rsplit("_", 1)[1] for c in cases if not c[0][-1].isdigit()}
    assert kinds == {"brk", "done", "last", "sweeps", "tiny", "wide"}
    assert {c[2] for c in cases if c[0].endswith("_tiny")} == {"complex128"}
    assert {c[1].rstrip("0123456789_") for c in cases} == set(
        chip_smoke.CX_SOURCES)
