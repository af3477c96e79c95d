"""The real non-symmetric reduced space as one kernel launch
(``ops/cuda_realnonsym_cycle.py``; its plain twin here, the kernel of
``csrc/realnonsym_cycle.cu`` on the card) and ``FusedRealNonsymSolver`` on
the shared device restart loop (``core/device_sym._DeviceLoop``), on the
CPU, against the host loop's numpy head and tail and the JAX package on
the same numpy inputs.

Tolerances (float64): against the host head and tail, everything equal;
against the JAX package's cycle, the counts equal, the sorted Ritz values
and bounds within 1e-12 of their largest, the kept columns of Q within
1e-10 and of H within (1e-12 + 2 dQ) max|H0| (two QR chases of the same
matrices, forward unstable near an exact shift's deflation); the
restart's Arnoldi relation ``Q^T H0 Q = Hc`` in the kept columns within
1e-12 max|H0| (the reference's too where it keeps its chase) on
Arnoldi Hessenbergs and within the chase's own guard, eps^(2/3) max|H0|,
on uniformly random Hessenbergs, whose exact shifts meet near-zero
pivots; solves against the JAX package's driver: the counters equal and
the values within 1e-10 |lambda|; against the host loop, bit for bit.

* (a) on Hessenberg matrices of ncv 6-40 (a pair straddling np0, a pair
  straddling the moved boundary: kev grows, and the np_eff <= 1 rule;
  zero-bound unwanted values, a done cycle, a last cycle, a chase that
  trips the guard), every case against the JAX package's
  ``make_realnonsym_cycle``, and the twin's packet, H, Q and sk against
  what the host head and tail leave in the solver's state (a check of the
  packet's layout and the restart's bookkeeping: both run the same
  numpy arithmetic);
* (b) the device loop against the JAX package's ``FusedRealNonsymSolver``
  and against the host loop (``HostLoopSolver.solve``);
* (c) ``multi`` for n cycles, then a resume, equals the unbroken solve,
  here and in the JAX package;
* (d) a failed refinement (``REDO``) and its restart vector equal the host
  loop;
* (e) a gloo world of 2 equals one process."""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import arpack_ng_tpu as at  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.config import IRAMConfig as JConfig  # noqa: E402
from arpack_ng_tpu.core import arnoldi as jarn  # noqa: E402
from arpack_ng_tpu.core import device_realnonsym as jdrn  # noqa: E402
from arpack_ng_tpu.io import checkpoint as jck  # noqa: E402
from arpack_ng_tpu.ops import sparse as jsparse  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402
from arpack_ng_tpu_torch.config import IRAMConfig as PConfig  # noqa: E402
from arpack_ng_tpu_torch.core import arnoldi as parn  # noqa: E402
from arpack_ng_tpu_torch.core import device_realnonsym as pdrn  # noqa: E402
from arpack_ng_tpu_torch.core.iram import HostLoopSolver  # noqa: E402
from arpack_ng_tpu_torch.io import checkpoint as pck  # noqa: E402
from arpack_ng_tpu_torch.ops import cuda_realnonsym_cycle as crc  # noqa
from arpack_ng_tpu_torch.utils.stats import OpCounts  # noqa: E402

from torch_mp_worker import run_world  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (its Arnoldi Hessenbergs)

COUNTS = ("nopx", "nbx", "nrorth", "nitref", "nrstrt", "nrotr")
N = 128          # the carrier operator's dimension (ncv <= 40 < N)
EPS = float(np.finfo(np.float64).eps)
EPS23 = EPS ** (2 / 3)


# ---- (a) one cycle's reduced space -----------------------------------------

def _with_spectrum(vals, seed):
    """An upper Hessenberg matrix with the given spectrum (real values and
    conjugate pairs given by their +imaginary member): a block-diagonal
    real matrix under a seeded non-orthogonal similarity, reduced to
    Hessenberg form."""
    rng = np.random.default_rng(seed)
    blocks = []
    for v in vals:
        if np.imag(v) == 0:
            blocks.append(np.array([[np.real(v)]]))
        else:
            a, b = np.real(v), np.imag(v)
            blocks.append(np.array([[a, b], [-b, a]]))
    D = sla.block_diag(*blocks)
    k = D.shape[0]
    S = np.linalg.qr(rng.standard_normal((k, k)))[0] \
        + 0.1 * rng.standard_normal((k, k))
    return sla.hessenberg(S @ D @ np.linalg.inv(S))


def _random_hessenberg(ncv, seed):
    rng = np.random.default_rng(seed)
    H = np.triu(rng.standard_normal((ncv, ncv)), -1)
    i = np.arange(1, ncv)
    H[i, i - 1] = np.abs(H[i, i - 1])
    return H


def _params(which, nev, tol):
    return crc.Params(which=which, nev=nev, tol=tol, eps23=EPS23, eps_m=EPS,
                      safmin=float(np.finfo(np.float64).tiny))


def _twin(H, rnorm, p, is_last):
    """The kernel's wrapper on CPU tensors (the twin)."""
    ncv = H.shape[0]
    f = dict(dtype=torch.float64)
    bufs = [torch.tensor(H, **f), torch.tensor(rnorm, **f),
            torch.tensor(-1, dtype=torch.int32),
            torch.tensor(0, dtype=torch.int32),
            torch.tensor([3, 1, 2, 0], dtype=torch.int64),
            torch.zeros(ncv, ncv, **f), torch.zeros(2, **f),
            torch.zeros(crc.packet_size(ncv), **f)]
    crc.realnonsym_cycle(*bufs, p, is_last)
    return dict(H=bufs[0].numpy(), Q=bufs[5].numpy(), sk=bufs[6].numpy(),
                pk=bufs[7].numpy())


def _carrier(ncv, nev, which, tol):
    """A port operator and config of N rows for a state whose H is given
    (the extension then has nothing to do), and the identity-padded basis:
    the restart writes Q^T into its first ncv columns."""
    a = np.random.default_rng(9).standard_normal((N, N))
    op = pt.from_dense(a, n_pad=pt.pad_dim(N), device="cpu")
    cfg = PConfig(n=N, nev=nev, ncv=ncv, which=which, symmetric=False,
                  dtype=np.dtype(np.float64), n_pad=op.n_pad, tol=tol)
    V = np.zeros((ncv, op.n_pad))
    V[np.arange(ncv), np.arange(ncv)] = 1.0
    r = np.zeros(op.n_pad)
    r[ncv] = 1.0
    return a, op, cfg, V, r


def _host(H, rnorm, which, nev, tol, is_last):
    """The host loop's head and tail on a state with k = ncv."""
    ncv = H.shape[0]
    _, op, cfg, V, r = _carrier(ncv, nev, which, tol)
    resid = torch.tensor(r)
    st = parn.FactorizationState(
        V=torch.tensor(V), H=H.copy(), resid=resid, b_resid=resid,
        rnorm=np.float64(rnorm), k=ncv, nev_cur=nev, iter=0, info=0,
        gen=torch.Generator(), counts=OpCounts())
    h = pdrn.make_realnonsym_head(op, cfg)(st)
    out = pdrn.make_realnonsym_tail(op, cfg)(h, is_last)
    return h, out


def _reference(H, rnorm, which, nev, tol, is_last):
    """The JAX package's cycle on a state with k = ncv."""
    ncv = H.shape[0]
    a, _, _, V, r = _carrier(ncv, nev, which, tol)
    opj = at.from_dense(a, n_pad=at.pad_dim(N))
    cj = JConfig(n=N, nev=nev, ncv=ncv, which=which, symmetric=False,
                 dtype=np.dtype(np.float64), n_pad=opj.n_pad, tol=tol)
    st = jarn.make_init(opj, cj)(jax.random.key(0), None)
    st = st._replace(V=jnp.asarray(V.reshape(st.V.shape)), H=jnp.asarray(H),
                     resid=jnp.asarray(r), b_resid=jnp.asarray(r),
                     rnorm=jnp.float64(rnorm), k=jnp.int32(ncv),
                     nev_cur=jnp.int32(nev))
    out = jax.jit(jdrn.make_realnonsym_cycle(opj, cj))(st, jnp.bool_(is_last))
    return jax.device_get(out)


def _relation(H0, Q, Hc, k):
    """The restart's Arnoldi relation in the kept columns, ``H0 Q_k =
    Q_{k+1} Hc[:k+1, :k]`` (Hc is Hessenberg), from Q's first k + 1
    columns."""
    return np.max(np.abs(H0 @ Q[:, :k] - Q[:, :k + 1] @ Hc[:k + 1, :k]))


def _guard_input():
    """The (H, rnorm) of the cycle whose explicit chase loses the
    Hessenberg form on test_torch_eigs.test_step_the_reference_breaks's
    problem (conv-diff nx = 10, LR, ncv = 24, tol = 1e-10)."""
    from unittest import mock
    seen = []
    real = pdrn.realnonsym_cycle

    def spy(H, rnorm, brk, force, cnt, Q, sk, packet, p, is_last):
        H0 = H.numpy().copy()
        real(H, rnorm, brk, force, cnt, Q, sk, packet, p, is_last)
        if packet[crc.P_IMPL] and not seen:
            seen.append((H0, float(rnorm)))

    op, _ = pmodels.convection_diffusion_2d(10, dtype=np.float64,
                                            device="cpu")
    with mock.patch.object(pdrn, "realnonsym_cycle", spy):
        pt.eigs(op, k=6, which="LR", ncv=24, tol=1e-10, maxiter=500,
                v0=np.random.default_rng(0).uniform(-1, 1, 100))
    return seen[0]


def _convdiff_dense(nx, rho=50.0):
    _, a = pmodels.convection_diffusion_2d(nx, rho=rho, dtype=np.float64,
                                           device="cpu")
    return a.toarray()


def _case(name):
    """(H, rnorm, which, nev, tol, is_last, what the packet must show)."""
    if name.startswith("arnoldi"):
        _, ncv, which, seed = name.split("-")
        ncv, seed = int(ncv), int(seed)
        a = _convdiff_dense(12) if seed % 2 else \
            np.random.default_rng(seed).standard_normal((200, 200)) / 14
        H, rn = chip_smoke._arnoldi_on(a, ncv, seed)
        return H, rn, which, max(2, ncv // 4), 1e-10, False, {}
    if name.startswith("uniform"):
        _, ncv, which = name.split("-")
        ncv = int(ncv)
        return (_random_hessenberg(ncv, ncv), 0.5, which, max(2, ncv // 4),
                1e-10, False, {})
    if name == "straddle-np0":
        # LM ascending: 7 smaller reals, the pair at 7-8 (np0 = 8), 3
        # larger reals; the cut grows kev to 5
        vals = list(range(1, 8)) + [5.0 + 5.5j] + [9.0, 10.0, 11.0]
        return (_with_spectrum(vals, 1), 1.0, "LM", 4, 1e-14, False,
                dict(nev=5, np=7, nconv=0))
    if name == "straddle-grow":
        # nconv = 2 of 4 wanted inflates nev to 6: np_eff = 6 splits the
        # pair at 5-6, kev grows to 7
        vals = [1.0, 2.0, 3.0, 4.0, 5.0, 3.0 + 4.5j, 7.0, 8.0, 9.0, 10.0,
                11.0]
        return (_with_spectrum(vals, 2), 1e-3, "LM", 4, "nconv=2", False,
                dict(nev=7, np=5, nconv=2))
    if name == "straddle-shrink":
        # ncv = 6, nev = 4: nconv = 1 inflates nev to 5; np_eff = 1 splits
        # the pair at 0-1, so both members become shifts (np_eff = 2)
        vals = [0.3 + 0.4j, 2.0, 3.0, 4.0, 5.0]
        return (_with_spectrum(vals, 3), 1e-3, "LM", 4, "nconv=1", False,
                dict(nev=4, np=2, nconv=1))
    if name == "zero-bounds":
        # H split after row 3: its top block's values (the least wanted
        # under LM) have bounds exactly 0 and cannot be shifted
        rng = np.random.default_rng(4)
        top = _with_spectrum([0.1, 0.2 + 0.1j], 5)
        bot = _with_spectrum([float(v) for v in range(2, 11)], 6)
        H = np.zeros((12, 12))
        H[:3, :3], H[3:, 3:] = top, bot
        H[:3, 3:] = rng.standard_normal((3, 9))
        return H, 1.0, "LM", 4, 1e-14, False, dict(nev=7, np=5, nconv=0,
                                                   zeros=3)
    if name == "done":
        H, rn = chip_smoke._arnoldi_on(_convdiff_dense(10), 20, 3)
        return H, rn, "LR", 4, 0.5, False, dict(done=1)
    if name == "last":
        H, rn = chip_smoke._arnoldi_on(_convdiff_dense(10), 20, 5)
        return H, rn, "SR", 4, 1e-10, True, dict(done=0)
    if name == "guard":
        H, rn = _guard_input()
        return H, rn, "LR", 6, 1e-10, False, dict(impl=1)
    raise KeyError(name)


def _tol_for(H, rnorm, which, nev, want):
    """A tol under which exactly ``want`` of the nev wanted values pass
    dnconv (the geometric mean of two neighbouring bound ratios)."""
    h = crc.head_plain(H, rnorm, _params(which, nev, 1e-300))
    ncv = H.shape[0]
    lo = ncv - nev
    ratio = np.sort(h.b_s[lo:] / np.maximum(EPS23, np.hypot(h.wr_s[lo:],
                                                            h.wi_s[lo:])))
    assert ratio[want] > 1.001 * ratio[want - 1] > 0
    return float(np.sqrt(ratio[want - 1] * ratio[want]))


CASES = (["arnoldi-6-LM-1", "arnoldi-12-SR-2", "arnoldi-24-LR-3",
          "arnoldi-32-LI-4", "arnoldi-40-SM-5", "arnoldi-16-SI-7",
          "uniform-8-LM", "uniform-16-SR", "uniform-24-LI"]
         + ["straddle-np0", "straddle-grow", "straddle-shrink", "zero-bounds",
            "done", "last", "guard"])


@pytest.mark.parametrize("name", CASES)
def test_twin_matches_host_head_tail(name):
    H, rn, which, nev, tol, is_last, want = _case(name)
    if isinstance(tol, str):
        tol = _tol_for(H, rn, which, nev, int(tol.split("=")[1]))
    ncv = H.shape[0]
    p = _params(which, nev, tol)
    t = _twin(H, rn, p, is_last)
    pk = t["pk"]
    h, out = _host(H, rn, which, nev, tol, is_last)
    P = crc.P_HEAD
    # the packet's header (the counters and flags pass through)
    assert list(pk[crc.P_CNT:crc.P_CNT + 4]) == [3, 1, 2, 0]
    assert pk[crc.P_BRK] == -1 and pk[crc.P_RNORM] == rn
    assert pk[crc.P_INFO] == 0
    assert (bool(pk[crc.P_DONE]), int(pk[crc.P_NCONV]), int(pk[crc.P_NEV]),
            int(pk[crc.P_NP])) == (h.done, h.nconv, h.nev_eff, h.np_eff)
    for got, ref in ((pk[P:P + ncv], h.wr_s), (pk[P + ncv:P + 2 * ncv], h.wi_s),
                     (pk[P + 2 * ncv:P + 3 * ncv], h.b_s)):
        np.testing.assert_array_equal(got, ref)
    assert h.nev_eff + h.np_eff == ncv
    if "nev" in want:
        assert (h.nev_eff, h.np_eff) == (want["nev"], want["np"])
    if "nconv" in want:
        assert h.nconv == want["nconv"]
    if "zeros" in want:
        assert np.count_nonzero(h.b_s[:ncv - nev] == 0) == want["zeros"]
    if "done" in want:
        assert h.done == bool(want["done"])
    if h.done or is_last:
        # no shifts: H, Q and sk untouched, the packet's H the input's
        np.testing.assert_array_equal(t["H"], H)
        assert not t["Q"].any() and not t["sk"].any()
        np.testing.assert_array_equal(pk[P + 3 * ncv:], H.ravel())
        assert out.state.k == ncv and out.state.iter == 1
        return
    k = h.nev_eff
    assert out.state.k == k
    rows = parn.kev_rows(ncv, k)
    Vn = out.state.V.numpy()
    np.testing.assert_array_equal(Vn[:rows, :ncv].T, t["Q"][:, :rows])
    np.testing.assert_array_equal(out.state.H, t["H"])
    np.testing.assert_array_equal(pk[P + 3 * ncv:], t["H"].ravel())
    assert t["sk"][0] == t["Q"][ncv - 1, k - 1] == out.state.resid[ncv]
    assert t["sk"][1] == t["H"][k, k - 1]
    if "impl" in want:
        assert bool(pk[crc.P_IMPL]) == bool(want["impl"])
    np.testing.assert_allclose(t["Q"].T @ t["Q"], np.eye(ncv), atol=1e-12)
    loss = _relation(H, t["Q"], t["H"], k)
    bound = EPS23 if name.startswith("uniform") else 1e-12
    assert loss <= bound * np.max(np.abs(H))


@pytest.mark.parametrize("name", CASES)
def test_twin_matches_reference_cycle(name):
    H, rn, which, nev, tol, is_last, want = _case(name)
    if isinstance(tol, str):
        tol = _tol_for(H, rn, which, nev, int(tol.split("=")[1]))
    ncv = H.shape[0]
    t = _twin(H, rn, _params(which, nev, tol), is_last)
    pk = t["pk"]
    ref = _reference(H, rn, which, nev, tol, is_last)
    P = crc.P_HEAD
    assert bool(pk[crc.P_DONE]) == bool(ref.done)
    assert int(pk[crc.P_NCONV]) == int(ref.nconv)
    scale = np.max(np.abs(np.hypot(ref.wr_s, ref.wi_s)))
    np.testing.assert_allclose(pk[P:P + ncv], ref.wr_s, rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(pk[P + ncv:P + 2 * ncv], ref.wi_s, rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(pk[P + 2 * ncv:P + 3 * ncv], ref.bounds_s,
                               rtol=0, atol=1e-12 * np.max(ref.bounds_s))
    Hr = np.asarray(ref.state.H)
    scale = np.max(np.abs(H))
    if pk[crc.P_DONE] or is_last:
        # no shifts in either: H as it was, k still ncv
        assert int(ref.state.k) == ncv
        np.testing.assert_array_equal(Hr, H)
        np.testing.assert_array_equal(t["H"], H)
        return
    k = int(pk[crc.P_NEV])
    assert int(ref.state.k) == k
    if "nev" in want:
        assert (k, int(pk[crc.P_NP])) == (want["nev"], want["np"])
    Vr = np.asarray(ref.state.V).reshape(ncv, -1)
    Qr = Vr[:parn.kev_rows(ncv, k), :ncv].T
    if pk[crc.P_IMPL]:
        # the reference keeps the explicit chase, which lost the
        # Hessenberg form in the kept columns and truncated it: its
        # restart breaks the Arnoldi relation; the twin's implicit chase
        # keeps it (on a uniformly random Hessenberg, within the chase's
        # guard)
        if name == "guard":
            assert _relation(H, Qr, Hr, k) > 1e-6 * scale
        bound = EPS23 if name.startswith("uniform") else 1e-12
        assert _relation(H, t["Q"], t["H"], k) <= bound * scale
        return
    # both restarts keep the Arnoldi relation; an exact shift's explicit
    # QR is forward unstable near the deflation it makes (betak is
    # rounding there, of either sign), so Q may move by up to 1e-10 and
    # the kept block of Hc = Q^T H0 Q with it, by about 2 max|H0| dQ
    assert _relation(H, Qr, Hr, k) <= 1e-12 * scale
    dQ = np.max(np.abs(t["Q"][:, :k] - Qr[:, :k]))
    assert dQ <= 1e-10
    assert np.max(np.abs(t["H"][:k + 1, :k] - Hr[:k + 1, :k])) \
        <= (1e-12 + 2 * dQ) * scale


def test_packet_layout_and_shared_memory_rule():
    # the packet: the symmetric header, the implicit flag, the sorted
    # values and bounds, then H; the workspace of six ncv x ncv matrices
    # and 18 vectors in double fits one block's shared memory to ncv 68
    assert (crc.P_IMPL, crc.P_HEAD) == (12, 13)
    assert crc.packet_size(32) == 13 + 96 + 1024
    assert crc.work_bytes(32) == (6 * 32 * 32 + 18 * 32) * 8
    assert crc.max_shared_ncv() == 68
    assert crc.fits_shared(68) and not crc.fits_shared(69)
    assert crc.WHICH == {"LM": 0, "SM": 1, "LR": 2, "SR": 3, "LI": 4,
                         "SI": 5}


def test_wrapper_refuses_bad_buffers_and_leaves_a_breakdown():
    f = dict(dtype=torch.float64)
    args = [torch.eye(8, **f), torch.tensor(1.0, **f),
            torch.tensor(-1, dtype=torch.int32),
            torch.tensor(0, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int64), torch.zeros(8, 8, **f),
            torch.zeros(2, **f), torch.zeros(crc.packet_size(8), **f)]
    p = _params("LM", 3, 1e-10)
    for i, bad in ((0, torch.eye(8, dtype=torch.float32)),
                   (2, torch.tensor(-1, dtype=torch.int64)),
                   (5, torch.zeros(8, 7, **f)),
                   (7, torch.zeros(5, **f))):
        with pytest.raises((ValueError, TypeError)):
            crc.realnonsym_cycle(*args[:i], bad, *args[i + 1:], p, False)
    with pytest.raises(ValueError):
        crc.realnonsym_cycle(*args, p._replace(which="LA"), False)
    # an extension that stopped short: only the header is written
    args[2] = torch.tensor(5, dtype=torch.int32)
    args[3] = torch.tensor(1, dtype=torch.int32)
    crc.realnonsym_cycle(*args, p, False)
    pk = args[7].numpy()
    assert (pk[crc.P_BRK], pk[crc.P_FORCE], pk[crc.P_RNORM]) == (5, 1, 1)
    assert not pk[crc.P_HEAD:].any() and not args[5].any()
    assert torch.equal(args[0], torch.eye(8, **f))


def test_clocks_argument_checked_and_ignored_by_the_twin():
    # the optional stamp buffer: an int64 vector of clock_size(ncv) on H's
    # device, refused otherwise; the twin (CPU tensors) leaves it as it was
    # and writes what it writes without it
    H, rn = chip_smoke._arnoldi_hessenberg(12, 0, nx=12)
    p = _params("LM", 3, 1e-10)
    size = crc.clock_size(12)
    assert size == len(crc.CLOCKS) + len(crc.LAPS) + len(crc.COUNTS) == 14

    def bufs():
        f = dict(dtype=torch.float64)
        return [torch.tensor(H, **f), torch.tensor(rn, **f),
                torch.tensor(-1, dtype=torch.int32),
                torch.tensor(0, dtype=torch.int32),
                torch.tensor([3, 1, 2, 0], dtype=torch.int64),
                torch.zeros(12, 12, **f), torch.zeros(2, **f),
                torch.zeros(crc.packet_size(12), **f)]

    for bad in (torch.zeros(size + 1, dtype=torch.int64),
                torch.zeros(size, dtype=torch.int32),
                torch.zeros(size, dtype=torch.int64, device="meta")):
        with pytest.raises(ValueError, match="clocks"):
            crc.realnonsym_cycle(*bufs(), p, False, clocks=bad)
    plain, stamped = bufs(), bufs()
    clk = torch.full((size,), 7, dtype=torch.int64)
    crc.realnonsym_cycle(*plain, p, False)
    crc.realnonsym_cycle(*stamped, p, False, clocks=clk)
    for a, b in zip(plain, stamped):
        assert torch.equal(a, b)
    assert torch.equal(clk, torch.full((size,), 7, dtype=torch.int64))


# ---- (b) the device loop ----------------------------------------------------

def _v0(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, n)


def _conv_diff(nx, rho=10.0):
    opj, a = jmodels.convection_diffusion_2d(nx, rho=rho, dtype=np.float64)
    opp, _ = pmodels.convection_diffusion_2d(nx, rho=rho, dtype=np.float64,
                                             device="cpu")
    return opj, opp, a


def _banded(n=400):
    rng = np.random.default_rng(2)
    import scipy.sparse as sp
    a = (sp.diags(2.0 + rng.standard_normal(n))
         + sp.diags(-1.5 * np.ones(n - 1), 1)
         + sp.diags(-0.5 * np.ones(n - 1), -1)).tocsr()
    return (jsparse.from_scipy(a, hermitian=False, format="dia"),
            pt.from_scipy(a, hermitian=False, format="dia", device="cpu"), a)


def _solvers(opj, opp, nev, ncv, which, tol, max_iter=800):
    kw = dict(n=opj.n, nev=nev, ncv=ncv, which=which, symmetric=False,
              dtype=np.dtype(np.float64), n_pad=opj.n_pad, tol=tol,
              max_iter=max_iter)
    cj, cp = JConfig(**kw), PConfig(**kw)
    return (jdrn.FusedRealNonsymSolver(opj, cj),
            pdrn.FusedRealNonsymSolver(opp, cp), cj, cp)


def _same(got, want, nev, rtol=1e-10):
    assert got.n_iter == want.n_iter and got.info == want.info
    assert got.nconv == want.nconv
    for f in COUNTS:
        assert int(getattr(got.stats, f)) == int(getattr(want.stats, f)), f
    lam = got.ritz[:nev]
    np.testing.assert_allclose(lam, want.ritz[:nev], rtol=0,
                               atol=rtol * np.max(np.abs(lam)))


def _rotations(nb=100):
    """2x2 rotation blocks a_i +- i b_i (a normal matrix, its values well
    conditioned; tests/test_fused_realnonsym.py's LI problem)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(6)
    blocks = []
    for i in range(nb):
        a = rng.standard_normal() * 0.3
        b = (i + 1) / nb * 3.0 + 0.1 * rng.standard_normal()
        blocks.append(np.array([[a, b], [-b, a]]))
    m = sp.block_diag(blocks).tocsr()
    return (jsparse.from_scipy(m, hermitian=False, format="dia"),
            pt.from_scipy(m, hermitian=False, format="dia", device="cpu"), m)


@pytest.mark.parametrize("problem,which", [
    ("cd10", "LM"), ("cd12", "LR"), ("cd14", "SR"), ("rotations", "LI"),
    ("banded", "LM")])
def test_device_loop_matches_reference(problem, which):
    # the device loop (the twin's reduced space on the CPU) against the
    # JAX package's fused driver from the same start vector, float64:
    # counters equal, values within 1e-10 |lambda|; and against the host
    # loop over the numpy head and tail (the witness) bit for bit
    nev, ncv = 5, 20
    if problem == "banded":
        opj, opp, _ = _banded()
    elif problem == "rotations":
        opj, opp, _ = _rotations()
    else:
        opj, opp, _ = _conv_diff(int(problem[2:]))
    sj, sp_, cj, cp = _solvers(opj, opp, nev, ncv, which, 1e-10)
    v0 = _v0(opj.n)
    want = sj.solve(v0=v0)
    assert not sp_._host_loop
    got = sp_.solve(v0=v0)
    assert got.stats.packets == got.n_iter > 1
    assert got.stats.graphs_captured == 0   # no card, no graph
    _same(got, want, cp.nev)
    host = HostLoopSolver.solve(
        pdrn.FusedRealNonsymSolver(opp, cp), v0=v0)
    assert host.stats.packets == 0
    np.testing.assert_array_equal(got.ritz, host.ritz)
    np.testing.assert_array_equal(got.bounds, host.bounds)
    for f in COUNTS:
        assert getattr(got.stats, f) == getattr(host.stats, f), f
    np.testing.assert_array_equal(got.state.H, host.state.H)
    assert torch.equal(got.state.V, host.state.V)
    assert torch.equal(got.state.resid, host.state.resid)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eigs_runs_the_device_loop(dtype):
    # eigs(strategy='auto' and 'fused_real') on a real operator runs
    # FusedRealNonsymSolver on the device loop: one packet per cycle, the
    # reduced space's launches counted on the card only (0 here); float32
    # solves in the float64 reduced space to the tolerance's residuals
    op, a = pmodels.convection_diffusion_2d(16, dtype=dtype, device="cpu")
    tol = 1e-5 if dtype == np.float32 else 1e-10
    for strategy in ("auto", "fused_real"):
        vals, vecs, out = pt.eigs(op, k=4, ncv=20, which="LM", tol=tol,
                                  strategy=strategy, return_stats=True)
        assert out.stats.packets == out.n_iter > 1
        r = np.linalg.norm(a @ vecs - vecs * vals, axis=0) / np.abs(vals)
        assert r.max() < (1e-3 if dtype == np.float32 else 1e-8)
    assert crc.realnonsym_cycle.launches == 0


def test_guard_case_through_the_loop():
    # test_torch_eigs.test_step_the_reference_breaks's problem on the
    # device loop: the implicit chase runs in a cycle and the residuals
    # meet 1e-8 |lambda|_max
    from unittest import mock
    flags = []
    real = pdrn.realnonsym_cycle

    def spy(*args):
        real(*args)
        flags.append(int(args[7][crc.P_IMPL]))

    op, a = pmodels.convection_diffusion_2d(10, dtype=np.float64,
                                            device="cpu")
    with mock.patch.object(pdrn, "realnonsym_cycle", spy):
        vals, vecs, out = pt.eigs(op, k=6, which="LR", ncv=24, tol=1e-10,
                                  maxiter=500, v0=_v0(100),
                                  return_stats=True)
    assert any(flags) and out.stats.packets == len(flags)
    r = np.linalg.norm(a @ vecs - vecs * vals[None, :], axis=0)
    assert r.max() < 1e-8 * np.abs(vals).max()


# ---- (c) multi and resume ----------------------------------------------------

@pytest.mark.parametrize("cut", [1, 3])
def test_multi_then_resume_equals_unbroken(cut, tmp_path):
    # n cycles through multi (the deferred restart applied at the
    # boundary), then a fresh solver resumes the state: the unbroken
    # solve's counters, values and basis bit for bit; the same boundary
    # dumped and resumed by the JAX package gives its unbroken solve
    opj, opp, _ = _conv_diff(12)
    sj, sp_, cj, cp = _solvers(opj, opp, 4, 16, "LM", 1e-10)
    v0 = _v0(opj.n)
    want = sp_.solve(v0=v0)
    s = pdrn.FusedRealNonsymSolver(opp, cp)
    out = s.multi(s.init_state(v0=v0), cut)
    st = out.state
    assert st.iter == cut and not out.done and st.k == st.nev_cur < cp.ncv
    path = tmp_path / "boundary.npz"
    pck.save_state(path, st, cp)
    got = pdrn.FusedRealNonsymSolver(opp, cp).solve(state=st)
    assert got.stats.packets == got.n_iter - cut
    assert got.n_iter == want.n_iter and got.nconv == want.nconv
    np.testing.assert_array_equal(got.ritz, want.ritz)
    for f in COUNTS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert torch.equal(got.state.V, want.state.V)
    jst, _ = jck.load_state(path, cfg=cj)
    ref = sj.solve(state=jst)
    _same(ref, sj.solve(v0=v0), cp.nev)
    _same(got, ref, cp.nev)


def test_multi_to_the_exit():
    # a multi run that reaches the exit hands back the exit's state as
    # solve does (the full factorization, done)
    opj, opp, _ = _conv_diff(10)
    _, sp_, _, cp = _solvers(opj, opp, 4, 20, "LR", 1e-8)
    v0 = _v0(opj.n)
    want = sp_.solve(v0=v0)
    s = pdrn.FusedRealNonsymSolver(opp, cp)
    out = s.multi(s.init_state(v0=v0), 10_000)
    assert out.done and out.state.iter == want.n_iter
    assert out.state.k == cp.ncv and out.nconv == want.nconv
    np.testing.assert_array_equal(out.state.H, want.state.H)


# ---- (d) a failed refinement and a breakdown --------------------------------

def _eigvec_problem():
    d = np.linspace(1.0, 10.0, 60)
    op = pt.from_diagonal(d, n_pad=pt.pad_dim(60), device="cpu")
    cfg = PConfig(n=60, nev=2, ncv=10, which="LM", symmetric=False,
                  dtype=np.dtype(np.float64), n_pad=op.n_pad, tol=1e-10,
                  max_iter=300)
    v0 = np.zeros(op.n_pad)
    v0[0] = 1.0
    return op, cfg, v0


def test_redo_and_restart_equal_host_loop():
    # v0 = e_0 on a diagonal operator solved as a non-symmetric one: the
    # first step's residual is exactly 0, both refinement passes fail
    # (REDO) and the host reruns the extension, drawing a restart vector;
    # the device loop reads a second packet and equals the host loop
    op, cfg, v0 = _eigvec_problem()
    parn.reruns.update(redo=0, breakdown=0)
    dev = pdrn.FusedRealNonsymSolver(op, cfg).solve(v0=v0)
    reruns = dict(parn.reruns)
    assert reruns["redo"] >= 1
    host = HostLoopSolver.solve(pdrn.FusedRealNonsymSolver(op, cfg), v0=v0)
    assert dev.stats.nrstrt == host.stats.nrstrt == 1
    assert dev.stats.packets == dev.n_iter + sum(reruns.values())
    np.testing.assert_array_equal(dev.ritz, host.ritz)
    for f in COUNTS:
        assert getattr(dev.stats, f) == getattr(host.stats, f), f
    np.testing.assert_allclose(np.sort(dev.ritz[:2].real), [9.84745763, 10],
                               rtol=1e-8)


def test_breakdown_equals_host_loop():
    # a state whose residual is exactly 0 after its first step (v0 = e_0
    # on the diagonal, finished by the host's step): the loop's first
    # extension flags a breakdown at step 1, the host draws the restart
    # vector on its generator and finishes it; the device loop reads a
    # second packet and equals the host loop
    op, cfg, v0 = _eigvec_problem()

    def entry(solver):
        st = solver._ext.stepwise(solver.init_state(v0=v0), 1)
        assert st.rnorm == 0 and st.k == 1
        return st

    s = pdrn.FusedRealNonsymSolver(op, cfg)
    parn.reruns.update(redo=0, breakdown=0)
    dev = s.solve(state=entry(s))
    reruns = dict(parn.reruns)
    s = pdrn.FusedRealNonsymSolver(op, cfg)
    host = HostLoopSolver.solve(s, state=entry(s))
    assert reruns == {"redo": 0, "breakdown": 1}
    assert dev.stats.nrstrt == host.stats.nrstrt == 1
    assert dev.stats.packets == dev.n_iter + 1
    np.testing.assert_array_equal(dev.ritz, host.ritz)
    for f in COUNTS:
        assert getattr(dev.stats, f) == getattr(host.stats, f), f


# ---- (e) a gloo world of 2 ---------------------------------------------------

def test_device_loop_on_two_ranks(tmp_path):
    # the real non-symmetric device loop on each rank's rows equals the
    # unsharded solve on every rank (counters exactly, values within
    # 1e-10), and the ranks agree bit for bit
    v0 = _v0(144, seed=3)
    out = run_world(2, ["realnonsym_loop"], tmp_path,
                    {"realnonsym_loop": v0})["realnonsym_loop"]
    for r in out:
        assert "error" not in r, r.get("error")
        m, s = r["mesh"], r["single"]
        assert not m["host_loop"] and m["packets"] == m["n_iter"] > 1
        assert m["counts"] == s["counts"] and m["n_iter"] == s["n_iter"]
        assert m["nconv"] == s["nconv"] >= 4
        np.testing.assert_allclose(m["ritz"][:4], s["ritz"][:4], rtol=1e-10)
        assert m["collectives"]["all_reduce"] > m["counts"][0]
    np.testing.assert_array_equal(out[0]["mesh"]["ritz"],
                                  out[1]["mesh"]["ritz"])


def test_multi_n_cycles_zero_and_config_checks():
    # multi(0) hands back the start; the driver refuses complex and
    # symmetric configs and caller shifts
    opj, opp, _ = _conv_diff(10)
    _, s, _, cp = _solvers(opj, opp, 4, 16, "LM", 1e-10)
    st = s.init_state(v0=_v0(opj.n))
    out = s.multi(st, 0)
    assert out.state is st and out.nconv == 0 and not out.done
    for bad in (dict(symmetric=True), dict(dtype=np.dtype(np.complex128)),
                dict(exact_shifts=False)):
        with pytest.raises(ValueError):
            pdrn.FusedRealNonsymSolver(opp, dataclasses.replace(cp, **bad))
