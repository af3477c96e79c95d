"""Mid-solve hand-over between the packages: the reference package's
``FusedSymSolver`` runs two restart cycles, its state goes to the port
through ``state_from_numpy``, and both run one more cycle; then the port's
state goes back through ``state_to_numpy`` and both run a fourth.  H, the
residual, its norm and the counters must agree (float64, tight: 1e-12 of
max|H|, 1e-10 relative on the residual)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.config import IRAMConfig as JConfig  # noqa: E402
from arpack_ng_tpu.core.arnoldi import FactorizationState as JState  # noqa
from arpack_ng_tpu.core.device_sym import FusedSymSolver  # noqa: E402
from arpack_ng_tpu.utils.stats import OpCounts as JCounts  # noqa: E402
from arpack_ng_tpu_torch import state_from_numpy, state_to_numpy  # noqa
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402
from arpack_ng_tpu_torch.config import IRAMConfig as PConfig  # noqa: E402
from arpack_ng_tpu_torch.core import device_sym as psym  # noqa: E402

FIELDS = ("V", "H", "resid", "b_resid", "rnorm", "k", "nev_cur", "iter",
          "info")


def _to_numpy(st):
    d = {f: np.array(getattr(st, f), copy=True) for f in FIELDS}
    d["V"] = d["V"].reshape(d["V"].shape[0], -1)
    d["counts"] = {f: int(v) for f, v in st.counts._asdict().items()}
    return d


def _to_jax(d, like):
    return JState(
        V=jnp.asarray(d["V"]).reshape(like.V.shape),
        H=jnp.asarray(d["H"]), resid=jnp.asarray(d["resid"]),
        b_resid=jnp.asarray(d["b_resid"]),
        rnorm=jnp.asarray(d["rnorm"]),
        **{f: jnp.int32(d[f]) for f in ("k", "nev_cur", "iter", "info")},
        key=jax.random.key(1),
        counts=JCounts(**{f: jnp.int32(v) for f, v in d["counts"].items()}))


def _assert_close(dj, dp):
    # after a restart only H[:k, :k] is live: the rows past k hold the
    # trailing columns of a QR of a singular shifted matrix, which each
    # LAPACK build rounds its own way and the next extension overwrites
    k = int(dj["k"])
    Hj, Hp = dj["H"][:k, :k], dp["H"][:k, :k]
    assert np.max(np.abs(Hp - Hj)) <= 1e-12 * np.max(np.abs(Hj))
    nr = np.linalg.norm(dj["resid"])
    assert np.linalg.norm(dp["resid"] - dj["resid"]) <= 1e-10 * nr
    np.testing.assert_allclose(float(dp["rnorm"]), float(dj["rnorm"]),
                               rtol=1e-10)
    for f in ("k", "nev_cur", "iter", "info"):
        assert int(dp[f]) == int(dj[f]), f
    assert dp["counts"] == dj["counts"]


@pytest.mark.parametrize("reorth", ["selective", "dgks"])
def test_mid_solve_handover(reorth):
    nx, ncv = 16, 20
    opj, _ = jmodels.laplacian_2d(nx, dtype=np.float64)
    opp, _ = pmodels.laplacian_2d(nx, dtype=np.float64, device="cpu")
    kw = dict(n=opj.n, nev=4, ncv=ncv, which="LA", symmetric=True,
              dtype=np.dtype(np.float64), n_pad=opj.n_pad, tol=1e-14,
              max_iter=500, reorth=reorth)
    solver = FusedSymSolver(opj, JConfig(**kw))
    v0 = np.random.default_rng(0).uniform(-1, 1, opj.n)
    one, lim = jnp.int32(1), jnp.int32(500)
    out = solver._multi(solver.init_state(key=jax.random.key(0), v0=v0),
                        jnp.int32(2), lim)
    d2 = _to_numpy(out.state)
    assert d2["iter"] == 2
    out = solver._multi(out.state, one, lim)  # reference: cycle 3
    d3 = _to_numpy(out.state)

    pcfg = PConfig(**kw)
    head, tail = psym.make_sym_head(opp, pcfg), psym.make_sym_tail(opp, pcfg)
    st = state_from_numpy(d2, device="cpu")
    pout = tail(head(st), False)  # port: cycle 3
    assert pout.done == bool(out.done) and pout.nconv == int(out.nconv)
    dp3 = state_to_numpy(pout.state)
    _assert_close(d3, dp3)

    # and back: the port's state resumes in the reference package
    out4 = solver._multi(_to_jax(dp3, out.state), one, lim)
    pout4 = tail(head(pout.state), False)
    _assert_close(_to_numpy(out4.state), state_to_numpy(pout4.state))


def test_numpy_round_trip_is_exact():
    op, _ = pmodels.laplacian_1d(100, dtype=np.float32, device="cpu")
    cfg = PConfig(n=op.n, nev=3, ncv=12, which="LA", symmetric=True,
                  dtype=np.dtype(np.float32), n_pad=op.n_pad)
    head, tail = psym.make_sym_head(op, cfg), psym.make_sym_tail(op, cfg)
    solver = psym.FusedSymSolver(op, cfg)
    st = tail(head(solver.init_state()), False).state
    d = state_to_numpy(st)
    back = state_to_numpy(state_from_numpy(d, device="cpu"))
    assert back.keys() == d.keys()
    for f in d:
        if f == "counts":
            assert back[f] == d[f]
        else:
            np.testing.assert_array_equal(back[f], d[f])
            assert np.asarray(back[f]).dtype == np.asarray(d[f]).dtype
