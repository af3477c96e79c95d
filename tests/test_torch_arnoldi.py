"""The port's Lanczos engine (arpack_ng_tpu_torch/core/arnoldi.py) against
the reference package's ``make_extend``, from the same numpy start vector,
on the tests/test_reorth.py problems (plus a geometric diagonal on which a
float64 extension already fires reorthogonalization events).

Tolerances: the tridiagonal (selective) or projected (dgks) H agrees to
1e-12 of max|H| in float64 and 1e-4 in float32 — the two packages round
their inner products in different orders, nothing else differs.  The op
counters must be equal in both dtypes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import arpack_ng_tpu as at  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.config import IRAMConfig as JConfig  # noqa: E402
from arpack_ng_tpu.core import arnoldi as jarn  # noqa: E402
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402
from arpack_ng_tpu_torch.config import IRAMConfig as PConfig  # noqa: E402
from arpack_ng_tpu_torch.core import arnoldi as parn  # noqa: E402

COUNTS = ("nopx", "nbx", "nrorth", "nitref", "nrstrt", "nrorthr")


def _problem(name, dtype):
    """(reference operator, port operator, ncv)."""
    if name == "lap2d":
        return (jmodels.laplacian_2d(16, dtype)[0],
                pmodels.laplacian_2d(16, dtype, device="cpu")[0], 24)
    if name == "diag":
        d = np.linspace(1.0, 100.0, 400).astype(dtype)
    elif name == "geo":
        d = np.geomspace(1.0, 1e4, 300).astype(dtype)
    else:
        a = np.random.default_rng(42).standard_normal((300, 300))
        a = ((a + a.T) / 2).astype(dtype)
        return (at.from_dense(a, n_pad=at.pad_dim(300)),
                pt.from_dense(a, n_pad=pt.pad_dim(300), device="cpu"), 20)
    n_pad = at.pad_dim(d.shape[0])
    return (at.from_diagonal(d, n_pad=n_pad),
            pt.from_diagonal(d, n_pad=n_pad, device="cpu"),
            48 if name == "geo" else 20)


def _extend_both(name, dtype, reorth):
    opj, opp, ncv = _problem(name, dtype)
    kw = dict(n=opj.n, nev=4, ncv=ncv, which="LA", symmetric=True,
              dtype=np.dtype(dtype), n_pad=opj.n_pad, reorth=reorth)
    v0 = np.zeros(opj.n_pad)
    v0[: opj.n] = np.random.default_rng(0).uniform(-1, 1, opj.n)
    v0 = v0.astype(dtype)
    cj, cp = JConfig(**kw), PConfig(**kw)
    stj = jarn.make_init(opj, cj)(jax.random.key(0), jnp.asarray(v0))
    ext = jarn.make_extend(opj, cj)
    stj = jax.device_get(jax.jit(lambda s: ext(s, jnp.int32(ncv)))(stj))
    stp = parn.make_init(opp, cp)(None, v0)
    stp = parn.make_extend(opp, cp)(stp, ncv)
    return stj, stp


@pytest.mark.parametrize("reorth", ["selective", "dgks"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["lap2d", "diag", "dense", "geo"])
def test_extend_matches_reference(name, dtype, reorth):
    stj, stp = _extend_both(name, dtype, reorth)
    tol = 1e-12 if dtype == np.float64 else 1e-4
    Hj = np.asarray(stj.H, np.float64)
    err = np.max(np.abs(stp.H - Hj))
    assert err <= tol * np.max(np.abs(Hj)), err
    np.testing.assert_allclose(float(stp.rnorm), float(stj.rnorm),
                               rtol=1e3 * tol)
    Vj = jarn.v_matrix(stj.V).astype(np.float64)
    np.testing.assert_allclose(parn.v_matrix(stp.V), Vj, rtol=0,
                               atol=1e3 * tol)
    got = {f: getattr(stp.counts, f) for f in COUNTS}
    want = {f: int(getattr(stj.counts, f)) for f in COUNTS}
    assert got == want
    assert stp.k == int(stj.k) and stp.info == int(stj.info) == 0


def test_geo_extension_fires_events_in_f64():
    # the f64 parity above covers the event path, not only the recurrence
    _, stp = _extend_both("geo", np.float64, "selective")
    assert stp.counts.nrorth > 0 and stp.counts.nrorthr > 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("hatch,value", [("ARPACK_TPU_FULL_REORTH", "1"),
                                         ("ARPACK_TPU_SEL_EXTRA_BUCKET", "1")])
def test_event_hatches_match_reference(monkeypatch, hatch, value, dtype):
    # each debug hatch set in both packages (read when the extension is
    # built): the events take all ncv rows, or one bucket more than the
    # selection needs, so they run the kernels' 16- to 48-row buckets
    monkeypatch.setenv(hatch, value)
    stj, stp = _extend_both("geo", dtype, "selective")
    tol = 1e-12 if dtype == np.float64 else 1e-4
    Hj = np.asarray(stj.H, np.float64)
    assert np.max(np.abs(stp.H - Hj)) <= tol * np.max(np.abs(Hj))
    got = {f: getattr(stp.counts, f) for f in COUNTS}
    assert got == {f: int(getattr(stj.counts, f)) for f in COUNTS}
    ncv = stp.V.shape[0]
    per_event = ncv if hatch == "ARPACK_TPU_FULL_REORTH" else 16
    assert stp.counts.nrorth > 0
    assert stp.counts.nrorthr >= per_event * stp.counts.nrorth
