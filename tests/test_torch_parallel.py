"""The port's row-partitioned solves (``mesh=``, ``arpack_ng_tpu_torch.
parallel``) against the JAX package's mesh solves, case by case after
tests/test_parallel.py.

The JAX side runs on conftest's 8 virtual CPU devices in the pytest
process; the port runs SPMD on gloo worlds of 2 and 4 OS processes on the
CPU (``tests/torch_mp_worker.py``), each world spun up once for the file,
both from the same numpy start vectors.  Tolerances:

* float64 values within 1e-10*|lambda| of the reference's mesh solve,
  and the matvec count equal on the simple spectra (the diagonal cases,
  the halo grid, the convection-diffusion operator at rho = 10 through
  all three eigs drivers); the 2-D Laplacian has double values, where
  the counts follow the last bits of the sums, so its values and
  residuals are held;
* the reference's own non-symmetric mesh cases (convection-diffusion at
  rho = 50) by their gates only: there the float64 values move by 1e-5
  relative with the order of a sum (the reference's mesh and single
  solves from one start vector differ by that much, and its mesh solve
  from this start vector misses its own 1e-7 residual gate), so they are
  held by the residual and the port's mesh solve against its own single
  one (1e-7, the reference's gate);
* every rank returns the same values bit for bit;
* residuals by ``conftest.residual``, with the reference tests' gates;
* the halo matvec equal to ``a_sp @ x`` within 1e-12;
* the communication model from the mesh's own counters: a bounded number
  of all-reduces per Lanczos step and no all-gather of the basis (the
  gather route moves one vector per operator application, the halo
  operator none)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import arpack_ng_tpu as at  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.models.distributed import \
    laplacian_2d_sharded as j_sharded  # noqa: E402
from arpack_ng_tpu.parallel.sharding import make_mesh  # noqa: E402

from conftest import residual  # noqa: E402
from torch_mp_worker import run_world  # noqa: E402

REL = 1e-10
SIZES = (2, 4)
CASES = ("diagonal", "matches_single", "stencil", "nonsym", "fused_real",
         "cd10", "layout", "halo_matvec", "halo_solve", "comm_model",
         "refusals")


def _v0(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, n)


def _inputs():
    rng = np.random.default_rng(7)
    d = np.sort(rng.uniform(1.0, 100.0, 600))
    return {"diagonal": _v0(1000),
            "matches_single": (d, rng.standard_normal(600)),
            "stencil": _v0(256), "nonsym": _v0(144), "fused_real": _v0(144),
            "cd10": _v0(144),
            "halo_matvec": np.random.default_rng(0).standard_normal(128 * 32),
            "halo_solve": _v0(128 * 32), "comm_model": _v0(1024)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    inputs = _inputs()
    return {size: run_world(size, CASES, tmp_path_factory.mktemp(f"w{size}"),
                            inputs)
            for size in SIZES}, inputs


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8
    return make_mesh(8)


def _ranks(worlds, size, case):
    res, _ = worlds
    out = res[size][case]
    for r in out:
        assert "error" not in r, r.get("error")
    return out


def _same_on_ranks(out, *keys):
    for r in out[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], out[0][k])


def _close(vals, ref, rel=REL):
    """The two value sets within ``rel * max|ref|`` of each other, each
    value matched to its nearest (a conjugate pair's order in a sort
    follows the last bits of its real part)."""
    vals, ref = np.asarray(vals), np.asarray(ref)
    assert vals.shape == ref.shape
    gap = np.abs(vals[:, None] - ref[None, :])
    tol = rel * float(np.max(np.abs(ref)))
    assert gap.min(axis=1).max() <= tol and gap.min(axis=0).max() <= tol, \
        (vals, ref)


@pytest.mark.parametrize("size", SIZES)
class TestDistributedEigsh:
    def test_diagonal(self, worlds, mesh8, size):
        out = _ranks(worlds, size, "diagonal")
        _same_on_ranks(out, "vals", "vecs")
        n = 1000
        op = at.from_diagonal(np.arange(1, n + 1, dtype=np.float64),
                              n_pad=at.pad_dim(n))
        vj, _, oj = at.eigsh(op, k=4, which="LM", tol=1e-10, maxiter=500,
                             v0=worlds[1]["diagonal"], mesh=mesh8,
                             return_stats=True)
        np.testing.assert_allclose(out[0]["vals"], [997.0, 998.0, 999.0,
                                                    1000.0], rtol=1e-9)
        _close(out[0]["vals"], vj)
        assert out[0]["nopx"] == oj.stats.nopx
        assert out[0]["n_iter"] == oj.n_iter

    def test_matches_single_device(self, worlds, mesh8, size):
        out = _ranks(worlds, size, "matches_single")
        _same_on_ranks(out, "vals")
        d, v0 = worlds[1]["matches_single"]
        op = at.from_diagonal(d, n_pad=at.pad_dim(len(d)))
        vj, oj = at.eigsh(op, k=5, which="LA", tol=1e-10, maxiter=800, v0=v0,
                          mesh=mesh8, return_eigenvectors=False,
                          return_stats=True)
        # shard-count invariance within roundoff (the mesh sums in parts)
        np.testing.assert_allclose(out[0]["vals"], out[0]["single"],
                                   rtol=1e-10)
        _close(out[0]["vals"], vj)
        assert out[0]["nopx"] == oj.stats.nopx

    def test_stencil_laplacian(self, worlds, mesh8, size):
        out = _ranks(worlds, size, "stencil")
        _same_on_ranks(out, "vals", "vecs")
        op, a_sp = jmodels.laplacian_2d(16, dtype=np.float64)
        vj = at.eigsh(op, k=4, which="LA", ncv=20, tol=1e-9, maxiter=500,
                      v0=worlds[1]["stencil"], mesh=mesh8,
                      return_eigenvectors=False)
        assert residual(a_sp, out[0]["vals"], out[0]["vecs"]).max() < 1e-8
        _close(out[0]["vals"], vj)

    def test_nonsym(self, worlds, size):
        out = _ranks(worlds, size, "nonsym")
        _same_on_ranks(out, "vals", "vecs")
        _, a_sp = jmodels.convection_diffusion_2d(12, rho=50.0,
                                                  dtype=np.float64)
        assert residual(a_sp, out[0]["vals"], out[0]["vecs"]).max() < 1e-7

    def test_fused_real_matches_single(self, worlds, size):
        out = _ranks(worlds, size, "fused_real")
        _same_on_ranks(out, "vals", "vecs")
        _, a_sp = jmodels.convection_diffusion_2d(12, rho=50.0,
                                                  dtype=np.float64)
        _close(out[0]["vals"], out[0]["single"], 1e-7)
        assert residual(a_sp, out[0]["vals"], out[0]["vecs"]).max() < 1e-7

    @pytest.mark.parametrize("strategy", ["fused_real", "hybrid", "fused"])
    def test_eigs_drivers_match_reference(self, worlds, mesh8, size,
                                          strategy):
        out = [r[strategy] for r in _ranks(worlds, size, "cd10")]
        _same_on_ranks(out, "vals", "vecs")
        op, a_sp = jmodels.convection_diffusion_2d(12, rho=10.0,
                                                   dtype=np.float64)
        vj, _, oj = at.eigs(op, k=4, which="LM", ncv=20, tol=1e-9,
                            maxiter=800, v0=worlds[1]["cd10"], mesh=mesh8,
                            strategy=strategy, return_stats=True)
        assert residual(a_sp, out[0]["vals"], out[0]["vecs"]).max() < 1e-9
        _close(out[0]["vals"], vj)
        assert out[0]["nopx"] == oj.stats.nopx


@pytest.mark.parametrize("size", SIZES)
class TestShardingLayout:
    def test_state_is_partitioned(self, worlds, size):
        out = _ranks(worlds, size, "layout")
        m = 1024 // size
        for rank, r in enumerate(out):
            assert r["V"] == (10, m)
            assert r["resid"] == r["b_resid"] == (m,)
            assert r["H"] == (10, 10)
            assert r["n_loc"] == m and r["rows"] == (rank * m,
                                                     (rank + 1) * m)
            assert {k for k, v in r["layout"].items() if v == "rows"} \
                == {"V", "resid", "b_resid"}
            assert r["transport"] == "gloo" and not r["capturable"]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case, match", [
    ("cgs_kernel", "cgs_kernel='pallas' does not support mesh-sharded"),
    ("n_pad", "must be divisible by the mesh size"),
    ("ny", "must be divisible by mesh size"),
    ("block", "n_pad/128 must divide the mesh size")])
def test_reference_refusals_kept(worlds, size, case, match):
    # the reference's own refusals under a mesh: the CGS kernels (a
    # pallas_call has no partitioning rule), an n_pad the mesh does not
    # divide (the block driver: n_pad/128), the halo grid's ny % size
    for r in _ranks(worlds, size, "refusals"):
        assert r[case] is not None and match in r[case], r[case]


@pytest.mark.parametrize("size", SIZES)
class TestHaloOperator:
    def test_halo_matvec_matches_sparse(self, worlds, mesh8, size):
        import jax.numpy as jnp
        from arpack_ng_tpu.parallel.sharding import row_sharding
        out = _ranks(worlds, size, "halo_matvec")
        _same_on_ranks(out, "y")
        x = worlds[1]["halo_matvec"]
        np.testing.assert_allclose(out[0]["y"], out[0]["ref"], rtol=0,
                                   atol=1e-12)
        op, a_sp = j_sharded(128, 32, mesh8, dtype=np.float64)
        yj = np.asarray(op.a_apply(jax.device_put(jnp.asarray(x),
                                                  row_sharding(mesh8))))
        np.testing.assert_allclose(out[0]["y"], yj, rtol=0, atol=1e-12)
        # one exchange, no gather of the operator's input: the matvec's
        # only all-gather is the host helper's return of the whole vector
        assert out[0]["collectives"]["halo"] == 1
        assert out[0]["collectives"]["all_gather"] == 1

    def test_halo_eigensolve(self, worlds, mesh8, size):
        out = _ranks(worlds, size, "halo_solve")
        _same_on_ranks(out, "vals", "vecs")
        op, a_sp = j_sharded(128, 32, mesh8, dtype=np.float64)
        vj, _, oj = at.eigsh(op, k=3, which="LA", tol=1e-9, maxiter=400,
                             v0=worlds[1]["halo_solve"], mesh=mesh8,
                             return_stats=True)
        assert residual(a_sp, out[0]["vals"], out[0]["vecs"]).max() < 1e-8
        _close(out[0]["vals"], vj)
        assert out[0]["nopx"] == oj.stats.nopx
        # a mesh-aware operator gathers nothing during the solve (the Ritz
        # vectors' one gather comes after it); one exchange per product
        c = out[0]["collectives"]
        assert c["all_gather"] == 0 and c["halo"] == out[0]["nopx"]


@pytest.mark.parametrize("size", SIZES)
def test_extend_collectives_bounded(worlds, size):
    """The communication model: O(1) all-reduces per Lanczos step at the
    reference's sites (PARPACK/SRC/MPI/pdsaitr.f:575-610: the CGS
    coefficients, wnorm, rnorm and the refinement's), never the basis
    gathered: the gather route moves one vector (n_loc rows from each rank)
    per operator application, the halo operator none."""
    out = _ranks(worlds, size, "comm_model")
    for rank in out:
        for tag, r in rank.items():
            c, steps = r["counts"], r["steps"]
            assert c["all_reduce"] >= steps, (tag, c)
            assert c["all_reduce"] <= 8 * steps, (tag, c)
            assert c["all_reduce_max"] == 0
            if tag == "halo":
                assert c["all_gather"] == 0 and c["halo"] == steps
            else:
                assert c["all_gather"] == steps == r["nopx"] - 1
                assert r["gathered"] == steps * r["n_loc"]
            assert c["all_gather"] <= c["all_reduce"]
    # the selective step: wnorm and alpha (one all-reduce), rnorm, the
    # event's coefficients and its norm
    sel = out[0]["selective"]
    assert sel["counts"]["all_reduce"] == 4 * sel["steps"]
