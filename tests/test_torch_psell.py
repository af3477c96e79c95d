"""The port's PSELL packing (``arpack_ng_tpu_torch/ops/psell.py``) and the
plain twin of its kernel (``ops/cuda_psell.py``) against the reference's
``ops/pallas_psell.py``: the packers' outputs are equal bit for bit, and
the matvec agrees with the Pallas kernel (interpret mode), with the
reference's uniform-W XLA matvec and with scipy, on the patterns of
tests/test_psell.py: float64 to 1e-12, float32 to rtol 2e-5, atol 2e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from arpack_ng_tpu.ops import pallas_psell as jps  # noqa: E402
from arpack_ng_tpu_torch.ops import cuda_psell  # noqa: E402
from arpack_ng_tpu_torch.ops import psell as pps  # noqa: E402

N = 2500


def _rand_sparse(n, density, rng, pattern="uniform"):
    # the generator of tests/test_psell.py
    if pattern == "uniform":
        a = sp.random(n, n, density=density, random_state=rng,
                      format="csr", dtype=np.float64)
    elif pattern == "powerlaw":
        nnz = int(n * n * density)
        ranks = rng.zipf(1.8, size=nnz) % n
        rows = rng.integers(0, n, nnz)
        vals = rng.standard_normal(nnz)
        a = sp.csr_matrix((vals, (rows, ranks)), shape=(n, n))
        a.sum_duplicates()
    else:  # banded-ish FEM look-alike
        diags = [rng.standard_normal(n) for _ in range(7)]
        offs = [0, 1, -1, 40, -40, 41, -41]
        a = sp.diags(
            [d[: n - abs(o)] for d, o in zip(diags, offs)], offs,
            shape=(n, n)).tocsr()
    return a


def _case(pattern, dtype):
    rng = np.random.default_rng(1)
    a = _rand_sparse(N, 4e-3, rng, pattern).astype(dtype)
    x = rng.standard_normal(N).astype(dtype)
    return a, x


def _tol(dtype):
    return dict(rtol=1e-12, atol=1e-12) if dtype == np.float64 else \
        dict(rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("pattern", ["uniform", "powerlaw", "fem"])
def test_packers_match_reference(pattern, uniform):
    a, _ = _case(pattern, np.float64)
    fn = "pack_psell_uniform" if uniform else "pack_psell"
    jpk, ppk = getattr(jps, fn)(a), getattr(pps, fn)(a)
    assert type(ppk).__name__ == type(jpk).__name__
    for f in jpk._fields:
        np.testing.assert_array_equal(getattr(ppk, f), getattr(jpk, f))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pattern", ["uniform", "powerlaw", "fem"])
def test_matvec_matches_pallas_kernel(pattern, dtype):
    a, x = _case(pattern, dtype)
    pk = jps.pack_psell(a)
    xp = np.zeros(pk.n_pad, dtype)
    xp[:N] = x
    mv = jps.make_psell_matvec(pk.vals.shape[0], pk.n_pad,
                               np.dtype(dtype).name, interpret=True)
    ref = np.asarray(mv(jnp.asarray(pk.vals), jnp.asarray(pk.meta),
                        jnp.asarray(pk.p_idx), jnp.asarray(pk.c_idx),
                        jnp.asarray(pk.first), jnp.asarray(xp)))
    tiles = cuda_psell.psell_tiles(pps.pack_psell(a), "cpu")
    y = cuda_psell.psell_matvec(tiles, torch.from_numpy(xp)).numpy()
    np.testing.assert_allclose(y, ref, **_tol(dtype))
    np.testing.assert_allclose(y[:N], a @ x, **_tol(dtype))
    assert not y[N:].any()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pattern", ["uniform", "powerlaw", "fem"])
def test_uniform_matvec_matches_reference_xla(pattern, dtype):
    a, x = _case(pattern, dtype)
    pk = jps.pack_psell_uniform(a)
    xp = np.zeros(pk.n_pad, dtype)
    xp[:N] = x
    mv = jps.make_psell_matvec_xla(pk.n_pad // jps.CHUNK, pk.W, pk.n_pad,
                                   np.dtype(dtype).name)
    ref = np.asarray(mv(jnp.asarray(pk.vals), jnp.asarray(pk.meta),
                        jnp.asarray(pk.p_idx), jnp.asarray(xp)))
    tiles = cuda_psell.psell_tiles(pps.pack_psell_uniform(a), "cpu")
    # x of logical length n: no padding copy is needed
    y = cuda_psell.psell_matvec(tiles, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, ref, **_tol(dtype))
    np.testing.assert_allclose(y[:N], a @ x, **_tol(dtype))


def test_both_packings_give_one_tile_list():
    # the chunk offsets of pack_psell (chunk-sorted c_idx) and of the
    # uniform packing (W tiles per chunk) drive the same matvec
    a, x = _case("powerlaw", np.float64)
    t1 = cuda_psell.psell_tiles(pps.pack_psell(a), "cpu")
    t2 = cuda_psell.psell_tiles(pps.pack_psell_uniform(a), "cpu")
    assert t1.tile_ptr.shape == t2.tile_ptr.shape == (t1.n_pad // 1024 + 1,)
    assert int(t2.tile_ptr[1]) == pps.pack_psell_uniform(a).W
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(cuda_psell.psell_matvec(t1, xt).numpy(),
                               cuda_psell.psell_matvec(t2, xt).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_tiles_that_break_the_run_order_are_refused():
    # the kernel adds each run of one row from one thread: a tile holding
    # one row in two separate runs of nonzero entries is refused on the
    # host, as is an entry that addresses a column >= n
    a, _ = _case("fem", np.float64)
    pk = pps.pack_psell_uniform(a)
    meta = pk.meta.copy()
    vals = pk.vals.copy()
    live = np.flatnonzero(vals[0])
    assert live.size > 4
    meta[0, live[0]], meta[0, live[-1]] = meta[0, live[-1]], meta[0, live[0]]
    vals[0, live[0]], vals[0, live[-1]] = vals[0, live[-1]], vals[0, live[0]]
    with pytest.raises(ValueError, match="two separate runs"):
        cuda_psell.psell_tiles(pk._replace(meta=meta, vals=vals), "cpu")
    with pytest.raises(ValueError, match="column >= n"):
        cuda_psell.psell_tiles(pk._replace(n=10), "cpu")


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("pattern", ["uniform", "powerlaw", "fem"])
def test_tile_lengths_match_the_packing(pattern, uniform):
    # one past each tile's last nonzero slot, 0 for an all-zero tile (the
    # uniform packing's padding tiles; a chunk past n, empty in both)
    a, _ = _case(pattern, np.float64)
    fn = pps.pack_psell_uniform if uniform else pps.pack_psell
    pk = fn(a, n_pad=4096)
    vals = pk.vals.reshape(-1, pps.TILE)
    lens = cuda_psell.psell_tiles(pk, "cpu").tile_len.numpy()
    want = [nz[-1] + 1 if nz.size else 0
            for nz in map(np.flatnonzero, vals)]
    np.testing.assert_array_equal(lens, want)
    assert lens.dtype == np.int32 and (lens == 0).any() and lens.max() > 0


def test_tile_check_covers_zero_slots_before_the_length():
    # the kernel sums every slot before a tile's length, zeros included: a
    # zero slot that puts one row in two runs there is refused too
    a, _ = _case("fem", np.float64)
    pk = pps.pack_psell_uniform(a)
    meta, vals = pk.meta.copy(), pk.vals.copy()
    live = np.flatnonzero(vals[0])
    mid = live[live.size // 2]
    assert meta[0, mid] != meta[0, 0]
    meta[0, mid], vals[0, mid] = meta[0, 0], 0.0
    with pytest.raises(ValueError, match="two separate runs"):
        cuda_psell.psell_tiles(pk._replace(meta=meta, vals=vals), "cpu")


def test_psell_sharded_solve_cpu_mesh(tmp_path):
    """PSELL under a row mesh (the reference's case on 4 devices, here 4
    gloo ranks): the operator runs on the gathered vector, each rank keeps
    its rows; values against scipy (1e-6, the reference's gate) and the
    port's single-device solve from the same start vector."""
    from torch_mp_worker import run_world
    rng = np.random.default_rng(5)
    n = 4096
    a = _rand_sparse(n, 3e-3, rng)
    a = (a + a.T).tocsr()
    a = a + sp.diags(np.full(n, 10.0))
    v0 = np.random.default_rng(0).uniform(-1, 1, n)
    out = run_world(4, ["psell"], tmp_path, {"psell": (a, v0)})["psell"]
    for r in out:
        assert "error" not in r, r.get("error")
        np.testing.assert_array_equal(r["vals"], out[0]["vals"])
        assert r["format"] == "psell"
    import scipy.sparse.linalg as sla
    ref = sla.eigsh(a, k=3, which="LA", tol=1e-10,
                    return_eigenvectors=False)
    np.testing.assert_allclose(np.sort(out[0]["vals"]), np.sort(ref),
                               rtol=1e-6)
    np.testing.assert_allclose(np.sort(out[0]["vals"]), out[0]["single"],
                               rtol=1e-10)


def test_wrapper_rejects_bad_arguments():
    a, x = _case("uniform", np.float64)
    tiles = cuda_psell.psell_tiles(pps.pack_psell_uniform(a), "cpu")
    with pytest.raises(ValueError):
        cuda_psell.psell_matvec(tiles, torch.from_numpy(x[:-1]))
    with pytest.raises(ValueError):
        cuda_psell.psell_matvec(tiles, torch.from_numpy(x).float())
    meta = cuda_psell.PSellTiles(*[t.to("meta") if torch.is_tensor(t) else t
                                   for t in tiles])
    with pytest.raises(ValueError, match="no kernel"):
        cuda_psell.psell_matvec(meta, torch.empty(N, dtype=torch.float64,
                                                  device="meta"))
