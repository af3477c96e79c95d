"""Thick-restart block Lanczos (``arpack_ng_tpu_torch.core.block``) and the
block DIA product against ``arpack_ng_tpu/core/block.py`` and
``arpack_ng_tpu/ops/sparse.py:118-183`` (the cases of tests/test_block.py),
on the same seeded numpy inputs in float64:

* with the reference's own start block (``jax.random`` at the same seed),
  values within 1e-10 relative of the reference's and the matvec and
  cycle counts equal, for b in {1, 2, 4}, on a spectrum without double
  values (on the 2-D Laplacian's double values b = 1's counts follow the
  last bits of the sums, so there the values and residuals are held);
* the reference's multiplet, refusal and block-apply cases;
* in float32 the port's basis stays orthonormal over 150 restarts where
  the reference's, rotated by a float32 eigensolve of T, drifts (a
  reference fault the port refuses: it solves T in float64);
* ``dia_block_matvec``: its argument checks, its twin equal bit for bit
  to the single product per column, and no launch counted on the CPU;
* no solver cache: two operators solved in turn each get their own
  answer."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import arpack_ng_tpu as at  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.core.block import eigsh_block as j_eigsh_block  # noqa: E402
from arpack_ng_tpu.ops import sparse as jsparse  # noqa: E402
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402
from arpack_ng_tpu_torch.core import block as pblock  # noqa: E402
from arpack_ng_tpu_torch.ops import cuda_dia, cuda_rot  # noqa: E402
from arpack_ng_tpu_torch.ops import sparse as psparse  # noqa: E402

#: float64 values: port against reference, relative
REL = 1e-10


def _jax_start(seed, b, n, n_pad):
    """The reference's start block (``make_block_solver``'s ``init``)."""
    _, sub = jax.random.split(jax.random.key(seed))
    X = np.array(jax.random.uniform(sub, (b, n_pad), jnp.float64, -1.0, 1.0))
    X[:, n:] = 0.0
    return X


def _penta(n, seed=5):
    """Random symmetric pentadiagonal matrix: simple spectrum."""
    rng = np.random.default_rng(seed)
    d0 = rng.uniform(0, 10, n)
    d1 = rng.uniform(-1, 1, n - 1)
    d2 = rng.uniform(-0.5, 0.5, n - 2)
    return sp.diags([d2, d1, d0, d1, d2], [-2, -1, 0, 1, 2]).tocsr()


def _res(a, vals, vecs):
    return max(np.linalg.norm(a @ vecs[:, i] - vals[i] * vecs[:, i])
               for i in range(len(vals)))


class TestBlockLanczos:
    @pytest.mark.parametrize("b", [1, 2, 4])
    def test_counters_match_reference(self, b):
        # DIA operators with the block product on both sides
        a = _penta(3000)
        jop = jsparse.from_scipy(a, hermitian=True)
        pop = pt.from_scipy(a, hermitian=True, device="cpu")
        assert pop.format == "dia" and pop.apply_block is not None
        assert pop.n_pad == jop.n_pad
        vj, _, ij = j_eigsh_block(jop, k=6, block_size=b, ncv=32, tol=1e-10,
                                  maxiter=400, dtype=np.float64)
        vp, vecs, ip = pblock.eigsh_block(
            pop, k=6, block_size=b, ncv=32, tol=1e-10, maxiter=400,
            dtype=np.float64, X0=_jax_start(0, b, pop.n, pop.n_pad))
        assert ip == ij
        np.testing.assert_allclose(vp, vj, rtol=REL)
        assert _res(a, vp, vecs) < 1e-8

    @pytest.mark.parametrize("b", [1, 2, 4])
    def test_matches_scalar_solver(self, b):
        # tests/test_block.py::test_matches_scalar_solver on the port: the
        # 2-D Laplacian (double values), matrix-free (no block product)
        op, a = pmodels.laplacian_2d(40, np.float64, device="cpu")
        assert op.apply_block is None
        ref = np.sort(pt.eigsh(op, k=6, which="LA", tol=1e-10,
                               return_eigenvectors=False))
        vals, vecs, info = pblock.eigsh_block(op, k=6, block_size=b, ncv=32,
                                              tol=1e-10, maxiter=400,
                                              dtype=np.float64)
        assert info["nconv"] >= 6
        np.testing.assert_allclose(np.sort(vals), ref, rtol=1e-10)
        assert _res(a, vals, vecs) < 1e-8
        jop, _ = jmodels.laplacian_2d(40, dtype=np.float64)
        vj, _, ij = j_eigsh_block(jop, k=6, block_size=b, ncv=32, tol=1e-10,
                                  maxiter=400, dtype=np.float64)
        np.testing.assert_allclose(np.sort(vals), np.sort(vj), rtol=REL)
        if b > 1:
            vp, _, ip = pblock.eigsh_block(
                op, k=6, block_size=b, ncv=32, tol=1e-10, maxiter=400,
                dtype=np.float64, X0=_jax_start(0, b, op.n, op.n_pad))
            assert ip == ij

    def test_resolves_multiplet_in_one_sweep(self):
        """A multiplicity-3 eigenvalue: block size >= multiplicity captures
        every copy; the multiplet convention holds the count captured and
        the residuals, never the exact value set."""
        d = np.concatenate([np.full(3, 50.0), np.linspace(1, 40, 197)])
        op = pt.from_diagonal(d, n_pad=pt.pad_dim(200), device="cpu")
        vals, vecs, info = pblock.eigsh_block(op, k=4, block_size=4, ncv=24,
                                              tol=1e-10, maxiter=200,
                                              dtype=np.float64)
        assert info["nconv"] >= 4
        assert np.sum(np.abs(vals - 50.0) < 1e-8) >= 3
        assert _res(np.diag(d), vals, vecs) < 1e-8
        jop = at.from_diagonal(d, n_pad=at.pad_dim(200))
        _, _, ij = j_eigsh_block(jop, k=4, block_size=4, ncv=24, tol=1e-10,
                                 maxiter=200, dtype=np.float64)
        _, _, ip = pblock.eigsh_block(op, k=4, block_size=4, ncv=24,
                                      tol=1e-10, maxiter=200,
                                      dtype=np.float64,
                                      X0=_jax_start(0, 4, 200, op.n_pad))
        assert ip == ij

    def test_rejects_unsupported(self):
        op, _ = pmodels.laplacian_2d(8, np.float64, device="cpu")
        with pytest.raises(ValueError, match="multiple"):
            pblock.make_block_solver(op, 3, 2, 16, np.float64)
        with pytest.raises(ValueError, match="real-only"):
            pblock.eigsh_block(op, k=2, block_size=2, ncv=16,
                               dtype=np.complex128)
        with pytest.raises(ValueError, match="room to expand"):
            pblock.make_block_solver(op, 4, 6, 16, np.float64)
        with pytest.raises(ValueError, match="orthonormal basis rows"):
            pblock.make_block_solver(op, 2, 2, 64, np.float64)
        m = sp.identity(64, format="csr")
        gen = pt.from_dense(np.diag(np.arange(1.0, 65.0)), m.toarray(),
                            device="cpu")
        with pytest.raises(ValueError, match="bmat='I'"):
            pblock.make_block_solver(gen, 2, 2, 16, np.float64)
        odd = pt.from_diagonal(np.arange(1.0, 101.0), device="cpu")
        with pytest.raises(ValueError, match="multiple of 128"):
            pblock.make_block_solver(odd, 2, 2, 16, np.float64)
        with pytest.raises(TypeError, match="RowMesh"):
            pblock.eigsh_block(op, k=2, block_size=2, mesh=object())

    def test_mesh_matches_reference(self, tmp_path):
        # mesh= on 2 gloo ranks (tests/torch_mp_worker.py) against the
        # reference's mesh solve on 8 devices, from the reference's start
        # block: equal cycles and matvecs, values within 1e-10; both ranks
        # equal bit for bit; the single-device solve's values
        from arpack_ng_tpu.parallel.sharding import make_mesh
        from torch_mp_worker import run_world
        a, b = _penta(3000), 2
        jop = jsparse.from_scipy(a, hermitian=True)
        X0 = _jax_start(0, b, a.shape[0], jop.n_pad)
        out = run_world(2, ["block"], tmp_path,
                        {"block": (a, X0, b)})["block"]
        for r in out:
            assert "error" not in r, r.get("error")
        np.testing.assert_array_equal(out[0]["vals"], out[1]["vals"])
        vj, _, ij = j_eigsh_block(jop, k=6, block_size=b, ncv=32,
                                  tol=1e-10, maxiter=400, dtype=np.float64,
                                  mesh=make_mesh(8))
        assert out[0]["info"] == ij
        np.testing.assert_allclose(out[0]["vals"], vj, rtol=REL)
        np.testing.assert_allclose(out[0]["vals"], out[0]["single"],
                                   rtol=REL)
        assert _res(a, out[0]["vals"], out[0]["vecs"]) < 1e-8

    def test_matrix_free_float32_operator_promotes(self):
        # a float32 matrix-free operator solved with dtype=float64: the
        # reference promotes in its products (float32 coefficients times
        # float64 vectors), and so does the port's elementwise product
        n = 1000
        rng = np.random.default_rng(11)
        d = rng.uniform(0, 10, n).astype(np.float32)
        e = rng.uniform(-1, 1, n - 1).astype(np.float32)
        n_pad = at.pad_dim(n)
        dj, ej = jnp.asarray(d), jnp.asarray(e)
        dp, ep = torch.from_numpy(d), torch.from_numpy(e)

        def jmv(v):
            y = v.at[:n].multiply(dj)
            y = y.at[:n - 1].add(ej * v[1:n])
            return y.at[1:n].add(ej * v[:n - 1])

        def pmv(v):
            y = v.clone()
            y[:n] = dp * v[:n]
            y[:n - 1] += ep * v[1:n]
            y[1:n] += ep * v[:n - 1]
            return y

        jop = at.from_matvec(jmv, n, np.float32, n_pad=n_pad, hermitian=True)
        pop = pt.from_matvec(pmv, n, np.float32, n_pad=n_pad, hermitian=True,
                             device="cpu")
        kw = dict(k=4, block_size=2, ncv=24, tol=1e-10, maxiter=300,
                  dtype=np.float64)
        vj, _, ij = j_eigsh_block(jop, **kw)
        vp, vecs, ip = pblock.eigsh_block(pop, X0=_jax_start(0, 2, n, n_pad),
                                          **kw)
        assert vecs.dtype == np.float64 and ip == ij
        np.testing.assert_allclose(vp, vj, rtol=REL)
        a = sp.diags([e.astype(np.float64), d.astype(np.float64),
                      e.astype(np.float64)], [-1, 0, 1])
        assert _res(a, vp, vecs) < 1e-8 * np.abs(vp).max()

    def test_no_solver_cache(self):
        # the reference cached built solvers by id(op); the port builds
        # each solve anew, so two operators solved in turn (and the first
        # again) each get their own values
        d1 = np.linspace(1, 10, 300)
        d2 = np.linspace(2, 30, 300)
        out = []
        for d in (d1, d2, d1):
            op = pt.from_diagonal(d, n_pad=384, device="cpu")
            vals, _, _ = pblock.eigsh_block(op, k=3, block_size=2, ncv=16,
                                            tol=1e-10, dtype=np.float64)
            out.append(np.sort(vals))
            np.testing.assert_allclose(np.sort(vals), np.sort(d)[-3:],
                                       rtol=1e-10)
        np.testing.assert_array_equal(out[0], out[2])

    def test_rotation_runs_on_the_restart(self, monkeypatch):
        # the thick restart is rotate_rows with rows = kev over V[:ncv];
        # rows ncv..ncv+b (the residual block) are left as they were
        op, _ = pmodels.laplacian_2d(20, np.float64, device="cpu")
        init, cycle, _, kev = pblock.make_block_solver(op, 2, 4, 16,
                                                       np.float64)
        st = init()
        tail = st.V[16:].clone()
        seen = []
        real = cuda_rot.rotate_rows

        def spy(Q, V, rows):
            seen.append((tuple(Q.shape), tuple(V.shape), rows))
            out = real(Q, V, rows)
            assert torch.equal(st.V[16:], tail)
            return out

        monkeypatch.setattr(pblock, "rotate_rows", spy)
        cycle(st)
        assert seen == [((16, kev), (16, op.n_pad), kev)]

    def test_float32_restart_keeps_the_basis_orthonormal(self):
        # a reference fault the port refuses: the reference's eigh of T
        # runs in float32 (arpack_ng_tpu/core/block.py:170), its S is
        # orthonormal to ~1e-6 only, and the thick restart rotates V by it
        # unchecked, so the basis drifts every cycle (on the card the
        # flagship's b = 1 solve then returned a value 2.8e-3 off the
        # spectrum with its bounds passing); the port's eigh runs in
        # float64 and the basis stays orthonormal to float32 rounding
        from arpack_ng_tpu.core import block as jblock
        nx, cycles = 64, 150
        op, _ = pmodels.laplacian_2d(nx, np.float32, device="cpu")
        init, cycle, _, _ = pblock.make_block_solver(op, 1, 8, 32,
                                                     np.float32)
        st = init()
        for _ in range(cycles):
            st, theta, _ = cycle(st)
        V = st.V[:32].double()
        port = float((V @ V.T - torch.eye(32, dtype=torch.float64)).abs()
                     .max())
        jop, _ = jmodels.laplacian_2d(nx, dtype=np.float32)
        jinit, jcycle, _, _ = jblock.make_block_solver(jop, 1, 8, 32,
                                                       np.float32)
        jcycle = jax.jit(jcycle)
        jst = jax.jit(jinit)(jax.random.key(0))
        for _ in range(cycles):
            jst, _, _ = jcycle(jst)
        Vj = np.asarray(jst.V)[:32].reshape(32, -1).astype(np.float64)
        ref = np.abs(Vj @ Vj.T - np.eye(32)).max()
        assert port <= 5e-6 < 1e-5 <= ref, (port, ref)
        lam_max = 8 - 8 * np.sin(np.pi / (2 * (nx + 1))) ** 2
        assert abs(float(theta[-1]) - lam_max) <= 1e-5 * lam_max

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pblock.eigsh_block(np.diag(np.arange(1.0, 65.0)), k=2)


class TestBlockApply:
    """The block DIA product (ops/sparse.dia_block_matvec_fn) against
    scipy and the reference's lane-major form, offsets past 128 and
    padded dimensions included."""

    OFFS = [0, 1, -1, 7, -7, 130, -130, 300, -300]

    def _matrix(self, rng, n, cplx=False):
        def diag(m):
            v = rng.standard_normal(m)
            return v + 1j * rng.standard_normal(m) if cplx else v
        return sp.diags([diag(n - abs(o)) for o in self.OFFS], self.OFFS,
                        shape=(n, n)).tocsr()

    @pytest.mark.parametrize("b", [1, 2, 4, 9])
    def test_matches_scipy_and_reference(self, b):
        rng = np.random.default_rng(b)
        n = 1000
        n_pad = pt.pad_dim(n)
        a = self._matrix(rng, n)
        offsets, diags = psparse._to_dia(a)
        blk = psparse.dia_block_matvec_fn(offsets, diags, n, n_pad,
                                          device="cpu")
        mv = psparse.dia_matvec_fn(offsets, diags, n, n_pad, device="cpu")
        X = rng.standard_normal((b, n_pad))
        X[:, n:] = 0.0
        Y = blk(torch.from_numpy(X)).numpy()
        Yj = np.asarray(jsparse.dia_block_matvec_fn(offsets, diags, n,
                                                    n_pad)(jnp.asarray(X)))
        for j in range(b):
            np.testing.assert_allclose(Y[j, :n], a @ X[j, :n], rtol=1e-12,
                                       atol=1e-12)
            # each row is the single product's, bit for bit
            np.testing.assert_array_equal(
                Y[j], mv(torch.from_numpy(X[j].copy())).numpy())
        np.testing.assert_allclose(Y, Yj, rtol=1e-14, atol=1e-14)
        assert not Y[:, n:].any()

    def test_complex_table_runs_the_twin(self):
        rng = np.random.default_rng(3)
        n = 700
        a = self._matrix(rng, n, cplx=True)
        op = pt.from_scipy(a, format="dia", device="cpu")
        X = rng.standard_normal((3, op.n_pad)) \
            + 1j * rng.standard_normal((3, op.n_pad))
        X[:, n:] = 0
        Y = op.apply_block(torch.from_numpy(X)).numpy()
        for j in range(3):
            np.testing.assert_allclose(Y[j, :n], a @ X[j, :n], rtol=1e-12,
                                       atol=1e-12)

    def test_from_scipy_dia_carries_block_apply(self):
        n = 3000   # above DENSE_MAX_N so auto picks 'dia'
        a = sp.diags([np.ones(n - 1), 2 * np.ones(n), np.ones(n - 1)],
                     [-1, 0, 1]).tocsr()
        op = pt.from_scipy(a, hermitian=True, device="cpu")
        assert op.format == "dia" and op.apply_block is not None
        X = np.random.default_rng(0).standard_normal((2, op.n_pad))
        X[:, n:] = 0
        Y = op.apply_block(torch.from_numpy(X)).numpy()
        for j in range(2):
            np.testing.assert_allclose(Y[j, :n], a @ X[j, :n], rtol=1e-12)
        # other formats, and a DIA operator on an odd n_pad, carry none
        assert pt.from_scipy(a, format="ell", device="cpu").apply_block \
            is None
        assert pt.from_scipy(a, format="dia", n_pad=3001,
                             device="cpu").apply_block is None
        with pytest.raises(ValueError, match="multiple of 128"):
            psparse.dia_block_matvec_fn([0], [np.ones(n)], n, 3001,
                                        device="cpu")


class TestDiaBlockMatvecWrapper:
    def _args(self, nd=3, b=2, n_pad=256, dtype=torch.float64):
        offs = torch.tensor([-1, 0, 1][:nd], dtype=torch.int64)
        dtab = torch.ones((nd, n_pad), dtype=dtype)
        X = torch.ones((b, n_pad), dtype=dtype)
        return offs, dtab, X

    def test_argument_checks(self):
        offs, dtab, X = self._args()
        cases = [
            ((offs, dtab[:, ::2], X[:, ::2], 100), "dtab must be"),
            ((offs.int(), dtab, X, 200), "offsets must be"),
            ((offs[:2], dtab, X, 200), "offsets must be"),
            ((offs, dtab, X.float(), 200), "X must be"),
            ((offs, dtab, X[0], 200), "X must be"),
            ((offs, dtab, X[:, :128], 100), "X must be"),
            ((offs, dtab, torch.ones((0, 256), dtype=torch.float64), 200),
             "X must be"),
            ((offs, dtab, X.T.contiguous().T, 200), "X must be"),
            ((offs, dtab, X, 257), "outside"),
            ((offs, dtab, X, -1), "outside"),
        ]
        for args, msg in cases:
            with pytest.raises(ValueError, match=msg):
                cuda_dia.dia_block_matvec(*args)
        meta = torch.ones((2, 256), dtype=torch.float64, device="meta")
        with pytest.raises(ValueError, match="share one device"):
            cuda_dia.dia_block_matvec(offs, dtab, meta, 200)
        with pytest.raises(ValueError, match="no kernel for device"):
            cuda_dia.dia_block_matvec(offs.to("meta"), dtab.to("meta"),
                                      meta, 200)

    @pytest.mark.parametrize("b", [1, 3, 8, 11])
    def test_twin_per_column_and_no_launch_on_cpu(self, b):
        # the CPU path runs the twin, bit-equal to the single product of
        # each column, and counts no kernel launch (the counters count the
        # card's launches only; tests/test_torch_gpu.py counts those)
        rng = np.random.default_rng(b)
        n, n_pad = 500, 512
        offs = torch.tensor([3, -2, 0, 7, -600, 1], dtype=torch.int64)
        dtab = torch.from_numpy(rng.standard_normal((6, n_pad)))
        X = torch.from_numpy(rng.standard_normal((b, n_pad)))
        before = (cuda_dia.dia_block_matvec.launches,
                  cuda_dia.dia_matvec.launches)
        Y = cuda_dia.dia_block_matvec(offs, dtab, X, n)
        for c in range(b):
            assert torch.equal(Y[c], cuda_dia.dia_matvec(offs, dtab,
                                                         X[c].contiguous(),
                                                         n))
        assert not Y[:, n:].any()
        assert (cuda_dia.dia_block_matvec.launches,
                cuda_dia.dia_matvec.launches) == before


@pytest.mark.parametrize("driver", ["eigsh_block", "eigsh_banded"])
def test_solvers_pin_full_precision_matmuls(driver):
    # the block solver's CGS passes, Gram matrices and CholQR2 are torch
    # products: its build pins full-precision float32 matmuls whatever the
    # caller set, as every driver of the package does; the banded driver
    # runs eigsh, which pins them
    from arpack_ng_tpu_torch.ops import banded
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        if driver == "eigsh_block":
            op, _ = pmodels.laplacian_2d(16, np.float32, device="cpu")
            pblock.eigsh_block(op, k=2, block_size=2, ncv=12, tol=1e-4,
                               maxiter=5)
        else:
            ab = np.zeros((3, 1500), np.float32)
            ab[0, 1:], ab[1], ab[2, :-1] = -1.0, 2.0, -1.0
            banded.eigsh_banded(ab, 1, 1, k=2, sigma=0.5, tol=1e-4,
                                return_eigenvectors=False, device="cpu")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
