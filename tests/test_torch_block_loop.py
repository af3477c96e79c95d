"""The block Lanczos cycle in its graph form (``core/block``: the work
after ``eigh`` on buffers that live for the whole solve, H rebuilt in
place, one CUDA graph per solve on a card), on the CPU, where it runs
eagerly:

* against the cycle as it was before (a fresh H each cycle, the matvec
  count carried through the steps; written out below as ``_Twin``) from
  the same start block: every cycle's Ritz values and bounds, the basis,
  H and the matvec count bit for bit (``torch.equal``), with and without
  the operator's block product, in float64 and float32;
* against the reference's ``eigsh_block`` from its own start block, in
  float64: equal cycles and matvecs, values to 1e-10 relative."""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from arpack_ng_tpu.core.block import eigsh_block as j_eigsh_block  # noqa
from arpack_ng_tpu.ops import sparse as jsparse  # noqa: E402
import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu_torch import models as pmodels  # noqa: E402
from arpack_ng_tpu_torch.core import block as pblock  # noqa: E402
from arpack_ng_tpu_torch.ops.cuda_rot import rotate_rows  # noqa: E402


def _penta(n, seed=7):
    rng = np.random.default_rng(seed)
    return sp.diags([rng.uniform(-0.5, 0.5, n - 2), rng.uniform(-1, 1, n - 1),
                     rng.uniform(0, 10, n), rng.uniform(-1, 1, n - 1),
                     rng.uniform(-0.5, 0.5, n - 2)],
                    [-2, -1, 0, 1, 2]).tocsr()


class _Twin:
    """The block cycle before its graph form, as plain torch: a fresh H
    each cycle, ``Bp`` a view of the old one."""

    def __init__(self, op, b, nev, ncv, kev, tdt):
        self.op, self.b, self.nev, self.ncv, self.kev = op, b, nev, ncv, kev
        self.tdt, self.nrow = tdt, ncv + b

    def a_block(self, Vb):
        if self.op.apply_block is not None:
            return self.op.apply_block(Vb)
        return torch.stack([self.op.apply(x, x)[0].to(self.tdt)
                            for x in Vb])

    def steps(self, V, H, s0, nmv):
        b, ncv = self.b, self.ncv
        s = s0
        while s + b <= ncv + b:
            AW = self.a_block(V[s - b:s])
            nmv += b
            Vs = V[:s]
            c1 = Vs @ AW.T
            AW = AW - c1.T @ Vs
            c2 = Vs @ AW.T
            AW = AW - c2.T @ Vs
            coeff = c1 + c2
            Q, R = pblock._qr_rows(AW)
            V[s:s + b] = Q
            H[:s, s - b:s] = coeff
            H[s - b:s, :s] = coeff.T
            H[s:s + b, s - b:s] = R
            H[s - b:s, s:s + b] = R.T
            s += b
        return nmv

    def cycle(self, V, H, nmv):
        b, ncv, kev, nev, nrow = self.b, self.ncv, self.kev, self.nev, \
            self.nrow
        T = H[:ncv, :ncv].double()
        theta, S = torch.linalg.eigh((T + T.T) / 2)
        S = S.to(self.tdt)
        Bp = H[ncv:nrow, ncv - b:ncv]
        bounds = torch.linalg.norm(Bp @ S[ncv - b:ncv, :], dim=0)
        theta_k = theta[ncv - kev:]
        S_k = S[:, ncv - kev:].contiguous()
        rotate_rows(S_k, V[:ncv], kev)
        V[kev:kev + b] = V[ncv:nrow]
        Hn = torch.zeros((nrow, nrow), dtype=self.tdt)
        Hn.diagonal()[:kev] = theta_k.to(self.tdt)
        arrow = Bp @ S_k[ncv - b:ncv, :]
        Hn[kev:kev + b, :kev] = arrow
        Hn[:kev, kev:kev + b] = arrow.T
        nmv = self.steps(V, Hn, kev + b, nmv)
        return Hn, nmv, theta[ncv - nev:], bounds[ncv - nev:].double()


@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("case", ["dia float64", "stencil float32"])
def test_cycle_equals_the_eager_cycle_before(case, b):
    if case == "dia float64":
        dt = np.float64
        op = pt.from_scipy(_penta(900), hermitian=True, format="dia",
                         device="cpu")
        assert op.apply_block is not None
    else:
        dt = np.float32
        op, _ = pmodels.laplacian_2d(24, dt, device="cpu")
        assert op.apply_block is None
    nev, ncv, cycles = 6, 24, 12
    init, cycle, _, kev = pblock.make_block_solver(op, b, nev, ncv, dt)
    st = init()
    twin = _Twin(op, b, nev, ncv, kev, st.V.dtype)
    V, H, nmv = st.V.clone(), st.H.clone(), st.nmv
    for _ in range(cycles):
        st, theta, bounds = cycle(st)
        H, nmv, t_theta, t_bounds = twin.cycle(V, H, nmv)
        assert torch.equal(theta, t_theta) and torch.equal(bounds, t_bounds)
        assert torch.equal(st.V, V) and torch.equal(st.H, H)
        assert st.nmv == nmv
    assert st.run.graph is None       # no graph off the card


@pytest.mark.parametrize("b", [1, 4])
def test_solve_matches_reference(b):
    # the reference's own start block, float64, a DIA operator with the
    # block product on both sides, a top cluster taking 4-19 cycles: equal
    # cycles and matvecs
    n = 1000
    rng = np.random.default_rng(11)
    e = rng.uniform(-0.05, 0.05, n - 1)
    a = sp.diags([e, np.r_[rng.uniform(0, 1, n - 8),
                           1.0 + 0.03 * np.arange(1, 9.0)], e],
                 [-1, 0, 1]).tocsr()
    jop = jsparse.from_scipy(a, hermitian=True)
    pop = pt.from_scipy(a, hermitian=True, format="dia", device="cpu")
    _, sub = jax.random.split(jax.random.key(0))
    X0 = np.array(jax.random.uniform(sub, (b, pop.n_pad), jnp.float64, -1.0,
                                     1.0))
    X0[:, pop.n:] = 0.0
    kw = dict(k=6, block_size=b, ncv=24, tol=1e-10, maxiter=100,
              dtype=np.float64)
    vj, _, ij = j_eigsh_block(jop, **kw)
    vp, _, ip = pblock.eigsh_block(pop, X0=X0, **kw)
    assert (ip["iters"], ip["matvecs"], ip["nconv"]) == (
        ij["iters"], ij["matvecs"], ij["nconv"])
    np.testing.assert_allclose(vp, vj, rtol=1e-10)
