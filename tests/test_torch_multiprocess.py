"""The port's multi-process tier, after tests/test_multiprocess.py: the
``mpiexec -n 2`` analog.  Two OS processes join one gloo world on the CPU
(``tests/torch_mp_worker.py``); first rank 0 solves alone on a sub-mesh
of its own (``torch.distributed.new_group([0])``, the MPI_Comm_split of
PARPACK/TESTS/MPI/issue46.f:18-30; the other rank idles), then both solve
on the world mesh.  The world's values must be equal bit for bit on both
ranks (SPMD: the reduced space is replicated), and both solves must agree
with scipy's ARPACK (1e-8) and with the JAX package's mesh solve
(1e-10*|lambda|)."""
import numpy as np
import pytest
import scipy.sparse.linalg as spla

pytest.importorskip("torch")

import arpack_ng_tpu as at  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.parallel.sharding import make_mesh  # noqa: E402

from torch_mp_worker import run_world  # noqa: E402


def test_two_process_world_and_submesh(tmp_path):
    out = run_world(2, ["submesh"], tmp_path)["submesh"]
    for r in out:
        assert "error" not in r, r.get("error")
    op, a_sp = jmodels.laplacian_2d(16, dtype=np.float64)
    sv = np.sort(spla.eigsh(a_sp, k=4, which="LA", ncv=20, tol=1e-10,
                            return_eigenvectors=False))
    ref = np.sort(at.eigsh(op, k=4, which="LA", ncv=20, tol=1e-10,
                           mesh=make_mesh(8), return_eigenvectors=False))
    # phase 1 ran only on rank 0's sub-mesh (issue46)
    assert out[0]["sub_size"] == 1 and "sub" not in out[1]
    np.testing.assert_allclose(out[0]["sub"], sv, rtol=1e-8)
    # phase 2 on the world mesh, on both ranks: bit-equal (SPMD)
    np.testing.assert_array_equal(out[0]["vals"], out[1]["vals"])
    np.testing.assert_allclose(out[0]["vals"], sv, rtol=1e-8)
    np.testing.assert_allclose(out[0]["vals"], ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())
    np.testing.assert_allclose(out[0]["sub"], ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())


def test_mesh_checkpoint_resumes_anywhere(tmp_path):
    # a world of 2 stops a solve at max_iter and dumps it (the ranks' rows
    # gathered, one file); the file resumes on one process, in the
    # reference package and on the mesh again, each to the unbroken
    # solve's values (1e-10*|lambda|) and counters
    import dataclasses

    from torch_mp_worker import _ckpt_problem, _iram_out

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu.config import IRAMConfig as JConfig
    from arpack_ng_tpu.core.iram import IRAMSolver as JSolver
    from arpack_ng_tpu.io import checkpoint as jck
    from arpack_ng_tpu_torch.io import checkpoint as pck

    n, cut, full = 600, 3, 500
    d = np.linspace(1.0, 50.0, n)
    v0 = np.random.default_rng(4).standard_normal(n)
    path = str(tmp_path / "mesh.npz")
    out = run_world(2, ["checkpoint"], tmp_path,
                    {"checkpoint": (d, v0, cut, full, path)})["checkpoint"]
    for r in out:
        assert "error" not in r, r.get("error")
    op, cfg = _ckpt_problem(d, full)
    want = _iram_out(pt.IRAMSolver(op, cfg).solve(v0=v0))
    assert want["n_iter"] > cut

    def same(got):
        assert got["n_iter"] == want["n_iter"] and got["info"] == 0
        assert got["nconv"] == want["nconv"]
        assert got["counts"] == want["counts"]
        np.testing.assert_allclose(got["ritz"][:4], want["ritz"][:4],
                                   rtol=0, atol=1e-10 * 50.0)

    n_pad = cfg.n_pad
    for r in out:
        assert r["cut"]["info"] == 1 and r["cut"]["n_iter"] == cut
        assert r["rows"] == (12, n_pad // 2) == r["loaded_rows"]
        same(r["resumed"])
    with np.load(path) as z:          # the whole rows, in either layout
        assert z["V"].reshape(12, -1).shape == (12, n_pad)
        assert z["resid"].shape == (n_pad,)
    st, meta = pck.load_state(path, cfg=cfg, device="cpu")
    assert meta["n_pad"] == n_pad and st.iter == cut - 1
    same(_iram_out(pt.IRAMSolver(op, cfg).solve(state=st)))
    jop = at.from_diagonal(d, n_pad=n_pad)
    jcfg = JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(JConfig)
                      if hasattr(cfg, f.name)})
    jst, _ = jck.load_state(path, cfg=jcfg)
    same(_iram_out(JSolver(jop, jcfg).solve(state=jst)))
