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
