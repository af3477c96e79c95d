"""An irregular-sparsity eigensolve: a FEM-class matrix with no usable
diagonal structure through ``from_scipy(format='psell')`` (the PSELL
kernel on the card), its values held against scipy's.

Run:  python -m arpack_ng_tpu_torch.examples.irregular_sparse [n] [--cpu]
"""
import numpy as np
import scipy.sparse.linalg as sla

import arpack_ng_tpu_torch as pt
from arpack_ng_tpu_torch.models import corpus


def main(n=20_000, device="cuda"):
    a = corpus.fem_triangulation(n).tocsr()
    a = ((a + a.T) * 0.5).tocsr()
    op = pt.from_scipy(a.astype(np.float32), hermitian=True,
                       format="psell", device=device)
    print(f"n = {a.shape[0]}, nnz = {a.nnz}, format = {op.format}")
    vals, vecs = pt.eigsh(op, k=4, which="LA", ncv=20, tol=1e-4,
                          maxiter=2000)
    ref = sla.eigsh(a.astype(np.float64), k=4, which="LA", tol=1e-8,
                    return_eigenvectors=False)
    print(f"values:    {np.round(np.sort(vals), 5)}")
    print(f"reference: {np.round(np.sort(ref), 5)}")
    err = np.max(np.abs(np.sort(vals) - np.sort(ref))
                 / np.abs(np.sort(ref)))
    res = np.array([np.linalg.norm(a @ vecs[:, i] - vals[i] * vecs[:, i])
                    / abs(vals[i]) for i in range(4)])
    print(f"max value relerr {err:.1e}, max residual {res.max():.1e}")
    assert err < 1e-3 and res.max() < 1e-3
    print("OK")
    return vals, res


if __name__ == "__main__":
    from arpack_ng_tpu_torch.examples._cli import run
    run(main, __doc__, ("n",))
