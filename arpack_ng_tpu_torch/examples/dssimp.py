"""dssimp equivalent (EXAMPLES/SIMPLE/dssimp.f): the 4 largest eigenvalues
of the 2-D Dirichlet Laplacian through the symmetric solver (the device
restart loop), with the residual ``||A x - lambda x||`` the reference
driver self-reports.

Run:  python -m arpack_ng_tpu_torch.examples.dssimp [nx] [--cpu]
"""
import numpy as np

import arpack_ng_tpu_torch as pt
from arpack_ng_tpu_torch.models import laplacian_2d


def main(nx=32, device="cuda"):
    op, a_sp = laplacian_2d(nx, np.float32, device=device)
    vals, vecs, out = pt.eigsh(op, k=4, which="LA", tol=1e-5,
                               return_stats=True)
    print(f"n = {op.n}  (nx = {nx});  {out.nconv} converged in "
          f"{out.n_iter} restart iterations")
    res = []
    for i, lam in enumerate(vals):
        r = np.linalg.norm(a_sp @ vecs[:, i] - lam * vecs[:, i])
        res.append(r)
        print(f"  lambda[{i}] = {lam:.8f}   ||A x - lam x|| = {r:.3e}")
    return vals, np.array(res)


if __name__ == "__main__":
    from arpack_ng_tpu_torch.examples._cli import run
    run(main, __doc__, ("nx",))
