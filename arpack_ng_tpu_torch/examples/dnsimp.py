"""dnsimp equivalent (EXAMPLES/SIMPLE/dnsimp.f): the largest-magnitude
eigenvalues of the 2-D convection-diffusion operator (non-symmetric;
complex conjugate pairs in real arithmetic).

Run:  python -m arpack_ng_tpu_torch.examples.dnsimp [nx] [--cpu]
"""
import numpy as np

import arpack_ng_tpu_torch as pt
from arpack_ng_tpu_torch.models import convection_diffusion_2d


def main(nx=20, device="cuda"):
    op, a_sp = convection_diffusion_2d(nx, rho=100.0, dtype=np.float64,
                                       device=device)
    vals, vecs = pt.eigs(op, k=4, which="LM", tol=1e-10)
    res = []
    for i, lam in enumerate(vals):
        r = np.linalg.norm(a_sp @ vecs[:, i] - lam * vecs[:, i])
        res.append(r)
        print(f"  lambda[{i}] = {lam:.8f}   ||A x - lam x|| = {r:.3e}")
    return vals, np.array(res)


if __name__ == "__main__":
    from arpack_ng_tpu_torch.examples._cli import run
    run(main, __doc__, ("nx",))
