"""zndrv1 equivalent (EXAMPLES/COMPLEX/zndrv1.f): a complex-arithmetic
standard eigenproblem (the complex convection-diffusion operator,
complex128) through ``eigs``.

Run:  python -m arpack_ng_tpu_torch.examples.zndrv1 [nx] [--cpu]
"""
import numpy as np

import arpack_ng_tpu_torch as pt
from arpack_ng_tpu_torch.models import convection_diffusion_2d


def main(nx=16, device="cuda"):
    op, a_sp = convection_diffusion_2d(nx, rho=80.0, dtype=np.complex128,
                                       device=device)
    vals, vecs = pt.eigs(op, k=4, which="LM", tol=1e-10)
    res = []
    for i, lam in enumerate(vals):
        r = np.linalg.norm(a_sp @ vecs[:, i] - lam * vecs[:, i])
        res.append(r)
        print(f"  lambda[{i}] = {lam:.8f}   resid = {r:.3e}")
    return vals, np.array(res)


if __name__ == "__main__":
    from arpack_ng_tpu_torch.examples._cli import run
    run(main, __doc__, ("nx",))
