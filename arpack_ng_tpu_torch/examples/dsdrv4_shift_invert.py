"""dsdrv4 equivalent (EXAMPLES/SYM/dsdrv4.f): the generalized symmetric
problem K x = lambda M x in shift-invert mode, the eigenvalues closest to
sigma of a 1-D Laplacian / mass-matrix pencil (the host factorization's
explicit inverse, applied on the device).

Run:  python -m arpack_ng_tpu_torch.examples.dsdrv4_shift_invert [n] [--cpu]
"""
import numpy as np
import scipy.sparse as sp

import arpack_ng_tpu_torch as pt


def main(n=300, sigma=0.0, device="cuda"):
    h = 1.0 / (n + 1)
    k_mat = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                     [-1, 0, 1]).toarray() / h
    m_mat = sp.diags([np.ones(n - 1), 4 * np.ones(n), np.ones(n - 1)],
                     [-1, 0, 1]).toarray() * (h / 6.0)
    vals, vecs = pt.eigsh(k_mat, k=4, M=m_mat, sigma=sigma, which="LM",
                          tol=1e-10, device=device)
    exact = (np.pi * np.arange(1, 5)) ** 2   # continuum eigenvalues
    print("computed:", np.round(np.sort(vals), 4))
    print("continuum limit:", np.round(exact, 4))
    res = []
    for i, lam in enumerate(vals):
        r = np.linalg.norm(k_mat @ vecs[:, i] - lam * (m_mat @ vecs[:, i]))
        res.append(r)
        print(f"  lambda[{i}] = {lam:.6f}   ||K x - lam M x|| = {r:.3e}")
    return vals, np.array(res)


if __name__ == "__main__":
    from arpack_ng_tpu_torch.examples._cli import run
    run(main, __doc__, ("n",))
