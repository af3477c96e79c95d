"""dsvd equivalent (EXAMPLES/SVD/dsvd.f): the leading singular triplets
by Lanczos on the normal equations, then by the augmented (cyclic)
operator.

Run:  python -m arpack_ng_tpu_torch.examples.svd [m] [--cpu]
"""
import numpy as np

import arpack_ng_tpu_torch as pt


def main(m=500, n=120, k=5, device="cuda"):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((m, n))
    u, s, vh = pt.svds(a, k=k, tol=1e-10, device=device)
    print("singular values (normal equations, dsvd class):",
          np.round(s, 6))
    res = []
    for i in range(k):
        r = np.linalg.norm(a @ vh[i] - s[i] * u[:, i])
        res.append(r)
        print(f"  ||A v - s u||[{i}] = {r:.3e}")
    # the augmented (cyclic-operator) method: kappa- instead of
    # kappa^2-limited accuracy (an extension over the reference's dsvd)
    u2, s2, vh2 = pt.svds(a, k=k, tol=1e-10, method="augmented",
                          device=device)
    print("singular values (augmented):", np.round(s2, 6))
    return s, np.array(res)


if __name__ == "__main__":
    from arpack_ng_tpu_torch.examples._cli import run
    run(main, __doc__, ("m",))
