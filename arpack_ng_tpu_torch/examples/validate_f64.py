"""A non-normal single-precision eigensolve with float64 validation: on a
strongly convective operator, float32 residual-converged Ritz values can
sit outside the true spectrum while meeting their residual bound (the
operator's eps_f32-pseudospectrum).  ``eigs(..., validate='f64')``
re-applies the converged pairs through a float64 operator, attaches an
:class:`arpack_ng_tpu_torch.F64Validation` report and warns
(:class:`arpack_ng_tpu_torch.PseudospectrumWarning`) when the result
deserves a pseudospectral reading.

Run:  python -m arpack_ng_tpu_torch.examples.validate_f64 [nx] [--cpu]
"""
import warnings

import numpy as np

import arpack_ng_tpu_torch as pt
from arpack_ng_tpu_torch.models import convection_diffusion_2d


def main(nx=16, device="cuda"):
    _, a_sp = convection_diffusion_2d(nx, rho=400.0, dtype=np.float32,
                                      device="cpu")
    a32 = a_sp.astype(np.float32)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        vals, vecs, out = pt.eigs(a32, k=4, which="LM", ncv=20, tol=1e-4,
                                  maxiter=500, validate="f64",
                                  return_stats=True, device=device)
    rep = out.validation
    print(f"converged |lambda|: {np.round(np.abs(vals), 4)}")
    print(f"f64 relative residuals: "
          f"{np.array2string(rep.rel_residuals, precision=2)}")
    print(f"non-normality probe: {rep.nonnormality:.2e}  "
          f"(0 for normal operators)")
    print(f"passed f64 tolerance bar ({rep.tol_bar:.0e}): {rep.passed}")
    for w in caught:
        if issubclass(w.category, pt.PseudospectrumWarning):
            print(f"warning raised: {str(w.message)[:100]}...")
            break
    assert rep is not None and np.all(np.isfinite(rep.rel_residuals))
    print("OK")
    return vals, np.asarray(rep.rel_residuals)


if __name__ == "__main__":
    from arpack_ng_tpu_torch.examples._cli import run
    run(main, __doc__, ("nx",))
