"""Realification (port of ``arpack_ng_tpu/ops/realify.py``): complex
eigenproblems through the REAL solver paths.

A complex operator ``A = Ar + i Ai`` acting on ``z = x + i y`` is the real
block operator

    M = [[Ar, -Ai],
         [Ai,  Ar]]        acting on [x; y]  (dimension 2n),

whose spectrum is ``spec(A) | conj(spec(A))`` and whose eigenvector for
the eigenvalue lambda is ``[Re z; Im z]``.  A Hermitian A gives a
symmetric M, so a complex Hermitian problem takes the real symmetric
route; a banded A gives a banded M, which the sparse importer runs as DIA
(the DIA kernel of ``csrc/dia.cu`` on the card, at dimension 2n).

The reference package needed this for TPU runtimes without complex
arithmetic; CUDA runs complex arithmetic natively (``eigs`` and ``eigsh``
take complex dtypes), so here it exists for API parity.  Cost: 2x memory
and about 2x flops against the native complex solve.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import pad_dim
from ..utils.device import DEFAULT, require
from .operator import Operator


def realify_matvec(a_apply_c: Callable, n: int, n_pad2: int):
    """Real matvec on stacked ``[x; y]`` (halves of ``n_pad2 // 2``) from
    a complex torch matvec on length-``n`` vectors."""
    half = n_pad2 // 2

    def mv(u):
        w = a_apply_c(torch.complex(u[:n], u[half: half + n]))
        out = torch.zeros(n_pad2, dtype=u.dtype, device=u.device)
        out[:n] = w.real.to(u.dtype)
        out[half: half + n] = w.imag.to(u.dtype)
        return out

    return mv


def realify_dense(a: np.ndarray, *, hermitian: Optional[bool] = None,
                  device=DEFAULT) -> Operator:
    """Dense complex matrix -> real block Operator of dimension 2n on
    ``device`` (the card unless told otherwise)."""
    a = np.asarray(a)
    if not np.iscomplexobj(a):
        raise ValueError("realify expects a complex matrix")
    device = require(device)
    n = a.shape[0]
    if hermitian is None:
        hermitian = np.allclose(a, a.conj().T, atol=1e-12)
    rdt = np.float32 if a.dtype == np.complex64 else np.float64
    half = pad_dim(n)
    n2 = 2 * half
    m = np.zeros((n2, n2), rdt)
    m[:n, :n] = a.real
    m[:n, half: half + n] = -a.imag
    m[half: half + n, :n] = a.imag
    m[half: half + n, half: half + n] = a.real
    m_dev = torch.from_numpy(m).to(device)

    def matvec(v):
        return m_dev @ v

    def apply(v, bv):
        w = matvec(v)
        return w, w

    return Operator(n=n2, dtype=np.dtype(rdt), apply=apply, bmat="I",
                    mode=1, a_apply=matvec, n_pad=n2,
                    hermitian=bool(hermitian), format="dense",
                    device=device, capturable=True)


def realify_sparse(a, *, hermitian: Optional[bool] = None,
                   device=DEFAULT) -> Operator:
    """Sparse complex matrix -> real block Operator of dimension 2n on
    ``device``, through the sparse importer (``ops/sparse.from_scipy``):
    the block matrix of a banded complex matrix has its nonzeros on about
    3x its diagonal count (around offsets 0 and +-half), so it runs as
    DIA."""
    import scipy.sparse as sp

    from .sparse import from_scipy

    if not sp.issparse(a):
        raise ValueError("realify_sparse expects a scipy sparse matrix")
    if not np.iscomplexobj(a):
        raise ValueError("realify expects a complex matrix")
    n = a.shape[0]
    if hermitian is None:
        hermitian = (abs(a - a.conj().T) > 1e-12).nnz == 0
    rdt = np.float32 if a.dtype == np.complex64 else np.float64
    half = pad_dim(n)
    ar = sp.csr_matrix(a.real.astype(rdt))
    ai = sp.csr_matrix(a.imag.astype(rdt))

    # the blocks at [0, n) and [half, half + n), so _recover's
    # z = u[:n] + i u[half:half + n] layout matches realify_dense
    def expand(m):
        c = m.tocoo()
        return sp.csr_matrix((c.data, (c.row, c.col)), shape=(half, half),
                             dtype=rdt)

    are, aim = expand(ar), expand(ai)
    a2 = sp.bmat([[are, -aim], [aim, are]]).tocsr()
    return from_scipy(a2, hermitian=bool(hermitian), n_pad=2 * half,
                      device=device)


def _recover(vals, vecs, a, n: int, half: int, k: int, *,
             tol: float = 0.0):
    """Map realified eigenpairs back to the complex problem, keeping for
    each value the one of (lambda, conj(lambda)) its vector satisfies.

    The gates follow the solve's working precision (and the caller's tol,
    whichever is looser):

    * ``floor`` (the conjugate-copy detector): for a copy of the conj(A)
      half, ``z = p + iq`` vanishes to solve accuracy (~sqrt(eps)), where a
      genuine copy has ``||z|| ~ 1/sqrt(2)``;
    * ``gate`` (residual acceptance): ~10 sqrt(eps) of the storage dtype;
    * ``dedup``: a real eigenvalue of A appears TWICE in spec(M); its
      copies agree to solve accuracy.
    """
    rdt = np.asarray(vecs).real.dtype
    eps = float(np.finfo(rdt).eps)
    floor = 10.0 * np.sqrt(eps)
    gate = max(float(tol), 10.0 * np.sqrt(eps))
    dedup = max(float(tol), 10.0 * np.sqrt(eps))
    out_vals, out_vecs = [], []
    seen = []
    for i in range(len(vals)):
        lam = complex(vals[i])
        u = vecs[:, i]
        # for M's eigenpair (lam, u = [p; q]), z = p + i q is an eigenvector
        # of A for lam, and ~zero exactly when the pair belongs to the
        # conj(A) half of the realified spectrum: skip those copies
        z = u[:n] + 1j * u[half: half + n]
        nrm = np.linalg.norm(z)
        if nrm < floor * max(np.linalg.norm(u), 1e-300):
            continue
        z = z / nrm
        az = a @ z
        res = np.linalg.norm(az - lam * z)
        res_conj = np.linalg.norm(az - np.conj(lam) * z)
        # keep the pair only if z is A's eigenvector for lam: closer to lam
        # than to conj(lam), and small in absolute terms
        if res > res_conj or res > gate * max(1.0, abs(lam)):
            continue
        if any(abs(lam - s) < dedup * max(1.0, abs(lam)) for s in seen):
            continue
        seen.append(lam)
        out_vals.append(lam)
        out_vecs.append(z)
        if len(out_vals) == k:
            break
    return (np.array(out_vals),
            np.stack(out_vecs, axis=1) if out_vecs else
            np.zeros((n, 0), complex))


def eigs_realified(a, k: int = 6, *, which: str = "LM",
                   tol: float = 0.0, ncv: Optional[int] = None,
                   maxiter: Optional[int] = None, seed: int = 0,
                   hermitian: Optional[bool] = None, mesh=None,
                   device=None) -> Tuple[np.ndarray, np.ndarray]:
    """znaupd-class solve of a complex matrix (dense or scipy sparse)
    through the REAL drivers, on ``device`` (the card unless told
    otherwise; a mesh's device under ``mesh``).

    Each complex eigenvalue of A surfaces in the realified spectrum with
    its conjugate partner; twice as many pairs are asked for and the
    genuine ones kept by residual.  Where the conjugate copies crowd out
    genuine pairs in the ``which`` selection (a one-sided selector like
    'LI' on an asymmetric spectrum), the subspace is enlarged and the solve
    retried, at most twice; a :class:`UserWarning` says when fewer than k
    came back.  Hermitian inputs take the real symmetric route ('LM', 'LA'
    and 'SA'; other selectors run as 'LM').  ``mesh``: the real solve runs
    row-partitioned on it (``eigsh``/``eigs(..., mesh=)``); the recovery
    runs on the whole vectors on every rank."""
    import scipy.sparse as sp

    from .. import api

    device = api._mesh_device(mesh, device) or DEFAULT
    if sp.issparse(a):
        n = a.shape[0]
        op = realify_sparse(a, hermitian=hermitian, device=device)
    else:
        a = np.asarray(a)
        n = a.shape[0]
        op = realify_dense(a, hermitian=hermitian, device=device)
    half = op.n_pad // 2
    kmax = op.n - 2
    k2 = min(2 * k, kmax)
    retries = 0
    while True:
        if op.hermitian:
            vals, vecs = api.eigsh(op, k=k2, which=which if which in
                                   ("LM", "LA", "SA") else "LM",
                                   tol=tol, ncv=ncv, maxiter=maxiter,
                                   seed=seed, mesh=mesh)
        else:
            vals, vecs = api.eigs(op, k=k2, which=which, tol=tol, ncv=ncv,
                                  maxiter=maxiter, seed=seed, mesh=mesh)
        out_vals, out_vecs = _recover(np.atleast_1d(vals), vecs, a, n,
                                      half, k, tol=tol)
        if len(out_vals) >= k or k2 >= kmax or retries >= 2:
            break
        # under-delivery: conjugate copies took part of the subspace; widen
        # and solve again (each retry is a whole solve)
        retries += 1
        k2 = min(2 * k2, kmax)
    if len(out_vals) < k:
        warnings.warn(
            f"eigs_realified recovered {len(out_vals)} of {k} requested "
            "pairs even at the maximum subspace size; the conjugate-copy "
            "filter rejected the rest (check `which` against the "
            "spectrum's symmetry, or raise tol)", stacklevel=2)
    return out_vals, out_vecs
