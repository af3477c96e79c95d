"""Singular value decomposition via Lanczos: the dsvd/ssvd driver
equivalent (EXAMPLES/SVD/dsvd.f; port of ``arpack_ng_tpu/core/svd.py``).

The reference computes the leading singular triplets of an m x n matrix A
by running the symmetric solver on OP = A^T A (dsvd.f:60) and recovering
the left vectors as u = A v / sigma (dsvd.f:37-38, 419).  For m < n the
smaller Gram operator A A^H is used instead (v = A^H u / sigma).

``method='augmented'`` runs Lanczos on the cyclic operator
``C = [[0, A], [A^H, 0]]`` (eigenvalues +-sigma_i, eigenvectors
(u_i; v_i)/sqrt(2)): the singular values' accuracy is then ~eps*kappa(A)
instead of the normal equations' ~eps*kappa(A)^2.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .. import api as _api
from ..config import pad_dim
from ..ops.operator import Operator
from ..utils import dtypes as _dt
from ..utils.device import DEFAULT, require


def _matvec_pair_from(A, dtype=None, device=DEFAULT
                      ) -> Tuple[Callable, Callable, int, int, np.dtype]:
    """``(av, ahv, m, n, dtype)`` from dense or sparse input (made dense,
    as the reference does), the products held on ``device``.  A torch
    tensor is used where it lies (moved only to ``device``), its adjoint a
    view."""
    if isinstance(A, torch.Tensor):
        a_dev = A.to(device=device, dtype=_dt.torch_dtype(dtype)
                     if dtype is not None else A.dtype)
        m, n = a_dev.shape
        ah_dev = a_dev.mH
        dt = np.dtype(str(a_dev.dtype).removeprefix("torch."))
    else:
        if sp.issparse(A):
            A = A.toarray()
        a = np.asarray(A)
        if dtype is not None:
            a = a.astype(dtype)
        m, n = a.shape
        dt = a.dtype
        a_dev = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        ah_dev = torch.from_numpy(np.ascontiguousarray(a.conj().T)).to(
            device)

    def av(x):      # (n,) -> (m,)
        return a_dev @ x

    def ahv(y):     # (m,) -> (n,)
        return ah_dev @ y

    return av, ahv, m, n, dt


def _padded(fn, dim: int, dim_pad: int):
    """``x -> [fn(x[:dim]); 0]`` on padded vectors."""
    if dim_pad == dim:
        return lambda x: fn(x[:dim])

    def g(x):
        out = torch.zeros(dim_pad, dtype=x.dtype, device=x.device)
        out[:dim] = fn(x[:dim])
        return out

    return g


def svds(
    A=None,
    k: int = 6,
    *,
    matvec: Optional[Callable] = None,
    rmatvec: Optional[Callable] = None,
    shape: Optional[Tuple[int, int]] = None,
    which: str = "LM",
    ncv: Optional[int] = None,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    return_singular_vectors: bool = True,
    dtype=None,
    seed: int = 0,
    method: str = "normal",
    mesh=None,
    device=None,
):
    """The k largest (``which='LM'``, dsvd) or smallest (``'SM'``)
    singular triplets on ``device`` (the CUDA card unless the caller asks
    for ``device="cpu"``).  Returns ``(u, s, vh)`` with ``s`` ascending, as
    scipy does, or ``s`` alone.

    ``A``: a dense or scipy sparse matrix (made dense), or a torch tensor
    (moved to ``device`` only where it lies elsewhere); or ``matvec``
    (``(n,) -> (m,)``) and ``rmatvec`` (``(m,) -> (n,)``) torch callables
    with ``shape``.  The package's own dense products make a capturable
    operator; a caller's callables do not.  ``method='normal'`` is the
    reference's Gram operator (dsvd.f:60), ``'augmented'`` the cyclic one
    (``which='LM'`` only).  ``mesh`` is not ported
    (``NotImplementedError``)."""
    _api._refuse_mesh(mesh)
    device = require(DEFAULT if device is None else device)
    if A is not None:
        av, ahv, m, n, dt = _matvec_pair_from(A, dtype, device)
        capturable = True
    else:
        if matvec is None or rmatvec is None or shape is None:
            raise ValueError("need A, or (matvec, rmatvec, shape)")
        av, ahv = matvec, rmatvec
        m, n = shape
        dt = np.dtype(dtype or np.float32)
        capturable = False

    if method not in ("normal", "augmented"):
        raise ValueError("method must be 'normal' or 'augmented'")
    if method == "augmented":
        if which != "LM":
            raise ValueError("method='augmented' supports which='LM' only")
        return _svds_augmented(av, ahv, m, n, np.dtype(dt), k, ncv, tol,
                               maxiter, return_singular_vectors, seed,
                               device, capturable)

    use_gram_right = n <= m   # Lanczos on A^H A (dim n) vs A A^H (dim m)
    dim = n if use_gram_right else m
    dim_pad = pad_dim(dim)
    if use_gram_right:
        gram = _padded(lambda x: ahv(av(x)), dim, dim_pad)
    else:
        gram = _padded(lambda x: av(ahv(x)), dim, dim_pad)
    op = Operator(n=dim, dtype=np.dtype(dt),
                  apply=lambda v, bv: (gram(v),) * 2, bmat="I", mode=1,
                  a_apply=gram, n_pad=dim_pad, hermitian=True,
                  device=device, capturable=capturable)

    # singular values^2 are the Gram eigenvalues: 'LM' -> 'LA' (PSD
    # spectrum), 'SM' -> 'SA'
    w_map = {"LM": "LA", "SM": "SA"}
    if which not in w_map:
        raise ValueError("which must be 'LM' or 'SM' for svds")
    vals, vecs = _api.eigsh(op, k=k, which=w_map[which], ncv=ncv, tol=tol,
                            maxiter=maxiter if maxiter else 600, seed=seed)
    s = np.sqrt(np.maximum(vals, 0.0))
    order = np.argsort(s, kind="stable")   # ascending, scipy convention
    s = s[order]
    vecs = vecs[:, order]
    if not return_singular_vectors:
        return s

    # the other side: u = A v / sigma (dsvd.f:419) or v = A^H u / sigma;
    # a zero sigma (null-space direction) normalizes instead
    small = vecs  # (dim, k): right vectors if use_gram_right, else left
    other_len = m if use_gram_right else n
    apply_other = av if use_gram_right else ahv
    tdt = _dt.torch_dtype(dt)
    other = np.zeros((other_len, len(s)), dtype=small.dtype)
    for i in range(len(s)):
        x = torch.from_numpy(np.ascontiguousarray(small[:, i].astype(dt)))
        w = apply_other(x.to(dtype=tdt, device=device)).cpu().numpy()
        w = w[:other_len]
        if s[i] > 0:
            other[:, i] = w / s[i]
        else:
            nrm = np.linalg.norm(w)
            other[:, i] = w / nrm if nrm > 0 else w
    u, v = (other, small) if use_gram_right else (small, other)
    return u, s, v.conj().T


def _svds_augmented(av, ahv, m, n, dt, k, ncv, tol, maxiter,
                    return_singular_vectors, seed, device, capturable):
    """Largest-k triplets via Lanczos on C = [[0, A], [A^H, 0]] (dim m+n):
    the ``'LA'`` end holds +sigma_i, whose eigenvectors split as
    (u_i; v_i)/sqrt(2), so both sides come out of one solve."""
    dim = m + n
    dim_pad = pad_dim(dim)

    def cyc(x):
        return torch.cat([av(x[m:dim])[:m], ahv(x[:m])[:n]])

    cyc_p = _padded(cyc, dim, dim_pad)
    op = Operator(n=dim, dtype=np.dtype(dt),
                  apply=lambda v, bv: (cyc_p(v),) * 2, bmat="I", mode=1,
                  a_apply=cyc_p, n_pad=dim_pad, hermitian=True,
                  device=device, capturable=capturable)
    vals, vecs = _api.eigsh(op, k=k, which="LA", ncv=ncv, tol=tol,
                            maxiter=maxiter if maxiter else 600, seed=seed)
    s = np.maximum(np.asarray(vals, dtype=np.float64), 0.0)
    order = np.argsort(s, kind="stable")   # ascending, scipy convention
    s = s[order]
    vecs = vecs[:, order]
    if not return_singular_vectors:
        return s

    u = np.asarray(vecs[:m, :])
    v = np.asarray(vecs[m:, :])
    for i in range(len(s)):
        un = np.linalg.norm(u[:, i])
        vn = np.linalg.norm(v[:, i])
        if un > 0:
            u[:, i] /= un
        if vn > 0:
            v[:, i] /= vn
    return u, s, v.conj().T
