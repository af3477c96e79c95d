"""Operator callables replacing arpack-ng's reverse communication
(SRC/dsaupd.f:68-97); port of ``arpack_ng_tpu/ops/operator.py``.

Contract (as in the reference package):

* ``apply(v, bv) -> (w, bw)`` with ``w = OP @ v`` and ``bw = B @ w``
  (``bw = w`` for ``bmat='I'``; ``bw = A @ v`` for mode 2).
* ``b_apply(v) -> B @ v`` (identity for ``bmat='I'``).
* ``a_apply``/``m_apply``: raw problem matvecs for verification.

Every vector is a torch tensor of length ``n_pad`` on ``device``, the CUDA
card unless the constructor is given another device (``device="cpu"``);
implementations map zero padding to zero padding.  ``perm`` is an optional
row permutation (internal row i holds logical coordinate ``perm[i]``);
``format`` is the execution structure the sparse importer chose;
``capturable`` says whether a CUDA graph may capture ``apply`` (the
operator's declared property: the package's own operators set it, a
caller's ``from_matvec`` callable does not unless told).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..utils import dtypes as _dt
from ..utils.device import DEFAULT, require


@dataclasses.dataclass(frozen=True)
class Operator:
    """A spectral-transformed operator pair (OP, B) plus raw matvecs."""

    n: int                          # logical dimension
    dtype: np.dtype                 # vector dtype
    apply: Callable                 # (v, bv) -> (w, bw)
    bmat: str = "I"                 # 'I' or 'G'
    mode: int = 1                   # ARPACK iparam(7)
    b_apply: Optional[Callable] = None   # v -> B v ; None => identity
    a_apply: Optional[Callable] = None   # raw A matvec (verification)
    m_apply: Optional[Callable] = None   # raw M matvec (verification)
    n_pad: int = 0                  # padded dimension (0 => n)
    sigma: complex = 0.0            # spectral shift (modes 3-5)
    hermitian: bool = False         # A (and M) hermitian/symmetric
    perm: object = None             # optional row permutation (np.ndarray)
    format: Optional[str] = None    # structure chosen by the sparse importer
    #   ('dense'/'dia'/'ell'/'hyb'/'psell'/'coo'); None for user-built
    #   operators
    device: object = DEFAULT        # torch device every vector lives on
    capturable: bool = False        # apply/b_apply are torch ops and
    #   kernels with no host read or sync, which a CUDA graph can hold
    #   (the restart loop then replays its extensions as graphs); False
    #   for a caller's Python matvec, which may do anything

    def __post_init__(self):
        if self.n_pad == 0:
            object.__setattr__(self, "n_pad", self.n)
        if self.b_apply is None:
            object.__setattr__(self, "b_apply", lambda v: v)
        object.__setattr__(self, "dtype", np.dtype(self.dtype))
        object.__setattr__(self, "device", torch.device(self.device))

    def matvec(self, v) -> np.ndarray:
        """Raw ``A @ v`` on a logical-length host vector (numpy in, numpy
        out), in the operator's internal (possibly permuted) order."""
        if self.a_apply is None:
            raise ValueError("operator has no raw a_apply")
        vp = torch.zeros(self.n_pad, dtype=_dt.torch_dtype(self.dtype),
                         device=self.device)
        vp[: self.n] = torch.from_numpy(np.asarray(v, self.dtype))
        return self.a_apply(vp)[: self.n].cpu().numpy()


def _pad_mat(a: np.ndarray, n_pad: int, fill_identity: bool = False
             ) -> np.ndarray:
    n = a.shape[0]
    if n_pad == n:
        return a
    out = (np.eye(n_pad, dtype=a.dtype) if fill_identity
           else np.zeros((n_pad, n_pad), a.dtype))
    out[:n, :n] = a
    return out


def from_dense(a, m=None, *, n_pad: int = 0, hermitian: bool = False,
               device=DEFAULT) -> Operator:
    """Standard (``m is None``: mode 1, ``OP = A``) or generalized mode-2
    (``OP = inv(M) A``, ``B = M``) operator from dense matrices, held on
    ``device`` (the card unless told otherwise)."""
    device = require(device)
    a = np.asarray(a)
    n = a.shape[0]
    n_pad = n_pad or n
    dtype = a.dtype
    a_dev = torch.as_tensor(_pad_mat(a, n_pad)).to(device)

    if m is None:
        def apply(v, bv):
            w = a_dev @ v
            return w, w

        return Operator(n=n, dtype=dtype, apply=apply, bmat="I", mode=1,
                        a_apply=lambda v: a_dev @ v, n_pad=n_pad,
                        hermitian=hermitian, format="dense", device=device,
                        capturable=True)

    # M is factored once on the host, as in the reference package
    import scipy.linalg as sla
    mp = _pad_mat(np.asarray(m), n_pad, fill_identity=True)
    lu, piv = sla.lu_factor(mp)
    minv = sla.lu_solve((lu, piv), np.eye(n_pad, dtype=mp.dtype))
    minv_dev = torch.as_tensor(minv.astype(dtype)).to(device)
    m_dev = torch.as_tensor(mp.astype(dtype)).to(device)

    def apply(v, bv):
        av = a_dev @ v
        return minv_dev @ av, av      # bw = A v  (mode-2 shortcut)

    return Operator(n=n, dtype=dtype, apply=apply, bmat="G", mode=2,
                    b_apply=lambda v: m_dev @ v,
                    a_apply=lambda v: a_dev @ v,
                    m_apply=lambda v: m_dev @ v,
                    n_pad=n_pad, hermitian=hermitian, device=device,
                    capturable=True)


def from_matvec(matvec: Callable, n: int, dtype, *, n_pad: int = 0,
                hermitian: bool = False, device=DEFAULT,
                capturable: bool = False) -> Operator:
    """Mode-1 standard operator from a torch matvec on padded vectors
    (the ``ido=1`` loop body of EXAMPLES/SIMPLE/dssimp.f) on ``device``
    (the card unless told otherwise).  No data moves here: a solve on a
    device this process lacks raises when it starts.  ``capturable``: the
    caller declares that ``matvec`` is torch ops and kernels with no host
    read or sync (see :class:`Operator`)."""
    def apply(v, bv):
        w = matvec(v)
        return w, w

    return Operator(n=n, dtype=np.dtype(dtype), apply=apply, bmat="I",
                    mode=1, a_apply=matvec, n_pad=n_pad or n,
                    hermitian=hermitian, device=device,
                    capturable=capturable)


def from_diagonal(d, *, n_pad: int = 0, device=DEFAULT) -> Operator:
    """Diagonal operator (the reference ICB test matrix,
    TESTS/icb_arpack_c.c:20-40) on ``device`` (the card unless told
    otherwise)."""
    device = require(device)
    d = np.asarray(d)
    n = d.shape[0]
    n_pad = n_pad or n
    dd = np.zeros((n_pad,), d.dtype)
    dd[:n] = d
    d_dev = torch.as_tensor(dd).to(device)

    def apply(v, bv):
        w = d_dev * v
        return w, w

    return Operator(n=n, dtype=d.dtype, apply=apply, bmat="I", mode=1,
                    a_apply=lambda v: d_dev * v, n_pad=n_pad,
                    hermitian=not np.iscomplexobj(d), device=device,
                    capturable=True)
