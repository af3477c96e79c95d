"""Banded-matrix operators and convenience eigensolver drivers, the
EXAMPLES/BAND family ([sdcz][sn]band.f) (port of
``arpack_ng_tpu/ops/banded.py``).

The reference's ``dsband`` is a self-contained driver: it factors
``A - sigma*M`` with LAPACK ``dgbtrf``, applies OP with ``dgbtrs``/
``dgbmv``, and internally runs the whole RCI loop for modes 1-5
(EXAMPLES/BAND/dsband.f:30-52,399-463).  Here:

* the banded **matvec** is a DIA product over the offsets ``-kl..ku`` in
  that order (:func:`~arpack_ng_tpu_torch.ops.sparse.dia_matvec_fn`: the
  kernel of ``csrc/dia.cu`` on the card, its twin on the CPU), the
  reference's order of the sum;
* the banded **solve** for shift-invert/generalized modes is
  host-factored once in float64 by block cyclic reduction
  (:mod:`.bandsolve`) and applied on the device as its level sweeps,
  O(n*b) memory; small problems (n <= :data:`DENSE_CUTOFF`) instead use a
  host dense inverse applied as one product (``ops/transforms``);
* :func:`eigsh_banded` / :func:`eigs_banded` are the one-call "give me
  eigenvalues of this concrete banded matrix" API, all spectral-transform
  modes included.

Every operator here but one whose solve took the host LU
(``BandedFactor.method == 'lu'``) is capturable: the device loop of
``eigsh`` replays its applies, BCR sweeps included, as CUDA graphs.

Banded storage follows the LAPACK/scipy ``ab[kl+ku+1, n]`` convention:
``ab[ku + i - j, j] == a[i, j]``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..config import pad_dim
from ..utils.device import DEFAULT, require
from . import transforms
from .bandsolve import BandedFactor, shifted_band
from .operator import Operator
from .sparse import dia_matvec_fn

#: below this dimension a host dense inverse (one product per apply) is
#: used; above it BCR, the only O(n*b) path
DENSE_CUTOFF = 1024


def _diagonals_from_ab(ab: np.ndarray, kl: int, ku: int, n: int):
    """Offsets and full-length diagonal arrays from LAPACK band storage.
    A negative diagonal is stored column-aligned, as the reference does:
    ``diag[j] = a[j - d, j]``."""
    offs, diags = [], []
    for d in range(-kl, ku + 1):
        row = ku - d
        diag = np.zeros(n, ab.dtype)
        if d >= 0:
            # a[i, i+d] = ab[ku - d, i + d] for i in 0..n-d-1
            diag[: n - d] = ab[row, d:n]
        else:
            diag[: n + d] = ab[row, : n + d]
        offs.append(d)
        diags.append(diag)
    return offs, diags


def _row_aligned(offs, diags, n: int):
    """The diagonals of :func:`_diagonals_from_ab` row-aligned, the DIA
    table's convention ``t[i] = a[i, i + d]``: a negative diagonal moves
    ``-d`` rows down."""
    out = []
    for d, diag in zip(offs, diags):
        if d < 0:
            t = np.zeros_like(diag)
            t[-d:] = diag[: n + d]
            diag = t
        out.append(diag)
    return out


def banded_matvec_fn(ab: np.ndarray, kl: int, ku: int, n: int, n_pad: int,
                     device=DEFAULT):
    """Device closure computing y = A x for the banded A (the dgbmv
    analog, EXAMPLES/BAND/dsband.f matvec): x and y have length
    ``n_pad``, y is zero past n.  The offsets ``-kl..ku`` are summed in
    that order, each product rounded on its own, as the reference's
    shift-multiply sweep (``arpack_ng_tpu/ops/banded.py:60-86``)."""
    offs, diags = _diagonals_from_ab(ab, kl, ku, n)
    return dia_matvec_fn(offs, _row_aligned(offs, diags, n), n, n_pad,
                         device=device)


def _ab_to_sparse(ab: np.ndarray, kl: int, ku: int, n: int) -> sp.spmatrix:
    offs, diags = _diagonals_from_ab(ab, kl, ku, n)
    mats = []
    for d, diag in zip(offs, diags):
        m = n - abs(d)
        mats.append(sp.diags(diag[:m], d, shape=(n, n)))
    return sum(mats).tocsr()


def banded_operator(ab, kl: int, ku: int, *, dtype=None,
                    hermitian: bool = False, n_pad: int = 0,
                    device=DEFAULT) -> Operator:
    """Mode-1 operator from LAPACK band storage, on ``device``."""
    device = require(device)
    ab = np.asarray(ab)
    if dtype is not None:
        ab = ab.astype(dtype)
    n = ab.shape[1]
    n_pad = n_pad or pad_dim(n)
    mv = banded_matvec_fn(ab, kl, ku, n, n_pad, device=device)

    def apply(v, bv):
        w = mv(v)
        return w, w

    return Operator(n=n, dtype=ab.dtype, apply=apply, bmat="I", mode=1,
                    a_apply=mv, n_pad=n_pad, hermitian=hermitian,
                    device=device, capturable=True)


def _banded_spectral_op(ab, mb, kl, ku, sigma, mode_num, sym, dtype,
                        solver: str = "auto", part: str = "real",
                        refine: int = 1, device=DEFAULT):
    """Build the OP/B pair for banded modes 2-5 (dsband types 2-6).

    ``solver``: 'auto' (dense inverse below :data:`DENSE_CUTOFF`, cyclic
    reduction above), 'dense', or 'cr'.  ``refine`` = iterative-refinement
    steps per CR solve (stability margin for indefinite shifts).
    """
    device = require(device)
    ab64 = np.asarray(ab)                       # native precision for factor
    ab = ab64 if dtype is None else ab64.astype(dtype)
    n = ab.shape[1]
    n_pad = pad_dim(n)
    if sigma is None and mb is None:
        return banded_operator(ab, kl, ku, hermitian=sym, device=device)
    mb64 = None if mb is None else np.asarray(mb)
    mb = None if mb is None else mb64.astype(ab.dtype)

    use_dense = solver == "dense" or (solver == "auto" and n <= DENSE_CUTOFF)
    if use_dense:
        a_sp = _ab_to_sparse(ab, kl, ku, n)
        m_sp = _ab_to_sparse(mb, kl, ku, n) if mb is not None else None
        if sigma is None:
            builder = transforms.build_sym_operator if sym \
                else transforms.build_nonsym_operator
            return builder(a_sp, M=m_sp, sigma=None, dtype=ab.dtype,
                           device=device)
        mode_name = {3: "normal", 4: "buckling", 5: "cayley"}[mode_num]
        if sym:
            return transforms.build_sym_operator(
                a_sp, M=m_sp, sigma=sigma, mode=mode_name, dtype=ab.dtype,
                device=device)
        return transforms.build_nonsym_operator(
            a_sp, M=m_sp, sigma=sigma, dtype=ab.dtype, part=part,
            device=device)

    # ---- scalable cyclic-reduction path (O(n*b) memory) ------------------
    a_mv = banded_matvec_fn(ab, kl, ku, n, n_pad, device=device)
    m_mv = None if mb is None else banded_matvec_fn(mb, kl, ku, n, n_pad,
                                                    device=device)
    if sigma is None:
        # mode 2: OP = inv(M) A, B = M — factor the banded M itself
        mfac = BandedFactor(mb64, kl, ku, dtype=ab.dtype, refine=refine, n=n,
                            device=device)

        def apply(v, bv, _a=a_mv, _mf=mfac):
            av = _a(v)
            return _mf.solve(av), av        # bw = A v (mode-2 shortcut)

        return Operator(n=n, dtype=ab.dtype, apply=apply, bmat="G", mode=2,
                        b_apply=m_mv, a_apply=a_mv, m_apply=m_mv,
                        n_pad=n_pad, hermitian=sym, device=device,
                        capturable=mfac.method == "cr")

    # shift-invert family: factor (A - sigma M) once on host in float64
    # (the dgbtrf step of dsband.f:463); device application = BCR sweeps
    sb, skl, sku = shifted_band(ab64, kl, ku, mb64, kl, ku, sigma, n)
    fac = BandedFactor(sb, skl, sku, dtype=ab.dtype, refine=refine, n=n,
                       device=device)
    if mb is None and mode_num == 5:
        m_mv = lambda v: v              # noqa: E731  (Cayley with M = I)
    if fac.realified:
        # complex sigma on a real problem: dnaupd modes 3/4 take the
        # real/imaginary part of inv(A - sigma M) M v (SRC/dnaupd.f:20-36)
        pick = 0 if part == "real" else 1
        solve = lambda b: fac.solve_parts(b)[pick]   # noqa: E731
    else:
        solve = fac.solve
    op = transforms.shift_invert_operator(
        n, ab.dtype, solve, sigma=sigma,
        mode=mode_num if sym else 3, n_pad=n_pad, hermitian=sym,
        a_apply=a_mv, m_apply=m_mv, device=device,
        capturable=fac.method == "cr")
    if (not sym) and fac.realified and part != "real":
        op = Operator(n=n, dtype=ab.dtype, apply=op.apply, bmat=op.bmat,
                      mode=4, b_apply=op.b_apply, a_apply=op.a_apply,
                      m_apply=op.m_apply, n_pad=n_pad, sigma=sigma,
                      hermitian=False, device=device,
                      capturable=op.capturable)
    return op


def eigsh_banded(ab, kl: int, ku: int, k: int = 6, *, mb=None,
                 sigma: Optional[float] = None, mode: str = "normal",
                 which: str = "LM", ncv: Optional[int] = None,
                 tol: float = 0.0, maxiter: int = 500, dtype=None,
                 return_eigenvectors: bool = True, seed: int = 0,
                 solver: str = "auto", refine: int = 1, v0=None,
                 return_stats: bool = False, device=DEFAULT):
    """dsband/ssband equivalent: symmetric banded eigensolver, modes 1-5,
    on ``device`` (the card unless told otherwise).

    ``solver='auto'`` picks a dense inverse below :data:`DENSE_CUTOFF`
    and O(n*b) block cyclic reduction above, the scalable analog of
    dsband's ``dgbtrf``/``dgbtrs``.  ``v0`` and ``return_stats`` are
    :func:`~arpack_ng_tpu_torch.eigsh`'s."""
    from .. import api
    mode_num = {"normal": 3, "buckling": 4, "cayley": 5}[mode]
    op = _banded_spectral_op(ab, mb, kl, ku, sigma, mode_num, True, dtype,
                             solver=solver, refine=refine, device=device)
    return api.eigsh(op, k=k, which=which, ncv=ncv, tol=tol,
                     maxiter=maxiter, seed=seed, v0=v0,
                     return_eigenvectors=return_eigenvectors,
                     return_stats=return_stats)


def eigs_banded(ab, kl: int, ku: int, k: int = 6, *, mb=None,
                sigma: Optional[complex] = None, which: str = "LM",
                ncv: Optional[int] = None, tol: float = 0.0,
                maxiter: int = 500, dtype=None,
                return_eigenvectors: bool = True, seed: int = 0,
                solver: str = "auto", part: str = "real",
                refine: int = 1, v0=None, return_stats: bool = False,
                device=DEFAULT):
    """dnband/znband equivalent: non-symmetric/complex banded solver on
    ``device`` (the card unless told otherwise).

    Complex ``sigma`` on a real problem routes through the realified
    cyclic-reduction solve; ``part`` selects dnaupd mode 3 ('real') vs
    mode 4 ('imag'), the dndrv5/dndrv6 pair.  ``v0`` and ``return_stats``
    are :func:`~arpack_ng_tpu_torch.eigs`'s."""
    from .. import api
    op = _banded_spectral_op(ab, mb, kl, ku, sigma, 3, False, dtype,
                             solver=solver, part=part, refine=refine,
                             device=device)
    return api.eigs(op, k=k, which=which, ncv=ncv, tol=tol,
                    maxiter=maxiter, seed=seed, v0=v0,
                    return_eigenvectors=return_eigenvectors,
                    return_stats=return_stats)
