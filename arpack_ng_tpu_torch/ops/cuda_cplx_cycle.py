"""The reduced space of one complex restart cycle: zneigh (the complex
Schur form by Wilkinson single-shift QR sweeps and the Ritz bounds by
dtrevc's back-substitution), zngets (the which-sort), znconv, the
zero-bound removal, nev inflation and znapps' explicit shifts with
accumulated Q, for the ``ncv x ncv`` complex Hessenberg of the dgks
Arnoldi loop (the ops the reference package runs on its device,
``arpack_ng_tpu/core/device_nonsym.py:104-154, 157-199, 233-291``; kernel
in ``csrc/cplx_cycle.cu``, one launch of one block per cycle).

:func:`cplx_cycle` reads the Hessenberg ``H``, the residual norm and the
extension's breakdown step, pair-rule flag and counters from device
memory and writes:

* ``Q`` ``(ncv, ncv)``: the accumulated shifts' unitary matrix; ``sk =
  (sigmak, betak) = (Q[ncv-1, nev_eff-1], Hc[nev_eff, nev_eff-1])``, what
  the restart rotation and residual update read;
* ``H``: the shifted Hessenberg ``Hc``, in place;
* ``packet`` (float64): what the host reads once per cycle, laid out by
  the ``P_*`` offsets below: the header of ``cuda_sym_cycle`` (exit flag,
  nconv, nev_eff, np_eff, info, breakdown word, pair-rule flag, rnorm,
  the 4 counters), the which-sorted Ritz values' real and imaginary parts
  and their bounds (wanted last), then ``H`` as the cycle leaves it
  (row-major, real and imaginary parts interleaved), which an exit hands
  back as the state's.

A cycle that ends the solve (``done`` or ``is_last``) and an extension
that stopped short (``brk`` not -1) leave ``H``, ``Q`` and ``sk``
untouched.

The arithmetic runs in complex128 whatever the problem dtype, and the
results are rounded to it; the thresholds (the deflation tests, dtrevc's
clamp, the convergence test) are the problem dtype's.  The plain twin,
:func:`cplx_cycle_plain`, is the numpy code the host loop ran
(``np.linalg.qr`` per sweep and per shift, ``solve_triangular`` per Ritz
value), in complex128, on CPU tensors; in a complex128 problem it is the
reference's order of operations.  The kernel's QR follows LAPACK's
conventions (zlarfg's ``beta = -sign(Re alpha) dlapy3(Re alpha, Im alpha,
|x|)`` and complex ``tau``, zung2r's backward accumulation), so Q's column
phases, and sigmak's, agree with the twin's.  The wrapper launches the
kernel for CUDA tensors of every ``ncv`` (its workspace in shared memory
up to :func:`max_shared_ncv`, else in a global buffer the wrapper
allocates) and runs the twin for CPU tensors; ``launches`` counts the
kernel launches.  A caller may pass ``clocks``, an int64 tensor of
:func:`clock_size` values on H's device, for the kernel's stamps
(``clock64()``, SM cycles): the :data:`CLOCKS` phase ends, then the
cycles of the QR steps' :data:`LAPS` summed over the Schur sweeps and the
chase's shifts, then the :data:`COUNTS`; the twin ignores it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.linalg as sla
import torch

from . import cuda_lib, reduced_space
from .cuda_sym_cycle import (P_BRK, P_CNT, P_DONE, P_FORCE,  # noqa: F401
                             P_INFO, P_NCONV, P_NEV, P_NP, P_RNORM)
from .reduced_space import SWEEPS_PER_EV, WHICH  # noqa: F401

#: packet offsets past the shared header: the sorted real parts, imaginary
#: parts and bounds (ncv each), then H's (re, im) pairs
P_HEAD = 12
#: the kernel's workspace (csrc/cplx_cycle.cu), in doubles: five complex
#: ncv x ncv matrices (the working T or Hc, the QR step's new T, its q, the
#: chase's Q and Q q; rows ncv | 1 entries apart, an odd stride) and VECTORS
#: doubles per row (the reflectors, the Schur vectors' last row and its
#: product, the shifts, the chain's row past its registers, and the product
#: warps' columns of X, which the phases after the QR steps reuse)
MATRICES = 5
VECTORS = 24
#: the kernel's phase stamps (a cycle that exits early stamps its exit in
#: every later one); warp 0's SM cycles summed over the Schur sweeps and the
#: chase's shifts: the shift choice (the deflation and the Wilkinson shift;
#: in the chase the deflation after each shift), the reflector chain (a QR
#: step's start to its last reflector) and the tail (the chain's end to the
#: step's block barrier: q's last columns and the products behind them);
#: and its counts of Schur sweeps and chase shifts
CLOCKS = ("entry", "schur", "trevc", "gets", "chase", "exit")
LAPS = ("shift", "chain", "tail")
COUNTS = ("sweeps", "shifts")


class Params(NamedTuple):
    which: str
    nev: int
    tol: float      # tol_effective, rounded to the problem's real dtype
    eps23: float    # the convergence floor
    eps_m: float    # machine eps of the problem dtype (deflations, clamp)


def packet_size(ncv: int) -> int:
    return P_HEAD + 3 * ncv + 2 * ncv * ncv


def clock_size(ncv: int) -> int:
    """Length of the kernel's optional stamp buffer (any ncv)."""
    return reduced_space.clock_size(CLOCKS, LAPS, COUNTS)


def work_bytes(ncv: int) -> int:
    """The kernel's whole workspace, in bytes."""
    return (MATRICES * 2 * ncv * (ncv | 1) + VECTORS * ncv) * 8


def fits_shared(ncv: int) -> bool:
    """Whether the workspace fits in one block's shared memory."""
    return reduced_space.fits_shared(work_bytes, ncv)


def max_shared_ncv() -> int:
    """The largest ncv whose workspace fits in shared memory (52)."""
    return reduced_space.max_shared_ncv(work_bytes)


# ---- the host loop's numpy reduced space --------------------------------

def which_key(which: str, vals):
    """Sort key on complex values; ascending puts the WANTED values last."""
    if which == "LM":
        return np.abs(vals)
    if which == "SM":
        return -np.abs(vals)
    if which == "LR":
        return vals.real
    if which == "SR":
        return -vals.real
    if which == "LI":
        return vals.imag
    if which == "SI":
        return -vals.imag
    raise ValueError(f"bad which={which!r}")


def deflate(T, eps):
    """Zero negligible subdiagonals; returns ``(T', keep)``, ``keep[i]``
    for each subdiagonal that stays."""
    sub = np.diag(T, -1)
    d = np.diag(T)
    big = np.abs(d[:-1]) + np.abs(d[1:])
    big = np.where(big == 0, np.ones_like(big), big)
    keep = np.abs(sub) > eps * big
    sub2 = np.where(keep, sub, np.zeros_like(sub))
    return np.triu(T, 0) + np.diag(sub2, -1), keep


def make_hessenberg_schur(k: int, cdt, sweeps: int, eps=None):
    """Schur decomposition of a complex Hessenberg matrix:
    ``schur(H) -> (T upper-triangular, Q unitary)``, ``H = Q T Q^H``, in
    the dtype ``cdt``; ``eps``: the deflation threshold (default ``cdt``'s
    machine eps).  A sweep with no active subdiagonal changes nothing, so
    the loop stops at the first one."""
    cdt = np.dtype(cdt)
    rdt = np.finfo(cdt).dtype
    eps = rdt.type(np.finfo(cdt).eps if eps is None else eps)
    eye = np.eye(k, dtype=cdt)
    idx1 = np.arange(k - 1)

    def schur(H):
        T, Q = H.astype(cdt), eye
        for _ in range(sweeps):
            T, keep = deflate(T, eps)
            if not keep.any():
                break
            # the trailing active 2x2: the largest i with keep[i]
            m = max(int(np.max(np.where(keep, idx1, -1))), 0)
            a11, a12 = T[m, m], T[m, m + 1]
            a21, a22 = T[m + 1, m], T[m + 1, m + 1]
            tr = a11 + a22
            det = a11 * a22 - a12 * a21
            disc = np.sqrt(tr * tr / 4.0 - det)
            mu1 = tr / 2.0 + disc
            mu2 = tr / 2.0 - disc
            mu = mu1 if np.abs(mu1 - a22) < np.abs(mu2 - a22) else mu2
            q, _ = np.linalg.qr(T - mu * eye)
            T = np.triu(q.conj().T @ T @ q, -1)     # re-Hessenberg
            Q = Q @ q
        T, _ = deflate(T, eps)
        return T, Q

    return schur


def make_last_components(k: int, cdt, eps=None):
    """``last_comps(T, Q)``: for every eigenvalue ``lambda_i = T[i, i]`` of
    the Schur pair (T, Q) of H, the modulus of the LAST component of the
    unit eigenvector of H, which dneigh feeds the Ritz bounds.

    The eigenvector of T for lambda_i: ``z[:i]`` solves ``(T[:i, :i] -
    lambda_i) u = -T[:i, i]``, ``z[i] = 1``, ``z[i+1:] = 0``; diagonal
    entries of modulus below ``eps max(max|T|, 1)`` are clamped to it
    (dtrevc's smallnum, for degenerate eigenvalues; ``eps`` defaults to
    ``cdt``'s machine eps)."""
    cdt = np.dtype(cdt)
    rdt = np.finfo(cdt).dtype
    eps = rdt.type(np.finfo(cdt).eps if eps is None else eps)

    def last_comps(T, Q):
        tnorm = np.maximum(np.max(np.abs(T)), rdt.type(1))
        small = eps * tnorm
        lam = np.diag(T)
        qlast = Q[k - 1, :]
        out = np.zeros(k, rdt)
        for i in range(k):
            z = np.zeros(k, cdt)
            z[i] = 1
            if i > 0:
                M = T[:i, :i] - lam[i] * np.eye(i, dtype=cdt)
                d = np.diag(M)
                dsafe = np.where(np.abs(d) < small, small.astype(cdt), d)
                M[np.arange(i), np.arange(i)] = dsafe
                z[:i] = sla.solve_triangular(M, -T[:i, i], lower=False)
            znorm = np.sqrt(np.abs(np.vdot(z, z)))
            out[i] = np.abs(qlast @ z) / znorm
        return out

    return last_comps


class Head(NamedTuple):
    """zneigh + zngets + znconv + inflation of one Hessenberg matrix."""

    r_s: np.ndarray      # (ncv,) which-sorted Ritz values, wanted last
    b_s: np.ndarray      # bounds
    nconv: int
    done: bool
    nev_eff: int         # after the zero-bound removal and inflation
    np_eff: int


def head_plain(H, rnorm, p: Params) -> Head:
    """znaup2's reduced work on ``H`` (complex128) from zneigh through the
    shift count (the Schur form, the Ritz values and bounds, zngets,
    znconv, the zero-bound shift removal and nev inflation), in numpy, in
    complex128."""
    ncv, nev0 = H.shape[0], p.nev
    np0 = ncv - nev0
    cdt = np.complex128
    R = np.float64
    T, Qs = make_hessenberg_schur(ncv, cdt, SWEEPS_PER_EV * ncv,
                                  p.eps_m)(H)
    lam = np.diag(T)
    bounds = (rnorm * make_last_components(ncv, cdt, p.eps_m)(T, Qs)
              ).astype(R)
    # ---- zngets: wanted last ----
    order = np.argsort(which_key(p.which, lam), kind="stable")
    r_s, b_s = lam[order], bounds[order]
    # ---- znconv over the nev0 wanted ----
    wanted, wb = r_s[np0:], b_s[np0:]
    nconv = int(np.sum(wb <= R(p.tol) * np.maximum(R(p.eps23),
                                                   np.abs(wanted))))
    nz = int(np.sum(b_s[:np0] == 0))
    np_eff, nev_eff = np0 - nz, nev0 + nz
    done = nconv >= nev0 or np_eff == 0
    # ---- nev inflation (znaup2.f, as dsaup2.f:673-693) ----
    nev_inf = nev_eff + min(nconv, np_eff // 2)
    if nev_inf == 1 and ncv >= 6:
        nev_inf = ncv // 2
    elif nev_inf == 1 and ncv > 3:
        nev_inf = 2
    nev_eff = min(nev_inf, ncv - 1)
    np_eff = ncv - nev_eff
    return Head(r_s=r_s, b_s=b_s, nconv=nconv, done=done, nev_eff=nev_eff,
                np_eff=np_eff)


def shift_pool(h, nev0: int):
    """The shifts znapps applies, in order: the np_eff least-wanted values,
    largest bound first (stably)."""
    ncv = h.r_s.shape[0]
    np0 = ncv - nev0
    active = (np.arange(ncv) < h.np_eff)[:np0]
    skey = np.where(active, -np.abs(h.b_s[:np0]), np.float64(np.inf))
    shifts = h.r_s[:np0][np.argsort(skey, kind="stable")]
    return [mu for mu, act in zip(shifts, active) if act]


def shifts_plain(H0, h, p: Params):
    """znapps on ``H0`` (complex128) with the shifts of :func:`shift_pool`:
    one explicit complex QR each, with deflation after each
    (dnapps.f:328-336).  Returns ``(Hc, Q)``."""
    ncv = H0.shape[0]
    eye = np.eye(ncv, dtype=np.complex128)
    eps_m = np.float64(p.eps_m)
    Hc, Q = H0.astype(np.complex128), eye
    for mu in shift_pool(h, p.nev):
        q, _ = np.linalg.qr(Hc - mu * eye)
        Hc, _ = deflate(np.triu(q.conj().T @ Hc @ q, -1), eps_m)
        Q = Q @ q
    return Hc, Q


def _check(H, rnorm, brk, force, cnt, Q, sk, packet):
    reduced_space.check_buffers(
        H, rnorm, brk, force, cnt, Q, sk, packet,
        dtypes=(torch.complex64, torch.complex128),
        rnorm_dtype=(torch.float32 if H.dtype == torch.complex64
                     else torch.float64),
        min_ncv=2, packet_size=packet_size(H.shape[0] if H.dim() else 0),
        what="complex reduced-space")


def cplx_cycle_plain(H, rnorm, brk, force, cnt, Q, sk, packet, p: Params,
                     is_last: bool) -> None:
    """Plain twin of :func:`cplx_cycle` on CPU tensors: the numpy code of
    the host loop (:func:`head_plain`, :func:`shifts_plain`)."""
    ncv = H.shape[0]
    pk = np.zeros(packet_size(ncv))
    pk[P_BRK], pk[P_FORCE] = int(brk), int(force)
    pk[P_RNORM] = float(rnorm)
    pk[P_CNT:P_CNT + 4] = cnt.numpy()
    if pk[P_BRK] == -1:
        H0 = H.numpy().astype(np.complex128)
        h = head_plain(H0, np.float64(rnorm.numpy()[()]), p)
        pk[P_DONE], pk[P_NCONV] = h.done, h.nconv
        pk[P_NEV], pk[P_NP] = h.nev_eff, h.np_eff
        pk[P_HEAD:P_HEAD + ncv] = h.r_s.real
        pk[P_HEAD + ncv:P_HEAD + 2 * ncv] = h.r_s.imag
        pk[P_HEAD + 2 * ncv:P_HEAD + 3 * ncv] = h.b_s
        if not (h.done or is_last):
            Hc, Qn = shifts_plain(H0, h, p)
            k = h.nev_eff
            H.copy_(torch.from_numpy(Hc))
            Q.copy_(torch.from_numpy(Qn))
            sk.copy_(torch.from_numpy(np.array([Qn[ncv - 1, k - 1],
                                                Hc[k, k - 1]])))
        pk[P_HEAD + 3 * ncv:] = torch.view_as_real(H).reshape(-1).numpy()
    packet.copy_(torch.from_numpy(pk))


def cplx_cycle(H, rnorm, brk, force, cnt, Q, sk, packet, p: Params,
               is_last: bool, clocks=None) -> None:
    """One cycle's reduced space (see the module note); on a CUDA device
    one kernel launch on the current stream, nothing read back."""
    _check(H, rnorm, brk, force, cnt, Q, sk, packet)
    ncv = H.shape[0]
    reduced_space.check_call(H, p.which, clocks, clock_size(ncv))
    if not 1 <= p.nev < ncv:
        raise ValueError(f"nev={p.nev} must lie in [1, ncv)")
    if H.device.type == "cpu":
        return cplx_cycle_plain(H, rnorm, brk, force, cnt, Q, sk, packet, p,
                                is_last)
    if H.device.type != "cuda":
        raise ValueError(f"no kernel for device {H.device}")
    work = None
    if not fits_shared(ncv):
        work = torch.empty(work_bytes(ncv), dtype=torch.uint8,
                           device=H.device)
    lib = cuda_lib.load()
    err = lib.atpt_cplx_cycle(
        cuda_lib.dtype_code(rnorm.dtype, rnorm.dtype), ncv, p.nev,
        WHICH[p.which], int(is_last), SWEEPS_PER_EV * ncv, p.tol, p.eps23,
        p.eps_m, H.data_ptr(), rnorm.data_ptr(), brk.data_ptr(),
        force.data_ptr(), cnt.data_ptr(), Q.data_ptr(), sk.data_ptr(),
        packet.data_ptr(), None if work is None else work.data_ptr(),
        None if clocks is None else clocks.data_ptr(),
        cuda_lib.stream_handle(H.device))
    cuda_lib.check(lib, err, "cplx_cycle")
    cplx_cycle.launches += 1


cplx_cycle.launches = 0
