"""The reduced space of one symmetric restart cycle: dseigt, dsgets,
dsconv, the zero-bound removal, nev inflation and the exact-shift sweep
with accumulated Q (dsapps), for the ``ncv x ncv`` tridiagonal of the
selective Lanczos loop (the ops the reference package runs on its device,
``arpack_ng_tpu/core/device_sym.py:104-149, 167-199``; kernel in
``csrc/sym_cycle.cu``, one launch of one block per cycle).

:func:`sym_cycle` reads the tridiagonal ``(a, b)`` (``b[i]`` couples rows
``i`` and ``i + 1``), the residual norm and the extension's breakdown
step, event counters and pair-rule flag from device memory and writes:

* ``Q`` ``(ncv, ncv)``: the accumulated shifts' orthogonal matrix, after
  the sign normalization; ``sk = (sigmak, betak)``, what the restart
  rotation and residual update read;
* ``a``, ``b``: the new tridiagonal, in place;
* ``packet`` (float64): what the host reads once per cycle, laid out by
  the ``P_*`` offsets below.

A cycle that ends the solve (``done`` or ``is_last``, or an eigensolver
failure, ``info = -8``) and an extension that stopped short (``brk`` not
-1: a breakdown step, or a doubtful event; the host finishes the extension
first and calls again) leave ``a``, ``b``, ``Q`` and ``sk`` untouched.

The plain twin, :func:`sym_cycle_plain`, is the numpy code the host loop
ran (``eigh``, a stable ``argsort``, ``np.linalg.qr`` per shift), on CPU
tensors; the kernel's QR follows LAPACK's conventions, so the two agree
to rounding. The wrapper launches the kernel for CUDA tensors of every
``ncv`` (the parts of its workspace that fit in shared memory there,
:func:`smem_parts`, the rest in a global-memory buffer the wrapper
allocates) and runs the twin for CPU tensors; ``launches`` counts the
kernel launches. A caller may pass ``clocks``, a CUDA int64 tensor of
:func:`clock_size` values, for the kernel's stamps (``clock64()``): the
:data:`CLOCKS` phase stamps, then per shift its sweep warp's start, last
reflector and last published entry, then per shift the end of its
``Q <- Q q``; the solver passes none.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import cuda_lib

#: packet offsets: exit flag, nconv, the next start k (nev_eff), np_eff,
#: info (0 or -8), the breakdown word (-1 for none), the pair-rule flag
#: at it, rnorm, the 4 event counters, then a, b, the which-sorted Ritz
#: values and their bounds (ncv each)
(P_DONE, P_NCONV, P_NEV, P_NP, P_INFO, P_BRK, P_FORCE, P_RNORM, P_CNT) = \
    range(9)
P_HEAD = 12
WHICH = {"LA": 0, "SA": 1, "LM": 2, "SM": 3, "BE": 4}
#: shared memory of one block on Hopper, less room for the kernel's static
#: progress words; the kernel's workspace (csrc/sym_cycle.cu) in two parts,
#: which claim it in order: the ncv-length vectors (in double the QL's 3
#: and a ring of R_SLOTS shifts' reflectors, tau and v1; in the compute
#: dtype 9 of the head and tail and a ring of T_SLOTS tridiagonals, d and
#: e), and the matrices (the packed q of each of the SWEEP_PAIRS column
#: warps, :func:`q_size`, then Q and its product, ncv x ncv each)
MAX_SMEM = 232448 - 256
SWEEP_PAIRS = 4
T_SLOTS = SWEEP_PAIRS + 1
R_SLOTS = 8
VECTORS = 9 + 2 * T_SLOTS
DVECTORS = 3 + 2 * R_SLOTS
#: the kernel's phase stamps: entry, QL, head (dsgets/dsconv), sweep, exit
CLOCKS = ("entry", "ql", "head", "sweep", "exit")


class Params(NamedTuple):
    which: str
    nev: int
    tol: float       # tol_effective, in the compute dtype
    eps23: float
    eps_m: float     # machine eps of the compute dtype
    inflate: bool = True


def packet_size(ncv: int) -> int:
    return P_HEAD + 4 * ncv


def clock_size(ncv: int) -> int:
    """Length of the kernel's optional stamp buffer."""
    return len(CLOCKS) + 4 * ncv


def q_size(ncv: int) -> int:
    """Values of one packed q: column c holds rows 0..min(c + 3, ncv - 1)
    (q is upper Hessenberg; the entry sums read two zeros past it)."""
    k0 = max(ncv - 4, 0)
    return k0 * (k0 + 7) // 2 + (ncv - k0) * ncv


def part_bytes(ncv: int, itemsize: int) -> tuple:
    """Bytes of the workspace's two parts, in the order they claim shared
    memory: the vectors, the matrices."""
    return (DVECTORS * ncv * 8 + VECTORS * ncv * itemsize,
            (SWEEP_PAIRS * q_size(ncv) + 2 * ncv * ncv) * itemsize)


def smem_parts(ncv: int, itemsize: int) -> int:
    """How many of the parts, claimed in order, fit in one block's shared
    memory (2: ncv <= 111 in float32, <= 78 in float64; 1: <= 1018, <=
    763)."""
    used, k = 0, 0
    for b in part_bytes(ncv, itemsize):
        if used + b > MAX_SMEM:
            break
        used, k = used + b, k + 1
    return k


def work_bytes(ncv: int, itemsize: int) -> int:
    """The kernel's whole workspace, in bytes."""
    return sum(part_bytes(ncv, itemsize))


def global_bytes(ncv: int, itemsize: int) -> int:
    """The bytes of the parts that do not fit in shared memory: the global
    buffer the wrapper passes (0: none)."""
    return sum(part_bytes(ncv, itemsize)[smem_parts(ncv, itemsize):])


def fits_shared(ncv: int, itemsize: int) -> bool:
    """Whether the whole workspace fits in one block's shared memory."""
    return smem_parts(ncv, itemsize) == 2


def which_key(which: str, vals):
    """Sort key: ascending order puts the WANTED nev last (dsortr)."""
    if which == "LA":
        return vals
    if which == "SA":
        return -vals
    if which == "LM":
        return np.abs(vals)
    if which == "SM":
        return -np.abs(vals)
    raise ValueError(f"device path does not support which={which!r}")


def be_arrange(vals_a, nev: int):
    """'BE' arrangement over the ascending order: [unwanted middle, low
    half, high half]; low share nev//2 (dsgets.f:166-171)."""
    ncv = vals_a.shape[0]
    iota = np.arange(ncv)
    lo = nev // 2
    hi = nev - lo
    np_ = ncv - nev
    src = np.where(iota < np_, lo + iota,
                   np.where(iota < np_ + lo, iota - np_,
                            (ncv - hi) + (iota - np_ - lo)))
    return vals_a[src]


class Head(NamedTuple):
    """dseigt + dsgets + dsconv + inflation of one tridiagonal."""

    T: np.ndarray        # (ncv, ncv) projected matrix
    evals: np.ndarray    # ascending eigenvalues of T
    S: np.ndarray        # eigenvectors of T (columns, matching evals)
    r_s: np.ndarray      # which-sorted Ritz values, nev0 arrangement
    b_s: np.ndarray      # matching bounds
    r_si: np.ndarray     # which-sorted with the INFLATED nev (differs
    b_si: np.ndarray     #   from r_s/b_s only for which='BE')
    nconv: int
    done: bool
    nev_eff: int         # after zero-bound removal + inflation
    np_eff: int


def head_plain(d, e, rnorm, p: Params) -> Head:
    """dsaup2's reduced work on ``T = tridiag(d, e)`` (dseigt, dsgets,
    dsconv, the zero-bound shift removal and the stagnation nev inflation,
    dsaup2.f:368-693), in numpy, in the dtype of ``d``."""
    return head_of(np.diag(d) + np.diag(e, 1) + np.diag(e, -1), rnorm, p)


def head_of(T, rnorm, p: Params) -> Head:
    """:func:`head_plain` on a symmetric ``T`` given whole (the thick
    restart's projected matrix), in the dtype of ``T``."""
    rdt = T.dtype
    ncv, nev0 = T.shape[0], p.nev
    np0 = ncv - nev0
    tol, eps23 = rdt.type(p.tol), rdt.type(p.eps23)
    evals, S = np.linalg.eigh(T)
    bounds = np.abs(rnorm * S[ncv - 1, :]).astype(rdt)
    if p.which == "BE":
        order_a = np.argsort(evals, kind="stable")
        r_a, b_a = evals[order_a], bounds[order_a]
        r_s, b_s = be_arrange(r_a, nev0), be_arrange(b_a, nev0)
    else:
        order = np.argsort(which_key(p.which, evals), kind="stable")
        r_s, b_s = evals[order], bounds[order]
    wanted, wb = r_s[np0:], b_s[np0:]
    nconv = int(np.sum(wb <= tol * np.maximum(eps23, np.abs(wanted))))
    # zero-bound unwanted (cannot be shifted away)
    nz = int(np.sum(b_s[:np0] == 0))
    np_eff = np0 - nz
    nev_eff = nev0 + nz
    done = nconv >= nev0 or np_eff == 0
    if p.inflate:
        # stagnation guard: nev inflation (dsaup2.f:673-693)
        nev_inf = nev_eff + min(nconv, np_eff // 2)
        if nev_inf == 1 and ncv >= 6:
            nev_inf = ncv // 2
        elif nev_inf == 1 and ncv > 3:
            nev_inf = 2
        nev_eff = min(nev_inf, ncv - 1)
        np_eff = ncv - nev_eff
    if p.which == "BE":
        # the BE split moves with the inflated nev (dsaup2.f:690-693)
        r_si, b_si = be_arrange(r_a, nev_eff), be_arrange(b_a, nev_eff)
    else:
        r_si, b_si = r_s, b_s
    return Head(T=T, evals=evals, S=S, r_s=r_s, b_s=b_s, r_si=r_si,
                b_si=b_si, nconv=nconv, done=done, nev_eff=nev_eff,
                np_eff=np_eff)


def shifts_plain(T, r_si, b_si, nev_eff: int, np_eff: int, p: Params,
                 shifts=None):
    """The shift sweep of dsapps on the tridiagonal T: each shift one QR
    step on T with Q accumulated; then the deflation sweep and the
    subdiagonal sign normalization.  The exact shifts (``shifts=None``):
    the np_eff least-wanted values of the which-sorted ``r_si`` (bounds
    ``b_si``), largest Ritz estimate first; or the leading np_eff of the
    caller's ``shifts`` (the ido=3 protocol), in the given order.  Returns
    ``(Q, d, e, sigmak, betak)``."""
    rdt = T.dtype
    ncv = T.shape[0]
    np0 = ncv - p.nev
    eps_m = rdt.type(p.eps_m)
    active = (np.arange(ncv) < np_eff)[:np0]
    if shifts is None:
        skey = np.where(active, -np.abs(b_si[:np0]), rdt.type(np.inf))
        shifts = r_si[:np0][np.argsort(skey, kind="stable")]
    eyek = np.eye(ncv, dtype=rdt)
    Tc, Q = T, eyek
    for mu, act in zip(shifts, active):
        if not act:
            continue
        q, _ = np.linalg.qr(Tc - mu * eyek)
        Tn = q.T @ Tc @ q
        dn = np.diag(Tn)
        en = 0.5 * (np.diag(Tn, 1) + np.diag(Tn, -1))
        Tc = np.diag(dn) + np.diag(en, 1) + np.diag(en, -1)
        Q = Q @ q
    dn = np.diag(Tc).copy()
    en = np.diag(Tc, -1).copy()
    # deflation sweep (dsapps.f:430-443)
    big = np.abs(dn[:-1]) + np.abs(dn[1:])
    en = np.where(np.abs(en) <= eps_m * big, rdt.type(0), en)
    # subdiagonal sign normalization via a diagonal similarity
    sgn = np.where(en >= 0, rdt.type(1), rdt.type(-1))
    phi = np.concatenate([np.ones(1, rdt), np.cumprod(sgn)])
    en = np.abs(en)
    Q = (Q * phi[None, :]).astype(rdt)
    sigmak = Q[ncv - 1, nev_eff - 1]
    betak = en[nev_eff - 1] if nev_eff < ncv else rdt.type(0)
    return Q, dn, en, sigmak, betak


def _check(a, b, rnorm, brk, force, cnt, Q, sk, packet):
    ncv = a.shape[0]
    if a.dim() != 1 or b.shape != (ncv,) or b.dtype != a.dtype \
            or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous (ncv,) vectors of one "
                         "dtype")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"no reduced-space kernel for {a.dtype}")
    if rnorm.shape != () or rnorm.dtype != a.dtype:
        raise ValueError("rnorm must be a 0-d tensor of a's dtype")
    if brk.shape != () or force.shape != () or brk.dtype != torch.int32 \
            or force.dtype != torch.int32:
        raise ValueError("brk and force must be 0-d int32 tensors")
    if cnt.shape != (4,) or cnt.dtype != torch.int64:
        raise ValueError("cnt must be an int64 (4,) tensor")
    if Q.shape != (ncv, ncv) or Q.dtype != a.dtype or not Q.is_contiguous():
        raise ValueError(f"Q must be a contiguous ({ncv}, {ncv}) matrix")
    if sk.shape != (2,) or sk.dtype != a.dtype:
        raise ValueError("sk must be a (2,) vector of a's dtype")
    if packet.shape != (packet_size(ncv),) or packet.dtype != torch.float64 \
            or not packet.is_contiguous():
        raise ValueError(f"packet must be a contiguous float64 vector of "
                         f"{packet_size(ncv)}")
    devs = {t.device for t in (a, b, rnorm, brk, force, cnt, Q, sk, packet)}
    if len(devs) != 1:
        raise ValueError("every tensor must be on one device")


def sym_cycle_plain(a, b, rnorm, brk, force, cnt, Q, sk, packet,
                    p: Params, is_last: bool) -> None:
    """Plain twin of :func:`sym_cycle` on CPU tensors: the numpy code of
    the host loop (:func:`head_plain`, :func:`shifts_plain`)."""
    ncv = a.shape[0]
    pk = np.zeros(packet_size(ncv))
    pk[P_BRK], pk[P_FORCE] = int(brk), int(force)
    pk[P_RNORM] = float(rnorm)
    pk[P_CNT:P_CNT + 4] = cnt.numpy()
    if pk[P_BRK] == -1:
        d, e = a.numpy().copy(), b.numpy()[:ncv - 1].copy()
        h = head_plain(d, e, rnorm.numpy()[()], p)
        pk[P_DONE], pk[P_NCONV] = h.done, h.nconv
        pk[P_NEV], pk[P_NP] = h.nev_eff, h.np_eff
        pk[P_HEAD + 2 * ncv:P_HEAD + 3 * ncv] = h.r_s
        pk[P_HEAD + 3 * ncv:] = h.b_s
        if not (h.done or is_last):
            Qn, d, e, sigmak, betak = shifts_plain(h.T, h.r_si, h.b_si,
                                                   h.nev_eff, h.np_eff, p)
            Q.copy_(torch.from_numpy(Qn))
            a.copy_(torch.from_numpy(d))
            b[:ncv - 1] = torch.from_numpy(e)
            sk.copy_(torch.from_numpy(np.array([sigmak, betak], d.dtype)))
        pk[P_HEAD:P_HEAD + ncv] = d
        pk[P_HEAD + ncv:P_HEAD + 2 * ncv - 1] = e
        pk[P_HEAD + 2 * ncv - 1] = pk[P_RNORM]
    packet.copy_(torch.from_numpy(pk))


def sym_cycle(a, b, rnorm, brk, force, cnt, Q, sk, packet, p: Params,
              is_last: bool, clocks=None) -> None:
    """One cycle's reduced space (see the module note); on a CUDA device
    one kernel launch on the current stream, nothing read back."""
    _check(a, b, rnorm, brk, force, cnt, Q, sk, packet)
    ncv = a.shape[0]
    if clocks is not None and (clocks.shape != (clock_size(ncv),)
                               or clocks.dtype != torch.int64
                               or clocks.device != a.device):
        raise ValueError(f"clocks must be an int64 ({clock_size(ncv)},) "
                         "tensor on a's device")
    if a.device.type == "cpu":
        return sym_cycle_plain(a, b, rnorm, brk, force, cnt, Q, sk, packet,
                               p, is_last)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    work = None
    nbytes = global_bytes(ncv, a.element_size())
    if nbytes:
        work = torch.empty(nbytes, dtype=torch.uint8, device=a.device)
    lib = cuda_lib.load()
    err = lib.atpt_sym_cycle(
        cuda_lib.dtype_code(a.dtype, a.dtype), ncv, p.nev, WHICH[p.which],
        int(p.inflate), int(is_last), p.tol, p.eps23, p.eps_m, a.data_ptr(),
        b.data_ptr(), rnorm.data_ptr(), brk.data_ptr(), force.data_ptr(),
        cnt.data_ptr(), Q.data_ptr(), sk.data_ptr(), packet.data_ptr(),
        None if work is None else work.data_ptr(),
        None if clocks is None else clocks.data_ptr(),
        cuda_lib.stream_handle(a.device))
    cuda_lib.check(lib, err, "sym_cycle")
    sym_cycle.launches += 1


sym_cycle.launches = 0
