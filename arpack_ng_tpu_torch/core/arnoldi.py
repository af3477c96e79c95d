"""Lanczos factorization engine for symmetric problems: ``dsaitr`` +
``dgetv0`` (port of ``arpack_ng_tpu/core/arnoldi.py``).

The loop runs on the host and the O(n) work on the operator's device:
the matvec, the three-term recurrence, the reorthogonalization passes,
the restart rotation and the norms.  The per-step decisions — Simon's
omega recurrence, whether a step needs a reorthogonalization event, the
event's row bucket, the DGKS test — are taken on the host from scalars
read back once per step (twice on a step with an event).

What the reference package computes and counts is kept exactly: the
8-row buckets of the CGS passes and of the eta-subset events, the pair
rule, the ``8*log2(n)*eps`` omega noise floor with its
``ARPACK_TPU_OMEGA_NOISE_MODEL`` hatch, ``eta_sub``, the event hatches
``ARPACK_TPU_FULL_REORTH`` and ``ARPACK_TPU_SEL_EXTRA_BUCKET``, the full
fallback pass, and ``cgs_kernel='pallas'``, which sends the 8-, 16- and
24-row buckets of the CGS passes (the dgks step and the selective step's
full fallback) to the kernels of ``csrc/cgs.cu`` on real float32
problems.  The basis is stored row-major as ``(ncv, n_pad)``; the
reference's 3-D ``(ncv, n_pad/128, 128)`` layout was a TPU tiling fix and
has the same element order.

The state is updated in place: ``extend`` writes the new basis rows into
``state.V`` and the restart rotation overwrites ``state.V``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..config import IRAMConfig
from ..ops.cuda_cgs import MAX_FAST_ROWS, cgs_proj, cgs_update
from ..ops.cuda_rot import rotate_rows
from ..ops.cuda_sel import sel_proj, sel_update
from ..ops.operator import Operator
from ..utils import dtypes as _dt
from ..utils.device import require
from ..utils.precision import pin_full_precision
from ..utils.stats import OpCounts

# Max refinement passes in the Lanczos step: 1 initial + 1 extra
# (SRC/dsaitr.f:771).
_MAX_DGKS_PASSES = 2
# Max refinement iterations in start-vector orthogonalization
# (SRC/dgetv0.f:~330).
_MAX_GETV0_REFINE = 5
# Max random-restart attempts on invariant-subspace breakdown
# (SRC/dsaitr.f:414).
_MAX_RESTART_TRIES = 3
#: row-bucket granularity of CGS passes, events and restart rotations
_BUCKET = 8


@dataclasses.dataclass
class FactorizationState:
    """The solver state between steps and cycles.

    ``V``, ``resid`` and ``b_resid`` live on the operator's device; the
    reduced quantities (``H``, ``rnorm``) and the counters live on the
    host.  ``gen`` draws restart vectors (SRC/dgetv0.f)."""

    V: torch.Tensor          # (ncv, n_pad) basis rows, storage dtype
    H: np.ndarray            # (ncv, ncv) projected matrix, compute dtype
    resid: torch.Tensor      # (n_pad,) current residual r_k
    b_resid: torch.Tensor    # (n_pad,) B @ resid (the same tensor for 'I')
    rnorm: np.floating       # B-norm of resid, real compute dtype
    k: int                   # current factorization length
    nev_cur: int             # current nev (dynamic inflation)
    iter: int                # restart (major) iteration counter
    info: int                # 0 ok; >0 invariant-subspace size; <0 error
    gen: torch.Generator     # restart-vector generator
    counts: OpCounts

    def replace(self, **changes) -> "FactorizationState":
        return dataclasses.replace(self, **changes)


def v_matrix(V: torch.Tensor) -> np.ndarray:
    """Host matrix view (ncv, n_pad) of the basis."""
    if V.dtype == torch.bfloat16:
        V = V.float()
    return V.detach().cpu().numpy()


def bucket_rows(ncv: int) -> list:
    """Row counts of the 8-row buckets (the last one is ncv)."""
    nb = max(1, -(-ncv // _BUCKET))
    return [min((b + 1) * _BUCKET, ncv) for b in range(nb)]


def rotate_basis_kev(Q: torch.Tensor, V: torch.Tensor, kev: int,
                     need_next: bool = True):
    """Restart rotation computing only the surviving rows (dsapps parity,
    SRC/dsapps.f:445-481): rows ``0..kev`` (with ``need_next``) of
    ``Q^T V``, bucketed up to a multiple of 8, written into V in place by
    the rotation kernel.  Rows past the bucket keep stale values, which
    are never read.

    Returns ``(V, v_next_row, rows_written)``; ``v_next_row`` is row
    ``kev`` of the rotated basis (a view, storage dtype)."""
    ncv = Q.shape[0]
    rows_list = bucket_rows(ncv)
    nrows = kev + (1 if need_next else 0)
    if len(rows_list) == 1:
        R = ncv
    else:
        R = rows_list[min((max(nrows, 1) - 1) // _BUCKET,
                          len(rows_list) - 1)]
    rotate_rows(Q, V, R)
    return V, V[min(kev, R - 1)], R


def _host(t: torch.Tensor, rdt) -> np.floating:
    """One scalar read back from the device, in the real compute dtype."""
    return np.dtype(rdt).type(t.item())


def make_bnorm(op: Operator, cfg: IRAMConfig):
    """Norm closure ``bnorm(r, br) -> 0-d tensor``: ``sqrt(|<r, B r>|)``
    (SRC/dsaitr.f:634-639), or with ``cfg.safe_norms`` on a standard
    problem the overflow-safe two-phase norm of PARPACK's pdnorm2."""
    if not (cfg.safe_norms and op.bmat == "I"):
        return lambda r, br: torch.sqrt(torch.abs(torch.dot(r, br)))
    tiny = _dt.safmin(cfg.dtype)

    def bnorm(r, br):
        m = torch.max(torch.abs(r))
        msafe = torch.clamp_min(m, tiny)
        scaled = r / msafe
        nrm = msafe * torch.sqrt(torch.abs(torch.dot(scaled, scaled)))
        return torch.where(m > 0, nrm, torch.zeros_like(nrm))

    return bnorm


def _random_vector(gen: torch.Generator, n_pad: int, n: int, dtype,
                   device) -> torch.Tensor:
    """Uniform(-1, 1) start vector (dlarnv idist=2, SRC/dgetv0.f:224-229),
    zero on the pad.  Drawn on the host generator, so a seed gives the same
    vector on every device."""
    rdt = _dt.torch_dtype(_dt.real_dtype(dtype))
    v = torch.rand(n_pad, generator=gen, dtype=rdt) * 2 - 1
    v[n:] = 0
    return v.to(device=device, dtype=_dt.torch_dtype(dtype))


def _check_slice(op: Operator, cfg: IRAMConfig) -> None:
    if _dt.is_complex(cfg.dtype):
        raise NotImplementedError("complex dtypes are not ported yet")
    if not cfg.symmetric:
        raise NotImplementedError("non-symmetric problems are not ported "
                                  "yet")
    if op.n != cfg.n or op.n_pad != cfg.n_pad:
        raise ValueError("operator/config dimension mismatch")
    require(op.device)


def make_init(op: Operator, cfg: IRAMConfig):
    """Build the state initializer (dgetv0, j=1 path):
    ``init(gen=None, v0=None)``; ``v0`` (length n_pad) plays the role of
    the reference's user-supplied ``resid`` (SRC/dsaupd.f:243-246)."""
    _check_slice(op, cfg)
    pin_full_precision()
    ncv, n_pad, n = cfg.ncv, cfg.n_pad, cfg.n
    dtype = cfg.dtype
    tdt = _dt.torch_dtype(dtype)
    sdt = _dt.torch_dtype(cfg.storage_dtype or dtype)
    rdt = _dt.real_dtype(dtype)
    nbx1 = 1 if op.bmat == "G" else 0
    bnorm = make_bnorm(op, cfg)
    device = op.device

    def init(gen: Optional[torch.Generator] = None, v0=None
             ) -> FactorizationState:
        if gen is None:
            gen = torch.Generator().manual_seed(cfg.seed)
        if v0 is None:
            r0 = _random_vector(gen, n_pad, n, dtype, device)
        else:
            r0 = torch.as_tensor(v0).to(device=device, dtype=tdt)
        # force the start vector into the range of OP (SRC/dgetv0.f:233-246)
        br0 = op.b_apply(r0)
        w, _ = op.apply(r0, br0)
        resid = w
        b_resid = op.b_apply(resid) if nbx1 else resid
        rnorm = _host(bnorm(resid, b_resid), rdt)
        return FactorizationState(
            V=torch.zeros((ncv, n_pad), dtype=sdt, device=device),
            H=np.zeros((ncv, ncv), dtype),
            resid=resid, b_resid=b_resid, rnorm=rnorm,
            k=0, nev_cur=cfg.nev, iter=0,
            # rnorm == 0 is the reference's info = -9 (SRC/dsaup2.f:332-341)
            info=0 if rnorm > 0 else -9,
            gen=gen,
            counts=OpCounts(nopx=1, nbx=2 * nbx1))

    return init


def make_extend(op: Operator, cfg: IRAMConfig):
    """Build ``extend(state, k_end)``: extend a ``state.k``-step Lanczos
    factorization to ``k_end`` steps (dsaitr).

    ``reorth='selective'`` runs the three-term recurrence with Simon's
    omega recurrence and eta-subset reorthogonalization events
    (``_step_pro``); ``reorth='dgks'`` runs the reference's bucketed CGS
    with the DGKS 0.717 refinement test (``_step``)."""
    _check_slice(op, cfg)
    pin_full_precision()
    ncv, n_pad, n = cfg.ncv, cfg.n_pad, cfg.n
    dtype = cfg.dtype
    tdt = _dt.torch_dtype(dtype)
    sdt = _dt.torch_dtype(cfg.storage_dtype or dtype)
    mixed = sdt != tdt
    rdt = _dt.real_dtype(dtype)
    R = rdt.type
    device = op.device
    is_g = op.bmat == "G"
    nbx1 = 1 if is_g else 0
    nbx_op = 1 if (is_g and op.mode != 2) else 0
    eta = R(_dt.DGKS_ETA)
    tiny = R(_dt.safmin(dtype))
    use_pro = (cfg.reorth == "selective" and cfg.symmetric
               and cfg.restart in ("implicit", "thick"))
    col_idx = np.arange(ncv)
    b_apply = op.b_apply if is_g else (lambda r: r)
    bnorm = make_bnorm(op, cfg)
    rows_list = bucket_rows(ncv)
    nbuckets = len(rows_list)
    # debug hatches of the selective events, read once, when the solver is
    # built: every event over all ncv rows, or one bucket more than the
    # eta-selection needs (reference arnoldi.py:357-363, 975-979)
    full_reorth = bool(os.environ.get("ARPACK_TPU_FULL_REORTH"))
    sel_extra = int(os.environ.get("ARPACK_TPU_SEL_EXTRA_BUCKET", "0"))

    def _rows_upto(j):
        return rows_list[min(j // _BUCKET, nbuckets - 1)]

    def _proj(Vr, w):
        """Projection coefficients ``Vr w`` accumulated in the compute
        dtype (narrow storage is widened first)."""
        return (Vr.to(tdt) if mixed else Vr) @ w

    def _comb(h, Vr):
        return h @ (Vr.to(tdt) if mixed else Vr)

    # CGS kernel routing (reference arnoldi.py:465-477, 505-567):
    # cgs_kernel='pallas' sends the 8-, 16- and 24-row buckets of the CGS
    # and DGKS passes to the kernels of csrc/cgs.cu; the 32-row bucket stays
    # a GEMV, as in the reference.
    kernels_ok = (dtype == np.float32
                  and sdt in (torch.float32, torch.bfloat16)
                  and n_pad % 128 == 0)
    use_kernels = cfg.cgs_kernel == "pallas"
    if use_kernels and not kernels_ok:
        raise ValueError("cgs_kernel='pallas' requires real float32 "
                         "compute, f32/bf16 storage, n_pad % 128 == 0")
    # the kernel update carries ||r||^2 out of its pass (standard problems
    # with plain norms; B-norms and safe norms keep their own pass)
    fuse_norm = use_kernels and not is_g and not cfg.safe_norms

    def _kernel_bucket(rows):
        return use_kernels and rows % 8 == 0 and rows <= MAX_FAST_ROWS

    def _proj_upto(V, w, j):
        """``V[:rows] w`` padded to (ncv,) and masked to ``col <= j``; rows
        = the smallest bucket holding row j (bit-exact vs the full masked
        form: excluded rows contribute exact zeros)."""
        rows = _rows_upto(j)
        h = torch.zeros(ncv, dtype=tdt, device=device)
        h[:rows] = (cgs_proj(V, w, rows) if _kernel_bucket(rows)
                    else _proj(V[:rows], w))
        h[j + 1:] = 0
        return h

    def _update_upto(w, h, V, j):
        rows = _rows_upto(j)
        if _kernel_bucket(rows):
            return cgs_update(w, h[:rows], V)
        return w - _comb(h[:rows], V[:rows])

    def _update_bnorm(w, h, V, j):
        """One CGS subtraction and the new residual's B-norm:
        ``(r, B r, ||r||_B)`` with the norm as a 0-d tensor."""
        if not fuse_norm:
            r = _update_upto(w, h, V, j)
            br = b_apply(r)
            return r, br, bnorm(r, br)
        rows = _rows_upto(j)
        if _kernel_bucket(rows):
            r, rn2 = cgs_update(w, h[:rows], V, with_norm=True)
        else:
            r = w - _comb(h[:rows], V[:rows])
            rn2 = torch.dot(r, r)
        return r, r, torch.sqrt(rn2)

    def _orth_refine(V, j, r, br, rn_prev, max_iter):
        """CGS against rows ``< j`` with iterative refinement until the
        norm stops collapsing (dgetv0's 0.717 loop).  Returns
        ``(r, br, rnorm, nbx_done, ok)``."""
        it, nbx_done = 0, 0
        while True:
            s = _proj(V, br)
            s[j:] = 0
            r = r - _comb(s, V)
            br = b_apply(r)
            rn = _host(bnorm(r, br), rdt)
            ok = rn > eta * rn_prev
            it += 1
            nbx_done += nbx1
            rn_prev = rn
            if ok:
                return r, br, rn, nbx_done, True
            if it >= max_iter:
                return (torch.zeros_like(r), torch.zeros_like(br), R(0),
                        nbx_done, False)

    def _restart_vector(st: FactorizationState, j: int):
        """Invariant-subspace hit: a new random vector B-orthogonal to
        V[:j] (SRC/dsaitr.f:380-427 + dgetv0); up to 3 tries, OP applied to
        the first try's vector only (dgetv0.f:236-246)."""
        counts = st.counts.add(nrstrt=1)
        r, br, rn, done = st.resid, st.b_resid, R(0), False
        for itry in range(_MAX_RESTART_TRIES):
            r = _random_vector(st.gen, n_pad, n, dtype, device)
            dop = dbx = 0
            if itry == 0:
                r, _ = op.apply(r, b_apply(r))
                dop, dbx = 1, nbx1
            br = b_apply(r)
            rn0 = _host(bnorm(r, br), rdt)
            r, br, rn, nbx_done, ok = _orth_refine(
                st.V, j, r, br, rn0, _MAX_GETV0_REFINE + 1)
            counts = counts.add(nopx=dop, nbx=dbx + nbx1 + nbx_done)
            done = ok and rn > 0
            if done:
                break
        # all tries failed: the factorization stops at size j
        # (SRC/dsaitr.f:418-425)
        return st.replace(resid=r, b_resid=br, rnorm=rn,
                          info=st.info if done else j, counts=counts)

    def _begin_step(j, st):
        """STEP 2-3 of dsaitr: v_j = r / rnorm into V[j], w = OP v_j."""
        inv = R(1) / np.maximum(st.rnorm, tiny)
        v_j = st.resid * float(inv)
        bv_j = st.b_resid * float(inv) if is_g else v_j
        st.V[j] = v_j
        w, bw = op.apply(v_j, bv_j)
        return v_j, w, bw, st.counts.add(nopx=1, nbx=nbx_op)

    # ---- full CGS + DGKS (reorth='dgks'), SRC/dsaitr.f:570-781 ---------
    def _step(j: int, st: FactorizationState) -> FactorizationState:
        rstart = st.rnorm <= 0
        if rstart and st.info == 0:
            st = _restart_vector(st, j)
        if st.info != 0:
            return st
        rnorm_prev = st.rnorm
        V = st.V
        v_j, w, bw, counts = _begin_step(j, st)
        wnorm_t = bnorm(w, bw)
        h_t = _proj_upto(V, bw, j)
        r, br, rnorm_t = _update_bnorm(w, h_t, V, j)
        back = torch.cat([h_t, torch.stack([wnorm_t, rnorm_t]).to(tdt)])
        back = back.cpu().numpy()
        h = back[:ncv].astype(dtype)
        wnorm, rnorm = R(back[ncv]), R(back[ncv + 1])
        H = st.H
        H[:, j] = h
        if j > 0:
            H[j, j - 1] = R(0) if rstart else rnorm_prev
        counts = counts.add(nbx=nbx1)
        needs = rnorm <= eta * wnorm
        if needs:
            counts = counts.add(nrorth=1)
            s_tot = np.zeros(ncv, dtype)
            rn_prev, passes, nfail = rnorm, 0, 0
            while True:
                s_t = _proj_upto(V, br, j)
                r, br, rn_t = _update_bnorm(r, s_t, V, j)
                back = torch.cat([s_t, rn_t.reshape(1).to(tdt)])
                back = back.cpu().numpy()
                s_tot = s_tot + back[:ncv].astype(dtype)
                rn = R(back[ncv])
                accept = rn > eta * rn_prev
                passes += 1
                nfail += 0 if accept else 1
                rn_prev = rn
                if accept:
                    break
                if passes >= _MAX_DGKS_PASSES:
                    # residual numerically in span(V): zero it
                    # (SRC/dsaitr.f:773-781)
                    r, br, rn = torch.zeros_like(r), torch.zeros_like(br), \
                        R(0)
                    break
            rnorm = rn
            counts = counts.add(nitref=nfail, nbx=passes * nbx1)
            # fold the refinement correction into H column j
            H[:, j] += s_tot
        return st.replace(H=H, resid=r, b_resid=br, rnorm=rnorm, k=j + 1,
                          counts=counts)

    # ---- partial reorthogonalization (reorth='selective') --------------
    # Noise floor of an inner product: 8*log2(n)*eps under pairwise/tree
    # summation (every reduction of this package and of its CUDA kernels is
    # a tree), plus the storage representation error.  The 'sequential'
    # hatch restores the classical sqrt(n)*eps bound.
    if os.environ.get("ARPACK_TPU_OMEGA_NOISE_MODEL", "pairwise") \
            == "sequential":
        eps_eff = float(np.sqrt(max(float(n), 2.0)) * _dt.eps(dtype)
                        + _dt.eps(sdt))
    else:
        eps_eff = float(8.0 * np.log2(max(float(n), 2.0)) * _dt.eps(dtype)
                        + _dt.eps(sdt))
    tau = R(np.sqrt(eps_eff) / _dt.SELECTIVE_SAFETY)
    eps1 = R(eps_eff)
    # eta-subset selection threshold, capped below tau so the selection
    # always includes the rows that caused the event
    eta_sub = R(min(eps_eff ** 0.75,
                    float(np.sqrt(eps_eff) / _dt.SELECTIVE_SAFETY) / 2.0))
    neg_inf = R(-np.inf)
    # fused ||r'||^2 from the event update: standard problems, plain norms
    fuse_sel_norm = not is_g and not cfg.safe_norms

    def _omega_update(a, b, wp, wc, j, wnorm, beta_j):
        """One row of Simon's omega recurrence (signed terms, abs at the
        end, additive noise eps1*wnorm):  beta_j w_{j+1,i} =
        beta_i w_{j,i+1} + (alpha_i - alpha_j) w_{j,i}
        + beta_{i-1} w_{j,i-1} - beta_{j-1} w_{j-1,i}."""
        aj = a[j]
        bjm1 = b[j - 1] if j > 0 else R(0)
        wc_full = wc.copy()
        wc_full[j] = 1
        wp_full = wp.copy()
        if j > 0:
            wp_full[j - 1] = 1
        wc_p1 = np.roll(wc_full, -1)
        wc_m1 = np.roll(wc_full, 1)
        wc_m1[0] = 0
        b_m1 = np.roll(b, 1)
        b_m1[0] = 0
        t = b * wc_p1 + (a - aj) * wc_full + b_m1 * wc_m1 - bjm1 * wp_full
        den = np.maximum(beta_j, tiny)
        wn = (np.abs(t) + eps1 * wnorm) / den
        wn[j] = eps1 * wnorm / den
        wn[col_idx > j] = 0
        return wn.astype(rdt)

    def _subset_pass(j, V, wn, r, br):
        """One CGS pass against the eta-selected rows (Larsen/PROPACK),
        padded up to an 8-row bucket K; rows past j are masked out.
        Returns ``(r2, rn2_or_None, reset, K)``."""
        sel_key = np.where(col_idx <= j, wn, neg_inf)
        order = np.argsort(-sel_key, kind="stable")
        if nbuckets == 1 or full_reorth:
            K = ncv
        else:
            cnt = int(np.sum(sel_key > eta_sub))
            b = max(cnt - 1, 0) // _BUCKET + sel_extra
            K = rows_list[min(max(b, 0), nbuckets - 1)]
        idx = order[:K]
        valid = sel_key[idx] > neg_inf
        idx_t = torch.from_numpy(idx.astype(np.int32)).to(device)
        s = sel_proj(idx_t, V, br)
        if not valid.all():
            s.masked_fill_(torch.from_numpy(~valid).to(device), 0)
        reset = np.zeros(ncv, bool)
        reset[idx] = valid
        if fuse_sel_norm:
            r2, rn2 = sel_update(idx_t, s, r, V, with_norm=True)
            return r2, rn2, reset, K
        return sel_update(idx_t, s, r, V), None, reset, K

    def _step_pro(j, st, wp, wc, force):
        rstart = st.rnorm <= 0
        if rstart and st.info == 0:
            st = _restart_vector(st, j)
        if rstart:
            # a fresh restart vector is fully orthogonalized
            wp = np.full(ncv, eps1, rdt)
            wc = np.full(ncv, eps1, rdt)
        if st.info != 0:
            return st, wp, wc, force
        rnorm_prev = st.rnorm
        V = st.V
        v_j, w, bw, counts = _begin_step(j, st)
        wnorm_t = bnorm(w, bw)
        # three-term recurrence: reads one stored row, v_{j-1}
        alpha_t = torch.dot(v_j, bw)
        beta_prev = R(0) if (rstart or j == 0) else rnorm_prev
        v_jm1 = V[max(j - 1, 0)].to(tdt)
        r = w - alpha_t * v_j - float(beta_prev) * v_jm1
        br = b_apply(r)
        counts = counts.add(nbx=nbx1)
        rnorm_t = bnorm(r, br)
        alpha, wnorm, rnorm = (R(x) for x in torch.stack(
            [alpha_t, wnorm_t, rnorm_t]).cpu().numpy())
        H = st.H
        H[j, j] = alpha
        if j > 0:
            H[j, j - 1] = beta_prev
            H[j - 1, j] = beta_prev
        a_vec = np.diagonal(H).real.astype(rdt)
        b_vec = np.concatenate([np.diagonal(H, offset=-1).real.astype(rdt),
                                np.zeros(1, rdt)])
        b_vec[j] = rnorm
        wn = _omega_update(a_vec, b_vec, wp, wc, j, wnorm, rnorm)
        need = bool(np.max(wn) > tau) or force > 0
        if need:
            counts = counts.add(nrorth=1)
            rn_prev = rnorm
            r, rn2_t, reset, K = _subset_pass(j, V, wn, r, br)
            if rn2_t is not None:
                br = r
                rn1 = R(np.sqrt(_host(rn2_t, rdt)))
            else:
                br = b_apply(r)
                rn1 = _host(bnorm(r, br), rdt)
            nfail, passes, extra_rows = 0, 1, 0
            if not rn1 > eta * rn_prev:
                # doubtful case (norm still collapsed): one full bucketed
                # pass, then the reference's span-declare give-up
                # (SRC/dsaitr.f:773-781)
                s_t = _proj_upto(V, br, j)
                r = _update_upto(r, s_t, V, j)
                br = b_apply(r)
                rn2 = _host(bnorm(r, br), rdt)
                in_span = not rn2 > eta * rn1
                if in_span:
                    r, br, rn2 = torch.zeros_like(r), torch.zeros_like(br), \
                        R(0)
                rn1 = rn2
                nfail, passes = 1 + int(in_span), 2
                extra_rows = _rows_upto(j)
                reset[:] = True
            rnorm = rn1
            counts = counts.add(nitref=nfail, nbx=passes * nbx1,
                                nrorthr=K + extra_rows)
            # reorthogonalized rows drop to the eps floor
            wn = np.where(reset, eps1, wn).astype(rdt)
        # pair rule: reorthogonalize the next step too, unless this event
        # was the forced follow-up
        if cfg.pair_rule == "clean":
            carrier_dirty = bool(np.max(np.where(col_idx < j, wc, R(0)))
                                 > eta_sub)
            force_out = int(need and force == 0 and carrier_dirty)
        else:
            force_out = int(need and force == 0)
        st = st.replace(H=H, resid=r, b_resid=br, rnorm=rnorm, k=j + 1,
                        counts=counts)
        return st, wc, wn, force_out

    def extend(st: FactorizationState, k_end: int) -> FactorizationState:
        """Extend from the state's current length ``st.k`` to ``k_end``."""
        if not use_pro:
            for j in range(st.k, k_end):
                st = _step(j, st)
            return st
        # omega starts AT tau: the mutual defect of carried-over columns is
        # unknown at a restart boundary
        w0 = np.full(ncv, tau, rdt)
        wp, wc, force = w0, w0, 0
        for j in range(st.k, k_end):
            st, wp, wc, force = _step_pro(j, st, wp, wc, force)
        return st

    return extend
