"""Lanczos/Arnoldi factorization engine: ``dsaitr``/``dnaitr``/``znaitr``
+ ``dgetv0`` (port of ``arpack_ng_tpu/core/arnoldi.py``) for real and
complex problems, symmetric (Hermitian) and non-symmetric.  Complex
projections are conjugated (``V^H w``) and the norms take ``|<r, B r>|``;
the Hermitian Lanczos recurrence keeps a real tridiagonal.  The event,
CGS and rotation kernels are real-only, as the reference package's Pallas
paths are: a complex event is a pair of masked GEMVs over all ncv rows, a
complex basis with a real rotation (the Hermitian restart) runs the
rotation kernel on its real view, and a complex rotation is a torch GEMM.
``H`` is a full ``(ncv, ncv)`` matrix: the
CGS + DGKS step (``_step``) writes whole Hessenberg columns, which the
non-symmetric driver reads; the selective step (``_step_pro``) is the
Lanczos recurrence and runs for symmetric problems only, as in the
reference package (a non-symmetric ``reorth='selective'`` runs ``_step``).

The selective step runs on the operator's device with no device-to-host
read (``Extension.run``, what the device restart loop captures as a CUDA
graph): Simon's omega recurrence, the event decision, its row bucket and
the eta-selected rows are device tensors, and the event kernels read
their row count from device memory (0: no event).  A breakdown
(rnorm <= 0) and the rare doubtful event (the norm still collapsed after
it) are finished by the host (``Extension.recover``): it draws restart
vectors on its generator and runs the doubtful pass.

The dgks step runs read-free too (``_dgks_step``, the reference's
``_step`` as one device program): the DGKS test ``rnorm <= 0.717 wnorm``
is a device flag, and the first refinement pass runs on every step with
its coefficients zeroed where the flag is false (``r - 0 V`` is ``r`` bit
for bit), its norm and H's correction selected on the device.  The second
refinement pass (the first one failed the test; rare) is only flagged
(``REDO``): the host restores the extension's entry and runs it again
with the host step (``_step``, which reads its decisions back once per
step and pass), as it does after a breakdown.

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

Under a row mesh (an operator with ``op.mesh``, ``parallel/sharding``)
each rank holds its rows of V, resid and b_resid and runs the same steps
on them, kernels included; the partial dot products are all-reduced at
the reference's sites (the CGS and event coefficients, alpha, the norms,
pdgetv0's), so H, the omega recurrence, every decision and every host
branch are the same on every rank.  Restart vectors are drawn at full
length on every rank and sliced to its rows.
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
#: the breakdown word of an extension that met a doubtful event: the host
#: runs the whole extension again (``Extension.recover``)
REDO = -2
#: the read-free extensions the host finished (``Extension.recover``) since
#: a caller last set the counts to 0, by cause: ``redo`` (a failed dgks
#: refinement or a doubtful selective event: the whole extension again on
#: the host) and ``breakdown`` (rnorm <= 0: the host drew a restart vector)
reruns = {"redo": 0, "breakdown": 0}


@dataclasses.dataclass
class FactorizationState:
    """The solver state between steps and cycles.

    ``V``, ``resid`` and ``b_resid`` live on the operator's device; the
    reduced quantities (``H``, ``rnorm``) and the counters live on the
    host.  ``gen`` draws restart vectors (SRC/dgetv0.f).  Under a mesh,
    ``V``, ``resid`` and ``b_resid`` are this rank's rows (``n_loc``
    columns) and every other field is replicated
    (``parallel/sharding.LOCAL_FIELDS``)."""

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


@dataclasses.dataclass
class DeviceLanczos:
    """What a read-free extension reads and writes, on the operator's
    device, in place: the buffers a captured extension (a CUDA graph) is
    bound to.  ``b[j]`` is the residual norm after step j (the subdiagonal
    of T below row ncv - 1); ``cnt`` the events' counters (nrorth, nitref,
    nbx, nrorthr); ``brk`` the first step that met rnorm <= 0 (-1: none;
    ``REDO``: a doubtful event, or a dgks step whose first refinement
    failed) and ``force`` the pair rule's flag entering it; ``resid0``,
    ``b_resid0``, ``rnorm0`` and ``cnt0`` the extension's entry, which
    ``REDO`` restores.  ``H``: the dgks step's projected matrix (ncv, ncv)
    in the compute dtype, whole Hessenberg columns (None for the selective
    step); for symmetric problems the step also writes its diagonal and
    subdiagonal into ``a`` and ``b``."""

    V: torch.Tensor
    resid: torch.Tensor
    b_resid: torch.Tensor    # the same tensor as resid for bmat 'I'
    rnorm: torch.Tensor      # () real compute dtype
    a: torch.Tensor          # (ncv,) diagonal of T
    b: torch.Tensor          # (ncv,)
    cnt: torch.Tensor        # (4,) int64
    brk: torch.Tensor        # () int32
    force: torch.Tensor      # () int32
    resid0: torch.Tensor
    b_resid0: torch.Tensor
    rnorm0: torch.Tensor
    cnt0: torch.Tensor
    H: Optional[torch.Tensor] = None


class Extension:
    """``extend(state, k_end)`` and the pieces the device restart loop
    drives: ``load`` (a state's device buffers), ``put_h`` (a host
    projected matrix into those buffers, in place: what a restart reduced
    on the host hands the next extension), ``run`` (steps with no
    device-to-host read), ``recover`` (the host's steps after a breakdown,
    a doubtful event or a failed dgks refinement) and ``static_counts``.
    ``stepwise``: for the dgks step, the extension step by step on the
    host, each decision read back (``recover``'s path and the twin the
    read-free steps are held against).  ``selective``: the step is the
    selective Lanczos step, whose buffers hold T's diagonals and no H."""

    def __init__(self, extend, load=None, run=None, recover=None,
                 static_counts=None, stepwise=None, put_h=None,
                 selective=False):
        self._extend = extend
        self.load, self.run, self.recover = load, run, recover
        self.static_counts = static_counts
        self.stepwise = stepwise
        self.put_h = put_h
        self.selective = selective

    @property
    def read_free(self) -> bool:
        return self.run is not None

    def __call__(self, st: FactorizationState, k_end: int
                 ) -> FactorizationState:
        return self._extend(st, k_end)


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
    the rotation kernel (a complex V with a real Q: on V's real view).  A
    complex Q (the complex Arnoldi restart) is a torch GEMM with ``Q^T``,
    transposed and not conjugated: V holds basis rows.  Rows past the
    bucket keep stale values, which are never read.

    Returns ``(V, v_next_row, rows_written)``; ``v_next_row`` is row
    ``kev`` of the rotated basis (a view, storage dtype)."""
    R = kev_rows(Q.shape[0], kev, need_next)
    if Q.is_complex():
        V[:R] = Q[:, :R].T @ V
    else:
        rotate_rows(Q, V, R)
    return V, V[min(kev, R - 1)], R


def restart_update(op: Operator, bnorm, V, resid, Q, sigmak, betak,
                   kev: int):
    """The device part of an implicit restart (dsapps / dnapps / znapps,
    SRC/dsapps.f:445-501, SRC/dsaup2.f:764-808), with no device-to-host
    read: the kev-row rotation of the basis ``V`` by ``Q`` in place (real,
    also for a Hermitian basis; complex for the complex Arnoldi restart),
    ``r <- sigma_k r + beta_k v_next`` (``sigmak``, ``betak``: host scalars
    or 0-d device tensors), its B-product and B-norm.  Returns ``(resid,
    b_resid, rnorm, rows)``: the norm a 0-d device tensor, ``rows`` the
    rotated row count."""
    V, v_next, rows = rotate_basis_kev(Q, V, kev)
    resid = sigmak * resid + betak * v_next.to(resid.dtype)
    b_resid = op.b_apply(resid) if op.bmat == "G" else resid
    return resid, b_resid, bnorm(resid, b_resid), rows


def restart_tail(op: Operator, cfg: IRAMConfig, bnorm, state, Q, H_new,
                 sigmak, betak, kev: int):
    """An implicit restart by the host ``Q``, ``sigmak`` and ``betak``:
    :func:`restart_update`, then one read of the new residual's B-norm.
    Returns the restarted state with ``H_new`` as its H."""
    tdt = _dt.torch_dtype(cfg.dtype)
    rdt = _dt.real_dtype(cfg.dtype)
    cplx_q = np.iscomplexobj(Q)
    Q_dev = torch.from_numpy(np.ascontiguousarray(Q)).to(
        device=op.device, dtype=tdt if cplx_q else _dt.torch_dtype(rdt))
    scalar = complex if cplx_q else (lambda x: float(np.real(x)))
    resid, b_resid, rn, rots = restart_update(
        op, bnorm, state.V, state.resid, Q_dev, scalar(sigmak),
        scalar(betak), kev)
    counts = state.counts.add(nbx=1 if op.bmat == "G" else 0, nrotr=rots)
    return state.replace(H=np.asarray(H_new).astype(cfg.dtype),
                         resid=resid, b_resid=b_resid, rnorm=_host(rn, rdt),
                         k=kev, nev_cur=kev, iter=state.iter + 1,
                         counts=counts)


def kev_rows(ncv: int, kev: int, need_next: bool = True) -> int:
    """Rows the restart rotation writes: ``kev`` (+1 with ``need_next``)
    bucketed up to a multiple of 8 (all ncv rows when ncv is one
    bucket)."""
    rows_list = bucket_rows(ncv)
    nrows = kev + (1 if need_next else 0)
    if len(rows_list) == 1:
        return ncv
    return rows_list[min((max(nrows, 1) - 1) // _BUCKET, len(rows_list) - 1)]


def _same(t):
    return t


def reducer(op: Operator):
    """The all-reduce (sum) of partial dot products under the operator's
    mesh, in place; the identity without one."""
    return _same if op.mesh is None else op.mesh.sum


def complex_event(idx: torch.Tensor, V: torch.Tensor, br: torch.Tensor,
                  take: torch.Tensor, red=_same) -> torch.Tensor:
    """The projection of a complex event as one masked GEMV over all ncv
    rows (the event kernels are real-only, as the reference's Pallas events
    are): ``<V[idx[k]], br>`` where ``take[k]``, else 0, put back in row
    order; the event's update is then ``r - c @ V``.  Torch ops with no
    host read, so a CUDA graph can hold them.  ``red``: the all-reduce of
    the products under a mesh."""
    s = torch.index_select(red(V.conj() @ br), 0, idx)
    s = torch.where(take, s, torch.zeros((), dtype=s.dtype, device=s.device))
    return torch.zeros(V.shape[0], dtype=s.dtype,
                       device=s.device).index_add_(0, idx, s)


def _host(t: torch.Tensor, rdt) -> np.floating:
    """One scalar read back from the device, in the real compute dtype."""
    return np.dtype(rdt).type(t.item())


def make_bnorm(op: Operator, cfg: IRAMConfig):
    """Norm closure ``bnorm(r, br) -> 0-d tensor``: ``sqrt(|<r, B r>|)``
    (SRC/dsaitr.f:634-639; conjugated for complex dtypes, SRC/znaitr.f),
    a real tensor, or with ``cfg.safe_norms`` on a standard
    problem the overflow-safe two-phase norm of PARPACK's pdnorm2.  Under
    a mesh the local dot is all-reduced before the root, and pdnorm2's
    largest entry before the scaling (pdnorm2.f:70-80)."""
    dot = torch.vdot if _dt.is_complex(cfg.dtype) else torch.dot
    red = reducer(op)
    if not (cfg.safe_norms and op.bmat == "I"):
        return lambda r, br: torch.sqrt(torch.abs(red(dot(r, br))))
    tiny = _dt.safmin(cfg.dtype)
    top = _same if op.mesh is None else op.mesh.max

    def bnorm(r, br):
        m = top(torch.max(torch.abs(r)))
        msafe = torch.clamp_min(m, tiny)
        scaled = r / msafe
        nrm = msafe * torch.sqrt(torch.abs(red(dot(scaled, scaled))))
        return torch.where(m > 0, nrm, torch.zeros_like(nrm))

    return bnorm


def _random_vector(gen: torch.Generator, n_pad: int, n: int, dtype,
                   device, mesh=None) -> torch.Tensor:
    """Uniform(-1, 1) start vector (dlarnv idist=2, SRC/dgetv0.f:224-229),
    real and imaginary parts drawn apart for complex dtypes, zero on the
    pad.  Drawn on the host generator, so a seed gives the same vector on
    every device; under a mesh every rank draws it whole and keeps its
    rows."""
    rdt = _dt.torch_dtype(_dt.real_dtype(dtype))
    if _dt.is_complex(dtype):
        re = torch.rand((2, n_pad), generator=gen, dtype=rdt) * 2 - 1
        v = torch.complex(re[0], re[1])
    else:
        v = torch.rand(n_pad, generator=gen, dtype=rdt) * 2 - 1
    v[n:] = 0
    if mesh is not None:
        v = mesh.local(v).clone()
    return v.to(device=device, dtype=_dt.torch_dtype(dtype))


def _check_slice(op: Operator, cfg: IRAMConfig) -> int:
    """Check the operator against the config; returns the rows this rank
    holds (``n_pad`` without a mesh)."""
    if op.n != cfg.n or op.n_pad != cfg.n_pad:
        raise ValueError("operator/config dimension mismatch")
    require(op.device)
    return cfg.n_pad if op.mesh is None else op.mesh.n_loc(cfg.n_pad)


def make_init(op: Operator, cfg: IRAMConfig):
    """Build the state initializer (dgetv0, j=1 path):
    ``init(gen=None, v0=None)``; ``v0`` (length n_pad) plays the role of
    the reference's user-supplied ``resid`` (SRC/dsaupd.f:243-246), whole
    on every rank of a mesh."""
    n_loc = _check_slice(op, cfg)
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
            r0 = _random_vector(gen, n_pad, n, dtype, device, op.mesh)
        else:
            r0 = torch.as_tensor(v0)
            if op.mesh is not None:
                r0 = op.mesh.local(r0).clone()
            r0 = r0.to(device=device, dtype=tdt)
        # force the start vector into the range of OP (SRC/dgetv0.f:233-246)
        br0 = op.b_apply(r0)
        w, _ = op.apply(r0, br0)
        resid = w
        b_resid = op.b_apply(resid) if nbx1 else resid
        rnorm = _host(bnorm(resid, b_resid), rdt)
        return FactorizationState(
            V=torch.zeros((ncv, n_loc), dtype=sdt, device=device),
            H=np.zeros((ncv, ncv), dtype),
            resid=resid, b_resid=b_resid, rnorm=rnorm,
            k=0, nev_cur=cfg.nev, iter=0,
            # rnorm == 0 is the reference's info = -9 (SRC/dsaup2.f:332-341)
            info=0 if rnorm > 0 else -9,
            gen=gen,
            counts=OpCounts(nopx=1, nbx=2 * nbx1))

    return init


def make_extend(op: Operator, cfg: IRAMConfig) -> "Extension":
    """Build ``extend(state, k_end)``: extend a ``state.k``-step Lanczos
    factorization to ``k_end`` steps (dsaitr).

    ``reorth='selective'`` runs the three-term recurrence with Simon's
    omega recurrence and eta-subset reorthogonalization events
    (``_pro_step``); ``reorth='dgks'`` runs the reference's bucketed CGS
    with the DGKS 0.717 refinement test (``_dgks_step``; ``_step`` on the
    host, ``Extension.stepwise``).  Both are read-free: ``extend`` reads
    the results back once at its end."""
    _check_slice(op, cfg)
    mesh = op.mesh
    red = reducer(op)
    pin_full_precision()
    ncv, n_pad, n = cfg.ncv, cfg.n_pad, cfg.n
    dtype = cfg.dtype
    tdt = _dt.torch_dtype(dtype)
    sdt = _dt.torch_dtype(cfg.storage_dtype or dtype)
    mixed = sdt != tdt
    cplx = _dt.is_complex(dtype)
    if mixed and cplx:
        raise ValueError("storage_dtype is supported for real dtypes only")
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
        """Projection coefficients ``Vr^H w`` accumulated in the compute
        dtype (narrow storage is widened first), all-reduced under a
        mesh."""
        if cplx:
            return red(Vr.conj() @ w)
        return red((Vr.to(tdt) if mixed else Vr) @ w)

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

    zero_c = torch.zeros((), dtype=tdt, device=device)
    # for each step j, the rows <= j of its bucket (a device constant: a
    # captured step copies no host data); None where that is every row
    keep = [torch.arange(_rows_upto(j), device=device) <= j
            if _rows_upto(j) > j + 1 else None for j in range(ncv)]

    def _proj_rows(V, w, j):
        """``V[:rows] w`` masked to ``col <= j``, (rows,); rows = the
        smallest bucket holding row j (bit-exact vs the full masked form:
        excluded rows contribute exact zeros)."""
        rows = _rows_upto(j)
        h = (red(cgs_proj(V, w, rows)) if _kernel_bucket(rows)
             else _proj(V[:rows], w))
        return h if keep[j] is None else torch.where(keep[j], h, zero_c)

    def _proj_upto(V, w, j):
        """:func:`_proj_rows` padded with zeros to (ncv,)."""
        h = _proj_rows(V, w, j)
        return torch.nn.functional.pad(h, (0, ncv - h.shape[0]))

    def _update_upto(w, h, V, j):
        """``w - h^T V[:rows]``; ``h`` of length ncv or rows."""
        rows = _rows_upto(j)
        h = h if h.shape[0] == rows else h[:rows]
        if _kernel_bucket(rows):
            return cgs_update(w, h, V)
        return w - _comb(h, V[:rows])

    def _update_bnorm(w, h, V, j):
        """One CGS subtraction and the new residual's B-norm:
        ``(r, B r, ||r||_B)`` with the norm as a 0-d tensor."""
        if not fuse_norm:
            r = _update_upto(w, h, V, j)
            br = b_apply(r)
            return r, br, bnorm(r, br)
        rows = _rows_upto(j)
        h = h if h.shape[0] == rows else h[:rows]
        if _kernel_bucket(rows):
            r, rn2 = cgs_update(w, h, V, with_norm=True)
        else:
            r = w - _comb(h, V[:rows])
            rn2 = torch.dot(r, r)
        return r, r, torch.sqrt(red(rn2))

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
            r = _random_vector(st.gen, n_pad, n, dtype, device, mesh)
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

    # ---- full CGS + DGKS on the host (reorth='dgks'), SRC/dsaitr.f:570-781
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
        wnorm, rnorm = R(back[ncv].real), R(back[ncv + 1].real)
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
                rn = R(back[ncv].real)
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

    def static_counts(counts: OpCounts, steps: int) -> OpCounts:
        """What ``steps`` steps of either read-free extension count
        whatever the data: one OP (and its B) per step, one B for the
        step's residual."""
        return counts.add(nopx=steps, nbx=steps * (nbx_op + nbx1))

    def stepwise(st: FactorizationState, k_end: int) -> FactorizationState:
        """The dgks extension from ``st.k`` to ``k_end`` on the host's
        steps (``_step``)."""
        for j in range(st.k, k_end):
            st = _step(j, st)
        return st

    # device constants, made here: a captured extension copies no host data
    rtd = _dt.torch_dtype(rdt)
    eta_f, tiny_f = float(eta), float(tiny)
    one_r = torch.ones((), dtype=rtd, device=device)
    zero_r = torch.zeros((), dtype=rtd, device=device)
    zero_l = torch.zeros((), dtype=torch.int64, device=device)
    no_brk = torch.full((), -1, dtype=torch.int32, device=device)
    redo_brk = torch.full((), REDO, dtype=torch.int32, device=device)
    live0 = torch.ones((), dtype=torch.bool, device=device)

    def _diagonals(H):
        """T's diagonal and subdiagonal of the host matrix ``H`` in the
        real dtype, the subdiagonal padded with a zero to ncv."""
        b = np.zeros(ncv, rdt)
        b[:ncv - 1] = np.diagonal(H, offset=-1).real
        return np.ascontiguousarray(np.diagonal(H).real.astype(rdt)), b

    def load(st: FactorizationState) -> DeviceLanczos:
        """The device buffers of an extension from a state: T's diagonals
        from ``st.H`` (and for dgks a copy of H), copies of the residual
        (the state is not changed), the basis itself (updated in place),
        room for the entry."""
        a, b = (torch.from_numpy(x).to(device) for x in _diagonals(st.H))
        resid = st.resid.clone()
        resid0 = torch.empty_like(resid)
        return DeviceLanczos(
            V=st.V, resid=resid,
            b_resid=st.b_resid.clone() if is_g else resid,
            rnorm=torch.tensor(float(st.rnorm), dtype=rtd, device=device),
            a=a, b=b, cnt=torch.zeros(4, dtype=torch.int64, device=device),
            brk=no_brk.clone(), force=torch.zeros((), dtype=torch.int32,
                                                  device=device),
            resid0=resid0,
            b_resid0=torch.empty_like(resid) if is_g else resid0,
            rnorm0=torch.empty((), dtype=rtd, device=device),
            cnt0=torch.empty(4, dtype=torch.int64, device=device),
            H=None if use_pro else torch.from_numpy(
                np.array(st.H, dtype=dtype)).to(device))

    def put_h(ds: DeviceLanczos, H, copy) -> None:
        """The host matrix ``H`` into the buffers the next extension reads,
        in place, as :func:`load` puts a state's: T's diagonals into ``a``
        and ``b`` for the selective step, H itself for dgks.  ``copy(dst,
        array)`` moves one host array into a device buffer."""
        if use_pro:
            a, b = _diagonals(H)
            copy(ds.a, a)
            copy(ds.b, b)
        else:
            copy(ds.H, np.asarray(H, dtype=dtype))

    def _save_entry(ds: DeviceLanczos) -> None:
        """The extension's entry, which ``REDO`` restores."""
        ds.resid0.copy_(ds.resid)
        if is_g:
            ds.b_resid0.copy_(ds.b_resid)
        ds.rnorm0.copy_(ds.rnorm)
        ds.cnt0.copy_(ds.cnt)

    def _restore_entry(ds: DeviceLanczos) -> None:
        ds.resid.copy_(ds.resid0)
        if is_g:
            ds.b_resid.copy_(ds.b_resid0)
        ds.rnorm.copy_(ds.rnorm0)
        ds.cnt.copy_(ds.cnt0)

    def _first_break(bds, flagged):
        """The breakdown word: ``REDO`` where a step was flagged for the
        host, else the first breakdown (argmax takes the first of equal
        maxima), else -1."""
        return torch.where(
            flagged, redo_brk,
            torch.where(bds.any(), torch.argmax(bds.to(torch.int32)), no_brk))

    if not use_pro:
        # ---- full CGS + DGKS with no device-to-host read ---------------
        def _dgks_step(j, ds, c):
            """Step j of ``_step`` with no device-to-host read: the same
            operations in the same order, each decision a device flag.
            ``c`` carries (r, br, rnorm, live) and the per-step records,
            lists stacked once at the end (each step's breakdown flag,
            DGKS flag, failed refinement, H column and subdiagonal entry:
            an eager step dispatches fewer ops).  The first refinement
            pass runs on every step,
            its coefficients zeroed where the DGKS test passed (``r - 0
            V`` is ``r``), its norm and H's correction selected; a step
            whose refinement fails (the second pass, SRC/dsaitr.f:
            760-781) is only flagged, and the host runs the extension
            again (``recover``).  A step entering with rnorm <= 0 is a
            breakdown: it and every later step commit no counter or flag
            (``live``)."""
            r, br, rn_prev, live, rec = c
            brk = rn_prev <= 0
            live = live & ~brk
            inv = one_r / torch.clamp_min(rn_prev, tiny_f)
            v_j = r * inv
            bv_j = br * inv if is_g else v_j
            ds.V[j] = v_j
            w, bw = op.apply(v_j, bv_j)
            wnorm = bnorm(w, bw)
            h = _proj_rows(ds.V, bw, j)
            r, br, rnorm = _update_bnorm(w, h, ds.V, j)
            needs = (rnorm <= eta_f * wnorm) & live
            s = torch.where(needs, _proj_rows(ds.V, br, j), zero_c)
            r, br, rn2 = _update_bnorm(r, s, ds.V, j)
            col = torch.where(needs, h + s, h)
            for lst, t in zip(rec, (brk, needs,
                                    needs & ~(rn2 > eta_f * rnorm),
                                    torch.nn.functional.pad(
                                        col, (0, ncv - col.shape[0])),
                                    rn_prev)):
                lst.append(t)
            return r, br, torch.where(needs, rn2, rnorm), live, rec

        def _tridiag(ds: DeviceLanczos, k0: int, k_end: int, rn) -> None:
            """T's diagonal and subdiagonal from H's steps ``k0 ..
            k_end - 1`` (what the symmetric reduced space reads), and
            ``b[k_end - 1]`` the residual norm."""
            lo = max(k0 - 1, 0)
            ds.a[k0:k_end] = torch.diagonal(ds.H)[k0:k_end].real
            ds.b[lo:k_end - 1] = torch.diagonal(ds.H, -1)[lo:k_end - 1].real
            ds.b[k_end - 1] = rn

        def run_dgks(ds: DeviceLanczos, k0: int, k_end: int) -> None:
            """Steps ``k0 .. k_end - 1`` with no device-to-host read (what
            a CUDA graph captures): the results go into ``ds`` in place,
            the entry is saved for ``REDO``."""
            _save_entry(ds)
            if k_end <= k0:
                ds.brk.copy_(no_brk)
                return
            c = (ds.resid, ds.b_resid, ds.rnorm, live0,
                 ([], [], [], [], []))
            for j in range(k0, k_end):
                c = _dgks_step(j, ds, c)
            r, br, rn, _, (brks, needs, fails, cols, rn_prevs) = c
            # H's columns k0..k_end-1, then the subdiagonal entries each
            # step wrote after its column: H[j, j-1] = the rnorm it began
            # with (dsaitr.f:680-690)
            ds.H[:, k0:k_end] = torch.stack(cols, 1)
            lo = max(k0, 1)
            if lo < k_end:
                torch.diagonal(ds.H, -1)[lo - 1:k_end - 1] = torch.stack(
                    rn_prevs[lo - k0:])
            n_ref = torch.count_nonzero(torch.stack(needs))
            ds.cnt.add_(torch.stack([n_ref, zero_l, n_ref * nbx1, zero_l]))
            ds.resid.copy_(r)
            if is_g:
                ds.b_resid.copy_(br)
            ds.rnorm.copy_(rn)
            if cfg.symmetric:
                _tridiag(ds, k0, k_end, rn)
            bds = torch.zeros(ncv, dtype=torch.bool, device=device)
            bds[k0:k_end] = torch.stack(brks)
            ds.brk.copy_(_first_break(bds, torch.stack(fails).any()))

        def recover_dgks(ds: DeviceLanczos, brk: int, k0: int, k_end: int,
                         gen, counts, info, force: int = 0):
            """The host's steps (``_step``) after an extension ``k0 ..
            k_end - 1`` whose breakdown word is ``brk``: from the
            breakdown step on (it draws a restart vector on the host
            generator, dsaitr.f:380-427), or after a failed refinement
            (``REDO``) the whole extension again from its saved entry.
            The results go back into ``ds``.  ``force`` is the selective
            step's and unused.  Returns ``(counts, info, k_stop)``."""
            reruns["redo" if brk == REDO else "breakdown"] += 1
            if brk == REDO:
                _restore_entry(ds)
                j0, rn = k0, _host(ds.rnorm, rdt)
            else:
                counts = static_counts(counts, brk - k0)
                j0, rn = brk, R(0)
            # rows past j0 hold the first run's values (after a breakdown,
            # maybe not finite); zero them, as a masked product reads them
            ds.V[j0:] = 0
            st = stepwise(FactorizationState(
                V=ds.V, H=ds.H.cpu().numpy().copy(), resid=ds.resid,
                b_resid=ds.b_resid, rnorm=rn, k=j0, nev_cur=0, iter=0,
                info=info, gen=gen, counts=counts), k_end)
            ds.H.copy_(torch.from_numpy(st.H))
            if st.resid is not ds.resid:
                ds.resid.copy_(st.resid)
                if is_g:
                    ds.b_resid.copy_(st.b_resid)
            ds.rnorm.fill_(float(st.rnorm))
            if cfg.symmetric and st.k > j0:
                _tridiag(ds, j0, st.k, ds.rnorm)
            ds.brk.fill_(-1)
            return st.counts, st.info, st.k

        def _read(ds: DeviceLanczos):
            """One read: the breakdown word, rnorm, the counters, H."""
            Hr = torch.view_as_real(ds.H) if cplx else ds.H
            back = torch.cat([ds.brk.double().reshape(1),
                              ds.rnorm.double().reshape(1), ds.cnt.double(),
                              Hr.double().reshape(-1)]).cpu().numpy()
            H = back[6:].reshape((ncv, ncv, 2) if cplx else (ncv, ncv))
            if cplx:
                H = H.view(np.complex128)[..., 0]
            return (int(back[0]), R(back[1]), back[2:6].astype(np.int64),
                    H.astype(dtype))

        def extend_dgks(st: FactorizationState, k_end: int
                        ) -> FactorizationState:
            """Extend from ``st.k`` to ``k_end``: :func:`run_dgks`, then
            one read (a second after the host's rerun)."""
            if st.info != 0 or st.k >= k_end:
                return st
            k0 = st.k
            ds = load(st)
            run_dgks(ds, k0, k_end)
            counts, info, k_stop = st.counts, st.info, k_end
            brk, rn, cnt, H = _read(ds)
            if brk != -1:
                counts, info, k_stop = recover_dgks(ds, brk, k0, k_end,
                                                    st.gen, counts, info)
                _, rn, cnt, H = _read(ds)
            else:
                counts = static_counts(counts, k_end - k0)
            counts = counts.add(nrorth=cnt[0], nitref=cnt[1], nbx=cnt[2],
                                nrorthr=cnt[3])
            return st.replace(V=ds.V, H=H, resid=ds.resid,
                              b_resid=ds.b_resid, rnorm=rn, k=k_stop,
                              info=info, counts=counts)

        return Extension(extend_dgks, load=load, run=run_dgks,
                         recover=recover_dgks, static_counts=static_counts,
                         stepwise=stepwise, put_h=put_h)

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
    tau = float(R(np.sqrt(eps_eff) / _dt.SELECTIVE_SAFETY))
    eps1 = float(R(eps_eff))
    # eta-subset selection threshold, capped below tau so the selection
    # always includes the rows that caused the event
    eta_sub = float(R(min(eps_eff ** 0.75,
                          float(np.sqrt(eps_eff) / _dt.SELECTIVE_SAFETY)
                          / 2.0)))
    # fused ||r'||^2 from the event update: real standard problems, plain
    # norms
    fuse_sel_norm = not is_g and not cfg.safe_norms and not cplx
    # one all-reduce for wnorm's and alpha's partials (plain norms)
    merge_wa = mesh is not None and not cfg.safe_norms
    dot = torch.vdot if cplx else torch.dot
    # (each torch op of a step is one node of the captured graph, and on
    # the card a node costs about as much as its work: the masks and
    # tables below save ops)
    col = torch.arange(ncv, device=device)
    rows_all = col.to(torch.int32)
    before = col[None, :] < col[:, None]          # [i, l]: l < i
    past = col[None, :] > col[:, None]            # [j, i]: i > j
    upto = ~past                                  # [j, i]: i <= j
    eye = torch.eye(ncv, dtype=torch.bool, device=device)
    # the event's bucket K by the count of rows above eta_sub (the
    # reference's rule, tabulated)
    ktab = torch.tensor(
        [ncv if nbuckets == 1 or full_reorth else
         rows_list[min(max(max(c - 1, 0) // _BUCKET + sel_extra, 0),
                       nbuckets - 1)] for c in range(ncv + 1)],
        dtype=torch.int32, device=device)
    zero_1 = torch.zeros(1, dtype=rtd, device=device)
    ninf_r = torch.full((), -np.inf, dtype=rtd, device=device)
    zero_i = torch.zeros((), dtype=torch.int32, device=device)
    tau_vec = torch.full((ncv,), tau, dtype=rtd, device=device)
    eps1_vec = torch.full((ncv,), eps1, dtype=rtd, device=device)
    no_force = torch.zeros((), dtype=torch.bool, device=device)

    def _omega_update(a, b, wp, wc, j, wnorm, beta_j):
        """One row of Simon's omega recurrence (signed terms, abs at the
        end, additive noise eps1*wnorm):  beta_j w_{j+1,i} =
        beta_i w_{j,i+1} + (alpha_i - alpha_j) w_{j,i}
        + beta_{i-1} w_{j,i-1} - beta_{j-1} w_{j-1,i}.
        One torch op per float32 op of the numpy recurrence it replaced,
        in the same order (no fused forms), so every decision repeats; the
        entries past j of a and b are stale and masked out.  Constants go
        in as device tensors or with ``fill_`` (an indexed assignment of a
        Python number copies a host tensor, which a CUDA graph cannot
        hold)."""
        aj = a[j]
        bjm1 = b[j - 1] if j > 0 else zero_r
        wc_full = torch.where(eye[j], one_r, wc)
        wp_full = torch.where(eye[j - 1], one_r, wp) if j > 0 else wp
        wc_p1 = torch.roll(wc_full, -1)
        wc_m1 = torch.cat([zero_1, wc_full[:-1]])
        b_m1 = torch.cat([zero_1, b[:-1]])
        t = b * wc_p1 + (a - aj) * wc_full + b_m1 * wc_m1 - bjm1 * wp_full
        den = torch.clamp_min(beta_j, tiny_f)
        ew = wnorm * eps1
        wn = (torch.abs(t) + ew) / den
        wn = torch.where(eye[j], ew / den, wn)
        wn[j + 1:].fill_(0)
        return wn

    def _descending(key):
        """numpy's stable argsort of ``-key`` without a sort: each entry's
        rank counts the larger keys and the equal ones before it.  A NaN
        (only in the steps after a breakdown, which commit nothing) ranks
        as -inf, so the order is always a permutation."""
        key = torch.where(torch.isnan(key), ninf_r, key)
        rank = ((key[None, :] > key[:, None])
                | ((key[None, :] == key[:, None]) & before)).sum(1)
        order = torch.empty(ncv, dtype=torch.int32, device=device)
        return order.scatter_(0, rank, rows_all), rank

    def _pass(idx, word, V, r, br, s):
        """The in-place update ``r -= sum_{k < word} s[k] V[idx[k]]`` of an
        event pass and the new residual's B-norm (garbage where word = 0:
        the caller selects); for complex dtypes ``s`` is the coefficient
        vector by row.  Returns ``(r, br, norm)``."""
        if cplx:
            r = r - s @ V
            br = b_apply(r)
            return r, br, bnorm(r, br)
        if fuse_sel_norm:
            r, rn2 = sel_update(idx, s, r, V, with_norm=True, word=word)
            return r, r, torch.sqrt(red(rn2))
        sel_update(idx, s, r, V, word=word)
        br = b_apply(r)
        return r, br, bnorm(r, br)

    def _doubtful_pass(j, ds, r, br, rn1):
        """The doubtful case (the norm still collapsed after the event), on
        the host: one full bucketed CGS pass, then the reference's
        span-declare give-up (SRC/dsaitr.f:773-781).  Its counters go into
        ``ds.cnt``.  Returns ``(r, br, rnorm)``."""
        V = ds.V
        h = _proj_upto(V, br, j)
        r = _update_upto(r, h, V, j)
        br = b_apply(r)
        rn2 = bnorm(r, br)
        in_span = not _host(rn2, rdt) > eta * _host(rn1, rdt)
        if in_span:
            r, br, rn2 = torch.zeros_like(r), torch.zeros_like(br), zero_r
        ds.cnt.add_(torch.tensor([0, 1 + int(in_span), nbx1, _rows_upto(j)],
                                 dtype=torch.int64, device=device))
        return r, (br if is_g else r), rn2

    def _pro_step(j, ds, c, restarted, host_doubt):
        """Lanczos step j (dsaitr with Simon's recurrence and an eta-subset
        event) with no device-to-host read: every decision is a device
        tensor, and an event that does not fire is a pair of kernel
        launches whose row-count word is 0.  ``c`` carries (r, br, rnorm,
        wp, wc, force, live) and the extension's per-step records (the
        breakdown flags, each event's and doubtful case's flags, the
        words); ``restarted``: the step follows a fresh restart vector
        (host-known).  A step entering with rnorm <= 0 is a breakdown: it
        and every later step of the extension commit no counter, flag or
        omega (``live``), and the first breakdown flag names it for the
        host.  A doubtful event is only flagged, and the host runs the
        extension again (``recover``) with ``host_doubt``: the step then
        reads the flag and runs the doubtful pass itself."""
        r, br, rn_prev, wp, wc, force, live, bds, ev, words = c
        if restarted:
            # a fresh restart vector is fully orthogonalized
            wp = wc = eps1_vec
        else:
            live = live & ~torch.le(rn_prev, 0, out=bds[j])
        V = ds.V
        inv = one_r / torch.clamp_min(rn_prev, tiny_f)
        v_j = r * inv
        bv_j = br * inv if is_g else v_j
        V[j] = v_j
        w, bw = op.apply(v_j, bv_j)
        # three-term recurrence: reads one stored row, v_{j-1}
        if merge_wa:
            # under a mesh, <w, Bw> and alpha in one all-reduce: the
            # collectives are latency-bound (the same partials, summed)
            p = red(torch.stack([dot(w, bw), dot(v_j, bw)]))
            wnorm = torch.sqrt(torch.abs(p[0]))
            alpha = p[1].real if cplx else p[1]
        else:
            wnorm = bnorm(w, bw)
            alpha = (red(torch.vdot(v_j, bw)).real if cplx
                     else red(torch.dot(v_j, bw)))
        beta = zero_r if (restarted or j == 0) else rn_prev
        v_jm1 = V[max(j - 1, 0)].to(tdt)
        r = w - alpha * v_j - beta * v_jm1
        br = b_apply(r)
        rnorm = bnorm(r, br)
        ds.a[j] = alpha
        if j > 0:
            ds.b[j - 1] = beta
        ds.b[j] = rnorm
        wn = _omega_update(ds.a, ds.b, wp, wc, j, wnorm, rnorm)
        need = ((torch.max(wn) > tau) | force) & live
        # the event: one CGS pass against the eta-selected rows
        # (Larsen/PROPACK), padded up to an 8-row bucket K; rows past j are
        # masked out (their keys are -inf: they sort last)
        sel_key = torch.where(past[j], ninf_r, wn)
        idx, rank = _descending(sel_key)
        cnt = torch.sum(sel_key > eta_sub).reshape(1)
        word = torch.where(need, torch.gather(ktab, 0, cnt).reshape(()),
                           zero_i)
        take = (col < word) & upto[j]
        if cplx:
            s = complex_event(idx, V, br, take, red)
        else:
            s = torch.where(take, red(sel_proj(idx, V, br, word=word)),
                            zero_r)
        reset = torch.gather(take, 0, rank)
        r, br_ev, rn_ev = _pass(idx, word, V, r, br, s)
        br = torch.where(need, br_ev, br) if is_g else r
        rn_out = torch.where(need, rn_ev, rnorm)
        # reorthogonalized rows drop to the eps floor
        wn = torch.where(reset, eps1_vec, wn)
        # doubtful case: the norm still collapsed
        doubt = need & ~(rn_out > rnorm * eta_f)
        if not host_doubt:
            ev[j] = torch.stack([need, doubt])
        else:
            ev[j, 0] = need
            if bool(doubt):
                r, br, rn_out = _doubtful_pass(j, ds, r, br, rn_out)
                wn = eps1_vec
        words[j] = word
        # pair rule: reorthogonalize the next step too, unless this event
        # was the forced follow-up
        force_out = need & ~force
        if cfg.pair_rule == "clean":
            force_out = force_out & (torch.max(torch.where(
                col < j, wc, zero_r)) > eta_sub)
        force = torch.where(live, force_out, force)
        return r, br, rn_out, wc, wn, force, live, bds, ev, words

    def run(ds: DeviceLanczos, k0: int, k_end: int, carry=None,
            restarted: bool = False, host_doubt: bool = False):
        """Steps ``k0 .. k_end - 1`` with no device-to-host read (what a
        CUDA graph captures): the results go into ``ds`` in place.
        ``carry`` is the ``(wp, wc, force)`` of the previous step, or None
        at an extension's start (omega starts AT tau: the mutual defect of
        carried-over columns is unknown at a restart boundary; the entry
        is saved for ``REDO``); ``restarted``: step ``k0`` follows a fresh
        restart vector; ``host_doubt``: the steps run the doubtful pass
        (eager, with host reads: ``recover``).  Returns the carry after the
        last step."""
        if carry is None:
            wp, wc, force = tau_vec, tau_vec, no_force
            _save_entry(ds)
        else:
            wp, wc, force = carry
        # each step's breakdown flag, (event, doubtful case) and row-count
        # word, summed into the results once at the end
        bds = torch.zeros(ncv, dtype=torch.bool, device=device)
        ev = torch.zeros((ncv, 2), dtype=torch.bool, device=device)
        words = torch.zeros(ncv, dtype=torch.int32, device=device)
        c = (ds.resid, ds.b_resid, ds.rnorm, wp, wc, force, live0, bds, ev,
             words)
        for j in range(k0, k_end):
            c = _pro_step(j, ds, c, restarted and j == k0, host_doubt)
        r, br, rn, wp, wc, force, _, _, _, _ = c
        # a doubtful event, else the first breakdown
        brk = _first_break(bds, ev[k0:k_end, 1].any())
        n_ev = ev[k0:k_end, 0].long().sum()
        ds.cnt.add_(torch.stack([n_ev, zero_l, n_ev * nbx1,
                                 words[k0:k_end].long().sum()]))
        if r is not ds.resid:
            ds.resid.copy_(r)
            if is_g:
                ds.b_resid.copy_(br)
            ds.rnorm.copy_(rn)
        ds.brk.copy_(brk)
        ds.force.copy_(force)
        return wp, wc, force

    def recover(ds: DeviceLanczos, brk: int, k0: int, k_end: int, gen,
                counts, info, force: int):
        """The host's steps after an extension ``k0 .. k_end - 1`` whose
        breakdown word is ``brk``: from the breakdown step ``brk`` on, or,
        after a doubtful event (``brk == REDO``), the whole extension again
        from its saved entry.  One step at a time with a host read of rnorm
        each: an invariant-subspace hit draws a restart vector on the host
        generator (dsaitr.f:380-427) and a doubtful event runs its pass.
        ``force``: the pair rule's flag entering ``brk``.  Returns
        ``(counts, info, k_stop)``."""
        reruns["redo" if brk == REDO else "breakdown"] += 1
        if brk == REDO:
            _restore_entry(ds)
            j0, broken, force = k0, False, 0
        else:
            counts = static_counts(counts, brk - k0)
            j0, broken = brk, True
        # rows past j0 hold the first run's values (after a breakdown, not
        # finite); zero them, as a masked product of them then reads
        ds.V[j0:] = 0
        carry = (tau_vec, tau_vec, torch.full((), bool(force),
                                              dtype=torch.bool,
                                              device=device))
        for j in range(j0, k_end):
            # step j0 of a breakdown met rnorm <= 0; ds.rnorm holds the
            # broken steps' value
            rn = R(0) if broken and j == j0 else _host(ds.rnorm, rdt)
            rstart = rn <= 0
            if rstart and info == 0:
                st = _restart_vector(FactorizationState(
                    V=ds.V, H=None, resid=ds.resid, b_resid=ds.b_resid,
                    rnorm=rn, k=j, nev_cur=0, iter=0, info=info, gen=gen,
                    counts=counts), j)
                counts, info = st.counts, st.info
                ds.resid.copy_(st.resid)
                if is_g:
                    ds.b_resid.copy_(st.b_resid)
                ds.rnorm.fill_(float(st.rnorm))
            if info != 0:
                return counts, info, j
            carry = run(ds, j, j + 1, carry, restarted=rstart,
                        host_doubt=True)
            counts = static_counts(counts, 1)
        return counts, info, k_end

    def finish(ds: DeviceLanczos, st: FactorizationState, k0: int,
               k_end: int) -> FactorizationState:
        """The state after :func:`run` of steps ``k0 .. k_end - 1``: one
        read of the device results, the host's rerun after a breakdown,
        the host fields (H, rnorm, counters)."""
        counts, info, k_stop = st.counts, st.info, k_end
        brk = int(ds.brk)
        if brk != -1:
            counts, info, k_stop = recover(ds, brk, k0, k_end, st.gen, counts,
                                           info, int(ds.force))
        else:
            counts = static_counts(counts, k_end - k0)
        back = torch.cat([ds.a.double(), ds.b.double(),
                          ds.rnorm.double().reshape(1),
                          ds.cnt.double()]).cpu().numpy()
        a, b = back[:ncv], back[ncv:2 * ncv]
        ev = back[2 * ncv + 1:].astype(np.int64)
        counts = counts.add(nrorth=ev[0], nitref=ev[1], nbx=ev[2],
                            nrorthr=ev[3])
        H = st.H.copy()
        for j in range(k0, k_stop):
            H[j, j] = a[j]
            if j > 0:
                H[j, j - 1] = H[j - 1, j] = b[j - 1]
        return st.replace(V=ds.V, H=H, resid=ds.resid, b_resid=ds.b_resid,
                          rnorm=R(back[2 * ncv]), k=k_stop, info=info,
                          counts=counts)

    def extend(st: FactorizationState, k_end: int) -> FactorizationState:
        """Extend from the state's current length ``st.k`` to ``k_end``."""
        if st.info != 0 or st.k >= k_end:
            return st
        ds = load(st)
        run(ds, st.k, k_end)
        return finish(ds, st, st.k, k_end)

    return Extension(extend, load=load, run=run, recover=recover,
                     static_counts=static_counts, put_h=put_h, selective=True)
