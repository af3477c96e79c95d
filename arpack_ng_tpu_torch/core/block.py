"""Thick-restart BLOCK Lanczos (port of ``arpack_ng_tpu/core/block.py``):
the b > 1 extension that arpack-ng fixes at nb = 1 (SRC/dsaupd.f:160
"NB: blocksize to be used ... use 1").

A block step applies the operator to b vectors at once and
orthogonalizes them against the basis in one pair of ``(s, n) x (n, b)``
products, so per new column the operator's data (DIA diagonals) is read
once per block instead of once per vector
(:func:`~arpack_ng_tpu_torch.ops.sparse.dia_block_matvec_fn`, the block
DIA kernel on the card) and the basis is streamed 2/b times.  Scalar
Krylov degree grows b times faster per matvec than block degree, so on
generic spectra the scalar selective path keeps its lead end to end;
block Lanczos converges degenerate multiplets of multiplicity <= b in one
sweep, which scalar Lanczos cannot.

Design (the reference's): Krylov-Schur / thick-restart form with a STATIC
restart size ``kev = nev + b`` rounded up to a multiple of b; the restart
keeps the kev wanted Ritz vectors plus the current residual block, with
the arrow coupling ``B_p S[last b rows]`` written explicitly into H.

On the device:

* the basis ``V`` is ``(ncv + b, n_pad)`` rows (the reference's
  ``(npan, 128)`` tiling was the TPU's layout); the solver updates it in
  place;
* the block CGS passes, the Gram matrices and CholQR2 are plain torch
  products under :func:`~arpack_ng_tpu_torch.utils.precision.
  pin_full_precision` (no TF32), as the reference left them to XLA;
* the thick restart ``V[:kev] = S_k^T V[:ncv]`` is the rotation kernel
  (:func:`~arpack_ng_tpu_torch.ops.cuda_rot.rotate_rows`, ``rows = kev``),
  which leaves rows ``ncv..ncv+b`` alone;
* ``eigh(T)`` runs on the device (``torch.linalg.eigh``) in float64 for
  every problem dtype; the reference's runs in the problem's dtype, and
  in float32 its eigenvectors are orthonormal to ~1e-6 only: the thick
  restart rotates the basis by them with no reorthogonalization, so the
  basis drifts that much per cycle (2e-4 after 300 cycles of the 2-D
  Laplacian at n = 65,536) and the Ritz values climb past the spectrum
  while their bounds stay small.  One read per cycle brings the wanted
  Ritz values and bounds to the host for the convergence test;
* the reference compiles the whole cycle (``hoisted_jit(cycle)``): here
  ``eigh`` stays outside (it synchronizes) and the rest of the cycle (the
  bounds, the thick restart, the new arrow H and the block steps back to
  ncv) runs on buffers that live for the whole solve, H rebuilt in place;
  on a CUDA card, for a capturable operator (and a mesh whose transport
  is, NCCL), that work is one CUDA graph (``core/loop.CapturedGraph``),
  captured in the second cycle after the first ran eagerly on the solve's
  stream and replayed every cycle after, with the same kernels in the
  same order as the eager cycle (``cholesky_ex`` and the triangular solve
  of CholQR2 capture as they are).  The matvec count is a host count each
  cycle adds to.

The reference cached built solvers by ``id(op)`` to amortize XLA
compiles; the port compiles nothing and keeps no such cache.

Under a row mesh (``mesh=``) each rank holds its rows of V; the block
CGS coefficients and CholQR2's Gram matrices are all-reduced, H and the
reduced space are replicated, and the Ritz vectors are gathered whole
onto every rank at the end.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import cuda_krylov_loop
from ..ops.cuda_rot import rotate_rows
from ..ops.operator import Operator
from ..parallel.sharding import mesh_operator
from ..utils import dtypes as _dt
from ..utils.precision import pin_full_precision
from .loop import CapturedGraph


class BlockState(NamedTuple):
    V: torch.Tensor    # (ncv + b, n_pad) basis rows, updated in place
    H: torch.Tensor    # (ncv + b, ncv + b) symmetric projection, in place
    nmv: int           # matvec counter
    run: Optional["_BlockRun"] = None   # the solve's cycle buffers, graph


class _BlockRun:
    """What one solve's cycles share (made by ``init``): T's eigenpairs in
    float64 (what ``eigh`` hands the restart), and on a CUDA card for a
    capturable operator the restart and refill as one CUDA graph
    (``core/loop.CapturedGraph``, captured in the second cycle, after the
    first ran eagerly on the same stream as its warm-up) and that
    stream."""

    def __init__(self, ncv: int, device, capture: bool):
        self.theta = torch.zeros(ncv, dtype=torch.float64, device=device)
        self.S = torch.zeros((ncv, ncv), dtype=torch.float64, device=device)
        self.capture = capture
        self.graph = None
        self.cycles = 0
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device=device)
            self.pool = torch.cuda.graph_pool_handle()


def _same(t):
    return t


def _qr_rows(W, red=_same):
    """Row-stored thin QR of the block via CholQR2: with column matrices
    ``W_c = W^T = Q_c R`` (R upper b x b), returns ``(Q_c^T as rows, R)``;
    the new-block coupling H[new, cur] equals R.

    CholQR (Gram Cholesky + triangular solve) costs two streaming passes
    over the (b, n) block and a b x b factorization; applied twice
    (CholQR2) the orthogonality defect is eps-level for any block the
    preceding CGS left well-conditioned.  A tiny trace-scaled ridge guards
    rank-deficient blocks (breakdown surfaces as a huge R entry, caught by
    the bounds test).  ``cholesky_ex`` reads no error flag back, so a
    step never waits on the device.  The triangular solve is ``inv(L) @
    W``, the b x b inverse first: cuBLAS's triangular solve with the
    block's n columns as right-hand sides stalled the flagship's b = 2
    solve on an H100.  ``red``: the all-reduce of the Gram matrix's
    partials under a mesh (W holds this rank's columns)."""
    b = W.shape[0]
    eye = torch.eye(b, dtype=W.dtype, device=W.device)
    eps = torch.finfo(W.dtype).eps

    def one(Wf):
        G = red(Wf @ Wf.T)
        ridge = 1e-30 + eps * torch.trace(G) / b
        L, _ = torch.linalg.cholesky_ex(G + ridge * eye)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        return Linv @ Wf, L.T

    Q1, R1 = one(W)
    Q2, R2 = one(Q1)
    return Q2, R2 @ R1


def make_block_solver(op: Operator, b: int, nev: int, ncv: int,
                      dtype, seed: int = 0):
    """Build ``(init, cycle, extract, kev)`` for thick-restart block
    Lanczos with block size ``b``, static restart size ``kev = nev + b``
    (rounded up to a multiple of b so restarts stay block-aligned).

    ``init(gen=None, X0=None)``: the start block, uniform(-1, 1) drawn
    from ``gen`` (default: a host generator seeded with ``seed``) or the
    caller's ``X0`` (``(b, n)`` or ``(b, n_pad)``), zero on the pad.
    ``cycle(state) -> (state, theta, bounds)`` with the nev wanted Ritz
    values and bounds on the device; ``extract(state) -> (vals, vecs)`` on
    the host in float64.  Under the operator's mesh (``op.mesh``) the
    basis holds this rank's rows and ``vecs`` comes back whole."""
    if ncv % b:
        raise ValueError("ncv must be a multiple of the block size")
    if op.bmat != "I":
        raise ValueError("block Lanczos harness supports standard "
                         "problems (bmat='I') only")
    if _dt.is_complex(np.dtype(dtype)):
        raise ValueError("block Lanczos harness is real-only")
    kev = -(-(nev + b) // b) * b            # static thick-restart size
    if kev + 2 * b > ncv:
        raise ValueError("need ncv >= kev + 2b (room to expand)")
    if ncv + b > op.n:
        raise ValueError(
            f"ncv + b = {ncv + b} orthonormal basis rows cannot exist in "
            f"an n = {op.n}-dimensional space (reference info = -3 class)")
    n, n_pad = op.n, op.n_pad
    if n_pad % 128:
        raise ValueError("n_pad must be a multiple of 128")
    mesh = op.mesh
    red = _same if mesh is None else mesh.sum
    if mesh is not None and (n_pad // 128) % mesh.size:
        raise ValueError("n_pad/128 must divide the mesh size for "
                         "the block driver")
    n_loc = n_pad if mesh is None else mesh.n_loc(n_pad)
    pin_full_precision()
    tdt = _dt.torch_dtype(np.dtype(dtype))
    device = op.device
    nrow = ncv + b
    # an operator of another dtype gets the solve's vectors, and its
    # product promotes (or refuses) as torch's arithmetic does, as the
    # reference's jnp products promote; its block product, a kernel of the
    # operator's dtype, is left out
    promote = np.dtype(dtype) != op.dtype
    blk_fn = None if promote else op.apply_block

    def a_block(Vb):                       # (b, n_pad) -> same
        if blk_fn is not None:
            return blk_fn(Vb)
        return torch.stack([op.apply(x, x)[0].to(tdt) for x in Vb])

    def _ortho_block(V, s, W):
        """Full block CGS of W (b rows) against V[:s], two passes (block
        DGKS); returns (W, coeffs (s, b))."""
        Vs = V[:s]
        c1 = red(Vs @ W.T)
        W = W - c1.T @ Vs
        c2 = red(Vs @ W.T)
        W = W - c2.T @ Vs
        return W, c1 + c2

    def _steps(V, H, s0) -> int:
        """Extend: the current orthonormal block sits at rows [s0-b, s0);
        run block steps until ncv rows are filled, leaving the final
        residual block (orthonormalized) at rows [ncv, ncv+b).  Returns the
        matvecs."""
        s = s0
        while s + b <= ncv + b:
            AW = a_block(V[s - b:s])
            AW, coeff = _ortho_block(V, s, AW)
            Q, R = _qr_rows(AW, red)
            V[s:s + b] = Q
            H[:s, s - b:s] = coeff
            H[s - b:s, :s] = coeff.T
            H[s:s + b, s - b:s] = R
            H[s - b:s, s:s + b] = R.T
            s += b
        return s - s0

    # a mesh's collectives are captured where its transport allows
    capture = (device.type == "cuda" and op.capturable
               and (mesh is None or mesh.capturable))

    def init(gen: Optional[torch.Generator] = None, X0=None) -> BlockState:
        X = torch.zeros((b, n_pad), dtype=tdt)
        if X0 is None:
            if gen is None:
                gen = torch.Generator().manual_seed(seed)
            X[:, :n] = torch.rand((b, n_pad), generator=gen,
                                  dtype=tdt)[:, :n] * 2 - 1
        else:
            X[:, :n] = torch.as_tensor(np.asarray(X0))[:, :n].to(tdt)
        if mesh is not None:
            X = mesh.local(X).contiguous()
        Q, _ = _qr_rows(X.to(device), red)
        V = torch.zeros((nrow, n_loc), dtype=tdt, device=device)
        V[:b] = Q
        H = torch.zeros((nrow, nrow), dtype=tdt, device=device)
        nmv = _steps(V, H, b)
        return BlockState(V=V, H=H, nmv=nmv,
                          run=_BlockRun(ncv, device, capture))

    def restart(V, H, run):
        """The cycle after T's eigensolve (``run.theta``, ``run.S``), with
        no device-to-host read (what the graph holds): the bounds, the
        thick restart and the refill, V and H in place.  Returns the nev
        wanted Ritz values and bounds, and the matvecs."""
        theta, S = run.theta, run.S.to(tdt)
        # bounds: || B_p * S[last b rows, i] ||, B_p = H[ncv:ncv+b,
        # ncv-b:ncv] (a copy: H is rebuilt in place below)
        Bp = H[ncv:nrow, ncv - b:ncv].clone()
        bounds = torch.linalg.norm(Bp @ S[ncv - b:ncv, :], dim=0)
        # wanted = largest algebraic (LA) at the top end of eigh order;
        # thick restart: V[:kev] = S_k^T V[:ncv]; residual block moves down
        theta_k = theta[ncv - kev:]
        S_k = S[:, ncv - kev:].contiguous()
        rotate_rows(S_k, V[:ncv], kev)
        V[kev:kev + b] = V[ncv:nrow]
        H.zero_()
        H.diagonal()[:kev] = theta_k.to(tdt)
        arrow = Bp @ S_k[ncv - b:ncv, :]                  # (b, kev)
        H[kev:kev + b, :kev] = arrow
        H[:kev, kev:kev + b] = arrow.T
        mv = _steps(V, H, kev + b)
        return theta[ncv - nev:], bounds[ncv - nev:].double(), mv

    def _cycle(st: BlockState):
        V, H, run = st.V, st.H, st.run
        T = H[:ncv, :ncv].double()
        # in float64 whatever the problem dtype (the reference's float32
        # eigh leaves S orthonormal to ~1e-6, and the restart below rotates
        # V by it unchecked: the basis drifts that much every cycle)
        theta, S = torch.linalg.eigh((T + T.T) / 2)
        cuda_krylov_loop.settle_pending()   # eigh synchronised
        run.theta.copy_(theta)
        run.S.copy_(S)
        run.cycles += 1
        if not run.capture or run.cycles == 1:
            theta_w, bounds_w, mv = restart(V, H, run)
        else:
            if run.graph is None:
                run.graph = CapturedGraph(lambda: restart(V, H, run),
                                          run.pool, mesh)
            theta_w, bounds_w, mv = run.graph.replay()
        return st._replace(nmv=st.nmv + mv), theta_w, bounds_w

    def cycle(st: BlockState):
        """Ritz + thick restart + refill: ``eigh`` of T (it synchronizes),
        then :func:`restart`, replayed as one CUDA graph from the second
        cycle on where the solve captures."""
        if st.run is None:
            st = st._replace(run=_BlockRun(ncv, device, capture))
        if device.type != "cuda":
            return _cycle(st)
        cur = torch.cuda.current_stream(device)
        st.run.stream.wait_stream(cur)
        try:
            with torch.cuda.stream(st.run.stream):
                return _cycle(st)
        finally:
            cur.wait_stream(st.run.stream)

    def extract(st: BlockState):
        """Ritz pairs of the current factorization (host, float64)."""
        H = st.H[:ncv, :ncv].cpu().numpy().astype(np.float64)
        cuda_krylov_loop.settle_pending()
        H = (H + H.T) / 2
        theta, S = np.linalg.eigh(H)
        V = st.V[:ncv].cpu().numpy()
        vecs = S[:, -nev:].T @ V
        if mesh is not None:
            vecs = mesh.gather_host(vecs)
        vecs = vecs[:, :n].T
        if op.perm is not None:
            # internal row i holds logical coordinate perm[i]
            unperm = np.empty_like(vecs)
            unperm[np.asarray(op.perm)] = vecs
            vecs = unperm
        return theta[-nev:], vecs

    return init, cycle, extract, kev


def eigsh_block(op_or_a, k: int = 6, *, block_size: int = 2,
                ncv: Optional[int] = None, tol: float = 0.0,
                maxiter: int = 200, dtype=None, seed: int = 0,
                mesh=None, X0=None, device=None):
    """Largest-algebraic eigenpairs by thick-restart block Lanczos
    (experimental; which='LA' only).  Returns ``(vals ascending, vecs,
    info dict)`` with the converged count, cycles (``iters``), matvec
    count, block size and kev.

    ``op_or_a``: an :class:`Operator` (its device is the solve's; a DIA
    operator of ``from_scipy`` brings its block product) or a dense or
    scipy sparse matrix moved to ``device`` (default: the card).  The
    start block is uniform(-1, 1) from a host generator seeded with
    ``seed``, or ``X0``.  ``dtype``: the solve's (default: the
    operator's); an operator of another dtype is applied to vectors of
    ``dtype`` and its results taken in ``dtype``, so a matrix-free product
    written with elementwise torch ops promotes (a float32 operator solved
    in float64), while one that multiplies a stored matrix of its own
    dtype refuses: pass the matrix itself, imported at ``dtype``.  Use it
    for degenerate clusters of multiplicity
    > 1 (``block_size >=`` the multiplicity): they converge in one sweep,
    where scalar Lanczos cannot separate the copies.  ``mesh``: the
    row-partitioned solve (the operator lifted onto it unless built for
    it; n_pad/128 must be a multiple of the mesh size), on the mesh's
    device unless ``device`` says otherwise."""
    from ..api import _as_operator, _mesh_device
    device = _mesh_device(mesh, device)
    op = (op_or_a if isinstance(op_or_a, Operator)
          else _as_operator(op_or_a, dtype=dtype, hermitian=True,
                            device=device))
    op = mesh_operator(op, mesh)
    b = block_size
    ncv = ncv or max(4 * b, 2 * (-(-(k + b) // b) * b) + 2 * b)
    ncv = -(-ncv // b) * b
    # clamp into the space like eigsh's min(ncv, n) convention
    if ncv + b > op.n:
        ncv = (op.n - b) // b * b
    dt = np.dtype(dtype or op.dtype)
    tol_eff = tol if tol > 0 else _dt.default_tol(dt)
    init, cycle, extract, kev = make_block_solver(op, b, k, ncv, dt,
                                                  seed=seed)
    return _run_block(init, cycle, extract, k, kev, b, tol_eff,
                      _dt.eps23(dt), maxiter, X0=X0)


def _run_block(init, cycle, extract, k, kev, b, tol_eff, eps23, maxiter,
               X0=None):
    st = init(X0=X0)
    nconv = 0
    for it in range(maxiter):
        st, theta, bounds = cycle(st)
        th, bo = torch.stack([theta, bounds]).cpu().numpy()
        nconv = int(np.sum(bo <= tol_eff * np.maximum(eps23, np.abs(th))))
        if nconv >= k:
            break
    vals, vecs = extract(st)
    return vals, vecs, {"nconv": nconv, "iters": it + 1,
                        "matvecs": st.nmv, "block_size": b, "kev": kev}
