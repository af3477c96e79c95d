"""Distribution layer (port of ``arpack_ng_tpu/parallel/sharding.py``):
PARPACK's row-block data distribution over a ``torch.distributed``
process group.

Reference model (SRC/dsaupd.f:331-348 "Data Distribution Note",
PARPACK/SRC/MPI/*):

* the problem dimension is row-block partitioned: each rank owns ``n_loc
  = n_pad / size`` rows of V, resid and b_resid;
* every ncv-sized quantity (H, Ritz values, bounds, Q, the device loop's
  tridiagonal and packet) is replicated;
* communication is an all-reduce of the Gram-Schmidt coefficient vectors
  (pdsaitr.f:604-610), all-reduces of the norms (pdsaitr.f:575, 672;
  the overflow-safe two-phase pdnorm2.f:70-80) and the reductions of
  pdgetv0, issued explicitly at those sites by the solver.

The solve is SPMD, as a PARPACK program is: one process per rank, each
calling the entry point with the same arguments.  Every rank draws the
same random vectors at full length and keeps its rows, and takes every
host decision on all-reduced numbers, so every rank takes the same
branch.  A :class:`RowMesh` counts its collectives by kind
(``counts``); a failed collective raises.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.operator import Operator
from ..utils.device import DEFAULT, require
from ..utils.device import same as same_device

ROWS = "rows"
#: the fields of a ``FactorizationState`` that each rank holds its rows
#: of; every other field is replicated (the reference's
#: ``state_shardings``)
LOCAL_FIELDS = ("V", "resid", "b_resid")
#: the collective kinds a mesh counts
KINDS = ("all_reduce", "all_reduce_max", "all_gather", "halo")


class RowMesh:
    """A 1-D row mesh over a ``torch.distributed`` process group (the
    world by default).  ``transport`` is fixed when the mesh is made:

    * ``'nccl'``: NCCL on the card; its collectives can be captured in a
      CUDA graph (``capturable``);
    * ``'gloo'``: gloo on CPU tensors;
    * ``'gloo+host'``: gloo on CUDA tensors, whose all-reduces gloo runs
      itself and whose gathers and halo transfers go through pinned host
      memory (gloo has no CUDA path for them).  Not capturable: gloo
      waits on the host."""

    def __init__(self, group=None, device=DEFAULT):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("a mesh needs torch.distributed to be "
                               "initialized (init_process_group)")
        self.group = group
        self.rank = dist.get_rank(group)
        if self.rank < 0:
            raise ValueError("this process is not a member of the group")
        self.size = dist.get_world_size(group)
        self.device = require(device)
        self.backend = str(dist.get_backend(group)).lower()
        if self.backend == "nccl":
            if self.device.type != "cuda":
                raise ValueError("an NCCL mesh runs on the card")
            self.transport = "nccl"
        elif self.backend == "gloo":
            self.transport = ("gloo+host" if self.device.type == "cuda"
                              else "gloo")
        else:
            raise ValueError(f"no transport for backend {self.backend!r}")
        self.capturable = self.transport == "nccl"
        self.counts = Counter({k: 0 for k in KINDS})
        #: elements moved by each kind, summed over calls
        self.elements = Counter({k: 0 for k in KINDS})
        #: with ``timed`` set (never under a capture), each collective
        #: waits for the device before and after it and adds its wall
        #: seconds to ``seconds`` by kind
        self.timed = False
        self.seconds = Counter()

    def __repr__(self) -> str:
        return (f"RowMesh(rank={self.rank}, size={self.size}, "
                f"transport={self.transport!r}, device={self.device})")

    # ---- layout ----------------------------------------------------------
    def n_loc(self, n_pad: int) -> int:
        """The rows each rank holds of an ``n_pad`` vector."""
        if n_pad % self.size:
            raise ValueError(f"n_pad={n_pad} must be divisible by the mesh "
                             f"size {self.size}")
        return n_pad // self.size

    def rows(self, n_pad: int) -> tuple:
        """This rank's row range ``[lo, hi)`` of an ``n_pad`` vector."""
        m = self.n_loc(n_pad)
        return self.rank * m, (self.rank + 1) * m

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows (the last axis) of a whole vector or rows."""
        lo, hi = self.rows(x.shape[-1])
        return x[..., lo:hi]

    def layout(self) -> dict:
        """Which ``FactorizationState`` fields are this rank's rows
        (``'rows'``) and which are replicated (``'replicated'``)."""
        from ..core.arnoldi import FactorizationState
        return {f.name: ROWS if f.name in LOCAL_FIELDS else "replicated"
                for f in dataclasses.fields(FactorizationState)}

    # ---- collectives -----------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, kind: str, numel: int, fn):
        """Count one collective of ``kind`` moving ``numel`` elements and
        run ``fn``, timed when ``timed`` is set."""
        self.counts[kind] += 1
        self.elements[kind] += numel
        if not self.timed:
            return fn()
        self._sync()
        t0 = time.perf_counter()
        out = fn()
        self._sync()
        self.seconds[kind] += time.perf_counter() - t0
        return out

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum) of the partials ``t`` in place; returns ``t``."""
        self._run("all_reduce", t.numel(), lambda: dist.all_reduce(
            torch.view_as_real(t) if t.is_complex() else t,
            op=dist.ReduceOp.SUM, group=self.group))
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce (max) of a real ``t`` in place; returns ``t``."""
        self._run("all_reduce_max", t.numel(), lambda: dist.all_reduce(
            t, op=dist.ReduceOp.MAX, group=self.group))
        return t

    def sum_host(self, a) -> np.ndarray:
        """All-reduce (sum) of a host array, through the mesh's device."""
        a = np.asarray(a)
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return self.sum(t).cpu().numpy()

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """A pinned host copy of a CUDA tensor (the staged transport)."""
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return h.copy_(t)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """All-gather of rows: ``(..., n_loc)`` on every rank to the whole
        ``(..., size * n_loc)``, in rank order."""
        return self._run("all_gather", t.numel(), lambda: self._gather(t))

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        cplx = t.is_complex()
        src = torch.view_as_real(t).flatten(-2) if cplx else t
        src = src.contiguous()
        if self.transport == "nccl":
            parts = torch.empty((self.size,) + src.shape, dtype=src.dtype,
                                device=src.device)
            dist.all_gather_into_tensor(parts, src, group=self.group)
        else:
            if self.transport == "gloo+host":
                src = self._host(src)
            bufs = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(bufs, src, group=self.group)
            parts = torch.stack(bufs).to(t.device)
        out = parts.movedim(0, -2).reshape(src.shape[:-1]
                                           + (self.size * src.shape[-1],))
        if cplx:
            out = torch.view_as_complex(out.unflatten(-1, (-1, 2)))
        return out

    def gather_host(self, a: np.ndarray) -> np.ndarray:
        """:meth:`gather` of a host array's last axis, through the mesh's
        device."""
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return self.gather(t).cpu().numpy()

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                 r)

    def exchange(self, first: torch.Tensor, last: torch.Tensor):
        """The halo exchange of a row-partitioned grid (pdsdrv1.f:466-480):
        ``first`` (this rank's first grid row) goes to the rank above,
        ``last`` to the rank below.  Returns ``(from_above, from_below)``,
        the neighbours' adjacent rows, zeros at the mesh's edges (the
        Dirichlet walls)."""
        n = first.numel() * ((self.rank > 0) + (self.rank < self.size - 1))
        return self._run("halo", n, lambda: self._exchange(first, last))

    def _exchange(self, first: torch.Tensor, last: torch.Tensor):
        staged = self.transport == "gloo+host"
        dev = first.device
        if staged:
            first, last = self._host(first), self._host(last)
        above = torch.zeros_like(first)
        below = torch.zeros_like(last)
        ops = []
        if self.rank > 0:
            up = self._peer(self.rank - 1)
            ops += [dist.P2POp(dist.isend, first.contiguous(), up,
                               self.group),
                    dist.P2POp(dist.irecv, above, up, self.group)]
        if self.rank < self.size - 1:
            down = self._peer(self.rank + 1)
            ops += [dist.P2POp(dist.isend, last.contiguous(), down,
                               self.group),
                    dist.P2POp(dist.irecv, below, down, self.group)]
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        if staged:
            above, below = above.to(dev), below.to(dev)
        return above, below

    def snapshot(self) -> Counter:
        """The counters now (a copy), to take differences against."""
        return Counter(self.counts)


def make_mesh(group=None, device=DEFAULT) -> RowMesh:
    """The row mesh over ``group`` (the world by default; a subgroup from
    ``torch.distributed.new_group``, as PARPACK's sub-communicator solve
    of issue46 uses) with its vectors on ``device`` (the card unless told
    otherwise; ``device="cpu"`` with a gloo group)."""
    return RowMesh(group, device)


def check_mesh(mesh) -> Optional[RowMesh]:
    """``mesh`` itself: None or a :class:`RowMesh` (a TypeError for
    anything else)."""
    if mesh is not None and not isinstance(mesh, RowMesh):
        raise TypeError(f"mesh must be a RowMesh (parallel.sharding."
                        f"make_mesh), not {type(mesh).__name__}")
    return mesh


def mesh_operator(op: Operator, mesh: Optional[RowMesh]) -> Operator:
    """The operator a mesh solve applies, mapping this rank's rows to its
    rows.  An operator built for ``mesh`` (``op.mesh``) is used as it is.
    Any other operator is lifted: its input rows are all-gathered, it is
    applied as on one device, and this rank's rows of the result are kept
    (what GSPMD does with an operator it cannot partition).  ``mesh``
    None: ``op`` itself."""
    if check_mesh(mesh) is None:
        return op
    if op.mesh is not None:
        if op.mesh is not mesh:
            raise ValueError("the operator was built for another mesh")
        return op
    if not same_device(op.device, mesh.device):
        raise ValueError(f"operator lives on {op.device}, the mesh on "
                         f"{mesh.device}")
    lo, hi = mesh.rows(op.n_pad)
    gather = mesh.gather

    def lift(fn):
        if fn is None:
            return None
        return lambda v: fn(gather(v))[lo:hi]

    is_g = op.bmat == "G"

    def apply(v, bv):
        x = gather(v)
        bx = gather(bv) if is_g and bv is not v else x
        w, bw = op.apply(x, bx)
        w_l = w[lo:hi]
        return w_l, (w_l if bw is w else bw[lo:hi])

    block = op.apply_block
    return dataclasses.replace(
        op, apply=apply, b_apply=lift(op.b_apply) if is_g else None,
        a_apply=lift(op.a_apply), m_apply=lift(op.m_apply),
        apply_block=(None if block is None
                     else (lambda V: block(gather(V))[:, lo:hi])),
        mesh=mesh,
        # NCCL beside a conditional node's body is unverified
        capturable=op.capturable and not op.while_loops)


def check_solver(op: Operator, cfg) -> None:
    """The reference's refusals for a mesh solve: the CGS kernels have no
    row-partitioned form (``cgs_kernel='pallas'``), and every rank holds
    the same number of rows."""
    if op.mesh is None:
        return
    if cfg.cgs_kernel == "pallas":
        # the reference: a pallas_call has no GSPMD partitioning rule
        raise ValueError("cgs_kernel='pallas' does not support "
                         "mesh-sharded solves; use the default")
    op.mesh.n_loc(cfg.n_pad)

