"""Rank program of the port's gloo worlds: the ``mpiexec -n N`` analog for
``arpack_ng_tpu_torch``'s row-partitioned solves (``mesh=``).

:func:`run_world` starts N OS processes of this file on the CPU; each
joins one gloo process group on localhost, makes the world's
``RowMesh`` and runs the named cases in order (the functions ``case_*``
below), each on the inputs the caller handed over, and pickles its
result to ``<out>/<case>.<rank>.pkl`` (or the traceback, where the case
raised).  The ranks import torch and the port only.  A test file spins
its world up once (a module fixture) and compares the ranks' results with
the JAX package's mesh solves in the pytest process.
"""
import os
import pickle
import socket
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
#: seconds a gloo collective may wait before it raises (a rank that took
#: another branch then fails its case instead of hanging the world)
COLLECTIVE_TIMEOUT_S = 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_world(nranks, cases, out, inputs=None, timeout=420):
    """Run ``cases`` (names of ``case_*`` functions) on a gloo world of
    ``nranks`` processes; ``inputs`` maps a case name to its input object.
    Returns ``{case: [result of rank 0, rank 1, ...]}``; a result is a
    dict, or ``{"error": traceback}``."""
    out = str(out)
    with open(os.path.join(out, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs or {}, f)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(nranks),
         str(port), out] + list(cases),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=os.path.dirname(HERE)) for r in range(nranks)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            left = max(1.0, deadline - time.monotonic())
            o, e = p.communicate(timeout=left)
            logs.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, rc, e) for r, (rc, _, e) in enumerate(logs) if rc != 0]
    if bad:
        raise RuntimeError("world ranks failed: " + "\n".join(
            f"rank {r} rc {rc}:\n{e[-3000:]}" for r, rc, e in bad))
    res = {}
    for c in cases:
        res[c] = []
        for r in range(nranks):
            with open(os.path.join(out, f"{c}.{r}.pkl"), "rb") as f:
                res[c].append(pickle.load(f))
    return res


# ---- the cases ------------------------------------------------------------
# Each ``case_<name>(mesh, inp)`` runs SPMD on every rank and returns a
# dict of numpy values and integers.


def _solve_out(vals, vecs, out):
    st = out.stats
    return dict(vals=vals, vecs=vecs, nopx=st.nopx, n_iter=out.n_iter,
                nrorth=st.nrorth, collectives=dict(st.collectives))


def case_diagonal(mesh, inp):
    import numpy as np
    import arpack_ng_tpu_torch as pt
    n = 1000
    d = np.arange(1, n + 1, dtype=np.float64)
    op = pt.from_diagonal(d, n_pad=pt.pad_dim(n), device="cpu")
    vals, vecs, out = pt.eigsh(op, k=4, which="LM", tol=1e-10, maxiter=500,
                               v0=inp, mesh=mesh, return_stats=True)
    return _solve_out(vals, vecs, out)


def case_matches_single(mesh, inp):
    import numpy as np
    import arpack_ng_tpu_torch as pt
    d, v0 = inp
    op = pt.from_diagonal(d, n_pad=pt.pad_dim(len(d)), device="cpu")
    kw = dict(k=5, which="LA", tol=1e-10, maxiter=800, v0=v0,
              return_stats=True)
    vals, out = pt.eigsh(op, return_eigenvectors=False, mesh=mesh, **kw)
    single, _ = pt.eigsh(op, return_eigenvectors=False, **kw)
    r = _solve_out(vals, None, out)
    r["single"] = np.asarray(single)
    return r


def case_stencil(mesh, inp):
    import numpy as np
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models import laplacian_2d
    op, _ = laplacian_2d(16, np.float64, device="cpu")
    vals, vecs, out = pt.eigsh(op, k=4, which="LA", ncv=20, tol=1e-9,
                               maxiter=500, v0=inp, mesh=mesh,
                               return_stats=True)
    return _solve_out(vals, vecs, out)


def _convdiff(rho=50.0):
    import numpy as np
    from arpack_ng_tpu_torch.models import convection_diffusion_2d
    op, _ = convection_diffusion_2d(12, rho=rho, dtype=np.float64,
                                    device="cpu")
    return op


def case_nonsym(mesh, inp):
    import arpack_ng_tpu_torch as pt
    vals, vecs, out = pt.eigs(_convdiff(), k=4, which="LM", ncv=20,
                              tol=1e-9, maxiter=800, v0=inp, mesh=mesh,
                              return_stats=True)
    return _solve_out(vals, vecs, out)


def case_fused_real(mesh, inp):
    import arpack_ng_tpu_torch as pt
    kw = dict(k=4, which="LM", ncv=20, tol=1e-9, maxiter=800,
              strategy="fused_real", v0=inp, return_stats=True)
    vals, vecs, out = pt.eigs(_convdiff(), mesh=mesh, **kw)
    single, _, _ = pt.eigs(_convdiff(), **kw)
    r = _solve_out(vals, vecs, out)
    r["single"] = single
    return r


def case_cd10(mesh, inp):
    """The three eigs drivers on the convection-diffusion operator at
    rho = 10 (well-conditioned values)."""
    import arpack_ng_tpu_torch as pt
    return {s: _solve_out(*pt.eigs(_convdiff(rho=10.0), k=4, which="LM",
                                   ncv=20, tol=1e-9, maxiter=800,
                                   strategy=s, v0=inp, mesh=mesh,
                                   return_stats=True))
            for s in ("fused_real", "hybrid", "fused")}


def case_layout(mesh, inp):
    import numpy as np
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.config import IRAMConfig
    from arpack_ng_tpu_torch.core.iram import IRAMSolver
    n = 1024
    op = pt.from_diagonal(np.linspace(1, 2, n), n_pad=1024, device="cpu")
    cfg = IRAMConfig(n=n, nev=3, ncv=10, which="LA", symmetric=True,
                     dtype=np.float64, n_pad=1024)
    st = IRAMSolver(op, cfg, mesh=mesh).init_state()
    return dict(V=tuple(st.V.shape), resid=tuple(st.resid.shape),
                b_resid=tuple(st.b_resid.shape), H=st.H.shape,
                layout=mesh.layout(), rows=mesh.rows(1024),
                n_loc=mesh.n_loc(1024), transport=mesh.transport,
                capturable=mesh.capturable)


def case_halo_matvec(mesh, inp):
    import numpy as np
    from arpack_ng_tpu_torch.models.distributed import laplacian_2d_sharded
    op, a = laplacian_2d_sharded(128, 32, mesh, np.float64)
    c0 = mesh.snapshot()
    y = op.matvec(inp)
    c = mesh.snapshot()
    c.subtract(c0)
    return dict(y=y, ref=a @ inp, collectives=dict(c))


def case_halo_solve(mesh, inp):
    import numpy as np
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models.distributed import laplacian_2d_sharded
    op, _ = laplacian_2d_sharded(128, 32, mesh, np.float64)
    vals, vecs, out = pt.eigsh(op, k=3, which="LA", tol=1e-9, maxiter=400,
                               v0=inp, mesh=mesh, return_stats=True)
    return _solve_out(vals, vecs, out)


def case_comm_model(mesh, inp):
    """The collectives of one extension to ncv from a fresh start, by
    kind, with the elements each all-gather moved: the dgks and selective
    steps on the gathered stencil, the selective step on the halo
    stencil."""
    import numpy as np
    from arpack_ng_tpu_torch.config import IRAMConfig
    from arpack_ng_tpu_torch.core.arnoldi import make_extend, make_init
    from arpack_ng_tpu_torch.models import laplacian_2d
    from arpack_ng_tpu_torch.models.distributed import laplacian_2d_sharded
    from arpack_ng_tpu_torch.parallel import mesh_operator
    out = {}
    op_g, _ = laplacian_2d(32, np.float64, device="cpu")
    op_h, _ = laplacian_2d_sharded(32, 32, mesh, np.float64)
    for tag, op, reorth in (("dgks", op_g, "dgks"),
                            ("selective", op_g, "selective"),
                            ("halo", op_h, "selective")):
        op = mesh_operator(op, mesh)
        cfg = IRAMConfig(n=op.n, nev=4, ncv=16, which="LA", symmetric=True,
                         dtype=np.dtype(np.float64), n_pad=op.n_pad,
                         tol=1e-8, max_iter=50, reorth=reorth)
        st = make_init(op, cfg)(None, inp)
        c0, e0 = mesh.snapshot(), dict(mesh.elements)
        st = make_extend(op, cfg)(st, cfg.ncv)
        c = mesh.snapshot()
        c.subtract(c0)
        out[tag] = dict(counts=dict(c), steps=cfg.ncv, nopx=st.counts.nopx,
                        gathered=mesh.elements["all_gather"]
                        - e0["all_gather"], n_loc=mesh.n_loc(op.n_pad))
    return out


def case_dgks_loop(mesh, inp):
    """The symmetric dgks solve on the device loop (``FusedSymSolver``),
    row-partitioned and then unsharded on each rank from the same start
    vector: values, counters, packets and the mesh's collectives."""
    import numpy as np
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.config import IRAMConfig
    from arpack_ng_tpu_torch.core.device_sym import FusedSymSolver
    d, v0 = inp
    op = pt.from_diagonal(d, n_pad=pt.pad_dim(len(d)), device="cpu")
    cfg = IRAMConfig(n=op.n, nev=4, ncv=16, which="LA", symmetric=True,
                     dtype=np.dtype(np.float64), n_pad=op.n_pad, tol=1e-10,
                     max_iter=500, reorth="dgks")
    out = {}
    for tag, m in (("mesh", mesh), ("single", None)):
        solver = FusedSymSolver(op, cfg, mesh=m)
        res = solver.solve(v0=v0)
        st = res.stats
        out[tag] = dict(
            host_loop=solver._host_loop, ritz=res.ritz, nconv=res.nconv,
            n_iter=res.n_iter, packets=st.packets,
            counts=tuple(int(getattr(st, f)) for f in (
                "nopx", "nbx", "nrorth", "nitref", "nrstrt", "nrotr")),
            collectives=dict(st.collectives or {}))
    return out


def case_realnonsym_loop(mesh, inp):
    """The real non-symmetric solve on the device loop
    (``FusedRealNonsymSolver``), row-partitioned and then unsharded on each
    rank from the same start vector: values, counters, packets and the
    mesh's collectives."""
    import numpy as np
    from arpack_ng_tpu_torch.config import IRAMConfig
    from arpack_ng_tpu_torch.core.device_realnonsym import (
        FusedRealNonsymSolver)
    op = _convdiff()
    cfg = IRAMConfig(n=op.n, nev=4, ncv=16, which="LM", symmetric=False,
                     dtype=np.dtype(np.float64), n_pad=op.n_pad, tol=1e-10,
                     max_iter=500)
    out = {}
    for tag, m in (("mesh", mesh), ("single", None)):
        solver = FusedRealNonsymSolver(op, cfg, mesh=m)
        res = solver.solve(v0=inp)
        st = res.stats
        out[tag] = dict(
            host_loop=solver._host_loop, ritz=res.ritz, nconv=res.nconv,
            n_iter=res.n_iter, packets=st.packets,
            counts=tuple(int(getattr(st, f)) for f in (
                "nopx", "nbx", "nrorth", "nitref", "nrstrt", "nrotr")),
            collectives=dict(st.collectives or {}))
    return out


def case_refusals(mesh, inp):
    """The reference's refusals under a mesh, each raised on every rank
    before any collective: the message of each ValueError."""
    import numpy as np
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core.block import eigsh_block
    from arpack_ng_tpu_torch.models import laplacian_2d
    from arpack_ng_tpu_torch.models.distributed import laplacian_2d_sharded
    odd = 4 * mesh.size + 1
    lap, _ = laplacian_2d(16, np.float32, device="cpu")
    cases = {
        "cgs_kernel": lambda: pt.eigsh(lap, k=2, reorth="dgks",
                                       cgs_kernel="pallas", mesh=mesh),
        "n_pad": lambda: pt.eigsh(pt.from_diagonal(
            np.arange(1.0, odd + 1), device="cpu"), k=2, mesh=mesh),
        "ny": lambda: laplacian_2d_sharded(8, odd, mesh),
        "block": lambda: eigsh_block(pt.from_diagonal(
            np.arange(1.0, 128 * odd + 1), n_pad=128 * odd, device="cpu"),
            k=2, mesh=mesh)}
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def case_world(mesh, inp):
    import numpy as np
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models import laplacian_2d
    op, _ = laplacian_2d(16, np.float64, device="cpu")
    vals = pt.eigsh(op, k=4, which="LA", ncv=20, tol=1e-10, mesh=mesh,
                    return_eigenvectors=False)
    return dict(vals=np.sort(vals))


def case_submesh(mesh, inp):
    """issue46 (PARPACK/TESTS/MPI/issue46.f:18-30): rank 0 solves on a
    sub-mesh of its own (every rank takes part in making the group), the
    other ranks idle; then the world solve."""
    import numpy as np
    import torch.distributed as dist
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models import laplacian_2d
    from arpack_ng_tpu_torch.parallel import make_mesh
    group = dist.new_group([0])
    out = {}
    if mesh.rank == 0:
        sub = make_mesh(group, device="cpu")
        op, _ = laplacian_2d(16, np.float64, device="cpu")
        vals = pt.eigsh(op, k=4, which="LA", ncv=20, tol=1e-10, mesh=sub,
                        return_eigenvectors=False)
        out["sub"] = np.sort(vals)
        out["sub_size"] = sub.size
    dist.barrier()
    out.update(case_world(mesh, inp))
    return out


def case_fused_nonsym(mesh, inp):
    import arpack_ng_tpu_torch as pt
    vals, vecs, out = pt.eigs(_convdiff(rho=40.0), k=3, which="LM", ncv=16,
                              tol=1e-9, strategy="fused", maxiter=400,
                              v0=inp, mesh=mesh, return_stats=True)
    return _solve_out(vals, vecs, out)


def case_svd(mesh, inp):
    import arpack_ng_tpu_torch as pt
    u, s, vh = pt.svds(inp, k=3, tol=1e-10, mesh=mesh)
    s0 = pt.svds(inp, k=3, tol=1e-10, return_singular_vectors=False,
                 device="cpu")
    s_aug = pt.svds(inp, k=3, tol=1e-10, method="augmented",
                    return_singular_vectors=False, mesh=mesh)
    return dict(u=u, s=s, vh=vh, s0=s0, s_aug=s_aug)


def case_psell(mesh, inp):
    import numpy as np
    import arpack_ng_tpu_torch as pt
    a, v0 = inp
    op = pt.from_scipy(a, hermitian=True, format="psell", device="cpu")
    vals, vecs, out = pt.eigsh(op, k=3, which="LA", ncv=14, tol=1e-8,
                               maxiter=2000, v0=v0, mesh=mesh,
                               return_stats=True)
    r = _solve_out(vals, vecs, out)
    r["format"] = op.format
    r["single"] = np.sort(pt.eigsh(op, k=3, which="LA", ncv=14, tol=1e-8,
                                   maxiter=2000, v0=v0,
                                   return_eigenvectors=False))
    return r


def case_realify(mesh, inp):
    from arpack_ng_tpu_torch.ops.realify import eigs_realified
    kw = dict(k=3, which="LM", tol=1e-10, maxiter=1000)
    vals, vecs = eigs_realified(inp, mesh=mesh, **kw)
    single, _ = eigs_realified(inp, device="cpu", **kw)
    return dict(vals=vals, vecs=vecs, single=single)


def case_block(mesh, inp):
    import numpy as np
    from arpack_ng_tpu_torch.core.block import eigsh_block
    a, X0, b = inp
    kw = dict(k=6, block_size=b, ncv=32, tol=1e-10, maxiter=400,
              dtype=np.float64, X0=X0)
    vals, vecs, info = eigsh_block(a, mesh=mesh, **kw)
    single, _, info1 = eigsh_block(a, device="cpu", **kw)
    return dict(vals=vals, vecs=vecs, info=info, single=single, info1=info1)


def _ckpt_problem(d, max_iter):
    import arpack_ng_tpu_torch as pt
    n = len(d)
    op = pt.from_diagonal(d, n_pad=pt.pad_dim(n), device="cpu")
    cfg = pt.IRAMConfig(n=n, nev=4, ncv=12, which="LA", symmetric=True,
                        dtype=d.dtype, n_pad=op.n_pad, tol=1e-12,
                        max_iter=max_iter)
    return op, cfg


def _iram_out(res):
    st = res.stats
    return dict(ritz=res.ritz, n_iter=res.n_iter, nconv=res.nconv,
                info=res.info, counts=tuple(int(getattr(st, f)) for f in (
                    "nopx", "nbx", "nrorth", "nitref", "nrstrt")))


def case_checkpoint(mesh, inp):
    """A mesh solve stopped by max_iter dumps its state (every rank calls
    ``save_state``, rank 0 writes the whole rows), then resumes from the
    file on the mesh with the full max_iter."""
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.io import checkpoint as ck
    d, v0, cut, full, path = inp
    op, cfg_cut = _ckpt_problem(d, cut)
    res = pt.IRAMSolver(op, cfg_cut, mesh=mesh).solve(v0=v0)
    out = dict(cut=_iram_out(res), rows=tuple(res.state.V.shape))
    ck.save_state(path, res.state, cfg_cut, mesh=mesh)
    op, cfg = _ckpt_problem(d, full)
    st, _ = ck.load_state(path, cfg=cfg, device="cpu", mesh=mesh)
    out["loaded_rows"] = tuple(st.V.shape)
    out["resumed"] = _iram_out(pt.IRAMSolver(op, cfg, mesh=mesh).solve(
        state=st))
    return out


def case_bridge_mesh(mesh, inp):
    """The C ABI's distributed entry points through the port's bridge:
    ``n_devices`` 0 (the world), 1 (sequential), 2 (a sub-mesh of ranks 0
    and 1; every rank makes the group), 3 and 4 (more than the world)."""
    import json
    from arpack_ng_tpu_torch import native_bridge as nb
    a, start = inp
    os.environ[nb.DEVICE_ENV] = "cpu"
    out = {"device_count": nb.device_count()}
    n = a.shape[0]
    for nd in (0, 1, 2, 3, 4):
        opt = dict(dtype="d", symmetric=True, n=n, k=4, which="LM",
                   tol=1e-10, restart=start, n_devices=nd)
        out[f"nd{nd}"] = nb.solve(json.dumps(opt),
                                  buf_a=memoryview(a.tobytes()))
    return out


def case_example(mesh, inp):
    import io
    from contextlib import redirect_stdout
    from arpack_ng_tpu_torch.examples import distributed_laplacian
    buf = io.StringIO()
    with redirect_stdout(buf):
        vals, res = distributed_laplacian.main(*inp, device="cpu")
    return dict(vals=vals, res=res, out=buf.getvalue())


def main():
    rank, size, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
    cases = sys.argv[5:]
    sys.path.insert(0, os.path.dirname(HERE))
    import datetime

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=size,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    from arpack_ng_tpu_torch.parallel import make_mesh
    with open(os.path.join(out, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    mesh = make_mesh(device="cpu")
    for c in cases:
        try:
            res = globals()[f"case_{c}"](mesh, inputs.get(c))
        except Exception:
            res = {"error": traceback.format_exc()}
        with open(os.path.join(out, f"{c}.{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
