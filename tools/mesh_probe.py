#!/usr/bin/env python3
"""Probe of the distribution layer's transports on one card.

    python3 tools/mesh_probe.py

Prints the torch, CUDA and NCCL versions, then:

1. a world of one under NCCL: ``RowMesh.sum`` and ``RowMesh.gather``
   eagerly, then captured in a CUDA graph on a side stream and replayed
   (the device loop's pattern), each result checked;
2. two ranks on the one card under gloo (spawned processes): sum, max,
   gather and the halo exchange on CUDA tensors, each checked, and the
   host microseconds per call;
3. a small selective solve (the 2-D Laplacian at nx = 128, float32) with
   ``mesh=`` on the world of one, beside the same solve without it: the
   counters must be equal.

Exits non-zero at the first check that fails.
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def world_of_one(torch, dist):
    from arpack_ng_tpu_torch.parallel import make_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_port()}",
                            rank=0, world_size=1)
    mesh = make_mesh(device=dev)
    print(f"mesh {mesh}: capturable {mesh.capturable}", flush=True)
    x = torch.arange(8, dtype=torch.float32, device=dev)
    assert torch.equal(mesh.sum(x.clone()), x)
    assert torch.equal(mesh.gather(x), x)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        buf = x.clone()
        g = torch.cuda.CUDAGraph()
        g.capture_begin()
        y = mesh.sum(buf * 2)
        z = mesh.gather(buf + 1)
        g.capture_end()
        for k in range(3):
            buf.copy_(x + k)
            g.replay()
            torch.cuda.current_stream().synchronize()
            assert torch.equal(y, 2 * (x + k)), (y, x + k)
            assert torch.equal(z, x + k + 1)
    torch.cuda.current_stream().wait_stream(s)
    print("nccl world of one: sum and gather captured and replayed: ok",
          flush=True)
    return mesh


def small_solve(torch, mesh):
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models import laplacian_2d
    from arpack_ng_tpu_torch.models.distributed import laplacian_2d_sharded
    dev = mesh.device
    kw = dict(k=8, ncv=32, which="LA", tol=1e-5, return_stats=True)
    op, _ = laplacian_2d(128, np.float32, device=dev)
    ops, _ = laplacian_2d_sharded(128, 128, mesh, np.float32)
    _, _, o1 = pt.eigsh(op, **kw)
    for tag, o in (("gather route", op), ("halo", ops)):
        t0 = time.perf_counter()
        _, _, o2 = pt.eigsh(o, mesh=mesh, **kw)
        torch.cuda.synchronize()
        st1, st2 = o1.stats, o2.stats
        print(f"small solve, {tag}: cycles {st2.n_iter} nopx {st2.nopx} "
              f"nrorth {st2.nrorth} (without mesh {st1.n_iter} {st1.nopx} "
              f"{st1.nrorth}); graphs {st2.graphs_captured}, replays "
              f"{st2.graph_replays}; collectives {st2.collectives}; "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        assert (st1.n_iter, st1.nopx, st1.nrorth) == (st2.n_iter, st2.nopx,
                                                      st2.nrorth)


def gloo_rank(rank, port):
    import torch
    import torch.distributed as dist
    from arpack_ng_tpu_torch.parallel import make_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    mesh = make_mesh(device=dev)
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
    assert torch.equal(mesh.sum(x.clone()),
                       2 * torch.arange(4, device=dev).float() + 10)
    assert torch.equal(mesh.max(x.clone()),
                       torch.arange(4, device=dev).float() + 10)
    g = mesh.gather(x)
    assert torch.equal(g, torch.cat([x - 10 * rank, x - 10 * rank + 10]))
    a, b = mesh.exchange(x, x + 1)
    if rank == 0:
        assert not a.any() and torch.equal(b, torch.arange(4, device=dev)
                                           .float() + 10)
    else:
        assert torch.equal(a, torch.arange(4, device=dev).float() + 1) \
            and not b.any()
    reps = 200
    for name, fn in (("sum", lambda: mesh.sum(x.clone())),
                     ("gather", lambda: mesh.gather(x)),
                     ("exchange", lambda: mesh.exchange(x, x))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / reps * 1e6
        if rank == 0:
            print(f"gloo+host, 2 ranks on one card: {name} {us:.1f} us/call",
                  flush=True)
    dist.destroy_process_group()


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--gloo-rank":
        gloo_rank(int(sys.argv[2]), sys.argv[3])
        return 0
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{torch.cuda.nccl.version()}, {torch.cuda.get_device_name(0)}",
          flush=True)
    mesh = world_of_one(torch, dist)
    port = str(_port())
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--gloo-rank", str(r), port])
             for r in range(2)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(rcs):
        print(f"gloo ranks failed: {rcs}", file=sys.stderr)
        return 1
    print("gloo+host 2 ranks: sum, max, gather, exchange: ok", flush=True)
    small_solve(torch, mesh)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
