"""pdsdrv1 equivalent (PARPACK/EXAMPLES/MPI/pdsdrv1.f): the 4 largest
eigenvalues of the 2-D Laplacian, row-partitioned over a mesh of ranks
with an explicit halo exchange (``models.distributed``); rank 0 prints
the residuals ``||A x - lambda x||``.

Run on N ranks, under torchrun or as spawned processes:

    torchrun --nproc-per-node N -m \\
        arpack_ng_tpu_torch.examples.distributed_laplacian [nx] [ny] [--cpu]
    python -m arpack_ng_tpu_torch.examples.distributed_laplacian \\
        [nx] [ny] [--ranks N] [--cpu]

``--cpu`` runs on the CPU over gloo.  On the card the ranks use NCCL where
each has a card of its own, and gloo where they share one (NCCL does not
run two ranks on one device).  ``main`` called in a process with no
process group runs a world of one.
"""
import argparse
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

import arpack_ng_tpu_torch as pt
from arpack_ng_tpu_torch.models.distributed import laplacian_2d_sharded
from arpack_ng_tpu_torch.parallel import make_mesh


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _backend(device, ranks: int) -> str:
    cards = torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 0
    return "nccl" if cards and ranks <= cards else "gloo"


def _init(rank: int, ranks: int, port: int, device) -> torch.device:
    """Join the process group; returns this rank's device."""
    backend = _backend(device, ranks)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count()
                           if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=ranks)
    return dev


def main(nx=128, ny=64, device="cuda"):
    own = not dist.is_initialized()
    if own:
        device = _init(0, 1, _free_port(), device)
    try:
        mesh = make_mesh(device=device)
        ndev = mesh.size
        ny = ny - (ny % ndev) or ndev
        op, a_sp = laplacian_2d_sharded(nx, ny, mesh, dtype=np.float32)
        vals, vecs = pt.eigsh(op, k=4, which="LA", tol=1e-5, mesh=mesh)
        res = np.linalg.norm(a_sp @ vecs - vecs * vals, axis=0)
        if mesh.rank == 0:
            print(f"mesh: {ndev} ranks ({mesh.transport}); grid {nx}x{ny}")
            for i, (lam, r) in enumerate(zip(vals, res)):
                print(f"  lambda[{i}] = {lam:.6f}   resid = {r:.3e}")
        return vals, res
    finally:
        if own:
            dist.destroy_process_group()


def _rank(rank, ranks, port, nx, ny, device):
    device = _init(rank, ranks, port, device)
    try:
        main(nx, ny, device=device)
    finally:
        dist.destroy_process_group()


def _cli():
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("nx", type=int, nargs="?", default=128)
    p.add_argument("ny", type=int, nargs="?", default=64)
    p.add_argument("--ranks", type=int, default=2,
                   help="processes to spawn outside torchrun (default 2)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU over gloo (default: the CUDA card)")
    args = p.parse_args()
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --cpu to run on the CPU")
    if "RANK" in os.environ:            # under torchrun
        ranks = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        backend = _backend(device, ranks)
        if device == "cuda":
            local = int(os.environ.get("LOCAL_RANK", rank))
            device = torch.device("cuda", local if backend == "nccl" else 0)
            torch.cuda.set_device(device)
        dist.init_process_group(backend)
        try:
            main(args.nx, args.ny, device=device)
        finally:
            dist.destroy_process_group()
        return
    import torch.multiprocessing as mp
    mp.spawn(_rank, args=(args.ranks, _free_port(), args.nx, args.ny,
                          device), nprocs=args.ranks)


if __name__ == "__main__":
    _cli()
