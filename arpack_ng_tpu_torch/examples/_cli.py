"""The examples' shared command line: optional integer sizes and
``--cpu``."""
from __future__ import annotations

import argparse


def run(main, doc: str, sizes=()) -> None:
    """Parse ``[size ...] [--cpu]`` and call ``main(*sizes, device=...)``;
    ``sizes`` names the optional positional integers ``main`` takes."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    for name in sizes:
        p.add_argument(name, type=int, nargs="?", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    args = p.parse_args()
    vals = [getattr(args, name) for name in sizes]
    kw = {name: v for name, v in zip(sizes, vals) if v is not None}
    main(**kw, device="cpu" if args.cpu else "cuda")
