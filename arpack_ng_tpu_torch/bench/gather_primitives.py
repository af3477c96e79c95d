"""The gather-primitive probe on the CUDA card (port of
``benchmarks/bench_gather_primitives.py``): which form of ``x[cols]`` can
carry an irregular sparse product at memory rate.

    python -m arpack_ng_tpu_torch.bench.gather_primitives

The reference's six forms at its shapes (x: n = 2^18 float32 values, 1 MiB,
as (2048, 128); 2^21 gathered elements per pass):

  1. flat element gather        x[cols]
  2. 128-wide row gather        X2d[rows]
  3. lane gather                torch.gather(X2d, 1, lidx)   (lidx < 128)
  4. one-hot sublane gather     onehot(sr) @ panel           (batched GEMM)
  5. one-hot two-stage          onehot(sr) @ panel, then a lane select
  6. the hand kernels           ``take_flat`` (the reference's ``pl_take``)
                                and ``take_lanes`` (``pl_tal``),
                                csrc/gather.cu

Forms 1-5 were left to XLA in the reference and are torch ops here, in
float32 with TF32 off (the reference's one-hot products ran at the TPU's
default reduced precision).  Every form is timed device-only, in
alternation, with the L2 flushed before each launch
(:func:`~arpack_ng_tpu_torch.bench.timing.alternating_ms`), and checked:
forms 4-6 must equal the direct gathers they stand for bit for bit (a
one-hot product adds exact zeros).  Needs a CUDA card; exits non-zero
without one.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from ..ops import cuda_gather
from ..utils.precision import pin_full_precision
from . import timing

N = 1 << 18       # gathered-from values (1 MiB of float32)
NEL = 1 << 21     # gathered elements per pass
W = 128           # row width


def make_inputs(device, seed: int = 0) -> dict:
    """The reference's inputs, drawn from one numpy generator in its
    order."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N,)).astype(np.float32)
    cols = rng.integers(0, N, NEL).astype(np.int32)
    rows = rng.integers(0, N // W, NEL // W).astype(np.int32)
    lidx = rng.integers(0, W, (N // W, W)).astype(np.int32)
    sr = rng.integers(0, W, (NEL // W, W)).astype(np.int32)
    l2 = rng.integers(0, W, (NEL // W, W)).astype(np.int32)
    out = {k: torch.from_numpy(v).to(device) for k, v in dict(
        x=x, cols=cols, rows=rows, lidx=lidx, sr=sr, l2=l2).items()}
    out["X2"] = out["x"].view(N // W, W)
    out["cols2"] = out["cols"].view(NEL // W, W)
    out["panel"] = out["X2"][:W]
    return out


def forms(inp: dict) -> list:
    """``(name, call, elements)`` for each form, on the inputs of
    :func:`make_inputs`."""
    X2, panel, sr, l2 = inp["X2"], inp["panel"], inp["sr"], inp["l2"]
    lanes = torch.arange(W, device=X2.device)

    def onehot_rows():
        oh = (sr[..., None] == lanes).to(torch.float32)   # (G, 128, 128)
        return torch.einsum("gij,jl->gil", oh, panel)

    def onehot_then_lane():
        lsel = (l2[..., None] == lanes).to(torch.float32)
        return torch.sum(onehot_rows() * lsel, dim=-1)

    return [
        ("1 flat x[cols] (2M)", lambda: inp["x"][inp["cols"]], NEL),
        ("2 row gather X2d[rows] (16k rows)", lambda: X2[inp["rows"]], NEL),
        ("3 lane gather torch.gather", lambda: torch.gather(
            X2, 1, inp["lidx"]), N),
        ("4 one-hot sublane (batched GEMM)", onehot_rows, NEL),
        ("5 one-hot 2-stage (full gather)", onehot_then_lane, NEL),
        ("6 kernel take_flat", lambda: cuda_gather.take_flat(
            X2, inp["cols2"], check_range=False), NEL),
        ("6b kernel take_lanes", lambda: cuda_gather.take_lanes(
            X2, inp["lidx"], check_range=False), N),
    ]


def check(inp: dict) -> None:
    """Forms 4-6 against the direct gathers they stand for, bit for bit
    (indices range-checked once here; the timed kernel calls skip it)."""
    X2, panel, sr, l2 = inp["X2"], inp["panel"], inp["sr"], inp["l2"]
    f = {name.split()[0]: fn for name, fn, _ in forms(inp)}
    cuda_gather.take_flat(X2, inp["cols2"])           # range check
    cuda_gather.take_lanes(X2, inp["lidx"])
    pairs = (("6", inp["x"][inp["cols"]].view(NEL // W, W)),
             ("6b", torch.gather(X2, 1, inp["lidx"])),
             ("4", panel[sr]),
             ("5", panel[sr, l2]))
    for key, ref in pairs:
        if not torch.equal(f[key](), ref):
            raise AssertionError(f"gather form {key} differs from the direct "
                                 "gather")


def run(device) -> list:
    """Check, then time every form once in alternation; prints one line
    per form and returns ``(name, ms, ns per element)``."""
    pin_full_precision()
    inp = make_inputs(device)
    check(inp)
    named = forms(inp)
    ms = timing.alternating_ms([fn for _, fn, _ in named],
                               timing.flush_buffer(device))
    rows = []
    for (name, _, elems), t in zip(named, ms):
        rows.append((name, t, t * 1e6 / elems))
        print(f"  {name:36s} {t * 1e3:9.2f} us   {t * 1e6 / elems:7.4f} "
              f"ns/el", flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_primitives: no CUDA device; this probe runs on the "
              "GPU only", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"gather probe: n={N}, {NEL} el/pass, device-only median of "
          f"{timing.REPS}, L2 flushed; card {card}", flush=True)
    run(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
