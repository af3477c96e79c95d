#!/usr/bin/env python3
"""Whether torch's CUDA kernels still round complex products and
quotients as the fused update kernels do, on a card.

    python tools/complex_rounding_probe.py [--n 2048]

The fused update kernels of ``arpack_ng_tpu_torch/csrc/krylov_loop.cu``
reproduce torch's ``alpha * p`` (a 0-d complex times a vector) and ``a /
b`` in complex64 and complex128 bit for bit.  c10::complex writes the
product as ``(a.re c.re - a.im c.im, a.re c.im + a.im c.re)`` and the
quotient as numpy's Smith division; the kernels fuse the first product of
each part of the product, and all three multiply-adds of the quotient, into
fused multiply-adds, as the card's torch build (2.11, CUDA 12.8) was found
to.  This script holds torch's outputs on the card against that rounding
computed exactly on the host (``fractions.Fraction``, rounded to nearest
even at the dtype's precision), on seeded normal operands, and prints per
dtype and operation how many of ``n`` values match.  The last line is a
JSON object; the exit code is 1 where any value differs.
"""
from __future__ import annotations

import argparse
import json
import sys
from fractions import Fraction as F

import numpy as np


def rnd(q: F, p: int) -> F:
    """``q`` rounded to nearest even with a ``p``-bit significand (normal
    range)."""
    if q == 0:
        return q
    neg = q < 0
    q = -q if neg else q
    scale = p - 1 - (q.numerator.bit_length() - q.denominator.bit_length())
    m = q * F(2) ** scale
    while m >= 2 ** p:
        m /= 2
        scale -= 1
    while m < 2 ** (p - 1):
        m *= 2
        scale += 1
    fl = m.numerator // m.denominator
    rem = m - fl
    if rem > F(1, 2) or (rem == F(1, 2) and fl & 1):
        fl += 1
    out = F(fl) / F(2) ** scale
    return -out if neg else out


def mul_parts(a, c, p):
    """``a * c`` with the first product of each part fused."""
    ar, ai, cr, ci = a.real, a.imag, c.real, c.imag
    r = (lambda q: rnd(q, p))
    return r(ar * cr - r(ai * ci)), r(ar * ci + r(ai * cr))


def div_parts(x, y, p):
    """``x / y`` by c10's Smith division, its multiply-adds fused."""
    r = (lambda q: rnd(q, p))
    a, b, c, d = x.real, x.imag, y.real, y.imag
    if abs(c) >= abs(d):
        rat = r(d / c)
        scl = r(1 / r(d * rat + c))
        return r(r(b * rat + a) * scl), r(r(-a * rat + b) * scl)
    rat = r(c / d)
    scl = r(1 / r(c * rat + d))
    return r(r(a * rat + b) * scl), r(r(b * rat - a) * scl)


class Cx:
    """A complex value as a pair of exact Fractions."""

    def __init__(self, z):
        self.real, self.imag = F(float(z.real)), F(float(z.imag))


def probe(torch, dev, dtype, n, seed):
    npd = np.complex64 if dtype == torch.complex64 else np.complex128
    p = 24 if dtype == torch.complex64 else 53
    rng = np.random.default_rng(seed)

    def cvec(m):
        return (rng.standard_normal(m)
                + 1j * rng.standard_normal(m)).astype(npd)

    alpha, vec = cvec(1)[0], cvec(n)
    got = (torch.tensor(alpha, device=dev) * torch.from_numpy(vec).to(dev)
           ).cpu().numpy()
    a = Cx(alpha)
    mul_hits = 0
    for z, g in zip(vec, got):
        mul_hits += mul_parts(a, Cx(z), p) == (F(float(g.real)),
                                               F(float(g.imag)))
    num, den = cvec(n), cvec(n)
    q = (torch.from_numpy(num).to(dev) / torch.from_numpy(den).to(dev)
         ).cpu().numpy()
    div_hits = 0
    for x, y, g in zip(num, den, q):
        div_hits += div_parts(Cx(x), Cx(y), p) == (F(float(g.real)),
                                                   F(float(g.imag)))
    return {"mul": mul_hits, "div": div_hits}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=25)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("complex_rounding_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    out = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "cuda": torch.version.cuda, "n": args.n}
    ok = True
    for dtype in (torch.complex64, torch.complex128):
        res = probe(torch, dev, dtype, args.n, args.seed)
        print(f"{str(dtype)[6:]}: alpha * p matches {res['mul']} of "
              f"{args.n}, a / b matches {res['div']} of {args.n}",
              flush=True)
        ok = ok and res["mul"] == args.n and res["div"] == args.n
        out[str(dtype)[6:]] = res
    out["matches"] = ok
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
