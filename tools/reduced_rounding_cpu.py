#!/usr/bin/env python3
"""How far a float32 eigensolve, or the kernel's own formulas, move the
symmetric reduced space, on the CPU.

    python3 tools/reduced_rounding_cpu.py

The reduced-space kernel (``arpack_ng_tpu_torch/csrc/sym_cycle.cu``)
runs its eigensolve and its QR factorizations in double and rounds their
results to float32, as its numpy twin does (numpy's float32 ``eigh`` and
``qr`` compute in double). ``chip_smoke.py`` (phase 3) and
``tests/test_torch_gpu.py`` hold the kernel to the twin on Lanczos
tridiagonals of the flagship's spectrum (ncv = 32, nev = 8). This script
takes the same inputs, for each ``which``, through the twin and through
a variant whose eigensolve and QR run in float32 (``torch.linalg.eigh``
/ ``qr`` on float32 CPU tensors: LAPACK's single-precision routines),
the fault a float32 kernel would have, and prints each gap the checks
read, in their units (``chip_smoke._sym_gaps``): Ritz values and bounds
over T's scale, the new T over the scale, Q's kept columns, sigmak, and
the residual's new part over the scale, and the smallest and largest of
each over the cases. A limit that a kernel meets and this variant breaks
sits between the two.

It also runs the twin with its ``eigh`` and ``qr`` replaced by a numpy
model, in double, of the kernel's own algorithm (:func:`kernel_model`): the
implicit QL with Wilkinson shifts for the eigenvalues and the last row of
the eigenvectors, and the reflector-by-reflector Householder QR of the
tridiagonal with q formed column by column in dorg2r's order, every Givens
and Householder step with dlapy2 and divisions, as the kernel forms them
(``tests/test_torch_sym_cycle_model.py`` holds the model to the twin and
to the reference package), and counts the QL's dependent divisions and
square roots on phase 3's timed input.
"""
from __future__ import annotations

import contextlib
import json
import math
import sys
from pathlib import Path
from unittest import mock

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

NCV, NEV = 32, 8
QL_ITERS = 30


def _lapy2(x, y):
    xa, ya = abs(x), abs(y)
    w, z = max(xa, ya), min(xa, ya)
    if z == 0.0:
        return w
    t = z / w
    return w * math.sqrt(1.0 + t * t)


def givens(f, g):
    """(r, s, c) with r = dlapy2(f, g), s = f / r, c = g / r (r = 0: s and
    c unused)."""
    r = _lapy2(f, g)
    if r == 0.0:
        return 0.0, 0.0, 0.0
    return r, f / r, g / r


def ql_eig(d, e, counts=None):
    """Implicit QL with Wilkinson shifts on tridiag(d, e) in double, the last
    row z of the eigenvectors beside (ARPACK's dstqrb; the kernel's
    ``tridiag_ql``).  Returns (eigenvalues unsorted, z) or None if an
    eigenvalue took more than QL_ITERS iterations.  ``counts``, a dict, gets
    the iterations and rotations run."""
    n = len(d)
    d = [float(x) for x in d]
    e = [float(x) for x in e] + [0.0]
    e = e[:n]
    e[n - 1] = 0.0
    z = [0.0] * n
    z[n - 1] = 1.0
    eps = np.finfo(np.float64).eps
    for l in range(n):
        it = 0
        while True:
            m = l
            while m < n - 1:
                if abs(e[m]) <= eps * (abs(d[m]) + abs(d[m + 1])):
                    break
                m += 1
            if m == l:
                break
            if it == QL_ITERS:
                return None
            it += 1
            if counts is not None:
                counts["iterations"] = counts.get("iterations", 0) + 1
            g = (d[l + 1] - d[l]) / (2.0 * e[l])
            r = _lapy2(g, 1.0)
            g = d[m] - d[l] + e[l] / (g + math.copysign(r, g))
            s = c = 1.0
            p = 0.0
            i = m - 1
            broke = False
            while i >= l:
                f, bb = s * e[i], c * e[i]
                if counts is not None:
                    counts["rotations"] = counts.get("rotations", 0) + 1
                r, s_new, c_new = givens(f, g)
                e[i + 1] = r
                if r == 0.0:
                    d[i + 1] -= p
                    e[m] = 0.0
                    broke = True
                    break
                s, c = s_new, c_new
                g = d[i + 1] - p
                r = (d[i] - g) * s + 2.0 * c * bb
                p = s * r
                d[i + 1] = g + p
                g = c * r - bb
                zf = z[i + 1]
                z[i + 1] = s * z[i] + c * zf
                z[i] = c * z[i] - s * zf
                i -= 1
            if broke:
                continue
            d[l] -= p
            e[l] = g
            e[m] = 0.0
    return np.array(d), np.array(z)


def reflector(alpha, x):
    """dlarfg's (tau, v1) for the pair (alpha, x), x != 0: beta =
    -sign(alpha) dlapy2(alpha, x), tau = (beta - alpha) / beta, v1 =
    x / (alpha - beta)."""
    beta = -math.copysign(_lapy2(alpha, x), alpha)
    return (beta - alpha) / beta, x * (1.0 / (alpha - beta))


def qr_tridiag(dm, e):
    """q of the Householder QR of the tridiagonal with diagonal dm (T - mu
    I) and off-diagonal e, in double, reflector by reflector (dgeqr2; the
    kernel's ``qr_step``), formed column by column (dorg2r's order)."""
    n = len(dm)
    tau, v1 = np.zeros(n), np.zeros(n)
    r0, r1 = float(dm[0]), float(e[0]) if n > 1 else 0.0
    for k in range(n - 1):
        alpha, x = r0, float(e[k])
        m1 = float(dm[k + 1])
        e1 = float(e[k + 1]) if k + 2 < n else 0.0
        if x != 0.0:
            t, v = reflector(alpha, x)
            tau[k], v1[k] = t, v
            w = r1 + m1 * v
            m1 = m1 + v * (-t * w)
            if k + 2 < n:
                e1 = e1 + v * (-t * (e1 * v))
        r0, r1 = m1, e1
    q = np.zeros((n, n))
    for c in range(n):
        cur, carry = (1.0, 0.0) if c <= n - 2 else (0.0, 1.0)
        for i in range(min(c, n - 2), -1, -1):
            if tau[i] != 0.0:
                t = -tau[i] * (cur + carry * v1[i])
                cur, carry = cur + t, carry + v1[i] * t
            q[i + 1, c], carry, cur = carry, cur, 0.0
        q[0, c] = carry
    return q


@contextlib.contextmanager
def kernel_model():
    """numpy's ``eigh`` and ``qr`` replaced, for the twin
    (``cuda_sym_cycle.head_plain`` / ``shifts_plain``), by the model of the
    kernel's: the QL's eigenvalues in ascending order (a stable sort, as
    the kernel's rank sort) and the last row of its eigenvectors, and the
    reflector QR's q; both in double, rounded to the input's dtype, as the
    kernel rounds them (it raises where the kernel reports info -8)."""
    def eigh(T):
        out = ql_eig(np.diag(T), np.diag(T, 1))
        if out is None:
            raise np.linalg.LinAlgError("QL did not converge")
        w, z = out
        order = np.argsort(w, kind="stable")
        S = np.zeros(T.shape)
        S[-1] = z[order]
        return w[order].astype(T.dtype), S.astype(T.dtype)

    def qr(M):
        q = qr_tridiag(np.diag(M), np.diag(M, -1))
        return q.astype(M.dtype), None

    with mock.patch.object(np.linalg, "eigh", eigh), \
            mock.patch.object(np.linalg, "qr", qr):
        yield


def _f32_eigh(a):
    import torch
    w, v = torch.linalg.eigh(torch.from_numpy(np.asarray(a, np.float32)))
    return w.numpy(), v.numpy()


def _f32_qr(a):
    import torch
    q, r = torch.linalg.qr(torch.from_numpy(np.asarray(a, np.float32)))
    return q.numpy(), r.numpy()


def main() -> int:
    import torch

    import chip_smoke
    from arpack_ng_tpu_torch.ops import cuda_sym_cycle as csc

    def cycle(d, e, p):
        return chip_smoke._sym_run(torch, csc, d, e, torch.float32,
                                   torch.device("cpu"), p)

    f = np.finfo(np.float32)
    lo, hi = {}, {}
    for which in csc.WHICH:
        p = csc.Params(which=which, nev=NEV, tol=1e-5,
                       eps23=float(f.eps ** (2 / 3)), eps_m=float(f.eps))
        for seed in range(4):
            d, e = chip_smoke._lanczos_tridiag(seed=seed)
            d, e = d.astype(np.float32), e.astype(np.float32)
            twin = cycle(d, e, p)
            with mock.patch.object(np.linalg, "eigh", _f32_eigh), \
                    mock.patch.object(np.linalg, "qr", _f32_qr):
                var = cycle(d, e, p)
            g = chip_smoke._sym_gaps(twin, var, d, NCV)
            line = {"which": which, "seed": seed,
                    "float32 eigensolve and QR": g}
            with kernel_model():
                gm = chip_smoke._sym_gaps(twin, cycle(d, e, p), d, NCV)
            line["kernel model"] = gm
            for key, v in gm.items():
                if key != "counts_equal":
                    hi["kernel model " + key] = max(
                        hi.get("kernel model " + key, 0.0), v)
            print(json.dumps(line))
            for key, v in g.items():
                if key != "counts_equal":
                    lo[key] = min(lo.get(key, np.inf), v)
                    hi[key] = max(hi.get(key, 0.0), v)
    print(json.dumps({"smallest over cases": lo, "largest": hi}))
    # the QL's dependent chain on phase 3's timed input (seed 0, float32):
    # a rotation waits on a dlapy2 (a division and a square root) and on
    # s = f / r, c = g / r; an iteration's shift adds a dlapy2 and two
    # divisions
    d, e = chip_smoke._lanczos_tridiag(seed=0)
    counts = {}
    ql_eig(d.astype(np.float32).astype(np.float64),
           e[:-1].astype(np.float32).astype(np.float64), counts)
    r, it = counts["rotations"], counts["iterations"]
    print(json.dumps({"QL on phase 3's timed input": counts,
                      "dependent divisions": 2 * r + 3 * it,
                      "dependent square roots": r + it}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
