"""arpackmm-equivalent command line (port of ``arpack_ng_tpu/cli.py``).

Flag vocabulary follows EXAMPLES/MATRIX_MARKET/arpackmm.cpp:104-292
(--A/--B .mtx inputs, --nonSymPb/--cpxPb/--genPb problem kinds, --nbEV/
--nbCV, --mag LM|SM|LA|SA|LR|SR|LI|SI, --shiftReal/--shiftImag, --invert,
--tol/--maxIt, --schur, --slv, --restart/--dump, --dense, --simplePrec,
--verbose/--debug), with the reference package's flags, defaults, output
lines, ``--json`` keys and exit codes (0: every wanted value converged with
its residual checked; 1: fewer converged or a residual too large; 2: an
error).

The solve runs on the CUDA card; ``--cpu`` runs it on the CPU.  Without a
card and without ``--cpu`` the command exits 2 and names the device: it
never falls back to the CPU.  The dtype follows ``--simplePrec`` and
``--cpxPb`` alone.  ``--dump`` writes the state as the reference's CLI
does, so ``--restart`` after a run stopped at ``--maxIt`` continues the
unbroken solve cycle for cycle, in either package.

Usage:
    python -m arpack_ng_tpu_torch.cli --A A.mtx --nbEV 4 --mag LM
    python -m arpack_ng_tpu_torch.cli --A K.mtx --B M.mtx --genPb \\
        --shiftReal 1.0 --invert
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

_DIRECT = ("LU", "QR", "LLT", "LDLT")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="arpack_ng_tpu_torch.cli",
        description="CUDA eigensolver CLI (arpackmm equivalent)")
    p.add_argument("--A", required=True, help="MatrixMarket file for A")
    p.add_argument("--B", default=None, help="MatrixMarket file for B/M")
    p.add_argument("--nonSymPb", action="store_true",
                   help="treat the problem as non-symmetric")
    p.add_argument("--cpxPb", action="store_true",
                   help="complex arithmetic problem")
    p.add_argument("--genPb", action="store_true",
                   help="generalized problem A x = lambda B x")
    p.add_argument("--nbEV", type=int, default=1, help="eigenvalues wanted")
    p.add_argument("--nbCV", type=int, default=None,
                   help="Krylov subspace size (ncv)")
    p.add_argument("--mag", default="LM",
                   help="which: LM|SM|LA|SA|BE|LR|SR|LI|SI")
    p.add_argument("--shiftReal", type=float, default=None)
    p.add_argument("--shiftImag", type=float, default=None)
    p.add_argument("--invert", action="store_true",
                   help="shift-invert mode (with --shiftReal/Imag)")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--maxIt", type=int, default=500)
    p.add_argument("--schur", action="store_true",
                   help="compute Schur basis instead of Ritz vectors")
    p.add_argument("--noEV", action="store_true",
                   help="eigenvalues only (skip vectors)")
    p.add_argument("--slv", default="LU",
                   help="mode solver (arpackmm.cpp:445-463): direct "
                        "LU | QR | LLT (SPD) | LDLT (sym indefinite), or "
                        "iterative CG (sym) | BiCG")
    p.add_argument("--slvTol", "--slvItrTol", dest="slvTol", type=float,
                   default=1e-10, help="iterative mode-solver tolerance")
    p.add_argument("--slvMaxIt", "--slvItrMaxIt", dest="slvMaxIt",
                   type=int, default=2000)
    p.add_argument("--slvItrPC", default="Diag",
                   help="iterative mode-solver preconditioner: Diag | "
                        "ILU[#dropTol#fillFactor] | None (arpackmm "
                        "--slvItrPC, ILU#D#F form incl. drop tolerance "
                        "and fill factor)")
    p.add_argument("--slvDrtPivot", type=float, default=1e-6,
                   help="direct mode-solver pivot/rank threshold "
                        "(LU sparse diag pivot thresh / QR rank test; "
                        "arpackmm --slvDrtPivot)")
    p.add_argument("--slvDrtOffset", type=float, default=0.0,
                   help="Cholesky-family offset: factor scale*S+offset*I "
                        "(arpackmm --slvDrtOffset)")
    p.add_argument("--slvDrtScale", type=float, default=1.0,
                   help="Cholesky-family scale (arpackmm --slvDrtScale)")
    p.add_argument("--dense", action="store_true",
                   help="use dense operator storage")
    p.add_argument("--simplePrec", action="store_true",
                   help="single precision (float32/complex64)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--restart", default=None,
                   help="checkpoint file to resume from")
    p.add_argument("--dump", default=None,
                   help="write final solver state to this checkpoint file")
    p.add_argument("--verbose", type=int, default=0)
    p.add_argument("--debug", type=int, default=0,
                   help="trace level (debug_c equivalent)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    return p


def _device(args):
    """``(device, None)``, or ``(None, message)`` when the card is asked
    for and this process has none."""
    import torch

    if args.cpu:
        return torch.device("cpu"), None
    if not torch.cuda.is_available():
        return None, ("device cuda requested, but CUDA is not available; "
                      "pass --cpu to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device()), None


def _mode_operator(args, a_sp, b_sp, sigma, sym, dtype, dev):
    """The mode > 1 operator (arpackmm "--slv S: solver (needed if arpack
    mode > 1)").  A, M and the shifted system share one unpermuted device
    format, so every product acts in the same coordinates."""
    import torch

    from .config import pad_dim
    from .ops import solvers as slv_mod
    from .ops import sparse as sparse_mod
    from .ops import transforms
    from .ops.operator import Operator

    slv = args.slv
    iterative = slv in ("CG", "BiCG")
    # ILU#D#F form: drop tolerance + fill factor (arpackmm.cpp:476-480)
    pc_parts = args.slvItrPC.split("#")
    pc_name = pc_parts[0].lower()
    ilu_drop = float(pc_parts[1]) if len(pc_parts) > 1 else 0.0
    ilu_fill = float(pc_parts[2]) if len(pc_parts) > 2 else 1.0
    n = a_sp.shape[0]
    n_pad = pad_dim(n)

    def _mv(mat):
        fmt = ("dia" if sparse_mod.structural_diagonals(mat)
               <= sparse_mod.DIA_MAX_DIAGONALS else "ell")
        return sparse_mod.from_scipy(mat, hermitian=False, format=fmt,
                                     n_pad=n_pad, device=dev).a_apply

    a_mv = _mv(a_sp)
    m_mv = _mv(b_sp) if b_sp is not None else None

    def _precond_for(mat):
        if pc_name == "ilu":
            return slv_mod.ilu0_preconditioner(
                mat, dtype=dtype, n_pad=n_pad, symmetric=(slv == "CG"),
                drop_tol=ilu_drop, fill_factor=ilu_fill, device=dev)
        if pc_name == "diag":
            d = np.ones(n_pad, dtype)
            d[:n] = np.asarray(mat.diagonal()).astype(dtype)
            return slv_mod.jacobi_preconditioner(
                torch.from_numpy(d).to(dev))
        return None

    def _direct_solve(mat):
        """The explicit-inverse direct mode solver (LU|QR|LLT|LDLT): one
        host factorization, one device GEMV per application."""
        inv = slv_mod.make_direct_inverse(
            mat, slv, pivot=args.slvDrtPivot, offset=args.slvDrtOffset,
            scale=args.slvDrtScale, n_pad=n_pad).astype(dtype)
        inv_dev = torch.from_numpy(np.ascontiguousarray(inv)).to(dev)
        return lambda v: inv_dev @ v

    cplx_dtype = np.issubdtype(np.dtype(dtype), np.complexfloating)
    cplx_shift_real_pb = (sigma is not None and np.asarray(sigma).imag != 0
                          and not cplx_dtype)
    if iterative and cplx_shift_real_pb:
        raise SystemExit(
            "complex shift on a real problem with an iterative mode "
            "solver is not supported; use a direct --slv (realified "
            "solve) or --cpxPb")
    if cplx_shift_real_pb:
        # the realified direct solve (dndrv5/6 class): the transform
        # builder solves the complexified system and takes its real part
        build = transforms.build_sym_operator if sym \
            else transforms.build_nonsym_operator
        return build(a_sp, M=b_sp, sigma=sigma, dtype=dtype, device=dev)
    if sigma is not None:
        import scipy.sparse as sp

        sig = np.dtype(dtype).type(sigma if cplx_dtype else sigma.real)
        shifted_mat = (a_sp - sig * b_sp) if b_sp is not None \
            else (a_sp - sig * sp.eye(n, dtype=dtype, format="csr"))
        if iterative:
            shifted = (lambda v: a_mv(v) - sig * m_mv(v)) \
                if b_sp is not None else (lambda v: a_mv(v) - sig * v)
            solve = slv_mod.make_iterative_solve(
                shifted, symmetric=(slv == "CG"), tol=args.slvTol,
                maxiter=args.slvMaxIt, precond=_precond_for(shifted_mat))
        else:
            solve = _direct_solve(shifted_mat)
        # the products and preconditioners here all capture: an iterative
        # solve runs as one CUDA-graph while loop in the restart's graphs
        return transforms.shift_invert_operator(
            n, dtype, solve, sigma=sigma, mode=3, n_pad=n_pad,
            hermitian=sym, a_apply=a_mv, m_apply=m_mv, device=dev,
            capturable=iterative)
    # mode 2: OP = inv(M) A (M SPD: CG / LLT are natural here)
    if iterative:
        solve_m = slv_mod.make_iterative_solve(
            m_mv, symmetric=(slv == "CG"), tol=args.slvTol,
            maxiter=args.slvMaxIt, precond=_precond_for(b_sp))
        if dev.type == "cuda":
            solve_m.bind(dev)
    else:
        solve_m = _direct_solve(b_sp)

    def apply(v, bv, _a=a_mv, _s=solve_m):
        av = _a(v)
        return _s(av), av        # bw = A v (mode-2 shortcut)

    return Operator(n=n, dtype=np.dtype(dtype), apply=apply, bmat="G",
                    mode=2, b_apply=m_mv, a_apply=a_mv, m_apply=m_mv,
                    n_pad=n_pad, hermitian=sym, device=dev,
                    capturable=iterative, while_loops=iterative)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev, err = _device(args)
    if dev is None:
        print(f"ERROR: {err}", file=sys.stderr)
        return 2

    from .config import IRAMConfig, default_ncv
    from .core.extract import extract
    from .core.iram import IRAMSolver
    from .io import checkpoint as ckpt
    from .io import matrix_market as mm
    from .ops.operator import from_dense
    from .ops.sparse import from_scipy
    from .utils.debug import debug

    if args.debug:
        debug.set_all(args.debug)

    t0 = time.perf_counter()
    if args.simplePrec:
        dtype = np.complex64 if args.cpxPb else np.float32
    else:
        dtype = np.complex128 if args.cpxPb else np.float64

    a_sp = mm.read_matrix(args.A).astype(dtype)
    b_sp = mm.read_matrix(args.B).astype(dtype) if args.B else None
    sym = not (args.nonSymPb or args.cpxPb)

    sigma = None
    if args.shiftReal is not None or args.shiftImag is not None:
        sigma = complex(args.shiftReal or 0.0, args.shiftImag or 0.0)
        if sym:
            sigma = sigma.real
    if args.invert and sigma is None:
        sigma = 0.0

    if args.slv not in ("CG", "BiCG") and args.slv.upper() not in _DIRECT:
        raise SystemExit(f"unknown --slv {args.slv!r}: expected "
                         f"{' | '.join(_DIRECT + ('CG', 'BiCG'))}")
    if sigma is not None or b_sp is not None:
        op = _mode_operator(args, a_sp, b_sp, sigma, sym, dtype, dev)
    elif args.dense:
        op = from_dense(a_sp.toarray(), hermitian=sym, device=dev)
    else:
        op = from_scipy(a_sp, hermitian=sym, device=dev)

    ncv = args.nbCV or default_ncv(op.n, args.nbEV, sym)
    cfg = IRAMConfig(n=op.n, nev=args.nbEV, ncv=min(ncv, op.n),
                     which=args.mag, bmat=op.bmat, mode=op.mode,
                     tol=args.tol, max_iter=args.maxIt, symmetric=sym,
                     dtype=np.dtype(op.dtype), n_pad=op.n_pad,
                     seed=args.seed)
    solver = IRAMSolver(op, cfg)

    state = None
    v0 = None
    if args.restart:
        state, meta = ckpt.load_state(args.restart, cfg=None, device=dev)
        if state is None:
            v0 = meta["resid"]
    res = solver.solve(v0=v0, state=state)
    if args.dump:
        ckpt.save_state(args.dump, res.state, cfg)
    if res.info < 0:
        print(f"ERROR: solver info = {res.info}", file=sys.stderr)
        return 2

    out = extract(op, cfg, res, rvec=not args.noEV,
                  howmny="P" if args.schur else "A")
    elapsed = time.perf_counter() - t0

    # residual verification with an independent matvec: arpackSolver::
    # checkEigVec (arpackSolver.hpp:297-323), on the host
    residuals = []
    if out.vectors is not None and not args.schur:
        for i in range(out.nconv):
            v = out.vectors[:, i]
            av = a_sp @ v
            bv = (b_sp @ v) if b_sp is not None else v
            residuals.append(
                float(np.linalg.norm(av - out.values[i] * bv)
                      / max(1.0, abs(out.values[i]))))

    if args.json:
        print(json.dumps({
            "nconv": out.nconv, "info": out.info, "n_iter": out.n_iter,
            "values_real": [float(v.real) for v in np.atleast_1d(out.values)],
            "values_imag": [float(np.imag(v))
                            for v in np.atleast_1d(out.values)],
            "residuals": residuals, "elapsed_s": elapsed,
        }))
    else:
        print(f"OPT: solved in {elapsed:.3f}s, {out.n_iter} restart "
              f"iterations, {out.nconv} converged (info={out.info})")
        for i, v in enumerate(np.atleast_1d(out.values)):
            line = f"  lambda[{i}] = {v}"
            if residuals:
                line += f"   ||A*x-l*B*x||/|l| = {residuals[i]:.3e}"
            print(line)
        if args.verbose:
            print(res.stats.summary())
    bad = [r for r in residuals if r > max(args.tol * 100, 1e-5)]
    return 1 if (out.nconv < args.nbEV or bad) else 0


def _main_guarded(argv=None) -> int:
    try:
        return main(argv)
    except (ValueError, FileNotFoundError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(_main_guarded())
