"""The port's ``arpackmm`` command line (``arpack_ng_tpu_torch.cli``)
against the reference package's (``arpack_ng_tpu.cli``), both in-process
with ``--cpu --json`` on ``.mtx`` files written from ``models/``.

Both CLIs start from one start vector: a resid-only checkpoint the test
writes (``--restart``), read the same way by both (the packages' random
start vectors differ).  Per case: equal rc, equal ``nconv``, values within
1e-10 of each other and equal ``n_iter`` in float64 (float32:
``--simplePrec`` values within 1e-4 relative), residuals checked.  Then the
error paths (unknown ``--slv``, a missing file, a complex shift with an
iterative solver on a real problem, no ``--cpu`` without a card: rc 2, no
CPU fallback), dump/restart in both directions, and the reference's
``arpackmm.sh`` sweep (``tests/test_sweep_cli.py``) on generated matrices
(the slow tier; its size check is fast)."""
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from arpack_ng_tpu import cli as jcli  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.io import matrix_market as jmm  # noqa: E402
from arpack_ng_tpu_torch import cli as pcli  # noqa: E402
from arpack_ng_tpu_torch.utils import debug as pdebug  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _v0_file(path, n, seed=5, cplx=False):
    """A resid-only checkpoint holding a seeded start vector of length n."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, n)
    if cplx:
        v = v + 1j * rng.uniform(-1, 1, n)
    meta = dict(version=1, n=n, nev=1, ncv=2, which="LM", bmat="I", mode=1,
                symmetric=True, dtype=v.dtype.name, n_pad=n,
                resid_only=True)
    np.savez(path, __meta__=json.dumps(meta), resid=v, rnorm=np.float64(1),
             key=np.zeros(2, np.uint32))
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mtx")
    out = {}

    def put(name, m):
        out[name] = str(d / f"{name}.mtx")
        jmm.write_matrix(out[name], m)

    _, lap = jmodels.laplacian_1d(80, dtype=np.float64)
    put("lap", lap)
    _, cd = jmodels.convection_diffusion_2d(10, rho=10.0, dtype=np.float64)
    put("cd", cd)
    _, zcd = jmodels.convection_diffusion_2d(10, rho=10.0,
                                             dtype=np.complex128)
    put("zcd", zcd)
    n = 120
    h = 1.0 / (n + 1)
    put("K", sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)) / h)
    put("M", sp.diags([1.0, 4.0, 1.0], [-1, 0, 1], shape=(n, n)) * (h / 6))
    out["v0_80"] = _v0_file(d / "v0_80.npz", 80)
    out["v0_100"] = _v0_file(d / "v0_100.npz", 100)
    out["v0_100c"] = _v0_file(d / "v0_100c.npz", 100, cplx=True)
    out["v0_120"] = _v0_file(d / "v0_120.npz", 120)
    return out


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines and
                lines[-1].startswith("{") else None), buf.getvalue()


def _argv(files, case):
    """``case``: the matrix, its start vector and the flags."""
    a, v0, *flags = case
    argv = ["--A", files[a], "--restart", files[v0]] + list(flags)
    return [files.get(x, x) for x in argv] + ["--cpu", "--json"]


LAP = ("lap", "v0_80")
CD = ("cd", "v0_100", "--nonSymPb")
SHIFT = ("--shiftReal", "0.0", "--invert")
CASES = {
    "sym_LA": LAP + ("--nbEV", "3", "--mag", "LA", "--tol", "1e-8"),
    "sym_SA_ncv": LAP + ("--nbEV", "4", "--nbCV", "12", "--mag", "SA",
                         "--tol", "1e-8", "--maxIt", "2000"),
    "nonsym": CD + ("--nbEV", "3", "--tol", "1e-8"),
    "nonsym_LR": CD + ("--nbEV", "3", "--mag", "LR", "--tol", "1e-8"),
    "cpx": ("zcd", "v0_100c", "--cpxPb", "--nbEV", "3", "--tol", "1e-8"),
    "gen_mode2": ("K", "v0_120", "--B", "M", "--genPb", "--nbEV", "3",
                  "--tol", "1e-8"),
    "gen_mode2_CG": ("K", "v0_120", "--B", "M", "--genPb", "--nbEV", "3",
                     "--tol", "1e-8", "--slv", "CG"),
    "gen_mode3": ("K", "v0_120", "--B", "M", "--genPb", "--shiftReal",
                  "10.0", "--invert", "--nbEV", "3", "--tol", "1e-8"),
    "cplx_shift_real_pb_LU": CD + ("--shiftReal", "1.0", "--shiftImag",
                                   "0.2", "--nbEV", "3", "--tol", "1e-8"),
    "nonsym_schur": CD + ("--nbEV", "3", "--tol", "1e-8", "--schur"),
    "sym_noEV": LAP + ("--nbEV", "3", "--mag", "LA", "--tol", "1e-8",
                       "--noEV"),
    "sym_dense": LAP + ("--nbEV", "3", "--mag", "LA", "--tol", "1e-8",
                        "--dense"),
    "sym_simplePrec": LAP + ("--nbEV", "3", "--mag", "LA", "--tol", "1e-5",
                             "--simplePrec"),
}
for _slv in ("LU", "QR", "LLT", "LDLT"):
    CASES[f"si_{_slv}"] = LAP + SHIFT + ("--nbEV", "3", "--tol", "1e-8",
                                         "--slv", _slv)
CASES["si_QR_pivot"] = LAP + SHIFT + ("--nbEV", "2", "--tol", "1e-8",
                                      "--slv", "QR", "--slvDrtPivot", "1e-8")
CASES["si_LLT_offset_scale"] = LAP + ("--shiftReal", "-1.0", "--invert",
                                      "--nbEV", "2", "--tol", "1e-8",
                                      "--slv", "LLT", "--slvDrtOffset",
                                      "0.5", "--slvDrtScale", "2.0")
#: the factor is scale*S + offset*I: the values are not A's, and both CLIs
#: report the residual check's failure (rc 1)
SHIFTED_FACTOR = {"si_LLT_offset_scale"}
for _pc in ("Diag", "ILU#1e-4#3", "None", "ILU"):
    CASES[f"si_CG_{_pc}"] = LAP + SHIFT + (
        "--nbEV", "3", "--tol", "1e-8", "--slv", "CG", "--slvItrPC", _pc,
        "--slvTol", "1e-12", "--slvMaxIt", "3000")
    CASES[f"si_BiCG_{_pc}"] = CD + (
        "--shiftReal", "0.5", "--invert", "--nbEV", "3", "--tol", "1e-8",
        "--slv", "BiCG", "--slvItrPC", _pc, "--slvTol", "1e-12")


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_matches_reference(files, name):
    argv = _argv(files, CASES[name])
    rc_p, out_p, _ = _run(pcli.main, argv)
    rc_j, out_j, _ = _run(jcli.main, argv)
    assert rc_p == rc_j, (rc_p, rc_j)
    assert out_p["nconv"] == out_j["nconv"] and out_p["info"] == out_j["info"]
    vp = np.array(out_p["values_real"]) + 1j * np.array(out_p["values_imag"])
    vj = np.array(out_j["values_real"]) + 1j * np.array(out_j["values_imag"])
    assert vp.shape == vj.shape
    scale = max(1.0, np.max(np.abs(vj)))
    if "--simplePrec" in argv:
        assert np.max(np.abs(vp - vj)) <= 1e-4 * scale
    else:
        assert out_p["n_iter"] == out_j["n_iter"]
        assert np.max(np.abs(vp - vj)) <= 1e-10 * scale
    assert len(out_p["residuals"]) == len(out_j["residuals"])
    if name in SHIFTED_FACTOR:
        return
    if out_p["residuals"]:
        assert max(out_p["residuals"]) <= 1e-5
    assert rc_p == 0


def test_text_output_matches_reference(files):
    # the same lines: the OPT line but for its seconds, then one lambda
    # line per value with its residual (numbers to rounding)
    import re
    argv = [a for a in _argv(files, CASES["sym_LA"]) if a != "--json"]
    _, _, text_p = _run(pcli.main, argv)
    _, _, text_j = _run(jcli.main, argv)
    lp, lj = text_p.splitlines(), text_j.splitlines()
    assert len(lp) == len(lj) == 4
    assert lp[0].split("s,", 1)[1] == lj[0].split("s,", 1)[1]
    assert lp[0].startswith("OPT: solved in")
    num = re.compile(r"[-+]?\d+\.\d+(?:e[-+]\d+)?")
    for a, b in zip(lp[1:], lj[1:]):
        assert num.sub("#", a) == num.sub("#", b)
        xa, xb = (np.array([float(x) for x in num.findall(t)])
                  for t in (a, b))
        np.testing.assert_allclose(xa, xb, rtol=1e-3, atol=1e-12)


def test_flags_are_the_references(files):
    # the port's parser takes the reference's flags with the same
    # defaults, and no others
    def flags(parser):
        return {o: a.default for a in parser._actions
                for o in a.option_strings if o not in ("-h", "--help")}
    assert flags(pcli.build_parser()) == flags(jcli.build_parser())
    for main in (pcli.main, jcli.main):
        with pytest.raises(SystemExit):
            main(["--A", files["lap"], "--cpu", "--reorth", "selective"])


def test_unknown_slv_raises(files):
    with pytest.raises(SystemExit):
        pcli.main(["--A", files["lap"], "--slv", "SVD", "--cpu"])


def test_complex_shift_iterative_real_problem_raises(files):
    with pytest.raises(SystemExit):
        pcli.main(["--A", files["cd"], "--nonSymPb", "--shiftReal", "1",
                   "--shiftImag", "0.5", "--slv", "BiCG", "--cpu"])


def test_missing_file_rc2(tmp_path, capsys):
    argv = ["--A", str(tmp_path / "none.mtx"), "--cpu", "--json"]
    assert pcli._main_guarded(argv) == 2
    assert jcli._main_guarded(argv) == 2
    assert "ERROR" in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA card")
def test_no_card_without_cpu_is_rc2(files, capsys, monkeypatch):
    # the CLI runs on the card; without one it refuses and never solves on
    # the CPU
    from arpack_ng_tpu_torch.core import iram

    def refuse(*a, **k):
        raise AssertionError("solved on the CPU")

    monkeypatch.setattr(iram.IRAMSolver, "solve", refuse)
    assert pcli._main_guarded(["--A", files["lap"], "--json"]) == 2
    err = capsys.readouterr()
    assert "cuda" in err.err and err.out == ""


def test_module_entry_point(files):
    # python -m arpack_ng_tpu_torch.cli, in a process that imports no JAX
    env = dict(os.environ, PYTHONPATH=REPO)
    base = [sys.executable, "-m", "arpack_ng_tpu_torch.cli", "--A",
            files["lap"], "--nbEV", "2", "--mag", "LA", "--json"]
    r = subprocess.run(base + ["--cpu"], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["nconv"] == 2
    if not torch.cuda.is_available():
        r = subprocess.run(base, capture_output=True, text=True, env=env,
                           cwd=REPO, timeout=300)
        assert r.returncode == 2 and "cuda" in r.stderr
        assert r.stdout == ""


def test_dump_restart_matches_reference(files, tmp_path):
    # issue401.sh: a converged run dumps, a second resumes from the dump;
    # both CLIs, each from its own file, and each from the other's
    base = _argv(files, CASES["sym_LA"])
    outs = {}
    for tag, main in (("p", pcli.main), ("j", jcli.main)):
        ck = str(tmp_path / f"{tag}.npz")
        rc1, o1, _ = _run(main, base + ["--dump", ck])
        assert rc1 == 0
        argv2 = [ck if a == files["v0_80"] else a for a in base]
        rc2, o2, _ = _run(main, argv2)
        assert rc2 == 0
        np.testing.assert_allclose(o1["values_real"], o2["values_real"],
                                   rtol=1e-10)
        outs[tag] = (o1, o2, argv2)
    assert outs["p"][0]["n_iter"] == outs["j"][0]["n_iter"]
    assert outs["p"][1]["n_iter"] == outs["j"][1]["n_iter"]
    # each package resumes the other's file as it resumes its own
    for tag, main, other in (("p", pcli.main, "j"), ("j", jcli.main, "p")):
        argv = list(outs[other][2])
        rc, o, _ = _run(main, argv)
        assert rc == 0 and o["n_iter"] == outs[other][1]["n_iter"]
        np.testing.assert_allclose(o["values_real"],
                                   outs[other][1]["values_real"], rtol=1e-10)


def test_maxit_dump_resumes_the_unbroken_solve(files, tmp_path):
    # a run stopped by --maxIt (rc 1) dumps the last cycle's factorization
    # under the cycles before it, as the reference's CLI does: --restart
    # repeats the unbroken run's cycles and values exactly, in either
    # package, from either package's file
    base = _argv(files, CASES["sym_SA_ncv"])
    rc, full, _ = _run(pcli.main, base)
    assert rc == 0 and full["n_iter"] > 6
    ck = str(tmp_path / "ck.npz")
    rc1, o1, _ = _run(pcli.main, base + ["--maxIt", "5", "--dump", ck])
    assert rc1 == 1 and o1["n_iter"] == 5
    argv = [ck if a == files["v0_80"] else a for a in base]
    for main in (pcli.main, jcli.main):
        rc2, o2, _ = _run(main, argv)
        assert rc2 == 0 and o2["n_iter"] == full["n_iter"]
        np.testing.assert_allclose(o2["values_real"], full["values_real"],
                                   rtol=1e-12)
    ckj = str(tmp_path / "ckj.npz")
    _run(jcli.main, base + ["--maxIt", "5", "--dump", ckj])
    argv[argv.index("--restart") + 1] = ckj
    for main in (pcli.main, jcli.main):
        _, o2, _ = _run(main, argv)
        assert o2["n_iter"] == full["n_iter"]
        np.testing.assert_allclose(o2["values_real"], full["values_real"],
                                   rtol=1e-12)


def test_debug_one_traces_each_cycle(files):
    log = io.StringIO()
    pdebug.debug.logfil = log
    try:
        rc, out, text = _run(pcli.main, _argv(files, CASES["sym_LA"])
                             + ["--debug", "1"])
    finally:
        pdebug.debug.set_all(0)
        pdebug.debug.logfil = None
    assert rc == 0
    lines = [ln for ln in log.getvalue().splitlines() if "nconv=" in ln]
    assert len(lines) == out["n_iter"]
    assert "Implicitly-restarted Arnoldi" in text     # maupd: the summary


# ---------------------------------------------------------------------------
# the arpackmm.sh sweep (tests/test_sweep_cli.py) on generated matrices
# ---------------------------------------------------------------------------

_SLV_CONFIGS = [
    (["--slv", "BiCG", "--slvItrTol", "1e-8", "--slvItrMaxIt", "300"], "itr"),
    (["--slv", "CG", "--slvItrTol", "1e-8", "--slvItrMaxIt", "300"], "cg"),
    (["--slv", "BiCG", "--slvItrPC", "ILU"], "itr"),
    (["--slv", "CG", "--slvItrPC", "ILU#1.e-06#2"], "cg"),
    (["--slv", "LU"], "drt"),
    (["--slv", "QR", "--slvDrtPivot", "1.e-06"], "drt"),
    (["--slv", "LLT"], "llt"),
    (["--slv", "LLT", "--slvDrtOffset", "0."], "llt"),
    (["--slv", "LDLT"], "ldlt"),
    (["--slv", "LDLT", "--slvDrtScale", "1."], "ldlt"),
]


def gen_sweep():
    """The reference sweep's cases (tests/test_sweep_cli.py:gen_sweep)."""
    cases = []
    for pb in ("sym", "nonsym", "cpx"):
        for gen in ("", "gen"):
            if gen and pb != "sym":
                continue
            for mag in ("", "LA", "SM"):
                if mag == "LA" and pb != "sym":
                    continue
                for shift in ("", "s"):
                    for invert in ("", "--invert"):
                        if invert and not shift:
                            continue
                        for tol in ("", "1.e-5"):
                            for slv_args, kind in _SLV_CONFIGS:
                                if kind == "cg" and pb != "sym":
                                    continue
                                if kind in ("llt", "ldlt") and \
                                        (pb != "sym" or gen):
                                    continue
                                if not (shift or gen) and \
                                        slv_args != ["--slv", "LU"]:
                                    continue
                                for schur in ("", "--schur"):
                                    if schur and pb == "sym":
                                        continue
                                    for prec in ("", "--simplePrec"):
                                        for dense in ("", "--dense"):
                                            if dense and kind in ("itr",
                                                                  "cg"):
                                                continue
                                            cases.append(
                                                (pb, gen, mag, shift, invert,
                                                 tol, tuple(slv_args), schur,
                                                 prec, dense))
    out = []
    ndrt = 0
    for i, c in enumerate(cases):
        if c[6][1] in ("QR", "LLT", "LDLT", "CG"):
            ndrt += 1
            if ndrt % 3 == 0:
                out.append(c)
        elif i % 8 == 0:
            out.append(c)
    return out


_SWEEP = gen_sweep()


@pytest.fixture(scope="module")
def sweep_files(tmp_path_factory):
    """Stand-ins for the reference's shipped As/B/An/Az.mtx: a symmetric
    positive definite stencil, a mass matrix, the 1-D convection-diffusion
    band and its complex form (n = 100), and one start vector of each
    kind."""
    d = tmp_path_factory.mktemp("sweep")
    n = 100
    out = {}
    mats = {
        "As": sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(n, n)),
        "B": sp.diags([1.0, 4.0, 1.0], [-1, 0, 1], shape=(n, n)) / 6,
        "An": jmodels.convection_diffusion_1d(n, rho=10.0,
                                              dtype=np.float64)[1],
        "Az": jmodels.convection_diffusion_1d(n, rho=10.0,
                                              dtype=np.complex128)[1]
        + 0.1j * sp.eye(n),
    }
    for k, m in mats.items():
        out[k] = str(d / f"{k}.mtx")
        jmm.write_matrix(out[k], m)
    out["v0"] = _v0_file(d / "v0.npz", n)
    out["v0c"] = _v0_file(d / "v0c.npz", n, cplx=True)
    return out


def _sweep_argv(case, mtx, ck, restart=False):
    """The sweep's command line; the first pass starts from the module's
    start vector and dumps, the second restarts from the dump."""
    pb, gen, mag, shift, invert, tol, slv_args, schur, prec, dense = case
    if pb == "sym":
        argv = ["--A", mtx["As"]]
        if gen:
            argv += ["--B", mtx["B"], "--genPb"]
    elif pb == "nonsym":
        argv = ["--A", mtx["An"], "--nonSymPb"]
    else:
        argv = ["--A", mtx["Az"], "--nonSymPb", "--cpxPb"]
    argv += ["--mag", mag or "LM"]
    if shift:
        if slv_args[1] == "LLT":
            argv += ["--shiftReal", "-1.0"]
        elif pb == "cpx":
            argv += ["--shiftReal", "99.0", "--shiftImag", "99.0"]
        else:
            argv += ["--shiftReal", "99.0"]
    argv += [invert] if invert else []
    argv += ["--tol", tol or "1e-6"] + list(slv_args)
    argv += [f for f in (schur, prec, dense) if f]
    argv += ["--nbEV", "2", "--nbCV", "6", "--maxIt", "400", "--json",
             "--cpu"]
    if restart:
        return argv + ["--restart", ck]
    return argv + ["--restart", mtx["v0c" if pb == "cpx" else "v0"],
                   "--dump", ck]


def test_sweep_has_reference_scale():
    # the reference script runs hundreds of configs; require >= 100
    assert len(_SWEEP) >= 100, len(_SWEEP)


@pytest.mark.slow
@pytest.mark.parametrize("case", _SWEEP,
                         ids=lambda c: "-".join(
                             str(x) for x in (c[0], c[1] or "std",
                                              c[2] or "LM",
                                              "shift" if c[3] else "plain",
                                              c[4] or "noinv",
                                              c[5] or "tol0",
                                              c[6][1], c[7] or "ritz",
                                              c[8] or "f64",
                                              c[9] or "sparse")))
def test_sweep_config(case, sweep_files, tmp_path):
    # both CLIs from one start vector, then each from its own dump
    # (arpackmm.sh:80-84): the same rc and converged count; in float64
    # the same cycles.  rc 1 (no convergence in 400 restarts) is allowed
    # where both report it: the stand-ins are not the reference's matrices
    for restart in (False, True):
        outs = []
        for tag, main in (("p", pcli.main), ("j", jcli.main)):
            ck = str(tmp_path / f"{tag}.npz")
            outs.append(_run(main, _sweep_argv(case, sweep_files, ck,
                                               restart)))
        (rc_p, o_p, _), (rc_j, o_j, _) = outs
        assert rc_p == rc_j and rc_p in (0, 1), (rc_p, rc_j, restart)
        assert o_p["nconv"] == o_j["nconv"], restart
        if not case[8]:
            assert o_p["n_iter"] == o_j["n_iter"], restart
