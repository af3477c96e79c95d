"""The port's runnable examples (``arpack_ng_tpu_torch/examples``): the
manifest against the reference's ``examples/``, each example's
``main(..., device="cpu")`` at a small size against the reference
package's API on the same problem (``distributed_laplacian`` on a gloo
world of 2 processes, ``tests/torch_mp_worker.py``, and as a world of one
in this process), and the module entry points with ``--cpu`` (without it
and without a card: an error, no CPU run)."""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import arpack_ng_tpu as at  # noqa: E402
from arpack_ng_tpu import models as jmodels  # noqa: E402
from arpack_ng_tpu.models import corpus as jcorpus  # noqa: E402
from arpack_ng_tpu.ops.sparse import from_scipy as jfrom_scipy  # noqa
import arpack_ng_tpu_torch.examples as pex  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: examples of the reference the port does not have yet
WAITING = set()


def test_manifest_matches_reference():
    ref = {f[:-3] for f in os.listdir(os.path.join(REPO, "examples"))
           if f.endswith(".py")}
    here = {f[:-3] for f in os.listdir(os.path.dirname(pex.__file__))
            if f.endswith(".py") and not f.startswith("_")}
    assert set(pex.EXAMPLES) == here == ref - WAITING


def _run(name, *args):
    import importlib
    mod = importlib.import_module(f"arpack_ng_tpu_torch.examples.{name}")
    return mod.main(*args, device="cpu")


def _close_sets(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    key = (lambda v: (np.round(v.real, 6), np.round(v.imag, 6)))
    sa = sorted(a, key=key)
    sb = sorted(b, key=key)
    np.testing.assert_allclose(sa, sb, rtol=rtol)


def test_dssimp(capsys):
    vals, res = _run("dssimp", 16)
    op, _ = jmodels.laplacian_2d(16, dtype=np.float32)
    ref = at.eigsh(op, k=4, which="LA", tol=1e-5, return_eigenvectors=False)
    # the spectrum has double values, of which a Krylov solve may return
    # one copy or two: every value on the analytic spectrum, the top one
    # the reference's
    g = 2 - 2 * np.cos(np.pi * np.arange(1, 17) / 17)
    spec = (g[:, None] + g[None, :]).ravel()
    assert all(np.min(np.abs(spec - v)) <= 1e-5 * v for v in vals)
    np.testing.assert_allclose(vals.max(), ref.max(), rtol=1e-5)
    assert res.max() < 1e-3 * np.abs(vals).max()
    assert "lambda[3]" in capsys.readouterr().out


def test_dnsimp():
    vals, res = _run("dnsimp", 12)
    op, _ = jmodels.convection_diffusion_2d(12, rho=100.0, dtype=np.float64)
    ref = at.eigs(op, k=4, which="LM", tol=1e-10,
                  return_eigenvectors=False)
    _close_sets(vals, ref, 1e-8)
    assert res.max() < 1e-8


def test_dsdrv4_shift_invert():
    vals, res = _run("dsdrv4_shift_invert", 120)
    n = 120
    h = 1.0 / (n + 1)
    k = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).toarray() / h
    m = sp.diags([1.0, 4.0, 1.0], [-1, 0, 1], shape=(n, n)).toarray() * h / 6
    ref = at.eigsh(k, k=4, M=m, sigma=0.0, which="LM", tol=1e-10,
                   return_eigenvectors=False)
    _close_sets(vals, ref, 1e-9)
    assert res.max() < 1e-6


def test_zndrv1():
    vals, res = _run("zndrv1", 10)
    op, _ = jmodels.convection_diffusion_2d(10, rho=80.0,
                                            dtype=np.complex128)
    ref = at.eigs(op, k=4, which="LM", tol=1e-10,
                  return_eigenvectors=False)
    _close_sets(vals, ref, 1e-8)
    assert res.max() < 1e-8


def test_svd():
    s, res = _run("svd", 300, 60, 4)
    a = np.random.default_rng(0).standard_normal((300, 60))
    _, ref, _ = at.svds(a, k=4, tol=1e-10)
    np.testing.assert_allclose(np.sort(s), np.sort(ref), rtol=1e-10)
    assert res.max() < 1e-8


def test_validate_f64():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        vals, rel = _run("validate_f64", 12)
        _, a_sp = jmodels.convection_diffusion_2d(12, rho=400.0,
                                                  dtype=np.float32)
        ref, _, out = at.eigs(a_sp.astype(np.float32), k=4, which="LM",
                              ncv=20, tol=1e-4, maxiter=500,
                              validate="f64", return_stats=True)
    _close_sets(np.abs(vals), np.abs(ref), 1e-3)
    assert np.all(np.isfinite(rel)) and rel.max() < 1e-2
    assert out.validation.passed


def test_irregular_sparse():
    vals, res = _run("irregular_sparse", 3000)
    a = jcorpus.fem_triangulation(3000).tocsr()
    a = ((a + a.T) * 0.5).tocsr()
    op = jfrom_scipy(a.astype(np.float32), hermitian=True, format="psell")
    ref = at.eigsh(op, k=4, which="LA", ncv=20, tol=1e-4, maxiter=2000,
                   return_eigenvectors=False)
    _close_sets(vals, ref, 1e-4)
    assert res.max() < 1e-3


def _grid_spectrum(nx, ny):
    gx = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    gy = 2 - 2 * np.cos(np.pi * np.arange(1, ny + 1) / (ny + 1))
    return (gx[:, None] + gy[None, :]).ravel()


def test_distributed_laplacian(tmp_path):
    from arpack_ng_tpu.models.distributed import laplacian_2d_sharded
    from arpack_ng_tpu.parallel.sharding import make_mesh
    from torch_mp_worker import run_world
    out = run_world(2, ["example"], tmp_path,
                    {"example": (64, 32)})["example"]
    for r in out:
        assert "error" not in r, r.get("error")
    np.testing.assert_array_equal(out[0]["vals"], out[1]["vals"])
    assert out[0]["out"].count("lambda[") == 4 and not out[1]["out"]
    assert "mesh: 2 ranks (gloo); grid 64x32" in out[0]["out"]
    mesh = make_mesh(8)
    op, _ = laplacian_2d_sharded(64, 32, mesh, dtype=np.float32)
    ref = at.eigsh(op, k=4, which="LA", tol=1e-5, mesh=mesh,
                   return_eigenvectors=False)
    spec = _grid_spectrum(64, 32)
    one, res1 = _run("distributed_laplacian", 64, 32)   # a world of one
    for vals, res in ((out[0]["vals"], out[0]["res"]), (one, res1)):
        # each value on the analytic spectrum within the solve's tol; the
        # reference's float32 mesh solve lies up to 1.1e-5 off it (within
        # its own tol), so the two sets agree within twice the tol
        assert all(np.min(np.abs(spec - v)) <= 1e-5 * v for v in vals)
        _close_sets(vals, ref, 2e-5)
        assert res.max() < 1e-3 * np.abs(vals).max()


def test_distributed_entry_point():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m",
           "arpack_ng_tpu_torch.examples.distributed_laplacian", "32", "16"]
    r = subprocess.run(cmd + ["--cpu", "--ranks", "2"], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.count("lambda[") == 4
    assert "mesh: 2 ranks (gloo)" in r.stdout
    if not torch.cuda.is_available():
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=REPO, timeout=300)
        assert r.returncode != 0 and "no CUDA device" in r.stderr
        assert "lambda[" not in r.stdout


def test_module_entry_point():
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "arpack_ng_tpu_torch.examples.dssimp", "8"]
    r = subprocess.run(cmd + ["--cpu"], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.count("lambda[") == 4
    if not torch.cuda.is_available():
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=REPO, timeout=300)
        assert r.returncode != 0 and "CUDA is not available" in r.stderr
        assert "lambda[" not in r.stdout
