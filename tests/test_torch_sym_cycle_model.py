"""A numpy model, in double, of the reduced-space kernel's own algorithm
(``tools/reduced_rounding_cpu.kernel_model``: the implicit QL and the
reflector-by-reflector Householder QR, each Givens and Householder step
with dlapy2 and divisions, as the kernel forms them) on the CPU:

* put in place of ``eigh`` and ``qr`` in the plain twin
  (``ops/cuda_sym_cycle.sym_cycle_plain``), against the twin itself on the
  Lanczos tridiagonals of ``chip_smoke.py``'s phase 3 (ncv = 32, nev = 8,
  seeds 0-3), for every ``which``, float32 and float64: the counts equal and
  every gap within ``chip_smoke.SYM_LIMITS``;
* in float64 against the reference package's reduced work
  (``make_sym_head`` / ``make_sym_tail``) on random Lanczos tridiagonals, with
  the checks of ``tests/test_torch_device_loop.py``."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

_TOOL = Path(__file__).resolve().parent.parent / "tools" / \
    "reduced_rounding_cpu.py"
_spec = importlib.util.spec_from_file_location("reduced_rounding_cpu", _TOOL)
model = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(model)  # puts the repository root on sys.path

import chip_smoke  # noqa: E402
from arpack_ng_tpu_torch.ops import cuda_sym_cycle as csc  # noqa: E402

WHICH = ["LA", "SA", "LM", "SM", "BE"]


def _params(which, dtype, nev=8):
    f = np.finfo(dtype)
    return csc.Params(which=which, nev=nev,
                      tol=1e-5 if dtype == np.float32 else 1e-10,
                      eps23=float(f.eps ** (2 / 3)), eps_m=float(f.eps))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("which", WHICH)
def test_model_matches_twin(which, dtype):
    dt = getattr(torch, dtype)
    p = _params(which, np.dtype(dtype).type)
    lim = chip_smoke.SYM_LIMITS[str(dt)]
    cpu = torch.device("cpu")
    for seed in range(4):
        d, e = chip_smoke._lanczos_tridiag(seed=seed)
        twin = chip_smoke._sym_run(torch, csc, d, e, dt, cpu, p)
        with model.kernel_model():
            got = chip_smoke._sym_run(torch, csc, d, e, dt, cpu, p)
        g = chip_smoke._sym_gaps(twin, got, d, chip_smoke.NCV)
        assert g.pop("counts_equal"), (which, seed)
        for key, v in g.items():
            assert v <= lim[key], (which, seed, key, v, lim[key])


@pytest.mark.parametrize("which", WHICH)
def test_model_matches_reference(which):
    from test_torch_device_loop import _check_cycle, _lanczos_T
    for seed in (0, 1):
        T, rnorm = _lanczos_T(seed)
        with model.kernel_model():
            _check_cycle(T, rnorm, which)

