"""The port's C library (``arpack_ng_tpu_torch.native_capi``): the
unchanged ``native/src/capi.cc`` built against the port's bridge, and the
unchanged C and C++ clients of ``native/tests`` against it, on the CPU.

* ``test_capi.c`` (LP64 and the ILP32 build, whose matrix-free callback
  takes a 32-bit ``n``) and ``test_capi_cpp.cc`` run as subprocesses with
  ``$ARPACK_TPU_TORCH_DEVICE=cpu`` and ``$ARPACK_TPU_PATH`` naming this
  interpreter's site-packages; each must exit 0 and print its OK line;
* the library loaded with ``ctypes.PyDLL`` in a fresh Python: a solve and
  ``atpu_device_count`` run, and neither ``jax`` nor ``arpack_ng_tpu`` is
  imported;
* without ``$ARPACK_TPU_TORCH_DEVICE`` and without CUDA a C call returns
  its error code and prints why: nothing runs on the CPU unasked."""
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from arpack_ng_tpu_torch import native_capi  # noqa: E402

#: seconds each subprocess may take (a client runs ~12 solves)
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def env():
    try:
        native_capi.build()
    except RuntimeError as e:     # no compiler or no Python.h: say so
        pytest.fail(f"the C library does not build here: {e}")
    return native_capi.client_env(device="cpu")


CLIENTS = [("test_capi.c", True, "C-ABI OK"),
           ("test_capi.c", False, "C-ABI OK"),
           ("test_capi_cpp.cc", True, "typed-enum header OK")]


@pytest.mark.parametrize("source,interface64,ok", CLIENTS,
                         ids=["c", "c-ilp32", "cpp"])
def test_client(env, source, interface64, ok):
    exe = native_capi.build_client(native_capi.NATIVE / "tests" / source,
                                   interface64)
    r = subprocess.run([str(exe)], capture_output=True, text=True, env=env,
                       timeout=TIMEOUT_S)
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    assert ok in r.stdout
    # one process on the CPU: the parallel tier reports a world of one
    assert "SKIP parallel" in r.stdout


_PYDLL = textwrap.dedent("""
    import ctypes, json, sys
    import numpy as np
    from arpack_ng_tpu_torch import native_capi
    lib = native_capi.load()
    assert isinstance(lib, ctypes.PyDLL)
    n = 200
    p = np.arange(n + 1, dtype=np.int64)
    i = np.arange(n, dtype=np.int64)
    v = np.arange(1.0, n + 1)
    vals = np.zeros(8)
    vecs = np.zeros(8 * n)
    nconv = ctypes.c_int64()
    rc = lib.atpu_eigsh_csr_d(n, p.ctypes.data, i.ctypes.data, v.ctypes.data,
                              n, 3, b"LA", 1e-10, 20, 500,
                              vals.ctypes.data, vecs.ctypes.data,
                              ctypes.byref(nconv))
    print(json.dumps({
        "count": lib.atpu_device_count(), "rc": rc, "nconv": nconv.value,
        "vals": vals[:3].tolist(), "nopx": native_capi.stat_c(lib)[0],
        "bridge": "arpack_ng_tpu_torch.native_bridge" in sys.modules,
        "jax": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib",
                                             "arpack_ng_tpu"))}))
""")


def _python(code, env):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=TIMEOUT_S,
                          cwd=str(native_capi.NATIVE.parent))


def test_pydll_in_a_fresh_python(env):
    import json
    r = _python(_PYDLL, env)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["count"] == 1 and out["rc"] == 0 and out["nconv"] >= 3
    assert out["vals"] == pytest.approx([198.0, 199.0, 200.0], abs=1e-8)
    assert out["nopx"] > 0 and out["bridge"]
    assert out["jax"] == []


def test_no_device_no_cuda_returns_the_error_code(env):
    import json
    env = dict(env)
    env.pop("ARPACK_TPU_TORCH_DEVICE")
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = _python(_PYDLL, env)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["count"] == -1 and out["rc"] == -9999 and out["nconv"] == 0
    assert out["nopx"] == 0
    assert "CUDA is not available" in r.stderr
