"""ctypes loader for the native C++ reduced-space kernels
(``native/src/reduced.cc``, C ABI in ``native/include/arpack_tpu.h``),
shared with the reference package; port of ``arpack_ng_tpu/native.py``.

The library is built on first use with g++ into ``native/build/`` and
reused as it is.  If the toolchain or the build is unavailable the callers
in ``core/reduced.py`` take their numpy/scipy branch.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "libarpack_tpu_native.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    src = _NATIVE_DIR / "src" / "reduced.cc"
    if not src.exists():
        return False
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           f"-I{_NATIVE_DIR / 'include'}", str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, _LIB_PATH)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("ARPACK_TPU_NO_NATIVE"):
        return None
    src = _NATIVE_DIR / "src" / "reduced.cc"
    if not _LIB_PATH.exists() or (
            src.exists()
            and src.stat().st_mtime > _LIB_PATH.stat().st_mtime):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    i64 = ctypes.c_int64
    dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.atpu_stqrb_d.restype = i64
    lib.atpu_stqrb_d.argtypes = [i64, dp, dp, dp]
    lib.atpu_steqr_d.restype = i64
    lib.atpu_steqr_d.argtypes = [i64, dp, dp, dp]
    lib.atpu_sym_shift_q_d.restype = i64
    lib.atpu_sym_shift_q_d.argtypes = [i64, dp, dp, i64, dp, dp]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def _tridiag(alpha, beta):
    n = alpha.shape[0]
    d = np.ascontiguousarray(alpha, np.float64).copy()
    e = np.zeros(max(n - 1, 1), np.float64)
    e[: n - 1] = beta[: n - 1]
    return n, d, e


def stqrb(alpha: np.ndarray, beta: np.ndarray, rnorm: float):
    """Native dstqrb: (ritz ascending, bounds)."""
    lib = _lib_or_raise()
    n, d, e = _tridiag(alpha, beta)
    z = np.zeros(n, np.float64)
    info = lib.atpu_stqrb_d(n, d, e, z)
    if info != 0:
        raise RuntimeError(f"atpu_stqrb_d failed: info={info}")
    return d, np.abs(rnorm * z)


def steqr(alpha: np.ndarray, beta: np.ndarray):
    """Native dsteqr-class: (evals ascending, eigenvector matrix S)."""
    lib = _lib_or_raise()
    n, d, e = _tridiag(alpha, beta)
    s = np.zeros((n, n), np.float64)
    info = lib.atpu_steqr_d(n, d, e, s)
    if info != 0:
        raise RuntimeError(f"atpu_steqr_d failed: info={info}")
    return d, s


def sym_shift_q(alpha: np.ndarray, beta: np.ndarray, shifts: np.ndarray):
    """Native dsapps Q computation: (d', e', Q)."""
    lib = _lib_or_raise()
    n, d, e = _tridiag(alpha, beta)
    sh = np.ascontiguousarray(shifts, np.float64)
    q = np.zeros((n, n), np.float64)
    lib.atpu_sym_shift_q_d(n, d, e, len(sh), sh, q)
    beta_out = np.zeros_like(np.asarray(beta, np.float64))
    beta_out[: n - 1] = e[: n - 1]
    return d, beta_out, q
