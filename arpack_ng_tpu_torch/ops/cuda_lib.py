"""Build and load the package's hand-written CUDA kernels.

The sources under ``arpack_ng_tpu_torch/csrc/`` are compiled with ``nvcc``
for ``sm_90a``, one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain C interface, loaded with
``ctypes``.  The build runs at first use, under a file lock, into
``arpack_ng_tpu_torch/_build/``; the library's name carries a hash of the
sources and flags, so an edited source is rebuilt and a finished build is
reused.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("sel.cu", "rot.cu", "cgs.cu", "dia.cu", "psell.cu", "gather.cu",
           "sym_cycle.cu", "realnonsym_cycle.cu", "cplx_cycle.cu",
           "krylov_loop.cu")
HEADERS = ("common.cuh", "passes.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: most basis rows one call of the row passes (sel and cgs kernels) takes
#: (``PASS_MAX_ROWS`` in csrc/passes.cuh)
MAX_ROWS = 256

#: dtype code of the C interface for each (storage, accumulation) pair
DTYPE_CODES = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.float32): 1,
    (torch.float64, torch.float64): 2,
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or /usr/local/cuda/bin)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libarpack_tpu_torch_{_digest()}.so"


def _run_all(cmds, log) -> None:
    """Run the commands concurrently; append each one's output to ``log``
    and raise if any fails.  Every process is waited for or killed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    try:
        for cmd, proc in zip(cmds, procs):
            text, _ = proc.communicate(timeout=900)
            log.append(" ".join(cmd) + "\n" + text)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{text}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the kernels if no build of the current sources exists: one
    ``nvcc`` per source, started together, then one link.  The compiler's
    report (registers, shared memory, spills) goes to ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():
                return out
            nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
            objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
            log = []
            try:
                _run_all([[nvcc, *FLAGS, "-c", "-o", str(o), str(CSRC / s)]
                          for s, o in zip(SOURCES, objs)], log)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *map(str, objs)]], log)
            finally:
                out.with_suffix(".log").write_text("\n".join(log))
                for o in objs:
                    o.unlink(missing_ok=True)
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raise on failure."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.atpt_error_string.argtypes = [i32]
    lib.atpt_error_string.restype = ctypes.c_char_p
    lib.atpt_sel_proj.argtypes = [i32, i32, i32, vp, i32, vp, vp, i64, vp,
                                  i64, vp, vp, vp, vp]
    lib.atpt_sel_proj.restype = i32
    lib.atpt_sel_update.argtypes = [i32, i32, i32, vp, vp, i32, vp, vp, i64,
                                    vp, i64, vp, vp, vp, vp]
    lib.atpt_sel_update.restype = i32
    f64 = ctypes.c_double
    lib.atpt_sym_cycle.argtypes = [i32, i32, i32, i32, i32, i32, f64, f64,
                                   f64, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                   vp, vp, vp]
    lib.atpt_sym_cycle.restype = i32
    lib.atpt_realnonsym_cycle.argtypes = [i32] * 6 + [f64] * 4 + [vp] * 11
    lib.atpt_realnonsym_cycle.restype = i32
    lib.atpt_cplx_cycle.argtypes = [i32] * 6 + [f64] * 3 + [vp] * 11
    lib.atpt_cplx_cycle.restype = i32
    lib.atpt_rotate_rows.argtypes = [i32, i32, i32, i32, vp, i32, i32, i32,
                                     vp, i64, i64, vp]
    lib.atpt_rotate_rows.restype = i32
    lib.atpt_cgs_proj.argtypes = [i32, i32, i32, i32, i32, vp, i64, vp, i64,
                                  vp, vp, vp, vp]
    lib.atpt_cgs_proj.restype = i32
    lib.atpt_cgs_update.argtypes = [i32, i32, i32, i32, vp, i32, vp, i64, vp,
                                    vp, i64, vp, vp, vp, vp]
    lib.atpt_cgs_update.restype = i32
    lib.atpt_dia_matvec_sub.argtypes = [i32, i32, vp, i32, vp, i64, vp, vp,
                                        vp, i64, i64, vp, vp]
    lib.atpt_dia_matvec_sub.restype = i32
    lib.atpt_dia_block_matvec.argtypes = [i32, vp, i32, vp, i64, vp, i64,
                                          i32, i64, i64, vp, i64, vp]
    lib.atpt_dia_block_matvec.restype = i32
    lib.atpt_dia_block_config.argtypes = [i32, i32, i32, i64, vp]
    lib.atpt_dia_block_config.restype = i32
    lib.atpt_psell_matvec.argtypes = [i32, vp, vp, vp, vp, vp, i32, vp, i64,
                                      vp, vp]
    lib.atpt_psell_matvec.restype = i32
    lib.atpt_take_flat.argtypes = [i32, vp, vp, i64, vp, vp]
    lib.atpt_take_flat.restype = i32
    lib.atpt_take_lanes.argtypes = [vp, vp, i64, vp, vp]
    lib.atpt_take_lanes.restype = i32
    lib.atpt_noop.argtypes = [vp]
    lib.atpt_noop.restype = i32
    _lib = lib
    return lib


def dtype_code(storage: torch.dtype, acc: torch.dtype) -> int:
    try:
        return DTYPE_CODES[(storage, acc)]
    except KeyError:
        raise TypeError(f"no CUDA kernel for storage {storage} with "
                        f"accumulation {acc}; supported: "
                        f"{sorted(map(str, DTYPE_CODES))}") from None


def stream_handle(device: torch.device) -> int:
    """The raw handle of the current CUDA stream of ``device``: read
    without building a ``torch.cuda.Stream``, which costs a wrapper call
    more host time than the rest of its argument checks."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a launch error reported by the C interface."""
    if err != 0:
        msg = lib.atpt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
