"""Build and load the port's C library: the unchanged
``native/src/capi.cc`` (the C ABI of ``native/include/arpack_tpu_solver.h``)
compiled against :mod:`arpack_ng_tpu_torch.native_bridge`.

``capi.cc`` embeds CPython and imports its Python side by name.  g++
builds it with ``-include csrc/capi_select.h``, which maps that import to
this package's bridge, so the library imports neither JAX nor
``arpack_ng_tpu``.  The library and its ILP32 twin (``-DATPU_INTERFACE64=0``,
32-bit ``atpu_int``) go straight into ``arpack_ng_tpu_torch/_build/``:
``capi.cc`` puts ``<directory of the library>/../..`` on ``sys.path``,
which from there is the repository root.  Compile and link flags come from
``sysconfig`` of the building interpreter; the library links its
libpython.

* :func:`build` / :func:`load`: the library, built at first use under a
  file lock with an atomic rename, rebuilt when a source, the flags or the
  interpreter change; :func:`load` returns a ``ctypes.PyDLL`` (the calls
  hold the GIL), never a ``CDLL``: ``capi.cc`` runs Python before it takes
  the GIL, which crashes a host that dropped it.
* :func:`build_client`: a C or C++ program linked against either library
  (``native/tests/test_capi.c`` and ``test_capi_cpp.cc``);
  :func:`client_env` its environment: ``$ARPACK_TPU_PATH`` names this
  interpreter's ``site-packages`` for the embedded interpreter, and
  ``$ARPACK_TPU_TORCH_DEVICE`` the bridge's device.
* :func:`build_stencil`: ``csrc/stencil5.c``, a C operator for the
  matrix-free entry points.

Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
import sysconfig
from pathlib import Path

_PKG = Path(__file__).resolve().parent
NATIVE = _PKG.parent / "native"
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
HEADER = CSRC / "capi_select.h"
SOURCE = NATIVE / "src" / "capi.cc"
LIB_NAMES = {True: "libarpack_tpu_torch_capi.so",
             False: "libarpack_tpu_torch_capi32.so"}

_libs = {}


def _python_flags():
    """``(compile flags, link flags)`` of this interpreter's libpython."""
    inc = sysconfig.get_config_var("INCLUDEPY") or ""
    if not (Path(inc) / "Python.h").exists():
        raise RuntimeError(
            f"Python.h not found (sysconfig INCLUDEPY = {inc!r}): the C "
            "library embeds CPython and needs the interpreter's headers")
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldlib = sysconfig.get_config_var("LDLIBRARY") or ""
    if not ldlib.endswith(".so") and ".so." not in ldlib:
        raise RuntimeError(f"the C library links a shared libpython; this "
                           f"interpreter's is {ldlib!r}")
    name = ldlib[3:].split(".so")[0]           # libpython3.12.so
    return ([f"-I{inc}"],
            [f"-L{libdir}", f"-l{name}", f"-Wl,-rpath,{libdir}", "-ldl"])


def _flags(interface64: bool):
    cflags, ldflags = _python_flags()
    width = [] if interface64 else ["-DATPU_INTERFACE64=0"]
    return (["-O2", "-shared", "-fPIC", "-std=c++17", *width,
             f"-I{NATIVE / 'include'}", *cflags, "-include", str(HEADER)],
            ldflags)


def _locked_build(out: Path, inputs, cmd_for) -> Path:
    """Build ``out`` with the command ``cmd_for(tmp)`` unless it exists
    with the key of ``inputs`` (paths and strings): under the build
    directory's lock, into a temporary file renamed into place; the key
    goes beside it (``<out>.key``)."""
    h = hashlib.sha256()
    for x in inputs:
        h.update(x.read_bytes() if isinstance(x, Path) else x.encode())
    key = h.hexdigest()
    stamp = out.with_name(out.name + ".key")

    def fresh():
        return out.exists() and stamp.exists() and \
            stamp.read_text() == key

    if fresh():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "capi.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if fresh():
                return out
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = cmd_for(tmp)
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=600)
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{' '.join(cmd)} failed "
                                   f"({r.returncode}):\n{r.stderr[-4000:]}")
            os.replace(tmp, out)
            stamp.write_text(key)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def library_path(interface64: bool = True) -> Path:
    return BUILD_DIR / LIB_NAMES[interface64]


def build(interface64: bool = True) -> Path:
    """Compile ``native/src/capi.cc`` for the bridge if no current build
    exists; returns the library's path."""
    cflags, ldflags = _flags(interface64)
    headers = sorted((NATIVE / "include").glob("*.h"))
    return _locked_build(
        library_path(interface64),
        [SOURCE, HEADER, *headers, " ".join(cflags + ldflags)],
        lambda tmp: ["g++", *cflags, str(SOURCE), "-o", str(tmp),
                     *ldflags])


def load(interface64: bool = True) -> ctypes.PyDLL:
    """Build (if needed) and load the library into this process as a
    ``ctypes.PyDLL``, with the signatures of the calls the package makes
    declared."""
    if interface64 in _libs:
        return _libs[interface64]
    lib = ctypes.PyDLL(str(build(interface64)))
    i = ctypes.c_int64 if interface64 else ctypes.c_int32
    vp, cp, f64 = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double
    ip = ctypes.POINTER(i)
    lib.atpu_device_count.argtypes = []
    lib.atpu_device_count.restype = i
    for name in ("atpu_eigsh_csr_s", "atpu_eigsh_csr_d"):
        fn = getattr(lib, name)
        fn.argtypes = [i, vp, vp, vp, i, i, cp, f64, i, i, vp, vp, ip]
        fn.restype = i
    for name in ("atpu_eigsh_matvec_s", "atpu_eigsh_matvec_d"):
        fn = getattr(lib, name)
        fn.argtypes = [i, vp, vp, i, cp, f64, i, i, vp, vp, ip]
        fn.restype = i
    lib.atpu_stats_reset.argtypes = []
    lib.atpu_stats_reset.restype = None
    fp = ctypes.POINTER(ctypes.c_float)
    lib.atpu_stat_c.argtypes = [ip] * 5 + [fp] * 26
    lib.atpu_stat_c.restype = None
    lib.atpu_int = i
    _libs[interface64] = lib
    return lib


def stat_c(lib) -> list:
    """``atpu_stat_c`` through ``lib``: the 5 counters and 26 timers."""
    ints = [lib.atpu_int() for _ in range(5)]
    flts = [ctypes.c_float() for _ in range(26)]
    lib.atpu_stat_c(*[ctypes.byref(x) for x in ints + flts])
    return [x.value for x in ints + flts]


def build_client(source, interface64: bool = True) -> Path:
    """Compile a C (``.c``, gcc) or C++ (g++) program that includes
    ``native/include`` and links against the library of that width; the
    program goes beside the library, named after its source (``32``
    appended for ILP32)."""
    source = Path(source)
    lib = build(interface64)
    cpp = source.suffix != ".c"
    out = BUILD_DIR / (source.stem + ("" if interface64 else "32"))
    width = [] if interface64 else ["-DATPU_INTERFACE64=0"]
    flags = ["-O2", *(["-std=c++17"] if cpp else []), *width,
             f"-I{NATIVE / 'include'}"]
    return _locked_build(
        out, [source, lib, " ".join(flags)],
        lambda tmp: ["g++" if cpp else "gcc", *flags, str(source), "-o",
                     str(tmp), f"-L{BUILD_DIR}", f"-l:{lib.name}",
                     f"-Wl,-rpath,{BUILD_DIR}", "-lm"])


def client_env(device=None, env=None) -> dict:
    """The environment of a C program on the library: ``env`` (default:
    this process's) with this interpreter's ``site-packages`` on
    ``$ARPACK_TPU_PATH`` (the embedded interpreter is the libpython the
    library links, which knows nothing of this interpreter's environment)
    and, with ``device``, ``$ARPACK_TPU_TORCH_DEVICE``."""
    env = dict(os.environ if env is None else env)
    paths = [sysconfig.get_paths()[k] for k in ("purelib", "platlib")]
    paths += [p for p in sys.path if p.endswith("site-packages")]
    old = env.get("ARPACK_TPU_PATH", "")
    keep = list(dict.fromkeys(p for p in paths + old.split(os.pathsep)
                              if p))
    env["ARPACK_TPU_PATH"] = os.pathsep.join(keep)
    if device is not None:
        env["ARPACK_TPU_TORCH_DEVICE"] = str(device)
    return env


def build_stencil() -> Path:
    """``csrc/stencil5.c`` as a shared library (``atpu_stencil5_s`` /
    ``_d``, ctx: a pointer to the grid's int64 nx)."""
    src = CSRC / "stencil5.c"
    return _locked_build(
        BUILD_DIR / "libatpu_stencil5.so", [src],
        lambda tmp: ["gcc", "-O2", "-shared", "-fPIC", str(src), "-o",
                     str(tmp)])
