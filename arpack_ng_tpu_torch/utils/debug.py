"""Per-module trace levels: the ``/debug/`` common block of arpack-ng
(debug.h:8-16, semantics in DOCUMENTS/debug.doc); port of
``arpack_ng_tpu/utils/debug.py``.

One message level per routine family (``mgetv0, maupd, maup2, maitr,
meigt, mapps, mgets, meupd``; the reference's s/n/c twins collapsed, as
the drivers are dtype-parametric), the output unit ``logfil`` and the print
width ``ndigit``, with :meth:`DebugConfig.set_all` for the command line's
``--debug`` and the ``ivout``/``dvout``/``dmout`` printers of UTIL/.

Every restart loop of this package reaches the host once per cycle, so
the reference's in-trace hook (``device_trace``) becomes a plain host
print, gated like :func:`trace`: the device loop prints from the packet it
reads anyway, and a level left at 0 costs nothing.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Any

import numpy as np


@dataclasses.dataclass
class DebugConfig:
    logfil: Any = None     # file-like; None -> stderr (reference: unit 6)
    ndigit: int = 6        # print precision
    mgetv0: int = 0        # start-vector generation
    maupd: int = 0         # the driver: its statistics summary at the end
    maup2: int = 0         # per-cycle dumps of the restart loop
    maitr: int = 0         # the factorization extension
    meigt: int = 0         # eigenvalues of the projected matrix
    mapps: int = 0         # the implicit shifts
    mgets: int = 0         # shift selection
    meupd: int = 0         # extraction

    def set_all(self, level: int) -> None:
        """Set every message level (the ``m*`` fields) to ``level``."""
        for f in dataclasses.fields(self):
            if f.name.startswith("m"):
                setattr(self, f.name, level)


#: Process-wide debug configuration (the ``/debug/`` common-block analog).
debug = DebugConfig()


def _out():
    return debug.logfil if debug.logfil is not None else sys.stderr


def ivout(label: str, values) -> None:
    """Integer vector print (UTIL/ivout.f analog)."""
    vals = np.atleast_1d(np.asarray(values))
    print(f" {label}\n   " + "  ".join(str(int(v)) for v in vals),
          file=_out())


def dvout(label: str, values) -> None:
    """Real/complex vector print (UTIL/dvout.f / UTIL/zvout.f analog)."""
    vals = np.atleast_1d(np.asarray(values))
    with np.printoptions(precision=debug.ndigit, suppress=False):
        print(f" {label}\n   {vals}", file=_out())


def dmout(label: str, mat) -> None:
    """Matrix print (UTIL/dmout.f analog)."""
    with np.printoptions(precision=debug.ndigit, suppress=False):
        print(f" {label}\n{np.asarray(mat)}", file=_out())


def trace(level: int, threshold: int, fmt: str, **kw) -> None:
    """Print ``fmt.format(**kw)`` when ``level > threshold``; array
    arguments print with ``debug.ndigit`` digits (UTIL/dvout.f analog)."""
    if level > threshold:
        with np.printoptions(precision=debug.ndigit, suppress=False):
            print(" " + fmt.format(**kw), file=_out())
