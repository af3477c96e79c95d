"""Per-module trace levels: the ``/debug/`` common block of arpack-ng
(debug.h:8-16), as far as the symmetric driver uses it.

The restart loop of this package runs on the host, so the reference
package's in-trace hook (``device_trace``) becomes a plain host print,
gated like ``trace``.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Any

import numpy as np


@dataclasses.dataclass
class DebugConfig:
    logfil: Any = None     # file-like; None -> stderr
    ndigit: int = 6        # print precision
    maup2: int = 0         # per-cycle dumps of the restart loop
    meigt: int = 0         # eigenvalues of the projected matrix


#: Process-wide debug configuration (the ``/debug/`` common-block analog).
debug = DebugConfig()


def _out():
    return debug.logfil if debug.logfil is not None else sys.stderr


def trace(level: int, threshold: int, fmt: str, **kw) -> None:
    """Print ``fmt.format(**kw)`` when ``level > threshold``; array
    arguments print with ``debug.ndigit`` digits (UTIL/dvout.f analog)."""
    if level > threshold:
        with np.printoptions(precision=debug.ndigit, suppress=False):
            print(" " + fmt.format(**kw), file=_out())
