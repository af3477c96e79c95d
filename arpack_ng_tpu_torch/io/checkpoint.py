"""Checkpoint / resume (port of ``arpack_ng_tpu/io/checkpoint.py``).

Reference protocol: the RCI state *is* the checkpoint (pass ``info != 0``
into Xsaupd with a caller-saved ``resid``, SRC/dsaupd.f:130-136; the C++
layer's ``dumpToFile``/``restartFromFile``, arpackSolver.hpp:153-154; the
CLI's ``--restart``).  Here the whole :class:`FactorizationState` is
written (resid AND the factorization V/H and the counters), so a resume
continues mid-factorization; ``save_resid_only=True`` keeps the
reference's semantics (a new solve seeded with the saved resid).

The file is the reference package's, so a checkpoint moves either way: an
``.npz`` with a ``__meta__`` JSON (version 1, the config echo checked on
load), the same array names, ``counts`` stacked in ``OpCounts`` field
order (a file with fewer counters resumes the missing ones from zero), V
in the layout the reference's ``v_is_3d`` picks for the config
(``(ncv, n_pad // 128, 128)`` when ``n_pad % 128 == 0`` and
``cgs_kernel != 'pallas'``, else ``(ncv, n_pad)``; either layout loads),
and ``key`` a ``uint32[2]``.

The key: the reference stores its PRNG key's data (threefry:
``uint32[2]``, ``[0, seed]`` for a fresh ``key(seed)``).  This package's
restart vectors come from a ``torch.Generator``; the file carries its
seed as ``[seed >> 32, seed & 0xffffffff]`` and a load seeds the state's
generator from the key's words (any shape), so the same file always
resumes the same way.  The generator's advance is not carried: a solve
that drew restart vectors after an invariant subspace (dgetv0 after a
breakdown) before the dump draws the same vectors again after a resume,
so from its next breakdown on it differs from the solve never
interrupted.  A solve with no breakdown before the dump resumes to the
unbroken solve.

Dump cadence: the hybrid driver and the host loops expose every cycle;
the device loop (``core/device_sym.FusedSymSolver``) hands back a state at
a cycle boundary (``multi``).  The hybrid driver's exit state holds the
cycles before the exit cycle (its factorization before the shifts), as
the reference's does: a run stopped at ``max_iter`` and resumed under a
larger one repeats the unbroken solve.  The port updates
``state.V`` in place: :func:`save_state` copies everything to the host
before it returns, so a solve may go on from the saved state.
"""
from __future__ import annotations

import hashlib
import json
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import IRAMConfig
from ..core.arnoldi import FactorizationState
from ..utils import dtypes as _dt
from ..utils.device import DEFAULT, require
from ..utils.stats import OpCounts

_FORMAT_VERSION = 1
#: the config fields a load checks against the caller's config
_CHECKED = ("n", "nev", "ncv", "which", "bmat", "mode", "symmetric",
            "n_pad")


def v_is_3d(cfg: IRAMConfig) -> bool:
    """The reference's basis layout rule (unsharded): the per-row-tiled
    ``(ncv, n_pad // 128, 128)`` layout unless the Pallas CGS kernels are
    asked for or n_pad is not a multiple of 128."""
    return cfg.cgs_kernel != "pallas" and cfg.n_pad % 128 == 0


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values in a host array of its own; bfloat16 as the
    two-byte void values numpy writes for the reference's bfloat16."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _device(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def key_of(gen: torch.Generator) -> np.ndarray:
    """The ``uint32[2]`` key written for a generator: its seed's words."""
    seed = int(gen.initial_seed()) & (2 ** 64 - 1)
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def seed_of(key) -> int:
    """The generator seed of a stored key: the two words of a ``uint32[2]``
    key as one 64-bit integer (the inverse of :func:`key_of`), any other
    key's bytes hashed to 64 bits."""
    k = np.asarray(key)
    if k.dtype == np.uint32 and k.shape == (2,):
        return (int(k[0]) << 32) | int(k[1])
    digest = hashlib.blake2b(np.ascontiguousarray(k).tobytes(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little")


def save_state(path, state: FactorizationState, cfg: IRAMConfig,
               save_resid_only: bool = False) -> None:
    """Write the solver state (and the config echo) to ``path`` (.npz)."""
    arrays = {
        "resid": _host(state.resid),
        "rnorm": np.asarray(state.rnorm),
        "key": key_of(state.gen),
    }
    if not save_resid_only:
        V = _host(state.V)
        if v_is_3d(cfg):
            V = V.reshape(V.shape[0], -1, 128)
        arrays.update({
            "V": V,
            "H": np.array(state.H),
            "b_resid": _host(state.b_resid),
            "k": np.int32(state.k),
            "nev_cur": np.int32(state.nev_cur),
            "iter": np.int32(state.iter),
            "info": np.int32(state.info),
            "counts": np.asarray(list(state.counts), np.int32),
        })
    meta = dict(version=_FORMAT_VERSION, n=cfg.n, nev=cfg.nev, ncv=cfg.ncv,
                which=cfg.which, bmat=cfg.bmat, mode=cfg.mode,
                symmetric=cfg.symmetric, dtype=np.dtype(cfg.dtype).name,
                n_pad=cfg.n_pad, resid_only=save_resid_only)
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load_state(path, cfg: Optional[IRAMConfig] = None, device=DEFAULT
               ) -> Tuple[Optional[FactorizationState], dict]:
    """Load a checkpoint written by either package onto ``device`` (the
    card unless told otherwise).  Returns ``(state | None, meta)``.

    ``state`` is None for a resid-only checkpoint: pass ``meta['resid']``
    (a numpy array) as ``v0`` to a fresh solve, the reference's info != 0
    protocol.  With ``cfg``, a config that differs from the file's echo in
    n, nev, ncv, which, bmat, mode, symmetric or n_pad raises
    ``ValueError``."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        if cfg is not None:
            for f in _CHECKED:
                if getattr(cfg, f) != meta[f]:
                    raise ValueError(
                        f"checkpoint/config mismatch on {f}: "
                        f"{meta[f]} vs {getattr(cfg, f)}")
        if meta["resid_only"]:
            meta["resid"] = z["resid"]
            return None, meta
        device = require(device)
        # counters are stored positionally; older checkpoints may carry
        # fewer of them: missing trailing counters resume from zero
        cvals = [int(c) for c in np.asarray(z["counts"]).reshape(-1)]
        nf = len(OpCounts._fields)
        counts = OpCounts(*(cvals + [0] * (nf - len(cvals)))[:nf])
        H = np.array(z["H"])
        V = np.asarray(z["V"])
        state = FactorizationState(
            V=_device(V.reshape(V.shape[0], -1), device),
            H=H,
            resid=_device(z["resid"], device),
            b_resid=_device(z["b_resid"], device),
            rnorm=_dt.real_dtype(H.dtype).type(np.asarray(z["rnorm"])),
            k=int(z["k"]), nev_cur=int(z["nev_cur"]), iter=int(z["iter"]),
            info=int(z["info"]),
            gen=torch.Generator().manual_seed(seed_of(z["key"])),
            counts=counts)
        if meta["bmat"] == "I":
            # one tensor for both, as a solve's own state holds them
            state = state.replace(b_resid=state.resid)
        return state, meta
