"""Factored banded solves: block cyclic reduction (BCR), with a pivoted
banded LU where BCR breaks down (port of ``arpack_ng_tpu/ops/bandsolve.py``).

The reference's banded drivers factor ``A - sigma*M`` with LAPACK's banded
LU and apply it with banded triangular solves (EXAMPLES/BAND/dsband.f:
399-463).  The reference package replaced the O(n)-deep substitution
chain by **block cyclic reduction**, and this port keeps its algorithm
and its host code:

* the band (half-bandwidth b = max(kl, ku)) is a block-tridiagonal matrix
  of b x b blocks; log2(n/b) levels eliminate the odd-indexed blocks;
* the factorization is computed ONCE on the host in float64 (numpy,
  near-verbatim) and held on the device in the target dtype;
* each solve is a forward and a backward sweep over the levels.

Two device forms of the sweeps, as in the reference:

* ``form == 'dia'``: each level's blocks scattered onto full-length
  diagonals at factor time, so a sweep is a chain of DIA products
  (:func:`~arpack_ng_tpu_torch.ops.sparse.dia_matvec_fn`: the kernel of
  ``csrc/dia.cu`` on the card), three per level; the level selectivity
  lives in the zeros of the diagonals.  It costs levels x O(n*b) memory
  and is taken while that stays under ``_DIA_CR_MAX_BYTES``;
* ``form == 'compact'``: the level arrays as they are, applied as
  batched ``einsum`` contractions over strided even/odd views.

Both are torch ops with no host read, so a CUDA graph holds a solve.
Construction measures BCR's relative residual on a float64 probe; where
pivotless reduction breaks down or is too inaccurate, ``method`` becomes
``'lu'``: the host pivoted banded LU (scipy's ``gbtrf``/``gbtrs``),
applied as device -> host -> device (the reference needed
``jax.pure_callback`` for it), which no CUDA graph can hold.

Complex shifts on real problems realify at the block level (each complex
b x b block becomes the real 2b x 2b block [[Re, -Im], [Im, Re]]) and run
:meth:`BandedFactor.solve_parts` in real arithmetic.
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import dtypes as _dt
from ..utils.device import DEFAULT, require


def _blocks_from_ab(ab: np.ndarray, kl: int, ku: int, n: int, b: int,
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """LAPACK band storage -> block-tridiagonal (D, L, U), (m, b, b) each.

    ``ab[ku + i - j, j] == a[i, j]``.  The block count m is padded to a
    power of two with identity diagonal blocks (decoupled rows: pad
    solution stays zero for zero rhs).
    """
    m_logical = -(-n // b)
    m = 1 << max(int(np.ceil(np.log2(max(m_logical, 1)))), 0)
    nb = m * b
    wdtype = (np.complex128 if np.iscomplexobj(ab) else np.float64)
    D = np.zeros((m, b, b), wdtype)
    L = np.zeros((m, b, b), wdtype)
    U = np.zeros((m, b, b), wdtype)
    # pad rows get unit diagonal
    idx = np.arange(nb)
    pad_mask = idx >= n
    bi_all = idx // b
    li_all = idx % b
    D[bi_all[pad_mask], li_all[pad_mask], li_all[pad_mask]] = 1.0
    for d in range(-kl, ku + 1):
        row = ku - d
        if d >= 0:
            i = np.arange(0, n - d)
            vals = ab[row, d:n]
        else:
            i = np.arange(-d, n)
            vals = ab[row, : n + d]
        j = i + d
        bi, li = i // b, i % b
        bj, lj = j // b, j % b
        off = bj - bi                       # in {-1, 0, +1} since |d| <= b
        for tgt, sel in ((D, off == 0), (U, off == 1), (L, off == -1)):
            if np.any(sel):
                tgt[bi[sel], li[sel], lj[sel]] = vals[sel]
    return D, L, U, m


def _realify_blocks(D, L, U):
    """Complex (m,b,b) blocks -> real (m,2b,2b): [[Re,-Im],[Im,Re]]."""
    def conv(B):
        m, b, _ = B.shape
        out = np.zeros((m, 2 * b, 2 * b), np.float64)
        out[:, :b, :b] = B.real
        out[:, :b, b:] = -B.imag
        out[:, b:, :b] = B.imag
        out[:, b:, b:] = B.real
        return out
    return conv(D), conv(L), conv(U)


def _cr_factor(D: np.ndarray, L: np.ndarray, U: np.ndarray):
    """Host float64 BCR factorization.

    Returns ``(levels, root_inv)`` where each level holds the arrays needed
    for one forward-reduction / back-substitution sweep:
    ``(G, H, Dinv_o, Lo, Uo)`` with

    * ``G[i] = L_even[i] @ inv(D_odd[i-1])`` (zero block at i=0),
    * ``H[i] = U_even[i] @ inv(D_odd[i])``,
    * ``Dinv_o`` the pivoted inverses of the eliminated (odd) diagonal
      blocks, ``Lo``/``Uo`` their couplings (for back-substitution).
    """
    levels = []
    m = D.shape[0]
    b = D.shape[1]
    zero = np.zeros((1, b, b), D.dtype)
    while m > 1:
        De, Do = D[0::2], D[1::2]
        Le, Lo = L[0::2], L[1::2]
        Ue, Uo = U[0::2], U[1::2]
        Dinv_o = np.linalg.inv(Do)
        Dinv_left = np.concatenate([zero, Dinv_o[:-1]])   # inv(D_odd[i-1])
        Uo_left = np.concatenate([zero, Uo[:-1]])
        Lo_left = np.concatenate([zero, Lo[:-1]])
        G = Le @ Dinv_left
        H = Ue @ Dinv_o
        D = De - G @ Uo_left - H @ Lo
        L = -G @ Lo_left
        U = -H @ Uo
        levels.append((G, H, Dinv_o, Lo, Uo))
        m //= 2
    root_inv = np.linalg.inv(D[0])
    return levels, root_inv


def _bmv(B, x):
    """Batched block product ``y[i] = B[i] @ x[i]``."""
    return torch.einsum("ibc,ic->ib", B, x)


class BandedFactor:
    """Factored banded matrix with a device-resident ``solve`` on
    ``device`` (the card unless told otherwise).

    The replacement of the reference's ``dgbtrf`` + ``dgbtrs`` pair
    (EXAMPLES/BAND/dsband.f:456-463): host factorization once, each solve
    a log-depth sequence of level sweeps on the device.  After
    construction ``method`` is ``'cr'`` or ``'lu'`` and ``form`` is
    ``'dia'`` or ``'compact'`` for BCR (None for LU).
    """

    #: memory gate for the full-length DIA device form (bytes)
    _DIA_CR_MAX_BYTES = 1.5e9

    def __init__(self, ab, kl: int, ku: int, *, dtype, n: Optional[int] = None,
                 refine: int = 1, probe_tol: float = 1e-8,
                 fallback_tol: float = 1e-6, method: str = "auto",
                 device=DEFAULT):
        ab = np.asarray(ab)
        self.device = require(device)
        self.n = n if n is not None else ab.shape[1]
        self.kl, self.ku = kl, ku
        self.dtype = np.dtype(dtype)
        self.tdtype = _dt.torch_dtype(self.dtype)
        self.refine = int(refine)
        want_complex_factor = np.iscomplexobj(ab)
        self.realified = want_complex_factor and not _dt.is_complex(self.dtype)
        self.method = None
        self.form = None
        self.probe_residual = np.inf
        self._dia_fwd = self._dia_bwd = None
        if method in ("auto", "cr"):
            self._try_cr(ab, kl, ku, want_complex_factor, probe_tol)
        if method == "lu" or (self.method is None and method == "auto") or \
                (self.method == "cr" and self.probe_residual > fallback_tol):
            if method == "cr":
                warnings.warn(
                    f"BCR probe residual {self.probe_residual:.2e} — "
                    "pivotless cyclic reduction is unstable for this shifted "
                    "matrix; results may be poor (method='lu' would use exact "
                    "partial pivoting)", stacklevel=2)
            else:
                # drop any weak CR factor
                self.levels = self._dia_fwd = self._dia_bwd = None
                self.form = None
                self._setup_lu(ab, kl, ku)
        if self.method is None:
            if method == "cr":
                raise ValueError(
                    "pivotless cyclic reduction broke down on this matrix "
                    "(singular reduced block); use method='lu' or 'auto'")
            raise ValueError(f"unknown banded solve method {method!r}")
        self._band_mv = _band_matvec_device(ab, kl, ku, self.n, self.dtype,
                                            self.device)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a.astype(self.dtype))
                                ).to(self.device)

    def _try_cr(self, ab, kl, ku, want_complex_factor, probe_tol):
        """Attempt the pivotless BCR factorization; record probe quality."""
        b = max(kl, ku, 1)
        D, L, U, m = _blocks_from_ab(ab, kl, ku, self.n, b)
        if self.realified:
            D, L, U = _realify_blocks(D, L, U)
            b *= 2
        try:
            with np.errstate(all="ignore"):
                levels, root_inv = _cr_factor(D, L, U)
        except np.linalg.LinAlgError:
            return                                   # singular reduced block
        finite = np.all(np.isfinite(root_inv)) and all(
            np.all(np.isfinite(x)) for lev in levels for x in lev)
        if not finite:
            return
        # float64 probe: how good is BCR alone on this matrix?
        rng = np.random.default_rng(7)
        probe = rng.standard_normal(m * b).astype(np.float64)
        if want_complex_factor and not self.realified:
            probe = probe + 1j * rng.standard_normal(m * b)
        probe = probe.astype(D.dtype)
        with np.errstate(all="ignore"):
            x = self._solve_host(levels, root_inv, probe.reshape(m, b))
            r = (self._blockmv_host(D, L, U, x) - probe.reshape(m, b))
        self.probe_residual = float(np.linalg.norm(r) / np.linalg.norm(probe))
        if not np.isfinite(self.probe_residual):
            self.probe_residual = np.inf
            return
        self.b, self.m = b, m
        # realified factors are real tensors in the (real) target dtype;
        # complex-native factors are held in the complex target dtype
        self.root_inv = self._to_dev(root_inv)
        self.method = "cr"
        if self._setup_cr_dia(levels):
            # the full-length DIA form is active; the compacted factor is
            # not needed on the device
            self.levels = None
            self.form = "dia"
        else:
            self.levels = [tuple(self._to_dev(a) for a in lev)
                           for lev in levels]
            self.form = "compact"
        if self.probe_residual > probe_tol and self.refine == 0:
            warnings.warn(
                f"BCR factorization probe residual {self.probe_residual:.2e}"
                " — shifted matrix is ill-conditioned for pivotless cyclic"
                " reduction; enable refine>=1 (iterative refinement) or use"
                " method='lu'", stacklevel=3)

    def _setup_lu(self, ab, kl, ku):
        """Host pivoted banded LU (the literal dgbtrf/dgbtrs pair,
        EXAMPLES/BAND/dsband.f:456-463), applied as a host call."""
        from scipy.linalg import lapack
        wd = np.complex128 if np.iscomplexobj(ab) else np.float64
        a2 = np.zeros((2 * kl + ku + 1, self.n), wd, order="F")
        a2[kl:, :] = ab[:, : self.n].astype(wd)
        gbtrf, gbtrs = lapack.get_lapack_funcs(("gbtrf", "gbtrs"), (a2,))
        lu, ipiv, info = gbtrf(a2, kl, ku)
        if info != 0:
            raise ValueError(
                "A - sigma*M is numerically singular: sigma appears to be "
                "an eigenvalue; perturb the shift (reference behavior: "
                "LAPACK factorization info>0 aborts the driver)")
        self._lu_data = (lu, ipiv, gbtrs, wd)
        # Overflow probe: a pivoted factorization can succeed while the
        # resolvent itself overflows (exponentially large pseudospectra of
        # nonnormal bands make interior shifts effectively singular).
        probe = np.ones(self.n, wd)
        with np.errstate(all="ignore"):
            x = self._lu_host_solve(probe)
        if not np.all(np.isfinite(x)):
            raise ValueError(
                "A - sigma*M is numerically singular (the solve overflows "
                "float64): sigma lies in the operator's pseudospectrum; "
                "perturb the shift (reference behavior: LAPACK "
                "factorization failure aborts the driver)")
        self.method = "lu"
        self.probe_residual = 0.0

    def _lu_host_solve(self, rhs64):
        lu, ipiv, gbtrs, wd = self._lu_data
        x, info = gbtrs(lu, self.kl, self.ku, np.asarray(rhs64, order="F"),
                        ipiv)
        return x

    # ---- host reference implementations (used for the probe) ------------

    @staticmethod
    def _blockmv_host(D, L, U, x):
        y = np.einsum("ibc,ic->ib", D, x)
        y[1:] += np.einsum("ibc,ic->ib", L[1:], x[:-1])
        y[:-1] += np.einsum("ibc,ic->ib", U[:-1], x[1:])
        return y

    @staticmethod
    def _solve_host(levels, root_inv, f):
        fos = []
        for (G, H, Dinv_o, Lo, Uo) in levels:
            fe, fo = f[0::2], f[1::2]
            fo_left = np.concatenate([np.zeros_like(fo[:1]), fo[:-1]])
            f = fe - np.einsum("ibc,ic->ib", G, fo_left) \
                   - np.einsum("ibc,ic->ib", H, fo)
            fos.append(fo)
        x = (root_inv @ f[0])[None]
        for (G, H, Dinv_o, Lo, Uo), fo in zip(reversed(levels),
                                              reversed(fos)):
            xe = x
            xe_right = np.concatenate([xe[1:], np.zeros_like(xe[:1])])
            rhs = fo - np.einsum("ibc,ic->ib", Lo, xe) \
                     - np.einsum("ibc,ic->ib", Uo, xe_right)
            xo = np.einsum("ibc,ic->ib", Dinv_o, rhs)
            x = np.stack([xe, xo], axis=1).reshape(-1, xe.shape[1])
        return x

    # ---- device path -----------------------------------------------------

    def _setup_cr_dia(self, levels) -> bool:
        """Build the full-length masked-shift (DIA) device form of the
        BCR sweeps.

        Each level's blocks are scattered onto FULL-LENGTH flat diagonals
        at factor time, so every sweep is a chain of contiguous DIA
        products; level selectivity lives in the zeros of the diagonals:

          forward  level l:  F -= G_f . shift(F, -s*b) + H_f . shift(+s*b)
                             (rows j*2^(l+1)*b only; s = 2^l)
          backward level l:  X += Dinv_f . (F - Lo_f . shift(X, -s*b)
                                              - Uo_f . shift(X, +s*b))
                             (rows (2j+1)*2^l*b only)

        The reference chose it because strided compaction was
        pathological on the TPU.  It costs levels*O(n*b) factor memory
        instead of O(n*b); gated by ``_DIA_CR_MAX_BYTES`` (returns False
        -> the compacted form).
        """
        from .sparse import dia_matvec_fn
        m, b = self.m, self.b
        mb = m * b
        itemsize = self.dtype.itemsize

        def scatter(diags, Block, p_blocks, sblk):
            rows_base = p_blocks * b
            for r in range(b):
                rows = rows_base + r
                for c in range(b):
                    vals = Block[:, r, c]
                    if not np.any(vals):
                        continue
                    off = sblk * b + (c - r)
                    d = diags.get(off)
                    if d is None:
                        d = np.zeros(mb, Block.dtype)
                        diags[off] = d
                    d[rows] = vals

        fwd, bwd = [], []
        total = 0
        for lvl, (G, H, Dinv_o, Lo, Uo) in enumerate(levels):
            s = 1 << lvl
            mj = G.shape[0]
            p_e = np.arange(mj) * (2 * s)
            p_o = p_e + s
            df, dlu, dd = {}, {}, {}
            scatter(df, G, p_e, -s)
            scatter(df, H, p_e, +s)
            scatter(dlu, Lo, p_o, -s)
            scatter(dlu, Uo, p_o, +s)
            scatter(dd, Dinv_o, p_o, 0)
            total += (len(df) + len(dlu) + len(dd)) * mb * itemsize
            if total > self._DIA_CR_MAX_BYTES:
                return False
            fwd.append(df)
            bwd.append((dlu, dd))

        def mk(dct):
            offs = sorted(dct)
            return dia_matvec_fn(offs, [dct[o].astype(self.dtype)
                                        for o in offs], mb, mb,
                                 device=self.device)

        self._dia_fwd = [mk(d) for d in fwd]
        self._dia_bwd = [(mk(dlu), mk(dd)) for dlu, dd in bwd]
        return True

    def _cr_solve_dia(self, f):
        """One BCR sweep in the full-length DIA form (see _setup_cr_dia)."""
        F = f.reshape(-1)
        for mv in self._dia_fwd:
            F = F - mv(F)
        X = torch.zeros_like(F)
        X[: self.b] = self.root_inv @ F[: self.b]
        for mv_lu, mv_d in reversed(self._dia_bwd):
            T = F - mv_lu(X)
            X = X + mv_d(T)
        return X.reshape(self.m, self.b)

    def _cr_solve_device(self, f):
        """One BCR sweep on the device. f: (m, b) tensor."""
        if self.form == "dia":
            return self._cr_solve_dia(f)
        fos = []
        for (G, H, Dinv_o, Lo, Uo) in self.levels:
            fe, fo = f[0::2], f[1::2]
            fo_left = torch.cat([torch.zeros_like(fo[:1]), fo[:-1]])
            f = fe - _bmv(G, fo_left) - _bmv(H, fo)
            fos.append(fo)
        x = (self.root_inv @ f[0])[None]
        for (G, H, Dinv_o, Lo, Uo), fo in zip(reversed(self.levels),
                                              reversed(fos)):
            xe = x
            xe_right = torch.cat([xe[1:], torch.zeros_like(xe[:1])])
            rhs = fo - _bmv(Lo, xe) - _bmv(Uo, xe_right)
            xo = _bmv(Dinv_o, rhs)
            x = torch.stack([xe, xo], dim=1).reshape(-1, xe.shape[1])
        return x

    def _pack(self, v):
        """The first n values of a device vector -> (m, b) block layout
        (``(m, b/2)`` for a realified factor: one of the two parts)."""
        bs = self.b // 2 if self.realified else self.b
        out = torch.zeros(self.m * bs, dtype=v.dtype, device=v.device)
        out[: self.n] = v[: self.n]
        return out.reshape(self.m, bs)

    def _unpack(self, x, n_pad):
        """(m, b) -> a length-``n_pad`` vector, zero past n."""
        out = torch.zeros(n_pad, dtype=x.dtype, device=x.device)
        out[: self.n] = x.reshape(-1)[: self.n]
        return out

    def _host_solve(self, rhs):
        """``method == 'lu'``: device -> host gbtrs -> device."""
        wd = self._lu_data[3]
        sol = self._lu_host_solve(rhs[: self.n].cpu().numpy().astype(wd))
        return torch.from_numpy(np.asarray(sol)).to(self.device)

    def solve(self, v):
        """``x ~= inv(S) v`` on padded device vectors (real/complex dtype
        matching the factorization; use :meth:`solve_parts` for the
        realified complex-shift path)."""
        n_pad = v.shape[0]
        if self.realified:
            re, im = self.solve_parts(v)
            return torch.complex(re, im)
        if self.method == "lu":
            out = torch.zeros(n_pad, dtype=self.tdtype, device=v.device)
            out[: self.n] = self._host_solve(v).to(self.tdtype)
            return out
        f = self._pack(v)
        x = self._cr_solve_device(f)
        for _ in range(self.refine):
            # r = f - S x ; packed residual solve, then correct
            r = f - self._pack(self._band_mv(x.reshape(-1)[: self.n]))
            x = x + self._cr_solve_device(r)
        return self._unpack(x, n_pad)

    def solve_parts(self, v_re, v_im=None):
        """Realified solve: real rhs (or re/im pair) -> (x_re, x_im), all
        real device tensors."""
        assert self.realified, "solve_parts requires a realified factor"
        n_pad = v_re.shape[0]
        if self.method == "lu":
            rhs = v_re[: self.n].double()
            if v_im is not None:
                rhs = torch.complex(rhs, v_im[: self.n].double())
            sol = self._host_solve(rhs.to(torch.complex128))
            out = torch.zeros((2, n_pad), dtype=self.tdtype,
                              device=v_re.device)
            out[0, : self.n] = sol.real.to(self.tdtype)
            out[1, : self.n] = sol.imag.to(self.tdtype)
            return out[0], out[1]
        b2 = self.b // 2
        fr = self._pack(v_re)
        fi = self._pack(v_im) if v_im is not None else torch.zeros_like(fr)
        f = torch.cat([fr, fi], dim=1)                  # (m, 2*b2)
        x = self._cr_solve_device(f)
        for _ in range(self.refine):
            xr = x[:, :b2].reshape(-1)[: self.n].contiguous()
            xi = x[:, b2:].reshape(-1)[: self.n].contiguous()
            rr = fr - self._pack(self._band_mv_re(xr, xi))
            ri = fi - self._pack(self._band_mv_im(xr, xi))
            x = x + self._cr_solve_device(torch.cat([rr, ri], dim=1))
        return self._unpack(x[:, :b2], n_pad), self._unpack(x[:, b2:], n_pad)

    # realified refinement needs S (complex) applied to (re, im):
    # S = Sr + i Si ; S (xr + i xi) = (Sr xr - Si xi) + i (Sr xi + Si xr)
    def _band_mv_re(self, xr, xi):
        return self._band_mv[0](xr) - self._band_mv[1](xi)

    def _band_mv_im(self, xr, xi):
        return self._band_mv[0](xi) + self._band_mv[1](xr)


def _band_matvec_device(ab: np.ndarray, kl: int, ku: int, n: int, dtype,
                        device):
    """Unpadded banded matvec closure(s) in the target dtype on ``device``.

    Returns a single callable for real/complex-native factors, or a
    ``(real_part_mv, imag_part_mv)`` pair for realified complex bands.
    """
    from .banded import banded_matvec_fn

    if np.iscomplexobj(ab) and not np.issubdtype(np.dtype(dtype),
                                                 np.complexfloating):
        ab_r = np.ascontiguousarray(ab.real).astype(dtype)
        ab_i = np.ascontiguousarray(ab.imag).astype(dtype)
        return (banded_matvec_fn(ab_r, kl, ku, n, n, device=device),
                banded_matvec_fn(ab_i, kl, ku, n, n, device=device))
    return banded_matvec_fn(ab.astype(dtype), kl, ku, n, n, device=device)


def shifted_band(ab_a, kl_a, ku_a, ab_m, kl_m, ku_m, sigma, n: int):
    """Host band storage of ``A - sigma*M`` (sigma may be complex).

    The band union: kl = max(kl_a, kl_m), ku likewise — the reference
    forms the same combined band before ``dgbtrf``
    (EXAMPLES/BAND/dsband.f:399-455)."""
    complex_out = np.iscomplexobj(ab_a) or (ab_m is not None and
                                            np.iscomplexobj(ab_m)) \
        or complex(sigma).imag != 0.0
    wd = np.complex128 if complex_out else np.float64
    kl = max(kl_a, kl_m if ab_m is not None else 0)
    ku = max(ku_a, ku_m if ab_m is not None else 0)
    out = np.zeros((kl + ku + 1, n), wd)
    # place A
    out[ku - ku_a: ku + kl_a + 1, :] = ab_a.astype(wd)
    if ab_m is not None:
        out[ku - ku_m: ku + kl_m + 1, :] -= sigma * ab_m.astype(wd)
    else:
        out[ku, :] -= sigma
    if not complex_out:
        out = out.real
    return out, kl, ku
