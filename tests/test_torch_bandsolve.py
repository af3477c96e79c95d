"""Block cyclic reduction of ``arpack_ng_tpu_torch.ops.bandsolve`` against
``arpack_ng_tpu/ops/bandsolve.py`` (the cases of tests/test_bandsolve.py:
38-124), on the same seeded numpy inputs:

* the host factorization (``_blocks_from_ab``, ``_realify_blocks``,
  ``_cr_factor``): every level array within 1e-14 of the reference's;
* ``BandedFactor.solve`` / ``solve_parts``: float64 solutions within 1e-12
  relative of the reference's, and each against scipy's
  ``solve_banded`` at the reference test's bound; the same method, the
  same refusals (``ValueError``) and the same probe residual;
* the two device forms of the sweeps (full-length DIA, compacted): the
  same solve within 1e-12 relative, the compacted form forced by setting
  ``_DIA_CR_MAX_BYTES`` on an instance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from scipy.linalg import solve_banded  # noqa: E402

from arpack_ng_tpu.ops import bandsolve as jb  # noqa: E402
from arpack_ng_tpu_torch.ops import bandsolve as pb  # noqa: E402
from arpack_ng_tpu_torch.ops import cuda_dia  # noqa: E402

#: float64 solves: port against reference, and the two device forms
REL64 = 1e-12


def _toeplitz_band(n, diags):
    """Band storage from {offset: value}."""
    kl = -min(diags)
    ku = max(diags)
    ab = np.zeros((kl + ku + 1, n))
    for d, v in diags.items():
        row = ku - d
        if d >= 0:
            ab[row, d:] = v
        else:
            ab[row, : n + d] = v
    return ab, kl, ku


def _lap(n):
    return _toeplitz_band(n, {-1: -1.0, 0: 2.0, 1: -1.0})


def _rel(x, ref):
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def _dominant(rng, n, kl, ku):
    ab = rng.standard_normal((kl + ku + 1, n))
    ab[ku] += 4.0 + kl + ku              # diagonally dominant
    return ab


def _compact(ab, kl, ku, **kw):
    """A factor built with the DIA form's gate at 0 bytes on the
    instance: the compacted form."""
    f = pb.BandedFactor.__new__(pb.BandedFactor)
    f._DIA_CR_MAX_BYTES = 0
    f.__init__(ab, kl, ku, device="cpu", **kw)
    return f


def _solve_both(ab, kl, ku, rhs, **kw):
    fj = jb.BandedFactor(ab, kl, ku, **kw)
    fp = pb.BandedFactor(ab, kl, ku, device="cpu", **kw)
    xj = np.asarray(fj.solve(jnp.asarray(rhs)))
    xp = fp.solve(torch.from_numpy(rhs)).numpy()
    return fj, fp, xj, xp


class TestHostFactor:
    @pytest.mark.parametrize("n,kl,ku", [(50, 1, 1), (257, 3, 3),
                                         (1000, 2, 5), (7, 2, 2)])
    def test_levels_equal_reference(self, n, kl, ku, rng):
        ab = _dominant(rng, n, kl, ku)
        b = max(kl, ku)
        got = pb._blocks_from_ab(ab, kl, ku, n, b)
        ref = jb._blocks_from_ab(ab, kl, ku, n, b)
        assert got[3] == ref[3]
        for x, y in zip(got[:3], ref[:3]):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-14)
        lv, root = pb._cr_factor(*got[:3])
        lv_j, root_j = jb._cr_factor(*ref[:3])
        assert len(lv) == len(lv_j) == int(np.log2(got[3]))
        np.testing.assert_allclose(root, root_j, rtol=1e-14, atol=1e-14)
        for lev, lev_j in zip(lv, lv_j):
            for x, y in zip(lev, lev_j):
                np.testing.assert_allclose(x, y, rtol=1e-14, atol=1e-14)

    def test_realified_levels_equal_reference(self, rng):
        n = 300
        ab = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
        ab[1] += 5.0
        got = pb._realify_blocks(*pb._blocks_from_ab(ab, 1, 1, n, 1)[:3])
        ref = jb._realify_blocks(*jb._blocks_from_ab(ab, 1, 1, n, 1)[:3])
        lv, root = pb._cr_factor(*got)
        lv_j, root_j = jb._cr_factor(*ref)
        np.testing.assert_allclose(root, root_j, rtol=1e-14, atol=1e-14)
        for lev, lev_j in zip(lv, lv_j):
            for x, y in zip(lev, lev_j):
                np.testing.assert_allclose(x, y, rtol=1e-14, atol=1e-14)

    def test_shifted_band_equals_reference(self):
        ab, kl, ku = _lap(64)
        mb, _, _ = _toeplitz_band(64, {-1: 1 / 6, 0: 4 / 6, 1: 1 / 6})
        for sigma, m in ((0.7, mb), (1.5 + 0.4j, None), (0.3 - 2j, mb)):
            got = pb.shifted_band(ab, kl, ku, m, 1, 1, sigma, 64)
            ref = jb.shifted_band(ab, kl, ku, m, 1, 1, sigma, 64)
            assert got[1:] == ref[1:]
            assert got[0].dtype == ref[0].dtype
            np.testing.assert_array_equal(got[0], ref[0])


class TestBCRSolve:
    @pytest.mark.parametrize("n,kl,ku", [(50, 1, 1), (257, 3, 3),
                                         (1000, 2, 5), (4097, 8, 8),
                                         (7, 2, 2)])
    def test_solve_matches_reference(self, n, kl, ku, rng):
        ab = _dominant(rng, n, kl, ku)
        rhs = rng.standard_normal(n)
        fj, fp, xj, xp = _solve_both(ab, kl, ku, rhs, dtype=np.float64,
                                     refine=1)
        assert fp.method == fj.method == "cr"
        assert fp.form == ("dia" if fj._dia_fwd is not None else "compact")
        assert fp.probe_residual == pytest.approx(fj.probe_residual,
                                                  rel=1e-12, abs=1e-30)
        assert _rel(xp, xj) < REL64
        assert _rel(xp, solve_banded((kl, ku), ab, rhs)) < 1e-12

    def test_indefinite_interior_shift(self, rng):
        n = 2048
        ab, kl, ku = _lap(n)
        sb, skl, sku = pb.shifted_band(ab, kl, ku, None, 0, 0, 1.7, n)
        rhs = rng.standard_normal(n)
        _, fp, xj, xp = _solve_both(sb, skl, sku, rhs, dtype=np.float64,
                                    refine=2)
        assert fp.method == "cr"
        assert _rel(xp, xj) < REL64
        assert _rel(xp, solve_banded((skl, sku), sb, rhs)) < 1e-10

    def test_breakdown_falls_back_to_pivoted_lu(self, rng):
        # sigma at the scalar-CR breakdown point: the probe switches to
        # the host pivoted LU, a host call on the CPU as on the card
        n = 3000
        ab, kl, ku = _lap(n)
        sb, skl, sku = pb.shifted_band(ab, kl, ku, None, 0, 0, 2.0, n)
        rhs = rng.standard_normal(n)
        _, fp, xj, xp = _solve_both(sb, skl, sku, rhs, dtype=np.float64)
        assert fp.method == "lu" and fp.form is None
        assert _rel(xp, xj) < REL64
        assert _rel(xp, solve_banded((skl, sku), sb, rhs)) < 1e-12

    def test_cr_only_raises_on_breakdown(self):
        n = 512
        ab, kl, ku = _lap(n)
        sb, skl, sku = pb.shifted_band(ab, kl, ku, None, 0, 0, 2.0, n)
        for mod, kw in ((jb, {}), (pb, dict(device="cpu"))):
            with pytest.raises(ValueError, match="cyclic reduction broke"):
                mod.BandedFactor(sb, skl, sku, dtype=np.float64,
                                 method="cr", **kw)

    def test_pseudospectrum_overflow_raises(self):
        n = 3000
        ab, kl, ku = _toeplitz_band(n, {-1: -1.3, 0: 2.0, 1: -0.7})
        sb, skl, sku = pb.shifted_band(ab, kl, ku, None, 0, 0, 0.4, n)
        for mod, kw in ((jb, {}), (pb, dict(device="cpu"))):
            with pytest.raises(ValueError, match="singular"):
                mod.BandedFactor(sb, skl, sku, dtype=np.float64, **kw)

    def test_unknown_method_raises(self):
        ab, kl, ku = _lap(64)
        with pytest.raises(ValueError, match="unknown banded solve"):
            pb.BandedFactor(ab, kl, ku, dtype=np.float64, method="qr",
                            device="cpu")

    @pytest.mark.parametrize("method", ["auto", "lu"])
    def test_realified_complex_shift(self, method, rng):
        n = 2048
        ab, kl, ku = _lap(n)
        sb, skl, sku = pb.shifted_band(ab, kl, ku, None, 0, 0, 1.5 + 0.4j, n)
        fj = jb.BandedFactor(sb, skl, sku, dtype=np.float64, refine=1,
                             method=method)
        fp = pb.BandedFactor(sb, skl, sku, dtype=np.float64, refine=1,
                             method=method, device="cpu")
        assert fp.realified and fp.method == fj.method
        rhs, rhs_i = rng.standard_normal(n), rng.standard_normal(n)
        xc = solve_banded((skl, sku), sb, rhs + 1j * rhs_i)
        for im in (None, rhs_i):
            jr, ji = fj.solve_parts(jnp.asarray(rhs), None if im is None
                                    else jnp.asarray(im))
            xr, xi = fp.solve_parts(torch.from_numpy(rhs), None if im is None
                                    else torch.from_numpy(im))
            got = xr.numpy() + 1j * xi.numpy()
            assert _rel(got, np.asarray(jr) + 1j * np.asarray(ji)) < REL64
        assert _rel(got, xc) < 1e-9
        # solve() of a realified factor is the complex solve of a real rhs
        full = fp.solve(torch.from_numpy(rhs)).numpy()
        assert _rel(full, solve_banded((skl, sku), sb,
                                       rhs.astype(np.complex128))) < 1e-9

    def test_complex_native_factor(self, rng):
        n = 600
        ab = (rng.standard_normal((3, n))
              + 1j * rng.standard_normal((3, n)))
        ab[1] += 5.0
        rhs = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        _, fp, xj, xp = _solve_both(ab, 1, 1, rhs, dtype=np.complex128)
        assert not fp.realified and fp.method == "cr"
        assert _rel(xp, xj) < REL64
        assert _rel(xp, solve_banded((1, 1), ab, rhs)) < 1e-12

    def test_float32_with_refinement(self, rng):
        # float32 apply of a float64 factor, as the reference's test: the
        # reference's bound against scipy, and the two packages within
        # the float32 apply's rounding of each other
        n = 4096
        ab, kl, ku = _lap(n)
        sb, skl, sku = pb.shifted_band(ab, kl, ku, None, 0, 0, 0.5, n)
        rhs = rng.standard_normal(n).astype(np.float32)
        _, fp, xj, xp = _solve_both(sb, skl, sku, rhs, dtype=np.float32,
                                    refine=2)
        assert xp.dtype == np.float32
        xs = solve_banded((skl, sku), sb, rhs.astype(np.float64))
        assert _rel(xp, xs) < 5e-5
        assert _rel(xp, xj) < 5e-5

    def test_solve_pads_and_counts_no_launch_on_cpu(self, rng):
        # a padded vector in, zero past n out; the CPU path runs the DIA
        # twin, which counts no kernel launch
        n, n_pad = 300, 384
        ab = _dominant(rng, n, 2, 2)
        f = pb.BandedFactor(ab, 2, 2, dtype=np.float64, device="cpu")
        v = torch.zeros(n_pad, dtype=torch.float64)
        v[:n] = torch.from_numpy(rng.standard_normal(n))
        before = cuda_dia.dia_matvec.launches
        x = f.solve(v)
        assert cuda_dia.dia_matvec.launches == before
        assert x.shape == (n_pad,) and not x[n:].any()
        assert _rel(x[:n].numpy(), solve_banded((2, 2), ab,
                                                v[:n].numpy())) < 1e-12


class TestBothForms:
    """The full-length DIA form and the compacted form give one solve."""

    @pytest.mark.parametrize("case", ["dominant", "interior", "wide"])
    def test_real(self, case, rng):
        if case == "dominant":
            n, kl, ku = 1000, 2, 5
            ab = _dominant(rng, n, kl, ku)
        elif case == "interior":
            n = 2048
            ab, kl, ku = pb.shifted_band(*_lap(n), None, 0, 0, 1.7, n)
        else:
            n, kl, ku = 4097, 8, 8
            ab = _dominant(rng, n, kl, ku)
        rhs = torch.from_numpy(rng.standard_normal(n))
        fd = pb.BandedFactor(ab, kl, ku, dtype=np.float64, refine=2,
                             device="cpu")
        fc = _compact(ab, kl, ku, dtype=np.float64, refine=2)
        assert (fd.form, fc.form) == ("dia", "compact")
        assert fd._dia_fwd is not None and fc._dia_fwd is None
        assert _rel(fc.solve(rhs).numpy(), fd.solve(rhs).numpy()) < REL64

    def test_realified(self, rng):
        n = 2048
        sb, skl, sku = pb.shifted_band(*_lap(n), None, 0, 0, 1.5 + 0.4j, n)
        fd = pb.BandedFactor(sb, skl, sku, dtype=np.float64, device="cpu")
        fc = _compact(sb, skl, sku, dtype=np.float64)
        assert (fd.form, fc.form) == ("dia", "compact")
        rhs = torch.from_numpy(rng.standard_normal(n))
        dr, di = fd.solve_parts(rhs)
        cr, ci = fc.solve_parts(rhs)
        assert _rel(torch.complex(cr, ci).numpy(),
                    torch.complex(dr, di).numpy()) < REL64

    def test_complex_native(self, rng):
        n = 600
        ab = (rng.standard_normal((3, n))
              + 1j * rng.standard_normal((3, n)))
        ab[1] += 5.0
        fd = pb.BandedFactor(ab, 1, 1, dtype=np.complex128, device="cpu")
        fc = _compact(ab, 1, 1, dtype=np.complex128)
        rhs = torch.from_numpy(rng.standard_normal(n)
                               + 1j * rng.standard_normal(n))
        assert _rel(fc.solve(rhs).numpy(), fd.solve(rhs).numpy()) < REL64
