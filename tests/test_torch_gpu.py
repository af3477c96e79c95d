"""The CUDA kernels of arpack_ng_tpu_torch against their plain PyTorch
twins on a CUDA card (marker ``gpu``; skipped without a card).

The file imports neither JAX nor the JAX package, so it runs on a machine
with only PyTorch and the CUDA toolkit; ``tests/conftest.py`` imports JAX,
so run it without the conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import numpy as np  # noqa: E402

from arpack_ng_tpu_torch.models import corpus  # noqa: E402
from arpack_ng_tpu_torch.ops import (  # noqa: E402
    cuda_cgs, cuda_dia, cuda_psell, cuda_rot, cuda_sel, psell)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(dev, sdt):
    store = getattr(torch, sdt)
    acc = torch.float64 if store == torch.float64 else torch.float32
    g = torch.Generator(device=dev).manual_seed(0)
    V = torch.randn(32, 1 << 16, generator=g, device=dev,
                    dtype=acc).to(store)
    tol = dict(rtol=1e-2, atol=1e-1) if store == torch.bfloat16 else \
        dict(rtol=1e-5, atol=1e-3)
    return g, V, acc, tol


def _sel_case(dev, sdt, n):
    # V with n columns (n + 3: rows not 16-byte aligned, the scalar path)
    # and a buffer whose [:n] is aligned and [1:] sits 4 or 8 bytes in
    store = getattr(torch, sdt)
    acc = torch.float64 if store == torch.float64 else torch.float32
    g = torch.Generator(device=dev).manual_seed(4)
    V = torch.randn(32, n, generator=g, device=dev, dtype=acc).to(store)
    buf = torch.randn(n + 1, generator=g, device=dev, dtype=acc)
    tol = dict(rtol=1e-2, atol=1e-1) if store == torch.bfloat16 else \
        dict(rtol=1e-5, atol=1e-3)
    return g, V, buf, tol


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1 << 16, (1 << 16) + 3])
@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "float64"])
def test_sel_kernels_match_twins_on_card(dev, sdt, n):
    # every K 1..32 (masked inside its bucket), rows picked by index, with
    # br and r aligned and at a one-value offset (the scalar path); the
    # update is in place and a zero coefficient skips its row
    g, V, buf, tol = _sel_case(dev, sdt, n)
    for vec in (buf[:n], buf[1:]):
        for K in range(1, 33):
            idx = torch.randperm(32, device=dev, generator=g)[:K].int()
            torch.testing.assert_close(cuda_sel.sel_proj(idx, V, vec),
                                       cuda_sel.sel_proj_plain(idx, V, vec),
                                       **tol)
            s = torch.randn(K, generator=g, device=dev, dtype=vec.dtype)
            s[K // 2] = 0
            for with_norm in (False, True):
                r = vec.clone()
                out = cuda_sel.sel_update(idx, s, r, V, with_norm)
                ref = cuda_sel.sel_update_plain(idx, s, vec.clone(), V,
                                                with_norm)
                if with_norm:
                    torch.testing.assert_close(out[1], ref[1], **tol)
                    out, ref = out[0], ref[0]
                assert out is r
                torch.testing.assert_close(out, ref, **tol)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "float64"])
def test_sel_kernels_repeat_bit_for_bit_on_card(dev, sdt):
    # a fixed grid and summation order: two calls agree bit for bit
    n = (1 << 16) + 3
    g, V, buf, _ = _sel_case(dev, sdt, n)
    for vec in (buf[:n], buf[1:]):
        for K in (3, 8, 21, 32, 40):
            idx = torch.randint(0, 32, (K,), generator=g, device=dev).int()
            s = cuda_sel.sel_proj(idx, V, vec)
            assert torch.equal(s, cuda_sel.sel_proj(idx, V, vec))
            r, nrm = cuda_sel.sel_update(idx, s, vec.clone(), V, True)
            r2, nrm2 = cuda_sel.sel_update(idx, s, vec.clone(), V, True)
            assert torch.equal(r, r2) and torch.equal(nrm, nrm2)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "float64"])
def test_sel_update_zero_s_returns_r_on_card(dev, sdt):
    # the valid-mask contract: an all-zero s leaves r bit for bit, in place
    n = (1 << 16) + 3
    g, V, buf, _ = _sel_case(dev, sdt, n)
    for vec in (buf[:n], buf[1:]):
        for K in (1, 8, 13, 32):
            idx = torch.randperm(32, device=dev, generator=g)[:K].int()
            s = torch.zeros(K, dtype=vec.dtype, device=dev)
            r = vec.clone()
            out, nrm = cuda_sel.sel_update(idx, s, r, V, True)
            assert out is r and torch.equal(r, vec)
            torch.testing.assert_close(nrm, torch.dot(vec, vec), rtol=1e-5,
                                       atol=0)
            assert torch.equal(cuda_sel.sel_update(idx, s, vec.clone(), V),
                               vec)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "float64"])
def test_rotate_rows_matches_twin_on_card(dev, sdt):
    g, V, acc, tol = _case(dev, sdt)
    Q = torch.linalg.qr(torch.randn(32, 32, dtype=torch.float64))[0]
    Q = Q.to(device=dev, dtype=acc).contiguous()  # QR returns column-major
    for rows in (8, 16, 24, 32):
        out = cuda_rot.rotate_rows(Q, V.clone(), rows)
        ref = cuda_rot.rotate_rows_plain(Q, V.clone(), rows)
        torch.testing.assert_close(out.to(acc), ref.to(acc), **tol)
        assert torch.equal(out[rows:], V[rows:])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1 << 16, (1 << 16) + 3])
@pytest.mark.parametrize("ncv", [20, 32, 40])
@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "float64"])
def test_rotate_rows_every_row_count_on_card(dev, sdt, ncv, n):
    # every rows 1..ncv: the register buckets (ncv 20 and 32; 16-byte words
    # at n = 2^16, single columns at n + 3, whose rows are not 16-byte
    # aligned) and the shared-memory slab kernel (ncv 40); two calls agree
    # bit for bit and rows past `rows` are untouched
    store = getattr(torch, sdt)
    acc = torch.float64 if store == torch.float64 else torch.float32
    g = torch.Generator(device=dev).manual_seed(5)
    V = torch.randn(ncv, n, generator=g, device=dev, dtype=acc).to(store)
    Q = torch.linalg.qr(torch.randn(ncv, ncv, dtype=torch.float64))[0]
    Q = Q.to(device=dev, dtype=acc).contiguous()
    tol = dict(rtol=1e-2, atol=1e-1) if store == torch.bfloat16 else \
        dict(rtol=1e-5, atol=1e-3)
    for rows in range(1, ncv + 1):
        out = cuda_rot.rotate_rows(Q, V.clone(), rows)
        assert torch.equal(out, cuda_rot.rotate_rows(Q, V.clone(), rows))
        ref = cuda_rot.rotate_rows_plain(Q, V.clone(), rows)
        torch.testing.assert_close(out[:rows].to(acc), ref[:rows].to(acc),
                                   **tol)
        assert torch.equal(out[rows:], V[rows:])
    torch.cuda.synchronize()


def _cgs_case(dev, sdt, n):
    store = getattr(torch, sdt)
    acc = torch.float64 if store == torch.float64 else torch.float32
    g = torch.Generator(device=dev).manual_seed(3)
    V = torch.randn(32, n, generator=g, device=dev, dtype=acc).to(store)
    buf = torch.randn(n + 1, generator=g, device=dev, dtype=acc)
    # dots of 2^16 terms reach ~1e3: the atol covers the summation order
    tol = dict(rtol=1e-2, atol=1e-1) if store == torch.bfloat16 else \
        dict(rtol=1e-5, atol=1e-3)
    return V, buf, tol


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1 << 16, (1 << 16) + 3])
@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "float64"])
def test_cgs_kernels_match_twins_on_card(dev, sdt, n):
    # every row count 1..32, with w aligned (16-byte
    # vectors, n % vec values in the tail) and at a one-value offset (the
    # scalar path); w is never written
    V, buf, tol = _cgs_case(dev, sdt, n)
    keep = buf.clone()
    for w in (buf[:n], buf[1:]):
        for rows in range(1, 33):
            h = cuda_cgs.cgs_proj(V, w, rows)
            torch.testing.assert_close(
                h, cuda_cgs.cgs_proj_plain(V, w, rows), **tol)
            for with_norm in (False, True):
                out = cuda_cgs.cgs_update(w, h, V, with_norm)
                ref = cuda_cgs.cgs_update_plain(w, h, V, with_norm)
                if with_norm:
                    torch.testing.assert_close(out[1], ref[1], **tol)
                    out, ref = out[0], ref[0]
                torch.testing.assert_close(out, ref, **tol)
    assert torch.equal(buf, keep)  # out of place
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "float64"])
def test_cgs_kernels_repeat_bit_for_bit_on_card(dev, sdt):
    # a fixed grid and summation order: two calls agree bit for bit
    V, buf, _ = _cgs_case(dev, sdt, (1 << 16) + 3)
    for w in (buf[:-1], buf[1:]):
        for rows in (3, 8, 21, 32):
            h = cuda_cgs.cgs_proj(V, w, rows)
            assert torch.equal(h, cuda_cgs.cgs_proj(V, w, rows))
            r, nrm = cuda_cgs.cgs_update(w, h, V, True)
            r2, nrm2 = cuda_cgs.cgs_update(w, h, V, True)
            assert torch.equal(r, r2) and torch.equal(nrm, nrm2)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "float64"])
def test_cgs_update_zero_h_returns_w_on_card(dev, sdt):
    V, buf, _ = _cgs_case(dev, sdt, (1 << 16) + 3)
    for w in (buf[:-1], buf[1:]):
        for rows in (1, 8, 13, 32):
            h = torch.zeros(rows, dtype=w.dtype, device=dev)
            r, nrm = cuda_cgs.cgs_update(w, h, V, True)
            assert torch.equal(r, w)
            torch.testing.assert_close(nrm, torch.dot(w, w), rtol=1e-5,
                                       atol=0)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dia_matvec_matches_twin_on_card(dev, dtype):
    n, n_pad = 60_000, 60_416
    offs = torch.tensor([-245, -1, 0, 1, 245], device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    dtab = torch.randn(5, n_pad, generator=g, device=dev, dtype=dtype)
    x = torch.randn(n_pad, generator=g, device=dev, dtype=dtype)
    y = cuda_dia.dia_matvec(offs, dtab, x, n)
    # the twin's order and rounding: equal bit for bit
    assert torch.equal(y, cuda_dia.dia_matvec_plain(offs, dtab, x, n))
    assert not y[n:].any()
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_psell_matvec_matches_twin_on_card(dev, dtype):
    a = corpus.fem_triangulation(20_000).astype(dtype)
    for pk in (psell.pack_psell(a), psell.pack_psell_uniform(a)):
        tiles = cuda_psell.psell_tiles(pk, dev)
        x = torch.from_numpy(np.random.default_rng(2).standard_normal(
            a.shape[0]).astype(dtype)).to(dev)
        y = cuda_psell.psell_matvec(tiles, x)
        ref = cuda_psell.psell_matvec_plain(tiles, x)
        tol = dict(rtol=1e-12, atol=1e-12) if dtype == np.float64 else \
            dict(rtol=2e-5, atol=2e-4)
        torch.testing.assert_close(y, ref, **tol)
        np.testing.assert_allclose(y[: a.shape[0]].cpu().numpy(),
                                   a @ x.cpu().numpy(), **tol)
        # deterministic: a fixed order per output, no atomics
        assert torch.equal(y, cuda_psell.psell_matvec(tiles, x))
    torch.cuda.synchronize()


def _psell_cases():
    # a hub row of the power-law graph spans several tiles (one per x panel)
    # and, within one, several warps; the uniform packing pads chunks with
    # all-zero tiles, and n_pad two chunks past n leaves chunks empty
    fem = corpus.fem_triangulation(20_000)
    return (("powerlaw", corpus.powerlaw_graph(100_000)),
            ("saddle", corpus.saddle_point(100)),
            ("fem", fem))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_psell_matvec_corpus_on_card(dev, dtype):
    tol = dict(rtol=1e-12, atol=1e-12) if dtype == np.float64 else \
        dict(rtol=2e-5, atol=2e-4)
    for name, a in _psell_cases():
        a = a.astype(dtype)
        n = a.shape[0]
        n_pad = -(-n // psell.CHUNK) * psell.CHUNK + 2 * psell.CHUNK
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            n).astype(dtype)).to(dev)
        ax = a @ x.cpu().numpy()
        scale = max(1.0, float(np.abs(ax).max()))
        for pk in (psell.pack_psell(a, n_pad),
                   psell.pack_psell_uniform(a, n_pad)):
            tiles = cuda_psell.psell_tiles(pk, dev)
            lens = tiles.tile_len.cpu().numpy()
            assert (lens == 0).any() and (lens > 0).any(), name
            y = cuda_psell.psell_matvec(tiles, x)
            torch.testing.assert_close(
                y, cuda_psell.psell_matvec_plain(tiles, x), rtol=tol["rtol"],
                atol=tol["atol"] * scale)
            np.testing.assert_allclose(y[:n].cpu().numpy(), ax,
                                       rtol=tol["rtol"],
                                       atol=tol["atol"] * scale)
            assert not y[n:].any(), name
            assert torch.equal(y, cuda_psell.psell_matvec(tiles, x)), name
    torch.cuda.synchronize()
