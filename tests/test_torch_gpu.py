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

import torch_dia_cases as dia_cases  # noqa: E402
from arpack_ng_tpu_torch.models import corpus  # noqa: E402
from arpack_ng_tpu_torch.ops import (  # noqa: E402
    cuda_cgs, cuda_dia, cuda_gather, cuda_psell, cuda_rot, cuda_sel, psell)


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


def _gather_case(dev):
    g = torch.Generator(device=dev).manual_seed(6)
    X = torch.randn(2048, 128, generator=g, device=dev)
    cols = torch.randint(0, X.numel(), (16_384 * 128,), generator=g,
                         device=dev, dtype=torch.int32)
    cols[:2] = torch.tensor([0, X.numel() - 1])
    cols[-2:] = torch.tensor([X.numel() - 1, 0])
    lidx = torch.randint(0, 128, (2048, 128), generator=g, device=dev,
                         dtype=torch.int32)
    lidx[0, :2] = torch.tensor([0, 127])
    lidx[-1, -2:] = torch.tensor([127, 0])
    return X, cols, lidx


@pytest.mark.gpu
def test_gather_kernels_match_twins_on_card(dev):
    # a gather does no arithmetic: bit for bit, with indices 0 and n - 1,
    # a tail past the last 16-byte vector and a misaligned index buffer
    X, cols, lidx = _gather_case(dev)
    for c in (cols.view(-1, 128), cols[:1001], cols[1:4098], cols[:3]):
        assert torch.equal(cuda_gather.take_flat(X, c),
                           cuda_gather.take_flat_plain(X, c))
    assert torch.equal(cuda_gather.take_lanes(X, lidx),
                       cuda_gather.take_lanes_plain(X, lidx))
    assert torch.equal(cuda_gather.take_lanes(X[:5], lidx[:5]),
                       cuda_gather.take_lanes_plain(X[:5], lidx[:5]))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("n, offset", [
    (1 << 18, 0),             # the probe's x
    ((1 << 18) + 3, 0),       # n not a multiple of 4
    (1000, 0),                # x in a few L2 lines
    (1 << 20, 0),             # the FEM's x, 4 MiB
    (1 << 18, 1)])            # x 4 bytes past a 16-byte boundary
def test_take_flat_sizes_match_twin_on_card(dev, n, offset):
    # bit for bit: 0 and n - 1 at both ends, nel tails of 1-3 past the last
    # int4 word, misaligned cols views (single values), every launch counted
    g = torch.Generator(device=dev).manual_seed(n + offset)
    x = torch.randn(n + offset, generator=g, device=dev)[offset:]
    cols = torch.randint(0, n, ((1 << 18) + 7,), generator=g, device=dev,
                         dtype=torch.int32)
    cols[:2] = torch.tensor([0, n - 1])
    cols[-2:] = torch.tensor([n - 1, 0])
    before = cuda_gather.take_flat.launches
    views = [cols, cols[:1], cols[:2], cols[:3], cols[:4097], cols[:4098],
             cols[:4099], cols[1:], cols[3:5002], cols.view(-1, 1)[:1000]]
    for c in views:
        assert torch.equal(cuda_gather.take_flat(x, c),
                           cuda_gather.take_flat_plain(x, c)), c.numel()
    assert cuda_gather.take_flat.launches - before == len(views)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [5, 2048, 4099, 16384, 16385])
def test_take_lanes_rows_match_twin_on_card(dev, rows):
    # 4099 and 16385 rows: not a multiple of a block's 8 rows; the empty
    # kernel of the launch floor launches beside it
    g = torch.Generator(device=dev).manual_seed(rows)
    X = torch.randn(rows, 128, generator=g, device=dev)
    lidx = torch.randint(0, 128, (rows, 128), generator=g, device=dev,
                         dtype=torch.int32)
    lidx[0, :2] = torch.tensor([0, 127])
    lidx[-1, -2:] = torch.tensor([127, 0])
    assert torch.equal(cuda_gather.take_lanes(X, lidx),
                       cuda_gather.take_lanes_plain(X, lidx))
    cuda_gather.noop(X.device)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["device", "contiguity", "dtype", "range",
                                  "lanes_shape"])
def test_gather_wrappers_refuse_on_card(dev, case):
    X, cols, lidx = _gather_case(dev)
    with pytest.raises((ValueError, IndexError)):
        if case == "device":
            cuda_gather.take_flat(X, cols.cpu())
        elif case == "contiguity":
            cuda_gather.take_lanes(X.t(), lidx)
        elif case == "dtype":
            cuda_gather.take_flat(X.double(), cols)
        elif case == "range":
            bad = cols.clone()
            bad[7] = X.numel()
            cuda_gather.take_flat(X, bad)
        else:
            cuda_gather.take_lanes(X[:, :64].contiguous(),
                                   lidx[:, :64].contiguous())


@pytest.mark.gpu
def test_eigs_on_card_counts_equal_twins(dev):
    # a small float64 eigs solve on the card: the restart rotation runs its
    # kernel, and the counters equal the same solve with the twin
    from unittest import mock

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core import arnoldi
    from arpack_ng_tpu_torch.models import convection_diffusion_2d

    op, a = convection_diffusion_2d(24, dtype=np.float64, device=dev)
    kw = dict(k=6, ncv=24, which="LM", tol=1e-10, maxiter=500,
              return_stats=True,
              v0=np.random.default_rng(0).uniform(-1, 1, op.n))
    cuda_rot.rotate_rows.launches = 0
    vals, vecs, out = pt.eigs(op, **kw)
    assert cuda_rot.rotate_rows.launches > 0
    with mock.patch.object(arnoldi, "rotate_rows", cuda_rot.rotate_rows_plain):
        vals2, _, out2 = pt.eigs(op, **kw)
    s, s2 = out.stats, out2.stats
    assert (s.n_iter, s.nopx, s.nrorth, s.nitref, s.nrotr) == \
        (s2.n_iter, s2.nopx, s2.nrorth, s2.nitref, s2.nrotr)
    np.testing.assert_allclose(np.sort_complex(vals), np.sort_complex(vals2),
                               rtol=1e-9)
    res = np.linalg.norm(a @ vecs - vecs * vals[None, :], axis=0)
    assert res.max() < 1e-8 * np.abs(vals).max()


@pytest.mark.gpu
@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "float64"])
def test_sel_word_kernels_on_card(dev, sdt):
    # the event kernels with K read from device memory: 0 leaves r bit for
    # bit (and s zero), and every K 1..32 over all 32 rows sums exactly as
    # a call over the K rows alone
    g, V, buf, tol = _sel_case(dev, sdt, (1 << 16) + 3)
    for vec in (buf[:-1], buf[1:]):
        idx = torch.randperm(32, device=dev, generator=g).int()
        s = torch.randn(32, generator=g, device=dev, dtype=vec.dtype)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        assert not cuda_sel.sel_proj(idx, V, vec, word=zero).any()
        r = vec.clone()
        nrm = cuda_sel.sel_update(idx, s, r, V, True, word=zero)[1]
        assert torch.equal(r, vec)
        assert cuda_sel.sel_update(idx, s, r, V, word=zero) is r
        for K in range(1, 33):
            word = torch.full((), K, dtype=torch.int32, device=dev)
            sw = cuda_sel.sel_proj(idx, V, vec, word=word)
            assert torch.equal(sw[:K], cuda_sel.sel_proj(idx[:K], V, vec))
            assert not sw[K:].any()
            torch.testing.assert_close(
                sw, cuda_sel.sel_proj_plain(idx, V, vec, word), **tol)
            rw, nw = cuda_sel.sel_update(idx, s, vec.clone(), V, True,
                                         word=word)
            rh, nh = cuda_sel.sel_update(idx[:K], s[:K].clone(), vec.clone(),
                                         V, True)
            assert torch.equal(rw, rh) and torch.equal(nw, nh)
            rp, np_ = cuda_sel.sel_update_plain(idx, s, vec.clone(), V, True,
                                                word)
            torch.testing.assert_close(rw, rp, **tol)
            torch.testing.assert_close(nw, np_, **tol)
        del nrm
    torch.cuda.synchronize()


def _lanczos_T(seed, ncv=32, n=400):
    """T and rnorm of ncv Lanczos steps with full reorthogonalization on a
    random diagonal (the tridiagonals a restart meets), or, for n = None,
    on the flagship's spectrum (the 2-D Laplacian's at nx = 64)."""
    rng = np.random.default_rng(seed)
    if n is None:
        g = 2.0 - 2.0 * np.cos(np.pi / 65 * np.arange(1, 65))
        lam = (g[:, None] + g[None, :]).ravel()
        n = lam.shape[0]
    else:
        lam = rng.uniform(0.0, 1.0, n)
    V = np.zeros((ncv + 1, n))
    v = rng.uniform(-1, 1, n)
    V[0] = v / np.linalg.norm(v)
    d, e = np.zeros(ncv), np.zeros(ncv)
    for j in range(ncv):
        w = lam * V[j]
        for _ in range(2):
            w -= V[:j + 1].T @ (V[:j + 1] @ w)
        d[j] = V[j] @ (lam * V[j])
        e[j] = np.linalg.norm(w)
        V[j + 1] = w / e[j]
    return d, e


def _sym_cycle_run(d, e, dt, p, is_last, device):
    from arpack_ng_tpu_torch.ops import cuda_sym_cycle as csc
    ncv = d.shape[0]
    t = dict(dtype=dt, device=device)
    a = torch.tensor(d, **t)
    b = torch.tensor(e, **t)
    Q = torch.zeros(ncv, ncv, **t)
    sk = torch.zeros(2, **t)
    pk = torch.zeros(csc.packet_size(ncv), dtype=torch.float64, device=device)
    csc.sym_cycle(a, b, torch.tensor(e[-1], **t),
                  torch.tensor(-1, dtype=torch.int32, device=device),
                  torch.tensor(0, dtype=torch.int32, device=device),
                  torch.zeros(4, dtype=torch.int64, device=device), Q, sk, pk,
                  p, is_last)
    return [x.cpu().numpy().astype(np.float64) for x in (a, b, Q, sk, pk)]


#: the reduced-space kernel against its twin: the largest gap allowed, in
#: the units of chip_smoke.py's SYM_LIMITS, and as there (Ritz values and
#: bounds, the new T and the residual's new part over T's scale; Q's kept
#: columns, sigmak), with the same override past the shared-memory limit
SYM_LIMITS = {
    "float32": dict(values=1e-7, T=5e-5, Q=2e-5, sigmak=5e-6, resid=1e-5),
    "float64": dict(values=1e-9, T=1e-7, Q=1e-7, sigmak=1e-7, resid=1e-7)}
SYM_LIMITS_GLOBAL = {"float32": dict(Q=1e-3, resid=1e-3), "float64": {}}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("which", ["LA", "SA", "LM", "SM", "BE"])
def test_sym_cycle_kernel_matches_twin_on_card(dev, dtype, which):
    # one cycle's reduced space, the kernel against its numpy twin on
    # Lanczos tridiagonals (ncv = 32, nev = 8, the workspace in shared
    # memory; and the first ncv past it, the matrices in global memory, on
    # the flagship's spectrum with the same 24 shifts): the counts equal, every
    # gap within SYM_LIMITS (the columns of Q past kev belong to the
    # deflated block and are free); a cycle that ends the solve leaves T
    # as it was
    from arpack_ng_tpu_torch.ops import cuda_sym_cycle as csc
    from arpack_ng_tpu_torch.ops.cuda_sym_cycle import (
        P_DONE, P_HEAD, P_INFO, P_NCONV, P_NEV, P_NP)
    dt = getattr(torch, dtype)
    f = np.finfo(np.dtype(dtype))
    top = next(n for n in range(32, 400)
               if not csc.fits_shared(n + 1, dt.itemsize))
    for seed, ncv, n in ((0, 32, 400), (1, 32, 400), (2, 32, 400),
                         (0, top + 1, None)):
        lim = dict(SYM_LIMITS[dtype])
        if ncv > 32:
            lim.update(SYM_LIMITS_GLOBAL[dtype])
        p = csc.Params(which=which, nev=8 if ncv == 32 else ncv - 24,
                       tol=1e-14 if dtype == "float64" else 1e-5,
                       eps23=float(f.eps ** (2 / 3)), eps_m=float(f.eps))
        d, e = _lanczos_T(seed, ncv, n)
        d, e = d.astype(dtype), e.astype(dtype)
        for is_last in (False, True):
            ka, kb, kQ, ksk, kpk = _sym_cycle_run(d, e, dt, p, is_last, dev)
            ta, tb, tQ, tsk, tpk = _sym_cycle_run(d, e, dt, p, is_last, "cpu")
            for i in (P_DONE, P_NCONV, P_NEV, P_NP, P_INFO):
                assert kpk[i] == tpk[i], (seed, ncv, i)
            k = int(kpk[P_NEV])
            scale = np.abs(d).max()
            np.testing.assert_allclose(kpk[P_HEAD + 2 * ncv:],
                                       tpk[P_HEAD + 2 * ncv:], rtol=0,
                                       atol=lim["values"] * scale)
            if is_last or kpk[P_DONE]:
                assert np.array_equal(ka, d) and np.array_equal(kb, e)
                continue
            np.testing.assert_allclose(ka[:k], ta[:k], rtol=0,
                                       atol=lim["T"] * scale)
            np.testing.assert_allclose(kb[:k - 1], tb[:k - 1], rtol=0,
                                       atol=lim["T"] * scale)
            np.testing.assert_allclose(kQ[:, :k], tQ[:, :k], rtol=0,
                                       atol=lim["Q"])
            np.testing.assert_allclose(ksk[0], tsk[0], rtol=0,
                                       atol=lim["sigmak"])
            np.testing.assert_allclose(ksk[1] * kQ[:, k], tsk[1] * tQ[:, k],
                                       rtol=0, atol=lim["resid"] * scale)
    torch.cuda.synchronize()


def _flagship_small(dev, capturable=True):
    import dataclasses

    from arpack_ng_tpu_torch.models import laplacian_2d
    op, _ = laplacian_2d(64, np.float32, device=dev)
    return dataclasses.replace(op, capturable=capturable)


@pytest.mark.gpu
def test_graph_replay_equals_eager_on_card(dev):
    # the selective loop with its extensions replayed as CUDA graphs gives
    # the eager card run bit for bit, and counts one packet per cycle
    import arpack_ng_tpu_torch as pt
    runs = []
    for capturable in (True, False):
        op = _flagship_small(dev, capturable)
        vals, vecs, out = pt.eigsh(op, k=8, ncv=32, which="LA", tol=1e-5,
                                   return_stats=True)
        runs.append((vals, vecs, out.stats))
    (v1, x1, s1), (v2, x2, s2) = runs
    assert s1.graphs_captured > 0 and s1.graph_replays > 0
    assert s2.graphs_captured == 0
    assert s1.packets == s2.packets == s1.n_iter
    for f in ("n_iter", "nopx", "nrorth", "nrorthr", "nitref", "nrotr"):
        assert getattr(s1, f) == getattr(s2, f), f
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(x1, x2)


def _host_sym_cycle(*args):
    """The reduced space as the host loop computes it: the kernel's buffers
    copied to the host, its numpy twin, the results copied back."""
    from arpack_ng_tpu_torch.ops import cuda_sym_cycle as csc
    bufs, (p, is_last) = args[:9], args[9:]
    cpu = [t.cpu() for t in bufs]
    csc.sym_cycle_plain(*cpu, p, is_last)
    for i in (0, 1, 6, 7, 8):  # a, b, Q, sk, packet
        bufs[i].copy_(cpu[i])


@pytest.mark.gpu
@pytest.mark.parametrize("capturable", [True, False])
def test_dgks_device_loop_equals_host_loop_on_card(dev, capturable):
    # the dgks flagship class at nx = 128 on the device loop (graphs
    # replayed, or eager for an operator that does not declare itself
    # capturable): with the reduced space patched to its host twin (the
    # host-reduced witness) the read-free steps give the host loop with
    # the host's step (each decision read back) bit for bit; with the
    # kernel, graphs captured, one packet per cycle and extension the host
    # finished, the values within 1e-4*|lambda| of the witness's
    import dataclasses
    from unittest import mock

    from arpack_ng_tpu_torch.config import IRAMConfig
    from arpack_ng_tpu_torch.core import arnoldi, device_sym
    from arpack_ng_tpu_torch.models import laplacian_2d
    op, _ = laplacian_2d(128, np.float32, device=dev)
    op = dataclasses.replace(op, capturable=capturable)
    cfg = IRAMConfig(n=op.n, nev=8, ncv=32, which="LA", symmetric=True,
                     dtype=np.dtype(np.float32), n_pad=op.n_pad, tol=1e-5,
                     max_iter=3000, reorth="dgks")
    real = device_sym.make_extend
    with mock.patch.object(device_sym, "make_extend",
                           lambda o, c: arnoldi.Extension(
                               real(o, c).stepwise)):
        host_solver = device_sym.FusedSymSolver(op, cfg)
    assert host_solver._host_loop
    host = host_solver.solve()
    with mock.patch.object(device_sym, "sym_cycle", _host_sym_cycle):
        witness = device_sym.FusedSymSolver(op, cfg).solve()
    arnoldi.reruns.update(redo=0, breakdown=0)
    kernel = device_sym.FusedSymSolver(op, cfg).solve()
    reruns = sum(arnoldi.reruns.values())
    for f in ("n_iter", "nopx", "nbx", "nrorth", "nitref", "nrstrt",
              "nrotr"):
        assert getattr(witness.stats, f) == getattr(host.stats, f), f
    np.testing.assert_array_equal(witness.ritz, host.ritz)
    assert torch.equal(witness.state.V, host.state.V)
    st = kernel.stats
    assert st.nrorth > 0
    assert st.packets == kernel.n_iter + reruns
    if capturable:
        assert st.graphs_captured > 0
        assert st.graph_replays == kernel.n_iter - 1
        assert any("rotate_rows" in d for d in st.replay_launches.values())
    else:
        assert st.graphs_captured == 0
    np.testing.assert_allclose(np.sort(kernel.ritz[:8]),
                               np.sort(witness.ritz[:8]), rtol=1e-4)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_failed_capture_raises_on_card(dev):
    # an operator that declares itself capturable but reads back raises
    # when its graph is captured: no eager fallback
    import dataclasses

    import arpack_ng_tpu_torch as pt
    op = _flagship_small(dev)
    inner = op.apply

    def apply(v, bv):
        w, bw = inner(v, bv)
        _ = float(w[0])
        return w, bw

    bad = dataclasses.replace(op, apply=apply)
    with pytest.raises(RuntimeError):
        pt.eigsh(bad, k=8, ncv=32, which="LA", tol=1e-5)


def _sym_pipeline_case(case, dtype):
    """(d, e, nev, limits) of a reduced-space case for the pipelined sweep:
    an ncv that is not a multiple of 32, shifts outnumbering the shifts in
    flight, zero Ritz bounds among the unwanted (T split after row 12, its
    top block moved below the rest: the top block's eigenvectors end in
    exact zeros, np_eff < np0 and nev inflated), and the workspace's parts
    in global memory: the matrices (global, past the shared-memory limit,
    on the flagship's spectrum with its 24 shifts) and both parts
    (all_global, from the first ncv that takes it, with 'LM' on a spectrum
    symmetric about 0 and 8 shifts: interior Ritz values far from
    converged, so no bound is near the exact zeros the zero-bound count
    tests)."""
    from arpack_ng_tpu_torch.ops import cuda_sym_cycle as csc
    lim = dict(SYM_LIMITS[dtype])
    if case == "ncv20":
        d, e = _lanczos_T(0, 20)
        nev = 6
    elif case == "ncv48":
        d, e = _lanczos_T(1, 48)
        nev = 8
    elif case == "ncv64_60shifts":
        d, e = _lanczos_T(2, 64)
        nev = 4
    elif case == "zero_bounds":
        d, e = _lanczos_T(0, 32)
        e[11] = 0.0
        d[:12] -= 2.0
        nev = 8
    else:  # past the shared-memory limit, the flagship's spectrum
        itemsize = np.dtype(dtype).itemsize
        parts = {"global": 1, "all_global": 0}[case]
        ncv = next(n for n in range(32, 2000)
                   if csc.smem_parts(n, itemsize) == parts)
        if case == "global":
            d, e = _lanczos_T(3, ncv + 8, None)
            nev = ncv + 8 - 24
        else:  # T - I/2 of a spectrum uniform in (0, 1)
            d, e = _lanczos_T(3, ncv, 4096)
            d -= 0.5
            nev = ncv - 8
        lim.update(SYM_LIMITS_GLOBAL[dtype])
    return d.astype(dtype), e.astype(dtype), nev, lim


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", ["ncv20", "ncv48", "ncv64_60shifts",
                                  "zero_bounds", "global", "all_global"])
def test_sym_cycle_pipeline_cases_on_card(dev, dtype, case):
    # the pipelined exact-shift sweep against the twin, LA and BE (all_global:
    # LM), within
    # the unchanged SYM_LIMITS (SYM_LIMITS_GLOBAL past the shared-memory
    # limit): the counts equal, the Ritz data, the new T, Q's kept columns,
    # sigmak and the residual's new part.  zero_bounds runs LA, whose 12
    # shifts are the split-off block's own eigenvalues: they annihilate that
    # block, whose rows any two QR codes then leave apart (LAPACK's and a
    # dgeqr2 sequence in numpy differ by 1.2 there in float64, with
    # tools/reduced_rounding_cpu.py's model), so T, Q, sigmak and the
    # residual are held to the twin on the coupled block (rows 12 on), where
    # the model agrees with LAPACK to 1e-15
    from arpack_ng_tpu_torch.ops import cuda_sym_cycle as csc
    from arpack_ng_tpu_torch.ops.cuda_sym_cycle import (
        P_DONE, P_HEAD, P_INFO, P_NCONV, P_NEV, P_NP)
    dt = getattr(torch, dtype)
    f = np.finfo(np.dtype(dtype))
    d, e, nev, lim = _sym_pipeline_case(case, dtype)
    ncv = d.shape[0]
    b0 = 12 if case == "zero_bounds" else 0  # the rows the shifts determine
    whiches = {"zero_bounds": ("LA",), "all_global": ("LM",)}
    for which in whiches.get(case, ("LA", "BE")):
        p = csc.Params(which=which, nev=nev,
                       tol=1e-14 if dtype == "float64" else 1e-5,
                       eps23=float(f.eps ** (2 / 3)), eps_m=float(f.eps))
        ka, kb, kQ, ksk, kpk = _sym_cycle_run(d, e, dt, p, False, dev)
        ta, tb, tQ, tsk, tpk = _sym_cycle_run(d, e, dt, p, False, "cpu")
        for i in (P_DONE, P_NCONV, P_NEV, P_NP, P_INFO):
            assert kpk[i] == tpk[i], (case, which, i)
        assert not kpk[P_DONE], (case, which)
        if case == "zero_bounds":
            assert kpk[P_NP] < ncv - nev, which  # zero bounds removed
        k = int(kpk[P_NEV])
        scale = np.abs(d).max()
        np.testing.assert_allclose(kpk[P_HEAD + 2 * ncv:],
                                   tpk[P_HEAD + 2 * ncv:], rtol=0,
                                   atol=lim["values"] * scale)
        np.testing.assert_allclose(ka[b0:k], ta[b0:k], rtol=0,
                                   atol=lim["T"] * scale)
        np.testing.assert_allclose(kb[b0:k - 1], tb[b0:k - 1], rtol=0,
                                   atol=lim["T"] * scale)
        np.testing.assert_allclose(kQ[b0:, b0:k], tQ[b0:, b0:k], rtol=0,
                                   atol=lim["Q"])
        np.testing.assert_allclose(ksk[0], tsk[0], rtol=0,
                                   atol=lim["sigmak"])
        np.testing.assert_allclose(ksk[1] * kQ[b0:, k], tsk[1] * tQ[b0:, k],
                                   rtol=0, atol=lim["resid"] * scale)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sym_cycle_breakdown_leaves_state_on_card(dev, dtype):
    # an extension that stopped short (brk != -1) leaves a, b, Q and sk as
    # they were and writes the packet's head as the twin does
    from arpack_ng_tpu_torch.ops import cuda_sym_cycle as csc
    dt = getattr(torch, dtype)
    f = np.finfo(np.dtype(dtype))
    d, e = _lanczos_T(0)
    p = csc.Params(which="LA", nev=8, tol=1e-5, eps23=float(f.eps ** (2 / 3)),
                   eps_m=float(f.eps))
    out = []
    for device in (dev, "cpu"):
        t = dict(dtype=dt, device=device)
        bufs = [torch.tensor(d, **t), torch.tensor(e, **t),
                torch.tensor(e[-1], **t),
                torch.tensor(5, dtype=torch.int32, device=device),
                torch.tensor(1, dtype=torch.int32, device=device),
                torch.arange(4, dtype=torch.int64, device=device) + 7,
                torch.full((32, 32), 3.0, **t), torch.full((2,), -2.0, **t),
                torch.zeros(csc.packet_size(32), dtype=torch.float64,
                            device=device)]
        csc.sym_cycle(*bufs, p, False)
        out.append([x.cpu() for x in bufs])
    (ka, kb, _, _, _, _, kQ, ksk, kpk), (_, _, _, _, _, _, _, _, tpk) = out
    assert torch.equal(ka, torch.tensor(d, dtype=dt))
    assert torch.equal(kb, torch.tensor(e, dtype=dt))
    assert torch.all(kQ == 3.0) and torch.all(ksk == -2.0)
    assert torch.equal(kpk, tpk)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1 << 16, (1 << 16) + 3])
@pytest.mark.parametrize("cdt", ["complex64", "complex128"])
def test_rotate_rows_complex_view_on_card(dev, cdt, n):
    # a complex basis rotated by a real Q (the Hermitian restart) runs the
    # kernel on its real view: the twin is the complex GEMM Q^T V; every
    # bucket, rows past it untouched, two calls bit-equal
    ct = getattr(torch, cdt)
    rt = torch.float32 if ct == torch.complex64 else torch.float64
    g = torch.Generator(device=dev).manual_seed(5)
    V = torch.complex(torch.randn(32, n, generator=g, device=dev, dtype=rt),
                      torch.randn(32, n, generator=g, device=dev, dtype=rt))
    Q = torch.linalg.qr(torch.randn(32, 32, dtype=torch.float64))[0]
    Q = Q.to(device=dev, dtype=rt).contiguous()
    tol = dict(rtol=1e-5, atol=1e-3) if rt == torch.float32 else \
        dict(rtol=1e-12, atol=1e-10)
    for rows in (8, 16, 24, 32):
        out = cuda_rot.rotate_rows(Q, V.clone(), rows)
        torch.testing.assert_close(out[:rows], Q[:, :rows].T.to(ct) @ V,
                                   **tol)
        assert torch.equal(out[rows:], V[rows:])
        assert torch.equal(out, cuda_rot.rotate_rows(Q, V.clone(), rows))
    with pytest.raises(ValueError, match="real Q"):
        cuda_rot.rotate_rows(Q.to(ct), V.clone(), 8)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("cdt", ["complex64", "complex128"])
def test_complex_event_matches_twin_on_card(dev, cdt):
    # the complex event of the Hermitian selective step (masked GEMVs over
    # all ncv rows, core/arnoldi.complex_event) against the gathered form
    # of the twins, conjugated: <V[idx[k]], br> for the taken positions,
    # and the update r - sum_k s_k V[idx[k]]
    from arpack_ng_tpu_torch.core.arnoldi import complex_event
    ct = getattr(torch, cdt)
    rt = torch.float32 if ct == torch.complex64 else torch.float64
    g = torch.Generator(device=dev).manual_seed(6)
    n = 1 << 16

    def crandn(*shape):
        return torch.complex(
            torch.randn(*shape, generator=g, device=dev, dtype=rt),
            torch.randn(*shape, generator=g, device=dev, dtype=rt))

    V, br, r = crandn(32, n), crandn(n), crandn(n)
    tol = dict(rtol=1e-4, atol=1e-2) if rt == torch.float32 else \
        dict(rtol=1e-10, atol=1e-8)
    for K in (0, 1, 8, 13, 32):
        idx = torch.randperm(32, generator=g, device=dev).to(torch.int32)
        take = torch.arange(32, device=dev) < K
        c = complex_event(idx, V, br, take)
        rows = V.index_select(0, idx[:K].long())
        s_ref = rows.conj() @ br
        c_ref = torch.zeros(32, dtype=ct, device=dev)
        c_ref[idx[:K].long()] = s_ref
        torch.testing.assert_close(c, c_ref, **tol)
        torch.testing.assert_close(r - c @ V, r - s_ref @ rows, **tol)
        if K == 0:
            assert torch.equal(r - c @ V, r)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_hermitian_device_loop_on_card(dev):
    # a complex Hermitian DIA operator through eigsh on the card: the
    # device loop (captured graphs, the reduced-space kernel, the rotation
    # kernel on the real view) and the hybrid driver, complex64: real
    # values within 1e-4 relative of each other, residuals <= 1e-3
    import scipy.sparse as sp

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.ops import cuda_sym_cycle
    nx = 64
    one = np.ones(nx - 1)
    tc = sp.diags([(-1 - 0.5j) * one, 2 * np.ones(nx), (-1 + 0.5j) * one],
                  [-1, 0, 1])
    t0 = sp.diags([-one, 2 * np.ones(nx), -one], [-1, 0, 1])
    eye = sp.identity(nx)
    a = (sp.kron(tc, eye) + sp.kron(eye, t0)).tocsr()
    op = pt.from_scipy(a, dtype=np.complex64, hermitian=True, device=dev)
    assert op.format == "dia"
    found = {}
    for strategy in ("auto", "hybrid"):
        cuda_rot.rotate_rows.launches = 0
        cuda_sym_cycle.sym_cycle.launches = 0
        vals, vecs, out = pt.eigsh(op, k=8, ncv=32, which="LA", tol=1e-5,
                                   strategy=strategy, return_stats=True)
        assert np.isrealobj(vals) and len(vals) == 8
        v = np.asarray(vecs, np.complex128)
        res = np.linalg.norm(a @ v - v * vals, axis=0) / np.abs(vals)
        assert res.max() <= 1e-3
        assert cuda_rot.rotate_rows.launches > 0
        if strategy == "auto":
            assert out.stats.graphs_captured > 0
            assert cuda_sym_cycle.sym_cycle.launches > 0
        found[strategy] = vals
    np.testing.assert_allclose(found["auto"], found["hybrid"], rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_complexified_dia_matches_twin_on_card(dev, dtype):
    # eigs(strategy='fused') on a real DIA matrix: the complexified
    # operator gives the DIA kernel the contiguous real and imaginary parts
    # (two launches per complex product), equal bit for bit to two twin
    # products, at a misaligned n
    import scipy.sparse as sp

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core.device_nonsym import complexify_operator
    from arpack_ng_tpu_torch.ops import sparse
    n = 60_003
    rng = np.random.default_rng(5)
    a = sp.diags([rng.standard_normal(n - 245), rng.standard_normal(n - 1),
                  2 + rng.standard_normal(n), rng.standard_normal(n - 1),
                  rng.standard_normal(n - 245)],
                 [-245, -1, 0, 1, 245]).tocsr().astype(dtype)
    op = pt.from_scipy(a, format="dia", device=dev)
    opc = complexify_operator(op)
    offsets, dtab = sparse.dia_table(a, op.n_pad)
    offs, tab = torch.from_numpy(offsets), torch.from_numpy(dtab).to(dev)
    cdt = torch.complex64 if dtype == np.float32 else torch.complex128
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(op.n_pad, generator=g, device=dev, dtype=cdt)
    x[n:] = 0
    before = cuda_dia.dia_matvec.launches
    y, by = opc.apply(x, x)
    assert cuda_dia.dia_matvec.launches - before == 2
    assert torch.equal(y, by)
    assert torch.equal(y.real, cuda_dia.dia_matvec_plain(
        offs, tab, x.real.contiguous(), n))
    assert torch.equal(y.imag, cuda_dia.dia_matvec_plain(
        offs, tab, x.imag.contiguous(), n))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["lower", "upper", "far"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dia_matvec_fn_strict_triangles_on_card(dev, dtype, case):
    # the ILU(0) preconditioner's tables: offsets of one sign, and offsets
    # at or past n, which select nothing; the kernel launches and equals
    # the twin bit for bit (the same order and rounding)
    from arpack_ng_tpu_torch.ops import sparse
    n, n_pad = 60_003, 60_416
    off = {"lower": [-1024, -245, -1], "upper": [1, 3, 1024],
           "far": [-n - 7, -n, -1, 1, n, n + 2]}[case]
    rng = np.random.default_rng(6)
    diags = [rng.standard_normal(n).astype(dtype) for _ in off]
    mv = sparse.dia_matvec_fn(off, diags, n, n_pad, device=dev)
    mv_cpu = sparse.dia_matvec_fn(off, diags, n, n_pad, device="cpu")
    x = torch.from_numpy(rng.standard_normal(n_pad).astype(dtype))
    before = cuda_dia.dia_matvec.launches
    y = mv(x.to(dev))
    assert cuda_dia.dia_matvec.launches - before == 1
    assert torch.equal(y.cpu(), mv_cpu(x))
    assert not y[n:].any()
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cg_solve_on_card_matches_cpu(dev):
    # one preconditioned CG solve of the shifted 2-D Laplacian on the card
    # (DIA kernel for the product and the IC(0) triangles) against the same
    # solve on the CPU (the twins; the dot products sum in another order):
    # iteration counts within one, both true residuals within twice the
    # tolerance (CG tests its recurrence's residual) and the solutions
    # within 1e-8 relative in norm
    import scipy.sparse as sp

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.ops import solvers
    nx = 128
    eye = sp.eye(nx)
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    a = (sp.kron(eye, t) + sp.kron(t, eye)).tocsr()
    b = np.random.default_rng(7).standard_normal(nx * nx)
    x, its = [], []
    for d in (dev, "cpu"):
        op = pt.from_scipy(a, format="dia", device=d)
        pc = solvers.ilu0_preconditioner(a, symmetric=True, sweeps=3,
                                         n_pad=op.n_pad, device=d)
        solve = solvers.make_iterative_solve(op.a_apply, symmetric=True,
                                             tol=1e-10, maxiter=2000,
                                             precond=pc)
        bp = torch.zeros(op.n_pad, dtype=torch.float64)
        bp[: nx * nx] = torch.from_numpy(b)
        before = cuda_dia.dia_matvec.launches \
            + cuda_dia.dia_matvec_sub.launches
        x.append(solve(bp.to(d)).cpu())
        its.append(solve.iterations[0])
        if d is dev:
            # the product and the six sweeps (each a launch of the DIA
            # kernel's epilogue form) per iteration
            assert cuda_dia.dia_matvec.launches \
                + cuda_dia.dia_matvec_sub.launches - before > 3 * its[0]
    assert abs(its[0] - its[1]) <= 1
    for xi in x:
        r = a @ xi[: nx * nx].numpy() - b
        assert np.linalg.norm(r) <= 2e-10 * np.linalg.norm(b)
    assert torch.linalg.norm(x[0] - x[1]) <= 1e-8 * torch.linalg.norm(x[1])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [60_000, 60_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dia_block_kernel_matches_twin_on_card(dev, dtype, n):
    # the block DIA kernel over b = 1..9 and 17 columns (one chunk of 8,
    # a remainder, several chunks) on 13 diagonals with offsets past the
    # rows at both ends: equal bit for bit to its twin, each column equal
    # to the single kernel, two calls equal, one launch per call
    n_pad = 60_416
    g = torch.Generator(device=dev).manual_seed(8)
    offs = torch.tensor([0, 1, -1, 4, -4, 128, -128, 129, -300, 3000,
                         -3000, n + 5, -n], dtype=torch.int64, device=dev)
    dtab = torch.randn(offs.numel(), n_pad, generator=g, device=dev,
                       dtype=dtype)
    for b in (*range(1, 10), 17):
        X = torch.randn(b, n_pad, generator=g, device=dev, dtype=dtype)
        before = cuda_dia.dia_block_matvec.launches
        Y = cuda_dia.dia_block_matvec(offs, dtab, X, n)
        assert cuda_dia.dia_block_matvec.launches - before == 1
        assert torch.equal(Y, cuda_dia.dia_block_matvec_plain(offs, dtab,
                                                              X, n))
        assert torch.equal(Y, cuda_dia.dia_block_matvec(offs, dtab, X, n))
        for c in range(b):
            assert torch.equal(Y[c], cuda_dia.dia_matvec(offs, dtab,
                                                         X[c].contiguous(),
                                                         n))
        assert not Y[:, n:].any()
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(dia_cases.CASES))
def test_dia_block_kernel_on_the_case_list(dev, name, dtype):
    # the plan's patterns of tests/torch_dia_cases.py (alternating offsets,
    # runs wider than a window, |off| >= n, 129 and 600 diagonals, n_pad
    # not a multiple of 4, non-finite table entries where terms are
    # skipped) at b = 1-9, 16, 17: the kernel bit for bit its twin and the
    # single kernel per column, one launch per call
    for b in dia_cases.BLOCKS:
        offs, dtab, X, n = (torch.from_numpy(a).to(dev) if
                            isinstance(a, np.ndarray) else a
                            for a in dia_cases.make(name, dtype, b))
        before = cuda_dia.dia_block_matvec.launches
        Y = cuda_dia.dia_block_matvec(offs, dtab, X, n)
        assert cuda_dia.dia_block_matvec.launches - before == 1
        assert torch.equal(Y, cuda_dia.dia_block_matvec_plain(offs, dtab,
                                                              X, n)), b
        for c in range(b):
            assert torch.equal(Y[c], cuda_dia.dia_matvec(offs, dtab, X[c],
                                                         n)), (b, c)
        assert torch.isfinite(Y).all() and not Y[:, n:].any()
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dia_block_plan_matches_the_library(dev, dtype, b):
    # the host's mirror of the kernel's launch shape (block_plan) against
    # the library's own answer (block_config), which reads no offsets
    offsets = dia_cases.CASES["alternating"][0]
    plan = cuda_dia.block_plan(offsets, 1 << 20, b, dtype)
    cfg = cuda_dia.block_config(len(offsets), b, 1 << 20, dtype)
    assert (cfg["tile"], cfg["window"], cfg["smem"], cfg["cols"]) == (
        plan["tile"], plan["window"], plan["smem"], b)
    assert cfg["planned"] == 1 and cfg["blocks_per_sm"] >= 1
    assert 1 <= cfg["grid"] <= ((1 << 20) + plan["tile"] - 1) // plan["tile"]


@pytest.mark.gpu
def test_banded_shift_invert_on_card(dev):
    # eigsh_banded through BCR's DIA form on the card (at ncv = 10 the
    # solve restarts, so the device loop's graphs replay the sweeps' DIA
    # launches) against the same solve on the CPU: values within 1e-10
    # relative, DIA launches counted per replay
    from arpack_ng_tpu_torch.ops import banded
    n = 5000
    ab = np.zeros((3, n))
    ab[0, 1:], ab[1], ab[2, :-1] = -1.0, 2.0, -1.0
    v0 = np.random.default_rng(0).uniform(-1, 1, n)
    vals = {}
    for d in (dev, "cpu"):
        before = cuda_dia.dia_matvec.launches
        vals[str(d)], _, out = banded.eigsh_banded(
            ab, 1, 1, k=4, ncv=10, sigma=0.5, tol=1e-10, v0=v0,
            return_stats=True, device=d)
        if d is dev:
            assert cuda_dia.dia_matvec.launches - before > 0
            assert out.stats.graph_replays > 0
            assert all(r["dia_matvec"] > 0
                       for r in out.stats.replay_launches.values())
    np.testing.assert_allclose(np.sort(vals[str(dev)]), np.sort(vals["cpu"]),
                               rtol=1e-10)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_block_lanczos_on_card(dev):
    # eigsh_block on a DIA operator on the card (the block DIA kernel and
    # the rotation kernel) against the same solve on the CPU: values within
    # 1e-10 relative, residuals <= 1e-8
    import scipy.sparse as sp

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core.block import eigsh_block
    rng = np.random.default_rng(5)
    n = 3000
    a = sp.diags([rng.uniform(-0.5, 0.5, n - 2), rng.uniform(-1, 1, n - 1),
                  rng.uniform(0, 10, n), rng.uniform(-1, 1, n - 1),
                  rng.uniform(-0.5, 0.5, n - 2)], [-2, -1, 0, 1, 2])
    a = (a + a.T).tocsr() / 2
    vals = {}
    for d in (dev, "cpu"):
        op = pt.from_scipy(a, hermitian=True, device=d)
        blk0, rot0 = (cuda_dia.dia_block_matvec.launches,
                      cuda_rot.rotate_rows.launches)
        vals[str(d)], vecs, info = eigsh_block(op, k=6, block_size=2,
                                               ncv=32, tol=1e-10,
                                               maxiter=400, dtype=np.float64)
        assert info["nconv"] >= 6
        res = np.linalg.norm(a @ vecs - vecs * vals[str(d)], axis=0)
        assert res.max() <= 1e-8
        if d is dev:
            assert cuda_dia.dia_block_matvec.launches - blk0 > 0
            assert cuda_rot.rotate_rows.launches - rot0 > 0
    np.testing.assert_allclose(vals[str(dev)], vals["cpu"], rtol=1e-10)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cli_on_card(dev, tmp_path, capsys):
    # the CLI on a .mtx file without --cpu runs on the card: it launches
    # the rotation and DIA kernels; its values equal the same command's
    # with --cpu within 1e-10 relative (float64)
    import json

    from arpack_ng_tpu_torch import cli
    from arpack_ng_tpu_torch.io import matrix_market as mm
    from arpack_ng_tpu_torch.models import laplacian_2d
    mm.write_matrix(tmp_path / "lap.mtx",
                    laplacian_2d(48, np.float64, device="cpu")[1])
    argv = ["--A", str(tmp_path / "lap.mtx"), "--nbEV", "4", "--mag", "LA",
            "--tol", "1e-10", "--json"]
    kernels = (cuda_rot.rotate_rows, cuda_dia.dia_matvec)
    before = [k.launches for k in kernels]
    outs = []
    for extra in ([], ["--cpu"]):
        assert cli.main(argv + extra) == 0
        outs.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
        if not extra:
            assert all(k.launches > b for k, b in zip(kernels, before))
    np.testing.assert_allclose(outs[0]["values_real"], outs[1]["values_real"],
                               rtol=1e-10)
    assert max(outs[0]["residuals"]) <= 1e-8
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_device_loop_boundary_resume_on_card(dev, tmp_path):
    # the device loop (CUDA graphs) stopped after 5 cycles, dumped, loaded
    # into a fresh solver and resumed: the unbroken solve's counters and
    # values bit for bit, the resumed loop's graphs replayed
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core.device_sym import FusedSymSolver
    from arpack_ng_tpu_torch.io import checkpoint as ckpt
    from arpack_ng_tpu_torch.models import laplacian_2d
    from arpack_ng_tpu_torch.ops import cuda_sym_cycle
    op, _ = laplacian_2d(64, np.float32, device=dev)
    cfg = pt.IRAMConfig(n=op.n, nev=6, ncv=24, which="LA", tol=1e-5,
                        max_iter=1000, symmetric=True,
                        dtype=np.dtype(np.float32), n_pad=op.n_pad,
                        reorth="selective")
    full = FusedSymSolver(op, cfg).solve()
    assert full.n_iter > 10
    first = FusedSymSolver(op, cfg)
    out = first.multi(first.init_state(), 5)
    ckpt.save_state(tmp_path / "ck.npz", out.state, cfg)
    st, _ = ckpt.load_state(tmp_path / "ck.npz", cfg=cfg, device=dev)
    before = (cuda_sel.sel_proj.launches, cuda_sym_cycle.sym_cycle.launches)
    res = FusedSymSolver(op, cfg).solve(state=st)
    assert cuda_sel.sel_proj.launches > before[0]
    assert cuda_sym_cycle.sym_cycle.launches > before[1]
    assert res.stats.graph_replays > 0
    assert res.stats.packets == res.n_iter - 5
    assert (res.n_iter, res.stats.nopx, res.stats.nrorth, res.stats.nrotr) \
        == (full.n_iter, full.stats.nopx, full.stats.nrorth, full.stats.nrotr)
    np.testing.assert_array_equal(res.ritz, full.ritz)
    torch.cuda.synchronize()


@pytest.fixture
def nccl_mesh(dev):
    """A world of one under NCCL on the card (NCCL runs one rank per
    device), torn down after the test."""
    import socket

    import torch.distributed as dist

    from arpack_ng_tpu_torch.parallel import make_mesh
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield make_mesh(device=torch.device("cuda", 0))
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("reorth", ["selective", "dgks"])
def test_mesh_world_of_one_equals_single_on_card(nccl_mesh, reorth):
    # a world of one sums nothing: mesh= (through the gathered stencil and
    # the halo operator) gives the single path's counters and values bit
    # for bit, on the device loop (selective and dgks), its NCCL
    # collectives captured in the loop's graphs
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models import laplacian_2d
    from arpack_ng_tpu_torch.models.distributed import laplacian_2d_sharded
    mesh = nccl_mesh
    op, _ = laplacian_2d(64, np.float32, device=mesh.device)
    halo, _ = laplacian_2d_sharded(64, 64, mesh, np.float32)
    kw = dict(k=8, ncv=32, which="LA", tol=1e-5, reorth=reorth,
              return_stats=True)
    v1, x1, o1 = pt.eigsh(op, **kw)
    for o in (op, halo):
        v2, x2, o2 = pt.eigsh(o, mesh=mesh, **kw)
        for f in ("n_iter", "nopx", "nrorth", "nrorthr", "nitref", "nrotr"):
            assert getattr(o1.stats, f) == getattr(o2.stats, f), f
        np.testing.assert_array_equal(v1, v2)
        np.testing.assert_array_equal(x1, x2)
        assert o2.stats.collectives["all_reduce"] >= o2.stats.nopx
        assert o2.stats.graphs_captured > 0 and o2.stats.graph_replays > 0
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_mesh_graph_capture_on_card(nccl_mesh):
    # NCCL's collectives are captured in the device loop's graphs: one
    # packet per cycle, every cycle after the first replayed, and the
    # captured collectives counted on every replay (four all-reduces and
    # one halo exchange per Lanczos step, a norm per restart)
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models.distributed import laplacian_2d_sharded
    mesh = nccl_mesh
    assert mesh.transport == "nccl" and mesh.capturable
    op, a_sp = laplacian_2d_sharded(64, 64, mesh, np.float32)
    vals, vecs, out = pt.eigsh(op, k=8, ncv=32, which="LA", tol=1e-5,
                               mesh=mesh, return_stats=True)
    st = out.stats
    assert st.graphs_captured > 0 and st.graph_replays == st.n_iter - 1
    assert st.packets == st.n_iter
    c = st.collectives
    assert c["halo"] == st.nopx and c["all_gather"] == 0
    assert 4 * (st.nopx - 1) <= c["all_reduce"] <= 4 * st.nopx + st.n_iter
    res = np.linalg.norm(a_sp @ vecs - vecs * vals, axis=0)
    assert res.max() < 1e-3 * np.abs(vals).max()
    torch.cuda.synchronize()


# ---- the real non-symmetric reduced space (csrc/realnonsym_cycle.cu) ------

def _smoke():
    """``chip_smoke.py``, whose harness of the real reduced-space kernel
    (its inputs, runs, gaps, limits and guard band, and the host-reduced
    witness) these card tests share, so that the card test and the smoke
    decide 'correct' alike."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def _eig_condition(H):
    """eps times the largest eigenvalue condition number of H times
    ||H||_2 over max |lambda|: the relative error a backward-stable
    eigensolve may leave in H's values, and the scale of what two of them
    may disagree by."""
    import scipy.linalg as sla
    w, vl, vr = sla.eig(H, left=True, right=True)
    kappa = 1.0 / np.abs(np.sum(vl.conj() * vr, axis=0))
    return (np.finfo(np.float64).eps * kappa.max() * np.linalg.norm(H, 2)
            / np.abs(w).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ncv", [8, 32, 72])
def test_realnonsym_cycle_kernel_matches_twin_on_card(dev, dtype, ncv):
    # one cycle's real reduced space, the kernel against its numpy twin on
    # Arnoldi Hessenbergs of the convection-diffusion matrix (nx = 24,
    # rho = 50), every which (ncv 8 and 32: the workspace in shared memory;
    # 72: in global memory), with chip_smoke.py's harness: the packet's
    # counts equal, every gap within RN_LIMITS, the kernel's restart
    # keeping the Arnoldi relation within 10 times RN_LIMITS' H; the
    # implicit-redo flag equal unless the twin's explicit chase lost
    # within RN_GUARD_BAND of the guard's limit (then the kernel's restart
    # is held to the relation the flag it took promises); a last cycle
    # leaves H as it was.  The inputs at ncv 8 and 32 are well-conditioned
    # (asserted: 100 eps kappa ||H|| / max|lambda| within RN_LIMITS'
    # values), so every gap is held strictly.  At ncv 72 the input's
    # eigenvalue condition numbers reach 1e8 and two backward-stable
    # reduced spaces differ by up to eps kappa ||H|| / max|lambda|
    # (_eig_condition): there the values and bounds are held to 100 times
    # that, and the kept Q and Hc, whose differences grow with it, to the
    # Arnoldi relation alone
    from arpack_ng_tpu_torch.ops import cuda_realnonsym_cycle as crc
    smoke = _smoke()
    P = crc.P_HEAD
    dt = getattr(torch, dtype)
    lim = smoke.RN_LIMITS[str(dt)]
    assert crc.fits_shared(ncv) == (ncv <= 68)
    H, rn = smoke._arnoldi_hessenberg(ncv, ncv, nx=24, rho=50.0)
    H = H.astype(dtype).astype(np.float64)
    cond = 100 * _eig_condition(H)
    ill = ncv == 72 and cond > lim["values"]
    if ncv < 72:
        assert cond <= lim["values"], cond
    loose = dict(lim, values=max(lim["values"], cond),
                 bounds=max(lim["bounds"], cond)) if ill else lim
    bad = []
    for which in crc.WHICH:
        p = smoke._rn_params(crc, str(dt), which, max(2, ncv // 4))
        for is_last in (False, True):
            kern = smoke._rn_run(torch, crc, H, rn, dt, dev, p, is_last)
            twin = smoke._rn_run(torch, crc, H, rn, dt, torch.device("cpu"),
                                 p, is_last)
            what = f"{which} last={is_last}"
            g = smoke._rn_gaps(crc, twin, kern, H)
            if not g.pop("counts_equal"):
                bad.append((what, "counts", kern[3][:P], twin[3][:P]))
            same_impl = g.pop("implicit_equal")
            if is_last or twin[3][crc.P_DONE]:
                if not np.array_equal(kern[0], H):
                    bad.append((what, "H changed"))
                g = {k: v for k, v in g.items() if k in ("values", "bounds")}
            else:
                if not np.array_equal(kern[3][P + 3 * ncv:],
                                      kern[0].ravel()):
                    bad.append((what, "packet H"))
                relation = g.pop("relation")
                if ill:
                    g = {k: v for k, v in g.items()
                         if k in ("values", "bounds")}
                if ill or same_impl:
                    if relation > 10 * lim["H"]:
                        bad.append((what, "relation", relation))
                else:
                    try:
                        smoke._rn_guard_case(crc, H, rn, p, kern,
                                             {"relation": relation}, lim,
                                             what)
                    except AssertionError as e:
                        bad.append(str(e))
            bad += [(what, key, v) for key, v in g.items()
                    if v > loose[key]]
    assert not bad, bad
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_realnonsym_cycle_repeats_bit_for_bit_on_card(dev, dtype):
    # one block, no atomics: two launches on the same input agree bit for
    # bit
    from arpack_ng_tpu_torch.ops import cuda_realnonsym_cycle as crc
    smoke = _smoke()
    dt = getattr(torch, dtype)
    H, rn = smoke._arnoldi_hessenberg(32, 1, nx=24, rho=50.0)
    p = smoke._rn_params(crc, str(dt), "LM", 8)
    a = smoke._rn_run(torch, crc, H, rn, dt, dev, p)
    b = smoke._rn_run(torch, crc, H, rn, dt, dev, p)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _rn_held(smoke, crc, H, rn, dt, dev, p, is_last=False):
    """One real reduced-space case on the card, with chip_smoke.py's
    harness: the kernel against its twin (the packet's counts equal, every
    gap within RN_LIMITS, the implicit redo decided alike or within the
    guard's band) and two launches equal bit for bit.  Returns the faults
    and the kernel's outputs."""
    lim = smoke.RN_LIMITS[str(dt)]
    kern = smoke._rn_run(torch, crc, H, rn, dt, dev, p, is_last)
    again = smoke._rn_run(torch, crc, H, rn, dt, dev, p, is_last)
    twin = smoke._rn_run(torch, crc, H, rn, dt, torch.device("cpu"), p,
                         is_last)
    bad = []
    if not all(np.array_equal(a, b) for a, b in zip(kern, again)):
        bad.append("two launches differ")
    g = smoke._rn_gaps(crc, twin, kern, H)
    if not g.pop("counts_equal"):
        bad.append(("counts", kern[3][:crc.P_HEAD], twin[3][:crc.P_HEAD]))
    if not g.pop("implicit_equal"):
        try:
            smoke._rn_guard_case(crc, H, rn, p, kern, g, lim, "redo")
        except AssertionError as e:
            bad.append(str(e))
    bad += [(k, v) for k, v in g.items() if k in lim and v > lim[k]]
    return bad, kern


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ncv", [3, 68, 69])
def test_realnonsym_cycle_edge_sizes_on_card(dev, dtype, ncv):
    # the smallest ncv (np_eff of 1 or 2, a double shift at the last
    # position), the last ncv whose workspace fits in shared memory (68)
    # and the first past it (69: the matrices in global memory), on phase
    # 9's Arnoldi Hessenbergs, every which, two seeds: the kernel against
    # its twin within RN_LIMITS, two launches equal bit for bit
    from arpack_ng_tpu_torch.ops import cuda_realnonsym_cycle as crc
    smoke = _smoke()
    dt = getattr(torch, dtype)
    assert crc.fits_shared(ncv) == (ncv <= 68)
    bad = []
    for seed in (0, 1):
        H, rn = smoke._arnoldi_hessenberg(ncv, seed)
        H = H.astype(dtype).astype(np.float64)
        for which in crc.WHICH:
            p = smoke._rn_params(crc, str(dt), which, max(1, ncv // 4))
            faults, _ = _rn_held(smoke, crc, H, rn, dt, dev, p)
            bad += [(seed, which, f) for f in faults]
    assert not bad, bad
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["brk", "done", "last", "sweeps"])
def test_realnonsym_cycle_exits_on_card(dev, dtype, case, monkeypatch):
    # each early exit at ncv 32: an extension that stopped short (brk = 3:
    # only the packet's header, H, Q and sk untouched), a converged cycle
    # (rnorm 1e-30: done, H as it was), a last cycle (H as it was), and a
    # Schur loop cut by its sweep count (SWEEPS_PER_EV = 1, the twin cut
    # alike); the kernel against its twin within RN_LIMITS, two launches
    # equal bit for bit
    from arpack_ng_tpu_torch.ops import cuda_realnonsym_cycle as crc
    smoke = _smoke()
    dt = getattr(torch, dtype)
    H, rn = smoke._arnoldi_hessenberg(32, 0)
    H = H.astype(dtype).astype(np.float64)
    p = smoke._rn_params(crc, str(dt), "LM", 8)
    if case == "brk":
        outs = []
        for where in (dev, torch.device("cpu"), dev):
            bufs = smoke._rn_buffers(torch, crc, H, rn, dt, where)
            bufs[2].fill_(3)
            crc.realnonsym_cycle(*bufs, p, False)
            outs.append([x.double().cpu().numpy() for x in bufs])
        for a, b in zip(outs[0], outs[2]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(outs[0], outs[1]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(outs[0][0], H)
        assert outs[0][7][crc.P_BRK] == 3 and not outs[0][7][crc.P_HEAD:].any()
        return
    if case == "done":
        rn = 1e-30
    if case == "sweeps":
        monkeypatch.setattr(crc, "SWEEPS_PER_EV", 1)
    bad, kern = _rn_held(smoke, crc, H, rn, dt, dev, p, case == "last")
    assert not bad, bad
    exits = case in ("done", "last")
    assert bool(kern[3][crc.P_DONE]) == (case == "done")
    assert np.array_equal(kern[0], H) == exits
    np.testing.assert_array_equal(kern[3][crc.P_HEAD + 3 * 32:],
                                  kern[0].ravel())


@pytest.mark.gpu
@pytest.mark.parametrize("ncv", [32, 69])
def test_realnonsym_cycle_stamps_on_card(dev, ncv):
    # the stamp buffer: the phases' stamps in order, the laps and counts
    # of a cycle that sweeps and shifts, and the outputs bit for bit those
    # of a launch without it
    from arpack_ng_tpu_torch.ops import cuda_realnonsym_cycle as crc
    smoke = _smoke()
    H, rn = smoke._arnoldi_hessenberg(ncv, 0)
    H = H.astype(np.float32).astype(np.float64)
    p = smoke._rn_params(crc, "torch.float32", "LM", 8 if ncv == 32 else 17)
    outs = []
    clk = torch.zeros(crc.clock_size(ncv), dtype=torch.int64, device=dev)
    for clocks in (None, clk):
        bufs = smoke._rn_buffers(torch, crc, H, rn, torch.float32, dev)
        crc.realnonsym_cycle(*bufs, p, False, clocks=clocks)
        outs.append([x.double().cpu().numpy() for x in bufs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    c = clk.cpu().numpy()
    nc, nl = len(crc.CLOCKS), len(crc.LAPS)
    assert np.all(np.diff(c[:nc]) >= 0) and c[nc - 1] > c[0]
    assert np.all(c[nc:nc + nl] > 0)
    sweeps, shifts = c[nc + nl:]
    assert 0 < sweeps <= crc.SWEEPS_PER_EV * ncv
    assert 0 < shifts <= outs[1][7][crc.P_NP]
    # the laps lie within the Schur sweeps and the chase
    assert c[nc:nc + nl].sum() <= c[crc.CLOCKS.index("chase")] - c[0]


def _convdiff_small(dev, capturable=True, nx=64):
    import dataclasses

    from arpack_ng_tpu_torch.models import convection_diffusion_2d
    op, a = convection_diffusion_2d(nx, dtype=np.float32, device=dev)
    return dataclasses.replace(op, capturable=capturable), a


@pytest.mark.gpu
def test_realnonsym_graph_replay_equals_eager_on_card(dev):
    # eigs's real loop with its extensions replayed as CUDA graphs gives
    # the eager card run bit for bit; one packet and one reduced-space
    # launch per cycle (and per extension the host finished)
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core import arnoldi
    from arpack_ng_tpu_torch.ops import cuda_realnonsym_cycle as crc
    runs = []
    for capturable in (True, False):
        op, _ = _convdiff_small(dev, capturable)
        arnoldi.reruns.update(redo=0, breakdown=0)
        crc.realnonsym_cycle.launches = 0
        vals, vecs, out = pt.eigs(op, k=8, ncv=32, which="LM", tol=1e-5,
                                  maxiter=300, return_stats=True)
        st = out.stats
        rr = sum(arnoldi.reruns.values())
        assert st.packets == st.n_iter + rr == crc.realnonsym_cycle.launches
        runs.append((vals, vecs, st))
    (v1, x1, s1), (v2, x2, s2) = runs
    assert s1.graphs_captured > 0 and s1.graph_replays == s1.n_iter - 1
    assert s2.graphs_captured == 0
    for f in ("n_iter", "nopx", "nrorth", "nitref", "nrotr", "packets"):
        assert getattr(s1, f) == getattr(s2, f), f
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(x1, x2)


@pytest.mark.gpu
def test_realnonsym_device_loop_equals_host_loop_on_card(dev):
    # conv-diff nx = 64, float32: the host loop over the numpy head and
    # tail (HostLoopSolver.solve) and the device loop with the reduced
    # space patched to its host twin (the host-reduced witness) agree bit
    # for bit; with the kernel, the values within 1e-4 |lambda| of the
    # witness's and the residuals under 1e-3
    from unittest import mock

    from arpack_ng_tpu_torch.config import IRAMConfig
    from arpack_ng_tpu_torch.core import device_realnonsym as drn
    from arpack_ng_tpu_torch.core.extract import extract
    from arpack_ng_tpu_torch.core.iram import HostLoopSolver
    op, a = _convdiff_small(dev)
    cfg = IRAMConfig(n=op.n, nev=8, ncv=32, which="LM", symmetric=False,
                     dtype=np.dtype(np.float32), n_pad=op.n_pad, tol=1e-5,
                     max_iter=300)
    host = HostLoopSolver.solve(drn.FusedRealNonsymSolver(op, cfg))
    with mock.patch.object(drn, "realnonsym_cycle",
                           _smoke()._host_realnonsym_cycle):
        witness = drn.FusedRealNonsymSolver(op, cfg).solve()
    kernel = drn.FusedRealNonsymSolver(op, cfg).solve()
    for f in ("n_iter", "nopx", "nbx", "nrorth", "nitref", "nrstrt",
              "nrotr"):
        assert getattr(witness.stats, f) == getattr(host.stats, f), f
    np.testing.assert_array_equal(witness.ritz, host.ritz)
    assert torch.equal(witness.state.V, host.state.V)
    assert kernel.stats.packets >= kernel.n_iter
    assert kernel.stats.graphs_captured > 0
    k = min(kernel.nconv, witness.nconv)
    assert k >= 8
    got = np.sort_complex(kernel.ritz[:k])
    want = np.sort_complex(witness.ritz[:k])
    assert np.max(np.abs(got - want) / np.abs(want)) < 1e-4
    out = extract(op, cfg, kernel)
    v = np.asarray(out.vectors, np.complex128)
    res = np.linalg.norm(a @ v - v * out.values, axis=0) / np.abs(out.values)
    assert res.max() < 1e-3
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_realnonsym_kernel_build_failure_raises_on_card(dev, tmp_path,
                                                        monkeypatch):
    # a source that does not compile makes the build raise (no fallback)
    import shutil

    from arpack_ng_tpu_torch.ops import cuda_lib
    src = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC, src)
    (src / "realnonsym_cycle.cu").write_text(
        (src / "realnonsym_cycle.cu").read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(cuda_lib, "CSRC", src)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_lib, "SOURCES", ("realnonsym_cycle.cu",))
    monkeypatch.setattr(cuda_lib, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_lib.load()


def _kernel_launches():
    """Every graph-held kernel wrapper's launch count, set to 0 first by
    :func:`_zero_launches`."""
    from arpack_ng_tpu_torch.core.loop import GRAPH_KERNELS
    return {f.__name__: f.launches for f in GRAPH_KERNELS}


def _zero_launches():
    from arpack_ng_tpu_torch.core.loop import GRAPH_KERNELS
    for f in GRAPH_KERNELS:
        f.launches = 0


def _hybrid_case(dev, case):
    """(operator, config) of a hybrid card case at a small width."""
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.config import IRAMConfig
    from arpack_ng_tpu_torch.models import convection_diffusion_2d
    if case in ("selective", "dgks"):
        op = _flagship_small(dev)
        kw = dict(which="LA", symmetric=True, reorth=case)
    elif case == "hermitian":
        import scipy.sparse as sp

        from arpack_ng_tpu_torch.models import laplacian_2d
        a = laplacian_2d(64, np.float64, device="cpu")[1]
        h = (a + 0.5j * (sp.eye(a.shape[0], k=1)
                         - sp.eye(a.shape[0], k=-1))).tocsr()
        op = pt.from_scipy(h, dtype=np.complex64, hermitian=True,
                           device=dev)
        kw = dict(which="LA", symmetric=True, reorth="selective")
    else:
        op, _ = convection_diffusion_2d(64, dtype=np.complex64, device=dev)
        kw = dict(which="LM", symmetric=False, reorth="dgks")
    cfg = IRAMConfig(n=op.n, nev=8, ncv=32, dtype=np.dtype(op.dtype),
                     n_pad=op.n_pad, tol=1e-5, max_iter=300, **kw)
    return op, cfg


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["selective", "dgks", "hermitian",
                                  "complex nonsym"])
def test_hybrid_graphs_equal_host_loop_on_card(dev, case):
    # the hybrid on the device loop (a CUDA graph per start k, one packet
    # a cycle, the host's reduce step) gives its eager host loop bit for
    # bit, and the replayed graphs' launch counts equal the host loop's
    from arpack_ng_tpu_torch.core import arnoldi
    from arpack_ng_tpu_torch.core.extract import extract
    from arpack_ng_tpu_torch.core.iram import IRAMSolver
    op, cfg = _hybrid_case(dev, case)
    runs = []
    for host_loop in (False, True):
        solver = IRAMSolver(op, cfg)
        solver._host_loop = host_loop
        arnoldi.reruns.update(redo=0, breakdown=0)
        _zero_launches()
        res = solver.solve()
        out = extract(op, cfg, res)
        runs.append((res, out, _kernel_launches(),
                     sum(arnoldi.reruns.values())))
    (r1, o1, l1, rr), (r2, o2, l2, _) = runs
    st = r1.stats
    assert st.graphs_captured > 0 and st.graph_replays == r1.n_iter - 1
    assert st.packets == r1.n_iter + rr and r2.stats.packets == 0
    for f in ("n_iter", "nopx", "nbx", "nrorth", "nitref", "nrstrt", "nrotr",
              "nrorthr"):
        assert getattr(st, f) == getattr(r2.stats, f), f
    # one rotation a restart, but the complex Arnoldi restart's GEMM
    assert l1 == l2
    assert l1["rotate_rows"] == (0 if case == "complex nonsym"
                                 else r1.n_iter - 1)
    np.testing.assert_array_equal(r1.ritz, r2.ritz)
    assert torch.equal(r1.state.V, r2.state.V)
    np.testing.assert_array_equal(o1.values, o2.values)
    np.testing.assert_array_equal(o1.vectors, o2.vectors)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2, 4])
def test_block_graph_equals_eager_on_card(dev, b):
    # the block cycle's restart and refill on one CUDA graph per solve give
    # the eager cycles bit for bit, with equal cycles, matvecs and
    # launches (the replays add the capture's counts)
    import dataclasses

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core import loop
    from arpack_ng_tpu_torch.core.block import eigsh_block
    from arpack_ng_tpu_torch.models import laplacian_2d
    a = laplacian_2d(128, np.float32, device="cpu")[1]
    A = pt.from_scipy(a, dtype=np.float32, hermitian=True, device=dev)
    assert A.apply_block is not None and A.capturable
    runs = []
    replays = []
    real = loop.CapturedGraph.replay

    def counted(self):
        replays.append(self)
        return real(self)

    for op in (A, dataclasses.replace(A, capturable=False)):
        _zero_launches()
        loop.CapturedGraph.replay = counted
        try:
            out = eigsh_block(op, k=8, ncv=32, tol=1e-5, block_size=b,
                              maxiter=500, dtype=np.float32)
        finally:
            loop.CapturedGraph.replay = real
        runs.append((out, _kernel_launches(), len(replays)))
    ((v1, x1, i1), l1, n1), ((v2, x2, i2), l2, n2) = runs
    assert n1 == i1["iters"] - 1 and n2 == n1     # no replay when eager
    assert i1 == i2 and l1 == l2
    assert l1["dia_block_matvec"] == i1["matvecs"] // b
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(x1, x2)
    torch.cuda.synchronize()


# ---- the complex reduced space (csrc/cplx_cycle.cu, row 13) ---------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
@pytest.mark.parametrize("ncv", [3, 12, 32, 52, 53, 100])
def test_cplx_cycle_kernel_matches_twin_on_card(dev, dtype, ncv):
    # one cycle's complex reduced space, the kernel against its numpy twin
    # on complex Arnoldi Hessenbergs of every source of chip_smoke.
    # _cx_hessenberg (the workspace in shared memory up to ncv 52, in
    # global memory past it), every which, under chip_smoke.py's
    # _cx_case_faults: the packet's counts equal, np_eff shifts applied
    # (none in a last cycle), the shifted kept block's values the packet's
    # kept values, every gap within CX_LIMITS (the values and bounds
    # loosened by the input's eigenvalue condition; Q and Hc exempt where
    # that condition is past the value limit, and the kept block where the
    # twin's own misses its limit), the normal source exempt from nothing,
    # a last cycle leaving H
    from arpack_ng_tpu_torch.ops import cuda_cplx_cycle as ccc
    smoke = _smoke()
    dt = getattr(torch, dtype)
    lim = smoke.CX_LIMITS[str(dt)]
    assert ccc.fits_shared(ncv) == (ncv <= 52)
    bad, exempt = [], {}
    for source in smoke.CX_SOURCES:
        H, rn = smoke._cx_hessenberg(ncv, ncv, source)
        H = H.astype(dtype).astype(np.complex128)
        cond = smoke._cx_cond(H)
        for which in ccc.WHICH:
            p = smoke._cx_params(ccc, str(dt), which, max(1, ncv // 4))
            for is_last in (False, True):
                kern = smoke._cx_run(torch, ccc, H, rn, dt, dev, p, is_last,
                                     shifts=True)
                twin = smoke._cx_run(torch, ccc, H, rn, dt,
                                     torch.device("cpu"), p, is_last)
                what = f"cplx_cycle {source} {which} last={is_last}"
                bad += smoke._cx_case_faults(ccc, twin, kern, H, p, lim,
                                             cond, what, {}, [], exempt)
                if is_last and not np.array_equal(kern[0], H):
                    bad.append((what, "H changed"))
    assert not [w for w in exempt if w.startswith("normal ")], exempt
    assert not bad, bad
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_cplx_cycle_repeats_and_leaves_exits_on_card(dev, dtype):
    # one block, no atomics: two launches on the same input agree bit for
    # bit; a done cycle, a last cycle and a breakdown leave H, Q and sk as
    # they were, the breakdown's packet the twin's (its header alone)
    from arpack_ng_tpu_torch.ops import cuda_cplx_cycle as ccc
    smoke = _smoke()
    dt = getattr(torch, dtype)
    H, rn = smoke._cx_hessenberg(32, 1, "convdiff")
    H = H.astype(dtype).astype(np.complex128)
    p = smoke._cx_params(ccc, str(dt), "LM", 8)
    a = smoke._cx_run(torch, ccc, H, rn, dt, dev, p)
    b = smoke._cx_run(torch, ccc, H, rn, dt, dev, p)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # the stamps: phase ends in order, the laps and counts of this input
    bufs = smoke._cx_buffers(torch, ccc, H, rn, dt, dev)
    clk = torch.zeros(ccc.clock_size(32), dtype=torch.int64, device=dev)
    ccc.cplx_cycle(*bufs, p, False, clocks=clk)
    c = clk.cpu().numpy()
    nc, nl = len(ccc.CLOCKS), len(ccc.LAPS)
    assert np.all(np.diff(c[:nc]) >= 0) and np.all(c[nc:nc + nl] > 0)
    assert c[-2] >= 1 and c[-1] == int(a[3][ccc.P_NP])
    np.testing.assert_array_equal(bufs[7].cpu().numpy(), a[3])
    for p, is_last, brk in ((smoke._cx_params(ccc, str(dt), "LM", 8,
                                              tol=0.5), False, -1),
                            (p, True, -1), (p, False, 7)):
        kern = smoke._cx_run(torch, ccc, H, rn, dt, dev, p, is_last, brk)
        np.testing.assert_array_equal(kern[0], H)
        assert not kern[1].any() and not kern[2].any()
        if brk != -1:
            twin = smoke._cx_run(torch, ccc, H, rn, dt, torch.device("cpu"),
                                 p, is_last, brk)
            np.testing.assert_array_equal(kern[3], twin[3])
        elif not is_last:
            assert kern[3][ccc.P_DONE] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("ncv", [32, 53])
@pytest.mark.parametrize("source", ["convdiff", "normal"])
def test_cplx_cycle_stamps_on_card(dev, source, ncv):
    # the stamps of a cycle that sweeps and shifts: its Schur sweeps and the
    # chase's shifts as the twin takes them (its np.linalg.qr calls in the
    # Schur form and the chase), the phase ends in order, the laps (the
    # shift choice, the reflector chain, the tail behind it) non-negative
    # and within the Schur sweeps and the chase, and the outputs bit for bit
    # those of a launch without the buffer
    from unittest import mock

    from arpack_ng_tpu_torch.ops import cuda_cplx_cycle as ccc
    smoke = _smoke()
    dt = torch.complex64
    H, rn = smoke._cx_hessenberg(ncv, 0, source)
    H = H.astype(np.complex64).astype(np.complex128)
    p = smoke._cx_params(ccc, str(dt), "LM", max(1, ncv // 4))
    outs = []
    clk = torch.zeros(ccc.clock_size(ncv), dtype=torch.int64, device=dev)
    for clocks in (None, clk):
        bufs = smoke._cx_buffers(torch, ccc, H, rn, dt, dev)
        ccc.cplx_cycle(*bufs, p, False, clocks=clocks)
        outs.append([x.cpu().numpy() for x in bufs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    calls = {"schur": 0, "chase": 0}
    where = ["schur"]
    real_qr = np.linalg.qr

    def qr(M, *args, **kwargs):
        calls[where[0]] += 1
        return real_qr(M, *args, **kwargs)

    with mock.patch.object(np.linalg, "qr", qr):
        h = ccc.head_plain(H, np.float64(np.float32(rn)), p)
        where[0] = "chase"
        if not (h.done):
            ccc.shifts_plain(H, h, p)
    c = clk.cpu().numpy()
    nc, nl = len(ccc.CLOCKS), len(ccc.LAPS)
    assert ccc.LAPS == ("shift", "chain", "tail")
    assert np.all(np.diff(c[:nc]) >= 0) and c[nc - 1] > c[0]
    assert np.all(c[nc:nc + nl] >= 0) and c[nc + 1] > 0
    sweeps, shifts = c[nc + nl:]
    assert (sweeps, shifts) == (calls["schur"], calls["chase"])
    assert shifts == int(outs[1][7][ccc.P_NP]) > 0
    schur, chase = (c[ccc.CLOCKS.index(k)] - c[ccc.CLOCKS.index(k) - 1]
                    for k in ("schur", "chase"))
    assert c[nc:nc + nl].sum() <= schur + chase
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("problem", ["realified", "stencil"])
def test_cplx_device_loop_equals_host_loop_on_card(dev, problem):
    # conv-diff nx = 64, complex64 (float32 input complexified, or the
    # complex64 stencil): the host loop over the numpy head and tail
    # (HostLoopSolver.solve) and the device loop with the reduced space
    # patched to its host twin (the host-reduced witness) agree bit for
    # bit; with the kernel, a graph per start k, one packet and one
    # launch a cycle, 8 converged values and residuals under 1e-3
    from unittest import mock

    from arpack_ng_tpu_torch.config import IRAMConfig
    from arpack_ng_tpu_torch.core import device_nonsym as dn
    from arpack_ng_tpu_torch.core.extract import extract
    from arpack_ng_tpu_torch.core.iram import HostLoopSolver
    from arpack_ng_tpu_torch.models import convection_diffusion_2d
    from arpack_ng_tpu_torch.ops import cuda_cplx_cycle as ccc
    if problem == "realified":
        op, a = convection_diffusion_2d(64, dtype=np.float32, device=dev)
        op = dn.complexify_operator(op)
    else:
        op, a = convection_diffusion_2d(64, dtype=np.complex64, device=dev)
    cfg = IRAMConfig(n=op.n, nev=8, ncv=32, which="LM", symmetric=False,
                     dtype=np.dtype(np.complex64), n_pad=op.n_pad, tol=1e-5,
                     max_iter=300)
    host = HostLoopSolver.solve(dn.FusedNonsymSolver(op, cfg))
    with mock.patch.object(dn, "cplx_cycle", _smoke()._host_cplx_cycle):
        witness = dn.FusedNonsymSolver(op, cfg).solve()
    ccc.cplx_cycle.launches = 0
    kernel = dn.FusedNonsymSolver(op, cfg).solve()
    for f in ("n_iter", "nopx", "nbx", "nrorth", "nitref", "nrstrt",
              "nrotr"):
        assert getattr(witness.stats, f) == getattr(host.stats, f), f
    np.testing.assert_array_equal(witness.ritz, host.ritz)
    assert torch.equal(witness.state.V, host.state.V)
    st = kernel.stats
    assert st.packets == ccc.cplx_cycle.launches >= kernel.n_iter
    assert st.graphs_captured > 0
    assert kernel.nconv >= 8
    out = extract(op, cfg, kernel)
    v = np.asarray(out.vectors, np.complex128)
    res = np.linalg.norm(a @ v - v * out.values, axis=0) / np.abs(out.values)
    assert res.max() < 1e-3
    torch.cuda.synchronize()


def _lap_dia(dev, nx):
    """The 2-D Laplacian imported as DIA on ``dev``, its IC(0) and ILU(0)
    preconditioners (the DIA kernel for the triangles), a seeded rhs."""
    import scipy.sparse as sp

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.ops import solvers
    eye = sp.eye(nx)
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    a = (sp.kron(eye, t) + sp.kron(t, eye)).tocsr()
    op = pt.from_scipy(a, format="dia", device=dev)
    pcs = {sym: solvers.ilu0_preconditioner(a, symmetric=sym,
                                            n_pad=op.n_pad, device=dev)
           for sym in (True, False)}
    b = torch.zeros(op.n_pad, dtype=torch.float64)
    b[: nx * nx] = torch.from_numpy(
        np.random.default_rng(7).standard_normal(nx * nx))
    return a, op, pcs, b.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_krylov_test_kernel_edge_inputs_on_card(dev, dtype):
    # the loop test's decision, launched alone, equals the host loop's
    # comparison on the card's values: |r.r| = atol2 and one ulp either
    # side, nan, it = maxiter - 1, maxiter = 0, b = 0; the rho == 0 flag
    from arpack_ng_tpu_torch.ops import cuda_krylov_loop as kl
    npd = np.float32 if dtype == torch.float32 else np.float64
    one = npd(1.0)
    for rr, a2, it0, maxiter in (
            (one, one, 0, 5), (np.nextafter(one, npd(2)), one, 0, 5),
            (np.nextafter(one, npd(0)), one, 0, 5), (np.nan, one, 0, 5),
            (2.0, one, 4, 5), (2.0, one, 5, 5), (2.0, one, 0, 0),
            (0.0, 0.0, 0, 5)):
        rr_d = torch.tensor(rr, dtype=dtype, device=dev)
        a2_d = torch.tensor(a2, dtype=dtype, device=dev)
        go = torch.zeros((), dtype=torch.int32, device=dev)
        it = torch.tensor(it0, dtype=torch.int32, device=dev)
        kl.krylov_test(rr_d, a2_d, it, maxiter, bump=0, go=go)
        host = it0 < maxiter and bool(rr_d > a2_d)
        assert bool(go.item()) is host, (rr, a2, it0, maxiter)
    for rho in (1.0, -0.0, 0.0):
        brk = torch.zeros((), dtype=torch.bool, device=dev)
        kl.krylov_test(torch.tensor(2.0, dtype=dtype, device=dev),
                       torch.tensor(1.0, dtype=dtype, device=dev),
                       torch.zeros((), dtype=torch.int32, device=dev), 5,
                       bump=0, rho=torch.tensor(rho, dtype=dtype,
                                                device=dev), brk=brk)
        assert bool(brk.item()) is (rho == 0)
    assert min(kl.versions().values()) >= kl.MIN_CUDA
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("symmetric", [True, False])
def test_while_node_solve_equals_host_loop_on_card(dev, symmetric):
    # one CG / BiCGSTAB solve captured as a WHILE node and replayed three
    # times gives the host loop's solution bit for bit and its iteration
    # count each time; the body's launches counted per iteration
    from arpack_ng_tpu_torch.core.loop import CapturedGraph
    from arpack_ng_tpu_torch.ops import cuda_krylov_loop as kl
    from arpack_ng_tpu_torch.ops import solvers
    _, op, pcs, b = _lap_dia(dev, 64)
    kw = dict(symmetric=symmetric, tol=1e-10, maxiter=2000,
              precond=pcs[symmetric])
    host = solvers.make_iterative_solve(op.a_apply, **kw)
    x_host = host(b)
    node = solvers.make_iterative_solve(op.a_apply, **kw)
    node.bind(dev)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    kernels = (cuda_dia.dia_matvec, cuda_dia.dia_matvec_sub,
               kl.krylov_test, *kl.UPDATES)
    c0 = [f.launches for f in kernels]
    with torch.cuda.stream(stream):
        graph = CapturedGraph(lambda: node(b), torch.cuda.graph_pool_handle())
        for _ in range(3):
            x_node = graph.replay()
    its = host.iterations[0]
    assert node.iterations == [its] * 3 and all(node.on_graph)
    assert torch.equal(x_node, x_host)
    got = {f.__name__: f.launches - c for f, c in zip(kernels, c0)}
    # per iteration: the products, the sweeps (the DIA kernel's epilogue
    # form) and the update kernels, the last of which runs the loop test;
    # before each node: r = b - A x (and z = M^-1 r for CG) and one test
    if symmetric:
        want = {"dia_matvec": its + 1, "dia_matvec_sub": 6 * its + 6,
                "cg_xr": its, "cg_p_test": its}
    else:
        want = {"dia_matvec": 2 * its + 1, "dia_matvec_sub": 12 * its,
                "bicg_p": its, "bicg_s": its, "bicg_r": its,
                "bicg_x_test": its}
    want["krylov_test"] = 1
    assert got == {k: 3 * want.get(k, 0) for k in got}
    # outside a capture the bound solve is a graph of its own
    assert torch.equal(node(b), x_host)
    assert node.iterations[-1] == its and node.on_graph[-1]
    assert kl.krylov_test.launches - c0[2] == 4
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "complex128"])
def test_update_kernels_match_twins_on_card(dev, dtype):
    # each fused update kernel equals its twin (the torch ops it replaces)
    # bit for bit: edge inputs at an odd length (a nan, an infinity,
    # signed zeros, a complex nan part), the restart's selects and the
    # rho == 0 flag both ways, z aliasing r; seeded vectors at 12a's length
    import chip_smoke
    for n, edge in ((65_539, True), (1 << 20, False)):
        faults, _ = chip_smoke.krylov_update_faults(
            torch, dev, getattr(torch, dtype), n, edge=edge)
        assert not faults, faults
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_fused_loop_test_edge_inputs_on_card(dev):
    # the loop test as cg_p_test and bicg_x_test run it decides as the host
    # loop does (|rr| = atol2, one ulp either side, nan, a complex rr off
    # the real axis, it = maxiter - 2 and - 1, maxiter = 0), bumps the
    # counter and logs a loop that ends
    import chip_smoke
    assert chip_smoke.fused_test_faults(torch, dev) == []
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_update_kernels_refuse_other_dtypes_on_card(dev):
    from arpack_ng_tpu_torch.ops import cuda_krylov_loop as kl
    for dt in (torch.float16, torch.bfloat16):
        v = [torch.ones(8, dtype=dt, device=dev) for _ in range(4)]
        s = [torch.ones((), dtype=dt, device=dev) for _ in range(3)]
        with pytest.raises(TypeError, match="no CUDA kernel"):
            kl.cg_xr(s[0], s[1], *v, s[2])


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(dia_cases.CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dia_matvec_sub_matches_twin_on_card(dev, dtype, case):
    # the DIA kernel's epilogue forms (y - A x, d (y - A x), y - d (A x))
    # equal their twins bit for bit on the block cases' tables, one launch
    # each, into a given out or a new vector
    import chip_smoke
    offsets, dtab, X, n = dia_cases.make(case, dtype, 3)
    offs = torch.from_numpy(offsets).to(dev)
    tab = torch.from_numpy(dtab).to(dev)
    x, y, d = (torch.from_numpy(X[i]).to(dev) for i in range(3))
    for form in (cuda_dia.SUB, cuda_dia.SCALE_SUB, cuda_dia.SUB_SCALED):
        want = cuda_dia.dia_matvec_sub_plain(offs, tab, x, n, y, d, form)
        before = cuda_dia.dia_matvec_sub.launches
        got = cuda_dia.dia_matvec_sub(offs, tab, x, n, y, d, form)
        out = torch.empty_like(x)
        assert cuda_dia.dia_matvec_sub(offs, tab, x, n, y, d, form,
                                       out=out) is out
        assert cuda_dia.dia_matvec_sub.launches - before == 2
        assert chip_smoke._bit_faults(torch, got, want) == 0, form
        assert chip_smoke._bit_faults(torch, out, want) == 0, form
    with pytest.raises(ValueError, match="overlap"):
        cuda_dia.dia_matvec_sub(offs, tab, x, n, y, out=x)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("symmetric", [True, False])
def test_shift_invert_graphs_equal_host_loop_on_card(dev, symmetric):
    # eigsh (CG + IC(0)) / eigs (BiCGSTAB + ILU(0)) shift-invert declared
    # capturable: every solve a WHILE node (the device loop's graphs
    # captured and replayed where the solve restarts), one packet a
    # cycle, and bit for bit the undeclared operator's host loop (values,
    # vectors, each solve's iterations, counters)
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.ops import solvers, transforms
    a, op_s, pcs, _ = _lap_dia(dev, 48)
    runs = []
    for capt in (True, False):
        solve = solvers.make_iterative_solve(
            op_s.a_apply, symmetric=symmetric, tol=1e-11, maxiter=3000,
            precond=pcs[symmetric])
        op = transforms.shift_invert_operator(
            a.shape[0], np.float64, solve, sigma=0.0, mode=3,
            n_pad=op_s.n_pad, hermitian=symmetric, a_apply=op_s.a_apply,
            device=dev, capturable=capt)
        fn = pt.eigsh if symmetric else pt.eigs
        vals, vecs, out = fn(op, k=6, which="LM", ncv=24, tol=1e-9,
                             return_stats=True)
        runs.append((vals, vecs, out.stats, solve.iterations,
                     solve.on_graph))
    (v1, x1, s1, i1, g1), (v0, x0, s0, i0, g0) = runs
    assert all(g1) and not any(g0) and s1.packets == s1.n_iter
    assert s1.n_iter == 1 or (s1.graphs_captured > 0
                              and s1.graph_replays > 0)
    np.testing.assert_array_equal(v1, v0)
    np.testing.assert_array_equal(x1, x0)
    assert i1 == i0
    for f in ("n_iter", "nopx", "nrorth", "nrorthr"):
        assert getattr(s1, f) == getattr(s0, f), f
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_failed_while_capture_raises_on_card(dev):
    # a solve whose product reads back cannot be a WHILE node's body: the
    # capture raises, nothing runs the host loop in its place
    from arpack_ng_tpu_torch.core.loop import CapturedGraph
    from arpack_ng_tpu_torch.ops import solvers
    _, op, pcs, b = _lap_dia(dev, 32)

    def reading(v):
        y = op.a_apply(v)
        _ = float(y[0])
        return y

    solve = solvers.make_iterative_solve(reading, symmetric=True, tol=1e-8,
                                         maxiter=100)
    solve.bind(dev)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with pytest.raises(RuntimeError):
        with torch.cuda.stream(stream):
            CapturedGraph(lambda: solve(b), torch.cuda.graph_pool_handle())
    assert solve.iterations == []
    torch.cuda.synchronize()
