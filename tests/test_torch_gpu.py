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


@pytest.mark.gpu
@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "float64"])
def test_sel_kernels_match_twins_on_card(dev, sdt):
    g, V, acc, tol = _case(dev, sdt)
    br = torch.randn(V.shape[1], generator=g, device=dev, dtype=acc)
    for K in (8, 16, 24, 32):
        idx = torch.randperm(32, device=dev, generator=g)[:K].int()
        torch.testing.assert_close(cuda_sel.sel_proj(idx, V, br),
                                   cuda_sel.sel_proj_plain(idx, V, br),
                                   **tol)
        s = torch.randn(K, generator=g, device=dev, dtype=acc)
        s[0] = 0
        out, nrm = cuda_sel.sel_update(idx, s, br.clone(), V, True)
        ref, nref = cuda_sel.sel_update_plain(idx, s, br.clone(), V, True)
        torch.testing.assert_close(out, ref, **tol)
        torch.testing.assert_close(nrm, nref, **tol)
        same = cuda_sel.sel_update(idx, torch.zeros_like(s), br.clone(), V)
        assert torch.equal(same, br)
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
@pytest.mark.parametrize("sdt", ["float32", "bfloat16"])
def test_cgs_kernels_match_twins_on_card(dev, sdt):
    g, V, acc, tol = _case(dev, sdt)
    w = torch.randn(V.shape[1], generator=g, device=dev, dtype=acc)
    for rows in (8, 16, 24):
        h = cuda_cgs.cgs_proj(V, w, rows)
        torch.testing.assert_close(h, cuda_cgs.cgs_proj_plain(V, w, rows),
                                   **tol)
        w0 = w.clone()
        for with_norm in (False, True):
            out = cuda_cgs.cgs_update(w, h, V, with_norm)
            ref = cuda_cgs.cgs_update_plain(w, h, V, with_norm)
            if with_norm:
                torch.testing.assert_close(out[1], ref[1], **tol)
                out, ref = out[0], ref[0]
            torch.testing.assert_close(out, ref, **tol)
        assert torch.equal(w, w0)  # out of place
        assert torch.equal(cuda_cgs.cgs_update(w, torch.zeros_like(h), V), w)
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
