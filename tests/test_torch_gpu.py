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

from arpack_ng_tpu_torch.ops import cuda_rot, cuda_sel  # noqa: E402


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
