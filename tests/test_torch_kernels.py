"""The port's kernel wrappers (arpack_ng_tpu_torch/ops/cuda_sel.py,
cuda_rot.py) against the reference package's Pallas kernels run in
interpret mode, on the same numpy inputs, plus the package rules: no JAX
import anywhere in the port, and kernel modules that import and run on a
machine without nvcc or a CUDA device.

On the CPU the wrappers run their plain PyTorch twins; the CUDA kernels
themselves are compared with the twins on the card by ``chip_smoke.py``
and by tests/test_torch_gpu.py."""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from arpack_ng_tpu.ops import pallas_rot, pallas_sel  # noqa: E402
from arpack_ng_tpu_torch.ops import cuda_lib, cuda_rot, cuda_sel  # noqa: E402

PORT = pathlib.Path(__file__).resolve().parent.parent / "arpack_ng_tpu_torch"


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    ncv, npan = 24, 16
    V = rng.standard_normal((ncv, npan, 128)).astype(np.float32)
    br = rng.standard_normal((npan * 128,)).astype(np.float32)
    r = rng.standard_normal((npan * 128,)).astype(np.float32)
    return ncv, npan, V, br, r


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("K", [8, 16, 24])
def test_sel_proj_matches_pallas(data, K):
    ncv, npan, V, br, r = data
    idx = np.random.default_rng(K).permutation(ncv)[:K].astype(np.int32)
    proj = pallas_sel.make_sel_proj(K, ncv, npan, "float32", "float32",
                                    panels=8, interpret=True)
    ref = np.asarray(proj(jnp.asarray(idx), jnp.asarray(V), jnp.asarray(br)))
    s = cuda_sel.sel_proj(_t(idx), _t(V.reshape(ncv, -1)), _t(br)).numpy()
    np.testing.assert_allclose(s, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("with_norm", [False, True])
@pytest.mark.parametrize("K", [8, 16, 24])
def test_sel_update_matches_pallas(data, K, with_norm):
    ncv, npan, V, br, r = data
    idx = np.random.default_rng(K + 1).permutation(ncv)[:K].astype(np.int32)
    s = np.random.default_rng(2).standard_normal(K).astype(np.float32)
    upd = pallas_sel.make_sel_update(K, ncv, npan, "float32", "float32",
                                     panels=8, with_norm=with_norm,
                                     interpret=True)
    ref = upd(jnp.asarray(idx), jnp.asarray(s), jnp.asarray(r),
              jnp.asarray(V))
    rt = _t(r.copy())
    out = cuda_sel.sel_update(_t(idx), _t(s), rt, _t(V.reshape(ncv, -1)),
                              with_norm=with_norm)
    if with_norm:
        (out, nrm), (ref, nref) = out, ref
        np.testing.assert_allclose(float(nrm), float(nref), rtol=1e-5)
    assert out is rt  # updated in place
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_masked_rows_are_noops(data):
    # a zero coefficient makes the streamed stale row a no-op
    ncv, npan, V, br, r = data
    idx = np.array([3, 5, 7, 9, 0, 0, 0, 0], np.int32)
    s = np.array([0.5, -1.0, 2.0, 0.25, 0.0, 0.0, 0.0, 0.0], np.float32)
    upd = pallas_sel.make_sel_update(8, ncv, npan, "float32", "float32",
                                     panels=8, interpret=True)
    ref = np.asarray(upd(jnp.asarray(idx), jnp.asarray(s), jnp.asarray(r),
                         jnp.asarray(V)))
    Vt = _t(V.reshape(ncv, -1))
    out = cuda_sel.sel_update(_t(idx), _t(s), _t(r.copy()), Vt).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    dense = r - np.einsum("k,kx->x", s[:4], V[idx[:4]].reshape(4, -1))
    np.testing.assert_allclose(out, dense, rtol=1e-4, atol=1e-4)
    zero = cuda_sel.sel_update(_t(idx), torch.zeros(8), _t(r.copy()), Vt)
    assert torch.equal(zero, _t(r))


def test_bf16_storage(data):
    ncv, npan, V, br, r = data
    K = 8
    idx = np.random.default_rng(3).permutation(ncv)[:K].astype(np.int32)
    Vb = jnp.asarray(V).astype(jnp.bfloat16)
    Vt = _t(V.reshape(ncv, -1)).to(torch.bfloat16)
    # both packages round float32 to bfloat16 the same way
    np.testing.assert_array_equal(
        np.asarray(Vb, np.float32).reshape(ncv, -1), Vt.float().numpy())
    proj = pallas_sel.make_sel_proj(K, ncv, npan, "bfloat16", "float32",
                                    panels=8, interpret=True)
    ref = np.asarray(proj(jnp.asarray(idx), Vb, jnp.asarray(br)))
    s = cuda_sel.sel_proj(_t(idx), Vt, _t(br)).numpy()
    np.testing.assert_allclose(s, ref, rtol=1e-2, atol=1e-1)
    upd = pallas_sel.make_sel_update(K, ncv, npan, "bfloat16", "float32",
                                     panels=8, interpret=True)
    coef = np.random.default_rng(4).standard_normal(K).astype(np.float32)
    ref_r = np.asarray(upd(jnp.asarray(idx), jnp.asarray(coef),
                           jnp.asarray(r), Vb))
    out = cuda_sel.sel_update(_t(idx), _t(coef), _t(r.copy()), Vt).numpy()
    np.testing.assert_allclose(out, ref_r, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("rows", [8, 16, 24])
def test_rotate_rows_matches_pallas(data, rows):
    ncv, npan, V, br, r = data
    rng = np.random.default_rng(rows)
    Q = np.linalg.qr(rng.standard_normal((ncv, ncv)))[0].astype(np.float32)
    if rows == ncv:
        kern = pallas_rot.make_rotate(ncv, npan, "float32", "float32",
                                      interpret=True)
        ref = np.asarray(kern(jnp.asarray(Q), jnp.asarray(V)))
    else:
        kern = pallas_rot.make_rotate_rows(ncv, rows, npan, "float32",
                                           "float32", interpret=True)
        ref = np.asarray(kern(jnp.asarray(Q[:, :rows]), jnp.asarray(V)))
    Vt = _t(V.reshape(ncv, -1).copy())
    out = cuda_rot.rotate_rows(_t(Q), Vt, rows)
    assert out is Vt  # in place
    np.testing.assert_allclose(out[:rows].numpy(),
                               ref.reshape(ncv, -1)[:rows],
                               rtol=1e-5, atol=1e-5)
    # rows past the bucket stay bit-identical
    np.testing.assert_array_equal(out[rows:].numpy(),
                                  V.reshape(ncv, -1)[rows:])


def test_rotate_full_matches_pallas_make_rotate(data):
    # rows = ncv is the full rotation, the reference's make_rotate
    ncv, npan, V, br, r = data
    Q = np.linalg.qr(np.random.default_rng(5).standard_normal(
        (ncv, ncv)))[0].astype(np.float32)
    ref = np.asarray(pallas_rot.make_rotate(ncv, npan, "float32", "float32",
                                            interpret=True)(
        jnp.asarray(Q), jnp.asarray(V)))
    out = cuda_rot.rotate_rows(_t(Q), _t(V.reshape(ncv, -1).copy()), ncv)
    np.testing.assert_allclose(out.numpy(), ref.reshape(ncv, -1),
                               rtol=1e-5, atol=1e-5)


def test_rotate_rows_bf16_storage(data):
    ncv, npan, V, br, r = data
    rows = 16
    Q = np.linalg.qr(np.random.default_rng(6).standard_normal(
        (ncv, ncv)))[0].astype(np.float32)
    Vb = jnp.asarray(V).astype(jnp.bfloat16)
    kern = pallas_rot.make_rotate_rows(ncv, rows, npan, "bfloat16",
                                       "float32", interpret=True)
    ref = np.asarray(kern(jnp.asarray(Q[:, :rows]).astype(jnp.bfloat16),
                          Vb), np.float32).reshape(ncv, -1)
    Vt = _t(V.reshape(ncv, -1)).to(torch.bfloat16)
    keep = Vt[rows:].clone()
    out = cuda_rot.rotate_rows(_t(Q), Vt, rows)
    np.testing.assert_allclose(out[:rows].float().numpy(), ref[:rows],
                               rtol=1e-2, atol=3e-2)
    assert torch.equal(out[rows:], keep)


@pytest.mark.parametrize("case", ["idx_dtype", "short_vec", "k_range",
                                  "rows_range"])
def test_wrappers_reject_bad_arguments(data, case):
    ncv, npan, V, br, r = data
    Vt = _t(V.reshape(ncv, -1))
    idx = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        if case == "idx_dtype":
            cuda_sel.sel_proj(idx.long(), Vt, _t(br))
        elif case == "short_vec":
            cuda_sel.sel_update(idx, torch.ones(8), _t(r)[:-1], Vt)
        elif case == "k_range":
            cuda_sel.sel_proj(torch.zeros(0, dtype=torch.int32), Vt, _t(br))
        else:
            cuda_rot.rotate_rows(torch.eye(ncv), Vt.clone(), ncv + 1)


def test_non_cuda_devices_raise_instead_of_falling_back(data):
    # a tensor that is neither on the CPU nor on a CUDA device gets no
    # twin: the wrappers raise
    ncv, npan, V, br, r = data
    Vm = torch.empty((ncv, npan * 128), device="meta")
    idx = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_sel.sel_proj(idx, Vm, torch.empty(npan * 128, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        cuda_rot.rotate_rows(torch.empty((ncv, ncv), device="meta"), Vm, 8)


def test_kernel_modules_import_without_nvcc_or_cuda(data):
    # importing and running the wrappers on CPU tensors neither builds nor
    # loads the CUDA library, and counts no kernel launch
    import importlib
    for name in ("cuda_lib", "cuda_sel", "cuda_rot"):
        importlib.import_module(f"arpack_ng_tpu_torch.ops.{name}")
    ncv, npan, V, br, r = data
    before = (cuda_sel.sel_proj.launches, cuda_rot.rotate_rows.launches)
    cuda_sel.sel_proj(torch.arange(8, dtype=torch.int32),
                      _t(V.reshape(ncv, -1)), _t(br))
    cuda_rot.rotate_rows(torch.eye(ncv), _t(V.reshape(ncv, -1).copy()), 8)
    assert (cuda_sel.sel_proj.launches,
            cuda_rot.rotate_rows.launches) == before
    assert cuda_lib._lib is None
    assert set(cuda_lib.SOURCES) <= {p.name for p in cuda_lib.CSRC.iterdir()}


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    assert len(files) > 10
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "arpack_ng_tpu"):
                bad.append(f"{path.name}: {mod}")
    assert not bad, bad
