"""The port's kernel wrappers (arpack_ng_tpu_torch/ops/cuda_sel.py,
cuda_rot.py, cuda_cgs.py, cuda_dia.py) against the reference package's
Pallas kernels run in interpret mode, on the same numpy inputs, plus the
package rules: no JAX import anywhere in the port, and kernel modules that
import and run on a machine without nvcc or a CUDA device.  The PSELL
kernel's twin is held to its Pallas kernel in tests/test_torch_psell.py.

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

import scipy.sparse as sp  # noqa: E402
from arpack_ng_tpu.ops import pallas_cgs, pallas_rot, pallas_sel  # noqa: E402
from arpack_ng_tpu.ops.pallas_dia import make_pallas_dia_matvec  # noqa: E402
from arpack_ng_tpu_torch.ops import (  # noqa: E402
    cuda_cgs, cuda_dia, cuda_lib, cuda_psell, cuda_rot, cuda_sel)

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


@pytest.mark.parametrize("with_norm", [False, True])
@pytest.mark.parametrize("K", [5, 13, 20])
def test_sel_masked_buckets_match_pallas(K, with_norm):
    # ncv = 20: K that is not a multiple of 8 (the last bucket is ncv, and
    # one bucket gives K = ncv) is masked inside the kernels' bucket
    rng = np.random.default_rng(20 + K)
    ncv, npan = 20, 16
    V = rng.standard_normal((ncv, npan, 128)).astype(np.float32)
    br = rng.standard_normal(npan * 128).astype(np.float32)
    r = rng.standard_normal(npan * 128).astype(np.float32)
    idx = rng.permutation(ncv)[:K].astype(np.int32)
    Vt = _t(V.reshape(ncv, -1))
    proj = pallas_sel.make_sel_proj(K, ncv, npan, "float32", "float32",
                                    panels=8, interpret=True)
    s_ref = np.asarray(proj(jnp.asarray(idx), jnp.asarray(V),
                            jnp.asarray(br)))
    s = cuda_sel.sel_proj(_t(idx), Vt, _t(br))
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-5, atol=1e-4)
    upd = pallas_sel.make_sel_update(K, ncv, npan, "float32", "float32",
                                     panels=8, with_norm=with_norm,
                                     interpret=True)
    ref = upd(jnp.asarray(idx), jnp.asarray(s_ref), jnp.asarray(r),
              jnp.asarray(V))
    rt = _t(r.copy())
    out = cuda_sel.sel_update(_t(idx), _t(s_ref.copy()), rt, Vt,
                              with_norm=with_norm)
    if with_norm:
        (out, nrm), (ref, nref) = out, ref
        np.testing.assert_allclose(float(nrm), float(nref), rtol=1e-5)
    assert out is rt  # updated in place
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", [1 << 20, (1 << 20) + 3, 5000, 3])
def test_sel_plan_K_1_to_32(n, aligned):
    # one launch per event: the bucket holds K (a K that is not a multiple
    # of 8 is masked inside it), 16-byte vectors only when every pointer
    # allows them, a grid of at least 132 blocks that grows only so that no
    # thread adds more than RUN vectors into one sum, scratch for K x grid
    for itemsize in (4, 2, 8):
        vec = 16 // itemsize if aligned else 1
        for K in range(1, 33):
            p = cuda_sel.plan(K, n, itemsize, aligned)
            assert p.bucket == 8 * -(-K // 8)
            assert p.vec == vec
            assert p.grid >= 132
            assert p.grid * cuda_cgs.THREADS * cuda_cgs.RUN >= n // vec
            assert p.grid == 132 or \
                (p.grid - 1) * cuda_cgs.THREADS * cuda_cgs.RUN < n // vec
            assert p.scratch == K * p.grid


def test_sel_plan_more_rows_and_refusals():
    # K > 32 loops over groups of 32 in the 32-row bucket
    for K in (33, 48, 256):
        p = cuda_sel.plan(K, 1 << 20, 4, True)
        assert (p.bucket, p.vec, p.grid) == (32, 4, 132)
        assert p.scratch == K * 132
    # a longer basis grows the grid: at most RUN vectors per thread
    p = cuda_sel.plan(8, 1 << 24, 4, True)
    assert p.grid == (1 << 22) // (cuda_cgs.THREADS * cuda_cgs.RUN)
    assert cuda_sel.plan(8, 1 << 24, 4, False).grid == 4 * p.grid
    for K in (0, -1, cuda_sel.MAX_K + 1):
        with pytest.raises(ValueError):
            cuda_sel.plan(K, 1024, 4, True)


def test_sel_alignment_picks_the_vector_width():
    # br or r one value into its buffer, or a row stride that is not a
    # multiple of 16 bytes, takes the scalar path
    V = torch.zeros((4, 1024))
    buf = torch.zeros(1025)
    assert cuda_sel._aligned(V, buf[:1024])
    assert not cuda_sel._aligned(V, buf[1:])
    assert not cuda_sel._aligned(torch.zeros((4, 1027)), torch.zeros(1027))
    Vb = torch.zeros((4, 1028), dtype=torch.bfloat16)  # 2056-byte rows
    assert not cuda_sel._aligned(Vb, torch.zeros(1028))
    assert cuda_sel.plan(8, 1028, 2, False).vec == 1


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
    wm = torch.empty(npan * 128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_cgs.cgs_proj(Vm, wm, 8)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_cgs.cgs_update(wm, torch.empty(8, device="meta"), Vm)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_dia.dia_matvec(torch.zeros(1, dtype=torch.int64, device="meta"),
                            torch.empty((1, npan * 128), device="meta"), wm,
                            npan * 128)


def test_kernel_modules_import_without_nvcc_or_cuda(data):
    # importing and running the wrappers on CPU tensors neither builds nor
    # loads the CUDA library, and counts no kernel launch
    import importlib
    for name in ("cuda_lib", "cuda_sel", "cuda_rot", "cuda_cgs", "cuda_dia",
                 "cuda_psell"):
        importlib.import_module(f"arpack_ng_tpu_torch.ops.{name}")
    ncv, npan, V, br, r = data
    kernels = (cuda_sel.sel_proj, cuda_sel.sel_update, cuda_rot.rotate_rows,
               cuda_cgs.cgs_proj, cuda_cgs.cgs_update, cuda_dia.dia_matvec,
               cuda_psell.psell_matvec)
    before = [k.launches for k in kernels]
    Vt = _t(V.reshape(ncv, -1))
    cuda_sel.sel_proj(torch.arange(8, dtype=torch.int32), Vt, _t(br))
    cuda_rot.rotate_rows(torch.eye(ncv), _t(V.reshape(ncv, -1).copy()), 8)
    cuda_cgs.cgs_update(_t(br), cuda_cgs.cgs_proj(Vt, _t(br), 8), Vt)
    cuda_dia.dia_matvec(torch.zeros(1, dtype=torch.int64),
                        torch.ones((1, br.size), dtype=torch.float32),
                        _t(br), br.size)
    assert [k.launches for k in kernels] == before
    assert cuda_lib._lib is None
    assert set(cuda_lib.SOURCES + cuda_lib.HEADERS) <= {
        p.name for p in cuda_lib.CSRC.iterdir()}


@pytest.mark.parametrize("rows", [5, 8, 13, 16, 24])
@pytest.mark.parametrize("with_norm", [False, True])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_cgs_kernels_match_pallas(storage, with_norm, rows):
    # pallas_cgs.make_proj / make_update (tests/test_pallas.py:64-92):
    # h = V[:rows] w, r = w - h V[:rows] (+ ||r||^2), V stored in float32 or
    # bfloat16, accumulated in float32
    rng = np.random.default_rng(rows)
    ncv, n_pad = 32, 128 * 40
    V = rng.standard_normal((ncv, n_pad)).astype(np.float32)
    w = rng.standard_normal(n_pad).astype(np.float32)
    Vj = jnp.asarray(V).astype(storage)
    Vt = _t(V).to(getattr(torch, storage))
    proj = pallas_cgs.make_proj(rows, ncv, n_pad, storage, "float32",
                                interpret=True)
    upd = pallas_cgs.make_update(rows, ncv, n_pad, storage, "float32",
                                 interpret=True, with_norm=with_norm)
    h_ref = np.asarray(proj(Vj, jnp.asarray(w)))
    h = cuda_cgs.cgs_proj(Vt, _t(w), rows)
    np.testing.assert_allclose(h.numpy(), h_ref, rtol=2e-5, atol=1e-3)
    wt = _t(w.copy())
    out = cuda_cgs.cgs_update(wt, _t(h_ref.copy()), Vt,
                              with_norm=with_norm)
    ref = upd(jnp.asarray(w), jnp.asarray(h_ref), Vj)
    if with_norm:
        (out, n2), (ref, n2_ref) = out, ref
        assert abs(float(n2) - float(n2_ref)) < 1e-5 * float(n2_ref)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).reshape(-1),
                               rtol=1e-4, atol=1e-3)
    assert torch.equal(wt, _t(w))  # out of place: w untouched


def test_cgs_zero_coefficients_leave_w_unchanged():
    # the solver masks h past row j to zero: those rows are exact no-ops
    rng = np.random.default_rng(9)
    V = _t(rng.standard_normal((16, 1024)).astype(np.float32))
    w = _t(rng.standard_normal(1024).astype(np.float32))
    h = torch.zeros(16)
    h[:3] = torch.tensor([0.5, -1.0, 2.0])
    r = cuda_cgs.cgs_update(w, h, V)
    torch.testing.assert_close(r, w - h[:3] @ V[:3], rtol=1e-6, atol=1e-6)
    assert torch.equal(cuda_cgs.cgs_update(w, torch.zeros(8), V), w)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", [1 << 20, (1 << 20) + 3, 5000, 3])
def test_cgs_plan_rows_1_to_32(n, aligned):
    # one launch per call: the bucket holds the rows, 16-byte vectors only
    # when every pointer allows them, a grid that fills the 132 SMs and
    # keeps each thread's run at RUN vectors, scratch for rows x grid
    for itemsize in (4, 2, 8):
        vec = 16 // itemsize if aligned else 1
        for rows in range(1, 33):
            p = cuda_cgs.plan(rows, n, itemsize, aligned)
            assert p.bucket == 8 * -(-rows // 8)
            assert p.vec == vec
            assert p.grid >= cuda_cgs.SMS
            assert p.grid * cuda_cgs.THREADS * cuda_cgs.RUN >= n // vec
            assert p.grid == cuda_cgs.SMS or \
                (p.grid - 1) * cuda_cgs.THREADS * cuda_cgs.RUN < n // vec
            assert p.scratch == rows * p.grid


def test_cgs_plan_more_rows_and_bad_arguments():
    # more than 32 rows loop over the 32-row bucket
    for rows in (33, 100, 256):
        p = cuda_cgs.plan(rows, 1 << 20, 4, True)
        assert (p.bucket, p.vec) == (32, 4)
        assert p.scratch == rows * p.grid
    # at the flagship size the grid is the 132 SMs in every width
    assert {cuda_cgs.plan(16, 1 << 20, s, a).grid
            for s in (2, 4, 8) for a in (True, False)} == {132}
    # a larger n grows the grid so that no thread sums more than RUN
    # vectors
    assert cuda_cgs.plan(8, 1 << 24, 4, True).grid == (1 << 22) // (256 * 32)
    with pytest.raises(ValueError):
        cuda_cgs.plan(0, 1024, 4, True)
    with pytest.raises(ValueError):
        cuda_cgs.plan(257, 1024, 4, True)


def test_cgs_alignment_picks_the_vector_width():
    # a w one value into its buffer, or a row stride that is not a multiple
    # of 16 bytes, takes the scalar path
    V = torch.zeros((4, 1024))
    buf = torch.zeros(1025)
    assert cuda_cgs._aligned(V, buf[:1024])
    assert not cuda_cgs._aligned(V, buf[1:])
    assert not cuda_cgs._aligned(torch.zeros((4, 1027)), torch.zeros(1027))


@pytest.mark.parametrize("ncv", [5, 16, 20, 24, 32])
def test_rot_plan_register_buckets(ncv):
    # ncv up to 32 takes the register kernel in the smallest bucket that
    # holds it; at the flagship size one wave of resident blocks strides
    # over the words, whatever `rows`
    bucket = max(16, 8 * -(-ncv // 8))
    for rows in range(1, ncv + 1):
        p = cuda_rot.plan(ncv, rows, 1 << 20, 4, 4, 16)
        assert (p.bucket, p.vec, p.smem) == (bucket, 2, 0)
        assert p.grid == cuda_rot.SMS * cuda_rot.blocks_per_sm(bucket, 2, 4)


@pytest.mark.parametrize("itemsize, acc, words", [
    (4, 4, {16: 2, 8: 2, 4: 1}),
    (2, 4, {16: 4, 8: 4, 4: 2, 2: 1}),
    (8, 8, {16: 2, 8: 1}),
])
def test_rot_plan_word_follows_alignment(itemsize, acc, words):
    # the plan's word (8 bytes of float32 or bfloat16, 16 of float64) where
    # the address and the row stride allow it, else the widest they allow
    for align, vec in words.items():
        p = cuda_rot.plan(32, 16, 1 << 20, itemsize, acc, align)
        assert p.vec == vec, align
        assert p.grid == min(cuda_rot.SMS * cuda_rot.blocks_per_sm(
            32, vec, acc), -(-(1 << 20) // vec // cuda_rot.THREADS))


def test_rot_plan_grid_blocks_and_slab_path():
    # two resident blocks of the float32 8-byte kernel, one of the
    # bfloat16 and float64 kernels at ncv 32; a small n needs fewer blocks
    # than one wave
    assert cuda_rot.blocks_per_sm(32, 2, 4) == 2
    assert cuda_rot.blocks_per_sm(32, 4, 4) == 1
    assert cuda_rot.blocks_per_sm(32, 2, 8) == 1
    assert cuda_rot.plan(32, 8, 100, 4, 4, 16).grid == 1
    p = cuda_rot.plan(32, 8, (1 << 16) + 3, 4, 4, 4)
    assert (p.vec, p.grid) == (1, -(-((1 << 16) + 3) // cuda_rot.THREADS))
    # ncv above the buckets: the shared-memory slab kernel
    p = cuda_rot.plan(40, 17, 1 << 20, 4, 4, 16)
    assert p == cuda_rot.Plan(0, 1, cuda_rot.SMS * 4, 40 * cuda_rot.SLAB * 4)
    assert cuda_rot.plan(40, 40, 50, 8, 8, 16).grid == 2


@pytest.mark.parametrize("args", [
    (32, 0, 1024, 4, 4, 16),     # rows below 1
    (32, 33, 1024, 4, 4, 16),    # rows above ncv
    (32, 8, 0, 4, 4, 16),        # no columns
    (2000, 8, 1024, 4, 4, 16),   # a slab above the 227 KB of shared memory
])
def test_rot_plan_refuses(args):
    with pytest.raises(ValueError):
        cuda_rot.plan(*args)


def test_rot_alignment_of_the_basis():
    assert cuda_rot._align(torch.zeros((4, 1024))) == 16
    assert cuda_rot._align(torch.zeros(4 * 1024 + 2)[2:].view(4, 1024)) == 8
    assert cuda_rot._align(torch.zeros((4, 1027))) == 4
    assert cuda_rot._align(torch.zeros((4, 1027), dtype=torch.bfloat16)) == 2


def _dia_case(offs, n, rng):
    # the banded matrices of tests/test_pallas.py:13-26
    diags, mats = [], []
    for o in offs:
        arr = np.zeros(n)
        m = n - abs(o)
        vals = rng.standard_normal(m)
        if o >= 0:
            arr[:m] = vals
        else:
            arr[-o:] = vals
        mats.append(sp.diags(vals, o, shape=(n, n)))
        diags.append(arr)
    return diags, sum(mats).tocsr()


@pytest.mark.parametrize("offs", [
    [0],
    [-1, 0, 1],
    [-130, -63, -1, 0, 1, 63, 130],
    [-256, 0, 256],
])
def test_dia_matvec_matches_pallas(offs):
    rng = np.random.default_rng(len(offs))
    n, n_pad = 4000, 4096
    diags, a = _dia_case(offs, n, rng)
    mv = make_pallas_dia_matvec(offs, diags, n, n_pad, tile_rows=8,
                                interpret=True)
    x = np.zeros(n_pad)
    x[:n] = rng.standard_normal(n)
    ref = np.asarray(mv(jnp.asarray(x)))
    dtab = np.zeros((len(offs), n_pad))
    for k, d in enumerate(diags):
        dtab[k, :n] = d
    y = cuda_dia.dia_matvec(torch.tensor(offs), _t(dtab), _t(x), n).numpy()
    np.testing.assert_allclose(y, ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y[:n], a @ x[:n], atol=1e-12)
    assert np.abs(y[n:]).max() == 0.0


def test_dia_matvec_reads_zero_outside_the_matrix():
    # x past n is not read even where it is not zero, and y's pad is zero
    rng = np.random.default_rng(11)
    n, n_pad = 1000, 1024
    diags, a = _dia_case([-3, 0, 5], n, rng)
    dtab = np.zeros((3, n_pad))
    for k, d in enumerate(diags):
        dtab[k, :n] = d
    x = rng.standard_normal(n_pad)
    y = cuda_dia.dia_matvec(torch.tensor([-3, 0, 5]), _t(dtab), _t(x), n)
    np.testing.assert_allclose(y[:n].numpy(), a @ x[:n], atol=1e-12)
    assert not y[n:].any()


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
