"""The block DIA product on the case list of ``tests/torch_dia_cases.py``,
on the CPU: ``cuda_dia.dia_block_matvec`` on CPU tensors (its plain twin)
against scipy's CSR product and, where ``n_pad % 128 == 0``, against the
reference package's ``dia_block_matvec_fn``
(``arpack_ng_tpu/ops/sparse.py:118-183``), in float32 and float64, at every
block size of ``BLOCKS``.

The three sum each row in different orders, so each entry is held to the
sum of its absolute terms, ``t = sum_k |dtab[k, i] X[c, i + off_k]|``:
within 1e-14 t in float64 and 1e-5 t in float32 (scipy's product in
float64 on the same values).  The twin equals ``dia_matvec_plain`` column
by column bit for bit.  The reference takes its diagonals zero-filled and
its block zero past ``n``, as its solver keeps it, so the ``nonfinite``
case (NaN past ``n``) is not given to it.

Also the plan the kernel derives (``cuda_dia.block_plan``): its runs take
the kept offsets in their order, each run within the window's span.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import scipy.sparse as sp  # noqa: E402

from arpack_ng_tpu.ops import sparse as jsparse  # noqa: E402
from arpack_ng_tpu_torch.ops import cuda_dia  # noqa: E402
from torch_dia_cases import BLOCKS, CASES, make  # noqa: E402

RTOL = {np.float32: 1e-5, np.float64: 1e-14}
#: block sizes the reference's product runs at: one jit each, which takes
#: ~20 s at 600 diagonals, so there only the chunk and its remainder
JAX_BLOCKS = {"nd600": (9,)}


def _csr(offsets, dtab, n):
    """The matrix of the case's kept terms, in float64."""
    i = np.arange(n)
    rows, cols, vals = [], [], []
    for k, o in enumerate(offsets):
        j = i + o
        m = (j >= 0) & (j < n)
        rows.append(i[m])
        cols.append(j[m])
        vals.append(dtab[k, :n][m].astype(np.float64))
    return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                 np.concatenate(cols))),
                         shape=(n, n))


def _jax_apply(offsets, dtab, n, n_pad):
    import jax

    diags = [dtab[k, :n] for k in range(len(offsets))]
    return jax.jit(jsparse.dia_block_matvec_fn([int(o) for o in offsets],
                                               diags, n, n_pad))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(CASES))
def test_twin_against_scipy_and_reference(name, dtype):
    offsets, n, n_pad = CASES[name]
    ref_apply = None
    for b in BLOCKS:
        offs, dtab, X, n = make(name, dtype, b)
        Y = cuda_dia.dia_block_matvec(torch.from_numpy(offs),
                                      torch.from_numpy(dtab),
                                      torch.from_numpy(X), n).numpy()
        assert Y.shape == X.shape and Y.dtype == dtype
        assert not Y[:, n:].any()
        a = _csr(offs, dtab, n)
        x64 = X[:, :n].astype(np.float64)
        want = (a @ x64.T).T
        t = (abs(a) @ abs(x64).T).T
        assert np.isfinite(Y).all()
        assert (abs(Y[:, :n] - want) <= RTOL[dtype] * t).all(), (name, b)
        for c in range(b):
            assert np.array_equal(
                Y[c], cuda_dia.dia_matvec_plain(
                    torch.from_numpy(offs), torch.from_numpy(dtab),
                    torch.from_numpy(X[c]), n).numpy()), (name, b, c)
        if n_pad % 128 or name == "nonfinite" \
                or b not in JAX_BLOCKS.get(name, (1, 9)):
            continue
        if ref_apply is None:
            ref_apply = _jax_apply(offs, dtab, n, n_pad)
        Xz = X.copy()
        Xz[:, n:] = 0
        Yz = cuda_dia.dia_block_matvec_plain(
            torch.from_numpy(offs), torch.from_numpy(dtab),
            torch.from_numpy(Xz), n).numpy()
        got = np.asarray(ref_apply(Xz))
        assert (abs(Yz - got)[:, :n] <= RTOL[dtype] * t).all(), (name, b)
        assert not got[:, n:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [1, 3, 8, 17])
@pytest.mark.parametrize("name", list(CASES))
def test_plan_covers_the_kept_offsets_in_order(name, b, dtype):
    offsets, n, _ = CASES[name]
    plan = cuda_dia.block_plan(offsets, n, b, dtype)
    runs = plan["runs"]
    kept = [k for k, o in enumerate(offsets) if abs(o) < n]
    assert [k for f, e, _, _ in runs for k in range(f, e)
            if abs(offsets[k]) < n] == kept
    assert all(r[1] <= s[0] for r, s in zip(runs, runs[1:]))
    for f, e, lo, hi in runs:
        inside = [offsets[k] for k in range(f, e) if abs(offsets[k]) < n]
        assert abs(offsets[f]) < n
        assert (lo, hi) == (min(inside), max(inside))
        assert hi - lo <= plan["span"] == plan["window"] - plan["tile"]
    if len(offsets) > cuda_dia.PLAN_CAP:
        assert all(e - f == 1 for f, e, _, _ in runs)
    else:
        # greedy: no run could have taken the next run's first offset
        for (f, e, lo, hi), nxt in zip(runs, runs[1:]):
            o = offsets[nxt[0]]
            assert max(hi, o) - min(lo, o) > plan["span"]
    cb = min(b, cuda_dia.DIA_COLS)
    isz = torch.empty((), dtype=dtype).element_size()
    assert plan["smem"] >= 2 * cb * plan["window"] * isz


def test_plan_of_the_timed_tables():
    # dia65's alternating offsets are one run; the flagship's sorted five
    # are one run where the window spans 2048, else three
    offs65 = CASES["alternating"][0]
    for dt in (torch.float32, torch.float64):
        for b in (1, 2, 4, 8):
            assert len(cuda_dia.block_plan(offs65, 1 << 20, b, dt)["runs"]) \
                == 1
    flag = [-1024, -1, 0, 1, 1024]
    one = [(0, 5, -1024, 1024)]
    for dt, b in ((torch.float32, 1), (torch.float32, 2), (torch.float32, 4),
                  (torch.float64, 1), (torch.float64, 2)):
        assert cuda_dia.block_plan(flag, 1 << 20, b, dt)["runs"] == one
    three = [(0, 1, -1024, -1024), (1, 4, -1, 1), (4, 5, 1024, 1024)]
    for dt, b in ((torch.float32, 8), (torch.float64, 4), (torch.float64, 8)):
        assert cuda_dia.block_plan(flag, 1 << 20, b, dt)["runs"] == three
