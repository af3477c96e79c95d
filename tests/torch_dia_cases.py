"""Cases of the block DIA product (``cuda_dia.dia_block_matvec``): the
offset patterns its kernel's plan has to handle, on inputs made with numpy
from a seed, so that every consumer builds the same arrays.

* ``alternating``: offsets 0, 4, -4, ..., 128, -128 (the order of
  ``chip_smoke.dia65``, unsorted and alternating in sign): one run;
* ``wide``: offsets to +-3000 and +-7000 in alternating order, wider than
  any window of the kernel, so the plan cuts several runs;
* ``past_n``: offsets with ``|off| >= n`` among those inside, which add
  nothing;
* ``nd129``: 129 unsorted offsets in [-300, 300];
* ``nd600``: 600 offsets, more than the kernel plans in shared memory
  (``cuda_dia.PLAN_CAP``): one diagonal per run;
* ``odd_pad``: ``n_pad`` (and n) not a multiple of 4;
* ``nonfinite``: NaN and Inf table entries wherever a term is skipped
  (``i + off`` outside ``[0, n)``) and in the rows past ``n``, and NaN in X
  past ``n``: a kernel that zero-fills instead of skipping returns NaN.

Each case runs at every block size of ``BLOCKS``: one chunk of columns
(1-8), a chunk and a remainder (9, 17), two full chunks (16).  The
consumers: ``tests/test_torch_dia_block_cases.py`` (the twin against scipy
and the reference package, on the CPU), ``tests/test_torch_gpu.py`` (the
kernel against the twin on the card), ``tools/dia_block_compare.py`` and
``chip_smoke.py`` phase 13e.
"""
from __future__ import annotations

import numpy as np

BLOCKS = (*range(1, 10), 16, 17)


def _alternating(step, count):
    out = [0]
    for k in range(1, count + 1):
        out += [k * step, -k * step]
    return out


def _nd129(rng):
    return [int(o) for o in rng.choice(np.arange(-300, 301), 129,
                                       replace=False)]


def _nd600(rng):
    return [int(o) for o in rng.choice(np.arange(-1500, 1501), 600,
                                       replace=False)]


#: name -> (offsets, n, n_pad); n_pad % 128 == 0 where the reference's
#: block product (which requires it) can take the case
CASES = {
    "alternating": (_alternating(4, 32), 5000, 5120),
    "wide": ([0, 3000, -3000, 1, -1, 7000, -7000, 2, -2], 20000, 20096),
    "past_n": ([0, 3000, 1, -2999, -3000, 5000, -1, -4], 3000, 3072),
    "nd129": (_nd129(np.random.default_rng(129)), 4000, 4096),
    "nd600": (_nd600(np.random.default_rng(600)), 2000, 2048),
    "odd_pad": ([-2, 0, 1, 5, -7], 1001, 1003),
    "nonfinite": ([-1, 0, 1, 7, -7, 300, -300], 1200, 1280),
}


def make(name, dtype, b, seed=0):
    """``(offsets, dtab, X, n)`` of case ``name``: int64 offsets, the
    ``(nd, n_pad)`` table (the same at every ``b``) and the ``(b, n_pad)``
    block in ``dtype`` (numpy), standard normal, with random values past
    ``n`` as well."""
    offsets, n, n_pad = CASES[name]
    dtab = np.random.default_rng([seed, len(offsets), n]).standard_normal(
        (len(offsets), n_pad)).astype(dtype)
    X = np.random.default_rng([seed, len(offsets), n, b]).standard_normal(
        (b, n_pad)).astype(dtype)
    if name == "nonfinite":
        i = np.arange(n_pad)
        for k, o in enumerate(offsets):
            skipped = (i + o < 0) | (i + o >= n) | (i >= n)
            dtab[k, skipped] = np.where(i[skipped] % 2, np.nan, np.inf)
        X[:, n:] = np.nan
    return np.asarray(offsets, np.int64), dtab, X, n
