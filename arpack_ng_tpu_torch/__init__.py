"""arpack_ng_tpu_torch: the implicitly restarted Lanczos and Arnoldi
solvers of ``arpack_ng_tpu`` on PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (H100) on their main paths.

This package imports neither JAX nor ``arpack_ng_tpu``; its module names
mirror ``arpack_ng_tpu`` so each counterpart is easy to find.  It covers
``eigsh`` for symmetric and Hermitian problems (modes 1-5: regular,
generalized, shift-invert, buckling and Cayley;
float32/float64/complex64/complex128, ``reorth`` selective or dgks, the
implicit exact-shift or thick restart; the fused driver or the hybrid
one), ``eigs`` for real and complex non-symmetric ones (modes 1-4, the
fused real, fused complex or hybrid driver) and ``svds``, with
``validate=``, for operators, dense matrices and scipy sparse matrices
(``from_scipy``); matrix-free shift-invert through the CG/BiCGSTAB solves
of ``ops/solvers``; the banded drivers ``ops.banded.eigsh_banded`` /
``eigs_banded`` (modes 1-5, shift-invert by block cyclic reduction,
``ops/bandsolve``) and thick-restart block Lanczos
``core.block.eigsh_block``.
Every entry point runs on the CUDA card unless the caller passes
``device="cpu"``.  On the card the reorthogonalization passes, the restart
rotation and the DIA (single and block) and PSELL sparse products run the
kernels of ``csrc/``, built with ``nvcc`` at first use; on the CPU the same
wrappers run their plain PyTorch twins.
"""

from .api import (ArpackError, ArpackNoConvergence, F64Validation,
                  PseudospectrumWarning, eigs, eigsh)
from .config import IRAMConfig, default_ncv, pad_dim
from .core.arnoldi import FactorizationState
from .core.extract import EigenResult, extract
from .core.iram import IRAMResult, IRAMSolver
from .core.svd import svds
from .ops.operator import Operator, from_dense, from_diagonal, from_matvec
from .ops.sparse import from_scipy
from .state import state_from_numpy, state_to_numpy

__version__ = "0.1.0"

__all__ = [
    "ArpackError",
    "ArpackNoConvergence",
    "EigenResult",
    "F64Validation",
    "FactorizationState",
    "IRAMConfig",
    "IRAMResult",
    "IRAMSolver",
    "Operator",
    "PseudospectrumWarning",
    "default_ncv",
    "eigs",
    "eigsh",
    "extract",
    "from_dense",
    "from_diagonal",
    "from_matvec",
    "from_scipy",
    "pad_dim",
    "state_from_numpy",
    "state_to_numpy",
    "svds",
]
