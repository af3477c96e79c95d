"""arpack_ng_tpu_torch: the implicitly restarted Lanczos solver of
``arpack_ng_tpu`` on PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper (H100) on its main path.

This package imports neither JAX nor ``arpack_ng_tpu``; its module names
mirror ``arpack_ng_tpu`` so each counterpart is easy to find.  It covers
the symmetric real path of ``eigsh`` (modes 1 and 2, float32/float64,
``reorth`` selective or dgks, the implicit exact-shift restart) on any
torch device: on a CUDA device the reorthogonalization events and the
restart rotation run the kernels of ``csrc/``, built with ``nvcc`` at
first use; on the CPU the same wrappers run their plain PyTorch twins.
"""

from .api import ArpackError, ArpackNoConvergence, eigsh
from .config import IRAMConfig, default_ncv, pad_dim
from .core.arnoldi import FactorizationState
from .core.extract import EigenResult, extract
from .core.iram import IRAMResult
from .ops.operator import Operator, from_dense, from_diagonal, from_matvec
from .state import state_from_numpy, state_to_numpy

__version__ = "0.1.0"

__all__ = [
    "ArpackError",
    "ArpackNoConvergence",
    "EigenResult",
    "FactorizationState",
    "IRAMConfig",
    "IRAMResult",
    "Operator",
    "default_ncv",
    "eigsh",
    "extract",
    "from_dense",
    "from_diagonal",
    "from_matvec",
    "pad_dim",
    "state_from_numpy",
    "state_to_numpy",
]
