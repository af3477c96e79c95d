"""Full-precision float32 contractions for every solver build (the
counterpart of ``arpack_ng_tpu/utils/precision.hiprec``).

Reduced-precision Gram-Schmidt dots make ghost Ritz values that pass
their own residual bound: the basis stops being orthonormal, so H stops
being a projection (``docs/PERF.md``, round 4).  On an NVIDIA card the
reduced-precision route is TF32, which keeps about three decimal digits.
PyTorch leaves TF32 off for matrix products by default but on for cuDNN;
a solver build sets both off and checks the float32 matmul precision,
so no setting left by the caller can reach the solver's contractions.
"""
from __future__ import annotations

import torch


def pin_full_precision() -> None:
    """Turn TF32 off for cuBLAS and cuDNN and require 'highest' float32
    matmul precision; raise if the setting does not hold."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("could not pin full-precision float32 matmuls; "
                           "TF32 contractions produce ghost Ritz values")
