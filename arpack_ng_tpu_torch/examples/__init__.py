"""Runnable examples on the CUDA card (``--cpu`` for the CPU), one per
reference driver class; each prints the residuals it checks.

    python -m arpack_ng_tpu_torch.examples.dssimp [nx] [--cpu]

``EXAMPLES`` names them; ``distributed_laplacian`` (``mesh=``) waits for
the port's distribution layer.
"""

EXAMPLES = ("dssimp", "dnsimp", "dsdrv4_shift_invert", "zndrv1", "svd",
            "validate_f64", "irregular_sparse")
