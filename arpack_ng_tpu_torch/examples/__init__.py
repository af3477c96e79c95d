"""Runnable examples on the CUDA card (``--cpu`` for the CPU), one per
reference driver class; each prints the residuals it checks.

    python -m arpack_ng_tpu_torch.examples.dssimp [nx] [--cpu]

``EXAMPLES`` names them; ``distributed_laplacian`` (``mesh=``) runs on
N ranks under torchrun or spawned (``--ranks N``), and as a world of one
when its ``main`` is called in a process with no process group.
"""

EXAMPLES = ("dssimp", "dnsimp", "dsdrv4_shift_invert", "zndrv1", "svd",
            "validate_f64", "irregular_sparse", "distributed_laplacian")
