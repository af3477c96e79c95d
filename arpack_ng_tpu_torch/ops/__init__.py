"""Operators and the hand-written CUDA kernels of arpack_ng_tpu_torch."""
