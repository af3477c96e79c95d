"""Lanczos engine, restart driver and extraction of arpack_ng_tpu_torch."""
