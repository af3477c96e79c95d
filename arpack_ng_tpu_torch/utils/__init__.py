"""Host-side numerics helpers of arpack_ng_tpu_torch."""
