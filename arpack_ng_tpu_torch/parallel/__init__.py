"""arpack_ng_tpu_torch.parallel: the row-partitioned (PARPACK) solve."""

from .sharding import ROWS, RowMesh, make_mesh, mesh_operator

__all__ = ["ROWS", "RowMesh", "make_mesh", "mesh_operator"]
