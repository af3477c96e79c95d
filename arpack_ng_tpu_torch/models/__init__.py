"""Model operators (the dssimp-class Laplacians)."""

from .stencil import laplacian_1d, laplacian_2d

__all__ = ["laplacian_1d", "laplacian_2d"]
