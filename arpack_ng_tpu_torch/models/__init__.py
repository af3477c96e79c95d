"""Model operators (the dssimp-class Laplacians) and the irregular-matrix
corpus."""

from .corpus import fem_triangulation, powerlaw_graph, saddle_point
from .stencil import laplacian_1d, laplacian_2d

__all__ = ["fem_triangulation", "laplacian_1d", "laplacian_2d",
           "powerlaw_graph", "saddle_point"]
