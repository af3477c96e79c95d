"""Model operators (the dssimp-class Laplacians, the dnsimp-class
convection-diffusion operators) and the irregular-matrix corpus."""

from .corpus import fem_triangulation, powerlaw_graph, saddle_point
from .stencil import (convection_diffusion_1d, convection_diffusion_2d,
                      laplacian_1d, laplacian_2d)

__all__ = ["convection_diffusion_1d", "convection_diffusion_2d",
           "fem_triangulation", "laplacian_1d", "laplacian_2d",
           "powerlaw_graph", "saddle_point"]
