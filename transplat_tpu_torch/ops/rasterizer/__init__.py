from .api import RasterizeConfig, RenderOutput, render, render_depth
from .projection import ProjectedGaussians, project_gaussians

__all__ = [
    "ProjectedGaussians",
    "RasterizeConfig",
    "RenderOutput",
    "project_gaussians",
    "render",
    "render_depth",
]
