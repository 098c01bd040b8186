from .base import SHAPES, ArchConfig, ShapeConfig
from .registry import ARCHS, all_cells, cell_applicable, get_arch, get_shape

__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "all_cells",
           "cell_applicable", "get_arch", "get_shape"]
