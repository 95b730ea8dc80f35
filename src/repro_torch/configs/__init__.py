from repro_torch.configs.base import ArchConfig, MixedArchConfig, ShapeCell, SHAPE_CELLS, cell_applicable
from repro_torch.configs.registry import ALL_ARCHS, PORT_ARCHS, get_config, reduced_config

__all__ = ["ArchConfig", "MixedArchConfig", "ShapeCell", "SHAPE_CELLS", "cell_applicable",
           "ALL_ARCHS", "PORT_ARCHS", "get_config", "reduced_config"]
