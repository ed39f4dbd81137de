from .base import (
    ARCH_IDS,
    SHAPES,
    LayerSpec,
    ModelConfig,
    ShapeSuite,
    get_config,
    list_configs,
    register,
    shape_cells,
)

__all__ = [
    "ARCH_IDS", "SHAPES", "LayerSpec", "ModelConfig", "ShapeSuite",
    "get_config", "list_configs", "register", "shape_cells",
]
