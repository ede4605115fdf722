from .camera import Intrinsics  # noqa: F401
from .renderer import (  # noqa: F401
    GaussianArrays,
    RenderConfig,
    RenderResult,
    TileLists,
    build_tile_lists,
    render,
)
