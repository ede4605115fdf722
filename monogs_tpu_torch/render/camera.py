"""Camera intrinsics (counterpart of ``monogs_tpu/render/camera.py``).

A hashable NamedTuple of Python scalars with the same fields, so a JAX
``Intrinsics`` maps one to one: ``Intrinsics(*jax_intr)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def fovx(self) -> float:
        return 2.0 * math.atan(self.width / (2.0 * self.fx))

    @property
    def fovy(self) -> float:
        return 2.0 * math.atan(self.height / (2.0 * self.fy))

    @property
    def tan_fovx(self) -> float:
        return self.width / (2.0 * self.fx)

    @property
    def tan_fovy(self) -> float:
        return self.height / (2.0 * self.fy)
