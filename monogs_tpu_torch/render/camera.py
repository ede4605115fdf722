"""Camera intrinsics and depth backprojection (counterpart of
``monogs_tpu/render/camera.py``).

``Intrinsics`` is a hashable NamedTuple of Python scalars with the same
fields, so a JAX ``Intrinsics`` maps one to one: ``Intrinsics(*jax_intr)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


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


def focal2fov(focal: float, pixels: int) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def project_points(p_view, intr: Intrinsics):
    """Camera-space points [..., 3] -> pixel coordinates (u, v) with the
    CUDA rasterizer's half-pixel convention (u = fx x / z + cx - 0.5), z
    clamped at 1e-6."""
    z = torch.clamp(p_view[..., 2], min=1e-6)
    u = intr.fx * p_view[..., 0] / z + intr.cx - 0.5
    v = intr.fy * p_view[..., 1] / z + intr.cy - 0.5
    return u, v


def backproject_pixels(depth, intr: Intrinsics):
    """[H, W] depth -> [H, W, 3] camera-space points, pixel (ix, iy) at
    ((ix - cx) / fx * z, (iy - cy) / fy * z, z) (the Open3D convention the
    reference's keyframe insertion used)."""
    h, w = depth.shape
    ys = torch.arange(h, dtype=torch.float32, device=depth.device)
    xs = torch.arange(w, dtype=torch.float32, device=depth.device)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    x = (xg - intr.cx) / intr.fx * depth
    y = (yg - intr.cy) / intr.fy * depth
    return torch.stack([x, y, depth], dim=-1)
