"""Per-Gaussian preprocessing: projection, EWA 2D covariance, color, culling.

Counterpart of ``monogs_tpu/render/primitives.py``: cull at z <= near, EWA
splat covariance with the 1.3 * tan_fov clamp and +0.3 px dilation, 3-sigma
radius from the dominant eigenvalue, SH -> RGB clamped at zero. Written as
scalar column ops over [N] with no in-place writes and no host reads, so
``torch.func.jvp``/``vmap`` (the second-order tracker's pose tangents) and
``torch.autograd.grad`` (the first-order pose gradient) run through it.

``means2d_offset`` is the mapping's zero-valued [N, 2] hook on the screen
means (scaled by 2/width and 2/height, the CUDA rasterizer's NDC units):
its gradient is the screen-space gradient that feeds densification.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import sh as sh_ops
from .camera import Intrinsics


class Projected(NamedTuple):
    mean2d: torch.Tensor   # [N, 2] pixel coords
    conic: torch.Tensor    # [N, 3] upper-triangular inverse 2D covariance
    opacity: torch.Tensor  # [N]
    rgb: torch.Tensor      # [N, 3]
    z: torch.Tensor        # [N] camera-space depth
    radius: torch.Tensor   # [N] 3-sigma radius in pixels (0 if culled)
    valid: torch.Tensor    # [N] bool


def covariance3d(log_scale, quat, scale_modifier=1.0):
    """Sigma = (R S)(R S)^T as its 6 unique [N] columns
    (xx, xy, xz, yy, yz, zz)."""
    S = torch.exp(log_scale) * scale_modifier
    n = torch.sqrt(torch.sum(quat * quat, dim=-1))
    q = quat / torch.clamp(n, min=1e-12)[:, None]
    r, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = (
        (1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)),
        (2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)),
        (2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)),
    )
    M = [[R[i][j] * S[:, j] for j in range(3)] for i in range(3)]

    def dot(i, j):
        return M[i][0] * M[j][0] + M[i][1] * M[j][1] + M[i][2] * M[j][2]

    return dot(0, 0), dot(0, 1), dot(0, 2), dot(1, 1), dot(1, 2), dot(2, 2)


def preprocess(xyz, log_scale, quat, opa_logit, sh_coeffs, active, T_cw,
               intr: Intrinsics, sh_degree: int = 0, near: float = 0.2,
               scale_modifier: float = 1.0, means2d_offset=None) -> Projected:
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    px = xyz[:, 0] * R[0, 0] + xyz[:, 1] * R[0, 1] + xyz[:, 2] * R[0, 2] + t[0]
    py = xyz[:, 0] * R[1, 0] + xyz[:, 1] * R[1, 1] + xyz[:, 2] * R[1, 2] + t[1]
    pz = xyz[:, 0] * R[2, 0] + xyz[:, 1] * R[2, 1] + xyz[:, 2] * R[2, 2] + t[2]
    z = pz
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    inv_z = 1.0 / zs

    u = intr.fx * px * inv_z + intr.cx - 0.5
    v = intr.fy * py * inv_z + intr.cy - 0.5
    if means2d_offset is not None:
        u = u + means2d_offset[:, 0] * (2.0 / intr.width)
        v = v + means2d_offset[:, 1] * (2.0 / intr.height)
    mean2d = torch.stack([u, v], dim=-1)

    sxx, sxy, sxz, syy, syz, szz = covariance3d(log_scale, quat,
                                                scale_modifier)
    limx = 1.3 * intr.tan_fovx
    limy = 1.3 * intr.tan_fovy
    txz = torch.clamp(px * inv_z, -limx, limx)
    tyz = torch.clamp(py * inv_z, -limy, limy)
    j00 = intr.fx * inv_z
    j02 = -intr.fx * txz * inv_z
    j11 = intr.fy * inv_z
    j12 = -intr.fy * tyz * inv_z
    jw0 = [j00 * R[0, c] + j02 * R[2, c] for c in range(3)]
    jw1 = [j11 * R[1, c] + j12 * R[2, c] for c in range(3)]

    def sig_vec(w):
        return (
            sxx * w[0] + sxy * w[1] + sxz * w[2],
            sxy * w[0] + syy * w[1] + syz * w[2],
            sxz * w[0] + syz * w[1] + szz * w[2],
        )

    s0 = sig_vec(jw0)
    a = jw0[0] * s0[0] + jw0[1] * s0[1] + jw0[2] * s0[2] + 0.3
    b = jw1[0] * s0[0] + jw1[1] * s0[1] + jw1[2] * s0[2]
    s1 = sig_vec(jw1)
    c = jw1[0] * s1[0] + jw1[1] * s1[1] + jw1[2] * s1[2] + 0.3

    det = a * c - b * b
    det_safe = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                           det)
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)))

    if sh_degree == 0:
        rgb = sh_ops.C0 * sh_coeffs[:, 0, :] + 0.5
    else:
        cam_center = -(R.T @ t)
        dirs = xyz - cam_center
        dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                                  min=1e-9)
        rgb = sh_ops.eval_sh(sh_degree, sh_coeffs.transpose(-1, -2), dirs) + 0.5
    rgb = torch.clamp(rgb, min=0.0)

    opacity = torch.sigmoid(opa_logit).reshape(-1)

    in_front = z > near
    on_screen = (
        (u + radius >= 0)
        & (u - radius <= intr.width - 1)
        & (v + radius >= 0)
        & (v - radius <= intr.height - 1)
    )
    valid = active & in_front & (det > 0) & (radius > 0) & on_screen
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return Projected(mean2d=mean2d, conic=conic, opacity=opacity, rgb=rgb,
                     z=z, radius=radius, valid=valid)
