"""Keyframe insertion: depth-map unprojection into new Gaussians.

Counterpart of ``monogs_tpu/models/insertion.py``: exposure-corrected colour
quantised through bytes, dense backprojection, a Bernoulli(1/downsample)
pixel selection compacted to a fixed capacity, the world-frame transform,
and initial isotropic scales from the mean squared distance to the 3
nearest neighbours.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import knn, losses, sh as sh_ops
from ..ops.se3 import se3_inverse
from ..render.camera import Intrinsics, backproject_pixels
from ..render.tiling import compact_indices
from .gaussian_map import ParamLeaves


def keyframe_to_gaussians(gt_image, depthmap, T_cw, exposure_a, exposure_b,
                          intr: Intrinsics, cap: int, sh_k: int,
                          downsample_factor: float, point_size: float,
                          adaptive_pointsize: bool,
                          generator: Optional[torch.Generator] = None,
                          keep_draw=None):
    """(ParamLeaves with ``cap`` rows, count of valid rows) from one frame
    (gt_image [3, H, W], depthmap [H, W] metric, 0 = invalid). A pixel is
    kept where its depth is in (0, 100) and a uniform draw is below
    1/downsample_factor; ``keep_draw`` [H, W] replaces the draw from
    ``generator``. Scales are sqrt(point size x mean 3-NN squared distance),
    the rotation identity and the opacity 0.5."""
    h, w = depthmap.shape
    dev = depthmap.device
    img_ab = torch.clamp(
        losses.apply_exposure(gt_image, exposure_a, exposure_b), 0.0, 1.0)
    img_ab = torch.floor(img_ab * 255.0) / 255.0

    pts_cam = backproject_pixels(depthmap, intr)
    valid = (depthmap > 0) & (depthmap < 100.0)
    if keep_draw is None:
        keep_draw = torch.rand((h, w), generator=generator, device=dev)
    keep = valid & (keep_draw < 1.0 / downsample_factor)
    sel, ok, count = compact_indices(keep.reshape(-1), cap)

    pts = pts_cam.reshape(-1, 3)[sel]
    cols = img_ab.permute(1, 2, 0).reshape(-1, 3)[sel]
    T_wc = se3_inverse(T_cw)
    pts_world = pts @ T_wc[:3, :3].T + T_wc[:3, 3]
    pts_world = torch.where(ok[:, None], pts_world,
                            torch.zeros_like(pts_world))

    if adaptive_pointsize:
        # min(0.05, point_size * median(depth)) over the whole image, zeros
        # included; the median of an even count averages the middle two
        dsort = torch.sort(depthmap.reshape(-1)).values
        nd = dsort.shape[0]
        med = 0.5 * (dsort[(nd - 1) // 2] + dsort[nd // 2])
        ps = torch.clamp(point_size * med, max=0.05)
    else:
        ps = point_size

    d2 = torch.clamp(knn.mean_knn_sq_dist(pts_world, ok, k=3), min=1e-7) * ps
    log_scale = torch.log(torch.sqrt(d2))[:, None].expand(cap, 3)

    sh = torch.zeros((cap, sh_k, 3), dtype=torch.float32, device=dev)
    sh[:, 0, :] = sh_ops.rgb_to_sh(cols)
    quat = torch.zeros((cap, 4), dtype=torch.float32, device=dev)
    quat[:, 0] = 1.0
    leaves = ParamLeaves(
        xyz=pts_world, sh=sh,
        log_scale=torch.where(ok[:, None], log_scale,
                              torch.full_like(log_scale, -10.0)),
        quat=quat, opa_logit=torch.zeros((cap, 1), dtype=torch.float32,
                                         device=dev))
    return leaves, count
