"""Undistortion and rectification: OpenCV's maps and bilinear remap.

``init_undistort_rectify_map`` is the closed form of
``cv2.initUndistortRectifyMap(K, dist, R, K_new, (W, H), CV_32FC1)`` in
float64 numpy (radial k1, k2, k3 and tangential p1, p2, after R^-1 and
K_new^-1), computed once per dataset. ``remap`` samples a uint8 image
through such maps as ``cv2.remap(.., INTER_LINEAR)`` with border value 0
does: the CUDA kernel ``csrc/remap.cu`` (one thread per output pixel,
all channels; ``remap_pair`` takes both images of a stereo pair in one
launch) on the card, beside its plain PyTorch version, which the CPU
path runs. Both compute in float32, two lerps along x and one along y,
rounded half to even, as OpenCV does, so they agree bit for bit with each
other and, on the datasets' maps, with OpenCV within 1 LSB on a few
values in a million.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..render.blend_lists import count_launch

LAUNCHES = {"remap": 0, "remap_pair": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def init_undistort_rectify_map(K, dist, R, K_new, size):
    """(map_x, map_y) float32 [H, W]: the raw-image point that each pixel of
    the undistorted (and rectified by ``R``) image with intrinsics
    ``K_new`` samples. ``dist`` is (k1, k2, p1, p2, k3); ``size`` (W, H)."""
    w, h = size
    K = np.asarray(K, np.float64)
    k1, k2, p1, p2, k3 = (float(v) for v in np.asarray(dist, np.float64))
    ir = np.linalg.inv(np.asarray(K_new, np.float64)
                       @ np.asarray(R, np.float64))
    j = np.arange(w, dtype=np.float64)[None, :]
    i = np.arange(h, dtype=np.float64)[:, None]
    _x = i * ir[0, 1] + ir[0, 2] + j * ir[0, 0]
    _y = i * ir[1, 1] + ir[1, 2] + j * ir[1, 0]
    _w = i * ir[2, 1] + ir[2, 2] + j * ir[2, 0]
    x, y = _x / _w, _y / _w
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    u = K[0, 0] * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)) + K[0, 2]
    v = K[1, 1] * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy) + K[1, 2]
    return u.astype(np.float32), v.astype(np.float32)


def remap_plain(img, map_x, map_y):
    """``remap`` in plain PyTorch: img [H, W] or [H, W, C] uint8, maps
    [H', W'] float32; returns [H', W'(, C)] uint8."""
    src = img if img.dim() == 3 else img[..., None]
    h, w, _ = src.shape
    fx, fy = torch.floor(map_x), torch.floor(map_y)
    a, b = (map_x - fx)[..., None], (map_y - fy)[..., None]
    x0 = fx.clamp(-2, w).long()
    y0 = fy.clamp(-2, h).long()
    flat = src.reshape(h * w, -1).float()

    def tap(yy, xx):
        inside = ((xx >= 0) & (xx < w) & (yy >= 0) & (yy < h))[..., None]
        v = flat[(yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))]
        return torch.where(inside, v, torch.zeros_like(v))

    p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
    p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    t0 = p00 + a * (p01 - p00)
    t1 = p10 + a * (p11 - p10)
    out = torch.round(t0 + b * (t1 - t0)).clamp(0, 255).to(torch.uint8)
    return out if img.dim() == 3 else out[..., 0]


class Maps(NamedTuple):
    """A pair of maps checked once (``check_maps``): ``x`` and ``y``
    float32 [H', W'], contiguous, on the device of index ``device`` (-1:
    the CPU). The datasets check theirs where they build them, so that a
    frame's ``remap`` checks only the image."""
    x: torch.Tensor
    y: torch.Tensor
    device: int


def check_maps(map_x, map_y) -> Maps:
    for name, m in (("map_x", map_x), ("map_y", map_y)):
        if (m.dtype != torch.float32 or m.dim() != 2
                or m.shape != map_x.shape or m.device != map_x.device):
            raise ValueError(f"remap: {name} must be [H, W] float32 on "
                             f"{map_x.device} like map_x")
    return Maps(map_x.contiguous(), map_y.contiguous(), map_x.get_device())


def _check(img, maps):
    if not isinstance(maps, Maps):
        raise TypeError("remap: give map_x and map_y, or Maps from "
                        "check_maps")
    if (img.dtype != torch.uint8 or img.dim() not in (2, 3)
            or img.get_device() != maps.device):
        raise ValueError(f"remap: img must be [H, W] or [H, W, C] uint8 on "
                         f"the maps' device, got {img.dtype} "
                         f"{tuple(img.shape)} on {img.device}")


def _raise_on(rc, fn):
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error "
                           f"{rc}")


def remap(img, map_x, map_y=None):
    """Bilinear remap with border value 0 (``cv2.remap``, INTER_LINEAR)
    through ``map_x`` and ``map_y``, or through ``Maps`` in ``map_x``
    alone: the kernel on a CUDA tensor, else the plain version."""
    maps = map_x if map_y is None else check_maps(map_x, map_y)
    _check(img, maps)
    if not img.is_cuda:
        return remap_plain(img, maps.x, maps.y)
    img = img.contiguous()
    out = img.new_empty(maps.x.shape + img.shape[2:])
    _raise_on(_build.library("remap").remap_u8(
        img.data_ptr(), maps.x.data_ptr(), maps.y.data_ptr(), out.data_ptr(),
        img.shape[0], img.shape[1], maps.x.shape[0], maps.x.shape[1],
        img.shape[2] if img.dim() == 3 else 1,
        _build.stream_handle(maps.device)), "remap_u8")
    count_launch(LAUNCHES, "remap")
    return out


def remap_pair(img0, maps0, img1, maps1):
    """``(remap(img0, *maps0), remap(img1, *maps1))``, a stereo pair: in one
    launch on CUDA tensors, else two plain remaps. Each maps is ``Maps``
    or ``(map_x, map_y)``; the two images, and the two maps, must have one
    shape."""
    maps0, maps1 = (m if isinstance(m, Maps) else check_maps(*m)
                    for m in (maps0, maps1))
    _check(img0, maps0)
    _check(img1, maps1)
    if (img1.shape != img0.shape or maps1.x.shape != maps0.x.shape
            or maps1.device != maps0.device):
        raise ValueError(f"remap_pair: images {tuple(img0.shape)} and "
                         f"{tuple(img1.shape)}, maps "
                         f"{tuple(maps0.x.shape)} and "
                         f"{tuple(maps1.x.shape)}: the images, and the "
                         "maps, must have one shape and one device")
    if not img0.is_cuda:
        return (remap_plain(img0, maps0.x, maps0.y),
                remap_plain(img1, maps1.x, maps1.y))
    img0, img1 = img0.contiguous(), img1.contiguous()
    shape = maps0.x.shape + img0.shape[2:]
    out0, out1 = img0.new_empty(shape), img1.new_empty(shape)
    _raise_on(_build.library("remap").remap_pair_u8(
        img0.data_ptr(), maps0.x.data_ptr(), maps0.y.data_ptr(),
        out0.data_ptr(), img1.data_ptr(), maps1.x.data_ptr(),
        maps1.y.data_ptr(), out1.data_ptr(), img0.shape[0], img0.shape[1],
        shape[0], shape[1], img0.shape[2] if img0.dim() == 3 else 1,
        _build.stream_handle(maps0.device)), "remap_pair_u8")
    count_launch(LAUNCHES, "remap_pair")
    return out0, out1


def undistort_points(pts, K, dist, R, P, iters=20):
    """[N, 2] raw-image points -> their undistorted, rectified positions in
    the image with intrinsics ``P``: OpenCV's ``undistortPoints``
    fixed-point inversion of the distortion (``iters`` steps, as a
    criteria of that count), then R and P, in float64."""
    pts = np.asarray(pts, np.float64)
    K = np.asarray(K, np.float64)
    k1, k2, p1, p2, k3 = (float(v) for v in np.asarray(dist, np.float64))
    x0 = (pts[:, 0] - K[0, 2]) / K[0, 0]
    y0 = (pts[:, 1] - K[1, 2]) / K[1, 1]
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    rr = np.asarray(P, np.float64)[:3, :3] @ np.asarray(R, np.float64)
    xyz = rr @ np.stack([x, y, np.ones_like(x)])
    return np.stack([xyz[0] / xyz[2], xyz[1] / xyz[2]], 1)
