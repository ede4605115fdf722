"""Undistortion and rectification: OpenCV's maps and bilinear remap.

``init_undistort_rectify_map`` is the closed form of
``cv2.initUndistortRectifyMap(K, dist, R, K_new, (W, H), CV_32FC1)`` in
float64 numpy (radial k1, k2, k3 and tangential p1, p2, after R^-1 and
K_new^-1), computed once per dataset. ``remap`` samples a uint8 image
through such maps as ``cv2.remap(.., INTER_LINEAR)`` with border value 0
does: the CUDA kernel ``csrc/remap.cu`` (one thread per output pixel, all
channels) on the card, beside its plain PyTorch version, which the CPU
path runs. Both compute in float32, two lerps along x and one along y,
rounded half to even, as OpenCV does, so they agree bit for bit with each
other and, on the datasets' maps, with OpenCV within 1 LSB on a few
values in a million.
"""

from __future__ import annotations

import numpy as np
import torch

from ..render.blend_lists import count_launch

LAUNCHES = {"remap": 0}


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


def _check(img, map_x, map_y):
    if img.dtype != torch.uint8 or img.dim() not in (2, 3):
        raise ValueError(f"remap: img must be [H, W] or [H, W, C] uint8, "
                         f"got {img.dtype} {tuple(img.shape)}")
    for name, m in (("map_x", map_x), ("map_y", map_y)):
        if (m.dtype != torch.float32 or m.shape != map_x.shape
                or m.dim() != 2 or m.device != img.device):
            raise ValueError(f"remap: {name} must be [H, W] float32 on "
                             f"{img.device} like map_x")


def remap(img, map_x, map_y):
    """Bilinear remap with border value 0 (``cv2.remap``, INTER_LINEAR):
    the kernel on a CUDA tensor, else the plain version."""
    _check(img, map_x, map_y)
    if img.device.type != "cuda":
        return remap_plain(img, map_x, map_y)
    from .._build import library

    img = img.contiguous()
    map_x, map_y = map_x.contiguous(), map_y.contiguous()
    h, w = img.shape[:2]
    c = img.shape[2] if img.dim() == 3 else 1
    out = torch.empty(tuple(map_x.shape) + tuple(img.shape[2:]),
                      dtype=torch.uint8, device=img.device)
    rc = library("remap").remap_u8(
        img.data_ptr(), map_x.data_ptr(), map_y.data_ptr(), out.data_ptr(),
        h, w, map_x.shape[0], map_x.shape[1], c,
        torch.cuda.current_stream(img.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"remap_u8: kernel launch failed with CUDA error "
                           f"{rc}")
    count_launch(LAUNCHES, "remap")
    return out


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
