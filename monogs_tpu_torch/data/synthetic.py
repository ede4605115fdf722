"""Synthetic Gaussian scenes and rendered sequences.

Counterpart of ``monogs_tpu/data/synthetic.py``: an opaque textured bumpy
surface of Gaussians with foreground clusters at distinct depths, a smooth
orbit of world->camera poses (its amplitudes optionally calibrated to a
handheld sequence's per-frame motion, ``tum_like_amps``), and a dataset of
frames rendered from the scene with the reference's default render
configuration. Random draws come from a ``torch.Generator``, so a scene has
the same statistics as the JAX package's but not the same numbers; tests
that need the same map build it once and carry it across with
``convert.py``. The poses are deterministic and match the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device
from ..ops import se3
from ..ops.sh import rgb_to_sh
from ..render import GaussianArrays, Intrinsics, RenderConfig, render


def make_synthetic_scene(generator: torch.Generator, n: int = 4096,
                         spread: float = 2.5, depth_mean: float = 3.5,
                         depth_spread: float = 0.5, scale_min: float = 0.02,
                         scale_max: float = 0.08) -> GaussianArrays:
    """Scene of ``n`` Gaussians on ``generator``'s device."""
    dev = generator.device

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    xy = spread * (rand(n, 2) * 2.0 - 1.0)
    x, y = xy[:, 0], xy[:, 1]
    z = depth_mean + depth_spread * (
        0.5 * torch.sin(1.7 * x + 0.3) * torch.cos(1.3 * y + 1.1)
        + 0.3 * torch.sin(3.1 * x + 2.0)
        + 0.2 * torch.cos(2.3 * y + 0.7))
    # foreground clusters at distinct depths give the parallax that makes
    # lateral translation and yaw distinguishable
    n_clusters = 6
    centers = spread * 0.7 * (rand(n_clusters, 2) * 2 - 1)
    cdepths = depth_mean * (0.35 + 0.4 * rand(n_clusters))
    assign = torch.randint(0, 4 * n_clusters, (n,), generator=generator,
                           device=dev)
    in_cluster = assign < n_clusters
    ci = torch.clamp(assign, 0, n_clusters - 1)
    lx = centers[ci, 0] + 0.22 * spread * torch.sin(13.7 * x + 5 * y)
    ly = centers[ci, 1] + 0.22 * spread * torch.cos(11.3 * y + 7 * x)
    x = torch.where(in_cluster, lx, x)
    y = torch.where(in_cluster, ly, y)
    z = torch.where(in_cluster, cdepths[ci] + 0.1 * torch.sin(21.0 * (x + y)),
                    z)
    base = torch.stack([
        0.5 + 0.35 * torch.sin(3.0 * x + 1.0) * torch.cos(2.0 * y),
        0.5 + 0.35 * torch.sin(2.2 * y + 0.5) * torch.cos(1.5 * x + 2.2),
        0.5 + 0.35 * torch.sin(2.7 * (x + y) + 1.7),
    ], dim=-1)
    noise = 0.15 * (rand(n, 3) * 2.0 - 1.0)
    sh = rgb_to_sh(torch.clamp(base + noise, 0.02, 0.98))[:, None, :]
    log_scale = torch.log(scale_min + (scale_max - scale_min) * rand(n, 3))
    quat = (torch.randn((n, 4), generator=generator, device=dev) * 0.2
            + torch.tensor([3.0, 0.0, 0.0, 0.0], device=dev))
    return GaussianArrays(
        xyz=torch.stack([x, y, z], dim=-1), sh=sh, log_scale=log_scale,
        quat=quat, opa_logit=torch.full((n, 1), 4.0, device=dev),
        active=torch.ones((n,), dtype=torch.bool, device=dev))


def orbit_pose(t: float, trans_amp=0.25, rot_amp=0.06, pan=None,
               device="cuda") -> torch.Tensor:
    """Smooth wiggly world->camera pose around the identity at time t."""
    tau = torch.tensor([
        trans_amp * math.sin(2 * math.pi * t),
        trans_amp * 0.6 * math.sin(4 * math.pi * t + 0.5),
        trans_amp * 0.4 * math.sin(2 * math.pi * t + 1.3),
        rot_amp * math.sin(2 * math.pi * t + 0.7),
        rot_amp * math.sin(4 * math.pi * t),
        rot_amp * 0.5 * math.sin(2 * math.pi * t + 2.0),
    ], dtype=torch.float32, device=resolve_device(device))
    if pan is not None:
        tau = tau + t * torch.as_tensor(pan, dtype=torch.float32,
                                        device=tau.device)
    return se3.se3_exp(tau)


def tum_like_amps(n_frames: int, step_trans: float = 0.008,
                  step_rot: float = 0.006):
    """(trans_amp, rot_amp) such that the orbit's mean per-frame motion is
    that of a handheld sequence, whatever ``n_frames`` (the orbit covers
    its whole path in n_frames): TUM fr3/long_office's published pace,
    about 0.25 m/s and 10 deg/s at 30 Hz, is 8 mm and 0.006 rad a frame.
    Calibrated numerically as the JAX package does: the unit-amplitude
    orbit's mean per-frame translation and rotation, measured once in
    float32, scale the steps (the two couple only at second order)."""
    ts = [i / max(n_frames, 1) for i in range(n_frames)]
    tt = [orbit_pose(t, trans_amp=1.0, rot_amp=0.0, device="cpu").numpy()
          for t in ts]
    tr = [orbit_pose(t, trans_amp=0.0, rot_amp=1.0, device="cpu").numpy()
          for t in ts]
    dt = np.mean([np.linalg.norm(tt[i + 1][:3, 3] - tt[i][:3, 3])
                  for i in range(n_frames - 1)])
    dr = np.mean([
        np.arccos(np.clip(
            (np.trace(tr[i + 1][:3, :3] @ tr[i][:3, :3].T) - 1) / 2, -1, 1))
        for i in range(n_frames - 1)])
    return float(step_trans / max(dt, 1e-9)), float(step_rot / max(dr, 1e-9))


class SyntheticDataset:
    """Frames rendered from a synthetic scene along the orbit:
    ``dataset[idx] -> (image [3,H,W], depth [H,W] or None, pose T_cw)``,
    plus the intrinsics attributes (``fx``, ``fy``, ``cx``, ``cy``,
    ``width``, ``height``, ``fovx``, ``fovy``). ``motion`` "tum_like"
    replaces the amplitudes by ``tum_like_amps(n_frames)``; the frames are
    rendered with ``render_cfg`` or the reference's default
    ``RenderConfig()``."""

    def __init__(self, intr: Intrinsics, n_frames: int = 32,
                 n_gauss: int = 4096, seed: int = 0,
                 sensor_type: str = "depth",
                 render_cfg: RenderConfig | None = None,
                 trans_amp: float = 0.25, rot_amp: float = 0.06, pan=None,
                 motion: str = "orbit", device="cuda"):
        if motion == "tum_like":
            trans_amp, rot_amp = tum_like_amps(n_frames)
        elif motion != "orbit":
            raise ValueError(f"unknown synthetic motion mode: {motion}")
        dev = resolve_device(device)
        self.intr = intr
        self.fx, self.fy = intr.fx, intr.fy
        self.cx, self.cy = intr.cx, intr.cy
        self.width, self.height = intr.width, intr.height
        self.fovx, self.fovy = intr.fovx, intr.fovy
        self.sensor_type = sensor_type
        self.has_depth = sensor_type != "monocular"
        self.num_imgs = n_frames
        cfg = (render_cfg or RenderConfig())._replace(with_n_touched=False)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.scene = make_synthetic_scene(gen, n=n_gauss)
        self.poses = [orbit_pose(i / max(n_frames, 1), trans_amp, rot_amp,
                                 pan=pan, device=dev)
                      for i in range(n_frames)]
        self._frames = []
        for T in self.poses:
            out = render(self.scene, T, intr, cfg)
            depth = out.depth[0] if self.has_depth else None
            self._frames.append((torch.clamp(out.image, 0.0, 1.0), depth))

    def __len__(self):
        return self.num_imgs

    def __getitem__(self, idx):
        img, depth = self._frames[idx]
        return img, depth, self.poses[idx]
