"""The benchmark's inputs, made from the seed: a synthetic Gaussian scene,
camera orbits and the rigid-motion algebra they need.

Plain PyTorch that imports nothing of the program. The scene is the
opaque textured bumpy surface with foreground clusters that the port's
``data/synthetic.py`` draws, and the orbit and its TUM pacing are those of
the same module, frozen here so that a change to the program cannot move
the yardstick. Every draw comes from one ``torch.Generator`` on the device
the run uses, in a few large calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SH_C0 = 0.28209479177387814


# ------------------------------------------------------------ SE(3) algebra

def _small(x2):
    return x2 < 1e-8


def _safe(x2):
    return torch.where(_small(x2), torch.ones_like(x2), x2)


def skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def se3_exp(tau):
    """[..., 6] tangent (translation part rho, rotation part theta) -> [..., 4, 4]
    rigid transform, with Taylor forms near zero so that autograd is finite
    at tau = 0."""
    rho, theta = tau[..., :3], tau[..., 3:]
    x2 = torch.sum(theta * theta, dim=-1)
    xs = _safe(x2)
    x = torch.sqrt(xs)
    small = _small(x2)
    a = torch.where(small, 1.0 - x2 / 6.0, torch.sin(x) / x)
    b = torch.where(small, 0.5 - x2 / 24.0, (1.0 - torch.cos(x)) / xs)
    c = torch.where(small, 1.0 / 6.0 - x2 / 120.0, (x - torch.sin(x)) / (xs * x))
    K = skew(theta)
    K2 = K @ K
    eye = torch.eye(3, dtype=tau.dtype, device=tau.device).expand(K.shape)
    R = eye + a[..., None, None] * K + b[..., None, None] * K2
    V = eye + b[..., None, None] * K + c[..., None, None] * K2
    t = (V @ rho[..., :, None])[..., 0]
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=tau.dtype,
                         device=tau.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


# ------------------------------------------------------------------ scene

def make_scene(seed: int, n: int, spread: float, depth_mean: float,
               depth_spread: float, scale_min: float, scale_max: float,
               device) -> dict:
    """``n`` Gaussians drawn from ``seed`` on ``device``: xyz [n, 3], sh
    [n, 1, 3] (degree 0), log_scale [n, 3], quat [n, 4], opa_logit [n, 1]."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    u = rand(n, 8)                      # one large draw for the per-Gaussian
    xy = spread * (u[:, :2] * 2.0 - 1.0)
    x, y = xy[:, 0], xy[:, 1]
    z = depth_mean + depth_spread * (
        0.5 * torch.sin(1.7 * x + 0.3) * torch.cos(1.3 * y + 1.1)
        + 0.3 * torch.sin(3.1 * x + 2.0)
        + 0.2 * torch.cos(2.3 * y + 0.7))
    n_clusters = 6
    c = rand(n_clusters, 3)
    centers = spread * 0.7 * (c[:, :2] * 2 - 1)
    cdepths = depth_mean * (0.35 + 0.4 * c[:, 2])
    assign = torch.randint(0, 4 * n_clusters, (n,), generator=g, device=device)
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
    noise = 0.15 * (u[:, 2:5] * 2.0 - 1.0)
    rgb = torch.clamp(base + noise, 0.02, 0.98)
    sh = ((rgb - 0.5) / SH_C0)[:, None, :]
    log_scale = torch.log(scale_min + (scale_max - scale_min) * rand(n, 3))
    quat = (torch.randn((n, 4), generator=g, device=device) * 0.2
            + torch.tensor([3.0, 0.0, 0.0, 0.0], device=device))
    return dict(xyz=torch.stack([x, y, z], dim=-1), sh=sh,
                log_scale=log_scale, quat=quat,
                opa_logit=torch.full((n, 1), 4.0, device=device))


# ------------------------------------------------------------------ orbit

def orbit_tangent(t: float, trans_amp: float, rot_amp: float):
    return [
        trans_amp * math.sin(2 * math.pi * t),
        trans_amp * 0.6 * math.sin(4 * math.pi * t + 0.5),
        trans_amp * 0.4 * math.sin(2 * math.pi * t + 1.3),
        rot_amp * math.sin(2 * math.pi * t + 0.7),
        rot_amp * math.sin(4 * math.pi * t),
        rot_amp * 0.5 * math.sin(2 * math.pi * t + 2.0),
    ]


def _orbit_np(t, trans_amp, rot_amp):
    tau = torch.tensor(orbit_tangent(t, trans_amp, rot_amp),
                       dtype=torch.float32)
    return se3_exp(tau).numpy()


def tum_like_amps(n_frames: int, step_trans: float = 0.008,
                  step_rot: float = 0.006):
    """(trans_amp, rot_amp) giving the orbit TUM fr3/long_office's mean pace
    (8 mm and 0.006 rad a frame) when it is gone round in ``n_frames``."""
    ts = [i / max(n_frames, 1) for i in range(n_frames)]
    tt = [_orbit_np(t, 1.0, 0.0) for t in ts]
    tr = [_orbit_np(t, 0.0, 1.0) for t in ts]
    dt = np.mean([np.linalg.norm(tt[i + 1][:3, 3] - tt[i][:3, 3])
                  for i in range(n_frames - 1)])
    dr = np.mean([
        np.arccos(np.clip(
            (np.trace(tr[i + 1][:3, :3] @ tr[i][:3, :3].T) - 1) / 2, -1, 1))
        for i in range(n_frames - 1)])
    return float(step_trans / max(dt, 1e-9)), float(step_rot / max(dr, 1e-9))


def orbit_poses(frame_ids, orbit_frames: int, jitter_trans: float,
                jitter_rot: float, seed: int, device):
    """World->camera poses [len(frame_ids), 4, 4] at the given frames of a
    TUM-paced orbit gone round in ``orbit_frames`` frames, each with its own
    jitter drawn from ``seed``."""
    ta, ra = tum_like_amps(orbit_frames)
    g = torch.Generator(device=device).manual_seed(seed)
    n = len(frame_ids)
    jit = torch.randn((n, 6), generator=g, device=device) * torch.tensor(
        [jitter_trans] * 3 + [jitter_rot] * 3, device=device)
    base = torch.tensor([orbit_tangent(i / orbit_frames, ta, ra)
                         for i in frame_ids], dtype=torch.float32,
                        device=device)
    return se3_exp(jit) @ se3_exp(base)
