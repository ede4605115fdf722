"""Frames written in the directory layouts of the recorded datasets.

For runs of SLAM from files where no recorded sequence is at hand:
rendered frames and their poses are written as TUM RGB-D
(``rgb/``, ``depth/``, ``rgb.txt``, ``depth.txt``, ``groundtruth.txt``),
Replica (``results/frame*.jpg``, ``results/depth*.png``, ``traj.txt``) or
EuRoC (``mav0/cam0|cam1/data/<ns>.png``,
``mav0/state_groundtruth_estimate0/data.csv``), for the loaders of
``datasets.py`` to read back. The image encoders are passed in
(``write(path, array)``), so the same layouts come from OpenCV in the CPU
tests and from the port's own encoders on the card.

``raw_maps`` gives the maps through which ``undistort.remap`` makes the
raw frame of a camera with lens distortion (and, for a stereo rig,
rectification) from an ideal render: each raw pixel samples the render at
its undistorted, rectified position (``undistort.undistort_points``), so
the loader's undistortion gives the ideal view back. Depth is written
unwarped, as the loaders use it.
"""

from __future__ import annotations

import os

import numpy as np

from .datasets import EuRoCParser


def matrix_quaternion(R):
    """(w, x, y, z) of a rotation matrix (inverse of
    ``datasets.quaternion_matrix``)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = 2.0 * np.sqrt(1.0 + t)
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q)


def depth_u16(depth, scale):
    """Metric depth -> the 16-bit PNG values of a dataset with
    ``depth_scale`` ``scale`` (rounded; 0 where there is none)."""
    d = np.nan_to_num(np.asarray(depth, np.float64), nan=0.0)
    return np.clip(np.round(d * scale), 0, 65535).astype(np.uint16)


def write_tum(root, colors, depths, poses_cw, depth_scale, write,
              t0=1305031102.0, dt=1.0 / 30.0):
    """TUM RGB-D layout; frames ``dt`` apart (the parser drops frames
    closer than 1/32 s), depth at the colour's timestamps."""
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_lines, depth_lines = [], []
    gt_lines = ["# timestamp tx ty tz qx qy qz qw"]
    for i, (color, depth, T_cw) in enumerate(zip(colors, depths, poses_cw)):
        ts = f"{t0 + i * dt:.6f}"
        write(os.path.join(root, "rgb", f"{ts}.png"), color)
        write(os.path.join(root, "depth", f"{ts}.png"),
              depth_u16(depth, depth_scale))
        rgb_lines.append(f"{ts} rgb/{ts}.png")
        depth_lines.append(f"{ts} depth/{ts}.png")
        T_wc = np.linalg.inv(np.asarray(T_cw, np.float64))
        w, x, y, z = matrix_quaternion(T_wc[:3, :3])
        tx, ty, tz = T_wc[:3, 3]
        gt_lines.append(" ".join([ts] + [repr(float(v)) for v in
                                         (tx, ty, tz, x, y, z, w)]))
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")


def write_replica(root, colors, depths, poses_cw, depth_scale, write_color,
                  write_depth):
    """Replica layout: JPEG colour (``write_color``), 16-bit PNG depth and
    the camera-to-world matrices, one row-major line each."""
    os.makedirs(os.path.join(root, "results"), exist_ok=True)
    lines = []
    for i, (color, depth, T_cw) in enumerate(zip(colors, depths, poses_cw)):
        write_color(os.path.join(root, "results", f"frame{i:06d}.jpg"), color)
        write_depth(os.path.join(root, "results", f"depth{i:06d}.png"),
                    depth_u16(depth, depth_scale))
        T_wc = np.linalg.inv(np.asarray(T_cw, np.float64))
        lines.append(" ".join(repr(float(v)) for v in T_wc.reshape(-1)))
    with open(os.path.join(root, "traj.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def write_euroc(root, lefts, rights, poses_cw, write,
                t0=1403636579763555584, dt=50_000_000):
    """EuRoC layout: grey PNG pairs named by their timestamps in ns and the
    body (IMU) poses ``T_w_i = inv(T_cw) @ inv(T_i_c0)`` as (w, x, y, z),
    so that the parser gives back ``T_cw``."""
    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(root, "mav0", cam, "data"), exist_ok=True)
    gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    os.makedirs(gt_dir, exist_ok=True)
    rows = ["#timestamp,p_RS_R_x [m],p_RS_R_y [m],p_RS_R_z [m],q_RS_w [],"
            "q_RS_x [],q_RS_y [],q_RS_z [],v_RS_R_x [m s^-1],"
            "v_RS_R_y [m s^-1],v_RS_R_z [m s^-1],b_w_RS_S_x [rad s^-1],"
            "b_w_RS_S_y [rad s^-1],b_w_RS_S_z [rad s^-1],"
            "b_a_RS_S_x [m s^-2],b_a_RS_S_y [m s^-2],b_a_RS_S_z [m s^-2]"]
    T_c0_i = np.linalg.inv(EuRoCParser.T_i_c0)
    for i, (left, right, T_cw) in enumerate(zip(lefts, rights, poses_cw)):
        ts = t0 + i * dt
        write(os.path.join(root, "mav0", "cam0", "data", f"{ts}.png"), left)
        write(os.path.join(root, "mav0", "cam1", "data", f"{ts}.png"), right)
        T_w_i = np.linalg.inv(np.asarray(T_cw, np.float64)) @ T_c0_i
        q = matrix_quaternion(T_w_i[:3, :3])
        rows.append(",".join([str(ts)] + [repr(float(v)) for v in
                                          (*T_w_i[:3, 3], *q)]
                             + ["0"] * 9))
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


def raw_maps(K_raw, dist, R, K_new, size, margin):
    """(map_x, map_y) float32 [H, W]: where each pixel of the raw (distorted)
    image lies in an ideal render with intrinsics ``K_new`` whose borders
    were widened by ``margin`` pixels."""
    from .undistort import undistort_points

    w, h = size
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    p = undistort_points(np.stack([u.ravel(), v.ravel()], 1), K_raw, dist, R,
                         K_new, iters=50)
    return ((p[:, 0] + margin).reshape(h, w).astype(np.float32),
            (p[:, 1] + margin).reshape(h, w).astype(np.float32))

