"""Absolute trajectory error: Umeyama alignment + APE translation RMSE.

Counterpart of ``monogs_tpu/eval/ate.py`` (the port keeps its own copy):
align the estimated camera-to-world keyframe positions to ground truth
with an SE(3) (Sim(3) when monocular) Umeyama fit, report the RMSE of the
translation residuals, and save trj_*.json / stats_*.json and a
best-effort 2D plot under <save_dir>/plot. Poses may be tensors on any
device or numpy arrays.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..utils.logging import Log


def host64(x) -> np.ndarray:
    """A tensor (any device) or array as float64 numpy."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool):
    """Least-squares similarity transform dst ~ s * R @ src + t.

    src/dst: [N, 3]. Returns (s, R, t).
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / src.shape[0]
        s = np.trace(np.diag(D) @ S) / max(var_s, 1e-12)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def evaluate_ate(poses_gt, poses_est, monocular=False):
    """APE translation RMSE after Umeyama alignment.

    poses_*: list of 4x4 camera-to-world matrices. Returns (rmse, stats).
    """
    p_gt = np.stack([host64(P)[:3, 3] for P in poses_gt])
    p_est = np.stack([host64(P)[:3, 3] for P in poses_est])
    s, R, t = umeyama(p_est, p_gt, with_scale=monocular)
    p_al = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(p_al - p_gt, axis=1)
    stats = {
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
        "sse": float((err**2).sum()),
    }
    return stats["rmse"], stats


def eval_ate(frames, kf_ids, save_dir, iterations, final=False, monocular=False):
    """Keyframe-trajectory ATE + json artifacts (eval_utils.py:72-111)."""
    if len(kf_ids) == 0:
        return float("nan")
    trj_id, trj_est, trj_gt = [], [], []
    trj_est_np, trj_gt_np = [], []
    for kf_id in kf_ids:
        kf = frames[kf_id]
        pose_est = np.linalg.inv(host64(kf.T))
        pose_gt = np.linalg.inv(host64(kf.T_gt))
        trj_id.append(kf.uid)
        trj_est.append(pose_est.tolist())
        trj_gt.append(pose_gt.tolist())
        trj_est_np.append(pose_est)
        trj_gt_np.append(pose_gt)

    ate, stats = evaluate_ate(trj_gt_np, trj_est_np, monocular=monocular)
    Log("RMSE ATE [m]", ate, tag="Eval")

    if save_dir is not None:
        plot_dir = os.path.join(save_dir, "plot")
        os.makedirs(plot_dir, exist_ok=True)
        label = "final" if final else "{:04}".format(iterations)
        with open(os.path.join(plot_dir, f"trj_{label}.json"), "w") as f:
            json.dump(
                {"trj_id": trj_id, "trj_est": trj_est, "trj_gt": trj_gt}, f,
                indent=4,
            )
        with open(os.path.join(plot_dir, f"stats_{label}.json"), "w") as f:
            json.dump(stats, f, indent=4)
        _try_plot(trj_gt_np, trj_est_np, stats, plot_dir, label, monocular)
    return ate


def _try_plot(trj_gt, trj_est, stats, plot_dir, label, monocular):
    """2D xy trajectory plot (eval_utils.py:53-67); best-effort."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        p_gt = np.stack([P[:3, 3] for P in trj_gt])
        p_est = np.stack([P[:3, 3] for P in trj_est])
        s, R, t = umeyama(p_est, p_gt, with_scale=monocular)
        p_al = (s * (R @ p_est.T)).T + t
        fig, ax = plt.subplots()
        ax.plot(p_gt[:, 0], p_gt[:, 1], "--", color="gray", label="gt")
        ax.plot(p_al[:, 0], p_al[:, 1], "-", color="C0", label="est")
        ax.set_title(f"ATE RMSE: {stats['rmse']}")
        ax.legend()
        fig.savefig(
            os.path.join(plot_dir, f"evo_2dplot_{label}.png"), dpi=90
        )
        plt.close(fig)
    except Exception:  # noqa: BLE001 - the plot is best-effort
        pass
