"""Keyframe policy and sliding-window management (host-side logic).

Counterpart of ``monogs_tpu/slam/keyframing.py`` (the port keeps its own
copy): translation-vs-median-depth checks, covisibility IoU against the
last keyframe, the Szymkiewicz-Simpson overlap cutoff for window eviction,
inverse-distance eviction when the window overflows, and the monocular
keyframe depth initialisation. Host numpy on 4x4 poses and visibility
vectors read once per frame; the numpy generator is passed in, so that a
run seeded like the JAX package's draws the same noise.
"""

from __future__ import annotations

import numpy as np


def is_keyframe(
    pose_CW: np.ndarray,
    last_kf_CW: np.ndarray,
    median_depth: float,
    cur_visibility: np.ndarray,
    last_kf_visibility: np.ndarray,
    kf_translation: float,
    kf_min_translation: float,
    kf_overlap: float,
) -> bool:
    last_kf_WC = np.linalg.inv(last_kf_CW)
    dist = float(np.linalg.norm((pose_CW @ last_kf_WC)[0:3, 3]))
    dist_check = dist > kf_translation * median_depth
    dist_check2 = dist > kf_min_translation * median_depth

    union = np.count_nonzero(np.logical_or(cur_visibility, last_kf_visibility))
    intersection = np.count_nonzero(
        np.logical_and(cur_visibility, last_kf_visibility)
    )
    point_ratio = intersection / max(union, 1)
    return (point_ratio < kf_overlap and dist_check2) or dist_check


def overlap_ratio(cur_visibility, last_kf_visibility) -> float:
    """IoU used by the not-yet-full-window keyframe check (:1925-1936)."""
    union = np.count_nonzero(np.logical_or(cur_visibility, last_kf_visibility))
    intersection = np.count_nonzero(
        np.logical_and(cur_visibility, last_kf_visibility)
    )
    return intersection / max(union, 1)


def add_to_window(
    cur_frame_idx: int,
    cur_visibility: np.ndarray,
    occ_aware_visibility: dict,
    window: list,
    poses: dict,          # kf_idx -> 4x4 W2C numpy
    window_size: int,
    kf_cutoff: float,
    initialized: bool,
):
    """Returns (new_window, removed_frame_or_None). Mirrors :1722-1783."""
    N_dont_touch = 2
    window = [cur_frame_idx] + window
    to_remove = []
    removed_frame = None
    for i in range(N_dont_touch, len(window)):
        kf_idx = window[i]
        intersection = np.count_nonzero(
            np.logical_and(cur_visibility, occ_aware_visibility[kf_idx])
        )
        denom = min(
            np.count_nonzero(cur_visibility),
            np.count_nonzero(occ_aware_visibility[kf_idx]),
        )
        point_ratio = intersection / max(denom, 1)
        cut_off = kf_cutoff if initialized else 0.4
        if point_ratio <= cut_off:
            to_remove.append(kf_idx)

    if to_remove:
        window.remove(to_remove[-1])
        removed_frame = to_remove[-1]

    kf_0_WC = np.linalg.inv(poses[cur_frame_idx])

    if len(window) > window_size:
        inv_dist = []
        for i in range(N_dont_touch, len(window)):
            inv_dists = []
            kf_i_CW = poses[window[i]]
            for j in range(N_dont_touch, len(window)):
                if i == j:
                    continue
                kf_j_WC = np.linalg.inv(poses[window[j]])
                T_CiCj = kf_i_CW @ kf_j_WC
                inv_dists.append(1.0 / (np.linalg.norm(T_CiCj[0:3, 3]) + 1e-6))
            T_CiC0 = kf_i_CW @ kf_0_WC
            k = np.sqrt(np.linalg.norm(T_CiC0[0:3, 3]))
            inv_dist.append(k * sum(inv_dists))

        idx = int(np.argmax(inv_dist))
        removed_frame = window[N_dont_touch + idx]
        window.remove(removed_frame)

    return window, removed_frame


def keyframe_depth_init(
    render_depth: np.ndarray,   # [H, W]
    render_opacity: np.ndarray, # [H, W]
    valid_rgb: np.ndarray,      # [H, W] bool
    rng: np.random.Generator,
) -> np.ndarray:
    """Monocular keyframe depth initialization (slam_frontend.py:194-230):
    clamp render depth to median +- std over confident pixels, then add noise
    (0.2*std inside the band, 0.5*std outside); invalid rgb pixels get 0."""
    depth = render_depth.copy()
    valid = (depth > 0) & (render_opacity > 0.95) & valid_rgb
    vals = depth[valid]
    if vals.size == 0:
        return np.zeros_like(depth)
    median = np.sort(vals)[(vals.size - 1) // 2]
    std = float(vals.std(ddof=1)) if vals.size > 1 else 0.0
    invalid = (depth > median + std) | (depth < median - std) | ~valid
    depth[invalid] = median
    noise_scale = np.where(invalid, std * 0.5, std * 0.2)
    depth = depth + rng.standard_normal(depth.shape).astype(depth.dtype) * noise_scale
    depth[~valid_rgb] = 0
    return depth
