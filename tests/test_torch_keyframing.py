"""The port's keyframe policy (``monogs_tpu_torch/slam/keyframing.py``):
``tests/test_keyframing.py`` mirrored, then random inputs through both
packages' functions, whose outputs must be equal (``keyframe_depth_init``
with equal-seeded numpy generators, bit for bit)."""

import numpy as np
import pytest

from monogs_tpu.slam import keyframing as jkf
from monogs_tpu_torch.slam.keyframing import (
    add_to_window,
    is_keyframe,
    keyframe_depth_init,
    overlap_ratio,
)


def pose(t):
    T = np.eye(4)
    T[:3, 3] = t
    return T


def test_is_keyframe_translation_trigger():
    """dist > kf_translation * median_depth forces a keyframe regardless of
    overlap (the `or dist_check` branch)."""
    vis = np.ones(100, bool)
    assert is_keyframe(
        pose([0.5, 0, 0]), pose([0, 0, 0]), median_depth=2.0,
        cur_visibility=vis, last_kf_visibility=vis,
        kf_translation=0.08, kf_min_translation=0.04, kf_overlap=0.9,
    )
    # tiny motion, full overlap: no keyframe
    assert not is_keyframe(
        pose([0.01, 0, 0]), pose([0, 0, 0]), median_depth=2.0,
        cur_visibility=vis, last_kf_visibility=vis,
        kf_translation=0.08, kf_min_translation=0.04, kf_overlap=0.9,
    )


def test_is_keyframe_overlap_trigger_needs_min_translation():
    """Low covisibility triggers a keyframe only above kf_min_translation
    (the `point_ratio < kf_overlap and dist_check2` branch)."""
    cur = np.zeros(100, bool)
    cur[:30] = True
    last = np.zeros(100, bool)
    last[25:60] = True  # IoU = 5/60 << kf_overlap
    common = dict(
        median_depth=2.0, cur_visibility=cur, last_kf_visibility=last,
        kf_translation=0.5, kf_min_translation=0.04, kf_overlap=0.9,
    )
    assert is_keyframe(pose([0.2, 0, 0]), pose([0, 0, 0]), **common)
    assert not is_keyframe(pose([0.01, 0, 0]), pose([0, 0, 0]), **common)


def test_overlap_ratio_is_iou():
    a = np.array([1, 1, 0, 0], bool)
    b = np.array([1, 0, 1, 0], bool)
    assert overlap_ratio(a, b) == 1 / 3
    assert overlap_ratio(np.zeros(4, bool), np.zeros(4, bool)) == 0.0


def test_add_to_window_evicts_low_overlap():
    """A window keyframe whose Szymkiewicz-Simpson overlap with the current
    frame falls at/below the cutoff is evicted (the LAST such one, :1752)."""
    n = 100
    cur = np.zeros(n, bool)
    cur[:50] = True
    high = np.zeros(n, bool)
    high[:45] = True            # overlap 45/45 = 1.0
    low = np.zeros(n, bool)
    low[60:] = True             # overlap 0
    occ = {10: high, 7: low, 3: low}
    poses = {i: pose([0.01 * i, 0, 0]) for i in [15, 10, 7, 3]}
    win, removed = add_to_window(
        15, cur, occ, [10, 7, 3], poses, window_size=8, kf_cutoff=0.3,
        initialized=True,
    )
    # slots 0-1 ([15, 10]) are never touched; of the two low-overlap frames
    # the LAST one (3) is removed
    assert removed == 3
    assert win == [15, 10, 7]


def test_add_to_window_inverse_distance_eviction():
    """When the window overflows, the frame with the largest
    sqrt(d_to_current) * sum(1/d_to_others) score is evicted (:1764-1783)."""
    n = 10
    vis = np.ones(n, bool)
    window = [4, 3, 2, 1]
    occ = {i: vis for i in window}
    # frame 1 sits far from the current frame AND near frame 2 -> largest
    # k * sum(1/d) score among the evictable slots
    poses = {
        5: pose([0.0, 0, 0]),
        4: pose([0.1, 0, 0]),
        3: pose([1.0, 0, 0]),
        2: pose([2.0, 0, 0]),
        1: pose([2.001, 0, 0]),
    }
    win, removed = add_to_window(
        5, vis, occ, window, poses, window_size=4, kf_cutoff=0.0,
        initialized=True,
    )
    assert removed in (1, 2)    # the near-duplicate far pair
    assert len(win) == 4
    assert win[0] == 5 and win[1] == 4  # N_dont_touch slots preserved


def test_add_to_window_uninitialized_cutoff():
    """Before initialization the cutoff is fixed at 0.4 (reset detection:
    a removed frame while uninitialized triggers the mono map reset)."""
    n = 100
    cur = np.zeros(n, bool)
    cur[:50] = True
    # overlap 12 common of min(50, 35) nnz -> ratio 0.343: between the
    # initialized cutoff (0.0 here) and the fixed uninitialized 0.4
    weak = np.zeros(n, bool)
    weak[38:73] = True          # intersection with cur = 12, min nnz = 35
    strong = cur.copy()
    # slots 0-1 of [11, 9, 8] are protected; the weak frame must sit at
    # slot >= 2 to be evictable
    occ = {9: strong, 8: weak}
    poses = {i: pose([0.01 * i, 0, 0]) for i in [11, 9, 8]}
    win, removed = add_to_window(
        11, cur, occ, [9, 8], poses, window_size=8, kf_cutoff=0.0,
        initialized=False,
    )
    # under initialized=True with kf_cutoff=0 this frame would survive
    # (0.343 > 0); the uninitialized 0.4 cutoff evicts it
    assert removed == 8
    win2, removed2 = add_to_window(
        11, cur, occ, [9, 8], poses, window_size=8, kf_cutoff=0.0,
        initialized=True,
    )
    assert removed2 is None and 8 in win2


def test_keyframe_depth_init_band_and_mask():
    rng = np.random.default_rng(0)
    h, w = 16, 16
    depth = np.full((h, w), 2.0, np.float32)
    depth[0, 0] = 50.0          # far outlier
    opacity = np.ones((h, w), np.float32)
    valid_rgb = np.ones((h, w), bool)
    valid_rgb[-1, :] = False
    out = keyframe_depth_init(depth, opacity, valid_rgb, rng)
    assert out.shape == (h, w)
    assert np.all(out[-1, :] == 0)          # invalid rgb zeroed
    # the outlier is clamped toward the median band (median 2, small std)
    assert abs(out[0, 0] - 2.0) < 25.0 and out[0, 0] != 50.0
    assert np.all(np.isfinite(out))


def random_pose(rng):
    from scipy.spatial.transform import Rotation

    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec(0.2 * rng.standard_normal(3)).as_matrix()
    T[:3, 3] = 0.3 * rng.standard_normal(3)
    return T.astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_policy_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 200
    vis = {i: rng.uniform(size=n) < rng.uniform(0.2, 0.9) for i in range(8)}
    cur = rng.uniform(size=n) < 0.6
    poses = {i: random_pose(rng) for i in range(9)}
    for args in [(poses[8], poses[0], float(rng.uniform(1, 4)), cur, vis[0],
                  0.08, 0.04, 0.9)]:
        assert is_keyframe(*args) == jkf.is_keyframe(*args)
    assert overlap_ratio(cur, vis[1]) == jkf.overlap_ratio(cur, vis[1])
    window = [int(i) for i in rng.permutation(8)[:6]]
    for initialized in (False, True):
        for cutoff in (0.3, 0.6):
            a = add_to_window(8, cur, vis, list(window), poses, 5, cutoff,
                              initialized)
            b = jkf.add_to_window(8, cur, vis, list(window), poses, 5, cutoff,
                                  initialized)
            assert a == b


@pytest.mark.parametrize("seed", range(3))
def test_depth_init_matches_jax_bitwise(seed):
    rng = np.random.default_rng(seed)
    h, w = 24, 32
    depth = rng.uniform(0.5, 5.0, (h, w)).astype(np.float32)
    depth[rng.uniform(size=(h, w)) < 0.1] = 0.0
    opacity = rng.uniform(0.8, 1.0, (h, w)).astype(np.float32)
    valid_rgb = rng.uniform(size=(h, w)) < 0.9
    a = keyframe_depth_init(depth, opacity, valid_rgb,
                            np.random.default_rng(100 + seed))
    b = jkf.keyframe_depth_init(depth, opacity, valid_rgb,
                                np.random.default_rng(100 + seed))
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
