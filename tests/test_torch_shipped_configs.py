"""The shipped recorded-dataset configs through both packages (CPU).

``configs/rgbd/tum/fr1_desk.yaml`` (RGB-D) and
``configs/mono/tum/fr3_office.yaml`` (mono), each loaded through each
package's ``load_config``, run through ``SLAM(config).run()`` of the JAX
package and of the port on the same frames, with the JAX key chain
replayed into the port (``JaxDraws``).

Kept as the files give them: ``Training`` ``kf_interval`` 5,
``kf_translation`` 0.08, ``kf_min_translation`` 0.05, ``kf_overlap`` 0.9,
``kf_cutoff`` 0.3, ``window_size`` 8, ``edge_threshold``,
``rgb_boundary_threshold``; ``Training.RGN`` (``so_from_fo_aux`` True,
``bin_margin`` 16, the tile fractions 0.12); ``Dataset``
``pcd_downsample`` (128 RGB-D, 64 mono), ``pcd_downsample_init`` 32,
``point_size`` 0.01, ``adaptive_pointsize``; ``Renderer.k_fine`` 96.

Changed, and nothing else:
- the calibration, scaled to ``test_slam_e2e.tiny_config``'s 160x128
  (focal lengths and principal points; the frames come undistorted);
- the iteration budgets, cut as in
  ``test_torch_slam_files.tum_files_config`` (init 2, mapping 1) but for
  tracking: first order 20, second order 1 for RGB-D (so that the
  second order runs once on the macro lists frozen at the seed pose,
  ``so_from_fo_aux``; a second-order iteration costs 2-3 s a frame in the
  port on one CPU thread and its program about 17 s of JAX compile) and
  0 for mono. Tracking follows about half of each frame's motion at this
  budget (a tenth at 3 first-order iterations, where the overlap never
  left 1.0);
- ``Dataset.single_thread`` True (deterministic);
- ``Renderer.backend`` "xla" on the CPU, as the other parity tests;
- two capacities, not policy: ``Renderer.insert_cap`` 4096 and
  ``map_capacity`` 16384, tiny_config's (the defaults, 32768 and 2^17,
  hold rows that no 160x128 insertion fills, and the brute-force k-NN of
  an insertion over 32768 rows takes 50 s on one CPU thread);
- ``Results.save_results`` False (no trajectory files);
- ``Training.monocular`` set from the sensor, as both runtimes read it;
- the frames: tiny_config's scene (3000 Gaussians, seed 0) on the stock
  synthetic orbit (``configs/synthetic/rgbd.yaml``'s ``trans_amp`` 0.25
  and ``rot_amp`` 0.06 over its 64 frames: 25 mm a frame, three times
  TUM's pace; tiny_config's pan left out), its first ``N_FRAMES``
  rendered by the port on the CPU at the config's scaled calibration as
  ``SyntheticDataset`` renders them, and handed to both packages as one
  list of numpy frames: 6 RGB-D, 7 mono. At TUM's pace
  (``tum_like_amps``) the shipped policy takes no second keyframe here:
  the visibility overlap with keyframe 0 stays above ``kf_overlap`` for
  32 frames, also at 640x480 (``chip_smoke.py``'s ``files_path``). On
  this orbit the decisions from frame 5 on (``kf_interval`` after
  keyframe 0) take keyframe 5 for RGB-D (overlap about 0.71) and
  keyframe 6 for mono (about 0.93 at frame 5, 0.86 at frame 6), so the
  later insertion (``pcd_downsample``) runs in both packages.

Tolerances, as ``tests/test_torch_slam.py``'s: keyframes and windows
equal, two keyframes or more; the overlap ratios behind each decision
within 0.01, the one that took the second keyframe under
``kf_overlap`` in both and those before it at or above it;
the insertions (keyframe, initial or ``pcd_downsample``) alike, with
``n_active`` after each within 0.5 %; every pose within 2 mm and 5 mrad;
keyframe ATE within 1 mm.
"""

import copy
import os

import numpy as np
import pytest
import torch

from monogs_tpu.eval.ate import evaluate_ate as jevaluate_ate
from monogs_tpu.slam import backend as jbackend
from monogs_tpu.slam import frontend as jfrontend
from monogs_tpu.slam.config import load_config as jload_config
from monogs_tpu.slam.runtime import SLAM as JSLAM
from monogs_tpu_torch.data.datasets import intrinsics_from_calibration
from monogs_tpu_torch.data.synthetic import make_synthetic_scene, orbit_pose
from monogs_tpu_torch.eval.ate import evaluate_ate
from monogs_tpu_torch.ops import se3 as tse3
from monogs_tpu_torch.render import RenderConfig, render
from monogs_tpu_torch.slam import backend as tbackend
from monogs_tpu_torch.slam import frontend as tfrontend
from monogs_tpu_torch.slam.config import load_config
from tests.test_slam_e2e import tiny_config
from tests.test_torch_slam import kf_ate, logging_ratio, port_slam, poses
from tests.torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = {"rgbd": "configs/rgbd/tum/fr1_desk.yaml",
           "mono": "configs/mono/tum/fr3_office.yaml"}
SEQUENCE = "configs/synthetic/rgbd.yaml"     # the stock orbit's amplitudes
N_FRAMES = {"rgbd": 6, "mono": 7}
SECOND_KEYFRAME = {"rgbd": 5, "mono": 6}
FO_ITERS = 20
SO_ITERS = {"rgbd": 1, "mono": 0}
WIDTH, HEIGHT = 160, 128
INSERT_CAP, MAP_CAPACITY = 4096, 16384     # tiny_config's

# (section, key, value) as the shipped files give them
KEPT = [("Training", "kf_interval", 5), ("Training", "kf_translation", 0.08),
        ("Training", "kf_min_translation", 0.05),
        ("Training", "kf_overlap", 0.9), ("Training", "kf_cutoff", 0.3),
        ("Training", "window_size", 8), ("Dataset", "pcd_downsample_init", 32),
        ("Dataset", "point_size", 0.01),
        ("Dataset", "adaptive_pointsize", True), ("Renderer", "k_fine", 96)]
PCD_DOWNSAMPLE = {"rgbd": 128, "mono": 64}


def shipped_config(load, sensor):
    """The shipped config of ``sensor`` through ``load`` with this file's
    changes (the module docstring's list)."""
    cfg = load(os.path.join(REPO, SHIPPED[sensor]))
    calib = cfg["Dataset"]["Calibration"]
    sx, sy = WIDTH / calib["width"], HEIGHT / calib["height"]
    calib.update(fx=calib["fx"] * sx, fy=calib["fy"] * sy,
                 cx=(calib["cx"] + 0.5) * sx - 0.5,
                 cy=(calib["cy"] + 0.5) * sy - 0.5, width=WIDTH,
                 height=HEIGHT)
    tr = cfg["Training"]
    tr["init_itr_num"] = 2
    tr["mapping_itr_num"] = 1
    tr["RGN"]["first_order"]["max_iter"] = FO_ITERS
    tr["RGN"]["second_order"]["max_iter"] = SO_ITERS[sensor]
    tr["monocular"] = sensor == "mono"
    cfg["Dataset"]["single_thread"] = True
    cfg["Renderer"].update(backend="xla", insert_cap=INSERT_CAP,
                           map_capacity=MAP_CAPACITY)
    cfg["Results"]["save_results"] = False
    return cfg


def stock_orbit_frames(cfg, n_frames):
    """tiny_config's scene on the stock synthetic orbit, rendered by the
    port at ``cfg``'s calibration: the first ``n_frames`` as numpy (image,
    depth, pose)."""
    syn = tiny_config()["Dataset"]["synthetic"]
    orbit = load_config(os.path.join(REPO, SEQUENCE))["Dataset"]["synthetic"]
    intr = intrinsics_from_calibration(cfg["Dataset"]["Calibration"])
    scene = make_synthetic_scene(torch.Generator().manual_seed(syn["seed"]),
                                 n=syn["n_gauss"])
    frames = []
    with torch.no_grad():
        for i in range(n_frames):
            T = orbit_pose(i / orbit["n_frames"], orbit["trans_amp"],
                           orbit["rot_amp"], device="cpu")
            out = render(scene, T, intr, RenderConfig(with_n_touched=False))
            frames.append((out.image.clamp(0.0, 1.0).numpy(),
                           out.depth[0].numpy(), T.numpy()))
    return frames


def logging_insertion(fn, log):
    """``BackEnd.add_next_kf`` logging (keyframe, initial?, n_active
    after) of each insertion."""
    def logged(self, frame_idx, kf, depth_map, init=False):
        out = fn(self, frame_idx, kf, depth_map, init=init)
        log.append((frame_idx, init, int(self.gaussians.n_active)))
        return out
    return logged


@pytest.fixture(scope="module", params=sorted(SHIPPED))
def shipped_runs(request):
    sensor = request.param
    jcfg = shipped_config(jload_config, sensor)
    cfg = shipped_config(load_config, sensor)
    frames = stock_orbit_frames(jcfg, N_FRAMES[sensor])
    ratios = {"jax": [], "port": []}
    inserts = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        for fe, be, key in ((jfrontend, jbackend, "jax"),
                            (tfrontend, tbackend, "port")):
            mp.setattr(fe, "overlap_ratio",
                       logging_ratio(fe.overlap_ratio, ratios[key]))
            mp.setattr(be.BackEnd, "add_next_kf",
                       logging_insertion(be.BackEnd.add_next_kf,
                                         inserts[key]))
        a = JSLAM(copy.deepcopy(jcfg), dataset=frames)
        a.run()
        b = port_slam(cfg, dataset=frames, replay=True)
        b.run()
    return sensor, jcfg, cfg, a, b, dict(ratios=ratios, inserts=inserts)


def test_shipped_settings_reach_both_packages(shipped_runs):
    """Both packages load the same config from the shipped file, and its
    policy, insertion, tracking and renderer settings reach both
    runtimes as the file gives them."""
    sensor, jcfg, cfg, a, b, _ = shipped_runs
    assert jcfg == cfg
    for section, key, value in KEPT + [
            ("Dataset", "pcd_downsample", PCD_DOWNSAMPLE[sensor])]:
        assert cfg[section][key] == value, (section, key)
    rgn = cfg["Training"]["RGN"]
    assert rgn["so_from_fo_aux"] and rgn["bin_margin"] == 16
    assert rgn["first_order"]["tile_frac"] == 0.12
    assert rgn["second_order"]["tile_frac"] == 0.12
    tr = cfg["Training"]
    for s in (a, b):
        fe, be = s.frontend, s.backend
        assert (fe.kf_interval, fe.kf_translation, fe.kf_min_translation,
                fe.kf_overlap, fe.kf_cutoff, fe.window_size) == (
            5, 0.08, 0.05, 0.9, 0.3, 8)
        assert (be.pcd_downsample, be.pcd_downsample_init, be.point_size,
                be.adaptive_pointsize) == (PCD_DOWNSAMPLE[sensor], 32, 0.01,
                                           True)
        assert s.tcfg.so_from_fo_aux and s.tcfg.bin_margin == 16
        assert s.tcfg.fo_tile_frac == s.tcfg.so_tile_frac == 0.12
        assert s.track_render_cfg.k_fine == s.render_cfg.k_fine == 96
        assert s.render_cfg.backend == "xla"
        assert (fe.single_thread, fe.monocular) == (True, sensor == "mono")
    assert tr["edge_threshold"] == 1.1 and tr["rgb_boundary_threshold"] == 0.01


def test_shipped_keyframes_and_windows(shipped_runs):
    sensor, _, cfg, a, b, logs = shipped_runs
    ratios = logs["ratios"]
    # the overlap ratios behind each keyframe decision, for the message
    assert b.frontend.kf_indices == a.frontend.kf_indices, ratios
    assert b.frontend.kf_indices[0] == 0
    assert len(b.frontend.kf_indices) >= 2, ratios
    assert b.frontend.current_window == a.frontend.current_window
    assert b.backend.current_window == a.backend.current_window
    assert sorted(b.backend.viewpoints) == sorted(a.backend.viewpoints)
    assert len(b.frontend.cameras) == N_FRAMES[sensor]
    # the shipped policy decided from frame 5 (kf_interval after keyframe
    # 0) on the same overlaps in both packages: the decisions before the
    # second keyframe at or above kf_overlap, its own under it in both
    np.testing.assert_allclose(ratios["port"], ratios["jax"], atol=0.01)
    second = SECOND_KEYFRAME[sensor]
    assert b.frontend.kf_indices == [0, second], ratios
    kf_overlap = cfg["Training"]["kf_overlap"]
    interval = cfg["Training"]["kf_interval"]
    for key in ("jax", "port"):
        # ratios[key][i] is frame i + 1's, a decision from frame interval
        assert ratios[key][second - 1] < kf_overlap, (key, ratios)
        assert all(r >= kf_overlap
                   for r in ratios[key][interval - 1:second - 1]), (key,
                                                                     ratios)


def test_shipped_insertions(shipped_runs):
    """Both packages insert at the same keyframes, the first at
    ``pcd_downsample_init`` and the next at ``pcd_downsample``, to active
    counts within 0.5 %."""
    sensor, _, _, a, b, logs = shipped_runs
    ja, po = logs["inserts"]["jax"], logs["inserts"]["port"]
    assert [k[:2] for k in po] == [k[:2] for k in ja], (ja, po)
    assert [k[:2] for k in po] == [(0, True),
                                   (SECOND_KEYFRAME[sensor], False)], po
    for (_, _, na), (_, _, nb) in zip(ja, po):
        assert abs(nb - na) <= 0.005 * na, (ja, po)


def test_shipped_map(shipped_runs):
    _, _, _, a, b, _ = shipped_runs
    na = int(a.backend.gaussians.n_active)
    nb = int(b.backend.gaussians.n_active)
    assert abs(nb - na) <= 0.005 * na, (na, nb)
    assert na > 100
    assert b.backend.iteration_count == a.backend.iteration_count


def test_shipped_poses_and_ate(shipped_runs):
    sensor, _, _, a, b, _ = shipped_runs
    pa, pb = poses(a), poses(b)
    assert sorted(pa) == sorted(pb)
    for i in pa:
        dt, dr = tse3.pose_diff(torch.from_numpy(pb[i]),
                                torch.from_numpy(pa[i]))
        assert float(dt) < 2e-3 and float(dr) < 5e-3, (i, float(dt), float(dr))
    ate_a = kf_ate(a.frontend, jevaluate_ate)
    ate_b = kf_ate(b.frontend, evaluate_ate)
    assert abs(ate_a - ate_b) < 1e-3, (ate_a, ate_b)
    assert np.isfinite(ate_b)
