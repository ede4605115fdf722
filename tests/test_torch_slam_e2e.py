"""End-to-end SLAM through the port on a tiny synthetic sequence (CPU).

``tests/test_slam_e2e.py`` mirrored on ``monogs_tpu_torch`` with
``device="cpu"`` (the port's own synthetic scene, its own generators):
SLAM rebuilds a map from scratch and tracks the camera; the run completes,
keyframes are created, the map is populated, and the keyframe ATE is
small beside the trajectory's extent. Same marks and bounds."""

import copy
import os

import numpy as np
import pytest

from monogs_tpu_torch.slam.config import load_config
from monogs_tpu_torch.slam.runtime import SLAM as _SLAM
from tests.torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def SLAM(cfg, save_dir=None):
    return _SLAM(cfg, save_dir=save_dir, device="cpu")


def tiny_config(sensor="depth"):
    cfg = load_config(os.path.join(REPO, "configs/synthetic/rgbd.yaml"))
    cfg = copy.deepcopy(cfg)
    cfg["Dataset"]["sensor_type"] = sensor
    cfg["Dataset"]["Calibration"].update(
        {"width": 160, "height": 128, "fx": 160.0, "fy": 160.0,
         "cx": 79.5, "cy": 63.5}
    )
    # per-frame motion ~ trans_amp * 2*pi / n_frames; keep it at the
    # 10-30mm/frame of a real handheld sequence (TUM-like) so the tracker's
    # per-frame iteration budget applies, but large enough that the keyframe
    # policy actually fires
    cfg["Dataset"]["synthetic"] = {
        "n_frames": 12, "n_gauss": 3000, "seed": 0,
        "trans_amp": 0.015, "rot_amp": 0.005,
        # linear pan: 0.14m sideways + 9 degrees yaw over the sequence,
        # ~12mm + 1-2px image shift per frame (TUM-frame-rate-like motion)
        # — sweeps the view so covisibility drops and keyframes fire
        "pan": [0.14, 0.0, 0.03, 0.0, 0.16, 0.0],
    }
    cfg["Training"]["kf_translation"] = 0.01
    cfg["Training"]["kf_min_translation"] = 0.005
    # dense-enough insertion for the tiny test resolution (the reference's
    # downsample factors assume 0.3-0.8 Mpixel frames)
    cfg["Dataset"]["pcd_downsample"] = 8
    cfg["Dataset"]["pcd_downsample_init"] = 4
    cfg["Training"]["lr"]["cam_trans_delta"] = 0.002
    cfg["Training"]["lr"]["cam_rot_delta"] = 0.006
    cfg["Dataset"]["single_thread"] = True
    cfg["Training"]["monocular"] = sensor == "monocular"
    cfg["Training"]["init_itr_num"] = 120
    cfg["Training"]["mapping_itr_num"] = 30
    cfg["Training"]["window_size"] = 5
    cfg["Training"]["pose_window"] = 3
    cfg["Training"]["kf_interval"] = 2
    cfg["Training"]["RGN"]["first_order"]["max_iter"] = 30
    cfg["Training"]["RGN"]["second_order"]["max_iter"] = 4
    cfg["Training"]["RGN"]["second_order"]["stack_dim"] = 4
    cfg["Renderer"] = {
        "map_capacity": 16384, "insert_cap": 4096,
        "macro_tiles": 4, "k_macro": 2048, "k_fine": 256,
    }
    return cfg


@pytest.mark.slow
def test_rgbd_slam_end_to_end(tmp_path):
    cfg = tiny_config("depth")
    cfg["Results"]["save_results"] = True
    cfg["Results"]["save_trj"] = True
    cfg["Results"]["save_dir"] = str(tmp_path)
    slam = SLAM(cfg, save_dir=str(tmp_path))
    slam.run()

    fe = slam.frontend
    assert len(fe.cameras) == 12
    assert len(fe.kf_indices) >= 2
    assert int(slam.backend.gaussians.n_active) > 500

    # keyframe ATE against ground truth
    from monogs_tpu_torch.eval.ate import evaluate_ate

    gt = [np.linalg.inv(np.asarray(fe.cameras[i].T_gt)) for i in fe.kf_indices]
    est = [np.linalg.inv(np.asarray(fe.cameras[i].T)) for i in fe.kf_indices]
    rmse, _ = evaluate_ate(gt, est, monocular=False)
    # trajectory extent is ~0.3m; demand cm-level tracking
    assert rmse < 0.03, rmse

    # trajectory artifacts written
    assert (tmp_path / "plot").exists()


@pytest.mark.slow
def test_rgbd_slam_threaded_pipelined():
    """Threaded frontend/backend (single_thread: False) with the depth-1
    tracking dispatch pipeline (Training.pipeline_tracking, default on):
    frame i's fused tracking program is enqueued, seeded from frame i-1's
    still-in-flight device pose, before the host syncs i-1. Same completion
    and accuracy contract as the deterministic run; the bound is slightly
    looser because the backend maps concurrently and keyframe sync points
    land nondeterministically."""
    cfg = tiny_config("depth")
    cfg["Dataset"]["single_thread"] = False
    cfg["Results"]["save_results"] = False
    slam = SLAM(cfg, save_dir=None)
    slam.run()

    fe = slam.frontend
    assert len(fe.cameras) == 12
    assert len(fe.kf_indices) >= 2
    assert fe._pending is None          # pipeline fully drained
    assert fe.n_pipelined >= 1, "dispatch pipeline never engaged"
    assert int(slam.backend.gaussians.n_active) > 500

    from monogs_tpu_torch.eval.ate import evaluate_ate

    gt = [np.linalg.inv(np.asarray(fe.cameras[i].T_gt)) for i in fe.kf_indices]
    est = [np.linalg.inv(np.asarray(fe.cameras[i].T)) for i in fe.kf_indices]
    rmse, _ = evaluate_ate(gt, est, monocular=False)
    assert rmse < 0.05, rmse


@pytest.mark.slow
def test_override_replay_modes(tmp_path):
    """Tracking override/replay (slam_frontend.py:106-110, 756-813): a gt
    override must adopt ground-truth poses (and re-render keyframe inputs at
    the adopted pose); a 'first' replay over a logged run must reproduce the
    logged trajectory."""
    # 1) logged baseline run
    cfg = tiny_config("depth")
    cfg["Dataset"]["synthetic"]["n_frames"] = 8
    cfg["Results"]["save_results"] = False
    cfg["Training"]["RGN"]["log_output"] = True
    cfg["Training"]["RGN"]["save_period"] = 1
    logdir = str(tmp_path / "baseline")   # logger writes <basedir>/<stamp>/
    cfg["Training"]["RGN"]["log_basedir"] = logdir
    slam = SLAM(cfg, save_dir=None)
    slam.run()
    base_T = {i: np.asarray(slam.frontend.cameras[i].T) for i in range(8)}

    from monogs_tpu_torch.utils.profiling import load_profile_logs

    logs = load_profile_logs(logdir)
    assert len(logs) >= 7, f"profile logs missing: {sorted(logs)}"

    # 2) gt override: adopted poses are exactly ground truth
    cfg_gt = tiny_config("depth")
    cfg_gt["Dataset"]["synthetic"]["n_frames"] = 8
    cfg_gt["Results"]["save_results"] = False
    cfg_gt["Training"]["RGN"]["override"] = {"mode": "gt"}
    slam_gt = SLAM(cfg_gt, save_dir=None)
    slam_gt.run()
    fe = slam_gt.frontend
    for i in range(1, 8):
        if i in fe.kf_indices:
            continue  # keyframe poses are later refined by mapping BA
        np.testing.assert_allclose(
            np.asarray(fe.cameras[i].T), np.asarray(fe.cameras[i].T_gt),
            atol=1e-6,
        )

    # 3) 'first' replay of the logged run reproduces its poses
    cfg_rp = tiny_config("depth")
    cfg_rp["Dataset"]["synthetic"]["n_frames"] = 8
    cfg_rp["Results"]["save_results"] = False
    cfg_rp["Training"]["RGN"]["override"] = {
        "mode": "first", "first_logdir": logdir,
    }
    slam_rp = SLAM(cfg_rp, save_dir=None)
    slam_rp.run()
    for i in range(1, 8):
        if i in slam_rp.frontend.kf_indices:
            continue  # keyframe poses are later refined by mapping BA
        np.testing.assert_allclose(
            np.asarray(slam_rp.frontend.cameras[i].T),
            np.asarray(logs[i]["pose"]), atol=1e-5,
        )
    del base_T  # baseline poses only anchor the log sanity check above


@pytest.mark.slow
def test_mono_slam_end_to_end(tmp_path):
    """Monocular pipeline: random-depth keyframe init, scale-free map,
    Sim(3)-aligned ATE, covisibility pruning. Thresholds are loose — mono
    SLAM on a 12-frame synthetic sequence is about exercising the code
    paths (reset logic, mono depth init, Sim3 eval), not accuracy."""
    cfg = tiny_config("monocular")
    cfg["Results"]["save_results"] = False
    slam = SLAM(cfg, save_dir=None)
    slam.run()

    fe = slam.frontend
    assert len(fe.cameras) == 12
    assert len(fe.kf_indices) >= 2
    assert int(slam.backend.gaussians.n_active) > 200

    from monogs_tpu_torch.eval.ate import evaluate_ate

    gt = [np.linalg.inv(np.asarray(fe.cameras[i].T_gt)) for i in fe.kf_indices]
    est = [np.linalg.inv(np.asarray(fe.cameras[i].T)) for i in fe.kf_indices]
    rmse, _ = evaluate_ate(gt, est, monocular=True)
    assert np.isfinite(rmse)
    assert rmse < 0.15, rmse
