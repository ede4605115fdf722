"""Live RealSense mode (``Dataset.type: realsense``) through both
packages, on a simulated camera (``tests/sim_realsense.py``: a stand-in
``pyrealsense2`` serving the stock synthetic sequence rendered by the
port at 640x360, with nonzero distortion coefficients), on the CPU.

- ``RealsenseDataset`` of the port against the JAX package's on the same
  camera: the undistorted image within 1/255 on at most 1e-4 of the
  values (the loader tests' limit for the port's remap against
  ``cv2.remap``, which the JAX loader calls), the depth equal to the JAX
  package's float64 depth cast to float32, the identity pose; both set
  the fixed exposure.
- A live SLAM run, cut to three frames and a few iterations,
  single-thread: RGB-D and mono, each completing with the GUI serving on
  a free port, ``backend.live_mode`` true and the intrinsics taken from
  the camera (the shipped live configs have no ``Dataset.Calibration``);
  the mono run's initial BA asks for 50 iterations.
- A live config with a ``Calibration`` constructs in both packages with
  the same ``use_gui`` and ``live_mode`` and the calibration's
  intrinsics; without one the JAX package raises ``KeyError`` (the
  reference's fault, which the port does not copy).
"""

import copy
import sys

import numpy as np
import pytest
import torch

from monogs_tpu.data import datasets as jds
from monogs_tpu.slam.runtime import SLAM as JSLAM
from monogs_tpu_torch.data import datasets as tds
from monogs_tpu_torch.slam import backend as tbackend
from monogs_tpu_torch.slam import runtime as truntime
from monogs_tpu_torch.slam.config import load_config
from tests import sim_realsense as sim
from tests.torch_one_thread import one_torch_thread  # noqa: F401

N_FRAMES = 3
LIVE = {"depth": "configs/live/realsense_rgbd.yaml",
        "monocular": "configs/live/realsense.yaml"}


@pytest.fixture(scope="module")
def frames():
    colors, depths, _ = sim.render_frames(N_FRAMES, "cpu")
    return colors, depths


@pytest.fixture
def camera(frames, monkeypatch):
    """A fresh simulated camera, as ``pyrealsense2`` for this test only."""
    rs = sim.module(*frames)
    monkeypatch.setitem(sys.modules, "pyrealsense2", rs)
    return rs


def live_config(sensor):
    """The shipped live config cut to a CPU run of N_FRAMES frames: few
    iterations, a sparse map, k_fine 16, one thread, a keyframe each
    frame (overlap test always passed) and a window of three, so that the
    mono run's third frame fills it and runs the initial BA."""
    cfg = load_config(LIVE[sensor])
    tr = cfg["Training"]
    tr.update(init_itr_num=2, mapping_itr_num=1, window_size=3,
              kf_interval=1, kf_translation=0.001, kf_min_translation=0.0005,
              kf_overlap=1.01)
    tr["RGN"]["first_order"].update(max_iter=2, min_iter=0)
    tr["RGN"]["second_order"]["max_iter"] = 1
    cfg["Dataset"].update(single_thread=True, pcd_downsample=1024,
                          pcd_downsample_init=256)
    cfg["Renderer"].update(gui_port=0, k_fine=16, k_macro=256,
                           mapping_tile_frac=0.1, map_capacity=8192,
                           insert_cap=2048)
    return cfg


def calibration():
    fx, fy, cx, cy, w, h = sim.intrinsics()
    k1, k2, p1, p2, k3 = sim.COEFFS
    return dict(fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h, k1=k1, k2=k2,
                p1=p1, p2=p2, k3=k3, distorted=True,
                depth_scale=1.0 / sim.DEPTH_SCALE)


def test_realsense_dataset_matches_jax(camera):
    cfg = {"Dataset": {"type": "realsense", "sensor_type": "depth"}}
    jd = jds.RealsenseDataset(cfg)
    td = tds.RealsenseDataset(cfg, device="cpu")
    fixed = [("color", "enable_auto_exposure", False),
             ("color", "enable_auto_white_balance", False),
             ("color", "exposure", 100)]
    assert camera.log == fixed + fixed
    assert (td.fx, td.fy, td.cx, td.cy, td.width, td.height) == (
        jd.fx, jd.fy, jd.cx, jd.cy, jd.width, jd.height) == sim.intrinsics()
    np.testing.assert_array_equal(td.dist_coeffs, jd.dist_coeffs)
    assert np.abs(td.dist_coeffs).sum() > 0 and td.disorted
    assert len(td) == len(jd) == 999999
    for i in range(2):
        jimg, jdepth, jpose = jd[i]
        timg, tdepth, tpose = td[i]
        lsb = np.abs(timg.numpy().astype(np.float64)
                     - np.asarray(jimg, np.float64)) * 255
        assert timg.shape == (3, sim.HEIGHT, sim.WIDTH)
        assert lsb.max() <= 1 + 1e-6 and (lsb > 1e-6).mean() <= 1e-4, (
            i, lsb.max(), (lsb > 1e-6).mean())
        assert tdepth.dtype == torch.float32
        np.testing.assert_array_equal(tdepth.numpy(),
                                      np.asarray(jdepth).astype(np.float32))
        assert (tdepth > 0).float().mean() > 0.9
        np.testing.assert_array_equal(tpose.numpy(), np.eye(4))
        np.testing.assert_array_equal(np.asarray(jpose), np.eye(4))


@pytest.mark.parametrize("sensor", ["depth", "monocular"])
def test_live_slam_runs(sensor, camera, monkeypatch):
    asked = []
    map_fn = tbackend.BackEnd.map

    def counted(self, window, prune=False, iters=1, frames_to_optimize=None):
        if not prune:
            asked.append((self.initialized, len(window), iters,
                          frames_to_optimize))
        return map_fn(self, window, prune, iters, frames_to_optimize)

    monkeypatch.setattr(tbackend.BackEnd, "map", counted)
    cfg = live_config(sensor)
    assert "Calibration" not in cfg["Dataset"]
    assert cfg["Results"]["use_gui"] is True
    cfg["Results"]["use_gui"] = False       # live mode turns it on
    slam = truntime.SLAM(cfg, device="cpu")
    assert slam.live_mode and slam.backend.live_mode and slam.use_gui
    assert (slam.intr.fx, slam.intr.fy, slam.intr.cx, slam.intr.cy,
            slam.intr.width, slam.intr.height) == sim.intrinsics()
    slam.dataset.num_imgs = N_FRAMES     # a live stream reports 999999
    res = slam.run()
    assert res["n_frames"] == N_FRAMES
    assert slam.gui_port > 0 and not slam.gui_thread.is_alive()
    assert slam.gui_params.error is None
    fe = slam.frontend
    assert fe.kf_indices == list(range(N_FRAMES))
    for f in fe.cameras.values():
        assert torch.isfinite(f.T).all()
    if sensor == "monocular":
        # the window filled at the third keyframe: the initial BA, 50
        # iterations in live mode (300 otherwise), over all but one view
        assert (False, 3, 50, 2) in asked, asked
        assert slam.backend.initialized
    else:
        assert all(initialized for initialized, *_ in asked), asked


def test_live_config_with_calibration_matches_jax(camera):
    cfg = live_config("depth")
    cfg["Dataset"]["Calibration"] = calibration()
    jslam = JSLAM(copy.deepcopy(cfg))
    tslam = truntime.SLAM(copy.deepcopy(cfg), device="cpu")
    assert tslam.use_gui == jslam.use_gui is True
    assert tslam.live_mode == jslam.live_mode is True
    assert tslam.backend.live_mode == jslam.backend.live_mode is True
    assert tslam.intr == truntime.intrinsics_from_config(cfg)
    assert (jslam.intr.fx, jslam.intr.width) == (tslam.intr.fx,
                                                  tslam.intr.width)
    # the shipped config, without a Calibration: the JAX package fails
    # before its first frame, the port takes the camera's
    bare = live_config("depth")
    with pytest.raises(KeyError, match="Calibration"):
        JSLAM(copy.deepcopy(bare))
    assert truntime.SLAM(bare, device="cpu").intr == tslam.intr
