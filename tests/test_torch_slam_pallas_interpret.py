"""The "pallas_lists" path through the port's SLAM on the CPU, held
against the JAX package's run of it in interpret mode.

``tests/test_slam_pallas_interpret.py``'s configuration (128x96, k_fine
64, frozen lists, tile subsets) through both packages on the JAX synthetic
dataset's frames, the JAX draws replayed: the port keeps its backend on
the CPU and runs the kernels' plain versions, the JAX package interprets
its Pallas kernels. Both must complete the wiring contract of the JAX
test (keyframes, a populated map, finite poses, ATE under 5 cm) and take
the same keyframes. Their poses are not held together: the JAX package's
Pallas kernels sum in three bf16 passes (1.8e-3 of a column maximum
against float64, ROADMAP Queue 3), a difference that 60 init BA
iterations grow to millimetres (rounding grows so through BA,
test_torch_slam.py); on the CPU the frames parted by up to 8.9 mm, where
the port parted from its own run on the depth moved by 1e-6 m by 2.1 mm."""

import copy
import os

import numpy as np
import pytest

from monogs_tpu.data.datasets import load_dataset as jload_dataset
from monogs_tpu.slam.config import load_config as jload_config
from monogs_tpu.slam.runtime import SLAM as JSLAM
from monogs_tpu_torch.eval.ate import evaluate_ate
from tests.test_torch_slam import NumpyDataset, port_slam
from tests.torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def interpret_config():
    cfg = jload_config(os.path.join(REPO, "configs/synthetic/rgbd.yaml"))
    cfg = copy.deepcopy(cfg)
    cfg["Dataset"]["sensor_type"] = "depth"
    cfg["Dataset"]["Calibration"].update(
        {"width": 128, "height": 96, "fx": 128.0, "fy": 128.0,
         "cx": 63.5, "cy": 47.5})
    cfg["Dataset"]["synthetic"] = {
        "n_frames": 6, "n_gauss": 2000, "seed": 0,
        "trans_amp": 0.008, "rot_amp": 0.003,
        "pan": [0.07, 0.0, 0.015, 0.0, 0.08, 0.0]}
    cfg["Dataset"]["pcd_downsample"] = 8
    cfg["Dataset"]["pcd_downsample_init"] = 4
    cfg["Dataset"]["single_thread"] = True
    tr = cfg["Training"]
    tr["kf_translation"] = 0.01
    tr["kf_min_translation"] = 0.005
    tr["kf_interval"] = 2
    tr["init_itr_num"] = 60
    tr["mapping_itr_num"] = 15
    tr["window_size"] = 4
    tr["pose_window"] = 2
    rgn = tr["RGN"]
    rgn["first_order"]["max_iter"] = 6
    rgn["second_order"]["max_iter"] = 2
    rgn["second_order"]["stack_dim"] = 4
    rgn["bin_margin"] = 8
    rgn["first_order"]["tile_frac"] = 0.5
    rgn["second_order"]["tile_frac"] = 0.5
    rgn["rebin_so_iters"] = 1
    cfg["Renderer"] = {
        "map_capacity": 8192, "insert_cap": 2048,
        "macro_tiles": 4, "k_macro": 512, "k_fine": 64,
        "backend": "pallas_lists", "pallas_interpret": True}
    cfg["Results"]["save_results"] = False
    return cfg


def kf_ate(fe):
    gt = [np.linalg.inv(np.asarray(fe.cameras[i].T_gt)) for i in fe.kf_indices]
    est = [np.linalg.inv(np.asarray(fe.cameras[i].T)) for i in fe.kf_indices]
    return evaluate_ate(gt, est, monocular=False)[0]


@pytest.mark.slow
def test_slam_pallas_lists_against_interpret():
    cfg = interpret_config()
    jcfg = copy.deepcopy(cfg)
    jcfg["Training"]["monocular"] = False
    frames = NumpyDataset(jload_dataset(jcfg))
    a = JSLAM(jcfg, dataset=frames)
    assert a.track_render_cfg.backend == "pallas_lists"
    a.run()
    b = port_slam(cfg, dataset=frames, replay=True)
    assert b.track_render_cfg.backend == "pallas_lists"
    b.run()
    for slam in (a, b):
        fe = slam.frontend
        assert len(fe.cameras) == 6
        assert len(fe.kf_indices) >= 2
        assert int(slam.backend.gaussians.n_active) > 200
        for i in range(6):
            assert np.all(np.isfinite(np.asarray(fe.cameras[i].T)))
        assert kf_ate(fe) < 0.05
    assert b.frontend.kf_indices == a.frontend.kf_indices
