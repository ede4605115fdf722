"""Full SLAM of the port from files: the loader feeds SLAM exactly what the
JAX package's loader reads.

The first frames of the port's synthetic sequence at
``test_slam_e2e.tiny_config``'s widths (160x128; its scene, motion and
calibration, rendered as ``SyntheticDataset`` renders them) are written as a TUM
RGB-D layout with cv2 (8-bit RGB PNG, 16-bit depth PNG at depth_scale
5000, ``rgb.txt``, ``depth.txt``, ``groundtruth.txt``, frames 1/30 s
apart). The port's ``SLAM(config).run()`` then runs twice on the CPU
with the same seeded draws: once with ``dataset=None``, so that it loads
the files through ``load_dataset`` (``TUMDataset``), and once with the
JAX package's ``TUMDataset`` frames of the same files handed in as
``dataset=``. The two runs must take the same keyframes and give every
frame the same pose, bit for bit. RGB-D and mono on the first three
frames, at ``test_torch_slam.trimmed_config``'s budgets cut further and
first-order tracking only (the runs are compared with each other, not
with the ground truth, and a second-order iteration costs seconds a
frame on the CPU).
"""

import copy

import numpy as np
import pytest
import torch

from monogs_tpu.data.datasets import TUMDataset as JTUMDataset
from monogs_tpu_torch.data import datasets as tds
from monogs_tpu_torch.data import layouts
from monogs_tpu_torch.data.synthetic import make_synthetic_scene, orbit_pose
from monogs_tpu_torch.render import Intrinsics, RenderConfig, render
from monogs_tpu_torch.slam import runtime as truntime
from tests.test_torch_slam import NumpyDataset, trimmed_config
from tests.torch_one_thread import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

DEPTH_SCALE = 5000.0


def cv_write(path, img):
    if img.ndim == 3:
        img = img[..., ::-1]
    assert cv2.imwrite(str(path), img)


def tum_files_config(root, sensor, n_frames):
    """trimmed_config as a TUM dataset at ``root``, its first
    ``n_frames`` synthetic frames written there."""
    cfg = trimmed_config(sensor)
    tr = cfg["Training"]
    tr["init_itr_num"] = 2
    tr["mapping_itr_num"] = 1
    tr["RGN"]["first_order"]["max_iter"] = 3
    tr["RGN"]["second_order"]["max_iter"] = 0
    calib = cfg["Dataset"]["Calibration"]
    syn = cfg["Dataset"].pop("synthetic")
    intr = Intrinsics(fx=calib["fx"], fy=calib["fy"], cx=calib["cx"],
                      cy=calib["cy"], width=calib["width"],
                      height=calib["height"])
    scene = make_synthetic_scene(
        torch.Generator().manual_seed(syn["seed"]), n=syn["n_gauss"])
    frames = []
    for i in range(n_frames):
        pose = orbit_pose(i / syn["n_frames"], syn["trans_amp"],
                          syn["rot_amp"], pan=syn["pan"], device="cpu")
        out = render(scene, pose, intr, RenderConfig())
        frames.append((out.image.clamp(0, 1), out.depth[0], pose))
    colors = [(img.permute(1, 2, 0) * 255).round().to(torch.uint8).numpy()
              for img, _, _ in frames]
    layouts.write_tum(str(root), colors, [d.numpy() for _, d, _ in frames],
                      [p.numpy() for _, _, p in frames], DEPTH_SCALE,
                      cv_write)
    cfg["Dataset"].update(type="tum", dataset_path=str(root))
    calib.update(depth_scale=DEPTH_SCALE, distorted=False)
    return cfg, colors, frames


def run_both(cfg):
    from_files = truntime.SLAM(copy.deepcopy(cfg), device="cpu")
    assert isinstance(from_files.dataset, tds.TUMDataset)
    from_files.run()
    jcfg = copy.deepcopy(cfg)
    jcfg["Training"]["monocular"] = cfg["Dataset"]["sensor_type"] == "monocular"
    frames = NumpyDataset(JTUMDataset(jcfg))
    handed = truntime.SLAM(copy.deepcopy(cfg), dataset=frames, device="cpu")
    handed.run()
    return from_files, handed


def assert_same_run(a, b, n_frames):
    assert a.frontend.kf_indices == b.frontend.kf_indices
    assert len(a.frontend.cameras) == len(b.frontend.cameras) == n_frames
    for i, cam in a.frontend.cameras.items():
        other = b.frontend.cameras[i]
        assert torch.equal(cam.T, other.T), i
        assert torch.equal(cam.T_gt, other.T_gt), i
    assert int(a.backend.gaussians.n_active) == int(
        b.backend.gaussians.n_active)


@pytest.fixture(scope="module")
def rgbd_files(tmp_path_factory):
    return tum_files_config(tmp_path_factory.mktemp("tum_rgbd"), "depth", 3)


def test_tum_files_give_back_the_frames(rgbd_files):
    """What the port's loader reads from the files is the synthetic
    sequence: the colour as written, the depth within its 1/5000 m
    quantisation, the ground truth within 1e-6."""
    cfg, colors, frames = rgbd_files
    ds = tds.load_dataset(cfg, device="cpu")
    assert isinstance(ds, tds.TUMDataset) and len(ds) == 3
    for i, (img, depth, pose) in enumerate(frames):
        timg, tdepth, tpose = ds[i]
        np.testing.assert_array_equal(
            timg.numpy(), (torch.from_numpy(colors[i]).double() / 255)
            .float().permute(2, 0, 1).numpy())
        assert float((tdepth - depth).abs().max()) <= 0.5 / DEPTH_SCALE + 1e-6
        np.testing.assert_allclose(tpose.numpy(), pose.numpy(), atol=1e-6)


def test_slam_from_tum_files_matches_the_jax_loader(rgbd_files):
    a, b = run_both(rgbd_files[0])
    assert_same_run(a, b, 3)


def test_slam_from_tum_mono_files_matches_the_jax_loader(tmp_path):
    cfg = tum_files_config(tmp_path, "monocular", 3)[0]
    a, b = run_both(cfg)
    assert_same_run(a, b, 3)
