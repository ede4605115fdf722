"""Dataset parsers and loaders (counterpart of
``monogs_tpu/data/datasets.py``): TUM, Replica, EuRoC (stereo depth from
semi-global matching), RealSense, and the synthetic sequence.

The parsers are the JAX package's numpy code: the same directory layouts,
TUM's timestamp association (``max_dt`` 0.08) and 32 fps thinning, its
(x, y, z, w) quaternions, EuRoC's IMU-to-cam0 extrinsic and (w, x, y, z)
quaternions, and stored poses that are the world-to-camera inverses of the
trajectory files. ``dataset[i]`` returns ``(image [3, H, W] float32,
depth [H, W] float32 or None, T_cw [4, 4] float32)`` on the dataset's
device, with the JAX package's values: the image and depth are divided in
float64 and then cast, as numpy does there.

Nothing here imports OpenCV or Pillow on the card's path: PNG is decoded
by ``png.py``, JPEG by nvJPEG (``jpeg.py``; on the CPU by cv2, the JAX
package's decoder), undistortion and rectification are ``undistort.py``'s
maps and remap kernel, and EuRoC's depth is ``stereo.py``'s SGBM kernel.
Frames are decoded ahead of use by ``native_loader.make_loader``. Depth is
used unwarped, as in the JAX package.
"""

from __future__ import annotations

import csv
import glob
import os

import numpy as np
import torch

from .. import resolve_device
from ..render.camera import Intrinsics, focal2fov
from .native_loader import make_loader
from .stereo import sgbm
from .synthetic import SyntheticDataset
from .undistort import (
    check_maps, init_undistort_rectify_map, remap, remap_pair,
)


def quaternion_matrix(q_wxyz):
    """4x4 homogeneous rotation from (w, x, y, z)."""
    w, x, y, z = q_wxyz
    n = w * w + x * x + y * y + z * z
    if n < 1e-12:
        return np.eye(4)
    s = 2.0 / n
    T = np.eye(4)
    T[:3, :3] = np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
            [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
            [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
        ]
    )
    return T


class ReplicaParser:
    def __init__(self, input_folder):
        self.input_folder = input_folder
        self.color_paths = sorted(glob.glob(f"{input_folder}/results/frame*.jpg"))
        self.depth_paths = sorted(glob.glob(f"{input_folder}/results/depth*.png"))
        self.n_img = len(self.color_paths)
        self.poses = []
        with open(f"{input_folder}/traj.txt", "r") as f:
            lines = f.readlines()
        for i in range(self.n_img):
            pose = np.array(list(map(float, lines[i].split()))).reshape(4, 4)
            self.poses.append(np.linalg.inv(pose))


class TUMParser:
    """Association of rgb.txt, depth.txt and groundtruth.txt."""

    def __init__(self, input_folder, frame_rate=32):
        self.input_folder = input_folder
        self.load_poses(input_folder, frame_rate)
        self.n_img = len(self.color_paths)

    @staticmethod
    def parse_list(filepath, skiprows=0):
        return np.loadtxt(filepath, delimiter=" ", dtype=np.str_, skiprows=skiprows)

    @staticmethod
    def associate_frames(tstamp_image, tstamp_depth, tstamp_pose, max_dt=0.08):
        associations = []
        for i, t in enumerate(tstamp_image):
            j = np.argmin(np.abs(tstamp_depth - t))
            k = np.argmin(np.abs(tstamp_pose - t))
            if (np.abs(tstamp_depth[j] - t) < max_dt) and (
                np.abs(tstamp_pose[k] - t) < max_dt
            ):
                associations.append((i, j, k))
        return associations

    def load_poses(self, datapath, frame_rate=-1):
        if os.path.isfile(os.path.join(datapath, "groundtruth.txt")):
            pose_list = os.path.join(datapath, "groundtruth.txt")
        else:
            pose_list = os.path.join(datapath, "pose.txt")
        image_data = self.parse_list(os.path.join(datapath, "rgb.txt"))
        depth_data = self.parse_list(os.path.join(datapath, "depth.txt"))
        pose_data = self.parse_list(pose_list, skiprows=1)
        pose_vecs = pose_data[:, 0:].astype(np.float64)

        tstamp_image = image_data[:, 0].astype(np.float64)
        tstamp_depth = depth_data[:, 0].astype(np.float64)
        tstamp_pose = pose_data[:, 0].astype(np.float64)
        associations = self.associate_frames(tstamp_image, tstamp_depth, tstamp_pose)

        indices = [0]
        for i in range(1, len(associations)):
            t0 = tstamp_image[associations[indices[-1]][0]]
            t1 = tstamp_image[associations[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indices += [i]

        self.color_paths, self.poses, self.depth_paths = [], [], []
        for ix in indices:
            (i, j, k) = associations[ix]
            self.color_paths += [os.path.join(datapath, str(image_data[i, 1]))]
            self.depth_paths += [os.path.join(datapath, str(depth_data[j, 1]))]
            quat = pose_vecs[k][4:]  # (x, y, z, w)
            trans = pose_vecs[k][1:4]
            T = quaternion_matrix(np.roll(quat, 1))
            T[:3, 3] = trans
            self.poses += [np.linalg.inv(T)]


class EuRoCParser:
    """Stereo pairs and IMU-frame ground truth."""

    T_i_c0 = np.array(
        [
            [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
            [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
            [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )

    def __init__(self, input_folder, start_idx=0):
        self.input_folder = input_folder
        self.color_paths = sorted(glob.glob(f"{input_folder}/mav0/cam0/data/*.png"))
        self.color_paths_r = sorted(glob.glob(f"{input_folder}/mav0/cam1/data/*.png"))
        assert len(self.color_paths) == len(self.color_paths_r)
        self.color_paths = self.color_paths[start_idx:]
        self.color_paths_r = self.color_paths_r[start_idx:]
        self.n_img = len(self.color_paths)
        self.load_poses(
            f"{input_folder}/mav0/state_groundtruth_estimate0/data.csv"
        )

    def load_poses(self, path):
        self.poses = []
        with open(path) as f:
            reader = csv.reader(f)
            next(reader)
            data = np.array([list(map(float, row)) for row in reader])
        pose_ts = data[:, 0]
        for i in range(self.n_img):
            color_ts = float(os.path.basename(self.color_paths[i]).split(".")[0])
            k = int(np.argmin(np.abs(pose_ts - color_ts)))
            trans = data[k, 1:4]
            # EuRoC stores q_RS as (w, x, y, z): no roll (the original
            # MonoGS rolled it as for TUM's (x, y, z, w), which scrambles
            # every ground-truth rotation)
            quat = data[k, 4:8]
            T_w_i = quaternion_matrix(quat)
            T_w_i[:3, 3] = trans
            T_w_c = T_w_i @ self.T_i_c0
            self.poses += [np.linalg.inv(T_w_c)]


def camera_matrix(c):
    """3x3 K of a calibration block (fx, fy, cx, cy)."""
    return np.array([[c["fx"], 0.0, c["cx"]], [0.0, c["fy"], c["cy"]],
                     [0.0, 0.0, 1.0]])


def dist_coeffs(c):
    """(k1, k2, p1, p2, k3) of a calibration block."""
    return np.array([c["k1"], c["k2"], c["p1"], c["p2"], c["k3"]])


def _to_image(rgb):
    """[H, W, 3] uint8 -> [3, H, W] float32 in [0, 1], divided in float64
    as the JAX package's numpy does."""
    img = torch.clamp(rgb.to(torch.float64) / 255.0, 0.0, 1.0)
    return img.to(torch.float32).permute(2, 0, 1).contiguous()


class BaseDataset:
    def __init__(self, config, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.num_imgs = 999999

    def __len__(self):
        return self.num_imgs

    def _set_poses(self, poses):
        """Keep the parser's poses, and all of them on the device at once:
        ``_pose`` then indexes that table, so ``dataset[i]`` never copies
        from host memory behind the kernels it has just launched (such a
        copy waits for them)."""
        self.poses = poses
        self._pose_table = torch.as_tensor(
            np.asarray(poses, np.float32).reshape(-1, 4, 4),
            device=self.device)

    def _pose(self, idx):
        return self._pose_table[idx].clone()


class MonocularDataset(BaseDataset):
    """Pinhole camera, optional undistortion, optional depth."""

    def __init__(self, config, device="cuda"):
        super().__init__(config, device)
        calibration = config["Dataset"]["Calibration"]
        self.fx = calibration["fx"]
        self.fy = calibration["fy"]
        self.cx = calibration["cx"]
        self.cy = calibration["cy"]
        self.width = calibration["width"]
        self.height = calibration["height"]
        self.fovx = focal2fov(self.fx, self.width)
        self.fovy = focal2fov(self.fy, self.height)
        self.K = camera_matrix(calibration)
        self.disorted = calibration["distorted"]
        self.dist_coeffs = dist_coeffs(calibration)
        if self.disorted:
            self.map1x, self.map1y = (
                torch.from_numpy(m).to(self.device)
                for m in init_undistort_rectify_map(
                    self.K, self.dist_coeffs, np.eye(3), self.K,
                    (self.width, self.height)))
            self.maps = check_maps(self.map1x, self.map1y)
        self.has_depth = "depth_scale" in calibration
        self.depth_scale = calibration.get("depth_scale")

    def _setup_loader(self):
        self._loader = make_loader(
            self.color_paths, self.depth_paths if self.has_depth else None,
            device=self.device)

    def __getitem__(self, idx):
        rgb, depth_raw = self._loader.get(idx)
        if self.disorted:
            rgb = remap(rgb, self.maps)
        depth = None
        if self.has_depth and depth_raw is not None:
            depth = (depth_raw.to(torch.float64) / self.depth_scale).to(
                torch.float32)
        return _to_image(rgb), depth, self._pose(idx)


class StereoDataset(BaseDataset):
    """Rectified stereo; depth from SGBM disparities."""

    def __init__(self, config, device="cuda"):
        super().__init__(config, device)
        calibration = config["Dataset"]["Calibration"]
        self.width = calibration["width"]
        self.height = calibration["height"]
        cam0raw = calibration["cam0"]["raw"]
        cam0opt = calibration["cam0"]["opt"]
        cam1raw = calibration["cam1"]["raw"]
        cam1opt = calibration["cam1"]["opt"]
        self.fx, self.fy = cam0opt["fx"], cam0opt["fy"]
        self.cx, self.cy = cam0opt["cx"], cam0opt["cy"]
        self.fovx = focal2fov(self.fx, self.width)
        self.fovy = focal2fov(self.fy, self.height)
        self.K = camera_matrix(cam0opt)
        size = (self.width, self.height)
        maps = (
            init_undistort_rectify_map(
                camera_matrix(cam0raw), dist_coeffs(cam0raw),
                np.array(calibration["cam0"]["R"]["data"]).reshape(3, 3),
                self.K, size)
            + init_undistort_rectify_map(
                camera_matrix(cam1raw), dist_coeffs(cam1raw),
                np.array(calibration["cam1"]["R"]["data"]).reshape(3, 3),
                camera_matrix(cam1opt), size))
        (self.map1x, self.map1y, self.map1x_r, self.map1y_r) = (
            torch.from_numpy(m).to(self.device) for m in maps)
        self.maps = check_maps(self.map1x, self.map1y)
        self.maps_r = check_maps(self.map1x_r, self.map1y_r)
        self.disorted = calibration["distorted"]
        self.has_depth = True
        # following ORB-SLAM2's EuRoC config: baseline * fx
        self.bf = 47.90639384423901

    def _setup_loader(self):
        self._loader = make_loader(self.color_paths, device=self.device)
        self._loader_r = make_loader(self.color_paths_r, device=self.device)

    def __getitem__(self, idx):
        image, _ = self._loader.get(idx)
        image_r, _ = self._loader_r.get(idx)
        if self.disorted:
            image, image_r = remap_pair(image, self.maps, image_r,
                                        self.maps_r)
        disparity = sgbm(image, image_r).to(torch.float64) / 16.0
        disparity = torch.where(disparity == 0,
                                torch.full_like(disparity, 1e10), disparity)
        depth = self.bf / disparity
        depth = torch.where(depth < 0, torch.zeros_like(depth), depth)
        rgb = image[..., None].expand(-1, -1, 3)
        return _to_image(rgb), depth.to(torch.float32), self._pose(idx)


class TUMDataset(MonocularDataset):
    def __init__(self, config, device="cuda"):
        super().__init__(config, device)
        parser = TUMParser(config["Dataset"]["dataset_path"])
        self.num_imgs = parser.n_img
        self.color_paths = parser.color_paths
        self.depth_paths = parser.depth_paths
        self._set_poses(parser.poses)
        self._setup_loader()


class ReplicaDataset(MonocularDataset):
    def __init__(self, config, device="cuda"):
        super().__init__(config, device)
        parser = ReplicaParser(config["Dataset"]["dataset_path"])
        self.num_imgs = parser.n_img
        self.color_paths = parser.color_paths
        self.depth_paths = parser.depth_paths
        self._set_poses(parser.poses)
        self._setup_loader()


class EurocDataset(StereoDataset):
    def __init__(self, config, device="cuda"):
        super().__init__(config, device)
        parser = EuRoCParser(config["Dataset"]["dataset_path"], start_idx=0)
        self.num_imgs = parser.n_img
        self.color_paths = parser.color_paths
        self.color_paths_r = parser.color_paths_r
        self._set_poses(parser.poses)
        self._setup_loader()


class RealsenseDataset(BaseDataset):
    """Live aligned colour (and depth) from a RealSense camera at fixed
    exposure, undistorted by the camera's own coefficients; the pose is
    the identity. Needs pyrealsense2 and a connected camera. ``len`` is
    999999 (a stream has no end): a run of a fixed length sets
    ``num_imgs``."""

    def __init__(self, config, device="cuda"):
        super().__init__(config, device)
        try:
            import pyrealsense2 as rs
        except ImportError as e:
            raise RuntimeError(
                "RealsenseDataset requires pyrealsense2 (not installed in "
                "this environment)"
            ) from e
        self.rs = rs
        self.pipeline = rs.pipeline()
        self.h, self.w = 360, 640
        self.rs_config = rs.config()
        self.rs_config.enable_stream(
            rs.stream.color, self.w, self.h, rs.format.bgr8, 30
        )
        self.rs_config.enable_stream(rs.stream.depth)
        self.profile = self.pipeline.start(self.rs_config)
        self.align = rs.align(rs.stream.color)
        rgb_sensor = self.profile.get_device().query_sensors()[1]
        rgb_sensor.set_option(rs.option.enable_auto_exposure, False)
        rgb_sensor.set_option(rs.option.enable_auto_white_balance, False)
        rgb_sensor.set_option(rs.option.exposure, 100)
        rgb_profile = rs.video_stream_profile(
            self.profile.get_stream(rs.stream.color)
        )
        intr = rgb_profile.get_intrinsics()
        self.fx, self.fy = intr.fx, intr.fy
        self.cx, self.cy = intr.ppx, intr.ppy
        self.width, self.height = intr.width, intr.height
        self.fovx = focal2fov(self.fx, self.width)
        self.fovy = focal2fov(self.fy, self.height)
        self.K = np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]]
        )
        self.disorted = True
        self.dist_coeffs = np.asarray(intr.coeffs)
        self.map1x, self.map1y = (
            torch.from_numpy(m).to(self.device)
            for m in init_undistort_rectify_map(
                self.K, self.dist_coeffs, np.eye(3), self.K,
                (self.w, self.h)))
        self.maps = check_maps(self.map1x, self.map1y)
        self.has_depth = config["Dataset"]["sensor_type"] == "depth"
        if self.has_depth:
            self.depth_scale = (
                self.profile.get_device().first_depth_sensor().get_depth_scale()
            )

    def __getitem__(self, idx):
        frameset = self.pipeline.wait_for_frames()
        aligned = self.align.process(frameset)
        bgr = np.asanyarray(aligned.get_color_frame().get_data())
        rgb = torch.from_numpy(np.ascontiguousarray(bgr[..., ::-1])).to(
            self.device)
        if self.disorted:
            rgb = remap(rgb, self.maps)
        depth = None
        if self.has_depth:
            raw = np.array(aligned.get_depth_frame().get_data())
            depth = torch.as_tensor(raw * self.depth_scale,
                                    device=self.device)
            depth = torch.where(depth < 0, torch.zeros_like(depth), depth)
            depth = depth.to(torch.float32)
        return _to_image(rgb), depth, torch.eye(4, device=self.device)


def intrinsics_from_calibration(calib) -> Intrinsics:
    return Intrinsics(
        fx=float(calib["fx"]), fy=float(calib["fy"]),
        cx=float(calib["cx"]), cy=float(calib["cy"]),
        width=int(calib["width"]), height=int(calib["height"]),
    )


def load_dataset(config, device="cuda"):
    """The dataset ``config["Dataset"]`` names, on ``device``."""
    t = config["Dataset"]["type"]
    if t == "tum":
        return TUMDataset(config, device)
    if t == "replica":
        return ReplicaDataset(config, device)
    if t == "euroc":
        return EurocDataset(config, device)
    if t == "realsense":
        return RealsenseDataset(config, device)
    if t != "synthetic":
        raise ValueError("Unknown dataset type")
    syn = config["Dataset"].get("synthetic", {})
    return SyntheticDataset(
        intrinsics_from_calibration(config["Dataset"]["Calibration"]),
        n_frames=syn.get("n_frames", 64),
        n_gauss=syn.get("n_gauss", 8192),
        seed=syn.get("seed", 0),
        sensor_type=config["Dataset"]["sensor_type"],
        trans_amp=syn.get("trans_amp", 0.25),
        rot_amp=syn.get("rot_amp", 0.06),
        pan=syn.get("pan"),
        # "tum_like" replaces the amplitudes (synthetic.tum_like_amps)
        motion=syn.get("motion", "orbit"),
        device=device,
    )
