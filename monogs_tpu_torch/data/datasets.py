"""Dataset loading from a config (counterpart of
``monogs_tpu/data/datasets.py::load_dataset``).

The synthetic branch builds the port's ``SyntheticDataset`` on the device.
The file-backed datasets (TUM, Replica, EuRoC) and the RealSense camera
arrive with the data-loader slice and raise.
"""

from __future__ import annotations

from ..render.camera import Intrinsics
from .synthetic import SyntheticDataset

_LOADER_SLICE = ("tum", "replica", "euroc", "realsense")


def intrinsics_from_calibration(calib) -> Intrinsics:
    return Intrinsics(
        fx=float(calib["fx"]), fy=float(calib["fy"]),
        cx=float(calib["cx"]), cy=float(calib["cy"]),
        width=int(calib["width"]), height=int(calib["height"]),
    )


def load_dataset(config, device="cuda"):
    """The dataset ``config["Dataset"]`` names, on ``device``."""
    t = config["Dataset"]["type"]
    if t in _LOADER_SLICE:
        raise NotImplementedError(
            f"Dataset.type {t!r} arrives with the data-loader slice; the "
            "port loads 'synthetic' only")
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
