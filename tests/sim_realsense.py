"""A simulated RealSense camera: a stand-in for the ``pyrealsense2``
module, for live mode (``Dataset.type: realsense``) where there is no
camera and no pyrealsense2.

``module(frames)`` builds a module object with the part of pyrealsense2's
API that both packages' ``RealsenseDataset`` call: ``pipeline`` (start,
wait_for_frames, stop), ``config`` (enable_stream), ``align`` (process),
the ``stream``, ``format`` and ``option`` enums, a device whose second
sensor takes the fixed-exposure options and whose first depth sensor has
the depth scale, and a colour stream profile whose intrinsics
(``fx, fy, ppx, ppy, width, height, coeffs``) carry nonzero Brown-Conrady
distortion, so that the loader undistorts every frame (the port's
``remap`` kernel on the card). Each pipeline serves the frames from the
first, in order, one a ``wait_for_frames``.

``render_frames`` makes the frames: the stock synthetic sequence
(configs/synthetic/rgbd.yaml: scene seed 0, 8192 Gaussians, its orbit)
rendered by the port at 640x360 (``k_fine`` 128: a frame takes seconds
on one CPU thread), the size the loader asks for, through
the camera's distortion (each raw pixel samples a render widened to hold
its undistorted point; depth at the nearest point), as BGR uint8 colour
and uint16 depth in units of ``DEPTH_SCALE`` metres, aligned to colour.

It enters ``sys.modules`` only where a test or a chip_smoke.py phase puts
it there (``installed``); nothing in either package imports it. The real
camera's path (USB frames, its own alignment and depth units) is not
exercised.
"""

from __future__ import annotations

import contextlib
import math
import sys
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SEQUENCE = ROOT / "configs" / "synthetic" / "rgbd.yaml"

WIDTH, HEIGHT = 640, 360          # what RealsenseDataset asks for
FX = FY = 460.0                   # about 70 degrees across, a D435's colour
CX, CY = 320.5, 180.25
COEFFS = (0.02, -0.04, 0.001, -0.0005, 0.0)   # k1, k2, p1, p2, k3
DEPTH_SCALE = 0.001               # metres a unit of the 16-bit depth


def intrinsics():
    """(fx, fy, cx, cy, width, height) of the colour stream."""
    return FX, FY, CX, CY, WIDTH, HEIGHT


def render_frames(n_frames, device="cpu", motion="orbit"):
    """The first ``n_frames`` of the stock synthetic sequence as the
    camera delivers them: ([H, W, 3] BGR uint8, [H, W] uint16) arrays, and
    the true world-to-camera poses [4, 4] float64. ``motion`` "tum_like"
    moves along the orbit at TUM's pace (``tum_like_amps`` over the
    sequence's frames, as ``SyntheticDataset``'s "tum_like" motion)
    instead of its own amplitudes."""
    import torch

    from monogs_tpu_torch.data.layouts import raw_maps
    from monogs_tpu_torch.data.synthetic import (
        make_synthetic_scene, orbit_pose, tum_like_amps,
    )
    from monogs_tpu_torch.render import Intrinsics, RenderConfig, render
    from monogs_tpu_torch.slam.config import load_config

    syn = load_config(str(SEQUENCE))["Dataset"]["synthetic"]
    amps = ((syn["trans_amp"], syn["rot_amp"]) if motion == "orbit"
            else tum_like_amps(syn["n_frames"]))
    dev = torch.device(device)
    scene = make_synthetic_scene(
        torch.Generator(device=dev).manual_seed(syn["seed"]),
        n=syn["n_gauss"])
    K = np.array([[FX, 0.0, CX], [0.0, FY, CY], [0.0, 0.0, 1.0]])
    mx, my = raw_maps(K, np.array(COEFFS), np.eye(3), K, (WIDTH, HEIGHT), 0)
    margin = 2 + math.ceil(max(0.0, -float(mx.min()),
                               float(mx.max()) - WIDTH + 1,
                               -float(my.min()), float(my.max()) - HEIGHT + 1))
    mx, my = (torch.from_numpy(m + margin).to(dev) for m in (mx, my))
    wide = Intrinsics(fx=FX, fy=FY, cx=CX + margin, cy=CY + margin,
                      width=WIDTH + 2 * margin, height=HEIGHT + 2 * margin)
    cfg = RenderConfig(backend="pallas_lists", k_fine=128)
    # bilinear weights of the colour, nearest point of the depth
    x0, y0 = mx.floor(), my.floor()
    fx, fy = (mx - x0)[..., None], (my - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    xn, yn = mx.round().long(), my.round().long()
    colors, depths, poses = [], [], []
    for i in range(n_frames):
        T = orbit_pose(i / syn["n_frames"], *amps, device=dev)
        with torch.no_grad():
            out = render(scene, T, wide, cfg)
        img = out.image.clamp(0, 1).permute(1, 2, 0)
        rgb = ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1])
               + fy * ((1 - fx) * img[y0 + 1, x0] + fx * img[y0 + 1, x0 + 1]))
        bgr = (rgb.flip(-1) * 255).round().to(torch.uint8)
        depth = (out.depth[0][yn, xn] / DEPTH_SCALE).round().clamp(0, 65535)
        colors.append(bgr.cpu().numpy())
        depths.append(depth.to(torch.int32).cpu().numpy().astype(np.uint16))
        poses.append(T.double().cpu().numpy())
    return colors, depths, poses


def module(colors, depths):
    """A ``pyrealsense2`` stand-in serving ``colors`` (BGR uint8) and
    ``depths`` (uint16) in order; its ``log`` lists the options set."""
    rs = types.ModuleType("pyrealsense2")
    rs.__doc__ = "simulated RealSense camera (tests/sim_realsense.py)"
    rs.stream = types.SimpleNamespace(color="color", depth="depth")
    rs.format = types.SimpleNamespace(bgr8="bgr8", z16="z16")
    rs.option = types.SimpleNamespace(
        enable_auto_exposure="enable_auto_exposure",
        enable_auto_white_balance="enable_auto_white_balance",
        exposure="exposure")
    rs.log = []

    class Frame:
        def __init__(self, data):
            self._data = data

        def get_data(self):
            return self._data

    class Frameset:
        def __init__(self, i):
            self.i = i

        def get_color_frame(self):
            return Frame(colors[self.i])

        def get_depth_frame(self):
            return Frame(depths[self.i])

    class Intrinsics:
        fx, fy, ppx, ppy, width, height = FX, FY, CX, CY, WIDTH, HEIGHT
        coeffs = list(COEFFS)
        model = "brown_conrady"

    class StreamProfile:
        def get_intrinsics(self):
            return Intrinsics()

    class Sensor:
        def __init__(self, name):
            self.name = name

        def set_option(self, option, value):
            rs.log.append((self.name, option, value))

        def get_depth_scale(self):
            return DEPTH_SCALE

    class Device:
        def query_sensors(self):
            return [Sensor("depth"), Sensor("color")]

        def first_depth_sensor(self):
            return Sensor("depth")

    class Profile:
        def get_device(self):
            return Device()

        def get_stream(self, stream):
            return StreamProfile()

    class Config:
        def __init__(self):
            self.streams = []

        def enable_stream(self, stream, *args):
            self.streams.append((stream, *args))

    class Pipeline:
        def __init__(self):
            self.next = 0

        def start(self, config):
            color = [s for s in config.streams if s[0] == rs.stream.color]
            assert color and color[0][1:3] == (WIDTH, HEIGHT), (
                f"the simulated camera serves {WIDTH}x{HEIGHT} colour, "
                f"asked for {config.streams}")
            return Profile()

        def wait_for_frames(self):
            if self.next >= len(colors):
                raise RuntimeError(f"the simulated camera holds "
                                   f"{len(colors)} frames")
            self.next += 1
            return Frameset(self.next - 1)

        def stop(self):
            pass

    class Align:
        def __init__(self, stream):
            assert stream == rs.stream.color

        def process(self, frameset):     # the frames are aligned already
            return frameset

    rs.pipeline, rs.config, rs.align = Pipeline, Config, Align
    rs.video_stream_profile = lambda profile: profile
    return rs


@contextlib.contextmanager
def installed(rs):
    """``rs`` as ``pyrealsense2`` in ``sys.modules`` inside the block."""
    saved = sys.modules.get("pyrealsense2")
    sys.modules["pyrealsense2"] = rs
    try:
        yield rs
    finally:
        if saved is None:
            sys.modules.pop("pyrealsense2", None)
        else:
            sys.modules["pyrealsense2"] = saved
