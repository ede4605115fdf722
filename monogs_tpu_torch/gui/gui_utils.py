"""GUI message protocol: GaussianPacket / Packet_vis2main.

Counterpart of ``monogs_tpu/gui/gui_utils.py``, field for field, so that
the frontend sends the same information: map snapshots, the current
tracked frame, the window's keyframe poses and graph, the ground-truth
images, the trajectories, and the pause back-channel.

A JAX map is immutable, so the JAX package's packet holds a reference to
it. A map of the port is a set of device tensors that any later change
could write in place, so a packet holds ``snapshot(m)``: a copy taken on
the card when the packet is sent, which the GUI thread alone reads.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class CameraMsg:
    """A camera's pose only: ``T`` (world to camera, [4, 4]) and its
    ground truth."""

    uid: int
    T: Any
    T_gt: Any = None


@dataclass
class GaussianPacket:
    gaussians: Any = None            # snapshot of the GaussianMap (or None)
    current_frame: Optional[CameraMsg] = None
    keyframes: list = field(default_factory=list)
    kf_window: dict = field(default_factory=dict)
    gtcolor: Any = None              # [3, H, W]
    gtdepth: Any = None              # [H, W]
    # estimated and ground-truth camera centres [n, 3] (numpy), the 3D
    # map view's polylines
    trajectory: Any = None
    trajectory_gt: Any = None
    finish: bool = False


@dataclass
class Packet_vis2main:
    flag_pause: bool = False


@dataclass
class ParamsGUI:
    q_main2vis: Any = None
    q_vis2main: Any = None
    gaussians: Any = None
    intr: Any = None
    render_cfg: Any = None
    port: int = 8765      # 0 binds a free port
    save_dir: Any = None  # screenshots land here (cwd if None)
    device: Any = "cuda"  # where the views render and JPEGs encode
    # set by the GUI thread: the port it bound, or the error that stopped
    # it; ``ready`` is set once either is known
    bound_port: Optional[int] = None
    error: Optional[BaseException] = None
    ready: Any = field(default_factory=threading.Event)


def snapshot(m):
    """A copy of the map ``m`` (a ``GaussianMap``) made on its device."""
    from ..models.gaussian_map import GaussianMap, ParamLeaves

    return GaussianMap(*(
        ParamLeaves(*(y.clone() for y in x)) if isinstance(x, ParamLeaves)
        else x.clone() for x in m))
