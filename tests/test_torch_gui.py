"""The port's web GUI on the CPU, a mirror of ``tests/test_gui.py``: serve
a live map over HTTP, probe every endpoint, the pause back-channel and the
finish shutdown; and the map snapshot a packet carries.

Each server binds a free port (port 0): two checkouts, or test_gui.py on
another worker, may serve at the same time. On the CPU the views render through the kernels' plain versions and
encode with cv2 (PPM without it); on the card nvJPEG encodes
(``tests/test_torch_cuda_kernels.py``)."""

import json
import os
import queue
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from monogs_tpu_torch.gui import GaussianPacket, Packet_vis2main, ParamsGUI
from monogs_tpu_torch.gui import slam_gui
from monogs_tpu_torch.gui.gui_utils import CameraMsg, snapshot
from monogs_tpu_torch.models import gaussian_map as gm
from monogs_tpu_torch.render import Intrinsics, RenderConfig
from tests.torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"
PORT = None     # the port the module's server bound


def small_map():
    rng = np.random.default_rng(0)
    leaves = gm.ParamLeaves(
        xyz=torch.tensor(np.concatenate(
            [0.5 * rng.standard_normal((256, 2)), np.full((256, 1), 2.0)],
            axis=-1), dtype=torch.float32),
        sh=torch.tensor(rng.standard_normal((256, 1, 3)) * 0.3,
                        dtype=torch.float32),
        log_scale=torch.full((256, 3), -2.5),
        quat=torch.tensor([[1.0, 0, 0, 0]]).repeat(256, 1),
        opa_logit=torch.full((256, 1), 2.0))
    return gm.insert(gm.new_map(256, sh_degree=0, device=CPU), leaves,
                     torch.tensor(200, dtype=torch.int32), kf_id=0)


@pytest.fixture(scope="module")
def gui(tmp_path_factory):
    global PORT
    intr = Intrinsics(fx=60.0, fy=60.0, cx=15.5, cy=11.5, width=32,
                      height=24)
    cfg = RenderConfig(tile=16, macro_tiles=2, k_macro=128, k_fine=64)
    m = small_map()
    q_m2v, q_v2m = queue.Queue(), queue.Queue()
    save_dir = str(tmp_path_factory.mktemp("gui_shots"))
    params = ParamsGUI(q_main2vis=q_m2v, q_vis2main=q_v2m, gaussians=m,
                       intr=intr, render_cfg=cfg, port=0,
                       save_dir=save_dir, device=CPU)
    t, PORT = slam_gui.start(params)
    q_m2v.put(GaussianPacket(
        gaussians=snapshot(m),
        current_frame=CameraMsg(uid=0, T=torch.eye(4)),
        keyframes=[CameraMsg(uid=0, T=torch.eye(4))],
        kf_window={0: []},
        gtcolor=torch.full((3, 24, 32), 0.5),
        trajectory=np.array([[0, 0, 0], [0.05, 0, 0.1], [0.1, 0.02, 0.2]],
                            np.float32),
        trajectory_gt=np.array([[0, 0, 0], [0.04, 0, 0.1],
                                [0.09, 0.02, 0.2]], np.float32)))
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            if json.loads(_get("/stats", 2))["packets"] >= 1:
                break
        except (urllib.error.URLError, ConnectionError):
            pass
        time.sleep(0.1)
    yield q_m2v, q_v2m, t, save_dir
    q_m2v.put(GaussianPacket(finish=True))
    t.join(timeout=15)
    assert not t.is_alive()


def _get(path, timeout=120):
    with urllib.request.urlopen(f"http://localhost:{PORT}{path}",
                                timeout=timeout) as r:
        return r.read()


def _image(b):
    return b[:2] == b"\xff\xd8" or b[:2] == b"P6"


def test_dashboard_and_stats(gui):
    page = _get("/")
    assert b"monogs-tpu" in page
    stats = json.loads(_get("/stats"))
    assert stats["n_gaussians"] == 200
    assert stats["n_keyframes"] == 1


def test_view_and_input_images(gui):
    view = _get("/view.jpg")
    assert _image(view)
    orbit = _get("/view.jpg?yaw=0.3&dx=0.2")
    assert orbit != view  # the viewpoint moved
    assert len(_get("/input.jpg")) > 100
    assert _image(_get("/depth.jpg"))


def test_pause_unpause_roundtrip(gui):
    q_v2m = gui[1]
    urllib.request.urlopen(urllib.request.Request(
        f"http://localhost:{PORT}/pause", method="POST"), timeout=10)
    pkt = q_v2m.get(timeout=5)
    assert isinstance(pkt, Packet_vis2main) and pkt.flag_pause
    urllib.request.urlopen(urllib.request.Request(
        f"http://localhost:{PORT}/unpause", method="POST"), timeout=10)
    assert not q_v2m.get(timeout=5).flag_pause


def test_map3d_view(gui):
    """The free-orbit 3D map view: valid image bytes, the orbit angle
    moves the render, every mode answers, the scale reaches the render."""
    base = _get("/map3d.jpg?yaw=0&pitch=0.5&mode=rgb&scale=1")
    assert _image(base)
    assert _get("/map3d.jpg?yaw=1.2&pitch=0.2&mode=rgb&scale=1") != base
    for mode in ("depth", "opacity", "ellipsoid"):
        assert len(_get(f"/map3d.jpg?yaw=0&pitch=0.5&mode={mode}&scale=1")
                   ) > 100, mode
    assert _get("/map3d.jpg?yaw=0&pitch=0.5&mode=rgb&scale=0.3") != base


def test_follow_camera_mode(gui):
    orbit = _get("/map3d.jpg?yaw=1.0&pitch=0.5&mode=rgb&scale=1")
    follow = _get("/map3d.jpg?yaw=1.0&pitch=0.5&mode=rgb&scale=1&follow=1")
    assert _image(follow)
    assert follow != orbit


def test_screenshot_saves_files(gui):
    save_dir = gui[3]
    req = urllib.request.Request(
        f"http://localhost:{PORT}/screenshot?yaw=0.3&mode=rgb",
        method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        res = json.loads(r.read())
    assert "saved" in res, res
    paths = [p.strip() for p in res["saved"].split(",")]
    assert len(paths) == 2
    for p in paths:
        assert os.path.commonpath([p, save_dir]) == save_dir
        assert os.path.getsize(p) > 100
        with open(p, "rb") as fh:
            assert _image(fh.read(2))


def test_404(gui):
    with pytest.raises(urllib.error.HTTPError):
        _get("/nope")


def test_packet_snapshot_is_a_copy():
    """A packet's map is a copy: a write to the map it was taken from
    after sending does not reach it."""
    m = small_map()
    snap = snapshot(m)
    assert all(torch.equal(a, b) for a, b in zip(snap.params, m.params))
    m.params.xyz.add_(1.0)
    m.active.zero_()
    assert not torch.equal(snap.params.xyz, m.params.xyz)
    assert int(snap.n_active) == 200


def test_segments_are_clipped_to_the_image():
    img = np.zeros((24, 32, 3), np.uint8)
    slam_gui._draw_segment(img, (-100.0, 12.0), (1e6, 12.0), (255, 0, 0))
    assert (img[12, :, 0] == 255).all() and img[:12].sum() == 0
    slam_gui._draw_segment(img, (-5.0, -5.0), (-1.0, 30.0), (0, 255, 0))
    assert img[..., 1].sum() == 0


# ----------------------------------------------------- the runtime's wiring

def gui_config(port):
    from tests.test_torch_slam import pallas_config

    cfg = pallas_config()
    cfg["Results"]["use_gui"] = True
    cfg["Renderer"]["gui_port"] = port
    return cfg


def test_slam_with_the_gui_tracks_as_without():
    """``Results.use_gui`` runs: the GUI serves on its own thread while the
    frontend sends a packet a tracked frame, it stops at the finish
    packet, and the run's poses equal those of the run without it bit for
    bit (the GUI only reads)."""
    from monogs_tpu_torch.slam import runtime

    runs = {}
    for use_gui in (False, True):
        cfg = gui_config(0)
        cfg["Results"]["use_gui"] = use_gui
        slam = runtime.SLAM(cfg, device=CPU)
        slam.run()
        runs[use_gui] = slam
    with_gui = runs[True]
    assert with_gui.gui_thread is not None
    assert with_gui.gui_port > 0
    assert not with_gui.gui_thread.is_alive()
    assert runs[False].gui_thread is None
    fe = with_gui.frontend
    assert len(fe._traj) == len(fe.cameras) - 1   # every frame after init
    for i, f in runs[False].frontend.cameras.items():
        assert torch.equal(f.T, fe.cameras[i].T), i


def test_gui_pause_reaches_the_backend():
    from monogs_tpu_torch.slam import runtime

    slam = runtime.SLAM(gui_config(0), device=CPU)
    fe = slam.frontend
    assert fe._check_gui_pause() is False
    slam.q_vis2main.put(Packet_vis2main(flag_pause=True))
    assert fe._check_gui_pause() is True
    assert fe._check_gui_pause() is True      # stays paused
    assert slam.backend_queue.get_nowait() == ["pause"]
    slam.q_vis2main.put(Packet_vis2main(flag_pause=False))
    assert fe._check_gui_pause() is False
    assert slam.backend_queue.get_nowait() == ["unpause"]


def test_a_port_taken_raises():
    """A GUI that cannot bind its port raises where it is started, and a
    SLAM run with it does not start; nothing serves in its name."""
    import socket

    from monogs_tpu_torch.slam import runtime

    with socket.socket() as held:
        held.bind(("0.0.0.0", 0))
        held.listen(1)
        taken = held.getsockname()[1]
        params = ParamsGUI(q_main2vis=queue.Queue(), q_vis2main=queue.Queue(),
                           port=taken, device=CPU)
        with pytest.raises(RuntimeError, match=f"port {taken}") as e:
            slam_gui.start(params)
        assert isinstance(e.value.__cause__, OSError)
        slam = runtime.SLAM(gui_config(taken), device=CPU)
        with pytest.raises(RuntimeError, match="could not serve"):
            slam.run()
        assert slam.gui_port is None
