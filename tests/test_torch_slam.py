"""Full SLAM through the port (``monogs_tpu_torch.slam.runtime.SLAM``).

The slice as a whole: a deterministic ``single_thread`` run of
``test_slam_e2e.tiny_config`` trimmed to its first 6 frames (init 20,
mapping 5, first order 10, second order 1 iteration; renderer "xla")
through both packages, on the JAX synthetic dataset's frames as numpy,
with the JAX key chain replayed through a ``DrawSource`` (``JaxDraws``).
Tolerances: keyframes and windows equal; ``n_active`` within 0.5 % (equal
unless a prune decision sits on a float margin); every frame's pose
within 2 mm and 5 mrad (``se3.pose_diff``); keyframe ATE within 1 mm.

The run is sensitive to rounding (``scripts/port_slam_rounding.py``): the
init BA's Adam steps Gaussians whose gradients are at the rounding level
by about their learning rate, so the two packages' maps part by up to
1 cm in 20 iterations (the port against itself from positions moved by
1e-7 m parts as much), and under-converged tracking turns a map
difference into a pose difference. The frames are the first six of
tiny_config's 12-frame orbit, not a 6-frame orbit, which would double
the motion per frame: there the port parts from its own run on the depth
moved by 1e-6 m by 12.7 mm and a keyframe decision of the JAX run sits
on the overlap threshold. On these frames the two packages part by under
1 mm, about as much as the port parts from its moved run.

Then the port alone on the CPU: "pallas_lists" at 128x96 with the plain
kernel versions counted (the backend is not swapped), the threaded mode
with its dispatch pipeline, a backend failure surfacing in the caller,
the live config constructing on a simulated camera, and the ``Parallel``
configs constructing (on NCCL with too few cards, raising).
"""

import copy
import threading

import jax
import numpy as np
import pytest
import torch

from monogs_tpu.data.datasets import load_dataset as jload_dataset
from monogs_tpu.eval.ate import evaluate_ate as jevaluate_ate
from monogs_tpu.ops import sketch as jsketch
from monogs_tpu.slam import frontend as jfrontend
from monogs_tpu.slam.runtime import SLAM as JSLAM
from monogs_tpu_torch.eval.ate import evaluate_ate
from monogs_tpu_torch.ops import se3 as tse3
from monogs_tpu_torch.render import blend_lists as bl
from monogs_tpu_torch.render.renderer import _tile_origins
from monogs_tpu_torch.slam import frontend as tfrontend
from monogs_tpu_torch.slam import runtime as truntime
from monogs_tpu_torch.slam.draws import DrawSource
from monogs_tpu_torch.slam.mapping import MapDraws
from monogs_tpu_torch.slam.tracking import TrackDraws
from tests.test_slam_e2e import tiny_config
from tests.torch_one_thread import one_torch_thread  # noqa: F401


def t(x):
    return torch.from_numpy(np.array(x))


class _Lazy:
    """A sequence whose items are computed when read (the densify noise of
    an iteration that densifies)."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]()


def n_fine(intr, cfg):
    """Fine tiles of the frame's macro-aligned tile grid."""
    return _tile_origins(intr, cfg, torch.device("cpu"))[0].shape[0]


class JaxDraws(DrawSource):
    """The JAX package's key chains (frontend ``PRNGKey(seed)``, backend
    ``PRNGKey(seed + 12345)``, one split per drawing call) turned into the
    port's draws: ``track_frame`` (tracking.py:445-446, 611-612, 667-668),
    ``keyframe_to_gaussians`` (insertion.py:61), ``map_iters``
    (mapping.py:397, 492-495) and ``color_refinement_iters``
    (mapping.py:802-803)."""

    def __init__(self, intr, track_cfg, tcfg, render_cfg, mcfg, seed=0):
        self.fkey = jax.random.PRNGKey(seed)
        self.bkey = jax.random.PRNGKey(seed + 12345)
        self.tcfg, self.mcfg = tcfg, mcfg
        self.track_cfg, self.render_cfg = track_cfg, render_cfg
        self.n_fine_track = n_fine(intr, track_cfg)
        self.m_pix = intr.height * intr.width
        self.n_fine_map = n_fine(intr, render_cfg)

    def _backend_key(self):
        self.bkey, k = jax.random.split(self.bkey)
        return k

    def track(self):
        self.fkey, key = jax.random.split(self.fkey)
        tc, n_fine = self.tcfg, self.n_fine_track
        use_lists = tc.bin_margin > 0
        fo_tsel = so_tsel = None
        if use_lists and tc.fo_tile_frac < 1.0 and tc.fo_max_iter > 0:
            key, ksub = jax.random.split(key)
            n_sub = max(8, int(n_fine * tc.fo_tile_frac) // 8 * 8)
            fo_tsel = t(jax.random.permutation(ksub, n_fine)[:n_sub]).long()
        m = self.m_pix
        if use_lists and self.track_cfg.backend == "pallas_lists":
            m = n_fine * self.track_cfg.tile ** 2
            if tc.so_tile_frac < 1.0:
                n_sub = max(8, int(n_fine * tc.so_tile_frac) // 8 * 8)
                so_tsel = t(jax.random.permutation(
                    jax.random.fold_in(key, 1), n_fine)[:n_sub]).long()
                m = n_sub * self.track_cfg.tile ** 2
        sketches = []
        for _ in range(tc.so_max_iter):
            key, k1 = jax.random.split(key)
            spec = jsketch.make_sketch(k1, m, tc.stack_dim, tc.sketch_dim)
            sketches.append((t(spec.perm), t(spec.signs)))
        return TrackDraws(fo_tsel=fo_tsel, so_tsel=so_tsel, sketches=sketches)

    def insert(self, h, w):
        return t(jax.random.uniform(self._backend_key(), (h, w)))

    def map(self, n_iters, slots):
        key, mc = self._backend_key(), self.mcfg
        use_sub = (mc.bin_margin > 0 and mc.fused_grad
                   and self.render_cfg.backend == "pallas_lists"
                   and mc.tile_frac < 1.0 and not mc.scatter_segsum
                   and not mc.io_batch)
        n_fine = self.n_fine_map
        n_sub = max(8, int(n_fine * mc.tile_frac) // 8 * 8)
        tsel, noise = [], []
        for _ in range(n_iters):
            key, k_dens = jax.random.split(key)
            noise.append(lambda k=k_dens: t(jax.random.normal(
                k, (2, mc.split_cap, 3))))
            if use_sub:
                key, k_sub = jax.random.split(key)
                tsel.append(torch.stack([
                    t(jax.random.permutation(k, n_fine)[:n_sub]).long()
                    for k in jax.random.split(k_sub, slots)]))
        return MapDraws(tsel=tsel, split_noise=_Lazy(noise))

    def refine(self, n_iters, n_valid):
        key, views = self._backend_key(), []
        for _ in range(n_iters):
            key, k1 = jax.random.split(key)
            views.append(int(jax.random.randint(k1, (), 0, n_valid)))
        return views


class NumpyDataset:
    """The first ``n`` frames of another dataset as numpy (image, depth or
    None, pose)."""

    def __init__(self, ds, n=None):
        self.frames = []
        for i in range(len(ds) if n is None else n):
            img, depth, pose = ds[i]
            self.frames.append((np.asarray(img), None if depth is None
                                else np.asarray(depth), np.asarray(pose)))

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx):
        return self.frames[idx]


def trimmed_config(sensor="depth"):
    """tiny_config with fewer iterations; ``first_frames`` keeps 6 of its
    12 frames."""
    cfg = tiny_config(sensor)
    tr = cfg["Training"]
    tr["init_itr_num"] = 20
    tr["mapping_itr_num"] = 5
    tr["RGN"]["first_order"]["max_iter"] = 10
    tr["RGN"]["second_order"]["max_iter"] = 1
    return cfg


def port_slam(cfg, dataset=None, replay=False):
    """The port's SLAM on the CPU (the JAX key chain replayed)."""
    cfg = copy.deepcopy(cfg)
    draws = None
    if replay:
        c = copy.deepcopy(cfg)
        c["Training"]["monocular"] = c["Dataset"]["sensor_type"] == "monocular"
        intr = truntime.intrinsics_from_config(c)
        rc = truntime.render_config_from_config(c, intr)
        draws = JaxDraws(intr, truntime.track_render_config(c, rc),
                         truntime.track_config_from_config(c), rc,
                         truntime.map_config_from_config(c))
    return truntime.SLAM(cfg, dataset=dataset, device="cpu", draws=draws)


def poses(slam):
    return {i: np.asarray(f.T) for i, f in slam.frontend.cameras.items()}


def kf_ate(fe, evaluate):
    gt = [np.linalg.inv(np.asarray(fe.cameras[i].T_gt)) for i in fe.kf_indices]
    est = [np.linalg.inv(np.asarray(fe.cameras[i].T)) for i in fe.kf_indices]
    return evaluate(gt, est, monocular=False)[0]


def logging_ratio(fn, log):
    def logged(cur, last):
        log.append(fn(cur, last))
        return log[-1]
    return logged


@pytest.fixture(scope="module")
def both_runs():
    cfg = trimmed_config("depth")
    jcfg = copy.deepcopy(cfg)
    jcfg["Training"]["monocular"] = False
    frames = NumpyDataset(jload_dataset(jcfg), n=6)
    ratios = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        for mod, log in ((jfrontend, ratios["jax"]),
                         (tfrontend, ratios["port"])):
            mp.setattr(mod, "overlap_ratio",
                       logging_ratio(mod.overlap_ratio, log))
        a = JSLAM(jcfg, dataset=frames)
        a.run()
        b = port_slam(cfg, dataset=frames, replay=True)
        b.run()
    return a, b, ratios


def test_slam_parity_keyframes_and_windows(both_runs):
    a, b, ratios = both_runs
    # the overlap ratios behind each keyframe decision, for the message
    assert b.frontend.kf_indices == a.frontend.kf_indices, ratios
    assert len(b.frontend.kf_indices) >= 2
    assert b.frontend.current_window == a.frontend.current_window
    assert b.backend.current_window == a.backend.current_window
    assert sorted(b.backend.viewpoints) == sorted(a.backend.viewpoints)
    assert len(b.frontend.cameras) == 6


def test_slam_parity_map(both_runs):
    a, b, _ = both_runs
    na, nb = int(a.backend.gaussians.n_active), int(b.backend.gaussians.n_active)
    assert abs(nb - na) <= 0.005 * na, (na, nb)
    assert na > 500
    assert b.backend.iteration_count == a.backend.iteration_count


def test_slam_parity_poses_and_ate(both_runs):
    a, b, _ = both_runs
    pa, pb = poses(a), poses(b)
    assert sorted(pa) == sorted(pb)
    for i in pa:
        dt, dr = tse3.pose_diff(torch.from_numpy(pb[i]),
                                torch.from_numpy(pa[i]))
        assert float(dt) < 2e-3 and float(dr) < 5e-3, (i, float(dt), float(dr))
    ate_a = kf_ate(a.frontend, jevaluate_ate)
    ate_b = kf_ate(b.frontend, evaluate_ate)
    assert abs(ate_a - ate_b) < 1e-3, (ate_a, ate_b)
    assert ate_b < 0.03, ate_b


def pallas_config():
    """test_slam_pallas_interpret.py's configuration (128x96, k_fine 64,
    frozen lists, tile subsets), fewer iterations."""
    cfg = tiny_config("depth")
    cfg["Dataset"]["Calibration"].update(
        {"width": 128, "height": 96, "fx": 128.0, "fy": 128.0,
         "cx": 63.5, "cy": 47.5})
    cfg["Dataset"]["synthetic"] = {
        "n_frames": 5, "n_gauss": 2000, "seed": 0,
        "trans_amp": 0.008, "rot_amp": 0.003,
        "pan": [0.07, 0.0, 0.015, 0.0, 0.08, 0.0]}
    tr = cfg["Training"]
    tr["init_itr_num"] = 10
    tr["mapping_itr_num"] = 3
    tr["window_size"] = 4
    tr["pose_window"] = 2
    rgn = tr["RGN"]
    rgn["first_order"]["max_iter"] = 4
    rgn["second_order"]["max_iter"] = 2
    rgn["bin_margin"] = 8
    rgn["first_order"]["tile_frac"] = 0.5
    rgn["second_order"]["tile_frac"] = 0.5
    rgn["rebin_so_iters"] = 1
    cfg["Renderer"] = {
        "map_capacity": 8192, "insert_cap": 2048, "macro_tiles": 4,
        "k_macro": 512, "k_fine": 64, "backend": "pallas_lists",
        "pallas_interpret": True}
    return cfg


def test_slam_pallas_lists_runs_plain_kernels(monkeypatch):
    """"pallas_lists" on the CPU keeps its backend and runs the plain
    versions of the kernels on the path: the counts render (#2), the
    fused first-order step (#3), the six-tangent JVP (#4) and the fused
    mapping step (#6)."""
    calls = {}
    for name in ("blend_lists_counts_plain", "fo_grad_lists_plain",
                 "blend_lists_jvp8_plain", "map_grad_lists_plain"):
        fn = getattr(bl, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kw)

        monkeypatch.setattr(bl, name, counted)
    slam = port_slam(pallas_config())
    assert slam.track_render_cfg.backend == "pallas_lists"
    assert slam.render_cfg.backend == "pallas_lists"
    slam.run()
    assert sorted(calls) == ["blend_lists_counts_plain",
                             "blend_lists_jvp8_plain", "fo_grad_lists_plain",
                             "map_grad_lists_plain"], calls
    fe = slam.frontend
    assert len(fe.kf_indices) >= 2
    assert int(slam.backend.gaussians.n_active) > 200
    for f in fe.cameras.values():
        assert torch.isfinite(f.T).all()
    assert kf_ate(fe, evaluate_ate) < 0.05


def test_slam_threaded_pipelined():
    """single_thread False: the backend maps while the frontend tracks,
    the dispatch pipeline engages and is drained at the end."""
    cfg = pallas_config()
    cfg["Dataset"]["single_thread"] = False
    cfg["Renderer"]["backend"] = "xla"
    cfg["Training"]["RGN"]["second_order"]["max_iter"] = 0
    slam = port_slam(cfg)
    slam.run()
    fe = slam.frontend
    assert len(fe.cameras) == 5
    assert fe._pending is None
    assert fe.n_pipelined >= 1
    assert not any(th.name == "monogs-backend" and th.is_alive()
                   for th in threading.enumerate())
    for f in fe.cameras.values():
        assert torch.isfinite(f.T).all()


def test_backend_failure_surfaces(monkeypatch):
    """An exception in the backend thread reaches the caller as
    RuntimeError, and the thread has been joined."""
    cfg = pallas_config()
    cfg["Renderer"]["backend"] = "xla"

    def boom(self, *args, **kw):
        raise ValueError("injected backend failure")

    monkeypatch.setattr(truntime.BackEnd, "initialize_map", boom)
    slam = port_slam(cfg)
    with pytest.raises(RuntimeError, match="backend thread failed") as e:
        slam.run()
    assert isinstance(e.value.__cause__, ValueError)
    assert not any(th.name == "monogs-backend" and th.is_alive()
                   for th in threading.enumerate())


@pytest.mark.parametrize("case", [
    pytest.param("gloo", id="change0-parallel slice"),
    pytest.param("nccl", id="change1-parallel slice"),
    pytest.param("realsense", id="change2-live mode"),
])
def test_unported_configs_raise(case, monkeypatch):
    """Configs of slices ported after the first runs of this test: live
    mode constructs from the shipped live config on a simulated camera
    (``tests/sim_realsense.py``; ``tests/test_torch_live.py`` runs it),
    with the GUI on, the backend in live mode and the camera's
    intrinsics. The ``Parallel`` configs (the parallel slice) construct:
    on the CPU with gloo, with their ranks not yet started; on NCCL, two
    ranks with one card raise and name both counts."""
    cfg = trimmed_config()
    if case == "realsense":
        import sys

        from monogs_tpu_torch.slam.config import load_config
        from tests import sim_realsense as sim

        monkeypatch.setitem(sys.modules, "pyrealsense2", sim.module([], []))
        slam = truntime.SLAM(load_config("configs/live/realsense_rgbd.yaml"),
                             device="cpu")
        assert slam.live_mode and slam.use_gui and slam.backend.live_mode
        assert (slam.intr.fx, slam.intr.fy, slam.intr.cx, slam.intr.cy,
                slam.intr.width, slam.intr.height) == sim.intrinsics()
    elif case == "gloo":
        for par, backend in (({"n_devices": 2}, "xla"),
                             ({"gauss_devices": 2}, "pallas_lists")):
            c = copy.deepcopy(cfg)
            c["Parallel"] = par
            c["Renderer"]["backend"] = backend
            slam = truntime.SLAM(c, device="cpu", dist_backend="gloo")
            assert slam.ranks.n_ranks == 2 and slam.ranks.procs == []
            assert slam.backend.shape == (
                par.get("n_devices", 1), par.get("gauss_devices", 1))
    else:
        cfg["Parallel"] = {"n_devices": 2}
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(RuntimeError, match="2 ranks on NCCL.* 1 card "):
            truntime.SLAM(cfg, device="cuda")


def test_slam_defaults_to_the_card(monkeypatch):
    """SLAM runs on the card unless asked for the CPU; without CUDA it
    raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        truntime.SLAM(trimmed_config())
