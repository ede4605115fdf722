"""Mapping backend: message loop and keyframe-window optimisation.

Counterpart of ``monogs_tpu/slam/backend.py``: the message vocabulary
(init / keyframe / pause / unpause / color_refinement / stop), idle
mapping with a covisibility prune every 10 iterations in threaded mode,
keyframe insertion, the initial-BA schedule, covisibility pruning, colour
refinement in chunks and ``push_to_frontend``. It runs as a host thread
that drives the port's ``map_iters`` over a fixed-capacity map.

Every map update returns new tensors (``models/gaussian_map.py``), so the
map and the keyframes' poses are handed to the frontend by reference: no
tensor that crossed a queue is written in place afterwards. Both threads
launch on their thread's current CUDA stream, the device's default one,
so the frontend's reads are ordered after the backend's writes without
events. Random draws come from a ``torch.Generator`` seeded with
``seed + 12345`` (the JAX package's key) or from a ``DrawSource``; the pool
permutation from a numpy generator seeded with ``seed + 54321``, as in the
JAX package.

Sharded mapping (``parallel/``): ``Parallel.n_devices`` shards the
window's views over a "view" mesh dimension, ``Parallel.gauss_devices``
the map itself over "gauss" (it needs ``Renderer.backend`` "pallas_lists":
the sharded loop is the fused step; ``check_parallel``), both a 2-D mesh.
``_map_iters`` then routes every mapping call through the run's
``RankGroup`` (``parallel/launch.py``), which hands it to the other ranks
first; colour refinement stays on this rank, as in the JAX package.
"""

from __future__ import annotations

import os
import queue
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..models import gaussian_map as gm
from ..models.insertion import keyframe_to_gaussians
from ..render import RenderConfig
from ..render.camera import Intrinsics
from ..utils.logging import Log
from ..utils.profiling import StageTimers
from .draws import DrawSource
from .frame import FrameData
from .mapping import (
    CamBatch, MapConfig, color_refinement_iters, covisibility_prune,
    empty_cam_batch, map_iters,
)


@dataclass
class Keyframe:
    uid: int
    data: FrameData
    T: torch.Tensor
    ea: torch.Tensor
    eb: torch.Tensor
    T_gt: Optional[torch.Tensor] = None


def parallel_shape(config):
    """(n_view, n_gauss): the mapping mesh of the config's ``Parallel``
    section (1 x 1 without one)."""
    par = config.get("Parallel", {}) or {}
    return int(par.get("n_devices", 1)), int(par.get("gauss_devices", 1))


def check_parallel(config, render_cfg: RenderConfig, mcfg: MapConfig):
    """``parallel_shape``, checked as the JAX backend checks it:
    ``gauss_devices`` above 1 needs the "pallas_lists" backend and ignores
    the mapping knobs of other branches (logged)."""
    n_view, n_gauss = parallel_shape(config)
    if n_gauss > 1:
        if render_cfg.backend != "pallas_lists":
            raise ValueError(
                "Parallel.gauss_devices needs Renderer.backend="
                "'pallas_lists' (the gauss-sharded mapping loop is built on "
                "the fused mapping step and the counts kernel)")
        ignored = [k for k, v, d in (
            ("fused_grad", mcfg.fused_grad, True),
            ("io_batch", mcfg.io_batch, False),
            ("scatter_segsum", mcfg.scatter_segsum, False),
            ("gather_first", mcfg.gather_first, False)) if v != d]
        if ignored:
            Log("Parallel.gauss_devices ignores non-default mapping knobs "
                f"{ignored} (the gauss-sharded loop is the fused step only)",
                tag="warn")
    return n_view, n_gauss


class BackEnd:
    def __init__(self, config: dict, gaussians: gm.GaussianMap,
                 intr: Intrinsics, render_cfg: RenderConfig, mcfg: MapConfig,
                 hyper: gm.MapHyper, frontend_queue, backend_queue,
                 live_mode: bool = False, insert_cap: int = 32768,
                 seed: int = 0, draws: Optional[DrawSource] = None,
                 ranks=None):
        self.config = config
        self.gaussians = gaussians
        self.device = gaussians.active.device
        self.intr = intr
        self.render_cfg = render_cfg
        self.mcfg = mcfg
        self.hyper = hyper
        self.frontend_queue = frontend_queue
        self.backend_queue = backend_queue
        self.live_mode = live_mode
        self.insert_cap = insert_cap

        tr = config["Training"]
        self.monocular = tr["monocular"]
        self.single_thread = config["Dataset"].get("single_thread", False)
        self.init_itr_num = tr["init_itr_num"]
        self.mapping_itr_num = tr["mapping_itr_num"]
        self.window_size = tr["window_size"]
        self.pose_window = tr["pose_window"]
        self.prune_mode = tr.get("prune_mode", "slam")
        self.save_initial_ply = config["Results"].get("save_initial_ply",
                                                      False)

        ds = config["Dataset"]
        self.pcd_downsample = ds.get("pcd_downsample", 64)
        self.pcd_downsample_init = ds.get("pcd_downsample_init", 32)
        self.point_size = ds.get("point_size", 0.01)
        self.adaptive_pointsize = ds.get("adaptive_pointsize", True)

        # the mesh shape, and the ranks that run its calls (SLAM starts
        # them, ``parallel/launch.RankGroup``)
        self.shape = parallel_shape(config)
        self.ranks = ranks
        if ranks is not None:
            Log(f"Mapping sharded over a {self.shape[0]} x {self.shape[1]} "
                f"(view x gauss) mesh of {ranks.backend} ranks")

        # time per stage: the full-system time split
        self.timers = StageTimers(period=1 << 30, tag="ProfBE")

        self.iteration_count = 0
        self.last_sent = 0
        self.viewpoints: dict[int, Keyframe] = {}
        self.current_window: list[int] = []
        self.occ_aware_visibility: dict[int, np.ndarray] = {}
        self.initialized = not self.monocular
        self.pause = False
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + 12345)
        self.draws = draws or DrawSource()
        self._np_rng = np.random.default_rng(seed + 54321)
        self._kf_adam = None  # window-pose Adam state, reset per keyframe
        # visibility of the last map() call, reused by the covisibility
        # prune while the map is unchanged since
        self._last_vis = None
        self._last_vis_window: list | None = None

    # ------------------------------------------------------------------
    def _map_iters(self, m, cams: CamBatch, n_iters, initialization=False,
                   **kw):
        # draws for the JAX package's batch: one slot at initialisation,
        # else window_size + pool_size, the staged views in the first
        slots = 1 if initialization else self.window_size + self.mcfg.pool_size
        draws = self.draws.map(n_iters, slots)
        if self.ranks is not None:
            return self.ranks.map_iters(
                self.shape, m, cams, n_iters, self.iteration_count,
                self.generator, self.intr, self.render_cfg, self.mcfg,
                self.hyper, initialization=initialization, draws=draws, **kw)
        if self.shape != (1, 1):
            raise RuntimeError(
                f"a {self.shape[0]} x {self.shape[1]} mapping mesh needs its "
                "ranks (SLAM.run starts a parallel.launch.RankGroup)")
        return map_iters(
            m, cams, n_iters, self.iteration_count, self.generator,
            self.intr, self.render_cfg, self.mcfg, self.hyper,
            initialization=initialization, draws=draws, **kw)

    def add_next_kf(self, frame_idx, kf: Keyframe, depth_map, init=False):
        """Insert the keyframe's unprojected depth into the map."""
        factor = self.pcd_downsample_init if init else self.pcd_downsample
        h, w = self.intr.height, self.intr.width
        leaves, count = keyframe_to_gaussians(
            kf.data.gt_image, depth_map, kf.T, kf.ea, kf.eb,
            intr=self.intr, cap=self.insert_cap,
            sh_k=self.gaussians.params.sh.shape[1],
            downsample_factor=factor, point_size=self.point_size,
            adaptive_pointsize=self.adaptive_pointsize,
            generator=self.generator, keep_draw=self.draws.insert(h, w))
        self.gaussians = gm.insert(self.gaussians, leaves, count, frame_idx)
        self._last_vis_window = None  # map changed: stored visibility stale
        n_active = int(self.gaussians.n_active)
        cap = self.gaussians.capacity
        if n_active > 0.9 * cap:
            Log(f"map at {n_active}/{cap} capacity — inserts will start "
                "dropping; raise Renderer.map_capacity", tag="Warn")

    def reset(self):
        """Full map and window reset."""
        self.iteration_count = 0
        self.occ_aware_visibility = {}
        self.viewpoints = {}
        self.current_window = []
        self.initialized = not self.monocular
        self._kf_adam = None
        self._last_vis = None
        self._last_vis_window = None
        self.gaussians = gm.prune(
            self.gaussians, torch.ones_like(self.gaussians.active))
        while not self.backend_queue.empty():
            try:
                self.backend_queue.get_nowait()
            except queue.Empty:
                break

    # ------------------------------------------------------------------
    def _stage_batch(self, window, pool_ids, frames_to_optimize) -> CamBatch:
        """The window's views, then the pool's. The JAX package pads the
        batch to window_size + pool_size slots for one compiled shape; the
        padding's gradients are masked to zero there, so the port stages
        only the real views and skips their work."""
        views = [(self.viewpoints[kf_idx],
                  rank < frames_to_optimize and kf_idx != 0, kf_idx != 0)
                 for rank, kf_idx in enumerate(window)]
        views += [(self.viewpoints[kf_idx], False, False)
                  for kf_idx in pool_ids]
        views = views[:self.window_size + self.mcfg.pool_size]

        def stack(get):
            return torch.stack([get(v[0]) for v in views])

        def flags(i):
            return torch.tensor([v[i] for v in views], device=self.device)

        return CamBatch(
            gt_image=stack(lambda k: k.data.gt_image),
            gt_depth=stack(lambda k: k.data.gt_depth),
            mapping_mask=stack(lambda k: k.data.mapping_mask),
            T=stack(lambda k: k.T), ea=stack(lambda k: k.ea),
            eb=stack(lambda k: k.eb),
            valid=torch.ones(len(views), dtype=torch.bool, device=self.device),
            opt_pose=flags(1), opt_exposure=flags(2))

    def _writeback(self, window, cams: CamBatch, visibility):
        vis_np = visibility.cpu().numpy()
        for rank, kf_idx in enumerate(window):
            kf = self.viewpoints[kf_idx]
            kf.T = cams.T[rank]
            kf.ea = cams.ea[rank]
            kf.eb = cams.eb[rank]
            self.occ_aware_visibility[kf_idx] = vis_np[rank]

    def initialize_map(self, cur_frame_idx):
        """init_itr_num iterations on the first keyframe."""
        kf = self.viewpoints[cur_frame_idx]
        no = torch.zeros((1,), dtype=torch.bool, device=self.device)
        cams = CamBatch(
            gt_image=kf.data.gt_image[None], gt_depth=kf.data.gt_depth[None],
            mapping_mask=kf.data.mapping_mask[None], T=kf.T[None],
            ea=kf.ea[None], eb=kf.eb[None], valid=~no, opt_pose=no,
            opt_exposure=no)
        r = self._map_iters(self.gaussians, cams, self.init_itr_num,
                            initialization=True)
        self.gaussians = r.m
        self.iteration_count = r.it_count
        self.occ_aware_visibility[cur_frame_idx] = r.visibility[0].cpu().numpy()
        Log("Initialized map")

        if self.save_initial_ply:
            # save the map after initialisation, and stop
            from ..models.ply import save_ply

            Log("Saving initial ply")
            save_ply(self.gaussians, os.path.join(
                self.config["Results"].get("save_dir", "results") or ".",
                "frame1.ply"))
            self.backend_queue.put(["stop"])
            self.frontend_queue.put(["stop"])

    def map(self, window, prune=False, iters=1, frames_to_optimize=None):
        """Window BA of ``iters`` iterations, or with ``prune`` the
        covisibility prune (which runs no optimizer step)."""
        if len(window) == 0:
            return
        if frames_to_optimize is None:
            frames_to_optimize = self.pose_window

        if prune:
            if len(window) == self.window_size:
                # the visibility of the preceding map() call on this window
                # (its final n_touched pass runs after the last update, on
                # the map and poses a fresh render here would see)
                if self._last_vis_window == list(window):
                    vis = self._last_vis
                else:  # a prune not preceded by map() on the window
                    cams = self._stage_batch(window, [], 0)
                    vis = self._map_iters(self.gaussians, cams, 0).visibility
                    vis_np = vis.cpu().numpy()
                    for rank, kf_idx in enumerate(window):
                        self.occ_aware_visibility[kf_idx] = vis_np[rank]
                ids = window + [-1] * (self.window_size - len(window))
                self.gaussians, _ = covisibility_prune(
                    self.gaussians, vis[: self.window_size],
                    torch.tensor(ids, dtype=torch.int32, device=self.device),
                    self.initialized, self.mcfg, prune_mode=self.prune_mode)
                self._last_vis_window = None  # map changed by the prune
                if not self.initialized:
                    self.initialized = True
                    Log("Initialized SLAM")
            return

        candidates = [i for i in self.viewpoints if i not in set(window)]
        pool = list(
            self._np_rng.permutation(candidates)[: self.mcfg.pool_size])
        cams = self._stage_batch(window, pool, frames_to_optimize)
        # the window pose/exposure Adam moments persist across idle-mapping
        # calls between keyframes
        r = self._map_iters(self.gaussians, cams, iters,
                            kf_adam=self._kf_adam)
        self.gaussians, self._kf_adam = r.m, r.kf_adam
        self.iteration_count = r.it_count
        self.last_sent += iters
        self._writeback(window, r.cams, r.visibility)
        self._last_vis = r.visibility
        self._last_vis_window = list(window)

    def color_refinement(self, iteration_total=None, chunk=2000, pool=16):
        """Photometric refinement (26000 iterations by default,
        ``Training.refinement_itr``), in chunks over random keyframes."""
        if iteration_total is None:
            iteration_total = self.config["Training"].get("refinement_itr",
                                                          26000)
        Log(f"Starting color refinement ({iteration_total} iters)")
        h, w = self.intr.height, self.intr.width
        b = max(pool, 1)
        done = 0
        while done < iteration_total:
            ids = list(self._np_rng.permutation(list(self.viewpoints))[:pool])
            views = [self.viewpoints[i] for i in ids]
            if not views:
                break
            pad = b - len(views)
            cams = empty_cam_batch(b, h, w, self.device)
            cams = cams._replace(
                gt_image=torch.stack([v.data.gt_image for v in views]
                                     + [views[0].data.gt_image] * pad),
                T=torch.stack([v.T for v in views] + [views[0].T] * pad),
                valid=torch.arange(b, device=self.device) < len(views))
            n = min(chunk, iteration_total - done)
            self._last_vis_window = None  # refinement moves the map
            self.gaussians = color_refinement_iters(
                self.gaussians, cams, n, self.generator, self.intr,
                self.render_cfg, self.mcfg, self.hyper,
                views=self.draws.refine(n, len(views)))
            done += n
        Log("Map refinement done")

    def stage_summary(self) -> dict:
        """{stage: (total_seconds, count)} of the backend's stages (insert,
        map_init, map_kf, map_idle, map_prune, refinement): on the card's
        timeline, read here (``StageTimers.summary``)."""
        return self.timers.summary()

    def push_to_frontend(self, tag=None):
        self.last_sent = 0
        keyframes = [(kf_idx, self.viewpoints[kf_idx].T)
                     for kf_idx in self.current_window]
        self.frontend_queue.put([tag or "sync_backend", self.gaussians,
                                 dict(self.occ_aware_visibility), keyframes])

    # ------------------------------------------------------------------
    def run(self):
        """Message loop."""
        while True:
            if self.backend_queue.empty():
                if (self.pause or len(self.current_window) == 0
                        or self.single_thread):
                    time.sleep(0.01)
                    continue
                with self.timers.stage("map_idle"):
                    self.map(self.current_window)
                if self.last_sent >= 10:
                    with self.timers.stage("map_prune"):
                        self.map(self.current_window, prune=True, iters=10)
                    self.push_to_frontend()
                continue

            data = self.backend_queue.get()
            if data[0] == "stop":
                break
            elif data[0] == "pause":
                self.pause = True
            elif data[0] == "unpause":
                self.pause = False
            elif data[0] == "color_refinement":
                with self.timers.stage("refinement"):
                    self.color_refinement()
                self.push_to_frontend()
            elif data[0] == "init":
                cur_frame_idx, kf, depth_map = data[1], data[2], data[3]
                Log("Resetting the system")
                self.reset()
                self.viewpoints[cur_frame_idx] = kf
                with self.timers.stage("insert"):
                    self.add_next_kf(cur_frame_idx, kf, depth_map, init=True)
                with self.timers.stage("map_init"):
                    self.initialize_map(cur_frame_idx)
                self.push_to_frontend("init")
            elif data[0] == "keyframe":
                cur_frame_idx, kf, current_window, depth_map = data[1:5]
                self.viewpoints[cur_frame_idx] = kf
                self.current_window = current_window
                with self.timers.stage("insert"):
                    self.add_next_kf(cur_frame_idx, kf, depth_map)
                # fresh keyframe optimizer state
                self._kf_adam = None

                frames_to_optimize = self.pose_window
                iter_per_kf = self.mapping_itr_num if self.single_thread else 10
                if not self.initialized:
                    if len(self.current_window) == self.window_size:
                        frames_to_optimize = self.window_size - 1
                        iter_per_kf = 50 if self.live_mode else 300
                        Log("Performing initial BA for initialization")
                    else:
                        iter_per_kf = self.mapping_itr_num
                with self.timers.stage("map_kf"):
                    self.map(self.current_window, iters=iter_per_kf,
                             frames_to_optimize=frames_to_optimize)
                with self.timers.stage("map_prune"):
                    self.map(self.current_window, prune=True)
                self.push_to_frontend("keyframe")
            else:
                raise ValueError(f"Unprocessed message {data[0]!r}")

        while not self.backend_queue.empty():
            self.backend_queue.get()
        while not self.frontend_queue.empty():
            self.frontend_queue.get()
