"""Tracking frontend: per-frame loop, keyframe policy, window management.

Counterpart of ``monogs_tpu/slam/frontend.py``: the previous pose as each
frame's seed, the port's ``track_frame``, the keyframe decision
(``is_keyframe`` and the overlap checks), window management with the
monocular map reset, depth initialisation for new keyframes, the message
handlers (sync_backend / keyframe / init / stop / backend_failed), the
tracking override and replay modes, and ATE evaluation during the run.

The depth-1 dispatch pipeline keeps the JAX package's semantics (frame i
is dispatched before frame i-1's host work; ``n_pipelined`` counts them;
``_pending`` is drained at the end), but the port's ``track_frame``
synchronises the host with the card once per iteration for its exit test
(``TrackResult.host_syncs``), so the dispatch returns with the frame
already tracked and the pipeline hides nothing.

Random draws come from a ``torch.Generator`` seeded with ``seed`` (the JAX
package's key) or from a ``DrawSource``; the monocular depth noise from a
numpy generator seeded with ``seed``, as in the JAX package.

With the GUI's queues (``q_main2vis``, ``q_vis2main``; ``Results.use_gui``)
each tracked frame sends a ``GaussianPacket`` (its pose, the window, the
ground-truth image, the trajectories; every 5th frame also a snapshot of
the map, copied on the card), and the loop honours the GUI's pause: a
paused frontend tracks nothing and tells the backend to pause too. The
GUI only reads: a run with it tracks and maps exactly as one without.
"""

from __future__ import annotations

import os
import queue
import time
from typing import Optional

import numpy as np
import torch

from .. import as_tensor
from ..ops.losses import get_median_depth
from ..render import RenderConfig, render
from ..render.camera import Intrinsics
from ..utils.logging import Log
from ..utils.profiling import ProfileLogger, StageTimers, load_profile_logs
from .backend import Keyframe
from .draws import DrawSource
from .frame import Frame, make_frame_data
from .keyframing import (
    add_to_window, is_keyframe, keyframe_depth_init, overlap_ratio,
)
from .tracking import TrackConfig, track_frame


def host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class FrontEnd:
    def __init__(self, config: dict, dataset, intr: Intrinsics,
                 render_cfg: RenderConfig, tcfg: TrackConfig, frontend_queue,
                 backend_queue, save_dir=None, seed: int = 0, device="cuda",
                 draws: Optional[DrawSource] = None, q_main2vis=None,
                 q_vis2main=None):
        self.config = config
        self.dataset = dataset
        self.intr = intr
        self.render_cfg = render_cfg
        self.tcfg = tcfg
        self.frontend_queue = frontend_queue
        self.backend_queue = backend_queue
        self.save_dir = save_dir
        self.device = torch.device(device)
        self.q_main2vis = q_main2vis
        self.q_vis2main = q_vis2main
        self.pause = False
        self._traj: list[np.ndarray] = []      # camera centres for the GUI
        self._traj_gt: list[np.ndarray] = []

        tr = config["Training"]
        self.monocular = tr["monocular"]
        self.kf_interval = tr["kf_interval"]
        self.window_size = tr["window_size"]
        self.kf_translation = tr["kf_translation"]
        self.kf_min_translation = tr["kf_min_translation"]
        self.kf_overlap = tr["kf_overlap"]
        self.kf_cutoff = tr.get("kf_cutoff", 0.4)
        self.edge_threshold = tr["edge_threshold"]
        self.rgb_boundary_threshold = tr["rgb_boundary_threshold"]
        self.single_thread = config["Dataset"].get("single_thread", False)
        # depth-1 tracking dispatch pipeline (threaded mode, initialised,
        # no override); Training.pipeline_tracking: false opts out
        self.pipeline_tracking = tr.get("pipeline_tracking", True)
        # threaded-mode gate: hold tracking while a keyframe request is in
        # flight (off = the reference's semantics)
        self.block_on_keyframe = tr.get("block_on_keyframe", False)
        self._pending = None  # (idx, Frame, TrackResult, t_dispatch)
        self.n_pipelined = 0  # frames dispatched ahead of the previous one's host work
        self.dataset_type = config["Dataset"].get("type", "tum")
        self.save_results = config["Results"].get("save_results", False)
        self.save_trj = config["Results"].get("save_trj", False)
        self.save_trj_kf_intv = config["Results"].get("save_trj_kf_intv", 10)

        self.initialized = not self.monocular
        self.cameras: dict[int, Frame] = {}
        self.kf_indices: list[int] = []
        self.current_window: list[int] = []
        self.occ_aware_visibility: dict[int, np.ndarray] = {}
        self.gaussians = None
        self.reset = True
        self.requested_init = False
        self.requested_keyframe = 0
        self.use_every_n_frames = 1
        self.median_depth = 4.0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.draws = draws or DrawSource()
        self._np_rng = np.random.default_rng(seed)
        self._ate_log: list[tuple[int, float]] = []
        self.metrics = None  # MetricsLogger, wired by the runtime

        rgn = tr.get("RGN", {})
        self.timers = StageTimers(period=10)

        # tracking override / replay: "gt" adopts the ground-truth pose;
        # "first" replays a logged run's poses; "best" replays the logged
        # frames whose tracking loss beat this run's
        override = rgn.get("override", {})
        self.override_mode = override.get("mode", "none")
        self.override_data = None
        if self.override_mode in ("first", "best"):
            logdir = override.get("first_logdir", "outputs")
            self.override_data = load_profile_logs(logdir)
            if not self.override_data:
                raise FileNotFoundError(
                    f"override mode '{self.override_mode}' found no "
                    f"run-frame*.npz logs under {logdir}")
            Log(f"Tracking override '{self.override_mode}': replaying "
                f"{len(self.override_data)} logged frames from {logdir}")

        self.profile_logger = None
        if rgn.get("log_output", False):
            logdir = os.path.join(rgn.get("log_basedir", "outputs"),
                                  time.strftime("%Y%m%d_%H%M"))
            self.profile_logger = ProfileLogger(
                logdir, save_period=rgn.get("save_period", 10))

    # ------------------------------------------------------------------
    def _load_frame(self, idx: int) -> Frame:
        image, depth, pose = self.dataset[idx]
        image = as_tensor(image, self.device)
        depth = None if depth is None else as_tensor(depth, self.device)
        data = make_frame_data(image, depth, self.edge_threshold,
                               self.rgb_boundary_threshold, self.dataset_type)
        return Frame.new(idx, as_tensor(pose, self.device), data, depth=depth)

    def add_new_keyframe(self, cur_frame_idx, depth=None, opacity=None,
                         init=False):
        """The depth map [H, W] for the keyframe's Gaussian insertion: the
        sensor depth (RGB-D), or random (mono, first keyframe) or rendered
        depth with noise (mono)."""
        self.kf_indices.append(cur_frame_idx)
        frame = self.cameras[cur_frame_idx]
        gt_img = frame.data.gt_image
        valid_rgb = gt_img.sum(dim=0) > self.rgb_boundary_threshold
        if self.monocular:
            if depth is None:
                initial = 2.0 * np.ones(tuple(gt_img.shape[1:]), np.float32)
                initial += (self._np_rng.standard_normal(initial.shape)
                            .astype(np.float32) * 0.3)
            else:
                initial = keyframe_depth_init(
                    host(depth[0]), host(opacity[0]), host(valid_rgb),
                    self._np_rng)
            # float64 where the noise scale was (as the JAX package,
            # which casts at insertion)
            return torch.as_tensor(initial, dtype=torch.float32,
                                   device=self.device)
        return torch.where(valid_rgb, frame.depth, torch.zeros_like(frame.depth))

    def initialize(self, cur_frame_idx, frame: Frame):
        """First frame, or a reset: the ground-truth pose, insertion."""
        self.initialized = not self.monocular
        self.kf_indices = []
        self.occ_aware_visibility = {}
        self.current_window = []
        while not self.backend_queue.empty():
            try:
                self.backend_queue.get_nowait()
            except queue.Empty:
                break
        frame.T = frame.T_gt
        depth_map = self.add_new_keyframe(cur_frame_idx, init=True)
        self.request_init(cur_frame_idx, frame, depth_map)
        self.reset = False

    def tracking(self, cur_frame_idx, frame: Frame):
        """Track from the previous frame's pose (the reference computes a
        constant-velocity seed and then overrides it with the previous
        pose)."""
        prev = self.cameras[cur_frame_idx - self.use_every_n_frames]
        res, t0 = self._dispatch_tracking(cur_frame_idx, frame, prev.T)
        return self._finish_tracking(cur_frame_idx, frame, res, t0)

    def _dispatch_tracking(self, cur_frame_idx, frame: Frame, seed_T):
        """Run ``track_frame`` from ``seed_T``; returns (result, t0)."""
        frame.T = seed_T
        t0 = time.time()
        res = track_frame(
            self.gaussians.render_view(), frame.data, frame.T,
            frame.exposure_a, frame.exposure_b, self.generator, self.intr,
            self.render_cfg, self.tcfg, draws=self.draws.track())
        return res, t0

    def _finish_tracking(self, cur_frame_idx, frame: Frame, res, t0):
        """Wait for the frame's result on the card, then the per-frame
        bookkeeping. The elapsed time spans dispatch to result."""
        if res.T.is_cuda:
            torch.cuda.current_stream(res.T.device).synchronize()
        elapsed = time.time() - t0
        frame.T = res.T
        frame.exposure_a = res.ea
        frame.exposure_b = res.eb

        overridden = False
        if self.override_mode == "gt":
            frame.T = frame.T_gt
            overridden = True
        elif self.override_mode in ("first", "best"):
            rec = self.override_data.get(cur_frame_idx)
            if rec is not None and "pose" in rec:
                replay = self.override_mode == "first" or (
                    float(rec.get("last_l1", np.inf)) < float(res.last_l1))
                if replay:
                    frame.T = as_tensor(rec["pose"], self.device)
                    if "exposure_a" in rec:
                        frame.exposure_a = as_tensor(rec["exposure_a"],
                                                     self.device)
                        frame.exposure_b = as_tensor(rec["exposure_b"],
                                                     self.device)
                    overridden = True
        if overridden:
            # re-render at the adopted pose: the keyframe depth, the
            # visibility and the median depth describe that pose; pose,
            # exposure and loss stay the tracker's own, so that a replay
            # run's profile log stays replayable
            out = render(self.gaussians.render_view(), frame.T, self.intr,
                         self.render_cfg)
            res = res._replace(
                image=out.image, depth=out.depth, opacity=out.opacity,
                n_touched=out.n_touched,
                median_depth=get_median_depth(out.depth, out.opacity))

        self.median_depth = float(res.median_depth)
        self.timers.add("tracking", elapsed)
        self.timers.frame_done()
        if self.profile_logger is not None:
            self.profile_logger.log_frame(
                cur_frame_idx, tracking_ms=elapsed * 1000.0,
                last_l1=float(res.last_l1), fo_iters=int(res.fo_iters),
                so_iters=int(res.so_iters), pose=host(res.T),
                exposure_a=float(res.ea), exposure_b=float(res.eb),
                fo_losses=host(res.fo_losses), so_losses=host(res.so_losses))
        return res

    def _flush_pending(self, post: bool = True):
        """Host-side processing of the pipelined frame in flight."""
        if self._pending is None:
            return
        idx, frame, res, t0 = self._pending
        self._pending = None
        self._finish_tracking(idx, frame, res, t0)
        if post:
            self._post_tracking(idx, frame, res)

    def _keyframe(self, cur_frame_idx, frame: Frame) -> Keyframe:
        return Keyframe(uid=cur_frame_idx, data=frame.data, T=frame.T,
                        ea=frame.exposure_a, eb=frame.exposure_b,
                        T_gt=frame.T_gt)

    def request_keyframe(self, cur_frame_idx, frame: Frame, current_window,
                         depthmap):
        self.backend_queue.put(["keyframe", cur_frame_idx,
                                self._keyframe(cur_frame_idx, frame),
                                current_window, depthmap])
        self.requested_keyframe += 1

    def request_init(self, cur_frame_idx, frame: Frame, depth_map):
        self.backend_queue.put(["init", cur_frame_idx,
                                self._keyframe(cur_frame_idx, frame),
                                depth_map])
        self.requested_init = True

    def sync_backend(self, data):
        self.gaussians = data[1]
        self.occ_aware_visibility = data[2]
        for kf_id, kf_T in data[3]:
            self.cameras[kf_id].T = kf_T

    def _send_gui_packet(self, cur_frame_idx, frame: Frame):
        """The frame's GUI packet; a snapshot of the map every 5th frame."""
        if self.q_main2vis is None:
            return
        from ..gui.gui_utils import CameraMsg, GaussianPacket, snapshot

        def center(T):
            T = host(T)
            return -T[:3, :3].T @ T[:3, 3]

        self._traj.append(center(frame.T))
        self._traj_gt.append(center(frame.T_gt))
        window = self.current_window
        self.q_main2vis.put(GaussianPacket(
            gaussians=(snapshot(self.gaussians) if cur_frame_idx % 5 == 0
                       else None),
            current_frame=CameraMsg(uid=cur_frame_idx, T=frame.T,
                                    T_gt=frame.T_gt),
            keyframes=[CameraMsg(uid=i, T=self.cameras[i].T,
                                 T_gt=self.cameras[i].T_gt) for i in window],
            kf_window={window[0]: window[1:]} if window else {},
            gtcolor=frame.data.gt_image if frame.data is not None else None,
            gtdepth=frame.depth,
            trajectory=np.asarray(self._traj, np.float32),
            trajectory_gt=np.asarray(self._traj_gt, np.float32)))

    def _check_gui_pause(self) -> bool:
        """The GUI's pause back-channel: the latest request, passed on to
        the backend."""
        if self.q_vis2main is None:
            return False
        try:
            data = self.q_vis2main.get_nowait()
        except queue.Empty:
            return self.pause
        self.pause = data.flag_pause
        self.backend_queue.put(["pause" if self.pause else "unpause"])
        return self.pause

    def cleanup(self, cur_frame_idx):
        self.cameras[cur_frame_idx].clean()

    def eval_ate_now(self, cur_frame_idx, final=False):
        from ..eval.ate import eval_ate

        ate = eval_ate(self.cameras, self.kf_indices, self.save_dir,
                       cur_frame_idx, final=final, monocular=self.monocular)
        self._ate_log.append((cur_frame_idx, ate))
        if self.metrics is not None:
            self.metrics.log({"frame_idx": cur_frame_idx, "ate": ate})
        return ate

    def _post_tracking(self, cur_frame_idx, frame: Frame, res) -> bool:
        """Keyframe decision and window management after a tracked frame.
        Returns False when a monocular map reset was triggered: the frame
        index must not advance, and the same frame re-initialises the map
        on the next pass."""
        self._send_gui_packet(cur_frame_idx, frame)
        if self.requested_keyframe > 0:
            self.cleanup(cur_frame_idx)
            return True

        last_keyframe_idx = self.current_window[0]
        check_time = (cur_frame_idx - last_keyframe_idx) >= self.kf_interval
        curr_visibility = host(res.n_touched > 0)
        create_kf = is_keyframe(
            host(frame.T), host(self.cameras[last_keyframe_idx].T),
            self.median_depth, curr_visibility,
            self.occ_aware_visibility[last_keyframe_idx],
            self.kf_translation, self.kf_min_translation, self.kf_overlap)
        if len(self.current_window) < self.window_size:
            ratio = overlap_ratio(curr_visibility,
                                  self.occ_aware_visibility[last_keyframe_idx])
            create_kf = check_time and ratio < self.kf_overlap
        if self.single_thread:
            create_kf = check_time and create_kf

        if create_kf:
            poses = {idx: host(self.cameras[idx].T)
                     for idx in self.current_window + [cur_frame_idx]}
            self.current_window, removed = add_to_window(
                cur_frame_idx, curr_visibility, self.occ_aware_visibility,
                self.current_window, poses, self.window_size, self.kf_cutoff,
                self.initialized)
            if self.monocular and not self.initialized and removed is not None:
                self.reset = True
                Log("Keyframes lacks sufficient overlap to initialize the "
                    "map, resetting.")
                return False
            depth_map = self.add_new_keyframe(
                cur_frame_idx, depth=res.depth, opacity=res.opacity)
            self.request_keyframe(cur_frame_idx, frame, self.current_window,
                                  depth_map)
        else:
            self.cleanup(cur_frame_idx)

        if (self.save_results and self.save_trj and create_kf
                and len(self.kf_indices) % self.save_trj_kf_intv == 0):
            Log("Evaluating ATE at frame: ", cur_frame_idx + 1)
            self.eval_ate_now(cur_frame_idx + 1)
        return True

    # ------------------------------------------------------------------
    def run(self):
        cur_frame_idx = 0
        while True:
            if self._check_gui_pause():
                time.sleep(0.05)
                continue
            if self.frontend_queue.empty():
                if cur_frame_idx >= len(self.dataset):
                    self._flush_pending()
                    if self.save_results and self.save_trj:
                        self.eval_ate_now(cur_frame_idx, final=True)
                    if self.profile_logger is not None:
                        self.profile_logger.close()
                    break

                if self.requested_init:
                    time.sleep(0.01)
                    continue
                if self.single_thread and self.requested_keyframe > 0:
                    time.sleep(0.01)
                    continue
                if self.block_on_keyframe and self.requested_keyframe > 0:
                    # hold tracking while keyframe BA is in flight, so the
                    # pose never runs ahead of a lagging map
                    time.sleep(0.005)
                    continue
                if not self.initialized and self.requested_keyframe > 0:
                    time.sleep(0.001)
                    continue

                frame = self._load_frame(cur_frame_idx)
                self.cameras[cur_frame_idx] = frame

                if self.reset:
                    self._flush_pending()  # pending implies initialised
                    self.initialize(cur_frame_idx, frame)
                    self.current_window.append(cur_frame_idx)
                    cur_frame_idx += 1
                    continue

                self.initialized = self.initialized or (
                    len(self.current_window) == self.window_size)

                pipelined = (self.pipeline_tracking and self.initialized
                             and not self.single_thread
                             and self.override_mode == "none")
                if pipelined:
                    # seed from the frame in flight when there is one
                    prev_T = (self._pending[2].T if self._pending is not None
                              else self.cameras[
                                  cur_frame_idx - self.use_every_n_frames].T)
                    res, t0 = self._dispatch_tracking(cur_frame_idx, frame,
                                                      prev_T)
                    self.n_pipelined += 1
                    self._flush_pending()
                    self._pending = (cur_frame_idx, frame, res, t0)
                    cur_frame_idx += 1
                    continue

                self._flush_pending()  # mode transition: drain first
                res = self.tracking(cur_frame_idx, frame)
                if not self._post_tracking(cur_frame_idx, frame, res):
                    continue
                cur_frame_idx += 1
            else:
                data = self.frontend_queue.get()
                if data[0] == "sync_backend":
                    self.sync_backend(data)
                elif data[0] == "keyframe":
                    self.sync_backend(data)
                    self.requested_keyframe -= 1
                elif data[0] == "init":
                    self.sync_backend(data)
                    self.requested_init = False
                elif data[0] == "backend_failed":
                    # the backend thread's exception, raised here instead
                    # of waiting for an acknowledgement that never comes
                    raise RuntimeError("backend thread failed") from data[1]
                elif data[0] == "stop":
                    # record the pose in flight, request no keyframe: the
                    # backend is shutting down
                    self._flush_pending(post=False)
                    Log("Frontend Stopped.")
                    break
