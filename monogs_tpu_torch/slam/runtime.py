"""SLAM orchestrator: config helpers, and the wiring of map, dataset,
frontend, backend, queues and eval.

Counterpart of ``monogs_tpu/slam/runtime.py``. The frontend runs in the
caller's thread and the backend in a host thread; they share the map and
the keyframes through ``queue.Queue`` messages by reference (every map
update returns new tensors). ``single_thread: True`` configs keep their
deterministic semantics: the backend maps only on request and the
frontend waits for each keyframe's acknowledgement. Both threads share
the Python interpreter lock, and the port's loops are host-bound, so the
threaded mode need not be faster than the deterministic one.

``render_config_from_config`` keeps the configured backend on every
device: on the card the kernels run, on the CPU (``device="cpu"``) their
plain versions (the JAX package swaps Pallas backends for "xla" on a CPU
instead). ``Renderer.pallas_interpret`` is read into the unused field of
the same name.

Not ported here, each raising ``NotImplementedError`` that names its
slice: the GUI and live mode (``Results.use_gui``, dataset type
"realsense"), sharded mapping (``Parallel.n_devices`` or
``gauss_devices`` above 1), and the datasets other than "synthetic".
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Optional

from .. import resolve_device
from ..data.datasets import intrinsics_from_calibration, load_dataset
from ..models import gaussian_map as gm
from ..render import RenderConfig
from ..render.camera import Intrinsics
from ..utils.logging import Log
from ..utils.metrics import MetricsLogger
from .backend import BackEnd, check_parallel
from .draws import DrawSource
from .frontend import FrontEnd
from .mapping import MapConfig
from .tracking import TrackConfig


def intrinsics_from_config(config) -> Intrinsics:
    return intrinsics_from_calibration(config["Dataset"]["Calibration"])


def render_config_from_config(config, intr: Intrinsics) -> RenderConfig:
    """The configured renderer, backend unchanged on every device."""
    tr = config["Training"]
    rc = config.get("Renderer", {})
    return RenderConfig(
        tile=rc.get("tile", 16),
        macro_tiles=rc.get("macro_tiles", 8),
        k_macro=rc.get("k_macro", 4096),
        k_fine=rc.get("k_fine", 512),
        sh_degree=3 if tr.get("spherical_harmonics", False) else 0,
        macro_chunk=rc.get("macro_chunk", 0),
        backend=rc.get("backend", "xla"),
        pallas_interpret=rc.get("pallas_interpret", False),
    )


def track_render_config(config, render_cfg: RenderConfig) -> RenderConfig:
    """Tracking-side RenderConfig: ``Renderer.track_k_fine`` if set, else
    the shared k_fine (a speed/accuracy knob)."""
    k = config.get("Renderer", {}).get("track_k_fine")
    if k is None:
        k = render_cfg.k_fine
    return render_cfg._replace(k_fine=int(k))


def track_config_from_config(config) -> TrackConfig:
    tr = config["Training"]
    rgn = tr["RGN"]
    lr = tr["lr"]
    fo, so = rgn["first_order"], rgn["second_order"]
    # so_from_fo_aux / final_reuse freeze macro-cell membership at the
    # frame's seed pose for the whole frame: a correction larger than
    # bin_margin pixels leaves it stale (16 px is the validated floor on
    # TUM-like motion)
    if rgn.get("so_from_fo_aux", False) or rgn.get("final_reuse", False):
        if rgn.get("bin_margin", 0) < 12:
            Log(
                "Training.RGN.so_from_fo_aux/final_reuse freeze macro "
                f"membership at the seed pose with bin_margin only "
                f"{rgn.get('bin_margin', 0)} px — 16 px is the validated "
                "floor on TUM-like motion; validate pose error on your "
                "motion regime before shipping this config.",
                tag="Warning",
            )
    return TrackConfig(
        monocular=tr["monocular"],
        alpha=tr.get("alpha", 0.95),
        use_huber=rgn["use_huber"],
        huber_delta=rgn["huber_delta"],
        pnorm=float(rgn["pnorm"]),
        fo_max_iter=fo["max_iter"],
        so_max_iter=so["max_iter"],
        lr_trans=lr["cam_trans_delta"],
        lr_rot=lr["cam_rot_delta"],
        lr_exposure_a=lr.get("exposure_a", 0.01),
        lr_exposure_b=lr.get("exposure_b", 0.01),
        stack_dim=so["stack_dim"],
        sketch_dim=so["sketch_dim"],
        initial_lambda=so["initial_lambda"],
        max_lambda=so["max_lambda"],
        min_lambda=so["min_lambda"],
        increase_factor=so["increase_factor"],
        decrease_factor=so["decrease_factor"],
        so_converged=so["converged_threshold"],
        use_first_order_best=so.get("use_first_order_best", True),
        use_best_loss=rgn.get("use_best_loss", True),
        bin_margin=rgn.get("bin_margin", 0.0),
        rebin_before_so=rgn.get("rebin_before_so", True),
        rebin_so=bool(rgn.get("rebin_so", rgn.get("rebin_so_every", 1))),
        rebin_so_iters=rgn.get("rebin_so_iters", 3),
        fo_tile_frac=fo.get("tile_frac", 1.0),
        so_tile_frac=so.get("tile_frac", 1.0),
        fo_fused=fo.get("fused_kernel", True),
        final_refine=rgn.get("final_refine", True),
        so_from_fo_aux=rgn.get("so_from_fo_aux", False),
        final_reuse=rgn.get("final_reuse", False),
        fo_plateau_patience=fo.get("plateau_patience", 0),
        fo_plateau_rtol=fo.get("plateau_rtol", 1e-3),
        fo_min_iter=fo.get("min_iter", 0),
        so_plateau_patience=so.get("plateau_patience", 0),
        so_plateau_rtol=so.get("plateau_rtol", 1e-4),
    )


def map_config_from_config(config, cameras_extent: float = 6.0) -> MapConfig:
    tr = config["Training"]
    opt = config["opt_params"]
    lr = tr["lr"]
    rc = config.get("Renderer", {})
    return MapConfig(
        monocular=tr["monocular"],
        alpha=tr.get("alpha", 0.95),
        window_size=tr["window_size"],
        pose_window=tr["pose_window"],
        pool_size=rc.get("pool_size", 2),
        lr_trans=lr["cam_trans_delta"] * 0.5,
        lr_rot=lr["cam_rot_delta"] * 0.5,
        lr_exposure_a=lr.get("exposure_a", 0.01),
        lr_exposure_b=lr.get("exposure_b", 0.01),
        densify_grad_threshold=opt["densify_grad_threshold"],
        gaussian_th=tr["gaussian_th"],
        gaussian_extent=cameras_extent * tr["gaussian_extent"],
        gaussian_update_every=tr["gaussian_update_every"],
        gaussian_update_offset=tr["gaussian_update_offset"],
        gaussian_reset=tr["gaussian_reset"],
        size_threshold=tr["size_threshold"],
        init_gaussian_update=tr["init_gaussian_update"],
        init_gaussian_reset=tr["init_gaussian_reset"],
        init_gaussian_th=tr["init_gaussian_th"],
        init_gaussian_extent=cameras_extent * tr["init_gaussian_extent"],
        densify_from_iter=opt["densify_from_iter"],
        lambda_dssim=opt["lambda_dssim"],
        # frozen per-view tile lists: margin in pixels (0 disables) and
        # rebuild cadence
        bin_margin=rc.get("mapping_bin_margin", 4.0),
        rebin_every=rc.get("mapping_rebin_every", 25),
        batch_render=rc.get("mapping_batch_render", False),
        fused_grad=rc.get("mapping_fused_grad", True),
        # per-iteration tile subset of the fused BA gradient
        tile_frac=rc.get("mapping_tile_frac", 1.0),
        gather_first=rc.get("mapping_gather_first", False),
    )


def map_hyper_from_config(config, spatial_lr_scale: float = 6.0) -> gm.MapHyper:
    opt = config["opt_params"]
    return gm.MapHyper(
        position_lr_init=opt["position_lr_init"],
        position_lr_final=opt["position_lr_final"],
        position_lr_delay_mult=opt["position_lr_delay_mult"],
        position_lr_max_steps=opt["position_lr_max_steps"],
        feature_lr=opt["feature_lr"],
        opacity_lr=opt["opacity_lr"],
        scaling_lr=opt["scaling_lr"],
        rotation_lr=opt["rotation_lr"],
        percent_dense=opt["percent_dense"],
        spatial_lr_scale=spatial_lr_scale,
    )


def check_supported(config):
    """Raise for a config whose paths this port does not have yet."""
    if (config["Results"].get("use_gui", False)
            or config["Dataset"]["type"] == "realsense"):
        raise NotImplementedError(
            "Results.use_gui / live mode (the web GUI) arrives with the GUI "
            "slice; run with use_gui False (--eval sets it)")
    check_parallel(config)


class SLAM:
    """A full SLAM run from ``config``: ``SLAM(config).run()``. Every map,
    frame and generator lives on ``device`` (the card unless the caller
    asks for the CPU, where the kernels' plain versions run). ``dataset``
    replaces the one the config names (``dataset[i] -> (image [3, H, W],
    depth [H, W] or None, T_cw)``, tensors or arrays); ``draws`` injects
    the random draws (``DrawSource``)."""

    def __init__(self, config, dataset=None, save_dir=None, device="cuda",
                 draws: Optional[DrawSource] = None):
        check_supported(config)
        self.device = resolve_device(device)
        self.config = config
        self.save_dir = save_dir
        self.monocular = config["Dataset"]["sensor_type"] == "monocular"
        config["Training"]["monocular"] = self.monocular
        self.eval_rendering_on = config["Results"].get("eval_rendering", False)

        if dataset is None:
            dataset = load_dataset(config, device=self.device)
        self.dataset = dataset

        self.intr = intrinsics_from_config(config)
        self.render_cfg = render_config_from_config(config, self.intr)
        self.track_render_cfg = track_render_config(config, self.render_cfg)
        self.tcfg = track_config_from_config(config)
        self.mcfg = map_config_from_config(config)
        self.hyper = map_hyper_from_config(config)

        rc = config.get("Renderer", {})
        gaussians = gm.new_map(rc.get("map_capacity", 1 << 17),
                               sh_degree=self.render_cfg.sh_degree,
                               device=self.device)
        self.frontend_queue = queue.Queue()
        self.backend_queue = queue.Queue()
        self.frontend = FrontEnd(
            config, dataset, self.intr, self.track_render_cfg, self.tcfg,
            self.frontend_queue, self.backend_queue, save_dir=save_dir,
            device=self.device, draws=draws)
        self.backend = BackEnd(
            config, gaussians, self.intr, self.render_cfg, self.mcfg,
            self.hyper, self.frontend_queue, self.backend_queue,
            insert_cap=rc.get("insert_cap", 32768), draws=draws)
        self.frontend.gaussians = gaussians
        self.metrics = MetricsLogger(
            save_dir=save_dir,
            use_wandb=config["Results"].get("use_wandb", False))
        self.frontend.metrics = self.metrics
        self.eval_s = 0.0  # wall-clock of the two rendering evals

    def _backend_main(self):
        # an exception in the backend thread must reach the frontend, which
        # otherwise waits forever for acknowledgements that never come
        try:
            self.backend.run()
        except BaseException as e:  # noqa: BLE001 - forwarded, not swallowed
            Log(f"Backend thread FAILED: {type(e).__name__}: {e}", tag="Error")
            self.frontend_queue.put(["backend_failed", e])

    def _stop_backend(self, thread: threading.Thread):
        """Stop the backend and join it; never return with it alive."""
        self.backend_queue.put(["stop"])
        thread.join(timeout=60)
        if thread.is_alive():
            # a backend inside a long mapping call: a live thread left
            # behind would race whatever the caller runs next, so wait
            Log("Backend still busy after 60s; waiting up to 30 min for it "
                "to drain", tag="Warn")
            thread.join(timeout=1740)
            if thread.is_alive():
                raise RuntimeError(
                    "backend thread failed to stop within 30 min of the "
                    "stop message — refusing to return with a live "
                    "backend racing the caller")
        Log("Backend stopped and joined the main thread")

    def _refine_and_sync(self):
        """Colour refinement in the backend; returns its final map."""
        while not self.frontend_queue.empty():
            self.frontend_queue.get()
        self.backend_queue.put(["color_refinement"])
        while True:
            if self.frontend_queue.empty():
                time.sleep(0.01)
                continue
            data = self.frontend_queue.get()
            if data[0] == "backend_failed":
                raise RuntimeError("backend thread failed") from data[1]
            if data[0] == "sync_backend" and self.frontend_queue.empty():
                return data[1]

    def run(self) -> dict:
        backend_thread = threading.Thread(target=self._backend_main,
                                          name="monogs-backend", daemon=True)
        t0 = time.time()
        backend_thread.start()
        try:
            self.frontend.run()
            self.backend_queue.put(["pause"])
            elapsed = time.time() - t0
            results = self._results(elapsed)
        finally:
            self._stop_backend(backend_thread)
        results["stages"] = self.stage_summary()
        self.results = results
        return results

    def stage_summary(self) -> dict:
        """{stage: (total_seconds, count)}: the backend's stages, the
        frontend's tracking, and the rendering eval."""
        fe = self.frontend.timers
        out = self.backend.stage_summary()
        out["tracking"] = (fe.totals["tracking"], fe.total_counts["tracking"])
        if self.eval_s:
            out["eval"] = (self.eval_s, 2)
        return out

    def _results(self, elapsed) -> dict:
        n_frames = len(self.frontend.cameras)
        fps = n_frames / max(elapsed, 1e-9)
        Log("Total time", elapsed, tag="Eval")
        Log("Total FPS", fps, tag="Eval")
        self.fps = fps
        self.elapsed = elapsed
        results = {"fps": fps, "n_frames": n_frames}
        if not self.eval_rendering_on:
            return results

        from ..eval.ate import eval_ate
        from ..eval.rendering import eval_rendering

        self.gaussians = self.frontend.gaussians
        kf_indices = self.frontend.kf_indices
        ate = eval_ate(self.frontend.cameras, kf_indices, self.save_dir, 0,
                       final=True, monocular=self.monocular)
        t_eval = time.time()
        before = eval_rendering(
            self.frontend.cameras, self.gaussians, self.dataset,
            self.save_dir, self.intr, self.render_cfg, kf_indices,
            iteration="before_opt")
        t_eval = time.time() - t_eval
        self.gaussians = self._refine_and_sync()
        t1 = time.time()
        after = eval_rendering(
            self.frontend.cameras, self.gaussians, self.dataset,
            self.save_dir, self.intr, self.render_cfg, kf_indices,
            iteration="after_opt")
        self.eval_s = t_eval + time.time() - t1
        results.update({"ate": ate, "before": before, "after": after})
        cols = ["tag", "psnr", "ssim", "lpips", "RMSE ATE", "FPS"]
        self.metrics.log_table("metrics_table", cols, [
            ["Before", before["mean_psnr"], before["mean_ssim"],
             before["mean_lpips"], ate, fps],
            ["After", after["mean_psnr"], after["mean_ssim"],
             after["mean_lpips"], ate, fps],
        ])
        self.metrics.finish()
        if self.save_dir is not None:
            from ..models.ply import save_ply

            save_ply(self.gaussians, os.path.join(
                self.save_dir, "point_cloud", "final", "point_cloud.ply"))
        return results
