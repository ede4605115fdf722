#!/usr/bin/env python3
"""Do the JAX package and the port end alike on a shipped config's frames?

Run from the root of a checkout:

    JAX_PLATFORMS=cpu python3 scripts/port_shipped_witness.py \
        --config configs/rgbd/tum/fr1_desk.yaml [--motion stock|tum_like] \
        [--size 320x240] [--frames 16] [--policy shipped|sequence|live] \
        [--package jax|port] [--device cpu|cuda] [--backend xla]
        [--interpret] [--replay] [--refine]

The frames are written once under ``--out``, on the CPU (a recorded
layout's on the card with ``--write-device cuda``, for runs of the port
alone; the scene is drawn on the CPU either way); every run reads those
files, so the packages and the devices see the same input.

- A recorded-dataset config (TUM, Replica, EuRoC): the stock synthetic
  sequence's scene (configs/synthetic/rgbd.yaml: seed 0, 8192 Gaussians,
  drawn on the CPU) on its orbit, at its own amplitudes (``stock``, 25 mm
  a frame) or at TUM's pace (``tum_like``, about 8 mm a frame), rendered
  at the config's calibration scaled to ``--size`` (the field of view
  stays) and written in the config's layout as ``chip_smoke.py``'s
  ``files_path`` writes it (JPEG by OpenCV, since nvJPEG needs the card).
  The config runs as ``files_path`` runs it (``chip_smoke.files_config``:
  its own keyframe policy and insertion, or the sequence's with
  ``--policy sequence``, or the live RGB-D config's with ``--policy
  live``; init 120 / mapping 30 BA iterations, single-thread, the
  capacities raised).
- A synthetic config (configs/synthetic/): the port's ``SyntheticDataset``
  of the config on the CPU, its first ``--frames`` frames stored as float
  arrays (``frames.npz``) and handed to both packages, and the config as
  ``chip_smoke.py``'s ``slam_path`` runs it (``SLAM_ITERS``' depth).

Each run skips the final colour refinement and the rendering evaluation
(they move no pose), unless ``--refine`` keeps both: the line then adds
the mean PSNR over the frames before and after the refinement.
``--replay`` hands the port the JAX package's random draws (its key
chains turned into the port's draws, as the CPU parity tests do with
``tests/test_torch_slam.py``'s ``JaxDraws``; the port on the CPU only),
so that with ``--backend xla`` the two runs differ by rounding alone.
The JAX package runs on the CPU, where it replaces
the configs' "pallas_lists" renderer by its "xla" one; the port keeps the
config's renderer, on the CPU (the plain versions of its kernels) or,
with ``--device cuda``, on the card (the card's machine has no JAX: pass
``--package port``). ``--backend`` sets ``Renderer.backend`` for both:
"xla" runs the port as the JAX package runs on the CPU. The two
renderers are not one algorithm: on "pallas_lists" the mapping gradient
of a BA iteration covers ``Renderer.mapping_tile_frac`` of the tiles and
the second order ``second_order.tile_frac`` of them; on "xla" both cover
every tile (the first order takes ``first_order.tile_frac`` on both).
``--interpret`` keeps "pallas_lists" in the JAX package on the CPU, its
Pallas kernels in interpret mode (``Renderer.pallas_interpret``), so that
both packages run one algorithm. One JSON line per run: keyframes,
keyframe ATE, ATE over every frame, the ATE of holding the first pose
(the RMS distance of the true camera centres from their mean: no
constant trajectory does better), the map's active count, seconds, and
the overlap (visibility IoU against the last keyframe) behind each
keyframe decision taken while the window is below ``window_size``.
Monocular runs align under Sim(3), the others under SE(3).

A 16-frame run at 320x240 takes 4-20 minutes a package on one or two
CPU threads and 1-3 GB (the JAX package's "xla" renderer the slowest).
``--write-only`` writes the frames and runs nothing, so that the runs
can go in parallel processes.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# --policy: whose keyframe policy and insertion replace the config's own
POLICIES = {"sequence": "configs/synthetic/rgbd.yaml",
            "live": "configs/live/realsense_rgbd.yaml"}


def scale_calibration(calib, width, height):
    """The calibration at ``width`` x ``height``: focal lengths and
    principal points scaled (pixel centres kept), distortion unchanged."""
    sx, sy = width / calib["width"], height / calib["height"]
    for c in [calib] + [calib[cam][k] for cam in ("cam0", "cam1")
                        if cam in calib for k in ("raw", "opt")]:
        c["fx"], c["fy"] = c["fx"] * sx, c["fy"] * sy
        c["cx"] = (c["cx"] + 0.5) * sx - 0.5
        c["cy"] = (c["cy"] + 0.5) * sy - 0.5
    calib.update(width=width, height=height)


def witness_config(file, size, policy, backend=None, interpret=False,
                   refine=False):
    """(config, synthetic?) as chip_smoke.py runs ``file``, at ``size``
    (None: the config's own), without the final refinement unless
    ``refine``, on ``backend`` (None: the config's renderer), the JAX
    package's Pallas kernels in interpret mode with ``interpret``."""
    import chip_smoke as cs

    cfg = cs.load_yaml_config(file)
    synthetic = cfg["Dataset"]["type"] == "synthetic"
    if synthetic:
        cfg["Training"].update(cs.SLAM_ITERS)
    else:
        cfg = cs.files_config(file, "own")
    if policy != "shipped":
        cs.take_policy(cfg, POLICIES[policy])
    if size is not None:
        scale_calibration(cfg["Dataset"]["Calibration"], *size)
    if backend is not None:
        cfg.setdefault("Renderer", {})["backend"] = backend
    if interpret:
        cfg.setdefault("Renderer", {})["pallas_interpret"] = True
    if not refine:
        cfg["Training"]["refinement_itr"] = 0
    cfg["Results"].update(save_results=False, eval_rendering=refine,
                          use_gui=False)
    return cfg, synthetic


def frames_dir(out, file, motion, size, frames, policy, device="cpu"):
    calib = witness_config(file, size, policy)[0]["Dataset"]["Calibration"]
    return out / (f"{Path(file).stem}_{motion}_{calib['width']}x"
                  f"{calib['height']}_{frames}"
                  + ("" if device == "cpu" else f"_{device}"))


class NpzFrames:
    """``frames.npz``'s frames: (image [3, H, W], depth [H, W] or None,
    pose [4, 4]) as numpy."""

    def __init__(self, path, with_depth):
        import numpy as np

        z = np.load(path)
        self.images, self.poses = z["images"], z["poses"]
        self.depths = z["depths"] if with_depth else None

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        depth = None if self.depths is None else self.depths[idx]
        return self.images[idx], depth, self.poses[idx]


def write_frames(cfg, synthetic, root, motion, n_frames, device="cpu"):
    import numpy as np
    import torch

    root.mkdir(parents=True, exist_ok=True)
    if synthetic:
        from monogs_tpu_torch.data import load_dataset

        c = copy.deepcopy(cfg)
        c["Dataset"]["synthetic"]["motion"] = (
            "tum_like" if motion == "tum_like" else "orbit")
        c["Dataset"]["sensor_type"] = "depth"
        # on the CPU, whose generator draws the scene
        ds = load_dataset(c, device="cpu")
        frames = [ds[i] for i in range(n_frames)]
        np.savez(root / "frames.npz",
                 images=np.stack([f[0].numpy() for f in frames]),
                 depths=np.stack([f[1].numpy() for f in frames]),
                 poses=np.stack([f[2].numpy() for f in frames]))
        return
    import cv2

    import chip_smoke as cs

    def jpg(path, rgb):
        rgb = rgb.cpu().numpy() if isinstance(rgb, torch.Tensor) else rgb
        assert cv2.imwrite(path, np.ascontiguousarray(rgb[..., ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, 95])

    scene, poses = cs.files_sequence(torch, device, n_frames,
                                     "stock" if motion == "stock"
                                     else "tum_like")
    with torch.no_grad():
        cs.write_files(torch, copy.deepcopy(cfg), root, scene, poses, jpg)
    (root / "written").write_text("ok\n")


def ates(cameras, kf_indices, monocular):
    import numpy as np
    import torch

    from monogs_tpu_torch.eval.ate import evaluate_ate

    def wc(T):
        if isinstance(T, torch.Tensor):
            T = T.detach().cpu()
        return np.linalg.inv(np.asarray(T, np.float64))

    ids = sorted(cameras)
    gt = {i: wc(cameras[i].T_gt) for i in ids}
    est = {i: wc(cameras[i].T) for i in ids}
    c = np.stack([gt[i][:3, 3] for i in ids])
    return dict(
        ate_keyframes=float(evaluate_ate([gt[i] for i in kf_indices],
                                         [est[i] for i in kf_indices],
                                         monocular=monocular)[0]),
        ate_frames=float(evaluate_ate([gt[i] for i in ids],
                                      [est[i] for i in ids],
                                      monocular=monocular)[0]),
        hold_first_ate=float(np.sqrt(((c - c.mean(0)) ** 2).sum(1).mean())))


def run(package, cfg, synthetic, root, device, tags, replay=False):
    cfg = copy.deepcopy(cfg)
    monocular = cfg["Dataset"]["sensor_type"] == "monocular"
    dataset = None
    if synthetic:
        dataset = NpzFrames(root / "frames.npz", not monocular)
    else:
        cfg["Dataset"]["dataset_path"] = str(root)
    from chip_smoke import overlaps_logged

    if package == "jax":
        from monogs_tpu.slam import frontend
        from monogs_tpu.slam.runtime import SLAM
    else:
        from monogs_tpu_torch.slam import frontend
        from monogs_tpu_torch.slam.runtime import SLAM
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as save_dir, \
            overlaps_logged(frontend) as overlaps:
        if package == "jax":
            slam = SLAM(cfg, dataset=dataset, save_dir=save_dir)
        elif replay:
            from tests.test_torch_slam import port_slam

            slam = port_slam(cfg, dataset=dataset, replay=True)
            slam.save_dir = save_dir
        else:
            slam = SLAM(cfg, dataset=dataset, device=device,
                        save_dir=save_dir)
        res = slam.run() or {}
    fe = slam.frontend
    psnr = {k: float(res[k]["mean_psnr"]) for k in ("before", "after")
            if k in res}
    print(json.dumps(dict(
        package=package, device=device if package == "port" else "cpu",
        **tags, backend=slam.render_cfg.backend, frames=len(fe.cameras),
        keyframes=list(fe.kf_indices),
        n_active=int(slam.backend.gaussians.n_active),
        seconds=time.perf_counter() - t0,
        **ates(fe.cameras, fe.kf_indices, monocular), psnr=psnr,
        overlaps=overlaps)), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True,
                    help="a config under configs/ (relative to the root)")
    ap.add_argument("--motion", choices=("stock", "tum_like"),
                    default="tum_like")
    ap.add_argument("--size", help="WIDTHxHEIGHT (default: the config's)")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--policy", choices=("shipped",) + tuple(POLICIES),
                    default="shipped",
                    help="the config's own keyframe policy and insertion, "
                         "or those of configs/synthetic/rgbd.yaml "
                         "(sequence) or configs/live/realsense_rgbd.yaml "
                         "(live)")
    ap.add_argument("--package", choices=("jax", "port"), action="append")
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--interpret", action="store_true",
                    help="the JAX package's Pallas kernels in interpret "
                         "mode instead of its \"xla\" renderer on the CPU")
    ap.add_argument("--backend", help="Renderer.backend of both packages "
                    "(default: the config's)")
    ap.add_argument("--replay", action="store_true",
                    help="the port takes the JAX package's random draws "
                         "(the port on the CPU)")
    ap.add_argument("--refine", action="store_true",
                    help="keep the colour refinement and the PSNR before "
                         "and after it")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", default=str(ROOT / "build" / "shipped_witness"))
    ap.add_argument("--write-device", default="cpu",
                    help="where the frames are rendered (cuda: for runs of "
                         "the port alone)")
    ap.add_argument("--write-only", action="store_true")
    args = ap.parse_args()
    import torch

    torch.set_num_threads(args.threads)
    size = (None if args.size is None
            else tuple(int(v) for v in args.size.split("x")))
    if args.replay and args.device != "cpu":
        ap.error("--replay runs the port on the CPU")
    cfg, synthetic = witness_config(args.config, size, args.policy,
                                    args.backend, args.interpret,
                                    args.refine)
    root = frames_dir(Path(args.out), args.config, args.motion, size,
                      args.frames, args.policy, args.write_device)
    done = root / ("frames.npz" if synthetic else "written")
    if not done.exists():
        write_frames(cfg, synthetic, root, args.motion, args.frames,
                     args.write_device)
    if args.write_only:
        return
    calib = cfg["Dataset"]["Calibration"]
    tags = dict(config=args.config, motion=args.motion, policy=args.policy,
                interpret=args.interpret, replay=args.replay,
                width=calib["width"], height=calib["height"])
    for package in args.package or ("jax", "port"):
        run(package, cfg, synthetic, root, args.device, tags, args.replay)


if __name__ == "__main__":
    main()
