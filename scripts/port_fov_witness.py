#!/usr/bin/env python3
"""Does a wide field of view track the synthetic scene, in either package?

Run from the root of a checkout, on a machine with JAX on the CPU:

    JAX_PLATFORMS=cpu python3 scripts/port_fov_witness.py \
        [--package jax|port] [--view replica|fr1] [--frames 16] \
        [--size 300x170]

The stock synthetic sequence (configs/synthetic/rgbd.yaml: scene seed 0,
8192 Gaussians, its orbit) is rendered by the port on the CPU at Replica's
field of view cut to a quarter of office0's width (300x170, fx = fy = 150,
90 degrees across) and, as the control, at the same size with TUM fr1's
horizontal field of view (fx = fy = 242.4, 63.5 degrees). ``--size``
renders at another width and height with the same two fields of view
(the focal length scales with the width: 600x340 gives fx = fy = 300 for
Replica's 90 degrees), to tell what the width does. The frames are
written as a Replica layout with OpenCV (JPEG quality 95, 16-bit depth x
6553.5). SLAM then runs from those files on the CPU with
configs/rgbd/replica/office0.yaml as ``chip_smoke.py``'s ``files_path``
runs it (``files_config``: the sequence's keyframe policy and insertion,
init 120 / mapping 30 iterations, single-thread), without the final
refinement and rendering evaluation (they move no pose): through the JAX
package (its ``ReplicaDataset``, the "xla" renderer) and through the port
(its ``ReplicaDataset``, the plain versions of the kernels). One JSON line
per run: keyframes, keyframe ATE, ATE over every frame, and the ATE of
holding the first pose.

Each run takes minutes to tens of minutes on 4 threads and a few hundred
MB; ``--package`` and ``--view`` pick one run, so that runs can go in
parallel processes once ``--write-only`` has written the frames.
``--package port --device cuda`` runs the port on the card from frames
written on the CPU, to tell the card's arithmetic from the width.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (fx = fy) at 300x170, the principal point at the centre
VIEWS = {"replica": 150.0, "fr1": 242.4}
WIDTH, HEIGHT = 300, 170


def focal(view, width=WIDTH):
    """fx = fy of ``view`` at ``width``: the field of view stays."""
    return VIEWS[view] * width / WIDTH


def view_config(view, width=WIDTH, height=HEIGHT):
    from chip_smoke import files_config

    cfg = files_config("configs/rgbd/replica/office0.yaml", "sequence")
    f = focal(view, width)
    cfg["Dataset"]["Calibration"].update(
        width=width, height=height, fx=f, fy=f, cx=(width - 1) / 2,
        cy=(height - 1) / 2)
    cfg["Training"]["refinement_itr"] = 0
    cfg["Results"].update(save_results=False, eval_rendering=False)
    return cfg


def write_frames(cfg, root, n_frames):
    import cv2
    import numpy as np
    import torch

    from monogs_tpu_torch.data import layouts
    from monogs_tpu_torch.data.synthetic import (
        make_synthetic_scene, orbit_pose,
    )
    from monogs_tpu_torch.render import Intrinsics, RenderConfig, render
    from monogs_tpu_torch.slam.config import load_config

    syn = load_config(str(ROOT / "configs/synthetic/rgbd.yaml"))[
        "Dataset"]["synthetic"]
    scene = make_synthetic_scene(torch.Generator().manual_seed(syn["seed"]),
                                 n=syn["n_gauss"])
    c = cfg["Dataset"]["Calibration"]
    intr = Intrinsics(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"],
                      width=c["width"], height=c["height"])
    colors, depths, poses = [], [], []
    for i in range(n_frames):
        T = orbit_pose(i / syn["n_frames"], syn["trans_amp"], syn["rot_amp"],
                       device="cpu")
        out = render(scene, T, intr, RenderConfig(backend="pallas_lists",
                                                  k_fine=512))
        img = out.image.clamp(0, 1).permute(1, 2, 0)
        colors.append((img * 255).round().to(torch.uint8).numpy())
        depths.append(out.depth[0].numpy())
        poses.append(T.double().numpy())

    def jpg(path, rgb):
        assert cv2.imwrite(path, np.ascontiguousarray(rgb[..., ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, 95])

    def png(path, a):
        assert cv2.imwrite(path, a)

    layouts.write_replica(str(root), colors, depths, poses,
                          c["depth_scale"], jpg, png)
    cfg["Dataset"]["dataset_path"] = str(root)


def ates(cameras, kf_indices):
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
    hold = float(np.sqrt(((c - c.mean(0)) ** 2).sum(1).mean()))
    return dict(
        ate_keyframes=float(evaluate_ate([gt[i] for i in kf_indices],
                                         [est[i] for i in kf_indices])[0]),
        ate_frames=float(evaluate_ate([gt[i] for i in ids],
                                      [est[i] for i in ids])[0]),
        hold_first_ate=hold)


def frames_dir(out_dir, view, n_frames, width=WIDTH, height=HEIGHT):
    size = "" if (width, height) == (WIDTH, HEIGHT) else f"_{width}x{height}"
    return out_dir / f"{view}_{n_frames}{size}"


def run(package, view, n_frames, out_dir, device="cpu", width=WIDTH,
        height=HEIGHT):
    cfg = view_config(view, width, height)
    cfg["Dataset"]["dataset_path"] = str(
        frames_dir(out_dir, view, n_frames, width, height))
    t0 = time.perf_counter()
    if package == "jax":
        from monogs_tpu.slam.runtime import SLAM

        slam = SLAM(copy.deepcopy(cfg))
    else:
        from monogs_tpu_torch.slam.runtime import SLAM

        slam = SLAM(copy.deepcopy(cfg), device=device)
    slam.run()
    fe = slam.frontend
    print(json.dumps(dict(package=package, device=device, view=view,
                          fx=focal(view, width),
                          width=width, height=height, frames=len(fe.cameras),
                          keyframes=list(fe.kf_indices),
                          seconds=time.perf_counter() - t0,
                          **ates(fe.cameras, fe.kf_indices))), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "port"), action="append")
    ap.add_argument("--view", choices=tuple(VIEWS), action="append")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--size", default=f"{WIDTH}x{HEIGHT}",
                    help="WIDTHxHEIGHT of the frames (the field of view "
                         "stays)")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", default=str(ROOT / "build" / "fov_witness"))
    ap.add_argument("--device", default="cpu",
                    help="the port's device (cuda runs it on the card from "
                         "the frames written on the CPU)")
    ap.add_argument("--write-only", action="store_true",
                    help="write the frames of each view, run nothing")
    args = ap.parse_args()
    import torch

    torch.set_num_threads(args.threads)
    width, height = (int(v) for v in args.size.split("x"))
    out_dir = Path(args.out)
    for view in args.view or tuple(VIEWS):
        root = frames_dir(out_dir, view, args.frames, width, height)
        if not (root / "traj.txt").exists():
            write_frames(view_config(view, width, height), root, args.frames)
        if args.write_only:
            continue
        for package in args.package or ("jax", "port"):
            run(package, view, args.frames, out_dir, args.device, width,
                height)


if __name__ == "__main__":
    main()
