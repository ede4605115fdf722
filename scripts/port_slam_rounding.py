#!/usr/bin/env python3
"""How far rounding differences carry through a SLAM run (CPU, JAX).

Run from the root of a checkout, on a machine with JAX on the CPU:

    JAX_PLATFORMS=cpu python3 scripts/port_slam_rounding.py ba
    JAX_PLATFORMS=cpu python3 scripts/port_slam_rounding.py slam [--orbit6]

``ba``: the init BA of ``tests/test_slam_e2e.py::tiny_config``'s first
keyframe (inserted by the JAX package) through the JAX package's
``map_iters`` and the port's (the JAX draws replayed), and through the
port again from positions moved by 1e-7 m; after 1, 3, 10 and 20
iterations, the largest, 99th-percentile and median per-Gaussian position
distance of each pair (port against JAX, port against moved port).

``slam``: a ``single_thread`` SLAM run of ``tests/test_torch_slam.py``'s
trimmed tiny_config (init 20, mapping 5, first order 10, second order 2)
on the first six frames of its 12-frame orbit, or with ``--orbit6`` on a
6-frame orbit of the same amplitudes (twice the motion a frame), through
the JAX package, the port, and the port on the depth moved by 1e-6 m (4
ulps at 3.5 m), the JAX draws replayed into both port runs. One JSON line
per run (keyframes, the overlap ratio behind each keyframe decision,
``n_active``, keyframe ATE), then the largest per-frame pose distance
(m, rad) of the port from the JAX run and from its moved run.

Minutes on 4 threads; each SLAM run a few hundred MB.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def leaves_np(m):
    import numpy as np

    return [[np.asarray(y) for y in x] if isinstance(x, tuple)
            else np.asarray(x) for x in m]


def ba():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from monogs_tpu.data.datasets import load_dataset
    from monogs_tpu.models import gaussian_map as jgm
    from monogs_tpu.models.insertion import keyframe_to_gaussians
    from monogs_tpu.slam import mapping as jmap
    from monogs_tpu.slam import runtime as jrt
    from monogs_tpu.slam.frame import make_frame_data
    from monogs_tpu_torch import convert
    from monogs_tpu_torch.slam import mapping as tmap
    from monogs_tpu_torch.slam import runtime as trt
    from tests.test_torch_slam import JaxDraws, NumpyDataset, trimmed_config

    cfg = trimmed_config("depth")
    cfg["Training"]["monocular"] = False
    img, depth, pose = NumpyDataset(load_dataset(cfg), n=1)[0]
    intr = jrt.intrinsics_from_config(cfg)
    rc = jrt.render_config_from_config(cfg, intr)
    mc, hy = jrt.map_config_from_config(cfg), jrt.map_hyper_from_config(cfg)
    fd = make_frame_data(img, depth, 1.1, 0.01, "synthetic")
    leaves, count = keyframe_to_gaussians(
        jax.random.PRNGKey(5), fd.gt_image, jnp.asarray(depth),
        jnp.asarray(pose), jnp.float32(1), jnp.float32(0), intr=intr,
        cap=4096, sh_k=1, downsample_factor=4, point_size=0.05,
        adaptive_pointsize=True)
    m = jgm.insert(jgm.new_map(16384), leaves, count, 0)
    no = jnp.array([False])
    cams = jmap.CamBatch(
        gt_image=fd.gt_image[None], gt_depth=fd.gt_depth[None],
        mapping_mask=fd.mapping_mask[None], T=jnp.asarray(pose)[None],
        ea=jnp.ones(1), eb=jnp.zeros(1), valid=~no, opt_pose=no,
        opt_exposure=no)
    ti = trt.intrinsics_from_config(cfg)
    trc = trt.render_config_from_config(cfg, ti)
    tmc, thy = trt.map_config_from_config(cfg), trt.map_hyper_from_config(cfg)
    tm = convert.map_from_numpy(*leaves_np(m), device="cpu")
    gen = torch.Generator().manual_seed(0)
    tm2 = tm._replace(params=tm.params._replace(
        xyz=tm.params.xyz + 1e-7 * torch.randn(tm.params.xyz.shape,
                                               generator=gen)))
    tcams = convert.cams_from_numpy(*leaves_np(cams), device="cpu")
    key = jax.random.PRNGKey(7)

    def port(m0, n):
        draws = JaxDraws(ti, trc, trt.track_config_from_config(cfg), trc, tmc)
        draws._backend_key = lambda: key        # the key map_iters got
        return tmap.map_iters(m0, tcams, n, 0, None, ti, trc, tmc, thy,
                              initialization=True,
                              draws=draws.map(n, 1)).m

    def dist(xyz_a, xyz_b, active):
        d = np.abs(xyz_a - xyz_b)[active].max(axis=1)
        return dict(max=float(d.max()), p99=float(np.percentile(d, 99)),
                    median=float(np.median(d)), over_1mm=int((d > 1e-3).sum()))

    for n in (1, 3, 10, 20):
        a = jmap.map_iters(m, cams, n, jnp.int32(0), key, intr, rc, mc, hy,
                           initialization=True)[0]
        b, c = port(tm, n), port(tm2, n)
        act = b.active.numpy()
        print(json.dumps(dict(
            iters=n,
            port_vs_jax=dist(b.params.xyz.numpy(),
                             np.asarray(a.params.xyz), act),
            port_vs_moved_port=dist(b.params.xyz.numpy(),
                                    c.params.xyz.numpy(), act))), flush=True)


def slam(orbit6: bool):
    import numpy as np
    import torch

    from monogs_tpu.data.datasets import load_dataset
    from monogs_tpu.slam import frontend as jfrontend
    from monogs_tpu.slam.runtime import SLAM as JSLAM
    from monogs_tpu_torch.ops import se3
    from monogs_tpu_torch.slam import frontend as tfrontend
    from monogs_tpu_torch.eval.ate import evaluate_ate
    from tests.test_torch_slam import (
        NumpyDataset, kf_ate, logging_ratio, port_slam, trimmed_config,
    )

    cfg = trimmed_config("depth")
    if orbit6:
        cfg["Dataset"]["synthetic"]["n_frames"] = 6
    jcfg = copy.deepcopy(cfg)
    jcfg["Training"]["monocular"] = False
    frames = NumpyDataset(load_dataset(jcfg), n=6)
    moved = copy.deepcopy(frames)
    moved.frames = [(i, d + np.float32(1e-6), p) for i, d, p in moved.frames]

    ratio = (jfrontend.overlap_ratio, tfrontend.overlap_ratio)

    def run(name, make):
        log = []
        jfrontend.overlap_ratio = logging_ratio(ratio[0], log)
        tfrontend.overlap_ratio = logging_ratio(ratio[1], log)
        slam = make()
        slam.run()
        fe = slam.frontend
        print(json.dumps(dict(
            run=name, keyframes=fe.kf_indices, overlap_ratios=log,
            n_active=int(slam.backend.gaussians.n_active),
            kf_ate=kf_ate(fe, evaluate_ate))), flush=True)
        return {i: torch.from_numpy(np.array(f.T, np.float32))
                for i, f in fe.cameras.items()}

    try:
        a = run("jax", lambda: JSLAM(copy.deepcopy(jcfg), dataset=frames))
        b = run("port", lambda: port_slam(cfg, dataset=frames, replay=True))
        c = run("port_depth_moved_1e-6",
                lambda: port_slam(cfg, dataset=moved, replay=True))
    finally:
        jfrontend.overlap_ratio, tfrontend.overlap_ratio = ratio

    def dist(x, y):
        d = [se3.pose_diff(x[i], y[i]) for i in x]
        return [max(float(t) for t, _ in d), max(float(r) for _, r in d)]

    print(json.dumps(dict(orbit6=orbit6, port_vs_jax=dist(b, a),
                          port_vs_moved_port=dist(b, c))), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("ba", "slam"))
    ap.add_argument("--orbit6", action="store_true",
                    help="a 6-frame orbit instead of tiny_config's first "
                         "six frames")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    import torch

    torch.set_num_threads(args.threads)
    if args.what == "ba":
        ba()
    else:
        slam(args.orbit6)


if __name__ == "__main__":
    main()
