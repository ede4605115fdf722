"""Full-size tracked frames through the JAX package and the PyTorch/CUDA
port (monogs_tpu_torch), on the same map and frames with the same random
draws.

    JAX_PLATFORMS=cpu python scripts/port_frame_parity.py [--seed 0] \
        [--frames 1]

Draws ``chip_smoke.make_bench``'s scene from ``--seed`` (100k Gaussians,
640x480, k_fine 96), renders frames 2 to ``--frames`` + 1 of its mono
chain with the port, and tracks them in order with both packages, as
``chip_smoke.track_chain`` does: frame 2 from frame 1's true pose, each
later frame from the pose the same package tracked for the frame before.
The JAX package runs its Pallas kernels in interpret mode, and each
frame's random draws (``PRNGKey(frame)``) are replayed into the port.
Prints one JSON line a frame as it is tracked: each package's pose error,
the distance between the two packages' poses, the error of holding the
previous true pose, iteration counts and seconds. It runs on a CPU (the
GPU machine has no JAX); a full-size interpret-mode frame takes minutes
and several GiB.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

CPU = torch.device("cpu")


def track_both(scene, intr, cfg, tcfg, poses_fn, n_frames=1):
    """Frames 2 .. n_frames + 1 of the mono chain, frame 2 seeded with
    frame 1's true pose and each later one with its package's pose of the
    frame before; yields one dict a frame."""
    from monogs_tpu.render import Intrinsics as JIntr
    from monogs_tpu.render import RenderConfig as JCfg
    from monogs_tpu.render.renderer import GaussianArrays as JGauss
    from monogs_tpu.slam import tracking as jt
    from monogs_tpu.slam.frame import make_frame_data as jframe
    from monogs_tpu_torch.ops import se3
    from monogs_tpu_torch.render.renderer import _tile_origins
    from monogs_tpu_torch.slam import tracking as tt
    from tests.test_torch_tracking import replay_draws

    poses = poses_fn(n_frames + 2, 42)
    frames = cs.render_frames(torch, scene, poses[2:], intr, cfg, False)[0]
    jg = JGauss(**{k: jnp.asarray(v.numpy())
                   for k, v in scene._asdict().items()})
    jc = JCfg(**{**cfg._asdict(), "pallas_interpret": True})
    jtc = jt.TrackConfig(**tcfg._asdict())
    n_fine = _tile_origins(intr, cfg, CPU)[0].shape[0]
    T_jax = T_port = poses[1]
    for j, frame in enumerate(frames):
        i = j + 2
        key = jax.random.PRNGKey(i - 1)

        def err_mm(T):
            return 1000.0 * float(se3.pose_diff(T, poses[i])[0])

        t0 = time.perf_counter()
        a = jt.track_frame(
            jg, jframe(jnp.asarray(frame.gt_image.numpy()), None, 1.1, 0.01,
                       "tum"),
            jnp.asarray(T_jax.numpy()), jnp.float32(1.0), jnp.float32(0.0),
            key, JIntr(*intr), jc, jtc)
        a_T = torch.from_numpy(np.array(a.T))
        t1 = time.perf_counter()
        b = tt.track_frame(scene, frame, T_port, 1.0, 0.0, None, intr, cfg,
                           tcfg, draws=replay_draws(key, n_fine, jtc))
        t2 = time.perf_counter()
        dt, dr = se3.pose_diff(b.T, a_T)
        yield dict(
            frame=i, jax_err_mm=err_mm(a_T), port_err_mm=err_mm(b.T),
            between_mm=1000.0 * float(dt), between_mrad=1000.0 * float(dr),
            seed_err_mm=err_mm(T_jax), port_seed_err_mm=err_mm(T_port),
            hold_prev_err_mm=err_mm(poses[i - 1]),
            iters_jax=[int(a.fo_iters), int(a.so_iters)],
            iters_port=[b.fo_iters, b.so_iters], jax_s=t1 - t0,
            port_s=t2 - t1)
        T_jax, T_port = a_T, b.T


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="scene seed")
    ap.add_argument("--frames", type=int, default=1,
                    help="frames of the chain to track (from frame 2)")
    args = ap.parse_args()
    intr, cfg, tcfg, scene, poses_fn = cs.make_bench(torch, CPU, args.seed)
    for out in track_both(scene, intr, cfg._replace(with_n_touched=True),
                          tcfg, poses_fn, args.frames):
        print(json.dumps({"seed": args.seed, **out}), flush=True)


if __name__ == "__main__":
    main()
