"""One full-size tracked frame through the JAX package and the PyTorch/CUDA
port (monogs_tpu_torch), on the same map and frame with the same random
draws.

    JAX_PLATFORMS=cpu python scripts/port_frame_parity.py [--seed 0]

Draws ``chip_smoke.make_bench``'s scene from ``--seed`` (100k Gaussians,
640x480, k_fine 96), renders frame 2 of its mono chain with the port, and
tracks it from frame 1's true pose with both packages: the JAX package's
Pallas kernels in interpret mode, its random draws replayed into the port.
Prints each package's pose error and iteration counts. It runs on a CPU
(the GPU machine has no JAX); a full-size interpret-mode frame takes
minutes and several GiB.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
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


def track_both(scene, intr, cfg, tcfg, poses_fn):
    """Frame 2 of the mono chain, seeded with frame 1's true pose."""
    from monogs_tpu.render import Intrinsics as JIntr
    from monogs_tpu.render import RenderConfig as JCfg
    from monogs_tpu.render.renderer import GaussianArrays as JGauss
    from monogs_tpu.slam import tracking as jt
    from monogs_tpu.slam.frame import make_frame_data as jframe
    from monogs_tpu_torch.ops import se3
    from monogs_tpu_torch.render.renderer import _tile_origins
    from monogs_tpu_torch.slam import tracking as tt
    from tests.test_torch_tracking import replay_draws

    poses = poses_fn(3, 42)
    frame = cs.render_frames(torch, scene, poses[2:], intr, cfg, False)[0][0]
    jg = JGauss(**{k: jnp.asarray(v.numpy())
                   for k, v in scene._asdict().items()})
    jc = JCfg(**{**cfg._asdict(), "pallas_interpret": True})
    jtc = jt.TrackConfig(**tcfg._asdict())
    key = jax.random.PRNGKey(1)
    a = jt.track_frame(
        jg, jframe(jnp.asarray(frame.gt_image.numpy()), None, 1.1, 0.01,
                   "tum"),
        jnp.asarray(poses[1].numpy()), jnp.float32(1.0), jnp.float32(0.0),
        key, JIntr(*intr), jc, jtc)
    n_fine = _tile_origins(intr, cfg, CPU)[0].shape[0]
    b = tt.track_frame(scene, frame, poses[1], 1.0, 0.0, None, intr, cfg,
                       tcfg, draws=replay_draws(key, n_fine, jtc))

    def err_mm(T):
        return 1000.0 * float(se3.pose_diff(T, poses[2])[0])

    return dict(
        jax_err_mm=err_mm(torch.from_numpy(np.array(a.T))),
        port_err_mm=err_mm(b.T), seed_err_mm=err_mm(poses[1]),
        iters_jax=[int(a.fo_iters), int(a.so_iters)],
        iters_port=[b.fo_iters, b.so_iters])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="scene seed")
    args = ap.parse_args()
    intr, cfg, tcfg, scene, poses_fn = cs.make_bench(torch, CPU, args.seed)
    print(json.dumps({"seed": args.seed, **track_both(
        scene, intr, cfg._replace(with_n_touched=True), tcfg, poses_fn)}),
        flush=True)


if __name__ == "__main__":
    main()
