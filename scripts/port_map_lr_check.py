#!/usr/bin/env python3
"""Window BA from an exact and from a perturbed geometry (PyTorch port).

Run from the root of a checkout:

    python3 scripts/port_map_lr_check.py [--device cuda] [--views 3]
                                          [--iters 35]
    JAX_PLATFORMS=cpu python3 scripts/port_map_lr_check.py --jax \\
        --views 2 --iters 2

On ``chip_smoke.py``'s scene and frames, maps a window of ``--views``
frames from iteration 190 (the densify at 200 included, from 10
iterations on) at tile_frac 0.25 in three cases, and prints one JSON line
per case with the window's mapping L1 before and after:

- ``exact_geometry``: SH and opacity logits perturbed, positions exact;
- ``exact_geometry_position_lr_0``: the same with the position learning
  rate at 1e-12 (nothing else changed);
- ``perturbed_geometry``: ``chip_smoke.map_window``'s window (positions
  also perturbed, by ``chip_smoke.MAP_XYZ_NOISE``).

It shows whether the reference's position learning rate (9.2e-3 per Adam
step at iteration 190) raises the L1 of an accurate map at this
resolution. ``--device cpu`` runs the kernels' plain versions (minutes).

``--jax`` runs the ``exact_geometry`` case instead through both the JAX
package (on the CPU, its Pallas kernels in interpret mode) and the port
(on the CPU), from the same map and window with the JAX random draws
replayed into the port, and prints the L1 after each, both measured with
the port's render: whether the reference shows the same rise. It needs
JAX and takes minutes and several GiB.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

IT0 = 190


def jax_and_port(m, cams, iters, intr, cfg, mc, hyper):
    """map_iters of the JAX package and of the port from ``m`` and
    ``cams`` (on the CPU), the JAX draws replayed into the port; returns
    both results as the port's (map, cams)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from monogs_tpu.models import gaussian_map as jgm
    from monogs_tpu.render import Intrinsics as JIntr
    from monogs_tpu.render import RenderConfig as JCfg
    from monogs_tpu.slam import mapping as jmap
    from monogs_tpu_torch.convert import map_from_numpy
    from monogs_tpu_torch.render.renderer import _tile_origins
    from monogs_tpu_torch.slam import mapping as mp
    from tests.test_torch_mapping import replay_map_draws

    def to_jax(x):
        if isinstance(x, tuple):
            return type(x)(*(to_jax(y) for y in x))
        return jnp.asarray(x.cpu().numpy())

    jm = jgm.GaussianMap(*(
        jgm.ParamLeaves(*(to_jax(y) for y in x)) if isinstance(x, tuple)
        else to_jax(x) for x in m))
    jmc = jmap.MapConfig(**mc._asdict())
    key = jax.random.PRNGKey(0)
    a = jmap.map_iters(
        jm, jmap.CamBatch(*(to_jax(x) for x in cams)), iters,
        jnp.int32(IT0), key, JIntr(*intr),
        JCfg(**{**cfg._asdict(), "pallas_interpret": True}), jmc,
        jgm.MapHyper())
    jax_m = map_from_numpy(*(
        [np.asarray(y) for y in x] if isinstance(x, tuple) else np.asarray(x)
        for x in a[0]), device="cpu")
    jax_cams = cams._replace(**{k: torch.from_numpy(np.array(getattr(a[1], k)))
                                for k in ("T", "ea", "eb")})
    n_fine = _tile_origins(intr, cfg, "cpu")[0].shape[0]
    b = mp.map_iters(m, cams, iters, IT0, None, intr, cfg, mc, hyper,
                     draws=replay_map_draws(key, iters, cams.T.shape[0],
                                            n_fine, jmc))
    return (jax_m, jax_cams), (b.m, b.cams)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--views", type=int, default=3)
    ap.add_argument("--iters", type=int, default=35)
    ap.add_argument("--jax", action="store_true",
                    help="the exact-geometry case through the JAX package "
                    "and the port, on the CPU")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from monogs_tpu_torch import resolve_device
    from monogs_tpu_torch.models import gaussian_map as gm
    from monogs_tpu_torch.slam import mapping as mp

    dev = resolve_device("cpu" if args.jax else args.device)
    intr, cfg, _, scene, poses_fn = cs.make_bench(torch, dev)
    poses = poses_fn(args.views, 42)
    frames, _ = cs.render_frames(torch, scene, poses, intr, cfg,
                                 with_depth=True)
    mc = mp.MapConfig(monocular=True, window_size=8, pose_window=5,
                      tile_frac=0.25)
    hyper = gm.MapHyper()
    exact = cs.map_window(torch, scene, frames, poses, views=args.views,
                          xyz_noise=0.0)

    def line(**kw):
        print(json.dumps(dict(device=str(dev), views=args.views,
                              iters=args.iters, **kw)), flush=True)

    if args.jax:
        m, cams = exact
        before = cs.window_l1(torch, m, cams, intr, cfg)
        t0 = time.perf_counter()
        res = jax_and_port(m, cams, args.iters, intr, cfg, mc, hyper)
        after = [cs.window_l1(torch, *r, intr, cfg) for r in res]
        dxyz = torch.abs(res[0][0].params.xyz
                         - res[1][0].params.xyz).max(-1).values[m.active]
        line(case="exact_geometry_jax_and_port", l1_before=before,
             l1_after_jax=after[0], l1_after_port=after[1],
             xyz_max_abs_diff=float(dxyz.max()),
             xyz_share_over_1mm=float((dxyz > 1e-3).float().mean()),
             seconds=time.perf_counter() - t0)
        return

    frozen = hyper._replace(position_lr_init=1e-12, position_lr_final=1e-12)
    perturbed = cs.map_window(torch, scene, frames, poses, views=args.views)
    for name, (m, cams), h in (
            ("exact_geometry", exact, hyper),
            ("exact_geometry_position_lr_0", exact, frozen),
            ("perturbed_geometry", perturbed, hyper)):
        gen = torch.Generator(device=dev).manual_seed(0)
        before = cs.window_l1(torch, m, cams, intr, cfg)
        t0 = time.perf_counter()
        r = mp.map_iters(m, cams, args.iters, IT0, gen, intr, cfg, mc, h)
        after = cs.window_l1(torch, r.m, r.cams, intr, cfg)
        line(case=name, l1_before=before, l1_after=after,
             ratio=after / before, seconds=time.perf_counter() - t0)


if __name__ == "__main__":
    main()
