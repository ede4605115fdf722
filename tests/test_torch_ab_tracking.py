"""The tracking A/B branches against the JAX package, at the sizes of
test_torch_mapping.py (64x48, 300 Gaussians in a map of capacity 1024,
k_fine 128), with the JAX random draws replayed (first-order tile subset
where there is one, second-order tile subset on the fast path, one sketch
per second-order iteration):

- "xla" with ``bin_margin`` 0 (each render bins at its pose) and with 4
  (full-frame first order over frozen lists, lists rebuilt per
  second-order iteration), first and second order: the second order by
  forward mode through the XLA blend (``jax.linearize`` there);
- "pallas_lists" with ``bin_margin`` 4 and a tile subset, with
  ``fo_fused=False`` and with ``use_huber=False`` (the unfused first order
  through ``render_tiles``), then the fast second order;
- "pallas" and "pallas_compact" with ``bin_margin`` 0, first order only
  (the macro-list blend and its VJP), and "pallas_compact" with
  ``bin_margin`` 4 and the linearised second order (the XLA blend over
  the frozen lists);
- the two combinations where the JAX package raises (the linearised
  second order through a kernel's custom VJP) raise in the port too;
- ``track_frame`` with the package defaults (``RenderConfig()``,
  ``TrackConfig()``, iteration counts cut) runs and lowers the L1.

Tolerances (test_torch_tracking.py's): per-iteration first-order L1 and
the first second-order L1 rtol 1e-3, iteration counts exact, final pose
within 0.5 mm and 1e-3 rad; second-order L1 after the first step rtol
2e-2 or, where the LM step removes nearly all of the residual (here up to
98 %, from 7.0 to 0.14), 2e-3 of the L1 before it: the two packages'
solved steps differ by about 1e-4 relative, which lands on what the step
leaves as a fraction of what it removed (0.023 of 7.0 on the fast path
after the unfused first order). The first-order-only cases (four Adam
steps) are held to the JAX package, not to the seed pose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.ops import se3 as jse3
from monogs_tpu.ops import sketch as jsketch
from monogs_tpu.slam import tracking as jtrack
from monogs_tpu.slam.frame import make_frame_data as jframe
from monogs_tpu_torch.ops import se3 as tse3
from monogs_tpu_torch.render import RenderConfig as TCfg
from monogs_tpu_torch.slam import tracking as ttrack
from monogs_tpu_torch.slam.frame import make_frame_data as tframe
from tests.test_torch_mapping import JC, JI, TC, TI, W, H, world
from tests.test_torch_ops import npy, t
from tests.torch_one_thread import one_torch_thread  # noqa: F401

BASE = dict(fo_max_iter=4, so_max_iter=3, stack_dim=4, sketch_dim=32,
            lr_trans=0.002, lr_rot=0.006)
CASES = {
    "xla_margin0": ("xla", dict(bin_margin=0.0)),
    "xla_margin4": ("xla", dict(bin_margin=4.0)),
    "lists_unfused": ("pallas_lists", dict(bin_margin=4.0, fo_tile_frac=0.5,
                                           so_tile_frac=0.5,
                                           fo_fused=False)),
    "lists_no_huber": ("pallas_lists", dict(bin_margin=4.0,
                                            fo_tile_frac=0.5,
                                            use_huber=False)),
    "pallas_margin0": ("pallas", dict(bin_margin=0.0, so_max_iter=0)),
    "compact_margin0": ("pallas_compact", dict(bin_margin=0.0,
                                               so_max_iter=0)),
    "compact_margin4": ("pallas_compact", dict(bin_margin=4.0)),
}


def replay_draws(key, n_fine, tcfg, fast_so):
    """The JAX track_frame's draws from ``key`` on the branch taken
    (tracking.py:445-446, 611-612, 667-668) as the port's TrackDraws."""
    fo_tsel = so_tsel = None
    if tcfg.bin_margin > 0 and tcfg.fo_tile_frac < 1.0:
        key, ksub = jax.random.split(key)
        n_sub = max(8, int(n_fine * tcfg.fo_tile_frac) // 8 * 8)
        fo_tsel = t(jax.random.permutation(ksub, n_fine)[:n_sub]).long()
    m = W * H
    if fast_so:
        n_sub_so = n_fine
        if tcfg.so_tile_frac < 1.0:
            n_sub_so = max(8, int(n_fine * tcfg.so_tile_frac) // 8 * 8)
            so_tsel = t(jax.random.permutation(jax.random.fold_in(key, 1),
                                               n_fine)[:n_sub_so]).long()
        m = n_sub_so * 16 * 16
    sketches = []
    for _ in range(tcfg.so_max_iter):
        key, k1 = jax.random.split(key)
        spec = jsketch.make_sketch(k1, m, tcfg.stack_dim, tcfg.sketch_dim)
        sketches.append((t(spec.perm), t(spec.signs)))
    return ttrack.TrackDraws(fo_tsel=fo_tsel, so_tsel=so_tsel,
                             sketches=sketches)


@pytest.fixture(scope="module")
def scene():
    """(JAX map view, port map view, true pose, seed pose, JAX and port
    frames): one view of test_torch_mapping's map, tracked from a pose
    perturbed by about 1 cm and 10 mrad."""
    jm, tm, views = world(seed=3, n_views=1)
    img, _, T_gt = views[0]
    T0 = np.asarray(jse3.retract(T_gt, np.float32(
        [0.006, -0.005, 0.004, 0.004, -0.006, 0.003])))
    jf = jframe(jnp.asarray(img[:3]), None, 1.1, 0.01, "tum")
    tf = tframe(t(img[:3]), None, 1.1, 0.01, "tum")
    return jm.render_view(), tm.render_view(), T_gt, T0, jf, tf


@pytest.mark.parametrize("case", list(CASES))
def test_track_frame_branch_parity(scene, case):
    jg, tg, T_gt, T0, jf, tf = scene
    backend, change = CASES[case]
    jtc = jtrack.TrackConfig(**{**BASE, **change})
    ttc = ttrack.TrackConfig(**{**BASE, **change})
    jc, tc = JC._replace(backend=backend), TC._replace(backend=backend)
    key = jax.random.PRNGKey(5)
    a = jtrack.track_frame(jg, jf, jnp.asarray(T0), jnp.float32(1.0),
                           jnp.float32(0.0), key, JI, jc, jtc)
    b = ttrack.track_frame(tg, tf, t(T0), 1.0, 0.0, None, TI, tc, ttc,
                           draws=replay_draws(key, 16, jtc,
                                              ttrack._fast_so(tc, ttc)))
    assert (b.fo_iters, b.so_iters) == (int(a.fo_iters), int(a.so_iters))
    assert b.fo_iters == ttc.fo_max_iter and b.so_iters == ttc.so_max_iter
    np.testing.assert_allclose(npy(b.fo_losses), np.asarray(a.fo_losses),
                               rtol=1e-3)
    so_b, so_a = npy(b.so_losses), np.asarray(a.so_losses)
    np.testing.assert_allclose(so_b[:1], so_a[:1], rtol=1e-3)
    if ttc.so_max_iter:
        np.testing.assert_allclose(so_b[1:], so_a[1:], rtol=2e-2,
                                   atol=2e-3 * so_a[0])
    np.testing.assert_allclose(float(b.last_l1), float(a.last_l1),
                               rtol=2e-2, atol=2e-3 * float(a.fo_losses[0]))
    dt, dr = tse3.pose_diff(b.T, t(np.asarray(a.T)))
    assert float(dt) < 5e-4 and float(dr) < 1e-3, (float(dt), float(dr))
    if ttc.so_max_iter:
        # the frame was tracked: better than the seed
        e0 = float(tse3.pose_diff(t(T0), t(T_gt))[0])
        assert float(tse3.pose_diff(b.T, t(T_gt))[0]) < 0.5 * e0
    assert bool(torch.isfinite(b.image).all()) and int(b.n_touched.sum()) > 0


@pytest.mark.parametrize("backend", ["pallas_lists", "pallas"])
def test_linearized_second_order_through_kernel_raises(scene, backend):
    """bin_margin 0 with a second order on a kernel backend: the JAX
    package's jax.linearize fails on the kernel's custom_vjp; the port
    refuses the same configuration and names the cause."""
    jg, tg, _, T0, jf, tf = scene
    tcfg = dict(BASE, bin_margin=0.0)
    with pytest.raises(TypeError, match="custom_vjp"):
        jtrack.track_frame(jg, jf, jnp.asarray(T0), jnp.float32(1.0),
                           jnp.float32(0.0), jax.random.PRNGKey(0), JI,
                           JC._replace(backend=backend),
                           jtrack.TrackConfig(**tcfg))
    with pytest.raises(TypeError, match="forward-mode"):
        ttrack.track_frame(tg, tf, t(T0), 1.0, 0.0, None, TI,
                           TC._replace(backend=backend),
                           ttrack.TrackConfig(**tcfg))


def test_track_frame_package_defaults(scene):
    """track_frame with the package defaults (``RenderConfig()``,
    ``TrackConfig()``: backend "xla", bin_margin 0, the full-frame first
    order and the linearised second order, each render binning at its
    pose) runs and lowers the L1; the iteration counts are cut to 3 and
    2, since at k_fine 512 each linearised step pushes four tangents
    through [64, 512, 256] blend tensors."""
    _, tg, _, T0, _, tf = scene
    tcfg = ttrack.TrackConfig()._replace(fo_max_iter=3, so_max_iter=2)
    r = ttrack.track_frame(tg, tf, t(T0), 1.0, 0.0,
                           torch.Generator().manual_seed(0), TI, TCfg(),
                           tcfg)
    assert (r.fo_iters, r.so_iters) == (3, 2)
    assert bool(torch.isfinite(r.T).all())
    assert float(r.so_losses[-1]) < 0.5 * float(r.fo_losses[0])
