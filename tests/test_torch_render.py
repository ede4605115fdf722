"""Parity of the port's render surface (monogs_tpu_torch.render.renderer)
with the JAX package's pallas_lists path run in interpret mode: the full
frame render (image, depth, opacity, n_touched), the fused first-order
objective and its 8-dim gradient over a tile subset (mono and RGB-D), the
pose-tangent render and the fused second-order step built on it.

Both packages get the same map (carried across with convert.py) and the
same frame. Tolerances: image/opacity atol 2e-5, depth 2e-4
(tests/test_pallas_lists.py); n_touched exact (integer counts of
contributing pixels); loss and L1 rtol 1e-4; the 8-dim gradient rtol 2e-3
with an atol of 1e-5 of its largest entry (tests/test_pallas_lists.py holds
the JAX kernel to rtol 2e-3 against autodiff; its bf16x3 reductions err by
up to 2e-3 of the column scale on the depth chain, see
test_torch_blend_lists.py); tangents rtol 1e-3 plus 2e-4 of the channel
maximum; the sketched system rtol 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.ops import se3 as jse3
from monogs_tpu.ops import sketch as jsketch
from monogs_tpu.render import Intrinsics as JIntr
from monogs_tpu.render import RenderConfig as JCfg
from monogs_tpu.render import renderer as jr
from monogs_tpu.slam import tracking as jtrack
from monogs_tpu.slam.frame import make_frame_data as jframe
from monogs_tpu_torch.ops import sketch as tsketch
from monogs_tpu_torch.render import Intrinsics as TIntr
from monogs_tpu_torch.render import RenderConfig as TCfg
from monogs_tpu_torch.render import renderer as tr
from monogs_tpu_torch.slam import tracking as ttrack
from monogs_tpu_torch.slam.frame import make_frame_data as tframe
from tests.test_torch_blend_lists import assert_per_column
from tests.test_torch_ops import both_gauss, npy, small_tau, surface_scene, t
from tests.torch_one_thread import one_torch_thread  # noqa: F401

# 96 px is not a multiple of the 64 px macro: the bottom macro row is
# partial (render must crop it, tile_images must zero-pad it)
INTR = dict(fx=120.0, fy=120.0, cx=63.5, cy=47.5, width=128, height=96)
CFG = dict(tile=16, macro_tiles=4, k_macro=1024, k_fine=96,
           backend="pallas_lists")


def world(seed=0, n=1500):
    """(jax map, port map, pose, frame pose, intrinsics and configs)."""
    jg, tg = both_gauss(surface_scene(n, seed, spread=2.0, depth_mean=3.0,
                                      scale_min=0.03, scale_max=0.09))
    T_gt = np.asarray(jse3.se3_exp(small_tau(seed + 10, 0.03)))
    T = np.asarray(jse3.retract(T_gt, small_tau(seed + 20, 0.004)))
    return (jg, tg, T_gt, T, JIntr(**INTR), TIntr(**INTR),
            JCfg(**CFG, pallas_interpret=True), TCfg(**CFG))


def frames(jg, T_gt, ji, jc, rgbd):
    """JAX and port FrameData of the ground-truth render at T_gt."""
    out = jr.render(jg, jnp.asarray(T_gt), ji,
                    jc._replace(with_n_touched=False))
    img = np.clip(np.asarray(out.image), 0.0, 1.0)
    dep = np.asarray(out.depth[0]) if rgbd else None
    jf = jframe(jnp.asarray(img), None if dep is None else jnp.asarray(dep),
                1.1, 0.01, "tum")
    tf = tframe(t(img), None if dep is None else t(dep), 1.1, 0.01, "tum")
    return jf, tf


@pytest.mark.parametrize("with_n_touched", [False, True])
def test_render_parity(with_n_touched):
    jg, tg, _, T, ji, ti, jc, tc = world()
    jc = jc._replace(with_n_touched=with_n_touched)
    tc = tc._replace(with_n_touched=with_n_touched)
    a = jr.render(jg, jnp.asarray(T), ji, jc)
    b = tr.render(tg, t(T), ti, tc)
    assert b.image.shape == (3, 96, 128)
    np.testing.assert_allclose(npy(b.image), np.asarray(a.image), atol=2e-5)
    np.testing.assert_allclose(npy(b.depth), np.asarray(a.depth), atol=2e-4)
    np.testing.assert_allclose(npy(b.opacity), np.asarray(a.opacity),
                               atol=2e-5)
    np.testing.assert_array_equal(npy(b.radii), np.asarray(a.radii))
    np.testing.assert_array_equal(npy(b.n_touched), np.asarray(a.n_touched))
    assert float(npy(b.opacity).mean()) > 0.5
    if with_n_touched:
        assert npy(b.n_touched).sum() > 0


def test_render_frozen_margin_lists_parity():
    """render from margin lists built at another pose and refined at this
    one (the final render of track_frame)."""
    jg, tg, T_gt, T, ji, ti, jc, tc = world(seed=1)
    _, jaux = jr.build_tile_lists(jg, jnp.asarray(T_gt), ji, jc, margin=16.0,
                                  with_aux=True)
    _, taux = tr.build_tile_lists(tg, t(T_gt), ti, tc, margin=16.0,
                                  with_aux=True)
    n_fine = 2 * 2 * 16
    jl = jr.refine_fine_lists(jg, jnp.asarray(T), ji, jc, jaux,
                              jnp.arange(n_fine, dtype=jnp.int32))
    tl = tr.refine_fine_lists(tg, t(T), ti, tc, taux, torch.arange(n_fine))
    a = jr.render(jg, jnp.asarray(T), ji, jc, lists=jl)
    b = tr.render(tg, t(T), ti, tc, lists=tl)
    np.testing.assert_allclose(npy(b.image), np.asarray(a.image), atol=2e-5)
    np.testing.assert_allclose(npy(b.depth), np.asarray(a.depth), atol=2e-4)
    np.testing.assert_array_equal(npy(b.n_touched), np.asarray(a.n_touched))


def subset(seed, jl, tl, ji, jc, ti, tc, jf, tf, n_sub=16):
    tsel = np.random.default_rng(seed).permutation(64)[:n_sub]
    jx, jy = jr._tile_origins(ji, jc)
    tx, ty = tr._tile_origins(ti, tc, "cpu")
    js = jr.TileLists(idx=jl.idx[tsel], vld=jl.vld[tsel])
    ts = tr.TileLists(idx=tl.idx[tsel], vld=tl.vld[tsel])

    def tiles(jimg, timg):
        return (jr.tile_images(jimg, ji, jc)[tsel],
                tr.tile_images(timg, ti, tc)[tsel])

    return dict(
        jl=js, tl=ts, jxy=(jx[tsel], jy[tsel]), txy=(tx[tsel], ty[tsel]),
        gt=tiles(jf.gt_image, tf.gt_image),
        mask=tiles(jf.mapping_mask, tf.mapping_mask),
        gtd=tiles(jf.gt_depth, tf.gt_depth))


@pytest.mark.parametrize("rgbd", [False, True])
def test_render_fo_grad_tiles_parity(rgbd):
    """(loss, l1, g8) of the fused first-order objective: the kernel's row
    cotangents pulled back through preprocess (torch.autograd.grad against
    jax.vjp)."""
    jg, tg, T_gt, T, ji, ti, jc, tc = world(seed=2)
    jf, tf = frames(jg, T_gt, ji, jc, rgbd)
    jl = jr.build_tile_lists(jg, jnp.asarray(T), ji, jc, margin=8.0)
    tl = tr.build_tile_lists(tg, t(T), ti, tc, margin=8.0)
    s = subset(3, jl, tl, ji, jc, ti, tc, jf, tf)
    tau = (0.001 * np.arange(6)).astype(np.float32)
    ea, eb = np.float32(1.07), np.float32(0.015)
    a = jr.render_fo_grad_tiles(
        jg, jnp.asarray(T), ji, jc, s["jl"], *s["jxy"], jnp.asarray(tau),
        jnp.float32(ea), jnp.float32(eb), s["gt"][0], s["mask"][0], True,
        0.01, gtd_t=s["gtd"][0] if rgbd else None)
    b = tr.render_fo_grad_tiles(
        tg, t(T), ti, tc, s["tl"], *s["txy"], t(tau), torch.tensor(ea),
        torch.tensor(eb), s["gt"][1], s["mask"][1], True, 0.01,
        gtd_t=s["gtd"][1] if rgbd else None)
    np.testing.assert_allclose(float(b[0]), float(a[0]), rtol=1e-4)
    np.testing.assert_allclose(float(b[1]), float(a[1]), rtol=1e-4)
    g, jg8 = npy(b[2]), np.asarray(a[2])
    np.testing.assert_allclose(g, jg8, rtol=2e-3,
                               atol=1e-5 * np.abs(jg8).max())
    assert np.abs(g[:6]).max() > 0


def test_render_pose_jvp_tiles_and_so_step_parity():
    """The primal-plus-six-tangents render over a tile subset, and the
    fused second-order step (sketched residual and Jacobian) on it with
    the JAX sketch injected."""
    jg, tg, T_gt, T, ji, ti, jc, tc = world(seed=4)
    jf, tf = frames(jg, T_gt, ji, jc, rgbd=False)
    jl = jr.build_tile_lists(jg, jnp.asarray(T), ji, jc, margin=8.0)
    tl = tr.build_tile_lists(tg, t(T), ti, tc, margin=8.0)
    s = subset(5, jl, tl, ji, jc, ti, tc, jf, tf)
    jo, jt = jr.render_pose_jvp_tiles(jg, jnp.asarray(T), ji, jc, s["jl"],
                                      *s["jxy"])
    to, tt = tr.render_pose_jvp_tiles(tg, t(T), ti, tc, s["tl"], *s["txy"])
    np.testing.assert_allclose(npy(to)[..., :3], np.asarray(jo)[..., :3],
                               atol=2e-5)
    np.testing.assert_allclose(npy(to)[..., 3], np.asarray(jo)[..., 3],
                               atol=2e-4)
    assert_per_column(npy(tt), np.asarray(jt), 2e-4, "touts")

    m = 16 * 256
    jspec = jsketch.make_sketch(jax.random.PRNGKey(6), m, 8, 32)
    tspec = tsketch.sketch_from_draw(t(jspec.perm), t(jspec.signs), m, 8, 32)
    jtc = jtrack.TrackConfig(monocular=True)
    ttc = ttrack.TrackConfig(monocular=True)
    ea, eb = np.float32(1.05), np.float32(0.02)
    a = jtrack._so_fast_step(jg, s["gt"][0], s["mask"][0], jnp.asarray(T),
                             jnp.float32(ea), jnp.float32(eb), jspec, ji, jc,
                             jtc, s["jl"], *s["jxy"], scale=4.0)
    b = ttrack._so_fast_step(tg, s["gt"][1], s["mask"][1], t(T),
                             torch.tensor(ea), torch.tensor(eb), tspec, ti,
                             tc, ttc, s["tl"], *s["txy"], scale=4.0)
    np.testing.assert_allclose(float(b[2]), float(a[2]), rtol=1e-4)
    for x, y, name in ((b[0], a[0], "Sf"), (b[1], a[1], "SJ")):
        y = np.asarray(y)
        np.testing.assert_allclose(npy(x), y, rtol=1e-3,
                                   atol=1e-4 * np.abs(y).max(), err_msg=name)
