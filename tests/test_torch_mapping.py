"""The mapping slice against the JAX package (pallas_lists in interpret
mode): the plain versions of the blend VJP and of the fused mapping
kernel, the differentiable render, ``render_map_grad`` with every
gradient, the tile-subset partition identity, ``map_iters`` over a few
iterations with the JAX draws replayed, ``covisibility_prune`` and
``color_refinement_iters``; and the port's own ``map_iters`` reducing the
loss and pulling back a perturbed window pose.

Both packages get the same map (``convert.map_from_numpy``) and the same
frames, made with numpy from a seed. Ground truth is offset (+0.03 colour,
+0.05 depth) so that no L1 residual sits at 0, where its sign would flip
on rounding noise.

Tolerances:
- row cotangents rtol 1e-3 plus a fraction of the column's largest
  magnitude, as in test_torch_blend_lists.py: 1e-4 for the colour chain,
  4e-3 where a depth cotangent enters (the Pallas kernel's bf16x3
  reductions err by up to 1.8e-3 of the column maximum there); per-tile
  sums rtol 1e-4;
- losses rtol 2e-5; map, pose and offset gradients atol 5e-5 and exposure
  gradients rtol 5e-5 (test_mapping.py's bounds for the fused kernel
  against autodiff); radii exact;
- after a few ``map_iters`` iterations: parameters atol 1e-4, poses 1e-6,
  exposures 1e-6 and visibility exact. Adam divides each gradient by its
  running RMS, so where a small gradient changes sign between steps the
  rounding difference of the gradients reappears as up to about 1e-3 of
  the leaf's learning rate (0.05 for opacity) in the parameter;
- colour refinement parameters atol 1e-4 after three steps (as above)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from monogs_tpu.models import gaussian_map as jgm
from monogs_tpu.ops import se3 as jse3
from monogs_tpu.render import Intrinsics as JIntr
from monogs_tpu.render import RenderConfig as JCfg
from monogs_tpu.render import pallas_lists as jpl
from monogs_tpu.render import renderer as jr
from monogs_tpu.slam import mapping as jmap
from monogs_tpu_torch.convert import cams_from_numpy
from monogs_tpu_torch.models import gaussian_map as tgm
from monogs_tpu_torch.ops import se3 as tse3
from monogs_tpu_torch.render import Intrinsics as TIntr
from monogs_tpu_torch.render import RenderConfig as TCfg
from monogs_tpu_torch.render import blend_lists as tbl
from monogs_tpu_torch.render import renderer as tr
from monogs_tpu_torch.slam import mapping as tmap
from tests.test_torch_blend_lists import assert_per_column, j, rows
from tests.test_torch_map import LEAVES, port_map
from tests.test_torch_ops import npy, small_tau, surface_scene, t
from tests.torch_one_thread import one_torch_thread  # noqa: F401

INTR = dict(fx=60.0, fy=60.0, cx=31.5, cy=23.5, width=64, height=48)
CFG = dict(tile=16, macro_tiles=2, k_macro=512, k_fine=128,
           backend="pallas_lists")
W, H = INTR["width"], INTR["height"]
JI, TI = JIntr(**INTR), TIntr(**INTR)
JC, TC = JCfg(**CFG, pallas_interpret=True), TCfg(**CFG)
MCFG = dict(monocular=False, window_size=2, pose_window=2,
            gaussian_update_every=10**9, gaussian_reset=10**9)
_jrender = jax.jit(lambda g, T: jr.render(
    g, T, JI, JC._replace(with_n_touched=False)))
_jmap_grad = jax.jit(jr.render_map_grad, static_argnums=(2, 3, 11, 12),
                     static_argnames=("px_frac",))


def world(seed=0, n=300, cap=1024, n_views=3):
    """(JAX map, port map, numpy frames (image, depth) and poses): a
    surface scene inserted into a map of capacity ``cap``, rendered by the
    JAX package at ``n_views`` poses."""
    sc = surface_scene(n, seed, spread=1.2, depth_mean=3.0,
                       scale_min=0.03, scale_max=0.12)
    jm = jgm.insert(jgm.new_map(cap), jgm.ParamLeaves(
        *(jnp.asarray(sc[k].astype(np.float32)) for k in LEAVES)),
        jnp.int32(n), kf_id=0)
    views = []
    for i in range(n_views):
        T = np.asarray(jse3.se3_exp(small_tau(seed + 30 + i, 0.03)))
        out = _jrender(jm.render_view(), jnp.asarray(T))
        views.append((np.clip(np.asarray(out.image), 0, 1),
                      np.asarray(out.depth), T))
    return jm, port_map(jm), views


def cam_batch(views, offset=True, opt_pose=None, opt_exposure=None):
    """(JAX CamBatch, port CamBatch) of the views."""
    b = len(views)
    img = np.stack([v[0] for v in views]) + (0.03 if offset else 0.0)
    dep = np.stack([v[1] for v in views]) + (0.05 if offset else 0.0)
    fields = dict(
        gt_image=img.astype(np.float32), gt_depth=dep.astype(np.float32),
        mapping_mask=np.ones((b, 1, H, W), np.float32),
        T=np.stack([v[2] for v in views]).astype(np.float32),
        ea=np.ones(b, np.float32), eb=np.zeros(b, np.float32),
        valid=np.ones(b, bool),
        opt_pose=np.zeros(b, bool) if opt_pose is None else opt_pose,
        opt_exposure=(np.zeros(b, bool) if opt_exposure is None
                      else opt_exposure))
    return (jmap.CamBatch(**{k: jnp.asarray(v) for k, v in fields.items()}),
            cams_from_numpy(**fields, device="cpu"))


def noisy(jm, seed=7):
    """The map with its colours and positions perturbed."""
    rng = np.random.default_rng(seed)
    p = jm.params
    jm = jm._replace(params=p._replace(
        sh=p.sh + jnp.asarray(0.3 * rng.standard_normal(p.sh.shape),
                              jnp.float32),
        xyz=p.xyz + jnp.asarray(0.01 * rng.standard_normal(p.xyz.shape),
                                jnp.float32)))
    return jm, port_map(jm)


# ------------------------------------------------------------ the kernels

@pytest.mark.parametrize("k_fine", [96, 256])
def test_blend_lists_vjp_parity(k_fine):
    """Plain blend VJP against jax.vjp of blend_lists_pallas (its custom
    VJP, _bwd_kernel), on real rows with a cotangent in every column."""
    d, _, tx0, ty0, pmat = rows(k_fine, seed=2)
    g = np.random.default_rng(3).normal(
        0, 1, (d.shape[0], pmat.shape[1], 8)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x, g_: jax.vjp(
        lambda y: jpl.blend_lists_pallas(y, j(tx0), j(ty0), j(pmat), 16, W, H,
                                         True), x)[1](g_)[0])(j(d), g))
    dd = npy(tbl.blend_lists_vjp(d, tx0, ty0, pmat, t(g), W, H))
    assert_per_column(dd, ref, 4e-3, "dd")
    assert np.abs(dd).max() > 1.0


def tiled_truth(d, tx0, ty0, pmat, seed):
    """gt, mask, gt depth [T, P, .] from the rows' own render plus noise
    and the +0.03 / +0.05 offsets."""
    img = npy(tbl.blend_lists(d, tx0, ty0, pmat, W, H))
    rng = np.random.default_rng(seed)
    gt = (img[..., :3] + 0.03 + rng.normal(0, 0.03, img[..., :3].shape))
    mask = (rng.uniform(size=img[..., :1].shape) > 0.2)
    gtd = img[..., 3:4] * rng.uniform(0.97, 1.03, img[..., 3:4].shape) + 0.05
    return [x.astype(np.float32) for x in (gt, mask, gtd)]


@pytest.mark.parametrize("mode", ["mono", "rgbd", "init", "subset"])
def test_map_grad_lists_parity(mode):
    """Plain fused mapping kernel against map_grad_lists_pallas: mono,
    RGB-D, initialisation (no exposure) and a half-tile subset with
    px_frac 0.5."""
    d, _, tx0, ty0, pmat = rows(96, seed=4)
    gt, mask, gtd = tiled_truth(d, tx0, ty0, pmat, 5)
    px_frac = 1.0
    if mode == "subset":
        sel = np.arange(0, d.shape[0], 2)
        d, tx0, ty0 = d[sel].contiguous(), tx0[sel], ty0[sel]
        gt, mask, gtd = gt[sel], mask[sel], gtd[sel]
        px_frac = 0.5
    ea, eb = np.float32(1.07), np.float32(0.015)
    rgbd = mode == "rgbd"
    ref_dd, ref_s = jpl.map_grad_lists_pallas(
        j(d), j(tx0), j(ty0), j(pmat), jnp.asarray(gt), jnp.asarray(mask),
        jnp.float32(ea), jnp.float32(eb), 16, W, H, True, mode != "init",
        0.9 if rgbd else 1.0, 1e-8, gtd_t=jnp.asarray(gtd) if rgbd else None,
        px_frac=px_frac)
    dd, sums = tbl.map_grad_lists(
        d, tx0, ty0, pmat, t(gt), t(mask), torch.tensor(ea),
        torch.tensor(eb), W, H, mode != "init", 0.9 if rgbd else 1.0, 1e-8,
        gtd_t=t(gtd) if rgbd else None, px_frac=px_frac)
    assert_per_column(npy(dd), np.asarray(ref_dd), 4e-3 if rgbd else 1e-4,
                      "dd")
    np.testing.assert_allclose(npy(sums), np.asarray(ref_s), rtol=1e-4,
                               atol=1e-5)
    assert float(sums[:, 0].sum()) > 0 and np.abs(npy(dd)).max() > 0
    if rgbd:
        assert float(sums[:, 1].sum()) > 0


# ------------------------------------------------------- the render surface

def test_render_gradient_parity():
    """render without n_touched is differentiable through the blend
    Function (backward = blend_lists_vjp): the gradient of a weighted sum
    of image, depth and opacity against jax.grad of the JAX render."""
    jm, tm, views = world(seed=1, n_views=1)
    T = views[0][2]
    rng = np.random.default_rng(2)
    wi, wd, wo = (rng.normal(0, 1, s).astype(np.float32)
                  for s in ((3, H, W), (1, H, W), (1, H, W)))
    cfg_j = JC._replace(with_n_touched=False)

    def jloss(xyz, sh, ls, quat, ol):
        g = jm.render_view()._replace(xyz=xyz, sh=sh, log_scale=ls,
                                      quat=quat, opa_logit=ol)
        out = jr.render(g, jnp.asarray(T), JI, cfg_j)
        return (jnp.sum(out.image * wi) + jnp.sum(out.depth * wd)
                + jnp.sum(out.opacity * wo))

    ref = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(*jm.params)
    leaves = [x.clone().requires_grad_(True) for x in tm.params]
    g = tr.GaussianArrays(*leaves, active=tm.active)
    out = tr.render(g, t(T), TI, TC._replace(with_n_touched=False))
    (torch.sum(out.image * t(wi)) + torch.sum(out.depth * t(wd))
     + torch.sum(out.opacity * t(wo))).backward()
    for x, r, name in zip(leaves, ref, LEAVES):
        r = np.asarray(r)
        np.testing.assert_allclose(npy(x.grad), r, rtol=1e-3,
                                   atol=4e-3 * np.abs(r).max(), err_msg=name)
    assert np.abs(npy(leaves[0].grad)).max() > 0


def map_grad_inputs(seed, rgbd, subset):
    jm, tm, views = world(seed=seed, n_views=1)
    img, dep, T = views[0]
    jcam, tcam = cam_batch([views[0]])
    lists_j = jr.build_tile_lists(jm.render_view(), jnp.asarray(T), JI, JC,
                                  margin=4.0)
    lists_t = tr.build_tile_lists(tm.render_view(), t(T), TI, TC,
                                  margin=4.0)
    np.testing.assert_array_equal(npy(lists_t.idx), np.asarray(lists_j.idx))
    tiles = [(jr.tile_images(x[0], JI, JC), tr.tile_images(y[0], TI, TC))
             for x, y in ((jcam.gt_image, tcam.gt_image),
                          (jcam.mapping_mask, tcam.mapping_mask),
                          (jcam.gt_depth, tcam.gt_depth))]
    n_fine = lists_t.idx.shape[0]
    kw_j, kw_t = dict(px_frac=1.0), dict(px_frac=1.0)
    if subset:
        ts = np.random.default_rng(seed).permutation(n_fine)[:n_fine // 2]
        lists_j = jr.TileLists(idx=lists_j.idx[ts], vld=lists_j.vld[ts])
        lists_t = tr.TileLists(idx=lists_t.idx[ts], vld=lists_t.vld[ts])
        tiles = [(a[ts], b[ts]) for a, b in tiles]
        jx, jy = jr._tile_origins(JI, JC)
        tx, ty = tr._tile_origins(TI, TC, "cpu")
        kw_j = dict(txy=(jx[ts], jy[ts]), px_frac=0.5)
        kw_t = dict(txy=(tx[ts], ty[ts]), px_frac=0.5)
    if not rgbd:
        tiles[2] = (None, None)
    n = jm.capacity
    ea, eb = np.float32(1.08), np.float32(0.02)
    ja = (jm.render_view(), jnp.asarray(T), JI, JC, lists_j, tiles[0][0],
          tiles[1][0], jnp.zeros(6), jnp.zeros((n, 2)), jnp.float32(ea),
          jnp.float32(eb))
    ta = (tm.render_view(), t(T), TI, TC, lists_t, tiles[0][1], tiles[1][1],
          torch.zeros(6), torch.zeros((n, 2)), torch.tensor(ea),
          torch.tensor(eb))
    return ja, ta, dict(gtd_t=tiles[2][0], **kw_j), dict(gtd_t=tiles[2][1],
                                                         **kw_t)


@pytest.mark.parametrize("rgbd", [False, True])
@pytest.mark.parametrize("subset", [False, True])
def test_render_map_grad_parity(rgbd, subset):
    """Loss and every gradient (map leaves, pose tangent, screen-space
    offset hook, exposure) and the radii, mono and RGB-D, all tiles and a
    half-tile subset."""
    ja, ta, kj, kt = map_grad_inputs(3, rgbd, subset)
    a = _jmap_grad(*ja, False, 0.9, **kj)
    b = tr.render_map_grad(*ta, False, 0.9, **kt)
    np.testing.assert_allclose(float(b[0]), float(a[0]), rtol=2e-5)
    for x, r, name in zip(b[1], a[1], LEAVES):
        np.testing.assert_allclose(npy(x), np.asarray(r), atol=5e-5,
                                   err_msg=name)
    np.testing.assert_allclose(npy(b[2]), np.asarray(a[2]), atol=5e-5)
    np.testing.assert_allclose(npy(b[3]), np.asarray(a[3]), atol=5e-5)
    for x, r in zip(b[4:6], a[4:6]):
        np.testing.assert_allclose(float(x), float(r), rtol=5e-5, atol=5e-6)
    np.testing.assert_array_equal(npy(b[6]), np.asarray(a[6]))
    assert np.abs(npy(b[3])).max() > 0 and np.abs(npy(b[1][0])).max() > 0


def test_map_grad_tile_subset_partition():
    """Averaging the 1/frac-scaled subset calls over a disjoint partition
    of the tiles gives the full call's loss and every gradient (each tile's
    part is linear in the pull-back), up to float32 summation order: the
    contract behind MapConfig.tile_frac."""
    _, ta, _, kt = map_grad_inputs(4, True, False)
    gauss, T, _, _, lists, gt_t, mask_t, tau, off, ea, eb = ta
    ref = tr.render_map_grad(*ta, False, 0.9, **kt)
    tx, ty = tr._tile_origins(TI, TC, "cpu")
    n_fine = lists.idx.shape[0]
    perm = torch.from_numpy(np.random.default_rng(3).permutation(n_fine))
    parts = []
    for half in (perm[:n_fine // 2], perm[n_fine // 2:]):
        parts.append(tr.render_map_grad(
            gauss, T, TI, TC, tr.TileLists(idx=lists.idx[half],
                                           vld=lists.vld[half]),
            gt_t[half], mask_t[half], tau, off, ea, eb, False, 0.9,
            gtd_t=kt["gtd_t"][half], txy=(tx[half], ty[half]), px_frac=0.5))
    np.testing.assert_allclose(float(parts[0][0] + parts[1][0]) / 2,
                               float(ref[0]), rtol=1e-5)
    for i in (1,):
        for a, b_, r in zip(parts[0][i], parts[1][i], ref[i]):
            np.testing.assert_allclose(npy(0.5 * (a + b_)), npy(r),
                                       atol=2e-5)
    for i in (2, 3):
        np.testing.assert_allclose(npy(0.5 * (parts[0][i] + parts[1][i])),
                                   npy(ref[i]), atol=2e-5)
    for i in (4, 5):
        np.testing.assert_allclose(float(0.5 * (parts[0][i] + parts[1][i])),
                                   float(ref[i]), rtol=2e-5, atol=2e-7)
    np.testing.assert_array_equal(npy(parts[0][6]), npy(ref[6]))


# ------------------------------------------------------------ the loop

def replay_map_draws(key, n_iters, b, n_fine, mcfg):
    """The JAX map_iters draws from ``key`` (mapping.py:397, 492-495) as
    the port's MapDraws."""
    tsel, noise = [], []
    n_sub = max(8, int(n_fine * mcfg.tile_frac) // 8 * 8)
    for _ in range(n_iters):
        key, k_dens = jax.random.split(key)
        noise.append(t(jax.random.normal(k_dens, (2, mcfg.split_cap, 3))))
        if mcfg.tile_frac < 1.0:
            key, k_sub = jax.random.split(key)
            tsel.append(torch.stack([
                t(jax.random.permutation(k, n_fine)[:n_sub]).long()
                for k in jax.random.split(k_sub, b)]))
    return tmap.MapDraws(tsel=tsel, split_noise=noise)


@pytest.mark.parametrize("tile_frac,densify", [(1.0, True), (0.5, False)])
def test_map_iters_parity(tile_frac, densify):
    """Four iterations of the window BA through both packages: all tiles
    with a densify at the third iteration (its split noise replayed), and
    half-tile subsets (the JAX subsets replayed); poses and exposures of
    two views optimised. Parameters, poses, exposures, the iteration
    counter and the final visibility."""
    jm, _, views = world(seed=5)
    jm, tm = noisy(jm)
    opt = np.array([False, True, True])
    jcam, tcam = cam_batch(views, opt_pose=opt, opt_exposure=opt)
    mc = dict(MCFG, tile_frac=tile_frac, clone_cap=64, split_cap=32)
    if densify:
        mc.update(gaussian_update_every=5, gaussian_update_offset=0,
                  densify_grad_threshold=1e-5)
    jmc, tmc = jmap.MapConfig(**mc), tmap.MapConfig(**mc)
    key = jax.random.PRNGKey(1)
    a = jmap.map_iters(jm, jcam, 4, jnp.int32(2), key, JI, JC, jmc,
                       jgm.MapHyper())
    b = tmap.map_iters(tm, tcam, 4, 2, None, TI, TC, tmc, tgm.MapHyper(),
                       draws=replay_map_draws(key, 4, 3, 16, jmc))
    assert b.it_count == int(a[2]) == 6
    np.testing.assert_array_equal(npy(b.m.active), np.asarray(a[0].active))
    if densify:
        assert int(b.m.n_active) != int(tm.n_active)
    for k in LEAVES:
        np.testing.assert_allclose(npy(getattr(b.m.params, k)),
                                   np.asarray(getattr(a[0].params, k)),
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(npy(b.cams.T), np.asarray(a[1].T), atol=1e-6)
    np.testing.assert_allclose(npy(b.cams.ea), np.asarray(a[1].ea), atol=1e-6)
    np.testing.assert_allclose(npy(b.cams.eb), np.asarray(a[1].eb), atol=1e-6)
    assert float(torch.abs(b.cams.T[1] - tcam.T[1]).max()) > 0
    np.testing.assert_array_equal(npy(b.visibility), np.asarray(a[3]))
    assert npy(b.visibility).sum() > 0


def photometric_err(m, views):
    errs = []
    for img, _, T in views:
        out = tr.render(m.render_view(), t(T), TI,
                        TC._replace(with_n_touched=False))
        errs.append(float(torch.mean(torch.abs(out.image - t(img)))))
    return float(np.mean(errs))


def test_map_iters_reduces_loss():
    """The port's map_iters with its own generator (tile_frac 0.5) brings a
    perturbed map back towards its views (test_map_iters_reduces_loss)."""
    jm, _, views = world(seed=6)
    _, tm = noisy(jm)
    _, tcam = cam_batch(views, offset=False)
    before = photometric_err(tm, views)
    r = tmap.map_iters(tm, tcam, 40, 0, torch.Generator().manual_seed(0),
                       TI, TC, tmap.MapConfig(**MCFG, tile_frac=0.5),
                       tgm.MapHyper())
    after = photometric_err(r.m, views)
    assert after < 0.6 * before, (before, after)
    assert r.it_count == 40 and bool(r.visibility[0].any())


def test_map_iters_pose_refinement():
    """A perturbed window pose is pulled back (test_map_iters_pose_
    refinement): BA is told its frame came from the true pose."""
    jm, tm, views = world(seed=7)
    opt = np.array([False, True, False])
    _, tcam = cam_batch(views, offset=False, opt_pose=opt, opt_exposure=opt)
    T_true = tcam.T[1].clone()
    d = torch.tensor([0.004, -0.003, 0.002, 0.002, -0.002, 0.001])
    tcam = tcam._replace(T=torch.stack(
        [tcam.T[0], tse3.se3_exp(d) @ T_true, tcam.T[2]]))
    before = float(tse3.pose_diff(tcam.T[1], T_true)[0])
    r = tmap.map_iters(tm, tcam, 60, 0, torch.Generator().manual_seed(0),
                       TI, TC, tmap.MapConfig(**MCFG), tgm.MapHyper())
    after = float(tse3.pose_diff(r.cams.T[1], T_true)[0])
    assert after < 0.5 * before, (before, after)


@pytest.mark.parametrize("initialized,mode", [(True, "slam"),
                                              (False, "slam"),
                                              (True, "odometry")])
def test_covisibility_prune_parity(initialized, mode):
    jm, tm, _ = world(seed=8, n_views=1)
    rng = np.random.default_rng(9)
    kf = rng.integers(0, 6, jm.capacity).astype(np.int32)
    jm = jm._replace(kf_id=jnp.where(jm.active, kf, -1))
    tm = port_map(jm)
    vis = rng.uniform(size=(4, jm.capacity)) < 0.6
    ids = np.array([5, 2, 4, -1], np.int32)
    mc = dict(MCFG, monocular=True)
    a, an = jmap.covisibility_prune(jm, jnp.asarray(vis), jnp.asarray(ids),
                                    jnp.asarray(initialized),
                                    jmap.MapConfig(**mc), prune_mode=mode)
    b, bn = tmap.covisibility_prune(tm, torch.from_numpy(vis),
                                    torch.from_numpy(ids), initialized,
                                    tmap.MapConfig(**mc), prune_mode=mode)
    np.testing.assert_array_equal(npy(bn), np.asarray(an))
    for k in ("active", "kf_id", "n_obs"):
        np.testing.assert_array_equal(npy(getattr(b, k)),
                                      np.asarray(getattr(a, k)), err_msg=k)
    assert int(b.n_active) < int(tm.n_active)


def test_color_refinement_parity():
    """Three refinement steps through the differentiable render (the blend
    VJP's plain version here) with the JAX view draws replayed."""
    jm, _, views = world(seed=9)
    jm, tm = noisy(jm, seed=10)
    jcam, tcam = cam_batch(views)
    mc = dict(MCFG, rebin_every=2)
    key = jax.random.PRNGKey(2)
    a = jmap.color_refinement_iters(jm, jcam, 3, key, JI, JC,
                                    jmap.MapConfig(**mc), jgm.MapHyper())
    views_drawn, k = [], key
    for _ in range(3):
        k, k1 = jax.random.split(k)
        views_drawn.append(int(jax.random.randint(k1, (), 0, 3)))
    b = tmap.color_refinement_iters(tm, tcam, 3, None, TI, TC,
                                    tmap.MapConfig(**mc), tgm.MapHyper(),
                                    views=views_drawn)
    for k in LEAVES:
        np.testing.assert_allclose(npy(getattr(b.params, k)),
                                   np.asarray(getattr(a.params, k)),
                                   atol=1e-4, err_msg=k)
    assert int(b.adam_t) == 3
    assert float(torch.abs(b.params.sh - tm.params.sh).max()) > 1e-4


@pytest.mark.parametrize("change", [
    dict(io_batch=True), dict(scatter_segsum=True), dict(gather_first=True),
    dict(batch_render=True, fused_grad=False),
])
def test_unported_branches_raise(change):
    """Every A/B knob is accepted, alone and with a group (a
    ``torch.distributed`` ProcessGroup: the view-sharded body of
    ``parallel/mesh.py``); an axis name, the JAX package's form of a
    group, raises."""
    mc = tmap.MapConfig(**change)
    tmap._check_supported(TC, mc, None)
    tmap._check_supported(TC, mc, dist.ProcessGroup(dist.HashStore(), 0, 1))
    with pytest.raises(TypeError, match="ProcessGroup"):
        tmap._check_supported(TC, mc, "views")


@pytest.mark.parametrize("change", [
    dict(bin_margin=0.0), dict(fused_grad=False), dict(vis_from_lists=False),
    dict(batch_render=True), dict(bin_margin=0.0, io_batch=True,
                                  scatter_segsum=True, gather_first=True),
])
def test_ported_branches_accepted(change):
    """The unfused branch and the visibility pass without lists run; a knob
    of a branch not taken is ignored, as in the JAX package."""
    tmap._check_supported(TC, tmap.MapConfig(**change), None)
    for backend in ("xla", "pallas", "pallas_compact"):
        tmap._check_supported(TC._replace(backend=backend),
                              tmap.MapConfig(**change), None)
