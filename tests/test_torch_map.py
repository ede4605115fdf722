"""Parity of the port's map state and the ops around it with the JAX package:
``compact_indices``, the fixed-capacity map (``insert``, ``adam_step``,
``prune``, both opacity resets, ``densify_and_prune`` with the JAX split
noise replayed), the k-NN scale initialiser, keyframe insertion with the
JAX keep draws replayed, SSIM / PSNR and the mapping losses.

Inputs are made with numpy from a seed and handed to both packages; maps
are carried across with ``convert.map_from_numpy``.

Tolerances: index outputs, masks, counters and active sets exact;
elementwise float32 math (Adam, resets, insertion's colours and
positions) rtol 1e-6; densified parameters within 1e-6 (the split offsets
are a 3x3 rotation applied to the noise, summed in another order); k-NN
distances rtol 1e-4 plus 1e-6 of their scale (|p|^2 - 2 p.q + |q|^2 cancels
for near neighbours, and the matrix products reassociate); SSIM, PSNR and
the losses rtol 1e-5 (sums and convolutions over a few thousand pixels in
another order), their gradients rtol 1e-4 with an atol of 1e-6 of the
largest entry (1e-5 for SSIM's, the transpose of five convolutions whose
smallest entries are sums that cancel)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.models import gaussian_map as jgm
from monogs_tpu.models import insertion as jins
from monogs_tpu.ops import image as jimage
from monogs_tpu.ops import knn as jknn
from monogs_tpu.ops import losses as jlosses
from monogs_tpu.ops import se3 as jse3
from monogs_tpu.render import Intrinsics as JIntr
from monogs_tpu.render.tiling import compact_indices as jcompact
from monogs_tpu_torch.convert import map_from_numpy
from monogs_tpu_torch.models import gaussian_map as tgm
from monogs_tpu_torch.models import insertion as tins
from monogs_tpu_torch.ops import image as timage
from monogs_tpu_torch.ops import knn as tknn
from monogs_tpu_torch.ops import losses as tlosses
from monogs_tpu_torch.render import Intrinsics as TIntr
from monogs_tpu_torch.render.tiling import compact_indices as tcompact
from tests.test_torch_ops import npy, small_tau, surface_scene, t
from tests.torch_one_thread import one_torch_thread  # noqa: F401

LEAVES = ("xyz", "sh", "log_scale", "quat", "opa_logit")
SIDE = ("adam_t", "active", "kf_id", "n_obs", "max_radii2d", "grad_accum",
        "denom")


def port_map(jm):
    """The port's GaussianMap of a JAX GaussianMap (CPU)."""
    return map_from_numpy(
        *(tuple(np.asarray(x) for x in leaves)
          for leaves in (jm.params, jm.adam_m, jm.adam_v)),
        *(np.asarray(getattr(jm, k)) for k in SIDE), device="cpu")


def assert_maps_close(tm, jm, rtol=1e-6, atol=0.0):
    for k in SIDE:
        np.testing.assert_array_equal(npy(getattr(tm, k)),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    for group in ("params", "adam_m", "adam_v"):
        for k in LEAVES:
            np.testing.assert_allclose(
                npy(getattr(getattr(tm, group), k)),
                np.asarray(getattr(getattr(jm, group), k)), rtol=rtol,
                atol=atol, err_msg=f"{group}.{k}")


def scene_leaves(n, seed):
    sc = surface_scene(n, seed, spread=1.2, depth_mean=3.0,
                       scale_min=0.01, scale_max=0.2)
    sc["opa_logit"] = np.random.default_rng(seed).normal(
        0.0, 2.0, (n, 1))
    return {k: v.astype(np.float32) for k, v in sc.items() if k != "active"}


def both_maps(cap=512, n=300, seed=0):
    """A JAX map with n Gaussians inserted into capacity cap, and the
    port's copy of it."""
    lv = scene_leaves(n, seed)
    jm = jgm.insert(jgm.new_map(cap), jgm.ParamLeaves(
        *(jnp.asarray(lv[k]) for k in LEAVES)), jnp.int32(n), kf_id=3)
    return jm, port_map(jm)


@pytest.mark.parametrize("density,cap", [(0.3, 64), (0.05, 64), (0.0, 8),
                                         (1.0, 300)])
def test_compact_indices_parity(density, cap):
    mask = np.random.default_rng(1).uniform(size=257) < density
    a = jcompact(jnp.asarray(mask), cap)
    b = tcompact(torch.from_numpy(mask), cap)
    for x, y in zip(b, a):
        np.testing.assert_array_equal(npy(x), np.asarray(y))


def test_insert_parity():
    """Two inserts: the second overflows the free slots and is cut."""
    lv = scene_leaves(200, 1)
    jm = jgm.new_map(320)
    tm = tgm.new_map(320, device="cpu")
    assert_maps_close(tm, jm)
    for lo, hi, count, kf in ((0, 150, 140, 0), (150, 200, 50, 1),
                              (0, 200, 200, 2)):
        new = {k: lv[k][lo:hi] for k in LEAVES}
        jm = jgm.insert(jm, jgm.ParamLeaves(
            *(jnp.asarray(new[k]) for k in LEAVES)), jnp.int32(count), kf)
        tm = tgm.insert(tm, tgm.ParamLeaves(*(t(new[k]) for k in LEAVES)),
                        torch.tensor(count), kf)
        assert_maps_close(tm, jm)
    assert int(tm.n_active) == 320


def test_adam_step_parity():
    """Three steps at different points of the xyz schedule, with half the
    map inactive (its parameters and moments must not move)."""
    jm, tm = both_maps()
    rng = np.random.default_rng(2)
    for step in (0, 7000, 45000):
        g = {k: rng.normal(0, 1e-3, getattr(jm.params, k).shape).astype(
            np.float32) for k in LEAVES}
        jm = jgm.adam_step(jm, jgm.ParamLeaves(
            *(jnp.asarray(g[k]) for k in LEAVES)), jgm.MapHyper(), step)
        tm = tgm.adam_step(tm, tgm.ParamLeaves(*(t(g[k]) for k in LEAVES)),
                           tgm.MapHyper(), step)
        assert_maps_close(tm, jm, rtol=1e-6, atol=1e-8)
    assert int(tm.adam_t) == 3
    np.testing.assert_allclose(tgm.xyz_lr_at(tgm.MapHyper(), 7000),
                               float(jgm.xyz_lr_at(jgm.MapHyper(), 7000)),
                               rtol=1e-6)


def test_prune_and_opacity_resets_parity():
    jm, tm = both_maps()
    jm = jm._replace(adam_m=jm.adam_m._replace(
        opa_logit=jnp.ones_like(jm.adam_m.opa_logit)))
    tm = port_map(jm)
    mask = np.random.default_rng(3).uniform(size=jm.capacity) < 0.2
    visible = np.random.default_rng(4).uniform(size=jm.capacity) < 0.5
    jp = jgm.prune(jm, jnp.asarray(mask))
    tp = tgm.prune(tm, torch.from_numpy(mask))
    assert_maps_close(tp, jp)
    assert_maps_close(tgm.reset_opacity(tp), jgm.reset_opacity(jp))
    assert_maps_close(
        tgm.reset_opacity_nonvisible(tp, torch.from_numpy(visible)),
        jgm.reset_opacity_nonvisible(jp, jnp.asarray(visible)))
    assert float(torch.abs(tgm.reset_opacity(tp).adam_m.opa_logit).max()) == 0


@pytest.mark.parametrize("max_screen_size", [None, 20])
def test_densify_and_prune_parity(max_screen_size):
    """Clones, splits (JAX split noise replayed), opacity and size prunes,
    with clone and split caps that overflow and a map nearly full."""
    jm, _ = both_maps(cap=420, n=300, seed=5)
    rng = np.random.default_rng(6)
    jm = jm._replace(
        grad_accum=jnp.asarray(rng.uniform(0, 2e-3, jm.capacity),
                               jnp.float32),
        denom=jnp.asarray(rng.integers(0, 4, jm.capacity), jnp.float32),
        max_radii2d=jnp.ones((jm.capacity,), jnp.float32))
    tm = port_map(jm)
    key = jax.random.PRNGKey(9)
    args = (2e-4, 0.005, 6.0, max_screen_size, jgm.MapHyper())
    a = jgm.densify_and_prune(jm, key, *args, clone_cap=48, split_cap=32)
    noise = t(jax.random.normal(key, (2, 32, 3)))
    b = tgm.densify_and_prune(tm, None, *args[:4], tgm.MapHyper(),
                              clone_cap=48, split_cap=32, samples=noise)
    np.testing.assert_array_equal(npy(b.active), np.asarray(a.active))
    assert_maps_close(b, a, rtol=0.0, atol=1e-6)
    # the map grew, lost its split parents and pruned transparent ones
    assert int(b.n_active) != int(tm.n_active)
    assert float(b.grad_accum.abs().max()) == 0


def test_mean_knn_sq_dist_parity():
    rng = np.random.default_rng(7)
    pts = rng.normal(0, 1, (700, 3)).astype(np.float32)
    valid = rng.uniform(size=700) < 0.8
    a = np.asarray(jknn.mean_knn_sq_dist(jnp.asarray(pts),
                                         jnp.asarray(valid), k=3, chunk=256))
    b = npy(tknn.mean_knn_sq_dist(t(pts), torch.from_numpy(valid), k=3,
                                  chunk=256))
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6 * a.max())
    assert (b[~valid] == 0).all() and (b[valid] > 0).all()


@pytest.mark.parametrize("adaptive", [False, True])
def test_keyframe_to_gaussians_parity(adaptive):
    rng = np.random.default_rng(8)
    h, w = 24, 32
    intr = dict(fx=30.0, fy=30.0, cx=15.5, cy=11.5, width=w, height=h)
    img = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    depth = rng.uniform(1.0, 4.0, (h, w)).astype(np.float32)
    depth[rng.uniform(size=(h, w)) < 0.1] = 0.0
    T = np.asarray(jse3.se3_exp(small_tau(9, 0.1)))
    key = jax.random.PRNGKey(4)
    ea, eb = np.float32(1.05), np.float32(-0.02)
    cap = 400
    jl, jc = jins.keyframe_to_gaussians(
        key, jnp.asarray(img), jnp.asarray(depth), jnp.asarray(T), ea, eb,
        JIntr(**intr), cap, 1, 2.0, 0.05, adaptive)
    tl, tc = tins.keyframe_to_gaussians(
        t(img), t(depth), t(T), torch.tensor(ea), torch.tensor(eb),
        TIntr(**intr), cap, 1, 2.0, 0.05, adaptive,
        keep_draw=t(jax.random.uniform(key, (h, w))))
    assert int(tc) == int(jc) and 0 < int(tc) < cap
    for k, rt in zip(LEAVES, (1e-5, 1e-6, 1e-4, 0, 0)):
        np.testing.assert_allclose(npy(getattr(tl, k)),
                                   np.asarray(getattr(jl, k)), rtol=rt,
                                   atol=1e-6, err_msg=k)


def test_ssim_psnr_parity():
    rng = np.random.default_rng(10)
    a = rng.uniform(0, 1, (3, 40, 52)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(timage.ssim(t(a), t(b))),
                               float(jimage.ssim(a, b)), rtol=1e-5)
    np.testing.assert_allclose(float(timage.psnr(t(a), t(b))),
                               float(jimage.psnr(a, b)), rtol=1e-5)
    x = t(a).requires_grad_(True)
    timage.ssim(x, t(b)).backward()
    ref = np.asarray(jax.grad(lambda y: jimage.ssim(y, b))(a))
    np.testing.assert_allclose(npy(x.grad), ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("init", [False, True])
def test_mapping_losses_parity(init):
    """Values and gradients of the mapping L1 losses (image, depth and the
    exposure) and of the isotropic regulariser; some residuals and scale
    deviations are exactly 0, where |x|'s slope follows jnp.abs."""
    rng = np.random.default_rng(11)
    h, w = 12, 16
    img = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    gt = img.copy()
    gt[:, :6] += rng.normal(0, 0.1, (3, 6, w)).astype(np.float32)
    dep = rng.uniform(1, 3, (1, h, w)).astype(np.float32)
    gtd = dep + rng.normal(0, 0.1, dep.shape).astype(np.float32)
    gtd[0, :3] = 0.0
    mask = (rng.uniform(size=(1, h, w)) > 0.2).astype(np.float32)
    ea, eb = np.float32(1.1), np.float32(0.02)

    def jl(i, d_, a, b_):
        return (jlosses.mapping_loss_rgb(i, gt, mask, a, b_, init),
                jlosses.mapping_loss_rgbd(i, d_, gt, gtd, mask, a, b_, 0.9,
                                          init))

    for which in (0, 1):
        ref_v, ref_g = jax.value_and_grad(
            lambda *a: jl(*a)[which], argnums=(0, 1, 2, 3))(img, dep, ea, eb)
        xs = [t(x).requires_grad_(True) for x in (img, dep)] + [
            torch.tensor(v, requires_grad=True) for v in (ea, eb)]
        fn = (tlosses.mapping_loss_rgb(xs[0], t(gt), t(mask), xs[2], xs[3],
                                       init) if which == 0 else
              tlosses.mapping_loss_rgbd(xs[0], xs[1], t(gt), t(gtd), t(mask),
                                        xs[2], xs[3], 0.9, init))
        fn.backward()
        np.testing.assert_allclose(float(fn.detach()), float(ref_v),
                                   rtol=1e-5)
        for x, r in zip(xs, ref_g):
            got = np.zeros_like(np.asarray(r)) if x.grad is None else npy(
                x.grad)
            np.testing.assert_allclose(got, np.asarray(r), rtol=1e-4,
                                       atol=1e-6 * max(np.abs(r).max(), 1e-6))

    s = np.exp(rng.normal(-3, 0.5, (50, 3))).astype(np.float32)
    s[:10] = s[:10, :1]                       # isotropic rows: |dev| at 0
    act = rng.uniform(size=50) < 0.7
    ref_v, ref_g = jax.value_and_grad(jlosses.isotropic_reg)(
        s, jnp.asarray(act))
    x = t(s).requires_grad_(True)
    v = tlosses.isotropic_reg(x, torch.from_numpy(act))
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(ref_v), rtol=1e-5)
    np.testing.assert_allclose(npy(x.grad), np.asarray(ref_g), rtol=1e-5,
                               atol=1e-9)
