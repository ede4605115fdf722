"""Parity of the PyTorch port's small ops (monogs_tpu_torch.ops) with the
JAX package: SE(3), spherical harmonics, the signed sqrt-Huber and its
forward-mode slope, the count sketch with an injected draw, the damped
solve, the frame masks and the median depth.

Inputs are made with numpy from a seed and handed to both packages. The
helpers at the top (scenes, conversion) are shared by the other
``test_torch_*`` files.

Tolerances: elementwise f32 math in both packages rounds alike, so values
agree to a few ulps (``rtol 1e-6``); products of 4x4 matrices and the 8x8
solve reassociate sums (``rtol 1e-5`` / ``1e-4``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.ops import image as jimage
from monogs_tpu.ops import losses as jlosses
from monogs_tpu.ops import se3 as jse3
from monogs_tpu.ops import sh as jsh
from monogs_tpu.ops import sketch as jsketch
from monogs_tpu.render.renderer import GaussianArrays as JGauss
from monogs_tpu_torch.convert import gaussians_from_numpy
from monogs_tpu_torch.ops import image as timage
from monogs_tpu_torch.ops import losses as tlosses
from monogs_tpu_torch.ops import se3 as tse3
from monogs_tpu_torch.ops import sh as tsh
from monogs_tpu_torch.ops import sketch as tsketch
from tests.torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"


# ------------------------------------------------------------- shared helpers

def t(x):
    """numpy / jax array -> float32 (or bool / int) CPU tensor."""
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True))


def npy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def blob_scene(n, seed, spread=1.0, z0=3.0):
    """Random Gaussian blobs in front of the camera (tests/test_render.py's
    make_scene, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([spread * rng.standard_normal((n, 2)),
                          z0 + 0.5 * rng.standard_normal((n, 1))], axis=-1)
    return dict(
        xyz=xyz, sh=rng.uniform(-1.0, 1.0, (n, 1, 3)),
        log_scale=np.log(0.05 + 0.1 * rng.uniform(size=(n, 3))),
        quat=rng.standard_normal((n, 4)) + np.array([2.0, 0, 0, 0]),
        opa_logit=np.full((n, 1), 1.5), active=np.ones((n,), bool))


def surface_scene(n, seed, spread=2.5, depth_mean=3.5, depth_spread=0.5,
                  scale_min=0.02, scale_max=0.08):
    """An opaque textured bumpy surface with foreground clusters, the shape
    of data/synthetic.make_synthetic_scene, drawn with numpy."""
    rng = np.random.default_rng(seed)
    xy = spread * rng.uniform(-1.0, 1.0, (n, 2))
    x, y = xy[:, 0], xy[:, 1]
    z = depth_mean + depth_spread * (
        0.5 * np.sin(1.7 * x + 0.3) * np.cos(1.3 * y + 1.1)
        + 0.3 * np.sin(3.1 * x + 2.0) + 0.2 * np.cos(2.3 * y + 0.7))
    nc = 6
    centers = spread * 0.7 * rng.uniform(-1.0, 1.0, (nc, 2))
    cdepths = depth_mean * (0.35 + 0.4 * rng.uniform(size=nc))
    assign = rng.integers(0, 4 * nc, n)
    inc = assign < nc
    ci = np.clip(assign, 0, nc - 1)
    lx = centers[ci, 0] + 0.22 * spread * np.sin(13.7 * x + 5 * y)
    ly = centers[ci, 1] + 0.22 * spread * np.cos(11.3 * y + 7 * x)
    x, y = np.where(inc, lx, x), np.where(inc, ly, y)
    z = np.where(inc, cdepths[ci] + 0.1 * np.sin(21.0 * (x + y)), z)
    base = np.stack([0.5 + 0.35 * np.sin(3.0 * x + 1.0) * np.cos(2.0 * y),
                     0.5 + 0.35 * np.sin(2.2 * y + 0.5) * np.cos(1.5 * x + 2.2),
                     0.5 + 0.35 * np.sin(2.7 * (x + y) + 1.7)], -1)
    rgb = np.clip(base + 0.15 * rng.uniform(-1.0, 1.0, (n, 3)), 0.02, 0.98)
    return dict(
        xyz=np.stack([x, y, z], -1),
        sh=((rgb - 0.5) / 0.28209479177387814)[:, None, :],
        log_scale=np.log(scale_min + (scale_max - scale_min)
                         * rng.uniform(size=(n, 3))),
        quat=rng.standard_normal((n, 4)) * 0.2 + np.array([3.0, 0, 0, 0]),
        opa_logit=np.full((n, 1), 4.0), active=np.ones((n,), bool))


def both_gauss(sc):
    """(JAX GaussianArrays, port GaussianArrays) of one numpy scene."""
    jg = JGauss(**{k: jnp.asarray(v.astype(np.float32) if v.dtype != bool
                                  else v) for k, v in sc.items()})
    return jg, gaussians_from_numpy(device=CPU, **sc)


def small_tau(seed, scale):
    return (scale * np.random.default_rng(seed).standard_normal(6)).astype(
        np.float32)


# ----------------------------------------------------------------------- se3

@pytest.mark.parametrize("scale", [0.0, 1e-4, 0.3, 2.0])
def test_se3_exp_log_family(scale):
    """skew, so3_exp, the left Jacobian and se3_exp, across the small-angle
    series (|theta| < 1e-5 uses the Taylor branches) and large angles."""
    rng = np.random.default_rng(1)
    taus = (scale * rng.standard_normal((5, 6))).astype(np.float32)
    for tau in taus:
        th = tau[3:]
        np.testing.assert_allclose(npy(tse3.skew(t(th))), jse3.skew(th),
                                   rtol=1e-6)
        np.testing.assert_allclose(npy(tse3.so3_exp(t(th))), jse3.so3_exp(th),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(npy(tse3.so3_left_jacobian(t(th))),
                                   jse3.so3_left_jacobian(th),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(npy(tse3.se3_exp(t(tau))),
                                   jse3.se3_exp(tau), rtol=1e-5, atol=1e-7)


def test_se3_retract_inverse_pose_diff():
    T = np.asarray(jse3.se3_exp(small_tau(2, 0.4)))
    tau = small_tau(3, 0.01)
    np.testing.assert_allclose(npy(tse3.retract(t(T), t(tau))),
                               jse3.retract(T, tau), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(npy(tse3.se3_inverse(t(T))),
                               jse3.se3_inverse(T), rtol=1e-5, atol=1e-7)
    T2 = np.asarray(jse3.retract(T, tau))
    a, b = tse3.pose_diff(t(T), t(T2))
    ja, jb = jse3.pose_diff(T, T2)
    np.testing.assert_allclose(float(a), float(ja), rtol=1e-5)
    np.testing.assert_allclose(float(b), float(jb), rtol=1e-3, atol=1e-4)


def test_quat_to_rotmat():
    q = np.random.default_rng(4).standard_normal((32, 4)).astype(np.float32)
    np.testing.assert_allclose(npy(tse3.quat_to_rotmat(t(q))),
                               jse3.quat_to_rotmat(q), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------------ sh

@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh(deg):
    rng = np.random.default_rng(deg)
    sh = rng.standard_normal((40, 3, (deg + 1) ** 2)).astype(np.float32)
    dirs = rng.standard_normal((40, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    np.testing.assert_allclose(npy(tsh.eval_sh(deg, t(sh), t(dirs))),
                               jsh.eval_sh(deg, sh, dirs), rtol=1e-5,
                               atol=1e-6)
    rgb = rng.uniform(size=(10, 3)).astype(np.float32)
    np.testing.assert_allclose(npy(tsh.rgb_to_sh(t(rgb))), jsh.rgb_to_sh(rgb),
                               rtol=1e-6)
    assert tsh.C0 == jsh.C0


# --------------------------------------------------------------------- huber

def test_huber_value_and_forward_slope():
    """huber_signed's value, its reverse-mode slope and its forward-mode
    slope (torch.func.jvp and torch.autograd.forward_ad) all equal the JAX
    custom_jvp's."""
    delta = 0.01
    x = np.random.default_rng(5).uniform(-0.05, 0.05, 257).astype(np.float32)
    x[:3] = [0.0, delta, -delta]
    dx = np.random.default_rng(6).standard_normal(257).astype(np.float32)
    jv, jt = jax.jvp(lambda z: jlosses.huber_signed(z, delta), (x,), (dx,))
    tv, tt = torch.func.jvp(lambda z: tlosses.huber_signed(z, delta),
                            (t(x),), (t(dx),))
    np.testing.assert_allclose(npy(tv), jv, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(npy(tt), jt, rtol=1e-6, atol=1e-9)
    import torch.autograd.forward_ad as fwAD
    with fwAD.dual_level():
        out = tlosses.huber_signed(fwAD.make_dual(t(x), t(dx)), delta)
        np.testing.assert_allclose(npy(fwAD.unpack_dual(out).tangent), jt,
                                   rtol=1e-6, atol=1e-9)
    xr = t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(tlosses.huber_signed(xr, delta).sum(), xr)
    jg = jax.grad(lambda z: jnp.sum(jlosses.huber_signed(z, delta)))(x)
    np.testing.assert_allclose(npy(g), jg, rtol=1e-6)


def test_residual_and_median_depth():
    rng = np.random.default_rng(7)
    img, gt = rng.uniform(size=(2, 3, 12, 16)).astype(np.float32)
    opa = rng.uniform(0.9, 1.0, (1, 12, 16)).astype(np.float32)
    mask = (rng.uniform(size=(1, 12, 16)) > 0.3).astype(np.float32)
    ea, eb = np.float32(-1.1), np.float32(0.02)
    np.testing.assert_allclose(
        npy(tlosses.tracking_residual_rgb(t(img), t(gt), t(opa), t(mask),
                                          torch.tensor(ea), torch.tensor(eb))),
        jlosses.tracking_residual_rgb(img, gt, opa, mask, ea, eb), rtol=1e-6,
        atol=1e-7)
    depth = rng.uniform(0.0, 4.0, (1, 12, 16)).astype(np.float32)
    depth[0, :3] = 0.0
    for kw in ({}, {"opacity": opa}):
        jm = jlosses.get_median_depth(depth, **kw)
        tm = tlosses.get_median_depth(t(depth), **{k: t(v) for k, v in
                                                   kw.items()})
        assert float(tm) == float(jm)


# -------------------------------------------------------------------- sketch

def test_sketch_with_injected_draw_and_damped_solve():
    m, stack, sk = 1000, 4, 8
    jspec = jsketch.make_sketch(jax.random.PRNGKey(3), m, stack, sk)
    tspec = tsketch.sketch_from_draw(t(jspec.perm), t(jspec.signs), m, stack,
                                     sk)
    assert (tspec.d, tspec.chunk) == (jspec.d, jspec.chunk)
    rng = np.random.default_rng(8)
    r = rng.standard_normal(m).astype(np.float32)
    cols = rng.standard_normal((8, m)).astype(np.float32)
    Sf = jsketch.apply_sketch(r, jspec)
    np.testing.assert_allclose(npy(tsketch.apply_sketch(t(r), tspec)), Sf,
                               rtol=1e-5, atol=1e-5)
    SJ = jnp.stack([jsketch.apply_sketch(c, jspec) for c in cols], axis=1)
    tSJ = tsketch.apply_sketch(t(cols), tspec).T
    np.testing.assert_allclose(npy(tSJ), SJ, rtol=1e-5, atol=1e-5)
    x = jsketch.damped_lstsq(SJ, Sf, jnp.float32(1e-3))
    tx = tsketch.damped_lstsq(t(SJ), t(Sf), torch.tensor(1e-3))
    np.testing.assert_allclose(npy(tx), x, rtol=1e-4, atol=1e-6)
    # a generator draw has the same structure
    g = torch.Generator().manual_seed(0)
    spec = tsketch.make_sketch(g, m, stack, sk)
    assert spec.perm.shape == (spec.d * spec.chunk,)
    assert len(set(spec.perm.tolist())) == spec.perm.numel()
    assert set(spec.signs.tolist()) == {-1.0, 1.0}


# --------------------------------------------------------------------- image

@pytest.mark.parametrize("dataset_type", ["tum", "replica"])
def test_compute_grad_mask(dataset_type):
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:64, 0:96].astype(np.float32)
    img = np.stack([0.5 + 0.4 * np.sin(0.2 * xx + c) * np.cos(0.13 * yy)
                    for c in range(3)]) + 0.05 * rng.uniform(size=(3, 64, 96))
    img[:, :4] = 0.0                    # a dark band exercises the boundary
    img = img.astype(np.float32)
    jt_, jm_ = jimage.compute_grad_mask(img, 1.1, 0.01, dataset_type)
    tt_, tm_ = timage.compute_grad_mask(t(img), 1.1, 0.01, dataset_type)
    np.testing.assert_array_equal(npy(tm_), np.asarray(jm_))
    np.testing.assert_array_equal(npy(tt_), np.asarray(jt_))
    x = t(img.reshape(-1))
    assert float(timage.torch_median(x)) == float(
        jimage.torch_median(img.reshape(-1)))


# ------------------------------------------------ functions nothing calls yet

def _leftover(case, rng):
    """(JAX value, port value, rtol, atol) of one leftover function on
    inputs drawn from ``rng``."""
    from monogs_tpu.ops import scan as jscan
    from monogs_tpu.render import camera as jcam
    from monogs_tpu.render import tiling as jtiling
    from monogs_tpu_torch.ops import scan as tscan
    from monogs_tpu_torch.render import camera as tcam
    from monogs_tpu_torch.render import tiling as ttiling

    f32 = np.float32
    if case == "relative_pose_error":
        P = [np.asarray(jse3.se3_exp(jnp.asarray(small_tau(i, 0.3))))
             for i in range(4)]
        return (jse3.relative_pose_error(*P),
                tse3.relative_pose_error(*map(t, P)), 1e-5, 1e-6)
    if case == "sh_to_rgb":
        sh = rng.standard_normal((50, 1, 3)).astype(f32)
        return jsh.sh_to_rgb(sh), tsh.sh_to_rgb(t(sh)), 1e-6, 0.0
    if case in ("blocked_cumsum_float", "blocked_cumsum_int"):
        if case.endswith("int"):
            x = rng.integers(0, 50, (3, 700)).astype(np.int32)
        else:
            x = rng.uniform(-1.0, 1.0, (3, 700)).astype(f32)
        return (jscan.blocked_cumsum(jnp.asarray(x), block=256),
                tscan.blocked_cumsum(torch.from_numpy(x), block=256),
                1e-5, 1e-4)
    intr = jcam.Intrinsics(fx=80.0, fy=82.0, cx=31.5, cy=23.5, width=64,
                           height=48)
    if case == "project_points":
        p = np.concatenate([rng.standard_normal((100, 2)),
                            rng.uniform(-0.5, 4.0, (100, 1))], -1).astype(f32)
        return (jcam.project_points(jnp.asarray(p), intr),
                tcam.project_points(t(p), tcam.Intrinsics(*intr)), 1e-6, 1e-5)
    if case == "tile_overlap_mask":
        m2 = rng.uniform(-10.0, 70.0, (200, 2)).astype(f32)
        rad = rng.uniform(0.0, 12.0, (200,)).astype(f32)
        vld = rng.uniform(size=200) > 0.2
        return (jtiling.tile_overlap_mask(m2, rad, vld, 16, 0, 32, 16),
                ttiling.tile_overlap_mask(t(m2), t(rad), t(vld), 16, 0, 32,
                                          16), 0.0, 0.0)
    img, gt = (rng.uniform(size=(3, 48, 64)).astype(f32) for _ in range(2))
    opa = rng.uniform(0.8, 1.0, (1, 48, 64)).astype(f32)
    mask = (rng.uniform(size=(1, 48, 64)) > 0.3).astype(f32)
    dep = rng.uniform(0.0, 3.0, (1, 48, 64)).astype(f32)
    gtd = rng.uniform(0.0, 3.0, (1, 48, 64)).astype(f32)
    if case == "tracking_loss_scalar_rgb":
        return (jlosses.tracking_loss_scalar_rgb(img, gt, opa, mask, 1.1,
                                                 0.02),
                tlosses.tracking_loss_scalar_rgb(
                    t(img), t(gt), t(opa), t(mask), torch.tensor(1.1),
                    torch.tensor(0.02)), 1e-5, 0.0)
    if case == "tracking_loss_scalar_rgbd":
        return (jlosses.tracking_loss_scalar_rgbd(img, dep, gt, gtd, opa,
                                                  mask, 1.1, 0.02, 0.9),
                tlosses.tracking_loss_scalar_rgbd(
                    t(img), t(dep), t(gt), t(gtd), t(opa), t(mask),
                    torch.tensor(1.1), torch.tensor(0.02), 0.9), 1e-5, 0.0)
    assert case == "median_depth_std"
    dep[0, :5] = 0.0
    return (jlosses.get_median_depth(dep, opa, return_std=True),
            tlosses.get_median_depth(t(dep), t(opa), return_std=True),
            1e-5, 0.0)


@pytest.mark.parametrize("case", [
    "relative_pose_error", "sh_to_rgb", "blocked_cumsum_float",
    "blocked_cumsum_int", "project_points", "tile_overlap_mask",
    "tracking_loss_scalar_rgb", "tracking_loss_scalar_rgbd",
    "median_depth_std"])
def test_leftovers_match_jax(case):
    """The JAX package's small functions that nothing in the port calls yet
    (se3, sh, scan, camera, tiling, the scalar tracking losses, the median
    depth's spread), against the JAX package on the same inputs. Elementwise
    math to a few ulps; reassociated sums (the blocked cumsum's products,
    the means) to rtol 1e-5; integer sums, masks and the median exactly."""
    want, got, rtol, atol = _leftover(case, np.random.default_rng(3))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w, g = np.asarray(w), npy(g)
        assert w.shape == g.shape and w.dtype == g.dtype, (w.dtype, g.dtype)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
