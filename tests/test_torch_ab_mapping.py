"""The mapping A/B knobs against the JAX package (pallas_lists in interpret
mode), at the sizes of test_torch_mapping.py (64x48, 300 Gaussians in a
map of capacity 1024, k_fine 128):

- the fused mapping kernel's ``madd`` variant (plain version) on raw
  gathered rows against ``map_grad_lists_pallas(madd=)``, mono and RGB-D,
  bit for bit against the plain version on the pre-masked rows, and
  against float64;
- ``render_map_grad`` with ``sortperm`` (the frozen-permutation pull-back)
  and with ``gather_first`` (all tiles and a half-tile subset);
- ``map_iters`` for three iterations with each of ``io_batch``,
  ``scatter_segsum``, ``gather_first`` (with and without ``tile_frac``)
  and ``batch_render``, against the JAX package with the same knob (its
  draws replayed), and against the port's own default branch on the same
  draws;
- ``render_batch``, ``render_tiles`` ("pallas_lists" and "xla", with the
  pose gradient) and ``render_pose_jvp`` (all tiles and a subset).

Tolerances, as test_torch_mapping.py: row cotangents rtol 1e-3 plus 1e-4
(colour) or 4e-3 (depth) of the column's largest magnitude, per-tile sums
rtol 1e-4; losses rtol 2e-5, map, pose and offset gradients atol 5e-5,
exposure gradients rtol 5e-5; after three ``map_iters`` iterations, the
port's knob against its own default branch: parameters atol 1e-4, poses
and exposures 1e-6, visibility exact. Against the JAX package, the bound
of test_torch_mapping_backends.py for rows at a threshold: the Pallas
kernel's bf16x3 sums round the transmittance otherwise, a row at the 1/255
or 1e-4 test can flip, and Adam turns the Gaussian's changed gradient into
a good part of a learning-rate step (with the JAX key 4 at tile_frac 0.5,
one Gaussian's position by 6.4e-4 in the third iteration, on the default
branch as with gather_first): at most 0.5 % of the parameters beyond 1e-4,
none beyond 1e-3, poses and exposures 1e-5, visibility exact; renders
as test_torch_render.py (image and opacity atol 2e-5, depth 2e-4,
tangents rtol 1e-3 plus 2e-4 of the channel maximum). The knobs change only
the order of float32 additions against the default branch (a fixed-order
sum against autograd's gather transpose), so the port's knob against its
own default is held to the same bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.models import gaussian_map as jgm
from monogs_tpu.ops import se3 as jse3
from monogs_tpu.render import pallas_lists as jpl
from monogs_tpu.render import renderer as jr
from monogs_tpu.slam import mapping as jmap
from monogs_tpu_torch.models import gaussian_map as tgm
from monogs_tpu_torch.render import blend_lists as tbl
from monogs_tpu_torch.render import renderer as tr
from monogs_tpu_torch.slam import mapping as tmap
from tests.test_torch_blend_lists import assert_per_column
from tests.test_torch_map import LEAVES
from tests.test_torch_mapping import (
    JC, JI, MCFG, TC, TI, W, H, cam_batch, map_grad_inputs,
    noisy, replay_map_draws, tiled_truth, world,
)
from tests.test_torch_ops import both_gauss, npy, small_tau, surface_scene, t

N_ITERS = 3
_jmap_grad_knob = jax.jit(jr.render_map_grad, static_argnums=(2, 3, 11, 12),
                          static_argnames=("px_frac", "gather_first"))


# ---------------------------------------------------------- the madd kernel

def madd_rows(scene):
    """(raw rows packed[idx] [Tf, Kf, F], madd [Tf, Kf], masked rows, tx0,
    ty0, pmat, gt, mask, gt depth) over margin lists: the list slots past a
    tile's valid entries hold Gaussian 0's real row, so only madd keeps
    them out of the blend. ``scene``: "blend" (the dense scene of
    test_torch_blend_lists.rows, seed 4, at k_fine 256, which leaves list
    slots empty) or "map" (a view of test_torch_mapping's map)."""
    if scene == "blend":
        sc = surface_scene(500, 4, spread=1.6, depth_mean=3.0,
                           scale_min=0.08, scale_max=0.25)
        g = both_gauss(sc)[1]
        T = t(np.asarray(jse3.se3_exp(small_tau(5, 0.02))))
    else:
        _, tm, views = world(seed=2, n_views=1)
        g, T = tm.render_view(), t(views[0][2])
    cfg = TC._replace(k_fine=256 if scene == "blend" else 128)
    lists = tr.build_tile_lists(g, T, TI, cfg, margin=4.0)
    prep, packed, _, _ = tr._project(g, T, TI, cfg, lists=lists)
    vld = lists.vld & prep.valid[lists.idx]
    raw = packed[lists.idx].contiguous()
    madd = torch.where(vld, 0.0, -1e30).to(torch.float32)
    masked = tr._masked_rows(raw, vld)
    tx0, ty0 = tr._tile_origins(TI, TC, "cpu")
    pmat = tr._tile_pmat(TC, "cpu")
    gt, mask, gtd = tiled_truth(masked, tx0, ty0, pmat, 6)
    assert not bool(vld.all()) and float(raw[~vld][:, tbl._LOGO].max()) > -50
    return raw, madd, masked, tx0, ty0, pmat, gt, mask, gtd


@pytest.fixture(scope="module", params=["blend", "map"])
def madd_case(request):
    return request.param, madd_rows(request.param)


@pytest.mark.parametrize("rgbd", [False, True])
def test_map_grad_madd_parity(madd_case, rgbd):
    """The plain madd version on raw rows: bit for bit the plain version on
    the pre-masked rows (the kernel's contract on the card, as the Pallas
    kernel's with_madd variant equals its masked call); within 1e-4 of the
    column maximum of the same function in float64; and against the Pallas
    kernel's with_madd variant on the blend tests' rows. On the map view
    the Pallas kernel's bf16x3 reductions err by up to 8 % of the u
    column's maximum against float64 (a row near the image edge, where
    the conic moments cancel), where the plain float32 version errs by
    3e-6 of it, and its colours move a residual's sign where the
    residual is near 0: there the port is held to float64 and the JAX
    package's with_madd call to its own masked call."""
    scene, (raw, madd, masked, tx0, ty0, pmat, gt, mask, gtd) = madd_case
    ea, eb = np.float32(1.06), np.float32(0.01)
    alpha = 0.9 if rgbd else 1.0
    gtd_t = t(gtd) if rgbd else None
    args = (tx0, ty0, pmat, t(gt), t(mask), torch.tensor(ea),
            torch.tensor(eb), W, H, True, alpha, 1e-8)
    dd, sums = tbl.map_grad_lists(raw, *args, gtd_t=gtd_t, madd=madd)
    m_dd, m_sums = tbl.map_grad_lists(masked, *args, gtd_t=gtd_t)
    assert torch.equal(dd, m_dd) and torch.equal(sums, m_sums)
    dd64, _ = tbl.map_grad_lists_plain(
        raw.double(), *(x.double() if torch.is_tensor(x) else x
                        for x in args),
        gtd_t=None if gtd_t is None else gtd_t.double(), madd=madd.double())
    assert_per_column(npy(dd), npy(dd64), 1e-4, "dd vs float64")

    def jax_call(d, m=None):
        return jpl.map_grad_lists_pallas(
            *(jnp.asarray(npy(x)) for x in (d, tx0, ty0, pmat)),
            jnp.asarray(gt), jnp.asarray(mask), jnp.float32(ea),
            jnp.float32(eb), 16, W, H, True, True, alpha, 1e-8,
            gtd_t=jnp.asarray(gtd) if rgbd else None,
            madd=None if m is None else jnp.asarray(npy(m)))

    ref_dd, ref_s = jax_call(raw, madd)
    m_ref_dd, m_ref_s = jax_call(masked)
    np.testing.assert_array_equal(np.asarray(ref_dd), np.asarray(m_ref_dd))
    np.testing.assert_array_equal(np.asarray(ref_s), np.asarray(m_ref_s))
    if scene == "blend":
        assert_per_column(npy(dd), np.asarray(ref_dd),
                          4e-3 if rgbd else 1e-4, "dd")
        np.testing.assert_allclose(npy(sums), np.asarray(ref_s), rtol=1e-4,
                                   atol=1e-5)
    assert float(sums[:, 0].sum()) > 0 and float(torch.abs(dd).max()) > 0


# ------------------------------------------------ render_map_grad's knobs

@pytest.fixture(scope="module")
def grad_inputs():
    """map_grad_inputs(3, rgbd, subset), built once per (rgbd, subset) and
    shared by the knobs (the JAX binning and renders of the view run once
    each)."""
    cache = {}

    def get(rgbd, subset):
        if (rgbd, subset) not in cache:
            cache[rgbd, subset] = map_grad_inputs(3, rgbd, subset)
        ja, ta, kj, kt = cache[rgbd, subset]
        return ja, ta, dict(kj), dict(kt)

    return get


@pytest.mark.parametrize("rgbd", [False, True])
@pytest.mark.parametrize("knob", ["sortperm", "gather_first",
                                  "gather_first_subset"])
def test_render_map_grad_knob_parity(grad_inputs, knob, rgbd):
    """Loss and every gradient with the knob against the JAX package with
    the same knob; radii exact."""
    ja, ta, kj, kt = grad_inputs(rgbd, knob.endswith("subset"))
    if knob == "sortperm":
        flat = ta[4].idx.reshape(-1)
        perm = torch.argsort(flat, stable=True)
        jflat = ja[4].idx.reshape(-1)
        jperm = jnp.argsort(jflat).astype(jnp.int32)
        np.testing.assert_array_equal(npy(flat[perm]),
                                      np.asarray(jflat[jperm]))
        kj = dict(kj, sortperm=(jperm, jflat[jperm]))
        kt = dict(kt, sortperm=(perm, flat[perm]))
    else:
        kj = dict(kj, gather_first=True)
        kt = dict(kt, gather_first=True)
    a = _jmap_grad_knob(*ja, False, 0.9, **kj)
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


# ------------------------------------------------------------ map_iters

KNOBS = {
    "io_batch": dict(io_batch=True),
    "scatter_segsum": dict(scatter_segsum=True),
    "gather_first": dict(gather_first=True),
    "gather_first_tile_frac": dict(gather_first=True, tile_frac=0.5),
    "batch_render": dict(batch_render=True, fused_grad=False, monocular=True),
}


@pytest.fixture(scope="module")
def window():
    jm, _, views = world(seed=5)
    jm, tm = noisy(jm)
    opt = np.array([False, True, True])
    return (jm, tm) + cam_batch(views, opt_pose=opt, opt_exposure=opt)


def run_port(window, mc, draws):
    _, tm, _, tcam = window
    return tmap.map_iters(tm, tcam, N_ITERS, 2, None, TI, TC,
                          tmap.MapConfig(**mc), tgm.MapHyper(), draws=draws)


@pytest.fixture(scope="module")
def default_runs(window):
    """The port's default branch on the window, run once per configuration
    and shared by the knobs that compare with it (io_batch, scatter_segsum
    and gather_first share one: the same configuration and, at tile_frac
    1.0, the same draws)."""
    cache = {}

    def get(base, draws):
        key = tuple(sorted(base.items()))
        if key not in cache:
            cache[key] = run_port(window, base, draws)
        return cache[key]

    return get


def assert_same_result(b, a, threshold_flips=False):
    """Port result ``b`` against a JAX tuple or another port result ``a``.
    ``threshold_flips``: at most 0.5 % of the parameters beyond 1e-4 and
    none beyond 1e-3, poses and exposures within 1e-5."""
    if isinstance(a, tmap.MapResult):
        a = (a.m, a.cams, a.it_count, a.visibility)
    for k in LEAVES:
        x, r = npy(getattr(b.m.params, k)), npy(getattr(a[0].params, k))
        if threshold_flips:
            err = np.abs(x - r)
            assert (err > 1e-4).mean() <= 0.005, (k, (err > 1e-4).sum())
        np.testing.assert_allclose(x, r, atol=1e-3 if threshold_flips
                                   else 1e-4, err_msg=k)
    for k in ("T", "ea", "eb"):
        np.testing.assert_allclose(npy(getattr(b.cams, k)),
                                   npy(getattr(a[1], k)),
                                   atol=1e-5 if threshold_flips else 1e-6,
                                   err_msg=k)
    assert b.it_count == int(a[2])
    np.testing.assert_array_equal(npy(b.visibility), npy(a[3]))


@pytest.mark.parametrize("knob", list(KNOBS))
def test_map_iters_knob_parity(window, default_runs, knob):
    """Three iterations with the knob through both packages (poses and
    exposures of two views optimised), and the port's knob against its
    own default branch (fused, or unfused per view for batch_render) on
    the same draws."""
    jm, _, jcam, _ = window
    mc = dict(MCFG, **KNOBS[knob])
    jmc = jmap.MapConfig(**mc)
    use_sub = (mc.get("tile_frac", 1.0) < 1.0 and not jmc.io_batch
               and not jmc.scatter_segsum)
    key = jax.random.PRNGKey(4)
    draws = replay_map_draws(key, N_ITERS, 3, 16,
                             jmc if use_sub else jmc._replace(tile_frac=1.0))
    a = jmap.map_iters(jm, jcam, N_ITERS, jnp.int32(2), key, JI, JC, jmc,
                       jgm.MapHyper())
    b = run_port(window, mc, draws)
    assert_same_result(b, a, threshold_flips=True)
    assert float(torch.abs(b.cams.T[1] - window[3].T[1]).max()) > 0
    assert npy(b.visibility).sum() > 0
    base = {k: v for k, v in mc.items() if k not in (
        "io_batch", "scatter_segsum", "gather_first", "batch_render")}
    assert_same_result(b, default_runs(base, draws))


# ------------------------------------------------------- render surface

def test_render_batch_parity():
    """render_batch over three views' frozen lists, with pose tangents and
    screen-space hooks, against the JAX package (its gradients are held
    by test_map_iters_knob_parity[batch_render])."""
    jm, tm, views = world(seed=1)
    Ts = np.stack([v[2] for v in views]).astype(np.float32)
    taus = np.stack([small_tau(50 + i, 0.002) for i in range(3)])
    offs = np.random.default_rng(3).normal(
        0, 0.5, (3, jm.capacity, 2)).astype(np.float32)
    lists_j = jax.vmap(lambda T: jr.build_tile_lists(
        jm.render_view(), T, JI, JC, margin=4.0))(jnp.asarray(Ts))
    lists_t = tr.TileLists(idx=t(lists_j.idx).long(), vld=t(lists_j.vld))
    a = jax.jit(jr.render_batch, static_argnums=(2, 3))(
        jm.render_view(), jnp.asarray(Ts), JI, JC, lists_j,
        taus=jnp.asarray(taus), means2d_offsets=jnp.asarray(offs))
    b = tr.render_batch(tm.render_view(), t(Ts), TI, TC, lists_t,
                        taus=t(taus), means2d_offsets=t(offs))
    for x, r, tol in zip(b[:3], a[:3], (2e-5, 2e-4, 2e-5)):
        assert x.shape == r.shape
        np.testing.assert_allclose(npy(x), np.asarray(r), atol=tol)
    np.testing.assert_array_equal(npy(b[3]), np.asarray(a[3]))
    assert float(b[2].max()) > 0.5


@pytest.mark.parametrize("backend", ["pallas_lists", "xla"])
def test_render_tiles_parity(backend):
    """render_tiles over a 6-tile subset, and the gradient of a weighted
    sum of its outputs in the pose tangent, against the JAX package."""
    jm, tm, views = world(seed=4, n_views=1)
    T = views[0][2]
    lists_j = jr.build_tile_lists(jm.render_view(), jnp.asarray(T), JI, JC,
                                  margin=4.0)
    ts = np.array([0, 3, 5, 8, 12, 15])
    jx, jy = jr._tile_origins(JI, JC)
    tx, ty = tr._tile_origins(TI, TC, "cpu")
    sub_j = jr.TileLists(idx=lists_j.idx[ts], vld=lists_j.vld[ts])
    sub_t = tr.TileLists(idx=t(sub_j.idx).long(), vld=t(sub_j.vld))
    jc, tc = JC._replace(backend=backend), TC._replace(backend=backend)
    w = np.random.default_rng(5).normal(0, 1, (6, 256, 5)).astype(np.float32)
    tau0 = small_tau(9, 0.002)

    def jloss(tau):
        col, dep, acc = jr.render_tiles(jm.render_view(), jnp.asarray(T), JI,
                                        jc, sub_j, jx[ts], jy[ts], tau=tau)
        return (jnp.sum(col * w[..., :3]) + jnp.sum(dep * w[..., 3])
                + jnp.sum(acc * w[..., 4])), (col, dep, acc)

    (_, outs_j), g_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(tau0))
    tau = t(tau0).requires_grad_(True)
    col, dep, acc = tr.render_tiles(tm.render_view(), t(T), TI, tc, sub_t,
                                    tx[ts], ty[ts], tau=tau)
    np.testing.assert_allclose(npy(col), np.asarray(outs_j[0]), atol=2e-5)
    np.testing.assert_allclose(npy(dep), np.asarray(outs_j[1]), atol=2e-4)
    np.testing.assert_allclose(npy(acc), np.asarray(outs_j[2]), atol=2e-5)
    (torch.sum(col * t(w[..., :3])) + torch.sum(dep * t(w[..., 3]))
     + torch.sum(acc * t(w[..., 4]))).backward()
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(npy(tau.grad), g_j, rtol=2e-3,
                               atol=1e-5 * np.abs(g_j).max())
    assert float(acc.max()) > 0.5


@pytest.mark.parametrize("subset", [False, True])
def test_render_pose_jvp_parity(subset):
    """The full-frame primal and six pose tangents (one jvp8 launch) against
    the JAX package, over all tiles and over a tile subset (the others
    zero)."""
    jm, tm, views = world(seed=6, n_views=1)
    T = views[0][2]
    lists_j = jr.build_tile_lists(jm.render_view(), jnp.asarray(T), JI, JC,
                                  margin=4.0)
    lists_t = tr.TileLists(idx=t(lists_j.idx).long(), vld=t(lists_j.vld))
    ts = np.array([1, 2, 6, 9, 10, 14]) if subset else None
    bg = np.array([0.2, 0.4, 0.1], np.float32)
    a = jax.jit(jr.render_pose_jvp, static_argnums=(2, 3))(
        jm.render_view(), jnp.asarray(T), JI, JC, lists_j, bg=jnp.asarray(bg),
        tsel=None if ts is None else jnp.asarray(ts))
    b = tr.render_pose_jvp(tm.render_view(), t(T), TI, TC, lists_t,
                           bg=t(bg), tsel=None if ts is None
                           else torch.from_numpy(ts))
    for x, r, tol in zip(b[:3], a[:3], (2e-5, 2e-4, 2e-5)):
        np.testing.assert_allclose(npy(x), np.asarray(r), atol=tol)
    for x, r in zip(b[3:], a[3:]):
        x, r = npy(x), np.asarray(r)
        assert x.shape == r.shape
        bound = 1e-3 * np.abs(r) + 2e-4 * np.abs(r).max(axis=(0, 2, 3),
                                                         keepdims=True)
        assert np.all(np.abs(x - r) <= bound), np.abs(x - r).max()
    assert np.abs(np.asarray(a[3])).max() > 0
