"""Gaussian-sharded mapping (``monogs_tpu_torch/parallel/gauss.py`` and
``gauss_iters.py``) against the JAX package's ``parallel/gauss.py`` and
``gauss_iters.py`` on its virtual CPU mesh.

The port's ranks are one gloo group of 4 on the CPU, started once for the
module (``parallel.launch.RankGroup``; this process is rank 0). Inputs are
``__graft_entry__._tiny_scene`` in a 512-slot map at 64x64, as the JAX
tests make them (``tests/test_gauss_parallel.py``,
``tests/test_gauss_iters.py``), carried over with ``convert.py``; each JAX
reference runs once, jitted.

Tolerances are the JAX tests': the merged rows' validity bit for bit and
their values within 1e-5 (preprocess runs over [N/D] rows against [N]);
the render atol 1e-4 (depth 1e-3); the loss rtol 2e-5, every gradient leg
under 2e-3 with at most 8 entries over 2e-5 (gate flips), the exposure
gradients rtol 2e-3 atol 1e-4; the loop's poses rtol 1e-5 atol 1e-6,
exposures rtol 1e-5 atol 1e-7, parameters rtol 2e-3 atol 2e-4 and
visibility equal (``test_gauss_iters.py::_check``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from monogs_tpu.parallel import gauss as jgauss
from monogs_tpu.parallel import gauss_iters as jgi
from monogs_tpu.render import Intrinsics as JIntr
from monogs_tpu.render import RenderConfig as JCfg
from monogs_tpu.render import render as jrender
from monogs_tpu.render.renderer import tile_images as jtile_images
from monogs_tpu.slam import mapping as jmap
from monogs_tpu_torch.convert import gaussians_from_numpy
from monogs_tpu_torch.models import gaussian_map as tgm
from monogs_tpu_torch.parallel.launch import RankGroup
from monogs_tpu_torch.render import Intrinsics as TIntr
from monogs_tpu_torch.render import RenderConfig as TCfg
from monogs_tpu_torch.slam import mapping as tmap
from tests import torch_parallel_ranks as pr
from tests.test_torch_mapping import replay_map_draws
from tests.test_torch_parallel_view import (
    CFG, HYPER_J, HYPER_T, INTR, MCFG, make_window, npy, tiny_map,
)
from tests.torch_one_thread import one_torch_thread  # noqa: F401

JI, TI = JIntr(**INTR), TIntr(**INTR)
JC = JCfg(**CFG, with_n_touched=False)
TC = TCfg(**CFG, with_n_touched=False)
# the loop: "pallas_lists" (in interpret mode on the JAX side)
JC_IT = JCfg(**CFG, with_n_touched=True, backend="pallas_lists",
             pallas_interpret=True)
TC_IT = TCfg(**CFG, backend="pallas_lists")
SHAPES = {"gauss4": (1, 4), "view2_gauss2": (2, 2)}


def t(x):
    return torch.from_numpy(np.array(x))


def port_gauss(g):
    return gaussians_from_numpy(*(np.asarray(x) for x in g), device="cpu")


def jax_mesh(shape):
    if shape[0] == 1:
        return Mesh(jax.devices()[:shape[1]], ("gauss",))
    return jgi.make_gauss_mesh2(*shape)


@pytest.fixture(scope="module")
def ranks():
    with RankGroup(4, "gloo", "cpu") as rg:
        yield rg


@pytest.fixture(scope="module")
def scene():
    jm = tiny_map()
    return jm, jm.render_view()


def jax_spmd(fn, gauss, out_specs):
    mesh = jgauss.make_gauss_mesh(4)
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P("gauss"),),
                                 out_specs=out_specs, check_vma=False))(
        jgauss.shard_gauss(gauss, mesh))


@pytest.mark.parametrize("margin", [0.0, 3.0])
def test_gp_tile_rows_match_jax(ranks, scene, margin):
    """The merged rows of 4 shards: the same selection as the JAX merge
    (validity bit for bit), values within the preprocess reassociation."""
    _, gauss = scene
    d4, vld4 = jax_spmd(lambda g: jgauss.gp_tile_rows(
        g, jnp.eye(4), JI, JC, margin=margin), gauss, P())
    d, vld = ranks.call(pr.gauss_rows, (1, 4), port_gauss(gauss),
                        torch.eye(4), TI, TC, margin)
    np.testing.assert_array_equal(npy(vld), np.asarray(vld4))
    ok = np.asarray(vld4)[..., None]
    np.testing.assert_allclose(np.where(ok, npy(d), 0.0),
                               np.where(ok, np.asarray(d4), 0.0),
                               rtol=1e-5, atol=1e-5)
    assert ok.sum() > 0


def test_gp_render_tiles_match_jax(ranks, scene):
    """The Gaussian-sharded render in tile space, margin 0."""
    _, gauss = scene
    c4, dp4, a4 = jax_spmd(lambda g: jgauss.gp_render_tiles(
        g, jnp.eye(4), JI, JC, margin=0.0), gauss, P())
    c, dp, a = ranks.call(pr.gauss_render, (1, 4), port_gauss(gauss),
                          torch.eye(4), TI, TC, 0.0)
    np.testing.assert_allclose(npy(c), np.asarray(c4), atol=1e-4)
    np.testing.assert_allclose(npy(dp), np.asarray(dp4), atol=1e-3)
    np.testing.assert_allclose(npy(a), np.asarray(a4), atol=1e-4)
    assert float(a.max()) > 0.5


def test_gp_map_loss_grad_matches_jax(ranks, scene):
    """One view's loss and each shard's gradients (through the gather's
    local-block backward), gathered in rank order, against JAX's psum
    scatter and rescale."""
    _, gauss = scene
    T = jnp.eye(4)
    gt_img = jnp.clip(jrender(gauss, T, JI, JC).image + 0.05 * jax.random.normal(
        jax.random.PRNGKey(3), (3, 64, 64)), 0, 1)
    gt_t = jtile_images(gt_img, JI, JC)
    mask_t = jtile_images(jnp.ones((1, 64, 64)), JI, JC)
    ea, eb = jnp.float32(1.05), jnp.float32(0.01)
    loss4, g4, gea4, geb4 = jax_spmd(lambda g: jgauss.gp_map_loss_grad(
        g, T, JI, JC, gt_t, mask_t, ea, eb, margin=3.0), gauss,
        (P(), (P("gauss"),) * 5, P(), P()))
    loss, g, gea, geb = ranks.call(
        pr.gauss_grad, (1, 4), port_gauss(gauss), torch.eye(4), TI, TC,
        t(gt_t), t(mask_t), torch.tensor(1.05), torch.tensor(0.01), 3.0)
    np.testing.assert_allclose(float(loss), float(loss4), rtol=2e-5)
    n_loose = 0
    for a, b in zip(g, g4):
        d = np.abs(npy(a) - np.asarray(b))
        n_loose += int((d > 2e-5).sum())
        assert d.max() < 2e-3, d.max()
    assert n_loose <= 8, n_loose
    np.testing.assert_allclose(float(gea), float(gea4), rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(float(geb), float(geb4), rtol=2e-3, atol=1e-4)
    assert float(g[0].abs().max()) > 0


@pytest.fixture(scope="module")
def window():
    return make_window()


def check(out, ref):
    """test_gauss_iters.py::_check."""
    m1, cams1, it1, vis1, ka1 = ref
    assert out.it_count == int(it1)
    np.testing.assert_allclose(npy(out.cams.T), np.asarray(cams1.T),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(npy(out.cams.ea), np.asarray(cams1.ea),
                               rtol=1e-5, atol=1e-7)
    for k in tgm.ParamLeaves._fields:
        np.testing.assert_allclose(npy(getattr(out.m.params, k)),
                                   np.asarray(getattr(m1.params, k)),
                                   rtol=2e-3, atol=2e-4, err_msg=k)
    np.testing.assert_array_equal(npy(out.visibility), np.asarray(vis1))
    assert npy(out.visibility).sum() > 0


@pytest.fixture(scope="module")
def jax_loops(window):
    """JAX ``gp_sharded_map_iters`` on each mesh shape, all tiles and
    tile_frac 0.5."""
    jm, jc, _, _ = window
    out = {}
    for name, shape in SHAPES.items():
        for frac in (1.0, 0.5):
            mcfg = jmap.MapConfig(**MCFG, tile_frac=frac)
            out[name, frac] = jgi.gp_sharded_map_iters(
                jm, jc, 4, 7, jax.random.PRNGKey(3), jax_mesh(shape), JI,
                JC_IT, mcfg, HYPER_J)
    return out


@pytest.mark.parametrize("frac", [1.0, 0.5])
@pytest.mark.parametrize("name", list(SHAPES))
def test_gp_sharded_map_iters_matches_jax(ranks, window, jax_loops, name,
                                          frac):
    """The map sharded over 4 ranks, and over a 2 x 2 ("view", "gauss")
    mesh, 4 iterations below every trigger; at tile_frac 0.5 the JAX
    subsets are replayed (on the 2-D mesh each view group splits the key
    over its 2 local views)."""
    _, _, tm, tc = window
    shape = SHAPES[name]
    mcfg = tmap.MapConfig(**MCFG, tile_frac=frac)
    draws = (replay_map_draws(jax.random.PRNGKey(3), 4, 4 // shape[0], 16,
                              mcfg) if frac < 1.0 else None)
    out = ranks.map_iters(shape, tm, tc, 4, 7, None, TI, TC_IT, mcfg,
                          HYPER_T, draws=draws)
    check(out, jax_loops[name, frac])


def test_gp_map_iters_through_densify_event(ranks, window):
    """Through densify / prune and opacity-reset events on 4 shards
    (test_gauss_iters.py's property test; the caps apply per shard, so no
    equality with one device): finite leaves, the active set within
    capacity, the statistics consumed, visibility, and a second call that
    composes."""
    _, _, tm, tc = window
    rng = np.random.default_rng(11)
    tm = tm._replace(params=tm.params._replace(sh=tm.params.sh + t(
        0.2 * rng.standard_normal(tm.params.sh.shape)).float()))
    mcfg = tmap.MapConfig(**MCFG)._replace(
        gaussian_update_every=2, gaussian_update_offset=0, gaussian_reset=3,
        densify_grad_threshold=1e-9, clone_cap=16, split_cap=8)
    gen = torch.Generator().manual_seed(3)
    out = ranks.map_iters((1, 4), tm, tc, 5, 0, gen, TI, TC_IT, mcfg,
                          HYPER_T)
    assert out.it_count == 5
    for k, x in zip(tgm.ParamLeaves._fields, out.m.params):
        assert bool(torch.isfinite(x).all()), k
    n_act = int(out.m.n_active)
    assert 0 < n_act <= out.m.capacity
    assert bool(torch.isfinite(out.m.grad_accum).all())
    assert bool(out.visibility.any())
    for a in out.kf_adam[:2]:
        assert bool(torch.isfinite(a).all())
    out2 = ranks.map_iters((1, 4), out.m, out.cams, 2, 5, gen, TI, TC_IT,
                           mcfg, HYPER_T, kf_adam=out.kf_adam)
    assert bool(torch.isfinite(out2.m.params.xyz).all())
    assert int(out2.m.n_active) > 0 and out2.it_count == 7


def test_gp_map_iters_initialization_mode(ranks, window):
    """Initialisation (one view, no pose or exposure optimised) on 4
    shards against the port's ``map_iters`` on one device, from a map
    moved off its views (an exactly converged map leaves residuals at the
    rounding level, whose L1 signs are noise; test_gauss_iters.py)."""
    _, _, tm, tc = window
    rng = np.random.default_rng(9)
    tm = tm._replace(params=tm.params._replace(
        xyz=tm.params.xyz + t(0.01 * rng.standard_normal(
            tm.params.xyz.shape)).float(),
        log_scale=tm.params.log_scale + 0.05))
    one = type(tc)(*(x[:1] for x in tc))
    no = torch.zeros(1, dtype=torch.bool)
    one = one._replace(valid=~no, opt_pose=no, opt_exposure=no)
    ref = tmap.map_iters(tm, one, 6, 0, None, TI, TC_IT,
                         tmap.MapConfig(**MCFG), HYPER_T,
                         initialization=True)
    out = ranks.map_iters((1, 4), tm, one, 6, 0, None, TI, TC_IT,
                          tmap.MapConfig(**MCFG), HYPER_T,
                          initialization=True)
    check(out, (ref.m, ref.cams, ref.it_count, ref.visibility, ref.kf_adam))
    assert torch.equal(out.cams.T, one.T)
