"""View-sharded mapping (``monogs_tpu_torch/parallel/mesh.py``) against the
JAX package's ``parallel/mesh.py`` on its virtual CPU mesh.

The port's ranks are one gloo group of 4 on the CPU, started once for the
module (``parallel.launch.RankGroup``; this process is rank 0); a 2-rank
case uses its first two ranks. Inputs are ``__graft_entry__._tiny_scene``
in a 512-slot map and a window of 4 views, made once, as the JAX tests
make them (``tests/test_multichip.py``, ``tests/test_gauss_iters.py``),
and carried over with ``convert.py``; each JAX reference runs once.

Tolerances: ``sharded_map_step`` loss rtol 1e-5, parameters and poses
atol 1e-5 (test_multichip.py); ``sharded_map_iters`` poses atol 1e-5,
visibility exactly equal, window Adam atol 1e-6 (test_multichip.py) and
parameters atol 1e-4, the port-against-JAX bound of ``map_iters``
(test_torch_mapping.py: Adam turns a rounding difference of a small
gradient that changes sign into up to about 1e-3 of a leaf's learning
rate). The port's own ``map_iters`` and its one-rank group give the same
bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from monogs_tpu.models import gaussian_map as jgm
from monogs_tpu.ops import se3 as jse3
from monogs_tpu.parallel import mesh as jmesh
from monogs_tpu.render import Intrinsics as JIntr
from monogs_tpu.render import RenderConfig as JCfg
from monogs_tpu.render import render as jrender
from monogs_tpu.slam import mapping as jmap
from monogs_tpu_torch.convert import cams_from_numpy
from monogs_tpu_torch.models import gaussian_map as tgm
from monogs_tpu_torch.parallel.launch import RankGroup
from monogs_tpu_torch.parallel.mesh import pad_cams
from monogs_tpu_torch.render import Intrinsics as TIntr
from monogs_tpu_torch.render import RenderConfig as TCfg
from monogs_tpu_torch.slam import mapping as tmap
from tests import torch_parallel_ranks as pr
from tests.test_torch_map import port_map
from tests.test_torch_mapping import replay_map_draws
from tests.torch_one_thread import one_torch_thread  # noqa: F401

INTR = dict(fx=80.0, fy=80.0, cx=31.5, cy=31.5, width=64, height=64)
CFG = dict(tile=16, macro_tiles=2, k_macro=256, k_fine=128)
JI, TI = JIntr(**INTR), TIntr(**INTR)
# 4 iterations from it_count 7 stay below every densify, reset and rebin
# trigger (test_gauss_iters.py)
MCFG = dict(monocular=True, window_size=2, pose_window=2, bin_margin=4.0,
            fused_grad=True, vis_from_lists=True)
HYPER_J, HYPER_T = jgm.MapHyper(), tgm.MapHyper()
OPT_POSE = np.array([False, True, True, False])
OPT_EXP = np.array([False, True, True, True])


def npy(x):
    return x.detach().cpu().numpy()


def port_cams(jc):
    return cams_from_numpy(**{k: np.asarray(getattr(jc, k))
                              for k in jc._fields}, device="cpu")


def tiny_map():
    scene = ge._tiny_scene(256)
    leaves = jgm.ParamLeaves(*(jnp.pad(x, ((0, 256),) + ((0, 0),) * (x.ndim - 1))
                               for x in (scene.xyz, scene.sh, scene.log_scale,
                                         scene.quat, scene.opa_logit)))
    return jgm.insert(jgm.new_map(512, sh_degree=0), leaves, jnp.int32(256),
                      kf_id=0)


@pytest.fixture(scope="module")
def ranks():
    with RankGroup(4, "gloo", "cpu") as rg:
        yield rg


def make_window():
    """test_gauss_iters.py's window: 4 views around the scene, the last
    slot invalid, ground truth rendered by the JAX package. Returns the
    JAX map and views and the port's."""
    jm = tiny_map()
    cfg = JCfg(**CFG, with_n_touched=False)
    Ts, gts = [], []
    for i in range(4):
        T = jse3.retract(jnp.eye(4), jnp.array(
            [0.01, -0.005, 0.008, 0.004, -0.006, 0.003]) * i)
        Ts.append(T)
        gts.append(jnp.clip(jrender(jm.render_view(), T, JI, cfg).image,
                            0.0, 1.0))
    jc = jmap.CamBatch(
        gt_image=jnp.stack(gts), gt_depth=jnp.zeros((4, 1, 64, 64)),
        mapping_mask=jnp.ones((4, 1, 64, 64)), T=jnp.stack(Ts),
        ea=jnp.full((4,), 1.05), eb=jnp.full((4,), 0.02),
        valid=jnp.array([True, True, True, False]),
        opt_pose=jnp.asarray(OPT_POSE), opt_exposure=jnp.asarray(OPT_EXP))
    return jm, jc, port_map(jm), port_cams(jc)


@pytest.fixture(scope="module")
def window():
    return make_window()


JC_ITERS = JCfg(**CFG, backend="pallas_lists", pallas_interpret=True)
TC_ITERS = TCfg(**CFG, backend="pallas_lists")


def jax_iters(jm, jc, n_view, mcfg):
    mesh = jmesh.make_mesh(n_view)
    return jmesh.sharded_map_iters(
        jmesh.replicate_map(jm, mesh), jmesh.shard_views(jc, mesh), 4,
        jnp.int32(7), jax.random.PRNGKey(3), mesh, JI, JC_ITERS, mcfg,
        HYPER_J)


@pytest.fixture(scope="module")
def jax_refs(window):
    """JAX ``sharded_map_iters`` on meshes of 2 and 4 (all tiles) and of 2
    at tile_frac 0.5."""
    jm, jc, _, _ = window
    mc = jmap.MapConfig(**MCFG)
    return {2: jax_iters(jm, jc, 2, mc), 4: jax_iters(jm, jc, 4, mc),
            "half": jax_iters(jm, jc, 2, mc._replace(tile_frac=0.5))}


def check_iters(out, ref, b=4):
    m1, cams1, it1, vis1, ka1 = ref
    assert out.it_count == int(it1) == 11
    for k in tgm.ParamLeaves._fields:
        np.testing.assert_allclose(npy(getattr(out.m.params, k)),
                                   np.asarray(getattr(m1.params, k)),
                                   atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(npy(out.m.active), np.asarray(m1.active))
    np.testing.assert_allclose(npy(out.cams.T), np.asarray(cams1.T)[:b],
                               atol=1e-5)
    np.testing.assert_allclose(npy(out.cams.ea), np.asarray(cams1.ea)[:b],
                               atol=1e-5)
    np.testing.assert_array_equal(npy(out.visibility), np.asarray(vis1)[:b])
    for i in range(2):
        np.testing.assert_allclose(npy(out.kf_adam[i]),
                                   np.asarray(ka1[i])[:b], atol=1e-6)
    assert npy(out.visibility).sum() > 0


def test_sharded_map_step_matches_jax(ranks):
    """One step of the view-sharded gradient on 2 ranks against JAX
    ``sharded_map_step`` on a 2-device mesh, jitted ("xla" blend, RGB-D;
    test_multichip.py's inputs: no pose or exposure optimised)."""
    jm = tiny_map()
    b = 4
    fields = dict(
        gt_image=np.asarray(jax.random.uniform(jax.random.PRNGKey(1),
                                               (b, 3, 64, 64))),
        gt_depth=np.full((b, 1, 64, 64), 3.0, np.float32),
        mapping_mask=np.ones((b, 1, 64, 64), np.float32),
        T=np.tile(np.eye(4, dtype=np.float32)[None], (b, 1, 1)),
        ea=np.ones(b, np.float32), eb=np.zeros(b, np.float32),
        valid=np.ones(b, bool), opt_pose=np.zeros(b, bool),
        opt_exposure=np.zeros(b, bool))
    jc = jmap.CamBatch(**{k: jnp.asarray(v) for k, v in fields.items()})
    mcfg = dict(monocular=False)
    mesh = jmesh.make_mesh(2)
    jm2, jc2, jloss = jax.jit(lambda m_, c_: jmesh.sharded_map_step(
        m_, c_, jnp.int32(1), mesh, JI, JCfg(**CFG), jmap.MapConfig(**mcfg),
        HYPER_J))(jmesh.replicate_map(jm, mesh), jmesh.shard_views(jc, mesh))
    params, T, ea, eb, loss = ranks.call(
        pr.view_step, (2, 1), port_map(jm),
        cams_from_numpy(**fields, device="cpu"), 1, TI, TCfg(**CFG),
        tmap.MapConfig(**mcfg), HYPER_T)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k, x in zip(tgm.ParamLeaves._fields, params):
        np.testing.assert_allclose(npy(x), np.asarray(getattr(jm2.params, k)),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(npy(T), np.asarray(jc2.T), atol=1e-5)
    np.testing.assert_allclose(npy(ea), np.asarray(jc2.ea), atol=1e-5)
    np.testing.assert_allclose(npy(eb), np.asarray(jc2.eb), atol=1e-5)
    assert float(np.abs(npy(params[0]) - np.asarray(jm.params.xyz)).max()) > 0


@pytest.mark.parametrize("n_view", [2, 4])
def test_sharded_map_iters_matches_jax(ranks, window, jax_refs, n_view):
    """The fused loop (frozen lists, the fused step, window Adam) with the
    4 views sharded over 2 and 4 ranks against JAX ``sharded_map_iters``
    on a mesh of the same size."""
    _, _, tm, tc = window
    out = ranks.map_iters((n_view, 1), tm, tc, 4, 7, None, TI, TC_ITERS,
                          tmap.MapConfig(**MCFG), HYPER_T)
    check_iters(out, jax_refs[n_view])


def test_pad_cams_on_two_ranks(ranks, window, jax_refs):
    """B = 3 on 2 ranks: ``pad_cams`` adds one invalid slot (identity pose,
    no ground truth) and the outputs are cut back to 3; the window's 4th
    slot is invalid, so the result is the 4-view reference's first 3
    rows."""
    _, _, tm, tc = window
    three = type(tc)(*(x[:3] for x in tc))
    padded = pad_cams(three, 2)
    assert padded.T.shape[0] == 4 and not bool(padded.valid[3])
    assert torch.equal(padded.T[3], torch.eye(4))
    assert float(padded.gt_image[3].abs().max()) == 0.0
    assert pad_cams(tc, 2) is tc
    out = ranks.map_iters((2, 1), tm, three, 4, 7, None, TI, TC_ITERS,
                          tmap.MapConfig(**MCFG), HYPER_T)
    assert out.cams.T.shape[0] == 3 and out.visibility.shape[0] == 3
    assert out.kf_adam[0].shape[0] == 3
    check_iters(out, jax_refs[2], b=3)


def test_tile_subsets_take_the_local_slot_draws(ranks, window, jax_refs):
    """tile_frac 0.5 on 2 ranks with the JAX draws replayed: every JAX
    device splits the replicated key over its 2 local views, so local view
    i on every rank takes the single-device loop's draw for view i; the
    port's ranks read the first rows of the same draws."""
    _, _, tm, tc = window
    mcfg = tmap.MapConfig(**MCFG, tile_frac=0.5)
    draws = replay_map_draws(jax.random.PRNGKey(3), 4, 2, 16, mcfg)
    out = ranks.map_iters((2, 1), tm, tc, 4, 7, None, TI, TC_ITERS, mcfg,
                          HYPER_T, draws=draws)
    check_iters(out, jax_refs["half"])


def test_one_rank_group_gives_map_iters_bits(ranks, window):
    """``map_iters`` with a one-rank view group (its sums are copies) has
    the bits of ``map_iters`` without a group, at tile_frac 0.5 from one
    generator seed."""
    _, _, tm, tc = window
    mcfg = tmap.MapConfig(**MCFG, tile_frac=0.5)
    a = tmap.map_iters(tm, tc, 4, 7, torch.Generator().manual_seed(5), TI,
                       TC_ITERS, mcfg, HYPER_T)
    b = ranks.map_iters((1, 1), tm, tc, 4, 7,
                        torch.Generator().manual_seed(5), TI, TC_ITERS, mcfg,
                        HYPER_T)
    assert a.it_count == b.it_count
    for x, y in zip([*a.m.params, *a.m.adam_m, *a.m.adam_v, *a.m[3:],
                     *a.cams, a.visibility, *a.kf_adam[:2]],
                    [*b.m.params, *b.m.adam_m, *b.m.adam_v, *b.m[3:],
                     *b.cams, b.visibility, *b.kf_adam[:2]]):
        assert torch.equal(x, y)
