"""The unfused mapping branch and the list-free refinement against the JAX
package.

``map_iters`` takes the unfused branch when ``bin_margin == 0``, when
``fused_grad`` is off, or on a backend other than ``"pallas_lists"``: per
view the mapping loss of a differentiable ``render`` and its gradients
(JAX: ``value_and_grad`` of ``_batch_loss``). Three iterations over two
views, poses and exposures of one view optimised, the JAX draws replayed,
through both packages:

- ``bin_margin 0`` (every render bins its view) on the port's
  ``"pallas"``, ``"pallas_compact"`` and ``"xla"`` against the JAX
  package's ``"xla"``, mono and RGB-D (``k_fine = k_macro``, where the
  masked walk and the compact blend equal the XLA blend);
- ``fused_grad=False`` on ``"pallas_lists"`` over frozen margin lists
  against the JAX package's ``"xla"`` over the same lists, with the final
  visibility from the lists and binning anew (``vis_from_lists=False``);
- ``color_refinement_iters`` without lists (``bin_margin 0``).

Compared: parameters, poses, exposures, the densification statistic
``grad_accum`` and the visibility. Ground truth is offset (+0.03 colour,
+0.05 depth) so that no L1 residual sits at 0, where its sign would flip
on rounding noise.

Tolerances (as tests/test_torch_mapping.py's map_iters parity): parameters
atol 1e-4 (Adam turns a gradient's rounding difference into up to about
1e-3 of a learning rate where a small gradient changes sign), poses and
exposures atol 1e-6, ``grad_accum`` rtol 1e-3 plus 1e-3 of its largest
entry, visibility exact. The list blend against the XLA blend (frozen
lists) forms the log-alpha in another order (directly, against a
[K, 6] x [6, P] product), so a row whose alpha sits at the 1/255 test can
pass in one and not the other; the Gaussian's small gradient then changes
and Adam's normalisation turns that into up to a few percent of a
learning-rate step: there at most 0.5 % of the entries may differ by more
than 1e-4, and none by more than 1e-3; poses and exposures atol 1e-5 (a
few 1e-4 of their learning rates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.models import gaussian_map as jgm
from monogs_tpu.ops import se3 as jse3
from monogs_tpu.render import Intrinsics as JIntr
from monogs_tpu.render import RenderConfig as JCfg
from monogs_tpu.render import renderer as jr
from monogs_tpu.slam import mapping as jmap
from monogs_tpu_torch.convert import cams_from_numpy
from monogs_tpu_torch.models import gaussian_map as tgm
from monogs_tpu_torch.render import Intrinsics as TIntr
from monogs_tpu_torch.render import RenderConfig as TCfg
from monogs_tpu_torch.render import blend_macros as tbm
from monogs_tpu_torch.render import renderer as tr
from monogs_tpu_torch.slam import mapping as tmap
from tests.test_torch_map import LEAVES, port_map
from tests.test_torch_mapping import replay_map_draws
from tests.test_torch_ops import npy, small_tau, surface_scene, t
from tests.torch_one_thread import one_torch_thread  # noqa: F401

INTR = dict(fx=60.0, fy=60.0, cx=31.5, cy=23.5, width=64, height=48)
W, H = INTR["width"], INTR["height"]
CFG = dict(tile=16, macro_tiles=2, k_macro=128, k_fine=128)
JI, TI = JIntr(**INTR), TIntr(**INTR)
JX, TX = JCfg(**CFG), TCfg(**CFG)
MCFG = dict(window_size=2, pose_window=2, gaussian_update_every=10**9,
            gaussian_reset=10**9)
N_ITERS = 3
_jvis = jax.jit(lambda g, T: jr.render(g, T, JI, JX).n_touched > 0)


@pytest.fixture(scope="module")
def world():
    """(JAX map, JAX CamBatch, port CamBatch): a surface scene in a map of
    capacity 1024 with its colours and positions perturbed, and two views
    rendered (by the port's XLA blend) from the unperturbed map (view 1's
    pose and exposure optimised)."""
    sc = surface_scene(300, 5, spread=1.2, depth_mean=3.0, scale_min=0.03,
                       scale_max=0.12)
    # built by the port and carried over (the JAX package's insert is the
    # same, tests/test_torch_map.py)
    tm = tgm.insert(tgm.new_map(1024, device="cpu"), tgm.ParamLeaves(
        *(t(sc[k]) for k in LEAVES)), 300, kf_id=0)
    jm = jgm.GaussianMap(*(
        jgm.ParamLeaves(*(jnp.asarray(npy(y)) for y in x))
        if isinstance(x, tuple) else jnp.asarray(npy(x)) for x in tm))
    views = []
    for i in range(2):
        T = np.asarray(jse3.se3_exp(small_tau(35 + i, 0.03)))
        with torch.no_grad():
            out = tr.render(tm.render_view(), t(T), TI,
                            TX._replace(with_n_touched=False))
        views.append((np.clip(npy(out.image), 0, 1), npy(out.depth), T))
    rng = np.random.default_rng(7)
    p = jm.params
    jm = jm._replace(params=p._replace(
        sh=p.sh + jnp.asarray(0.3 * rng.standard_normal(p.sh.shape),
                              jnp.float32),
        xyz=p.xyz + jnp.asarray(0.01 * rng.standard_normal(p.xyz.shape),
                                jnp.float32)))
    opt = np.array([False, True])
    fields = dict(
        gt_image=np.stack([v[0] for v in views]).astype(np.float32) + 0.03,
        gt_depth=np.stack([v[1] for v in views]).astype(np.float32) + 0.05,
        mapping_mask=np.ones((2, 1, H, W), np.float32),
        T=np.stack([v[2] for v in views]).astype(np.float32),
        ea=np.ones(2, np.float32), eb=np.zeros(2, np.float32),
        valid=np.ones(2, bool), opt_pose=opt, opt_exposure=opt)
    return (jm, jmap.CamBatch(**{k: jnp.asarray(v) for k, v in
                                 fields.items()}),
            cams_from_numpy(**fields, device="cpu"))


def run_both(world, jcfg, tcfgs, mc, key_seed, tchanges=None):
    """map_iters through the JAX package (``jcfg``) and the port (each of
    ``tcfgs``, its MapConfig changed by ``tchanges``) from the same map,
    cams and draws; returns (JAX result, [port results])."""
    jm, jcam, tcam = world
    jmc = jmap.MapConfig(**mc)
    key = jax.random.PRNGKey(key_seed)
    a = jmap.map_iters(jm, jcam, N_ITERS, jnp.int32(2), key, JI, jcfg, jmc,
                       jgm.MapHyper())
    draws = replay_map_draws(key, N_ITERS, 2, 16, jmc)
    return a, [tmap.map_iters(port_map(jm), tcam, N_ITERS, 2, None, TI, c,
                              tmap.MapConfig(**mc, **ch), tgm.MapHyper(),
                              draws=draws)
               for c, ch in zip(tcfgs, tchanges or [{}] * len(tcfgs))]


def assert_map_result(b, a, tcam, threshold_flips=False):
    assert b.it_count == int(a[2]) == 2 + N_ITERS
    for k in LEAVES:
        x = npy(getattr(b.m.params, k))
        r = np.asarray(getattr(a[0].params, k))
        if threshold_flips:
            err = np.abs(x - r)
            assert (err > 1e-4).mean() <= 0.005, (k, (err > 1e-4).sum())
            np.testing.assert_allclose(x, r, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_allclose(x, r, atol=1e-4, err_msg=k)
    cam_atol = 1e-5 if threshold_flips else 1e-6
    for k in ("T", "ea", "eb"):
        np.testing.assert_allclose(npy(getattr(b.cams, k)),
                                   np.asarray(getattr(a[1], k)),
                                   atol=cam_atol, err_msg=k)
    ga, gb = np.asarray(a[0].grad_accum), npy(b.m.grad_accum)
    np.testing.assert_allclose(gb, ga, rtol=1e-3, atol=1e-3 * ga.max())
    np.testing.assert_array_equal(npy(b.m.denom), np.asarray(a[0].denom))
    np.testing.assert_array_equal(npy(b.visibility), np.asarray(a[3]))
    assert ga.max() > 0 and npy(b.visibility).sum() > 0
    assert float(torch.abs(b.cams.T[1] - tcam.T[1]).max()) > 0


@pytest.mark.parametrize("monocular", [True, False])
def test_map_iters_unbinned_backends(world, monocular, monkeypatch):
    """bin_margin 0: the port's list-free backends (RGB-D: the two macro
    ones) against the JAX package's XLA render, each iteration binning
    every view anew; the
    macro-list wrappers run (their plain versions here) once per view and
    iteration."""
    mc = dict(MCFG, monocular=monocular, bin_margin=0.0)
    backends = ("pallas", "pallas_compact") + (("xla",) if monocular else ())
    before = dict(tbm.LAUNCHES)
    calls = {"macro": 0, "compact": 0}
    vjp = tbm.blend_macros_vjp

    def counted(*args, k_fine=None):
        calls["macro" if k_fine is None else "compact"] += 1
        return vjp(*args, k_fine=k_fine)

    monkeypatch.setattr(tbm, "blend_macros_vjp", counted)
    a, bs = run_both(world, JX, [TX._replace(backend=x) for x in backends],
                     mc, 1)
    assert calls == {"macro": 2 * N_ITERS, "compact": 2 * N_ITERS}
    assert tbm.LAUNCHES == before   # no card here
    for b, name in zip(bs, backends):
        try:
            assert_map_result(b, a, world[2])
        except AssertionError as e:
            raise AssertionError(f"backend {name}") from e


def test_map_iters_unfused_frozen_lists(world):
    """fused_grad off on "pallas_lists" over frozen margin lists (the list
    blend's differentiable render) against the JAX package's XLA blend over
    the same lists. The final visibility from the lists, and with
    vis_from_lists off from renders that bin anew, held against the JAX
    package's render of its final map at its final poses."""
    mc = dict(MCFG, monocular=True, bin_margin=4.0, fused_grad=False,
              rebin_every=2)
    tc = TX._replace(backend="pallas_lists")
    a, (b, c) = run_both(world, JX, [tc, tc], mc, 2,
                         [{}, dict(vis_from_lists=False)])
    assert_map_result(b, a, world[2], threshold_flips=True)
    # the loop is the same (up to the CPU's float32 summation order)
    np.testing.assert_allclose(npy(c.m.params.xyz), npy(b.m.params.xyz),
                               atol=1e-6)
    vis = np.stack([np.asarray(_jvis(a[0].render_view(), a[1].T[v]))
                    for v in range(2)])
    np.testing.assert_array_equal(npy(c.visibility), vis)


def test_color_refinement_without_lists(world):
    """Three refinement steps with bin_margin 0 (every render bins its
    view) through the masked walk's VJP, the JAX view draws replayed."""
    jm, jcam, tcam = world
    mc = dict(MCFG, bin_margin=0.0)
    key = jax.random.PRNGKey(3)
    a = jmap.color_refinement_iters(jm, jcam, N_ITERS, key, JI, JX,
                                    jmap.MapConfig(**mc), jgm.MapHyper())
    views, k = [], key
    for _ in range(N_ITERS):
        k, k1 = jax.random.split(k)
        views.append(int(jax.random.randint(k1, (), 0, 2)))
    tm = port_map(jm)
    b = tmap.color_refinement_iters(tm, tcam, N_ITERS, None, TI,
                                    TX._replace(backend="pallas"),
                                    tmap.MapConfig(**mc), tgm.MapHyper(),
                                    views=views)
    for k_ in LEAVES:
        np.testing.assert_allclose(npy(getattr(b.params, k_)),
                                   np.asarray(getattr(a.params, k_)),
                                   atol=1e-4, err_msg=k_)
    assert float(torch.abs(b.params.sh - tm.params.sh).max()) > 1e-4
