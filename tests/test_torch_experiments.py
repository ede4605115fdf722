"""The port's diagnostics harness (``slam/experiments.py``), a mirror of
``tests/test_experiments.py``, held to the JAX package's functions on the
same inputs with the JAX draws injected.

``check_grad``'s SJ and ``lm_sweep``'s losses: the JAX side is
``jax.jacfwd`` of its ``_sketched_Sf`` (what its ``check_grad`` holds
``jax.linearize`` to) and the full-frame L1 after each damped step, in one
jitted program so that the file compiles once. ``step_size_sweep``,
``kfine_vs_backward_subsample`` (the kept Gaussians drawn as the JAX
function draws them, ``jax.random.uniform(key, N) < frac``) and
``pool_vs_fresh_sampling`` (its degrading noise and pools drawn from the
JAX function's keys) are the JAX functions themselves, with their
``_fo_loss`` and ``render`` jitted for the call (the same arithmetic,
compiled once instead of dispatched op by op).

Tolerances: SJ to 1e-4 of its largest |entry| plus rtol 1e-3 (float32
renders round alike; the bucket sums and the blend's pixel sums
reassociate); the LM losses rtol 1e-4 (sums of 12,288 residuals after a
step solved from those) and the step norms rtol 1e-3; the step-size sweep's
losses and pose deltas rtol 1e-4 (three gradient steps; 2e-5 seen); the
k_fine cosines atol 5e-6 and norm ratios rtol 5e-6 (8e-7 seen; an error in
the quaternion conjugation moves them by 3e-5 or more); the pool run's
L1s rtol 1e-3 (Adam over three iterations; 1.2e-4 seen). ``check_sketch``
is held to the JAX test's statistics, and the pool test on "pallas_lists"
to the JAX test's properties on the port's own draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.models import gaussian_map as jgm
from monogs_tpu.ops import losses as jlosses
from monogs_tpu.ops import se3 as jse3
from monogs_tpu.ops.sketch import damped_lstsq as jlstsq
from monogs_tpu.ops.sketch import make_sketch as jmake_sketch
from monogs_tpu.render import Intrinsics as JIntr
from monogs_tpu.render import RenderConfig as JCfg
from monogs_tpu.render import render as jrender
from monogs_tpu.render.renderer import GaussianArrays as JGauss
from monogs_tpu.render.renderer import render_jit as jrender_jit
from monogs_tpu.slam import experiments as jex
from monogs_tpu.slam import tracking as jtracking
from monogs_tpu.slam.frame import make_frame_data as jframe
from monogs_tpu.slam.mapping import CamBatch as JCamBatch
from monogs_tpu.slam.mapping import MapConfig as JMapConfig
from monogs_tpu.slam.tracking import TrackConfig as JTrack
from monogs_tpu.slam.tracking import _sketched_Sf as j_sketched_Sf
from monogs_tpu_torch.data.synthetic import (
    SyntheticDataset, make_synthetic_scene,
)
from monogs_tpu_torch.models import gaussian_map as gm
from monogs_tpu_torch.ops import se3
from monogs_tpu_torch.ops.sketch import sketch_from_draw
from monogs_tpu_torch.render import Intrinsics, RenderConfig, render
from monogs_tpu_torch.slam import experiments as ex
from monogs_tpu_torch.slam.frame import make_frame_data
from monogs_tpu_torch.slam.mapping import CamBatch, MapConfig
from monogs_tpu_torch.slam.tracking import TrackConfig
from tests.test_torch_ops import npy, t
from tests.torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"
INTR = dict(fx=80.0, fy=80.0, cx=31.5, cy=31.5, width=64, height=64)
CFG = dict(tile=16, macro_tiles=2, k_macro=512, k_fine=128)
TRACK = dict(monocular=True, stack_dim=4, sketch_dim=16)
LAMBDAS = (1e-3, 1e-1)
TAU = np.array([0.01, 0.0, 0.005, 0.0, 0.01, 0.0], np.float32)


@pytest.fixture(scope="module")
def jax_jitted():
    """The JAX experiments with their ``_fo_loss`` and ``render`` jitted
    (both are looked up when a function runs)."""
    fo = jax.jit(jtracking._fo_loss, static_argnames=("intr", "cfg", "tcfg"))

    def fo_loss(gauss, frame, T, p8, intr, cfg, tcfg, lists=None):
        assert lists is None
        return fo(gauss, frame, T, p8, intr=intr, cfg=cfg, tcfg=tcfg)

    def render(gauss, T, intr, cfg):
        return jrender_jit(gauss, T, intr=intr, cfg=cfg)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtracking, "_fo_loss", fo_loss)
        mp.setattr(jex, "render", render)
        yield jex


@pytest.fixture(scope="module")
def scene():
    """The JAX test's scene size (400 Gaussians, the port's synthetic
    scene of seed 0, carried to the JAX package as numpy), the frame at its
    first pose, a perturbed pose, the JAX sketch of key 0, and the JAX
    package's SJ and LM losses there."""
    ji, jc, jt = JIntr(**INTR), JCfg(**CFG), JTrack(**TRACK)
    ds = SyntheticDataset(Intrinsics(**INTR), n_frames=1, n_gauss=400,
                          render_cfg=RenderConfig(**CFG), trans_amp=0.0,
                          rot_amp=0.0, device=CPU)
    img, _, T_gt = ds[0]
    img, T_gt = npy(img), npy(T_gt)
    jg = JGauss(**{k: jnp.asarray(npy(v)) for k, v in
                   ds.scene._asdict().items()})
    frame = jframe(jnp.asarray(img), None, 1.1, 0.01, "synthetic")
    T = jse3.retract(jnp.asarray(T_gt), jnp.asarray(TAU))
    m = INTR["width"] * INTR["height"]
    sk = jmake_sketch(jax.random.PRNGKey(0), m, jt.stack_dim, jt.sketch_dim)
    cfg_t = jc._replace(with_n_touched=False)
    p0 = jnp.concatenate([jnp.zeros(6), jnp.ones(1), jnp.zeros(1)])

    @jax.jit
    def reference(T, perm, signs):
        spec = sk._replace(perm=perm, signs=signs)

        def sf(p):
            return j_sketched_Sf(jg, frame, T, p, spec, ji, cfg_t,
                                 jt)[0]

        Sf, SJ = sf(p0), jax.jacfwd(sf)(p0)
        out = []
        for lam in LAMBDAS:
            x = jlstsq(SJ, Sf, lam)
            r = jrender(jg, jse3.retract(T, x[:6]), ji, cfg_t)
            res = jlosses.tracking_residual_rgb(
                r.image, frame.gt_image, r.opacity, frame.mapping_mask,
                1.0 + x[6], x[7])
            out.append(jnp.stack([jnp.sum(jnp.abs(res)),
                                  jnp.linalg.norm(x)]))
        return Sf, SJ, jnp.stack(out)

    _, SJ, lm = (np.asarray(x) for x in reference(T, sk.perm, sk.signs))
    tframe = make_frame_data(t(img), None, 1.1, 0.01, "synthetic")
    tsk = sketch_from_draw(t(sk.perm), t(sk.signs), m, jt.stack_dim,
                           jt.sketch_dim)
    return dict(gauss=ds.scene, frame=tframe, T=t(T), sketch=tsk, SJ=SJ,
                lm=lm, jgauss=jg, jframe=frame, jT=T)


def _close_to_scale(got, want, frac, rtol=1e-3):
    err = np.abs(got - want)
    assert np.all(err <= rtol * np.abs(want) + frac * np.abs(want).max()), \
        float(err.max())


def test_check_grad(scene):
    s = scene
    diff, SJ = ex.check_grad(s["gauss"], s["frame"], s["T"],
                             Intrinsics(**INTR), RenderConfig(**CFG),
                             TrackConfig(**TRACK), None, sketch=s["sketch"])
    assert diff < 1e-4
    assert SJ.shape == (4 * 16, 8)
    assert float(torch.abs(SJ).max()) > 0
    _close_to_scale(npy(SJ), s["SJ"], 1e-4)


def test_check_grad_raises_through_a_kernel(scene):
    """Forward mode through a kernel's autograd Function has no rule; the
    JAX package fails there too (jax.linearize of a custom_vjp)."""
    s = scene
    with pytest.raises(TypeError, match="forward-mode"):
        ex.check_grad(s["gauss"], s["frame"], s["T"], Intrinsics(**INTR),
                      RenderConfig(**CFG, backend="pallas_lists"),
                      TrackConfig(**TRACK), None, sketch=s["sketch"])


def test_check_sketch_stats():
    stats = ex.check_sketch(m=5000, n=8, stack_dim=4, sketch_dim=32,
                            trials=10, device=CPU)
    d = stats["distortion_theory"]
    assert abs(stats["sigma_max_ratio_mean"] - 1.0) < 3 * d
    assert abs(stats["sigma_min_ratio_mean"] - 1.0) < 5 * d


def test_lm_sweep_matches_jax(scene):
    s = scene
    res = ex.lm_sweep(s["gauss"], s["frame"], s["T"], Intrinsics(**INTR),
                      RenderConfig(**CFG), TrackConfig(**TRACK), None,
                      lambdas=LAMBDAS, sketch=s["sketch"])
    assert list(res) == [float(x) for x in LAMBDAS]
    for (lam, v), (loss, norm) in zip(res.items(), s["lm"]):
        assert v["loss"] >= 0 and v["step_norm"] >= 0
        np.testing.assert_allclose(v["loss"], loss, rtol=1e-4)
        np.testing.assert_allclose(v["step_norm"], norm, rtol=1e-3)


def test_step_size_sweep_runs(scene, jax_jitted):
    """The losses before each step and the pose's final move, against the
    JAX function's at the same pose."""
    s = scene
    kw = dict(step_sizes=(1e-3, 1e-2), n_iters=3)
    res = ex.step_size_sweep(s["gauss"], s["frame"], s["T"],
                             Intrinsics(**INTR), RenderConfig(**CFG),
                             TrackConfig(**TRACK), **kw)
    want = jax_jitted.step_size_sweep(s["jgauss"], s["jframe"], s["jT"],
                                      JIntr(**INTR), JCfg(**CFG),
                                      JTrack(**TRACK), None, **kw)
    assert list(res) == list(want) == [1e-3, 1e-2]
    for lr, v in res.items():
        assert len(v["losses"]) == 3
        assert v["final_trans_delta"] > 0
        np.testing.assert_allclose(v["losses"], want[lr]["losses"],
                                   rtol=1e-4)
        for k in ("final_trans_delta", "final_angle_delta"):
            np.testing.assert_allclose(v[k], want[lr][k], rtol=1e-4,
                                       err_msg=k)


def test_kfine_truncation_vs_backward_subsampling(jax_jitted):
    """The JAX test's claim on the port: at a 1/8 backward fraction on an
    over-dense scene both mechanisms keep the pose gradient aligned with
    the untruncated one (cosine > 0.9); and every cosine and norm ratio
    equals the JAX function's on the same scene, frame and pose with its
    draw of the kept Gaussians."""
    gen = torch.Generator().manual_seed(7)
    sc = make_synthetic_scene(gen, n=4000, spread=1.2, depth_mean=3.0,
                              depth_spread=0.6, scale_min=0.04,
                              scale_max=0.1)
    intr = Intrinsics(**INTR)
    cfg = RenderConfig(**CFG)._replace(k_macro=4096, k_fine=512)
    out = render(sc, torch.eye(4), intr, cfg._replace(with_n_touched=False))
    img = torch.clamp(out.image, 0.0, 1.0)
    frame = make_frame_data(img, None, 1.1, 0.01, "synthetic")
    tau = torch.tensor(0.01 * np.random.default_rng(3).standard_normal(6),
                       dtype=torch.float32)
    T0 = se3.se3_exp(tau)
    key = jax.random.PRNGKey(4)
    keep = np.array(jax.random.uniform(key, (sc.xyz.shape[0],)) < 0.125)
    res = ex.kfine_vs_backward_subsample(
        sc, frame, T0, intr, cfg, TrackConfig(**TRACK), None,
        k_fine_full=512, k_fine_trunc=64, keep=t(keep))
    want = jax_jitted.kfine_vs_backward_subsample(
        JGauss(**{k: jnp.asarray(npy(v)) for k, v in sc._asdict().items()}),
        jframe(jnp.asarray(npy(img)), None, 1.1, 0.01, "synthetic"),
        jnp.asarray(npy(T0)), JIntr(**INTR),
        JCfg(**CFG)._replace(k_macro=4096, k_fine=512), JTrack(**TRACK), key,
        k_fine_full=512, k_fine_trunc=64)
    assert res["frac"] == want["frac"] == 0.125
    assert res["cos_sub_pose"] < 0.999999, res
    assert res["cos_trunc_pose"] > 0.9, res
    assert res["cos_sub_pose"] > 0.9, res
    assert 0.1 < res["norm_ratio_trunc"] < 10.0, res
    for k in ("cos_trunc_pose", "cos_sub_pose", "cos_trunc_all",
              "cos_sub_all"):
        np.testing.assert_allclose(res[k], want[k], rtol=0, atol=5e-6,
                                   err_msg=k)
    for k in ("norm_ratio_trunc", "norm_ratio_sub"):
        np.testing.assert_allclose(res[k], want[k], rtol=5e-6, err_msg=k)


def pool_problem(backend):
    """The JAX test's recovery problem: six views of a 400-Gaussian scene,
    the map at capacity 512, densify and reset out of reach."""
    intr = Intrinsics(**INTR)
    cfg = RenderConfig(**CFG, backend=backend)
    ds = SyntheticDataset(intr, n_frames=6, n_gauss=400, render_cfg=cfg,
                          trans_amp=0.05, rot_amp=0.02, device=CPU)
    n_views, (h, w) = 6, (INTR["height"], INTR["width"])
    imgs, Ts = zip(*((ds[i][0], ds[i][2]) for i in range(n_views)))
    views = CamBatch(
        gt_image=torch.stack(imgs), gt_depth=torch.zeros(n_views, 1, h, w),
        mapping_mask=torch.ones(n_views, 1, h, w), T=torch.stack(Ts),
        ea=torch.ones(n_views), eb=torch.zeros(n_views),
        valid=torch.ones(n_views, dtype=torch.bool),
        opt_pose=torch.zeros(n_views, dtype=torch.bool),
        opt_exposure=torch.zeros(n_views, dtype=torch.bool))
    n, cap = ds.scene.xyz.shape[0], 512

    def pad(x):
        return torch.cat([x, torch.zeros((cap - n,) + x.shape[1:])])

    sc = ds.scene
    leaves = gm.ParamLeaves(xyz=pad(sc.xyz), sh=pad(sc.sh),
                            log_scale=pad(sc.log_scale), quat=pad(sc.quat),
                            opa_logit=pad(sc.opa_logit))
    m = gm.insert(gm.new_map(cap, device=CPU), leaves,
                  torch.tensor(n, dtype=torch.int32), kf_id=0)
    mcfg = dict(monocular=True, window_size=3, pool_size=2,
                gaussian_update_every=10_000, gaussian_reset=10_000,
                densify_from_iter=10_000)
    return intr, cfg, views, leaves, m, mcfg


def test_pool_vs_fresh_matches_jax(jax_jitted):
    """Three iterations each way, in calls of two (staged) and of one
    (fresh), on "xla" in both packages: the degrading noise and the pools
    are the JAX function's draws (key 5: its degrade key split in two
    normals; its run key split per call, the staged run's calls and then
    the fresh run's from the same key), and the start, staged and fresh
    L1s equal the JAX function's."""
    n_iters, chunk, window, pool = 3, 2, 3, 2
    intr, cfg, views, leaves, m, mcfg = pool_problem("xla")
    n_views, cap = views.T.shape[0], leaves.xyz.shape[0]
    key = jax.random.PRNGKey(5)
    k_deg, k_run = jax.random.split(key)
    k_xyz, k_opa = jax.random.split(k_deg)
    noise = (np.array(jax.random.normal(k_xyz, (cap, 3))),
             np.array(jax.random.normal(k_opa, (cap, 1))))

    def pools(n_calls):
        k, out = k_run, []
        for _ in range(n_calls):
            k, k_pool, _ = jax.random.split(k, 3)
            out.append(np.array(jax.random.choice(
                k_pool, jnp.arange(window, n_views), shape=(pool,),
                replace=False)))
        return out

    res = ex.pool_vs_fresh_sampling(
        m, views, intr, cfg, MapConfig(**mcfg), gm.MapHyper(), None,
        n_iters=n_iters, window=window, pool=pool, chunk=chunk, noise=noise,
        pools=pools(-(-n_iters // chunk)) + pools(n_iters))
    jm = jgm.insert(jgm.new_map(cap),
                    jgm.ParamLeaves(*(jnp.asarray(npy(x)) for x in leaves)),
                    jnp.int32(int(m.n_active)), kf_id=0)
    want = jax_jitted.pool_vs_fresh_sampling(
        jm, JCamBatch(*(jnp.asarray(npy(x)) for x in views)), JIntr(**INTR),
        JCfg(**CFG), JMapConfig(**mcfg), jgm.MapHyper(), key,
        n_iters=n_iters, window=window, pool=pool, chunk=chunk)
    assert res["staged_l1"] < res["start_l1"], res
    for k in ("start_l1", "staged_l1", "fresh_l1"):
        np.testing.assert_allclose(res[k], want[k], rtol=1e-3, err_msg=k)


def test_pool_staging_matches_fresh_sampling():
    """Chunk-staged random keyframes recover a degraded map about as well
    as fresh per-iteration sampling at equal total iterations (20 each
    way, where the JAX test runs 30). On
    "pallas_lists" (the shipped fused mapping branch, its plain versions
    here), where the JAX test maps on "xla": the claim is the staging's,
    and the fused branch takes two thirds of the time on the CPU."""
    intr, cfg, views, _, m, mcfg = pool_problem("pallas_lists")
    res = ex.pool_vs_fresh_sampling(
        m, views, intr, cfg, MapConfig(**mcfg), gm.MapHyper(),
        torch.Generator().manual_seed(5), n_iters=20, window=3, pool=2,
        chunk=10)
    assert res["staged_l1"] < res["start_l1"], res
    assert res["fresh_l1"] < res["start_l1"], res
    assert res["staged_l1"] < 1.25 * res["fresh_l1"] + 1e-4, res
