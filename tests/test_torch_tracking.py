"""The tracking slice as a whole: the port's ``track_frame`` against the JAX
package's on the same map and frame, with the JAX random draws replayed
(first-order tile subset, second-order tile subset, one sketch per
second-order iteration); its convergence with its own generator; and the
device contract of its entry points.

Tolerances: per-iteration first-order L1 and the first second-order L1
rtol 1e-3 (the kernels' reductions round in another order, see
test_torch_blend_lists.py, and each Adam step carries the difference into
the next iterate); second-order L1 after the first step rtol 2e-2 (an LM
step removes up to 95 % of the residual, so the 1e-4 relative difference of
the two solved steps reappears up to 20 times larger in the loss after it);
iteration counts exact; final pose within 0.5 mm and 1e-3 rad."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.ops import se3 as jse3
from monogs_tpu.ops import sketch as jsketch
from monogs_tpu.slam import tracking as jtrack
from monogs_tpu_torch.ops import se3 as tse3
from monogs_tpu_torch.slam import tracking as ttrack
from tests.test_torch_ops import npy, t
from tests.test_torch_render import frames, world
from tests.torch_one_thread import one_torch_thread  # noqa: F401

TRACK = dict(fo_max_iter=12, so_max_iter=4, stack_dim=8, sketch_dim=32,
             bin_margin=16.0, fo_tile_frac=0.25, so_tile_frac=0.25,
             rebin_so_iters=2, fo_plateau_patience=5, fo_min_iter=3,
             so_plateau_patience=4, so_from_fo_aux=True)


def replay_draws(key, n_fine, tcfg):
    """The JAX track_frame's draws from ``key`` (tracking.py:445-446,
    611-612, 667-668) as the port's TrackDraws."""
    key, ksub = jax.random.split(key)
    n_sub = max(8, int(n_fine * tcfg.fo_tile_frac) // 8 * 8)
    fo_tsel = jax.random.permutation(ksub, n_fine)[:n_sub]
    n_sub_so = max(8, int(n_fine * tcfg.so_tile_frac) // 8 * 8)
    so_tsel = jax.random.permutation(jax.random.fold_in(key, 1),
                                     n_fine)[:n_sub_so]
    m = n_sub_so * 16 * 16
    sketches = []
    for _ in range(tcfg.so_max_iter):
        key, k1 = jax.random.split(key)
        spec = jsketch.make_sketch(k1, m, tcfg.stack_dim, tcfg.sketch_dim)
        sketches.append((t(spec.perm), t(spec.signs)))
    return ttrack.TrackDraws(fo_tsel=t(fo_tsel).long(),
                             so_tsel=t(so_tsel).long(), sketches=sketches)


@pytest.mark.parametrize("rgbd", [False, True])
def test_track_frame_parity(rgbd):
    jg, tg, T_gt, T0, ji, ti, jc, tc = world(seed=7)
    T0 = np.asarray(jse3.retract(T_gt, np.float32([0.006, -0.004, 0.003,
                                                    0.002, -0.003, 0.001])))
    jf, tf = frames(jg, T_gt, ji, jc, rgbd)
    jtc = jtrack.TrackConfig(monocular=not rgbd, **TRACK)
    ttc = ttrack.TrackConfig(monocular=not rgbd, **TRACK)
    key = jax.random.PRNGKey(3)
    a = jtrack.track_frame(jg, jf, jnp.asarray(T0), jnp.float32(1.0),
                           jnp.float32(0.0), key, ji, jc, jtc)
    b = ttrack.track_frame(tg, tf, t(T0), 1.0, 0.0, None, ti, tc, ttc,
                           draws=replay_draws(key, 64, jtc))
    assert (b.fo_iters, b.so_iters) == (int(a.fo_iters), int(a.so_iters))
    assert b.host_syncs == b.fo_iters + b.so_iters
    np.testing.assert_allclose(npy(b.fo_losses), np.asarray(a.fo_losses),
                               rtol=1e-3)
    so_b, so_a = npy(b.so_losses), np.asarray(a.so_losses)
    np.testing.assert_allclose(so_b[:1], so_a[:1], rtol=1e-3)
    np.testing.assert_allclose(so_b[1:], so_a[1:], rtol=2e-2)
    dt, dr = tse3.pose_diff(b.T, t(np.asarray(a.T)))
    assert float(dt) < 5e-4 and float(dr) < 1e-3, (float(dt), float(dr))
    # the frame was really tracked: better than the seed
    e0 = float(tse3.pose_diff(t(T0), t(T_gt))[0])
    assert float(tse3.pose_diff(b.T, t(T_gt))[0]) < 0.5 * e0
    np.testing.assert_allclose(npy(b.image), np.asarray(a.image), atol=1e-3)
    np.testing.assert_allclose(float(b.median_depth), float(a.median_depth),
                               rtol=1e-3)
    assert npy(b.n_touched).sum() > 0


def test_tracking_converges_with_own_generator():
    """track_frame with the port's own random draws recovers a perturbed
    pose on a synthetic scene (test_tracking_fused_fo_converges's setting)."""
    from monogs_tpu_torch.data import SyntheticDataset
    from monogs_tpu_torch.render import Intrinsics, RenderConfig
    from monogs_tpu_torch.slam.frame import make_frame_data

    intr = Intrinsics(fx=120.0, fy=120.0, cx=63.5, cy=47.5, width=128,
                      height=96)
    cfg = RenderConfig(tile=16, macro_tiles=4, k_macro=1024, k_fine=128,
                       backend="pallas_lists")
    ds = SyntheticDataset(intr, n_frames=2, n_gauss=1200, seed=6,
                          sensor_type="monocular", render_cfg=cfg,
                          trans_amp=0.0, rot_amp=0.0, device="cpu")
    img, _, T_gt = ds[0]
    frame = make_frame_data(img, None, 1.1, 0.01, "synthetic")
    g = torch.Generator().manual_seed(2)
    T0 = tse3.se3_exp(0.008 * torch.randn(6, generator=g)) @ T_gt
    tcfg = ttrack.TrackConfig(monocular=True, fo_max_iter=30, so_max_iter=6,
                              lr_trans=0.002, lr_rot=0.006, stack_dim=8,
                              sketch_dim=64, bin_margin=8.0,
                              fo_tile_frac=0.5, so_tile_frac=0.5,
                              rebin_so_iters=2)
    res = ttrack.track_frame(ds.scene, frame, T0, 1.0, 0.0,
                             torch.Generator().manual_seed(0), intr, cfg,
                             tcfg)
    trans = float(tse3.pose_diff(res.T, T_gt)[0])
    trans0 = float(tse3.pose_diff(T0, T_gt)[0])
    assert trans < 0.3 * trans0, (trans, trans0)
    assert res.fo_iters > 0 and res.so_iters > 0


def test_cuda_default_entry_points_raise_without_cuda(monkeypatch):
    """Entry points default to the card; without CUDA they raise instead of
    running on the CPU, unless the caller asks for the CPU."""
    from monogs_tpu_torch.convert import gaussians_from_numpy
    from monogs_tpu_torch.data import SyntheticDataset, orbit_pose
    from monogs_tpu_torch.render import Intrinsics

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    intr = Intrinsics(fx=60.0, fy=60.0, cx=31.5, cy=23.5, width=64,
                      height=48)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        orbit_pose(0.1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SyntheticDataset(intr, n_frames=1, n_gauss=16)
    z = np.zeros((2, 3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gaussians_from_numpy(z, np.zeros((2, 1, 3)), z, np.ones((2, 4)),
                             np.zeros((2, 1)), np.ones(2, bool))
    assert orbit_pose(0.1, device="cpu").shape == (4, 4)


@pytest.mark.parametrize("backend,change,error,match", [
    ("pallas_lists", dict(stage="preprocess"), ValueError, "not one of"),
    ("pallas_lists", dict(bin_margin=0.0), TypeError, "forward-mode"),
    ("pallas", dict(bin_margin=0.0), TypeError, "forward-mode"),
])
def test_unported_branches_raise(backend, change, error, match):
    """A stage the JAX package does not have is refused; the linearised
    second order through a kernel (where the JAX package raises too)
    names its cause; every other branch, and every truncated stage, is
    accepted."""
    from monogs_tpu_torch.render import RenderConfig

    with pytest.raises(error, match=match):
        ttrack._check_supported(RenderConfig(backend=backend),
                                ttrack.TrackConfig(**{**TRACK, **change}))
    for be in ("xla", "pallas", "pallas_compact", "pallas_lists"):
        ttrack._check_supported(RenderConfig(backend=be),
                                ttrack.TrackConfig(**TRACK))
    ttrack._check_supported(RenderConfig(), ttrack.TrackConfig())
    for stage in ttrack.STAGES:
        ttrack._check_supported(RenderConfig(backend=backend),
                                ttrack.TrackConfig(**TRACK, stage=stage))
