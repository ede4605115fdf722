"""The port's eval and I/O: ATE, rendering eval, PLY, checkpoints,
profiling and metrics logs.

``tests/test_eval.py``'s ATE tests, ``tests/test_ply.py`` and
``tests/test_checkpoint.py`` mirrored on ``monogs_tpu_torch``; then across
the packages: ``eval_rendering`` on the same map (carried over with
``convert.map_from_numpy``) within 1e-4 in PSNR and SSIM (the renders
agree to about 1e-5 per pixel, test_torch_render.py); a checkpoint written
by either package loads in the other bit for bit; a PLY written by either
loads in the other exactly (the format is float32); profile logs load in
either package."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.data.synthetic import SyntheticDataset as JSynthetic
from monogs_tpu.eval.rendering import eval_rendering as jeval_rendering
from monogs_tpu.models import checkpoint as jckpt
from monogs_tpu.models import gaussian_map as jgm
from monogs_tpu.models import ply as jply
from monogs_tpu.render import Intrinsics as JIntrinsics
from monogs_tpu.render import RenderConfig as JRenderConfig
from monogs_tpu.utils import profiling as jprof
from monogs_tpu_torch import convert
from monogs_tpu_torch.eval.ate import eval_ate, evaluate_ate, umeyama
from monogs_tpu_torch.eval.rendering import eval_rendering
from monogs_tpu_torch.models import gaussian_map as gm
from monogs_tpu_torch.models.checkpoint import load_checkpoint, save_checkpoint
from monogs_tpu_torch.models.ply import load_ply, save_ply
from monogs_tpu_torch.render import Intrinsics, RenderConfig
from monogs_tpu_torch.slam.frame import Frame
from monogs_tpu_torch.utils.metrics import MetricsLogger
from monogs_tpu_torch.utils.profiling import (
    ProfileLogger, StageTimers, load_profile_logs, trace,
)
from tests.torch_one_thread import one_torch_thread  # noqa: F401

FIELDS = ("xyz", "sh", "log_scale", "quat", "opa_logit")


def _traj(n=20, seed=0):
    rng = np.random.default_rng(seed)
    poses = []
    p = np.zeros(3)
    for _ in range(n):
        p = p + 0.1 * rng.standard_normal(3)
        T = np.eye(4)
        T[:3, 3] = p
        poses.append(T)
    return poses


# ------------------------------------------------------------------ ATE

def test_umeyama_recovers_similarity():
    rng = np.random.default_rng(1)
    src = rng.standard_normal((30, 3))
    Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    s_true, t_true = 1.7, np.array([0.3, -0.2, 1.1])
    dst = s_true * (Q @ src.T).T + t_true
    s, R, t = umeyama(src, dst, with_scale=True)
    assert np.isclose(s, s_true, rtol=1e-6)
    np.testing.assert_allclose(R, Q, atol=1e-6)
    np.testing.assert_allclose(t, t_true, atol=1e-6)


def test_ate_zero_for_identical():
    gt = _traj()
    assert evaluate_ate(gt, gt)[0] < 1e-9


def test_ate_invariant_to_rigid_offset():
    gt = _traj()
    offset = np.eye(4)
    offset[:3, 3] = [1.0, 2.0, 3.0]
    assert evaluate_ate(gt, [offset @ T for T in gt])[0] < 1e-9


def test_ate_scale_corrected_when_monocular():
    gt = _traj()
    est = [T.copy() for T in gt]
    for T in est:
        T[:3, 3] *= 2.0
    assert evaluate_ate(gt, est, monocular=True)[0] < 1e-9
    assert evaluate_ate(gt, est, monocular=False)[0] > 0.01


def test_ate_detects_error():
    rng = np.random.default_rng(2)
    gt = _traj()
    est = [T.copy() for T in gt]
    for T in est:
        T[:3, 3] += 0.05 * rng.standard_normal(3)
    assert 0.01 < evaluate_ate(gt, est)[0] < 0.2


def test_eval_ate_artifacts(tmp_path):
    """Keyframe ATE from frames holding tensor poses, with its JSON files
    (trj_final.json, stats_final.json) and the keyframes' uids."""
    gt = _traj(6)
    frames = {}
    for i, T in enumerate(gt):
        T_cw = torch.from_numpy(np.linalg.inv(T)).float()
        frames[i] = Frame(uid=i, T=T_cw, T_gt=T_cw,
                          exposure_a=torch.ones(()),
                          exposure_b=torch.zeros(()))
    ate = eval_ate(frames, [0, 2, 4], str(tmp_path), 0, final=True)
    assert ate < 1e-6
    trj = json.load(open(tmp_path / "plot" / "trj_final.json"))
    assert trj["trj_id"] == [0, 2, 4]
    assert json.load(open(tmp_path / "plot" / "stats_final.json"))["rmse"] < 1e-6


# ---------------------------------------------------- rendering eval

class _JFrame:
    def __init__(self, T):
        self.T = T


def test_eval_rendering_matches_jax():
    """PSNR / SSIM of the same perturbed map at the same poses, through
    both packages, within 1e-4."""
    ji = JIntrinsics(fx=60.0, fy=60.0, cx=31.5, cy=23.5, width=64, height=48)
    ti = Intrinsics(*ji)
    ds = JSynthetic(ji, n_frames=8, n_gauss=600, seed=3, trans_amp=0.05,
                    rot_amp=0.02)
    sc = ds.scene
    n = sc.xyz.shape[0]
    m = jgm.new_map(1024)
    rng = np.random.default_rng(0)
    leaves = jgm.ParamLeaves(
        xyz=sc.xyz + 0.01 * rng.standard_normal(sc.xyz.shape).astype(np.float32),
        sh=sc.sh, log_scale=sc.log_scale, quat=sc.quat, opa_logit=sc.opa_logit)
    m = jgm.insert(m, leaves, jnp.int32(n), kf_id=0)
    tm = convert.map_from_numpy(
        *([np.asarray(y) for y in x] if isinstance(x, tuple) else np.asarray(x)
          for x in m), device="cpu")
    cfg = dict(tile=16, macro_tiles=4, k_macro=1024, k_fine=128)
    jframes = {i: _JFrame(ds.poses[i]) for i in range(8)}
    tframes = {i: _JFrame(torch.from_numpy(np.asarray(ds.poses[i])))
               for i in range(8)}
    a = jeval_rendering(jframes, m, ds, None, ji, JRenderConfig(**cfg),
                        kf_indices=[0, 4], interval=1)
    b = eval_rendering(tframes, tm, ds, None, ti, RenderConfig(**cfg),
                       kf_indices=[0, 4], interval=1)
    assert np.isfinite(b["mean_psnr"]) and b["mean_psnr"] < 60
    assert abs(a["mean_psnr"] - b["mean_psnr"]) < 1e-4, (a, b)
    assert abs(a["mean_ssim"] - b["mean_ssim"]) < 1e-4, (a, b)
    assert np.isnan(b["mean_lpips"])


# ---------------------------------------------------------- PLY

def _map(cap, n, sh_degree=0, seed=0, kf_id=0, steps=0):
    g = torch.Generator().manual_seed(seed)
    k = (sh_degree + 1) ** 2
    m = gm.new_map(cap, sh_degree=sh_degree, device="cpu")
    leaves = gm.ParamLeaves(
        xyz=torch.randn((cap, 3), generator=g),
        sh=0.2 * torch.randn((cap, k, 3), generator=g),
        log_scale=0.1 * torch.randn((cap, 3), generator=g) - 3.0,
        quat=torch.randn((cap, 4), generator=g),
        opa_logit=torch.randn((cap, 1), generator=g))
    m = gm.insert(m, leaves, n, kf_id)
    for step in range(1, steps + 1):
        grads = gm.ParamLeaves(*(torch.full_like(p, 0.1) for p in m.params))
        m = gm.adam_step(m, grads, gm.MapHyper(), step=step)
    return m


def test_ply_roundtrip(tmp_path):
    m = _map(64, 37)
    path = str(tmp_path / "map.ply")
    save_ply(m, path)
    assert os.path.getsize(path) > 0
    m2 = load_ply(path, device="cpu")
    assert int(m2.n_active) == 37
    for f in ("xyz", "opa_logit", "quat"):
        torch.testing.assert_close(getattr(m2.params, f)[:37],
                                   getattr(m.params, f)[:37], rtol=1e-6,
                                   atol=0)


def test_ply_roundtrip_sh_degree3(tmp_path):
    m = _map(16, 10, sh_degree=3)
    path = str(tmp_path / "map3.ply")
    save_ply(m, path)
    m2 = load_ply(path, device="cpu")
    assert int(m2.n_active) == 10
    assert m2.params.sh.shape[1] == 16
    torch.testing.assert_close(m2.params.sh[:10], m.params.sh[:10],
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_ply_across_packages(tmp_path, sh_degree):
    """A PLY written by either package loads in the other with the same
    active rows (the file holds float32, so exactly)."""
    m = _map(32, 20, sh_degree=sh_degree, seed=1)
    save_ply(m, str(tmp_path / "port.ply"))
    j = jply.load_ply(str(tmp_path / "port.ply"))
    assert int(j.n_active) == 20
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(j.params, f))[:20],
                                      getattr(m.params, f)[:20].numpy())
    jply.save_ply(j, str(tmp_path / "jax.ply"))
    back = load_ply(str(tmp_path / "jax.ply"), device="cpu")
    assert back.capacity == j.capacity
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back.params, f).numpy(),
                                      np.asarray(getattr(j.params, f)))
    np.testing.assert_array_equal(back.active.numpy(), np.asarray(j.active))
    np.testing.assert_array_equal(back.kf_id.numpy(), np.asarray(j.kf_id))


# ---------------------------------------------------- checkpoints

def _leaves_of(m):
    out = []
    for x in m:
        out.extend(x if isinstance(x, tuple) else [x])
    return out


def test_checkpoint_roundtrip_bitexact(tmp_path):
    m = _map(32, 20, kf_id=7, steps=1)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(m, path, extra={"iteration_count": 42})
    m2, extra = load_checkpoint(path, device="cpu")
    assert int(extra["iteration_count"]) == 42
    for a, b in zip(_leaves_of(m), _leaves_of(m2)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    g = gm.ParamLeaves(*(torch.full_like(p, 0.1) for p in m.params))
    torch.testing.assert_close(
        gm.adam_step(m, g, gm.MapHyper(), step=2).params.xyz,
        gm.adam_step(m2, g, gm.MapHyper(), step=2).params.xyz, rtol=0, atol=0)


def test_checkpoint_across_packages(tmp_path):
    """A checkpoint of either package loads in the other bit for bit,
    Adam moments and slot state included."""
    m = _map(32, 20, kf_id=3, steps=2)
    save_checkpoint(m, str(tmp_path / "port.npz"), extra={"it": 5})
    j, extra = jckpt.load_checkpoint(str(tmp_path / "port.npz"))
    assert int(extra["it"]) == 5
    for a, b in zip(_leaves_of(m), jax.tree.leaves(j)):
        np.testing.assert_array_equal(np.asarray(b), a.numpy())
        assert np.asarray(b).dtype == a.numpy().dtype
    j = jgm.adam_step(j, jgm.ParamLeaves(*(jnp.full_like(p, 0.05)
                                           for p in j.params)),
                      jgm.MapHyper(), step=jnp.int32(3))
    jckpt.save_checkpoint(j, str(tmp_path / "jax.npz"))
    back, _ = load_checkpoint(str(tmp_path / "jax.npz"), device="cpu")
    for a, b in zip(_leaves_of(back), jax.tree.leaves(j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.numpy().dtype == np.asarray(b).dtype


# ------------------------------------------------ profiling, metrics

def test_stage_timers_totals():
    timers = StageTimers(period=2)
    with timers.stage("a"):
        pass
    timers.add("a", 0.5)
    timers.add("b", 0.25)
    timers.frame_done()
    timers.frame_done()        # logs and restarts the period's sums
    timers.add("a", 1.0)
    assert timers.sums["a"] == 1.0 and timers.counts["a"] == 1
    assert timers.totals["a"] >= 1.5 and timers.total_counts["a"] == 3
    assert timers.totals["b"] == 0.25


def test_profile_logs_roundtrip_across_packages(tmp_path):
    """ProfileLogger's run-frame npz files load in both packages, and the
    JAX package's in the port's."""
    logger = ProfileLogger(str(tmp_path / "port"), save_period=2)
    for i in range(5):
        logger.log_frame(i, last_l1=float(i), pose=np.eye(4) * i,
                         fo_iters=i + 1)
    logger.close()
    for load in (load_profile_logs, jprof.load_profile_logs):
        recs = load(str(tmp_path / "port"))
        assert sorted(recs) == list(range(5))
        np.testing.assert_array_equal(recs[3]["pose"], np.eye(4) * 3)
        assert float(recs[4]["last_l1"]) == 4.0
    jl = jprof.ProfileLogger(str(tmp_path / "jax" / "stamp"), save_period=3)
    for i in range(4):
        jl.log_frame(i, last_l1=2.0 * i)
    jl.close()
    recs = load_profile_logs(str(tmp_path / "jax"))
    assert sorted(recs) == list(range(4)) and float(recs[3]["last_l1"]) == 6.0


def test_trace_names_its_slice():
    with pytest.raises(NotImplementedError, match="profiling slice"):
        with trace("unused"):
            pass


def test_metrics_logger(tmp_path):
    ml = MetricsLogger(save_dir=str(tmp_path))
    ml.log({"frame_idx": 3, "ate": np.float32(0.5)})
    ml.log({"frame_idx": 4, "ate": 0.25})
    ml.log_table("metrics_table", ["tag", "psnr"], [["Before", 20.0]])
    ml.finish()
    lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert lines == [{"frame_idx": 3, "ate": 0.5},
                     {"frame_idx": 4, "ate": 0.25}]
    table = json.load(open(tmp_path / "metrics_table.json"))
    assert table == {"columns": ["tag", "psnr"], "data": [["Before", 20.0]]}
    MetricsLogger(save_dir=None).log({"x": 1})   # no directory: no file
