"""The port's synthetic dataset against the JAX package's: the handheld-pace
calibration ``tum_like_amps``, the poses of both motions, the default
render backend and the intrinsics attributes. The scene itself is drawn
from a ``torch.Generator`` (a known difference: tests carry a scene across
with ``convert.py``), so only its deterministic parts are compared.

Tolerances: ``tum_like_amps`` rtol 1e-6 (both measure the unit orbit in
float32, and the per-frame rotation goes through an arccos near 1, which
turns a last-bit difference of the two packages' se3_exp into up to 7e-7
relative at 64 frames); poses atol 1e-6."""

import types

import numpy as np
import pytest

from tests.torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def pk():
    from monogs_tpu.data import synthetic as jsyn
    from monogs_tpu_torch.data import synthetic as tsyn
    from monogs_tpu_torch.render import Intrinsics

    intr = Intrinsics(fx=60.0, fy=58.0, cx=31.5, cy=23.5, width=64,
                      height=48)
    return types.SimpleNamespace(jsyn=jsyn, tsyn=tsyn, intr=intr)


def dataset(pk, **kw):
    return pk.tsyn.SyntheticDataset(pk.intr, n_gauss=64, seed=3,
                                    device="cpu", **kw)


@pytest.mark.parametrize("n_frames", [8, 32, 64])
def test_tum_like_amps_matches_jax(pk, n_frames):
    np.testing.assert_allclose(pk.tsyn.tum_like_amps(n_frames),
                               pk.jsyn.tum_like_amps(n_frames), rtol=1e-6)


@pytest.mark.parametrize("motion", ["orbit", "tum_like"])
def test_poses_match_jax(pk, motion):
    n = 3
    ds = dataset(pk, n_frames=n, motion=motion, trans_amp=0.2, rot_amp=0.05,
                 sensor_type="monocular")
    amps = (pk.jsyn.tum_like_amps(n) if motion == "tum_like"
            else (0.2, 0.05))
    assert len(ds) == n and ds[0][1] is None
    for i in range(n):
        want = np.asarray(pk.jsyn.orbit_pose(i / n, *amps))
        np.testing.assert_allclose(ds.poses[i].numpy(), want, rtol=0,
                                   atol=1e-6)
        assert ds[i][0].shape == (3, pk.intr.height, pk.intr.width)


def test_unknown_motion_raises(pk):
    with pytest.raises(ValueError, match="unknown synthetic motion mode"):
        dataset(pk, n_frames=2, motion="spiral")


def test_default_backend_is_the_references(pk, monkeypatch):
    """Without ``render_cfg`` the frames are rendered with
    ``RenderConfig()``, whose backend is "xla" in both packages; a given
    configuration is used as it is (without n_touched)."""
    from monogs_tpu.render import RenderConfig as JaxRenderConfig
    from monogs_tpu_torch.render import RenderConfig

    seen = []
    render = pk.tsyn.render

    def spy(scene, T, intr, cfg):
        seen.append(cfg)
        return render(scene, T, intr, cfg)

    monkeypatch.setattr(pk.tsyn, "render", spy)
    ds = dataset(pk, n_frames=2)
    assert [c.backend for c in seen] == ["xla", "xla"]
    assert RenderConfig().backend == JaxRenderConfig().backend == "xla"
    assert not seen[0].with_n_touched
    assert ds[1][1].shape == (pk.intr.height, pk.intr.width)
    seen.clear()
    dataset(pk, n_frames=1, render_cfg=RenderConfig(backend="pallas_lists",
                                                    k_fine=64))
    assert seen[0] == RenderConfig(backend="pallas_lists", k_fine=64,
                                   with_n_touched=False)


def test_intrinsics_attributes(pk):
    ds = dataset(pk, n_frames=1)
    intr = pk.intr
    assert (ds.fx, ds.fy, ds.cx, ds.cy) == (intr.fx, intr.fy, intr.cx,
                                            intr.cy)
    assert (ds.width, ds.height) == (intr.width, intr.height)
    assert ds.fovx == pytest.approx(2 * np.arctan(64 / 120.0))
    assert ds.fovy == pytest.approx(2 * np.arctan(48 / 116.0))
    assert ds.intr is intr and ds.num_imgs == 1
