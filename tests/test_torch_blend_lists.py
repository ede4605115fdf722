"""Parity of the plain PyTorch versions of the four list-blend kernels
(monogs_tpu_torch.render.blend_lists) with the JAX package's Pallas kernels
run in interpret mode (monogs_tpu.render.pallas_lists): the forward blend,
the forward blend with per-row counts, the fused first-order loss and
gradient (mono and RGB-D) and the primal-plus-six-tangents blend.

The rows are real: a dense opaque scene is binned and packed by the port on
the CPU, so pixels saturate and the early exit (T(1 - a) < 1e-4) fires; the
same numpy arrays go to both packages. The CUDA kernels themselves are held
against these plain versions on the card (tests/test_torch_cuda_kernels.py
and chip_smoke.py).

Tolerances (pallas_lists computes its reductions with three bf16 MXU
passes, about 2^-16 relative, and its transmittance with a blocked
cumprod):
- image and opacity atol 2e-5, depth 2e-4 (tests/test_pallas_lists.py);
- counts exact (integers summed in f32);
- row cotangents rtol 1e-3 plus an atol that is a fraction of the
  column's largest magnitude: the reverse blend forms
  abar = T * wbar - suffix / (1 - alpha), and the (u, v) and conic columns
  combine pixel moments up to 16^2 with opposite signs, so rounding is
  amplified by cancellation. Against the same function in float64 the
  Pallas kernel errs by 2e-5 of the column maximum on the RGB chain and
  1.8e-3 on the depth chain, the plain float32 version by 1e-6 and 2e-5;
  the atol is 1e-4 (RGB) and 4e-3 (depth) of the maximum, and the plain
  version is also held within 1e-4 of it against float64;
- per-tile sums rtol 1e-4 (sums of a few hundred per-pixel terms);
- tangents rtol 1e-3, atol 2e-4 of the channel's largest magnitude (the
  Pallas kernel's reductions err by up to 7e-5 of it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.render import pallas_lists as jpl
from monogs_tpu.ops import se3 as jse3
from monogs_tpu_torch.render import Intrinsics as TIntr
from monogs_tpu_torch.render import RenderConfig as TCfg
from monogs_tpu_torch.render import blend_lists as tbl
from monogs_tpu_torch.render import renderer as tr
from tests.test_torch_ops import both_gauss, npy, small_tau, surface_scene, t

# 48 px is not a multiple of the 32 px macro: the bottom tile row lies
# below the image and pix_ok must mask it
INTR = dict(fx=60.0, fy=60.0, cx=31.5, cy=23.5, width=64, height=48)
TILE = 16


def rows(k_fine, seed=0, n=500):
    """(d, d_tan, tx0, ty0, pmat, image) over all 16 tiles of a dense
    opaque scene, from the port's binning and packing."""
    sc = surface_scene(n, seed, spread=1.6, depth_mean=3.0,
                       scale_min=0.08, scale_max=0.25)
    _, tg = both_gauss(sc)
    T = t(np.asarray(jse3.se3_exp(small_tau(seed + 1, 0.02))))
    ti = TIntr(**INTR)
    tc = TCfg(tile=TILE, macro_tiles=2, k_macro=512, k_fine=k_fine,
              with_n_touched=False, backend="pallas_lists")
    lists = tr.build_tile_lists(tg, T, ti, tc, margin=4.0)
    d, d_tan = tr.tile_rows_jvp(tg, T, ti, tc, lists)
    tx0, ty0 = tr._tile_origins(ti, tc, "cpu")
    pmat = tr._tile_pmat(tc, "cpu")
    return d, d_tan, tx0, ty0, pmat


def j(x):
    return jnp.asarray(npy(x))


def assert_outs(a, b):
    np.testing.assert_allclose(a[..., :3], b[..., :3], atol=2e-5)
    np.testing.assert_allclose(a[..., 3], b[..., 3], atol=2e-4)
    np.testing.assert_allclose(a[..., 4], b[..., 4], atol=2e-5)
    np.testing.assert_array_equal(a[..., 5:], 0.0)


def assert_per_column(a, b, frac, name, rtol=1e-3):
    """|a - b| <= rtol |b| + frac * (largest |b| of the last-axis column)."""
    scale = np.abs(b).max(axis=tuple(range(b.ndim - 1)), keepdims=True)
    bound = rtol * np.abs(b) + frac * scale
    bad = np.abs(a - b) > bound
    assert not bad.any(), (name, int(bad.sum()), np.argwhere(bad)[:5])


def terminated_fraction(d, tx0, ty0, pmat):
    """Share of pixels whose walk ended early (some later row passed the
    alpha test but no longer contributes)."""
    f = tbl._forward_plain(d, tx0, ty0, pmat, W, H)
    return float((f["ok"] & ~f["contrib"]).any(dim=1).float().mean())


W, H = INTR["width"], INTR["height"]


@pytest.mark.parametrize("k_fine", [96, 256])
def test_blend_and_counts_parity(k_fine):
    """Forward blend and per-row contributing-pixel counts. k_fine 256 makes
    the Pallas kernel scan K in two chunks (_chunk_kc), which pins the
    transmittance carry across chunks."""
    d, _, tx0, ty0, pmat = rows(k_fine)
    if k_fine == 256:
        assert jpl._pick_bt_kc(d.shape[0], k_fine)[1] < k_fine
    ref = np.asarray(jpl.blend_lists_pallas(j(d), j(tx0), j(ty0), j(pmat),
                                            TILE, W, H, True))
    outs = npy(tbl.blend_lists(d, tx0, ty0, pmat, W, H))
    assert_outs(outs, ref)
    # the scene saturates: many pixels terminate before the list ends
    assert terminated_fraction(d, tx0, ty0, pmat) > 0.2

    ref_o, ref_c = jpl.blend_lists_pallas_counts(
        j(d), j(tx0), j(ty0), j(pmat), TILE, W, H, True)
    outs_c, cnts = tbl.blend_lists_counts(d, tx0, ty0, pmat, W, H)
    assert_outs(npy(outs_c), np.asarray(ref_o))
    np.testing.assert_array_equal(npy(cnts), np.asarray(ref_c))
    assert npy(cnts).max() > 0
    # rows behind saturated pixels contribute nowhere; the tiles of the
    # bottom macro row's lower half (y0 = 48) lie below the image
    assert (npy(cnts) == 0).any()
    below = [10, 11, 14, 15]
    assert (npy(ty0)[below] == H).all()
    np.testing.assert_array_equal(outs[below], 0.0)
    np.testing.assert_array_equal(npy(cnts)[below], 0.0)


@pytest.mark.parametrize("rgbd", [False, True])
@pytest.mark.parametrize("k_fine", [96, 256])
def test_fo_grad_parity(rgbd, k_fine):
    """Fused first-order kernel: row cotangents of the Huber RGB chain (and
    of the depth chain for RGB-D) and the per-tile partial sums."""
    d, _, tx0, ty0, pmat = rows(k_fine, seed=3)
    ref_img = tbl.blend_lists(d, tx0, ty0, pmat, W, H)
    rng = np.random.default_rng(11)
    n_t, p = ref_img.shape[:2]
    gt = np.clip(npy(ref_img[..., :3]) + rng.normal(0, 0.03, (n_t, p, 3)),
                 0.0, 1.0).astype(np.float32)
    mask = (rng.uniform(size=(n_t, p, 1)) > 0.2).astype(np.float32)
    gtd = None
    if rgbd:
        gtd = (npy(ref_img[..., 3:4])
               * rng.uniform(0.97, 1.03, (n_t, p, 1))).astype(np.float32)
    ea, eb = np.float32(1.07), np.float32(0.015)
    args = dict(use_huber=True, delta=0.01, eps=1e-8)
    jdd, jddd, jsums = jpl.fo_grad_lists_pallas(
        j(d), j(tx0), j(ty0), j(pmat), j(gt), j(mask), jnp.float32(ea),
        jnp.float32(eb), TILE, W, H, True,
        gtd_t=None if gtd is None else j(gtd), **args)
    dd, ddd, sums = tbl.fo_grad_lists(
        d, tx0, ty0, pmat, t(gt), t(mask), torch.tensor(ea),
        torch.tensor(eb), W, H, gtd_t=None if gtd is None else t(gtd),
        **args)
    assert_per_column(npy(dd), np.asarray(jdd), 1e-4, "dd")
    np.testing.assert_allclose(npy(sums), np.asarray(jsums), rtol=1e-4,
                               atol=1e-7)
    # the Huber knee is crossed on both sides, so both slopes are exercised
    r = np.abs(npy(sums)[:, 1]).sum()
    assert r > 0 and np.abs(npy(dd)).max() > 0
    f64 = [x.double() if x is not None else None for x in
           (d, tx0, ty0, pmat, t(gt), t(mask), torch.tensor(ea),
            torch.tensor(eb), None if gtd is None else t(gtd))]
    dd64, ddd64, _ = tbl.fo_grad_lists(*f64[:8], W, H, gtd_t=f64[8], **args)
    assert_per_column(npy(dd), npy(dd64), 1e-4, "dd vs float64")
    if rgbd:
        assert_per_column(npy(ddd), np.asarray(jddd), 4e-3, "dd_dep")
        assert_per_column(npy(ddd), npy(ddd64), 1e-4, "dd_dep vs float64")
        assert float(sums[:, 4].sum()) > 0
    else:
        assert ddd is None and jddd is None


@pytest.mark.parametrize("k_fine", [96, 256])
def test_jvp8_parity(k_fine):
    """Primal plus six pose tangents over the real row tangents of
    preprocess + pack."""
    d, d_tan, tx0, ty0, pmat = rows(k_fine, seed=5)
    jo, jt = jpl.blend_lists_jvp8(j(d), j(d_tan), j(tx0), j(ty0), j(pmat),
                                  TILE, W, H, True)
    outs, touts = tbl.blend_lists_jvp8(d, d_tan, tx0, ty0, pmat, W, H)
    assert_outs(npy(outs), np.asarray(jo))
    assert_per_column(npy(touts), np.asarray(jt), 2e-4, "touts")
    assert np.abs(npy(touts)).max() > 1.0


def test_wrappers_check_devices():
    """A wrapper runs its plain version only for CPU tensors; any other
    device raises instead of falling back."""
    d, _, tx0, ty0, pmat = rows(96)
    meta = d.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tbl.blend_lists(meta, tx0, ty0, pmat, W, H)
    before = dict(tbl.LAUNCHES)
    tbl.blend_lists(d, tx0, ty0, pmat, W, H)
    assert tbl.LAUNCHES == before          # the plain path is not a launch
