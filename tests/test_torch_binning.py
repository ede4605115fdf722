"""Parity of the port's binning half (preprocess, macro instance binning,
per-tile lists, fine-stage refinement, tile layout) with the JAX package.

Sort keys are unique integers (``macro * 2R + margin_bit + depth rank``), so
the lists agree index for index wherever both packages computed the same
geometry; preprocess is the same f32 elementwise math (``rtol 1e-5``: XLA
may fuse a multiply-add where PyTorch rounds twice)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.ops import se3 as jse3
from monogs_tpu.render import Intrinsics as JIntr
from monogs_tpu.render import RenderConfig as JCfg
from monogs_tpu.render import renderer as jr
from monogs_tpu.render import tiling as jtiling
from monogs_tpu.render.primitives import preprocess as jpre
from monogs_tpu_torch.render import Intrinsics as TIntr
from monogs_tpu_torch.render import RenderConfig as TCfg
from monogs_tpu_torch.render import renderer as tr
from monogs_tpu_torch.render import tiling as ttiling
from monogs_tpu_torch.render.primitives import preprocess as tpre
from tests.test_torch_ops import blob_scene, both_gauss, npy, small_tau, t
from tests.torch_one_thread import one_torch_thread  # noqa: F401

# 48 px is not a multiple of the 32 px macro: the bottom macro row is partial
INTR = dict(fx=60.0, fy=60.0, cx=31.5, cy=23.5, width=64, height=48)
CFG = dict(tile=16, macro_tiles=2, k_macro=256, k_fine=64,
           with_n_touched=False, backend="pallas_lists")


def setup(n=160, seed=0, pose_scale=0.05):
    jg, tg = both_gauss(blob_scene(n, seed))
    T = np.asarray(jse3.se3_exp(small_tau(seed + 100, pose_scale)))
    return jg, tg, T, JIntr(**INTR), TIntr(**INTR), JCfg(**CFG), TCfg(**CFG)


def prep_both(jg, tg, T, ji, ti, sh_degree=0):
    a = jpre(jg.xyz, jg.log_scale, jg.quat, jg.opa_logit, jg.sh, jg.active,
             jnp.asarray(T), ji, sh_degree=sh_degree)
    b = tpre(tg.xyz, tg.log_scale, tg.quat, tg.opa_logit, tg.sh, tg.active,
             t(T), ti, sh_degree=sh_degree)
    return a, b


@pytest.mark.parametrize("sh_degree", [0, 1])
def test_preprocess_parity(sh_degree):
    sc = blob_scene(200, 3)
    if sh_degree:
        sc["sh"] = np.random.default_rng(0).uniform(-1, 1, (200, 4, 3))
    jg, tg = both_gauss(sc)
    T = np.asarray(jse3.se3_exp(small_tau(1, 0.1)))
    a, b = prep_both(jg, tg, T, JIntr(**INTR), TIntr(**INTR), sh_degree)
    for name in ("mean2d", "conic", "opacity", "rgb", "z", "radius"):
        np.testing.assert_allclose(npy(getattr(b, name)),
                                   np.asarray(getattr(a, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(npy(b.valid), np.asarray(a.valid))


@pytest.mark.parametrize("margin,span_cap,k_big", [
    (0.0, 16, 128),     # shipped capacities
    (8.0, 16, 128),     # strict-first priority under a margin
    (8.0, 2, 4),        # sidecar fills: span overflow and n_overflow
])
def test_macro_instance_bin_parity(margin, span_cap, k_big):
    jg, tg, T, ji, ti, jc, tc = setup(n=300, seed=4)
    a, b = prep_both(jg, tg, T, ji, ti)
    order = np.argsort(np.where(np.asarray(a.valid), np.asarray(a.z), np.inf),
                       kind="stable")
    u, v = np.asarray(a.mean2d[:, 0])[order], np.asarray(a.mean2d[:, 1])[order]
    rs = np.asarray(a.radius)[order]
    val = np.asarray(a.valid)[order]
    r = np.where(val, rs + margin, rs) if margin else rs
    args = (2, 2, 32, 64, span_cap, k_big)
    js = jtiling.macro_instance_bin(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(r), jnp.asarray(val),
        *args, radius_strict=jnp.asarray(rs) if margin else None)
    ts = ttiling.macro_instance_bin(
        t(u), t(v), t(r), t(val), *args,
        radius_strict=t(rs) if margin else None)
    np.testing.assert_array_equal(npy(ts[1]), np.asarray(js[1]))
    np.testing.assert_array_equal(npy(ts[0]), np.asarray(js[0]))
    assert int(ts[2]) == int(js[2])
    if span_cap == 2:
        assert int(js[2]) > 0          # the overflow path really ran


@pytest.mark.parametrize("margin", [0.0, 8.0])
def test_make_lists_parity(margin):
    jg, tg, T, ji, ti, jc, tc = setup(n=400, seed=5)
    jl, jaux = jr.build_tile_lists(jg, jnp.asarray(T), ji, jc, margin=margin,
                                   with_aux=True)
    tl, taux = tr.build_tile_lists(tg, t(T), ti, tc, margin=margin,
                                   with_aux=True)
    np.testing.assert_array_equal(npy(tl.vld), np.asarray(jl.vld))
    np.testing.assert_array_equal(npy(tl.idx), np.asarray(jl.idx))
    np.testing.assert_array_equal(npy(taux.sel_m), np.asarray(jaux.sel_m))
    np.testing.assert_array_equal(npy(taux.vld_m), np.asarray(jaux.vld_m))
    # a tile subset builds the same rows, in tsel order
    tsel = np.array([5, 0, 3, 7], np.int32)
    jl_s = jr.build_tile_lists(jg, jnp.asarray(T), ji, jc, margin=margin,
                               tsel=jnp.asarray(tsel))
    tl_s = tr.build_tile_lists(tg, t(T), ti, tc, margin=margin,
                               tsel=t(tsel).long())
    np.testing.assert_array_equal(npy(tl_s.idx), np.asarray(jl_s.idx))
    np.testing.assert_array_equal(npy(tl_s.idx), npy(tl.idx)[tsel])


def test_refine_fine_lists_parity():
    """Fine-stage rebinning at a moved pose against frozen margin macro
    lists: fresh overlap, fresh depth order."""
    jg, tg, T, ji, ti, jc, tc = setup(n=400, seed=6)
    _, jaux = jr.build_tile_lists(jg, jnp.asarray(T), ji, jc, margin=8.0,
                                  with_aux=True)
    _, taux = tr.build_tile_lists(tg, t(T), ti, tc, margin=8.0,
                                  with_aux=True)
    T1 = np.asarray(jse3.retract(T, small_tau(7, 0.004)))
    tsel = np.array([0, 2, 4, 6, 1], np.int32)
    jl = jr.refine_fine_lists(jg, jnp.asarray(T1), ji, jc, jaux,
                              jnp.asarray(tsel))
    tl = tr.refine_fine_lists(tg, t(T1), ti, tc, taux, t(tsel).long())
    np.testing.assert_array_equal(npy(tl.vld), np.asarray(jl.vld))
    np.testing.assert_array_equal(npy(tl.idx), np.asarray(jl.idx))


def test_tile_layout_parity():
    """tile_images (zero padding of the partial macro row) and the tile
    origins are the JAX layout."""
    ji, ti = JIntr(**INTR), TIntr(**INTR)
    jc, tc = JCfg(**CFG), TCfg(**CFG)
    img = np.random.default_rng(0).uniform(size=(3, 48, 64)).astype(np.float32)
    np.testing.assert_array_equal(npy(tr.tile_images(t(img), ti, tc)),
                                  np.asarray(jr.tile_images(img, ji, jc)))
    jx, jy = jr._tile_origins(ji, jc)
    tx, ty = tr._tile_origins(ti, tc, "cpu")
    np.testing.assert_array_equal(npy(tx), np.asarray(jx))
    np.testing.assert_array_equal(npy(ty), np.asarray(jy))
    assert tx.shape[0] == 16           # 2x2 macros of 2x2 tiles; the bottom
    #                                    macro row is partial (48 = 32 + 16)
    pm = npy(tr._tile_pmat(tc, "cpu"))
    p = np.arange(256)
    np.testing.assert_array_equal(
        pm, np.asarray(jr._pixel_basis((p % 16).astype(np.float32),
                                       (p // 16).astype(np.float32))))


def test_int32_key_overflow_asserts():
    """The int32 range of the binning keys is asserted, as in the JAX
    package (renderer._make_lists)."""
    ti = TIntr(fx=500.0, fy=500.0, cx=4000.0, cy=4000.0, width=8192,
               height=8192)
    tc = TCfg(**{**CFG, "tile": 8, "macro_tiles": 1})
    n = 2 ** 12 + 1
    z = torch.ones(n)
    with pytest.raises(AssertionError, match="overflow int32"):
        tr._make_lists(z, z, z, torch.ones(n, dtype=torch.bool), z, ti, tc)
