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

import functools

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
from chip_smoke import TF32_SPLIT_FRAC, f64_excess
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


FO_ARGS = dict(use_huber=True, delta=0.01, eps=1e-8)


@functools.lru_cache(maxsize=None)
def fo_case(rgbd, k_fine):
    """(torch inputs of fo_grad_lists, JAX kernel's (dd, dd_dep, sums)) on
    the rows of seed 3, with a noisy gt, a random mask and (RGB-D) a gt
    depth; the JAX kernel runs once per case."""
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
    jdd, jddd, jsums = jpl.fo_grad_lists_pallas(
        j(d), j(tx0), j(ty0), j(pmat), j(gt), j(mask), jnp.float32(ea),
        jnp.float32(eb), TILE, W, H, True,
        gtd_t=None if gtd is None else j(gtd), **FO_ARGS)
    args = (d, tx0, ty0, pmat, t(gt), t(mask), torch.tensor(ea),
            torch.tensor(eb), None if gtd is None else t(gtd))
    return args, tuple(None if x is None else np.asarray(x)
                       for x in (jdd, jddd, jsums))


@pytest.mark.parametrize("rgbd", [False, True])
@pytest.mark.parametrize("k_fine", [96, 256])
def test_fo_grad_parity(rgbd, k_fine):
    """Fused first-order kernel: row cotangents of the Huber RGB chain (and
    of the depth chain for RGB-D) and the per-tile partial sums."""
    args, (jdd, jddd, jsums) = fo_case(rgbd, k_fine)
    dd, ddd, sums = tbl.fo_grad_lists(*args[:8], W, H, gtd_t=args[8],
                                      **FO_ARGS)
    assert_per_column(npy(dd), jdd, 1e-4, "dd")
    np.testing.assert_allclose(npy(sums), jsums, rtol=1e-4, atol=1e-7)
    # the Huber knee is crossed on both sides, so both slopes are exercised
    r = np.abs(npy(sums)[:, 1]).sum()
    assert r > 0 and np.abs(npy(dd)).max() > 0
    f64 = [x.double() if x is not None else None for x in args]
    dd64, ddd64, _ = tbl.fo_grad_lists(*f64[:8], W, H, gtd_t=f64[8],
                                       **FO_ARGS)
    assert_per_column(npy(dd), npy(dd64), 1e-4, "dd vs float64")
    if rgbd:
        assert_per_column(npy(ddd), jddd, 4e-3, "dd_dep")
        assert_per_column(npy(ddd), npy(ddd64), 1e-4, "dd_dep vs float64")
        assert float(sums[:, 4].sum()) > 0
    else:
        assert ddd is None and jddd is None


# ---- the arithmetic of the CUDA fused steps and blend VJP
# (csrc/blend_common.cuh, reverse_chunk_tc), emulated: the row sums are TF32
# products on the tensor cores with each float32 operand split into a TF32
# big part and a TF32 remainder, and the rows of the chunks of 32 that no
# pixel walks into get zeros without a reverse.

KC = 32


def tf32(x):
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero (PTX cvt.rna.tf32.f32)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def tc_product(a, b, b_exact, split=True):
    """sum_p a[t, k, p] b[t, p, j] as the kernels' TF32 passes: a = big +
    small; b exact in TF32 (the pixel basis): small.b + big.b; else b = bb
    + bs: small.bb + big.bs + big.bb. The products of TF32 values are exact
    in float64; the float32 accumulation of the tensor cores, in an order
    the hardware picks, is stood for by float64 sums. ``split`` False: a
    single pass, big.bb."""
    ab = tf32(a)
    a_s = tf32(a - ab)
    if not split:
        parts = [(ab, tf32(b))]
    elif b_exact:
        assert torch.equal(tf32(b), b)
        parts = [(a_s, b), (ab, b)]
    else:
        bb = tf32(b)
        parts = [(a_s, bb), (ab, tf32(b - bb)), (ab, bb)]
    return sum(torch.einsum("tkp,tpj->tkj", x.double(), y.double())
               for x, y in parts).float()


def tc_reverse(f, pmat, g_outs, pix_ok, split=True):
    """Row cotangents [T, K, F] from output cotangents g_outs [T, P, 8] as
    the kernels compute them (_dd_from_gouts_plain's math); pix_ok [T, P]:
    the pixels inside the image."""
    w, feats, alpha, contrib = f["w"], f["feats"], f["alpha"], f["contrib"]
    n_t, kf, p = w.shape
    wbar = torch.einsum("tkf,tpf->tkp", feats, g_outs)
    abar = (torch.where(contrib, f["t_excl"] * wbar, torch.zeros_like(w))
            - tbl._excl_suffix_sum(wbar * w, 1) / f["one_minus"])
    sbar = torch.where(contrib & (alpha < 0.99), alpha * abar,
                       torch.zeros_like(w))
    # a chunk is live if some pixel of the image walks into it, that is
    # terminates at a row after the chunk's first or never
    term = f["ok"] & ~f["contrib"]
    stop = torch.where(term.any(1), term.int().argmax(1), kf)   # [T, P]
    first = torch.arange(kf) // KC * KC
    live = ((first[None, :, None] < stop[:, None, :])
            & pix_ok[:, None, :]).any(-1)                       # [T, K]
    assert not bool(((sbar != 0) & ~live[..., None]).any())
    G = tc_product(sbar, pmat.T.expand(n_t, p, 6), True, split)
    fbar = tc_product(w, g_outs[..., :4].contiguous(), False, split)
    g0, g1, g2, g3, g4, g5 = G.unbind(-1)
    a, b, c, ul, vl = f["a"], f["b"], f["c"], f["ul"], f["vl"]
    z = torch.zeros_like(a)
    cols = [z] * tbl._F
    cols[tbl._U] = a * g3 + b * g4 - (a * ul + b * vl) * g5
    cols[tbl._V] = b * g3 + c * g4 - (b * ul + c * vl) * g5
    cols[tbl._CA] = -0.5 * g0 + ul * g3 - 0.5 * ul * ul * g5
    cols[tbl._CB] = -g1 + vl * g3 + ul * g4 - ul * vl * g5
    cols[tbl._CC] = -0.5 * g2 + vl * g4 - 0.5 * vl * vl * g5
    cols[tbl._LOGO] = g5
    cols[tbl._R0], cols[tbl._G0], cols[tbl._B0], cols[tbl._Z] = \
        fbar.unbind(-1)
    dd = torch.stack(cols, dim=-1)
    return torch.where(live[..., None], dd, torch.zeros_like(dd))


def fo_grad_tc(d, tx0, ty0, pmat, gt_t, mask_t, ea, eb, gtd_t, use_huber,
               delta, eps, split=True):
    """(dd, dd_dep) of the fused first-order step as the CUDA kernel
    computes them (the residual and output cotangents of
    fo_grad_lists_plain); ``split`` False: single TF32 passes."""
    f = tbl._forward_plain(d, tx0, ty0, pmat, W, H)
    pix_ok = ((tx0[:, None] + pmat[3] <= W - 1)
              & (ty0[:, None] + pmat[4] <= H - 1))
    outs = f["outs"]
    col, acc = outs[..., 0:3], outs[..., 4:5]
    e = torch.abs(ea) + eps
    diff = e * col + eb - gt_t
    am = acc * mask_t
    r = am * diff
    assert use_huber
    ax = torch.abs(r)
    safe = torch.sqrt(torch.clamp(2.0 * delta * ax - delta * delta,
                                  min=1e-20))
    small = ax < delta
    hub = torch.where(small, r, torch.sign(r) * safe)
    rbar = 2.0 * hub * torch.where(small, torch.ones_like(r), delta / safe)
    z1 = torch.zeros_like(acc)
    g_outs = torch.cat([rbar * am * e, z1,
                        torch.sum(rbar * mask_t * diff, -1, keepdim=True),
                        z1, z1, z1], dim=-1)
    dd_dep = None
    if gtd_t is not None:
        r_d = torch.where((gtd_t > 0.01) & (acc > 0.95),
                          outs[..., 3:4] - gtd_t, torch.zeros_like(gtd_t))
        dd_dep = tc_reverse(f, pmat, torch.cat(
            [z1, z1, z1, 2.0 * r_d, z1, z1, z1, z1], -1), pix_ok, split)
    return tc_reverse(f, pmat, g_outs, pix_ok, split), dd_dep


def test_tf32_rounding():
    """tf32 keeps 10 mantissa bits, rounds to nearest with ties away from
    zero, and big + remainder restores a float32 to 2^-22 of itself."""
    one = 1.0 + 2.0 ** -10
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), one,
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0, 0.0],
                     dtype=torch.float32)
    np.testing.assert_array_equal(
        npy(tf32(x)), np.float32([one, -one, one, 1.0, 3.0, 0.0]))
    y = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32))
    big = tf32(y)
    rel = torch.abs((big.double() + tf32(y - big).double()) - y.double())
    assert float((rel / torch.abs(y.double())).max()) <= 2.0 ** -22
    assert float((torch.abs(big - y) / torch.abs(y)).max()) <= 2.0 ** -11


@pytest.mark.parametrize("rgbd", [False, True])
@pytest.mark.parametrize("k_fine", [96, 256])
def test_fo_grad_tc_emulation(rgbd, k_fine):
    """The fused first-order step's arithmetic on the card (TF32
    big/remainder products, zero rows in chunks no pixel walks into) holds
    against the plain version and the Pallas kernel within chip_smoke's
    tolerances (dd and dd_dep rtol 1e-3 + 1e-4 of the column's largest
    magnitude; the depth chain against Pallas 4e-3, as above)."""
    args, (jdd, jddd, _) = fo_case(rgbd, k_fine)
    dd, ddd = fo_grad_tc(*args, **FO_ARGS)
    pdd, pddd, _ = tbl.fo_grad_lists_plain(*args[:8], W, H, gtd_t=args[8],
                                           **FO_ARGS)
    assert d_chunks(k_fine) > 1
    assert_per_column(npy(dd), npy(pdd), 1e-4, "dd vs plain")
    assert_per_column(npy(dd), jdd, 1e-4, "dd vs Pallas")
    # the products do round: a single TF32 pass errs by 2^-11
    assert not torch.equal(dd, pdd)
    if rgbd:
        assert_per_column(npy(ddd), npy(pddd), 1e-4, "dd_dep vs plain")
        assert_per_column(npy(ddd), jddd, 4e-3, "dd_dep vs Pallas")
        assert float(torch.abs(ddd).max()) > 0


@pytest.mark.parametrize("rgbd", [False, True])
@pytest.mark.parametrize("k_fine", [96, 256])
def test_fo_grad_tc_precision(rgbd, k_fine):
    """The bound that chip_smoke.py and the card tests hold the fused steps
    to against the plain version in float64 (f64_excess at most
    TF32_SPLIT_FRAC, 2^-14 of a column's largest magnitude beyond the
    float32 plain version's own error) separates the kernels' split TF32
    products from single TF32 passes, which err by about 2^-11 of a
    product: the split meets it, a single pass does not."""
    args, _ = fo_case(rgbd, k_fine)
    f64 = [x.double() if x is not None else None for x in args]
    dd64, ddd64, _ = tbl.fo_grad_lists_plain(*f64[:8], W, H, gtd_t=f64[8],
                                             **FO_ARGS)
    pdd, pddd, _ = tbl.fo_grad_lists_plain(*args[:8], W, H, gtd_t=args[8],
                                           **FO_ARGS)
    for split in (True, False):
        dd, ddd = fo_grad_tc(*args, **FO_ARGS, split=split)
        ex = [f64_excess(torch, dd, pdd, dd64)]
        if rgbd:
            ex.append(f64_excess(torch, ddd, pddd, ddd64))
        if split:
            assert max(ex) <= TF32_SPLIT_FRAC / 4, ex
        else:
            assert min(ex) > 2 * TF32_SPLIT_FRAC, ex


@pytest.mark.parametrize("k_fine", [96, 256])
def test_blend_vjp_tc_precision(k_fine):
    """The blend VJP's arithmetic on the card (the fused steps' tensor-core
    reverse with the output cotangent of every column read per pixel: r,
    g, b and depth as feature sums, acc through wbar) against the plain
    version in float64: the split TF32 products meet chip_smoke's bound
    (f64_excess at most TF32_SPLIT_FRAC) with room, single passes do not."""
    d, _, tx0, ty0, pmat = rows(k_fine, seed=6)
    g_outs = torch.from_numpy(np.random.default_rng(7).normal(
        size=(d.shape[0], pmat.shape[1], 8)).astype(np.float32))
    f = tbl._forward_plain(d, tx0, ty0, pmat, W, H)
    pix_ok = ((tx0[:, None] + pmat[3] <= W - 1)
              & (ty0[:, None] + pmat[4] <= H - 1))
    plain = tbl.blend_lists_vjp_plain(d, tx0, ty0, pmat, g_outs, W, H)
    dd64 = tbl.blend_lists_vjp_plain(*(x.double() for x in (
        d, tx0, ty0, pmat, g_outs)), W, H)
    assert float(torch.abs(plain).max()) > 0
    for split in (True, False):
        ex = f64_excess(torch, tc_reverse(f, pmat, g_outs, pix_ok, split),
                        plain, dd64)
        if split:
            assert ex <= TF32_SPLIT_FRAC / 4, ex
        else:
            assert ex > 2 * TF32_SPLIT_FRAC, ex


def d_chunks(kf):
    return (kf + KC - 1) // KC


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


def fma(a, b, c):
    """a b + c rounded once to float32, as CUDA's fmaf: the product of two
    float32 values is exact in float64, and the float64 sum rounded to
    float32 is fmaf's result but where the two roundings meet (one ulp,
    rarely)."""
    return (a.double() * b.double() + c.double()).float()


def jvp8_rows(d, d_tan, tx0, ty0, pmat, fused=True):
    """touts [T, 6, P, 8] of the jvp8 kernel's arithmetic: the primal as
    the plain version computes it (the kernel rounds s, alpha and T the
    same way), each pixel's tangent carries and sums added row by row in
    the kernel's order, with its fused multiply-adds (``fused`` False: a
    product and a sum, each rounded, as the kernel before them). Rows at
    or after a pixel's terminating row change nothing the outputs read."""
    mad = fma if fused else (lambda a, b, c: a * b + c)
    f = tbl._forward_plain(d, tx0, ty0, pmat, W, H)
    n_t, kf, p = f["w"].shape
    pre = torch.zeros(n_t, tbl._NTAN, p)
    to = torch.zeros(n_t, tbl._NTAN, p, 8)
    for k in range(kf):
        def at(name):
            return f[name][:, k, None]                       # [T, 1, P]

        def col(i):
            return d_tan[:, :, k, i, None]                    # [T, 6, 1]

        alpha, tx, dx, dy = at("alpha"), at("t_excl"), at("dx"), at("dy")
        contrib = at("contrib")
        a, b, c = (f[n][:, k, None, None] for n in ("a", "b", "c"))
        xx, yy, xy = -0.5 * (dx * dx), -0.5 * (dy * dy), dx * dy
        gx, gy = a * dx + b * dy, b * dx + c * dy
        inv_om = 1.0 / (1.0 - alpha)
        s_t = mad(col(tbl._CA), xx, mad(col(tbl._CC), yy, mad(
            -col(tbl._CB), xy, mad(-gx, col(tbl._U), mad(
                -gy, col(tbl._V), col(tbl._LOGO))))))
        alpha_t = torch.where(at("ok") & (alpha < 0.99), alpha * s_t,
                              torch.zeros_like(s_t))
        w_t = mad(alpha_t, tx, alpha * (tx * pre))
        w = alpha * tx
        for ci, fc in enumerate((tbl._R0, tbl._G0, tbl._B0, tbl._Z)):
            new = mad(w_t, d[:, k, fc, None, None],
                      mad(w, col(fc), to[..., ci]))
            to[..., ci] = torch.where(contrib, new, to[..., ci])
        to[..., 4] = torch.where(contrib, to[..., 4] + w_t, to[..., 4])
        pre = torch.where(contrib, mad(-alpha_t, inv_om, pre), pre)
    return to


@pytest.mark.parametrize("k_fine", [96, 256])
def test_jvp8_fma_precision(k_fine):
    """The jvp8 kernel's tangent sums in fused multiply-adds against the
    plain version in float64: within chip_smoke's bound (f64_excess at most
    TF32_SPLIT_FRAC of a channel's largest magnitude beyond the float32
    plain version's own error; both the fused and the unfused row order
    read about 3e-7 at 96 rows and 1.8e-6 at 256), and no more than twice
    the unfused row order's largest error; within the card's tolerance
    of the float32 plain version, whose bits they do not give."""
    d, d_tan, tx0, ty0, pmat = rows(k_fine, seed=5)
    plain = tbl.blend_lists_jvp8_plain(d, d_tan, tx0, ty0, pmat, W, H)[1]
    t64 = tbl.blend_lists_jvp8_plain(*(x.double() for x in (
        d, d_tan, tx0, ty0, pmat)), W, H)[1]
    got = jvp8_rows(d, d_tan, tx0, ty0, pmat)
    unfused = jvp8_rows(d, d_tan, tx0, ty0, pmat, fused=False)
    assert f64_excess(torch, got, plain, t64) <= TF32_SPLIT_FRAC
    scale = torch.amax(torch.abs(t64).reshape(-1, 8), 0).clamp_min(1e-300)

    def err(x):
        return float((torch.abs(x.double() - t64).reshape(-1, 8).amax(0)
                      / scale).max())

    assert err(got) <= 2 * err(unfused), (err(got), err(unfused))
    assert not torch.equal(got, plain)
    assert_per_column(npy(got), npy(plain), 2e-4, "touts")
    assert float(torch.abs(t64).max()) > 1.0


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
