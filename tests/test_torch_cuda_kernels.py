"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc: the kernels have no CPU mode, so
they skip elsewhere. Run them on a machine with a card:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda

The file imports no JAX, so it also runs where JAX is not installed.
Tolerances are those of chip_smoke.py (the same float32 math in the same
order along K; sums over pixels in another order).
"""

import pytest
import torch

from chip_smoke import TF32_SPLIT_FRAC, as_f64, f64_excess
from monogs_tpu_torch.data.synthetic import make_synthetic_scene
from monogs_tpu_torch.ops import se3
from monogs_tpu_torch.render import Intrinsics, RenderConfig
from monogs_tpu_torch.render import blend_lists as bl
from monogs_tpu_torch.render import renderer as rr

pytestmark = pytest.mark.cuda

INTR = Intrinsics(fx=120.0, fy=120.0, cx=63.5, cy=47.5, width=128,
                  height=96)
CFG = RenderConfig(tile=16, macro_tiles=4, k_macro=1024, k_fine=96,
                   with_n_touched=False, backend="pallas_lists")
W, H = INTR.width, INTR.height


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def scene_rows(dev, n=3000, k_fine=96, tile=16):
    cfg = CFG._replace(k_fine=k_fine, tile=tile)
    g = torch.Generator().manual_seed(0)
    scene = make_synthetic_scene(g, n=n, spread=2.0, depth_mean=3.0,
                                 scale_min=0.03, scale_max=0.09)
    scene = type(scene)(*(x.to(dev) for x in scene))
    T = se3.se3_exp(torch.tensor([0.01, -0.02, 0.0, 0.01, 0.0, -0.01],
                                 device=dev))
    d = rr.frame_rows(scene, T, INTR, cfg)[0]
    lists = rr.build_tile_lists(scene, T, INTR, cfg, margin=8.0)
    d_j, d_tan = rr.tile_rows_jvp(scene, T, INTR, cfg, lists)
    tx0, ty0 = rr._tile_origins(INTR, cfg, dev)
    return d, d_j, d_tan, tx0, ty0, rr._tile_pmat(cfg, dev)


def ground_truth(d, tx0, ty0, pmat, dev, seed=1):
    """gt image (render + noise), mask and gt depth [T, P, .] for rows d,
    residuals kept away from 0 (the L1 sign)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    img = bl.blend_lists_plain(d, tx0, ty0, pmat, W, H)
    gt = (img[..., :3] + 0.03 + 0.03 * torch.randn(
        img[..., :3].shape, generator=g, device=dev)).contiguous()
    mask = (torch.rand(img[..., :1].shape, generator=g, device=dev)
            > 0.2).float()
    gtd = (img[..., 3:4] * 1.02 + 0.05).contiguous()
    return gt, mask, gtd


def assert_outs(got, want):
    torch.testing.assert_close(got[..., :3], want[..., :3], rtol=0,
                               atol=2e-5)
    torch.testing.assert_close(got[..., 3], want[..., 3], rtol=0, atol=2e-4)
    torch.testing.assert_close(got[..., 4], want[..., 4], rtol=0, atol=2e-5)


def assert_per_column(got, want, frac, rtol=1e-3):
    scale = torch.amax(torch.abs(want).reshape(-1, want.shape[-1]), 0)
    bad = torch.abs(got - want) > rtol * torch.abs(want) + frac * scale
    assert not bool(bad.any()), int(bad.sum())


def test_blend_and_counts_on_card(card):
    d, _, _, tx0, ty0, pmat = scene_rows(card)
    n0 = dict(bl.LAUNCHES)
    assert_outs(bl.blend_lists(d, tx0, ty0, pmat, W, H),
                bl.blend_lists_plain(d, tx0, ty0, pmat, W, H))
    outs, cnts = bl.blend_lists_counts(d, tx0, ty0, pmat, W, H)
    want, want_c = bl.blend_lists_counts_plain(d, tx0, ty0, pmat, W, H)
    assert_outs(outs, want)
    assert torch.equal(cnts, want_c) and float(cnts.sum()) > 0
    assert bl.LAUNCHES["fwd"] == n0["fwd"] + 1
    assert bl.LAUNCHES["fwd_counts"] == n0["fwd_counts"] + 1


@pytest.mark.parametrize("rgbd", [False, True])
def test_fo_grad_on_card(card, rgbd):
    _, d, _, tx0, ty0, pmat = scene_rows(card)
    n = d.shape[0]
    tx, ty = tx0[:n], ty0[:n]
    g = torch.Generator(device=card).manual_seed(1)
    img = bl.blend_lists_plain(d, tx, ty, pmat, W, H)
    gt = torch.clamp(img[..., :3] + 0.03 * torch.randn(
        img[..., :3].shape, generator=g, device=card), 0, 1).contiguous()
    mask = (torch.rand(img[..., :1].shape, generator=g, device=card)
            > 0.2).float()
    gtd = (img[..., 3:4] * 1.02).contiguous() if rgbd else None
    args = (d, tx, ty, pmat, gt, mask, torch.tensor(1.07, device=card),
            torch.tensor(0.015, device=card), W, H)
    kw = dict(use_huber=True, delta=0.01, eps=1e-8, gtd_t=gtd)
    dd, ddd, sums = bl.fo_grad_lists(*args, **kw)
    pdd, pddd, psums = bl.fo_grad_lists_plain(*args, **kw)
    assert_per_column(dd, pdd, 1e-4)
    torch.testing.assert_close(sums, psums, rtol=1e-4, atol=1e-6)
    if rgbd:
        assert_per_column(ddd, pddd, 1e-4)


def check_jvp8(dev, tile):
    """jvp8 against its plain version, and in float64 within chip_smoke's
    bound (its tangent sums are fused multiply-adds); two launches give
    the same bits."""
    _, d, d_tan, tx0, ty0, pmat = scene_rows(dev, tile=tile)
    n = d.shape[0]
    n0 = bl.LAUNCHES["jvp8"]
    outs, touts = bl.blend_lists_jvp8(d, d_tan, tx0[:n], ty0[:n], pmat, W, H)
    again = bl.blend_lists_jvp8(d, d_tan, tx0[:n], ty0[:n], pmat, W, H)
    assert bl.LAUNCHES["jvp8"] == n0 + 2
    assert torch.equal(outs, again[0]) and torch.equal(touts, again[1])
    p_outs, p_touts = bl.blend_lists_jvp8_plain(d, d_tan, tx0[:n], ty0[:n],
                                                pmat, W, H)
    assert_outs(outs, p_outs)
    assert_per_column(touts, p_touts, 2e-4)
    t64 = bl.blend_lists_jvp8_plain(*as_f64(torch, (
        d, d_tan, tx0[:n], ty0[:n], pmat)), W, H)[1]
    assert f64_excess(torch, touts, p_touts, t64) <= TF32_SPLIT_FRAC
    assert float(torch.abs(p_touts).max()) > 0


def test_jvp8_on_card(card):
    check_jvp8(card, 16)


@pytest.mark.parametrize("k_fine", [96, 256])
@pytest.mark.parametrize("mode", ["mono", "rgbd", "init", "subset"])
def test_map_grad_on_card(card, mode, k_fine):
    d, _, _, tx0, ty0, pmat = scene_rows(card, k_fine=k_fine)
    gt, mask, gtd = ground_truth(d, tx0, ty0, pmat, card)
    px_frac = 1.0
    if mode == "subset":
        sel = torch.arange(0, d.shape[0], 2, device=card)
        d, tx0, ty0 = d[sel].contiguous(), tx0[sel], ty0[sel]
        gt, mask, gtd = gt[sel], mask[sel], gtd[sel]
        px_frac = 0.5
    args = (d, tx0, ty0, pmat, gt, mask, torch.tensor(1.07, device=card),
            torch.tensor(0.015, device=card), W, H, mode != "init", 0.9,
            1e-8)
    kw = dict(gtd_t=gtd if mode == "rgbd" else None, px_frac=px_frac)
    n0 = dict(bl.LAUNCHES)
    dd, sums = bl.map_grad_lists(*args, **kw)
    pdd, psums = bl.map_grad_lists_plain(*args, **kw)
    key = "map_grad_rgbd" if mode == "rgbd" else "map_grad"
    assert bl.LAUNCHES[key] == n0[key] + 1
    assert_per_column(dd, pdd, 1e-4)
    torch.testing.assert_close(sums, psums, rtol=1e-4, atol=1e-5)
    assert float(psums[:, 0].sum()) > 0 and float(torch.abs(pdd).max()) > 0


def check_map_grad_madd(card, rgbd, k_fine, tile):
    """The madd variant on raw gathered rows (empty list slots hold
    Gaussian 0's row): against its plain version, and bit for bit against
    the kernel without madd on the same rows pre-masked."""
    cfg = CFG._replace(k_fine=k_fine, tile=tile)
    g = torch.Generator().manual_seed(0)
    scene = make_synthetic_scene(g, n=3000, spread=2.0, depth_mean=3.0,
                                 scale_min=0.03, scale_max=0.09)
    scene = type(scene)(*(x.to(card) for x in scene))
    T = se3.se3_exp(torch.tensor([0.01, -0.02, 0.0, 0.01, 0.0, -0.01],
                                 device=card))
    lists = rr.build_tile_lists(scene, T, INTR, cfg, margin=4.0)
    prep, packed, _, _ = rr._project(scene, T, INTR, cfg, lists=lists)
    vld = lists.vld & prep.valid[lists.idx]
    raw = packed[lists.idx].contiguous()
    madd = torch.where(vld, 0.0, -1e30).to(torch.float32)
    masked = rr._masked_rows(raw, vld)
    assert not bool(vld.all())
    tx0, ty0 = rr._tile_origins(INTR, cfg, card)
    pmat = rr._tile_pmat(cfg, card)
    gt, mask, gtd = ground_truth(masked, tx0, ty0, pmat, card)
    args = (tx0, ty0, pmat, gt, mask, torch.tensor(1.07, device=card),
            torch.tensor(0.015, device=card), W, H, True, 0.9, 1e-8)
    kw = dict(gtd_t=gtd if rgbd else None)
    n0 = dict(bl.LAUNCHES)
    dd, sums = bl.map_grad_lists(raw, *args, madd=madd, **kw)
    key = "map_grad_madd_rgbd" if rgbd else "map_grad_madd"
    assert bl.LAUNCHES[key] == n0[key] + 1
    pdd, psums = bl.map_grad_lists_plain(raw, *args, madd=madd, **kw)
    assert_per_column(dd, pdd, 1e-4)
    torch.testing.assert_close(sums, psums, rtol=1e-4, atol=1e-5)
    m_dd, m_sums = bl.map_grad_lists(masked, *args, **kw)
    assert torch.equal(dd, m_dd) and torch.equal(sums, m_sums)
    assert float(psums[:, 0].sum()) > 0 and float(torch.abs(pdd).max()) > 0


@pytest.mark.parametrize("k_fine", [96, 256])
@pytest.mark.parametrize("rgbd", [False, True])
def test_map_grad_madd_on_card(card, rgbd, k_fine):
    check_map_grad_madd(card, rgbd, k_fine, 16)


# ---- the fused steps' live-chunk walk and tensor-core row sums at the
# shapes that stress them: a list length that is no multiple of the 32-row
# chunk, 8 px tiles (P 64), an image that is no multiple of the tile (some
# pixels, and whole tiles, beyond its edge), a tile whose rows are all
# invalid and a tile whose pixels all terminate in the first chunk

ODD = Intrinsics(fx=120.0, fy=120.0, cx=59.5, cy=44.5, width=120, height=90)


def edge_rows(dev, k_fine, tile):
    """(d, tx0, ty0, pmat, gt, mask, gtd) over every tile of the 120x90
    frame; tile 0's rows are invalid, and tile 1 starts with three
    tile-wide opaque rows (alpha 0.99), so each of its pixels terminates at
    row 2."""
    cfg = CFG._replace(k_fine=k_fine, tile=tile)
    g = torch.Generator().manual_seed(0)
    scene = make_synthetic_scene(g, n=3000, spread=2.0, depth_mean=3.0,
                                 scale_min=0.03, scale_max=0.09)
    scene = type(scene)(*(x.to(dev) for x in scene))
    T = se3.se3_exp(torch.tensor([0.01, -0.02, 0.0, 0.01, 0.0, -0.01],
                                 device=dev))
    d = rr.frame_rows(scene, T, ODD, cfg)[0].clone()
    tx0, ty0 = rr._tile_origins(ODD, cfg, dev)
    pmat = rr._tile_pmat(cfg, dev)
    d[0, :, rr._LOGO] = -1e30
    wall = d[1, 0].clone()
    wall[rr._U] = tx0[1] + tile / 2
    wall[rr._V] = ty0[1] + tile / 2
    wall[rr._CA], wall[rr._CB], wall[rr._CC] = 1e-4, 0.0, 1e-4
    wall[rr._LOGO] = 0.0
    d[1, :3] = wall
    d = d.contiguous()
    img = bl.blend_lists_plain(d, tx0, ty0, pmat, ODD.width, ODD.height)
    gen = torch.Generator(device=dev).manual_seed(1)
    gt = (img[..., :3] + 0.03 + 0.03 * torch.randn(
        img[..., :3].shape, generator=gen, device=dev)).contiguous()
    mask = (torch.rand(img[..., :1].shape, generator=gen, device=dev)
            > 0.2).float()
    gtd = (img[..., 3:4] * 1.02 + 0.05).contiguous()
    return d, tx0, ty0, pmat, gt, mask, gtd


@pytest.mark.parametrize("shape", [(40, 16), (96, 16), (256, 16), (96, 8),
                                   (96, 32), (256, 32)])
@pytest.mark.parametrize("kind", ["fo_grad", "fo_grad_rgbd", "map_grad",
                                  "map_grad_rgbd"])
def test_fused_steps_edges_on_card(card, kind, shape):
    """Each fused step against its plain version, and in float64 within
    chip_smoke's bound for the split TF32 products; two launches give the
    same bits; the invalid tile and the terminated tile's rows after its
    third get exact zeros."""
    k_fine, tile = shape
    d, tx0, ty0, pmat, gt, mask, gtd = edge_rows(card, k_fine, tile)
    assert pmat.shape[1] == tile * tile
    pix_ok = ((tx0[:, None] + pmat[3] <= ODD.width - 1)
              & (ty0[:, None] + pmat[4] <= ODD.height - 1))
    assert not bool(pix_ok.all()) and not bool(pix_ok.any(1).all())
    ea = torch.tensor(1.07, device=card)
    eb = torch.tensor(0.015, device=card)
    rgbd = kind.endswith("rgbd")
    if kind.startswith("fo_grad"):
        args = (d, tx0, ty0, pmat, gt, mask, ea, eb, ODD.width, ODD.height)
        kw = dict(use_huber=True, delta=0.01, eps=1e-8,
                  gtd_t=gtd if rgbd else None)
        fn, plain, s_atol = bl.fo_grad_lists, bl.fo_grad_lists_plain, 1e-6
    else:
        args = (d, tx0, ty0, pmat, gt, mask, ea, eb, ODD.width, ODD.height,
                True, 0.9, 1e-8)
        kw = dict(gtd_t=gtd if rgbd else None)
        fn, plain, s_atol = bl.map_grad_lists, bl.map_grad_lists_plain, 1e-5
    n0 = bl.LAUNCHES[kind]
    got, again, want = fn(*args, **kw), fn(*args, **kw), plain(*args, **kw)
    assert bl.LAUNCHES[kind] == n0 + 2
    for x, y in zip(got, again):
        assert x is None or torch.equal(x, y)
    torch.testing.assert_close(got[-1], want[-1], rtol=1e-4, atol=s_atol)
    kw64 = dict(kw, gtd_t=gtd.double() if rgbd else None)
    want64 = plain(*as_f64(torch, args), **kw64)
    for x, y, y64 in zip(got[:-1], want[:-1], want64[:-1]):
        if y is None:
            continue
        assert_per_column(x, y, 1e-4)
        assert f64_excess(torch, x, y, y64) <= TF32_SPLIT_FRAC
        assert float(torch.abs(x[0]).max()) == 0.0
        assert float(torch.abs(x[1, 3:]).max()) == 0.0
    assert float(torch.abs(want[0][1, :2]).max()) > 0
    assert float(torch.abs(want[0]).max()) > 0


@pytest.mark.parametrize("kind", ["map_grad_madd", "map_grad_madd_rgbd",
                                  "jvp8", "bwd"])
def test_wide_tiles_on_card(card, kind):
    """32 px tiles (P 1024; the tensor-core reverse walks four pixel slices
    of 256): the madd variant, jvp8 and the blend VJP against their plain
    versions as at 16 px (the fused steps at 32 px:
    test_fused_steps_edges_on_card)."""
    if kind == "jvp8":
        check_jvp8(card, 32)
    elif kind == "bwd":
        check_blend_vjp(card, 96, 32)
    else:
        check_map_grad_madd(card, kind.endswith("rgbd"), 96, 32)


def check_blend_vjp(dev, k_fine, tile):
    """The blend VJP against its plain version, and in float64 within
    chip_smoke's bound for the split TF32 row sums; two launches give the
    same bits."""
    d, _, _, tx0, ty0, pmat = scene_rows(dev, k_fine=k_fine, tile=tile)
    g = torch.Generator(device=dev).manual_seed(2)
    g_outs = torch.randn((d.shape[0], pmat.shape[1], 8), generator=g,
                         device=dev)
    n0 = bl.LAUNCHES["bwd"]
    dd = bl.blend_lists_vjp(d, tx0, ty0, pmat, g_outs, W, H)
    assert torch.equal(dd, bl.blend_lists_vjp(d, tx0, ty0, pmat, g_outs, W,
                                              H))
    assert bl.LAUNCHES["bwd"] == n0 + 2
    want = bl.blend_lists_vjp_plain(d, tx0, ty0, pmat, g_outs, W, H)
    assert_per_column(dd, want, 1e-4)
    want64 = bl.blend_lists_vjp_plain(
        *as_f64(torch, (d, tx0, ty0, pmat, g_outs)), W, H)
    assert f64_excess(torch, dd, want, want64) <= TF32_SPLIT_FRAC
    assert float(torch.abs(want).max()) > 0


@pytest.mark.parametrize("k_fine", [96, 256])
def test_blend_vjp_on_card(card, k_fine):
    check_blend_vjp(card, k_fine, 16)


def test_blend_function_backward_on_card(card):
    """The differentiable blend's backward (the VJP kernel) against
    autograd through the plain version, on the same card."""
    d, _, _, tx0, ty0, pmat = scene_rows(card)
    g = torch.Generator(device=card).manual_seed(3)
    wts = torch.randn((d.shape[0], pmat.shape[1], 8), generator=g,
                      device=card)
    grads = []
    for fn in (bl.blend_lists_fn, bl.blend_lists_plain):
        x = d.clone().requires_grad_(True)
        (torch.sum(fn(x, tx0, ty0, pmat, W, H) * wts)).backward()
        grads.append(x.grad)
    assert_per_column(grads[0], grads[1], 1e-4)


def test_densify_and_prune_on_card(card):
    """densify_and_prune with clones, splits (some beyond split_cap) and
    prunes on the card (compaction by cumsum and searchsorted, the split
    noise turned into each Gaussian's frame, the slot fill) against the
    same call on the CPU: the same slots, parameters within float32
    rounding."""
    from monogs_tpu_torch.models import gaussian_map as gm

    g = torch.Generator().manual_seed(4)
    n, cap = 600, 2048

    def rand(*shape):
        return torch.rand(shape, generator=g)

    leaves = gm.ParamLeaves(
        xyz=3.0 * rand(n, 3) - 1.5, sh=rand(n, 1, 3),
        log_scale=torch.log(0.01 + 0.08 * rand(n, 3)),
        quat=torch.nn.functional.normalize(rand(n, 4) - 0.5, dim=-1),
        opa_logit=4.0 * rand(n, 1) - 1.0)
    m = gm.insert(gm.new_map(cap, device="cpu"), leaves, n, kf_id=3)
    m = m._replace(grad_accum=4e-4 * rand(cap), denom=torch.ones(cap))
    samples = torch.randn((2, 128, 3), generator=g)
    args = (2e-4, 0.3, 6.0, 20, gm.MapHyper())
    kw = dict(clone_cap=256, split_cap=128)
    hot = m.active & (m.grad_accum >= 2e-4)
    small = torch.exp(m.params.log_scale).max(-1).values <= 0.06
    assert int((hot & small).sum()) > 0 and int((hot & ~small).sum()) > 128
    want = gm.densify_and_prune(m, None, *args, samples=samples, **kw)
    got = gm.densify_and_prune(m.to(card), None, *args,
                               samples=samples.to(card), **kw).to("cpu")
    for k in ("active", "kf_id", "n_obs"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    for k, x, y in zip(got.params._fields, got.params, want.params):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6, msg=k)
    assert int(want.n_active) != int(m.n_active)


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    d, _, _, tx0, ty0, pmat = scene_rows(card)
    with pytest.raises(ValueError, match="contiguous"):
        bl.blend_lists(d.transpose(0, 1).contiguous().transpose(0, 1),
                       tx0, ty0, pmat, W, H)
    with pytest.raises(ValueError, match="float32 CUDA"):
        bl.blend_lists(d, tx0.cpu(), ty0, pmat, W, H)


# ------------------------------------------------------ macro-list kernels

def macro_case(dev, shape):
    """(data_m, xy0, counts, pmat, tile, ft_side, W, H, k_fine) from a
    synthetic scene binned at a small pose: the small frame of this file,
    the bench's 640x480 (k_macro 1024, k_fine 96), the 320x240 of
    configs/synthetic/rgbd.yaml (k_macro 4096, k_fine 256) or a 100x77
    frame that is no multiple of the tile. Macro 0's count is set to 0 and
    the first ten valid rows of macro 1 are moved off every tile."""
    intr, k_macro, k_fine, n = {
        "small": (INTR, 1024, 96, 3000),
        "bench": (Intrinsics(fx=535.4, fy=539.2, cx=320.1, cy=247.6,
                             width=640, height=480), 1024, 96, 30000),
        "rgbd": (Intrinsics(fx=320.0, fy=320.0, cx=159.5, cy=119.5,
                            width=320, height=240), 4096, 256, 30000),
        "odd": (Intrinsics(fx=100.0, fy=100.0, cx=49.5, cy=38.0, width=100,
                           height=77), 1024, 96, 3000),
    }[shape]
    cfg = CFG._replace(k_macro=k_macro, k_fine=k_fine)
    g = torch.Generator().manual_seed(5)
    scene = make_synthetic_scene(g, n=n, spread=2.0, depth_mean=3.0,
                                 scale_min=0.015, scale_max=0.06)
    scene = type(scene)(*(x.to(dev) for x in scene))
    T = se3.se3_exp(torch.tensor([0.01, -0.02, 0.0, 0.01, 0.0, -0.01],
                                 device=dev))
    with torch.no_grad():
        _, packed, _, aux = rr._project(scene, T, intr, cfg)
        data_m, xy0, counts = rr.macro_rows(packed, aux)
        data_m = data_m.contiguous()
    counts[0] = 0.0
    data_m[1, :10, rr._U] = -1000.0
    assert float(counts[1]) > 10 and float(counts.max()) > 0
    return (data_m, xy0, counts, rr._tile_pmat(cfg, dev), cfg.tile,
            cfg.macro_tiles, intr.width, intr.height, k_fine)


def macro_fns(kind, k_fine):
    """(k_fine argument, plain forward, plain VJP with the same trailing
    arguments, launch counter keys) of the masked walk or of the compact
    blend."""
    from monogs_tpu_torch.render import blend_macros as bm

    if kind == "macro":
        return (None, bm.blend_macros_plain, bm.blend_macros_vjp_plain, (),
                ("macro_fwd", "macro_bwd"))
    return (k_fine, bm.blend_compact_plain, bm.blend_compact_vjp_plain,
            (k_fine,), ("compact_fwd", "compact_bwd"))


@pytest.mark.parametrize("shape", ["small", "bench", "rgbd", "odd"])
@pytest.mark.parametrize("kind", ["macro", "compact"])
def test_macro_kernels_on_card(card, kind, shape):
    """Forward and VJP of the masked walk and of the compact blend against
    their plain versions; a macro with count 0 and rows off every tile
    get no cotangent; two launches of the VJP are bit-identical."""
    from monogs_tpu_torch.render import blend_macros as bm

    (data_m, xy0, counts, pmat, tile, fs, w, h, k_fine) = macro_case(card,
                                                                     shape)
    kf, fwd_p, vjp_p, extra, keys = macro_fns(kind, k_fine)
    args = (data_m, xy0, counts, pmat)
    geo = (tile, fs, w, h)
    n0 = dict(bm.LAUNCHES)
    outs = bm.blend_macros(*args, *geo, k_fine=kf)
    assert_outs(outs, fwd_p(*args, *geo, *extra))
    g = torch.Generator(device=card).manual_seed(6)
    g_outs = torch.randn(outs.shape, generator=g, device=card)
    dd = bm.blend_macros_vjp(*args, g_outs, *geo, k_fine=kf)
    want = vjp_p(*args, g_outs, *geo, *extra)
    assert_per_column(dd, want, 1e-4)
    assert torch.equal(dd, bm.blend_macros_vjp(*args, g_outs, *geo,
                                               k_fine=kf))
    assert bm.LAUNCHES[keys[0]] == n0[keys[0]] + 1
    assert bm.LAUNCHES[keys[1]] == n0[keys[1]] + 2
    assert float(torch.abs(dd[0]).max()) == 0.0
    assert float(torch.abs(dd[1, :10]).max()) == 0.0
    assert float(torch.abs(outs[0, ..., 4]).max()) == 0.0
    assert float(torch.abs(want).max()) > 0


@pytest.mark.parametrize("kind", ["macro", "compact"])
def test_macro_function_backward_on_card(card, kind):
    """The differentiable Function's backward (the VJP kernel) against
    autograd through the plain forward, on the same card."""
    from monogs_tpu_torch.render import blend_macros as bm

    (data_m, xy0, counts, pmat, tile, fs, w, h, k_fine) = macro_case(card,
                                                                     "small")
    kf, fwd_p, _, extra, _ = macro_fns(kind, k_fine)
    g = torch.Generator(device=card).manual_seed(7)
    wts = torch.randn((data_m.shape[0], fs * fs, tile * tile, 8),
                      generator=g, device=card)
    grads = []
    for f, tail, kw in ((bm.blend_macros_fn, (), dict(k_fine=kf)),
                        (fwd_p, extra, {})):
        x = data_m.clone().requires_grad_(True)
        torch.sum(f(x, xy0, counts, pmat, tile, fs, w, h, *tail, **kw)
                  * wts).backward()
        grads.append(x.grad)
    assert_per_column(grads[0], grads[1], 1e-4)


def test_macro_list_too_long_is_refused(card):
    """A masked-walk VJP whose row index and checkpoints do not fit in a
    CTA's shared memory raises, and the next launch runs."""
    from monogs_tpu_torch.render import blend_macros as bm

    (data_m, xy0, counts, pmat, tile, fs, w, h, _) = macro_case(card,
                                                                "small")
    long_m = torch.zeros((data_m.shape[0], 16384, data_m.shape[2]),
                         device=card)
    long_m[:, :data_m.shape[1]] = data_m
    g_outs = torch.ones((data_m.shape[0], fs * fs, tile * tile, 8),
                        device=card)
    with pytest.raises(RuntimeError, match="macro_bwd"):
        bm.blend_macros_vjp(long_m, xy0, counts, pmat, g_outs, tile, fs, w, h)
    outs = bm.blend_macros(data_m, xy0, counts, pmat, tile, fs, w, h)
    assert_outs(outs, bm.blend_macros_plain(data_m, xy0, counts, pmat, tile,
                                            fs, w, h))
