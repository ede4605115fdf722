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

from chip_smoke import TF32_SPLIT_FRAC, as_f64, f64_excess, textured_pair
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


@pytest.mark.parametrize("shape", [(96, 16), (40, 16), (256, 16), (96, 8),
                                   (96, 32), (40, 32)])
def test_blend_and_counts_on_card(card, shape):
    """fwd and fwd_counts against their plain versions on edge_rows' frame
    with one more tile wholly beyond the image edge, counts exactly; two
    launches give the same bits, and the two kernels the same outputs; the
    invalid tile and the tile beyond the edge blend nothing, and the tile
    whose pixels all terminate by row 2 (in the first chunk) counts no row
    after it."""
    k_fine, tile = shape
    d, tx0, ty0, pmat = edge_rows(card, k_fine, tile)[:4]
    d = torch.cat([d, d[2:3]]).contiguous()
    tx0 = torch.cat([tx0, tx0.new_tensor([float(ODD.width)])])
    ty0 = torch.cat([ty0, ty0[2:3]])
    args = (d, tx0, ty0, pmat, ODD.width, ODD.height)
    n0 = dict(bl.LAUNCHES)
    outs, again = bl.blend_lists(*args), bl.blend_lists(*args)
    (oc, cnts), (oc2, cnts2) = (bl.blend_lists_counts(*args),
                                bl.blend_lists_counts(*args))
    assert bl.LAUNCHES["fwd"] == n0["fwd"] + 2
    assert bl.LAUNCHES["fwd_counts"] == n0["fwd_counts"] + 2
    assert torch.equal(outs, again) and torch.equal(oc, oc2)
    assert torch.equal(cnts, cnts2) and torch.equal(oc, outs)
    want, want_c = bl.blend_lists_counts_plain(*args)
    assert_outs(outs, want)
    assert torch.equal(cnts, want_c) and float(cnts.sum()) > 0
    for tl in (0, -1):
        assert float(outs[tl].abs().max()) == 0.0
        assert float(cnts[tl].abs().max()) == 0.0
    assert float(cnts[1, 0]) > 0 and float(cnts[1, 3:].abs().max()) == 0


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
    shifted = torch.empty(d.numel() + 1, device=card)[1:].view(d.shape)
    with pytest.raises(ValueError, match="16-byte"):
        bl.blend_lists(shifted, tx0, ty0, pmat, W, H)


# ------------------------------------------------------ macro-list kernels

BENCH_INTR = Intrinsics(fx=535.4, fy=539.2, cx=320.1, cy=247.6, width=640,
                        height=480)
RGBD_INTR = Intrinsics(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320,
                       height=240)


def macro_case(dev, shape):
    """(data_m, xy0, counts, pmat, tile, ft_side, W, H, k_fine) from a
    synthetic scene binned at a small pose: the small frame of this file,
    the bench's 640x480 (k_macro 1024, k_fine 96), the 320x240 of
    configs/synthetic/rgbd.yaml (k_macro 4096, k_fine 256), a 100x77
    frame that is no multiple of the tile, the bench's in 32 px tiles (P
    1024 with k_macro 1024) or a deep 320x240 (k_macro 8192, 60k large
    Gaussians of opacity 0.006-0.03: 1,000-2,700 rows enter a fine tile and
    pixels walk past 1,024 of them, so the index and the VJP's checkpoints
    spill to global scratch). The last two are shapes that the earlier
    macro VJP refused for its shared memory. Macro 0's count is set to 0
    and the first ten valid rows of macro 1 are moved off every tile."""
    intr, k_macro, k_fine, n, tile = {
        "small": (INTR, 1024, 96, 3000, 16),
        "bench": (BENCH_INTR, 1024, 96, 30000, 16),
        "rgbd": (RGBD_INTR, 4096, 256, 30000, 16),
        "odd": (Intrinsics(fx=100.0, fy=100.0, cx=49.5, cy=38.0, width=100,
                           height=77), 1024, 96, 3000, 16),
        "tile32": (BENCH_INTR, 1024, 96, 30000, 32),
        "deep": (RGBD_INTR, 8192, 256, 60000, 16),
    }[shape]
    cfg = CFG._replace(k_macro=k_macro, k_fine=k_fine, tile=tile)
    g = torch.Generator().manual_seed(5)
    scale = (0.03, 0.1) if shape == "deep" else (0.015, 0.06)
    scene = make_synthetic_scene(g, n=n, spread=2.0, depth_mean=3.0,
                                 scale_min=scale[0], scale_max=scale[1])
    scene = type(scene)(*(x.to(dev) for x in scene))
    T = se3.se3_exp(torch.tensor([0.01, -0.02, 0.0, 0.01, 0.0, -0.01],
                                 device=dev))
    with torch.no_grad():
        _, packed, _, aux = rr._project(scene, T, intr, cfg)
        data_m, xy0, counts = rr.macro_rows(packed, aux)
        data_m = data_m.contiguous()
    counts[0] = 0.0
    data_m[1, :10, rr._U] = -1000.0
    if shape == "deep":
        opa = torch.rand(data_m.shape[:2], generator=g.manual_seed(6))
        data_m[..., rr._LOGO] = torch.log(0.006 + 0.024 * opa).to(dev)
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


@pytest.mark.parametrize("shape", ["small", "bench", "rgbd", "odd", "tile32",
                                   "deep"])
@pytest.mark.parametrize("kind", ["macro", "compact"])
def test_macro_kernels_on_card(card, kind, shape):
    """Forward and VJP of the masked walk and of the compact blend against
    their plain versions, the VJP also in float64 (f64_excess at most
    2^-14 of a column maximum, as the list VJP); a macro with count 0 and
    rows off every tile get no cotangent; two launches of each are
    bit-identical."""
    from monogs_tpu_torch.render import blend_macros as bm

    (data_m, xy0, counts, pmat, tile, fs, w, h, k_fine) = macro_case(card,
                                                                     shape)
    kf, fwd_p, vjp_p, extra, keys = macro_fns(kind, k_fine)
    args = (data_m, xy0, counts, pmat)
    geo = (tile, fs, w, h)
    n0 = dict(bm.LAUNCHES)
    outs = bm.blend_macros(*args, *geo, k_fine=kf)
    assert_outs(outs, fwd_p(*args, *geo, *extra))
    assert torch.equal(outs, bm.blend_macros(*args, *geo, k_fine=kf))
    g = torch.Generator(device=card).manual_seed(6)
    g_outs = torch.randn(outs.shape, generator=g, device=card)
    dd = bm.blend_macros_vjp(*args, g_outs, *geo, k_fine=kf)
    want = vjp_p(*args, g_outs, *geo, *extra)
    assert_per_column(dd, want, 1e-4)
    want64 = vjp_p(*as_f64(torch, args + (g_outs,)), *geo, *extra)
    assert f64_excess(torch, dd, want, want64) <= TF32_SPLIT_FRAC
    assert torch.equal(dd, bm.blend_macros_vjp(*args, g_outs, *geo,
                                               k_fine=kf))
    assert bm.LAUNCHES[keys[0]] == n0[keys[0]] + 2
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
    """A masked-walk VJP over a list of 16,384 rows, which the earlier VJP
    refused (its row index and checkpoints lived in shared memory), now
    runs and matches the plain version; the shared memory of neither
    macro kernel depends on the list's length, and the next launch runs."""
    from monogs_tpu_torch.render import blend_macros as bm

    (data_m, xy0, counts, pmat, tile, fs, w, h, _) = macro_case(card,
                                                                "small")
    long_m = torch.zeros((data_m.shape[0], 16384, data_m.shape[2]),
                         device=card)
    long_m[:, :data_m.shape[1]] = data_m
    g_outs = torch.ones((data_m.shape[0], fs * fs, tile * tile, 8),
                        device=card)
    dd = bm.blend_macros_vjp(long_m, xy0, counts, pmat, g_outs, tile, fs, w,
                             h)
    assert_per_column(dd, bm.blend_macros_vjp_plain(
        long_m, xy0, counts, pmat, g_outs, tile, fs, w, h), 1e-4)
    assert float(torch.abs(dd[:, data_m.shape[1]:]).max()) == 0.0
    from chip_smoke import macro_attrs
    assert macro_attrs()["macro_bwd"]["ctas_per_sm"] >= 1
    outs = bm.blend_macros(data_m, xy0, counts, pmat, tile, fs, w, h)
    assert_outs(outs, bm.blend_macros_plain(data_m, xy0, counts, pmat, tile,
                                            fs, w, h))


# ---------------------------------------------- the data loaders' kernels

def remap_case(case, channels, dev, seed=0):
    """(image, Maps) of a remap case on ``dev``: random maps that leave the
    image on every side ("small"; "odd" and "one" at widths that are not a
    multiple of 4; "wide" at EuRoC's 752x480) or the maps that TUM fr1_desk's
    (640x480) and EuRoC mh02's cam0 (752x480) datasets build ("tum",
    "euroc")."""
    from chip_smoke import dataset_maps
    from monogs_tpu_torch.data.undistort import check_maps

    g = torch.Generator().manual_seed(channels + 10 * seed)
    src, dst = {"small": ((37, 53), (41, 59)), "odd": ((30, 61), (33, 65)),
                "one": ((3, 2), (1, 1)), "wide": ((480, 752), (480, 752)),
                "tum": ((480, 640), None), "euroc": ((480, 752), None)}[case]
    img = torch.randint(0, 256, src + ((3,) if channels == 3 else ()),
                        generator=g, dtype=torch.uint8).to(dev)
    if dst is None:
        config = {"tum": "configs/rgbd/tum/fr1_desk.yaml",
                  "euroc": "configs/stereo/euroc/mh02.yaml"}[case]
        return img, dataset_maps(torch, config, dev)[0]
    ys, xs = torch.meshgrid(torch.arange(float(dst[0])),
                            torch.arange(float(dst[1])), indexing="ij")
    sx, sy = (src[1] + 6) / dst[1], (src[0] + 6) / dst[0]
    maps = [xs * sx - 4 + 0.7 * torch.rand(xs.shape, generator=g),
            ys * sy - 3 + 0.7 * torch.rand(ys.shape, generator=g)]
    if case == "one":      # inside, between the taps
        maps = [torch.tensor([[0.6]]), torch.tensor([[1.3]])]
    return img, check_maps(*(m.to(dev) for m in maps))


@pytest.mark.parametrize("case", ["small", "odd", "one", "wide", "tum",
                                  "euroc"])
@pytest.mark.parametrize("channels", [1, 3])
def test_remap_on_card(card, channels, case):
    """The remap kernel bit for bit against its plain version at the
    shapes it must handle (widths not a multiple of 4, 1x1, TUM's
    and EuRoC's frames through their datasets' maps, maps that leave the
    image on every side), through ``Maps`` and through
    (map_x, map_y), two launches alike."""
    from monogs_tpu_torch.data.undistort import remap, remap_plain

    img, maps = remap_case(case, channels, card)
    want = remap_plain(img.cpu(), maps.x.cpu(), maps.y.cpu())
    a = remap(img, maps)
    b = remap(img, maps.x, maps.y)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a.cpu(), want)


@pytest.mark.parametrize("case", ["small", "odd", "euroc"])
@pytest.mark.parametrize("channels", [1, 3])
def test_remap_pair_on_card(card, channels, case):
    """``remap_pair`` (one launch) gives the bits of two ``remap`` calls,
    on EuRoC's two eyes through their datasets' maps and on random maps;
    it counts one launch; a pair of other shapes raises."""
    from chip_smoke import dataset_maps
    from monogs_tpu_torch.data import undistort

    img0, maps0 = remap_case(case, channels, card)
    img1, maps1 = remap_case(case, channels, card, seed=1)
    if case == "euroc":
        maps1 = dataset_maps(torch, "configs/stereo/euroc/mh02.yaml",
                             card)[1]
    before = dict(undistort.LAUNCHES)
    pair = undistort.remap_pair(img0, maps0, img1, maps1)
    assert undistort.LAUNCHES["remap_pair"] == before["remap_pair"] + 1
    assert undistort.LAUNCHES["remap"] == before["remap"]
    two = (undistort.remap(img0, maps0), undistort.remap(img1, maps1))
    torch.cuda.synchronize()
    assert all(torch.equal(p, t) for p, t in zip(pair, two))
    with pytest.raises(ValueError, match="one shape"):
        undistort.remap_pair(img0, maps0, img1[:-1], maps1)


@pytest.mark.parametrize("shape", [(120, 200), (33, 65), (480, 752),
                                   (16, 8191)])
def test_sgbm_on_card(card, shape):
    """SGBM's five launches bit for bit against the plain version and
    between two launches: a row narrower than the window, a width of
    numDisparities + 1, EuRoC's 752x480 (where no launch has fewer CTAs
    than the card has SMs) and the widest the kernel takes (its match
    keys hold a column in 13 bits)."""
    from monogs_tpu_torch.data.stereo import sgbm, sgbm_grids, sgbm_plain

    left, right = textured_pair(torch, card, *shape)
    want = sgbm_plain(left.cpu(), right.cpu())
    a, b = sgbm(left, right), sgbm(left, right)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a.cpu(), want)
    if shape in ((120, 200), (480, 752)):
        assert float((want >= 0).float().mean()) > 0.3
    if shape == (480, 752):
        sms = torch.cuda.get_device_properties(card).multi_processor_count
        assert min(sgbm_grids(*shape)) >= sms, (sgbm_grids(*shape), sms)


@pytest.mark.parametrize("sample", ["smooth", "sharp"])
def test_nvjpeg_on_card(card, sample):
    """nvJPEG's planes through the ycc_rgb kernel within 3 LSB of
    libjpeg's pixels (mean) on chip_smoke's embedded JPEGs, and the
    encoder's round trip of the smooth one (the sharp one is random
    colour, which a 4:2:0 encoder cannot keep: libjpeg's own round trip
    of it is 47 LSB off)."""
    import numpy as np

    import chip_smoke
    from monogs_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

    data, want = chip_smoke.jpeg_sample(sample)
    got = decode_jpeg(data, card)
    assert got.is_cuda and got.shape == want.shape
    assert np.abs(got.cpu().numpy().astype(int) - want).mean() < 3.0
    if sample == "sharp":
        return
    again = decode_jpeg(encode_jpeg(torch.from_numpy(want).to(card)), card)
    assert (again.int() - torch.from_numpy(want).to(card).int()).abs().float(
    ).mean() < 3.0


@pytest.mark.parametrize("shape", [(680, 1200), (480, 640), (480, 752),
                                   (35, 51), (33, 65), (481, 752), (9, 3),
                                   (6, 2), (7, 4), (8, 8), (1, 1)])
def test_ycc_rgb_kernel_matches_plain(card, shape):
    """The upsampling and colour conversion kernel equals its plain
    version bit for bit at every subsampling it takes (4:2:0, 4:2:2,
    4:4:4, grey): Replica's, TUM's and EuRoC's sizes, widths not a
    multiple of 4, an odd height, 1x1, and the replicated narrow chroma
    (2 samples across at widths 3 and 4); also on chroma planes that are
    views of a wider plane."""
    from monogs_tpu_torch.data.jpeg import ycc_to_rgb, ycc_to_rgb_plain

    h, w = shape
    g = torch.Generator().manual_seed(h * 10_000 + w)
    y = torch.randint(0, 256, (h, w), generator=g, dtype=torch.uint8)
    for factors in [(2, 2), (1, 2), (1, 1), None]:
        wide = [y]
        if factors is not None:
            sy, sx = factors
            wide += [torch.randint(0, 256, (-(-h // sy), -(-w // sx) + 1),
                                   generator=g, dtype=torch.uint8)
                     for _ in range(2)]
        want = ycc_to_rgb_plain(y, *(p[:, 1:].contiguous()
                                     for p in wide[1:]))
        on_card = [p.to(card) for p in wide]
        got = ycc_to_rgb(on_card[0], *(p[:, 1:] for p in on_card[1:]))
        again = ycc_to_rgb(on_card[0], *(p[:, 1:].contiguous()
                                         for p in on_card[1:]))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (shape, factors)
        assert torch.equal(again, got), (shape, factors)


def test_png_unfilter_native_on_card_machine(card):
    """The host unfilter (built with the kernels) against the numpy one."""
    import numpy as np

    from monogs_tpu_torch.data import png

    rng = np.random.default_rng(0)
    for img in (rng.integers(0, 256, (31, 45, 3), dtype=np.uint8),
                rng.integers(0, 65536, (20, 7), dtype=np.uint16)):
        data = png.encode_png(img)
        assert np.array_equal(png.decode_png(data, native=True), img)
        w, h, depth, ctype, raw = png.parse(data)
        bpp = (3 if ctype == 2 else 1) * depth // 8
        # every filter type: rows re-filtered by type (y % 5)
        rows = np.frombuffer(raw, np.uint8).reshape(h, -1).copy()
        rows[:, 0] = np.arange(h) % 5
        raw = rows.tobytes()
        assert np.array_equal(png.unfilter_native(raw, h, w * bpp, bpp),
                              png.unfilter_plain(raw, h, w * bpp, bpp))


# ------------------------------------------------ observability on the card

def test_trace_records_device_events(card, tmp_path):
    """profiling.trace on the card records CUDA activity: the list blend's
    kernel, its device time and the window's idle share; the trace file
    is Chrome JSON."""
    import json

    from monogs_tpu_torch.utils import profiling

    d, _, _, tx0, ty0, pmat = scene_rows(card)
    bl.blend_lists(d, tx0, ty0, pmat, W, H)          # built and warm
    with profiling.trace(str(tmp_path)) as tr:
        for _ in range(3):
            bl.blend_lists(d, tx0, ty0, pmat, W, H)
    s = tr.summary
    assert s["kernel_launches"] >= 3 and s["device_busy_ms"] > 0
    assert 0.0 <= s["device_idle_share"] < 1.0
    assert s["device_ms_by_class"]["list_blend"] > 0
    assert any("fwd_kernel" in t["name"] for t in s["top"])
    with open(tr.path) as f:
        assert json.load(f)["traceEvents"]


def test_gui_view_jpeg_round_trip(card):
    """A rendered view through the GUI's encoder (nvJPEG) and back through
    decode_jpeg: within 3 LSB on average of the 8-bit view (quality 95,
    4:2:0)."""
    from monogs_tpu_torch.data.jpeg import decode_jpeg
    from monogs_tpu_torch.gui import slam_gui

    g = torch.Generator().manual_seed(0)
    scene = make_synthetic_scene(g, n=3000, spread=2.0, depth_mean=3.0,
                                 scale_min=0.03, scale_max=0.09)
    scene = type(scene)(*(x.to(card) for x in scene))
    out = rr.render(scene, torch.eye(4, device=card), INTR, CFG)
    img = torch.clamp(out.image, 0.0, 1.0)
    body, ctype = slam_gui._encode_jpg(img)
    assert ctype == "image/jpeg" and body[:2] == b"\xff\xd8"
    back = decode_jpeg(body, card)
    want = slam_gui._to_u8(img)
    assert back.shape == want.shape == (H, W, 3)
    err = (back.int() - want.int()).abs().float()
    assert float(err.mean()) <= 3.0, float(err.mean())
