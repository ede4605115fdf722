"""The macro-list kernels' design (csrc/blend_macros.cu), emulated on the
CPU against the plain versions of render/blend_macros.py.

- The row index: the block scan of ``build_row_index`` (each of nt threads
  tests RPT rows per step, positions from per-warp popcounts in list
  order, the scan stopping once ``cap`` rows are in) gives the first
  ``cap`` overlapping valid rows in list order, and every valid row its
  slot or -1.
- The VJP's compact partials: each fine tile writes its n rows'
  cotangents to slots 0 .. n-1 and a slot map for the macro rows; the
  second kernel adds, per macro row, the slots of fine tiles 0 .. ft-1 in
  that order. The emulation equals ``blend_macros_vjp_plain`` and
  ``blend_compact_vjp_plain`` bit for bit on random lists with empty
  tiles, rows in several tiles, ``k_fine`` truncation and a tile row below
  the image (the plain versions' ``sum(1)`` over ft <= 16 fine tiles adds
  them in order on the CPU).
- The forward's warp culling (``row_reaches``, as
  tests/test_torch_blend_lists.py emulates it) on macro lists gathered
  through each fine tile's index: a culled row passes the alpha test at
  no pixel of that warp.
"""

import numpy as np
import pytest
import torch

from monogs_tpu.ops import se3 as jse3
from monogs_tpu_torch.render import Intrinsics as TIntr
from monogs_tpu_torch.render import RenderConfig as TCfg
from monogs_tpu_torch.render import blend_lists as tbl
from monogs_tpu_torch.render import blend_macros as tbm
from monogs_tpu_torch.render import renderer as tr
from tests.test_torch_blend_lists import INTR, row_reaches, warp_boxes
from tests.test_torch_ops import both_gauss, small_tau, surface_scene, t
from tests.torch_one_thread import one_torch_thread  # noqa: F401

W, H = INTR["width"], INTR["height"]
RPT = 4  # csrc/blend_macros.cu


def random_lists(seed, n_macro=4, km=96, ft_side=2, tile=16):
    """Random depth-ordered macro lists (data_m, xy0, counts, pmat) over a
    W x H frame of 32 px macros: boxes of 1-14 px radius around and beyond
    each macro (rows in several fine tiles, rows in none), random
    positive-definite conics and opacities, macro 1's count 0 and the other
    counts random; the last macro row's second fine-tile row lies below
    the image."""
    rng = np.random.default_rng(seed)
    mpx = tile * ft_side
    n_mx = -(-W // mpx)
    xy0 = np.array([[(m % n_mx) * mpx, (m // n_mx) * mpx]
                    for m in range(n_macro)], np.float32)
    d = np.zeros((n_macro, km, tbl._F), np.float32)
    for col, axis in ((tbl._U, 0), (tbl._V, 1)):
        d[..., col] = xy0[:, None, axis] + rng.uniform(-8, mpx + 8,
                                                       (n_macro, km))
    s1 = rng.uniform(0.8, 6.0, (n_macro, km))
    s2 = rng.uniform(0.8, 6.0, (n_macro, km))
    th = rng.uniform(0, np.pi, (n_macro, km))
    c, s = np.cos(th), np.sin(th)
    # inverse covariance R diag(1/s^2) R^T
    d[..., tbl._CA] = c * c / s1 ** 2 + s * s / s2 ** 2
    d[..., tbl._CB] = c * s * (1 / s1 ** 2 - 1 / s2 ** 2)
    d[..., tbl._CC] = s * s / s1 ** 2 + c * c / s2 ** 2
    opa = rng.uniform(0.05, 0.99, (n_macro, km))
    d[..., 5] = opa
    d[..., tbl._R0:tbl._R0 + 3] = rng.uniform(0, 1, (n_macro, km, 3))
    d[..., tbl._Z] = np.sort(rng.uniform(1, 4, (n_macro, km)), axis=1)
    d[..., tbl._RAD] = rng.uniform(1.0, 14.0, (n_macro, km))
    d[..., tbl._LOGO] = np.log(opa)
    counts = rng.integers(km // 2, km + 1, n_macro).astype(np.float32)
    counts[1] = 0.0
    cfg = TCfg(tile=tile, macro_tiles=ft_side, k_macro=km, k_fine=8,
               with_n_touched=False)
    return (t(d), t(xy0), t(counts), tr._tile_pmat(cfg, "cpu")), (
        tile, ft_side, W, H)


def scene_lists(k_macro=256):
    """Macro lists of tests/test_torch_blend_lists.py's dense scene (a 32
    px macro grid over the 64x48 frame) from the port's binning."""
    sc = surface_scene(500, 0, spread=1.6, depth_mean=3.0, scale_min=0.08,
                       scale_max=0.25)
    _, tg = both_gauss(sc)
    T = t(np.asarray(jse3.se3_exp(small_tau(1, 0.02))))
    cfg = TCfg(tile=16, macro_tiles=2, k_macro=k_macro, k_fine=16,
               with_n_touched=False)
    ti = TIntr(**INTR)
    with torch.no_grad():
        _, packed, _, aux = tr._project(tg, T, ti, cfg)
        data_m, xy0, counts = tr.macro_rows(packed, aux)
    return (data_m.contiguous(), xy0, counts, tr._tile_pmat(cfg, "cpu")), (
        cfg.tile, cfg.macro_tiles, W, H)


def scan_index(hit, valid, cap, nt):
    """build_row_index's block scan on one tile, in numpy: ``hit`` [km]
    (the box test), ``valid`` [km] (row < count); returns (the index, the
    slot map with -2 where the kernel writes nothing)."""
    km = hit.shape[0]
    idx = []
    slot = np.full(km, -2)
    base, r0 = 0, 0
    lanes = np.arange(nt) & 31
    warps = np.arange(nt) >> 5
    while r0 < km and valid[r0] and base < cap:
        before = base
        for j in range(RPT):
            r = r0 + j * nt + np.arange(nt)
            h = np.zeros(nt, bool)
            inside = r < km
            h[inside] = hit[r[inside]] & valid[r[inside]]
            per_warp = np.bincount(warps, h, minlength=nt // 32)
            lane_before = np.array([h[(warps == w) & (lanes < ln)].sum()
                                    for w, ln in zip(warps, lanes)])
            pos = before + np.cumsum(per_warp)[warps] - per_warp[warps] \
                + lane_before
            sel = h & (pos < cap)
            for k in np.flatnonzero(sel):
                idx.append((int(pos[k]), int(r[k])))
            wr = inside.copy()
            wr[inside] = valid[r[inside]]
            slot[r[wr]] = np.where(sel[wr], pos[wr], -1)
            before += int(per_warp.sum())
        base = before
        r0 += RPT * nt
    tail = np.arange(r0, km)
    slot[tail[valid[tail]]] = -1
    idx = [r for _, r in sorted(idx)]
    return np.array(idx, int), slot


@pytest.mark.parametrize("nt,cap", [(128, 5), (128, 1000), (256, 40)])
def test_index_scan(nt, cap):
    """The scan's index is the first cap hits among the valid rows, in
    list order; each valid row's slot is its position there or -1, even
    past the row at which the scan stopped; invalid rows get nothing."""
    rng = np.random.default_rng(nt + cap)
    km = 1500
    hit = rng.uniform(size=km) < 0.3
    valid = np.arange(km) < 1234
    idx, slot = scan_index(hit, valid, cap, nt)
    want = np.flatnonzero(hit & valid)[:cap]
    np.testing.assert_array_equal(idx, want)
    expect = np.full(km, -2)
    expect[valid] = -1
    expect[want] = np.arange(want.shape[0])
    np.testing.assert_array_equal(slot, expect)


def emulate_vjp(args, geo, g_outs, cap):
    """macro_bwd's result from its parts: per fine tile, the first cap
    rows that enter it (none for a tile outside the image) blended by the
    plain version into its compact partial [cap][F] and its slot map;
    then per macro row the fine tiles' slots added in order."""
    data_m, xy0, counts, pmat = args
    tile, fs, width, height = geo
    n_macro, km, _ = data_m.shape
    ft, p = fs * fs, pmat.shape[1]
    tx0, ty0 = tbm.fine_origins(xy0, tile, fs)
    mask = tbm.overlap_mask(data_m, counts, tx0, ty0, tile)
    in_image = ((tx0[..., None] + pmat[3] <= width - 1)
                & (ty0[..., None] + pmat[4] <= height - 1)).any(-1)
    mask = mask & in_image[..., None]
    idx, vld = tbm.compact_rows(mask, cap)                  # [Tm, ft, cap]
    rows = torch.gather(data_m[:, None].expand(-1, ft, -1, -1), 2,
                        idx[..., None].expand(-1, -1, -1, tbl._F))
    d = tbm._masked(rows, vld).reshape(-1, cap, tbl._F)
    f = tbl._forward_plain(d, tx0.reshape(-1), ty0.reshape(-1), pmat, width,
                           height)
    part = tbl._dd_from_gouts_plain(f, pmat, g_outs.reshape(-1, p, 8))
    part = part.reshape(n_macro, ft, cap, tbl._F)
    cs = torch.cumsum(mask.to(torch.int64), -1)
    slot = torch.where(mask & (cs <= cap), cs - 1, -1)      # [Tm, ft, km]
    dd = torch.zeros_like(data_m)
    for fi in range(ft):
        s = slot[:, fi]
        take = torch.gather(part[:, fi], 1, s.clamp(min=0)[..., None].expand(
            -1, -1, tbl._F))
        dd = torch.where((s >= 0)[..., None], dd + take, dd)
    return dd, int((slot >= 0).sum()), int(((slot >= 0).sum(1) > 1).sum())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["macro", "compact"])
def test_compact_partials_sum_is_the_plain_vjp(kind, seed):
    """The compact partials and their slot-ordered sum over the fine tiles
    give the plain VJP's bits, on random lists with an empty macro, rows
    entering several fine tiles, a tile row below the image and, for the
    compact blend, k_fine truncation."""
    args, geo = random_lists(seed)
    data_m, xy0, counts, pmat = args
    tile, fs, width, height = geo
    n_macro, km, _ = data_m.shape
    rng = np.random.default_rng(seed + 10)
    g_outs = t(rng.normal(size=(n_macro, fs * fs, tile * tile, 8)).astype(
        np.float32))
    if kind == "macro":
        cap = km
        want = tbm.blend_macros_vjp_plain(*args, g_outs, *geo)
    else:
        cap = 8
        want = tbm.blend_compact_vjp_plain(*args, g_outs, *geo, cap)
    dd, n_entries, n_multi = emulate_vjp(args, geo, g_outs, cap)
    assert torch.equal(dd, want)
    assert float(torch.abs(want).max()) > 0
    assert float(torch.abs(want[1]).max()) == 0.0       # count 0
    tx0, ty0 = tbm.fine_origins(xy0, tile, fs)
    assert bool((ty0 > height - 1).any())                # below the image
    assert n_multi > 0                                   # several tiles
    if kind == "compact":
        mask = tbm.overlap_mask(data_m, counts, tx0, ty0, tile)
        assert int(mask.sum(-1).max()) > cap             # truncated


@pytest.mark.parametrize("kind", ["macro", "compact"])
def test_forward_cull_is_exact_on_macro_lists(kind):
    """A row that the macro forward culls for a warp (row_reaches against
    the warp's 16x4 box, the rows gathered through the fine tile's index)
    passes the alpha test at no pixel of that warp, and the culling is not
    idle on these lists."""
    args, geo = scene_lists()
    data_m, xy0, counts, pmat = args
    tile, fs, width, height = geo
    km = data_m.shape[1]
    cap = km if kind == "macro" else 16
    d, _, vld, tx0, ty0 = tbm.compact_chunk(data_m, xy0, counts, tile, fs,
                                            cap, slice(0, data_m.shape[0]))
    reach = row_reaches(d, tx0, ty0, warp_boxes(tx0, ty0, pmat, 2))
    f = tbl._forward_plain(d, tx0, ty0, pmat, width, height)
    n_w = reach.shape[-1]
    used = f["ok"].reshape(*f["ok"].shape[:2], n_w, 64).any(-1)
    assert not bool((used & ~reach).any())
    live = (vld.reshape(-1, cap)[..., None]
            & (ty0 <= height - 1)[:, None, None]).expand_as(reach)
    culled = float((~reach)[live].float().mean())
    assert int(vld.sum()) > 0 and culled > 0.1, culled
