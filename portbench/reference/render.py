"""A plain tiled Gaussian-splat renderer: projection, binning into capped
per-tile lists, and the front-to-back blend, written from the semantics
the port documents and not from its code.

Plain PyTorch that imports nothing of the program. Everything is
differentiable by autograd except the binning. The blend is dense over
[tiles, list entries, pixels] and runs in blocks of tiles, so that a
1200x680 view at 256 entries a tile fits (``reference.ba`` pulls a
per-pixel loss back through one block at a time and then once through the
projection).

Semantics (the port's renderer, ``monogs_tpu_torch/render``):

- projection: world->camera, pinhole with pixel centres at integers
  (``u = fx x / z + cx - 0.5``), the EWA covariance with the 1.3 tan(fov)
  clamp and a 0.3 px dilation, a 3-sigma radius from the larger eigenvalue
  (its discriminant floored at 0.1), colour from the degree-0 SH clamped at
  zero, culling at ``z <= near``, a singular conic or an off-screen box;
- binning: macro cells of ``tile * macro_tiles`` pixels hold the
  ``k_macro`` Gaussians whose (margin-grown) box meets them, Gaussians whose
  un-grown box meets the cell first, then by depth rank; a box spanning more
  than ``span_cap`` cells is kept whole for the ``k_big`` nearest such
  Gaussians and cut to the first ``span_cap`` cells of its un-grown span
  (row-major) for the others; each fine tile takes, from its macro cell's
  list, the ``k_fine`` Gaussians whose grown box meets it, un-grown first,
  then by depth rank, and blends them in depth-rank order;
- blend: per pixel and entry, s = -q/2 + log(opacity) with q the conic's
  quadratic form, alpha = min(exp(min(s, 2)), 0.99), kept where s <=
  log(opacity) + 1e-4 and alpha >= 1/255; an entry contributes while the
  transmittance after it stays >= 1e-4; colour, depth and accumulated alpha
  are the alpha-T weighted sums (black background).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

SH_C0 = 0.28209479177387814
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


class Grid(NamedTuple):
    tile: int
    macro_tiles: int
    k_macro: int
    k_fine: int
    span_cap: int = 16
    k_big: int = 128
    near: float = 0.2


class Lists(NamedTuple):
    idx: torch.Tensor   # [Tf, Kf] Gaussian ids in depth-rank order
    vld: torch.Tensor   # [Tf, Kf]


# ------------------------------------------------------------- projection

def quat_rot(q):
    """[N, 3, 3] rotations of the quaternions q [N, 4] (w, x, y, z), each
    normalised first."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1), min=1e-12)[:, None]
    w, x, y, zq = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + zq * zq), 2 * (x * y - w * zq),
                     2 * (x * zq + w * y)], -1),
        torch.stack([2 * (x * y + w * zq), 1 - 2 * (x * x + zq * zq),
                     2 * (y * zq - w * x)], -1),
        torch.stack([2 * (x * zq - w * y), 2 * (y * zq + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def project(p: dict, active, T, cam: Camera, near: float, off=None):
    """Per-Gaussian screen geometry at world->camera pose ``T``: a dict of
    [N] columns u, v, ca, cb, cc (conic), logo (log opacity), r, g, b, z,
    radius and the bool ``valid``. ``off`` [N, 2], zero where given, moves
    the screen means by 2 / width and 2 / height pixels a unit (the port's
    hook whose gradient is the densification statistic)."""
    xyz = p["xyz"]
    R, t = T[:3, :3], T[:3, 3]
    pc = xyz @ R.transpose(0, 1) + t
    px, py, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / zs
    u = cam.fx * px * iz + cam.cx - 0.5
    v = cam.fy * py * iz + cam.cy - 0.5
    if off is not None:
        u = u + off[:, 0] * (2.0 / cam.width)
        v = v + off[:, 1] * (2.0 / cam.height)

    s = torch.exp(p["log_scale"])
    rot = quat_rot(p["quat"])                                  # [N, 3, 3]
    M = rot * s[:, None, :]
    sigma = M @ M.transpose(1, 2)                              # [N, 3, 3]

    limx = 1.3 * cam.width / (2.0 * cam.fx)
    limy = 1.3 * cam.height / (2.0 * cam.fy)
    tx = torch.clamp(px * iz, -limx, limx)
    ty = torch.clamp(py * iz, -limy, limy)
    zero = torch.zeros_like(iz)
    J = torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * tx * iz], -1),
        torch.stack([zero, cam.fy * iz, -cam.fy * ty * iz], -1)], -2)
    JW = J @ R                                                 # [N, 2, 3]
    cov = JW @ sigma @ JW.transpose(1, 2)                      # [N, 2, 2]
    a = cov[:, 0, 0] + 0.3
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + 0.3
    det = a * c - b * b
    det_s = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                        det)
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)))
    rgb = torch.clamp(SH_C0 * p["sh"][:, 0, :] + 0.5, min=0.0)
    opa = torch.sigmoid(p["opa_logit"]).reshape(-1)
    on_screen = ((u + radius >= 0) & (u - radius <= cam.width - 1)
                 & (v + radius >= 0) & (v - radius <= cam.height - 1))
    valid = active & (z > near) & (det > 0) & (radius > 0) & on_screen
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return dict(u=u, v=v, ca=c / det_s, cb=-b / det_s, cc=a / det_s,
                logo=torch.log(torch.clamp(opa, min=1e-12)),
                r=rgb[:, 0], g=rgb[:, 1], b=rgb[:, 2], z=z,
                radius=radius, valid=valid)


# ---------------------------------------------------------------- binning

def grid_shape(cam: Camera, grid: Grid):
    mpx = grid.tile * grid.macro_tiles
    return -(-cam.width // mpx), -(-cam.height // mpx), mpx


def tile_origins(cam: Camera, grid: Grid, device):
    """[Tf] pixel origins of the fine tiles, macro cell by macro cell."""
    n_mx, n_my, mpx = grid_shape(cam, grid)
    mt = grid.macro_tiles
    m = torch.arange(n_mx * n_my, device=device)
    f = torch.arange(mt * mt, device=device)
    x0 = (m % n_mx * mpx)[:, None] + (f % mt * grid.tile)[None, :]
    y0 = (m // n_mx * mpx)[:, None] + (f // mt * grid.tile)[None, :]
    return x0.reshape(-1).float(), y0.reshape(-1).float()


def _meets(u, v, r, x0, y0, size):
    """Whether the box [u-r, u+r] x [v-r, v+r] meets the pixel rect of
    ``size`` pixels at (x0, y0) (broadcasting)."""
    return ((u + r >= x0) & (u - r <= x0 + size - 1)
            & (v + r >= y0) & (v - r <= y0 + size - 1))


def _cell_span(u, v, r, n_x, n_y, cell):
    x0 = torch.clamp(torch.ceil((u - r - (cell - 1.0)) / cell), 0, n_x - 1)
    x1 = torch.clamp(torch.floor((u + r) / cell), 0, n_x - 1)
    y0 = torch.clamp(torch.ceil((v - r - (cell - 1.0)) / cell), 0, n_y - 1)
    y1 = torch.clamp(torch.floor((v + r) / cell), 0, n_y - 1)
    return x0.long(), y0.long(), (x1 - x0).long() + 1, (y1 - y0).long() + 1


@torch.no_grad()
def macro_lists(g: dict, cam: Camera, grid: Grid, margin: float = 0.0):
    """Each macro cell's list of the Gaussians of ``g`` (``project``'s
    output): (ids [Tm, Km], depth ranks [Tm, Km], validity [Tm, Km], the
    ids in depth order [N]), the un-grown boxes first, then by depth
    rank."""
    u, v, rad, valid, z = (g["u"].float(), g["v"].float(),
                           g["radius"].float(), g["valid"], g["z"].float())
    dev = u.device
    n = u.shape[0]
    n_mx, n_my, mpx = grid_shape(cam, grid)
    n_macro = n_mx * n_my
    order = torch.argsort(torch.where(valid, z, torch.full_like(z, math.inf)),
                          stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    rad_m = torch.where(valid, rad + margin, rad) if margin else rad
    ok = (valid & (u + rad_m >= 0) & (u - rad_m <= n_mx * mpx - 1)
          & (v + rad_m >= 0) & (v - rad_m <= n_my * mpx - 1))

    _, _, mw, mh = _cell_span(u, v, rad_m, n_mx, n_my, mpx)
    sx0, sy0, sw, sh = _cell_span(u, v, rad, n_mx, n_my, mpx)
    big = ok & (mw * mh > grid.span_cap)
    # the k_big nearest big boxes are kept whole
    big_rank = torch.where(big, rank, torch.full_like(rank, n))
    nth = torch.sort(big_rank).values[min(grid.k_big, n) - 1]
    whole = big & (rank <= nth) if grid.k_big > 0 else torch.zeros_like(big)
    cut = big & ~whole

    mids = torch.arange(n_macro, device=dev)
    mcx, mcy = mids % n_mx, mids // n_mx                     # [Tm]
    x0m, y0m = (mcx * mpx).float(), (mcy * mpx).float()
    member = ok[None, :] & _meets(u[None], v[None], rad_m[None],
                                  x0m[:, None], y0m[:, None], mpx)
    strict = _meets(u[None], v[None], rad[None], x0m[:, None], y0m[:, None],
                    mpx)
    # a cut box: the first span_cap cells of its un-grown span, row-major
    dx = mcx[:, None] - sx0[None]
    dy = mcy[:, None] - sy0[None]
    in_span = (dx >= 0) & (dx < sw[None]) & (dy >= 0) & (dy < sh[None])
    first = (dy * sw[None] + dx) < grid.span_cap
    member = torch.where(cut[None], in_span & first, member)
    strict = strict | cut[None]
    keys = torch.where(member, rank[None] + torch.where(strict, 0, n),
                       torch.full_like(rank[None], 2 * n))
    mkeys = torch.sort(keys, dim=1).values[:, :grid.k_macro]  # [Tm, Km]
    m_ok = mkeys < 2 * n
    m_rank = torch.where(m_ok, mkeys % n, 0)
    return order[m_rank], m_rank, m_ok, order


@torch.no_grad()
def bin_lists(g: dict, cam: Camera, grid: Grid, margin: float = 0.0) -> Lists:
    """Per-fine-tile lists of the Gaussians of ``g`` (``project``'s
    output), as the module docstring sets out."""
    u, v, rad = g["u"].float(), g["v"].float(), g["radius"].float()
    n = u.shape[0]
    m_id, m_rank, m_ok, order = macro_lists(g, cam, grid, margin)
    rad_m = torch.where(g["valid"], rad + margin, rad) if margin else rad
    n_macro = m_id.shape[0]
    ft = grid.macro_tiles * grid.macro_tiles
    x0f, y0f = tile_origins(cam, grid, u.device)
    x0f, y0f = x0f.reshape(n_macro, ft), y0f.reshape(n_macro, ft)
    um, vm = u[m_id][:, None, :], v[m_id][:, None, :]
    fm = m_ok[:, None, :] & _meets(um, vm, rad_m[m_id][:, None, :],
                                   x0f[..., None], y0f[..., None], grid.tile)
    fs = _meets(um, vm, rad[m_id][:, None, :], x0f[..., None],
                y0f[..., None], grid.tile)
    rk = m_rank[:, None, :].expand(fm.shape)
    fkeys = torch.where(fm, rk + torch.where(fs, 0, n),
                        torch.full_like(rk, 2 * n))
    fkeys = fkeys.reshape(n_macro * ft, -1)
    picked = torch.sort(fkeys, dim=1).values[:, :grid.k_fine]
    f_rank = torch.where(picked < 2 * n, picked % n, n)
    f_rank = torch.sort(f_rank, dim=1).values
    vld = f_rank < n
    idx = torch.where(vld, order[torch.where(vld, f_rank, 0)], 0)
    if idx.shape[1] < grid.k_fine:
        pad = grid.k_fine - idx.shape[1]
        idx = torch.nn.functional.pad(idx, (0, pad))
        vld = torch.nn.functional.pad(vld, (0, pad))
    return Lists(idx=idx, vld=vld)


# ------------------------------------------------------------------ blend

ROW_COLS = ("u", "v", "ca", "cb", "cc", "logo", "r", "g", "b", "z")


def rows_of(g: dict):
    """[N, 10] the columns a list entry carries, in ``ROW_COLS`` order."""
    return torch.stack([g[k] for k in ROW_COLS], dim=-1)


def blend_block(rows, vld, x0, y0, cam: Camera, tile: int, stats=False):
    """Blend the entries rows [T, K, 10] (validity vld [T, K]) of T tiles at
    origins x0, y0 [T]. Returns colour [T, P, 3], depth [T, P], acc [T, P]
    and pix_ok [T, P]; with ``stats`` also the entry-pixel pair counts of
    each kind (walked, ok, contrib, live)."""
    dev = rows.device
    i = torch.arange(tile * tile, device=dev)
    pxl = (i % tile).to(rows.dtype)
    pyl = (i // tile).to(rows.dtype)
    pix_ok = ((x0[:, None] + pxl <= cam.width - 1)
              & (y0[:, None] + pyl <= cam.height - 1))
    c = rows.unbind(-1)
    u, v, ca, cb, cc, logo = c[:6]
    dx = (x0[:, None] + pxl)[:, None, :] - u[..., None]       # [T, K, P]
    dy = (y0[:, None] + pyl)[:, None, :] - v[..., None]
    s = (-0.5 * (ca[..., None] * dx * dx + cc[..., None] * dy * dy)
         - cb[..., None] * dx * dy + logo[..., None])
    alpha = torch.clamp(torch.exp(torch.clamp(s, max=2.0)), max=0.99)
    ok = (vld[..., None] & pix_ok[:, None, :]
          & (s <= logo[..., None] + 1e-4) & (alpha >= ALPHA_MIN))
    alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
    om = 1.0 - alpha
    t_incl = torch.cumprod(om, dim=1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], 1)
    contrib = ok & (t_incl >= T_EPS)
    w = torch.where(contrib, alpha * t_excl, torch.zeros_like(alpha))
    feats = torch.stack([c[6], c[7], c[8], c[9]], dim=-1)      # [T, K, 4]
    out = torch.einsum("tkp,tkf->tpf", w, feats)
    acc = w.sum(1)
    res = (out[..., :3], out[..., 3], acc, pix_ok)
    if not stats:
        return res
    with torch.no_grad():
        term = ok & ~contrib
        k = torch.arange(rows.shape[1], device=dev)[None, :, None]
        stop = torch.where(term.any(1), term.int().argmax(1) + 1,
                           rows.shape[1])
        walked = (k < stop[:, None, :]) & pix_ok[:, None, :] & vld[..., None]
        n = dict(walked=int(walked.sum()), ok=int((walked & ok).sum()),
                 contrib=int(contrib.sum()),
                 live=int((contrib & (alpha < 0.99)).sum()))
    return res + (n,)


def tiles_to_image(x, cam: Camera, grid: Grid):
    """[Tf, P, C] tile-space values -> [C, H, W]."""
    n_mx, n_my, mpx = grid_shape(cam, grid)
    mt, tile = grid.macro_tiles, grid.tile
    c = x.shape[-1]
    x = x.reshape(n_my, n_mx, mt, mt, tile, tile, c).permute(
        0, 2, 4, 1, 3, 5, 6)
    x = x.reshape(n_my * mpx, n_mx * mpx, c)[:cam.height, :cam.width]
    return x.permute(2, 0, 1)


def image_to_tiles(img, cam: Camera, grid: Grid):
    """[C, H, W] -> [Tf, P, C] in the fine tiles' order (zero padded)."""
    n_mx, n_my, mpx = grid_shape(cam, grid)
    mt, tile = grid.macro_tiles, grid.tile
    c = img.shape[0]
    x = torch.nn.functional.pad(img, (0, n_mx * mpx - cam.width,
                                      0, n_my * mpx - cam.height))
    x = x.reshape(c, n_my, mt, tile, n_mx, mt, tile).permute(
        1, 4, 2, 5, 3, 6, 0)
    return x.reshape(n_mx * n_my * mt * mt, tile * tile, c)


def block_tiles(cam: Camera, grid: Grid, budget: int = 1 << 23) -> int:
    """Tiles a block so that [T, Kf, P] holds about ``budget`` elements."""
    return max(1, budget // (grid.k_fine * grid.tile * grid.tile))


@torch.no_grad()
def render(p: dict, active, T, cam: Camera, grid: Grid, lists: Lists = None,
           stats=False):
    """Image [3, H, W], depth [1, H, W], opacity [1, H, W] (and with
    ``stats`` the summed pair counts) at pose ``T``; binned afresh (no
    margin) unless ``lists`` are given."""
    g = project(p, active, T, cam, grid.near)
    if lists is None:
        lists = bin_lists(g, cam, grid)
    rows = rows_of(g)
    x0, y0 = tile_origins(cam, grid, rows.device)
    x0, y0 = x0.to(rows.dtype), y0.to(rows.dtype)
    bt = block_tiles(cam, grid)
    outs, tot = [], dict(walked=0, ok=0, contrib=0, live=0)
    for a in range(0, lists.idx.shape[0], bt):
        sl = slice(a, a + bt)
        idx = lists.idx[sl]
        vld = lists.vld[sl] & g["valid"][idx]
        r = blend_block(rows[idx], vld, x0[sl], y0[sl], cam, grid.tile,
                        stats=stats)
        if stats:
            for k in tot:
                tot[k] += r[4][k]
        outs.append(torch.cat([r[0], r[1][..., None], r[2][..., None]], -1))
    img = tiles_to_image(torch.cat(outs, 0), cam, grid)
    res = (img[:3], img[3:4], img[4:5])
    return res + (tot,) if stats else res
