"""The per-tile list blend: six CUDA kernels, each beside its plain version.

Counterpart of ``monogs_tpu/render/pallas_lists.py``. Binning produced
``d = packed[lists.idx]``, [T, Kf, 16] depth-ordered rows per tile (invalid
rows carry LOGO = -1e30); what is left per render is the alpha blend. Each
entry point below has

- a CUDA kernel (``csrc/blend_lists.cu``), launched when the tensors lie on a
  CUDA device, and counted in ``LAUNCHES`` where it is launched;
- a plain PyTorch version (``*_plain``), written as dense [T, K, P] tensor
  math, which the entry point runs when the tensors lie on the CPU and which
  the on-card check compares the kernel with.

A CUDA tensor never falls back to the plain version: the kernel launches or
the call raises. ``blend_lists_fn`` is the differentiable list blend: a
``torch.autograd.Function`` whose forward is ``blend_lists`` and whose
backward is ``blend_lists_vjp``; it saves only the rows (not the [T, K, P]
activations), which the VJP kernel re-blends from chunk checkpoints. No
other function here is differentiable.

Kernels (TPU kernel replaced -> bound on the H100 -> design):

- ``blend_lists`` <- ``pallas_lists.py::_fwd_kernel``; bound by FP32
  operations: 26 per (row, pixel) pair walked (expf is 10) and 13 more per
  contributing pair, against 64 bytes per row: about 41 operations per
  byte at the frame's shapes, twice the card's ratio of FP32 rate to HBM
  bandwidth (chip_smoke.py counts the pairs); the library is built
  without fused multiply-adds, so the card issues them at half its FP32
  peak. One CTA per tile, two adjacent pixels per thread, so a warp holds
  a compact block of the tile and reads each staged row once for two
  pixels. The warps walk independently: each copies the tile's rows into
  its own two buffers by ``cp.async`` (the next 32-row chunk while it
  walks the current one) and stops once its pixels have terminated. Before
  walking a chunk a warp culls the rows that no pixel of its bounding box
  can take: a pair passes the alpha test only if its log-alpha lies in
  [-5.55, log-opacity + 1e-4], and for a well-conditioned conic the
  smallest quadratic form over the box bounds that from above, with a
  margin for rounding. Culling skips only pairs that fail the alpha test
  in the plain version too, so the outputs are those of a walk over every
  row, bit for bit.
- ``blend_lists_counts`` <- ``_fwd_counts_kernel``; as above, plus each
  row's contributing-pixel count from a warp ballot and popcount per pixel
  slot, added by the row's lane into the tile's integer counts in shared
  memory (exact in any order) and written out as f32.
- ``fo_grad_lists`` <- ``_fo_grad_kernel``; bound by FP32 operations
  (26 per walked pair and 43 more per contributing one, 64 for RGB-D;
  40-49 per byte; the row sums among them run on the tensor cores). One
  CTA per tile: the forward stores the transmittance at each 32-row
  chunk's entry and finds the chunks that some pixel walks into; the
  per-pixel residual/Huber/output cotangent; then each live chunk, back to
  front, is walked again from its checkpoint (alpha and transmittance
  kept in shared memory) and reversed, carrying the suffix
  sum(wbar * w), and each row's six conic moments and colour sums are
  TF32 products on the tensor cores (float32 operands split into a big
  part and a remainder), added over the warps in a fixed order; no
  atomics. Chunks that no pixel walks into get zero rows. The RGB-D
  variant carries the depth chain as a third product. A tile of more
  than 256 pixels (tile 32: P 1024) is walked by 256 threads in slices of
  256 pixels, each slice's products added into the same sums in turn.
- ``map_grad_lists`` <- ``_map_grad_kernel``, and with ``madd`` its
  ``with_madd`` variant; bound and design as ``fo_grad_lists`` (29 more
  operations per live contributing pair, 33 for RGB-D), one reverse chain
  even for RGB-D. ``madd`` [T, Kf] (0 valid, -1e30 invalid) is added to
  each raw row's log-opacity as the rows are staged, in the forward and
  the checkpointed reverse alike, so the caller makes no masked copy of
  the rows; 4 bytes per row more than the 64 of a row.
- ``blend_lists_vjp`` <- ``_bwd_kernel``; bound by FP32 operations (34
  per live contributing pair beyond the forward's), design as
  ``fo_grad_lists`` with the output cotangent read per pixel, and its
  depth column as a fourth feature sum.
- ``blend_lists_jvp8`` <- ``_jvp8_kernel``; bound by FP32 operations (26
  per walked pair and 229 more per contributing one for the seven chains;
  about 20 per byte, so the bytes bind nearly as hard). The card issues
  these operations about as fast as it can once an SM holds 16 warps, and
  a tile gives 8: one CTA per (half tile, group of three tangents), each
  walking the primal of its pixels itself (39 of a contributing pair's
  268 operations), puts four or five CTAs on every SM where one CTA per
  tile left most SMs with one and some with two. The tangent sums are
  fused multiply-adds (the primal's, which decide the thresholds, are
  not), so they round otherwise than the plain version's. The primal and
  the tangent carries of log T live in registers; the next chunk's rows
  and tangent rows are copied into shared memory (``cp.async``, two
  buffers) while the CTA walks the current one.
"""

from __future__ import annotations

import torch

# blend constants and the packed row layout (renderer._F columns)
_ALPHA_MIN = 1.0 / 255.0
_T_EPS = 1e-4
_U, _V, _CA, _CB, _CC, _OPA, _R0, _G0, _B0, _Z, _RAD, _LOGO = range(12)
_F = 16
_NTAN = 6

# launches of each kernel since the last reset (the RGB-D variants of the
# fused kernels, and the fused mapping kernel with ``madd``, are counted
# apart)
LAUNCHES = {"fwd": 0, "fwd_counts": 0, "fo_grad": 0, "fo_grad_rgbd": 0,
            "jvp8": 0, "bwd": 0, "map_grad": 0, "map_grad_rgbd": 0,
            "map_grad_madd": 0, "map_grad_madd_rgbd": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain versions

def _forward_plain(d, tx0, ty0, pmat, width: int, height: int):
    """Dense front-to-back blend of [T, K, F] rows over the tile's P pixels.
    Returns every [T, K, P] activation the reverse and tangent passes use."""
    pxl, pyl = pmat[3], pmat[4]
    a, b, c = d[..., _CA, None], d[..., _CB, None], d[..., _CC, None]
    logo = d[..., _LOGO, None]
    ul = d[..., _U] - tx0[:, None]
    vl = d[..., _V] - ty0[:, None]
    dx = ul[..., None] - pxl
    dy = vl[..., None] - pyl
    s = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy + logo
    pix_ok = ((tx0[:, None] + pxl <= width - 1)
              & (ty0[:, None] + pyl <= height - 1))          # [T, P]
    alpha = torch.clamp(torch.exp(torch.clamp(s, max=2.0)), max=0.99)
    ok = pix_ok[:, None, :] & (s <= logo + 1e-4) & (alpha >= _ALPHA_MIN)
    alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
    one_minus = 1.0 - alpha
    t_incl = torch.cumprod(one_minus, dim=1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], 1)
    contrib = ok & (t_excl * one_minus >= _T_EPS)
    w = torch.where(contrib, alpha * t_excl, torch.zeros_like(alpha))
    ones = torch.ones_like(d[..., _Z])
    zeros = torch.zeros_like(ones)
    feats = torch.stack([d[..., _R0], d[..., _G0], d[..., _B0], d[..., _Z],
                         ones, zeros, zeros, zeros], dim=-1)  # [T, K, 8]
    outs = torch.einsum("tkp,tkf->tpf", w, feats)
    return dict(dx=dx, dy=dy, ul=ul, vl=vl, a=a[..., 0], b=b[..., 0],
                c=c[..., 0], alpha=alpha, ok=ok, one_minus=one_minus,
                t_excl=t_excl, contrib=contrib, w=w, feats=feats, outs=outs)


def blend_lists_plain(d, tx0, ty0, pmat, width: int, height: int):
    return _forward_plain(d, tx0, ty0, pmat, width, height)["outs"]


def blend_lists_counts_plain(d, tx0, ty0, pmat, width: int, height: int):
    f = _forward_plain(d, tx0, ty0, pmat, width, height)
    return f["outs"], f["contrib"].sum(dim=2).to(torch.float32)


def _excl_suffix_sum(x, dim: int):
    """sum_{k' > k} x[k'] along ``dim``."""
    incl = torch.flip(torch.cumsum(torch.flip(x, [dim]), dim), [dim])
    tail = incl.narrow(dim, 1, x.shape[dim] - 1)
    return torch.cat([tail, torch.zeros_like(incl.narrow(dim, 0, 1))], dim)


def _excl_prefix_sum(x, dim: int):
    """sum_{k' < k} x[k'] along ``dim``."""
    incl = torch.cumsum(x, dim)
    head = incl.narrow(dim, 0, x.shape[dim] - 1)
    return torch.cat([torch.zeros_like(incl.narrow(dim, 0, 1)), head], dim)


def _dd_from_gouts_plain(f, pmat, g_outs):
    """Reverse blend: output cotangents [T, P, 8] -> row cotangents
    [T, K, F] (pallas_lists._dd_from_gouts)."""
    wbar = torch.einsum("tkf,tpf->tkp", f["feats"], g_outs)
    fbar = torch.einsum("tkp,tpf->tkf", f["w"], g_outs)
    obar = _excl_suffix_sum(wbar * f["w"], 1) / f["one_minus"]
    abar = torch.where(f["contrib"], f["t_excl"] * wbar,
                       torch.zeros_like(wbar)) - obar
    live = f["ok"] & (f["alpha"] < 0.99)
    sbar = torch.where(live, f["alpha"] * abar, torch.zeros_like(abar))
    G = torch.einsum("tkp,jp->tkj", sbar, pmat)
    g0, g1, g2, g3, g4, g5 = G.unbind(-1)
    a, b, c, ul, vl = f["a"], f["b"], f["c"], f["ul"], f["vl"]
    z = torch.zeros_like(a)
    cols = [z] * _F
    cols[_U] = a * g3 + b * g4 - (a * ul + b * vl) * g5
    cols[_V] = b * g3 + c * g4 - (b * ul + c * vl) * g5
    cols[_CA] = -0.5 * g0 + ul * g3 - 0.5 * ul * ul * g5
    cols[_CB] = -g1 + vl * g3 + ul * g4 - ul * vl * g5
    cols[_CC] = -0.5 * g2 + vl * g4 - 0.5 * vl * vl * g5
    cols[_LOGO] = g5
    cols[_R0], cols[_G0], cols[_B0], cols[_Z] = fbar[..., :4].unbind(-1)
    return torch.stack(cols, dim=-1)


def fo_grad_lists_plain(d, tx0, ty0, pmat, gt_t, mask_t, ea, eb, width: int,
                        height: int, use_huber: bool, delta: float,
                        eps: float, gtd_t=None):
    f = _forward_plain(d, tx0, ty0, pmat, width, height)
    outs = f["outs"]
    col, acc = outs[..., 0:3], outs[..., 4:5]
    e = torch.abs(ea) + eps
    diff = e * col + eb - gt_t
    am = acc * mask_t
    r = am * diff
    if use_huber:
        ax = torch.abs(r)
        safe = torch.sqrt(torch.clamp(2.0 * delta * ax - delta * delta,
                                      min=1e-20))
        small = ax < delta
        hub = torch.where(small, r, torch.sign(r) * safe)
        slope = torch.where(small, torch.ones_like(r), delta / safe)
    else:
        hub, slope = r, torch.ones_like(r)
    rbar = 2.0 * hub * slope
    g_col = rbar * am * e
    g_acc = torch.sum(rbar * mask_t * diff, dim=-1, keepdim=True)
    z1 = torch.zeros_like(g_acc)
    g_outs = torch.cat([g_col, z1, g_acc, z1, z1, z1], dim=-1)

    def tile_sum(x):
        return x.sum(dim=(1, 2))

    zs = torch.zeros_like(tile_sum(hub))
    sd = zs
    dd_dep = None
    if gtd_t is not None:
        depth_mask = (gtd_t > 0.01) & (acc > 0.95)
        r_d = torch.where(depth_mask, outs[..., 3:4] - gtd_t,
                          torch.zeros_like(gtd_t))
        g_outs_dep = torch.cat([z1, z1, z1, 2.0 * r_d, z1, z1, z1, z1], -1)
        sd = tile_sum(r_d * r_d)
        dd_dep = _dd_from_gouts_plain(f, pmat, g_outs_dep)
    sums = torch.stack([tile_sum(hub * hub), tile_sum(torch.abs(r)),
                        tile_sum(rbar * am * col), tile_sum(rbar * am), sd,
                        zs, zs, zs], dim=1)
    return _dd_from_gouts_plain(f, pmat, g_outs), dd_dep, sums


def blend_lists_jvp8_plain(d, d_tan, tx0, ty0, pmat, width: int,
                           height: int):
    f = _forward_plain(d, tx0, ty0, pmat, width, height)
    dx, dy = f["dx"][:, None], f["dy"][:, None]               # [T,1,K,P]
    a, b, c = (f[k][:, None, :, None] for k in ("a", "b", "c"))
    xx = -0.5 * (dx * dx)
    yy = -0.5 * (dy * dy)
    xy = dx * dy
    gx = a * dx + b * dy
    gy = b * dx + c * dy

    def tc(col):
        return d_tan[..., col, None]                           # [T,6,K,1]

    s_t = (tc(_CA) * xx + tc(_CC) * yy - tc(_CB) * xy
           - gx * tc(_U) - gy * tc(_V) + tc(_LOGO))            # [T,6,K,P]
    alpha = f["alpha"][:, None]
    live = (f["ok"] & (f["alpha"] < 0.99))[:, None]
    alpha_t = torch.where(live, alpha * s_t, torch.zeros_like(s_t))
    c_sum = -alpha_t * (1.0 / f["one_minus"][:, None])
    t_excl = f["t_excl"][:, None]
    texcl_t = t_excl * _excl_prefix_sum(c_sum, 2)
    w_t = torch.where(f["contrib"][:, None], alpha_t * t_excl + alpha * texcl_t,
                      torch.zeros_like(s_t))
    zeros = torch.zeros_like(d_tan[..., 0])
    feats_t = torch.stack([d_tan[..., _R0], d_tan[..., _G0], d_tan[..., _B0],
                           d_tan[..., _Z], zeros, zeros, zeros, zeros], -1)
    touts = (torch.einsum("tjkp,tkf->tjpf", w_t, f["feats"])
             + torch.einsum("tkp,tjkf->tjpf", f["w"], feats_t))
    return f["outs"], touts


def blend_lists_vjp_plain(d, tx0, ty0, pmat, g_outs, width: int,
                          height: int):
    return _dd_from_gouts_plain(
        _forward_plain(d, tx0, ty0, pmat, width, height), pmat, g_outs)


def map_grad_weights(width: int, height: int, alpha: float, rgbd: bool,
                     px_frac: float = 1.0):
    """(w_rgb, w_dep): the mapping loss's weights of the summed |r| terms,
    mean normalisers m_rgb = 3 W H px_frac and m_dep = W H px_frac with the
    RGB-D mix (renderer.map_grad_from_rows)."""
    m_rgb = 3.0 * width * height * px_frac
    m_dep = float(width * height) * px_frac
    if rgbd:
        return alpha / m_rgb, (1.0 - alpha) / m_dep
    return 1.0 / m_rgb, 0.0


def map_grad_lists_plain(d, tx0, ty0, pmat, gt_t, mask_t, ea, eb, width: int,
                         height: int, use_exposure: bool, alpha: float,
                         eps: float, gtd_t=None, px_frac: float = 1.0,
                         madd=None):
    if madd is not None:
        d = torch.cat([d[..., :_LOGO], (d[..., _LOGO] + madd)[..., None],
                       d[..., _LOGO + 1:]], dim=-1)
    f = _forward_plain(d, tx0, ty0, pmat, width, height)
    outs = f["outs"]
    col = outs[..., 0:3]
    if use_exposure:
        e = torch.abs(ea) + eps
        image_ab = e * col + eb
    else:
        e = 1.0
        image_ab = col
    r = (image_ab - gt_t) * mask_t
    sgn = torch.sign(r)
    w_rgb, w_dep = map_grad_weights(width, height, alpha, gtd_t is not None,
                                    px_frac)
    g_col = (w_rgb * e) * sgn * mask_t

    def tile_sum(x):
        return x.sum(dim=(1, 2))

    z1 = torch.zeros_like(mask_t)
    zs = torch.zeros_like(tile_sum(mask_t))
    if gtd_t is not None:
        dm = (gtd_t > 0.01).to(d.dtype)
        r_d = (outs[..., 3:4] - gtd_t) * dm
        g_dep = w_dep * torch.sign(r_d) * dm
        l_dep = tile_sum(torch.abs(r_d))
    else:
        g_dep, l_dep = z1, zs
    g_outs = torch.cat([g_col, g_dep, z1, z1, z1, z1], dim=-1)
    sums = torch.stack([tile_sum(torch.abs(r)), l_dep,
                        tile_sum(sgn * mask_t * col), tile_sum(sgn * mask_t),
                        zs, zs, zs, zs], dim=1)
    return _dd_from_gouts_plain(f, pmat, g_outs), sums


# ------------------------------------------------------------------ kernels

def _on_cuda(d) -> bool:
    if d.device.type == "cpu":
        return False
    if d.device.type != "cuda":
        raise ValueError(f"blend_lists: unsupported device {d.device}")
    return True


def _check(name, t, shape):
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected a float32 CUDA tensor, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_common(d, tx0, ty0, pmat):
    n_tiles, kf, nf = d.shape
    p = pmat.shape[1]
    if nf != _F:
        raise ValueError(f"d: expected {_F} packed columns, got {nf}")
    if p % 32 or not 32 <= p <= 1024:
        raise ValueError(f"pmat: P={p} must be a multiple of 32 in [32, 1024]")
    _check("d", d, (n_tiles, kf, _F))
    _check("tx0", tx0, (n_tiles,))
    _check("ty0", ty0, (n_tiles,))
    _check("pmat", pmat, (6, p))
    if d.data_ptr() % 16:
        raise ValueError("d: the kernels copy rows 16 bytes at a time, so its "
                         "data must start on a 16-byte boundary")
    return n_tiles, kf, p


def _lib():
    from .._build import library

    return library("blend_lists")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise_on(rc: int, fn: str):
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")


def _fwd_cuda(d, tx0, ty0, pmat, width, height, counts: bool):
    n_tiles, kf, p = _check_common(d, tx0, ty0, pmat)
    outs = torch.empty((n_tiles, p, 8), dtype=torch.float32, device=d.device)
    cnts = (torch.empty((n_tiles, kf), dtype=torch.float32, device=d.device)
            if counts else None)
    rc = _lib().blend_fwd(
        d.data_ptr(), tx0.data_ptr(), ty0.data_ptr(), pmat.data_ptr(),
        outs.data_ptr(), cnts.data_ptr() if counts else None,
        n_tiles, kf, p, width, height, _stream())
    _raise_on(rc, "blend_fwd")
    LAUNCHES["fwd_counts" if counts else "fwd"] += 1
    return outs, cnts


def blend_lists(d, tx0, ty0, pmat, width: int, height: int):
    """Blend frozen per-tile lists. d: [T, Kf, F]; tx0/ty0: [T] tile
    origins; pmat: [6, P] pixel basis. Returns [T, P, 8] with columns
    (r, g, b, depth, acc, 0, 0, 0)."""
    if not _on_cuda(d):
        return blend_lists_plain(d, tx0, ty0, pmat, width, height)
    return _fwd_cuda(d, tx0, ty0, pmat, width, height, counts=False)[0]


def blend_lists_counts(d, tx0, ty0, pmat, width: int, height: int):
    """``blend_lists`` plus each row's contributing-pixel count [T, Kf]."""
    if not _on_cuda(d):
        return blend_lists_counts_plain(d, tx0, ty0, pmat, width, height)
    return _fwd_cuda(d, tx0, ty0, pmat, width, height, counts=True)


def fo_grad_lists(d, tx0, ty0, pmat, gt_t, mask_t, ea, eb, width: int,
                  height: int, use_huber: bool, delta: float, eps: float,
                  gtd_t=None):
    """Fused first-order loss and gradient over frozen lists.

    gt_t/mask_t: [T, P, 3]/[T, P, 1] tiled ground truth; ea/eb: 0-d exposure
    tensors; gtd_t: [T, P, 1] tiled gt depth for RGB-D. Returns (dd
    [T, Kf, F] = d(sum hub^2)/d(d), dd_dep = d(sum r_d^2)/d(d) or None,
    sums [T, 8] = per-tile (sum hub^2, sum |r|, d(sumsq)/d|ea|,
    d(sumsq)/d(eb), sum r_d^2, 0, 0, 0))."""
    if not _on_cuda(d):
        return fo_grad_lists_plain(d, tx0, ty0, pmat, gt_t, mask_t, ea, eb,
                                   width, height, use_huber, delta, eps,
                                   gtd_t)
    n_tiles, kf, p = _check_common(d, tx0, ty0, pmat)
    _check("gt_t", gt_t, (n_tiles, p, 3))
    _check("mask_t", mask_t, (n_tiles, p, 1))
    if gtd_t is not None:
        _check("gtd_t", gtd_t, (n_tiles, p, 1))
    sc = torch.stack([ea, eb]).to(torch.float32)
    dd = torch.empty_like(d)
    dd_dep = torch.empty_like(d) if gtd_t is not None else None
    sums = torch.empty((n_tiles, 8), dtype=torch.float32, device=d.device)
    rc = _lib().blend_fo_grad(
        d.data_ptr(), tx0.data_ptr(), ty0.data_ptr(), pmat.data_ptr(),
        gt_t.data_ptr(), mask_t.data_ptr(),
        gtd_t.data_ptr() if gtd_t is not None else None, sc.data_ptr(),
        dd.data_ptr(), dd_dep.data_ptr() if dd_dep is not None else None,
        sums.data_ptr(), n_tiles, kf, p, width, height, int(use_huber),
        delta, 2.0 * delta, delta * delta, eps, _stream())
    _raise_on(rc, "blend_fo_grad")
    LAUNCHES["fo_grad" if gtd_t is None else "fo_grad_rgbd"] += 1
    return dd, dd_dep, sums


def blend_lists_jvp8(d, d_tan, tx0, ty0, pmat, width: int, height: int):
    """Primal blend plus the six pose-tangent pushforwards. d: [T, Kf, F];
    d_tan: [T, 6, Kf, F] row tangents. Returns (outs [T, P, 8],
    touts [T, 6, P, 8])."""
    if not _on_cuda(d):
        return blend_lists_jvp8_plain(d, d_tan, tx0, ty0, pmat, width,
                                      height)
    n_tiles, kf, p = _check_common(d, tx0, ty0, pmat)
    _check("d_tan", d_tan, (n_tiles, _NTAN, kf, _F))
    for name, x in (("d", d), ("d_tan", d_tan)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the jvp8 kernel copies rows 16 bytes "
                             f"at a time; the tensor must start at a "
                             f"16-byte boundary")
    outs = torch.empty((n_tiles, p, 8), dtype=torch.float32, device=d.device)
    touts = torch.empty((n_tiles, _NTAN, p, 8), dtype=torch.float32,
                        device=d.device)
    rc = _lib().blend_jvp8(
        d.data_ptr(), d_tan.data_ptr(), tx0.data_ptr(), ty0.data_ptr(),
        pmat.data_ptr(), outs.data_ptr(), touts.data_ptr(), n_tiles, kf, p,
        width, height, _stream())
    _raise_on(rc, "blend_jvp8")
    LAUNCHES["jvp8"] += 1
    return outs, touts


def blend_lists_vjp(d, tx0, ty0, pmat, g_outs, width: int, height: int):
    """Row cotangents [T, Kf, F] of ``blend_lists`` from output cotangents
    g_outs [T, P, 8] (columns 5-7 are ignored: their features are 0)."""
    if not _on_cuda(d):
        return blend_lists_vjp_plain(d, tx0, ty0, pmat, g_outs, width, height)
    n_tiles, kf, p = _check_common(d, tx0, ty0, pmat)
    _check("g_outs", g_outs, (n_tiles, p, 8))
    dd = torch.empty_like(d)
    rc = _lib().blend_bwd(
        d.data_ptr(), tx0.data_ptr(), ty0.data_ptr(), pmat.data_ptr(),
        g_outs.data_ptr(), dd.data_ptr(), n_tiles, kf, p, width, height,
        _stream())
    _raise_on(rc, "blend_bwd")
    LAUNCHES["bwd"] += 1
    return dd


class _BlendLists(torch.autograd.Function):
    """The list blend, differentiable in ``d``: forward ``blend_lists``,
    backward ``blend_lists_vjp`` (JAX ``blend_lists_pallas``'s custom VJP)."""

    @staticmethod
    def forward(ctx, d, tx0, ty0, pmat, width, height):
        ctx.save_for_backward(d, tx0, ty0, pmat)
        ctx.size = (width, height)
        return blend_lists(d, tx0, ty0, pmat, width, height)

    @staticmethod
    def backward(ctx, g_outs):
        d, tx0, ty0, pmat = ctx.saved_tensors
        dd = blend_lists_vjp(d, tx0, ty0, pmat, g_outs.contiguous(),
                             *ctx.size)
        return dd, None, None, None, None, None


def blend_lists_fn(d, tx0, ty0, pmat, width: int, height: int):
    """``blend_lists`` with a gradient to ``d`` through the VJP kernel."""
    return _BlendLists.apply(d, tx0, ty0, pmat, width, height)


def map_grad_lists(d, tx0, ty0, pmat, gt_t, mask_t, ea, eb, width: int,
                   height: int, use_exposure: bool, alpha: float, eps: float,
                   gtd_t=None, px_frac: float = 1.0, madd=None):
    """Fused mapping loss and gradient over frozen lists.

    d: [S, Kf, F]; gt_t/mask_t: [S, P, 3]/[S, P, 1] tiled ground truth
    (and gtd_t [S, P, 1] for RGB-D); ea/eb: 0-d exposure tensors (unused
    without ``use_exposure``); ``alpha`` mixes RGB and depth; ``px_frac``
    scales the mean normalisers of a tile-subset call; ``madd`` [S, Kf]
    (0 valid, -1e30 invalid), when given, is added to the log-opacity of
    the raw rows ``d`` in the kernel. Returns (dd
    [S, Kf, F] = d(loss)/d(d) with the normalisers applied, sums [S, 8] =
    per-tile (sum |r_rgb|, sum |r_d|, sum sgn mask col, sum sgn mask, 0,
    0, 0, 0))."""
    if not _on_cuda(d):
        return map_grad_lists_plain(d, tx0, ty0, pmat, gt_t, mask_t, ea, eb,
                                    width, height, use_exposure, alpha, eps,
                                    gtd_t, px_frac, madd)
    n_tiles, kf, p = _check_common(d, tx0, ty0, pmat)
    _check("gt_t", gt_t, (n_tiles, p, 3))
    _check("mask_t", mask_t, (n_tiles, p, 1))
    if gtd_t is not None:
        _check("gtd_t", gtd_t, (n_tiles, p, 1))
    if madd is not None:
        _check("madd", madd, (n_tiles, kf))
    w_rgb, w_dep = map_grad_weights(width, height, alpha, gtd_t is not None,
                                    px_frac)
    sc = torch.stack([ea, eb]).to(torch.float32)
    dd = torch.empty_like(d)
    sums = torch.empty((n_tiles, 8), dtype=torch.float32, device=d.device)
    rc = _lib().blend_map_grad(
        d.data_ptr(), tx0.data_ptr(), ty0.data_ptr(), pmat.data_ptr(),
        gt_t.data_ptr(), mask_t.data_ptr(),
        gtd_t.data_ptr() if gtd_t is not None else None,
        madd.data_ptr() if madd is not None else None, sc.data_ptr(),
        dd.data_ptr(), sums.data_ptr(), n_tiles, kf, p, width, height,
        int(use_exposure), w_rgb, w_dep, eps, _stream())
    _raise_on(rc, "blend_map_grad")
    LAUNCHES["map_grad" + ("_madd" if madd is not None else "")
             + ("_rgbd" if gtd_t is not None else "")] += 1
    return dd, sums
