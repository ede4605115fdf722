"""The tiled Gaussian-splat renderer.

Counterpart of ``monogs_tpu/render/renderer.py``: the binning half
(``_make_lists``, ``build_tile_lists``, ``refine_fine_lists``,
``tile_images``) and the render surface (``render``; ``tile_rows``,
``render_fo_grad_tiles``, ``render_pose_jvp_tiles``, ``render_pose_jvp``,
``render_batch``, ``render_tiles``, ``render_map_grad``,
``map_grad_from_rows`` over the list kernels; ``render_golden``, the
sequential test model). Binning is plain PyTorch sorts, as the JAX package
left it to XLA.

``render`` blends as the JAX package does for each ``RenderConfig.backend``:

- ``"pallas_lists"``: the list kernels of ``blend_lists`` over the per-tile
  lists (the counts kernel with ``with_n_touched``);
- ``"pallas"`` / ``"pallas_compact"`` without frozen lists and without
  ``with_n_touched``: the macro-list kernels of ``blend_macros`` (every
  overlapping row, no ``k_fine`` cap / the first ``k_fine``), over
  ``packed[order][sel_m]`` of the binning's macro stage;
- otherwise, ``"xla"`` always: the XLA blend, plain PyTorch as the JAX
  package's is XLA code (``_blend``: a [K, 6] x [6, P] log-alpha product per
  tile, the blocked transmittance scan of ``ops/scan.py``), over chunks of
  ``macro_chunk`` macro tiles under ``torch.utils.checkpoint`` when
  autograd records; its
  ``n_touched`` counts come from the blend's contributing mask.

Binning is not differentiable and runs under ``torch.no_grad``. Indices are
int64 (PyTorch's index type); every sort key stays in the int32 value range
of the JAX package, which ``_make_lists`` asserts.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import se3
from ..ops.scan import blocked_cumprod_excl
from ..utils.profiling import span
from .blend_lists import (  # noqa: F401  (the packed row layout)
    _ALPHA_MIN, _CA, _CB, _CC, _F, _LOGO, _OPA, _R0, _G0, _B0, _RAD, _T_EPS,
    _U, _V, _Z, blend_lists_counts, blend_lists_fn, blend_lists_jvp8,
    fo_grad_lists, map_grad_lists, map_grad_weights,
)
from .blend_macros import blend_macros_fn
from .camera import Intrinsics
from .primitives import preprocess
from .tiling import macro_instance_bin


class GaussianArrays(NamedTuple):
    """Render-facing SoA view of the map (fixed capacity N)."""

    xyz: torch.Tensor        # [N, 3]
    sh: torch.Tensor         # [N, K, 3] SH coefficients, K = (deg+1)^2
    log_scale: torch.Tensor  # [N, 3]
    quat: torch.Tensor       # [N, 4] (w, x, y, z), unnormalized
    opa_logit: torch.Tensor  # [N, 1]
    active: torch.Tensor     # [N] bool


class RenderConfig(NamedTuple):
    tile: int = 16
    macro_tiles: int = 8
    k_macro: int = 4096
    k_fine: int = 512
    sh_degree: int = 0
    near: float = 0.2
    macro_chunk: int = 0          # XLA blend: tiles of this many macros per
    #                               checkpointed chunk (0: all at once)
    with_n_touched: bool = True
    fine_mode: str = "sort"       # legacy knob, ignored
    backend: str = "xla"          # "xla" | "pallas" | "pallas_compact" |
    #                               "pallas_lists" (see the module docstring)
    pallas_interpret: bool = False  # TPU interpreter knob; unused here
    span_cap: int = 16
    k_big: int = 128

    @property
    def macro_px(self) -> int:
        return self.tile * self.macro_tiles


class RenderResult(NamedTuple):
    image: torch.Tensor      # [3, H, W]
    depth: torch.Tensor      # [1, H, W]
    opacity: torch.Tensor    # [1, H, W]
    radii: torch.Tensor      # [N] (0 = culled)
    n_touched: torch.Tensor  # [N] int32 (zeros if with_n_touched=False)

    @property
    def visibility_filter(self):
        return self.radii > 0


class TileLists(NamedTuple):
    """Frozen per-fine-tile Gaussian lists: idx [n_tiles, k_fine] original
    Gaussian indices front to back at the build pose; vld same-shape bool."""

    idx: torch.Tensor
    vld: torch.Tensor


class _BinAux(NamedTuple):
    order: torch.Tensor       # [N] depth-ascending permutation
    sel_m: torch.Tensor       # [Tm, Km] rank-space macro lists
    vld_m: torch.Tensor
    x0m: torch.Tensor         # [Tm] macro origins (pixels)
    y0m: torch.Tensor
    n_overflow: torch.Tensor  # splats whose strict span overflowed span_cap


BACKENDS = ("xla", "pallas", "pallas_compact", "pallas_lists")


def _check_backend(cfg: RenderConfig):
    if cfg.backend not in BACKENDS:
        raise ValueError(f"backend={cfg.backend!r}: expected one of "
                         f"{BACKENDS}")


def _pack(prep):
    cols = [
        prep.mean2d[:, 0], prep.mean2d[:, 1],
        prep.conic[:, 0], prep.conic[:, 1], prep.conic[:, 2],
        prep.opacity,
        prep.rgb[:, 0], prep.rgb[:, 1], prep.rgb[:, 2],
        prep.z, prep.radius,
        torch.log(torch.clamp(prep.opacity, min=1e-12)),
    ]
    cols += [torch.zeros_like(prep.z)] * (_F - len(cols))
    return torch.stack(cols, dim=-1)


def _pixel_basis(px_local, py_local):
    """[6, P] tile-local pixel polynomial basis (px^2, px py, py^2, px, py,
    1); rows 3/4 are the pixel coordinates the kernels read."""
    return torch.stack([px_local * px_local, px_local * py_local,
                        py_local * py_local, px_local, py_local,
                        torch.ones_like(px_local)], dim=0)


def _tile_pmat(cfg: RenderConfig, device):
    p = cfg.tile * cfg.tile
    i = torch.arange(p, device=device)
    return _pixel_basis((i % cfg.tile).to(torch.float32),
                        (i // cfg.tile).to(torch.float32))


def _grid(intr: Intrinsics, cfg: RenderConfig):
    mpx = cfg.macro_px
    n_mx = -(-intr.width // mpx)
    n_my = -(-intr.height // mpx)
    return n_mx, n_my, cfg.macro_tiles * cfg.macro_tiles


def _tile_origins(intr: Intrinsics, cfg: RenderConfig, device):
    """[Tf] fine-tile pixel origins in macro-major order."""
    n_mx, n_my, ft = _grid(intr, cfg)
    mpx, mt = cfg.macro_px, cfg.macro_tiles
    f = torch.arange(ft, device=device)
    m = torch.arange(n_mx * n_my, device=device)
    tx0 = (m % n_mx * mpx)[:, None] + (f % mt * cfg.tile)[None, :]
    ty0 = (m // n_mx * mpx)[:, None] + (f // mt * cfg.tile)[None, :]
    return (tx0.reshape(-1).to(torch.float32),
            ty0.reshape(-1).to(torch.float32))


@torch.no_grad()
def _make_lists(u, v, rad, valid, z, intr: Intrinsics, cfg: RenderConfig,
                margin: float = 0.0, tsel=None):
    """Index-space binning over UNSORTED [N] geometry. With ``tsel`` ([S]
    fine-tile indices) only those tiles' lists are built, in tsel order."""
    dev = u.device
    n = u.shape[0]
    tile, mpx, mt = cfg.tile, cfg.macro_px, cfg.macro_tiles
    n_mx, n_my, ft = _grid(intr, cfg)
    n_macro = n_mx * n_my

    order = torch.argsort(
        torch.where(valid, z, torch.full_like(z, float("inf"))), stable=True)
    u_s, v_s, valid_s = u[order], v[order], valid[order]
    rad_strict = rad[order]
    rad_s = (torch.where(valid_s, rad_strict + margin, rad_strict)
             if margin else rad_strict)

    r_pow2 = 1 << max(1, (n - 1).bit_length())
    assert n_macro * 2 * r_pow2 < 2**31, (
        "macro instance keys overflow int32; lower capacity or image size")
    mids = torch.arange(n_macro, device=dev)
    x0m = (mids % n_mx * mpx).to(torch.float32)
    y0m = (mids // n_mx * mpx).to(torch.float32)
    sel_m, vld_m, n_overflow = macro_instance_bin(
        u_s, v_s, rad_s, valid_s, n_mx, n_my, mpx, cfg.k_macro,
        cfg.span_cap, cfg.k_big,
        radius_strict=rad_strict if margin else None)

    # fine stage: per fine tile, the macro list's overlapping entries,
    # strict-first under a margin, back in depth order
    if tsel is None:
        f = torch.arange(ft, device=dev)
        txp = (x0m[:, None] + (f % mt * tile).to(torch.float32))[:, :, None]
        typ = (y0m[:, None] + (f // mt * tile).to(torch.float32))[:, :, None]
        um, vm = u_s[sel_m][:, None, :], v_s[sel_m][:, None, :]
        ranks_sel = sel_m[:, None, :]
        vldm_b = vld_m[:, None, :]
        bshape = (n_macro, ft, cfg.k_macro)
        n_rows = n_macro * ft
    else:
        mi = tsel // ft
        um, vm = u_s[sel_m][mi], v_s[sel_m][mi]
        tx0f, ty0f = _tile_origins(intr, cfg, dev)
        txp = tx0f[tsel][:, None]
        typ = ty0f[tsel][:, None]
        ranks_sel = sel_m[mi]
        vldm_b = vld_m[mi]
        bshape = (tsel.shape[0], cfg.k_macro)
        n_rows = tsel.shape[0]

    def overlap(rad_all):
        rm = rad_all[sel_m][:, None, :] if tsel is None else rad_all[sel_m][mi]
        return (vldm_b
                & (um + rm >= txp) & (um - rm <= txp + tile - 1)
                & (vm + rm >= typ) & (vm - rm <= typ + tile - 1))

    fm = overlap(rad_s).reshape(n_rows, cfg.k_macro)
    ranks = ranks_sel.expand(bshape).reshape(n_rows, cfg.k_macro)
    if margin:
        fs = overlap(rad_strict).reshape(n_rows, cfg.k_macro)
        keys = torch.where(fm, ranks + torch.where(fs, 0, r_pow2),
                           torch.full_like(ranks, 2 * r_pow2))
        picked = torch.sort(keys, dim=1).values[:, :cfg.k_fine]
        rank_g = torch.where(picked < 2 * r_pow2, picked & (r_pow2 - 1),
                             torch.full_like(picked, r_pow2))
        rank_g = torch.sort(rank_g, dim=1).values
    else:
        keys = torch.where(fm, ranks, torch.full_like(ranks, r_pow2))
        rank_g = torch.sort(keys, dim=1).values[:, :cfg.k_fine]
    vld_f = rank_g < r_pow2
    idx = torch.where(vld_f, order[torch.where(vld_f, rank_g, 0)], 0)
    return (TileLists(idx=idx, vld=vld_f),
            _BinAux(order=order, sel_m=sel_m, vld_m=vld_m, x0m=x0m,
                    y0m=y0m, n_overflow=n_overflow))


def _preprocess_rows(gauss: GaussianArrays, fi, T_eff, intr, cfg,
                     sh_degree=None):
    """preprocess of the gathered rows ``fi`` (gather-first)."""
    return preprocess(
        gauss.xyz[fi], gauss.log_scale[fi], gauss.quat[fi],
        gauss.opa_logit[fi], gauss.sh[fi], gauss.active[fi], T_eff, intr,
        sh_degree=cfg.sh_degree if sh_degree is None else sh_degree,
        near=cfg.near)


@torch.no_grad()
def build_tile_lists(gauss: GaussianArrays, T_cw, intr: Intrinsics,
                     cfg: RenderConfig, margin: float = 0.0, tau=None,
                     scale_modifier: float = 1.0, tsel=None,
                     with_aux: bool = False):
    """Bin the scene into per-fine-tile lists at the given pose."""
    T_eff = se3.retract(T_cw, tau) if tau is not None else T_cw
    prep = preprocess(
        gauss.xyz, gauss.log_scale, gauss.quat, gauss.opa_logit, gauss.sh,
        gauss.active, T_eff, intr, sh_degree=0, near=cfg.near,
        scale_modifier=scale_modifier)
    lists, aux = _make_lists(prep.mean2d[:, 0], prep.mean2d[:, 1],
                             prep.radius, prep.valid, prep.z, intr, cfg,
                             margin, tsel=tsel)
    return (lists, aux) if with_aux else lists


@torch.no_grad()
def refine_fine_lists(gauss: GaussianArrays, T_cw, intr: Intrinsics,
                      cfg: RenderConfig, aux: _BinAux, tsel) -> TileLists:
    """Re-run only the fine binning stage at a fresh pose against frozen
    macro lists: overlap, depth selection and order all use current-pose
    geometry; only macro membership is stale (the build margin covers it).
    Equal depths keep their macro-list order (stable sort)."""
    ft = cfg.macro_tiles * cfg.macro_tiles
    orig_m = aux.order[aux.sel_m]                          # [Tm, Km]
    prep = _preprocess_rows(gauss, orig_m.reshape(-1), T_cw, intr, cfg,
                            sh_degree=0)
    km = aux.sel_m.shape
    mi = tsel // ft
    um = prep.mean2d[:, 0].reshape(km)[mi]
    vm = prep.mean2d[:, 1].reshape(km)[mi]
    rm = prep.radius.reshape(km)[mi]
    okm = (prep.valid.reshape(km) & aux.vld_m)[mi]
    tx0f, ty0f = _tile_origins(intr, cfg, um.device)
    txp = tx0f[tsel][:, None]
    typ = ty0f[tsel][:, None]
    tile = cfg.tile
    fm = (okm
          & (um + rm >= txp) & (um - rm <= txp + tile - 1)
          & (vm + rm >= typ) & (vm - rm <= typ + tile - 1))
    z_m = prep.z.reshape(km)[mi]
    zkey = torch.where(fm, z_m, torch.full_like(z_m, float("inf")))
    zs, perm = torch.sort(zkey, dim=1, stable=True)
    zs = zs[:, :cfg.k_fine]
    ids = torch.gather(orig_m[mi], 1, perm[:, :cfg.k_fine])
    vld_f = torch.isfinite(zs)
    return TileLists(idx=torch.where(vld_f, ids, 0), vld=vld_f)


def _masked_rows(packed, vld):
    """Fold row validity into the log-opacity column (invalid: -1e30)."""
    logo = torch.where(vld, packed[..., _LOGO],
                       torch.full_like(packed[..., _LOGO], -1e30))
    return torch.cat([packed[..., :_LOGO], logo[..., None],
                      packed[..., _LOGO + 1:]], dim=-1).contiguous()


def _assemble(x, intr: Intrinsics, cfg: RenderConfig):
    """[Tf, P, C] tile-space values -> [C, H, W] image."""
    n_mx, n_my, _ = _grid(intr, cfg)
    mt, tile, mpx = cfg.macro_tiles, cfg.tile, cfg.macro_px
    c = x.shape[-1]
    x = x.reshape(n_my, n_mx, mt, mt, tile, tile, c)
    x = x.permute(0, 2, 4, 1, 3, 5, 6)
    x = x.reshape(n_my * mpx, n_mx * mpx, c)[:intr.height, :intr.width]
    return x.permute(2, 0, 1)


def _project(gauss: GaussianArrays, T_cw, intr: Intrinsics, cfg: RenderConfig,
             tau=None, scale_modifier: float = 1.0,
             lists: Optional[TileLists] = None, means2d_offset=None):
    """preprocess and pack the map at the pose (retracted by ``tau``);
    without ``lists`` the scene is binned first. Returns (prep, packed
    [N, F], lists, the binning's _BinAux or None)."""
    T_eff = se3.retract(T_cw, tau) if tau is not None else T_cw
    prep = preprocess(gauss.xyz, gauss.log_scale, gauss.quat,
                      gauss.opa_logit, gauss.sh, gauss.active, T_eff, intr,
                      sh_degree=cfg.sh_degree, near=cfg.near,
                      scale_modifier=scale_modifier,
                      means2d_offset=means2d_offset)
    packed = _pack(prep)
    aux = None
    if lists is None:
        lists, aux = _make_lists(packed[:, _U], packed[:, _V],
                                 packed[:, _RAD], prep.valid, prep.z, intr,
                                 cfg)
    return prep, packed, lists, aux


def frame_rows(gauss: GaussianArrays, T_cw, intr: Intrinsics,
               cfg: RenderConfig, tau=None, scale_modifier: float = 1.0,
               lists: Optional[TileLists] = None, means2d_offset=None):
    """What the full-frame list blend consumes: (d [Tf, Kf, F] packed rows
    with validity folded in, vld_f [Tf, Kf], lists, prep). Without
    ``lists`` the scene is binned at this pose first. Differentiable in the
    map, ``tau`` and ``means2d_offset`` (the gather's transpose is
    autograd's)."""
    prep, packed, lists, _ = _project(gauss, T_cw, intr, cfg, tau,
                                      scale_modifier, lists, means2d_offset)
    # entries culled at the CURRENT pose must not blend even if the (possibly
    # stale) lists still carry them
    vld_f = lists.vld & prep.valid[lists.idx]
    return _masked_rows(packed[lists.idx], vld_f), vld_f, lists, prep


def macro_rows(packed, aux: _BinAux):
    """What the macro-list kernels consume, from the binning's macro stage:
    (data_m [Tm, Km, F] = packed[order][sel_m], xy0 [Tm, 2] macro origins,
    counts [Tm] float). The macro lists hold their valid rows first, in
    depth order (tiling.macro_instance_bin), so the count is the row mask.
    Differentiable in ``packed``."""
    return (packed[aux.order[aux.sel_m]],
            torch.stack([aux.x0m, aux.y0m], dim=-1),
            aux.vld_m.sum(1).to(torch.float32))


def _blend(data, vld, tx0, ty0, pmat, bg, pix_ok):
    """The XLA blend (JAX ``renderer._blend``) of T tiles at once: a dense
    front-to-back composite of depth-ordered rows data [T, K, F] with
    validity vld [T, K] at tile origins tx0/ty0 [T] over the pixels of
    pmat [6, P] (pix_ok [T, P]). The log-alpha is one [K, 6] x [6, P]
    product per tile of the rows' quadratic coefficients and the pixel
    basis, and the transmittance the blocked exclusive cumprod, as in the
    JAX package; the weighted colour, depth and alpha sums one [P, K] x
    [K, 5] product. Returns (colour [T, P, 3] with the background, depth
    [T, P], acc [T, P], contrib [T, K, P])."""
    ul = data[..., _U] - tx0[:, None]
    vl = data[..., _V] - ty0[:, None]
    a, b, c = data[..., _CA], data[..., _CB], data[..., _CC]
    log_opa = data[..., _LOGO]
    G = torch.stack([
        -0.5 * a, -b, -0.5 * c, a * ul + b * vl, b * ul + c * vl,
        -0.5 * (a * ul * ul + 2.0 * b * ul * vl + c * vl * vl) + log_opa,
    ], dim=-1)                                               # [T, K, 6]
    s = torch.matmul(G, pmat)                                # [T, K, P]
    alpha = torch.clamp(torch.exp(torch.clamp(s, max=2.0)), max=0.99)
    ok = (vld[..., None] & pix_ok[:, None, :]
          & (s <= log_opa[..., None] + 1e-4) & (alpha >= _ALPHA_MIN))
    alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
    one_minus = 1.0 - alpha
    blk = math.gcd(one_minus.shape[1], 16)
    t_excl, _ = blocked_cumprod_excl(one_minus, axis=1, block=blk)
    contrib = ok & (t_excl * one_minus >= _T_EPS)
    w = torch.where(contrib, alpha * t_excl, torch.zeros_like(alpha))
    feats = torch.stack([data[..., _R0], data[..., _G0], data[..., _B0],
                         data[..., _Z], torch.ones_like(ul)], dim=-1)
    outs = torch.einsum("tkp,tkf->tpf", w, feats)            # [T, P, 5]
    acc = outs[..., 4]
    color = outs[..., :3] + (1.0 - acc)[..., None] * bg
    return color, outs[..., 3], acc, contrib


def _remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (as ``jax.checkpoint``)
    where autograd records a graph; without one (``torch.no_grad``, which
    the forward-mode tangents of tracking's linearised step run under)
    nothing is rematerialised, and checkpoint has no ``vmap`` rule in
    every torch release."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _xla_blend(packed, idx, vld_f, intr: Intrinsics, cfg: RenderConfig, bg,
               with_counts: bool):
    """The XLA render path's blend over every fine tile's list (JAX
    ``render``'s generic tail): ``packed[idx]`` and ``_blend`` per chunk of
    ``macro_chunk`` macro tiles (all tiles when 0), each chunk under
    ``torch.utils.checkpoint`` as ``jax.checkpoint`` rematerialises it in
    the backward. Returns colour [Tf, P, 3], depth [Tf, P], acc [Tf, P] and,
    with ``with_counts``, the contributing-pixel count of each list entry
    [Tf, Kf] (int32)."""
    dev = packed.device
    tx0, ty0 = _tile_origins(intr, cfg, dev)
    pmat = _tile_pmat(cfg, dev)
    W, H = intr.width, intr.height

    def blend_tiles(packed_, idx_c, vf_c, x0, y0):
        pix_ok = ((x0[:, None] + pmat[3] <= W - 1)
                  & (y0[:, None] + pmat[4] <= H - 1))
        color, depth, acc, contrib = _blend(packed_[idx_c], vf_c, x0, y0,
                                            pmat, bg, pix_ok)
        if with_counts:
            return color, depth, acc, contrib.sum(-1).to(torch.int32)
        return color, depth, acc

    n_fine = idx.shape[0]
    ft = cfg.macro_tiles * cfg.macro_tiles
    chunk = cfg.macro_chunk * ft if cfg.macro_chunk else n_fine
    parts = [_remat(blend_tiles, packed, idx[i:i + chunk],
                    vld_f[i:i + chunk], tx0[i:i + chunk], ty0[i:i + chunk])
             for i in range(0, n_fine, chunk)]
    out = [torch.cat(x, 0) for x in zip(*parts)]
    return out if with_counts else out + [None]


def render(gauss: GaussianArrays, T_cw, intr: Intrinsics, cfg: RenderConfig,
           tau=None, bg=None, scale_modifier: float = 1.0,
           lists: Optional[TileLists] = None,
           means2d_offset=None) -> RenderResult:
    """Tiled render; without ``lists`` the scene is binned at this pose
    first. The blend follows ``cfg.backend`` (see the module docstring).
    Differentiable in the map, ``tau`` and ``means2d_offset``, except on
    ``"pallas_lists"`` with ``cfg.with_n_touched``, where the counts kernel
    runs, as in the JAX package."""
    _check_backend(cfg)
    n = gauss.xyz.shape[0]
    dev = gauss.xyz.device
    if bg is None:
        bg = torch.zeros((3,), dtype=torch.float32, device=dev)
    prep, packed, lists, aux = _project(gauss, T_cw, intr, cfg, tau,
                                        scale_modifier, lists, means2d_offset)
    W, H = intr.width, intr.height
    zeros_n = torch.zeros((n,), dtype=torch.int32, device=dev)

    def result(colors, depths, accs, n_touched):
        return RenderResult(image=_assemble(colors, intr, cfg),
                            depth=_assemble(depths[..., None], intr, cfg),
                            opacity=_assemble(accs[..., None], intr, cfg),
                            radii=prep.radius, n_touched=n_touched)

    if (cfg.backend in ("pallas", "pallas_compact")
            and not cfg.with_n_touched and aux is not None):
        p = cfg.tile * cfg.tile
        args = (*macro_rows(packed, aux), _tile_pmat(cfg, dev), cfg.tile,
                cfg.macro_tiles)
        outs = blend_macros_fn(*args, W, H, k_fine=(
            cfg.k_fine if cfg.backend == "pallas_compact" else None))
        outs = outs.reshape(-1, p, 8)                          # [Tf, P, 8]
        accs = outs[..., 4]
        colors = outs[..., :3] + (1.0 - accs)[..., None] * bg
        return result(colors, outs[..., 3], accs, zeros_n)

    # entries culled at the CURRENT pose must not blend even if the (possibly
    # stale) lists still carry them
    vld_f = lists.vld & prep.valid[lists.idx]
    if cfg.backend == "pallas_lists":
        d = _masked_rows(packed[lists.idx], vld_f)
        tx0, ty0 = _tile_origins(intr, cfg, dev)
        pmat = _tile_pmat(cfg, dev)
        if cfg.with_n_touched:
            outs, cnts = blend_lists_counts(d.detach(), tx0, ty0, pmat, W, H)
            cnts = cnts.to(torch.int32)
        else:
            outs = blend_lists_fn(d, tx0, ty0, pmat, W, H)
            cnts = None
        accs = outs[..., 4]
        colors = outs[..., :3] + (1.0 - accs)[..., None] * bg
        depths = outs[..., 3]
    else:
        colors, depths, accs, cnts = _xla_blend(
            packed, lists.idx, vld_f, intr, cfg, bg, cfg.with_n_touched)
    n_touched = zeros_n
    if cfg.with_n_touched:
        orig = torch.where(vld_f, lists.idx, n).reshape(-1)
        n_touched = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
        n_touched = n_touched.index_add_(0, orig, cnts.reshape(-1))[:n]
    return result(colors, depths, accs, n_touched)


def render_batch(gauss: GaussianArrays, Ts, intr: Intrinsics,
                 cfg: RenderConfig, lists_b: TileLists, taus=None,
                 means2d_offsets=None, bg=None):
    """B views over their frozen lists (idx/vld [B, Tf, Kf]) in one list
    blend: each view's preprocess and gather, the B Tf tiles' rows stacked
    into one [B Tf, Kf, F] call of the differentiable list blend (forward
    kernel, VJP kernel). Differentiable in the map, ``taus`` [B, 6] and
    ``means2d_offsets`` [B, N, 2]. Returns (image [B, 3, H, W], depth
    [B, 1, H, W], opacity [B, 1, H, W], radii [B, N]). ``cfg.backend``
    must be "pallas_lists" (the JAX package's callers render view by view
    otherwise)."""
    b = Ts.shape[0]
    dev = gauss.xyz.device
    if bg is None:
        bg = torch.zeros((3,), dtype=torch.float32, device=dev)
    rows, radii = [], []
    for v in range(b):
        T = se3.retract(Ts[v], taus[v]) if taus is not None else Ts[v]
        prep = preprocess(gauss.xyz, gauss.log_scale, gauss.quat,
                          gauss.opa_logit, gauss.sh, gauss.active, T, intr,
                          sh_degree=cfg.sh_degree, near=cfg.near,
                          means2d_offset=(None if means2d_offsets is None
                                          else means2d_offsets[v]))
        idx = lists_b.idx[v]
        rows.append(_masked_rows(_pack(prep)[idx],
                                 lists_b.vld[v] & prep.valid[idx]))
        radii.append(prep.radius)
    n_fine, kf = lists_b.idx.shape[1:]
    tx0, ty0 = _tile_origins(intr, cfg, dev)
    outs = blend_lists_fn(torch.cat(rows).reshape(b * n_fine, kf, _F),
                          tx0.repeat(b), ty0.repeat(b), _tile_pmat(cfg, dev),
                          intr.width, intr.height).reshape(b, n_fine, -1, 8)
    accs = outs[..., 4]
    colors = outs[..., :3] + (1.0 - accs)[..., None] * bg
    return (torch.stack([_assemble(x, intr, cfg) for x in colors]),
            torch.stack([_assemble(x[..., None], intr, cfg)
                         for x in outs[..., 3]]),
            torch.stack([_assemble(x[..., None], intr, cfg) for x in accs]),
            torch.stack(radii))


def render_tiles(gauss: GaussianArrays, T_cw, intr: Intrinsics,
                 cfg: RenderConfig, lists_sub: TileLists, tx0s, ty0s,
                 tau=None):
    """Blend only the tile subset of ``lists_sub`` (S tiles at origins
    tx0s/ty0s), gather-first: preprocess runs on the subset's S Kf rows.
    On "pallas_lists" the differentiable list blend; on every other
    backend the XLA blend under ``torch.utils.checkpoint``. Returns
    (colour [S, P, 3], depth [S, P], acc [S, P]) with a zero background;
    differentiable in the map and ``tau``."""
    dev = tx0s.device
    pmat = _tile_pmat(cfg, dev)
    W, H = intr.width, intr.height
    if cfg.backend == "pallas_lists":
        d = tile_rows(gauss, T_cw, intr, cfg, lists_sub, tau)
        outs = blend_lists_fn(d, tx0s, ty0s, pmat, W, H)
        return outs[..., :3], outs[..., 3], outs[..., 4]
    T_eff = se3.retract(T_cw, tau) if tau is not None else T_cw
    s_tiles, kf = lists_sub.idx.shape
    prep = _preprocess_rows(gauss, lists_sub.idx.reshape(-1), T_eff, intr,
                            cfg)
    vld = lists_sub.vld & prep.valid.reshape(s_tiles, kf)
    bg0 = torch.zeros((3,), dtype=torch.float32, device=dev)

    def blend_tiles(d, x0, y0):
        pix_ok = (x0[:, None] + pmat[3] <= W - 1) & (y0[:, None] + pmat[4]
                                                     <= H - 1)
        return _blend(d, vld, x0, y0, pmat, bg0, pix_ok)[:3]

    return _remat(blend_tiles, _pack(prep).reshape(s_tiles, kf, _F), tx0s,
                  ty0s)


def render_pose_jvp(gauss: GaussianArrays, T_cw, intr: Intrinsics,
                    cfg: RenderConfig, lists: TileLists, bg=None, tsel=None):
    """Render and its six SE(3) pose-tangent pushforwards through one jvp8
    kernel launch over the lists (only the tiles ``tsel`` [S] when given;
    the others come out zero). Returns (image [3, H, W], depth [1, H, W],
    opacity [1, H, W], image_t [6, 3, H, W], depth_t [6, 1, H, W],
    opacity_t [6, 1, H, W])."""
    dev = T_cw.device
    if bg is None:
        bg = torch.zeros((3,), dtype=torch.float32, device=dev)
    tx0, ty0 = _tile_origins(intr, cfg, dev)
    n_fine = tx0.shape[0]
    if tsel is not None:
        lists_sub = TileLists(idx=lists.idx[tsel], vld=lists.vld[tsel])
        txs, tys = tx0[tsel], ty0[tsel]
    else:
        lists_sub, txs, tys = lists, tx0, ty0
    outs, touts = render_pose_jvp_tiles(gauss, T_cw, intr, cfg, lists_sub,
                                        txs, tys)
    if tsel is not None:
        outs = torch.zeros((n_fine,) + outs.shape[1:], device=dev).index_copy(
            0, tsel, outs)
        touts = torch.zeros((n_fine,) + touts.shape[1:],
                            device=dev).index_copy(0, tsel, touts)
    acc, acc_t = outs[..., 4], touts[..., 4]                # [Tf, (6,) P]
    img_t = touts[..., :3] - acc_t[..., None] * bg

    def tangents(x):                                        # [Tf, 6, P, C]
        return torch.stack([_assemble(x[:, j], intr, cfg) for j in range(6)])

    return (_assemble(outs[..., :3] + (1.0 - acc)[..., None] * bg, intr,
                      cfg),
            _assemble(outs[..., 3:4], intr, cfg),
            _assemble(acc[..., None], intr, cfg),
            tangents(img_t), tangents(touts[..., 3:4]),
            tangents(acc_t[..., None]))


def tile_rows(gauss: GaussianArrays, T_cw, intr: Intrinsics,
              cfg: RenderConfig, lists_sub: TileLists, tau=None):
    """Packed per-tile blend rows d [S, Kf, F] for a tile subset, validity
    folded into the log-opacity column; differentiable in ``tau``."""
    T_eff = se3.retract(T_cw, tau) if tau is not None else T_cw
    s_tiles, kf = lists_sub.idx.shape
    prep = _preprocess_rows(gauss, lists_sub.idx.reshape(-1), T_eff, intr,
                            cfg)
    vld = lists_sub.vld & prep.valid.reshape(s_tiles, kf)
    return _masked_rows(_pack(prep).reshape(s_tiles, kf, _F), vld)


def tile_rows_jvp(gauss: GaussianArrays, T_cw, intr: Intrinsics,
                  cfg: RenderConfig, lists_sub: TileLists):
    """``tile_rows`` at ``T_cw`` and its six pose tangents: (d [S, Kf, F],
    d_tan [S, 6, Kf, F]). Forward-mode AD of preprocess + pack on the
    gathered S*Kf rows (``torch.func.jvp`` under ``vmap`` over the six basis
    directions of tau)."""
    idx_s, vld_s = lists_sub.idx, lists_sub.vld
    s_tiles, kf = idx_s.shape
    dev = idx_s.device
    fi = idx_s.reshape(-1)
    T_cw = T_cw.detach()

    def pp(tau):
        prep = _preprocess_rows(gauss, fi, se3.retract(T_cw, tau), intr, cfg)
        return _pack(prep), prep.valid

    tau0 = torch.zeros(6, dtype=torch.float32, device=dev)
    eye = torch.eye(6, dtype=torch.float32, device=dev)
    rows_b, tans, valid_b = torch.func.vmap(
        lambda e: torch.func.jvp(pp, (tau0,), (e,), has_aux=True))(eye)
    vld = vld_s & valid_b[0].reshape(s_tiles, kf)
    d = _masked_rows(rows_b[0].reshape(s_tiles, kf, _F), vld)
    # tangents of rows that cannot blend are zeroed so that a non-finite
    # tangent of a culled splat cannot reach the outputs through 0 * inf
    d_tan = tans.reshape(6, s_tiles, kf, _F).permute(1, 0, 2, 3)
    d_tan = torch.where(vld[:, None, :, None], d_tan,
                        torch.zeros_like(d_tan)).contiguous()
    return d, d_tan


def render_pose_jvp_tiles(gauss: GaussianArrays, T_cw, intr: Intrinsics,
                          cfg: RenderConfig, lists_sub: TileLists, txs, tys):
    """Tile-space primal outs [S, P, 8] and its six pose-tangent
    pushforwards touts [S, 6, P, 8] over the tiles of ``lists_sub``
    (origins txs/tys): the rows and their tangents (``tile_rows_jvp``), then
    one jvp8 kernel launch for the blend and all six tangents."""
    _check_backend(cfg)
    d, d_tan = tile_rows_jvp(gauss, T_cw, intr, cfg, lists_sub)
    return blend_lists_jvp8(d, d_tan, txs, tys, _tile_pmat(cfg, d.device),
                            intr.width, intr.height)


def render_fo_grad_tiles(gauss: GaussianArrays, T_cw, intr: Intrinsics,
                         cfg: RenderConfig, lists_sub: TileLists, tx0s, ty0s,
                         tau, ea, eb, gt_t, mask_t, use_huber: bool,
                         delta: float, gtd_t=None, alpha: float = 0.95):
    """Fused first-order objective and its 8-dim gradient (mono and RGB-D).

    One fo_grad kernel launch computes the blend, the masked exposed Huber
    residual, the output cotangents and the reverse blend; the pose part is
    pulled back through preprocess with ``torch.autograd.grad`` over
    ``tile_rows``. Returns (loss, l1, g8) with l1 unscaled and
    g8 = d(loss)/d[tau(6), ea, eb]."""
    from ..ops.losses import EXPOSURE_EPS

    _check_backend(cfg)
    dev = gt_t.device
    tau = tau.detach().requires_grad_(True)
    with torch.enable_grad():
        d = tile_rows(gauss, T_cw.detach(), intr, cfg, lists_sub, tau)
    dd, dd_dep, sums = fo_grad_lists(
        d.detach(), tx0s, ty0s, _tile_pmat(cfg, dev), gt_t, mask_t, ea, eb,
        intr.width, intr.height, use_huber, delta, EXPOSURE_EPS, gtd_t=gtd_t)
    sumsq = torch.sum(sums[:, 0])
    l1 = torch.sum(sums[:, 1])
    if gtd_t is None:
        loss = torch.sqrt(sumsq + 1e-20)
        c_rgb = 0.5 / loss
        dd_total = dd * c_rgb
    else:
        # m/m_d = 3: three rgb residuals per pixel against one depth residual
        loss_rgb = torch.sqrt(sumsq + 1e-20)
        loss_dep = torch.sqrt(torch.sum(sums[:, 4]) * 3.0 + 1e-20)
        loss = alpha * loss_rgb + (1.0 - alpha) * loss_dep
        c_rgb = alpha * 0.5 / loss_rgb
        c_dep = (1.0 - alpha) * 3.0 * 0.5 / loss_dep
        dd_total = dd * c_rgb + dd_dep * c_dep
    (g_tau,) = torch.autograd.grad(d, tau, grad_outputs=dd_total)
    g_ea = c_rgb * torch.sum(sums[:, 2]) * torch.sign(ea)
    g_eb = c_rgb * torch.sum(sums[:, 3])
    return loss, l1, torch.cat([g_tau, g_ea[None], g_eb[None]])


def segment_sum(n: int, sids, vals):
    """out [n, ...]: out[i] = the sum of vals[j] over the j with
    sids[j] == i, added in the order of j (``sids`` sorted ascending), so
    that every run gives the same bits on any device. ``index_add_`` adds
    with atomics on the card, in an order that changes from run to run;
    this is the fixed-order sum of the A/B knobs' pull-backs."""
    ends = torch.searchsorted(sids, torch.arange(n + 1, device=sids.device))
    return torch.segment_reduce(vals, "sum", lengths=torch.diff(ends),
                                axis=0, unsafe=True)


def scatter_sum(n: int, ids, vals):
    """``segment_sum`` of vals [M, ...] by unsorted ids [M]: rows with the
    same id are added in the order of j (a stable sort of the ids)."""
    perm = torch.argsort(ids, stable=True)
    return segment_sum(n, ids[perm], vals[perm])


def render_map_grad(gauss: GaussianArrays, T_cw, intr: Intrinsics,
                    cfg: RenderConfig, lists: TileLists, gt_t, mask_t, tau,
                    off, ea, eb, initialization: bool, alpha: float,
                    gtd_t=None, sortperm=None, txy=None,
                    px_frac: float = 1.0, gather_first: bool = False):
    """Fused mapping loss and its full gradient for one view over frozen
    lists.

    One map_grad kernel launch computes the blend, the masked L1 chain
    (``ops/losses.mapping_loss_rgb[d]``, exposure unless
    ``initialization``) and the reverse blend; the row cotangents are pulled
    back through the full-N preprocess and the ``packed[lists.idx]`` gather
    with ``torch.autograd.grad``, whose graph is freed when it returns.
    ``off`` [N, 2] is the zero screen-space hook whose gradient feeds
    densification. ``txy``/``px_frac``: a tile-subset call (``lists``,
    ``gt_t``, ``mask_t``, ``gtd_t`` hold S of the Tf tiles, ``txy`` their
    origins, ``px_frac`` = S/Tf unbiases the normalisers).

    ``sortperm`` = (perm, sids) ([Tf Kf] each: the frozen argsort of the
    flat list ids and the ids in that order) pulls the row cotangents back
    to the Gaussians by a gather in that order and a ``segment_sum`` over
    the sorted ids, instead of autograd's transpose of the gather: the
    same adds in another order (full lists only, as in the JAX package).
    ``gather_first`` gathers the listed rows' parameters before preprocess,
    so the differentiated pipeline runs over S Kf rows, scatters each
    leaf's row cotangents back by list id with ``scatter_sum``, and takes
    ``radii`` from one full-N preprocess without gradients. Both differ
    from the default only in the order of float32 additions, and give the
    same bits on every run.

    While the profiler records, the view's work is three spans
    (``utils/profiling.py``): ``ba.prep`` (preprocess, pack, the gather and
    mask of the rows), ``ba.map_grad`` (the kernel) and ``ba.pullback``
    (the pull-back to the leaves).

    Returns (loss, g_leaves, g_tau, g_off, g_ea, g_eb, radii) with g_leaves
    the gradients of (xyz, sh, log_scale, quat, opa_logit)."""
    _check_backend(cfg)
    full = (gauss.xyz, gauss.sh, gauss.log_scale, gauss.quat,
            gauss.opa_logit)
    tau = tau.detach().requires_grad_(True)
    kw = dict(gtd_t=gtd_t, txy=txy, px_frac=px_frac)
    if gather_first and sortperm is None:
        s_tiles, kf = lists.idx.shape
        ids = lists.idx.reshape(-1)
        with span("ba.prep"):
            leaves = [x[ids].detach().requires_grad_(True) for x in full]
            off_g = off[ids].detach().requires_grad_(True)
            with torch.enable_grad():
                prep = preprocess(leaves[0], leaves[2], leaves[3], leaves[4],
                                  leaves[1], gauss.active[ids],
                                  se3.retract(T_cw, tau), intr,
                                  sh_degree=cfg.sh_degree, near=cfg.near,
                                  means2d_offset=off_g)
                d = _masked_rows(_pack(prep).reshape(s_tiles, kf, _F),
                                 lists.vld & prep.valid.reshape(s_tiles, kf))
        with span("ba.map_grad"):
            loss, dd, g_ea, g_eb = map_grad_from_rows(
                d.detach(), intr, cfg, gt_t, mask_t, ea, eb, initialization,
                alpha, **kw)
        with span("ba.pullback"):
            gg = torch.autograd.grad(d, leaves + [tau, off_g],
                                     grad_outputs=dd)
            n = off.shape[0]
            perm = torch.argsort(ids, stable=True)
            sids = ids[perm]
            g_leaves = tuple(segment_sum(n, sids, g[perm]) for g in gg[:5])
            g_off = segment_sum(n, sids, gg[6][perm])
        with span("ba.prep"), torch.no_grad():
            radii = preprocess(*(full[i] for i in (0, 2, 3, 4, 1)),
                               gauss.active, se3.retract(T_cw, tau), intr,
                               sh_degree=cfg.sh_degree,
                               near=cfg.near).radius
        return loss, g_leaves, gg[5], g_off, g_ea, g_eb, radii

    with span("ba.prep"):
        leaves = [x.detach().requires_grad_(True) for x in full]
        off = off.detach().requires_grad_(True)
        with torch.enable_grad():
            prep = preprocess(leaves[0], leaves[2], leaves[3], leaves[4],
                              leaves[1], gauss.active,
                              se3.retract(T_cw, tau), intr,
                              sh_degree=cfg.sh_degree, near=cfg.near,
                              means2d_offset=off)
            packed = _pack(prep)
        vld_f = lists.vld & prep.valid[lists.idx]
        if sortperm is None:
            with torch.enable_grad():
                d = _masked_rows(packed[lists.idx], vld_f)
        else:
            assert txy is None and px_frac == 1.0, (
                "sortperm is a permutation of the full lists")
            d = _masked_rows(packed.detach()[lists.idx], vld_f)
    if sortperm is None:
        with span("ba.map_grad"):
            loss, dd, g_ea, g_eb = map_grad_from_rows(
                d.detach(), intr, cfg, gt_t, mask_t, ea, eb, initialization,
                alpha, **kw)
        with span("ba.pullback"):
            grads = torch.autograd.grad(d, leaves + [tau, off],
                                        grad_outputs=dd)
    else:
        with span("ba.map_grad"):
            loss, dd, g_ea, g_eb = map_grad_from_rows(
                d, intr, cfg, gt_t, mask_t, ea, eb, initialization, alpha,
                gtd_t=gtd_t)
        # the gather and the mask transposed by hand: the log-opacity
        # cotangent is gated by the mask (the -1e30 branch is constant),
        # then the rows go back in the frozen order of their ids
        with span("ba.pullback"):
            perm, sids = sortperm
            logo = torch.where(vld_f, dd[..., _LOGO],
                               torch.zeros_like(dd[..., _LOGO]))
            dd = torch.cat([dd[..., :_LOGO], logo[..., None],
                            dd[..., _LOGO + 1:]], dim=-1).reshape(-1, _F)
            dpacked = segment_sum(packed.shape[0], sids, dd[perm])
            grads = torch.autograd.grad(packed, leaves + [tau, off],
                                        grad_outputs=dpacked)
    return (loss, tuple(grads[:5]), grads[5], grads[6], g_ea, g_eb,
            prep.radius.detach())


def map_grad_from_rows(d, intr: Intrinsics, cfg: RenderConfig, gt_t, mask_t,
                       ea, eb, initialization: bool, alpha: float,
                       gtd_t=None, madd=None, txy=None,
                       px_frac: float = 1.0):
    """The kernel and loss half of ``render_map_grad``: one map_grad kernel
    launch over pre-gathered rows d [S, Kf, F] -> (loss, dL/dd, g_ea,
    g_eb). ``txy`` overrides the tile origins of a tile-subset call.
    ``madd`` [S, Kf] (0 valid, -1e30 invalid; ``MapConfig.io_batch``)
    masks the log-opacity of the raw rows ``d`` in the kernel, in place of
    a masked copy of the rows."""
    from ..ops.losses import EXPOSURE_EPS

    dev = d.device
    tx0, ty0 = txy if txy is not None else _tile_origins(intr, cfg, dev)
    use_exposure = not initialization
    rgbd = gtd_t is not None
    dd, sums = map_grad_lists(
        d, tx0, ty0, _tile_pmat(cfg, dev), gt_t, mask_t, ea, eb, intr.width,
        intr.height, use_exposure, alpha if rgbd else 1.0, EXPOSURE_EPS,
        gtd_t=gtd_t, px_frac=px_frac, madd=madd)
    w_rgb, w_dep = map_grad_weights(intr.width, intr.height, alpha, rgbd,
                                    px_frac)
    loss = w_rgb * torch.sum(sums[:, 0])
    if rgbd:
        loss = loss + w_dep * torch.sum(sums[:, 1])
    if use_exposure:
        g_ea = w_rgb * torch.sum(sums[:, 2]) * torch.sign(ea)
        g_eb = w_rgb * torch.sum(sums[:, 3])
    else:
        g_ea = torch.zeros_like(ea)
        g_eb = torch.zeros_like(eb)
    return loss, dd, g_ea, g_eb


def tile_images(img, intr: Intrinsics, cfg: RenderConfig):
    """[C, H, W] -> [n_fine, P, C] per-fine-tile pixels (zero-padded at the
    image edges), tiles in the macro-major order of ``_tile_origins``."""
    c, H, W = img.shape
    n_mx, n_my, _ = _grid(intr, cfg)
    mt, tile, mpx = cfg.macro_tiles, cfg.tile, cfg.macro_px
    x = F.pad(img, (0, n_mx * mpx - W, 0, n_my * mpx - H))
    x = x.reshape(c, n_my, mt, tile, n_mx, mt, tile)
    x = x.permute(1, 4, 2, 5, 3, 6, 0)
    return x.reshape(n_mx * n_my * mt * mt, tile * tile, c)


def render_golden(gauss: GaussianArrays, T_cw, intr: Intrinsics,
                  sh_degree: int = 0, near: float = 0.2, tau=None, bg=None,
                  tile: int = 16) -> RenderResult:
    """Slow sequential reference renderer (a test model; JAX
    ``render_golden``): the CUDA rasterizer's per-pixel front-to-back loop
    with its sticky ``done`` flag, one Gaussian at a time in depth order,
    each entering the pixels of every ``tile``-px tile its 3-sigma box
    overlaps. O(N H W): tiny scenes only."""
    dev = gauss.xyz.device
    if bg is None:
        bg = torch.zeros((3,), dtype=torch.float32, device=dev)
    T_eff = se3.retract(T_cw, tau) if tau is not None else T_cw
    prep = preprocess(gauss.xyz, gauss.log_scale, gauss.quat,
                      gauss.opa_logit, gauss.sh, gauss.active, T_eff, intr,
                      sh_degree=sh_degree, near=near)
    n = gauss.xyz.shape[0]
    order = torch.argsort(torch.where(prep.valid, prep.z,
                                      torch.full_like(prep.z, float("inf"))),
                          stable=True)
    packed = _pack(prep)[order]
    valid_s = prep.valid[order]
    H, W = intr.height, intr.width
    i = torch.arange(H * W, device=dev)
    px = (i % W).to(torch.float32)
    py = (i // W).to(torch.float32)
    tile_x0 = torch.floor(px / tile) * tile
    tile_y0 = torch.floor(py / tile) * tile
    C = torch.zeros((H * W, 3), device=dev)
    D = torch.zeros((H * W,), device=dev)
    A = torch.zeros((H * W,), device=dev)
    T = torch.ones((H * W,), device=dev)
    done = torch.zeros((H * W,), dtype=torch.bool, device=dev)
    nt_sorted = []
    for g, v in zip(packed, valid_s):
        dx = g[_U] - px
        dy = g[_V] - py
        power = (-0.5 * (g[_CA] * dx * dx + g[_CC] * dy * dy)
                 - g[_CB] * dx * dy)
        alpha = torch.clamp(g[_OPA] * torch.exp(power), max=0.99)
        in_tile = ((g[_U] + g[_RAD] >= tile_x0)
                   & (g[_U] - g[_RAD] <= tile_x0 + tile - 1)
                   & (g[_V] + g[_RAD] >= tile_y0)
                   & (g[_V] - g[_RAD] <= tile_y0 + tile - 1))
        ok = v & in_tile & (power <= 0.0) & (alpha >= _ALPHA_MIN)
        alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
        test = T * (1.0 - alpha)
        fail = ok & (test < _T_EPS)
        contrib = ok & ~done & ~fail
        w = torch.where(contrib, alpha * T, torch.zeros_like(alpha))
        C = C + w[:, None] * g[_R0:_B0 + 1][None, :]
        D = D + w * g[_Z]
        A = A + w
        T = torch.where(contrib, test, T)
        done = done | fail
        nt_sorted.append(contrib.sum().to(torch.int32))
    C = C + T[:, None] * bg[None, :]
    n_touched = torch.zeros((n,), dtype=torch.int32, device=dev)
    if n:
        n_touched[order] = torch.stack(nt_sorted)
    return RenderResult(image=C.reshape(H, W, 3).permute(2, 0, 1),
                        depth=D.reshape(1, H, W), opacity=A.reshape(1, H, W),
                        radii=prep.radius, n_touched=n_touched)
