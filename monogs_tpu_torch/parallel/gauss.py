"""Gaussian-sharded mapping primitives: the MAP sharded over a mesh
dimension "gauss" (JAX ``parallel/gauss.py``).

View sharding (``parallel/mesh.py``) replicates the map; here the [N]
arrays themselves are sharded, which is how a map larger than one card's
memory is mapped. Each rank holds the block ``[r N / D, (r + 1) N / D)``
(``shard_gauss``; ``gather_gauss`` is the inverse).

1. Each rank preprocesses and bins only its block (``build_tile_lists``),
   and gathers its per-fine-tile survivor rows d_local [Tf, Kf, F], the
   post-cull data, far below N.
2. One ``all_gather`` of those rows gives every rank the device-major
   [Tf, D Kf, F]; per tile the D local top-Kf lists are merged back into
   the global top-Kf by the single-device rule (strict overlaps first,
   then depth; ``_merge_rows``). A tile's global selection is contained in
   the union of the local ones (each local list ranks a subset of the
   candidates by the same key), so the merge selects exactly the
   single-device lists' rows.
3. The blend (and the fused mapping step, ``gauss_iters.py``) runs on the
   merged rows as on one device; every rank computes the same merged rows,
   loss and row cotangents.

The row gather's gradient (``_AllGatherRows``): in JAX the transpose of
``all_gather`` is a ``psum_scatter`` of the D ranks' identical cotangents,
which brings each rank D times its own block, scaled back by 1/D
(``gauss.py:295-301``). The port's backward returns this rank's own block
of the cotangent and needs no collective, since the merged rows, the loss
and so the cotangent are the same on every rank. It equals JAX's sum and
rescale up to the rounding of that sum. Parameter gradients thus come out
[N/D]-shaped on the rank that owns the Gaussians; no [N] cotangent is
formed on any rank.

Composes with view sharding as a 2-D mesh ("view", "gauss")
(``gauss_iters.make_gauss_mesh2``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models import gaussian_map as gm
from ..ops.losses import mapping_loss_rgb, mapping_loss_rgbd
from ..render import RenderConfig, build_tile_lists
from ..render.camera import Intrinsics
from ..render.primitives import preprocess
from ..render.renderer import (
    _RAD, _U, _V, _Z, GaussianArrays, _assemble, _blend, _masked_rows, _pack,
    _tile_origins, _tile_pmat,
)
from . import comm
from .mesh import _device_type


def make_gauss_mesh(n_devices: Optional[int] = None) -> DeviceMesh:
    """A 1-D mesh "gauss" over the first ``n_devices`` ranks (all by
    default). Every rank of the default group calls it."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return DeviceMesh(_device_type(), torch.arange(n),
                      mesh_dim_names=("gauss",))


def _block(n: int, r: int, d: int) -> slice:
    if n % d:
        raise ValueError(f"capacity {n} does not divide over {d} shards")
    return slice(r * (n // d), (r + 1) * (n // d))


def shard_gauss(gauss: GaussianArrays, mesh: DeviceMesh) -> GaussianArrays:
    """This rank's block of the [N] leaves over the mesh's "gauss"
    dimension (N divisible by its size: fixed-capacity maps are powers of
    two)."""
    group = mesh.get_group("gauss")
    sl = _block(gauss.xyz.shape[0], dist.get_rank(group), dist.get_world_size(group))
    return GaussianArrays(*(x[sl] for x in gauss))


def gather_gauss(local: GaussianArrays, mesh: DeviceMesh) -> GaussianArrays:
    """Every rank's block concatenated in rank order (``shard_gauss``'s
    inverse)."""
    return GaussianArrays(*comm.gather_cat(
        list(local), mesh.get_group("gauss"), (0,) * len(local)))


class _AllGatherRows(torch.autograd.Function):
    """[T, Kf, F] rows of every rank -> the device-major [T, D Kf, F]
    (JAX: ``all_gather`` then the moveaxis/reshape); the backward returns
    this rank's own block of the cotangent (module docstring)."""

    @staticmethod
    def forward(ctx, d_l, group):
        ctx.r, ctx.k = dist.get_rank(group), d_l.shape[1]
        return comm.gather_cat([d_l.detach()], group, (1,))[0]

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.r * ctx.k:(ctx.r + 1) * ctx.k].contiguous(), None


def all_gather_rows(d_l, group):
    """Differentiable ``_AllGatherRows``."""
    return _AllGatherRows.apply(d_l, group)


def _local_rows(gauss: GaussianArrays, T_cw, intr: Intrinsics,
                cfg: RenderConfig, margin: float, tau=None):
    """The local block's survivor rows: bin the local Gaussians, then a
    differentiable full-local preprocess and row gather (the rows of
    ``render_map_grad``). ``tau`` moves the binning's pose only, as in the
    JAX package. Returns (d [Tf, Kf, F], vld [Tf, Kf])."""
    lists = build_tile_lists(gauss, T_cw, intr, cfg, margin=margin, tau=tau)
    prep = preprocess(gauss.xyz, gauss.log_scale, gauss.quat, gauss.opa_logit,
                      gauss.sh, gauss.active, T_cw, intr,
                      sh_degree=cfg.sh_degree, near=cfg.near)
    vld = lists.vld & prep.valid[lists.idx]
    return _masked_rows(_pack(prep)[lists.idx], vld), vld


@torch.no_grad()
def _merge_src(d_all, vld_all, tx0, ty0, tile: int, k_fine: int,
               margin: float):
    """The merge's selection: per tile the first ``k_fine`` of the D Kf
    rows by (class, depth) with class 0 a strict overlap, 1 a margin-only
    row, 2 invalid (strictness recomputed from each row's mean and strict
    radius against the tile; margin rows carry the same packed radius),
    then those in depth order, invalid last. A lexicographic sort (a
    stable depth sort, then a stable class sort), never depth plus a class
    offset, which would quantise float32 depth to the offset's ulp and
    scramble the blend order among margin rows. Returns src [T, k_fine]
    into the D Kf axis."""
    z, u, v, r = (d_all[..., c] for c in (_Z, _U, _V, _RAD))
    if margin:
        x0, y0 = tx0[:, None], ty0[:, None]
        strict = ((u + r >= x0) & (u - r <= x0 + (tile - 1))
                  & (v + r >= y0) & (v - r <= y0 + (tile - 1)))
        cls = (~strict).to(torch.float32)
    else:
        cls = torch.zeros_like(z)
    cls = torch.where(vld_all, cls, torch.full_like(cls, 2.0))
    by_z = torch.argsort(z, dim=1, stable=True)
    by_cls = torch.argsort(torch.gather(cls, 1, by_z), dim=1, stable=True)
    src = torch.gather(by_z, 1, by_cls)[:, :k_fine]
    z_k = torch.gather(z, 1, src)
    zsel = torch.where(torch.gather(cls, 1, src) < 2.0, z_k,
                       torch.full_like(z_k, float("inf")))
    return torch.gather(src, 1, torch.argsort(zsel, dim=1, stable=True))


def take_rows(d_all, src):
    """Rows ``src`` [T, K] of d_all [T, M, F] (differentiable)."""
    return torch.gather(d_all, 1, src[..., None].expand(-1, -1,
                                                        d_all.shape[-1]))


def _merge_rows(d_all, vld_all, tx0, ty0, tile: int, k_fine: int,
                margin: float):
    """Merge the D per-rank top-Kf survivor lists d_all [Tf, D Kf, F]
    (device-major), vld_all [Tf, D Kf] into the global top-Kf
    (``_merge_src``); the row gather stays differentiable. Returns (d
    [Tf, k_fine, F], vld, src_k)."""
    src = _merge_src(d_all, vld_all, tx0, ty0, tile, k_fine, margin)
    return take_rows(d_all, src), torch.gather(vld_all, 1, src), src


def gp_tile_rows(gauss_local: GaussianArrays, T_cw, intr: Intrinsics,
                 cfg: RenderConfig, margin: float = 0.0, group=None,
                 tau=None):
    """SPMD body: the local block -> the merged global blend rows
    (d [Tf, Kf, F], vld [Tf, Kf]), the same on every rank of ``group``
    (the mesh's "gauss" group). The all_gather is the only exchange; its
    backward keeps each rank's own block."""
    d_l, vld_l = _local_rows(gauss_local, T_cw, intr, cfg, margin, tau=tau)
    d_all = all_gather_rows(d_l, group)
    (vld_all,) = comm.gather_cat([vld_l], group, (1,))
    tx0, ty0 = _tile_origins(intr, cfg, d_l.device)
    d, vld, _ = _merge_rows(d_all, vld_all, tx0, ty0, cfg.tile, cfg.k_fine,
                            margin)
    return d, vld


def _blend_tiles(d, vld, intr: Intrinsics, cfg: RenderConfig):
    """The XLA blend of every tile's merged rows (no background)."""
    dev = d.device
    tx0, ty0 = _tile_origins(intr, cfg, dev)
    pmat = _tile_pmat(cfg, dev)
    pix_ok = ((tx0[:, None] + pmat[3] <= intr.width - 1)
              & (ty0[:, None] + pmat[4] <= intr.height - 1))
    color, depth, acc, _ = _blend(d, vld, tx0, ty0, pmat,
                                  torch.zeros(3, device=dev), pix_ok)
    return color, depth, acc


def gp_render_tiles(gauss_local: GaussianArrays, T_cw, intr: Intrinsics,
                    cfg: RenderConfig, margin: float = 0.0, group=None):
    """SPMD body: Gaussian-sharded forward render in tile space, (colour
    [Tf, P, 3], depth [Tf, P], acc [Tf, P]), the single-device lists render
    of the full map; the plain blend (``renderer._blend``), as the JAX
    package blends these rows with its XLA ``_blend``."""
    d, vld = gp_tile_rows(gauss_local, T_cw, intr, cfg, margin, group)
    return _blend_tiles(d, vld, intr, cfg)


def gp_map_loss_grad(gauss_local: GaussianArrays, T_cw, intr: Intrinsics,
                     cfg: RenderConfig, gt_t, mask_t, ea, eb,
                     margin: float = 4.0, group=None, alpha: float = 1.0,
                     gtd_t=None, initialization: bool = False):
    """SPMD body: one view's mapping loss (``ops/losses.mapping_loss_rgb``
    or ``_rgbd`` over the full map, the same on every rank) and the
    gradients of the local block's leaves (xyz, sh, log_scale, quat,
    opa_logit; [N/D] each, through the row gather's local-block backward)
    and of the exposures. ``gt_t``/``mask_t``/``gtd_t``: the view's ground
    truth in tile space. Returns (loss, g_leaves, g_ea, g_eb)."""
    leaves = [x.detach().requires_grad_(True) for x in (
        gauss_local.xyz, gauss_local.sh, gauss_local.log_scale,
        gauss_local.quat, gauss_local.opa_logit)]
    ea_ = torch.as_tensor(ea, dtype=torch.float32,
                          device=leaves[0].device).detach().requires_grad_()
    eb_ = torch.as_tensor(eb, dtype=torch.float32,
                          device=leaves[0].device).detach().requires_grad_()
    with torch.enable_grad():
        g2 = GaussianArrays(*leaves, active=gauss_local.active)
        d, vld = gp_tile_rows(g2, T_cw, intr, cfg, margin, group)
        colors, depths, _ = _blend_tiles(d, vld, intr, cfg)
        image = _assemble(colors, intr, cfg)
        gt_img = _assemble(gt_t, intr, cfg)
        mask = _assemble(mask_t, intr, cfg)
        if gtd_t is None:
            loss = mapping_loss_rgb(image, gt_img, mask, ea_, eb_,
                                    initialization=initialization)
        else:
            loss = mapping_loss_rgbd(
                image, _assemble(depths[..., None], intr, cfg), gt_img,
                _assemble(gtd_t, intr, cfg), mask, ea_, eb_, alpha=alpha,
                initialization=initialization)
    grads = torch.autograd.grad(loss, leaves + [ea_, eb_],
                                allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves + [ea_, eb_])]
    return loss.detach(), tuple(grads[:5]), grads[5], grads[6]


def gp_adam_map_step(m_local: gm.GaussianMap, g_leaves, hyper: gm.MapHyper,
                     step: int) -> gm.GaussianMap:
    """Adam over the local block only: ``adam_step`` is elementwise over
    [N], so the sharded update needs no communication."""
    return gm.adam_step(m_local, gm.ParamLeaves(*g_leaves), hyper, step=step)
