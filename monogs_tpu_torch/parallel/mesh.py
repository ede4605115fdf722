"""View-sharded mapping over ``torch.distributed`` (JAX ``parallel/mesh.py``).

Bundle adjustment renders B keyframes an iteration. Here the view batch is
sharded over the ranks of a ``DeviceMesh`` with one dimension, "view": each
rank renders its own views and the map-parameter gradients are summed over
the mesh; the map is replicated (a few hundred MB) and its update, which
follows every cross-view sum, is the same on every rank.

The JAX package runs one controller and ``jax.shard_map``; the port runs
one process per rank (SPMD). Every rank calls ``sharded_map_iters`` or
``sharded_map_step`` with the full, replicated map and view batch, takes
its own views ``[r B / D, (r + 1) B / D)`` (after ``pad_cams``), runs the
body and returns the full outputs: poses, exposures, visibility and the
window Adam state are gathered back in rank order, so a caller needs no
knowledge of the layout (the JAX package's in/out specs). At the start of
a call rank 0's generator state and draws reach every rank
(``comm.sync_draws``); each rank draws the tile subsets of its views as
the single-device loop draws its first views, as every JAX device splits
the replicated key over its local views. ``parallel/launch.py`` brings the
ranks up for the SLAM runtime.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models import gaussian_map as gm
from ..ops import losses, se3
from ..render import RenderConfig, render
from ..render.camera import Intrinsics
from ..slam.mapping import (
    CamBatch, MapConfig, MapDraws, MapResult, _gauss_view, empty_cam_batch,
    map_iters, new_kf_adam,
)
from . import comm


def _device_type() -> str:
    """The mesh's device type: "cuda" for NCCL, else "cpu" (gloo, also where
    ranks share one card)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None, axis: str = "view"
              ) -> DeviceMesh:
    """A 1-D mesh named ``axis`` over the first ``n_devices`` ranks (all of
    the default group's by default). Every rank of the default group calls
    it."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return DeviceMesh(_device_type(), torch.arange(n),
                      mesh_dim_names=(axis,))


def mesh_groups(mesh: DeviceMesh) -> list:
    """The mesh's process groups, its last dimension first
    (``comm.sync_draws``' order)."""
    return [mesh.get_group(name) for name in reversed(mesh.mesh_dim_names)]


def _views(cams: CamBatch, r: int, n: int) -> CamBatch:
    bl = cams.T.shape[0] // n
    return CamBatch(*(x[r * bl:(r + 1) * bl] for x in cams))


def shard_views(cams: CamBatch, mesh: DeviceMesh) -> CamBatch:
    """This rank's block of the view batch (B divisible by the mesh size)."""
    group = mesh.get_group("view")
    return _views(cams, dist.get_rank(group), dist.get_world_size(group))


def replicate_map(m: gm.GaussianMap, mesh: DeviceMesh) -> gm.GaussianMap:
    """Rank 0's map on every rank of the mesh."""
    flat = [*m.params, *m.adam_m, *m.adam_v, *m[3:]]
    for g in mesh_groups(mesh):
        flat = comm.broadcast_many(flat, g)
    return gm.GaussianMap(gm.ParamLeaves(*flat[:5]), gm.ParamLeaves(*flat[5:10]),
                          gm.ParamLeaves(*flat[10:15]), *flat[15:])


def pad_cams(cams: CamBatch, n_view: int) -> CamBatch:
    """The view batch padded to a multiple of the mesh size with invalid
    slots (masked out of every loss and statistic by ``cams.valid``)."""
    b = cams.T.shape[0]
    pad = (-b) % n_view
    if pad == 0:
        return cams
    h, w = cams.gt_image.shape[-2:]
    empty = empty_cam_batch(pad, h, w, cams.T.device)
    return CamBatch(*(torch.cat([a, e]) for a, e in zip(cams, empty)))


def _pad_kf_adam(kf_adam, b: int, device):
    if kf_adam is None:
        return new_kf_adam(b, device)
    pad = b - kf_adam[0].shape[0]
    if pad == 0:
        return kf_adam
    z = torch.zeros((pad, 8), device=device)
    return (torch.cat([kf_adam[0], z]), torch.cat([kf_adam[1], z]),
            kf_adam[2])


def sharded_map_step(m: gm.GaussianMap, cams: CamBatch, it_count: int,
                     mesh: DeviceMesh, intr: Intrinsics, cfg: RenderConfig,
                     mcfg: MapConfig, hyper: gm.MapHyper):
    """One mapping iteration with the view batch sharded over the mesh
    (JAX ``sharded_map_step``): per rank the local views' renders and
    losses (autograd through ``render``), the isotropic regulariser over
    the mesh size, the gradients and the loss summed over the mesh, the
    replicated map Adam step, and one SGD step of the local poses and
    exposures. Returns (map, cams with the retracted poses, loss)."""
    group = mesh.get_group("view")
    n_view, r = dist.get_world_size(group), dist.get_rank(group)
    b = cams.T.shape[0]
    if b % n_view:
        raise ValueError(f"{b} views do not divide over {n_view} ranks")
    cfg = cfg._replace(with_n_touched=False)
    local = _views(cams, r, n_view)
    bl, dev = local.T.shape[0], local.T.device
    leaves = [x.detach().requires_grad_(True) for x in m.params]
    taus = torch.zeros((bl, 6), device=dev, requires_grad=True)
    eas = local.ea.detach().requires_grad_(True)
    ebs = local.eb.detach().requires_grad_(True)
    with torch.enable_grad():
        gauss = _gauss_view(gm.ParamLeaves(*leaves), m.active)
        total = 0.0
        for v in range(bl):
            out = render(gauss, local.T[v], intr, cfg, tau=taus[v])
            if mcfg.monocular:
                loss = losses.mapping_loss_rgb(
                    out.image, local.gt_image[v], local.mapping_mask[v],
                    eas[v], ebs[v])
            else:
                loss = losses.mapping_loss_rgbd(
                    out.image, out.depth, local.gt_image[v],
                    local.gt_depth[v], local.mapping_mask[v], eas[v], ebs[v],
                    alpha=mcfg.alpha)
            total = total + torch.where(local.valid[v], loss,
                                        torch.zeros_like(loss))
        # the regulariser once a rank, over the mesh size, so that the
        # summed total is the single-device loss
        total = total + (mcfg.isotropic_weight * losses.isotropic_reg(
            torch.exp(leaves[2]), m.active) / n_view)
    grads = torch.autograd.grad(total, leaves + [taus, eas, ebs])
    *g_params, loss = comm.all_reduce_flat_(
        [*grads[:5], total.detach().reshape(1)], group)
    m2 = gm.adam_step(m, gm.ParamLeaves(*g_params), hyper, step=it_count)
    lr8 = torch.tensor([mcfg.lr_trans] * 3 + [mcfg.lr_rot] * 3
                       + [mcfg.lr_exposure_a, mcfg.lr_exposure_b],
                       device=dev)
    g8 = torch.cat([grads[5], grads[6][:, None], grads[7][:, None]], dim=-1)
    opt = torch.cat([local.opt_pose[:, None].expand(bl, 6),
                     local.opt_exposure[:, None].expand(bl, 2)], dim=-1)
    d8 = torch.where(opt, -lr8 * g8, torch.zeros_like(g8))
    T, ea, eb = comm.gather_cat(
        [se3.retract(local.T, d8[:, :6]), local.ea + d8[:, 6],
         local.eb + d8[:, 7]], group, (0, 0, 0))
    return m2, cams._replace(T=T, ea=ea, eb=eb), loss[0]


def sharded_map_iters(m: gm.GaussianMap, cams: CamBatch, n_iters: int,
                      it_count: int, generator: Optional[torch.Generator],
                      mesh: DeviceMesh, intr: Intrinsics, cfg: RenderConfig,
                      mcfg: MapConfig, hyper: gm.MapHyper, kf_adam=None,
                      initialization: bool = False,
                      draws: Optional[MapDraws] = None) -> MapResult:
    """``slam.mapping.map_iters`` with the view batch sharded over the
    mesh's "view" dimension (JAX ``sharded_map_iters``): same arguments
    and result, the map and every output full on every rank (module
    docstring). The body is ``map_iters`` with the view group, whose
    gradient and statistic sums precede each replicated map update.
    ``draws.tsel`` holds the rows of a rank's views (each rank reads the
    first rows, as every JAX device splits the key over its local
    views)."""
    group = mesh.get_group("view")
    n_view, r = dist.get_world_size(group), dist.get_rank(group)
    dev = cams.T.device
    draws = comm.sync_draws(generator, draws, mesh_groups(mesh), dev)
    b0 = cams.T.shape[0]
    cams = pad_cams(cams, n_view)
    b = cams.T.shape[0]
    ka = _pad_kf_adam(kf_adam, b, dev)
    bl = b // n_view
    sl = slice(r * bl, (r + 1) * bl)
    # the regulariser is added on every rank and its gradient summed
    mcfg_dev = mcfg._replace(isotropic_weight=mcfg.isotropic_weight / n_view)
    res = map_iters(m, _views(cams, r, n_view), n_iters, it_count, generator,
                    intr, cfg, mcfg_dev, hyper,
                    kf_adam=(ka[0][sl], ka[1][sl], ka[2]),
                    initialization=initialization, group=group, draws=draws)
    c = res.cams
    T, ea, eb, vis, kam, kav = comm.gather_cat(
        [c.T, c.ea, c.eb, res.visibility, *res.kf_adam[:2]], group,
        (0,) * 6)
    cams = cams._replace(T=T, ea=ea, eb=eb)
    return MapResult(m=res.m, cams=CamBatch(*(x[:b0] for x in cams)),
                     it_count=res.it_count, visibility=vis[:b0],
                     kf_adam=(kam[:b0], kav[:b0], res.kf_adam[2]))
