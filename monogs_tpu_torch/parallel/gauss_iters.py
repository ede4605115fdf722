"""The production mapping loop with the MAP sharded over a mesh dimension
"gauss" (JAX ``parallel/gauss_iters.py``).

``parallel/gauss.py`` has the SPMD primitives (local binning, the one
``all_gather`` of survivor rows and their merge, the local-block backward);
this module lifts them to the whole ``slam.mapping.map_iters`` contract
(iteration count, frozen per-view lists, Adam, densify / prune / opacity
resets, the window pose and exposure Adam, the final visibility), so that
``BackEnd`` routes bundle adjustment through a sharded map as through the
view-sharded one (``Parallel.gauss_devices``).

- Map leaves live [N/D] a rank. The frozen per-view structure is the
  LOCAL tile lists (indices into the rank's block) and a frozen merge
  selection ``src_k`` [Tf, Kf] into the device-major [D Kf] row axis;
  freezing the merge keeps the single-device frozen lists' meaning: the
  blend order is the depth order when the lists were built.
- Each iteration, each view: local preprocess, local row gather,
  ``all_gather`` over "gauss", ``src_k``'s rows, then the fused mapping
  step, kernel #6, through ``map_grad_from_rows``, as on one device. The
  row cotangents go back through the gather's local-block backward to the
  rank that owns each Gaussian. Pose-tangent gradients are partial on a
  rank (it backpropagates its own rows only) and summed over "gauss";
  the exposure gradients come from the merged rows, the same on every
  rank.
- Densify, prune, the opacity resets and Adam are elementwise over [N/D]
  and stay local; ``clone_cap`` / ``split_cap`` apply per shard (the
  global growth budget is D times theirs), and every shard draws the same
  split noise (``MapConfig`` notes it).
- The final visibility: kernel #2's per-row counts on the merged rows,
  added back to the owning shard by provenance (merged row j came from
  rank ``src_k // Kf``, its local list row ``src_k % Kf``).
- On a 2-D mesh ("view", "gauss") the views are sharded over "view" as in
  ``parallel/mesh.py``: the map-parameter gradients and the statistics
  are summed (``max_radii2d`` maxed) over "view".

Every decision that leads to a collective (densify, reset, rebuild) comes
from the Python iteration counter, so every rank calls the collectives in
the same order. Random draws: ``comm.sync_draws`` at the start of a call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models import gaussian_map as gm
from ..ops import losses, se3
from ..render import RenderConfig, build_tile_lists
from ..render.blend_lists import blend_lists_counts
from ..render.camera import Intrinsics
from ..render.primitives import preprocess
from ..render.renderer import (
    _masked_rows, _pack, _tile_origins, _tile_pmat, map_grad_from_rows,
    tile_images,
)
from ..slam.mapping import (
    CamBatch, MapConfig, MapDraws, MapResult, _draw, _gauss_view,
    new_kf_adam,
)
from . import comm
from .gauss import _block, _merge_src, all_gather_rows, take_rows
from .mesh import _device_type, _pad_kf_adam, mesh_groups, pad_cams


def make_gauss_mesh2(n_view: int, n_gauss: int) -> DeviceMesh:
    """A 2-D ("view", "gauss") mesh over the first n_view n_gauss ranks,
    rank r at (r // n_gauss, r % n_gauss), as
    ``np.reshape(devices, (n_view, n_gauss))`` lays the JAX mesh out."""
    return DeviceMesh(_device_type(),
                      torch.arange(n_view * n_gauss).reshape(n_view, n_gauss),
                      mesh_dim_names=("view", "gauss"))


def _local_merged_rows(params: gm.ParamLeaves, active, T_eff, li, lv, sk,
                       intr: Intrinsics, cfg: RenderConfig, group, off=None):
    """Differentiable: the local block -> the merged global blend rows
    through the frozen selection (li / lv local lists, sk merge indices).
    Returns (d [Tf, Kf, F], the local radii)."""
    prep = preprocess(params.xyz, params.log_scale, params.quat,
                      params.opa_logit, params.sh, active, T_eff, intr,
                      sh_degree=cfg.sh_degree, near=cfg.near,
                      means2d_offset=off)
    d_l = _masked_rows(_pack(prep)[li], lv & prep.valid[li])
    return take_rows(all_gather_rows(d_l, group), sk), prep.radius


def _map_fields(m: gm.GaussianMap) -> list:
    """The map's [N] tensors, in order (all but ``adam_t``)."""
    return [*m.params, *m.adam_m, *m.adam_v, *m[4:]]


def _map_from_fields(f: list, adam_t) -> gm.GaussianMap:
    return gm.GaussianMap(gm.ParamLeaves(*f[:5]), gm.ParamLeaves(*f[5:10]),
                          gm.ParamLeaves(*f[10:15]), adam_t, *f[15:])


def gp_map_iters_impl(m: gm.GaussianMap, cams: CamBatch, n_iters: int,
                      it_count: int, generator: Optional[torch.Generator],
                      intr: Intrinsics, cfg: RenderConfig, mcfg: MapConfig,
                      hyper: gm.MapHyper, kf_adam=None,
                      initialization: bool = False, gauss_group=None,
                      view_group=None,
                      draws: Optional[MapDraws] = None) -> MapResult:
    """SPMD body: ``slam.mapping.map_iters`` with ``m`` the rank's block
    ([N/D] leaves) and ``cams`` the rank's views; returns the same result
    with the block's map and visibility [B, N/D] (module docstring)."""
    draws = draws or MapDraws()
    dev = cams.T.device
    b, nl = cams.T.shape[0], m.capacity
    cfg_iter = cfg._replace(with_n_touched=False)
    kf = cfg_iter.k_fine
    my = dist.get_rank(gauss_group)
    lr8 = torch.tensor([mcfg.lr_trans] * 3 + [mcfg.lr_rot] * 3
                       + [mcfg.lr_exposure_a, mcfg.lr_exposure_b],
                       device=dev)
    opt_mask = torch.cat([cams.opt_pose[:, None].expand(b, 6),
                          cams.opt_exposure[:, None].expand(b, 2)], dim=-1)
    valid_f = cams.valid.to(torch.float32)
    margin = mcfg.bin_margin if mcfg.bin_margin > 0 else 4.0
    tx0, ty0 = _tile_origins(intr, cfg_iter, dev)
    pmat = _tile_pmat(cfg_iter, dev)

    def tiles(imgs):
        return [tile_images(im, intr, cfg_iter) for im in imgs]

    gt_tb, mask_tb = tiles(cams.gt_image), tiles(cams.mapping_mask)
    gtd_tb = [None] * b if mcfg.monocular else tiles(cams.gt_depth)
    # tile subsets on the single-device schedule (a 1-D mesh draws what
    # map_iters draws); they also shrink each all_gather to S tiles
    n_fine = tx0.shape[0]
    use_sub = mcfg.tile_frac < 1.0
    n_sub = max(8, int(n_fine * mcfg.tile_frac) // 8 * 8)
    px_frac = n_sub / n_fine if use_sub else 1.0
    n_view = 1 if view_group is None else dist.get_world_size(view_group)

    def build_frozen(mc, Ts):
        """Per view: the local lists and the frozen merge selection."""
        gauss = _gauss_view(mc.params, mc.active)
        out = []
        for T_v in Ts:
            ll = build_tile_lists(gauss, T_v, intr, cfg_iter, margin=margin)
            with torch.no_grad():
                prep = preprocess(gauss.xyz, gauss.log_scale, gauss.quat,
                                  gauss.opa_logit, gauss.sh, gauss.active,
                                  T_v, intr, sh_degree=cfg_iter.sh_degree,
                                  near=cfg_iter.near)
                vld_f = ll.vld & prep.valid[ll.idx]
                d_l = _masked_rows(_pack(prep)[ll.idx], vld_f)
            d_all, v_all = comm.gather_cat([d_l, vld_f], gauss_group, (1, 1))
            out.append((ll.idx, ll.vld, _merge_src(
                d_all, v_all, tx0, ty0, cfg_iter.tile, kf, margin)))
        return out

    frozen = build_frozen(m, cams.T)
    kam, kav, kat = kf_adam if kf_adam is not None else new_kf_adam(b, dev)
    T, ea, eb = cams.T, cams.ea, cams.eb
    itc, since = int(it_count), 0
    for i in range(n_iters):
        itc += 1
        tsel_b = None
        if use_sub:
            tsel_b = _draw(draws.tsel, i)
            if tsel_b is None:
                tsel_b = torch.stack([
                    torch.randperm(n_fine, generator=generator,
                                   device=dev)[:n_sub] for _ in range(b)])
            tsel_b = tsel_b.to(dev)

        g_leaves, g_tau, g_ea, g_eb = None, [], [], []
        accum = torch.zeros(nl, dtype=torch.float32, device=dev)
        denom = torch.zeros_like(accum)
        radii_d = torch.zeros_like(accum)
        visible_any = torch.zeros(nl, dtype=torch.bool, device=dev)
        for v in range(b):
            li, lv, sk = frozen[v]
            gt_t, mask_t, gtd_t = gt_tb[v], mask_tb[v], gtd_tb[v]
            txy = None
            if use_sub:
                ts = tsel_b[v]
                li, lv, sk, gt_t, mask_t = li[ts], lv[ts], sk[ts], gt_t[ts], \
                    mask_t[ts]
                if gtd_t is not None:
                    gtd_t = gtd_t[ts]
                txy = (tx0[ts], ty0[ts])
            leaves = [x.detach().requires_grad_(True) for x in m.params]
            tau = torch.zeros(6, device=dev, requires_grad=True)
            off = torch.zeros((nl, 2), device=dev, requires_grad=True)
            with torch.enable_grad():
                d, radii = _local_merged_rows(
                    gm.ParamLeaves(*leaves), m.active, se3.retract(T[v], tau),
                    li, lv, sk, intr, cfg_iter, gauss_group, off=off)
            _, dd, gea_v, geb_v = map_grad_from_rows(
                d.detach(), intr, cfg_iter, gt_t, mask_t, ea[v], eb[v],
                initialization, mcfg.alpha, gtd_t=gtd_t, txy=txy,
                px_frac=px_frac)
            grads = torch.autograd.grad(d, leaves + [tau, off],
                                        grad_outputs=dd)
            s = valid_f[v]
            gl = [g * s for g in grads[:5]]
            g_leaves = gl if g_leaves is None else [
                a + c for a, c in zip(g_leaves, gl)]
            g_tau.append(grads[5] * s)
            g_ea.append(gea_v * s)
            g_eb.append(geb_v * s)
            radii = radii.detach()
            vis = (radii > 0) & cams.valid[v]
            norms = torch.linalg.norm(grads[6] * s, dim=-1)
            accum = accum + torch.where(vis, norms, torch.zeros_like(norms))
            denom = denom + vis.to(torch.float32)
            radii_d = torch.maximum(
                radii_d, torch.where(vis, radii, torch.zeros_like(radii)))
            visible_any = visible_any | vis
        # pose tangents: each rank backpropagates only its own rows
        g_tau = comm.all_reduce_(torch.stack(g_tau), gauss_group)
        # the isotropic regulariser is separable over the shards; its
        # denominator is the GLOBAL active count, and on a 2-D mesh it is
        # added once a view rank and summed over "view"
        n_act = comm.all_reduce_(
            torch.sum(m.active.to(torch.float32)).reshape(1), gauss_group)
        ls = m.params.log_scale.detach().requires_grad_(True)
        with torch.enable_grad():
            scaling = torch.exp(ls)
            dev_s = losses.abs_(scaling - torch.mean(scaling, dim=1,
                                                     keepdim=True))
            mmask = m.active[:, None].to(scaling.dtype)
            reg = (mcfg.isotropic_weight / n_view) * torch.sum(
                dev_s * mmask) / torch.clamp(n_act[0] * scaling.shape[1],
                                             min=1.0)
        (g_iso,) = torch.autograd.grad(reg, ls)
        g_leaves[2] = g_leaves[2] + g_iso
        if view_group is not None:
            *g_leaves, accum, denom = comm.all_reduce_flat_(
                [*g_leaves, accum, denom], view_group)
            comm.all_reduce_(radii_d, view_group, "max")
        m = m._replace(grad_accum=m.grad_accum + accum,
                       denom=m.denom + denom,
                       max_radii2d=torch.maximum(m.max_radii2d, radii_d))
        m = gm.adam_step(m, gm.ParamLeaves(*g_leaves), hyper, step=itc - 1)

        if initialization:
            do_dens = itc % mcfg.init_gaussian_update == 0
            do_reset = itc in (mcfg.init_gaussian_reset,
                               mcfg.densify_from_iter)
            dens = (mcfg.init_gaussian_th, mcfg.init_gaussian_extent, None)
        else:
            do_dens = (itc % mcfg.gaussian_update_every
                       == mcfg.gaussian_update_offset)
            do_reset = itc % mcfg.gaussian_reset == 0 and not do_dens
            dens = (mcfg.gaussian_th, mcfg.gaussian_extent,
                    mcfg.size_threshold)
        if do_dens:
            noise = _draw(draws.split_noise, i)
            m = gm.densify_and_prune(
                m, generator, mcfg.densify_grad_threshold, *dens, hyper,
                clone_cap=mcfg.clone_cap, split_cap=mcfg.split_cap,
                samples=None if noise is None else noise.to(dev))
        if do_reset:
            if initialization:
                m = gm.reset_opacity(m)
            else:
                if view_group is not None:
                    visible_any = comm.all_reduce_(
                        visible_any.to(torch.int32), view_group) > 0
                m = gm.reset_opacity_nonvisible(m, visible_any)

        if not initialization:
            g8 = torch.cat([g_tau, torch.stack(g_ea)[:, None],
                            torch.stack(g_eb)[:, None]], dim=-1)
            g8 = torch.where(opt_mask, g8, torch.zeros_like(g8))
            kat += 1
            kam = 0.9 * kam + 0.1 * g8
            kav = 0.999 * kav + 0.001 * g8 * g8
            d8 = -lr8 * (kam / (1 - 0.9 ** kat)) / (
                torch.sqrt(kav / (1 - 0.999 ** kat)) + 1e-8)
            d8 = torch.where(opt_mask, d8, torch.zeros_like(d8))
            T = se3.retract(T, d8[:, :6])
            ea = ea + d8[:, 6]
            eb = eb + d8[:, 7]

        since += 1
        if since >= mcfg.rebin_every or do_dens:
            frozen = build_frozen(m, T)
            since = 0

    # the final visibility over the block: kernel #2's counts on the merged
    # rows, each added to the Gaussian it came from on its owning rank
    vis_b = []
    for v in range(b):
        li, lv, sk = frozen[v]
        with torch.no_grad():
            d, _ = _local_merged_rows(m.params, m.active, T[v], li, lv, sk,
                                      intr, cfg_iter, gauss_group)
        _, cnts = blend_lists_counts(d, tx0, ty0, pmat, intr.width,
                                     intr.height)
        gi = torch.gather(li, 1, sk % kf)
        tgt = torch.where(sk // kf == my, gi, nl)
        nt = torch.zeros((nl + 1,), dtype=torch.int32, device=dev).index_add_(
            0, tgt.reshape(-1), cnts.to(torch.int32).reshape(-1))[:nl]
        vis_b.append((nt > 0) & cams.valid[v])
    return MapResult(m=m, cams=cams._replace(T=T, ea=ea, eb=eb),
                     it_count=itc, visibility=torch.stack(vis_b),
                     kf_adam=(kam, kav, kat))


def gp_sharded_map_iters(m: gm.GaussianMap, cams: CamBatch, n_iters: int,
                         it_count: int, generator: Optional[torch.Generator],
                         mesh: DeviceMesh, intr: Intrinsics,
                         cfg: RenderConfig, mcfg: MapConfig,
                         hyper: gm.MapHyper, kf_adam=None,
                         initialization: bool = False,
                         draws: Optional[MapDraws] = None) -> MapResult:
    """``map_iters`` with the map sharded over the mesh's "gauss"
    dimension (and the views over "view" on a 2-D mesh). Takes and
    returns the FULL map on every rank: each rank takes its block of the
    map and of the views, and the blocks, the visibility, the poses and
    the window Adam state are gathered back in rank order, so ``BackEnd``
    needs no knowledge of the layout. Always the fused step over frozen
    lists (``bin_margin`` 0 bins with a margin of 4 px)."""
    gg = mesh.get_group("gauss")
    vg = mesh.get_group("view") if "view" in mesh.mesh_dim_names else None
    dev = cams.T.device
    draws = comm.sync_draws(generator, draws, mesh_groups(mesh), dev)
    b0 = cams.T.shape[0]
    if vg is not None:
        cams = pad_cams(cams, dist.get_world_size(vg))
    b = cams.T.shape[0]
    ka = _pad_kf_adam(kf_adam, b, dev)
    bl = b if vg is None else b // dist.get_world_size(vg)
    r = 0 if vg is None else dist.get_rank(vg)
    sl = slice(r * bl, (r + 1) * bl)
    blk = _block(m.capacity, dist.get_rank(gg), dist.get_world_size(gg))
    m_local = _map_from_fields([x[blk] for x in _map_fields(m)], m.adam_t)
    res = gp_map_iters_impl(
        m_local, CamBatch(*(x[sl] for x in cams)), n_iters, it_count,
        generator, intr, cfg, mcfg, hyper,
        kf_adam=(ka[0][sl], ka[1][sl], ka[2]),
        initialization=initialization, gauss_group=gg, view_group=vg,
        draws=draws)
    fields = _map_fields(res.m)
    *fields, vis = comm.gather_cat(fields + [res.visibility], gg,
                                   (0,) * len(fields) + (1,))
    c = res.cams
    out = [c.T, c.ea, c.eb, vis, *res.kf_adam[:2]]
    if vg is not None:
        out = comm.gather_cat(out, vg, (0,) * 6)
    T, ea, eb, vis, kam, kav = (x[:b0] for x in out)
    cams = CamBatch(*(x[:b0] for x in cams))
    return MapResult(m=_map_from_fields(fields, res.m.adam_t),
                     cams=cams._replace(T=T, ea=ea, eb=eb),
                     it_count=res.it_count, visibility=vis,
                     kf_adam=(kam, kav, res.kf_adam[2]))
