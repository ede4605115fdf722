"""Mapping: keyframe-window bundle adjustment and colour refinement.

Counterpart of ``monogs_tpu/slam/mapping.py``. ``map_iters`` takes one of
the JAX package's two branches:

- fused (``bin_margin > 0``, ``fused_grad`` and ``backend="pallas_lists"``,
  the shipped configuration, ``bench.py::bench_mapping``): frozen per-view
  margin tile lists and one fused map_grad kernel per view per iteration
  over all tiles or a fresh random tile subset (``tile_frac < 1``). Its
  A/B knobs: ``io_batch`` (all B views preprocessed in one graph, one flat
  gather at view offsets, the kernel's in-kernel validity mask ``madd``
  on the raw rows, one flat sum of the row cotangents and one pull-back;
  no tile subsets), ``scatter_segsum`` (the row cotangents go back through
  a frozen argsort of each view's list ids, rebuilt with the lists; no
  tile subsets) and ``gather_first`` (preprocess over the listed rows
  only, a sum per leaf). Their sums add each Gaussian's rows in a fixed
  order (``renderer.segment_sum``), so that a BA iteration gives the same
  bits on every run;
- unfused (otherwise): per view, the mapping loss of a differentiable
  ``render`` and its gradients by autograd, the isotropic regulariser
  inside the loss. With ``bin_margin == 0`` every render bins its view
  anew and blends through ``cfg.backend`` (the macro-list kernels on
  ``"pallas"`` / ``"pallas_compact"``); with frozen lists it blends them
  through the list kernels (``"pallas_lists"``) or the XLA blend. With
  ``batch_render`` over frozen lists on ``"pallas_lists"`` the B views
  blend in one list-blend call (``render_batch``) and the per-view losses
  are summed under one autograd graph.

Both cover mono and RGB-D, ``initialization``, the window pose/exposure
Adam with retraction, densify/prune and the opacity resets on their
schedule; the fused branch also rebuilds its lists every ``rebin_every``
iterations and after a densify. The final visibility pass renders with
``n_touched``, from the lists (``vis_from_lists``) or binning anew.

The JAX package runs a call as one program (``lax.fori_loop``); here it is
a Python loop over device tensors. The densify, reset and rebuild schedule
depends only on the iteration counter, which stays a Python int, and no
tensor is copied from the host inside the loop, so a mapping iteration
never synchronises the host with the card (``chip_smoke.py`` counts the
synchronisations under ``torch.cuda.set_sync_debug_mode``). Views run one
after another; each view's autograd graph over the full-N preprocess is
freed when its pull-back returns, as ``lax.map`` bounds the JAX program's
memory.

Random draws come from a ``torch.Generator``: per iteration, each view's
tile subset (fused branch with ``tile_frac < 1`` only), then the split
noise of a densify; per colour-refinement iteration, the view.
``MapDraws`` and ``views`` replace them with given values, so a test can
replay the JAX package's ``jax.random`` keys.

With ``group`` (a ``torch.distributed`` ``ProcessGroup``, the counterpart
of the JAX package's ``axis_name``) the same loop runs on each rank of a
view-sharded call (``parallel/mesh.py::sharded_map_iters``) over the
rank's own views: after every iteration's gradients the map-parameter
gradients, ``grad_accum`` and ``denom`` are summed over the group in one
collective, ``max_radii2d`` maxed, and at an opacity reset the views'
visibility summed, before the replicated map update, which is therefore
the same on every rank; the window pose/exposure Adam stays with the rank
that owns the view. The caller pre-scales ``isotropic_weight`` by the
group's size, as in the JAX package (the regulariser is added on every
rank and its gradient summed).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..models import gaussian_map as gm
from ..ops import losses, se3
from ..ops.image import ssim as ssim_fn
from ..render.camera import Intrinsics
from ..render.primitives import preprocess
from ..render.renderer import (
    _F, GaussianArrays, RenderConfig, TileLists, _check_backend, _pack,
    _tile_origins, build_tile_lists, map_grad_from_rows, render,
    render_batch, render_map_grad, scatter_sum, tile_images,
)
from ..utils.profiling import count, span


class MapConfig(NamedTuple):
    """Static mapping hyperparameters; same fields and defaults as the JAX
    package's MapConfig (see there for each knob's rationale)."""

    monocular: bool = True
    alpha: float = 0.95
    window_size: int = 8
    pose_window: int = 3
    pool_size: int = 2
    lr_trans: float = 0.0005
    lr_rot: float = 0.0015
    lr_exposure_a: float = 0.01
    lr_exposure_b: float = 0.01
    densify_grad_threshold: float = 0.0002
    gaussian_th: float = 0.7
    gaussian_extent: float = 6.0
    gaussian_update_every: int = 150
    gaussian_update_offset: int = 50
    gaussian_reset: int = 2001
    size_threshold: int = 20
    init_gaussian_update: int = 100
    init_gaussian_reset: int = 500
    init_gaussian_th: float = 0.005
    init_gaussian_extent: float = 180.0
    densify_from_iter: int = 500
    isotropic_weight: float = 10.0
    lambda_dssim: float = 0.2
    clone_cap: int = 8192
    split_cap: int = 4096
    bin_margin: float = 4.0
    rebin_every: int = 25
    batch_render: bool = False
    fused_grad: bool = True
    scatter_segsum: bool = False
    io_batch: bool = False
    tile_frac: float = 1.0
    gather_first: bool = False
    vis_from_lists: bool = True


class CamBatch(NamedTuple):
    """Stacked per-view tensors of the window (and staged pool)."""

    gt_image: torch.Tensor      # [B, 3, H, W]
    gt_depth: torch.Tensor      # [B, 1, H, W]
    mapping_mask: torch.Tensor  # [B, 1, H, W]
    T: torch.Tensor             # [B, 4, 4]
    ea: torch.Tensor            # [B]
    eb: torch.Tensor            # [B]
    valid: torch.Tensor         # [B] bool, slot in use
    opt_pose: torch.Tensor      # [B] bool, optimise the pose
    opt_exposure: torch.Tensor  # [B] bool, optimise the exposure


def empty_cam_batch(b: int, h: int, w: int, device="cuda") -> CamBatch:
    from .. import resolve_device

    dev = resolve_device(device)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return CamBatch(
        gt_image=z(b, 3, h, w), gt_depth=z(b, 1, h, w),
        mapping_mask=z(b, 1, h, w),
        T=torch.eye(4, device=dev).expand(b, 4, 4).clone(),
        ea=torch.ones((b,), device=dev), eb=z(b),
        valid=z(b, dtype=torch.bool), opt_pose=z(b, dtype=torch.bool),
        opt_exposure=z(b, dtype=torch.bool))


def new_kf_adam(b: int, device="cuda"):
    """Fresh window pose/exposure Adam state (m [B, 8], v [B, 8], step)."""
    from .. import resolve_device

    dev = resolve_device(device)
    return (torch.zeros((b, 8), device=dev), torch.zeros((b, 8), device=dev),
            0)


class MapDraws(NamedTuple):
    """Injected random draws, indexed by the call's iteration (0-based); a
    missing or None entry is drawn from the generator."""

    tsel: Sequence = ()         # [B, S] per-view tile subsets (tile_frac < 1)
    split_noise: Sequence = ()  # [2, split_cap, 3] normals of a densify


class MapResult(NamedTuple):
    m: gm.GaussianMap
    cams: CamBatch            # poses and exposures after the window Adam
    it_count: int
    visibility: torch.Tensor  # [B, N] bool: n_touched > 0 in a valid view
    kf_adam: tuple            # (m [B, 8], v [B, 8], step) for the next call


def _fused(cfg: RenderConfig, mcfg: MapConfig) -> bool:
    """Whether map_iters takes the fused branch (JAX mapping.py:331-336)."""
    return (mcfg.bin_margin > 0 and mcfg.fused_grad
            and cfg.backend == "pallas_lists")


def _check_supported(cfg: RenderConfig, mcfg: MapConfig, group):
    if group is not None and not isinstance(group, dist.ProcessGroup):
        raise TypeError(
            "group: expected a torch.distributed ProcessGroup (the JAX "
            "package's axis_name is DeviceMesh.get_group(name) here), got "
            f"{type(group).__name__}")


def _draw(seq: Sequence, i: int):
    return seq[i] if i < len(seq) else None


def _mapping_loss_one(gauss: GaussianArrays, T, gt_image, gt_depth, mask,
                      ea, eb, tau, off, intr: Intrinsics, cfg: RenderConfig,
                      mcfg: MapConfig, initialization: bool, lists=None):
    """Render one view and its mapping loss (slam_utils.py:224-253);
    returns (loss, radii)."""
    out = render(gauss, T, intr, cfg, tau=tau, means2d_offset=off,
                 lists=lists)
    if mcfg.monocular:
        loss = losses.mapping_loss_rgb(out.image, gt_image, mask, ea, eb,
                                       initialization=initialization)
    else:
        loss = losses.mapping_loss_rgbd(out.image, out.depth, gt_image,
                                        gt_depth, mask, ea, eb,
                                        alpha=mcfg.alpha,
                                        initialization=initialization)
    return loss, out.radii


def _view_loss_grads(gauss: GaussianArrays, cams: CamBatch, v: int, T, ea,
                     eb, intr: Intrinsics, cfg: RenderConfig, mcfg: MapConfig,
                     initialization: bool, lists=None):
    """One view's term of the unfused branch (a step of JAX ``_batch_loss``'s
    ``lax.map`` under ``value_and_grad``): the mapping loss and its
    gradients in the map leaves, the pose tangent, the zero screen-space
    hook [N, 2] and the exposures, by autograd through the render; the
    view's graph is freed when it returns. Same tuple as
    ``render_map_grad``."""
    n, dev = gauss.xyz.shape[0], gauss.xyz.device
    leaves = [x.detach().requires_grad_(True) for x in
              (gauss.xyz, gauss.sh, gauss.log_scale, gauss.quat,
               gauss.opa_logit)]
    extra = [torch.zeros(6, device=dev).requires_grad_(True),
             torch.zeros((n, 2), device=dev).requires_grad_(True),
             ea.detach().requires_grad_(True),
             eb.detach().requires_grad_(True)]
    with torch.enable_grad():
        loss, radii = _mapping_loss_one(
            GaussianArrays(*leaves, active=gauss.active), T,
            cams.gt_image[v], cams.gt_depth[v], cams.mapping_mask[v],
            extra[2], extra[3], extra[0], extra[1], intr, cfg, mcfg,
            initialization, lists)
    xs = leaves + extra
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    # the exposures do not enter an initialisation loss
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, xs)]
    return (loss.detach(), tuple(grads[:5]), grads[5], grads[6], grads[7],
            grads[8], radii.detach())


def _batch_render_grads(gauss: GaussianArrays, cams: CamBatch, T, ea, eb,
                        intr: Intrinsics, cfg: RenderConfig, mcfg: MapConfig,
                        initialization: bool, lists):
    """The unfused branch with ``batch_render`` (JAX ``_batch_loss``'s
    render_batch branch): the B views' lists in one list-blend call, the
    per-view mapping losses (zero for an invalid view) summed, and the
    gradients of the sum by autograd. Returns (g_leaves summed over the
    views, [(g_tau, g_off, g_ea, g_eb, radii)] per view)."""
    b, n, dev = T.shape[0], gauss.xyz.shape[0], gauss.xyz.device
    leaves = [x.detach().requires_grad_(True) for x in
              (gauss.xyz, gauss.sh, gauss.log_scale, gauss.quat,
               gauss.opa_logit)]
    extra = [torch.zeros((b, 6), device=dev).requires_grad_(True),
             torch.zeros((b, n, 2), device=dev).requires_grad_(True),
             ea.detach().requires_grad_(True),
             eb.detach().requires_grad_(True)]
    lists_b = TileLists(idx=torch.stack([x.idx for x in lists]),
                        vld=torch.stack([x.vld for x in lists]))
    with torch.enable_grad():
        image, depth, _, radii = render_batch(
            GaussianArrays(*leaves, active=gauss.active), T, intr, cfg,
            lists_b, taus=extra[0], means2d_offsets=extra[1])
        per_view = []
        for v in range(b):
            if mcfg.monocular:
                loss = losses.mapping_loss_rgb(
                    image[v], cams.gt_image[v], cams.mapping_mask[v],
                    extra[2][v], extra[3][v], initialization=initialization)
            else:
                loss = losses.mapping_loss_rgbd(
                    image[v], depth[v], cams.gt_image[v], cams.gt_depth[v],
                    cams.mapping_mask[v], extra[2][v], extra[3][v],
                    alpha=mcfg.alpha, initialization=initialization)
            per_view.append(torch.where(cams.valid[v], loss,
                                        torch.zeros_like(loss)))
        total = torch.stack(per_view).sum()
    xs = leaves + extra
    grads = torch.autograd.grad(total, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, xs)]
    radii = radii.detach()
    return grads[:5], [(grads[5][v], grads[6][v], grads[7][v], grads[8][v],
                        radii[v]) for v in range(b)]


def _io_batch_grads(gauss: GaussianArrays, cams: CamBatch, T, ea, eb,
                    intr: Intrinsics, cfg: RenderConfig, mcfg: MapConfig,
                    initialization: bool, lists, gt_tb, mask_tb, gtd_tb):
    """The fused branch with ``io_batch`` (JAX mapping.py:405-495): every
    view's preprocess and pack in one autograd graph ([B, N, F]), one flat
    gather of the raw rows at view offsets, the validity mask as ``madd``,
    one map_grad kernel per view on the raw rows, one flat fixed-order sum
    of the row cotangents (``scatter_sum``; an invalid view's zeroed) and
    one pull-back.
    Returns (g_leaves, [(g_tau, g_off, g_ea, g_eb, radii)] per view)."""
    b, n, dev = T.shape[0], gauss.xyz.shape[0], gauss.xyz.device
    leaves = [x.detach().requires_grad_(True) for x in
              (gauss.xyz, gauss.sh, gauss.log_scale, gauss.quat,
               gauss.opa_logit)]
    taus = torch.zeros((b, 6), device=dev).requires_grad_(True)
    offs = torch.zeros((b, n, 2), device=dev).requires_grad_(True)
    with torch.enable_grad():
        preps = [preprocess(leaves[0], leaves[2], leaves[3], leaves[4],
                            leaves[1], gauss.active,
                            se3.retract(T[v], taus[v]), intr,
                            sh_degree=cfg.sh_degree, near=cfg.near,
                            means2d_offset=offs[v]) for v in range(b)]
        packed_b = torch.stack([_pack(p) for p in preps])       # [B, N, F]
    valid_b = torch.stack([p.valid for p in preps])
    l_idx = torch.stack([x.idx for x in lists])                 # [B, Tf, Kf]
    l_vld = torch.stack([x.vld for x in lists])
    gidx = (l_idx.reshape(b, -1)
            + (torch.arange(b, device=dev) * n)[:, None]).reshape(-1)
    d0 = packed_b.detach().reshape(b * n, _F)[gidx].reshape(
        l_idx.shape + (_F,))
    vld_b = l_vld & valid_b.reshape(-1)[gidx].reshape(l_idx.shape)
    madd_b = torch.where(vld_b, 0.0, -1e30).to(torch.float32)
    outs = [map_grad_from_rows(
        d0[v], intr, cfg, gt_tb[v], mask_tb[v], ea[v], eb[v],
        initialization, mcfg.alpha,
        gtd_t=None if gtd_tb is None else gtd_tb[v], madd=madd_b[v])
        for v in range(b)]
    dd_b = (torch.stack([o[1] for o in outs])
            * cams.valid.to(torch.float32)[:, None, None, None])
    dpacked = scatter_sum(b * n, gidx, dd_b.reshape(-1, _F)).reshape(b, n,
                                                                     _F)
    grads = torch.autograd.grad(packed_b, leaves + [taus, offs],
                                grad_outputs=dpacked)
    return list(grads[:5]), [
        (grads[5][v], grads[6][v], outs[v][2], outs[v][3],
         preps[v].radius.detach()) for v in range(b)]


def _sort_lists(lists):
    """Per view, the frozen argsort of the flat list ids and the ids in
    that order (``scatter_segsum``; paid once per rebuild)."""
    out = []
    for x in lists:
        flat = x.idx.reshape(-1)
        perm = torch.argsort(flat, stable=True)
        out.append((perm, flat[perm]))
    return out


def _gauss_view(params: gm.ParamLeaves, active) -> GaussianArrays:
    """The render-facing view of map parameters (JAX ``_gauss_view``)."""
    return GaussianArrays(xyz=params.xyz, sh=params.sh,
                          log_scale=params.log_scale, quat=params.quat,
                          opa_logit=params.opa_logit, active=active)


def _build_lists(m: gm.GaussianMap, Ts, intr, cfg, margin):
    gauss = m.render_view()
    return [build_tile_lists(gauss, T, intr, cfg, margin=margin) for T in Ts]


def _rebin(m: gm.GaussianMap, Ts, intr, cfg, margin, use_segsum: bool):
    """The views' lists and, under ``scatter_segsum``, their argsorts."""
    with span("ba.rebin"):
        lists = _build_lists(m, Ts, intr, cfg, margin)
        return lists, (_sort_lists(lists) if use_segsum
                       else [None] * len(lists))


def map_iters(m: gm.GaussianMap, cams: CamBatch, n_iters: int, it_count: int,
              generator: Optional[torch.Generator], intr: Intrinsics,
              cfg: RenderConfig, mcfg: MapConfig, hyper: gm.MapHyper,
              kf_adam=None, initialization: bool = False, group=None,
              draws: Optional[MapDraws] = None) -> MapResult:
    """Run ``n_iters`` mapping iterations over the window ``cams``.

    Per iteration: every view's loss and gradient (map parameters, pose
    tangent, screen-space hook, exposure; fused or unfused, see the module
    docstring), the isotropic regulariser,
    the densification statistics, one map Adam step, densify / prune and
    the opacity reset on their schedule, the window pose/exposure Adam with
    retraction (not when ``initialization``), and a list rebuild when due
    (``bin_margin > 0``).
    ``kf_adam`` carries the window Adam state across calls. All tensors lie
    on one device; ``generator`` is a ``torch.Generator`` on it. ``group``:
    the view-sharded body (module docstring), ``cams`` the rank's views.

    While the profiler records, the call is span ``ba.call``, each
    iteration ``ba.iter`` (and one ``ba.iters`` count), with ``ba.rebin``
    (list builds), ``ba.prep`` (the views' render and gradient code outside
    ``render_map_grad``'s own spans), ``ba.map_adam``, ``ba.densify``
    (densify and prune, opacity resets) and ``ba.visibility`` inside
    (``utils/profiling.py``)."""
    with span("ba.call"):
        return _map_iters(m, cams, n_iters, it_count, generator, intr, cfg,
                          mcfg, hyper, kf_adam, initialization, group, draws)


def _map_iters(m, cams, n_iters, it_count, generator, intr, cfg, mcfg, hyper,
               kf_adam, initialization, group, draws) -> MapResult:
    _check_supported(cfg, mcfg, group)
    if group is not None:
        from ..parallel import comm
    draws = draws or MapDraws()
    dev = cams.T.device
    b = cams.T.shape[0]
    n = m.capacity
    cfg_iter = cfg._replace(with_n_touched=False)
    lr8 = torch.cat([torch.full((n_,), lr, device=dev) for n_, lr in (
        (3, mcfg.lr_trans), (3, mcfg.lr_rot), (1, mcfg.lr_exposure_a),
        (1, mcfg.lr_exposure_b))])
    opt_mask = torch.cat([cams.opt_pose[:, None].expand(b, 6),
                          cams.opt_exposure[:, None].expand(b, 2)], dim=-1)
    valid_f = cams.valid.to(torch.float32)
    use_lists = mcfg.bin_margin > 0
    fused = _fused(cfg, mcfg)
    io_batch = fused and mcfg.io_batch
    use_segsum = fused and mcfg.scatter_segsum and not io_batch
    batch = (not fused and use_lists and mcfg.batch_render
             and cfg.backend == "pallas_lists")

    def tiles(imgs):
        return [tile_images(im, intr, cfg_iter) for im in imgs]

    if fused:
        # the ground truth in tile space, once per call
        gt_tb, mask_tb = tiles(cams.gt_image), tiles(cams.mapping_mask)
        gtd_tb = None if mcfg.monocular else tiles(cams.gt_depth)
    tx0f, ty0f = _tile_origins(intr, cfg_iter, dev)
    n_fine = tx0f.shape[0]
    # tile subsets ride the plain fused branch only: the frozen
    # permutation and io_batch's flat gather index the full lists
    use_sub = (fused and mcfg.tile_frac < 1.0 and not mcfg.scatter_segsum
               and not mcfg.io_batch)
    # a multiple of 8 tiles, as the JAX package keeps it; it sets px_frac
    n_sub = max(8, int(n_fine * mcfg.tile_frac) // 8 * 8)
    px_frac = n_sub / n_fine if use_sub else 1.0

    lists, sortperm = [None] * b, [None] * b
    if use_lists:
        lists, sortperm = _rebin(m, cams.T, intr, cfg_iter, mcfg.bin_margin,
                                 use_segsum)
    kam, kav, kat = kf_adam if kf_adam is not None else new_kf_adam(b, dev)
    T, ea, eb = cams.T, cams.ea, cams.eb
    tau0 = torch.zeros(6, dtype=torch.float32, device=dev)
    off0 = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    itc, since = int(it_count), 0
    for i in range(n_iters):
        count("ba.iters")
        with span("ba.iter", i):
            itc += 1
            gauss = m.render_view()
            tsel_b = None
            if use_sub:
                tsel_b = _draw(draws.tsel, i)
                if tsel_b is None:
                    tsel_b = torch.stack([
                        torch.randperm(n_fine, generator=generator,
                                       device=dev)[:n_sub] for _ in range(b)])
                tsel_b = tsel_b.to(dev)

            g_leaves = None
            g_tau, g_ea, g_eb = [], [], []
            accum = torch.zeros(n, dtype=torch.float32, device=dev)
            denom = torch.zeros_like(accum)
            radii_d = torch.zeros_like(accum)
            visible_any = torch.zeros(n, dtype=torch.bool, device=dev)
            if io_batch:
                with span("ba.prep"):
                    g_leaves, per_view = _io_batch_grads(
                        gauss, cams, T, ea, eb, intr, cfg_iter, mcfg,
                        initialization, lists, gt_tb, mask_tb, gtd_tb)
            elif batch:
                with span("ba.prep"):
                    g_leaves, per_view = _batch_render_grads(
                        gauss, cams, T, ea, eb, intr, cfg_iter, mcfg,
                        initialization, lists)
            else:
                per_view = []
                for v in range(b):
                    if not fused:
                        with span("ba.prep"):
                            _, gl, gt_v, go_v, gea_v, geb_v, radii_v = (
                                _view_loss_grads(
                                    gauss, cams, v, T[v], ea[v], eb[v],
                                    intr, cfg_iter, mcfg, initialization,
                                    lists[v]))
                    else:
                        li, lv = lists[v].idx, lists[v].vld
                        gt_t, mask_t = gt_tb[v], mask_tb[v]
                        gtd_t = None if gtd_tb is None else gtd_tb[v]
                        txy = None
                        if use_sub:
                            ts = tsel_b[v]
                            li, lv = li[ts], lv[ts]
                            gt_t, mask_t = gt_t[ts], mask_t[ts]
                            if gtd_t is not None:
                                gtd_t = gtd_t[ts]
                            txy = (tx0f[ts], ty0f[ts])
                        _, gl, gt_v, go_v, gea_v, geb_v, radii_v = (
                            render_map_grad(
                                gauss, T[v], intr, cfg_iter,
                                TileLists(idx=li, vld=lv), gt_t, mask_t, tau0,
                                off0, ea[v], eb[v], initialization, mcfg.alpha,
                                gtd_t=gtd_t, sortperm=sortperm[v], txy=txy,
                                px_frac=px_frac,
                                gather_first=mcfg.gather_first))
                    gl = [g * valid_f[v] for g in gl]
                    g_leaves = gl if g_leaves is None else [
                        a + c for a, c in zip(g_leaves, gl)]
                    per_view.append((gt_v, go_v, gea_v, geb_v, radii_v))
            for v, (gt_v, go_v, gea_v, geb_v, radii_v) in enumerate(per_view):
                s = valid_f[v]
                g_tau.append(gt_v * s)
                g_ea.append(gea_v * s)
                g_eb.append(geb_v * s)
                # densification statistics (per-view screen-space gradient
                # norms of the visible Gaussians, summed over views)
                vis = (radii_v > 0) & cams.valid[v]
                norms = torch.linalg.norm(go_v * s, dim=-1)
                accum = accum + torch.where(vis, norms,
                                            torch.zeros_like(norms))
                denom = denom + vis.to(torch.float32)
                radii_d = torch.maximum(radii_d, torch.where(
                    vis, radii_v, torch.zeros_like(radii_v)))
                visible_any = visible_any | vis

            ls = m.params.log_scale.detach().requires_grad_(True)
            with torch.enable_grad():
                reg = mcfg.isotropic_weight * losses.isotropic_reg(
                    torch.exp(ls), m.active)
            (g_iso,) = torch.autograd.grad(reg, ls)
            g_leaves[2] = g_leaves[2] + g_iso
            if group is not None:
                # the JAX body's psum of the gradients and of the statistics,
                # in one collective; then the pmax
                *g_leaves, accum, denom = comm.all_reduce_flat_(
                    [*g_leaves, accum, denom], group)
                comm.all_reduce_(radii_d, group, "max")
            m = m._replace(grad_accum=m.grad_accum + accum,
                           denom=m.denom + denom,
                           max_radii2d=torch.maximum(m.max_radii2d, radii_d))
            with span("ba.map_adam"):
                m = gm.adam_step(m, gm.ParamLeaves(*g_leaves), hyper,
                                 step=itc - 1)

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
                with span("ba.densify"):
                    m = gm.densify_and_prune(
                        m, generator, mcfg.densify_grad_threshold, *dens,
                        hyper, clone_cap=mcfg.clone_cap,
                        split_cap=mcfg.split_cap,
                        samples=None if noise is None else noise.to(dev))
            if do_reset:
                with span("ba.densify"):
                    if not initialization and group is not None:
                        visible_any = comm.all_reduce_(
                            visible_any.to(torch.int32), group) > 0
                    m = (gm.reset_opacity(m) if initialization
                         else gm.reset_opacity_nonvisible(m, visible_any))

            if not initialization:
                g8 = torch.cat([torch.stack(g_tau), torch.stack(g_ea)[:, None],
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

            # rebuild when stale or when the Gaussian set changed (new slots
            # are in no list)
            since += 1
            if use_lists and (since >= mcfg.rebin_every or do_dens):
                lists, sortperm = _rebin(m, T, intr, cfg_iter,
                                         mcfg.bin_margin, use_segsum)
                since = 0

    # the final visibility pass, from the lists or binning anew
    with span("ba.visibility"):
        gauss = m.render_view()
        if not (use_lists and mcfg.vis_from_lists):
            lists = [None] * b
        visibility = torch.stack([
            (render(gauss, T[v], intr, cfg, lists=lists[v]).n_touched > 0)
            & cams.valid[v] for v in range(b)])
    return MapResult(m=m, cams=cams._replace(T=T, ea=ea, eb=eb),
                     it_count=itc, visibility=visibility,
                     kf_adam=(kam, kav, kat))


def covisibility_prune(m: gm.GaussianMap, visibility, window_kf_ids,
                       initialized: bool, mcfg: MapConfig,
                       prune_mode: str = "slam", prune_coviz: int = 3):
    """Occlusion-aware pruning of Gaussians seen by too few window views
    (monocular only, as the reference). Returns (map, n_obs)."""
    n_obs = torch.sum(visibility, dim=0).to(torch.int32)
    if prune_mode == "odometry":
        to_prune = n_obs < 3
    else:
        cutoff_id = torch.sort(window_kf_ids, descending=True).values[2]
        mask = (m.kf_id >= cutoff_id) if initialized else (m.kf_id >= 0)
        to_prune = (n_obs <= prune_coviz) & mask
    to_prune = to_prune & m.active
    m = m._replace(n_obs=torch.where(m.active, n_obs, torch.zeros_like(n_obs)))
    if mcfg.monocular:
        m = gm.prune(m, to_prune)
    return m, n_obs


def color_refinement_iters(m: gm.GaussianMap, cams: CamBatch, n_iters: int,
                           generator: Optional[torch.Generator],
                           intr: Intrinsics, cfg: RenderConfig,
                           mcfg: MapConfig, hyper: gm.MapHyper,
                           views=None) -> gm.GaussianMap:
    """Photometric refinement: per iteration one random staged view, loss
    (1 - lambda) L1 + lambda (1 - SSIM) against its raw ground truth (no
    exposure, no mask), gradients through the differentiable render (a
    VJP kernel of ``cfg.backend``), Adam on the map with the xyz schedule at
    the local iteration. With ``bin_margin > 0`` the staged views' lists
    are rebuilt every ``rebin_every`` iterations; without, every render
    bins its view. ``views`` [n_iters] replaces the view draws."""
    _check_backend(cfg)
    dev = cams.T.device
    cfg_iter = cfg._replace(with_n_touched=False)
    n_valid = torch.clamp(torch.sum(cams.valid.to(torch.int64)), min=1)
    lam = mcfg.lambda_dssim
    use_lists = mcfg.bin_margin > 0
    for i in range(n_iters):
        if use_lists and i % mcfg.rebin_every == 0:
            lists = _build_lists(m, cams.T, intr, cfg_iter, mcfg.bin_margin)
            l_idx = torch.stack([x.idx for x in lists])
            l_vld = torch.stack([x.vld for x in lists])
        if views is not None:
            vi = torch.as_tensor(views[i], device=dev).reshape(1)
        else:
            u = torch.rand((), generator=generator, device=dev)
            vi = torch.minimum((u * n_valid).long(), n_valid - 1).reshape(1)

        def pick(x):
            return x.index_select(0, vi)[0]

        leaves = [p.detach().requires_grad_(True) for p in m.params]
        with torch.enable_grad():
            gauss = GaussianArrays(*leaves, active=m.active)
            lists_v = (TileLists(idx=pick(l_idx), vld=pick(l_vld))
                       if use_lists else None)
            out = render(gauss, pick(cams.T), intr, cfg_iter, lists=lists_v)
            gt = pick(cams.gt_image)
            l1 = torch.mean(losses.abs_(out.image - gt))
            loss = (1.0 - lam) * l1 + lam * (1.0 - ssim_fn(out.image, gt))
        g = torch.autograd.grad(loss, leaves)
        m = gm.adam_step(m, gm.ParamLeaves(*g), hyper, step=i + 1)
    return m
