"""Camera tracking: first-order Adam + count-sketched Gauss-Newton/LM.

Counterpart of ``monogs_tpu/slam/tracking.py``, branch for branch:

- lists: with ``bin_margin > 0``, frozen margin tile lists built at the
  seed pose; with ``bin_margin == 0`` none, and every render bins the scene
  at its pose and blends through ``cfg.backend`` (the list kernels, the
  macro-list kernels or the XLA blend, see ``render``);
- first order (Adam over the 8-dim pose/exposure state): over a random
  tile subset of the lists (``fo_tile_frac < 1``) either one fused
  loss-and-gradient kernel per iteration (``fo_fused``, Huber,
  ``"pallas_lists"``: the shipped configuration,
  ``configs/mono/tum/base_config.yaml``, ``bench.py``) or the subset's
  loss through ``render_tiles`` and autograd; otherwise the full frame's
  loss through ``render`` and autograd;
- second order: on ``"pallas_lists"`` with lists the fast path, one
  primal-plus-six-tangents kernel per iteration over a tile subset, a
  fresh count sketch, a damped 8x8 solve, fine-stage refinement against
  frozen macro lists (``so_from_fo_aux``, ``rebin_so_iters``); otherwise
  the linearised path (``jax.linearize`` in the JAX package): the sketched
  full-frame residual and its eight tangents by ``torch.func.jvp`` under
  ``vmap``, four tangents at a time, over lists rebuilt at each
  iteration's pose (``rebin_so``) or frozen, or binned at the pose;
- the final n_touched render (``final_refine`` / ``final_reuse``),
  best-loss caching and plateau exits; mono and RGB-D.

Until the port had every branch, ``track_frame`` with the package defaults
(``RenderConfig()``, ``TrackConfig()``: backend "xla", ``bin_margin`` 0,
``fo_tile_frac`` 1) raised; it now runs the full-frame first order and the
linearised second order. Where the JAX package raises, the port raises
too: the linearised second order through a kernel's autograd Function
(``"pallas_lists"`` without lists, ``"pallas"`` / ``"pallas_compact"``
without lists), which has no forward-mode rule in either package.

PyTorch runs eagerly, so the two optimizer loops are Python loops over
device tensors that synchronize with the host once per iteration, to test
the exit condition; ``TrackResult.host_syncs`` counts them. (The JAX package
runs each frame as one program with ``lax.while_loop``s.)

Random draws come from a ``torch.Generator``: the first-order tile subset
(with lists and ``fo_tile_frac < 1``), then the second-order tile subset
(fast path with ``so_tile_frac < 1``), then one sketch per second-order
iteration. ``draws`` replaces them with given values, so a test can replay
another generator's stream.

``TrackConfig.stage`` truncates the frame for attribution
(``chip_smoke.py``'s ``diag_path``, as ``scripts/profile_track_fixed.py``
uses the JAX package's): "build" stops after the initial margin build,
"lists" after the first-order subset gathers and the ground-truth tiling,
"fo" after the first-order loop, "so_prep" after the second order's list
rebuild, "so" after the second-order loop, and "final_nc" runs everything
but the final render's counts kernel; "full" is the product. The early
stages return a ``TrackResult`` with zeroed images whose ``median_depth``
and ``last_l1`` hold a sum over the stage's outputs, read to the host: PyTorch
runs eagerly and eliminates no dead work, so the sum only marks the cut,
and that read is the one host sync the cut adds (``host_syncs`` counts it).
The sum over "build"'s lists is taken in int64, not int32 as the JAX
package's wraps; the value is finite and is not compared across packages.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..ops import losses, se3
from ..ops.sketch import apply_sketch, damped_lstsq, make_sketch, sketch_from_draw
from ..render.camera import Intrinsics
from ..render.renderer import (
    GaussianArrays, RenderConfig, TileLists, _check_backend, _tile_origins,
    build_tile_lists, refine_fine_lists, render, render_fo_grad_tiles,
    render_pose_jvp_tiles, render_tiles, tile_images,
)
from .frame import FrameData


class TrackConfig(NamedTuple):
    """Static tracking hyperparameters; same fields and defaults as the JAX
    package's TrackConfig (see there for each knob's rationale)."""

    monocular: bool = True
    alpha: float = 0.95
    use_huber: bool = True
    huber_delta: float = 0.01
    pnorm: float = 1.0
    fo_max_iter: int = 40
    so_max_iter: int = 10
    lr_trans: float = 0.001
    lr_rot: float = 0.003
    lr_exposure_a: float = 0.01
    lr_exposure_b: float = 0.01
    fo_converged: float = 1e-4
    stack_dim: int = 16
    sketch_dim: int = 64
    initial_lambda: float = 0.001
    max_lambda: float = 1e7
    min_lambda: float = 1e-6
    increase_factor: float = 5.0
    decrease_factor: float = 5.0
    so_converged: float = 1e-5
    use_first_order_best: bool = True
    use_best_loss: bool = True
    bin_margin: float = 0.0
    rebin_before_so: bool = True
    rebin_so: bool = True
    rebin_so_iters: int = 3
    fo_tile_frac: float = 1.0
    so_tile_frac: float = 1.0
    fo_fused: bool = True
    final_refine: bool = True
    so_from_fo_aux: bool = False
    final_reuse: bool = False
    fo_plateau_patience: int = 0
    fo_plateau_rtol: float = 1e-3
    fo_min_iter: int = 0
    so_plateau_patience: int = 0
    so_plateau_rtol: float = 1e-4
    stage: str = "full"


STAGES = ("build", "lists", "fo", "so_prep", "so", "final_nc", "full")


class TrackState(NamedTuple):
    i: int
    T: torch.Tensor
    ea: torch.Tensor
    eb: torch.Tensor
    adam_m: torch.Tensor
    adam_v: torch.Tensor
    adam_t: int
    lam: torch.Tensor
    prev_l1: torch.Tensor
    best_l1: torch.Tensor
    best_T: torch.Tensor
    best_ea: torch.Tensor
    best_eb: torch.Tensor
    converged: bool
    hist: list
    since_best: torch.Tensor


class TrackResult(NamedTuple):
    T: torch.Tensor
    ea: torch.Tensor
    eb: torch.Tensor
    image: torch.Tensor
    depth: torch.Tensor
    opacity: torch.Tensor
    n_touched: torch.Tensor
    median_depth: torch.Tensor
    last_l1: torch.Tensor
    fo_iters: int
    so_iters: int
    fo_losses: torch.Tensor   # [fo_max_iter] per-iteration L1 (NaN past fo_iters)
    so_losses: torch.Tensor   # [so_max_iter] per-iteration L1 (NaN past so_iters)
    host_syncs: int           # device-to-host synchronizations in this frame


class TrackDraws(NamedTuple):
    """Injected random draws (each None/empty = draw from the generator)."""

    fo_tsel: Optional[torch.Tensor] = None   # [n_sub] first-order tiles
    so_tsel: Optional[torch.Tensor] = None   # [n_sub_so] second-order tiles
    sketches: Sequence = ()                  # per so iteration: (perm, signs)


def _fast_so(cfg: RenderConfig, tcfg: TrackConfig) -> bool:
    """Whether the second order takes the fused jvp8 path
    (tracking.py:597-600); otherwise it linearises the render."""
    return cfg.backend == "pallas_lists" and tcfg.bin_margin > 0


def _check_supported(cfg: RenderConfig, tcfg: TrackConfig):
    _check_backend(cfg)
    if tcfg.stage not in STAGES:
        raise ValueError(f"stage={tcfg.stage!r}: not one of {STAGES}")
    # the linearised second order pushes tangents through the render; on
    # these backends without frozen lists the render blends through a
    # kernel's autograd Function, which has no forward-mode rule (the JAX
    # package's custom_vjp has none either: jax.linearize raises there)
    if (tcfg.so_max_iter > 0 and tcfg.bin_margin <= 0
            and cfg.backend != "xla"):
        raise TypeError(
            f"backend={cfg.backend!r} with bin_margin == 0 and "
            "so_max_iter > 0: the linearised second order would push "
            "tangents through the blend kernel's autograd Function, which "
            "has no forward-mode (JVP) rule; the JAX package fails here too "
            "(jax.linearize of a custom_vjp). Use bin_margin > 0, backend "
            "'xla', or so_max_iter 0")


def _p0(ea, eb):
    """The 8-dim state (tau = 0, ea, eb) the unfused paths differentiate."""
    return torch.cat([torch.zeros(6, dtype=ea.dtype, device=ea.device),
                      ea.reshape(1), eb.reshape(1)])


def _residual(gauss, frame: FrameData, T, p8, intr, cfg, tcfg: TrackConfig,
              lists=None):
    """Per-pixel residual images at pose Exp(p8[:6]) T: the opacity-weighted
    masked exposure residual [3, H, W] and, for RGB-D, the masked depth
    residual [1, H, W] (None for mono)."""
    out = render(gauss, T, intr, cfg, tau=p8[:6], lists=lists)
    r_rgb = losses.tracking_residual_rgb(out.image, frame.gt_image,
                                         out.opacity, frame.mapping_mask,
                                         p8[6], p8[7])
    if tcfg.monocular:
        return r_rgb, None
    depth_mask = (frame.gt_depth > 0.01) & (out.opacity > 0.95)
    r_depth = torch.where(depth_mask, out.depth - frame.gt_depth,
                          torch.zeros_like(out.depth))
    return r_rgb, r_depth


def _objective(r, r_d, tcfg: TrackConfig):
    """The first-order objective of residual r (and depth residual r_d):
    the norm of the signed-Huber residual (or the p-norm), mixed with the
    depth term's norm for RGB-D (slam_utils.py:103-113)."""
    if tcfg.use_huber:
        loss = torch.sqrt(torch.sum(r * r) + 1e-20)
    else:
        loss = torch.sum(losses.abs_(r) ** tcfg.pnorm) ** (1.0 / tcfg.pnorm)
    if r_d is not None:
        loss = tcfg.alpha * loss + (1 - tcfg.alpha) * torch.sqrt(
            torch.sum(r_d * r_d) * (r.numel() / r_d.numel()) + 1e-20)
    return loss


def _fo_loss(gauss, frame, T, p8, intr, cfg, tcfg: TrackConfig, lists=None):
    """First-order objective over the full frame (slam_frontend.py:596-600)
    and the L1 of its (signed-Huber) residual."""
    r_rgb, r_depth = _residual(gauss, frame, T, p8, intr, cfg, tcfg, lists)
    if tcfg.use_huber:
        r_rgb = losses.huber_signed(r_rgb, tcfg.huber_delta)
    return _objective(r_rgb, r_depth, tcfg), torch.sum(torch.abs(r_rgb))


def _fo_loss_tiles(gauss, T, p8, intr, cfg, tcfg: TrackConfig, lists_sub,
                   tx0s, ty0s, gt_t, mask_t, gtd_t, scale):
    """First-order objective over a tile subset (``render_tiles``, zero
    background) and its L1 scaled by ``scale`` (n_fine / n_sub)."""
    col, dep, acc = render_tiles(gauss, T, intr, cfg, lists_sub, tx0s, ty0s,
                                 tau=p8[:6])
    e = torch.abs(p8[6]) + losses.EXPOSURE_EPS
    r = acc[..., None] * mask_t * ((e * col + p8[7]) - gt_t)
    l1 = torch.sum(torch.abs(r)) * scale
    if tcfg.use_huber:
        r = losses.huber_signed(r, tcfg.huber_delta)
    r_d = None
    if not tcfg.monocular:
        depth_mask = (gtd_t > 0.01) & (acc[..., None] > 0.95)
        r_d = torch.where(depth_mask, dep[..., None] - gtd_t,
                          torch.zeros_like(gtd_t))
    return _objective(r, r_d, tcfg), l1


def _sketched_Sf(gauss, frame, T, p8, sketch, intr, cfg, tcfg, lists):
    """The bucketed residual sums Sf(p8) (slam_frontend.py:637-649) and the
    raw L1, from one render."""
    r_rgb, r_depth = _residual(gauss, frame, T, p8, intr, cfg, tcfg, lists)
    l1 = torch.sum(torch.abs(r_rgb))
    if tcfg.use_huber:
        r_rgb = losses.huber_signed(r_rgb, tcfg.huber_delta)
        if r_depth is not None:
            r_depth = losses.huber_signed(r_depth, tcfg.huber_delta)
    r2 = torch.sum(r_rgb, dim=0)
    if r_depth is not None:
        r2 = tcfg.alpha * r2 + (1 - tcfg.alpha) * r_depth[0]
    r2 = r2 * (sketch.d / r2.numel())
    return apply_sketch(r2.reshape(-1), sketch), l1


def _so_linearized_step(gauss, frame, T, ea, eb, sketch, intr, cfg, tcfg,
                        lists):
    """(Sf, SJ, l1) by forward mode (JAX: jax.linearize, then the 8 tangents
    by lax.map in batches of 4): ``torch.func.jvp`` of the sketched residual
    under ``vmap`` over 4 of the 8 basis tangents at a time, which bounds
    the blend's transient memory at 4 tangents. Without ``lists`` the
    scene is binned at the pose first (what the render would do; the lists
    carry no tangent)."""
    p = _p0(ea, eb)
    if lists is None:
        lists = build_tile_lists(gauss, T, intr, cfg, tau=p[:6])
    eye = torch.eye(8, dtype=p.dtype, device=p.device)

    def sf(q):
        return _sketched_Sf(gauss, frame, T, q, sketch, intr, cfg, tcfg,
                            lists)

    # forward mode records no graph: under no_grad the XLA blend runs
    # without its reverse-mode checkpoint
    cols = []
    with torch.no_grad():
        for k in (0, 4):
            (Sf, l1), (t_sf, _) = torch.func.vmap(
                lambda e: torch.func.jvp(sf, (p,), (e,)))(eye[k:k + 4])
            cols.append(t_sf)
    return Sf[0], torch.cat(cols).T, l1[0]


def _huber_chain(r, delta):
    """(hub, slope): signed sqrt-Huber value and its elementwise d/dr."""
    ax = torch.abs(r)
    safe = torch.sqrt(torch.clamp(2.0 * delta * ax - delta * delta,
                                  min=1e-20))
    small = ax < delta
    hub = torch.where(small, r, torch.sign(r) * safe)
    slope = torch.where(small, torch.ones_like(r), delta / safe)
    return hub, slope


def _so_fast_step(gauss, gt_t, mask_t, T, ea, eb, sketch, intr, cfg, tcfg,
                  lists_sub, txs, tys, scale=1.0, gtd_t=None):
    """(Sf, SJ, l1) from one primal-plus-six-tangents blend over the tile
    subset: the exposure columns are chained analytically, the sketch is
    drawn over the subset's pixels, and l1 is scaled by ``scale``."""
    outs, touts = render_pose_jvp_tiles(gauss, T, intr, cfg, lists_sub,
                                        txs, tys)
    img = outs[..., :3]                                  # [S, P, 3]
    opa = outs[..., 4:5]                                 # [S, P, 1]
    e = torch.abs(ea) + losses.EXPOSURE_EPS
    diff = (e * img + eb) - gt_t
    r = opa * mask_t * diff
    l1 = torch.sum(torch.abs(r)) * scale
    if tcfg.use_huber:
        hub, slope = _huber_chain(r, tcfg.huber_delta)
    else:
        hub, slope = r, torch.ones_like(r)
    d_over_m = sketch.d / (sketch.d * sketch.chunk)

    img_t = touts[..., :3]                               # [S, 6, P, 3]
    opa_t = touts[..., 4:5]
    pose_cols = mask_t[:, None] * (opa_t * diff[:, None]
                                   + (opa * e)[:, None] * img_t)
    col_sums = torch.cat([
        torch.sum(slope[:, None] * pose_cols, dim=-1),                # 6
        torch.sum(slope * (opa * mask_t * img * torch.sign(ea)), -1)[:, None],
        torch.sum(slope * (opa * mask_t).expand_as(r), -1)[:, None],
    ], dim=1)                                            # [S, 8, P]
    r2 = torch.sum(hub, dim=-1)                          # [S, P]
    if gtd_t is not None:
        dep, dep_t = outs[..., 3:4], touts[..., 3]       # [S,P,1], [S,6,P]
        depth_mask = (gtd_t > 0.01) & (opa > 0.95)
        r_d = torch.where(depth_mask, dep - gtd_t, torch.zeros_like(dep))
        if tcfg.use_huber:
            hub_d, slope_d = _huber_chain(r_d, tcfg.huber_delta)
        else:
            hub_d, slope_d = r_d, torch.ones_like(r_d)
        a = tcfg.alpha
        r2 = a * r2 + (1 - a) * hub_d[..., 0]
        dms = torch.where(depth_mask, slope_d, torch.zeros_like(slope_d))
        col_sums = torch.cat([
            a * col_sums[:, :6] + (1 - a) * dms[:, None, :, 0] * dep_t,
            a * col_sums[:, 6:],
        ], dim=1)
    Sf = apply_sketch((r2 * d_over_m).reshape(-1), sketch)
    SJ = apply_sketch(
        (col_sums * d_over_m).permute(1, 0, 2).reshape(8, -1), sketch).T
    return Sf, SJ, l1


def _nan_padded(hist, n, device):
    out = torch.full((n,), float("nan"), dtype=torch.float32, device=device)
    if hist:
        out[:len(hist)] = torch.stack(hist)
    return out


def track_frame(gauss: GaussianArrays, frame: FrameData, T_init, ea_init,
                eb_init, generator: Optional[torch.Generator],
                intr: Intrinsics, cfg: RenderConfig, tcfg: TrackConfig,
                draws: Optional[TrackDraws] = None) -> TrackResult:
    """Track one frame from ``T_init`` against a fixed map.

    All tensors lie on one device (the card, or the CPU where the kernels'
    plain versions run); ``generator`` is a ``torch.Generator`` on that
    device, used for every draw ``draws`` does not supply."""
    _check_supported(cfg, tcfg)
    dev = T_init.device
    draws = draws or TrackDraws()
    syncs = 0

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    ea_init, eb_init = f32(ea_init), f32(eb_init)
    lr8 = f32([tcfg.lr_trans] * 3 + [tcfg.lr_rot] * 3
              + [tcfg.lr_exposure_a, tcfg.lr_exposure_b])
    big = f32(float("inf"))
    zero6 = torch.zeros(6, dtype=torch.float32, device=dev)
    cfg_track = cfg._replace(with_n_touched=False)
    p_pix = cfg.tile * cfg.tile

    def randperm(n):
        return torch.randperm(n, generator=generator, device=dev)

    def cut(live, T_, ea_, eb_, fo_it, so_it, fo_h, so_h):
        """A truncated stage's result (``TrackConfig.stage``): zeroed
        images, ``live`` (a sum over the stage's outputs) read to the host
        as the median depth and the last L1."""
        live = f32(float(live))
        z1 = torch.zeros((1, intr.height, intr.width), device=dev)
        return TrackResult(
            T=T_, ea=ea_, eb=eb_,
            image=torch.zeros((3, intr.height, intr.width), device=dev),
            depth=z1, opacity=z1.clone(),
            n_touched=torch.zeros((gauss.xyz.shape[0],), dtype=torch.int32,
                                  device=dev),
            median_depth=live, last_l1=live, fo_iters=fo_it, so_iters=so_it,
            fo_losses=fo_h, so_losses=so_h, host_syncs=syncs + 1)

    def list_sum(lists, aux):
        if lists is None:
            return f32(0.0)
        live = torch.sum(lists.idx).to(torch.float32)
        if aux is not None:
            live = live + torch.sum(aux.sel_m).to(torch.float32)
        return live

    no_fo = _nan_padded([], tcfg.fo_max_iter, dev)
    no_so = torch.zeros((0,), dtype=torch.float32, device=dev)
    use_lists = tcfg.bin_margin > 0
    lists_fo = fo_aux = None
    if use_lists:
        lists_fo, fo_aux = build_tile_lists(
            gauss, T_init, intr, cfg_track, margin=tcfg.bin_margin,
            with_aux=True)
    if tcfg.stage == "build":
        return cut(list_sum(lists_fo, fo_aux), T_init, ea_init, eb_init, 0,
                   0, no_fo, no_so)
    tx0f, ty0f = _tile_origins(intr, cfg_track, dev)
    n_fine = tx0f.shape[0]
    fast_so = _fast_so(cfg, tcfg)
    gt_all = tile_images(frame.gt_image, intr, cfg_track)
    mask_all = tile_images(frame.mapping_mask, intr, cfg_track)
    gtd_all = (None if tcfg.monocular
               else tile_images(frame.gt_depth, intr, cfg_track))

    def subset(tsel):
        return (TileLists(idx=lists_fo.idx[tsel], vld=lists_fo.vld[tsel]),
                tx0f[tsel], ty0f[tsel], gt_all[tsel], mask_all[tsel],
                None if gtd_all is None else gtd_all[tsel])

    # ---------------- phase 1: first-order Adam -------------------------
    s = TrackState(
        i=0, T=T_init, ea=ea_init, eb=eb_init,
        adam_m=torch.zeros(8, device=dev), adam_v=torch.zeros(8, device=dev),
        adam_t=0, lam=f32(tcfg.initial_lambda), prev_l1=big, best_l1=big,
        best_T=T_init, best_ea=ea_init, best_eb=eb_init, converged=False,
        hist=[], since_best=torch.zeros((), dtype=torch.int64, device=dev))
    fo_sub = use_lists and tcfg.fo_tile_frac < 1.0 and tcfg.fo_max_iter > 0
    # the fused loss-and-gradient kernel: Huber on the list subset path
    fo_fused = (fo_sub and tcfg.fo_fused and tcfg.use_huber
                and cfg.backend == "pallas_lists")
    if fo_sub:
        n_sub = max(8, int(n_fine * tcfg.fo_tile_frac) // 8 * 8)
        tsel = (draws.fo_tsel.to(dev) if draws.fo_tsel is not None
                else randperm(n_fine)[:n_sub])
        lists_sub, tx0s, ty0s, gt_t, mask_t, gtd_t = subset(tsel)
        sub_scale = n_fine / n_sub
    if tcfg.stage == "lists":
        live = list_sum(lists_fo, None)
        if fo_sub:
            live = (live + torch.sum(gt_t)
                    + torch.sum(lists_sub.idx).to(torch.float32)
                    + torch.sum(tx0s))
        return cut(live, T_init, ea_init, eb_init, 0, 0, no_fo, no_so)

    def fo_grad(s: TrackState):
        """(l1, g8) of the first-order objective at s."""
        if fo_fused:
            _, l1, g = render_fo_grad_tiles(
                gauss, s.T, intr, cfg_track, lists_sub, tx0s, ty0s, zero6,
                s.ea, s.eb, gt_t, mask_t, tcfg.use_huber, tcfg.huber_delta,
                gtd_t=gtd_t, alpha=tcfg.alpha)
            return l1 * sub_scale, g
        p8 = _p0(s.ea, s.eb).requires_grad_(True)
        with torch.enable_grad():
            if fo_sub:
                loss, l1 = _fo_loss_tiles(
                    gauss, s.T, p8, intr, cfg_track, tcfg, lists_sub, tx0s,
                    ty0s, gt_t, mask_t, gtd_t, sub_scale)
            else:
                loss, l1 = _fo_loss(gauss, frame, s.T, p8, intr, cfg_track,
                                    tcfg, lists_fo)
        (g,) = torch.autograd.grad(loss, p8)
        return l1.detach(), g

    while s.i < tcfg.fo_max_iter and not s.converged:
        l1, g = fo_grad(s)
        better = l1 < s.best_l1
        t = s.adam_t + 1
        m = 0.9 * s.adam_m + 0.1 * g
        v = 0.999 * s.adam_v + 0.001 * g * g
        mh = m / (1 - 0.9 ** t)
        vh = v / (1 - 0.999 ** t)
        d = -lr8 * mh / (torch.sqrt(vh) + 1e-8)
        converged = torch.sum(d[:6] * d[:6]) < tcfg.fo_converged ** 2
        since_best = s.since_best
        if tcfg.fo_plateau_patience > 0:
            sig = l1 < s.best_l1 * (1.0 - tcfg.fo_plateau_rtol)
            since_best = torch.where(sig, 0, s.since_best + 1)
            if s.i + 1 >= tcfg.fo_min_iter:
                converged = converged | (
                    since_best >= tcfg.fo_plateau_patience)
        s = s._replace(
            i=s.i + 1, T=se3.retract(s.T, d[:6]), ea=s.ea + d[6],
            eb=s.eb + d[7], adam_m=m, adam_v=v, adam_t=t, prev_l1=l1,
            best_l1=torch.where(better, l1, s.best_l1),
            best_T=torch.where(better, s.T, s.best_T),
            best_ea=torch.where(better, s.ea, s.best_ea),
            best_eb=torch.where(better, s.eb, s.best_eb),
            hist=s.hist + [l1], since_best=since_best,
            converged=bool(converged))
        syncs += 1
    fo_iters = s.i
    fo_losses = _nan_padded(s.hist, tcfg.fo_max_iter, dev)
    if tcfg.stage == "fo":
        return cut(s.best_l1 + torch.sum(s.T), s.T, s.ea, s.eb, fo_iters, 0,
                   fo_losses, no_so)

    # ---------------- phase 2: sketched Gauss-Newton / LM ----------------
    so_aux = None
    if tcfg.so_max_iter > 0:
        if tcfg.use_first_order_best:
            s = s._replace(T=s.best_T, ea=s.best_ea, eb=s.best_eb)
        if use_lists and tcfg.so_from_fo_aux:
            lists_so, so_aux = lists_fo, fo_aux
        elif use_lists and tcfg.rebin_before_so:
            lists_so, so_aux = build_tile_lists(
                gauss, s.T, intr, cfg_track, margin=tcfg.bin_margin,
                with_aux=True)
        else:
            lists_so = lists_fo
        if tcfg.stage == "so_prep":
            return cut(list_sum(lists_so, so_aux) + s.best_l1, s.T, s.ea,
                       s.eb, fo_iters, 0, fo_losses, no_so)
        if not fast_so:
            m_sketch = frame.gt_image.shape[1] * frame.gt_image.shape[2]
        else:
            if tcfg.so_tile_frac < 1.0:
                n_sub_so = max(8, int(n_fine * tcfg.so_tile_frac) // 8 * 8)
                so_tsel = (draws.so_tsel.to(dev) if draws.so_tsel is not None
                           else randperm(n_fine)[:n_sub_so])
                so_scale = n_fine / n_sub_so
            else:
                n_sub_so = n_fine
                so_tsel = torch.arange(n_fine, device=dev)
                so_scale = 1.0
            so_txs, so_tys = tx0f[so_tsel], ty0f[so_tsel]
            gt_t_so, mask_t_so = gt_all[so_tsel], mask_all[so_tsel]
            gtd_t_so = None if gtd_all is None else gtd_all[so_tsel]
            m_sketch = n_sub_so * p_pix

        def refine_at(T):
            return refine_fine_lists(gauss, T, intr, cfg_track, so_aux,
                                     so_tsel)

        def so_step(s: TrackState, lists_it: Optional[TileLists]
                    ) -> TrackState:
            if s.i < len(draws.sketches):
                perm, signs = draws.sketches[s.i]
                sketch = sketch_from_draw(perm.to(dev), signs.to(dev),
                                          m_sketch, tcfg.stack_dim,
                                          tcfg.sketch_dim)
            else:
                sketch = make_sketch(generator, m_sketch, tcfg.stack_dim,
                                     tcfg.sketch_dim, device=dev)
            if fast_so:
                Sf, SJ, l1 = _so_fast_step(
                    gauss, gt_t_so, mask_t_so, s.T, s.ea, s.eb, sketch,
                    intr, cfg_track, tcfg, lists_it, so_txs, so_tys,
                    scale=so_scale, gtd_t=gtd_t_so)
            else:
                if use_lists and tcfg.rebin_so:
                    lists_it = build_tile_lists(gauss, s.T, intr, cfg_track)
                Sf, SJ, l1 = _so_linearized_step(
                    gauss, frame, s.T, s.ea, s.eb, sketch, intr, cfg_track,
                    tcfg, lists_it)
            lam = torch.where(
                l1 < s.prev_l1,
                torch.clamp(s.lam / tcfg.decrease_factor,
                            min=tcfg.min_lambda),
                torch.clamp(s.lam * tcfg.increase_factor,
                            max=tcfg.max_lambda))
            better = l1 < s.best_l1
            x = damped_lstsq(SJ, Sf, lam)
            converged = torch.linalg.norm(x) < tcfg.so_converged
            since_best = s.since_best
            if tcfg.so_plateau_patience > 0:
                sig = l1 < s.best_l1 * (1.0 - tcfg.so_plateau_rtol)
                since_best = torch.where(sig, 0, s.since_best + 1)
                converged = converged | (
                    since_best >= tcfg.so_plateau_patience)
            return s._replace(
                i=s.i + 1, T=se3.retract(s.T, x[:6]), ea=s.ea + x[6],
                eb=s.eb + x[7], lam=lam, prev_l1=l1,
                best_l1=torch.where(better, l1, s.best_l1),
                best_T=torch.where(better, s.T, s.best_T),
                best_ea=torch.where(better, s.ea, s.best_ea),
                best_eb=torch.where(better, s.eb, s.best_eb),
                hist=s.hist + [l1], since_best=since_best,
                converged=bool(converged))

        s = s._replace(i=0, prev_l1=big, converged=False, hist=[],
                       since_best=torch.zeros_like(s.since_best))
        can_refine = fast_so and tcfg.rebin_so and so_aux is not None
        if can_refine and tcfg.rebin_so_iters > 0:
            k_rebin = min(tcfg.rebin_so_iters, tcfg.so_max_iter)
            while s.i < k_rebin and not s.converged:
                s = so_step(s, refine_at(s.T))
                syncs += 1
            lists_fixed = refine_at(s.T)
            while s.i < tcfg.so_max_iter and not s.converged:
                s = so_step(s, lists_fixed)
                syncs += 1
        else:
            frozen = lists_so
            if fast_so and not can_refine:
                frozen = TileLists(idx=lists_so.idx[so_tsel],
                                   vld=lists_so.vld[so_tsel])
            while s.i < tcfg.so_max_iter and not s.converged:
                s = so_step(s, refine_at(s.T) if can_refine else frozen)
                syncs += 1
        so_iters = s.i
        so_losses = _nan_padded(s.hist, tcfg.so_max_iter, dev)
    else:
        so_iters = 0
        so_losses = no_so
    if tcfg.stage == "so":
        return cut(s.best_l1 + torch.sum(s.T), s.T, s.ea, s.eb, fo_iters,
                   so_iters, fo_losses, so_losses)

    if tcfg.use_best_loss:
        T, ea, eb, last_l1 = s.best_T, s.best_ea, s.best_eb, s.best_l1
    else:
        T, ea, eb, last_l1 = s.T, s.ea, s.eb, s.prev_l1

    # final render with n_touched (keyframing / visibility) and the median
    # depth, from frozen or refined margin lists where the config allows
    final_lists = None
    if tcfg.final_reuse and use_lists and tcfg.so_max_iter > 0:
        final_lists = lists_so
    elif (tcfg.final_refine and tcfg.so_max_iter > 0 and fast_so
          and so_aux is not None):
        final_lists = refine_fine_lists(gauss, T, intr, cfg_track, so_aux,
                                        torch.arange(n_fine, device=dev))
    cfg_final = (cfg._replace(with_n_touched=False)
                 if tcfg.stage == "final_nc" else cfg)
    out = render(gauss, T, intr, cfg_final, lists=final_lists)
    return TrackResult(
        T=T, ea=ea, eb=eb, image=out.image, depth=out.depth,
        opacity=out.opacity, n_touched=out.n_touched,
        median_depth=losses.get_median_depth(out.depth, out.opacity),
        last_l1=last_l1, fo_iters=fo_iters, so_iters=so_iters,
        fo_losses=fo_losses, so_losses=so_losses, host_syncs=syncs)
