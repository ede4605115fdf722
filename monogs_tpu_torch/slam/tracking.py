"""Camera tracking: fused first-order Adam + count-sketched Gauss-Newton/LM.

Counterpart of ``monogs_tpu/slam/tracking.py`` for the branch the shipped
configuration takes (``configs/mono/tum/base_config.yaml``,
``bench.py``):

- frozen margin tile lists (``bin_margin > 0``) over a random tile subset
  (``fo_tile_frac < 1``), one fused loss-and-gradient kernel per
  first-order iteration (``fo_fused``);
- the fast second-order path: one primal-plus-six-tangents kernel per
  iteration over a tile subset, a fresh count sketch, a damped 8x8 solve,
  fine-stage refinement against frozen macro lists (``so_from_fo_aux``,
  ``rebin_so_iters``), and the final n_touched render (``final_refine`` /
  ``final_reuse``);
- best-loss caching and plateau exits; mono and RGB-D.

PyTorch runs eagerly, so the two optimizer loops are Python loops over
device tensors that synchronize with the host once per iteration, to test
the exit condition; ``TrackResult.host_syncs`` counts them. (The JAX package
runs each frame as one program with ``lax.while_loop``s.)

Random draws come from a ``torch.Generator``: the first-order tile subset,
then the second-order tile subset, then one sketch per second-order
iteration. ``draws`` replaces them with given values, so a test can replay
another generator's stream.

The other branches raise ``NotImplementedError`` and name the slice that
brings them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..ops import losses, se3
from ..ops.sketch import apply_sketch, damped_lstsq, make_sketch, sketch_from_draw
from ..render.camera import Intrinsics
from ..render.renderer import (
    GaussianArrays, RenderConfig, TileLists, _tile_origins, build_tile_lists,
    refine_fine_lists, render, render_fo_grad_tiles, render_pose_jvp_tiles,
    tile_images,
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


def _check_supported(cfg: RenderConfig, tcfg: TrackConfig):
    if tcfg.stage != "full":
        raise NotImplementedError(
            f"stage={tcfg.stage!r}: the attribution-only truncated frame "
            "programs are not ported (profiling slice)")
    if cfg.backend != "pallas_lists":
        raise NotImplementedError(
            f"backend={cfg.backend!r}: tracking is ported for the list blend "
            "only. On the other backends the JAX package's frame takes its "
            "unfused branches (the XLA blend over frozen lists; without "
            "lists, a second-order phase by jax.linearize), which arrive "
            "with the tracking A/B-knobs slice")
    if tcfg.bin_margin <= 0:
        raise NotImplementedError(
            "bin_margin == 0 (per-iteration rebinning through the "
            "differentiable blend) arrives with the tracking A/B-knobs slice")
    if tcfg.fo_max_iter > 0 and not (
            tcfg.fo_tile_frac < 1.0 and tcfg.fo_fused and tcfg.use_huber):
        raise NotImplementedError(
            "the unfused first-order path (fo_tile_frac == 1, fo_fused "
            "False or use_huber False) differentiates through the blend and "
            "arrives with the tracking A/B-knobs slice")


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

    if tcfg.so_from_fo_aux:
        lists_fo, fo_aux = build_tile_lists(
            gauss, T_init, intr, cfg_track, margin=tcfg.bin_margin,
            with_aux=True)
    else:
        lists_fo, fo_aux = build_tile_lists(
            gauss, T_init, intr, cfg_track, margin=tcfg.bin_margin), None
    tx0f, ty0f = _tile_origins(intr, cfg_track, dev)
    n_fine = tx0f.shape[0]
    gt_all = tile_images(frame.gt_image, intr, cfg_track)
    mask_all = tile_images(frame.mapping_mask, intr, cfg_track)
    gtd_all = (None if tcfg.monocular
               else tile_images(frame.gt_depth, intr, cfg_track))

    def subset(tsel):
        return (TileLists(idx=lists_fo.idx[tsel], vld=lists_fo.vld[tsel]),
                tx0f[tsel], ty0f[tsel], gt_all[tsel], mask_all[tsel],
                None if gtd_all is None else gtd_all[tsel])

    # ---------------- phase 1: first-order Adam (fused kernel) ----------
    s = TrackState(
        i=0, T=T_init, ea=ea_init, eb=eb_init,
        adam_m=torch.zeros(8, device=dev), adam_v=torch.zeros(8, device=dev),
        adam_t=0, lam=f32(tcfg.initial_lambda), prev_l1=big, best_l1=big,
        best_T=T_init, best_ea=ea_init, best_eb=eb_init, converged=False,
        hist=[], since_best=torch.zeros((), dtype=torch.int64, device=dev))
    if tcfg.fo_max_iter > 0:
        n_sub = max(8, int(n_fine * tcfg.fo_tile_frac) // 8 * 8)
        tsel = (draws.fo_tsel.to(dev) if draws.fo_tsel is not None
                else randperm(n_fine)[:n_sub])
        lists_sub, tx0s, ty0s, gt_t, mask_t, gtd_t = subset(tsel)
        sub_scale = n_fine / n_sub
    while s.i < tcfg.fo_max_iter and not s.converged:
        _, l1, g = render_fo_grad_tiles(
            gauss, s.T, intr, cfg_track, lists_sub, tx0s, ty0s, zero6,
            s.ea, s.eb, gt_t, mask_t, tcfg.use_huber, tcfg.huber_delta,
            gtd_t=gtd_t, alpha=tcfg.alpha)
        l1 = l1 * sub_scale
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

    # ---------------- phase 2: sketched Gauss-Newton / LM ----------------
    so_aux = None
    if tcfg.so_max_iter > 0:
        if tcfg.use_first_order_best:
            s = s._replace(T=s.best_T, ea=s.best_ea, eb=s.best_eb)
        if tcfg.so_from_fo_aux and fo_aux is not None:
            lists_so, so_aux = lists_fo, fo_aux
        elif tcfg.rebin_before_so:
            lists_so, so_aux = build_tile_lists(
                gauss, s.T, intr, cfg_track, margin=tcfg.bin_margin,
                with_aux=True)
        else:
            lists_so = lists_fo
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

        def so_step(s: TrackState, lists_it: TileLists) -> TrackState:
            if s.i < len(draws.sketches):
                perm, signs = draws.sketches[s.i]
                sketch = sketch_from_draw(perm.to(dev), signs.to(dev),
                                          m_sketch, tcfg.stack_dim,
                                          tcfg.sketch_dim)
            else:
                sketch = make_sketch(generator, m_sketch, tcfg.stack_dim,
                                     tcfg.sketch_dim, device=dev)
            Sf, SJ, l1 = _so_fast_step(
                gauss, gt_t_so, mask_t_so, s.T, s.ea, s.eb, sketch, intr,
                cfg_track, tcfg, lists_it, so_txs, so_tys, scale=so_scale,
                gtd_t=gtd_t_so)
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
        can_refine = tcfg.rebin_so and so_aux is not None
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
            frozen = (None if can_refine else TileLists(
                idx=lists_so.idx[so_tsel], vld=lists_so.vld[so_tsel]))
            while s.i < tcfg.so_max_iter and not s.converged:
                s = so_step(s, frozen if frozen is not None
                            else refine_at(s.T))
                syncs += 1
        so_iters = s.i
        so_losses = _nan_padded(s.hist, tcfg.so_max_iter, dev)
    else:
        so_iters = 0
        so_losses = torch.zeros((0,), dtype=torch.float32, device=dev)

    if tcfg.use_best_loss:
        T, ea, eb, last_l1 = s.best_T, s.best_ea, s.best_eb, s.best_l1
    else:
        T, ea, eb, last_l1 = s.T, s.ea, s.eb, s.prev_l1

    # final render with n_touched (keyframing / visibility) and the median
    # depth, from frozen or refined margin lists where the config allows
    final_lists = None
    if tcfg.final_reuse and tcfg.so_max_iter > 0:
        final_lists = lists_so
    elif tcfg.final_refine and tcfg.so_max_iter > 0 and so_aux is not None:
        final_lists = refine_fine_lists(gauss, T, intr, cfg_track, so_aux,
                                        torch.arange(n_fine, device=dev))
    out = render(gauss, T, intr, cfg, lists=final_lists)
    return TrackResult(
        T=T, ea=ea, eb=eb, image=out.image, depth=out.depth,
        opacity=out.opacity, n_touched=out.n_touched,
        median_depth=losses.get_median_depth(out.depth, out.opacity),
        last_l1=last_l1, fo_iters=fo_iters, so_iters=so_iters,
        fo_losses=fo_losses, so_losses=so_losses, host_syncs=syncs)
