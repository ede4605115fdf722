"""Plain window bundle adjustment: the steps that the benchmark's BA cells
hold the program's ``map_iters`` to.

Plain PyTorch that imports nothing of the program. One step, as the port's
mapping documents it (``monogs_tpu_torch/slam/mapping.py``, fused branch
over all tiles; ``models/gaussian_map.py``):

- each view is binned afresh at the step's start with the mapping margin
  (``render.bin_lists``), rendered over those lists with the entries culled
  at the current pose left out, and its mapping loss taken: the mean masked
  L1 of the exposed image ``(|a| + 1e-8) image + b`` against the frame,
  with RGB-D ``alpha`` times that plus ``1 - alpha`` times the mean L1 of
  the depth where the frame's depth exceeds 0.01;
- the gradients of the summed losses by autograd, in the map leaves, each
  view's pose tangent (left retraction ``exp(tau) T``), exposure and
  screen-mean hook (``render.project``'s ``off``), plus the gradient of
  ``isotropic_weight`` times the mean |s - mean_row(s)| of the scales;
- the densification statistics: per view, the norm of the hook's gradient
  summed over the Gaussians the view sees (radius > 0), and the count of
  views that see each;
- one Adam step on the map (bias-corrected, eps outside the root, the
  position rate on its log-linear schedule at the step's iteration);
- at the iterations ``gaussian_update_offset`` past a multiple of
  ``gaussian_update_every``, densify and prune (``densify``), then the
  statistics start again from zero;
- one Adam step on the window's poses and exposures (the optimised ones
  only), the pose retracted by the step.

The map is held at the program's capacity: rows past the active ones are
free slots, which densification fills in index order.

``dtype`` runs the whole step in another precision (the control).
"""

from __future__ import annotations

import math

import torch

from . import render as R
from .scene import se3_exp

LEAVES = ("xyz", "sh", "log_scale", "quat", "opa_logit")


def l1(x):
    """|x|, its subgradient 0 at 0 (as the shipped fused mapping step takes
    it: the sign of the residual)."""
    return torch.abs(x)


def xyz_lr(hyper: dict, step: int) -> float:
    lr_init = hyper["position_lr_init"] * hyper["spatial_lr_scale"]
    lr_final = hyper["position_lr_final"] * hyper["spatial_lr_scale"]
    t = min(max(step / hyper["position_lr_max_steps"], 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def view_loss_grads(p, active, T, ea, eb, gt_t, mask_t, gtd_t, lists, cam,
                    grid, alpha):
    """One view's mapping loss and its gradients: (loss, {leaf: grad},
    g_tau [6], g_ea, g_eb, g_off [N, 2], radius [N]). The blend runs a block
    of tiles at a time; its row cotangents are pulled back through the
    projection once."""
    leaves = {k: p[k].detach().requires_grad_(True) for k in LEAVES}
    tau = torch.zeros(6, dtype=T.dtype, device=T.device, requires_grad=True)
    off = torch.zeros((p["xyz"].shape[0], 2), dtype=T.dtype,
                      device=T.device, requires_grad=True)
    ea = ea.detach().requires_grad_(True)
    eb = eb.detach().requires_grad_(True)
    with torch.enable_grad():
        g = R.project(leaves, active, se3_exp(tau) @ T, cam, grid.near,
                      off=off)
        rows = R.rows_of(g)
    rows_d = rows.detach().requires_grad_(True)
    valid = g["valid"]
    npix = cam.width * cam.height
    x0, y0 = R.tile_origins(cam, grid, T.device)
    x0, y0 = x0.to(T.dtype), y0.to(T.dtype)
    bt = R.block_tiles(cam, grid)
    total = torch.zeros((), dtype=T.dtype, device=T.device)
    for a in range(0, lists.idx.shape[0], bt):
        sl = slice(a, a + bt)
        idx = lists.idx[sl]
        vld = lists.vld[sl] & valid[idx]
        with torch.enable_grad():
            color, depth, _, _ = R.blend_block(rows_d[idx], vld, x0[sl],
                                               y0[sl], cam, grid.tile)
            m = mask_t[sl]
            img = (torch.abs(ea) + 1e-8) * color + eb
            lrgb = l1(img * m - gt_t[sl] * m).sum() / (3 * npix)
            if gtd_t is None:
                loss = lrgb
            else:
                dm = (gtd_t[sl, :, 0] > 0.01).to(depth.dtype)
                l1d = l1(depth * dm - gtd_t[sl, :, 0] * dm).sum() / npix
                loss = alpha * lrgb + (1 - alpha) * l1d
        loss.backward()
        total = total + loss.detach()
    rows.backward(rows_d.grad)
    return (total, {k: leaves[k].grad for k in LEAVES}, tau.grad, ea.grad,
            eb.grad, off.grad, g["radius"].detach())


def iso_grad(log_scale, active, weight):
    ls = log_scale.detach().requires_grad_(True)
    with torch.enable_grad():
        s = torch.exp(ls)
        dev = torch.where(s >= s.mean(dim=1, keepdim=True),
                          s - s.mean(dim=1, keepdim=True),
                          s.mean(dim=1, keepdim=True) - s)
        m = active[:, None].to(s.dtype)
        reg = weight * (dev * m).sum() / torch.clamp(m.sum() * 3, min=1.0)
    (g,) = torch.autograd.grad(reg, ls)
    return g


def densify(p, am, av, active, accum, denom, noise, mapping: dict,
            hyper: dict):
    """Densify and prune, as the port's ``densify_and_prune`` documents it:
    the statistic is ``accum / denom`` (0 where no view saw the Gaussian);
    a Gaussian at or over ``densify_grad_threshold`` is cloned where its
    largest scale is at most ``percent_dense`` times ``gaussian_extent``
    and split in two otherwise (scales / 1.6, offsets ``noise`` [2,
    split_cap, 3] times the scales, turned by its rotation); Gaussians under
    the opacity ``gaussian_th`` or (with a ``size_threshold``) larger than a
    tenth of the extent are pruned, children alike; split parents go.
    The first ``clone_cap`` clones and ``split_cap`` splits in index order
    are kept, written into the free slots in index order (overflow
    dropped), with zeroed Adam moments. Returns (p, am, av, active,
    {clone, split, prune, children: counts})."""
    extent = mapping["gaussian_extent"]
    stat = torch.where(denom > 0, accum / torch.clamp(denom, min=1e-12),
                       torch.zeros_like(accum))
    scale = torch.exp(p["log_scale"])
    max_scale = scale.max(dim=-1).values
    opa = torch.sigmoid(p["opa_logit"][:, 0])
    hot = active & (stat >= mapping["densify_grad_threshold"])
    small = max_scale <= hyper["percent_dense"] * extent
    clone, split = hot & small, hot & ~small
    prune = active & (opa < mapping["gaussian_th"])
    sized = mapping["size_threshold"] is not None
    if sized:
        prune = prune | (active & (max_scale > 0.1 * extent))
    keep = active & ~split & ~prune

    c_idx = torch.nonzero(clone).reshape(-1)[:mapping["clone_cap"]]
    s_idx = torch.nonzero(split).reshape(-1)[:mapping["split_cap"]]
    ns = s_idx.shape[0]
    std = scale[s_idx]
    rot = R.quat_rot(p["quat"][s_idx])
    kids = {k: [p[k][c_idx]] for k in LEAVES}
    for j in range(2):
        off = torch.einsum("nij,nj->ni", rot, noise[j, :ns].to(std.dtype)
                           * std)
        kids["xyz"].append(p["xyz"][s_idx] + off)
        kids["log_scale"].append(torch.log(torch.clamp(std / 1.6,
                                                       min=1e-12)))
        for k in ("sh", "quat", "opa_logit"):
            kids[k].append(p[k][s_idx])
    kids = {k: torch.cat(v, dim=0) for k, v in kids.items()}
    ok = torch.sigmoid(kids["opa_logit"][:, 0]) >= mapping["gaussian_th"]
    if sized:
        ok = ok & (torch.exp(kids["log_scale"]).max(dim=-1).values
                   <= 0.1 * extent)
    kids = {k: v[ok] for k, v in kids.items()}
    free = torch.nonzero(~keep).reshape(-1)[:kids["xyz"].shape[0]]
    nk = free.shape[0]
    p, am, av = dict(p), dict(am), dict(av)
    for k in LEAVES:
        p[k] = p[k].clone()
        p[k][free] = kids[k][:nk]
        am[k] = am[k].clone()
        am[k][free] = 0
        av[k] = av[k].clone()
        av[k][free] = 0
    active = keep.clone()
    active[free] = True
    counts = dict(clone=int(clone.sum()), split=int(split.sum()),
                  prune=int(prune.sum()), children=nk)
    return p, am, av, active, counts


def ba_steps(state: dict, cams: dict, n_steps: int, it0: int, cam, grid,
             mapping: dict, hyper: dict, split_noise, dtype=torch.float32,
             view_weights=None, grad_hook=None, densify_fn=densify):
    """Run ``n_steps`` BA steps from ``state`` (params {leaf: tensor},
    adam_m, adam_v {leaf: tensor}, adam_t int, active [N], kf_adam (m [B, 8],
    v [B, 8], t); the densification statistics start at zero) over ``cams``
    (T [B, 4, 4], ea, eb [B], gt_image [B, 3, H, W], gt_depth [B, 1, H, W]
    or None, mask [B, 1, H, W], opt_pose, opt_exposure [B] bool). Returns a
    list of per-step records: loss, the gradients ({leaf: grad}, g8 [B,
    8]), the statistics before any densify of the step, the densify's
    counts (None where none ran) and the state after the step.
    ``view_weights`` [B] weigh the views' terms (1 each when None);
    ``grad_hook(g_sum, g8)`` may change the gradients before the Adam
    steps; ``densify_fn`` replaces ``densify``. These serve the faults that
    the benchmark's check must catch."""
    def cast(x):
        return x.to(dtype) if torch.is_floating_point(x) else x

    p = {k: cast(state["params"][k]) for k in LEAVES}
    am = {k: cast(state["adam_m"][k]) for k in LEAVES}
    av = {k: cast(state["adam_v"][k]) for k in LEAVES}
    at = int(state["adam_t"])
    active = state["active"]
    kam, kav, kat = (cast(state["kf_adam"][0]), cast(state["kf_adam"][1]),
                     int(state["kf_adam"][2]))
    T, ea, eb = cast(cams["T"]), cast(cams["ea"]), cast(cams["eb"])
    b = T.shape[0]
    gt_t = [R.image_to_tiles(cast(x), cam, grid) for x in cams["gt_image"]]
    mask_t = [R.image_to_tiles(cast(x), cam, grid) for x in cams["mask"]]
    gtd_t = ([None] * b if cams.get("gt_depth") is None else
             [R.image_to_tiles(cast(x), cam, grid) for x in cams["gt_depth"]])
    opt = torch.cat([cams["opt_pose"][:, None].expand(b, 6),
                     cams["opt_exposure"][:, None].expand(b, 2)], dim=-1)
    lr8 = torch.tensor([mapping["lr_trans"]] * 3 + [mapping["lr_rot"]] * 3
                       + [mapping["lr_exposure_a"], mapping["lr_exposure_b"]],
                       dtype=dtype, device=T.device)
    b1, b2, eps = hyper["beta1"], hyper["beta2"], hyper["adam_eps"]
    lrs = dict(sh=hyper["feature_lr"],
               log_scale=hyper["scaling_lr"] * hyper["spatial_lr_scale"],
               quat=hyper["rotation_lr"], opa_logit=hyper["opacity_lr"])
    accum = torch.zeros_like(p["xyz"][:, 0])
    denom = torch.zeros_like(accum)
    out = []
    for s in range(n_steps):
        itc = it0 + s + 1
        g_sum = {k: torch.zeros_like(p[k]) for k in LEAVES}
        g8 = torch.zeros((b, 8), dtype=dtype, device=T.device)
        loss = torch.zeros((), dtype=dtype, device=T.device)
        for v in range(b):
            with torch.no_grad():
                lists = R.bin_lists(R.project(p, active, T[v], cam, grid.near),
                                    cam, grid, margin=mapping["bin_margin"])
            lv, gl, gtau, gea, geb, goff, rad = view_loss_grads(
                p, active, T[v], ea[v], eb[v], gt_t[v], mask_t[v], gtd_t[v],
                lists, cam, grid, mapping["alpha"])
            w = 1.0 if view_weights is None else float(view_weights[v])
            loss = loss + w * lv
            for k in LEAVES:
                g_sum[k] = g_sum[k] + w * gl[k]
            g8[v] = w * torch.cat([gtau, gea.reshape(1), geb.reshape(1)])
            vis = rad > 0
            accum = accum + torch.where(
                vis, torch.linalg.norm(w * goff, dim=-1),
                torch.zeros_like(accum))
            denom = denom + vis.to(denom.dtype)
        g_sum["log_scale"] = g_sum["log_scale"] + iso_grad(
            p["log_scale"], active, mapping["isotropic_weight"])
        if grad_hook is not None:
            grad_hook(g_sum, g8)
        stats = dict(accum=accum.clone(), denom=denom.clone())
        counts = None
        with torch.no_grad():
            at += 1
            bc1, bc2 = 1.0 - b1 ** at, 1.0 - b2 ** at
            lr = dict(lrs, xyz=xyz_lr(hyper, itc - 1))
            for k in LEAVES:
                am_ = active.reshape((-1,) + (1,) * (p[k].ndim - 1))
                gk = torch.where(am_, g_sum[k], torch.zeros_like(g_sum[k]))
                m2 = b1 * am[k] + (1 - b1) * gk
                v2 = b2 * av[k] + (1 - b2) * gk * gk
                step = lr[k] * (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
                p[k] = torch.where(am_, p[k] - step, p[k])
                am[k] = torch.where(am_, m2, am[k])
                av[k] = torch.where(am_, v2, av[k])
            if (itc % mapping["gaussian_update_every"]
                    == mapping["gaussian_update_offset"]):
                p, am, av, active, counts = densify_fn(
                    p, am, av, active, accum, denom, split_noise, mapping,
                    hyper)
                accum = torch.zeros_like(accum)
                denom = torch.zeros_like(denom)
            g8 = torch.where(opt, g8, torch.zeros_like(g8))
            kat += 1
            kam = 0.9 * kam + 0.1 * g8
            kav = 0.999 * kav + 0.001 * g8 * g8
            d8 = -lr8 * (kam / (1 - 0.9 ** kat)) / (
                torch.sqrt(kav / (1 - 0.999 ** kat)) + 1e-8)
            d8 = torch.where(opt, d8, torch.zeros_like(d8))
            T = se3_exp(d8[:, :6]) @ T
            ea = ea + d8[:, 6]
            eb = eb + d8[:, 7]
        out.append(dict(loss=float(loss), grads=g_sum, g8=g8, stats=stats,
                        densified=counts,
                        params={k: x.clone() for k, x in p.items()},
                        active=active.clone(),
                        T=T.clone(), ea=ea.clone(), eb=eb.clone()))
    return out
