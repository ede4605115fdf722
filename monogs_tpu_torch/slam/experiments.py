"""Tracking and mapping diagnostics harness.

Counterpart of ``monogs_tpu/slam/experiments.py`` (the reference's
``FrontEnd.tracking_experiment``), function for function:

- ``check_grad``: every sketched-Jacobian entry SJ[i, j] of the second
  order's linearised step (``tracking._so_linearized_step``: ``jvp`` under
  ``vmap``, four tangents at a time) against a direct forward-mode
  derivative of the bucketed residual sums, one basis tangent at a time
  (dual tensors of ``torch.autograd.forward_ad``), as the JAX package holds
  ``jax.linearize`` against ``jax.jacfwd``;
- ``check_sketch``: singular-value distortion statistics of the count
  sketch over repeated draws;
- ``lm_sweep`` / ``step_size_sweep``: the loss after one sketched
  Gauss-Newton step per LM damping, and first-order trajectories per step
  size;
- ``kfine_vs_backward_subsample``: the tracking gradient under ``k_fine``
  truncation against the reference's random backward subsampling;
- ``pool_vs_fresh_sampling``: mapping with a keyframe pool staged per
  ``map_iters`` call against one drawn every iteration.

Forward mode runs under ``torch.no_grad`` (checkpoint has no ``vmap``
rule in every torch release) and only on the "xla" backend: through a
kernel's autograd Function it has no rule, and the JAX package fails there
too (``jax.linearize`` of a Pallas ``custom_vjp``), so ``check_grad`` and
``lm_sweep`` raise for the other backends. The reverse-mode functions
(``step_size_sweep``, ``kfine_vs_backward_subsample``,
``pool_vs_fresh_sampling``) run on every backend, through the kernels on
the card.

Random draws come from a ``torch.Generator`` on the inputs' device; the
sketch (``sketch``), the subsampling mask (``keep``) and the staged pools
and degradation noise (``pools``, ``noise``) can be injected, so that a
test can replay the JAX package's keys.

Run ``python -m monogs_tpu_torch.slam.experiments [--device cpu]`` for the
sketch statistics as JSON.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import losses, se3
from ..ops.sketch import SketchSpec, apply_sketch, damped_lstsq, make_sketch
from ..render import RenderConfig, build_tile_lists, render
from .frame import FrameData
from .tracking import (
    TrackConfig, _fo_loss, _p0, _sketched_Sf, _so_linearized_step,
)


def _forward_mode_backend(cfg: RenderConfig, what: str):
    if cfg.backend != "xla":
        raise TypeError(
            f"{what} pushes forward-mode tangents through the render; on "
            f"backend {cfg.backend!r} it blends through a kernel's autograd "
            "Function, which has no forward-mode rule (the JAX package "
            "fails here too: jax.linearize of a custom_vjp). Use 'xla'.")


def _sketch_for(frame: FrameData, tcfg: TrackConfig, generator,
                sketch: Optional[SketchSpec]) -> SketchSpec:
    if sketch is not None:
        return sketch
    m_pix = frame.gt_image.shape[1] * frame.gt_image.shape[2]
    return make_sketch(generator, m_pix, tcfg.stack_dim, tcfg.sketch_dim)


def _unit_exposure(T):
    one = torch.ones((), dtype=torch.float32, device=T.device)
    return one, torch.zeros_like(one)


def check_grad(gauss, frame: FrameData, T, intr, cfg: RenderConfig,
               tcfg: TrackConfig, generator: Optional[torch.Generator],
               atol: float = 1e-4, sketch: Optional[SketchSpec] = None):
    """The linearised step's SJ against a direct forward-mode Jacobian of
    the bucketed residual sums at (tau = 0, ea = 1, eb = 0). Returns
    (max_abs_diff, SJ [d, 8]); raises AssertionError when the difference
    reaches ``atol``, as the reference's ``torch.allclose`` assert."""
    from torch.autograd import forward_ad as fwAD

    _forward_mode_backend(cfg, "check_grad")
    cfg_t = cfg._replace(with_n_touched=False)
    sketch = _sketch_for(frame, tcfg, generator, sketch)
    ea, eb = _unit_exposure(T)
    _, SJ_lin, _ = _so_linearized_step(gauss, frame, T, ea, eb, sketch, intr,
                                       cfg_t, tcfg, None)
    p0 = _p0(ea, eb)
    lists = build_tile_lists(gauss, T, intr, cfg_t, tau=p0[:6])
    cols = []
    with torch.no_grad():
        for e in torch.eye(8, dtype=p0.dtype, device=p0.device):
            with fwAD.dual_level():
                Sf = _sketched_Sf(gauss, frame, T, fwAD.make_dual(p0, e),
                                  sketch, intr, cfg_t, tcfg, lists)[0]
                cols.append(fwAD.unpack_dual(Sf).tangent)
    SJ_direct = torch.stack(cols, dim=1)
    diff = float(torch.max(torch.abs(SJ_lin - SJ_direct)))
    if not diff < atol:
        raise AssertionError(f"SJ mismatch: {diff} >= {atol}")
    return diff, SJ_lin


def check_sketch(m: int = 30000, n: int = 8, stack_dim: int = 8,
                 sketch_dim: int = 64, trials: int = 100, seed: int = 0,
                 device="cuda"):
    """Singular-value distortion statistics of the count sketch over
    ``trials`` draws (trial t draws from a generator seeded ``seed + t``)
    on a Gaussian [m, n] matrix drawn with numpy from ``seed``: mean and
    standard deviation of sigma_max(SA) / sigma_max(A) and of
    sigma_min(SA) / sigma_min(A), and the distortion sqrt(n / d) that
    theory gives for d = stack_dim * sketch_dim buckets."""
    from .. import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    sigmas = np.linalg.svd(A, compute_uv=False)
    At = torch.as_tensor(A.T.copy(), device=dev)          # [n, m] columns
    ratios_max, ratios_min = [], []
    for t in range(trials):
        gen = torch.Generator(device=dev).manual_seed(seed + t)
        spec = make_sketch(gen, m, stack_dim, sketch_dim)
        SA = apply_sketch(At, spec).T.cpu().numpy()          # [d, n]
        s2 = np.linalg.svd(SA, compute_uv=False)
        ratios_max.append(s2[0] / sigmas[0])
        ratios_min.append(s2[-1] / sigmas[-1])
    rmax, rmin = np.array(ratios_max), np.array(ratios_min)
    return {
        "sigma_max_ratio_mean": float(rmax.mean()),
        "sigma_max_ratio_std": float(rmax.std()),
        "sigma_min_ratio_mean": float(rmin.mean()),
        "sigma_min_ratio_std": float(rmin.std()),
        "distortion_theory": float(np.sqrt(n / (stack_dim * sketch_dim))),
    }


def _l1_at(gauss, frame: FrameData, T, intr, cfg: RenderConfig, ea, eb):
    out = render(gauss, T, intr, cfg._replace(with_n_touched=False))
    r = losses.tracking_residual_rgb(out.image, frame.gt_image, out.opacity,
                                     frame.mapping_mask, ea, eb)
    return float(torch.sum(torch.abs(r)))


def lm_sweep(gauss, frame: FrameData, T, intr, cfg: RenderConfig,
             tcfg: TrackConfig, generator: Optional[torch.Generator],
             lambdas: Sequence[float] = (1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0),
             sketch: Optional[SketchSpec] = None):
    """{lambda: {"loss", "step_norm"}}: the L1 of the full frame after one
    sketched Gauss-Newton step from (T, ea = 1, eb = 0) damped by each
    lambda, and the step's norm."""
    _forward_mode_backend(cfg, "lm_sweep")
    cfg_t = cfg._replace(with_n_touched=False)
    sketch = _sketch_for(frame, tcfg, generator, sketch)
    ea, eb = _unit_exposure(T)
    Sf, SJ, _ = _so_linearized_step(gauss, frame, T, ea, eb, sketch, intr,
                                    cfg_t, tcfg, None)
    results = {}
    with torch.no_grad():
        for lam in lambdas:
            x = damped_lstsq(SJ, Sf, lam)
            results[float(lam)] = {
                "loss": _l1_at(gauss, frame, se3.retract(T, x[:6]), intr,
                               cfg_t, 1.0 + x[6], x[7]),
                "step_norm": float(torch.linalg.norm(x)),
            }
    return results


def step_size_sweep(gauss, frame: FrameData, T, intr, cfg: RenderConfig,
                    tcfg: TrackConfig, generator=None,
                    step_sizes: Sequence[float] = (3e-4, 1e-3, 3e-3, 1e-2,
                                                   3e-2),
                    n_iters: int = 20):
    """{step size: {"losses", "final_trans_delta", "final_angle_delta"}}:
    ``n_iters`` steps of plain gradient descent on the first-order
    objective from (T, 1, 0) at each step size, the L1 before each step
    and how far the pose moved. ``generator`` is unused (nothing is drawn;
    kept for the JAX signature's key)."""
    cfg_t = cfg._replace(with_n_touched=False)
    results = {}
    for lr in step_sizes:
        Tc = T
        ea, eb = _unit_exposure(T)
        traj = []
        for _ in range(n_iters):
            p = _p0(ea, eb).requires_grad_(True)
            with torch.enable_grad():
                loss, l1 = _fo_loss(gauss, frame, Tc, p, intr, cfg_t, tcfg)
                (g,) = torch.autograd.grad(loss, p)
            traj.append(float(l1.detach()))
            d = -lr * g
            Tc = se3.retract(Tc, d[:6])
            ea, eb = ea + d[6], eb + d[7]
        trans_d, ang_d = se3.pose_diff(Tc, T)
        results[float(lr)] = {
            "losses": traj,
            "final_trans_delta": float(trans_d),
            "final_angle_delta": float(ang_d),
        }
    return results


def _rotmat_to_quat_near_identity(R):
    """(w, x, y, z) of a rotation near the identity (trace > -1)."""
    w = 0.5 * torch.sqrt(torch.clamp(1.0 + R[0, 0] + R[1, 1] + R[2, 2],
                                     min=1e-12))
    return torch.stack([w, (R[2, 1] - R[1, 2]) / (4 * w),
                        (R[0, 2] - R[2, 0]) / (4 * w),
                        (R[1, 0] - R[0, 1]) / (4 * w)])


def _quat_premul(p, q):
    """Hamilton product p (x) q for every row of q [N, 4]."""
    pw, px, py, pz = p
    qw, qx, qy, qz = q.unbind(1)
    return torch.stack([
        pw * qw - px * qx - py * qy - pz * qz,
        pw * qx + px * qw + py * qz - pz * qy,
        pw * qy - px * qz + py * qw + pz * qx,
        pw * qz + px * qy - py * qx + pz * qw,
    ], dim=1)


def kfine_vs_backward_subsample(gauss, frame: FrameData, T, intr,
                                cfg: RenderConfig, tcfg: TrackConfig,
                                generator: Optional[torch.Generator],
                                k_fine_full: Optional[int] = None,
                                k_fine_trunc: Optional[int] = None,
                                keep: Optional[torch.Tensor] = None):
    """The 8-dim tracking gradient under the two ways of bounding the
    backward pass, against the untruncated one at a matched backward
    fraction frac = k_fine_trunc / k_fine_full (see the JAX function for
    the argument): ``g_trunc`` at ``k_fine_trunc`` (this package's
    mechanism) and ``g_sub`` at ``k_fine_full`` with only a random
    ``frac`` of the Gaussians contributing pose gradient (the reference's
    ``num_backward_gaussians``). A dropped Gaussian keeps its forward
    contribution but no pose gradient: it is moved in world space by
    M(tau) = (Exp(tau) T)^-1 Exp(sg(tau)) T (the identity at the
    evaluation point), its orientation conjugated alike. ``keep`` [N]
    (bool) replaces the draw of the kept Gaussians.

    Returns the cosine similarities to the untruncated gradient (pose part
    and all eight) and the norm ratios."""
    cfg_full = cfg._replace(with_n_touched=False,
                            k_fine=k_fine_full or max(cfg.k_fine * 4, 256))
    cfg_trunc = cfg_full._replace(k_fine=k_fine_trunc or cfg.k_fine)
    frac = cfg_trunc.k_fine / cfg_full.k_fine
    ea, eb = _unit_exposure(T)
    p0 = _p0(ea, eb)

    def grad(loss_of_p):
        p = p0.clone().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(loss_of_p(p), p)
        return g

    g_ref = grad(lambda p: _fo_loss(gauss, frame, T, p, intr, cfg_full,
                                    tcfg)[0])
    g_trunc = grad(lambda p: _fo_loss(gauss, frame, T, p, intr, cfg_trunc,
                                      tcfg)[0])
    if keep is None:
        n = gauss.xyz.shape[0]
        keep = torch.rand((n,), generator=generator,
                          device=gauss.xyz.device) < frac
    keep = keep.to(gauss.xyz.device)

    def masked_loss(p):
        C = se3.retract(T, p[:6])
        C0 = se3.retract(T, p[:6].detach())
        M = torch.linalg.solve(C, C0)
        xyz_m = gauss.xyz @ M[:3, :3].T + M[:3, 3]
        quat_m = _quat_premul(_rotmat_to_quat_near_identity(M[:3, :3]),
                              gauss.quat)
        gz = gauss._replace(
            xyz=torch.where(keep[:, None], gauss.xyz, xyz_m),
            quat=torch.where(keep[:, None], gauss.quat, quat_m))
        return _fo_loss(gz, frame, T, p, intr, cfg_full, tcfg)[0]

    g_sub = grad(masked_loss)

    def cos(a, b):
        return float(torch.dot(a, b)
                     / (torch.linalg.norm(a) * torch.linalg.norm(b) + 1e-20))

    return {
        "frac": float(frac),
        "cos_trunc_pose": cos(g_trunc[:6], g_ref[:6]),
        "cos_sub_pose": cos(g_sub[:6], g_ref[:6]),
        "cos_trunc_all": cos(g_trunc, g_ref),
        "cos_sub_all": cos(g_sub, g_ref),
        "norm_ratio_trunc": float(torch.linalg.norm(g_trunc)
                                  / torch.linalg.norm(g_ref)),
        "norm_ratio_sub": float(torch.linalg.norm(g_sub)
                                / torch.linalg.norm(g_ref)),
    }


def pool_vs_fresh_sampling(scene, views, intr, cfg: RenderConfig, mcfg,
                           hyper, generator: Optional[torch.Generator],
                           n_iters: int = 60, window: int = 3, pool: int = 2,
                           chunk: int = 10, perturb: float = 0.3,
                           noise=None, pools: Optional[Sequence] = None):
    """The mapping keyframe-pool approximation (``slam/mapping.py``): the
    reference draws ``pool`` random past keyframes every iteration; this
    design stages a pool per ``map_iters`` call. The same recovery problem
    (the map ``scene`` with its positions and opacities degraded by
    ``perturb`` noise, optimised against ``views``, a ``CamBatch``) runs
    both ways at equal total iterations: "staged", calls of ``chunk``
    iterations with the pool re-drawn per call, and "fresh", one-iteration
    calls. The window is the first ``window`` views; each pool is drawn
    without replacement from the others.

    ``noise`` (xyz [N, 3], opa_logit [N, 1] standard normals) and
    ``pools`` (one index sequence per call: the staged run's calls, then
    the fresh run's) replace the draws. Returns the mean per-view L1 of
    the degraded map (``start_l1``), after each run, and their ratio."""
    from ..models import gaussian_map as gm
    from .mapping import map_iters

    dev = views.T.device
    n_views = views.T.shape[0]
    calls = iter(pools or ())

    def stage():
        ids = next(calls, None)
        if ids is None:
            ids = window + torch.randperm(n_views - window,
                                          generator=generator,
                                          device=dev)[:pool]
        sel = torch.cat([torch.arange(window, device=dev),
                         torch.as_tensor(ids, device=dev).long()])
        return type(views)(*(x[sel] for x in views))

    if noise is None:
        p = scene.params
        noise = (torch.randn(p.xyz.shape, generator=generator, device=dev),
                 torch.randn(p.opa_logit.shape, generator=generator,
                             device=dev))
    n_xyz, n_opa = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                    for x in noise)

    def degrade(m):
        p = m.params
        return m._replace(params=p._replace(
            xyz=p.xyz + perturb * 0.02 * n_xyz,
            opa_logit=p.opa_logit + perturb * n_opa))

    def mean_l1(m: gm.GaussianMap):
        g = m.render_view()
        tot = 0.0
        with torch.no_grad():
            for i in range(n_views):
                out = render(g, views.T[i], intr,
                             cfg._replace(with_n_touched=False))
                tot += float(torch.mean(torch.abs(out.image
                                                  - views.gt_image[i])))
        return tot / n_views

    results = {}
    for mode, step in (("staged", chunk), ("fresh", 1)):
        m = degrade(scene)
        if "start_l1" not in results:
            results["start_l1"] = mean_l1(m)
        kf_adam, it, done = None, 0, 0
        while done < n_iters:
            n = min(step, n_iters - done)
            res = map_iters(m, stage(), n, it, generator, intr, cfg, mcfg,
                            hyper, kf_adam=kf_adam)
            m, it, kf_adam = res.m, res.it_count, res.kf_adam
            done += n
        results[mode + "_l1"] = mean_l1(m)
    results["ratio_fresh_over_staged"] = (
        results["fresh_l1"] / max(results["staged_l1"], 1e-12))
    return results


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="Count-sketch distortion statistics (check_sketch) as "
        "JSON.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--trials", type=int, default=20)
    args = ap.parse_args(argv)
    print(json.dumps(check_sketch(trials=args.trials, device=args.device),
                     indent=2))


if __name__ == "__main__":
    main()
