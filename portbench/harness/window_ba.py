"""Driver of the ``window_ba`` traffic: keyframe-window bundle adjustment
through the port's ``slam.mapping.map_iters`` on a fixed window.

Set-up (``setup_s``, from process start to the first timed iteration):

1. the configuration as shipped, through the port's own config readers;
2. on the device, the same every run (drawn from the scene seed in the
   configuration file, as a deployment maps one place): the scene
   (``reference.scene``), the staged views' poses and their frames,
   rendered by the reference renderer, and the map: the scene with its
   positions, colours and opacity logits perturbed. The views are staged
   as the single-process backend stages them (``_stage_batch``): the
   window's ``window_size`` keyframes (every ``kf_interval``-th frame of a
   TUM-paced orbit, jittered; poses 1 to ``pose_window - 1`` and exposures
   1 and on optimised), then ``pool_size`` earlier keyframes of the orbit,
   rendered and never optimised;
3. the map inserted into a map of the shipped capacity as one part a
   staged view (the parts are the scene's; the run's seed orders the
   Gaussians within each part), the part of view ``fresh_part`` (the
   newest keyframe's) at the opacity logit ``fresh_opa_logit`` that
   insertion gives new Gaussians;
4. ``check_steps`` iterations, one ``map_iters`` call each from ``it0``,
   their losses and states kept for the correctness check (with ``it0``
   46 they cross the shipped densify and prune of iteration 50, whose
   split draws the benchmark makes and hands to both sides); then
   ``warm_chunks`` calls of ``chunk`` iterations. The same map, cameras,
   iteration counter and window Adam state go on into the window.

Window: calls of ``chunk`` iterations until ``seconds`` have passed. The
backend makes one call of ``mapping_itr_num`` iterations a keyframe, with
its lists rebuilt every ``rebin_every`` and one visibility pass at the
end; a chunk of ``rebin_every - 1`` builds its lists at its start and
never again, so the cadence of list builds is the backend's, and the
visibility pass is made once a chunk (PERF.md, section 4). The map is
copied on the device once ``l1_at`` window iterations are done. With
trace, the first call to start a third of the way in or later (at the
latest once the seconds are up) runs under the profiler and the next
under the card's sync debug mode; both are left out of the rates.

After the window: the peak memory is read, the program's state freed,
``ba_l1`` (the staged views' mapping loss of the copy, rendered by the
reference) computed, and the reference's steps from the set-up's start
state compared with the program's (``compare.training_numbers``).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

from . import compare, trace as tracemod
from .device import forbidden_modules
from ..reference import ba as ref_ba, render as R, scene as S


def _ref_settings(conf: dict, cfgfile: dict):
    """The reference's camera, grid, mapping and optimizer settings, read
    from the configuration file with the port's documented defaults."""
    cal = conf["Dataset"]["Calibration"]
    rc, tr, opt = conf["Renderer"], conf["Training"], conf["opt_params"]
    cam = R.Camera(float(cal["fx"]), float(cal["fy"]), float(cal["cx"]),
                   float(cal["cy"]), int(cal["width"]), int(cal["height"]))
    grid = R.Grid(tile=rc.get("tile", 16), macro_tiles=rc["macro_tiles"],
                  k_macro=rc["k_macro"], k_fine=rc["k_fine"])
    extent = cfgfile["cameras_extent"]
    mapping = dict(
        lr_trans=tr["lr"]["cam_trans_delta"] * 0.5,
        lr_rot=tr["lr"]["cam_rot_delta"] * 0.5,
        lr_exposure_a=tr["lr"].get("exposure_a", 0.01),
        lr_exposure_b=tr["lr"].get("exposure_b", 0.01),
        bin_margin=rc.get("mapping_bin_margin", 4.0),
        rebin_every=rc.get("mapping_rebin_every", 25),
        alpha=tr.get("alpha", 0.95), isotropic_weight=10.0,
        pool_size=rc.get("pool_size", 2),
        densify_grad_threshold=opt["densify_grad_threshold"],
        gaussian_th=tr["gaussian_th"],
        gaussian_extent=extent * tr["gaussian_extent"],
        gaussian_update_every=tr["gaussian_update_every"],
        gaussian_update_offset=tr["gaussian_update_offset"],
        size_threshold=tr["size_threshold"], clone_cap=8192,
        split_cap=4096)
    hyper = dict(
        position_lr_init=opt["position_lr_init"],
        position_lr_final=opt["position_lr_final"],
        position_lr_max_steps=opt["position_lr_max_steps"],
        feature_lr=opt["feature_lr"], opacity_lr=opt["opacity_lr"],
        scaling_lr=opt["scaling_lr"], rotation_lr=opt["rotation_lr"],
        percent_dense=opt["percent_dense"],
        spatial_lr_scale=cfgfile["spatial_lr_scale"], beta1=0.9,
        beta2=0.999, adam_eps=1e-15)
    return cam, grid, mapping, hyper


def _agree(what, ours, theirs):
    for k, v in ours.items():
        if abs(float(v) - float(theirs[k])) > 1e-12 * max(1.0, abs(float(v))):
            raise RuntimeError(f"{what}.{k}: the reference reads {v}, the "
                               f"port's config reader {theirs[k]}")


def settings(cell):
    """The program's configuration objects and the reference's settings of
    ``cell``, checked against each other."""
    from monogs_tpu_torch.slam import runtime as rt

    cfgfile = cell["config"]
    conf = cfgfile["config"]
    intr = rt.intrinsics_from_config(conf)
    st = SimpleNamespace(
        conf=conf, intr=intr, rcfg=rt.render_config_from_config(conf, intr),
        mcfg=rt.map_config_from_config(conf, cfgfile["cameras_extent"]),
        hyper=rt.map_hyper_from_config(conf, cfgfile["spatial_lr_scale"]),
        cap=conf["Renderer"].get("map_capacity", 1 << 17),
        mono=bool(conf["Training"]["monocular"]), scene=cfgfile["scene"],
        prm=cell["params"])
    st.cam, st.grid, st.rmap, st.rhyper = _ref_settings(conf, cfgfile)
    _agree("mapping", st.rmap, st.mcfg._asdict())
    _agree("hyper", st.rhyper, st.hyper._asdict())
    _agree("grid", dict(near=st.grid.near, span_cap=st.grid.span_cap,
                        k_big=st.grid.k_big, tile=st.grid.tile),
           st.rcfg._asdict())
    st.w = st.mcfg.window_size
    st.b = st.w + st.mcfg.pool_size
    return st


def make_inputs(st, seed: int, d):
    """On device ``d``: the perturbed map leaves at the map's capacity (the
    rows past the scene's free), its active rows, the staged views (poses,
    frames, masks, what is optimised) as the reference's dict, the frames'
    depth for the program's views, and the split draws [2, split_cap, 3]
    of a densify. Everything but the order of the map's Gaussians within
    each part and the split draws, which the run's seed draws, is drawn
    from the configuration's scene seed."""
    import torch

    sc, prm, b, w = st.scene, st.prm, st.b, st.w
    scene = S.make_scene(sc["seed"], sc["n"], sc["spread"], sc["depth_mean"],
                         sc["depth_spread"], sc["scale_min"],
                         sc["scale_max"], d)
    n = scene["xyz"].shape[0]
    kfi = st.conf["Training"]["kf_interval"]
    frames = ([v * kfi for v in range(w)]
              + [-(j + 1) * kfi for j in range(b - w)])
    poses = S.orbit_poses(frames, prm["orbit_frames"], prm["jitter_trans"],
                          prm["jitter_rot"], sc["seed"] + 1, d)
    active = torch.ones(n, dtype=torch.bool, device=d)
    imgs, depths = [], []
    for v in range(b):
        im, dp, _ = R.render(scene, active, poses[v], st.cam, st.grid)
        imgs.append(torch.clamp(im, 0.0, 1.0))
        depths.append(dp)
    g = torch.Generator(device=d).manual_seed(sc["seed"] + 2)
    z = torch.randn((n, 7), generator=g, device=d)
    pert = prm["perturb"]
    leaves = dict(
        xyz=scene["xyz"] + pert["xyz"] * z[:, :3],
        sh=scene["sh"] + pert["sh"] * z[:, None, 3:6],
        log_scale=scene["log_scale"], quat=scene["quat"],
        opa_logit=scene["opa_logit"] + pert["opa_logit"] * z[:, 6:7])
    # each Gaussian's part (the staged view whose keyframe inserted it) is
    # the scene's; the run's seed orders the Gaussians within each part
    rank = torch.randperm(n, generator=g, device=d)
    part = rank * b // n
    gs = torch.Generator(device=d).manual_seed(seed)
    perm = torch.randperm(n, generator=gs, device=d)
    order = perm[torch.argsort(part[perm], stable=True)]
    leaves = {k: x[order] for k, x in leaves.items()}
    part = part[order]
    leaves["opa_logit"] = torch.where(
        part[:, None] == prm["fresh_part"],
        torch.full_like(leaves["opa_logit"], prm["fresh_opa_logit"]),
        leaves["opa_logit"])
    free = st.cap - n
    leaves = {k: torch.cat([x, torch.zeros((free,) + x.shape[1:],
                                           device=d)]) for k, x in
              leaves.items()}
    active = torch.cat([active, torch.zeros(free, dtype=torch.bool,
                                            device=d)])
    noise = torch.randn((2, st.rmap["split_cap"], 3), generator=gs, device=d)
    idx = torch.arange(b, device=d)
    cams = dict(
        T=poses, ea=torch.ones(b, device=d), eb=torch.zeros(b, device=d),
        gt_image=torch.stack(imgs),
        gt_depth=None if st.mono else torch.stack(depths),
        mask=torch.ones((b, 1, st.cam.height, st.cam.width), device=d),
        opt_pose=idx.lt(st.mcfg.pose_window) & idx.gt(0),
        opt_exposure=idx.gt(0) & idx.lt(w))
    return dict(leaves=leaves, active=active, cams=cams, n=n, part=part,
                depths=torch.stack(depths), noise=noise)


def _shown(params, active):
    """Each leaf with the free slots' rows zeroed: what the map holds."""
    import torch

    return {k: torch.where(active.reshape((-1,) + (1,) * (x.ndim - 1)), x,
                           torch.zeros_like(x)) for k, x in params.items()}


class Program:
    """The port's map and staged views, and its ``map_iters`` calls with
    the iteration counter and the window Adam state carried across
    them."""

    def __init__(self, st, inp, seed: int, d):
        import torch

        from monogs_tpu_torch.models import gaussian_map as gm
        from monogs_tpu_torch.slam import mapping as mp

        self.st, self.mp, self.n = st, mp, inp["n"]
        leaves, cams, part = inp["leaves"], inp["cams"], inp["part"]
        m = gm.new_map(st.cap, device=d)
        for v in range(st.b):
            rows = torch.nonzero(part == v).reshape(-1)
            m = gm.insert(m, gm.ParamLeaves(**{k: x[rows] for k, x in
                                               leaves.items()}),
                          rows.shape[0], kf_id=v)
        self.m = m
        self.cams = mp.CamBatch(
            gt_image=cams["gt_image"], gt_depth=inp["depths"],
            mapping_mask=cams["mask"], T=cams["T"].clone(),
            ea=cams["ea"].clone(), eb=cams["eb"].clone(),
            valid=torch.ones(st.b, dtype=torch.bool, device=d),
            opt_pose=cams["opt_pose"], opt_exposure=cams["opt_exposure"])
        self.gen = torch.Generator(device=d).manual_seed(seed + 3)
        self.itc = int(st.prm["it0"])
        self.kf = None

    def call(self, k: int, draws=None):
        st = self.st
        r = self.mp.map_iters(self.m, self.cams, k, self.itc, self.gen,
                              st.intr, st.rcfg, st.mcfg, st.hyper,
                              kf_adam=self.kf, draws=draws)
        self.m, self.cams, self.kf, self.itc = (r.m, r.cams, r.kf_adam,
                                                r.it_count)

    def checked_steps(self, steps: int, noise):
        """``steps`` calls of one iteration, through the window's own call
        (each handed the split draws ``noise``): each step's loss (the
        views' losses the mapping step returned, summed), the first
        gradient as the optimizers' state holds it after one step, the
        change of every leaf over the first ``change_steps``, the
        densification statistics after them, and the change of what the
        map holds over the step after them (the densify's)."""
        import torch

        mp, n = self.mp, self.n
        cs = self.st.prm["change_steps"]
        orig, captured, losses = mp.render_map_grad, [], []

        def capture(*a, **k):
            out = orig(*a, **k)
            captured.append(out[0].detach())
            return out

        p0 = {k: x[:n].clone() for k, x in self.m.params._asdict().items()}
        T0, ea0, eb0 = (self.cams.T.clone(), self.cams.ea.clone(),
                        self.cams.eb.clone())
        draws = mp.MapDraws(split_noise=[noise])
        mp.render_map_grad = capture
        try:
            for s in range(steps):
                captured.clear()
                self.call(1, draws)
                losses.append(float(torch.stack(captured).sum())
                              if captured else float("nan"))
                if s == 0:
                    b1 = self.st.hyper.beta1
                    grads = {k: x[:n] / (1 - b1)
                             for k, x in self.m.adam_m._asdict().items()}
                    g8 = self.kf[0] / 0.1
                    grads["pose"], grads["exposure"] = g8[:, :6], g8[:, 6:]
                if s == cs - 1:
                    prm = self.m.params._asdict()
                    change = {k: x[:n] - p0[k] for k, x in prm.items()}
                    change["pose"] = self.cams.T - T0
                    change["exposure"] = torch.stack(
                        [self.cams.ea - ea0, self.cams.eb - eb0], -1)
                    stats = dict(accum=self.m.grad_accum.clone(),
                                 denom=self.m.denom.clone())
                    shown = _shown(prm, self.m.active)
                    n_before = int(self.m.active.sum())
                if s == cs:
                    after = _shown(self.m.params._asdict(), self.m.active)
                    dens = {k: after[k] - shown[k] for k in after}
                    n_after = int(self.m.active.sum())
        finally:
            mp.render_map_grad = orig
        return dict(losses=losses, grads=grads, change=change, stats=stats,
                    densify=dens, active=(n_before, n_after))

    def snapshot(self):
        return ({k: x.clone() for k, x in self.m.params._asdict().items()},
                self.m.active.clone(), self.cams.T.clone(),
                self.cams.ea.clone(), self.cams.eb.clone())

    def finite(self) -> bool:
        import torch

        return (all(bool(torch.isfinite(x).all()) for x in self.m.params)
                and bool(torch.isfinite(self.cams.T).all()))


def reference_steps(st, inp, dtype=None, view_weights=None, grad_hook=None,
                    densify_fn=None):
    """The reference's ``check_steps`` from the start state, in the form
    ``Program.checked_steps`` gives."""
    import torch

    b, n, cs = st.b, inp["n"], st.prm["change_steps"]
    leaves, active, cams = inp["leaves"], inp["active"], inp["cams"]
    d = leaves["xyz"].device
    state = dict(params=leaves, active=active,
                 adam_m={k: torch.zeros_like(x) for k, x in leaves.items()},
                 adam_v={k: torch.zeros_like(x) for k, x in leaves.items()},
                 adam_t=0, kf_adam=(torch.zeros((b, 8), device=d),
                                    torch.zeros((b, 8), device=d), 0))
    kw = {} if densify_fn is None else dict(densify_fn=densify_fn)
    recs = ref_ba.ba_steps(state, cams, st.prm["check_steps"],
                           int(st.prm["it0"]), st.cam, st.grid, st.rmap,
                           st.rhyper, inp["noise"],
                           dtype=dtype or torch.float32,
                           view_weights=view_weights, grad_hook=grad_hook,
                           **kw)
    f32 = {k: v[:n].float() for k, v in recs[0]["grads"].items()}
    g8 = recs[0]["g8"].float()
    last = recs[cs - 1]
    change = {k: last["params"][k][:n].float() - leaves[k][:n]
              for k in leaves}
    change["pose"] = last["T"].float() - cams["T"]
    change["exposure"] = torch.stack([last["ea"].float() - cams["ea"],
                                      last["eb"].float() - cams["eb"]], -1)

    def shown(r):
        return _shown({k: x.float() for k, x in r["params"].items()},
                      r["active"])

    before, after = shown(last), shown(recs[cs])
    return dict(losses=[r["loss"] for r in recs],
                grads=dict(f32, pose=g8[:, :6], exposure=g8[:, 6:]),
                change=change,
                stats={k: x.float() for k, x in
                       recs[cs - 1]["stats"].items()},
                densify={k: after[k] - before[k] for k in after},
                active=(int(last["active"].sum()),
                        int(recs[cs]["active"].sum())),
                densified=recs[cs]["densified"])


def run(cell, seed, seconds, trace, dev, t0, log):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = settings(cell)
    prm, d = st.prm, dev.dev
    inp = make_inputs(st, seed, d)
    dev.sync()
    dev.reset_peak()
    prog = Program(st, inp, seed, d)
    checked = prog.checked_steps(prm["check_steps"], inp["noise"])
    for _ in range(prm["warm_chunks"]):
        prog.call(prm["chunk"])
    dev.sync()
    if forbidden_modules():
        raise RuntimeError(f"JAX modules loaded: {forbidden_modules()}")
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s; window from iteration {prog.itc}")

    chunk, l1_at = prm["chunk"], prm["l1_at"]
    done, timed_iters, timed_s, snap = 0, 0, 0.0, None
    traced = synced = None
    chunk_s = []
    w0 = time.perf_counter()
    while True:
        if trace and traced is None and (
                time.perf_counter() - w0 >= seconds / 3):
            res = tracemod.profile(lambda: prog.call(chunk), dev.sync)
            done += chunk
            if res is None:
                log("the profiler saw no device event; tracing once more")
                res = tracemod.profile(lambda: prog.call(chunk), dev.sync)
                done += chunk
            if res is None:
                log("the profiler saw no device event twice: the metrics "
                    "read from the trace are left out")
            traced = res or dict(missing=True)
            synced = dev.count_syncs(lambda: prog.call(chunk))
            dev.sync()
            done += chunk
        else:
            a = time.perf_counter()
            prog.call(chunk)
            dev.sync()
            chunk_s.append(time.perf_counter() - a)
            timed_s += chunk_s[-1]
            done += chunk
            timed_iters += chunk
        if snap is None and done >= l1_at:
            snap = prog.snapshot()
        # a traced run's window ends only after its traced calls
        if time.perf_counter() - w0 >= seconds and (
                not trace or traced is not None):
            break
    window_s = time.perf_counter() - w0
    dev.sync()
    log(f"window {window_s:.3f} s, {done} iterations to {prog.itc}, "
        f"{int(prog.m.active.sum())} Gaussians; timed calls of {chunk}: "
        f"{[round(x, 4) for x in chunk_s]}")
    peak = dev.peak_bytes()
    finite = prog.finite()
    del prog
    dev.free()

    values = dict(setup_s=setup_s, ba_iters_per_s=done / window_s)
    if snap is not None:
        values["ba_l1"] = window_l1(st, snap, inp["cams"])
    ref = reference_steps(st, inp)
    numbers, detail = compare.training_numbers(checked, ref)
    correct, checks = compare.verdict(numbers, cell["limits"])
    correct = correct and finite and snap is not None
    log(f"check detail: {detail}")
    rec_dev = dev.record(cell["chips"])
    rec_dev["memory_peak_bytes"] = peak
    ctx = dict(trace=traced, syncs=synced, chunk=chunk,
               rate_iters=timed_iters, rate_s=timed_s)
    breakdown = None
    if trace and traced is not None and not traced.get("missing"):
        rec_dev["busy_s"] = traced["busy_s"]
        rec_dev["window_s"] = traced["wall_s"]
        ctx["work"] = blend_work(st, snap)
        breakdown = traced["breakdown"]
    return dict(correct=correct, attempted=done,
                failed=0 if correct else done, values=values, ctx=ctx,
                device=rec_dev, checks=checks, breakdown=breakdown)


def window_l1(st, snap, cams):
    """Mean over the views of the mapping loss of a full reference render of
    the copied map at the copied poses and exposures."""
    import torch

    params, active, T, ea, eb = snap
    tot = 0.0
    for v in range(T.shape[0]):
        im, dp, _ = R.render(params, active, T[v], st.cam, st.grid)
        m = cams["mask"][v]
        img = (torch.abs(ea[v]) + 1e-8) * im + eb[v]
        loss = torch.mean(ref_ba.l1(img * m - cams["gt_image"][v] * m))
        if not st.mono:
            gd = cams["gt_depth"][v]
            dm = (gd > 0.01).to(dp.dtype)
            loss = (st.rmap["alpha"] * loss + (1 - st.rmap["alpha"])
                    * torch.mean(ref_ba.l1(dp * dm - gd * dm)))
        tot += float(loss)
    return tot / T.shape[0]


def blend_work(st, snap):
    """The mapping step's work in one BA iteration, counted by the
    benchmark: per view, the pairs of the reference's blend over lists
    binned with the mapping margin at the copied map, summed; and the bytes
    the step reads and writes once."""
    from . import roofline

    params, active, T, _, _ = snap
    pairs = dict(walked=0, ok=0, contrib=0, live=0)
    for v in range(T.shape[0]):
        g = R.project(params, active, T[v], st.cam, st.grid.near)
        lists = R.bin_lists(g, st.cam, st.grid, margin=st.rmap["bin_margin"])
        *_, cnt = R.render(params, active, T[v], st.cam, st.grid,
                           lists=lists, stats=True)
        for k in pairs:
            pairs[k] += cnt[k]
    tiles = R.tile_origins(st.cam, st.grid, T.device)[0].shape[0]
    name = "map_grad" if st.mono else "map_grad_rgbd"
    nbytes = T.shape[0] * roofline.map_grad_bytes(
        tiles, st.grid.k_fine, st.grid.tile * st.grid.tile, not st.mono)
    return dict(kernel=name, pairs=pairs, bytes=nbytes,
                bound_s=roofline.bound_s(name, pairs, nbytes))
