"""Fixed-capacity Gaussian map state.

Counterpart of ``monogs_tpu/models/gaussian_map.py``: a structure of
arrays of fixed capacity N with an ``active`` mask. Insertion,
densification (clone and split) and pruning are masked scatters into free
slots found by ``compact_indices``, and the Adam moments live beside the
parameters and move with them (new slots get zeroed moments). Slots never
move once allocated, so per-Gaussian side state (``kf_id``, ``n_obs``)
stays index-aligned.

Every function returns a new ``GaussianMap`` and leaves its input as it
was; none reads a value back to the host. Random draws come from a
``torch.Generator`` or are given (``densify_and_prune``'s ``samples``), so
that a test can replay the JAX package's ``jax.random`` draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..ops import se3
from ..render.renderer import GaussianArrays
from ..render.tiling import compact_indices


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


class ParamLeaves(NamedTuple):
    """The optimised leaves, one Adam group each."""

    xyz: torch.Tensor        # [N, 3]
    sh: torch.Tensor         # [N, K, 3] (index 0 = DC)
    log_scale: torch.Tensor  # [N, 3]
    quat: torch.Tensor       # [N, 4]
    opa_logit: torch.Tensor  # [N, 1]


class GaussianMap(NamedTuple):
    params: ParamLeaves
    adam_m: ParamLeaves
    adam_v: ParamLeaves
    adam_t: torch.Tensor       # [] int32 Adam step, shared by all leaves
    active: torch.Tensor       # [N] bool
    kf_id: torch.Tensor        # [N] int32 (-1 = free slot)
    n_obs: torch.Tensor        # [N] int32
    max_radii2d: torch.Tensor  # [N] f32
    grad_accum: torch.Tensor   # [N] f32 (screen-space gradient norms)
    denom: torch.Tensor        # [N] f32

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    @property
    def n_active(self):
        return torch.sum(self.active)

    def render_view(self) -> GaussianArrays:
        p = self.params
        return GaussianArrays(xyz=p.xyz, sh=p.sh, log_scale=p.log_scale,
                              quat=p.quat, opa_logit=p.opa_logit,
                              active=self.active)

    def to(self, device) -> "GaussianMap":
        """The same map on ``device``."""
        return GaussianMap(*(
            ParamLeaves(*(y.to(device) for y in x))
            if isinstance(x, ParamLeaves) else x.to(device) for x in self))


class MapHyper(NamedTuple):
    """Optimizer hyperparameters (the JAX package's defaults)."""

    position_lr_init: float = 0.0016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.001
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    spatial_lr_scale: float = 6.0
    adam_eps: float = 1e-15
    beta1: float = 0.9
    beta2: float = 0.999


def _zeros_like_leaves(p: ParamLeaves) -> ParamLeaves:
    return ParamLeaves(*(torch.zeros_like(x) for x in p))


def new_map(capacity: int, sh_degree: int = 0, device="cuda") -> GaussianMap:
    from .. import resolve_device

    dev = resolve_device(device)
    k = (sh_degree + 1) ** 2

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=dev)

    quat = torch.zeros((capacity, 4), dtype=torch.float32, device=dev)
    quat[:, 0] = 1.0
    params = ParamLeaves(
        xyz=full((capacity, 3), 0.0), sh=full((capacity, k, 3), 0.0),
        log_scale=full((capacity, 3), -10.0), quat=quat,
        opa_logit=full((capacity, 1), -10.0))
    return GaussianMap(
        params=params, adam_m=_zeros_like_leaves(params),
        adam_v=_zeros_like_leaves(params),
        adam_t=torch.zeros((), dtype=torch.int32, device=dev),
        active=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        kf_id=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        n_obs=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        max_radii2d=full((capacity,), 0.0), grad_accum=full((capacity,), 0.0),
        denom=full((capacity,), 0.0))


def xyz_lr_at(h: MapHyper, step: int) -> float:
    """Log-linear position learning rate at iteration ``step``."""
    lr_init = h.position_lr_init * h.spatial_lr_scale
    lr_final = h.position_lr_final * h.spatial_lr_scale
    t = min(max(step / h.position_lr_max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def adam_step(m: GaussianMap, grads: ParamLeaves, h: MapHyper,
              step: int) -> GaussianMap:
    """One Adam step over the active Gaussians with torch.optim.Adam's
    semantics (bias correction, eps outside the square root of v_hat);
    ``step`` drives the xyz learning-rate schedule. The SH leaf's DC
    coefficient learns at feature_lr, the rest at feature_lr / 20."""
    t = m.adam_t + 1
    bc1 = 1.0 - h.beta1 ** t.float()
    bc2 = 1.0 - h.beta2 ** t.float()
    # built on the device: an item assignment would copy from the host and
    # synchronise the stream
    sh_lr = torch.cat([
        torch.full((1,), h.feature_lr, device=t.device),
        torch.full((m.params.sh.shape[1] - 1,), h.feature_lr / 20.0,
                   device=t.device)])
    lrs = ParamLeaves(xyz=xyz_lr_at(h, step), sh=sh_lr[None, :, None],
                      log_scale=h.scaling_lr * h.spatial_lr_scale,
                      quat=h.rotation_lr, opa_logit=h.opacity_lr)
    b1, b2 = h.beta1, h.beta2

    def upd(p, g, mm, vv, lr):
        am = m.active.reshape((-1,) + (1,) * (p.ndim - 1))
        g = torch.where(am, g, torch.zeros_like(g))
        mm2 = b1 * mm + (1 - b1) * g
        vv2 = b2 * vv + (1 - b2) * g * g
        step_val = lr * (mm2 / bc1) / (torch.sqrt(vv2 / bc2) + h.adam_eps)
        return (torch.where(am, p - step_val, p), torch.where(am, mm2, mm),
                torch.where(am, vv2, vv))

    out = [upd(*a) for a in zip(m.params, grads, m.adam_m, m.adam_v, lrs)]
    return m._replace(params=ParamLeaves(*(o[0] for o in out)),
                      adam_m=ParamLeaves(*(o[1] for o in out)),
                      adam_v=ParamLeaves(*(o[2] for o in out)), adam_t=t)


def _scatter(arr, idx, write, val):
    """arr with rows ``idx`` set to ``val`` where ``write``; unwritten rows
    go to a padding row past the end, which is dropped."""
    n = arr.shape[0]
    pad = torch.cat([arr, torch.zeros_like(arr[:1])], dim=0)
    idx = torch.where(write, idx, n)
    wm = write.reshape((-1,) + (1,) * (arr.ndim - 1))
    val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
    val = torch.where(wm, val.expand((idx.shape[0],) + arr.shape[1:]),
                      pad[idx])
    return pad.index_put((idx,), val)[:n]


def _scatter_leaves(params: ParamLeaves, slots, write, new: ParamLeaves):
    return ParamLeaves(*(_scatter(p, slots, write, q)
                         for p, q in zip(params, new)))


def _fill_slots(m: GaussianMap, slots, write, new: ParamLeaves, kf_id,
                n_obs) -> GaussianMap:
    """Write ``new`` into ``slots`` (zeroed Adam moments and stats)."""
    zero = _zeros_like_leaves(new)
    return m._replace(
        params=_scatter_leaves(m.params, slots, write, new),
        adam_m=_scatter_leaves(m.adam_m, slots, write, zero),
        adam_v=_scatter_leaves(m.adam_v, slots, write, zero),
        active=_scatter(m.active, slots, write, True),
        kf_id=_scatter(m.kf_id, slots, write, kf_id),
        n_obs=_scatter(m.n_obs, slots, write, n_obs),
        max_radii2d=_scatter(m.max_radii2d, slots, write, 0.0),
        grad_accum=_scatter(m.grad_accum, slots, write, 0.0),
        denom=_scatter(m.denom, slots, write, 0.0))


def insert(m: GaussianMap, new: ParamLeaves, new_count, kf_id) -> GaussianMap:
    """Append the first ``new_count`` rows of ``new`` into free slots (rows
    past the free slots are dropped); new slots get zeroed moments."""
    cap_new = new.xyz.shape[0]
    slots, slot_ok, _ = compact_indices(~m.active, cap_new)
    row = torch.arange(cap_new, device=slots.device)
    write = slot_ok & (row < new_count)
    return _fill_slots(m, slots, write, new, kf_id, 0)


def prune(m: GaussianMap, mask) -> GaussianMap:
    """Free the slots where ``mask``."""
    return m._replace(active=m.active & ~mask,
                      kf_id=torch.where(mask, -1, m.kf_id))


def _with_opacity(m: GaussianMap, opa_logit) -> GaussianMap:
    """New opacity logits; the whole opacity moment tensor is zeroed, as
    the reference's optimizer-state replacement does."""
    z = torch.zeros_like(m.adam_m.opa_logit)
    return m._replace(params=m.params._replace(opa_logit=opa_logit),
                      adam_m=m.adam_m._replace(opa_logit=z),
                      adam_v=m.adam_v._replace(opa_logit=z))


def reset_opacity(m: GaussianMap, value: float = 0.01) -> GaussianMap:
    """Set every active Gaussian's opacity to ``value``."""
    target = inverse_sigmoid(torch.full_like(m.params.opa_logit, value))
    return _with_opacity(m, torch.where(m.active[:, None], target,
                                        m.params.opa_logit))


def reset_opacity_nonvisible(m: GaussianMap, visible_any) -> GaussianMap:
    """Set the opacity of active Gaussians no window view sees to 0.4."""
    target = inverse_sigmoid(torch.full_like(m.params.opa_logit, 0.4))
    keep = visible_any[:, None] | ~m.active[:, None]
    return _with_opacity(m, torch.where(keep, m.params.opa_logit, target))


def densify_and_prune(m: GaussianMap, generator: Optional[torch.Generator],
                      max_grad: float, min_opacity: float, extent: float,
                      max_screen_size, h: MapHyper, clone_cap: int = 8192,
                      split_cap: int = 4096, samples=None) -> GaussianMap:
    """Clone small high-gradient Gaussians, split large ones in two (scale
    / 1.6, offsets drawn in their own frame), prune transparent and (with
    ``max_screen_size``) oversized ones, parents and children alike. Children
    are compacted to ``clone_cap`` / ``split_cap`` and scattered into free
    slots; overflow is dropped; split parents are freed; all densification
    statistics reset. ``samples`` [2, split_cap, 3] replaces the standard
    normal draw from ``generator``."""
    dev = m.active.device
    grads = m.grad_accum / torch.clamp(m.denom, min=1e-12)
    grads = torch.where(m.denom > 0, grads, torch.zeros_like(grads))
    scale = torch.exp(m.params.log_scale)
    max_scale = torch.max(scale, dim=-1).values
    opa = torch.sigmoid(m.params.opa_logit[:, 0])

    hot = m.active & (grads >= max_grad)
    clone_mask = hot & (max_scale <= h.percent_dense * extent)
    split_mask = hot & (max_scale > h.percent_dense * extent)
    prune_parent = m.active & (opa < min_opacity)
    if max_screen_size is not None:
        # the reference's screen-size test reads max_radii2D after
        # densification zeroed it, so only the world-size test is live
        prune_parent = prune_parent | (m.active & (max_scale > 0.1 * extent))
    keep = m.active & ~split_mask & ~prune_parent
    m2 = m._replace(active=keep, kf_id=torch.where(keep, m.kf_id, -1))

    def gather(idx):
        return ParamLeaves(*(p[idx] for p in m.params)), m.kf_id[idx], \
            m.n_obs[idx]

    c_idx, c_ok, _ = compact_indices(clone_mask, clone_cap)
    clone_p, clone_kf, clone_nobs = gather(c_idx)
    s_idx, s_ok, _ = compact_indices(split_mask, split_cap)
    sp, sp_kf, sp_nobs = gather(s_idx)
    stds = torch.exp(sp.log_scale)
    if samples is None:
        samples = torch.randn((2, split_cap, 3), generator=generator,
                              device=dev)
    samples = samples * stds[None]
    rots = se3.quat_to_rotmat(sp.quat)
    offs = torch.einsum("cij,kcj->kci", rots, samples)
    new_log_scale = torch.log(torch.clamp(stds / (0.8 * 2.0), min=1e-12))

    def split_child(i):
        return ParamLeaves(xyz=sp.xyz + offs[i], sh=sp.sh,
                           log_scale=new_log_scale, quat=sp.quat,
                           opa_logit=sp.opa_logit)

    children = ParamLeaves(*(torch.cat(x, dim=0) for x in zip(
        clone_p, split_child(0), split_child(1))))
    child_kf = torch.cat([clone_kf, sp_kf, sp_kf])
    child_nobs = torch.cat([clone_nobs, sp_nobs, sp_nobs])
    child_ok = torch.cat([c_ok, s_ok, s_ok])
    child_prune = torch.sigmoid(children.opa_logit[:, 0]) < min_opacity
    if max_screen_size is not None:
        child_maxs = torch.max(torch.exp(children.log_scale), dim=-1).values
        child_prune = child_prune | (child_maxs > 0.1 * extent)
    child_ok = child_ok & ~child_prune

    n_child_cap = child_ok.shape[0]
    ci, ci_ok, n_children = compact_indices(child_ok, n_child_cap)
    children = ParamLeaves(*(p[ci] for p in children))
    slots, slot_ok, _ = compact_indices(~m2.active, n_child_cap)
    write = (slot_ok & ci_ok
             & (torch.arange(n_child_cap, device=dev) < n_children))
    out = _fill_slots(m2, slots, write, children, child_kf[ci],
                      child_nobs[ci])
    z = torch.zeros_like(m.max_radii2d)
    return out._replace(max_radii2d=z, grad_accum=z, denom=z)
