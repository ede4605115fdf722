"""Losses: affine exposure, the tracking residual, signed sqrt-Huber, the
mapping L1 losses, the isotropic regulariser and the median depth.

Counterpart of ``monogs_tpu/ops/losses.py``. ``abs_`` is |x| with the
derivative jnp.abs has at 0 (1, where torch.abs has 0), so that gradients
through an L1 term match the JAX package's where a residual is exactly 0.
"""

from __future__ import annotations

import torch

EXPOSURE_EPS = 1e-8


def apply_exposure(image, exposure_a, exposure_b):
    return (torch.abs(exposure_a) + EXPOSURE_EPS) * image + exposure_b


def _huber_value_slope(x, delta):
    ax = torch.abs(x)
    safe = torch.sqrt(torch.clamp(2.0 * delta * ax - delta * delta, min=1e-20))
    small = ax < delta
    return (torch.where(small, x, torch.sign(x) * safe),
            torch.where(small, torch.ones_like(x), delta / safe))


class _HuberSigned(torch.autograd.Function):
    """Signed sqrt-Huber with the reference's custom slope: 1 below delta,
    delta / sqrt(2 delta |x| - delta^2) above it. Defines both backward and
    jvp, so reverse mode, ``torch.autograd.forward_ad`` and ``torch.func``
    transforms all see the same slope."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, delta):
        return _huber_value_slope(x, delta)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, delta = inputs
        ctx.delta = delta
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * _huber_value_slope(x, ctx.delta)[1], None

    @staticmethod
    def jvp(ctx, dx, _ddelta):
        (x,) = ctx.saved_tensors
        return _huber_value_slope(x, ctx.delta)[1] * dx


def huber_signed(x, delta: float):
    """Signed sqrt-Huber; identity below ``delta``."""
    return _HuberSigned.apply(x, float(delta))


def abs_(x):
    """|x|, differentiated as jnp.abs (slope 1 at 0)."""
    return torch.where(x >= 0, x, -x)


def tracking_residual_rgb(image, gt_image, opacity, mapping_mask,
                          exposure_a, exposure_b):
    """Signed per-pixel tracking residual [3, H, W]."""
    image_ab = apply_exposure(image, exposure_a, exposure_b)
    return opacity * (image_ab * mapping_mask - gt_image * mapping_mask)


def tracking_loss_scalar_rgb(image, gt_image, opacity, rgb_pixel_mask,
                             exposure_a, exposure_b):
    """Mean masked opacity-weighted L1 of the exposed image."""
    image_ab = apply_exposure(image, exposure_a, exposure_b)
    return torch.mean(opacity * abs_(image_ab * rgb_pixel_mask
                                     - gt_image * rgb_pixel_mask))


def tracking_loss_scalar_rgbd(image, depth, gt_image, gt_depth, opacity,
                              rgb_pixel_mask, exposure_a, exposure_b,
                              alpha: float = 0.95):
    """alpha * ``tracking_loss_scalar_rgb`` + (1 - alpha) * mean L1 of the
    depth where gt > 0.01 and opacity > 0.95."""
    l1_rgb = tracking_loss_scalar_rgb(image, gt_image, opacity,
                                      rgb_pixel_mask, exposure_a, exposure_b)
    dm = ((gt_depth > 0.01) & (opacity > 0.95)).to(depth.dtype)
    l1_depth = abs_(depth * dm - gt_depth * dm)
    return alpha * l1_rgb + (1 - alpha) * torch.mean(l1_depth)


def mapping_loss_rgb(image, gt_image, mapping_mask, exposure_a, exposure_b,
                     initialization: bool = False):
    """Mean masked L1, with exposure unless initialising."""
    image_ab = (image if initialization
                else apply_exposure(image, exposure_a, exposure_b))
    return torch.mean(abs_(image_ab * mapping_mask - gt_image * mapping_mask))


def mapping_loss_rgbd(image, depth, gt_image, gt_depth, mapping_mask,
                      exposure_a, exposure_b, alpha: float = 0.95,
                      initialization: bool = False):
    """alpha * masked RGB L1 + (1 - alpha) * L1 of depth where gt > 0.01."""
    image_ab = (image if initialization
                else apply_exposure(image, exposure_a, exposure_b))
    l1_rgb = abs_(image_ab * mapping_mask - gt_image * mapping_mask)
    dm = (gt_depth > 0.01).to(depth.dtype)
    l1_depth = abs_(depth * dm - gt_depth * dm)
    return alpha * torch.mean(l1_rgb) + (1 - alpha) * torch.mean(l1_depth)


def isotropic_reg(scaling, active_mask):
    """Mean |s - mean_row(s)| over the active Gaussians' [N, 3] scales."""
    dev = abs_(scaling - torch.mean(scaling, dim=1, keepdim=True))
    m = active_mask[:, None].to(scaling.dtype)
    denom = torch.clamp(torch.sum(m) * scaling.shape[1], min=1.0)
    return torch.sum(dev * m) / denom


def get_median_depth(depth, opacity=None, mask=None, return_std=False):
    """Lower median of the valid rendered depth (d > 0, opacity > 0.95);
    with ``return_std`` also (the sample standard deviation of the valid
    depths, the validity mask shaped as ``depth``)."""
    d = depth.reshape(-1)
    valid = d > 0
    if opacity is not None:
        valid = valid & (opacity.reshape(-1) > 0.95)
    if mask is not None:
        valid = valid & mask.reshape(-1)
    n_valid = torch.sum(valid)
    sorted_d = torch.sort(torch.where(valid, d, torch.inf)).values
    med_idx = torch.clamp(torch.div(n_valid - 1, 2, rounding_mode="floor"),
                          min=0)
    # index_select, not sorted_d[med_idx]: a 0-d index tensor would be read
    # back to the host
    median = sorted_d.index_select(0, med_idx.reshape(1))[0]
    if not return_std:
        return median
    zero = torch.zeros_like(d)
    mean = torch.sum(torch.where(valid, d, zero)) / torch.clamp(n_valid,
                                                                min=1)
    var = (torch.sum(torch.where(valid, (d - mean) ** 2, zero))
           / torch.clamp(n_valid - 1, min=1))
    return median, torch.sqrt(var), valid.reshape(depth.shape)
