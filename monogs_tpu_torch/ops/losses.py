"""Tracking losses: affine exposure, the per-pixel residual, signed
sqrt-Huber and the median depth.

Counterpart of ``monogs_tpu/ops/losses.py`` (the mapping losses arrive with
the mapping slice).
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


def tracking_residual_rgb(image, gt_image, opacity, mapping_mask,
                          exposure_a, exposure_b):
    """Signed per-pixel tracking residual [3, H, W]."""
    image_ab = apply_exposure(image, exposure_a, exposure_b)
    return opacity * (image_ab * mapping_mask - gt_image * mapping_mask)


def get_median_depth(depth, opacity=None, mask=None):
    """Lower median of the valid rendered depth (d > 0, opacity > 0.95)."""
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
    return sorted_d.index_select(0, med_idx.reshape(1))[0]
