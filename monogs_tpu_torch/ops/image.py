"""Image-space ops: Scharr gradients, the validity mask, the edge-aware
tracking mask (``make_frame_data``), PSNR and SSIM (colour refinement).

Counterpart of ``monogs_tpu/ops/image.py``. Images are channel-first
[C, H, W] float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_KERN_V = ((3.0, 10.0, 3.0), (0.0, 0.0, 0.0), (-3.0, -10.0, -3.0))
_KERN_H = ((3.0, 0.0, -3.0), (10.0, 0.0, -10.0), (3.0, 0.0, -3.0))
_NORMALIZER = 1.0 / 32.0


def _conv3x3(img, kernel):
    """Per-channel 3x3 'same' cross-correlation with reflect padding."""
    k = torch.as_tensor(kernel, dtype=img.dtype, device=img.device)
    pad = F.pad(img[:, None], (1, 1, 1, 1), mode="reflect")  # [C,1,H+2,W+2]
    return F.conv2d(pad, k[None, None])[:, 0]


def image_gradient(image):
    """(grad_v, grad_h) per channel."""
    return (_NORMALIZER * _conv3x3(image, _KERN_V),
            _NORMALIZER * _conv3x3(image, _KERN_H))


def image_gradient_mask(image, eps=0.01):
    """Mask of pixels whose full 3x3 neighbourhood is valid (|I| > eps),
    returned twice like the reference."""
    valid = (torch.abs(image) > eps).to(image.dtype)
    cnt = _conv3x3(valid, ((1.0,) * 3,) * 3)
    m = cnt == 9.0
    return m, m


def torch_median(x):
    """Lower median (sorted[(n-1)//2]) of a 1-D tensor."""
    return torch.sort(x).values[(x.shape[0] - 1) // 2]


def compute_grad_mask(gt_image, edge_threshold, rgb_boundary_threshold,
                      dataset_type: str = "tum", patch_size: int = 32):
    """(tracking mask, mapping mask), both [1, H, W] float32.

    Mapping mask: gt RGB channel-sum > boundary threshold. Tracking mask:
    mapping mask times the gradient-intensity edge mask (global-median
    threshold; per-patch median for "replica")."""
    gray = torch.mean(gt_image, dim=0, keepdim=True)
    gv, gh = image_gradient(gray)
    mv, mh = image_gradient_mask(gray)
    gv = gv * mv
    gh = gh * mh
    intensity = torch.sqrt(gv * gv + gh * gh)[0]
    H, W = intensity.shape
    if dataset_type == "replica":
        ph, pw = H // patch_size, W // patch_size
        crop = intensity[: ph * patch_size, : pw * patch_size]
        patches = crop.reshape(ph, patch_size, pw, patch_size)
        patches = patches.permute(0, 2, 1, 3).reshape(ph * pw, -1)
        med = torch.sort(patches, dim=1).values[:, (patches.shape[1] - 1) // 2]
        med_full = med.reshape(ph, pw).repeat_interleave(
            patch_size, 0).repeat_interleave(patch_size, 1)
        grad_mask = torch.zeros((H, W), dtype=torch.float32,
                                device=gt_image.device)
        grad_mask[: ph * patch_size, : pw * patch_size] = (
            crop > med_full * edge_threshold).float()
        grad_mask = grad_mask[None]
    else:
        med = torch_median(intensity.reshape(-1))
        grad_mask = (intensity > med * edge_threshold)[None].float()
    mapping = (torch.sum(gt_image, dim=0) > rgb_boundary_threshold)[None].float()
    return mapping * grad_mask, mapping


def psnr(img1, img2):
    """20 log10(1 / sqrt(mse)) over all pixels."""
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def _gaussian_window(size: int, sigma: float, device):
    xs = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(img1, img2, window_size: int = 11):
    """Mean SSIM with an 11x11 Gaussian window (sigma 1.5) and 'same' zero
    padding, per channel. imgs: [C, H, W]."""
    win = _gaussian_window(window_size, 1.5, img1.device)[None, None]
    pad = window_size // 2

    def f(img):
        return F.conv2d(img[:, None], win.to(img.dtype), padding=pad)[:, 0]

    mu1, mu2 = f(img1), f(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = f(img1 * img1) - mu1_sq
    sigma2_sq = f(img2 * img2) - mu2_sq
    sigma12 = f(img1 * img2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)
