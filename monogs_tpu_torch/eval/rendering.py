"""Rendering quality evaluation: PSNR / SSIM / LPIPS.

Counterpart of ``monogs_tpu/eval/rendering.py``: every ``interval``-th
frame that is not a keyframe is rendered at its tracked pose through the
port's ``render`` and compared with its ground truth. PSNR is taken over
the pixels where the ground truth is positive, SSIM with the 11x11
Gaussian window (``ops.image.ssim``). LPIPS(alex) needs pretrained weights
that are not downloaded: without them on disk it is NaN.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from .. import as_tensor
from ..ops.image import ssim as ssim_fn
from ..render import render
from ..utils.logging import Log

_lpips_model = None
_lpips_failed = False
# torchvision's AlexNet weights, which torchmetrics' LPIPS loads
_ALEXNET = "alexnet-owt-7be5be79.pth"


def _lpips(img_a, img_b):
    """LPIPS(alex, normalize=True) through torchmetrics on the CPU, as the
    JAX package computes it; NaN when torchmetrics or the AlexNet weights
    are missing (they are looked up in torch hub's cache, never
    fetched)."""
    global _lpips_model, _lpips_failed
    if _lpips_failed:
        return float("nan")
    try:
        if _lpips_model is None:
            weights = os.path.join(torch.hub.get_dir(), "checkpoints",
                                   _ALEXNET)
            if not os.path.exists(weights):
                raise FileNotFoundError(weights)
            from torchmetrics.image.lpip import (
                LearnedPerceptualImagePatchSimilarity,
            )

            _lpips_model = LearnedPerceptualImagePatchSimilarity(
                net_type="alex", normalize=True)
        a = img_a.detach().float().cpu()[None]
        b = img_b.detach().float().cpu()[None]
        with torch.no_grad():
            return float(_lpips_model(a, b))
    except (ImportError, OSError) as e:
        _lpips_failed = True
        Log(f"LPIPS unavailable ({type(e).__name__}); reporting NaN",
            tag="Eval")
        return float("nan")


def eval_rendering(frames, gaussians, dataset, save_dir, intr, render_cfg,
                   kf_indices, iteration="final", interval: int = 5):
    """Mean PSNR / SSIM / LPIPS over the evaluated frames; the map's
    device renders, and the ground truth is moved there."""
    end_idx = len(frames) - 1
    psnr_array, ssim_array, lpips_array = [], [], []
    cfg = render_cfg._replace(with_n_touched=False)
    dev = gaussians.active.device
    kf_set = set(kf_indices)
    for idx in range(0, end_idx, interval):
        if idx in kf_set or idx not in frames:
            continue
        frame = frames[idx]
        gt_image, _, _ = dataset[idx]
        gt_image = as_tensor(gt_image, dev)
        out = render(gaussians.render_view(), frame.T, intr, cfg)
        image = torch.clamp(out.image, 0.0, 1.0)
        mask = gt_image > 0
        # PSNR over the masked pixels: the full-image mse corrected by the
        # mask's density
        n_valid = max(float(torch.sum(mask)), 1.0)
        mse_full = float(torch.mean(torch.where(
            mask, (image - gt_image) ** 2, torch.zeros_like(image))))
        mse = mse_full * mask.numel() / n_valid
        psnr_score = 20.0 * math.log10(1.0 / math.sqrt(max(mse, 1e-12)))
        ssim_score = float(ssim_fn(image, gt_image))
        psnr_array.append(psnr_score)
        ssim_array.append(ssim_score)
        lpips_array.append(_lpips(image, gt_image))

    output = {
        "mean_psnr": float(np.mean(psnr_array)) if psnr_array else float("nan"),
        "mean_ssim": float(np.mean(ssim_array)) if ssim_array else float("nan"),
        "mean_lpips": float(np.mean(lpips_array)) if lpips_array else float("nan"),
    }
    Log(
        f'mean psnr: {output["mean_psnr"]}, ssim: {output["mean_ssim"]}, '
        f'lpips: {output["mean_lpips"]}',
        tag="Eval",
    )
    if save_dir is not None:
        psnr_save_dir = os.path.join(save_dir, "psnr", str(iteration))
        os.makedirs(psnr_save_dir, exist_ok=True)
        with open(os.path.join(psnr_save_dir, "final_result.json"), "w") as f:
            json.dump(output, f, indent=4)
    return output
