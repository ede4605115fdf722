"""Per-frame device tensors (counterpart of ``monogs_tpu/slam/frame.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.image import compute_grad_mask


class FrameData(NamedTuple):
    """Per-frame tensors, all [.., H, W] float32 on one device."""

    gt_image: torch.Tensor      # [3, H, W]
    gt_depth: torch.Tensor      # [1, H, W] (zeros when no depth)
    has_depth: torch.Tensor     # [] bool
    track_mask: torch.Tensor    # [1, H, W] boundary * edge mask
    mapping_mask: torch.Tensor  # [1, H, W] boundary mask (per-pixel loss)


def make_frame_data(gt_image, gt_depth, edge_threshold, rgb_boundary_threshold,
                    dataset_type: str) -> FrameData:
    """FrameData on ``gt_image``'s device; ``gt_depth`` may be None."""
    gt_image = torch.as_tensor(gt_image, dtype=torch.float32)
    dev = gt_image.device
    track_mask, mapping_mask = compute_grad_mask(
        gt_image, edge_threshold, rgb_boundary_threshold, dataset_type)
    if gt_depth is None:
        depth = torch.zeros((1,) + tuple(gt_image.shape[1:]),
                            dtype=torch.float32, device=dev)
    else:
        depth = torch.as_tensor(gt_depth, dtype=torch.float32,
                                device=dev).reshape(
            (1,) + tuple(gt_image.shape[1:]))
    return FrameData(
        gt_image=gt_image, gt_depth=depth,
        has_depth=torch.tensor(gt_depth is not None, device=dev),
        track_mask=track_mask, mapping_mask=mapping_mask)
