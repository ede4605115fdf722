"""Frame containers (counterpart of ``monogs_tpu/slam/frame.py``).

``FrameData`` holds a frame's device tensors (images, depth, masks);
``Frame`` the frontend's per-frame state: the pose estimate, the ground
truth, the exposure, and the data until ``clean()`` frees it for a frame
that did not become a keyframe. Its tensors lie on the frame's device and
are replaced, never written in place, once a keyframe carrying them has
gone to the backend.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

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


@dataclass
class Frame:
    """Frontend-side frame state."""

    uid: int
    T: torch.Tensor                   # [4, 4] world->camera estimate
    T_gt: torch.Tensor                # [4, 4] ground truth (for eval)
    exposure_a: torch.Tensor          # [] affine exposure gain
    exposure_b: torch.Tensor          # [] affine exposure offset
    data: Optional[FrameData] = None  # freed by clean() for non-keyframes
    depth: Optional[torch.Tensor] = None  # [H, W] sensor depth (insertion)

    @classmethod
    def new(cls, uid: int, T_gt, data: FrameData, depth=None) -> "Frame":
        """A frame at the identity pose with unit exposure, on the device
        of ``data``."""
        dev = data.gt_image.device
        return cls(uid=uid, T=torch.eye(4, device=dev),
                   T_gt=torch.as_tensor(T_gt, dtype=torch.float32,
                                        device=dev),
                   exposure_a=torch.ones((), device=dev),
                   exposure_b=torch.zeros((), device=dev), data=data,
                   depth=depth)

    def clean(self):
        """Free the per-frame tensors."""
        self.data = None
        self.depth = None
