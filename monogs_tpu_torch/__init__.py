"""PyTorch/CUDA port of monogs_tpu (Gaussian-splatting SLAM) for NVIDIA Hopper.

Layout mirrors ``monogs_tpu/`` module for module (``ops/``, ``render/``,
``data/``, ``slam/``). The port imports torch only; the JAX package is the
reference it is tested against (``tests/test_torch_*.py``).

Entry points default to ``device="cuda"`` and raise without CUDA unless the
caller asks for the CPU, where every kernel wrapper runs its plain PyTorch
version.

TF32 is switched off for the whole package: the reference blend and pose
math are full float32 (Precision.HIGHEST in the JAX package), and the frame
mask goes through a 3x3 convolution whose TF32 rounding (cuDNN's default)
moves the edge-mask median threshold and so the mask itself.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """torch.device for an entry point's ``device`` argument; a CUDA device
    without CUDA raises instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path"
        )
    return dev


def as_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    """``x`` (a tensor, a numpy array or anything ``np.asarray`` takes, such
    as another package's array) as a tensor of ``dtype`` on ``device``."""
    if not torch.is_tensor(x):
        import numpy as np

        x = np.asarray(x)
    return torch.as_tensor(x, dtype=dtype, device=device)
