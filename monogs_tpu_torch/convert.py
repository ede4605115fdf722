"""Carry a map across from the JAX package's arrays.

``gaussians_from_numpy`` takes the fields of a JAX ``GaussianArrays`` as
numpy arrays (``np.asarray(field)``) and returns the port's
``GaussianArrays``, so that both packages can render the same map.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .render.renderer import GaussianArrays


def gaussians_from_numpy(xyz, sh, log_scale, quat, opa_logit, active,
                         device="cuda") -> GaussianArrays:
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return GaussianArrays(
        xyz=f32(xyz), sh=f32(sh), log_scale=f32(log_scale), quat=f32(quat),
        opa_logit=f32(opa_logit),
        active=torch.as_tensor(np.asarray(active, bool), device=dev))
