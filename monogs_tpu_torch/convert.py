"""Carry a map and a camera window across from the JAX package's arrays.

Each function takes the fields of a JAX structure as numpy arrays
(``np.asarray(field)``) and returns the port's counterpart on ``device``,
so that both packages can run on the same state:
``gaussians_from_numpy`` (``GaussianArrays``), ``map_from_numpy``
(``GaussianMap`` with its Adam moments and side state) and
``cams_from_numpy`` (``CamBatch``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .models.gaussian_map import GaussianMap, ParamLeaves
from .render.renderer import GaussianArrays
from .slam.mapping import CamBatch


def _to(x, dtype, dev):
    np_dtype = {torch.float32: np.float32, torch.int32: np.int32,
                torch.bool: bool}[dtype]
    return torch.as_tensor(np.array(x, np_dtype), device=dev)


def gaussians_from_numpy(xyz, sh, log_scale, quat, opa_logit, active,
                         device="cuda") -> GaussianArrays:
    dev = resolve_device(device)

    return GaussianArrays(
        *(_to(x, torch.float32, dev)
          for x in (xyz, sh, log_scale, quat, opa_logit)),
        active=_to(active, torch.bool, dev))


def map_from_numpy(params, adam_m, adam_v, adam_t, active, kf_id, n_obs,
                   max_radii2d, grad_accum, denom,
                   device="cuda") -> GaussianMap:
    """params / adam_m / adam_v: sequences of the five leaves (xyz, sh,
    log_scale, quat, opa_logit), as a JAX ``ParamLeaves`` unpacks."""
    dev = resolve_device(device)

    def leaves(ps):
        return ParamLeaves(*(_to(x, torch.float32, dev) for x in ps))

    return GaussianMap(
        params=leaves(params), adam_m=leaves(adam_m), adam_v=leaves(adam_v),
        adam_t=_to(adam_t, torch.int32, dev),
        active=_to(active, torch.bool, dev),
        kf_id=_to(kf_id, torch.int32, dev), n_obs=_to(n_obs, torch.int32, dev),
        max_radii2d=_to(max_radii2d, torch.float32, dev),
        grad_accum=_to(grad_accum, torch.float32, dev),
        denom=_to(denom, torch.float32, dev))


def cams_from_numpy(gt_image, gt_depth, mapping_mask, T, ea, eb, valid,
                    opt_pose, opt_exposure, device="cuda") -> CamBatch:
    dev = resolve_device(device)
    f32 = [_to(x, torch.float32, dev)
           for x in (gt_image, gt_depth, mapping_mask, T, ea, eb)]
    return CamBatch(*f32, *(_to(x, torch.bool, dev)
                           for x in (valid, opt_pose, opt_exposure)))
