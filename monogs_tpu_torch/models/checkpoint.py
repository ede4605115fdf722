"""Full-state checkpoints of the Gaussian map (parameters, Adam moments,
slot metadata).

Counterpart of ``monogs_tpu/models/checkpoint.py``, in the same npz layout,
so that a checkpoint written by either package loads in the other bit for
bit: a resumed run continues where a PLY round trip would lose the
optimizer state and the slot bookkeeping.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from .gaussian_map import GaussianMap, ParamLeaves

_LEAF_FIELDS = ("xyz", "sh", "log_scale", "quat", "opa_logit")
_SIDE_FIELDS = ("adam_t", "active", "kf_id", "n_obs", "max_radii2d",
                "grad_accum", "denom")


def save_checkpoint(m: GaussianMap, path: str, extra: dict | None = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def host(x):
        return x.detach().cpu().numpy()

    arrays = {}
    for name in _LEAF_FIELDS:
        arrays[f"params.{name}"] = host(getattr(m.params, name))
        arrays[f"adam_m.{name}"] = host(getattr(m.adam_m, name))
        arrays[f"adam_v.{name}"] = host(getattr(m.adam_v, name))
    for name in _SIDE_FIELDS:
        arrays[name] = host(getattr(m, name))
    for k, v in (extra or {}).items():
        arrays[f"extra.{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, device="cuda") -> tuple[GaussianMap, dict]:
    """(map on ``device``, {name: numpy array} of the extras)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        def t(name):
            return torch.as_tensor(z[name], device=dev)

        def leaves(prefix):
            return ParamLeaves(*(t(f"{prefix}.{n}") for n in _LEAF_FIELDS))

        m = GaussianMap(params=leaves("params"), adam_m=leaves("adam_m"),
                        adam_v=leaves("adam_v"),
                        **{n: t(n) for n in _SIDE_FIELDS})
        extra = {k[len("extra."):]: z[k] for k in z.files
                 if k.startswith("extra.")}
    return m, extra
