"""PLY import/export of the Gaussian map.

Counterpart of ``monogs_tpu/models/ply.py``, in the same file format:
binary little-endian PLY with the standard 3DGS attribute layout
(x y z nx ny nz f_dc_* f_rest_* opacity scale_* rot_*), so that a map
written by either package loads in the other. numpy structured arrays, no
plyfile dependency.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from .gaussian_map import GaussianMap, ParamLeaves, new_map


def _attribute_names(sh_k: int):
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(3 * (sh_k - 1))]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def save_ply(m: GaussianMap, path: str):
    """The active Gaussians of ``m`` (any device) to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    active = m.active.cpu().numpy()

    def host(x):
        return x.detach().cpu().numpy()[active]

    xyz = host(m.params.xyz)
    sh = host(m.params.sh)                        # [n, K, 3]
    n = xyz.shape[0]
    sh_k = sh.shape[1]
    normals = np.zeros_like(xyz)
    # features stored transposed: f_dc [3], f_rest channel-major
    f_dc = sh[:, 0, :]
    f_rest = sh[:, 1:, :].transpose(0, 2, 1).reshape(n, -1)
    names = _attribute_names(sh_k)
    data = np.concatenate(
        [xyz, normals, f_dc, f_rest, host(m.params.opa_logit),
         host(m.params.log_scale), host(m.params.quat)], axis=1
    ).astype("<f4")
    rec = np.empty(n, dtype=[(name, "<f4") for name in names])
    for i, name in enumerate(names):
        rec[name] = data[:, i]

    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {name}\n" for name in names)
        + "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


def load_ply(path: str, capacity: int | None = None,
             device="cuda") -> GaussianMap:
    """A map of ``capacity`` slots (by default the next power of two that
    keeps it 3/4 full, at least 1024) on ``device`` holding the file's
    Gaussians in its first slots, keyframe id 0, zeroed moments."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        n = 0
        names = []
        for line in header.decode("ascii").splitlines():
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                names.append(line.split()[-1])
        rec = np.fromfile(f, dtype=[(name, "<f4") for name in names], count=n)

    n_rest = sum(1 for name in names if name.startswith("f_rest_"))
    sh_k = 1 + n_rest // 3
    if capacity is None:
        capacity = max(1 << int(np.ceil(np.log2(max(n, 1) / 0.75))), 1024)
    m = new_map(capacity, sh_degree=int(np.sqrt(sh_k)) - 1, device=dev)

    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1)
    sh = np.zeros((n, sh_k, 3), np.float32)
    sh[:, 0, :] = np.stack([rec[f"f_dc_{i}"] for i in range(3)], axis=1)
    if n_rest:
        rest = np.stack(
            [rec[f"f_rest_{i}"] for i in range(n_rest)], axis=1
        ).reshape(n, 3, sh_k - 1)
        sh[:, 1:, :] = rest.transpose(0, 2, 1)
    opacity = rec["opacity"][:, None]
    scale = np.stack([rec[f"scale_{i}"] for i in range(3)], axis=1)
    rot = np.stack([rec[f"rot_{i}"] for i in range(4)], axis=1)

    pad = capacity - n

    def padded(x, fill=0.0):
        return torch.as_tensor(np.concatenate(
            [x, np.full((pad,) + x.shape[1:], fill, x.dtype)]), device=dev)

    active = torch.arange(capacity, device=dev) < n
    return m._replace(
        params=ParamLeaves(xyz=padded(xyz), sh=padded(sh),
                           log_scale=padded(scale, -10.0),
                           quat=padded(rot), opa_logit=padded(opacity, -10.0)),
        active=active,
        kf_id=torch.where(active, 0, -1).to(torch.int32),
    )
