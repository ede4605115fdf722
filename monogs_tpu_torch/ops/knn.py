"""Brute-force k-nearest-neighbour mean squared distance.

Counterpart of ``monogs_tpu/ops/knn.py`` (the reference's ``simple-knn``
``distCUDA2``, used once per keyframe insertion to set initial Gaussian
scales): rows are taken in chunks against all points, distances come from
one matrix product per chunk, and the k nearest are found by k passes of
min / argmin, masking each pass's winner (exact; ties go to the first
column, like a top-k).
"""

from __future__ import annotations

import torch


def mean_knn_sq_dist(points, valid_mask=None, k: int = 3, chunk: int = 2048):
    """Mean squared distance from each point to its k nearest neighbours.

    points: [N, 3]; valid_mask: [N] bool (invalid points are no neighbour
    and get 0). Returns [N] float32."""
    n = points.shape[0]
    dev = points.device
    sq = torch.sum(points * points, dim=-1)
    if valid_mask is None:
        valid_mask = torch.ones((n,), dtype=torch.bool, device=dev)
    big = torch.tensor(1e12, dtype=points.dtype, device=dev)
    col = torch.arange(n, device=dev)[None, :]
    out = []
    for base in range(0, n, chunk):
        p_c, sq_c = points[base:base + chunk], sq[base:base + chunk]
        d = sq_c[:, None] - 2.0 * (p_c @ points.T) + sq[None, :]
        row = base + torch.arange(p_c.shape[0], device=dev)[:, None]
        d = torch.where(valid_mask[None, :] & (col != row), d, big)
        ksum = torch.zeros((d.shape[0],), dtype=d.dtype, device=dev)
        for _ in range(k):
            ksum = ksum + torch.clamp(torch.min(d, dim=-1).values, min=0.0)
            first = torch.argmin(d, dim=-1)
            d = torch.where(col == first[:, None], big, d)
        out.append(torch.where(valid_mask[base:base + chunk], ksum / k,
                               torch.zeros_like(ksum)))
    return torch.cat(out)
