"""Count-sketch utilities for the sketched Gauss-Newton tracker.

Counterpart of ``monogs_tpu/ops/sketch.py``: a random permutation of the m
pixels sliced into d = stack_dim * sketch_dim buckets, Rademacher signs per
pixel, S @ v as gather + reshape + row sum, and a damped 8x8 solve. The draw
comes from a ``torch.Generator``; tests inject the JAX draw as a
``SketchSpec`` built from its (perm, signs).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SketchSpec(NamedTuple):
    perm: torch.Tensor   # [d * chunk] int64, bucket-major pixel indices
    signs: torch.Tensor  # [m] float32 Rademacher weights
    d: int
    chunk: int


def make_sketch(generator: torch.Generator, m: int, stack_dim: int,
                sketch_dim: int, device=None) -> SketchSpec:
    d = stack_dim * sketch_dim
    chunk = m // d
    device = generator.device if device is None else device
    perm = torch.randperm(m, generator=generator, device=device)[: d * chunk]
    signs = torch.randint(0, 2, (m,), generator=generator,
                          device=device).float() * 2.0 - 1.0
    return SketchSpec(perm=perm, signs=signs, d=d, chunk=chunk)


def sketch_from_draw(perm, signs, m: int, stack_dim: int,
                     sketch_dim: int) -> SketchSpec:
    """SketchSpec from an injected (perm, signs) draw."""
    d = stack_dim * sketch_dim
    return SketchSpec(perm=perm.long(), signs=signs.float(), d=d,
                      chunk=m // d)


def apply_sketch(residual_flat, spec: SketchSpec):
    """S @ r for flat per-pixel residuals [..., m] -> [..., d] (leading
    dims are independent columns)."""
    weighted = residual_flat * spec.signs
    lead = weighted.shape[:-1]
    return weighted[..., spec.perm].reshape(*lead, spec.d, spec.chunk).sum(-1)


def damped_lstsq(SJ, Sf, lam):
    """argmin_x ||[SJ; sqrt(lam) I] x + [Sf; 0]||_2 via the normal equations.

    ``solve_ex`` is ``torch.linalg.solve`` without its singularity check,
    which would cost a host sync per call; the damping keeps the 8x8 system
    well conditioned."""
    n = SJ.shape[1]
    H = SJ.T @ SJ + lam * torch.eye(n, dtype=SJ.dtype, device=SJ.device)
    g = SJ.T @ Sf
    return -torch.linalg.solve_ex(H, g[:, None])[0][:, 0]
