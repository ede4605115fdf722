"""Blocked scans.

Counterpart of ``monogs_tpu/ops/scan.py``. ``blocked_cumprod_excl`` is the
transmittance scan of the XLA render path (``renderer._blend``): the
two-level association (a running product inside blocks of ``block``, then
the blocks' exclusive products) is kept, so that the port rounds the
transmittance as the JAX package does; ``torch.cumprod`` would associate
it as one sequential chain. ``blocked_cumsum`` (nothing in the port calls
it) sums within blocks by a product with a triangular matrix in float32
and adds the blocks' exclusive totals, as the JAX function does.
"""

from __future__ import annotations

import torch


def blocked_cumsum(x, block: int = 256):
    """Inclusive cumsum of ``x`` [..., M] (float or integer) along the last
    axis; M is padded up to a multiple of ``block``. Integer inputs come
    back rounded to their dtype (exact while the sums stay below 2^24)."""
    xf = x.to(torch.float32)
    m = xf.shape[-1]
    pad = (-m) % block
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    nb = xf.shape[-1] // block
    xb = xf.reshape(xf.shape[:-1] + (nb, block))
    tri = torch.tril(torch.ones((block, block), dtype=torch.float32,
                                device=x.device))
    within = torch.einsum("...nb,cb->...nc", xb, tri)
    totals = within[..., -1]
    offsets = torch.cumsum(totals, dim=-1) - totals
    out = (within + offsets[..., None]).reshape(xf.shape[:-1]
                                                + (nb * block,))[..., :m]
    if not x.dtype.is_floating_point:
        out = torch.round(out).to(x.dtype)
    return out


def blocked_cumprod_excl(x, axis: int = 0, block: int = 16):
    """(exclusive, inclusive) cumprod of ``x`` along ``axis``, whose length
    must be a multiple of ``block``. x: positive values (e.g. 1 - alpha)."""
    x = torch.movedim(x, axis, 0)
    k = x.shape[0]
    if k % block:
        raise ValueError(f"axis length {k} is not a multiple of {block}")
    nb = k // block
    xb = x.reshape((nb, block) + x.shape[1:])
    parts = [xb[:, 0]]
    for i in range(1, block):
        parts.append(parts[-1] * xb[:, i])
    within = torch.stack(parts, dim=1)               # [nb, block, ...]
    totals = within[:, -1]
    offs = [torch.ones_like(totals[0])]
    for i in range(1, nb):
        offs.append(offs[-1] * totals[i - 1])
    offsets = torch.stack(offs, dim=0)               # [nb, ...]
    incl = (within * offsets[:, None]).reshape((k,) + x.shape[1:])
    excl = torch.cat([torch.ones_like(incl[:1]), incl[:-1]], dim=0)
    return torch.movedim(excl, 0, axis), torch.movedim(incl, 0, axis)
