"""Tile binning for the tiled rasterizer.

Counterpart of ``monogs_tpu/render/tiling.py``: ``compact_sort``,
``compact_indices`` and the
duplicated-instance macro binning of the CUDA rasterizer (one global sort
of ``macro_id * R + margin_bit + depth_rank`` keys, R = pow2 >= N, per-macro
lists as contiguous ranges found with ``searchsorted``) with the exact
``k_big`` sidecar for splats whose span exceeds ``span_cap`` and strict-first
priority under a pixel margin. Keys keep the reference's int32 value range
(the caller asserts ``n_macro * 2R < 2**31``); they are held as int64 so
that they index directly. Equal keys are equal integers, so the sort order
is fully determined.
"""

from __future__ import annotations

import torch

_INT32_MAX = 2**31 - 1


def compact_sort(mask, capacity: int):
    """(idx [capacity], valid [capacity]): the first ``capacity`` set bits
    of ``mask`` in order (unset bits sort to the sentinel M)."""
    m = mask.shape[0]
    iota = torch.arange(m, device=mask.device)
    keys = torch.where(mask, iota, torch.full_like(iota, m))
    if m < capacity:
        keys = torch.cat([keys, torch.full((capacity - m,), m,
                                           dtype=keys.dtype,
                                           device=mask.device)])
    skeys = torch.sort(keys).values[:capacity]
    valid = skeys < m
    return torch.where(valid, skeys, torch.zeros_like(skeys)), valid


def compact_indices(mask, capacity: int):
    """(idx [capacity], valid [capacity], total): indices of the first
    ``capacity`` set bits of ``mask`` in order (cumsum and a binary search,
    no host sync); entries beyond the population count point at 0."""
    cs = torch.cumsum(mask.long(), 0)
    total = cs[-1]
    targets = torch.arange(1, capacity + 1, device=mask.device)
    idx = torch.searchsorted(cs, targets, side="left")
    valid = targets <= torch.clamp(total, max=capacity)
    return torch.where(valid, idx, torch.zeros_like(idx)), valid, total


def grid_span(u, v, radius, n_x: int, n_y: int, cell: int):
    """Inclusive cell rect (cx0, cy0, w, h) of the grid cells whose pixel
    rect overlaps the splat box [u-r, u+r] x [v-r, v+r], clipped to the
    grid. The box must overlap the grid (see the JAX counterpart)."""
    cellf = float(cell)
    cx0 = torch.clamp(torch.ceil((u - radius - (cellf - 1.0)) / cellf), 0, n_x - 1)
    cx1 = torch.clamp(torch.floor((u + radius) / cellf), 0, n_x - 1)
    cy0 = torch.clamp(torch.ceil((v - radius - (cellf - 1.0)) / cellf), 0, n_y - 1)
    cy1 = torch.clamp(torch.floor((v + radius) / cellf), 0, n_y - 1)
    cx0 = cx0.long()
    cy0 = cy0.long()
    return cx0, cy0, cx1.long() - cx0 + 1, cy1.long() - cy0 + 1


def macro_instance_bin(u, v, radius, valid, n_mx: int, n_my: int, cell: int,
                       k_macro: int, span_cap: int = 16, k_big: int = 128,
                       radius_strict=None):
    """Duplicated-instance macro binning (one global sort).

    u, v, radius, valid: [N] in DEPTH-SORTED order (row index == depth
    rank). Returns (sel [n_macro, k_macro] rank indices, vld, n_overflow).
    With ``radius_strict`` (un-inflated radius when ``radius`` carries a
    margin) cells truly overlapped claim capacity before margin-only cells;
    the lists are then not depth-interleaved across the two classes."""
    if radius_strict is None:
        radius_strict = radius
    dev = u.device
    n = u.shape[0]
    n_macro = n_mx * n_my
    r_pow2 = 1 << max(1, (n - 1).bit_length())
    r2 = 2 * r_pow2
    rank = torch.arange(n, device=dev)[:, None]

    gw = n_mx * cell - 1
    gh = n_my * cell - 1
    valid = (valid & (u + radius >= 0) & (u - radius <= gw)
             & (v + radius >= 0) & (v - radius <= gh))

    mx0, my0, w, h = grid_span(u, v, radius, n_mx, n_my, cell)
    span = w * h
    sx0, sy0, sw, sh = grid_span(u, v, radius_strict, n_mx, n_my, cell)

    if k_big > 0:
        big = valid & (span > span_cap)
        big_pos = torch.cumsum(big.long(), 0) - 1
        in_sidecar = big & (big_pos < k_big)
    else:
        in_sidecar = torch.zeros_like(valid)
    norm = valid & ~in_sidecar

    overflow = norm & (span > span_cap)
    ew = torch.where(overflow, sw, w)
    ex0 = torch.where(overflow, sx0, mx0)
    ey0 = torch.where(overflow, sy0, my0)
    espan = torch.where(overflow, sw * sh, span)
    n_overflow = torch.sum(norm & (sw * sh > span_cap))

    c = torch.arange(span_cap, device=dev)[None, :]
    # ew is 0 only for a zero-radius (culled) splat between pixel centres,
    # whose instances are masked out below; the floor keeps the division
    # defined
    dy = torch.div(c, torch.clamp(ew, min=1)[:, None], rounding_mode="floor")
    dx = c - dy * ew[:, None]
    cx = ex0[:, None] + dx
    cy = ey0[:, None] + dy
    m_id = cy * n_mx + cx
    strict = ((cx >= sx0[:, None]) & (cx < (sx0 + sw)[:, None])
              & (cy >= sy0[:, None]) & (cy < (sy0 + sh)[:, None]))
    ok = norm[:, None] & (c < torch.clamp(espan, max=span_cap)[:, None])
    keys = torch.where(
        ok, m_id * r2 + torch.where(strict, 0, r_pow2) + rank,
        torch.full_like(m_id, _INT32_MAX))

    skeys = torch.sort(keys.reshape(-1)).values
    bounds = torch.arange(n_macro + 1, device=dev) * r2
    off = torch.searchsorted(skeys, bounds, side="left")
    cnt = off[1:] - off[:-1]

    j = torch.arange(k_macro, device=dev)[None, :]
    pos = torch.clamp(off[:-1, None] + j, max=n * span_cap - 1)
    val = skeys[pos]
    vld = j < torch.clamp(cnt, max=k_macro)[:, None]
    enc = torch.where(vld, val & (r2 - 1), torch.full_like(val, r2))

    if k_big > 0:
        big_idx, big_vld = compact_sort(in_sidecar, k_big)
        bu, bv = u[big_idx], v[big_idx]
        br, brs = radius[big_idx], radius_strict[big_idx]
        mids = torch.arange(n_macro, device=dev)
        gx0 = (mids % n_mx * cell).float()[:, None]
        gy0 = (torch.div(mids, n_mx, rounding_mode="floor") * cell).float()[:, None]

        def overlap(r):
            return (big_vld[None, :]
                    & (bu[None, :] + r[None, :] >= gx0)
                    & (bu[None, :] - r[None, :] <= gx0 + cell - 1)
                    & (bv[None, :] + r[None, :] >= gy0)
                    & (bv[None, :] - r[None, :] <= gy0 + cell - 1))

        ov, ovs = overlap(br), overlap(brs)
        bkeys = torch.where(
            ov, big_idx[None, :] + torch.where(ovs, 0, r_pow2),
            torch.full_like(ov, r2, dtype=torch.long))
        allk = torch.sort(torch.cat([enc, bkeys], dim=1), dim=1).values
        enc = allk[:, :k_macro]
        vld = enc < r2

    sel = torch.where(vld, enc & (r_pow2 - 1), torch.zeros_like(enc))
    return sel, vld, n_overflow


def tile_overlap_mask(mean2d, radius, valid, x0, y0, x1, y1):
    """Which Gaussians' 3-sigma boxes meet the pixel rect [x0, x1) x [y0, y1)
    (mean2d [M, 2], radius [M]; the rect spans pixel centres x0..x1-1)."""
    u, v = mean2d[:, 0], mean2d[:, 1]
    return (valid & (u + radius >= x0) & (u - radius <= x1 - 1)
            & (v + radius >= y0) & (v - radius <= y1 - 1))
