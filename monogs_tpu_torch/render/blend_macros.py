"""The macro-list blends (the "pallas" and "pallas_compact" backends): CUDA
kernels beside their plain versions.

Counterpart of ``monogs_tpu/render/pallas_blend.py`` (the masked walk) and
``monogs_tpu/render/pallas_compact.py`` (the compact blend). Without frozen
lists, ``render`` hands the blend the depth-ordered macro lists
``data_m = packed[order][sel_m]`` [Tm, Km, 16], their origins ``xy0``
[Tm, 2] and valid-row counts ``counts`` [Tm] (float). A row enters a fine
tile of its macro when it is valid (``row < counts[m]``) and its 3-sigma box
overlaps the tile. The masked walk composites every such row, with no
``k_fine`` cap; the compact blend only the first ``k_fine`` in list (depth)
order, the truncation of the XLA "sort" fine stage, so it equals the XLA
render at the same ``k_fine``. Outputs are [Tm, ft, P, 8] with columns
(r, g, b, depth, acc, 0, 0, 0).

- ``blend_macros`` / ``blend_macros_vjp`` take ``k_fine``: None for the
  masked walk, else the compact blend's cap. For CUDA tensors they launch
  ``macro_fwd_kernel`` / ``macro_bwd_kernel`` (``csrc/blend_macros.cu``)
  over the first ``cap`` rows that enter each tile (cap = Km, or
  ``k_fine``), with a scratch in device memory that the library sizes
  (``macro_scratch_bytes``: the row index and checkpoints beyond shared
  memory, the VJP's compact partials and slot map); for CPU tensors they
  run the plain versions. Launches are counted in ``LAUNCHES``, per
  backend. A CUDA tensor never falls back to the plain version.
- The plain masked walk is the list blend's plain version
  (``blend_lists._forward_plain``) over all Km rows of each (macro, fine
  tile), the rows that do not enter the tile carrying LOGO = -1e30; its VJP
  sums the fine tiles' row cotangents. The plain compaction
  (``compact_rows``) takes the first ``k_fine`` set entries of each tile's
  overlap mask by a cumsum, as the one-hot compaction of the TPU kernel
  (its ``_batched_compact``) without the matrix unit; its VJP scatters the
  compacted rows' cotangents back to their macro rows (each row at most
  once per fine tile) and sums over the fine tiles. Both loop over chunks
  of macros, so that their dense intermediates stay within a few hundred MB
  each.
- ``blend_macros_fn`` is differentiable in ``data_m``: a
  ``torch.autograd.Function`` that saves only its inputs and recomputes the
  forward in its backward (the VJP kernel's checkpointed forward).
"""

from __future__ import annotations

from typing import Optional

import torch

from .blend_lists import (
    _F, _LOGO, _RAD, _U, _V, _check, _dd_from_gouts_plain, _forward_plain,
    _on_cuda, _raise_on, _stream, count_launch,
)

LAUNCHES = {"macro_fwd": 0, "macro_bwd": 0, "compact_fwd": 0,
            "compact_bwd": 0}

# elements of one dense [tiles, K, P] intermediate of a plain-version chunk
_PLAIN_ELEMS = 1 << 26


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain version

def fine_origins(xy0, tile: int, ft_side: int):
    """(tx0, ty0) [Tm, ft]: the fine tiles' pixel origins, fine tile f of
    macro m at xy0[m] + tile * (f % ft_side, f // ft_side)."""
    f = torch.arange(ft_side * ft_side, device=xy0.device)
    fx = (f % ft_side).to(torch.float32) * tile
    fy = (f // ft_side).to(torch.float32) * tile
    return xy0[:, 0:1] + fx, xy0[:, 1:2] + fy


def overlap_mask(data_m, counts, tx0, ty0, tile: int):
    """[Tm, ft, Km] bool: the macro row is valid (row < counts) and its
    3-sigma box overlaps the fine tile (pallas_blend._g_and_alpha)."""
    km = data_m.shape[1]
    rows = torch.arange(km, device=data_m.device).to(torch.float32)
    row_ok = rows[None, :] < counts[:, None]                  # [Tm, Km]
    u, v = data_m[:, None, :, _U], data_m[:, None, :, _V]
    rad = data_m[:, None, :, _RAD]
    x0, y0 = tx0[..., None], ty0[..., None]
    return (row_ok[:, None, :]
            & (u + rad >= x0) & (u - rad <= x0 + tile - 1)
            & (v + rad >= y0) & (v - rad <= y0 + tile - 1))


def _masked(d, mask):
    """Rows d [..., K, F] with LOGO = -1e30 where ``mask`` is false."""
    logo = torch.where(mask, d[..., _LOGO],
                       torch.full_like(d[..., _LOGO], -1e30))
    return torch.cat([d[..., :_LOGO], logo[..., None], d[..., _LOGO + 1:]],
                     dim=-1)


def macro_chunks(n_macro: int, ft: int, k: int, p: int):
    """Slices of macros whose dense [chunk * ft, k, p] intermediates stay
    within _PLAIN_ELEMS elements."""
    step = max(1, _PLAIN_ELEMS // max(1, ft * k * p))
    return [slice(i, min(i + step, n_macro)) for i in range(0, n_macro, step)]


def _walk_rows(data_m, xy0, counts, tile, ft_side, sl):
    """The chunk ``sl``'s per-(macro, fine tile) rows [n * ft, Km, F] with
    the rows outside each tile masked, and their origins [n * ft]."""
    tx0, ty0 = fine_origins(xy0[sl], tile, ft_side)
    dm = data_m[sl]
    mask = overlap_mask(dm, counts[sl], tx0, ty0, tile)
    d = _masked(dm[:, None].expand(-1, mask.shape[1], -1, -1), mask)
    return d.reshape(-1, dm.shape[1], _F), tx0.reshape(-1), ty0.reshape(-1)


def blend_macros_plain(data_m, xy0, counts, pmat, tile: int, ft_side: int,
                       width: int, height: int):
    n_macro, km, _ = data_m.shape
    ft, p = ft_side * ft_side, pmat.shape[1]
    outs = []
    for sl in macro_chunks(n_macro, ft, km, p):
        d, tx0, ty0 = _walk_rows(data_m, xy0, counts, tile, ft_side, sl)
        o = _forward_plain(d, tx0, ty0, pmat, width, height)["outs"]
        outs.append(o.reshape(-1, ft, p, 8))
    return torch.cat(outs, 0)


def blend_macros_vjp_plain(data_m, xy0, counts, pmat, g_outs, tile: int,
                           ft_side: int, width: int, height: int):
    n_macro, km, _ = data_m.shape
    ft, p = ft_side * ft_side, pmat.shape[1]
    dds = []
    for sl in macro_chunks(n_macro, ft, km, p):
        d, tx0, ty0 = _walk_rows(data_m, xy0, counts, tile, ft_side, sl)
        f = _forward_plain(d, tx0, ty0, pmat, width, height)
        dd = _dd_from_gouts_plain(f, pmat, g_outs[sl].reshape(-1, p, 8))
        dds.append(dd.reshape(-1, ft, km, _F).sum(1))
    return torch.cat(dds, 0)


def compact_rows(mask, k_fine: int):
    """(idx, vld) [..., k_fine]: the indices of the first ``k_fine`` set
    entries of ``mask`` [..., Km] in order (vld marks the slots filled;
    empty slots point at row 0)."""
    km = mask.shape[-1]
    cs = torch.cumsum(mask.to(torch.int64), -1)
    slot = torch.where(mask & (cs <= k_fine), cs - 1,
                       torch.full_like(cs, k_fine))
    rows = torch.arange(km, device=mask.device).expand_as(cs)
    idx = torch.zeros(mask.shape[:-1] + (k_fine + 1,), dtype=torch.int64,
                      device=mask.device)
    # every filled slot receives exactly one row; the overflow slot k_fine
    # collects the rest and is dropped
    idx = idx.scatter(-1, slot, rows)[..., :k_fine]
    vld = (torch.arange(k_fine, device=mask.device)
           < torch.clamp(cs[..., -1:], max=k_fine))
    return torch.where(vld, idx, torch.zeros_like(idx)), vld


def compact_chunk(data_m, xy0, counts, tile, ft_side, k_fine, sl):
    """The chunk ``sl``'s compacted rows [n * ft, k_fine, F] (empty slots
    masked), their macro-row indices and validity [n, ft, k_fine] and the
    tiles' origins [n * ft]."""
    tx0, ty0 = fine_origins(xy0[sl], tile, ft_side)
    dm = data_m[sl]
    idx, vld = compact_rows(overlap_mask(dm, counts[sl], tx0, ty0, tile),
                            k_fine)
    d = torch.gather(dm[:, None].expand(-1, idx.shape[1], -1, -1), 2,
                     idx[..., None].expand(-1, -1, -1, _F))
    return (_masked(d, vld).reshape(-1, k_fine, _F), idx, vld,
            tx0.reshape(-1), ty0.reshape(-1))


def blend_compact_plain(data_m, xy0, counts, pmat, tile: int, ft_side: int,
                        width: int, height: int, k_fine: int):
    n_macro = data_m.shape[0]
    ft, p = ft_side * ft_side, pmat.shape[1]
    outs = []
    for sl in macro_chunks(n_macro, ft, k_fine, p):
        d, _, _, tx0, ty0 = compact_chunk(data_m, xy0, counts, tile, ft_side,
                                          k_fine, sl)
        o = _forward_plain(d, tx0, ty0, pmat, width, height)["outs"]
        outs.append(o.reshape(-1, ft, p, 8))
    return torch.cat(outs, 0)


def blend_compact_vjp_plain(data_m, xy0, counts, pmat, g_outs, tile: int,
                            ft_side: int, width: int, height: int,
                            k_fine: int):
    n_macro, km, _ = data_m.shape
    ft, p = ft_side * ft_side, pmat.shape[1]
    dds = []
    for sl in macro_chunks(n_macro, ft, k_fine, p):
        d, idx, vld, tx0, ty0 = compact_chunk(data_m, xy0, counts, tile,
                                              ft_side, k_fine, sl)
        f = _forward_plain(d, tx0, ty0, pmat, width, height)
        ddc = _dd_from_gouts_plain(f, pmat, g_outs[sl].reshape(-1, p, 8))
        ddc = ddc.reshape(idx.shape + (_F,))
        # per fine tile, each filled slot back to its macro row (the
        # transposed one-hot of pallas_compact.py); empty slots go to a
        # spare row km that is dropped
        tgt = torch.where(vld, idx, torch.full_like(idx, km))
        part = torch.zeros(idx.shape[:2] + (km + 1, _F), dtype=ddc.dtype,
                           device=ddc.device)
        part = part.scatter(2, tgt[..., None].expand(-1, -1, -1, _F), ddc)
        dds.append(part[:, :, :km].sum(1))
    return torch.cat(dds, 0)


# ------------------------------------------------------------------ kernels

def check_macro_inputs(data_m, xy0, counts, pmat, tile: int):
    """Validate the kernels' inputs; returns (n_macro, km, p)."""
    n_macro, km, nf = data_m.shape
    p = pmat.shape[1]
    if nf != _F:
        raise ValueError(f"data_m: expected {_F} packed columns, got {nf}")
    if p != tile * tile or p % 32 or not 32 <= p <= 1024:
        raise ValueError(f"pmat: P={p} must be tile^2 = {tile * tile}, a "
                         f"multiple of 32 in [32, 1024]")
    _check("data_m", data_m, (n_macro, km, _F))
    _check("xy0", xy0, (n_macro, 2))
    _check("counts", counts, (n_macro,))
    _check("pmat", pmat, (6, p))
    if data_m.data_ptr() % 16:
        raise ValueError("data_m: the kernels copy rows 16 bytes at a time, "
                         "so its data must start on a 16-byte boundary")
    return n_macro, km, p


def _lib():
    from .._build import library

    return library("blend_macros")


def _scratch(lib, fwd: bool, n_macro, km, cap, p, ft_side, device):
    """The kernels' scratch in device memory, sized by the library (the
    parts of the row index and of the checkpoints beyond shared memory,
    and the VJP's compact partials and slot map)."""
    n = int(lib.macro_scratch_bytes(int(fwd), n_macro, km, cap, p, ft_side))
    return torch.empty(max(n, 16), dtype=torch.uint8, device=device)


def macro_fwd_cuda(data_m, xy0, counts, pmat, tile, ft_side, width, height,
                   cap: int):
    """Launch macro_fwd_kernel over the first ``cap`` rows that enter each
    (macro, fine tile)."""
    n_macro, km, p = check_macro_inputs(data_m, xy0, counts, pmat, tile)
    ft = ft_side * ft_side
    outs = torch.empty((n_macro, ft, p, 8), dtype=torch.float32,
                       device=data_m.device)
    lib = _lib()
    scratch = _scratch(lib, True, n_macro, km, cap, p, ft_side,
                       data_m.device)
    rc = lib.macro_fwd(
        data_m.data_ptr(), xy0.data_ptr(), counts.data_ptr(),
        pmat.data_ptr(), outs.data_ptr(), scratch.data_ptr(), n_macro, km,
        cap, p, tile, ft_side, width, height, _stream())
    _raise_on(rc, "macro_fwd")
    return outs


def macro_bwd_cuda(data_m, xy0, counts, pmat, g_outs, tile, ft_side, width,
                   height, cap: int):
    """Launch macro_bwd_kernel (each fine tile's compact partials) and the
    fixed-order sum of the partials over the fine tiles."""
    n_macro, km, p = check_macro_inputs(data_m, xy0, counts, pmat, tile)
    ft = ft_side * ft_side
    _check("g_outs", g_outs, (n_macro, ft, p, 8))
    lib = _lib()
    scratch = _scratch(lib, False, n_macro, km, cap, p, ft_side,
                       data_m.device)
    ddata = torch.empty_like(data_m)
    rc = lib.macro_bwd(
        data_m.data_ptr(), xy0.data_ptr(), counts.data_ptr(),
        pmat.data_ptr(), g_outs.data_ptr(), scratch.data_ptr(),
        ddata.data_ptr(), n_macro, km, cap, p, tile, ft_side, width, height,
        _stream())
    _raise_on(rc, "macro_bwd")
    return ddata


def _backend(k_fine: Optional[int]) -> str:
    return "macro" if k_fine is None else "compact"


def _cap(data_m, k_fine: Optional[int]) -> int:
    km = data_m.shape[1]
    return km if k_fine is None else min(k_fine, km)


def blend_macros(data_m, xy0, counts, pmat, tile: int, ft_side: int,
                 width: int, height: int, k_fine: Optional[int] = None):
    """Blend every (macro, fine tile) over the rows of its macro list that
    enter it: all of them (``k_fine`` None, the masked walk) or the first
    ``k_fine`` (the compact blend). data_m: [Tm, Km, F]; xy0: [Tm, 2];
    counts: [Tm] float; pmat: [6, P]. Returns [Tm, ft, P, 8]."""
    if not _on_cuda(data_m):
        if k_fine is None:
            return blend_macros_plain(data_m, xy0, counts, pmat, tile,
                                      ft_side, width, height)
        return blend_compact_plain(data_m, xy0, counts, pmat, tile, ft_side,
                                   width, height, k_fine)
    outs = macro_fwd_cuda(data_m, xy0, counts, pmat, tile, ft_side, width,
                          height, _cap(data_m, k_fine))
    count_launch(LAUNCHES, _backend(k_fine) + "_fwd")
    return outs


def blend_macros_vjp(data_m, xy0, counts, pmat, g_outs, tile: int,
                     ft_side: int, width: int, height: int,
                     k_fine: Optional[int] = None):
    """Cotangent [Tm, Km, F] of ``data_m`` from output cotangents g_outs
    [Tm, ft, P, 8] (columns 5-7 are not read: their features are 0)."""
    if not _on_cuda(data_m):
        if k_fine is None:
            return blend_macros_vjp_plain(data_m, xy0, counts, pmat, g_outs,
                                          tile, ft_side, width, height)
        return blend_compact_vjp_plain(data_m, xy0, counts, pmat, g_outs,
                                       tile, ft_side, width, height, k_fine)
    dd = macro_bwd_cuda(data_m, xy0, counts, pmat, g_outs, tile, ft_side,
                        width, height, _cap(data_m, k_fine))
    count_launch(LAUNCHES, _backend(k_fine) + "_bwd")
    return dd


class _BlendMacros(torch.autograd.Function):
    """``blend_macros``, differentiable in ``data_m`` (the custom VJPs of
    JAX ``blend_macros_pallas`` and ``blend_macros_compact``)."""

    @staticmethod
    def forward(ctx, data_m, xy0, counts, pmat, tile, ft_side, width, height,
                k_fine):
        ctx.save_for_backward(data_m, xy0, counts, pmat)
        ctx.args = (tile, ft_side, width, height)
        ctx.k_fine = k_fine
        return blend_macros(data_m, xy0, counts, pmat, tile, ft_side, width,
                            height, k_fine=k_fine)

    @staticmethod
    def backward(ctx, g_outs):
        data_m, xy0, counts, pmat = ctx.saved_tensors
        dd = blend_macros_vjp(data_m, xy0, counts, pmat, g_outs.contiguous(),
                              *ctx.args, k_fine=ctx.k_fine)
        return (dd,) + (None,) * 8


def blend_macros_fn(data_m, xy0, counts, pmat, tile: int, ft_side: int,
                    width: int, height: int, k_fine: Optional[int] = None):
    """``blend_macros`` with a gradient to ``data_m`` through the VJP
    kernel."""
    return _BlendMacros.apply(data_m, xy0, counts, pmat, tile, ft_side, width,
                              height, k_fine)
