"""The collectives of the sharded mapping loops, over ``torch.distributed``.

The JAX package's ``psum``, ``pmax`` and ``all_gather`` over a named mesh
axis become collectives over the ``ProcessGroup`` of that mesh dimension
(``DeviceMesh.get_group(name)``). Every rank calls them in the same order
with tensors of the same shapes; the sharded loops take each decision that
leads to a collective from the Python iteration counter, never from one
rank's tensor, so the order is the same on every rank.

NCCL runs every collective on the rank's own card. Gloo (the CPU, and
ranks that share one card) takes CPU tensors and, in the card's torch
2.11, CUDA tensors for every collective tried, faster than staging them
through host memory (``scripts/port_gloo_cuda_probe.py``), so no
collective is staged. Boolean tensors travel as uint8.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

def all_reduce_(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` in place (sum or max); every rank ends
    with the same bits."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(x, red, group=group)
    return x


def broadcast_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of the group's first rank, in place on every rank."""
    dist.broadcast(x, dist.get_global_rank(group, 0), group=group)
    return x


def _all_gather(x: torch.Tensor, group) -> list:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def gather_cat(tensors: Sequence[torch.Tensor], group,
               dims: Sequence[int]) -> list:
    """Each tensor of every rank concatenated in rank order along its dim
    (``all_gather`` of shards of equal shape): one collective per dtype,
    over the flattened tensors of that dtype."""
    out = [None] * len(tensors)
    wire, groups = _by_dtype(tensors)
    for idx in groups.values():
        parts = _all_gather(torch.cat([wire[i].reshape(-1) for i in idx]),
                            group)
        off = 0
        for i in idx:
            n = wire[i].numel()
            y = torch.cat([p[off:off + n].reshape(wire[i].shape)
                           for p in parts], dim=dims[i])
            out[i] = y.to(torch.bool) if tensors[i].dtype == torch.bool else y
            off += n
    return out


def _by_dtype(tensors):
    """(tensors with booleans as uint8, {dtype: [indices]})."""
    wire = [x.to(torch.uint8) if x.dtype == torch.bool else x
            for x in tensors]
    groups = {}
    for i, x in enumerate(wire):
        groups.setdefault(x.dtype, []).append(i)
    return wire, groups


def broadcast_many(tensors: Sequence[torch.Tensor], group) -> list:
    """The group's first rank's tensors on every rank; the other ranks pass
    tensors of the same shapes and dtypes (their values are not read). One
    collective per dtype, over the flattened tensors of that dtype."""
    out = [None] * len(tensors)
    wire, groups = _by_dtype(tensors)
    for idx in groups.values():
        flat = broadcast_(torch.cat([wire[i].reshape(-1) for i in idx]),
                          group)
        off = 0
        for i in idx:
            n = wire[i].numel()
            y = flat[off:off + n].reshape(wire[i].shape)
            out[i] = y.to(torch.bool) if tensors[i].dtype == torch.bool else y
            off += n
    return out


def all_reduce_flat_(tensors: Sequence[torch.Tensor], group) -> list:
    """The sums over ``group`` of float32 tensors, in one collective over
    their concatenation."""
    flat = torch.cat([x.reshape(-1) for x in tensors])
    all_reduce_(flat, group)
    out, off = [], 0
    for x in tensors:
        out.append(flat[off:off + x.numel()].reshape(x.shape))
        off += x.numel()
    return out


def _cpu(seq):
    return None if seq is None else tuple(
        None if x is None else x.cpu() for x in seq)


def sync_draws(generator: Optional[torch.Generator], draws, groups,
               device):
    """Rank 0's generator state and injected draws on every rank, at the
    start of a sharded call: broadcast over each of ``groups`` in turn,
    the last mesh dimension first, so that rank (0, ..., 0)'s reach every
    rank. Under ``shard_map`` the JAX key is replicated; from here on every
    rank draws what rank 0 draws. Every rank passes a generator or every
    rank passes None. Returns the draws (a ``MapDraws`` of CPU tensors, or
    None)."""
    from ..slam.mapping import MapDraws

    if draws is not None:
        draws = MapDraws(*(_cpu(seq) for seq in draws))
    for g in groups:
        if generator is not None:
            st = generator.get_state().to(device)
            broadcast_(st, g)
            generator.set_state(st.cpu())
        nccl = dist.get_backend(g) == "nccl"
        box = [draws]
        dist.broadcast_object_list(
            box, dist.get_global_rank(g, 0), group=g,
            device=device if nccl else torch.device("cpu"))
        draws = box[0]
    return draws
