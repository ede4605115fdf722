"""Rank functions of the port's parallel tests.

``RankGroup.call`` runs them on every rank of a mesh: the test process is
rank 0 and the others are spawned workers, which import this module (and
never JAX) by name, so they live here and not in a test module. Each
takes the mesh first and returns CPU-picklable results."""

from __future__ import annotations

import os

from monogs_tpu_torch.parallel import comm
from monogs_tpu_torch.parallel.gauss import (
    gp_map_loss_grad, gp_render_tiles, gp_tile_rows, shard_gauss,
)
from monogs_tpu_torch.parallel.mesh import sharded_map_step


def view_step(mesh, m, cams, it_count, intr, cfg, mcfg, hyper):
    """``sharded_map_step``: (parameters, poses, exposures a / b, loss)."""
    m2, cams2, loss = sharded_map_step(m, cams, it_count, mesh, intr, cfg,
                                       mcfg, hyper)
    return tuple(m2.params), cams2.T, cams2.ea, cams2.eb, loss


def gauss_rows(mesh, gauss, T, intr, cfg, margin):
    """``gp_tile_rows`` of the rank's block: (d, vld)."""
    return gp_tile_rows(shard_gauss(gauss, mesh), T, intr, cfg, margin,
                        mesh.get_group("gauss"))


def gauss_render(mesh, gauss, T, intr, cfg, margin):
    """``gp_render_tiles``: (colour, depth, acc) in tile space."""
    return gp_render_tiles(shard_gauss(gauss, mesh), T, intr, cfg, margin,
                           mesh.get_group("gauss"))


def gauss_grad(mesh, gauss, T, intr, cfg, gt_t, mask_t, ea, eb, margin):
    """``gp_map_loss_grad``: (loss, the leaves' gradients gathered over the
    ranks in rank order, g_ea, g_eb)."""
    group = mesh.get_group("gauss")
    loss, g, gea, geb = gp_map_loss_grad(
        shard_gauss(gauss, mesh), T, intr, cfg, gt_t, mask_t, ea, eb,
        margin=margin, group=group)
    return loss, comm.gather_cat(list(g), group, (0,) * 5), gea, geb


def _raise_where_unpickled(value: float, pid: int):
    if os.getpid() != pid:
        raise ValueError("injected worker failure")
    return WorkerBoom(value)


class WorkerBoom(float):
    """A float that raises where it is unpickled in another process than
    the one that made it: in a config value it reaches a worker rank in a
    call's header, and only the worker raises."""

    def __new__(cls, value):
        out = super().__new__(cls, value)
        out.pid = os.getpid()
        return out

    def __reduce__(self):
        return _raise_where_unpickled, (float(self), self.pid)
