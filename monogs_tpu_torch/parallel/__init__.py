"""Sharded mapping over ``torch.distributed`` (JAX ``monogs_tpu/parallel``):
the view batch (``mesh.py``) or the map itself (``gauss.py``,
``gauss_iters.py``) sharded over the ranks of a ``DeviceMesh``; ``launch.py``
brings the ranks up for the SLAM runtime, ``comm.py`` holds the
collectives."""

from .gauss import (  # noqa: F401
    gp_adam_map_step,
    gp_map_loss_grad,
    gp_render_tiles,
    gp_tile_rows,
    make_gauss_mesh,
    shard_gauss,
)
from .mesh import make_mesh, sharded_map_step  # noqa: F401
