"""Injected random draws for a whole SLAM run.

The JAX package's frontend and backend each split a ``jax.random`` key per
call that draws (the frontend per tracked frame; the backend per
insertion, ``map_iters`` call and colour-refinement chunk). The port draws
from a ``torch.Generator`` per thread instead, and each of those calls
takes injected draws (``TrackDraws``, ``MapDraws``, insertion's
``keep_draw``, refinement's ``views``). A ``DrawSource`` hands them out in
call order; whatever it returns as None is drawn from the calling thread's
generator. The base class injects nothing. A test subclasses it to replay
another package's key chain, so that a run through both packages can be
compared call for call.

The frontend calls only ``track`` and the backend only the others, so a
source that keeps one chain for each is safe across the two threads.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .mapping import MapDraws
from .tracking import TrackDraws


class DrawSource:
    """Hands each drawing call of the frontend and backend its draws."""

    def track(self) -> Optional[TrackDraws]:
        """Draws for the next ``track_frame`` call."""
        return None

    def insert(self, h: int, w: int) -> Optional[torch.Tensor]:
        """``keep_draw`` [h, w] for the next ``keyframe_to_gaussians``."""
        return None

    def map(self, n_iters: int, slots: int) -> Optional[MapDraws]:
        """Draws for the next ``map_iters`` call of ``n_iters`` iterations.
        ``slots`` is the JAX package's batch size for the call (1 at
        initialisation, else window_size + pool_size); the backend's
        staged views are its first rows, so per-view draws of ``slots``
        rows serve them."""
        return None

    def refine(self, n_iters: int, n_valid: int) -> Optional[Sequence[int]]:
        """``views`` for the next ``color_refinement_iters`` chunk of
        ``n_iters`` iterations over ``n_valid`` staged views."""
        return None
