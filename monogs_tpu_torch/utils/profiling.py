"""Profiling: stage timers and per-frame profile logs.

Counterpart of ``monogs_tpu/utils/profiling.py``:
  1. wall-clock stage timers, averages logged every ``period`` frames
     (``StageTimers``);
  2. per-frame profile records saved as run-frame%06d.npz, the same layout
     as the JAX package's, so that either package's logs load in the other
     (``ProfileLogger``, ``load_profile_logs``).
Device traces (``trace``) arrive with the profiling slice and raise.
"""

from __future__ import annotations

import contextlib
import glob
import os
import time
from collections import defaultdict

import numpy as np

from .logging import Log


class StageTimers:
    """Accumulate wall-clock per stage; log averages every `period` frames.
    ``sums``/``counts`` restart after each log; ``totals``/``total_counts``
    cover the whole run."""

    def __init__(self, period: int = 10, tag: str = "Prof"):
        self.period = period
        self.tag = tag
        self.sums = defaultdict(float)
        self.counts = defaultdict(int)
        self.totals = defaultdict(float)
        self.total_counts = defaultdict(int)
        self.frames = 0

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.add(name, time.time() - t0)

    def add(self, name: str, seconds: float):
        self.sums[name] += seconds
        self.counts[name] += 1
        self.totals[name] += seconds
        self.total_counts[name] += 1

    def frame_done(self):
        self.frames += 1
        if self.frames % self.period == 0:
            for name in sorted(self.sums):
                avg = self.sums[name] / max(self.counts[name], 1)
                Log(f"avg {name}: {avg * 1000:.2f} ms", tag=self.tag)
            self.sums.clear()
            self.counts.clear()


class ProfileLogger:
    """Per-frame profile records -> run-frame%06d.npz every save_period
    frames."""

    def __init__(self, logdir: str, save_period: int = 10):
        self.logdir = logdir
        self.save_period = save_period
        self.records: list[dict] = []
        self._last_frame = 0
        os.makedirs(logdir, exist_ok=True)

    def log_frame(self, frame_idx: int, **fields):
        rec = {"frame": frame_idx, "timestamp": time.time()}
        rec.update(fields)
        self.records.append(rec)
        self._last_frame = frame_idx
        if (frame_idx + 1) % self.save_period == 0:
            self.flush(frame_idx)

    def close(self):
        """Flush the records after the last period boundary."""
        if self.records:
            self.flush(self._last_frame)

    def flush(self, frame_idx: int):
        if not self.records:
            return
        fname = os.path.join(self.logdir, f"run-frame{frame_idx:06d}.npz")
        keys = sorted({k for r in self.records for k in r})
        arrays = {}
        for k in keys:
            vals = [r.get(k, np.nan) for r in self.records]
            try:
                arrays[k] = np.asarray(vals)
            except ValueError:
                arrays[k] = np.asarray([str(v) for v in vals])
        np.savez(fname, **arrays)
        self.records = []


def load_profile_logs(logdir: str) -> dict:
    """Every run-frame*.npz under ``logdir`` (or one level down, where
    ProfileLogger writes under log_basedir/<timestamp>/) as
    {frame_idx: record}. allow_pickle because ``flush`` can fall back to
    object arrays; the logs are the run's own local files."""
    out: dict[int, dict] = {}
    names = sorted(
        glob.glob(os.path.join(logdir, "run-frame*.npz"))
        or glob.glob(os.path.join(logdir, "*", "run-frame*.npz"))
    )
    for fname in names:
        with np.load(fname, allow_pickle=True) as z:
            keys = list(z.keys())
            for i, fi in enumerate(np.asarray(z["frame"], np.int64)):
                out[int(fi)] = {k: z[k][i] for k in keys}
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Device traces (torch.profiler) arrive with the profiling slice."""
    raise NotImplementedError(
        "profiling.trace (a device trace of the port) arrives with the "
        "profiling slice")
    yield  # pragma: no cover
