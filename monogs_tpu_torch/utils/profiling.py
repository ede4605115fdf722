"""Profiling: stage timers and per-frame profile logs.

Counterpart of ``monogs_tpu/utils/profiling.py``:
  1. wall-clock stage timers, averages logged every ``period`` frames
     (``StageTimers``);
  2. per-frame profile records saved as run-frame%06d.npz, the same layout
     as the JAX package's, so that either package's logs load in the other
     (``ProfileLogger``, ``load_profile_logs``);
  3. device traces: ``trace`` runs ``torch.profiler`` over a block (CUDA
     activity on the card) and writes a Chrome trace that TensorBoard's
     profiler plugin and Perfetto open, and ``trace_summary`` reads a
     profile: device time and launches by kernel and by class, the busiest
     kernels, and the device's idle share over the traced window.
"""

from __future__ import annotations

import contextlib
import glob
import os
import socket
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


# kernel classes of trace_summary: a kernel goes to the first class one of
# whose keys its name contains
KERNEL_CLASSES = (
    ("macro_blend", ("macro_fwd_kernel", "macro_bwd_kernel",
                     "sum_fine_tiles")),
    ("list_blend", ("::fwd_kernel<", "::fo_grad_kernel<", "::jvp8_kernel(",
                    "::map_grad_kernel<", "::map_grad_madd_kernel<",
                    "::bwd_kernel(")),
    ("data", ("remap", "sgbm", "ycc_rgb")),
    ("sort", ("sort", "radix", "Sort")),
    ("elementwise", ("elementwise",)),
    ("reduce", ("reduce",)),
    ("gather_scatter_index", ("index", "gather", "scatter")),
)


def trace_summary(prof, wall_ms, top=8):
    """What a ``torch.profiler`` profile of a ``wall_ms`` window shows.

    Device side (CUDA events): ``kernel_launches``, ``device_busy_ms`` (the
    kernels' device time summed; one stream, so kernels do not overlap),
    ``device_idle_share`` (1 - busy / wall), ``device_ms_by_class``
    (``KERNEL_CLASSES``, the rest under "other") and ``top``, the busiest
    kernels (name, ms, count). Without device events these are 0, None, {}
    and []: a CPU run is never written under a device metric. Host side:
    ``cpu_ops`` (operator calls) and ``top_cpu``, the operators with the
    most self CPU time."""
    from torch.autograd import DeviceType

    kernels, ops = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            kernels[e.key] = (us / 1000.0, e.count)
        elif e.device_type == DeviceType.CPU:
            ops[e.key] = (e.self_cpu_time_total / 1000.0, e.count)
    out = dict(wall_ms=wall_ms, kernel_launches=0, device_busy_ms=None,
               device_idle_share=None, device_ms_by_class={}, top=[])
    if kernels:
        busy = sum(ms for ms, _ in kernels.values())
        by_class = {name: 0.0 for name, _ in KERNEL_CLASSES}
        by_class["other"] = 0.0
        for k, (ms, _) in kernels.items():
            cls = next((n for n, keys in KERNEL_CLASSES
                        if any(x in k for x in keys)), "other")
            by_class[cls] += ms
        out.update(
            kernel_launches=sum(c for _, c in kernels.values()),
            device_busy_ms=busy,
            device_idle_share=max(0.0, 1.0 - busy / wall_ms),
            device_ms_by_class=by_class,
            top=[dict(name=k[:80], ms=ms, count=c) for k, (ms, c) in sorted(
                kernels.items(), key=lambda kv: -kv[1][0])[:top]])
    out["cpu_ops"] = sum(c for _, c in ops.values())
    out["top_cpu"] = [dict(name=k[:80], cpu_ms=ms, count=c)
                      for k, (ms, c) in sorted(ops.items(),
                                               key=lambda kv: -kv[1][0])[:top]]
    return out


class Trace:
    """What ``trace`` recorded, filled in when its block ends: ``path`` of
    the trace file, ``wall_ms`` of the block (up to a synchronisation of
    the card), ``summary`` (``trace_summary``) and the profile itself."""

    path = None
    wall_ms = None
    summary = None
    prof = None


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """Trace the block with ``torch.profiler`` and write
    ``<logdir>/<host>_<pid>.<ns>.pt.trace.json`` (the name TensorBoard's
    profiler plugin reads; Perfetto opens the same file). On a CUDA device
    (the default) it records CUDA activity and the card is synchronised
    before the window closes; a trace with no device event raises, so a
    trace on the card never records the CPU alone. With ``device="cpu"`` it
    records the CPU. Yields a ``Trace``, filled in on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .. import resolve_device

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    os.makedirs(logdir, exist_ok=True)
    res = Trace()
    prof = profile(activities=activities)
    prof.start()
    t0 = time.perf_counter()
    try:
        yield res
        if cuda:
            torch.cuda.synchronize(dev)
        res.wall_ms = 1000.0 * (time.perf_counter() - t0)
    finally:
        prof.stop()
    res.prof = prof
    res.path = os.path.join(
        logdir, f"{socket.gethostname()}_{os.getpid()}."
        f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(res.path)
    res.summary = trace_summary(prof, res.wall_ms)
    if cuda and not res.summary["kernel_launches"]:
        raise RuntimeError(
            f"the trace of {res.wall_ms:.1f} ms on {dev} holds no device "
            "event: CUPTI recorded no CUDA activity (trace file "
            f"{res.path})")
