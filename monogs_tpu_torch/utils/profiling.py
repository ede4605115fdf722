"""Profiling: spans, stage timers and per-frame profile logs.

Counterpart of ``monogs_tpu/utils/profiling.py``:
  1. spans and counters inside the program (``span``, ``count``, read by
     ``span_table`` and ``counters``), recorded only while ``torch.profiler``
     records: a span off costs one attribute read;
  2. stage timers, averages logged every ``period`` frames
     (``StageTimers``), always on, on the card's timeline;
  3. per-frame profile records saved as run-frame%06d.npz, the same layout
     as the JAX package's, so that either package's logs load in the other
     (``ProfileLogger``, ``load_profile_logs``);
  4. device traces: ``trace`` runs ``torch.profiler`` over a block (CUDA
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
import threading
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from .logging import Log


class _Store:
    """The spans and counters recorded while the profiler records: the
    finished and open spans in the order they began, each thread's stack of
    open spans, and the counters."""

    def __init__(self):
        self.spans: list = []
        self.counts: dict = defaultdict(int)
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_STORE = _Store()
_OFF = contextlib.nullcontext()


class _Span:
    """One timed interval: the host's ``perf_counter_ns`` at enter and exit
    and, in a process that has initialised CUDA, a pair of timing events on
    the current stream, read only when ``device_s`` asks (no synchronise
    when the span ends). With ``store`` the span is also recorded: pushed on
    the thread's stack (``parent`` the span open around it, ``call`` the
    outermost one, which identifies e.g. a ``map_iters`` call, and ``it``
    the iteration it belongs to, given or its parent's) and entered as a
    profiler operation, so that it lands in the trace on the device events'
    clock. The operation is a function-scope record: a ``record_function``
    is a user annotation, which the profiler mirrors onto the device's
    timeline as an event of its own that readers of the device events would
    count as device work."""

    __slots__ = ("name", "parent", "call", "it", "t0", "t1", "ev", "_rf",
                 "_store")

    def __init__(self, name: str, store: _Store = None, it=None):
        self.name, self._store, self.it = name, store, it
        self.parent = self.ev = self._rf = self.t1 = None
        self.call = self

    def __enter__(self):
        store = self._store
        if store is not None:
            stack = store.stack()
            if stack:
                self.parent = stack[-1]
                self.call = self.parent.call
                if self.it is None:
                    self.it = self.parent.it
            stack.append(self)
            store.spans.append(self)
            self._rf = torch._C._profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
        if torch.cuda.is_initialized():
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.ev is not None:
            self.ev[1].record()
        if self._store is not None:
            self._rf.__exit__(None, None, None)
            self._store.stack().pop()
        return False

    def host_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def done(self) -> bool:
        """Whether the card has reached the span's end (always on the
        host)."""
        return self.ev is None or self.ev[1].query()

    def device_s(self) -> float:
        """Seconds between the two events on the card's timeline, waiting
        for the card to reach the second; the host's time where no event
        was recorded (the device is the host)."""
        if self.ev is None:
            return self.host_s()
        self.ev[1].synchronize()
        return self.ev[0].elapsed_time(self.ev[1]) * 1e-3


def span(name: str, it=None):
    """A context manager that records the block as span ``name`` (of
    iteration ``it``, else of the span around it) while the profiler
    records (``torch.profiler``, ``trace``), and otherwise does nothing:
    off, it costs one attribute read (the profiler's own flag) and returns
    a shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, _STORE, it)


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name`` while the profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _STORE.lock:
        _STORE.counts[name] += n


def counters() -> dict:
    """{name: count} of ``count`` since ``reset_spans``."""
    with _STORE.lock:
        return dict(_STORE.counts)


def reset_spans():
    """Forget every recorded span and counter."""
    with _STORE.lock:
        _STORE.spans = []
        _STORE.counts.clear()


def span_table() -> dict:
    """Per span name, over the finished spans since ``reset_spans``:
    ``count``, ``calls`` and ``iters`` (the outermost spans and the
    iterations of them that the spans belong to), ``host_s`` and
    ``device_s`` (the spans' durations summed, on the host's clock and on
    the card's timeline), and ``host_self_s`` and ``device_self_s``: the
    same less the part that the spans' children cover. The card's times
    wait for it to reach the spans' ends."""
    spans = [s for s in _STORE.spans if s.t1 is not None]
    dur = {id(s): (s.host_s(), s.device_s()) for s in spans}
    inner = defaultdict(lambda: [0.0, 0.0])
    for s in spans:
        if s.parent is not None:
            h, d = dur[id(s)]
            acc = inner[id(s.parent)]
            acc[0] += h
            acc[1] += d
    out, seen = {}, defaultdict(lambda: (set(), set()))
    for s in spans:
        h, d = dur[id(s)]
        ch, cd = inner.get(id(s), (0.0, 0.0))
        row = out.setdefault(s.name, dict(count=0, calls=0, iters=0,
                                          host_s=0.0, host_self_s=0.0,
                                          device_s=0.0, device_self_s=0.0))
        calls, iters = seen[s.name]
        calls.add(id(s.call))
        if s.it is not None:
            iters.add((id(s.call), s.it))
        row["calls"], row["iters"] = len(calls), len(iters)
        row["count"] += 1
        row["host_s"] += h
        row["host_self_s"] += h - ch
        row["device_s"] += d
        row["device_self_s"] += d - cd
    return out


class StageTimers:
    """Accumulate time per stage; log averages every `period` frames.
    ``sums``/``counts`` restart after each log; ``totals``/``total_counts``
    cover the whole run.

    A ``stage`` is a span (recorded in a trace while the profiler records).
    In a process that has initialised CUDA its time is the card's timeline
    between events recorded at its enter and exit, added when the card has
    reached them: ``frame_done`` adds those it has reached, ``summary``
    waits for the rest, so a stage adds no synchronise. On the CPU it is
    the host's clock, added at once."""

    def __init__(self, period: int = 10, tag: str = "Prof"):
        self.period = period
        self.tag = tag
        self.sums = defaultdict(float)
        self.counts = defaultdict(int)
        self.totals = defaultdict(float)
        self.total_counts = defaultdict(int)
        self.frames = 0
        self._pending: list = []

    @contextlib.contextmanager
    def stage(self, name: str):
        s = _Span(name, _STORE if _autograd_profiler._is_profiler_enabled
                  else None)
        try:
            with s:
                yield
        finally:
            if s.ev is None:
                self.add(name, s.host_s())
            else:
                self._pending.append(s)

    def _resolve(self, wait: bool):
        keep = []
        for s in self._pending:
            if wait or s.done():
                self.add(s.name, s.device_s())
            else:
                keep.append(s)
        self._pending = keep

    def summary(self) -> dict:
        """{stage: (total_seconds, count)} over the run, every stage's
        events waited for."""
        self._resolve(wait=True)
        return {k: (self.totals[k], self.total_counts[k])
                for k in sorted(self.totals)}

    def add(self, name: str, seconds: float):
        self.sums[name] += seconds
        self.counts[name] += 1
        self.totals[name] += seconds
        self.total_counts[name] += 1

    def frame_done(self):
        self._resolve(wait=False)
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
    the card), ``summary`` (``trace_summary``), ``spans`` (``span_table``
    of the block's spans) and the profile itself."""

    path = None
    wall_ms = None
    summary = None
    spans = None
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
    reset_spans()
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
    res.spans = span_table()
    if cuda and not res.summary["kernel_launches"]:
        raise RuntimeError(
            f"the trace of {res.wall_ms:.1f} ms on {dev} holds no device "
            "event: CUPTI recorded no CUDA activity (trace file "
            f"{res.path})")
