"""The traced slice of a run: ``torch.profiler`` over one call, reduced to
what the per-layer readers and the breakdown need.

From the profiler's device events: every kernel's device time and launch
count by name, the device's busy time (the union of its events'
intervals) over the slice's wall time, and the idle gaps between them,
each charged to the innermost host operation that was running at the
gap's midpoint (what the host was doing while the card waited).
"""

from __future__ import annotations

import bisect
import time


def _events(prof):
    """([(start, end, name)] of the device, of the host) in microseconds,
    read from the profiler's raw results (building its event tree costs
    minutes for a call of some 10^5 launches)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns() * 1e-3, e.end_ns() * 1e-3
        t = e.device_type()
        if t == DeviceType.CUDA:
            dev.append((a, b, e.name()))
        elif t == DeviceType.CPU and b > a:
            host.append((a, b, e.name()))
    return dev, host


def _label_gaps(gaps, host):
    """{host op: idle seconds} over ``gaps`` [(start_us, end_us)]."""
    host.sort()
    starts = [h[0] for h in host]
    out = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        name = "host: outside any operator"
        for j in range(i, max(-1, i - 400), -1):
            if host[j][1] >= mid:
                name = "host: " + host[j][2]
                break
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out


def profile(fn, sync):
    """Run ``fn()`` under the profiler (CPU and CUDA activity) and reduce
    it; returns None where the profiler saw no device event."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    sync()
    prof = tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    try:
        fn()
        sync()
        wall = time.perf_counter() - t0
    finally:
        prof.stop()
    dev, host = _events(prof)
    if not dev:
        return None
    dev.sort()
    kernels = {}
    for a, b, name in dev:
        s, c = kernels.get(name, (0.0, 0))
        kernels[name] = (s + (b - a) * 1e-6, c + 1)
    busy, gaps = 0.0, []
    cur_a, cur_b = dev[0][0], dev[0][1]
    for a, b, _ in dev[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    idle = _label_gaps(gaps, host)
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        wall_s=wall, busy_s=busy * 1e-6, kernels=kernels,
        launches=sum(c for _, c in kernels.values()),
        breakdown=dict(device_ops=[[k[:160], v[0]] for k, v in top_ops],
                       idle_gaps=[[k, v] for k, v in top_idle]))
