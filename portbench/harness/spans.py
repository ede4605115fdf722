"""The program's own spans in a traced run: the device-timeline self time of
named spans, per BA iteration.

The port records spans and counters while the profiler records
(``monogs_tpu_torch/utils/profiling.py``: ``span_table``, ``counters``), so
the traced call of a ``window_ba`` run leaves them in the process. A span's
self time is its time between the events recorded at its enter and exit
less the part its child spans cover; on the CPU, where no event is
recorded, the host's. A program without the spans or the counter gives
nothing to read.
"""

from __future__ import annotations


def self_ms_per_iter(names) -> float | None:
    """The self times of the spans ``names``, summed, in ms, over the
    ``ba.iters`` count; None where the program recorded none of them."""
    try:
        from monogs_tpu_torch.utils import profiling
    except ImportError:
        return None
    table = getattr(profiling, "span_table", None)
    counters = getattr(profiling, "counters", None)
    if table is None or counters is None:
        return None
    iters = counters().get("ba.iters", 0)
    rows = table()
    if not iters or not any(n in rows for n in names):
        return None
    return 1e3 * sum(rows[n]["device_self_s"] for n in names
                     if n in rows) / iters
