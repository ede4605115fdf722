"""The span metrics in a traced run at a size a CPU test holds: the CPU
profiler records no device event, so the metrics read from the device
trace are left out, and the program's spans are still read (on the host's
clock, as the CPU has no device timeline)."""

import math

from monogs_tpu_torch.utils import profiling
from portbench.harness.spec import Spec
from portbench.tests.tiny import run_tiny

SPAN_METRICS = ("ba.pullback_ms", "ba.prep_ms", "ba.map_state_ms",
                "ba.rebin_ms", "ba.loop_ms")


def test_traced_tiny_run_reports_the_span_metrics():
    """The Replica cell's run reports its five; the monocular cell's five
    read the same spans, so they read the same numbers from the spans the
    run left."""
    spec = Spec()
    for cell, suffix in (("replica-sp-ba", ""), ("fr3-mono-ba", "_mono")):
        names = {m["name"] for m in spec.metrics_of(cell, "per_layer")
                 if m["source"] == "program_span"}
        assert names == {n + suffix for n in SPAN_METRICS}
    profiling.reset_spans()
    rec = run_tiny("replica-sp-ba", trace=True, spec=spec)
    assert rec["correct"], rec["checks"]
    for name in SPAN_METRICS:
        v = rec["metrics"][name]
        assert v["unit"] == "ms/iter" and math.isfinite(v["value"]), name
        assert v["value"] > 0.0, name
    assert "device.idle_pct.ba" not in rec["metrics"]
    # the traced call and its retry, each of one chunk
    assert profiling.counters()["ba.iters"] == 2 * 2
    for name in SPAN_METRICS:
        mono = spec.reader(name + "_mono")({})
        assert mono == rec["metrics"][name]["value"], name
