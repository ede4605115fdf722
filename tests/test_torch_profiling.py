"""The port's observability modules on the CPU: ``utils/profiling``'s spans
and counters (off, under the CPU profiler, inside ``map_iters``),
``utils/profiling.trace`` and its summary, ``track_frame``'s truncated stages (a mirror of
``tests/test_tracking.py::test_stage_truncation_consistent_with_full`` on
the port), ``utils/roofline.py`` (its bounds against chip_smoke.py's
formulas from before they moved there, ``program_cost``, ``classify``) and
``utils/compile_stats.py`` on a fake build cache.

The stages run the port alone: the full frame's parity with the JAX
package is ``tests/test_torch_tracking.py``'s. On the CPU every kernel
wrapper runs its plain version, so the stages are compared bit for bit
with the full frame (one torch thread, the same generator seed)."""

import json
import os
import stat
import time
import zlib

import numpy as np
import pytest
import torch

from monogs_tpu_torch import _build
from monogs_tpu_torch.data.synthetic import SyntheticDataset
from monogs_tpu_torch.models import gaussian_map as gm
from monogs_tpu_torch.ops import se3
from monogs_tpu_torch.render import Intrinsics, RenderConfig
from monogs_tpu_torch.render import blend_lists as bl
from monogs_tpu_torch.slam import mapping
from monogs_tpu_torch.slam.frame import make_frame_data
from monogs_tpu_torch.slam.tracking import STAGES, TrackConfig, track_frame
from monogs_tpu_torch.utils import compile_stats, profiling, roofline
from tests.torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"


# ------------------------------------------------------------------ spans

def _cpu_profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def test_span_off_records_nothing():
    profiling.reset_spans()
    a, b = profiling.span("a"), profiling.span("b", it=3)
    assert a is b                  # one shared null context
    with a, profiling.span("c"):
        profiling.count("n", 5)
    assert profiling.span_table() == {} and profiling.counters() == {}


def test_spans_nest_under_the_cpu_profiler():
    """Parents, calls and iterations, self times (a span's duration less its
    children's), counters, and the spans among the profiler's operations;
    on the CPU the device time is the host's."""
    profiling.reset_spans()
    with _cpu_profiler() as prof:
        for call in range(2):
            with profiling.span("outer"):
                for i in range(3):
                    profiling.count("n")
                    with profiling.span("inner", it=i):
                        with profiling.span("leaf"):
                            time.sleep(0.002)
                        time.sleep(0.001)
    spans = list(profiling._STORE.spans)
    tab, cnt = profiling.span_table(), profiling.counters()
    assert cnt == {"n": 6}
    assert {k: (r["count"], r["calls"], r["iters"]) for k, r in tab.items()} \
        == {"outer": (2, 2, 0), "inner": (6, 2, 6), "leaf": (6, 2, 6)}
    for s in spans:
        if s.name == "leaf":
            assert s.parent.name == "inner" and s.it == s.parent.it
            assert s.call is s.parent.parent
        if s.name == "outer":
            assert s.parent is None and s.call is s
    for k, r in tab.items():
        assert r["device_s"] == r["host_s"]
        assert r["device_self_s"] == r["host_self_s"]
    assert tab["leaf"]["host_self_s"] == tab["leaf"]["host_s"] >= 0.012
    assert tab["inner"]["host_self_s"] == pytest.approx(
        tab["inner"]["host_s"] - tab["leaf"]["host_s"], abs=1e-12)
    assert tab["inner"]["host_self_s"] >= 0.006
    assert tab["outer"]["host_self_s"] == pytest.approx(
        tab["outer"]["host_s"] - tab["inner"]["host_s"], abs=1e-12)
    # the spans are operations of the profile, nested as entered
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert (names.count("outer"), names.count("inner"),
            names.count("leaf")) == (2, 6, 6)
    profiling.reset_spans()
    assert profiling.span_table() == {} and profiling.counters() == {}


def test_spans_and_counts_from_many_threads():
    """Each thread nests its spans on its own stack, and no count is lost
    (more threads than cores, a short switch interval)."""
    import sys
    import threading

    n_threads, n_rounds = 2 * (os.cpu_count() or 1) + 2, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    profiling.reset_spans()

    def work(k):
        for _ in range(n_rounds):
            with profiling.span("outer", it=k):
                profiling.count("n")
                with profiling.span("inner"):
                    profiling.count("n", 2)

    try:
        with _cpu_profiler():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert profiling.counters() == {"n": 3 * n_threads * n_rounds}
    inner = [s for s in profiling._STORE.spans if s.name == "inner"]
    assert len(inner) == n_threads * n_rounds
    assert all(s.parent.name == "outer" and s.it == s.parent.it
               and s.call is s.parent for s in inner)
    tab = profiling.span_table()
    assert tab["outer"]["calls"] == tab["inner"]["iters"] == len(inner)
    profiling.reset_spans()


def test_trace_fills_its_span_table(tmp_path):
    profiling.count("before")           # off: not counted
    with profiling.trace(str(tmp_path / "tr"), device=CPU) as tr:
        with profiling.span("work"):
            torch.ones(8).sum()
        profiling.count("n", 2)
    assert set(tr.spans) == {"work"} and tr.spans["work"]["count"] == 1
    assert profiling.counters() == {"n": 2}


def test_stage_timers_on_the_host_clock_and_as_spans():
    """On the CPU a stage adds its host time at once; under the profiler it
    is also a span."""
    timers = profiling.StageTimers(period=1 << 30)
    with timers.stage("a"):
        time.sleep(0.002)
    assert timers.totals["a"] >= 0.002 and timers.total_counts["a"] == 1
    profiling.reset_spans()
    with _cpu_profiler():
        with timers.stage("b"), profiling.span("inner"):
            pass
    tab = profiling.span_table()
    assert tab["b"]["count"] == 1 and tab["inner"]["calls"] == 1
    summary = timers.summary()
    assert set(summary) == {"a", "b"} and summary["b"][1] == 1
    assert summary["b"][0] == pytest.approx(tab["b"]["host_s"])


MAP_INTR = Intrinsics(fx=50.0, fy=50.0, cx=31.5, cy=23.5, width=64,
                      height=48)
MAP_CFG = RenderConfig(tile=16, macro_tiles=2, k_macro=64, k_fine=32,
                       backend="pallas_lists")
MAP_ITERS, MAP_B = 3, 3


@pytest.fixture(scope="module")
def map_runs():
    """A tiny fused ``map_iters`` (full lists, as the benchmark's cells),
    across the densify of iteration 50, with spans off and then under the
    CPU profiler, from the same state and draws."""
    ds = SyntheticDataset(MAP_INTR, n_frames=MAP_B, n_gauss=300, seed=1,
                          sensor_type="depth", render_cfg=MAP_CFG,
                          trans_amp=0.05, rot_amp=0.02, device=CPU)
    scene = ds.scene
    g = torch.Generator().manual_seed(2)
    leaves = gm.ParamLeaves(
        xyz=scene.xyz + 0.02 * torch.randn(scene.xyz.shape, generator=g),
        sh=scene.sh, log_scale=scene.log_scale, quat=scene.quat,
        opa_logit=scene.opa_logit)
    m = gm.insert(gm.new_map(512, device=CPU), leaves, 300, kf_id=0)
    frames = [ds[v] for v in range(MAP_B)]
    idx = torch.arange(MAP_B)
    cams = mapping.empty_cam_batch(MAP_B, 48, 64, CPU)._replace(
        gt_image=torch.stack([f[0] for f in frames]),
        gt_depth=torch.stack([f[1][None] for f in frames]),
        mapping_mask=torch.ones((MAP_B, 1, 48, 64)),
        T=torch.stack([f[2] for f in frames]),
        valid=torch.ones(MAP_B, dtype=torch.bool), opt_pose=idx > 0,
        opt_exposure=idx > 0)
    mcfg = mapping.MapConfig(monocular=False, window_size=MAP_B,
                             pool_size=0, split_cap=64, clone_cap=64)
    noise = torch.randn((2, 64, 3), generator=g)

    def run():
        return mapping.map_iters(
            m, cams, MAP_ITERS, 48, torch.Generator().manual_seed(3),
            MAP_INTR, MAP_CFG, mcfg, gm.MapHyper(),
            draws=mapping.MapDraws(split_noise=[None, noise]))

    profiling.reset_spans()
    off = run()
    assert profiling.span_table() == {}
    with _cpu_profiler():
        on = run()
    return off, on, profiling.span_table(), profiling.counters()


def test_map_iters_records_the_ba_tree(map_runs):
    *_, tab, cnt = map_runs
    assert cnt == {"ba.iters": MAP_ITERS}
    per_view = MAP_ITERS * MAP_B
    assert {k: r["count"] for k, r in tab.items()} == {
        "ba.call": 1, "ba.iter": MAP_ITERS, "ba.prep": per_view,
        "ba.map_grad": per_view, "ba.pullback": per_view,
        "ba.map_adam": MAP_ITERS, "ba.densify": 1,
        # at the call's start and after the densify of iteration 50
        "ba.rebin": 2, "ba.visibility": 1}
    for k, r in tab.items():
        assert r["calls"] == 1, k
        assert r["iters"] == (0 if k in ("ba.call", "ba.visibility")
                              else 1 if k in ("ba.densify", "ba.rebin")
                              else MAP_ITERS), k
        assert r["host_self_s"] >= 0.0, k
    # the self times under the call add up to the call
    assert sum(r["host_self_s"] for r in tab.values()) == pytest.approx(
        tab["ba.call"]["host_s"], rel=1e-9)


def test_map_iters_same_bits_with_spans_on_and_off(map_runs):
    off, on, *_ = map_runs
    assert off.it_count == on.it_count == 48 + MAP_ITERS
    a = torch.utils._pytree.tree_leaves((off.m, off.cams, off.visibility,
                                         off.kf_adam))
    b = torch.utils._pytree.tree_leaves((on.m, on.cams, on.visibility,
                                         on.kf_adam))
    assert len(a) == len(b) > 20
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


# ------------------------------------------------------------------ trace

def test_trace_on_cpu_writes_a_readable_trace(tmp_path):
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    with profiling.trace(str(tmp_path / "tr"), device=CPU) as tr:
        y = (x @ x).relu().sum()
    assert float(y) > 0
    assert os.path.dirname(tr.path) == str(tmp_path / "tr")
    assert tr.path.endswith(".pt.trace.json")
    with open(tr.path) as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "aten::mm" in names
    s = tr.summary
    for k in ("wall_ms", "kernel_launches", "device_busy_ms",
              "device_idle_share", "device_ms_by_class", "top", "cpu_ops",
              "top_cpu"):
        assert k in s, k
    assert s["wall_ms"] > 0 and s["cpu_ops"] >= 3
    assert "aten::mm" in {t["name"] for t in s["top_cpu"]}
    # no device ran: no device metric is reported
    assert s["kernel_launches"] == 0 and s["device_busy_ms"] is None
    assert s["device_idle_share"] is None and s["top"] == []


class _Avg:
    def __init__(self, key, device_type, us, count):
        self.key, self.device_type, self.count = key, device_type, count
        self.self_device_time_total = us
        self.self_cpu_time_total = us


class _Prof:
    def __init__(self, avgs):
        self.avgs = avgs

    def key_averages(self):
        return self.avgs


def test_trace_summary_classes_and_idle_share():
    """trace_summary on a profile's averages: device time by kernel class
    (KERNEL_CLASSES), the busiest kernels, the idle share of the window."""
    from torch.autograd import DeviceType

    cu, cpu = DeviceType.CUDA, DeviceType.CPU
    prof = _Prof([
        _Avg("void blend::fwd_kernel<false>(Args)", cu, 300.0, 3),
        _Avg("void macro_bwd_kernel<4>(...)", cu, 500.0, 1),
        _Avg("void at::native::elementwise_kernel<...>", cu, 150.0, 30),
        _Avg("void cub::DeviceRadixSortOnesweepKernel<...>", cu, 50.0, 2),
        _Avg("cudaLaunchKernel", cpu, 900.0, 36),
    ])
    s = profiling.trace_summary(prof, wall_ms=4.0, top=2)
    assert s["kernel_launches"] == 36 and s["cpu_ops"] == 36
    assert s["device_busy_ms"] == pytest.approx(1.0)
    assert s["device_idle_share"] == pytest.approx(0.75)
    assert s["device_ms_by_class"]["list_blend"] == pytest.approx(0.3)
    assert s["device_ms_by_class"]["macro_blend"] == pytest.approx(0.5)
    assert s["device_ms_by_class"]["elementwise"] == pytest.approx(0.15)
    assert s["device_ms_by_class"]["sort"] == pytest.approx(0.05)
    assert [t["ms"] for t in s["top"]] == pytest.approx([0.5, 0.3])


# ----------------------------------------------------------------- stages

INTR = Intrinsics(fx=120.0, fy=120.0, cx=63.5, cy=47.5, width=128, height=96)
CFG = RenderConfig(tile=16, macro_tiles=4, k_macro=1024, k_fine=256)


@pytest.fixture(scope="module")
def stage_runs():
    ds = SyntheticDataset(INTR, n_frames=2, n_gauss=1500, seed=0,
                          sensor_type="monocular", render_cfg=CFG,
                          trans_amp=0.0, rot_amp=0.0, device=CPU)
    img, _, T_gt = ds[0]
    frame = make_frame_data(img, None, 1.1, 0.01, "synthetic")
    tau = 0.01 * np.random.default_rng(1).standard_normal(6)
    T0 = se3.se3_exp(torch.tensor(tau, dtype=torch.float32)) @ T_gt
    # test_tracking.py's configuration with fewer iterations (6 and 3, not
    # 10 and 4): every stage still cuts a loop that has run
    tcfg = TrackConfig(monocular=True, fo_max_iter=6, so_max_iter=3,
                       bin_margin=8.0, fo_tile_frac=0.5, so_tile_frac=0.5)
    cfg_p = CFG._replace(backend="pallas_lists", with_n_touched=True)

    def run(stage):
        gen = torch.Generator().manual_seed(0)
        return track_frame(ds.scene, frame, T0, 1.0, 0.0, gen, INTR, cfg_p,
                           tcfg._replace(stage=stage))

    return T0, {stage: run(stage) for stage in STAGES}


def test_stage_truncation_consistent_with_full(stage_runs):
    """Every cut agrees with the full frame: "build" and "lists" return the
    seed, "fo" and "so_prep" the first order's iterations, "so" the second
    order's, and "final_nc" differs from the full frame only in n_touched.
    Each cut adds one host sync to those of the loops before it."""
    T0, r = stage_runs
    full = r["full"]
    for stage in ("build", "lists"):
        assert torch.equal(r[stage].T, T0), stage
        assert np.isfinite(float(r[stage].last_l1)), stage
        assert r[stage].fo_iters == 0 and r[stage].so_iters == 0
        assert r[stage].host_syncs == 1
        assert float(r[stage].image.abs().sum()) == 0.0
    assert float(r["build"].last_l1) > 0
    assert r["fo"].fo_iters == full.fo_iters and r["fo"].so_iters == 0
    assert r["fo"].host_syncs == full.fo_iters + 1
    assert torch.equal(r["fo"].fo_losses, full.fo_losses)
    assert r["so_prep"].fo_iters == full.fo_iters
    assert r["so_prep"].so_iters == 0
    assert np.isfinite(float(r["so_prep"].last_l1))
    assert r["so"].so_iters == full.so_iters
    assert r["so"].host_syncs == full.host_syncs + 1
    assert torch.equal(r["so"].so_losses, full.so_losses)
    fnc = r["final_nc"]
    assert torch.equal(fnc.T, full.T)
    assert torch.equal(fnc.image, full.image)
    assert fnc.host_syncs == full.host_syncs
    # the counts kernel is the only difference
    assert int(full.n_touched.sum()) > 0
    assert int(fnc.n_touched.sum()) == 0


def test_unknown_stage_is_refused():
    with pytest.raises(ValueError, match="not one of"):
        track_frame(None, None, torch.eye(4), 1.0, 0.0, None, INTR,
                    CFG._replace(backend="pallas_lists"),
                    TrackConfig(stage="preprocess"))


# --------------------------------------------------------------- roofline

# chip_smoke.py's bound before its formulas moved to utils/roofline.py,
# kept here unchanged as the reference the move is held to
def _old_tc_ops(name, n):
    live, contrib = n["live"], n["contrib"]
    return {
        "fo_grad": 6 * contrib + 12 * live,
        "fo_grad_rgbd": 8 * contrib + 24 * live,
        "map_grad": 6 * contrib + 12 * live,
        "map_grad_rgbd": 8 * contrib + 12 * live,
        "map_grad_madd": 6 * contrib + 12 * live,
        "map_grad_madd_rgbd": 8 * contrib + 12 * live,
    }.get(name.split("@")[0], 0)


def _old_ops(name, n, e_exp):
    fwd = (16 + e_exp) * n["walked"] + 3 * n["ok"] + 10 * n["contrib"]
    live, dead = n["live"], n["contrib"] - n["live"]
    fo = fwd + 30 * live + 14 * dead
    box = 8 * n.get("box_tests", 0)
    bwd = fwd + 34 * live + 18 * dead
    return {
        "macro_fwd": fwd + box,
        "compact_fwd": fwd + box,
        "macro_bwd": bwd + box + 16 * n.get("ft_adds", 0),
        "compact_bwd": bwd + box + 16 * n.get("ft_adds", 0),
        "fwd": fwd,
        "fwd_counts": fwd + n["contrib"],
        "fo_grad": fo,
        "fo_grad_rgbd": fo + 21 * live + 5 * dead,
        "jvp8": fwd + (12 + 6 * 34) * live + 6 * 19 * dead,
        "map_grad": fwd + 29 * live + 13 * dead,
        "map_grad_rgbd": fwd + 33 * live + 17 * dead,
        "map_grad_madd": fwd + 29 * live + 13 * dead,
        "map_grad_madd_rgbd": fwd + 33 * live + 17 * dead,
        "bwd": bwd,
    }[name.split("@")[0]]


def _old_bound(name, pairs, in_bytes, out_bytes, e_exp):
    ops = _old_ops(name, pairs, e_exp)
    tc_ops = _old_tc_ops(name, pairs)
    t_bytes = (in_bytes + out_bytes) / 3.35e12 * 1e3
    t_ops = ((ops - tc_ops) / 67e12 + tc_ops / 495e12) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), ops, tc_ops


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# PERF.md §6's shapes (f32, P 256): each kernel's inputs and outputs, and
# the share of its T x K x P pairs of each kind (walked, ok, contrib, live)
_P = 256
_CASES = {
    "fwd": ((1280, 96), [(1280, 96, 16), (1280,), (1280,), (8, _P)],
            [(1280, _P, 8)]),
    "fwd_counts": ((1280, 96), [(1280, 96, 16), (1280,), (1280,), (8, _P)],
                   [(1280, _P, 8), (1280, 96)]),
    "fo_grad": ((152, 96), [(152, 96, 16), (152,), (152,), (8, _P),
                            (152, _P, 3), (152, _P, 1)],
                [(152, 96, 16), (152, 4)]),
    "fo_grad_rgbd": ((152, 96), [(152, 96, 16), (152,), (152,), (8, _P),
                                 (152, _P, 3), (152, _P, 1), (152, _P, 1)],
                     [(152, 96, 16), (152, 96, 16), (152, 4)]),
    "jvp8": ((152, 96), [(152, 96, 16), (152, 96, 6, 16), (152,), (152,),
                         (8, _P)], [(152, _P, 8), (152, 6, _P, 8)]),
    "bwd": ((1280, 96), [(1280, 96, 16), (1280,), (1280,), (8, _P),
                         (1280, _P, 8)], [(1280, 96, 16)]),
    "map_grad": ((320, 96), [(320, 96, 16), (320,), (320,), (8, _P),
                             (320, _P, 3), (320, _P, 1)],
                 [(320, 96, 16), (320, 4)]),
    "map_grad_rgbd@k256": ((80, 256), [(80, 256, 16), (80,), (80,),
                                       (8, _P), (80, _P, 3), (80, _P, 1),
                                       (80, _P, 1)],
                           [(80, 256, 16), (80, 4)]),
    "map_grad_madd": ((1280, 96), [(1280, 96, 16), (1280,), (1280,),
                                   (8, _P), (1280, _P, 3), (1280, _P, 1),
                                   (1280, 96)],
                      [(1280, 96, 16), (1280, 4)]),
    "macro_fwd": ((80 * 16, 1024), [(80, 1024, 16), (80, 2), (80,),
                                    (8, _P)], [(80 * 16, _P, 8)]),
    "macro_bwd": ((80 * 16, 1024), [(80, 1024, 16), (80, 2), (80,),
                                    (8, _P), (80 * 16, _P, 8)],
                  [(80, 1024, 16)]),
    "compact_fwd@rgbd": ((20 * 16, 256), [(20, 4096, 16), (20, 2), (20,),
                                          (8, _P)], [(20 * 16, _P, 8)]),
    "compact_bwd@rgbd": ((20 * 16, 256), [(20, 4096, 16), (20, 2), (20,),
                                          (8, _P), (20 * 16, _P, 8)],
                         [(20, 4096, 16)]),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_roofline_bounds_equal_chip_smokes_former_formulas(name):
    (tk, kf), ins, outs = _CASES[name]
    pairs_tot = tk * kf * _P
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    walked = int(pairs_tot * rng.uniform(0.3, 0.7))
    ok = int(walked * rng.uniform(0.3, 0.9))
    contrib = int(ok * rng.uniform(0.5, 1.0))
    pairs = dict(walked=walked, ok=ok, contrib=contrib,
                 live=int(contrib * rng.uniform(0.5, 1.0)),
                 box_tests=tk * 200, ft_adds=tk * 30)
    in_b = roofline.nbytes(*(_meta(*s) for s in ins))
    out_b = roofline.nbytes(*(_meta(*s) for s in outs))
    for e_exp in (10, 14):
        b = roofline.kernel_bound(name, pairs, in_b + out_b, e_exp)
        assert (b["bound_ms"], b["bound_by"], b["ops"], b["tc_ops"]) == \
            _old_bound(name, pairs, in_b, out_b, e_exp)
    # the data kernels' bound: bytes over the memory rate
    assert roofline.bytes_bound_ms(in_b) == in_b / 3.35e12 * 1e3


def test_program_cost_counts_dense_ops_and_launches(monkeypatch):
    """FlopCounterMode's dense operations plus each kernel's launches in
    the run times its per-launch cost; a kernel without a cost is named."""
    launches = dict(bl.LAUNCHES, fwd=0, jvp8=0)
    monkeypatch.setattr(bl, "LAUNCHES", launches)
    a = torch.randn(32, 48, generator=torch.Generator().manual_seed(0))

    def fn(x):
        launches["fwd"] += 3
        launches["jvp8"] += 1
        return (x @ x.T).sum()

    per_launch = {"fwd": dict(ops=1000, tc_ops=100, bytes=4096)}
    out, cost = roofline.program_cost(fn, a, per_launch=per_launch)
    assert float(out) == float((a @ a.T).sum())
    assert cost["dense_flops"] == 2 * 32 * 48 * 32
    assert cost["flops"] == cost["dense_flops"] + 3000
    assert cost["tc_flops"] == 300 and cost["bytes"] == 3 * 4096
    assert cost["launches"] == {"fwd": 3, "jvp8": 1}
    assert cost["uncounted"] == ["jvp8"]
    c = roofline.classify(cost["flops"], cost["bytes"], 1e-3,
                          tc_flops=cost["tc_flops"])
    assert c["bound"] == "latency"
    assert c["mfu_fp32"] == pytest.approx(cost["flops"] / 1e-3 / 67e12)
    assert c["bound_ms"] == pytest.approx(1e3 * max(
        (cost["flops"] - 300) / 67e12 + 300 / 495e12, 12288 / 3.35e12))
    assert "latency-bound" in roofline.fmt("x", c)
    busy = roofline.classify(67e12, 1.0, 1.0)
    assert busy["bound"] == "compute"
    assert roofline.classify(1.0, 3.35e12, 1.0)["bound"] == "bandwidth"


# ---------------------------------------------------------- compile stats

def test_compile_stats_on_a_fake_build_cache(tmp_path, monkeypatch):
    """A build, then a hash-cache hit of the same library, then a failed
    build: counted, timed and summarised; nothing after uninstall."""
    fake_cc = tmp_path / "fake_cc"
    fake_cc.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then shift; echo lib > \"$1\"; fi\n"
        "  if [ \"$1\" = --fail ]; then echo broken; exit 3; fi\n"
        "  shift\ndone\n")
    fake_cc.chmod(fake_cc.stat().st_mode | stat.S_IEXEC)
    src = tmp_path / "fake.cpp"
    src.write_text("int f() { return 1; }\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")

    def fake_compiler():
        return str(fake_cc)

    monkeypatch.setattr(_build, "SOURCES", {
        "fake": _build.Source(src, compiler=fake_compiler, flags=("-O2",)),
        "broken": _build.Source(src, compiler=fake_compiler,
                                flags=("--fail",)),
    })
    stats = compile_stats.CompileStats.install()
    try:
        path = _build.build_all(["fake"])["fake"]
        assert path.read_text() == "lib\n"
        _build.build_all(["fake"])
        with pytest.raises(RuntimeError, match="build failed for broken"):
            _build.build_all(["broken"])
    finally:
        stats.uninstall()
    _build.build_all(["fake"])   # not counted once uninstalled
    assert stats.compiled == ["fake", "broken"]
    assert stats.failed == ["broken"]
    assert stats.cache_hits == ["fake"]
    assert stats.n_compiled == 2 and stats.n_cache_hits == 1
    assert stats.hit_rate() == pytest.approx(1 / 3)
    assert stats.build_seconds > 0.0
    s = stats.summary()
    assert s.startswith("2 libraries built in ")
    assert "1 build-cache hits (33%)" in s
    assert "failed: broken" in s
