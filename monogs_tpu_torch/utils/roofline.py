"""Operation and byte accounting against one H100's peaks.

Counterpart of ``monogs_tpu/utils/roofline.py``, for the port on an NVIDIA
H100 SXM (NVIDIA's data sheet, dense rates, at the full 700 W power limit;
a card set below it is slower, so every number names the card's limit):
3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor cores, 495
TFLOP/s in TF32 on them (the fused steps' row sums). Its integer rate is
not on the data sheet: NVIDIA's H100 architecture white paper gives 64
INT32 units a streaming multiprocessor, which at 132 of them and the
1.98 GHz boost clock that the data sheet's float32 rate implies (132 x
128 x 2 x 1.98 GHz = 67 TFLOP/s) is 16.7 T integer operations a second
(SGBM's bound).

- ``kernel_ops`` / ``kernel_tc_ops``: the analytic float32 operations of
  each port kernel's function on a run's (row, pixel) pairs, and the part
  of them done as TF32 products (the counterparts of ``pallas_flops_*``,
  which count from shapes; these count what the run's data needs);
  ``expf_ops`` reads one expf's cost from the SASS of a probe kernel.
- ``kernel_bound``: the least time the card could take for a kernel's
  work, the larger of its bytes over the memory rate and its operations
  over the peak rate of their type.
- ``program_cost(fn, *args)``: the counterpart of ``compiled_cost``. A
  CUDA kernel is as opaque to PyTorch's op counter as a Pallas custom call
  was to XLA's cost analysis, so the count has two parts: the dense ops'
  floating-point operations (``torch.utils.flop_counter.FlopCounterMode``:
  matrix products, convolutions, attention), and each kernel's launches
  in the run (the wrappers' launch counters) times its operations and
  bytes per launch, which the caller supplies (``per_launch``).
  Elementwise ops, sorts, gathers and scatters outside the kernels are
  not counted, in operations or in bytes; the result says so
  (``caveat``), and a kernel launched without a per-launch cost is named
  under ``uncounted``.
- ``classify`` / ``fmt``: a measured time against both peaks, with the
  JAX module's verdicts (compute-, bandwidth- or latency-bound).
- ``sgbm_ops`` / ``sgbm_bound`` / ``sgbm_chain_ms``: the integer
  operations of semi-global matching on an [H, W] pair, its bound, and
  the latency of its longest chain of dependent path steps.

Nothing here runs at import time; ``expf_ops`` needs the CUDA toolkit.
"""

from __future__ import annotations

import subprocess
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12   # dense, tensor cores
INT32_OPS_PER_S = 132 * 64 * 1.98e9     # white paper's units, boost clock
SM_CLOCK_HZ = 1.98e9


def kernel_tc_ops(name, n):
    """The part of ``kernel_ops`` that the kernel does as TF32 products on
    the tensor cores: the fused steps' row sums, that is the feature sums
    (6 per contributing pair for r, g, b; 8 with a depth column, the
    mapping step's or the first-order step's depth chain) and the six
    conic moments and their sums (12 per live pair, 24 with the depth
    chain). Counted once, as the function needs them: the split into TF32
    big parts and remainders is the design's cost. The blend VJP's row
    sums run on the tensor cores too (since its redesign), but its bound
    stays the one of its function's FP32 operations, so that it compares
    with its earlier measurements."""
    live, contrib = n["live"], n["contrib"]
    return {
        "fo_grad": 6 * contrib + 12 * live,
        "fo_grad_rgbd": 8 * contrib + 24 * live,
        "map_grad": 6 * contrib + 12 * live,
        "map_grad_rgbd": 8 * contrib + 12 * live,
        "map_grad_madd": 6 * contrib + 12 * live,
        "map_grad_madd_rgbd": 8 * contrib + 12 * live,
    }.get(name.split("@")[0], 0)


def kernel_ops(name, n, e_exp):
    """Float32 operations a kernel's function needs on this run's rows.

    ``n`` counts the (row, pixel) pairs of each kind (``pair_counts``);
    ``e_exp`` is one expf's float32 operations (``expf_ops``). Each kind of
    pair is charged only the work the function does on it:

    - walked (every pair up to the pixel's terminating row): dx, dy (2), the
      log-alpha quadratic (10), two clamps (2), expf, the two alpha tests (2);
    - ok (walked and passing the alpha test): 1 - a, T(1 - a), its test (3);
    - contrib (ok and before termination): w = aT and the five weighted sums
      (10); counts add one increment. The reverse pass and the tangents are
      zero on every other pair: a pair that fails the alpha test has a = 0,
      and the suffix sum is 0 from the terminating row on;
    - fused first-order step, per contributing pair: wbar (6), the suffix
      (2) and three colour sums (6); where a < 0.99 (live), also obar (1),
      abar (2), sbar (1) and six conic moments and their sums (12). The
      RGB-D chain adds wbar, its suffix and the depth sum (5), and on live
      pairs obar, abar, sbar and the moments (16);
    - jvp8, per contributing pair and pose tangent: w_t's log-T term (2) and
      five tangent sums (17); on live pairs also s_t (10), alpha_t (1), the
      carry of log T (2) and w_t's alpha term (2), plus the shared monomials
      and 1 / (1 - a) once (12);
    - the other reverse kernels, per contributing pair: wbar over the
      output columns with a cotangent (a multiply each and the adds
      between: 5 for the mapping step's r, g, b; 7 with its depth; 8 for
      the VJP's r, g, b, depth and acc), the suffix (2) and a sum of w g
      per feature column (6 or 8); live pairs add the same 16 as above.

    - the macro-list kernels (``macro_*``, ``compact_*``) walk only the rows
      that enter a tile, with the list kernels' costs per pair, and test the
      box of every valid macro row (below its list's count) against every
      fine tile of its macro: four adds and four compares (8, ``box_tests``
      pairs). Their VJPs also add up each row's cotangent over the fine
      tiles it entered: 16 adds for each such (row, fine tile) beyond the
      row's first (``ft_adds``). The index scan and the per-fine-tile
      partials are this design's cost, not the function's, and are left
      out.

    - the mapping step's ``madd`` variant does the mapping step's work;
      its one add per staged row is work per row.

    Work per row or per pixel (the row cotangents, the residual), under 2 %
    of the total at these shapes, is left out: a lower bound.
    ``kernel_tc_ops`` says which of these operations the kernel does on the
    tensor cores.
    """
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


EXPF_PROBE = r"""
extern "C" __global__ void probe_exp(const float* x, float* y) {
  y[threadIdx.x] = expf(x[threadIdx.x]);
}
extern "C" __global__ void probe_copy(const float* x, float* y) {
  y[threadIdx.x] = x[threadIdx.x];
}
"""


def expf_ops():
    """Float32 operations of one expf as the kernels are compiled: the SASS
    of a probe kernel that computes expf, less that of one that copies,
    with FFMA counted as two and every other F* instruction as one. Also
    returns the SASS instruction counts of the difference. Needs nvcc and
    cuobjdump; builds under the package's build directory."""
    import re

    from .. import _build

    def need(cond, msg):
        if not cond:
            raise RuntimeError(msg)

    nvcc = Path(_build.nvcc_path())
    cuobjdump = nvcc.parent / "cuobjdump"
    need(cuobjdump.is_file(), f"no cuobjdump beside {nvcc}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "expf_probe.cu"
    cubin = src.with_suffix(".cubin")
    src.write_text(EXPF_PROBE)
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    for cmd in ([str(nvcc), *flags, "-cubin", "-o", str(cubin), str(src)],
                [str(cuobjdump), "-sass", str(cubin)]):
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        need(out.returncode == 0, f"{cmd[0]} failed: {out.stderr}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = counts.setdefault(m.group(1), {})
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if m and fn is not None:
            fn[m.group(1)] = fn.get(m.group(1), 0) + 1
    need({"probe_exp", "probe_copy"} <= counts.keys(),
         "probe kernels missing from the SASS")
    diff = {op: c - counts["probe_copy"].get(op, 0)
            for op, c in counts["probe_exp"].items()
            if c != counts["probe_copy"].get(op, 0)}
    ops = sum((2 if op == "FFMA" else 1) * c for op, c in diff.items()
              if op.startswith("F") and c > 0)
    need(ops > 0, f"no float32 instructions in expf's SASS: {diff}")
    return ops, diff


def nbytes(*ts):
    """Bytes of the given tensors (None skipped)."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bytes_bound_ms(n_bytes):
    """Milliseconds to move ``n_bytes`` at the card's memory rate."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def kernel_bound(name, pairs, n_bytes, e_exp):
    """The least time the card could take for kernel ``name``'s work on a
    run whose pairs are ``pairs`` and whose inputs and outputs take
    ``n_bytes`` (each read or written once): the larger of the bytes over
    the memory rate and the operations over their peak rate (TF32 for
    ``kernel_tc_ops``, float32 for the rest). Returns a dict with
    ``bound_ms``, ``bound_by`` ("bytes" or "operations"), ``ops`` and
    ``tc_ops``."""
    ops = kernel_ops(name, pairs, e_exp)
    tc_ops = kernel_tc_ops(name, pairs)
    t_bytes = bytes_bound_ms(n_bytes)
    t_ops = ((ops - tc_ops) / FP32_FLOPS_PER_S
             + tc_ops / TF32_FLOPS_PER_S) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                ops=ops, tc_ops=tc_ops)


# SGBM's integer operations per cost-volume cell (one left pixel at one
# disparity), as the function needs them: the Birchfield-Tomasi cost of
# two channels (per channel 4 differences, 4 maxima with zero or each
# other, a minimum, a shift and an add), the two window sums as running
# sums (an add and a subtract down the rows and along the row), five path
# steps (per step the two P1 adds, three minima, the cost added and the
# path's minimum subtracted, its share of the minimum over disparities,
# the 16-bit store), and the selection (the three upper paths summed,
# two saturated adds, the least sum, the uniqueness test).
SGBM_CELL_OPS = dict(pixel_cost=2 * 11, window_sums=4, paths=5 * 9,
                     select=14)
# the dependent latency of one path step, in cycles: two shuffles issued
# together, four integer operations, the warp's minimum and the 16-bit
# wrap (an estimate from the instructions' published latencies, not a
# measurement)
SGBM_STEP_CYCLES = 80


def sgbm_ops(h, w, num_disp=64):
    """Integer operations of SGBM on an [h, w] pair (SGBM_CELL_OPS a
    cell of the [h, w - num_disp, num_disp] cost volume)."""
    return sum(SGBM_CELL_OPS.values()) * h * (w - num_disp) * num_disp


def sgbm_bound(h, w, num_disp=64):
    """SGBM's bound on an [h, w] pair: the larger of its bytes (the two
    images read and the disparities written once, the 16-bit cost volume
    written once and read once) over the memory rate and its integer
    operations over ``INT32_OPS_PER_S``. Returns a dict with ``bound_ms``,
    ``bound_by``, ``bytes``, ``ops`` and, for information,
    ``chain_ms``."""
    cells = h * (w - num_disp) * num_disp
    n_bytes = 2 * h * w + 2 * h * w + 2 * 2 * cells
    ops = sgbm_ops(h, w, num_disp)
    t_bytes = bytes_bound_ms(n_bytes)
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=n_bytes, ops=ops, chain_ms=sgbm_chain_ms(h, w))


def sgbm_chain_ms(h, w, num_disp=64):
    """The latency floor of SGBM's longest chain of dependent path steps
    (a row's w - num_disp pixels, or a column's h) at SGBM_STEP_CYCLES a
    step and the boost clock."""
    return max(h, w - num_disp) * SGBM_STEP_CYCLES / SM_CLOCK_HZ * 1e3


def launch_counters():
    """The launch counters of the kernel modules (one dict each), and the
    PNG unfilter's calls (host code)."""
    from ..data import jpeg, png, stereo, undistort
    from ..render import blend_lists, blend_macros

    return (blend_lists.LAUNCHES, blend_macros.LAUNCHES, undistort.LAUNCHES,
            stereo.LAUNCHES, jpeg.LAUNCHES, png.LAUNCHES)


def all_launches():
    """{kernel: launches so far} over every kernel module."""
    out = {}
    for c in launch_counters():
        out.update(c)
    return out


CAVEAT = ("flops: dense ops (FlopCounterMode) + kernel launches x analytic "
          "operations; bytes: the kernels' only; elementwise ops, sorts, "
          "gathers and scatters outside the kernels are not counted")


def program_cost(fn, *args, per_launch=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` once and count its work; returns (its
    result, the cost). ``per_launch`` maps a kernel's name to its
    ``ops``, ``tc_ops`` (the TF32 part) and ``bytes`` per launch, for
    example a kernel entry measured at the same shapes. The cost: ``flops``
    (dense + kernels), ``tc_flops`` (the kernels' TF32 part), ``bytes``
    (kernels only), ``dense_flops``, ``launches`` in the run, ``uncounted``
    (kernels launched without a per-launch cost) and ``caveat``."""
    from torch.utils.flop_counter import FlopCounterMode

    per_launch = per_launch or {}
    before = all_launches()
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn(*args, **kwargs)
    dense = int(counter.get_total_flops())
    launches = {k: v - before.get(k, 0) for k, v in all_launches().items()
                if v - before.get(k, 0)}
    ops = tc = n_bytes = 0
    for k, n in launches.items():
        c = per_launch.get(k)
        if c is not None:
            ops += n * c["ops"]
            tc += n * c.get("tc_ops", 0)
            n_bytes += n * c["bytes"]
    return out, dict(
        flops=dense + ops, tc_flops=tc, bytes=n_bytes, dense_flops=dense,
        kernel_flops=ops, launches=launches,
        uncounted=sorted(k for k in launches if k not in per_launch),
        caveat=CAVEAT)


def classify(flops, bytes_accessed, time_s, tc_flops=0):
    """Roofline classification of a measured execution of ``time_s``
    seconds that did ``flops`` operations (``tc_flops`` of them as TF32
    products) and moved ``bytes_accessed`` bytes.

    Returns achieved TFLOP/s and GB/s, arithmetic intensity, the share of
    each peak (``mfu_fp32`` over the float32 rate, ``mfu_tf32`` over the
    TF32 rate, ``hbm_util``), ``bound_ms`` (the least time for that work:
    the float32 operations at the float32 rate plus the TF32 ones at the
    TF32 rate, or the bytes at the memory rate, whichever is longer) and a
    verdict, as in the JAX module: "compute" if the achieved rate is over
    30 % of the float32 peak, "bandwidth" if the bytes are over 25 % of
    the memory rate, else "latency" (the program waits, not works)."""
    out = {"time_s": time_s}
    if flops is not None and time_s and time_s > 0:
        ach = flops / time_s
        out["flops"] = flops
        out["tflops_achieved"] = ach / 1e12
        out["mfu_fp32"] = ach / FP32_FLOPS_PER_S
        out["mfu_tf32"] = ach / TF32_FLOPS_PER_S
    if bytes_accessed is not None and time_s and time_s > 0:
        bw = bytes_accessed / time_s
        out["bytes"] = bytes_accessed
        out["gbps_achieved"] = bw / 1e9
        out["hbm_util"] = bw / HBM_BYTES_PER_S
    if flops and bytes_accessed:
        out["arith_intensity"] = flops / bytes_accessed
    if flops is not None and bytes_accessed is not None:
        t_ops = ((flops - tc_flops) / FP32_FLOPS_PER_S
                 + tc_flops / TF32_FLOPS_PER_S)
        out["bound_ms"] = 1e3 * max(t_ops, bytes_accessed / HBM_BYTES_PER_S)
    cb = out.get("mfu_fp32", 0.0) > 0.30
    bb = out.get("hbm_util", 0.0) > 0.25
    out["bound"] = "compute" if cb else ("bandwidth" if bb else "latency")
    return out


def fmt(tag, c):
    """One line of ``classify``'s result."""
    parts = [tag]
    if "flops" in c:
        parts.append(f"{c['flops'] / 1e9:.3f} GFLOP")
        parts.append(f"{c['tflops_achieved']:.4f} TFLOP/s")
        parts.append(f"of peak fp32 {100 * c['mfu_fp32']:.3f}% / "
                     f"tf32 {100 * c['mfu_tf32']:.4f}%")
    if "gbps_achieved" in c:
        parts.append(f"{c['gbps_achieved']:.2f} GB/s "
                     f"({100 * c['hbm_util']:.3f}% HBM)")
    if "arith_intensity" in c:
        parts.append(f"AI {c['arith_intensity']:.1f}")
    if "bound_ms" in c:
        parts.append(f"bound {c['bound_ms']:.4f} ms")
    parts.append(c["bound"] + "-bound")
    return "  ".join(parts)
