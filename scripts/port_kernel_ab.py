"""Time the port's list-blend kernels against other builds of them, in
turns, on one NVIDIA GPU.

    python3 scripts/port_kernel_ab.py --against DIR [DIR ...] [--rounds N]
    python3 scripts/port_kernel_ab.py --no-fmad [--rounds N]

The other builds are either ``csrc/blend_lists.cu`` of other checkouts
(for example the parent commit, unpacked with ``git archive``), with this
checkout's nvcc flags, or this checkout's source without ``-fmad=false``
(nvcc then contracts a * b + c into one FFMA; the library is built with the
flag so that its alpha and transmittance thresholds round as the plain
PyTorch version's do). Every build must have the same C interface, except
that a ``blend_map_grad`` without the ``madd`` argument (sources before
the fused mapping step's madd variant) is called through an adapter, and
the madd variant is then left out of the turns. The attribute reports
(``blend_fused_attrs``, ``blend_fwd_attrs``: registers and shared memory,
which the turns do not call) may be missing from the other builds.

It prints each build's registers per kernel (``ptxas -v``), then whether
the forward blends' and jvp8's outputs at the tracking shapes have the
same bits in every build as in the first other build (a redesign that
keeps each pixel's arithmetic must give them), then runs
chip_smoke's tracking and mapping kernel phases (kernels 1-6 at the main
path's shapes and the madd variant at its two, each held against its
plain version) with the libraries in turns: each round runs every build
once and then again in reverse order, starting one build later than the
round before, so that over as many rounds as builds each build takes
every place. It prints one JSON line per
turn and kernel (both of chip_smoke's times, bound, error, within
tolerance), then per kernel the median of each time for each build over
its turns and its ratio to the first other build's, then the card's name
and power limit. ``ms`` is the CUDA-event time of one call on an idle
card, ``device_ms`` the device time of one call with the card kept busy
(chip_smoke.kernel_ms). Needs one CUDA card and nvcc;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


class _NoMaddInterface:
    """A library whose ``blend_map_grad`` takes no ``madd`` pointer, called
    with this checkout's arguments (``madd`` must be None)."""

    def __init__(self, lib):
        from monogs_tpu_torch import _build

        self._lib = lib
        sig = list(_build._SIGNATURES["blend_lists"]["blend_map_grad"])
        lib.blend_map_grad.argtypes = sig[:7] + sig[8:]

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def blend_map_grad(self, *args):
        assert args[7] is None, "this build has no madd variant"
        return self._lib.blend_map_grad(*args[:7], *args[8:])


def load(path: Path):
    """The library at ``path`` with blend_lists' C interface, but for the
    attribute reports (``blend_*_attrs``), which the turns do not call and
    older builds lack."""
    from monogs_tpu_torch import _build

    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build._SIGNATURES["blend_lists"].items():
        if not fn.endswith("_attrs"):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def build(srcs: dict[str, tuple[Path, list[str]]]):
    """Build each source of ``srcs`` ({name: (source, flags)}) with its
    flags (and ``-Xptxas -v``) into this checkout's build directory as
    build ``name`` (two copies of one source are two libraries), one nvcc
    each, started together; returns {name: (the library loaded with
    blend_lists' C interface, {kernel: registers})}."""
    from monogs_tpu_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (src, flags) in srcs.items():
        h = hashlib.sha256(src.read_bytes())
        for header in sorted(src.parent.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(flags).encode())
        out = (_build.BUILD_DIR
               / f"libblend_lists_ab_{name}_{h.hexdigest()[:12]}.so")
        jobs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *flags, "-Xptxas", "-v", "-o", str(out),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out, src)
    built = {}
    for name, (proc, out, src) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {src}:\n{log}")
        regs, fn = {}, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn is not None:
                regs[fn] = int(m.group(1))
        lib = load(out)
        if "madd" not in src.read_text():
            lib = _NoMaddInterface(lib)
        built[name] = (lib, regs)
    return built


def same_bits(libs, first, rows, intr):
    """{kernel: {build: whether its outputs equal build ``first``'s bit
    for bit}} for fwd and fwd_counts over the frame and jvp8 over the
    tracking subset."""
    from monogs_tpu_torch import _build
    from monogs_tpu_torch.render import blend_lists as bl

    d_full, tx0, ty0, pmat, tsel, _, d_j, d_tan = rows
    wh = (intr.width, intr.height)
    calls = {
        "fwd": lambda: (bl.blend_lists(d_full, tx0, ty0, pmat, *wh),),
        "fwd_counts": lambda: bl.blend_lists_counts(d_full, tx0, ty0, pmat,
                                                    *wh),
        "jvp8": lambda: bl.blend_lists_jvp8(d_j, d_tan, tx0[tsel],
                                            ty0[tsel], pmat, *wh),
    }
    outs = {}
    for name, lib in libs.items():
        _build._LIBS["blend_lists"] = lib
        outs[name] = {k: f() for k, f in calls.items()}
    return {k: {name: all(bool(torch.equal(x, y)) for x, y in
                          zip(o[k], outs[first][k]))
                for name, o in outs.items()} for k in calls}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    other = ap.add_mutually_exclusive_group(required=True)
    other.add_argument("--against", type=Path, nargs="+",
                       help="roots of other checkouts whose blend_lists.cu "
                            "are the other builds")
    other.add_argument("--no-fmad", action="store_true",
                       help="the other build is this source without "
                            "-fmad=false")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of turns (default %(default)s)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("port_kernel_ab: needs a CUDA card")
    from monogs_tpu_torch import _build

    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    srcs = {}
    if args.no_fmad:
        srcs["no_fmad"] = (_build.SOURCES["blend_lists"],
                           [f for f in flags if f != "-fmad=false"])
    else:
        for d in args.against:
            srcs[d.name] = (d / "monogs_tpu_torch" / "csrc" /
                            "blend_lists.cu", flags)
    others = list(srcs)
    srcs["this"] = (_build.SOURCES["blend_lists"], flags)
    libs = {}
    for name, (lib, regs) in build(srcs).items():
        libs[name] = lib
        print(json.dumps({"build": name, "registers": regs}), flush=True)
    with_madd = not any(isinstance(lib, _NoMaddInterface)
                        for lib in libs.values())
    e_exp, _ = cs.expf_ops()

    dev = torch.device("cuda")
    intr, cfg, tcfg, scene, poses_fn = cs.make_bench(torch, dev)
    poses = poses_fn(3, 42)
    frame = cs.render_frames(torch, scene, poses[2:], intr, cfg,
                             with_depth=True)[0][0]
    print(json.dumps({"same_bits_as": others[0], **same_bits(
        libs, others[0], cs.tracking_rows(torch, intr, cfg, tcfg, scene,
                                          poses[1]), intr)}), flush=True)
    measures = ("ms", "device_ms")
    times: dict[str, dict[str, dict[str, list[float]]]] = {}
    names = others + ["this"]
    order = []
    for r in range(args.rounds):
        rot = names[r % len(names):] + names[:r % len(names)]
        order += rot + rot[::-1]
    for turn, name in enumerate(order):
        _build._LIBS["blend_lists"] = libs[name]
        entries = cs.kernel_phase(torch, intr, cfg, tcfg, scene, poses[1],
                                  frame, e_exp, strict=False)
        entries.update(cs.mapping_kernel_phase(torch, intr, cfg, scene,
                                               poses[1], frame, e_exp,
                                               with_madd=with_madd,
                                               strict=False))
        for e in entries.values():
            for m in measures:
                times.setdefault(m, {}).setdefault(e["name"], {}).setdefault(
                    name, []).append(e[m])
            print(json.dumps({"turn": turn, "build": name, **{
                k: e[k] for k in ("name", *measures, "bound_ms",
                                  "max_abs_err", "within_tol")}}),
                  flush=True)
    _build._LIBS["blend_lists"] = libs["this"]
    for kernel in times["ms"]:
        line = {"name": kernel}
        for m in measures:
            med = {b: statistics.median(v)
                   for b, v in times[m][kernel].items()}
            line[f"median_{m}"] = med
            line[f"{m}_over_first"] = {b: t / med[others[0]]
                                       for b, t in med.items()}
        print(json.dumps(line), flush=True)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main()
