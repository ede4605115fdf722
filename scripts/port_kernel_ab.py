"""Time the port's blend kernels against other builds of them, in turns,
on one NVIDIA GPU.

    python3 scripts/port_kernel_ab.py --against DIR [DIR ...] [--rounds N]
                                      [--only blend_lists|blend_macros]
    python3 scripts/port_kernel_ab.py --no-fmad [--rounds N] [--only ...]

The other builds are either ``csrc/blend_lists.cu`` and
``csrc/blend_macros.cu`` of other checkouts (for example the parent
commit, unpacked with ``git archive``), with this checkout's nvcc flags,
or this checkout's sources without ``-fmad=false`` (nvcc then contracts
a * b + c into one FFMA; the library is built with the flag so that its
alpha and transmittance thresholds round as the plain PyTorch version's
do). Every build must have the same C interface, except that older ones
are called through adapters: a ``blend_map_grad`` without the ``madd``
argument (sources before the fused mapping step's madd variant; the madd
variant is then left out of the turns), and macro-list kernels without a
scratch (older sources, whose VJP takes a dense per-fine-tile partial
where the scratch is now). The attribute reports (``*_attrs``: registers and shared
memory, which the turns do not call) may be missing from the other
builds.

It prints each build's registers per kernel (``ptxas -v``), then whether
the forward blends', jvp8's and the macro-list forwards' outputs have the
same bits in every build as in the first other build (a redesign that
keeps each pixel's arithmetic must give them), then runs chip_smoke's
tracking and mapping kernel phases (kernels 1-6 at the main path's shapes
and the madd variant at its two) and its macro kernel phase (kernels 7-10
at the bench and configs/synthetic/rgbd.yaml shapes, 16 px tiles), each
kernel held against its plain version, with the libraries in turns
(``--only``: one source's kernels): each round runs every build
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
from monogs_tpu_torch.utils import roofline  # noqa: E402


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


class _DenseMacroInterface:
    """An older macro-list library (no ``macro_scratch_bytes``:
    ``macro_fwd`` takes no scratch, ``macro_bwd`` a dense per-fine-tile
    partial [Tm, ft, Km, 16] where the scratch is now), called with this
    checkout's arguments."""

    def __init__(self, lib):
        from monogs_tpu_torch import _build

        self._lib = lib
        sig = list(_build._SIGNATURES["blend_macros"]["macro_fwd"])
        lib.macro_fwd.argtypes = sig[:5] + sig[6:]

    def __getattr__(self, name):
        return getattr(self._lib, name)

    @staticmethod
    def macro_scratch_bytes(fwd, n_macro, km, cap, p, ft_side):
        return 0 if fwd else n_macro * ft_side * ft_side * km * 16 * 4

    def macro_fwd(self, *args):
        return self._lib.macro_fwd(*args[:5], *args[6:])


def load(path: Path, name: str = "blend_lists"):
    """The library at ``path`` with the C interface of source ``name``,
    but for the attribute reports (``*_attrs``), which the turns do not
    call and older builds lack."""
    from monogs_tpu_torch import _build

    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build._SIGNATURES[name].items():
        if not fn.endswith("_attrs") and (fn != "macro_scratch_bytes"
                                          or hasattr(lib, fn)):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _build._RESTYPES.get(fn,
                                                            ctypes.c_int)
    return lib


def load_as(path: Path, name: str, source: str):
    """``load``, with an adapter where ``source`` (the library's source
    text) has an older C interface than this checkout's."""
    lib = load(path, name)
    if name == "blend_lists" and "madd" not in source:
        return _NoMaddInterface(lib)
    if name == "blend_macros" and "macro_scratch_bytes" not in source:
        return _DenseMacroInterface(lib)
    return lib


LIBS = ("blend_lists", "blend_macros")


def build(srcs: dict[str, tuple[Path, list[str]]], names=LIBS):
    """Build the sources ``names`` of each csrc directory of ``srcs``
    ({build: (csrc, flags)}) with its flags (and ``-Xptxas -v``) into this
    checkout's build directory (two copies of one source are two
    libraries), one nvcc each, all started together; returns {build:
    ({source: the library with this checkout's C interface}, {kernel:
    registers})}."""
    from monogs_tpu_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (csrc, flags) in srcs.items():
        for lib_name in names:
            src = csrc / f"{lib_name}.cu"
            h = hashlib.sha256(src.read_bytes())
            for header in sorted(csrc.glob("*.cuh")):
                h.update(header.name.encode() + header.read_bytes())
            h.update(" ".join(flags).encode())
            out = (_build.BUILD_DIR
                   / f"lib{lib_name}_ab_{name}_{h.hexdigest()[:12]}.so")
            jobs[name, lib_name] = (subprocess.Popen(
                [_build.nvcc_path(), *flags, "-Xptxas", "-v", "-o",
                 str(out), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), out, src)
    built = {name: ({}, {}) for name in srcs}
    for (name, lib_name), (proc, out, src) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {src}:\n{log}")
        fn = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn is not None:
                built[name][1][fn] = int(m.group(1))
        built[name][0][lib_name] = load_as(out, lib_name, src.read_text())
    return built


def use(libs):
    """Make the wrappers launch the kernels of ``libs`` ({source: lib})."""
    from monogs_tpu_torch import _build

    _build._LIBS.update(libs)


def same_bits(libs, first, rows, intr, macro):
    """{kernel: {build: whether its outputs equal build ``first``'s bit
    for bit}} for fwd and fwd_counts over the frame, jvp8 over the
    tracking subset and the macro-list forwards on chip_smoke's macro
    lists (``macro``: its macro_cases; None leaves out the ones, or the
    others)."""
    from monogs_tpu_torch.render import blend_lists as bl
    from monogs_tpu_torch.render import blend_macros as bm

    calls = {}
    if rows is not None:
        d_full, tx0, ty0, pmat, tsel, _, d_j, d_tan = rows
        wh = (intr.width, intr.height)
        calls.update({
            "fwd": lambda: (bl.blend_lists(d_full, tx0, ty0, pmat, *wh),),
            "fwd_counts": lambda: bl.blend_lists_counts(d_full, tx0, ty0,
                                                        pmat, *wh),
            "jvp8": lambda: bl.blend_lists_jvp8(d_j, d_tan, tx0[tsel],
                                                ty0[tsel], pmat, *wh),
        })
    for tag, args, geo, kf, _ in macro or ():
        for kind, k_fine in (("macro", None), ("compact", kf)):
            calls[f"{kind}_fwd{tag}"] = (
                lambda a=args, g=geo, k=k_fine:
                (bm.blend_macros(*a, *g, k_fine=k),))
    outs = {}
    for name, lib in libs.items():
        use(lib)
        outs[name] = {k: f() for k, f in calls.items()}
    return {k: {name: all(bool(torch.equal(x, y)) for x, y in
                          zip(o[k], outs[first][k]))
                for name, o in outs.items()} for k in calls}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    other = ap.add_mutually_exclusive_group(required=True)
    other.add_argument("--against", type=Path, nargs="+",
                       help="roots of other checkouts whose csrc sources "
                            "are the other builds")
    other.add_argument("--no-fmad", action="store_true",
                       help="the other build is this source without "
                            "-fmad=false")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of turns (default %(default)s)")
    ap.add_argument("--only", choices=LIBS,
                    help="time only the kernels of this source (default: "
                         "both)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("port_kernel_ab: needs a CUDA card")
    from monogs_tpu_torch import _build

    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    csrc = _build.SOURCES["blend_lists"].path.parent
    srcs = {}
    if args.no_fmad:
        srcs["no_fmad"] = (csrc, [f for f in flags if f != "-fmad=false"])
    else:
        for d in args.against:
            srcs[d.name] = (d / "monogs_tpu_torch" / "csrc", flags)
    others = list(srcs)
    srcs["this"] = (csrc, flags)
    names = (args.only,) if args.only else LIBS
    libs = {}
    for name, (lib, regs) in build(srcs, names).items():
        libs[name] = lib
        print(json.dumps({"build": name, "registers": regs}), flush=True)
    with_madd = not any(isinstance(lib.get("blend_lists"), _NoMaddInterface)
                        for lib in libs.values())
    e_exp, _ = roofline.expf_ops()

    dev = torch.device("cuda")
    intr, cfg, tcfg, scene, poses_fn = cs.make_bench(torch, dev)
    poses = poses_fn(3, 42)
    frame = cs.render_frames(torch, scene, poses[2:], intr, cfg,
                             with_depth=True)[0][0]
    lists, macros = "blend_lists" in names, "blend_macros" in names
    print(json.dumps({"same_bits_as": others[0], **same_bits(
        libs, others[0],
        cs.tracking_rows(torch, intr, cfg, tcfg, scene, poses[1])
        if lists else None, intr,
        cs.macro_cases(torch, intr, cfg, scene, poses[1], poses[2], frame)
        if macros else None)}), flush=True)
    measures = ("ms", "device_ms")
    times: dict[str, dict[str, dict[str, list[float]]]] = {}
    builds = others + ["this"]
    order = []
    for r in range(args.rounds):
        rot = builds[r % len(builds):] + builds[:r % len(builds)]
        order += rot + rot[::-1]
    for turn, name in enumerate(order):
        use(libs[name])
        entries = {}
        if lists:
            entries.update(cs.kernel_phase(torch, intr, cfg, tcfg, scene,
                                           poses[1], frame, e_exp,
                                           strict=False))
            entries.update(cs.mapping_kernel_phase(
                torch, intr, cfg, scene, poses[1], frame, e_exp,
                with_madd=with_madd, strict=False))
        if macros:
            entries.update(cs.macro_kernel_phase(
                torch, intr, cfg, scene, poses[1], poses[2], frame, e_exp,
                tile32=False, strict=False, plain_reps=2))
        for e in entries.values():
            for m in measures:
                times.setdefault(m, {}).setdefault(e["name"], {}).setdefault(
                    name, []).append(e[m])
            print(json.dumps({"turn": turn, "build": name, **{
                k: e.get(k) for k in ("name", *measures, "bound_ms",
                                      "max_abs_err", "within_tol",
                                      "f64_excess")}}),
                  flush=True)
    use(libs["this"])
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
