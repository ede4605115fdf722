"""Split the time of a list-blend kernel's CTAs over their phases, on one
NVIDIA GPU.

    python3 scripts/port_kernel_split.py [--kernel fwd|fwd_counts|jvp8]
                                         [--root DIR]

Copies ``monogs_tpu_torch/csrc`` of the checkout at DIR (default: this
one; for example the parent commit unpacked with ``git archive`` under
``build/``) into ``build/kernel_split/``, adds ``clock64()`` and
``%globaltimer`` stamps to the kernel's walk (thread 0 of each CTA: its
SM, its start, one stamp at each of the walk's marks in every chunk, its
end; the CTA's end is its last warp's) and a C function that copies them
out, builds it with the library's nvcc flags, and times and runs the
kernel at the main path's shapes on the tracking rows of chip_smoke's
scene (``fwd`` and ``fwd_counts``: the whole frame, [1280, 96, 16];
``jvp8``: the tracking subset, S 152). Beside it, the uninstrumented copy
is built with only the report of the kernel's registers, shared memory
and resident CTAs per SM (``cudaFuncGetAttributes``,
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).

It prints one JSON line with the stamps of the last launch: the launch's
span, each CTA's time (median, deciles, largest), when each SM's last CTA
ended (the earliest, median and latest SM), the number of SMs that ran
one, two or more of its CTAs and the most CTAs that one SM held at once,
and the shares of thread 0's cycles over all CTAs in each phase of the
walk, as the kernel's target names them (for example staging rows,
thread 0's own walk, the wait at a chunk's barrier for the slowest
pixel), and after the last chunk; then the card's name and power limit.
For the forward blends the line also profiles what the frame's rows ask
of a walk (``walk_profile``). The stamps' own cost is in the times (the
line's ``device_ms`` is the instrumented kernel's). Needs one CUDA card
and nvcc; imports nothing of JAX. The instrumented build is never part
of the library.

Each kernel has a list of targets, one per version of its source that
this script knows: the function that holds the walk, and the anchors in
it before which (or after which) the stamps go. ``instrument`` takes the
first target whose function and anchors are all in the source.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

MAX_CTAS = 16384
MAX_CHUNKS = 8
MAX_MARKS = 5
# per CTA: SM, start and end (globaltimer), start and end (clock64), chunks
# walked, threads, dynamic shared memory; then MAX_MARKS stamps per chunk
SLOTS = 8 + MAX_MARKS * MAX_CHUNKS

PRELUDE = """
__device__ long long split_stamps_[%d][%d];
__device__ __forceinline__ long long gtimer_() {
  long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ long long smid_() {
  unsigned r;
  asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(r));
  return r;
}
__device__ __forceinline__ long long dsmem_() {
  unsigned r;
  asm volatile("mov.u32 %%0, %%%%dynamic_smem_size;" : "=r"(r));
  return r;
}
#define SPLIT_AT_(slot)                                              \\
  do {                                                               \\
    if (on_ && nch_ < %d) st_[8 + %d * nch_ + (slot)] = clock64();   \\
  } while (0)
""" % (MAX_CTAS, SLOTS, MAX_CHUNKS, MAX_MARKS)

BEGIN = (
    "  const bool on_ = threadIdx.x == 0 && (%s);\n"
    "  long long* st_ = split_stamps_[blockIdx.x + gridDim.x * blockIdx.y];\n"
    "  int nch_ = 0;\n"
    "  if (on_) { st_[0] = smid_(); st_[1] = gtimer_(); st_[6] = blockDim.x;"
    " st_[7] = dsmem_(); st_[3] = clock64(); }\n")
MARK = "SPLIT_AT_(%d);\n"
# the CTA's end: its last warp's
END = ("  if (on_) { st_[5] = nch_; st_[4] = clock64(); }\n"
       "  if ((threadIdx.x & 31) == 0)\n"
       "    atomicMax(reinterpret_cast<unsigned long long*>(st_ + 2),\n"
       "              (unsigned long long)gtimer_());\n")

EXPORT = """
extern "C" int split_stamps(void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, split_stamps_,
                                   (size_t)n * %d * sizeof(long long));
}
""" % SLOTS

# registers, static + dynamic shared memory and resident CTAs per SM of
# the kernel at nt threads and smem bytes of dynamic shared memory
ATTRS = """
extern "C" int split_attrs(int nt, int smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t rc = cudaFuncGetAttributes(&a, %s);
  int n = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, %s, nt, smem);
  out[0] = a.numRegs;
  out[1] = smem + (int)a.sharedSizeBytes;
  out[2] = n;
  return (int)rc;
}
"""


@dataclass(frozen=True)
class Target:
    """Where a kernel's walk is: ``file`` under csrc and the function
    whose signature starts with ``func``. In its body (after ``rewrite``,
    pairs of (old, new) statements that split a barrier from the break
    that reads it), each anchor is exactly once: ``begin``, before which
    the CTA's start is stamped; ``marks``, up to MAX_MARKS (anchor, label,
    where) in the program order of one chunk's iteration, stamped before or
    after the anchor (``where``), the last one ending the chunk; ``end``,
    before which the CTA's end is stamped (None: the end of the function).
    The time from one mark to the next is charged to the later mark's
    label. ``select`` is the C condition under which this instantiation of
    the function stamps; ``kernel`` the kernel whose attributes are
    reported (at file scope of blend_lists.cu); ``via``, where the walk is
    a function that the kernel calls, (file, the kernel's signature, the
    call) that must be in the kernel's body."""
    file: str
    func: str
    begin: str
    marks: tuple
    end: str | None
    select: str
    kernel: str
    rewrite: tuple = ()
    via: tuple | None = None


# The walk since PR 7: the warps walk independently, each syncing only
# itself at a chunk's start (its copy of the chunk has landed, the other
# buffer is free), voting on its exit, issuing the next chunk's copy,
# culling the chunk's rows, walking the rest; the stamps are warp 0's.
FWD = dict(
    file="blend_lists.cu",
    func="fwd_kernel(const float* __restrict__ d,",
    begin="  float T[NPX], o[NPX][5];\n",
    marks=(("    __syncwarp();  // the chunk's rows visible, the other buffer "
            "free\n", "copy_wait", "after"),
           ("    if (ch + 1 < nch) stage(ch + 1);\n", "exit_vote", "before"),
           ("    const int n = min(KC, kf - ch * KC);\n", "staging",
            "before"),
           ("    int my_cnt = 0;\n", "cull", "before"),
           ("    if (COUNTS && my_cnt != 0) atomicAdd(", "walk", "before")),
    end="  if constexpr (COUNTS) {\n    __syncthreads();\n    float* cnts_t")
# the walk before PR 7: forward_walk, which macro_fwd_kernel shares
FWD_V1 = dict(
    file="blend_common.cuh",
    func="__device__ __forceinline__ void forward_walk(",
    begin="  float T = 1.0f;\n",
    marks=(("    for (int i = 0; i < n; ++i) {\n", "staging", "before"),
           ("    const bool all_done = __syncthreads_and(done);\n", "walk",
            "before"),
           ("    const bool all_done = __syncthreads_and(done);\n",
            "exit_barrier", "after"),
           ("    if (all_done) break;\n", "counts", "before")),
    end=None,
    via=("blend_lists.cu", "__global__ void fwd_kernel(",
         "forward_walk<COUNTS>("))
JVP8 = Target(
    file="blend_lists.cu",
    func="__global__ void jvp8_kernel(",
    begin="  float T = 1.0f;\n",
    rewrite=(("    if (__syncthreads_and(done)) break;\n",
              "    const bool all_ = __syncthreads_and(done);\n"
              "    if (all_) break;\n"),),
    marks=(("    for (int i = 0; i < n && !done; ++i) {\n", "staging",
            "before"),
           ("    const bool all_ = __syncthreads_and(done);\n", "walk",
            "before"),
           ("    if (all_) break;\n", "exit_barrier", "before")),
    end="  cp_async_wait<0>();  // a chunk staged past the exit\n",
    select="true", kernel="jvp8_kernel<JVP_NTG, JVP_PARTS>")

TARGETS = {
    "fwd": tuple(Target(**w, select="!COUNTS", kernel="fwd_kernel<false>")
                 for w in (FWD, FWD_V1)),
    "fwd_counts": tuple(Target(**w, select="COUNTS",
                               kernel="fwd_kernel<true>")
                        for w in (FWD, FWD_V1)),
    "jvp8": (JVP8,),
}


def _body(text: str, func: str):
    """(start, end) of the body of the function whose signature starts
    with ``func``, or None."""
    at = text.find(func)
    if at < 0:
        return None
    start = text.index("{\n", at) + 2
    return start, text.index("\n}\n", start) + 1


def _patch_body(body: str, t: Target) -> str | None:
    """The body with the stamps, or None if an anchor is not in it
    exactly once."""
    for old, new in t.rewrite:
        if body.count(old) != 1:
            return None
        body = body.replace(old, new)
    anchors = {t.begin, *(m[0] for m in t.marks)} | (
        {t.end} if t.end else set())
    if any(body.count(a) != 1 for a in anchors):
        return None
    body = body.replace(t.begin, BEGIN % t.select + t.begin)
    stamps = {}
    for slot, (anchor, _, where) in enumerate(t.marks):
        text = MARK % slot + ("++nch_;\n" if slot == len(t.marks) - 1
                              else "")
        before, after = stamps.get(anchor, ("", ""))
        stamps[anchor] = ((before + text, after) if where == "before"
                          else (before, after + text))
    for anchor, (before, after) in stamps.items():
        body = body.replace(anchor, before + anchor + after)
    return body + END if t.end is None else body.replace(t.end, END + t.end)


def find_target(files: dict[str, str], kernel: str) -> Target:
    """The first of ``kernel``'s targets that ``files`` ({name: text} of a
    csrc directory) match; raises ValueError if none does."""
    for t in TARGETS[kernel]:
        if t.via:
            text = files.get(t.via[0], "")
            span = _body(text, t.via[1])
            if not span or t.via[2] not in text[span[0]:span[1]]:
                continue
        text = files.get(t.file, "")
        span = _body(text, t.func)
        if span and _patch_body(text[span[0]:span[1]], t) is not None:
            return t
    raise ValueError(f"no known version of {kernel}'s walk in these sources")


def instrument(files: dict[str, str], kernel: str,
               stamps: bool = True) -> dict[str, str]:
    """``files`` ({name: text} of a csrc directory) with ``kernel``'s walk
    stamped (unless ``stamps`` is false) and blend_lists.cu given the
    exports ``split_stamps`` and ``split_attrs``; the rest unchanged."""
    t = find_target(files, kernel)
    out = dict(files)
    if stamps:
        text = out[t.file]
        a, b = _body(text, t.func)
        text = text[:a] + _patch_body(text[a:b], t) + text[b:]
        ns = text.index("namespace {") + len("namespace {")
        out[t.file] = text[:ns] + PRELUDE + text[ns:]
    out["blend_lists.cu"] += (EXPORT if stamps else "") + ATTRS % (
        (t.kernel,) * 2)
    return out


def split_stats(rows, labels):
    """The shares and spans of one launch's stamps (one list of SLOTS
    values per CTA that ran); ``labels``: the target's marks' labels."""
    m = len(labels)
    res = []
    for st in rows:
        prev, parts = st[3], [0] * m
        for c in range(min(st[5], MAX_CHUNKS)):
            base = 8 + MAX_MARKS * c
            for j, s in enumerate(st[base: base + m]):
                parts[j] += s - prev
                prev = s
        res.append(dict(sm=st[0], t0=st[1], t1=st[2], ns=st[2] - st[1],
                        cyc=st[4] - st[3], parts=parts, tail=st[4] - prev,
                        chunks=st[5]))
    per_sm, on_sm = {}, {}
    for x in res:
        per_sm[x["sm"]] = per_sm.get(x["sm"], 0) + 1
        on_sm.setdefault(x["sm"], []).extend(((x["t0"], 1), (x["t1"], -1)))
    most = {}
    for sm, ev in on_sm.items():
        n = peak = 0
        for _, d in sorted(ev):
            n += d
            peak = max(peak, n)
        most[sm] = peak
    tot = sum(x["cyc"] for x in res)
    t_first = min(x["t0"] for x in res)
    ends = {}
    for x in res:
        ends[x["sm"]] = max(ends.get(x["sm"], 0), x["t1"])
    return dict(
        ctas=len(res), threads=rows[0][6], dyn_smem_bytes=rows[0][7],
        span_us=(max(x["t1"] for x in res) - min(x["t0"] for x in res))
        / 1e3,
        cta_us_median=statistics.median(x["ns"] for x in res) / 1e3,
        cta_us_max=max(x["ns"] for x in res) / 1e3,
        cta_us_deciles=[q / 1e3 for q in statistics.quantiles(
            [x["ns"] for x in res], n=10)],
        sm_last_end_us=[(q - t_first) / 1e3 for q in (
            min(ends.values()), statistics.median(ends.values()),
            max(ends.values()))],
        sm_mhz=statistics.median(x["cyc"] / x["ns"] * 1e3 for x in res),
        sms_by_ctas={k: list(per_sm.values()).count(k)
                     for k in sorted(set(per_sm.values()))},
        sms_by_most_at_once={k: list(most.values()).count(k)
                             for k in sorted(set(most.values()))},
        **{f"share_{lab}": sum(x["parts"][j] for x in res) / tot
           for j, lab in enumerate(labels)},
        share_after_last_chunk=sum(x["tail"] for x in res) / tot,
        chunks_mean=statistics.fmean(x["chunks"] for x in res))


# alpha >= 1/255 needs s >= log(1/255) = -5.5413 (expf errs by 2 ulp):
# below S_LO no pair passes the alpha test
S_LO = -5.55


def walk_profile(torch, bl, d, tx0, ty0, pmat, width, height):
    """What the forward's rows ask of its threads, from the plain version
    on the card: (row, pixel) pairs walked (up to and including the
    pixel's terminating row), passing the alpha test, contributing, and
    with s in [S_LO, log-opacity + 1e-4] (candidates: the only pairs that
    may pass); rows whose log-opacity + 1e-4 is below S_LO (no pixel can
    take them); and for a thread holding ``npx`` adjacent pixels of a
    32-thread warp, the pixel slots that the warps' walks issue (each
    warp walks to its last pixel's end) and the share of (warp, row)
    steps in which some still-walking pixel of the warp is a
    candidate."""
    f = bl._forward_plain(d, tx0, ty0, pmat, width, height)
    logo = d[..., 11]
    s = (-0.5 * (f["a"][..., None] * f["dx"] * f["dx"]
                 + f["c"][..., None] * f["dy"] * f["dy"])
         - f["b"][..., None] * f["dx"] * f["dy"] + logo[..., None])
    lim = logo + 1e-4
    n_t, kf, n_p = s.shape
    term = f["ok"] & ~f["contrib"]
    stop = torch.where(term.any(1), term.int().argmax(1) + 1, kf)
    pix_ok = ((tx0[:, None] + pmat[3] <= width - 1)
              & (ty0[:, None] + pmat[4] <= height - 1))
    stop = torch.where(pix_ok, stop, torch.zeros_like(stop))     # [T, P]
    k = torch.arange(kf, device=d.device)[None, :, None]
    walking = k < stop[:, None, :]
    cand = walking & (s >= S_LO) & (s <= lim[..., None])
    out = dict(walked=int(walking.sum()), ok=int((walking & f["ok"]).sum()),
               contrib=int(f["contrib"].sum()), cand=int(cand.sum()),
               rows=n_t * kf, rows_no_pixel=int((lim < S_LO).sum()))
    for npx in (1, 2):
        per_warp = 32 * npx
        w_stop = stop.reshape(n_t, -1, per_warp).amax(2)          # [T, W]
        steps = k < w_stop[:, None, :]                            # [T, K, W]
        any_cand = cand.reshape(n_t, kf, -1, per_warp).any(3) & steps
        out[f"npx{npx}"] = dict(
            slots=int(w_stop.sum()) * per_warp,
            warp_steps=int(steps.sum()),
            warp_steps_with_cand=int(any_cand.sum()))
    return out


def build(srcs: dict[str, Path], flags) -> dict[str, Path]:
    """Build each blend_lists.cu of ``srcs`` ({name: path}) with one nvcc
    each, started together; {name: library}."""
    from monogs_tpu_torch import _build

    jobs = {}
    for name, src in srcs.items():
        lib = src.parent / f"libblend_lists_{name}.so"
        jobs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *flags, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    for name, (proc, _) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{out}")
    return {name: lib for name, (_, lib) in jobs.items()}


def attrs(lib, nt, smem):
    buf = (ctypes.c_int * 3)()
    lib.split_attrs.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    rc = lib.split_attrs(nt, smem, ctypes.addressof(buf))
    if rc != 0:
        sys.exit(f"split_attrs failed with CUDA error {rc}")
    return dict(registers=buf[0], smem_bytes=buf[1], ctas_per_sm=buf[2])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(TARGETS), default="jvp8")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose csrc is instrumented")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("port_kernel_split: needs a CUDA card")
    import chip_smoke as cs
    import port_kernel_ab as ab
    from monogs_tpu_torch import _build
    from monogs_tpu_torch.render import blend_lists as bl

    csrc = args.root / "monogs_tpu_torch" / "csrc"
    files = {p.name: p.read_text() for p in sorted(csrc.iterdir())
             if p.suffix in (".cu", ".cuh")}
    work = (_build.BUILD_DIR / "kernel_split" / args.kernel
            / args.root.resolve().name)
    target = find_target(files, args.kernel)
    srcs = {}
    for name, stamps in (("split", True), ("plain", False)):
        d = work / name
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        for f, text in instrument(files, args.kernel, stamps).items():
            (d / f).write_text(text)
        srcs[name] = d / "blend_lists.cu"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    libs = build(srcs, flags)
    lib = ab.load(libs["split"])
    if "madd" not in files["blend_lists.cu"]:
        lib = ab._NoMaddInterface(lib)
    lib.split_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _build._LIBS["blend_lists"] = lib

    dev = torch.device("cuda")
    intr, cfg, tcfg, scene, poses_fn = cs.make_bench(torch, dev)
    poses = poses_fn(3, 42)
    d_full, tx0, ty0, pmat, tsel, _, d_j, d_tan = cs.tracking_rows(
        torch, intr, cfg, tcfg, scene, poses[1])
    wh = (intr.width, intr.height)
    fn = {
        "fwd": lambda: bl.blend_lists(d_full, tx0, ty0, pmat, *wh),
        "fwd_counts": lambda: bl.blend_lists_counts(d_full, tx0, ty0, pmat,
                                                    *wh),
        "jvp8": lambda: bl.blend_lists_jvp8(d_j, d_tan, tx0[tsel], ty0[tsel],
                                            pmat, *wh),
    }[args.kernel]
    device_ms = cs.kernel_ms(torch, fn)
    fn()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (MAX_CTAS * SLOTS))()
    rc = lib.split_stamps(ctypes.addressof(buf), MAX_CTAS)
    if rc != 0:
        sys.exit(f"split_stamps failed with CUDA error {rc}")
    rows = [buf[i * SLOTS:(i + 1) * SLOTS] for i in range(MAX_CTAS)
            if buf[i * SLOTS + 1] != 0]
    stats = split_stats(rows, [m[1] for m in target.marks])
    nt, smem = stats["threads"], stats["dyn_smem_bytes"]
    if args.kernel != "jvp8":
        stats["walk"] = walk_profile(torch, bl, d_full, tx0, ty0, pmat, *wh)
    print(json.dumps({"kernel_split": dict(
        kernel=args.kernel, root=str(args.root),
        shape=list((d_j if args.kernel == "jvp8" else d_full).shape),
        **stats, device_ms=device_ms,
        attrs=attrs(ctypes.CDLL(str(libs["plain"])), nt, smem),
        attrs_instrumented=attrs(lib, nt, smem))}), flush=True)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main()
