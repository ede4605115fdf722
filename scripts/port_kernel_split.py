"""Split the time of a blend kernel's CTAs over their phases, on one NVIDIA
GPU.

    python3 scripts/port_kernel_split.py [--kernel KERNEL] [--root DIR]

KERNEL is one of the list blends ``fwd``, ``fwd_counts`` and ``jvp8``,
run at the main path's shapes on the tracking rows of chip_smoke's scene
(``fwd`` and ``fwd_counts``: the whole frame, [1280, 96, 16]; ``jvp8``:
the tracking subset, S 152), or one of the macro-list kernels
``macro_fwd``, ``macro_bwd``, ``compact_fwd`` and ``compact_bwd``, run on
chip_smoke's macro lists at both of its macro shapes (640x480 / k_macro
1024 / k_fine 96 and 320x240 / k_macro 4096 / k_fine 256; the VJPs with
chip_smoke's L1 cotangent).

Copies ``monogs_tpu_torch/csrc`` of the checkout at DIR (default: this
one; for example the parent commit unpacked with ``git archive`` under
``build/``) into ``build/kernel_split/``, adds ``clock64()`` and
``%globaltimer`` stamps at the kernel's marks (thread 0 of each CTA keeps
a running split in shared memory: the cycles since the previous mark are
charged to the mark's label, over every chunk; the CTA's SM, start, end
and the chunks it ended are kept too; its end is its last warp's) and a
C function that copies them out, builds it with the library's nvcc flags,
and times and runs the kernel. Beside it, the uninstrumented copy is
built with only the report of the kernel's registers, shared memory and
resident CTAs per SM (``cudaFuncGetAttributes``,
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).

It prints one JSON line per shape with the stamps of the last launch: the
launch's span, each CTA's time (median, deciles, largest), when each SM's
last CTA ended (the earliest, median and latest SM), the number of SMs
that ran one, two or more of its CTAs and the most CTAs that one SM held
at once, and the shares of thread 0's cycles over all CTAs at each mark
(for example staging rows, thread 0's own walk, the wait at a chunk's
barrier for the slowest pixel) and after the last one; then the card's
name and power limit. For the forward blends the line also profiles what
the rows ask of a walk (``walk_profile``); for the macro-list kernels it
gives the distribution over CTAs of the rows that enter the tile (``n``,
after the cap) and of the chunks that some pixel walks into (``n_live``),
and for the VJPs the device time of the second kernel that sums the fine
tiles (the launch repeated ``REPS`` times, the difference over
``REPS - 1``). The stamps' own cost is in the times (the line's
``device_ms`` is the instrumented kernel's). Needs one CUDA card and nvcc;
imports nothing of JAX. The instrumented build is never part of the
library.

Each kernel has a list of targets, one per version of its source that
this script knows: the kernel, the anchors in its body and in the device
functions that it calls (``Site``) before which (or after which) the
stamps go. ``instrument`` takes the first target whose functions and
anchors are all in the source.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
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
MAX_MARKS = 12
# per CTA: SM, start and end (globaltimer), start and end (clock64), chunks
# ended, threads, dynamic shared memory; then the cycles of each mark
SLOTS = 8 + MAX_MARKS
# launches of a VJP's second kernel when its time is taken
REPS = 11
# the header that every blend source includes first; the stamps' state
# goes there
COMMON = "blend_common.cuh"

PRELUDE = """
__device__ long long split_stamps_[%d][%d];
// thread 0's running split of its CTA: cycles per mark, the last stamp,
// the chunks ended, whether this kernel stamps
__shared__ long long split_sh_[%d];
int split_reps_ = 1;
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
#define SPLIT_AT_(slot, chunk_end)                                   \\
  do {                                                               \\
    if (threadIdx.x == 0 && split_sh_[%d + 2]) {                     \\
      const long long n_ = clock64();                                \\
      split_sh_[slot] += n_ - split_sh_[%d];                         \\
      split_sh_[%d] = n_;                                            \\
      split_sh_[%d + 1] += (chunk_end);                              \\
    }                                                                \\
  } while (0)
""" % ((MAX_CTAS, SLOTS, MAX_MARKS + 3) + (MAX_MARKS,) * 4)

BEGIN = (
    "  const int split_cta_ = blockIdx.x + gridDim.x * blockIdx.y;\n"
    "  const bool split_on_ = (%s) && split_cta_ < " + str(MAX_CTAS) + ";\n"
    "  long long* const st_ = split_stamps_[split_on_ ? split_cta_ : 0];\n"
    "  if (threadIdx.x == 0) {\n"
    "    for (int i_ = 0; i_ < " + str(MAX_MARKS + 2) + "; ++i_)"
    " split_sh_[i_] = 0;\n"
    "    split_sh_[" + str(MAX_MARKS + 2) + "] = split_on_;\n"
    "    if (split_on_) { st_[0] = smid_(); st_[1] = gtimer_();"
    " st_[6] = blockDim.x; st_[7] = dsmem_();"
    " st_[3] = split_sh_[" + str(MAX_MARKS) + "] = clock64(); }\n"
    "  }\n")
MARK = "SPLIT_AT_(%d, %d);\n"
# the CTA's end: its last warp's
END = ("  if (threadIdx.x == 0 && split_on_) {\n"
       "    st_[4] = clock64(); st_[5] = split_sh_[" + str(MAX_MARKS + 1)
       + "];\n"
       "    for (int i_ = 0; i_ < " + str(MAX_MARKS) + "; ++i_)"
       " st_[8 + i_] = split_sh_[i_];\n"
       "  }\n"
       "  if (split_on_ && (threadIdx.x & 31) == 0)\n"
       "    atomicMax(reinterpret_cast<unsigned long long*>(st_ + 2),\n"
       "              (unsigned long long)gtimer_());\n")

EXPORT = """
extern "C" int split_stamps(void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, split_stamps_,
                                   (size_t)n * %d * sizeof(long long));
}
extern "C" void split_set_reps(int n) { split_reps_ = n; }
""" % SLOTS

# registers, static + dynamic shared memory and resident CTAs per SM of
# the kernel at nt threads and smem bytes of dynamic shared memory
ATTRS = """
extern "C" int split_attrs(int nt, int smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t rc = cudaFuncGetAttributes(&a, %s);
  if (rc == cudaSuccess && smem > 48 * 1024)
    rc = cudaFuncSetAttribute(%s,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
class Site:
    """A device function that the kernel calls: ``file`` under csrc, the
    function whose signature starts with ``func``, and its ``marks``
    (anchor, label, where) as in Target; ``rewrite`` as in Target."""
    file: str
    func: str
    marks: tuple
    rewrite: tuple = ()


@dataclass(frozen=True)
class Target:
    """Where a kernel's phases are: ``file`` under csrc and the kernel
    whose signature starts with ``func``. In its body (after ``rewrite``,
    pairs of (old, new) statements that split a barrier from the break
    that reads it), each anchor is exactly once: ``begin``, before which
    the CTA's start is stamped; ``marks``, (anchor, label, where) in
    program order, stamped before or after the anchor (``where``);
    ``end``, before which the CTA's end is stamped (None: the end of the
    function). ``sites``: the device functions with more marks, in the
    order in which the kernel calls them. The time from one mark to the
    next in a CTA's run is charged to the later mark's label; a stamp of
    label ``chunk`` ends a chunk. ``select`` is the C condition under
    which this instantiation of the kernel stamps; ``kernel`` the kernel
    whose attributes are reported (at file scope of ``file``);
    ``second``, a second kernel's launch in the C entry (the text before
    its ``<<<``, once in ``file``), repeated as ``split_set_reps`` asks."""
    file: str
    func: str
    begin: str
    marks: tuple
    end: str | None
    select: str
    kernel: str
    rewrite: tuple = ()
    sites: tuple = ()
    chunk: str | None = None
    second: str | None = None

    def labels(self) -> list[str]:
        """The marks' labels, each once, in the order of their slots."""
        out = []
        for m in self.marks + sum((s.marks for s in self.sites), ()):
            if m[1] not in out:
                out.append(m[1])
        return out


# The walk since PR 7: the warps walk independently, each syncing only
# itself at a chunk's start (its copy of the chunk has landed, the other
# buffer is free), voting on its exit, issuing the next chunk's copy,
# culling the chunk's rows, walking the rest; the stamps are warp 0's.
_WALK_MARKS = (
    ("    __syncwarp();  // the chunk's rows visible, the other buffer "
     "free\n", "copy_wait", "after"),
    ("    if (ch + 1 < nch) stage(ch + 1);\n", "exit_vote", "before"),
    ("    const int n = min(KC, kf - ch * KC);\n", "staging", "before"),
    ("    int my_cnt = 0;\n", "cull", "before"),
    ("    if (COUNTS && my_cnt != 0) atomicAdd(", "walk", "before"))
# now in fwd_walk (blend_forward.cuh), which the macro forward shares;
# in the version before it, in fwd_kernel itself
_FWD_WALK = Site(file="blend_forward.cuh",
                 func="__device__ __forceinline__ void fwd_walk(",
                 marks=_WALK_MARKS)
_FWD_END = "  if constexpr (COUNTS) {\n    __syncthreads();\n    float* cnts_t"
FWD = dict(file="blend_lists.cu",
           func="fwd_kernel(const float* __restrict__ d,",
           begin="  float o[NPX][5];\n", marks=(), end=_FWD_END,
           sites=(_FWD_WALK,), chunk="walk")
FWD_V1 = dict(file="blend_lists.cu",
              func="fwd_kernel(const float* __restrict__ d,",
              begin="  float T[NPX], o[NPX][5];\n", marks=_WALK_MARKS,
              end=_FWD_END, chunk="walk")
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
    select="true", kernel="jvp8_kernel<JVP_NTG, JVP_PARTS>",
    chunk="exit_barrier")

# The macro-list kernels as they are: the index scan (up to cap rows), then
# the list forward's walk (fwd_walk) over the index, or the tensor-core
# reverse (forward_live, then per live chunk back to front: staging, the
# record of alpha and T per slice, the suffix pass, the products on the
# tensor cores, the row sums over the warps, the write-out), and a second
# kernel that adds the compact partials over the fine tiles.
MACRO_FWD = Target(
    file="blend_macros.cu", func="__global__ void macro_fwd_kernel(",
    begin="  const FineTile ft = fine_tile(xy0, tile, ft_side);\n",
    marks=(("  float o[NPX][5];\n", "index_scan", "before"),), end=None,
    select="true", kernel="macro_fwd_kernel", sites=(_FWD_WALK,),
    chunk="walk")
MACRO_BWD = Target(
    file="blend_macros.cu", func=" macro_bwd_kernel(const float*",
    begin="  const FineTile ft = fine_tile(xy0, tile, ft_side);\n",
    marks=(("  const SplitCk ck{\n", "index_scan", "before"),), end=None,
    select="true", kernel="macro_bwd_kernel<1>",
    sites=(
        Site(file=COMMON,
             func="__device__ __forceinline__ void forward_live(",
             rewrite=(("    if (!__syncthreads_or(walking)) break;\n",
                       "    const bool any_ = __syncthreads_or(walking);\n"
                       "    if (!any_) break;\n"),),
             marks=(("    if (!any_) break;\n", "fwd_exit_barrier",
                     "before"),
                    ("    stage_rows(rows, c, k0, n);\n    __syncthreads();"
                     "\n", "fwd_staging", "after"),
                    ("        T[s] = test;\n      }\n    }\n", "fwd_walk",
                     "after"))),
        Site(file=COMMON,
             func="__device__ __forceinline__ void reverse_tile_tc(",
             marks=(("  float S[NSL], Sd[NSL];", "zero_rows", "before"),)),
        Site(file=COMMON,
             func="__device__ __forceinline__ void reverse_chunk_tc(",
             marks=(("  stage_rows(rows, c, k0, n);\n  __syncthreads();\n",
                     "rev_staging", "after"),
                    ("        A1[i * lda + c.p] = tx;\n      }\n    }\n",
                     "rev_record", "after"),
                    ("      if constexpr (DEPCHAIN) A2[i * lda + c.p] = sbd;"
                     "\n    }\n", "rev_suffix", "after"),
                    ("    __syncwarp();\n", "rev_barrier", "before"),
                    ("    __syncthreads();  // every warp has read the "
                     "operands\n", "rev_mma", "before"),
                    ("  // columns of tot per row: moments 0-5", "rev_row_sums",
                     "before"),
                    ("                tr[11]);\n  }\n", "write_out",
                     "after")))),
    chunk="write_out", second="  sum_fine_tiles")

# The earlier macro-list kernels: one thread per pixel; the
# overlapping rows' index built by a block scan, then forward_walk (two
# barriers around each chunk's staging, an exit vote), or
# forward_checkpointed and the scalar reverse_blend (warp shuffles per row)
# over the index, and a second kernel that sums the dense per-fine-tile
# partials.
_INDEX_V1 = ("  const auto c = make_tile(blockIdx.x, ft.x0, ft.y0, pmat,\n",
             "index_scan", "before")
MACRO_FWD_V1 = Target(
    file="blend_macros.cu", func="__global__ void macro_fwd_kernel(",
    begin="  const FineTile ft = fine_tile(xy0, tile, ft_side);\n",
    marks=(_INDEX_V1,),
    end="  store8(outs + ((size_t)blockIdx.x * c.P + c.p) * 8, o);\n",
    select="true", kernel="macro_fwd_kernel",
    sites=(Site(
        file=COMMON, func="__device__ __forceinline__ void forward_walk(",
        rewrite=(("    if (__syncthreads_and(done)) break;\n",
                  "    const bool all_ = __syncthreads_and(done);\n"
                  "    if (all_) break;\n"),),
        marks=(("    stage_rows(rows, c, k0, n);\n", "barrier_in",
                "before"),
               ("    for (int i = 0; i < n; ++i) {\n", "staging", "before"),
               ("    const bool all_ = __syncthreads_and(done);\n", "walk",
                "before"),
               ("    if (all_) break;\n", "exit_barrier", "before"))),),
    chunk="exit_barrier")
MACRO_BWD_V1 = Target(
    file="blend_macros.cu", func="__global__ void macro_bwd_kernel(",
    begin="  const FineTile ft = fine_tile(xy0, tile, ft_side);\n",
    marks=(_INDEX_V1,), end=None, select="true", kernel="macro_bwd_kernel",
    sites=(
        Site(file=COMMON,
             func="__device__ __forceinline__ int forward_checkpointed(",
             rewrite=(("      if (__syncthreads_and(kend < kf)) {\n",
                       "      const bool all_ = __syncthreads_and(kend < "
                       "kf);\n      if (all_) {\n"),),
             marks=(("    if (kend == kf) {\n", "ck_staging", "before"),
                    ("    if constexpr (Rows::kStopEarly) {\n", "ck_walk",
                     "before"),
                    ("      if (all_) {\n", "ck_exit_barrier", "before"))),
        Site(file=COMMON,
             func="__device__ __forceinline__ void reverse_blend(",
             marks=(("  float S = 0.f, Sd = 0.f;", "zero_rows", "before"),
                    ("    float Tc = ck[ch * c.P + c.p];\n", "rev_staging",
                     "before"),
                    ("    for (int i = n - 1; i >= 0; --i) {\n",
                     "rev_recompute", "before"),
                    ("        red[(i * c.nw + c.warp) * NV + j] = "
                     "warp_sum(v[j]);\n    }\n", "rev_rows_shuffles",
                     "after"),
                    ("    for (int i = c.p; i < n; i += c.P) {\n",
                     "rev_barrier", "before"),
                    ("                  tot[NV0 + 6]);\n    }\n",
                     "write_out", "after")))),
    chunk="write_out", second="  sum_fine_tiles")

TARGETS = {
    "fwd": tuple(Target(**w, select="!COUNTS", kernel="fwd_kernel<false>")
                 for w in (FWD, FWD_V1)),
    "fwd_counts": tuple(Target(**w, select="COUNTS",
                               kernel="fwd_kernel<true>")
                        for w in (FWD, FWD_V1)),
    "jvp8": (JVP8,),
    "macro_fwd": (MACRO_FWD, MACRO_FWD_V1),
    "compact_fwd": (MACRO_FWD, MACRO_FWD_V1),
    "macro_bwd": (MACRO_BWD, MACRO_BWD_V1),
    "compact_bwd": (MACRO_BWD, MACRO_BWD_V1),
}
MACRO_KERNELS = ("macro_fwd", "macro_bwd", "compact_fwd", "compact_bwd")


def _body(text: str, func: str):
    """(start, end) of the body of the function whose signature starts
    with ``func``, or None."""
    at = text.find(func)
    if at < 0:
        return None
    start = text.index("{\n", at) + 2
    return start, text.index("\n}\n", start) + 1


def _stamp(body: str, marks, rewrite, slots, chunk) -> str | None:
    """``body`` with ``rewrite`` applied and a stamp at each of ``marks``,
    or None if an old statement or an anchor is not in it exactly once."""
    for old, new in rewrite:
        if body.count(old) != 1:
            return None
        body = body.replace(old, new)
    if any(body.count(m[0]) != 1 for m in marks):
        return None
    stamps = {}
    for anchor, label, where in marks:
        text = MARK % (slots[label], int(label == chunk))
        before, after = stamps.get(anchor, ("", ""))
        stamps[anchor] = ((before + text, after) if where == "before"
                          else (before, after + text))
    for anchor, (before, after) in stamps.items():
        body = body.replace(anchor, before + anchor + after)
    return body


def _patch_kernel(body: str, t: Target) -> str | None:
    """The kernel's body with its stamps, or None if an anchor is not in
    it exactly once."""
    slots = {lab: i for i, lab in enumerate(t.labels())}
    for a in (t.begin,) + ((t.end,) if t.end else ()):
        if body.count(a) != 1 or any(a in m[0] or m[0] in a
                                     for m in t.marks):
            return None
    body = _stamp(body, t.marks, t.rewrite, slots, t.chunk)
    if body is None or body.count(t.begin) != 1:
        return None
    body = body.replace(t.begin, BEGIN % t.select + t.begin)
    return body + END if t.end is None else body.replace(t.end, END + t.end)


def _apply(files: dict[str, str], t: Target) -> dict[str, str] | None:
    """``files`` with every function of ``t`` stamped, or None if one of
    them or an anchor is missing."""
    out = dict(files)
    slots = {lab: i for i, lab in enumerate(t.labels())}
    if len(slots) > MAX_MARKS:
        return None
    for file, func, fix in ((t.file, t.func, None),) + tuple(
            (s.file, s.func, s) for s in t.sites):
        text = out.get(file, "")
        span = _body(text, func)
        if not span:
            return None
        body = text[span[0]:span[1]]
        body = (_patch_kernel(body, t) if fix is None else
                _stamp(body, fix.marks, fix.rewrite, slots, t.chunk))
        if body is None:
            return None
        out[file] = text[:span[0]] + body + text[span[1]:]
    if t.second is not None:
        text = out[t.file]
        if text.count(t.second + "<<<") != 1:
            return None
        out[t.file] = text.replace(
            t.second + "<<<", "  for (int rep_ = 0; rep_ < split_reps_; "
            "++rep_)\n" + t.second + "<<<")
    return out


def find_target(files: dict[str, str], kernel: str) -> Target:
    """The first of ``kernel``'s targets that ``files`` ({name: text} of a
    csrc directory) match; raises ValueError if none does."""
    for t in TARGETS[kernel]:
        if _apply(files, t) is not None:
            return t
    raise ValueError(f"no known version of {kernel}'s walk in these sources")


def instrument(files: dict[str, str], kernel: str,
               stamps: bool = True) -> dict[str, str]:
    """``files`` ({name: text} of a csrc directory) with ``kernel``'s
    phases stamped (unless ``stamps`` is false), the stamps' state in the
    common header, and the kernel's file given the exports
    ``split_stamps``, ``split_set_reps`` and ``split_attrs``; the rest
    unchanged."""
    t = find_target(files, kernel)
    out = dict(files)
    if stamps:
        out = _apply(files, t)
        text = out[COMMON]
        ns = text.index("namespace {") + len("namespace {")
        out[COMMON] = text[:ns] + PRELUDE + text[ns:]
    out[t.file] += (EXPORT if stamps else "") + ATTRS % ((t.kernel,) * 3)
    return out


def split_stats(rows, labels):
    """The shares and spans of one launch's stamps (one list of SLOTS
    values per CTA that ran); ``labels``: the target's labels."""
    m = len(labels)
    res = []
    for st in rows:
        parts = list(st[8:8 + m])
        cyc = st[4] - st[3]
        res.append(dict(sm=st[0], t0=st[1], t1=st[2], ns=st[2] - st[1],
                        cyc=cyc, parts=parts, tail=cyc - sum(parts),
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
        share_after_last_mark=sum(x["tail"] for x in res) / tot,
        chunks_mean=statistics.fmean(x["chunks"] for x in res))


# alpha >= 1/255 needs s >= log(1/255) = -5.5413 (expf errs by 2 ulp):
# below S_LO no pair passes the alpha test
S_LO = -5.55
KC = 32  # rows of a chunk (csrc/blend_common.cuh)


def walk_profile(torch, bl, d, tx0, ty0, pmat, width, height, n_rows=None):
    """What the forward's rows ask of its threads, from the plain version
    on the card: (row, pixel) pairs walked (up to and including the
    pixel's terminating row, and within the tile's first ``n_rows`` [T]
    rows where given), passing the alpha test, contributing, and with s
    in [S_LO, log-opacity + 1e-4] (candidates: the only pairs that may
    pass); rows whose log-opacity + 1e-4 is below S_LO (no pixel can take
    them); and for a thread holding ``npx`` adjacent pixels of a 32-thread
    warp, the pixel slots that the warps' walks issue (each warp walks to
    its last pixel's end) and the share of (warp, row) steps in which some
    still-walking pixel of the warp is a candidate."""
    f = bl._forward_plain(d, tx0, ty0, pmat, width, height)
    logo = d[..., 11]
    s = (-0.5 * (f["a"][..., None] * f["dx"] * f["dx"]
                 + f["c"][..., None] * f["dy"] * f["dy"])
         - f["b"][..., None] * f["dx"] * f["dy"] + logo[..., None])
    lim = logo + 1e-4
    n_t, kf, n_p = s.shape
    term = f["ok"] & ~f["contrib"]
    stop = torch.where(term.any(1), term.int().argmax(1) + 1, kf)
    if n_rows is not None:
        stop = torch.minimum(stop, n_rows[:, None])
    pix_ok = ((tx0[:, None] + pmat[3] <= width - 1)
              & (ty0[:, None] + pmat[4] <= height - 1))
    stop = torch.where(pix_ok, stop, torch.zeros_like(stop))     # [T, P]
    k = torch.arange(kf, device=d.device)[None, :, None]
    walking = k < stop[:, None, :]
    cand = walking & (s >= S_LO) & (s <= lim[..., None])
    rows_ok = (torch.arange(kf, device=d.device)[None] < n_rows[:, None]
               if n_rows is not None else torch.ones_like(lim, dtype=bool))
    out = dict(walked=int(walking.sum()), ok=int((walking & f["ok"]).sum()),
               contrib=int(f["contrib"].sum()), cand=int(cand.sum()),
               rows=int(rows_ok.sum()),
               rows_no_pixel=int((rows_ok & (lim < S_LO)).sum()))
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


def _quantiles(xs):
    xs = sorted(xs)
    at = lambda q: xs[min(len(xs) - 1, int(q * len(xs)))]  # noqa: E731
    return dict(mean=statistics.fmean(xs), min=xs[0], p10=at(0.1),
                p25=at(0.25), p50=at(0.5), p75=at(0.75), p90=at(0.9),
                p99=at(0.99), max=xs[-1])


def macro_row_stats(torch, bl, bm, args, geo, k_fine, walk=False):
    """Over the CTAs (macro, fine tile) of a macro-list kernel: the
    distribution of ``n``, the rows that enter the tile after the cap (Km,
    or ``k_fine``), and of ``n_live``, the chunks of KC of them that some
    pixel of the tile walks into (a pixel walks to its terminating row,
    or through all n; a pixel beyond the image walks none); the share of
    CTAs with n_live at most 4, 8, 16 and 32; with ``walk``, the walk
    profile of the rows gathered through the index."""
    data_m, xy0, counts, pmat = args
    tile, fs, width, height = geo
    n_macro, km, _ = data_m.shape
    cap = km if k_fine is None else min(k_fine, km)
    ft, p = fs * fs, pmat.shape[1]
    ns, lives, prof = [], [], {}
    for sl in bm.macro_chunks(n_macro, ft, cap, p):
        d, _, vld, tx0, ty0 = bm.compact_chunk(data_m, xy0, counts, tile, fs,
                                               cap, sl)
        n = vld.sum(-1).reshape(-1)                                # [T]
        f = bl._forward_plain(d, tx0, ty0, pmat, width, height)
        term = f["ok"] & ~f["contrib"]
        stop = torch.where(term.any(1), term.int().argmax(1) + 1, cap)
        stop = torch.minimum(stop, n[:, None])
        pix_ok = ((tx0[:, None] + pmat[3] <= width - 1)
                  & (ty0[:, None] + pmat[4] <= height - 1))
        stop = torch.where(pix_ok, stop, torch.zeros_like(stop)).amax(1)
        ns += n.tolist()
        lives += ((stop + KC - 1) // KC).tolist()
        if walk:
            for k, v in walk_profile(torch, bl, d, tx0, ty0, pmat, width,
                                     height, n_rows=n).items():
                if isinstance(v, dict):
                    for k2, v2 in v.items():
                        prof.setdefault(k, {})[k2] = (
                            prof.get(k, {}).get(k2, 0) + v2)
                else:
                    prof[k] = prof.get(k, 0) + v
        del d, f
    out = dict(cap=cap, n_chunks_cap=math.ceil(cap / KC),
               n=_quantiles(ns), n_live=_quantiles(lives),
               n_live_at_most={L: sum(x <= L for x in lives) / len(lives)
                               for L in (4, 8, 16, 32)})
    if walk:
        out["walk"] = prof
    return out


def build(srcs: dict[str, Path], flags) -> dict[str, Path]:
    """Build each source of ``srcs`` ({name: path}) with one nvcc each,
    started together; {name: library}."""
    from monogs_tpu_torch import _build

    jobs = {}
    for name, src in srcs.items():
        lib = src.parent / f"lib{src.stem}_{name}.so"
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


def read_stamps(lib, n_cta):
    buf = (ctypes.c_longlong * (MAX_CTAS * SLOTS))()
    rc = lib.split_stamps(ctypes.addressof(buf), MAX_CTAS)
    if rc != 0:
        sys.exit(f"split_stamps failed with CUDA error {rc}")
    return [buf[i * SLOTS:(i + 1) * SLOTS] for i in range(min(n_cta,
                                                               MAX_CTAS))
            if buf[i * SLOTS + 1] != 0]


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
    from monogs_tpu_torch.render import blend_macros as bm

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
        srcs[name] = d / target.file
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    libs = build(srcs, flags)
    lib_name = Path(target.file).stem
    lib = ab.load_as(libs["split"], lib_name, files[target.file])
    lib.split_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.split_set_reps.argtypes = [ctypes.c_int]
    lib.split_set_reps.restype = None
    _build._LIBS[lib_name] = lib
    plain = ctypes.CDLL(str(libs["plain"]))
    labels = target.labels()

    dev = torch.device("cuda")
    intr, cfg, tcfg, scene, poses_fn = cs.make_bench(torch, dev)
    poses = poses_fn(3, 42)
    if args.kernel in MACRO_KERNELS:
        frame = cs.render_frames(torch, scene, poses[2:], intr, cfg,
                                 with_depth=False)[0][0]
        kind, step = args.kernel.split("_")
        for tag, margs, geo, kf, gt in cs.macro_cases(
                torch, intr, cfg, scene, poses[1], poses[2], frame):
            k_fine = kf if kind == "compact" else None
            outs = bm.blend_macros(*margs, *geo, k_fine=k_fine)
            g_outs = cs.l1_cotangent(torch, outs, gt, geo[2], geo[3])
            fn = ((lambda: bm.blend_macros(*margs, *geo, k_fine=k_fine))
                  if step == "fwd" else
                  (lambda: bm.blend_macros_vjp(*margs, g_outs, *geo,
                                               k_fine=k_fine)))
            device_ms = cs.kernel_ms(torch, fn)
            line = {}
            if target.second is not None:
                lib.split_set_reps(REPS)
                line["second_kernel_ms"] = (cs.kernel_ms(torch, fn)
                                            - device_ms) / (REPS - 1)
                lib.split_set_reps(1)
            fn()
            torch.cuda.synchronize()
            n_cta = margs[0].shape[0] * geo[1] ** 2
            stats = split_stats(read_stamps(lib, n_cta), labels)
            nt, smem = stats["threads"], stats["dyn_smem_bytes"]
            print(json.dumps({"kernel_split": dict(
                kernel=args.kernel + tag, root=str(args.root),
                shape=list(margs[0].shape), p=int(margs[3].shape[1]),
                **stats, device_ms=device_ms, **line,
                attrs=attrs(plain, nt, smem),
                attrs_instrumented=attrs(lib, nt, smem),
                rows=macro_row_stats(torch, bl, bm, margs, geo, k_fine,
                                     walk=step == "fwd"))}), flush=True)
            del outs, g_outs
    else:
        d_full, tx0, ty0, pmat, tsel, _, d_j, d_tan = cs.tracking_rows(
            torch, intr, cfg, tcfg, scene, poses[1])
        wh = (intr.width, intr.height)
        fn = {
            "fwd": lambda: bl.blend_lists(d_full, tx0, ty0, pmat, *wh),
            "fwd_counts": lambda: bl.blend_lists_counts(d_full, tx0, ty0,
                                                        pmat, *wh),
            "jvp8": lambda: bl.blend_lists_jvp8(d_j, d_tan, tx0[tsel],
                                                ty0[tsel], pmat, *wh),
        }[args.kernel]
        device_ms = cs.kernel_ms(torch, fn)
        fn()
        torch.cuda.synchronize()
        d_run = d_j if args.kernel == "jvp8" else d_full
        stats = split_stats(read_stamps(lib, MAX_CTAS), labels)
        nt, smem = stats["threads"], stats["dyn_smem_bytes"]
        if args.kernel != "jvp8":
            stats["walk"] = walk_profile(torch, bl, d_full, tx0, ty0, pmat,
                                         *wh)
        print(json.dumps({"kernel_split": dict(
            kernel=args.kernel, root=str(args.root),
            shape=list(d_run.shape), **stats, device_ms=device_ms,
            attrs=attrs(plain, nt, smem),
            attrs_instrumented=attrs(lib, nt, smem))}), flush=True)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main()
