"""Split the time of the jvp8 kernel's CTAs over their phases, on one
NVIDIA GPU.

    python3 scripts/port_jvp8_split.py [--root DIR]

Copies ``monogs_tpu_torch/csrc`` of the checkout at DIR (default: this
one; for example the parent commit unpacked with ``git archive`` under
``build/``) into ``build/jvp8_split/``, adds ``clock64()`` and
``%globaltimer`` stamps to ``jvp8_kernel`` (thread 0 of each CTA: its SM,
its start, after each chunk's staging barrier, after its own walk of the
chunk, after the chunk's exit barrier, its end) and a C function that
copies them out, builds it with the library's nvcc flags, and runs
chip_smoke's tracking kernel phase on it (the tracking subset, S 152).
It prints one JSON line with the stamps of the phase's last jvp8 launch:
the launch's span, each CTA's time, the number of SMs holding one, two or
more of its CTAs, and the shares of all CTAs' cycles spent staging rows
(from a chunk's start to the barrier after its staging), in thread 0's
own walk, waiting at the exit barrier for the slowest pixel, and after
the last chunk; then the card's name and power limit. The stamps' own
cost is in the times. Needs one CUDA card and nvcc; imports nothing of
JAX. The instrumented build is never part of the library.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import port_kernel_ab as ab  # noqa: E402

SLOTS = 32          # stamps per CTA
MAX_CHUNKS = 8

PRELUDE = """
__device__ long long jvp8_stamps_[16384][%d];
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
""" % SLOTS

# (anchor in jvp8_kernel, text inserted before it)
PATCHES = (
    ("  float T = 1.0f;\n  float o[5] = {0.f, 0.f, 0.f, 0.f, 0.f};\n",
     "  long long* st_ = jvp8_stamps_[blockIdx.x + gridDim.x * blockIdx.y];\n"
     "  int nch_ = 0;\n"
     "  if (threadIdx.x == 0) { st_[0] = smid_(); st_[1] = gtimer_();"
     " st_[3] = clock64(); }\n"),
    ("    for (int i = 0; i < n && !done; ++i) {\n",
     "    if (threadIdx.x == 0 && nch_ < %d) st_[6 + 3 * nch_] = clock64();\n"
     % MAX_CHUNKS),
    ("    if (__syncthreads_and(done)) break;\n",
     "    if (threadIdx.x == 0 && nch_ < %d) st_[7 + 3 * nch_] = clock64();\n"
     "    const bool all_ = __syncthreads_and(done);\n"
     "    if (threadIdx.x == 0 && nch_ < %d) st_[8 + 3 * nch_] = clock64();\n"
     "    ++nch_;\n"
     "    if (all_) break;\n" % (MAX_CHUNKS, MAX_CHUNKS)),
)
END = ("  if (threadIdx.x == 0) { st_[5] = nch_; st_[4] = clock64();"
       " st_[2] = gtimer_(); }\n")
EXPORT = """
extern "C" int jvp8_stamps(void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, jvp8_stamps_,
                                   (size_t)n * %d * sizeof(long long));
}
""" % SLOTS


def instrument(src: str) -> str:
    """jvp8_kernel of ``src`` with the stamps; the rest unchanged."""
    head, sep, rest = src.partition("__global__ void jvp8_kernel(")
    assert sep, "no jvp8_kernel"
    body_end = rest.index("\n}\n")
    body = rest[:body_end]
    for anchor, text in PATCHES:
        assert anchor in body, anchor
        if "__syncthreads_and" in anchor:
            body = body.replace(anchor, text)
        else:
            body = body.replace(anchor, text + anchor)
    out_store = body.rindex("store8(outs")
    line = body.rindex("\n", 0, out_store) + 1
    body = body[:line] + END + body[line:]
    ns = head.index("namespace {") + len("namespace {")
    head = head[:ns] + PRELUDE + head[ns:]
    return head + sep + body + rest[body_end:] + EXPORT


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose csrc is instrumented")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("port_jvp8_split: needs a CUDA card")
    from monogs_tpu_torch import _build

    work = _build.BUILD_DIR / "jvp8_split" / args.root.resolve().name
    if work.exists():
        shutil.rmtree(work)
    shutil.copytree(args.root / "monogs_tpu_torch" / "csrc", work)
    src = work / "blend_lists.cu"
    src.write_text(instrument(src.read_text()))
    lib_path = work / "libblend_lists_split.so"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    r = subprocess.run([_build.nvcc_path(), *flags, "-o", str(lib_path),
                        str(src)], capture_output=True, text=True)
    if r.returncode != 0:
        sys.exit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ab.load(lib_path)
    if "madd" not in (args.root / "monogs_tpu_torch" / "csrc" /
                      "blend_lists.cu").read_text():
        lib = ab._NoMaddInterface(lib)
    lib.jvp8_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _build._LIBS["blend_lists"] = lib
    e_exp, _ = cs.expf_ops()
    dev = torch.device("cuda")
    intr, cfg, tcfg, scene, poses_fn = cs.make_bench(torch, dev)
    poses = poses_fn(3, 42)
    frame = cs.render_frames(torch, scene, poses[2:], intr, cfg,
                             with_depth=True)[0][0]
    seen = {}
    launch = lib.blend_jvp8

    def counting(*a):
        seen["n_tiles"] = a[7]
        return launch(*a)

    lib.blend_jvp8 = counting
    entries = cs.kernel_phase(torch, intr, cfg, tcfg, scene, poses[1],
                              frame, e_exp, strict=False)
    torch.cuda.synchronize()
    # every launch at this shape writes the same rows: the last one's
    buf = (ctypes.c_longlong * (16384 * SLOTS))()
    rc = lib.jvp8_stamps(ctypes.addressof(buf), 16384)
    if rc != 0:
        sys.exit(f"jvp8_stamps failed with CUDA error {rc}")
    rows = [buf[i * SLOTS:(i + 1) * SLOTS] for i in range(16384)
            if buf[i * SLOTS + 1] != 0]
    res = []
    for st in rows:
        prev, stage, walk, wait = st[3], 0, 0, 0
        for c in range(min(st[5], MAX_CHUNKS)):
            a, b, e = st[6 + 3 * c], st[7 + 3 * c], st[8 + 3 * c]
            stage, walk, wait = stage + a - prev, walk + b - a, wait + e - b
            prev = e
        res.append(dict(sm=st[0], ns=st[2] - st[1], cyc=st[4] - st[3],
                        stage=stage, walk=walk, wait=wait, tail=st[4] - prev,
                        chunks=st[5]))
    per_sm = {}
    for x in res:
        per_sm[x["sm"]] = per_sm.get(x["sm"], 0) + 1
    tot = sum(x["cyc"] for x in res)
    print(json.dumps({"jvp8_split": dict(
        root=str(args.root), ctas=len(res), n_tiles=seen.get("n_tiles"),
        span_us=(max(st[2] for st in rows) - min(st[1] for st in rows))
        / 1e3,
        cta_us_median=statistics.median(x["ns"] for x in res) / 1e3,
        cta_us_max=max(x["ns"] for x in res) / 1e3,
        sm_mhz=statistics.median(x["cyc"] / x["ns"] * 1e3 for x in res),
        sms_by_ctas={k: list(per_sm.values()).count(k)
                     for k in sorted(set(per_sm.values()))},
        share_staging=sum(x["stage"] for x in res) / tot,
        share_walk_thread0=sum(x["walk"] for x in res) / tot,
        share_wait_exit_barrier=sum(x["wait"] for x in res) / tot,
        share_after_last_chunk=sum(x["tail"] for x in res) / tot,
        chunks_mean=statistics.fmean(x["chunks"] for x in res),
        device_ms=entries["jvp8"]["device_ms"], ms=entries["jvp8"]["ms"])}),
        flush=True)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main()
