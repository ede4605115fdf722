"""Reproducibility and time of one BA iteration for the port's package in
other checkouts, in turns, on one NVIDIA GPU.

    python3 scripts/port_ba_ab.py --against DIR [DIR ...] [--probe]

Runs chip_smoke's ``ba_repro_path`` (one BA iteration of the mapping
path's window three times from one saved state, on the default fused
branch at tile_frac 1.0 and 0.25 and on each A/B knob; every tensor of the
map and of the window's cameras compared bit for bit; the median ms of an
iteration) with the ``monogs_tpu_torch`` package of each checkout (this
one and each DIR, for example the parent commit unpacked with ``git
archive`` under ``build/``), each in a process of its own, in turns: the
others, this one, this one again, the others in reverse. Each process
builds its checkout's kernels into that checkout's ``build/``. It prints
one JSON line per turn: per branch whether the three runs gave the same
bits, the tensors that differed and the ms of an iteration. ``--probe``
also times, in this checkout's turns, one scatter of 1.2M rows of 16
floats into 100k ids by ``index_add_``, by ``index_put_`` with
accumulation and by ``renderer.scatter_sum``, and says whether three
repeats of each give the same bits. Then the card's name and power limit.
Needs one CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

TURN = r"""
import importlib.util, json, sys, time
from pathlib import Path
root, probe = Path(sys.argv[1]).resolve(), sys.argv[2] == "1"
sys.path.insert(0, str(root))
import torch
import monogs_tpu_torch
assert Path(monogs_tpu_torch.__file__).resolve().parent.parent == root
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              sys.argv[3])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
dev = torch.device("cuda")
intr, cfg, tcfg, scene, poses_fn = cs.make_bench(torch, dev)
poses = poses_fn(cs.MAP_VIEWS + 2, 42)
frames, _ = cs.render_frames(torch, scene, poses, intr, cfg,
                             with_depth=True)
out = dict(root=str(root), ba=cs.ba_repro_path(torch, intr, cfg, scene,
                                               frames, poses, strict=False))
if probe:
    from monogs_tpu_torch.render.renderer import scatter_sum
    g = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, 100_000, (1_200_000,), device=dev, generator=g)
    vals = torch.randn(1_200_000, 16, device=dev, generator=g)
    fns = {
        "index_add_": lambda: torch.zeros(100_000, 16, device=dev)
        .index_add_(0, ids, vals),
        "index_put_accumulate": lambda: torch.zeros(100_000, 16, device=dev)
        .index_put_((ids,), vals, accumulate=True),
        "scatter_sum": lambda: scatter_sum(100_000, ids, vals),
    }
    out["probe"] = {k: dict(same_bits=all(bool(torch.equal(f(), f()))
                                          for _ in range(3)),
                            device_ms=cs.kernel_ms(torch, f),
                            host_syncs=cs.count_syncs(torch, f)[0])
                    for k, f in fns.items()}
print(json.dumps(out), flush=True)
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, nargs="+", required=True,
                    help="roots of other checkouts")
    ap.add_argument("--probe", action="store_true",
                    help="also time and repeat the three scatters")
    args = ap.parse_args()
    others = [d.resolve() for d in args.against]
    order = others + [ROOT, ROOT] + others[::-1]
    for turn, root in enumerate(order):
        probe = "1" if args.probe and root == ROOT else "0"
        r = subprocess.run([sys.executable, "-c", TURN, str(root), probe,
                            str(ROOT / "chip_smoke.py")],
                           capture_output=True, text=True)
        if r.returncode != 0:
            sys.exit(f"turn {turn} ({root}) failed:\n{r.stderr[-4000:]}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        res["ba"] = {k: dict(bit_identical=v["bit_identical"],
                             differing=v["differing"],
                             ms_per_iter=v["ms_per_iter"])
                     for k, v in res["ba"].items()}
        print(json.dumps({"turn": turn, **res}), flush=True)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main()
