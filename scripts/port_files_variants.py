#!/usr/bin/env python3
"""Variants of ``chip_smoke.py``'s file-backed SLAM runs, on the card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/port_files_variants.py [--run files_replica_rgbd ...]
        [--variant sequence|full_insert|own_insert ...]

Each named ``files_path`` run's config (default: Replica office0 and TUM
fr1_desk RGB-D) is written from the stock synthetic sequence on its stock
orbit (25 mm a frame; ``files_path`` writes it at TUM's pace) and run
with ``files_config(file, "sequence")``'s settings changed by each
variant:

- ``sequence``: the sequence's keyframe policy and insertion density,
  ``insert_cap`` raised to hold a whole first-keyframe insertion at the
  config's width, ``map_capacity`` 2^18;
- ``capped``: the same with the config's own ``insert_cap`` and
  ``map_capacity`` (an insertion holds at most ``insert_cap`` points, the
  first in raster order, so a capped one leaves the bottom of the frame
  empty);
- ``own_insert``: the dataset's own insertion density and point size.

One JSON line per run and variant: ATE of the keyframes and over every
frame, the ATE of holding the first pose, keyframes, ``n_active`` and
seconds (chip_smoke's ``files_run`` line, cut to these keys).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANTS = ("sequence", "capped", "own_insert")


def variant_config(cs, file, variant):
    cfg = cs.files_config(file, "sequence")
    own = cs.load_yaml_config(file)
    if variant == "capped":
        rc = own.get("Renderer", {})
        for k in ("insert_cap", "map_capacity"):
            if k in rc:
                cfg["Renderer"][k] = rc[k]
            else:
                cfg["Renderer"].pop(k)
    elif variant == "own_insert":
        for k in cs.SEQUENCE_KEYS["Dataset"]:
            cfg["Dataset"][k] = own["Dataset"][k]
    return cfg


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", action="append",
                    help="a files_path run name (repeatable)")
    ap.add_argument("--variant", action="append", choices=VARIANTS)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from monogs_tpu_torch import _build

    if not torch.cuda.is_available():
        sys.exit("port_files_variants: needs a CUDA card")
    _build.build_all()
    smi = cs.smi_line()
    runs = {run.name: run.config for run in cs.FILES_RUNS}
    scene, poses = cs.files_sequence(torch, motion="stock")
    for name in args.run or ("files_replica_rgbd", "files_tum_rgbd"):
        for variant in args.variant or VARIANTS:
            cfg = variant_config(cs, runs[name], variant)
            root = ROOT / "build" / "files_variants" / name / variant
            shutil.rmtree(root, ignore_errors=True)
            root.mkdir(parents=True)
            cs.write_files(torch, cfg, root, scene, poses)
            out, _, _ = cs.files_run(torch, f"{name}_{variant}", cfg, smi)
            keep = ("n_frames", "fps", "seconds", "ate", "ate_frames",
                    "hold_first_ate", "kf_indices", "n_active",
                    "tracking_ms_per_frame", "peak_mem_bytes", "device")
            print(json.dumps(dict(run=name, variant=variant,
                                  renderer=cfg.get("Renderer", {}),
                                  **{k: out.get(k) for k in keep})),
                  flush=True)


if __name__ == "__main__":
    main()
