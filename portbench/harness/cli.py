"""Command line of the benchmark:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

prints, as the last line of its standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and with
``--trace 1`` ``breakdown``) and, last, ``checks``: each number the
correctness comparison held beside its limit; the same checks end its
standard error. With ``--trace 0`` the metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics. Without a CUDA card, or
with fewer cards than the cell asks for, or with a JAX module loaded, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import traceback

from . import device as devmod
from .spec import Spec


def log(msg: str):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(spec: Spec, name: str, seed: int, seconds: float, trace: bool,
             device: str, t0: float, overrides=None) -> dict:
    """Run one cell and return its result record (``checks`` last). The
    driver module is ``harness/<kind>.py``; ``overrides`` replaces
    configuration and parameter entries (the harness's own tests use it to
    run a cell at a tiny size)."""
    import torch

    cell = spec.cell(name)
    if overrides:
        cell = overrides(cell)
    dev = devmod.Device(torch, device)
    driver = importlib.import_module(f"portbench.harness.{cell['kind']}")
    out = driver.run(cell, seed, seconds, trace, dev, t0, log)

    metrics = {}
    if not trace:
        for m in spec.metrics_of(name, "end_to_end"):
            if m["name"] not in out["values"]:
                raise RuntimeError(f"cell {name} gives no {m['name']}")
            metrics[m["name"]] = dict(value=out["values"][m["name"]],
                                      unit=m["unit"])
    else:
        for m in spec.metrics_of(name, "per_layer"):
            v = spec.reader(m["name"])(out["ctx"])
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    rec = dict(correct=out["correct"], attempted=out["attempted"],
               failed=out["failed"], metrics=metrics, device=out["device"])
    if trace and out.get("breakdown"):
        rec["breakdown"] = out["breakdown"]
    rec["checks"] = out["checks"]
    return rec


def main(argv, t0: float) -> int:
    args = parse(argv)
    try:
        spec = Spec()
        chips = spec.cell(args.workload)["chips"]
        import torch

        if not torch.cuda.is_available():
            log("no CUDA device: the benchmark measures the port on the card")
            return 3
        if torch.cuda.device_count() < chips:
            log(f"cell {args.workload} needs {chips} cards, "
                f"{torch.cuda.device_count()} present")
            return 3
        rec = run_cell(spec, args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", t0)
    except Exception:
        traceback.print_exc()
        return 1
    bad = devmod.forbidden_modules()
    if bad:
        log(f"JAX modules loaded in the benchmark's process: {bad}")
        return 4
    for k, c in rec["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(rec), flush=True)
    return 0
