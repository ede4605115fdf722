"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout names the cells, their
configurations and traffic mixes, and the metrics. Each piece lives in a
file of its own under ``portbench/``, found by its name:

- a configuration: ``configs/<config>.json``;
- a traffic mix: ``traffic/<mix>.json`` (its ``kind`` names the general
  driver that reads it, ``harness/<kind>.py``);
- a cell: ``workloads/<cell>.json`` (its config, its mix and the mix's
  parameters for this cell, and the limits of its correctness check);
- a per-layer metric: ``metrics/<metric>.py`` with ``read(ctx)``, which
  returns the metric's value or None where the run gives it nothing to read.

So a later change adds a configuration, a mix, a cell or a metric by
adding files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent       # portbench/
ROOT = PKG.parent


class Spec:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT, pkg: Path = None):
        self.root = Path(root)
        self.pkg = Path(pkg) if pkg is not None else self.root / "portbench"
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)
        self.workloads = {w["name"]: w for w in self.bench["workloads"]}

    def _json(self, *parts):
        path = self.pkg.joinpath(*parts)
        with open(path) as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        """The cell's entry in BENCHMARK.json merged with its file, its
        configuration's file and its mix's file (the cell's parameters over
        the mix's)."""
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(self.workloads)})")
        entry = self.workloads[name]
        own = self._json("workloads", f"{name}.json")
        for k in ("config", "traffic"):
            if own[k] != entry[k]:
                raise ValueError(f"workloads/{name}.json names {k} "
                                 f"{own[k]!r}, BENCHMARK.json {entry[k]!r}")
        mix = self._json("traffic", f"{entry['traffic']}.json")
        params = dict(mix)
        params.update(own.get("params", {}))
        return dict(name=name, chips=entry["chips"],
                    config=self._json("configs", f"{entry['config']}.json"),
                    traffic=entry["traffic"], kind=mix["kind"],
                    params=params, limits=own["limits"])

    def metrics_of(self, cell: str, section: str) -> list:
        """The metrics of ``section`` ("end_to_end" or "per_layer") that
        ``cell`` reports: those that list it, and those that list no cell."""
        return [m for m in self.bench[section]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """``read`` of ``metrics/<metric>.py``."""
        path = self.pkg / "metrics" / f"{metric}.py"
        mod_name = "portbench_metric_" + "".join(
            c if c.isalnum() else "_" for c in metric)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
