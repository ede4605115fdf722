"""BENCHMARK.json against the benchmark's contract, and every piece of a
cell found by its name (CPU)."""

import json
import re
import shutil

import pytest

from portbench.harness.spec import PKG, ROOT, Spec
from portbench.tests.tiny import run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert b["command"] == ["python3", "portbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in bench()[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_metrics_units_sources_and_arrows():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        moved = e2e[m["moves"]]
        # every cell of the metric reports the metric it moves
        assert set(m.get("workloads", cells)) <= set(
            moved.get("workloads", cells))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    spec = Spec()
    for w in bench()["workloads"]:
        e2e = [m["name"] for m in spec.metrics_of(w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(w["name"], "per_layer")
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200


def test_configs_files_and_reduced():
    for c in bench()["configs"]:
        assert c["file"].startswith("portbench/")
        with open(ROOT / c["file"]) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not k.endswith(("_dim", "_rank"))


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_pieces_found_by_name(cell):
    spec = Spec()
    c = spec.cell(cell)
    assert (PKG / "workloads" / f"{cell}.json").is_file()
    assert (PKG / "traffic" / f"{c['traffic']}.json").is_file()
    assert (PKG / "harness" / f"{c['kind']}.py").is_file()
    assert set(c["limits"]) == {
        "window_ba": {"loss_gap", "grad_gap", "change_gap", "stat_gap",
                      "densify_gap"}}[c["kind"]]
    for m in spec.metrics_of(cell, "per_layer"):
        assert callable(spec.reader(m["name"]))


def test_a_new_cell_mix_and_metric_need_no_edit(tmp_path):
    """A mix, a cell and a per-layer metric added as files (and entries in
    a copy of BENCHMARK.json) run with no file of the harness edited."""
    shutil.copytree(PKG, tmp_path / "portbench")
    b = bench()
    mix = json.loads((PKG / "traffic" / "window_ba.json").read_text())
    mix["perturb"] = dict(mix["perturb"], xyz=0.01)
    (tmp_path / "portbench" / "traffic" / "window_ba_light.json").write_text(
        json.dumps(mix))
    base = json.loads((PKG / "workloads" / "fr3-mono-ba.json").read_text())
    base["traffic"] = "window_ba_light"
    (tmp_path / "portbench" / "workloads" / "fr3-mono-ba-light.json"
     ).write_text(json.dumps(base))
    (tmp_path / "portbench" / "metrics" / "ba.chunk_iters.py").write_text(
        "def read(ctx):\n    return float(ctx['chunk'])\n")
    b["workloads"].append(dict(name="fr3-mono-ba-light",
                               config="tum-fr3-office-mono",
                               traffic="window_ba_light", chips=1,
                               why="a lighter perturbation"))
    b["per_layer"].append(dict(name="ba.chunk_iters", unit="iters",
                               better="higher", source="program_counter",
                               layer="BA loop (slam/mapping.py)",
                               moves="ba_l1",
                               workloads=["fr3-mono-ba-light"]))
    for m in b["end_to_end"]:
        if "workloads" in m and "ba_l1" == m["name"]:
            m["workloads"].append("fr3-mono-ba-light")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    spec = Spec(root=tmp_path)
    rec = run_tiny("fr3-mono-ba-light", trace=True, spec=spec)
    assert rec["metrics"]["ba.chunk_iters"]["value"] == 2.0
    rec = run_tiny("fr3-mono-ba-light", spec=spec)
    assert set(rec["metrics"]) == {"ba_l1", "setup_s"}
    assert rec["correct"]
