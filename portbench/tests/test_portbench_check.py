"""The correctness check of the cells at a size a CPU test holds: a sound
run is correct, and a run with the timed path broken underneath, or the
reference in bfloat16 put in the program's place (the control), is not."""

import json

import pytest
import torch

from monogs_tpu_torch.models import gaussian_map as gm
from monogs_tpu_torch.slam import mapping as mp
from portbench.harness import compare, window_ba as W
from portbench.harness.spec import Spec
from portbench.tests.tiny import SEED, run_tiny, shrink

CELLS = ["replica-sp-ba", "fr3-mono-ba"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    rec = run_tiny(cell)
    assert rec["correct"], rec["checks"]
    assert list(rec)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(rec)
    for c in rec["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(rec)


def state_unchanged(monkeypatch):
    monkeypatch.setattr(gm, "adam_step", lambda m, *a, **k: m)


def half_the_views(monkeypatch):
    orig = mp.render_map_grad
    calls = []

    def fault(*a, **k):
        out = orig(*a, **k)
        w = 2.0 if len(calls) % 2 == 0 else 0.0
        calls.append(1)
        loss, gl, g_tau, g_off, g_ea, g_eb, radii = out
        return (loss * w, tuple(g * w for g in gl), g_tau * w, g_off * w,
                g_ea * w, g_eb * w, radii)

    monkeypatch.setattr(mp, "render_map_grad", fault)


def densify_skipped(monkeypatch):
    """Densify and prune return the map as they got it."""
    monkeypatch.setattr(gm, "densify_and_prune", lambda m, *a, **k: m)


def altered_gradient(monkeypatch):
    orig = mp.render_map_grad

    def fault(*a, **k):
        loss, gl, *rest = orig(*a, **k)
        return (loss, (gl[0] * 1.01,) + tuple(gl[1:]), *rest)

    monkeypatch.setattr(mp, "render_map_grad", fault)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [state_unchanged, half_the_views,
                                   densify_skipped, altered_gradient])
def test_broken_step_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    rec = run_tiny(cell)
    assert not rec["correct"], rec["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_bfloat16_fails_a_limit(cell):
    torch.set_num_threads(2)
    c = shrink(Spec().cell(cell))
    st = W.settings(c)
    inp = W.make_inputs(st, SEED, torch.device("cpu"))
    ref = W.reference_steps(st, inp)
    got = W.reference_steps(st, inp, dtype=torch.bfloat16)
    ok, checks = compare.verdict(compare.training_numbers(got, ref)[0],
                                 c["limits"])
    assert not ok, checks
