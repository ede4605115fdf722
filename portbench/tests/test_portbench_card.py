"""One short run of each cell on the card: the result line's form and
``correct``. Skips without a CUDA card."""

import json
import subprocess
import sys

import pytest

from portbench.harness.spec import ROOT

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["replica-sp-ba", "fr3-mono-ba"])
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on "
                    "the card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 77), "--seconds", "5", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["correct"], rec["checks"]
    assert rec["device"]["platform"] == "gpu"
    assert rec["device"]["memory_peak_bytes"] > 0
    if trace:
        assert rec["device"]["busy_s"] > 0
