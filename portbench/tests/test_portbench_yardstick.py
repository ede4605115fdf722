"""The yardstick against what it was frozen from, and the import rules
(CPU)."""

import ast
import subprocess
import sys

import pytest

from portbench.harness import roofline as frozen
from portbench.harness.spec import PKG, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "monogs_tpu"}


def test_frozen_roofline_matches_the_port_at_one_shape():
    from monogs_tpu_torch.utils import roofline as port

    n = dict(walked=9_000_000, ok=4_000_000, contrib=2_500_000,
             live=1_800_000)
    for name in ("map_grad", "map_grad_rgbd"):
        assert frozen.kernel_ops(name, n) == port.kernel_ops(name, n, 10)
        assert frozen.kernel_tc_ops(name, n) == port.kernel_tc_ops(name, n)
        for nbytes in (10, 10**9):
            want = port.kernel_bound(name, n, nbytes, 10)["bound_ms"] / 1e3
            assert frozen.bound_s(name, n, nbytes) == pytest.approx(
                want, rel=1e-12)
    assert (frozen.HBM_BYTES_PER_S, frozen.FP32_FLOPS_PER_S,
            frozen.TF32_FLOPS_PER_S) == (port.HBM_BYTES_PER_S,
                                         port.FP32_FLOPS_PER_S,
                                         port.TF32_FLOPS_PER_S)


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(p.relative_to(PKG).as_posix()
                                        for p in PKG.rglob("*.py")))
def test_no_jax_import_in_the_benchmark(path):
    """Compared by whole top-level names: monogs_tpu_torch is allowed,
    monogs_tpu is not."""
    assert not imported_tops(PKG / path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    p.name for p in (PKG / "reference").glob("*.py")))
def test_reference_imports_nothing_of_the_program(path):
    assert "monogs_tpu_torch" not in imported_tops(PKG / "reference" / path)


def test_reference_loads_no_program_module():
    code = ("import sys; import portbench.reference.ba, "
            "portbench.reference.render, portbench.reference.scene; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'monogs_tpu_torch', 'monogs_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from portbench.harness import device

    monkeypatch.setitem(sys.modules, "monogs_tpu_torch_fake", sys)
    assert "monogs_tpu" not in device.forbidden_modules()
    monkeypatch.setitem(sys.modules, "monogs_tpu.fake", sys)
    assert "monogs_tpu" in device.forbidden_modules()


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "fr3-mono-ba",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT / "build")})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
