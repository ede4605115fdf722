"""``scripts/port_kernel_split.py`` finds its anchors in the current kernel
sources (no nvcc, no card): a redesign that moves a walk's barriers or
loops fails here, before a chip run needs the split. Also the split's
arithmetic on made-up stamps."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import port_kernel_split as ks  # noqa: E402

CSRC = ROOT / "monogs_tpu_torch" / "csrc"


def sources():
    return {p.name: p.read_text() for p in sorted(CSRC.iterdir())
            if p.suffix in (".cu", ".cuh")}


@pytest.mark.parametrize("kernel", sorted(ks.TARGETS))
def test_instrument_finds_the_current_walk(kernel):
    """The kernel's first target (this source's version) matches; each
    mark is stamped once, in the program order of a chunk; the stamps
    and the exports go only where the target says."""
    files = sources()
    t = ks.find_target(files, kernel)
    assert t is ks.TARGETS[kernel][0]
    out = ks.instrument(files, kernel)
    text = out[t.file]
    a, b = ks._body(text, t.func)
    body = text[a:b]
    at = [body.index(f"SPLIT_AT_({slot});") for slot in range(len(t.marks))]
    assert all(body.count(f"SPLIT_AT_({s});") == 1 for s in range(len(at)))
    assert at == sorted(at)
    assert body.count("++nch_;") == 1 and body.count("atomicMax(") == 1
    assert body.count("st_[4] = clock64()") == 1
    assert len(t.marks) <= ks.MAX_MARKS
    assert body.index("st_[1] = gtimer_()") < at[0]
    assert "split_stamps" in out["blend_lists.cu"]
    assert t.kernel in out["blend_lists.cu"].split("split_attrs")[-1]
    for f, src in files.items():
        if f not in (t.file, "blend_lists.cu"):
            assert out[f] == src, f
    plain = ks.instrument(files, kernel, stamps=False)
    assert "SPLIT_AT_" not in "".join(plain.values())
    assert plain["blend_lists.cu"].startswith(files["blend_lists.cu"])


def test_unknown_source_is_refused():
    files = sources()
    files["blend_lists.cu"] = files["blend_lists.cu"].replace(
        "  float T", "  float T_").replace("stage(ch + 1)", "stage(ch + 2)")
    for kernel in ("fwd", "jvp8"):
        with pytest.raises(ValueError, match="no known version"):
            ks.find_target(files, kernel)


def test_split_stats():
    """Two CTAs on one SM (overlapping) and one on another, two chunks
    each: shares of the four marks and the tail add up to one."""
    labels = ("a", "b", "c", "d")
    rows = []
    for sm, t0 in ((0, 1000), (0, 1500), (1, 1000)):
        st = [0] * ks.SLOTS
        st[0], st[1], st[2], st[3], st[4] = sm, t0, t0 + 1000, 0, 100
        st[5], st[6], st[7] = 2, 128, 4096
        st[8:12] = [10, 20, 30, 40]
        st[8 + ks.MAX_MARKS:12 + ks.MAX_MARKS] = [50, 60, 70, 90]
        rows.append(st)
    s = ks.split_stats(rows, labels)
    assert s["ctas"] == 3 and s["threads"] == 128
    assert s["dyn_smem_bytes"] == 4096
    assert s["sms_by_ctas"] == {1: 1, 2: 1}
    assert s["sms_by_most_at_once"] == {1: 1, 2: 1}
    assert s["span_us"] == pytest.approx(1.5)
    assert s["share_a"] == pytest.approx(0.2)
    assert s["share_d"] == pytest.approx(0.3)
    assert s["share_after_last_chunk"] == pytest.approx(0.1)
    assert sum(v for k, v in s.items() if k.startswith("share_")) == \
        pytest.approx(1.0)
