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
    mark is stamped once in its function, in program order, with its
    label's slot; the CTA's start and end are stamped once, in the kernel;
    the stamps' state goes into the common header and the exports into the
    kernel's file; every other file is unchanged."""
    files = sources()
    t = ks.find_target(files, kernel)
    assert t is ks.TARGETS[kernel][0]
    labels = t.labels()
    assert len(labels) <= ks.MAX_MARKS
    assert t.chunk in labels
    out = ks.instrument(files, kernel)
    stamped = 0
    for file, func, marks in ((t.file, t.func, t.marks),) + tuple(
            (s.file, s.func, s.marks) for s in t.sites):
        text = out[file]
        a, b = ks._body(text, func)
        body = text[a:b]
        at = []
        for _, label, _ in marks:
            stamp = ks.MARK % (labels.index(label), int(label == t.chunk))
            assert body.count(stamp) == 1, (func, label)
            at.append(body.index(stamp))
        assert at == sorted(at), func
        stamped += body.count("SPLIT_AT_(")
        if func == t.func:
            assert body.count("st_[1] = gtimer_()") == 1
            assert body.count("st_[4] = clock64()") == 1
            assert body.count("atomicMax(") == 1
            assert not at or body.index("st_[1] = gtimer_()") < at[0]
    assert stamped == len(t.marks) + sum(len(s.marks) for s in t.sites)
    assert "split_sh_[" in out[ks.COMMON].split("namespace {")[1]
    assert "split_stamps" in out[t.file]
    assert t.kernel in out[t.file].split("split_attrs")[-1]
    if t.second is not None:
        assert out[t.file].count("rep_ < split_reps_") == 1
    touched = {t.file, ks.COMMON} | {s.file for s in t.sites}
    for f, src in files.items():
        if f not in touched:
            assert out[f] == src, f
    plain = ks.instrument(files, kernel, stamps=False)
    assert "SPLIT_AT_" not in "".join(plain.values())
    assert plain[t.file].startswith(files[t.file])


def test_unknown_source_is_refused():
    files = {f: text.replace("  float T", "  float T_").replace(
        "stage(ch + 1)", "stage(ch + 2)") for f, text in sources().items()}
    for kernel in ("fwd", "jvp8"):
        with pytest.raises(ValueError, match="no known version"):
            ks.find_target(files, kernel)
    files = sources()
    files["blend_macros.cu"] = files["blend_macros.cu"].replace(
        "fine_tile(", "fine_tile_(")
    for kernel in ("macro_fwd", "macro_bwd"):
        with pytest.raises(ValueError, match="no known version"):
            ks.find_target(files, kernel)


def test_split_stats():
    """Two CTAs on one SM (overlapping) and one on another: shares of the
    four marks and the time after the last add up to one."""
    labels = ("a", "b", "c", "d")
    rows = []
    for sm, t0 in ((0, 1000), (0, 1500), (1, 1000)):
        st = [0] * ks.SLOTS
        st[0], st[1], st[2], st[3], st[4] = sm, t0, t0 + 1000, 0, 100
        st[5], st[6], st[7] = 2, 128, 4096
        st[8:12] = [20, 20, 20, 30]
        rows.append(st)
    s = ks.split_stats(rows, labels)
    assert s["ctas"] == 3 and s["threads"] == 128
    assert s["dyn_smem_bytes"] == 4096
    assert s["sms_by_ctas"] == {1: 1, 2: 1}
    assert s["sms_by_most_at_once"] == {1: 1, 2: 1}
    assert s["span_us"] == pytest.approx(1.5)
    assert s["share_a"] == pytest.approx(0.2)
    assert s["share_d"] == pytest.approx(0.3)
    assert s["share_after_last_mark"] == pytest.approx(0.1)
    assert s["chunks_mean"] == 2
    assert sum(v for k, v in s.items() if k.startswith("share_")) == \
        pytest.approx(1.0)
