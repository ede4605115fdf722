"""Compare the SASS of the port's kernels with another checkout's, function
by function.

    python3 scripts/port_sass_diff.py --against DIR [--dump OUT]

Builds ``monogs_tpu_torch/csrc/blend_lists.cu`` and ``blend_macros.cu`` of
this checkout and of the checkout at DIR (for example the parent commit,
unpacked with ``git archive`` into a directory under ``build/``) to cubins
with the library's nvcc flags, disassembles them with ``cuobjdump -sass``
and prints one JSON line per kernel: whether its instructions are the same
in both builds (addresses and encodings left out, names demangled with
``cu++filt`` so that the anonymous namespace's per-file tag does not
count), each build's instruction count, and this build's count of
tensor-core (HMMA), shuffle (SHFL) and barrier (BAR) instructions. A
kernel of this build that the other lacks is paired with the other's of
the same name less its parameter list and a last numeric template
argument (``base_name``: a pixel-slice count or tangent group size). For
both builds it counts the HMMA that are predicated or lie in a region
where the warp may be diverged (between a ``BSSY`` and the reconvergence
point it names, or between a forward branch on a per-thread predicate and
its target): ``mma.sync`` needs the whole warp converged, so both should
be 0. ``--dump OUT`` also writes each build's
disassembly to OUT. Needs the CUDA toolkit (nvcc, cuobjdump, cu++filt); no
card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from monogs_tpu_torch import _build  # noqa: E402

SOURCES = ("blend_lists.cu", "blend_macros.cu")


def parse(text: str) -> dict[str, list[tuple[int, str]]]:
    """{mangled kernel name: [(address, instruction)]} of a ``cuobjdump
    -sass`` listing, whitespace normalised and branch targets given as
    addresses (cuobjdump names them by label)."""
    funcs: dict[str, list[tuple[int, str]]] = {}
    labels: dict[str, dict[str, int]] = {}
    cur, pending = None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur, pending = m.group(1), []
            funcs[cur], labels[cur] = [], {}
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            addr = int(m.group(1), 16)
            labels[cur].update((lab, addr) for lab in pending)
            pending = []
            funcs[cur].append((addr, re.sub(r"\s+", " ", m.group(2))))
    return {fn: [(a, re.sub(r"`\((\.L_x_\d+)\)",
                            lambda t: hex(labels[fn].get(t.group(1), -1)), i))
                 for a, i in ins]
            for fn, ins in funcs.items()}


def sass(src: Path, tag: str, dump: Path | None = None
         ) -> dict[str, list[tuple[int, str]]]:
    """{demangled kernel name: [(address, instruction)]} of ``src``."""
    nvcc = Path(_build.nvcc_path())
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / f"{src.stem}.cubin"
        for cmd in ([str(nvcc), *flags, "-cubin", "-o", str(cubin),
                     str(src)],
                    [str(nvcc.parent / "cuobjdump"), "-sass", str(cubin)]):
            out = subprocess.run(cmd, capture_output=True, text=True)
            if out.returncode != 0:
                sys.exit(f"{cmd[0]} failed: {out.stderr}")
    if dump is not None:
        dump.mkdir(parents=True, exist_ok=True)
        (dump / f"{tag}_{src.stem}.sass").write_text(out.stdout)
    funcs = parse(out.stdout)
    names = subprocess.run([str(nvcc.parent / "cu++filt")],
                           input="\n".join(funcs), capture_output=True,
                           text=True).stdout.splitlines()
    return {n.replace("(anonymous namespace)::", ""): v
            for n, v in zip(names, funcs.values())}


def count(ins: list[tuple[int, str]], op: str) -> int:
    return sum(1 for _, i in ins if re.match(rf"(@!?U?P\w+ )?{op}\b", i))


def hmma_unsafe(ins: list[tuple[int, str]]) -> int:
    """HMMA where the warp may be diverged: predicated ones, and those
    between a BSSY and the reconvergence point that it names or between a
    forward branch on a per-thread predicate (``@P``, not ``@UP``) and its
    target. The count errs on the safe side (a per-thread predicate may
    hold the same value in every lane); 0 means no HMMA can run diverged."""
    regions = []
    for a, i in ins:
        m = (re.match(r"(@!?U?P\w+ )?BSSY B\d+, (0x[0-9a-f]+)", i)
             or re.match(r"(@!?P\d+ )BRA (0x[0-9a-f]+)", i))
        if m and int(m.group(2), 16) > a:
            regions.append((a, int(m.group(2), 16)))
    return sum(1 for a, i in ins if re.match(r"(@!?U?P\w+ )?HMMA\b", i)
               and (i.startswith("@")
                    or any(s < a < t for s, t in regions)))


def base_name(fn: str) -> str:
    """A demangled kernel's name without its parameter list and without a
    last template argument that is a number (a pixel-slice count or a
    tangent group's size that the other build's kernel may lack):
    ``void bwd_kernel<1>(const float*, ...)`` -> ``bwd_kernel``,
    ``void fo_grad_kernel<false, 4>(...)`` -> ``fo_grad_kernel<false>``."""
    name = re.sub(r"^void ", "", fn.split("(")[0])
    name = re.sub(r"<\d+>$", "", name)
    return re.sub(r", \d+>$", ">", name)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, required=True,
                    help="root of the other checkout")
    ap.add_argument("--dump", type=Path,
                    help="directory for each build's disassembly")
    args = ap.parse_args()
    for name in SOURCES:
        ours = sass(_build.SOURCES[name.split(".")[0]].path, "this",
                    args.dump)
        theirs = sass(args.against / "monogs_tpu_torch" / "csrc" / name,
                      "other", args.dump)
        by_base = {base_name(fn): fn for fn in theirs}
        pairs = [(fn, fn if fn in theirs else by_base.get(base_name(fn)))
                 for fn in sorted(ours)]
        paired = {o for _, o in pairs}
        pairs += [(None, fn) for fn in sorted(theirs) if fn not in paired]
        for fn, other in pairs:
            a = ours.get(fn) if fn else None
            b = theirs.get(other) if other else None
            print(json.dumps({
                "source": name, "kernel": fn or other,
                "other_kernel": other if other != fn else None,
                "same": (a is not None and b is not None
                         and [i for _, i in a] == [i for _, i in b]),
                "instructions": len(a) if a else None,
                "other_instructions": len(b) if b else None,
                "hmma": count(a, "HMMA") if a else None,
                "shfl": count(a, "SHFL") if a else None,
                "bar": count(a, "BAR") if a else None,
                "hmma_unsafe": hmma_unsafe(a) if a else None,
                "other_hmma": count(b, "HMMA") if b else None,
                "other_hmma_unsafe": hmma_unsafe(b) if b else None}),
                flush=True)


if __name__ == "__main__":
    main()
