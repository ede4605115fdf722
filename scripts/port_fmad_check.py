"""Time the port's list-blend kernels with and without multiply-add
contraction, on one NVIDIA GPU.

    python3 scripts/port_fmad_check.py

The kernel library is built with ``-fmad=false``, so that its alpha and
transmittance thresholds round as the plain PyTorch version's do. This
builds a second library without that flag (nvcc then contracts a * b + c
into one FFMA) and runs chip_smoke's kernel phase with each library in
turns (off, on, on, off) at the main path's shapes. It prints, per turn and
kernel, the time, the error against the plain version and whether it stays
within chip_smoke's tolerance, then the card's name and power limit. Needs
one CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("port_fmad_check: needs a CUDA card")
    from monogs_tpu_torch import _build

    libs = {"fmad_off": _build.library("blend_lists")}
    e_exp, _ = cs.expf_ops()
    _build.NVCC_FLAGS = [f for f in _build.NVCC_FLAGS if f != "-fmad=false"]
    _build._LIBS.clear()
    libs["fmad_on"] = _build.library("blend_lists")

    dev = torch.device("cuda")
    intr, cfg, tcfg, scene, poses_fn = cs.make_bench(torch, dev)
    poses = poses_fn(3, 42)
    frame = cs.render_frames(torch, scene, poses[2:], intr, cfg,
                             with_depth=True)[0][0]
    for turn, build in enumerate(("fmad_off", "fmad_on", "fmad_on",
                                  "fmad_off")):
        _build._LIBS["blend_lists"] = libs[build]
        entries = cs.kernel_phase(torch, intr, cfg, tcfg, scene, poses[1],
                                  frame, e_exp, strict=False)
        for e in entries.values():
            print(json.dumps({"turn": turn, "build": build, **{
                k: e[k] for k in ("name", "ms", "bound_ms", "max_abs_err",
                                  "within_tol")}}), flush=True)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main()
