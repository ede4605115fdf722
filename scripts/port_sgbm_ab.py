#!/usr/bin/env python3
"""Check the SGBM kernel (``csrc/sgbm.cu``) on one NVIDIA GPU, split its
device time by launch, and time it against another build of it in turns.

    python3 scripts/port_sgbm_ab.py [--against FILE] [--rounds N]

1. Its registers and shared memory (``ptxas -v``) and the CTAs of each
   launch at 752x480 against the card's SMs.
2. On textured pairs (``chip_smoke.textured_pair``) at 33x65, 120x200,
   480x752 and 16x8191 (the widest it takes): the disparities bit for bit against ``sgbm_plain`` on the card
   and between two launches. Where they differ, the stage that differs
   first: the cost volume against ``stereo.cost_volume``, then each
   path's plane against the plain path (its first differing cell).
3. At 480x752: device ms by launch (CUDA events between the launches),
   and with ``--against`` another ``sgbm.cu`` (for example the parent
   commit's, written out with ``git show``) built under another name with
   this checkout's nvcc flags, both timed in turns
   (``chip_smoke.sgbm_ab``).

One JSON line per result, then the card's name and power limit. Needs one
CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SHAPES = ((33, 65), (120, 200), (480, 752), (16, 8191))
PLANES = ("lr", "rl", "up", "up_left", "up_right")


def plain_paths(c):
    """The five paths' values [H, W1, D] int32 of the plain version, in the
    kernel's plane order."""
    from monogs_tpu_torch.data import stereo

    h, w1, d = c.shape
    ups = [torch.empty_like(c) for _ in range(3)]
    prev = [torch.zeros((w1, d), dtype=torch.int32, device=c.device)
            for _ in range(3)]
    prev_min = [torch.zeros((w1,), dtype=torch.int32, device=c.device)
                for _ in range(3)]
    for y in range(h):
        for i, dx in enumerate((-1, 0, 1)):   # up-left, up, up-right
            ups[i][y], prev[i], prev_min[i] = stereo._path_step(
                c[y], stereo._shift_x(prev[i], dx),
                stereo._shift_x(prev_min[i], dx))
    return [stereo._horizontal(c, False), stereo._horizontal(c, True),
            ups[1], ups[0], ups[2]]


def first_difference(a, b):
    bad = (a != b).nonzero()
    if not len(bad):
        return None
    idx = tuple(int(i) for i in bad[0])
    return dict(count=int(len(bad)), at=idx, got=int(a[idx]),
                want=int(b[idx]))


def diagnose(left, right):
    """Which stage of the kernel parts from the plain version first."""
    from monogs_tpu_torch._build import library
    from monogs_tpu_torch.data import stereo

    lib = library("sgbm")
    h, w = left.shape
    w1, d = w - stereo.NUM_DISP, stereo.NUM_DISP
    cost = torch.empty((h, w1, d), dtype=torch.int16, device="cuda")
    paths = torch.empty((5, h, w1, d), dtype=torch.int32, device="cuda")
    keys = torch.empty((h, w), dtype=torch.int32, device="cuda")
    pre = torch.empty((h, w), dtype=torch.int16, device="cuda")
    out = torch.empty((h, w), dtype=torch.int16, device="cuda")
    rc = lib.sgbm_run(left.data_ptr(), right.data_ptr(), cost.data_ptr(),
                      paths.data_ptr(), keys.data_ptr(), pre.data_ptr(),
                      out.data_ptr(), h, w,
                      torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    want_c = stereo.cost_volume(left, right)
    res = dict(rc=rc, cost=first_difference(cost.int(), want_c))
    for name, got, want in zip(PLANES, paths, plain_paths(want_c)):
        res[name] = first_difference(got, want)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another sgbm.cu to time in turns")
    ap.add_argument("--rounds", type=int, default=cs.SGBM_AB_ROUNDS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from monogs_tpu_torch import _build
    from monogs_tpu_torch.data import stereo
    from monogs_tpu_torch.utils import roofline

    _build.build_all(["sgbm"])
    for line in _build.BUILD_LOG.get("sgbm", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"ptxas sgbm: {line.strip()}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(json.dumps(dict(ctas=stereo.sgbm_grids(480, 752), sms=sms)),
          flush=True)
    ok = True
    for h, w in SHAPES:
        left, right = cs.textured_pair(torch, "cuda", h, w)
        a, b = stereo.sgbm(left, right), stereo.sgbm(left, right)
        want = stereo.sgbm_plain(left, right)
        torch.cuda.synchronize()
        same = bool(torch.equal(a, b) and torch.equal(a, want))
        line = dict(shape=[h, w], bit_for_bit=same,
                    valid=float((want >= 0).float().mean()))
        if not same:
            ok = False
            line["two_launches_equal"] = bool(torch.equal(a, b))
            line["first_difference"] = first_difference(a.int(), want.int())
            line["stages"] = diagnose(left, right)
        print(json.dumps(line), flush=True)
    if ok:
        left, right = cs.textured_pair(torch, "cuda", 480, 752)
        line = dict(shape=[480, 752], bound=roofline.sgbm_bound(480, 752),
                    ms=cs.cuda_ms(torch, lambda: stereo.sgbm(left, right)),
                    device_ms=cs.kernel_ms(
                        torch, lambda: stereo.sgbm(left, right)),
                    split=cs.sgbm_marks_split(torch, left, right))
        if args.against:
            line["ab"] = cs.sgbm_ab(torch, left, right,
                                    cs.sgbm_build_other(args.against),
                                    rounds=args.rounds)
        print(json.dumps(line), flush=True)
    print(cs.smi_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
