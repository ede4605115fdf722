#!/usr/bin/env python3
"""Check the data loaders' remap and ycc_rgb kernels (``csrc/remap.cu``,
``csrc/ycc_rgb.cu``) on one NVIDIA GPU, time them, and time them against
other builds of them in turns.

    python3 scripts/port_data_ab.py [--remap-against FILE]
        [--ycc-against FILE] [--rounds N]

1. Their registers and spills (``ptxas -v``).
2. Bit for bit against the plain versions: ``remap`` on random images
   through the maps that TUM fr1_desk's (640x480 RGB) and EuRoC mh02's
   (752x480 grey) datasets build, ``remap_pair`` on EuRoC's two eyes
   against two ``remap`` calls, ``ycc_to_rgb`` on random 1200x680 4:2:0
   planes (Replica's frames); ``remap_pair`` also timed on two TUM frames
   (what a second frame costs in the same launch).
3. At those shapes: ms (``chip_smoke.cuda_ms``) and device ms
   (``kernel_ms``) against the bytes bound, ``grid_sample``'s ms and
   device ms, an empty kernel's device ms on one CTA and on each
   kernel's grid (the floor of a launch), the host µs of each step of one
   ``remap`` wrapper call, the parent's wrapper and this checkout's
   (``chip_smoke.wrapper_split``), and with ``--remap-against`` /
   ``--ycc-against`` (for example the parent commit's sources, written out
   with ``git show``) each other build with the parent's wrapper timed in
   turns against this checkout's (``chip_smoke.remap_ab``, ``ycc_ab``),
   the bits held equal.

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

TUM = "configs/rgbd/tum/fr1_desk.yaml"
EUROC = "configs/stereo/euroc/mh02.yaml"


def timed(fn, nbytes, library=None):
    """ms, device ms, host µs a call and the bytes bound of ``fn``;
    ``library``'s ms, device ms and host µs."""
    from monogs_tpu_torch.utils import roofline

    out = dict(ms=cs.cuda_ms(torch, fn), device_ms=cs.kernel_ms(torch, fn),
               host_us=cs.host_us(torch, fn),
               bound_ms=roofline.bytes_bound_ms(nbytes))
    out["share_of_bound"] = out["bound_ms"] / out["device_ms"]
    if library is not None:
        out.update(library_ms=cs.cuda_ms(torch, library),
                   library_device_ms=cs.kernel_ms(torch, library),
                   library_host_us=cs.host_us(torch, library))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--remap-against", help="another remap.cu to time in "
                    "turns")
    ap.add_argument("--ycc-against", help="another ycc_rgb.cu to time in "
                    "turns")
    ap.add_argument("--rounds", type=int, default=cs.DATA_AB_ROUNDS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from monogs_tpu_torch import _build
    from monogs_tpu_torch.data.jpeg import ycc_to_rgb, ycc_to_rgb_plain
    from monogs_tpu_torch.data.undistort import remap, remap_pair, remap_plain

    _build.build_all(["remap", "ycc_rgb"])
    for name in ("remap", "ycc_rgb"):
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    libs = cs.data_build(args.remap_against, args.ycc_against)
    empty = libs["empty_kernel"]
    floor = cs.kernel_ms(torch, cs.empty_launcher(torch, empty))
    print(json.dumps(dict(name="empty kernel, one CTA", device_ms=floor,
                          host_us=cs.host_us(torch, cs.empty_launcher(
                              torch, empty)))), flush=True)
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randint(0, 256, shape, generator=g,
                             dtype=torch.uint8).cuda()

    ok = True
    tum_maps = cs.dataset_maps(torch, TUM)[0]
    euroc_maps = cs.dataset_maps(torch, EUROC)
    cases = (("remap", rand(480, 640, 3), tum_maps),
             ("remap@euroc", rand(480, 752), euroc_maps[0]))
    for name, img, maps in cases:
        same = bool(torch.equal(remap(img, maps).cpu(), remap_plain(
            img.cpu(), maps.x.cpu(), maps.y.cpu())))
        ok &= same
        h, w = maps.x.shape
        line = dict(name=name, shape=list(img.shape), bit_for_bit=same,
                    **timed(lambda: remap(img, maps),
                            2 * img.numel() + 8 * maps.x.numel(),
                            cs.grid_sample(torch, [img], [maps])),
                    empty_device_ms=dict(one_cta=floor, grid=cs.kernel_ms(
                        torch, cs.empty_launcher(torch, empty,
                                                 cs.grid_of(w, h, 1)))))
        if args.remap_against:
            line["ab"] = cs.remap_ab(torch, img, maps, cs.parent_remap(
                libs["remap_other"])[0], rounds=args.rounds)
            ok &= line["ab"]["same_bits"]
        print(json.dumps(line), flush=True)
    img, maps = cases[0][1:]
    call, steps = cs.parent_remap(libs.get("remap_other")
                                  or _build.library("remap"))
    print(json.dumps(dict(
        name="remap wrapper host us",
        parent=cs.wrapper_split(torch, steps(img, maps.x, maps.y),
                                lambda: call(img, maps.x, maps.y)),
        this=cs.wrapper_split(torch, cs.this_remap_steps(img, maps),
                              lambda: remap(img, maps)))), flush=True)
    left, right = rand(480, 752), rand(480, 752)
    pair = remap_pair(left, euroc_maps[0], right, euroc_maps[1])
    two = (remap(left, euroc_maps[0]), remap(right, euroc_maps[1]))
    same = all(bool(torch.equal(p, t)) for p, t in zip(pair, two))
    ok &= same
    print(json.dumps(dict(
        name="remap_pair", bit_for_bit_with_two=same,
        **timed(lambda: remap_pair(left, euroc_maps[0], right, euroc_maps[1]),
                2 * (2 * left.numel() + 8 * euroc_maps[0].x.numel()),
                cs.grid_sample(torch, [left, right], euroc_maps)),
        against_two=cs.turns(torch, {
            "pair": lambda: remap_pair(left, euroc_maps[0], right,
                                       euroc_maps[1]),
            "two": lambda: (remap(left, euroc_maps[0]),
                            remap(right, euroc_maps[1]))},
            rounds=args.rounds))), flush=True)
    rgb = (rand(480, 640, 3), rand(480, 640, 3))
    print(json.dumps(dict(
        name="remap_pair@rgb", **timed(
            lambda: remap_pair(rgb[0], tum_maps, rgb[1], tum_maps),
            2 * (2 * rgb[0].numel() + 8 * tum_maps.x.numel())))), flush=True)
    planes = [rand(680, 1200), rand(340, 600), rand(340, 600)]
    same = bool(torch.equal(ycc_to_rgb(*planes).cpu(), ycc_to_rgb_plain(
        *(p.cpu() for p in planes))))
    ok &= same
    parent = cs.parent_ycc(libs.get("ycc_rgb_other")
                           or _build.library("ycc_rgb"))
    line = dict(name="ycc_rgb", shape=[680, 1200, 3], bit_for_bit=same,
                **timed(lambda: ycc_to_rgb(*planes),
                        4 * planes[0].numel() + 2 * planes[1].numel()),
                empty_device_ms=dict(one_cta=floor, grid=cs.kernel_ms(
                    torch, cs.empty_launcher(torch, empty,
                                             cs.grid_of(1200, 680, 4)))),
                wrapper_us=dict(
                    parent=cs.host_us(torch, lambda: parent(*planes)),
                    this=cs.host_us(torch, lambda: ycc_to_rgb(*planes))))
    if args.ycc_against:
        line["ab"] = cs.ycc_ab(torch, planes, cs.parent_ycc(
            libs["ycc_rgb_other"]), rounds=args.rounds)
        ok &= line["ab"]["same_bits"]
    print(json.dumps(line), flush=True)
    print(cs.smi_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
