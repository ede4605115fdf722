#!/usr/bin/env python3
"""Which collectives gloo takes on CUDA tensors in this torch.

    python3 scripts/port_gloo_cuda_probe.py [--ranks 2]

Brings up ``--ranks`` ranks with the gloo backend on ``cuda:0`` (the
port's ``parallel.launch.RankGroup``: ranks that share one card, as
``--dist-backend gloo`` runs them) and tries each collective that the
sharded mapping loops could use on CUDA tensors: all_reduce (sum and max;
float32, int32, uint8), broadcast, all_gather (list form),
all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single and
broadcast_object_list. Prints one JSON line per rank with each
collective's result ("ok", or the error's first line) and whether the
values are right, and the median ms of an all_reduce, an all_gather and
a broadcast at the mapping path's sizes, on the CUDA tensors and staged
through host memory (``timings``); then the torch and CUDA versions.
Gloo refusing a collective on CUDA tensors would make the port's helper
(``monogs_tpu_torch/parallel/comm.py``) stage it through host memory for
gloo only; in torch 2.11 it takes all of them. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def probe(mesh):
    import torch
    import torch.distributed as dist

    r, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}

    def attempt(name, fn, want):
        try:
            got = fn()
            torch.cuda.synchronize()
            out[name] = "ok" if bool(torch.equal(got.cpu(), want)) else \
                "wrong values"
        except Exception as e:   # noqa: BLE001 - recorded, the probe goes on
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"

    def ar(dtype, op, want):
        def fn():
            x = torch.full((5,), r + 1, dtype=dtype, device=dev)
            dist.all_reduce(x, op)
            return x
        return fn, torch.full((5,), want, dtype=dtype)

    tot, top = n * (n + 1) // 2, n
    for dt in (torch.float32, torch.int32, torch.uint8):
        name = str(dt).split(".")[1]
        attempt(f"all_reduce_sum_{name}", *ar(dt, dist.ReduceOp.SUM, tot))
        attempt(f"all_reduce_max_{name}", *ar(dt, dist.ReduceOp.MAX, top))

    def bcast(dtype):
        def fn():
            x = torch.full((7,), r + 3, dtype=dtype, device=dev)
            dist.broadcast(x, 0)
            return x
        return fn, torch.full((7,), 3, dtype=dtype)

    attempt("broadcast_float32", *bcast(torch.float32))
    attempt("broadcast_uint8", *bcast(torch.uint8))
    want_g = torch.arange(n, dtype=torch.float32).repeat_interleave(3)

    def gather_list():
        parts = [torch.empty(3, device=dev) for _ in range(n)]
        dist.all_gather(parts, torch.full((3,), float(r), device=dev))
        return torch.cat(parts)

    def gather_tensor():
        y = torch.empty(3 * n, device=dev)
        dist.all_gather_into_tensor(y, torch.full((3,), float(r), device=dev))
        return y

    def reduce_scatter():
        y = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(y, torch.ones(2 * n, device=dev))
        return y

    def all_to_all():
        y = torch.empty(n, device=dev)
        dist.all_to_all_single(y, torch.full((n,), float(r), device=dev))
        return y

    def objects():
        box = [{"rank": r}]
        dist.broadcast_object_list(box, 0, device=dev)
        return torch.tensor([box[0]["rank"]])

    attempt("all_gather_list", gather_list, want_g)
    attempt("all_gather_into_tensor", gather_tensor, want_g)
    attempt("reduce_scatter_tensor", reduce_scatter, torch.full((2,), float(n)))
    attempt("all_to_all_single", all_to_all, torch.arange(n, dtype=torch.float32))
    attempt("broadcast_object_list_cuda", objects, torch.tensor([0]))
    return dict(rank=r, results=out, ms=timings(dev))


def timings(dev, reps=5):
    """Median ms of the sharded loops' collectives at the mapping path's
    sizes (a 2^17 map: the 16 summed floats a Gaussian, 8.4 MB; a view's
    [1280, 96, 16] rows, 7.9 MB; the 92 MB payload of a call), on the CUDA
    tensors directly and staged through host memory."""
    import statistics
    import time

    import torch
    import torch.distributed as dist

    def timed(fn):
        out = []
        for _ in range(reps + 1):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1000.0 * (time.perf_counter() - t0))
        return statistics.median(out[1:])

    n = dist.get_world_size()
    red = torch.ones((1 << 17) * 16, device=dev)
    rows = torch.ones(1280 * 96 * 16, device=dev)
    payload = torch.ones(23 * 1 << 20, device=dev)

    def staged(op, x):
        def fn():
            h = x.cpu()
            op(h)
            x.copy_(h)
        return fn

    def gather(x):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x)
        return parts

    return dict(
        all_reduce_8mb=timed(lambda: dist.all_reduce(red)),
        all_reduce_8mb_host=timed(staged(dist.all_reduce, red)),
        all_gather_8mb=timed(lambda: gather(rows)),
        all_gather_8mb_host=timed(lambda: [p.to(dev) for p in gather(
            rows.cpu())]),
        broadcast_92mb=timed(lambda: dist.broadcast(payload, 0)),
        broadcast_92mb_host=timed(staged(lambda h: dist.broadcast(h, 0),
                                         payload)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from monogs_tpu_torch.parallel.launch import RankGroup

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    with RankGroup(args.ranks, "gloo", "cuda", timeout_s=120) as rg:
        for line in rg.call(probe, (args.ranks, 1), gather=True):
            print(json.dumps(line), flush=True)
    print(json.dumps(dict(torch=torch.__version__, cuda=torch.version.cuda,
                          card=torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
