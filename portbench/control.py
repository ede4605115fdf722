"""The readings that a cell's correctness limits are set from, on the
card at the cell's own size (not run by the benchmark's own runs):

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 [--out FILE]

For every seed of ``--seeds`` the program's checked first steps against
the reference as a run compares them (the sound runs: the lower
readings). For every seed of ``--control-seeds``, in the program's place,
the reference computed in bfloat16, the nearest precision below the
float32 the configuration states (the control), and the reference with
three faults planted: half of the staged views left out and the rest
weighed double, the position gradient altered by 1 % where it is
produced, and densify and prune returning the map as they got it (a state
left unchanged). One JSON line per reading on standard output (and in
``--out``).
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv):
    import argparse
    import json

    sys.path.insert(0, ROOT)
    import torch

    from portbench.harness import device as devmod
    from portbench.harness.spec import Spec

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Spec().cell(a.workload)
    dev = devmod.Device(torch, a.device)
    out = open(a.out, "a") if a.out else None

    def emit(**rec):
        line = json.dumps(dict(workload=a.workload, **rec))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    emit(kind="device", device=dev.record(cell["chips"]))

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    ba_readings(cell, seeds(a.seeds), seeds(a.control_seeds), dev, emit)
    emit(kind="done", seconds=time.perf_counter() - T0,
         jax_modules=devmod.forbidden_modules())
    return 0


def ba_readings(cell, seeds, control_seeds, dev, emit):
    import torch

    from portbench.harness import compare, window_ba as W

    st = W.settings(cell)
    for seed in seeds:
        t = time.perf_counter()
        inp = W.make_inputs(st, seed, dev.dev)
        prog = W.Program(st, inp, seed, dev.dev)
        got = prog.checked_steps(st.prm["check_steps"], inp["noise"])
        del prog
        dev.free()
        ref = W.reference_steps(st, inp)
        nums, detail = compare.training_numbers(got, ref)
        emit(kind="program", seed=seed, numbers=nums, detail=detail,
             seconds=time.perf_counter() - t)

    half = [2.0 if v % 2 == 0 else 0.0 for v in range(st.b)]

    def altered(g_sum, g8):
        g_sum["xyz"] = g_sum["xyz"] * 1.01

    def kept(p, am, av, active, *a):
        return p, am, av, active, None

    for seed in control_seeds:
        t = time.perf_counter()
        inp = W.make_inputs(st, seed, dev.dev)
        ref = W.reference_steps(st, inp)
        for name, kw in (("control_bf16", dict(dtype=torch.bfloat16)),
                         ("fault_half_views", dict(view_weights=half)),
                         ("fault_altered_grad", dict(grad_hook=altered)),
                         ("fault_densify_skipped", dict(densify_fn=kept))):
            got = W.reference_steps(st, inp, **kw)
            nums, detail = compare.training_numbers(got, ref)
            emit(kind=name, seed=seed, numbers=nums, detail=detail)
        emit(kind="control_seed_done", seed=seed,
             seconds=time.perf_counter() - t)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
