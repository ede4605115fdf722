"""A cell at a size a CPU test can hold: 64x48 pixels, 2,000 Gaussians,
a BA window of three views and two pool views in two-iteration calls;
everything else as the cell's files give it."""

import copy
import time

import torch

from portbench.harness.cli import run_cell
from portbench.harness.spec import Spec

SEED = 2**31 + 12345


def shrink(cell):
    cell = copy.deepcopy(cell)
    conf = cell["config"]["config"]
    conf["Dataset"]["Calibration"].update(fx=50.0, fy=50.0, cx=31.5,
                                          cy=23.5, width=64, height=48)
    conf["Renderer"].update(macro_tiles=2, k_macro=64, k_fine=16,
                            map_capacity=4096)
    conf["Training"].update(window_size=3, pose_window=2)
    cell["config"]["scene"].update(n=2000, scale_min=0.05, scale_max=0.15)
    cell["params"].update(chunk=2, l1_at=2)
    return cell


def run_tiny(name, trace=False, spec=None, seed=SEED):
    """One run of cell ``name`` at the tiny size on the CPU."""
    torch.set_num_threads(2)
    spec = spec or Spec()
    return run_cell(spec, name, seed, 0.5, trace, "cpu",
                    time.perf_counter(), overrides=shrink)
