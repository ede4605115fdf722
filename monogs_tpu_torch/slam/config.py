"""YAML config system: recursive inherit_from merge and defaults.

Counterpart of ``monogs_tpu/slam/config.py`` (the port keeps its own copy):
sections Results / Dataset / Training (+RGN, lr) / opt_params /
model_params / Renderer. ``inherit_from`` is resolved against the working
directory, the config file's directory and each directory above it, and
the ``Training.RGN`` block and the exposure learning rates are defaulted,
so that every config under ``configs/`` loads alike in both packages.
"""

from __future__ import annotations

import copy
import os

import yaml

RGN_DEFAULTS = {
    "use_huber": True,
    "huber_delta": 0.01,
    "pnorm": 1,
    "first_order": {
        "max_iter": 40,
        "fast_iter": 0,
        "num_backward_gaussians": -1,
        "num_pixels": -1,
    },
    "second_order": {
        "max_iter": 10,
        "num_backward_gaussians": -1,
        "repeat_dim": 1,
        "stack_dim": 16,
        "sketch_dim": 64,
        "initial_lambda": 0.001,
        "max_lambda": 10000000,
        "min_lambda": 0.000001,
        "increase_factor": 5,
        "decrease_factor": 5,
        "trust_region_cutoff": 0.0001,
        "converged_threshold": 0.00001,
        "use_nonmonotonic_step": False,
        "use_first_order_best": True,
    },
    "override": {"mode": "none", "first_logdir": ""},
    "use_best_loss": True,
    "print_output": False,
    "log_output": False,
    "log_basedir": "outputs",
    "save_period": 10,
}

_DEFAULTS = {
    "Results": {
        "save_results": False,
        "save_dir": "results",
        "save_trj": True,
        "save_trj_kf_intv": 10,
        "use_gui": False,
        "eval_rendering": False,
        "use_wandb": False,
        "save_initial_ply": False,
    },
    "Training": {
        "lr": {
            "cam_rot_delta": 0.003,
            "cam_trans_delta": 0.001,
            "exposure_a": 0.01,
            "exposure_b": 0.01,
        },
        "RGN": RGN_DEFAULTS,
        "experiment_step": -1,
        "alpha": 0.95,
        "spherical_harmonics": False,
        "edge_threshold": 1.1,
        "rgb_boundary_threshold": 0.01,
        "kf_cutoff": 0.4,
        "prune_mode": "slam",
    },
}


def update_recursive(dict1, dict2):
    """dict1 masked by dict2, recursively (config_utils.py:36-49)."""
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = dict()
        if isinstance(v, dict):
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v
    return dict1


def _resolve_inherit(path: str, base_file: str) -> str:
    if os.path.exists(path):
        return path
    rel = os.path.join(os.path.dirname(os.path.abspath(base_file)), path)
    if os.path.exists(rel):
        return rel
    # walk up from the config file looking for the referenced path, so
    # "configs/..." references work from any CWD
    d = os.path.dirname(os.path.abspath(base_file))
    while True:
        cand = os.path.join(d, path)
        if os.path.exists(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            return path
        d = parent


def load_config(path: str, default_path: str | None = None) -> dict:
    with open(path, "r") as f:
        cfg_special = yaml.full_load(f)

    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        cfg = load_config(_resolve_inherit(inherit_from, path), default_path)
    elif default_path is not None:
        with open(default_path, "r") as f:
            cfg = yaml.full_load(f)
    else:
        cfg = copy.deepcopy(_DEFAULTS)

    update_recursive(cfg, cfg_special)
    return cfg
