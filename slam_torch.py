#!/usr/bin/env python
"""SLAM CLI of the PyTorch/CUDA port:
python slam_torch.py --config <yaml> [--eval] [--device cuda|cpu]

The command-line surface of ``slam.py`` for ``monogs_tpu_torch``: --eval
sets save_results and eval_rendering and clears use_gui; results land in
save_dir/<scene>/<datetime>/ with the resolved config (config.yml) and
the results (results.json); the run logs its total FPS and, with --eval,
the keyframe ATE and PSNR/SSIM/LPIPS before and after colour refinement,
and prints the results (with the keyframe ATE also without --eval, and the
stage split, ``SLAM.stage_summary``) as one JSON line.
It runs on the card unless --device cpu asks for the kernels' plain
versions on the CPU. A config with ``Parallel.n_devices`` or
``gauss_devices`` above 1 maps on that many ranks: NCCL with a card each
on the card, gloo on the CPU; ``--dist-backend gloo`` shares one card
among them.
"""

import argparse
import json
import os
import sys
from datetime import datetime

import yaml

from monogs_tpu_torch.eval.ate import eval_ate
from monogs_tpu_torch.slam.config import load_config
from monogs_tpu_torch.slam.runtime import SLAM
from monogs_tpu_torch.utils.logging import Log


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Gaussian-splatting SLAM (PyTorch/CUDA port)")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"),
                        default=None,
                        help="process-group backend of a config with "
                        "Parallel.n_devices or gauss_devices above 1: nccl "
                        "(a card per rank; the default on cuda) or gloo "
                        "(the CPU, or ranks sharing one card)")
    args = parser.parse_args(argv)

    config = load_config(args.config)

    if args.eval:
        Log("Running in Evaluation Mode: save_results=True, use_gui=False, "
            "eval_rendering=True")
        config["Results"]["save_results"] = True
        config["Results"]["use_gui"] = False
        config["Results"]["eval_rendering"] = True

    save_dir = None
    if config["Results"]["save_results"]:
        current_datetime = datetime.now().strftime("%Y%m%d_%H%M%S")
        path = config["Dataset"].get("dataset_path", "synthetic/scene").split("/")
        tag = (path[-3] + "_" + path[-2]) if len(path) >= 3 else path[-1]
        save_dir = os.path.join(
            config["Results"]["save_dir"], tag, current_datetime)
        os.makedirs(save_dir, exist_ok=True)
        config["Results"]["save_dir"] = save_dir
        with open(os.path.join(save_dir, "config.yml"), "w") as f:
            yaml.dump(config, f)
        Log("saving results in " + save_dir)

    slam = SLAM(config, save_dir=save_dir, device=args.device,
                dist_backend=args.dist_backend)
    results = slam.run()
    if "ate" not in results:
        # the keyframe ATE without the eval round trip
        results["ate"] = eval_ate(
            slam.frontend.cameras, slam.frontend.kf_indices, None, 0,
            final=True, monocular=slam.monocular)
    if save_dir is not None:
        with open(os.path.join(save_dir, "results.json"), "w") as f:
            json.dump(results, f, indent=2, default=float)
    print(json.dumps(results, default=float), flush=True)
    Log("Done.")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
