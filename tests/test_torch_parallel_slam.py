"""Full SLAM through the port with sharded mapping: ``SLAM`` on a config
with ``Parallel.n_devices`` or ``gauss_devices`` 2, its ranks a gloo group
on the CPU (this process is rank 0; ``parallel/launch.py`` spawns the
other), as ``tests/test_multichip.py::test_slam_e2e_sharded_mapping`` and
``tests/test_gauss_iters.py::test_slam_e2e_gauss_sharded_mapping`` run
the JAX package: ``test_slam_e2e.tiny_config("depth")``'s first 8 frames,
the same checks (8 tracked frames, 2 keyframes or more, over 500 active
Gaussians, keyframe ATE under 0.03 m). The port runs them at a cut depth
(init 10 and mapping 3 iterations, first order 6 and no second order, on
"pallas_lists", whose plain kernels are the fastest path on the CPU): the
full depth takes about 6 minutes a run here. Then the configs that
cannot run: the map sharded off "pallas_lists", NCCL with more ranks than
cards, and a worker rank that raises, which fails the run with its
traceback as the cause and leaves no live child."""

import multiprocessing
import threading

import numpy as np
import pytest
import torch

from monogs_tpu_torch.eval.ate import evaluate_ate
from monogs_tpu_torch.parallel.launch import WorkerError
from monogs_tpu_torch.slam import runtime as truntime
from tests import torch_parallel_ranks as pr
from tests.test_slam_e2e import tiny_config
from tests.torch_one_thread import one_torch_thread  # noqa: F401


def sharded_config(parallel):
    cfg = tiny_config("depth")
    cfg["Dataset"]["synthetic"]["n_frames"] = 8
    cfg["Results"]["save_results"] = False
    tr = cfg["Training"]
    tr["init_itr_num"] = 10
    tr["mapping_itr_num"] = 3
    tr["RGN"]["first_order"]["max_iter"] = 6
    tr["RGN"]["second_order"]["max_iter"] = 0
    cfg["Renderer"]["backend"] = "pallas_lists"
    cfg["Parallel"] = parallel
    return cfg


def no_live_children():
    assert multiprocessing.active_children() == []
    assert not any(th.name == "monogs-backend" and th.is_alive()
                   for th in threading.enumerate())


@pytest.mark.parametrize("parallel", [{"n_devices": 2},
                                      {"gauss_devices": 2}],
                         ids=["n_devices", "gauss_devices"])
def test_sharded_slam_end_to_end(parallel):
    slam = truntime.SLAM(sharded_config(parallel), device="cpu")
    assert slam.ranks.backend == "gloo"
    slam.run()
    no_live_children()
    fe = slam.frontend
    assert len(fe.cameras) == 8
    assert len(fe.kf_indices) >= 2
    assert int(slam.backend.gaussians.n_active) > 500
    gt = [np.linalg.inv(fe.cameras[i].T_gt.numpy()) for i in fe.kf_indices]
    est = [np.linalg.inv(fe.cameras[i].T.numpy()) for i in fe.kf_indices]
    rmse, _ = evaluate_ate(gt, est, monocular=False)
    assert rmse < 0.03, rmse
    # every rank reported its launch counters at the end (the plain
    # versions run here, so they count none)
    assert [r["rank"] for r in slam.ranks.final_launches] == [0, 1]


def test_gauss_devices_need_pallas_lists():
    cfg = sharded_config({"gauss_devices": 2})
    cfg["Renderer"]["backend"] = "xla"
    with pytest.raises(ValueError, match="pallas_lists"):
        truntime.SLAM(cfg, device="cpu")


def test_nccl_needs_a_card_per_rank(monkeypatch):
    """NCCL, the default on a CUDA device, with 4 ranks and 2 cards raises
    before anything is allocated, naming both counts; gloo there is
    never chosen unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cfg = sharded_config({"n_devices": 2, "gauss_devices": 2})
    with pytest.raises(RuntimeError, match="4 ranks on NCCL.* 2 cards"):
        truntime.SLAM(cfg, device="cuda")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        truntime.SLAM(cfg, device="cpu", dist_backend="nccl")


def test_worker_failure_fails_the_run():
    """A worker rank that raises (here while it reads the first call's
    header: a config value that raises where it is unpickled) fails
    ``run`` with the worker's traceback as the cause, within the group's
    timeout, and leaves no live child."""
    cfg = sharded_config({"n_devices": 2})
    cfg["Training"]["alpha"] = pr.WorkerBoom(0.95)
    slam = truntime.SLAM(cfg, device="cpu")
    with pytest.raises(RuntimeError) as e:
        slam.run()
    causes, err = [], e.value
    while err is not None:
        causes.append(err)
        err = err.__cause__
    worker = [c for c in causes if isinstance(c, WorkerError)]
    assert worker and "injected worker failure" in str(worker[0]), causes
    assert "sharded mapping failed on rank 1" in str(causes)
    no_live_children()
