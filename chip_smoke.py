#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (monogs_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py [--scene-seed N] [--sgbm-against FILE]

It needs one CUDA card and the CUDA toolkit (nvcc); it imports nothing of
JAX. Phases, each of which exits non-zero on failure:

1. build the kernels from ``monogs_tpu_torch/csrc`` (one nvcc for sm_90a
   per source, started together) and print the build time, the build
   record (``utils/compile_stats.py``: the libraries built, their
   seconds, and those reused from disk) and the card's name and power
   limit;
2. kernel phase: run each kernel on the card at the shapes of its path
   (640x480 in 16 px tiles, k_fine 96: a 12 % tile subset for tracking, 320
   and all 1280 tiles for mapping, plus one RGB-D mapping call at the
   320x240 / k_fine 256 shapes of configs/synthetic/rgbd.yaml), on rows of
   the main path's scene, and hold it against its plain PyTorch version on
   the same inputs; time both with CUDA events; then the four macro-list
   kernels of the "pallas" and "pallas_compact" render backends on the
   scene's macro lists at frame 1's pose with the L1 cotangent of frame 2,
   at the bench shape (k_macro 1024, k_fine 96), at the 320x240 /
   k_macro 4096 / k_fine 256 shape of configs/synthetic/rgbd.yaml and at
   the bench shape in 32 px tiles ("@tile32"); and the mapping step's
   madd variant on raw rows at both mapping shapes, also bit for bit
   against the step on the same rows pre-masked; every kernel is
   launched twice and must give the same bits, the kernels on the
   tensor-core reverse (the fused steps and the list and macro VJPs) are
   held to their plain version in float64 (``f64_excess``), and their,
   the forward blends' and the macro forward's registers, shared memory
   per CTA and resident CTAs per SM are logged and added to their kernel
   entries; then the list kernels again at 32 px tiles (P 1024, entries
   tagged "@tile32");
3. tracking path: render the 22 frames of a jittered orbit around a
   100k-Gaussian synthetic scene through the port's ``render``, track a
   20-frame monocular chain with the shipped tracking configuration
   (previous tracked pose as the seed), then an 8-frame RGB-D chain;
4. mapping path (``bench.py::bench_mapping``'s workload): the scene in a
   map of capacity 2^17, its positions, colours and opacities perturbed, a
   window of the chain's frames 0-9 (B = 10, poses 1-4 and exposures 1-9
   optimised, a tenth of the scene inserted per keyframe): BA at tile_frac
   0.25 across a densify (iteration 200) and at 1.0, timed by
   bench_mapping's delta method (at 0.25 the timed iterations include the
   densify and its list rebuild); a densify with clones and splits held
   against the same call on the CPU; RGB-D BA; initialisation on one view;
   covisibility pruning; colour refinement; one profiled BA iteration;
5. macro-backend mapping path (the unfused branch, ``bin_margin`` 0, every
   render binning its view anew): one frame on "xla", "pallas_compact" and
   "pallas", then 10 BA iterations of the same window on "pallas", 10 more
   on "pallas_compact", 5 RGB-D iterations on "pallas" and 10
   colour-refinement steps without lists, timed by the delta method, with
   host syncs, peak memory and one profiled iteration;
6. A/B mapping path: 5 BA iterations of the same window with each of
   io_batch (the mapping step's madd kernel), scatter_segsum, gather_first
   at tile_frac 0.25 and batch_render, each held against the default fused
   branch from the same state, then 2 RGB-D io_batch iterations;
7. A/B tracking path: 3 frames of the mono chain on each of the unfused
   first order over lists, "xla" with bin_margin 0 (linearised second
   order) and "pallas" with bin_margin 0 (first order only);
8. BA reproducibility: one BA iteration of the mapping path's window run
   three times from one saved state on the default fused branch (all
   tiles and a quarter) and on each mapping knob; every tensor of the map
   and the window's cameras must come out with the same bits;
9. SLAM path: full SLAM through ``SLAM(config).run()``, ``--eval``, on
   configs/synthetic/rgbd.yaml, mono.yaml and rgbd_threaded.yaml at their
   widths, cut to 16 frames and fewer BA / refinement iterations (see
   ``SLAM_RUNS``): keyframe ATE, PSNR/SSIM before and after refinement,
   the stage split, and kernels #1-#6 launched;
10. parallel path (sharded mapping, ``monogs_tpu_torch/parallel/``): the
   mapping path's window at k_macro 4096, 4 BA iterations on one NCCL
   rank (the view-sharded call with ``map_iters``'s bits, the map-sharded
   one within the JAX tests' tolerances), on 2 gloo ranks sharing the
   card (views; map) and on a 2 x 2 mesh, each held to ``map_iters``, 30
   iterations across a densify on the sharded map held to its
   properties, then the SLAM path's rgbd first16 run with
   ``Parallel.n_devices: 2`` and with ``gauss_devices: 2`` through
   ``SLAM(config, dist_backend="gloo")``, the 4-rank NCCL config raising
   on one card, and kernels #2 and #6 launched on every rank;
11. diag path (observability, on the tracking path's scene): (a) one
   frame of the mono chain cut at each of ``track_frame``'s stages
   (build, lists, fo, so_prep, so, final_nc, full), checked as the CPU
   test checks them, with each stage's least time over 5 interleaved
   rounds (and the median) and the consecutive deltas; (b) the device
   trace of one full frame that the tracking path took
   (``utils/profiling.trace``), its summary and file size; (c) ``utils/roofline.py``'s
   ``program_cost`` and ``classify`` of one frame and of one BA iteration;
   (d) ``slam/experiments.py``'s check_grad and lm_sweep on "xla", and
   kfine_vs_backward_subsample and pool_vs_fresh_sampling on
   "pallas_lists", each with the kernels it launched; (e) the GUI on the
   card: a packet of the scene, /stats, /view.jpg, /depth.jpg and
   /map3d.jpg fetched over localhost, the view decoded and held to the
   render, then the SLAM path's "rgbd" run once more with ``use_gui``
   (its poses bit for bit those of the run without the GUI);
12. files path: SLAM from files through the port's loaders. The stock
   synthetic sequence's first 16 frames at TUM's pace (its orbit's
   amplitudes from ``tum_like_amps``, about 8 mm a frame), rendered at
   each config's own calibration and width, are written in the layout of
   configs/rgbd/tum/fr1_desk.yaml (640x480 PNG, distorted: the raw frames
   sample the render at each pixel's undistorted point),
   configs/mono/tum/fr3_office.yaml (640x480 PNG),
   configs/rgbd/replica/office0.yaml (1200x680, JPEG colour by nvJPEG's
   encoder, 16-bit PNG depth) and configs/stereo/euroc/mh02.yaml (752x480
   grey PNG pairs, distorted and rectified); each loader is held to its
   CPU path on two frames (PNG bit for bit, remapped images within 1 LSB,
   SGBM depth bit for bit; Replica's decode within 3 LSB of the encoded
   frames), and the embedded JPEGs' decode within 3 LSB of libjpeg's
   pixels; then ``SLAM(config).run()`` reads the files (``slam_path``'s
   depth, --eval) once a ``FILES_RUNS`` row, with the config's own
   keyframe policy and insertion or, where both packages keep only
   keyframe 0 with those, the sequence's (fr1_desk runs both ways):
   one JSON line each with the keyframes, the keyframe ATE, the ATE over
   the frames and that of holding the first pose, the Gaussians after the
   first keyframe, the overlaps behind the keyframe decisions and
   ``load_ms``, the time ``dataset[i]`` blocks the frontend; checks: ATE
   under 5 cm for TUM RGB-D and below holding the first pose for mono,
   stereo and Replica, two keyframes or more (or, on a row that names
   them, the keyframes both packages take), PSNR not lower after
   refinement, kernels #1-#6 on the RGB-D runs, remap on the
   distorted TUM ones, on EuRoC ``remap_pair`` once a frame loaded (both
   eyes in one launch) and no ``remap``, SGBM on EuRoC, ycc_rgb on
   Replica; last the remap, remap_pair, SGBM and ycc_rgb kernels held to
   their plain versions and to a second launch and timed against their
   bounds (SGBM's the larger of its bytes and its integer operations),
   ``grid_sample``'s ms, device ms and host µs beside remap's, an empty
   kernel's device ms on one CTA and on each remap and ycc_rgb grid, the
   host µs of each step of one remap wrapper call (the parent's wrapper
   and this one), SGBM's device time split by launch and the CTAs of each
   launch held to the card's SMs, the PNG unfilter's calls over the runs,
   and the PNG unfilter and nvJPEG decode timed on the host; with
   ``--sgbm-against FILE`` (another sgbm.cu, for example the parent
   commit's) the two SGBM builds timed in turns on EuRoC's first pair,
   and EuRoC's ``dataset[i]`` timed with each build and with the pose
   table or a pose copied from the host; with ``--remap-against FILE`` /
   ``--ycc-against FILE`` (another remap.cu / ycc_rgb.cu) each timed in
   turns against this checkout's through the parent's wrapper, the bits
   held equal;
13. live path: live mode (``Dataset.type: realsense``) through a
   simulated camera (``tests/sim_realsense.py``, a ``pyrealsense2``
   stand-in serving the stock sequence at TUM's pace rendered at 640x360
   through the camera's distortion): configs/live/realsense_rgbd.yaml
   with the sequence's keyframe policy and insertion, 12 frames,
   threaded, the GUI forced on and one /view.jpg fetched during the run;
   checks: the frames tracked, two keyframes or more, ``remap`` once a
   frame, the ATE over the frames against the camera's true poses below
   holding the first pose.
Each path's launch counters are zeroed just before it and read just after.

Output, one JSON object per line: each path's metrics, then
``{"kernels": [...]}`` (each kernel's time, plain time, bound, error and
launches on its path, and on ``slam_path``, ``parallel_path`` (summed
over the ranks), ``diag_path``, ``files_path`` and ``live_path``; ``ms`` is
the CUDA-event time of one call on an idle card, which also counts the
card's wait for the host, and ``device_ms`` the device time of one call
with the card kept busy), then
the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TRACE_DIR = ROOT / "build" / "traces"   # profiling.trace's files

# The H100's peaks, each kernel's analytic operations and its bound:
# monogs_tpu_torch/utils/roofline.py (imported once the checkout's package
# is on the path, see import_port).


# Each kernel, the TPU kernel it replaces and the tolerance it is held to
# against its plain version on the card. Both run the same float32
# elementwise math in the same order along K (the CUDA library is built
# with -fmad=false; torch.cumprod/cumsum over a non-innermost dimension scan
# sequentially), so the alpha and early-exit decisions agree and counts are
# exact; sums over pixels are taken in another order (warp shuffles, or for
# the fused steps TF32 products of split float32 operands on the tensor
# cores, against cuBLAS), hence the tolerances (as in
# tests/test_torch_blend_lists.py). The list kernels and the macro VJPs
# are launched twice and must give the same bits.
REPLACES = "monogs_tpu/render/pallas_lists.py"
KERNELS = {
    "fwd": (f"{REPLACES}:310 (_fwd_kernel)",
            "image/opacity atol 2e-5, depth atol 2e-4; two launches "
            "bit-identical"),
    "fwd_counts": (f"{REPLACES}:323 (_fwd_counts_kernel)",
                   "as fwd; counts exact"),
    "fo_grad": (f"{REPLACES}:466 (_fo_grad_kernel)",
                "dd rtol 1e-3 + 1e-4 x column max; sums rtol 1e-4; two "
                "launches bit-identical; f64_excess <= 2^-14"),
    "fo_grad_rgbd": (f"{REPLACES}:466 (_fo_grad_kernel, rgbd)",
                     "dd, dd_dep rtol 1e-3 + 1e-4 x column max; "
                     "sums rtol 1e-4; two launches bit-identical; "
                     "f64_excess <= 2^-14"),
    "jvp8": (f"{REPLACES}:794 (_jvp8_kernel)",
             "outs as fwd; touts rtol 1e-3 + 2e-4 x channel max; two "
             "launches bit-identical; f64_excess <= 2^-14"),
    "bwd": (f"{REPLACES}:451 (_bwd_kernel)",
            "dd rtol 1e-3 + 1e-4 x column max; two launches "
            "bit-identical; f64_excess <= 2^-14"),
    "map_grad": (f"{REPLACES}:636 (_map_grad_kernel)",
                 "dd rtol 1e-3 + 1e-4 x column max; sums rtol 1e-4 + 1e-4; "
                 "two launches bit-identical; f64_excess <= 2^-14"),
    "map_grad_rgbd": (f"{REPLACES}:636 (_map_grad_kernel, rgbd)",
                      "dd rtol 1e-3 + 1e-4 x column max; "
                      "sums rtol 1e-4 + 1e-4; two launches bit-identical; "
                      "f64_excess <= 2^-14"),
    "map_grad_madd": (f"{REPLACES}:636 (_map_grad_kernel, with_madd, "
                      "madd_ref :655-677)",
                      "as map_grad; dd and sums bit-identical to map_grad "
                      "on the rows pre-masked"),
    "map_grad_madd_rgbd": (f"{REPLACES}:636 (_map_grad_kernel, with_madd, "
                           "rgbd)",
                           "as map_grad_rgbd; dd and sums bit-identical to "
                           "map_grad_rgbd on the rows pre-masked"),
}

KERNELS.update({
    "macro_fwd": ("monogs_tpu/render/pallas_blend.py:197 (_fwd_kernel)",
                  "image/opacity atol 2e-5, depth atol 2e-4; two launches "
                  "bit-identical"),
    "macro_bwd": ("monogs_tpu/render/pallas_blend.py:259 (_bwd_kernel)",
                  "ddata rtol 1e-3 + 1e-4 x column max; two launches "
                  "bit-identical; f64_excess <= 2^-14"),
    "compact_fwd": ("monogs_tpu/render/pallas_compact.py:244 (_fwd_kernel)",
                    "image/opacity atol 2e-5, depth atol 2e-4; two launches "
                    "bit-identical"),
    "compact_bwd": ("monogs_tpu/render/pallas_compact.py:262 (_bwd_kernel)",
                    "ddata rtol 1e-3 + 1e-4 x column max; two launches "
                    "bit-identical; f64_excess <= 2^-14"),
})

TRACK_KERNELS = ("fwd", "fwd_counts", "fo_grad", "fo_grad_rgbd", "jvp8")
MAP_KERNELS = ("fwd", "fwd_counts", "bwd", "map_grad", "map_grad_rgbd")
MACRO_KERNELS = ("macro_fwd", "macro_bwd", "compact_fwd", "compact_bwd")
AB_MAP_KERNELS = ("map_grad_madd", "map_grad_madd_rgbd")

# the data loaders' kernels, which stand in for OpenCV calls of the JAX
# package's loader (no TPU kernel behind them); bit for bit against their
# plain versions
DATA = "monogs_tpu/data/datasets.py"
KERNELS.update({
    "remap": (f"{DATA}:235 (cv2.remap INTER_LINEAR; also :311-314)",
              "bit for bit against the plain version; two launches "
              "bit-identical"),
    "remap_pair": (f"{DATA}:311-314 (cv2.remap of both eyes of a stereo "
                   "pair)",
                   "bit for bit against two plain remaps; two launches "
                   "bit-identical"),
    "sgbm": (f"{DATA}:315-319 (cv2.StereoSGBM compute)",
             "disparities bit for bit against the plain version; two "
             "launches bit-identical"),
    "ycc_rgb": (f"{DATA}:221 (cv2.imread of a JPEG: libjpeg's chroma "
                "upsampling and YCbCr -> RGB)",
                "bit for bit against the plain version; two launches "
                "bit-identical"),
})
# each data kernel's source
DATA_KERNELS = {"remap": "remap", "remap_pair": "remap", "sgbm": "sgbm",
                "ycc_rgb": "ycc_rgb"}


def kernel_source(kind):
    name = ("blend_macros" if kind in MACRO_KERNELS
            else DATA_KERNELS.get(kind, "blend_lists"))
    return f"monogs_tpu_torch/csrc/{name}.cu"

SHAPE = dict(fx=535.4, fy=539.2, cx=320.1, cy=247.6, width=640, height=480)
N_GAUSS = 100_000
SCENE_SEED = 4          # see make_bench; --scene-seed draws another
N_FRAMES = 20           # monocular chain (bench.py)
N_RGBD_FRAMES = 8
MAP_CAP = 1 << 17       # bench.py::bench_mapping
MAP_VIEWS = 10
MAP_XYZ_NOISE = 0.03    # metres, see map_window
# the L1 of the window after the 0.25-tile_frac phase must fall below
# this share of the L1 before it
MAP_L1_RATIO = 0.95
MACRO_ITERS = 10        # BA iterations of each macro-backend phase


# Two 32x24 RGB JPEGs (quality 95, 4:2:0) and their pixels as libjpeg
# decodes them (RGB, zlib-compressed), all made by OpenCV's
# imencode/imdecode on a CPU machine: "smooth" from a fixed smooth pattern
# with luma detail, "sharp" from
# np.random.default_rng(0).integers(0, 256, (24, 32, 3), np.uint8), whose
# chroma changes at every pixel. files_path holds nvJPEG's decode of each
# stream to its pixels (tests/test_torch_datasets.py checks that cv2
# still decodes the streams to them).
JPEG_B64 = (
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAIBAQEBAQIBAQECAgICAgQDAgICAgUEBAMEBgUG"
    "BgYFBgYGBwkIBgcJBwYGCAsICQoKCgoKBggLDAsKDAkKCgr/2wBDAQICAgICAgUDAwUKBwYH"
    "CgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgr/wAAR"
    "CAAYACADASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAA"
    "AgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkK"
    "FhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWG"
    "h4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl"
    "5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREA"
    "AgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYk"
    "NOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOE"
    "hYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
    "5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwD7B8AfELRbTQU8OyFN+zbiuc8e/CmO7mfx"
    "GiDby2a8e0TxNfpqy6uJmEW7Oc8V6Jrf7TGgHwwdDe7TzTHjG72rwKmVVMmndLY9zinB4nhD"
    "KnGGlkeUfGTxPp0+ny+GlClyCuBXyj4u/Ziv7vXG8SrbEoW3Z21754h0+81/xQdYVi0Rk3e2"
    "K9E0m20HWNBGkeWhlKY6V4ObeIeJy6m6akfzLgOIszzTP1GTbVzyuf4yaZovg82k1wonEeOT"
    "zmvnfXfjP4hl8ZGVbt/I83+8cdaKK/WOIIRqQd0f2n4y04VYSi1oe9fD/wCMGial4dS1luEM"
    "5Tuec13Hwh/tO+8Ux3bljAZB9MZoor+beKMDQnWdz+fuEOHMreO9o4an/9k=")
JPEG_PIXELS_B64 = (
    "eNoVzIdaGgkCAOBXufu+3b1NcmnGWEF67yBNKWJDgqLRiCWaKJHehg4DM8BQBqQXFQuKUWNM"
    "spfbe6Lb/R/gt9QNoYvd8p3r/CH65QH+8QX50YW/tmM3h8EO5Kj5LKjDhByYkmYLbPfA7gjs"
    "Q6BwIR6rBsCKNVzc9ma1pohk3UGa33ktX/6Nrf4HRfpPAv9XHPsFSTDClDqaa+DFXu0L0H2I"
    "fX1I/7zP/Oxlvp/AN5XwOeJphh0lwJp1WlNOB+zxJXwROJyJg4UIVALg0qcYuhFIz5sj4i07"
    "Wb8zMLXy+7jmF7bsF4bwMY3XzxJh+VKgsQmfmxs3gcv7xMN9+udt9u//LHXXiHXzwSMYqMU8"
    "aNCTDgBwOBiLRKNQ2p/MeZG8BcntwKmVKDjl9An2LPi1jX7d0hOV5jeZ9JFI+EzIHxwX4mTi"
    "QGU3dWxtXPgve/EvvdQfV8iPC+RbJ3XXgi7L0U4u3ERCBTiIwCEIjoaToBeBbZnEpyy0nQVX"
    "kqE5EJD5HCzb3tjuu4H1xWeLmidz0mdT4/0qPlYtIGqEYNGUrdrrbd/5cfTmBLo/gb8ep+6P"
    "0nftVK8Bn1ehdilRKiayBTBRSPjzoBWN7qDB9bxPn3Nr0nZJ4oAT2qV4N7G2t8Of3vTvTvcb"
    "J4ZWRFgDn7LIYyxy01krijrrh8BJKdAtR69r8ZsGdNNM3R4h1+3M5XGmc4RU2kiunY7XIU81"
    "tl8Jrh26dXmrKmsSJd8zE0ZybBUXMmD8+lFAO+qaGbMqSCYpfVfA2eTwjEw06SrCrirsaSaB"
    "45T/NBO6LIBXVfivvNfJXV8Uzi+LjasC2s1HOyl7O7pVc+uKB4rMe0FqjZpYGgN12LgOA85j"
    "wDlCfI4EztAjKl5gQuQWiQ840j16KQIcht3lgKsWdDaCriPQ10FC58V4r4X0TvPXvdLFbbl5"
    "e5i/QcNd2HwSXK1bNYUdUfotFXqDiU0PxtVDsHo4qRrLaCj5GTY6K8xp5CmFIjau8nJUNmrD"
    "F6y4gZLdUbHbq057DXC3Y/6TTPS8CvdO0avrUve+2vpWyX1Fg5+h/TPfUv1gomBkJhewcfXr"
    "mPxFTNIHSQczsrGCkl6bErZmJxrT02XlPCrVJrgzfvKRPVo/8FU+OsofbOV9W9XqaPiBNhQ6"
    "O4S6x9mLy2LnrlT7epi+R7yfYztnTm1jT1xYJUMzg6D8eVT0BOQ+T/EHUDGuJmccKyVn0+pT"
    "jfZYuVSTGrLcNyC5sxdrvQ82NtwVo728bal8tNddQDMcOMlCZ/Vs5xRt9wqHd/n4Dey4ChhP"
    "LZrae05+EQspX4HiJyDn9wTjaYb1uiwktKWss0lZTz3dU+u7k29PxGtlzkqG3N1IdNajR6u+"
    "1pqnYXTVdpx1C1AHAu0EeFRINuvp8lkmfZkMdCOmM/fy0b6iss7Ma0eSk32w6EmS/ShJe5Zj"
    "DFTZhCM+62Jcdi2buZEZriTrp8KNOmO9QOgZ4Isl8HQp2DEE2m+B5iZQ3/fVHP5KIFyBY4U8"
    "mKrEQs2gpenZbBzM17alpRU6OodB5K8R0fMs+2mW+rJIG6rRSCds9gVX1hPM9gTLXd7GKWu7"
    "Sdmp4D9rUz0tdKUDL/Th0+Xg8Xqg+SFYNQeKzkA2GIRAXyDlseXsW6jJUNxVF9aEBT0NncLl"
    "5EM5YT/KflWkD1Qo2AaVckLlnNFkF/Tpc5qhQ9k8Ie+3yKYG4WYqdTeTutXCN3rociV69i7c"
    "3A6U93yIyZ2wOwGn2QzsbYTe62PrGvidJKXnZGapeRWhIMcWRSNlzmiN+VeOb5KoLTynjZMc"
    "4aZaWH0Ts9nAHNRx9gbuVp78qka+zWe/L2bv36Yu18CWMVTc8sa37IEP5oOPOxumdzqzQeVa"
    "kPl13Mg0HVbScpOUwwlSWUqoC0ktDqnJINcJtBqGWxsVV4dU5df68sBmZdBSHXU1cPci+McE"
    "8t+Z/B+63MNy7no13V6NoqtAbNVsWd7aXF7RrS0oNjXju0r2JwXTo6SDCmp6kllQsKqTjKaE"
    "3uTSmkx6jcgojXCL/eL8C0XmqS77YhN9ZS4PAy3cF3bsuzj5v6n8n7rCdwP6eSXdWo5ml9z+"
    "hb0Ps28XZ+YVM5O8BRF9WUg2CigmCdUno8Zl7LyKX1EKGjJeS8StszgVIhcd5iOvxNBTRfzR"
    "m8STbaTPUhgMtUi31Mh3YfJPNfpzvvCgR3tL6cabMDRnc2l2jJNvZmQqoVRAUbDxs0z8Epuw"
    "LSDahNSghJ9WiYsqSXVCWpeIyxwBShQgo8L4C0nosTrwL33o0U7ipTM3kmhSb8ihB17iPxOZ"
    "75rM3Rxypo2XZoGo2vRJtrYsnFXwZGwuCy+kjkxQhmfpmBUm4SOX7h4XxCbEqUl5XjZRGJfn"
    "WJIUQQoOSwMvld5/z7kfr/me7kf6fEksUmVe4/33zOiDCLqfgC9VUFsdzkzafdLdXf6Sjj0l"
    "o4toNBqGTRwSEYcmSSNaKsHIpH3iCb0SSUQqj4+rYKEywVJEiaogRu3pm3c+W3E+2/X0OQID"
    "UYhwWOJejQG3lOAdJ9ITRTriUEnijov2HXzjFlunpSnEFD6NQsfSicN8/JCMNDpLxS1RKVsM"
    "3gFf7BTIAZ4qwFEH6BoAP+vBaB0Dy7b+TWvfgWvQ78ckQWoFFfSw7iu8t0vxHjNcJZYtyd7z"
    "Mjf2GYZV2twUSS4i8alk2t8/hzAgIgwrSZh5In6JSDfSODt0oYkuNVOUNtK0Dbdgwy5bh7dt"
    "oyb7qNeNjwfJOZDVyIqvMK5zjP0Iay3jTCn8bpCwbiEY3pMWDCSNmigbJwuYdA6RRR3hEgcE"
    "+EE5fmhqbHQOi9ePkVewjHdj/O1R6Qfs1D5GZx5dtWL2HASnmxj201MR5iHIayOS/wMELnSi")
SHARP_JPEG_B64 = (
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAIBAQEBAQIBAQECAgICAgQDAgICAgUEBAMEBgUG"
    "BgYFBgYGBwkIBgcJBwYGCAsICQoKCgoKBggLDAsKDAkKCgr/2wBDAQICAgICAgUDAwUKBwYH"
    "CgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgr/wAAR"
    "CAAYACADASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAA"
    "AgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkK"
    "FhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWG"
    "h4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl"
    "5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREA"
    "AgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYk"
    "NOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOE"
    "hYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
    "5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwBfG/xa+JniXxnrXgfXvG2gS3vhrw6t8LXS"
    "tLC2V47QQWk19e6WYzHBCESFkF0I7eyCxgSmGO424GoW+peCfisPgv4h8LTWnirVVsdU0zVL"
    "yG4s1S8mcW0r3CLNm4nk+ytaoPtTReZaWchn+zT3cg0viLq/hXwL8Xo/E3gXR9NNldeDbfxF"
    "qEFmlnpsuq2lnb2VnpZtBIYzpkkM2mrLIbUyyW2+FjDMZ/slTy6Q2oeHrnwJq+meI/E2qWen"
    "tqj3uj6lbRzalqFxfR6cdMt4dK1Nxp0cNyZFluoYoluXgkujIW2zS9eIU63LmCw6o+zjOSbU"
    "IOM3zSnNvRucHGc5c/s4pTnUjTjSqVeXghXwWW4HCR5v3MoTVWC+N3lCnKSnGKnFOM4P2cqj"
    "n7ynLm96MI9U8EX2u/FSb4d/C3wN4s1bSPEPhyWXRH1rxU3kzafdrLE17fTveb7q3kvY3inh"
    "lxE0Mdu0U1w09oJud8K+MdTuhqN74D8Qa5Jq9v4K8RzeOtcQN9r8QT2N/LcQTwwv5oitJJrq"
    "5d2NtEZJILx4FtoPOifpNJ1n4m/Ee68PWHw2+G9ppc91Fpen6Z4U129um07WYftNub20vLV7"
    "WW3sbKa0nnhSNbdGWBxM7rbGONeg8IeHtG8aeNtR1P4maNqWq+HvEukXltpUOuahYxQ/Z4oI"
    "p4fPtI/9OiWCSeOeG3tXh2iGV08mSO1E3l1K+Lx86GLqYOpOnywjpOrUnKMW4TTnWnac6kPf"
    "TnGTrck+aMVKThrjOJ8pwWF9jm8p4alXjKzvKo0oSrOVOlKMJQ5OTkfw88alGaalGmpFr40a"
    "pqWj+MtP8OaJDp3jm2tmtNM8E3wv3hn1+7Ooi1vIGaRzKl3JbXJLTHzbeO5ktlTyTNKVzfEP"
    "gDQXm1XXrH4If2H4r0mPzNEW23XF/fT3FvG1vp8IgeZo5DNZxsv2cu08sF8ouCDcOSivCjxL"
    "j8HRwtGKUpVKbnKUpVG+Z1KUW0ufkjpKStGCSTaVoto8PK8dLinOMJPHU4uUqsqMnbmUoSq4"
    "alZwm50/djNuPuK0kntzKVGD7L8Dpb7U/Gvi3xb4Z8L3Pg62v9J1XW7S7t7vQ5TPNbPbwQz3"
    "ck6T3UrzDzGUJEJbuSOaQRTrOniDwVqmgaJpXiL4Z+KprWws5bK8143d/Ilzdaw0k5gW1itF"
    "iv5wqzf2bNAyiRVRB5sI06K7iKK7eF8N9fxmBxdapNzx2LWGqtzlJ8sauHoqpGU3KSqpe/zO"
    "Tjz814OE6kJexSzrEzz+OFcItclN3a5p35LXc5Nyd1o03y3vO3tJTlL/2Q==")
SHARP_JPEG_PIXELS_B64 = (
    "eNoFwQlUGoYBAFB3973mrd1L26TL0sY0JlGTqDGHES8C3hoPFEVEERBBTkGQQ24QkVME5FAQ"
    "EcSD0wuPeBG1MSaaODVt065Nu65b2tdue9v6+l6f+x8tc85/9UmBJMX/jWFkY0nv9IgEtSjM"
    "df2IqlXQcD4uJjyI6ceg5XA+VxAQ9z+3uX5kYNd0zXPzvKgwp/PF8KPn4w8AsRe2NsOVRakH"
    "QwPA3709bVmYno1ap+U8V93ez8ey8Ix6tTv0YiQeCKpvoK8FArtL/iZkibALQ2y9veST0ooK"
    "hBhudgWjUeA+m1B0J6VWSfZyKpQSqKgiHoQvr2ITkG67tOD22W5YWUdhMRwEWbq/RlW2Um3Y"
    "G0yzdvMTwaCNyGJxeYZqYPui9Ihxh+EWtPe0l7mt3UXA9O37c3gS2bD6CNPfbRhv7DVBetQG"
    "aCVdzJSaDUqxia6xUS+ciIkOCFacch0LuR5yZANT76LrEhFVMfFZ4tAjOEFbWEAV810hxz4p"
    "w0jO4ELSL1KwAF4nqxlNHbG6nj47jCsAp0JvLq23HuwrGogMYHkHoU1kdJhGN5zp4FgTth5y"
    "+q1/fbpjNnBP/CaGI6Faoiu5IrHKN1zQSAIVKxqavCXVfHGPk06V0VhMfUShnJPGAW+KpZaa"
    "NFRIE8hMTlj02354tD7aMwAs7J64f9zBnYiPB456J/FldUYgbYk0uLOwzVfIsnIziWIGb9r5"
    "DrxgfGNVOTDJaPfdSiQNaeeHLeMTs34AEngS+oFm103RKwE5UA5CXXQW/M+dTWZxrh7K2Rv+"
    "POMWP+EaIyellY6WJ1655lAaPtc+7E6jXz17WaKTp4Puaq129ZgvHY6sFozy+iMitm5CaFMB"
    "MJP4noSLl/qXJzXbwSwGsss+dOa9pNxsGB/fySgp+to/90A6S7xJ+f7gR1BC/rI8hASUzu1P"
    "rH863dNIy/19HLkZ7J9RpiVfXXRFe/He2ktM/sQ22+irLYdnv3mOfgb4pWnh8f3txDzg8FHU"
    "8mRpbG3tRmYeDEVAwVH0krLHVhcBCFvz3t+KrrbW1gruQP6z/rA7TNd+KKUTUci74H4VGZD6"
    "BgtV7eb1/zR3LE9znQXGeVenLsWlI/IJMqTIIxgoTil5vHfEGJZcw2YProeG58JoCkHYyVWT"
    "mQ6JIBXwlmFBLloxKTz6DxWGGTZrbN8QA4xplbZsrK1HXLONwEIFofDppLXg7VJujtW/qd/9"
    "auOPial0hkbF1bza/UzWTOtoaVXZNb69yK/Ov1mKg2lc1jpkPRmOOP2HX3h3tLnyzNpJ6sn8"
    "2PZqiFvIEjioke9ngnujsKZKal2bgcqf6cN6RNVH/uV7cRUsCXztcCarFaIZH0AAc3C3rz8L"
    "6Qel1Nqc2svv3bGM2Lf+sqsLjDdzWRw+yRM0YnVExQOTaFnsPhohdbOLYFV/unRqZcdPEZR3"
    "CCHUZgilGlxwMaanOeVwVvvtYz+nB632Crrn1MaAqSkDTLh+R1Cf8/LJbHNNW342VtXT7w6F"
    "MpBIlFKiHtEzlO0kHcu4YgsfDCaUnSnlYL3bD9+N/cDh0mv9NIKmBN1ebujv9Ln5B7u2v38f"
    "aCReDLxw9y8rwPCkUZcZdKpgCO/637MvL114H9ffO/vX76YDR6QWpdDrtTx90DXpK0A3gGoy"
    "evqJybd/XY240SbntGu0r79/7rdXTor3uxpmcVmCpqSmavPDCSC3WH5obF5hKCKG9n7m/AMP"
    "rOwetUouhNvzPiiF1eJ+mZvVubpy7WrZ+VPZJwG5A0dPsyno5IqMRlJREzazuu66w67gUNlG"
    "3YjG6hFPDoNNuBRjUww6r2F+NObc6y0LAynOto5/38+qxbsjm+Gl5TdPn1Gaxr1jHy7ad5AQ"
    "/uw3x3e50sNPPjMZB4lqv2J+60TGayw7JK3oNKAo3r7gonRwuCXMwRZLWQ7i8OufkyqpVVZP"
    "zbMp8qsoLuhumwq1f7x72alHNWvUKn94fA2Lob1xLoEu7GPjDOWFnVj9zLkqlN7Vl1MMKqMY"
    "dat/xjrxEx/1UjpQM9PzFSi8wx60tSjNTaI53+ziw8NWpoc3/ijJKmx6MprHZZSzxLTZKMQz"
    "ve57Mqb07Xu2nCyTnN0Hq2NKZBNU6RhEOpxG5sA5hDwE5LVroCvNzFsyimwhKKF5uOXmw4VX"
    "3dSuda8NhwRMPR50b420MNki49AJQArfN9g7ZGFxhV19nuDqx/R7pHGhec86/tw310lhwlFE"
    "szdSzZYDZV3S7fXYwhzN6EhyXpVn8wBAbivrEKWl1rfm81A3UDIMoRFzYXi+ST2MgDQlc9iI"
    "3LuA+egusLDqi+dPk947xcbQ0WU4Vinhu429oxlrBegd/4pe7pYI+uQ9U07RywBsQU2wWPYO"
    "v512hFuK6vU8TVe3hOui6P1cemUpIvNC+AhrWgKpaMBeRP4Ir7Im67JeHijLa6MioPNOxY3T"
    "b73c2vFpVDx01YAaI+SXchQoqZ5bCC6YerAM87JrwnK+f0FnW3R2WbTN9H3/agO0MJ91SRZA"
    "oMB3kJnxxK4zwccwWk3Cio5ppmfthnUfb3w1qIpkxF0VYGAuRWfJ9bgffgjabHhmO6IRCsOW"
    "4X/aP06JSaeXSOzBpUpxVyHXVExWTQaWx50eFptfWV+xuOMwmBk7Y2smPH+0p4GCO//yv4u6"
    "0bZOHkgrhn6xG5XTJILW3opMGLWhqleIevKNemZPGdmLJN4EkhpkQ6zpwQZ3XWJj7JVkrsuW"
    "RxWWM2RkhdgRGJ6NTJWXghH1WX6P1q+358deu5d4anm+z7zpgOlbhAPEgxdBVH06h4xymidw"
    "CO7hxlEXQ9AXpfBCeJSDwQrZVeGZehyTWIsJjFl6H4lEUfY9bLlryovqRVsiKh2tBZGccC8/"
    "AYG8OT5E8nsYyJZc55Lv3WJoKp6eBAebI71cFW7IJ17fsX79t48yLpKbckLkUWiWMA0T5is+"
    "mn2nKr9exAaBbz17GRLsIjs2YWOR3uKK28FXEwXU68N09PHO5uaiYyGqevUPMxJzqi8ohUr4"
    "b+cTXweiecHRu9QS9YSMpa0xTkDbOqqptQs++fH/AdxBcJE=")
JPEG_SHAPE = (24, 32, 3)
JPEG_SAMPLES = {"smooth": (JPEG_B64, JPEG_PIXELS_B64),
                "sharp": (SHARP_JPEG_B64, SHARP_JPEG_PIXELS_B64)}


def jpeg_sample(name):
    """(JPEG stream, libjpeg's [24, 32, 3] uint8 RGB pixels of it) of one
    of JPEG_SAMPLES."""
    import base64
    import zlib

    import numpy as np

    stream, pixels = JPEG_SAMPLES[name]
    return base64.b64decode(stream), np.frombuffer(
        zlib.decompress(base64.b64decode(pixels)), np.uint8).reshape(
            JPEG_SHAPE)

class Failure(Exception):
    pass


def log(msg):
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def check(cond, msg):
    if not cond:
        raise Failure(msg)


def import_port():
    sys.path.insert(0, str(ROOT))
    try:
        import monogs_tpu_torch
    except ImportError as e:
        raise Failure(f"monogs_tpu_torch is not beside {ROOT}: {e}")
    pkg = Path(monogs_tpu_torch.__file__).resolve().parent
    check(pkg.parent == ROOT, f"monogs_tpu_torch imported from {pkg}, not "
          f"from this checkout")


def counters():
    """The launch counters of the kernel modules."""
    from monogs_tpu_torch.utils import roofline

    return roofline.launch_counters()


def all_launches():
    from monogs_tpu_torch.utils import roofline

    return roofline.all_launches()


def reset_launches():
    for c in counters():
        for k in c:
            c[k] = 0


def restore_launches(saved):
    for c in counters():
        for k in c:
            c[k] = saved[k]


# the kernels on the tensor-core reverse, in blend_fused_attrs' order
FUSED_KERNELS = ("fo_grad", "fo_grad_rgbd", "map_grad", "map_grad_rgbd",
                 "map_grad_madd", "map_grad_madd_rgbd", "bwd")


def fused_attrs(kf=96, p=256):
    """{kind: registers per thread, shared memory per CTA and resident CTAs
    per SM} of the tensor-core reverse kernels at list length kf and P = p,
    from the library."""
    import ctypes

    from monogs_tpu_torch import _build

    buf = (ctypes.c_int * (3 * len(FUSED_KERNELS)))()
    rc = _build.library("blend_lists").blend_fused_attrs(
        kf, p, ctypes.addressof(buf))
    check(rc == 0, f"blend_fused_attrs failed with CUDA error {rc}")
    return {k: dict(registers=buf[3 * i], smem_bytes=buf[3 * i + 1],
                    ctas_per_sm=buf[3 * i + 2])
            for i, k in enumerate(FUSED_KERNELS)}


def fwd_attrs(kf=96, p=256):
    """{kind: registers per thread, shared memory per CTA and resident CTAs
    per SM} of the forward blends (fwd, fwd_counts) at list length kf and
    P = p, from the library."""
    import ctypes

    from monogs_tpu_torch import _build

    buf = (ctypes.c_int * 6)()
    rc = _build.library("blend_lists").blend_fwd_attrs(
        kf, p, ctypes.addressof(buf))
    check(rc == 0, f"blend_fwd_attrs failed with CUDA error {rc}")
    return {k: dict(registers=buf[3 * i], smem_bytes=buf[3 * i + 1],
                    ctas_per_sm=buf[3 * i + 2])
            for i, k in enumerate(("fwd", "fwd_counts"))}


def macro_attrs(p=256):
    """{kind: registers per thread, shared memory per CTA and resident CTAs
    per SM} of the macro-list kernels at P = p (the same for every list
    length), from the library."""
    import ctypes

    from monogs_tpu_torch import _build

    buf = (ctypes.c_int * 6)()
    rc = _build.library("blend_macros").macro_attrs(p, ctypes.addressof(buf))
    check(rc == 0, f"macro_attrs failed with CUDA error {rc}")
    out = {}
    for i, step in enumerate(("fwd", "bwd")):
        a = dict(registers=buf[3 * i], smem_bytes=buf[3 * i + 1],
                 ctas_per_sm=buf[3 * i + 2])
        out[f"macro_{step}"] = out[f"compact_{step}"] = a
    return out


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def kernel_ms(torch, fn, reps=25, warmup=3):
    """Device time of one call of ``fn`` with the card kept busy: a spin
    kernel holds the card while the host enqueues ``reps`` calls, so that
    the CUDA events around them time the calls' kernels back to back. It
    leaves out the time that the card would wait for the wrapper on the
    host (tens of microseconds per call, more than some of these kernels
    take); the wrapper's own small kernels (a stack of two scalars for the
    fused steps) are in."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    # twice the host's enqueue time at 2 GHz, so the calls queue up behind it
    torch.cuda._sleep(int(4e9 * host_s) + 1_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def cuda_ms(torch, fn, reps=25, warmup=3):
    """Median time of one call of ``fn`` on the card (CUDA events): the
    device's time from the call's start to its end, including any time it
    waits for the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ------------------------------------------------------------------ scene

def make_bench(torch, device, scene_seed=SCENE_SEED):
    """The main path's scene, configuration and ground-truth poses."""
    from monogs_tpu_torch.data.synthetic import make_synthetic_scene, orbit_pose
    from monogs_tpu_torch.ops import se3
    from monogs_tpu_torch.render import Intrinsics, RenderConfig
    from monogs_tpu_torch.slam.tracking import TrackConfig

    intr = Intrinsics(**SHAPE)
    cfg = RenderConfig(tile=16, macro_tiles=4, k_macro=1024, k_fine=96,
                       macro_chunk=16, backend="pallas_lists")
    tcfg = TrackConfig(
        monocular=True, fo_max_iter=40, so_max_iter=8, stack_dim=16,
        sketch_dim=64, bin_margin=16.0, fo_tile_frac=0.12, so_tile_frac=0.12,
        rebin_so_iters=3, fo_plateau_patience=5, fo_min_iter=3,
        so_plateau_patience=4, so_from_fo_aux=True)
    # drawn on the CPU, so the scene is the same whatever the device. With
    # k_fine 96 the share of the frame a scene covers, and with it how well
    # its frames can be tracked, varies from seed to seed; the main-path
    # line reports it as `coverage`. Seed 4 was chosen after seed 0 failed
    # the accuracy check; PERF.md gives every seed's coverage and error.
    gen = torch.Generator().manual_seed(scene_seed)
    scene = make_synthetic_scene(gen, n=N_GAUSS, spread=2.2, depth_mean=3.0,
                                 depth_spread=0.8, scale_min=0.015,
                                 scale_max=0.05)
    scene = type(scene)(*(x.to(device) for x in scene))

    def poses(n, seed):
        # orbit at bench.py's pace plus 4 mm / 2 mrad of per-frame jitter
        g = torch.Generator().manual_seed(seed)
        amp = torch.tensor([0.004] * 3 + [0.002] * 3)
        out = []
        for i in range(n):
            T = orbit_pose(i / 400.0, trans_amp=0.8, rot_amp=0.15,
                           device=device)
            jit = (torch.randn(6, generator=g) * amp).to(device)
            out.append(se3.se3_exp(jit) @ T)
        return out

    return intr, cfg, tcfg, scene, poses


def render_frames(torch, scene, poses, intr, cfg, with_depth):
    """Ground-truth frames at ``poses``, and the share of their pixels the
    scene covers (mean opacity of the renders)."""
    from monogs_tpu_torch.render import render
    from monogs_tpu_torch.slam.frame import make_frame_data

    frames, cover = [], 0.0
    for T in poses:
        out = render(scene, T, intr, cfg._replace(with_n_touched=False))
        cover += float(out.opacity.mean())
        frames.append(make_frame_data(
            torch.clamp(out.image, 0.0, 1.0),
            out.depth[0] if with_depth else None, 1.1, 0.01, "tum"))
    return frames, cover / len(poses)


# ----------------------------------------------------------- kernel phase

def pair_counts(torch, bl, d, tx0, ty0, pmat, W, H, row_mask=None):
    """(row, pixel) pairs of each kind that these rows give (kernel_ops):
    ``walked``, each image pixel's rows up to and including the one at which
    it terminates (all of them if it never does; pixels beyond the image
    edge walk none), only rows of ``row_mask`` [T, K] where given;
    ``ok``, walked pairs that pass the alpha test; ``contrib``, ok pairs
    before termination; ``live``, contrib pairs with alpha below its 0.99
    clamp."""
    f = bl._forward_plain(d, tx0, ty0, pmat, W, H)
    kf = d.shape[1]
    term = f["ok"] & ~f["contrib"]                       # [T, K, P]
    stop = torch.where(term.any(1), term.int().argmax(1) + 1, kf)
    pix_ok = ((tx0[:, None] + pmat[3] <= W - 1)
              & (ty0[:, None] + pmat[4] <= H - 1))
    k = torch.arange(kf, device=d.device)[None, :, None]
    walked = (k < stop[:, None, :]) & pix_ok[:, None, :]
    if row_mask is not None:
        walked = walked & row_mask[..., None]
    return dict(walked=int(walked.sum()), ok=int((walked & f["ok"]).sum()),
                contrib=int(f["contrib"].sum()),
                live=int((f["contrib"] & (f["alpha"] < 0.99)).sum()))


def per_column_err(torch, got, want, frac, rtol=1e-3):
    """(max abs error, ok) under |got - want| <= rtol |want| + frac * the
    last-axis column's largest |want|."""
    want = want.float()
    err = torch.abs(got - want)
    scale = torch.amax(torch.abs(want).reshape(-1, want.shape[-1]), 0)
    ok = bool(torch.all(err <= rtol * torch.abs(want) + frac * scale))
    return float(err.max()), ok


# The fused steps' row sums are TF32 products of float32 operands split
# into a TF32 big part and a TF32 remainder (about 2^-22 of a product); a
# single TF32 pass errs by about 2^-11 of a product. Against the plain
# version in float64, a fused step may err by no more than the float32
# plain version does, entry by entry (both make the same alpha and exit
# decisions), plus TF32_SPLIT_FRAC of the column's largest magnitude: the
# split stays far below it, a single pass does not
# (tests/test_torch_blend_lists.py::test_fo_grad_tc_precision).
TF32_SPLIT_FRAC = 2.0 ** -14


def f64_excess(torch, got, plain, plain64):
    """Largest excess of |got - plain64| over |plain - plain64|, over the
    last-axis column's largest |plain64|."""
    excess = (torch.abs(got.double() - plain64)
              - torch.abs(plain.double() - plain64))
    scale = torch.amax(torch.abs(plain64).reshape(-1, plain64.shape[-1]), 0)
    return float(torch.amax(excess.reshape(-1, excess.shape[-1]), 0).div(
        scale.clamp_min(1e-300)).max())


def as_f64(torch, args):
    return tuple(x.double() if torch.is_tensor(x) and x.is_floating_point()
                 else x for x in args)


def outs_err(torch, got, want):
    e_img = float(torch.abs(got[..., :3] - want[..., :3]).max())
    e_dep = float(torch.abs(got[..., 3] - want[..., 3]).max())
    e_acc = float(torch.abs(got[..., 4] - want[..., 4]).max())
    ok = e_img <= 2e-5 and e_dep <= 2e-4 and e_acc <= 2e-5
    return max(e_img, e_dep, e_acc), ok


def record_kernel(torch, entries, name, fn, plain, err, ok, in_bytes,
                  out_bytes, pairs, e_exp, strict=True, plain_reps=20):
    """Time kernel ``name`` (``fn``) and its plain version, compute its
    bound from this run's pairs and bytes, and add its entry. ``name`` may
    carry a shape tag after "@"."""
    from monogs_tpu_torch.utils import roofline

    kind = name.split("@")[0]
    torch.cuda.synchronize()
    check(ok or not strict,
          f"{name}: kernel disagrees with its plain version "
          f"(max abs error {err:.3e}; tolerance {KERNELS[kind][1]})")
    ms = cuda_ms(torch, fn)
    device_ms = kernel_ms(torch, fn)
    plain_ms = cuda_ms(torch, plain, reps=plain_reps, warmup=1)
    b = roofline.kernel_bound(name, pairs, in_bytes + out_bytes, e_exp)
    entries[name] = dict(
        name=name, route="cuda", source=kernel_source(kind),
        replaces=KERNELS[kind][0], launches=0, max_abs_err=err,
        tol=KERNELS[kind][1], ms=ms, device_ms=device_ms, plain_ms=plain_ms,
        bound_ms=b["bound_ms"], bound_by=b["bound_by"],
        library_ms=None, within_tol=ok, pairs=pairs,
        bytes=in_bytes + out_bytes, ops=b["ops"], tc_ops=b["tc_ops"],
        expf_ops=e_exp)
    log(f"{name}: {ms:.4f} ms (device {device_ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms), bound "
        f"{entries[name]['bound_ms']:.4f} ms by "
        f"{entries[name]['bound_by']}, max abs error {err:.3e}")


def tracking_rows(torch, intr, cfg, tcfg, scene, pose):
    """The tracking kernels' inputs at ``pose``: (full-frame rows, tile
    origins, pixel basis, the first-order tile subset (``tcfg``'s
    fraction, drawn from seed 1), its rows, its rows and row tangents for
    jvp8)."""
    from monogs_tpu_torch.render import renderer as rr
    from monogs_tpu_torch.render.renderer import TileLists

    dev = pose.device
    cfg_t = cfg._replace(with_n_touched=False)
    pmat = rr._tile_pmat(cfg, dev)
    tx0, ty0 = rr._tile_origins(intr, cfg, dev)
    with torch.no_grad():
        d_full = rr.frame_rows(scene, pose, intr, cfg_t)[0]
        lists = rr.build_tile_lists(scene, pose, intr, cfg_t,
                                    margin=tcfg.bin_margin)
        n_fine = tx0.shape[0]
        n_sub = max(8, int(n_fine * tcfg.fo_tile_frac) // 8 * 8)
        g = torch.Generator(device=dev).manual_seed(1)
        tsel = torch.randperm(n_fine, generator=g, device=dev)[:n_sub]
        sub = TileLists(idx=lists.idx[tsel], vld=lists.vld[tsel])
        d_sub = rr.tile_rows(scene, pose, intr, cfg_t, sub)
    d_j, d_tan = rr.tile_rows_jvp(scene, pose, intr, cfg_t, sub)
    return d_full, tx0, ty0, pmat, tsel, d_sub, d_j, d_tan


def kernel_phase(torch, intr, cfg, tcfg, scene, pose, frame, e_exp,
                 strict=True, tag="", plain_reps=20):
    """Run each kernel at the main path's shapes against its plain
    version, on rows of ``scene`` binned at ``pose`` and the ground truth
    (image, mask and depth) of ``frame``; returns {name: entry}. Raises if
    a kernel disagrees, unless ``strict`` is false: each entry then says
    whether it held (``within_tol``). ``e_exp``: expf's operations;
    ``tag`` is appended to each entry's name (another ``cfg.tile``)."""
    from monogs_tpu_torch.render import blend_lists as bl
    from monogs_tpu_torch.render import renderer as rr
    from monogs_tpu_torch.utils import roofline

    dev = pose.device
    W, H = intr.width, intr.height
    d_full, tx0, ty0, pmat, tsel, d_sub, d_j, d_tan = tracking_rows(
        torch, intr, cfg, tcfg, scene, pose)
    txs, tys = tx0[tsel], ty0[tsel]
    with torch.no_grad():
        gt = rr.tile_images(frame.gt_image, intr, cfg)[tsel].contiguous()
        mask = rr.tile_images(frame.mapping_mask, intr, cfg)[tsel].contiguous()
        gtd = rr.tile_images(frame.gt_depth, intr, cfg)[tsel].contiguous()
    ea = torch.tensor(1.0, device=dev)
    eb = torch.tensor(0.0, device=dev)
    fo = dict(use_huber=True, delta=tcfg.huber_delta, eps=1e-8)
    log(f"kernel shapes: full d {tuple(d_full.shape)}, subset d "
        f"{tuple(d_sub.shape)}, d_tan {tuple(d_tan.shape)}")

    entries = {}

    def record(name, fn, plain, err, ok, in_bytes, out_bytes, pairs):
        record_kernel(torch, entries, name + tag, fn, plain, err, ok,
                      in_bytes, out_bytes, pairs, e_exp, strict,
                      plain_reps)

    inputs = (tx0, ty0, pmat)
    # 1. forward blend over the whole frame
    pairs_full = pair_counts(torch, bl, d_full, tx0, ty0, pmat, W, H)
    want = bl.blend_lists_plain(d_full, tx0, ty0, pmat, W, H)
    got = bl.blend_lists(d_full, tx0, ty0, pmat, W, H)
    check(bool(torch.equal(got, bl.blend_lists(d_full, tx0, ty0, pmat, W,
                                               H))),
          "fwd: two launches differ")
    err, ok = outs_err(torch, got, want)
    record("fwd", lambda: bl.blend_lists(d_full, tx0, ty0, pmat, W, H),
           lambda: bl.blend_lists_plain(d_full, tx0, ty0, pmat, W, H),
           err, ok, roofline.nbytes(d_full, *inputs), roofline.nbytes(got),
           pairs_full)

    # 2. forward blend with per-row counts
    got, cnt = bl.blend_lists_counts(d_full, tx0, ty0, pmat, W, H)
    again = bl.blend_lists_counts(d_full, tx0, ty0, pmat, W, H)
    check(bool(torch.equal(got, again[0])) and bool(torch.equal(cnt,
                                                                again[1])),
          "fwd_counts: two launches differ")
    del again
    want, want_c = bl.blend_lists_counts_plain(d_full, tx0, ty0, pmat, W, H)
    err, ok = outs_err(torch, got, want)
    ok = ok and bool(torch.equal(cnt, want_c))
    err = max(err, float(torch.abs(cnt - want_c).max()))
    check(float(want_c.sum()) > 0, "fwd_counts: no row touched a pixel")
    record("fwd_counts",
           lambda: bl.blend_lists_counts(d_full, tx0, ty0, pmat, W, H),
           lambda: bl.blend_lists_counts_plain(d_full, tx0, ty0, pmat, W, H),
           err, ok, roofline.nbytes(d_full, *inputs),
           roofline.nbytes(got, cnt), pairs_full)
    del want, want_c, got, cnt

    # 3. fused first-order step, mono and RGB-D
    pairs_sub = pair_counts(torch, bl, d_sub, txs, tys, pmat, W, H)
    sub_in = (txs, tys, pmat, gt, mask)
    for name, gd in (("fo_grad", None), ("fo_grad_rgbd", gtd)):
        args = (d_sub, txs, tys, pmat, gt, mask, ea, eb, W, H)
        dd, ddd, sums = bl.fo_grad_lists(*args, gtd_t=gd, **fo)
        again = bl.fo_grad_lists(*args, gtd_t=gd, **fo)
        check(all(x is None or bool(torch.equal(x, y))
                  for x, y in zip((dd, ddd, sums), again)),
              f"{name}: two launches differ")
        del again
        pdd, pddd, psums = bl.fo_grad_lists_plain(*args, gtd_t=gd, **fo)
        err, ok = per_column_err(torch, dd, pdd, 1e-4)
        e_s = torch.abs(sums - psums)
        ok = ok and bool(torch.all(e_s <= 1e-4 * torch.abs(psums) + 1e-6))
        err = max(err, float(e_s.max()))
        if gd is not None:
            e2, ok2 = per_column_err(torch, ddd, pddd, 1e-4)
            err, ok = max(err, e2), ok and ok2
        dd64, ddd64, _ = bl.fo_grad_lists_plain(
            *as_f64(torch, args), gtd_t=None if gd is None else gd.double(),
            **fo)
        ex = f64_excess(torch, dd, pdd, dd64)
        if gd is not None:
            ex = max(ex, f64_excess(torch, ddd, pddd, ddd64))
        del dd64, ddd64
        ok = ok and ex <= TF32_SPLIT_FRAC
        check(float(psums[:, 0].sum()) > 0, f"{name}: zero residual")
        record(name,
               lambda a=args, g_=gd: bl.fo_grad_lists(*a, gtd_t=g_, **fo),
               lambda a=args, g_=gd: bl.fo_grad_lists_plain(*a, gtd_t=g_,
                                                            **fo),
               err, ok, roofline.nbytes(d_sub, *sub_in, gd) + 8,
               roofline.nbytes(dd, ddd, sums), pairs_sub)
        entries[name + tag]["f64_excess"] = ex
    del dd, ddd, sums, pdd, pddd, psums

    # 4. primal plus six pose tangents
    pairs_j = pair_counts(torch, bl, d_j, txs, tys, pmat, W, H)
    outs, touts = bl.blend_lists_jvp8(d_j, d_tan, txs, tys, pmat, W, H)
    again = bl.blend_lists_jvp8(d_j, d_tan, txs, tys, pmat, W, H)
    check(bool(torch.equal(outs, again[0]))
          and bool(torch.equal(touts, again[1])), "jvp8: two launches differ")
    del again
    p_outs, p_touts = bl.blend_lists_jvp8_plain(d_j, d_tan, txs, tys, pmat,
                                                W, H)
    e1, ok1 = outs_err(torch, outs, p_outs)
    e2, ok2 = per_column_err(torch, touts, p_touts, 2e-4)
    # the tangent sums are fused multiply-adds in another order than the
    # plain version's: held to float64 as the tensor-core sums are
    ex = f64_excess(torch, touts, p_touts, bl.blend_lists_jvp8_plain(
        *as_f64(torch, (d_j, d_tan, txs, tys, pmat)), W, H)[1])
    check(float(torch.abs(p_touts).max()) > 0, "jvp8: zero tangents")
    record("jvp8",
           lambda: bl.blend_lists_jvp8(d_j, d_tan, txs, tys, pmat, W, H),
           lambda: bl.blend_lists_jvp8_plain(d_j, d_tan, txs, tys, pmat,
                                             W, H),
           max(e1, e2), ok1 and ok2 and ex <= TF32_SPLIT_FRAC,
           roofline.nbytes(d_j, d_tan, txs, tys, pmat),
           roofline.nbytes(outs, touts), pairs_j)
    entries["jvp8" + tag]["f64_excess"] = ex
    return entries


def l1_cotangent(torch, outs, gt, W, H):
    """Output cotangents [..., P, 8] of colour refinement's L1 term
    (0.8 |image - gt| over 3 W H values) of the blend outputs ``outs``
    against tiled ground truth ``gt`` [..., P, 3], on a grey background so
    that the acc column carries one too."""
    bg = torch.tensor([0.5, 0.5, 0.5], device=outs.device)
    colors = outs[..., :3] + (1.0 - outs[..., 4:5]) * bg
    g_col = 0.8 / (3 * W * H) * torch.sign(colors - gt)
    return torch.cat([g_col, torch.zeros_like(g_col[..., :1]),
                      -(g_col * bg).sum(-1, keepdim=True),
                      torch.zeros_like(g_col)], dim=-1).contiguous()


def mapping_kernel_phase(torch, intr, cfg, scene, pose, frame, e_exp,
                         with_madd=True, tag="", plain_reps=20, strict=True):
    """The mapping path's kernels against their plain versions: the blend
    VJP over the whole frame with a real colour-refinement cotangent (L1
    of the render against the frame, on a grey background so that the acc
    column carries one too), and the fused mapping step over 320 tiles
    (tile_frac 0.25) and all 1280, mono and RGB-D, plus RGB-D at the
    320x240 / k_fine 256 shapes of configs/synthetic/rgbd.yaml (80 of its
    320 tiles). ``with_madd``: also the step's madd variant (io_batch: all
    tiles, raw rows of the margin lists, whose empty slots hold Gaussian
    0's row) at both shapes, mono and RGB-D, against its plain version
    and bit for bit against the step without madd on the rows
    pre-masked. The VJP and the mapping steps are launched twice and must
    give the same bits, and are held to their plain version in float64
    (``f64_excess``). ``tag`` is appended to each entry's name; ``strict``
    as in kernel_phase."""
    from monogs_tpu_torch.render import Intrinsics
    from monogs_tpu_torch.render import blend_lists as bl
    from monogs_tpu_torch.render import renderer as rr
    from monogs_tpu_torch.render.renderer import TileLists
    from monogs_tpu_torch.utils import roofline

    dev = pose.device
    entries = {}

    def record(name, fn, plain, err, ok, in_bytes, out_bytes, pairs):
        record_kernel(torch, entries, name + tag, fn, plain, err, ok,
                      in_bytes, out_bytes, pairs, e_exp, strict, plain_reps)

    # 1. blend VJP, Tf 1280
    cfg_t = cfg._replace(with_n_touched=False)
    W, H = intr.width, intr.height
    pmat = rr._tile_pmat(cfg, dev)
    tx0, ty0 = rr._tile_origins(intr, cfg, dev)
    with torch.no_grad():
        d = rr.frame_rows(scene, pose, intr, cfg_t)[0]
        outs = bl.blend_lists(d, tx0, ty0, pmat, W, H)
        g_outs = l1_cotangent(torch, outs,
                              rr.tile_images(frame.gt_image, intr, cfg), W,
                              H)
    dd = bl.blend_lists_vjp(d, tx0, ty0, pmat, g_outs, W, H)
    check(bool(torch.equal(dd, bl.blend_lists_vjp(d, tx0, ty0, pmat, g_outs,
                                                  W, H))),
          "bwd: two launches differ")
    want = bl.blend_lists_vjp_plain(d, tx0, ty0, pmat, g_outs, W, H)
    err, ok = per_column_err(torch, dd, want, 1e-4)
    ex = f64_excess(torch, dd, want, bl.blend_lists_vjp_plain(
        *as_f64(torch, (d, tx0, ty0, pmat, g_outs)), W, H))
    ok = ok and ex <= TF32_SPLIT_FRAC
    check(float(torch.abs(want).max()) > 0, "bwd: zero row cotangents")
    record("bwd", lambda: bl.blend_lists_vjp(d, tx0, ty0, pmat, g_outs, W, H),
           lambda: bl.blend_lists_vjp_plain(d, tx0, ty0, pmat, g_outs, W, H),
           err, ok, roofline.nbytes(d, tx0, ty0, pmat, g_outs),
           roofline.nbytes(dd),
           pair_counts(torch, bl, d, tx0, ty0, pmat, W, H))
    entries["bwd" + tag]["f64_excess"] = ex
    del dd, want, outs, g_outs

    # 2. fused mapping step
    def map_grad_case(name, intr_c, cfg_c, n_sub, rgbd, madd=False):
        cfg_c = cfg_c._replace(with_n_touched=False)
        Wc, Hc = intr_c.width, intr_c.height
        pm = rr._tile_pmat(cfg_c, dev)
        txf, tyf = rr._tile_origins(intr_c, cfg_c, dev)
        with torch.no_grad():
            lists = rr.build_tile_lists(scene, pose, intr_c, cfg_c,
                                        margin=4.0)
            g = torch.Generator(device=dev).manual_seed(2)
            ts = torch.randperm(txf.shape[0], generator=g,
                                device=dev)[:n_sub]
            sub = TileLists(idx=lists.idx[ts], vld=lists.vld[ts])
            dm = rr.tile_rows(scene, pose, intr_c, cfg_c, sub)
            if madd:
                prep = rr._preprocess_rows(scene, sub.idx.reshape(-1), pose,
                                           intr_c, cfg_c)
                raw = rr._pack(prep).reshape(dm.shape).contiguous()
                vld = sub.vld & prep.valid.reshape(sub.vld.shape)
                madd_t = torch.where(vld, 0.0, -1e30).to(torch.float32)
                check(not bool(vld.all()), f"{name}: no masked row")
                check(bool(torch.equal(rr._masked_rows(raw, vld), dm)),
                      f"{name}: raw rows do not mask to the rows")
            if (Wc, Hc) == (W, H):
                img, dep, msk = (frame.gt_image, frame.gt_depth,
                                 frame.mapping_mask)
            else:
                # the render at the rows' own pose, offset so that no L1
                # residual sits at 0 (its sign would flip on rounding)
                out = rr.render(scene, pose, intr_c, cfg_c)
                img, dep = out.image + 0.03, out.depth + 0.05
                msk = torch.ones_like(dep)
            gt_t, mask_t, gtd_t = (
                rr.tile_images(x, intr_c, cfg_c)[ts].contiguous()
                for x in (img, msk, dep))
        if not rgbd:
            gtd_t = None
        args = (dm, txf[ts], tyf[ts], pm, gt_t, mask_t,
                torch.tensor(1.0, device=dev), torch.tensor(0.0, device=dev),
                Wc, Hc, True, 0.95 if rgbd else 1.0, 1e-8)
        kw = dict(gtd_t=gtd_t, px_frac=n_sub / txf.shape[0])
        if madd:
            want = bl.map_grad_lists(*args, **kw)
            args = (raw,) + args[1:]
            kw["madd"] = madd_t
        got, sums = bl.map_grad_lists(*args, **kw)
        got2, sums2 = bl.map_grad_lists(*args, **kw)
        check(bool(torch.equal(got, got2)) and bool(torch.equal(sums, sums2)),
              f"{name}: two launches differ")
        del got2, sums2
        pdd, psums = bl.map_grad_lists_plain(*args, **kw)
        err, ok = per_column_err(torch, got, pdd, 1e-4)
        e_s = torch.abs(sums - psums)
        ok = ok and bool(torch.all(e_s <= 1e-4 * torch.abs(psums) + 1e-4))
        kw64 = dict(kw, gtd_t=None if gtd_t is None else gtd_t.double())
        if madd:
            kw64["madd"] = madd_t.double()
        ex = f64_excess(torch, got, pdd, bl.map_grad_lists_plain(
            *as_f64(torch, args), **kw64)[0])
        ok = ok and ex <= TF32_SPLIT_FRAC
        check(float(psums[:, 0].sum()) > 0, f"{name}: zero residual")
        if madd:
            check(bool(torch.equal(got, want[0]))
                  and bool(torch.equal(sums, want[1])),
                  f"{name}: not bit-identical to the step on the rows "
                  f"pre-masked (dd {float(torch.abs(got - want[0]).max())}"
                  f", sums {float(torch.abs(sums - want[1]).max())})")
        record(name, lambda: bl.map_grad_lists(*args, **kw),
               lambda: bl.map_grad_lists_plain(*args, **kw),
               max(err, float(e_s.max())), ok,
               roofline.nbytes(args[0], txf[ts], tyf[ts], pm, gt_t,
                               mask_t, gtd_t, kw.get("madd")) + 8,
               roofline.nbytes(got, sums),
               pair_counts(torch, bl, dm, txf[ts], tyf[ts], pm, Wc, Hc))
        entries[name + tag]["f64_excess"] = ex

    n_fine = tx0.shape[0]
    n_sub = max(8, int(n_fine * 0.25) // 8 * 8)
    for rgbd in (False, True):
        base = "map_grad_rgbd" if rgbd else "map_grad"
        map_grad_case(base, intr, cfg, n_sub, rgbd)
        map_grad_case(f"{base}@all_tiles", intr, cfg, n_fine, rgbd)
    intr_s = Intrinsics(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320,
                        height=240)
    cfg_s = cfg._replace(k_fine=256)
    n_fine_s = rr._tile_origins(intr_s, cfg_s, dev)[0].shape[0]
    map_grad_case("map_grad_rgbd@320x240_kf256", intr_s, cfg_s,
                  max(8, int(n_fine_s * 0.25) // 8 * 8), True)
    if with_madd:
        for rgbd in (False, True):
            base = "map_grad_madd_rgbd" if rgbd else "map_grad_madd"
            map_grad_case(base, intr, cfg, n_fine, rgbd, madd=True)
            map_grad_case(f"{base}@320x240_kf256", intr_s, cfg_s, n_fine_s,
                          rgbd, madd=True)
    return entries


def tile32_kernel_phase(torch, intr, cfg, tcfg, scene, pose, frame, e_exp):
    """The list kernels at 32 px tiles (P 1024: the tensor-core reverse
    walks four pixel slices of 256, jvp8 and the forward blends run 1024
    threads a CTA), on the same scene, pose and frame as the 16 px kernel
    phases and at the same tile fractions: kernel_phase's and
    mapping_kernel_phase's checks, entries tagged "@tile32"."""
    cfg32 = cfg._replace(tile=32)
    entries = kernel_phase(torch, intr, cfg32, tcfg, scene, pose, frame,
                           e_exp, tag="@tile32", plain_reps=3)
    entries.update(mapping_kernel_phase(torch, intr, cfg32, scene, pose,
                                        frame, e_exp, tag="@tile32",
                                        plain_reps=3))
    return entries


def macro_lists(torch, scene, pose, intr, cfg):
    """The render's inputs to the macro-list kernels at ``pose``: (data_m
    [Tm, Km, 16], xy0 [Tm, 2], counts [Tm], pmat [6, P])."""
    from monogs_tpu_torch.render import renderer as rr

    with torch.no_grad():
        _, packed, _, aux = rr._project(scene, pose, intr, cfg)
        data_m, xy0, counts = rr.macro_rows(packed, aux)
        return (data_m.contiguous(), xy0, counts,
                rr._tile_pmat(cfg, pose.device))


def macro_pairs(torch, args, tile, fs, W, H, k_fine=None):
    """kernel_ops' pair counts of a macro-list kernel on these lists: the
    pairs of the rows that enter each fine tile (all of them for the
    masked walk, the first ``k_fine`` for the compact blend), the box tests
    of the valid rows, and the adds of the sum over fine tiles."""
    from monogs_tpu_torch.render import blend_lists as bl
    from monogs_tpu_torch.render import blend_macros as bm

    data_m, xy0, counts, pmat = args
    n_macro, km, _ = data_m.shape
    ft, p = fs * fs, pmat.shape[1]
    tot = dict(walked=0, ok=0, contrib=0, live=0)
    entered = rows_entered = 0
    for sl in bm.macro_chunks(n_macro, ft, k_fine or km, p):
        if k_fine is None:
            d, tx0, ty0 = bm._walk_rows(data_m, xy0, counts, tile, fs, sl)
            sel = (d[..., bl._LOGO] > -1e29).reshape(-1, ft, km)
        else:
            d, idx, vld, tx0, ty0 = bm.compact_chunk(data_m, xy0, counts,
                                                     tile, fs, k_fine, sl)
            sel = torch.zeros(idx.shape[:2] + (km + 1,), dtype=torch.bool,
                              device=d.device).scatter(
                2, torch.where(vld, idx, km), True)[..., :km]
        entered += int(sel.sum())
        rows_entered += int(sel.any(1).sum())
        # rows that do not enter the tile carry LOGO -1e30 and are skipped
        n = pair_counts(torch, bl, d, tx0, ty0, pmat, W, H,
                        row_mask=d[..., bl._LOGO] > -1e29)
        for k in tot:
            tot[k] += n[k]
        del d, sel
    valid = int(torch.clamp(counts, max=km).sum())
    return dict(tot, box_tests=ft * valid, ft_adds=entered - rows_entered)


def macro_cases(torch, intr, cfg, scene, pose, pose2, frame, tile32=False):
    """The macro-list kernels' inputs at the bench shape (640x480, k_macro
    1024, k_fine 96) and at configs/synthetic/rgbd.yaml's (320x240,
    k_macro 4096, k_fine 256), and with ``tile32`` at the bench shape in 32
    px tiles (P 1024, 128 px macros): [(tag, (data_m, xy0, counts, pmat),
    (tile, ft_side, W, H), k_fine, gt)], the lists binned at ``pose`` and
    ``gt`` [Tm, ft, P, 3] the view at ``pose2`` (``frame`` at the bench
    shape, a render at the 320x240 one)."""
    from monogs_tpu_torch.render import Intrinsics
    from monogs_tpu_torch.render import render
    from monogs_tpu_torch.render import renderer as rr

    intr_s = Intrinsics(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320,
                        height=240)
    out = []
    for tag, intr_c, cfg_c, gt_img in (
            ("", intr, cfg, frame.gt_image),
            ("@320x240_km4096_kf256", intr_s,
             cfg._replace(k_macro=4096, k_fine=256), None),
            ("@tile32", intr, cfg._replace(tile=32), frame.gt_image))[
                :3 if tile32 else 2]:
        args = macro_lists(torch, scene, pose, intr_c, cfg_c)
        if gt_img is None:
            with torch.no_grad():
                gt_img = render(scene, pose2, intr_c, cfg_c._replace(
                    with_n_touched=False)).image
        tile, fs = cfg_c.tile, cfg_c.macro_tiles
        gt = rr.tile_images(gt_img, intr_c, cfg_c).reshape(
            args[0].shape[0], fs * fs, tile * tile, 3)
        out.append((tag, args, (tile, fs, intr_c.width, intr_c.height),
                    cfg_c.k_fine, gt))
    return out


def macro_kernel_phase(torch, intr, cfg, scene, pose, pose2, frame, e_exp,
                       tile32=True, strict=True, plain_reps=5):
    """The four macro-list kernels against their plain versions on the
    scene's macro lists at ``pose``, the VJPs with the L1 cotangent of the
    view at ``pose2``, at macro_cases' shapes (``tile32``: also in 32 px
    tiles); each kernel is launched twice and must give the same bits, and
    the VJPs are held to their plain version in float64 (``f64_excess``).
    ``strict`` as in kernel_phase."""
    from monogs_tpu_torch.render import blend_macros as bm
    from monogs_tpu_torch.utils import roofline

    entries = {}
    for tag, args, geo, kf, gt in macro_cases(torch, intr, cfg, scene, pose,
                                              pose2, frame, tile32):
        tile, fs, W, H = geo
        log(f"macro lists{tag}: data_m {tuple(args[0].shape)}, rows "
            f"{int(args[2].sum())}")
        for kind, k_fine, fwd_p, vjp_p, extra in (
                ("macro", None, bm.blend_macros_plain,
                 bm.blend_macros_vjp_plain, ()),
                ("compact", kf, bm.blend_compact_plain,
                 bm.blend_compact_vjp_plain, (kf,))):
            def fwd(k_fine=k_fine):
                return bm.blend_macros(*args, *geo, k_fine=k_fine)

            def vjp(g_outs, k_fine=k_fine):
                return bm.blend_macros_vjp(*args, g_outs, *geo,
                                           k_fine=k_fine)

            pairs = macro_pairs(torch, args, tile, fs, W, H, k_fine)
            outs = fwd()
            check(bool(torch.equal(outs, fwd())),
                  f"{kind}_fwd{tag}: two launches differ")
            err, ok = outs_err(torch, outs, fwd_p(*args, *geo, *extra))
            check(float(outs[..., 4].max()) > 0, f"{kind}_fwd{tag}: empty")
            record_kernel(torch, entries, f"{kind}_fwd{tag}", fwd,
                          lambda: fwd_p(*args, *geo, *extra), err, ok,
                          roofline.nbytes(*args), roofline.nbytes(outs),
                          pairs, e_exp,
                          strict, plain_reps)
            g_outs = l1_cotangent(torch, outs, gt, W, H)
            dd, dd2 = vjp(g_outs), vjp(g_outs)
            want = vjp_p(*args, g_outs, *geo, *extra)
            err, ok = per_column_err(torch, dd, want, 1e-4)
            check(bool(torch.equal(dd, dd2)),
                  f"{kind}_bwd{tag}: two launches differ")
            check(float(torch.abs(want).max()) > 0,
                  f"{kind}_bwd{tag}: zero row cotangents")
            ex = f64_excess(torch, dd, want, vjp_p(
                *as_f64(torch, (*args, g_outs)), *geo, *extra))
            record_kernel(torch, entries, f"{kind}_bwd{tag}",
                          lambda: vjp(g_outs),
                          lambda: vjp_p(*args, g_outs, *geo, *extra), err,
                          ok and ex <= TF32_SPLIT_FRAC,
                          roofline.nbytes(*args, g_outs),
                          roofline.nbytes(dd), pairs, e_exp,
                          strict, plain_reps)
            entries[f"{kind}_bwd{tag}"]["f64_excess"] = ex
            del outs, g_outs, dd, dd2, want
    return entries


# -------------------------------------------------------------- main path

def track_chain(torch, scene, frames, poses, intr, cfg, tcfg, seed0):
    """Track frames[2:] seeded with the previous tracked pose (frames[1]'s
    ground truth first); returns (seconds, results)."""
    from monogs_tpu_torch.slam.tracking import track_frame

    dev = poses[0].device

    def one(i, T_seed):
        gen = torch.Generator(device=dev).manual_seed(seed0 + i)
        return track_frame(scene, frames[i + 1], T_seed, 1.0, 0.0, gen,
                           intr, cfg, tcfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    T_prev, outs = poses[1], []
    for i in range(1, len(frames) - 1):
        r = one(i, T_prev)
        T_prev = r.T
        outs.append(r)
    sync()
    return time.perf_counter() - t0, outs


def chain_metrics(torch, outs, poses, seconds):
    from monogs_tpu_torch.ops import se3

    n = len(outs)
    err = [1000.0 * float(se3.pose_diff(outs[j].T, poses[j + 2])[0])
           for j in range(n)]
    rot = [float(se3.pose_diff(outs[j].T, poses[j + 2])[1]) for j in range(n)]
    hold = [1000.0 * float(se3.pose_diff(poses[j + 1], poses[j + 2])[0])
            for j in range(n)]
    for o in outs:
        check(bool(torch.isfinite(o.T).all()), "non-finite tracked pose")
        check(bool(torch.isfinite(o.image).all()), "non-finite final render")
        check(int(o.n_touched.sum()) > 0, "final render touched nothing")
    return dict(
        frames=n, fps=n / seconds, ms_per_frame=1000.0 * seconds / n,
        err_mm_mean=statistics.fmean(err), err_mm_max=max(err),
        rot_err_rad_mean=statistics.fmean(rot),
        hold_prev_err_mm_mean=statistics.fmean(hold),
        fo_iters_mean=statistics.fmean(o.fo_iters for o in outs),
        so_iters_mean=statistics.fmean(o.so_iters for o in outs),
        host_syncs_per_frame=statistics.fmean(o.host_syncs for o in outs))


def main_path(torch, intr, cfg, tcfg, scene, poses_fn):
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    poses = poses_fn(N_FRAMES + 2, 42)
    # with depth, for the mapping path's RGB-D phase (mono tracking reads
    # no depth)
    frames, cover = render_frames(torch, scene, poses, intr, cfg,
                                  with_depth=True)
    render_s = time.perf_counter() - t0
    # first frame: cuBLAS/cuSOLVER handles and the allocator warm up
    track_chain(torch, scene, frames[:3], poses[:3], intr, cfg, tcfg, 1000)
    secs, outs = track_chain(torch, scene, frames, poses, intr, cfg, tcfg, 0)
    mono = dict(coverage=cover, **chain_metrics(torch, outs, poses, secs))

    poses_d = poses_fn(N_RGBD_FRAMES + 2, 43)
    frames_d, cover_d = render_frames(torch, scene, poses_d, intr, cfg,
                                      with_depth=True)
    secs_d, outs_d = track_chain(torch, scene, frames_d, poses_d, intr, cfg,
                                 tcfg._replace(monocular=False), 0)
    rgbd = dict(coverage=cover_d,
                **chain_metrics(torch, outs_d, poses_d, secs_d))
    torch.cuda.synchronize()
    launches = all_launches()

    for name, m in (("mono", mono), ("rgbd", rgbd)):
        log(f"{name} chain: {json.dumps(m)}")
        check(m["err_mm_mean"] < 0.5 * m["hold_prev_err_mm_mean"],
              f"{name} tracking: mean error {m['err_mm_mean']:.3f} mm is not "
              f"below half of holding the previous pose "
              f"({m['hold_prev_err_mm_mean']:.3f} mm)")
    for name in TRACK_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the tracking path")
    peak = torch.cuda.max_memory_allocated()
    return dict(
        render_frames=len(frames), render_s=render_s, mono=mono, rgbd=rgbd,
        peak_mem_bytes=peak, launches=launches,
        profile=profile_frame(torch, scene, frames, poses, intr, cfg,
                              tcfg)), frames, poses


def profile_frame(torch, scene, frames, poses, intr, cfg, tcfg):
    """Where one tracked mono frame's time goes: ``profiling.trace`` over
    the frame (after the chain, so everything is warm), its summary
    (device time of the kernels by class, launches, the idle share). The
    profiler slows the host, so wall_ms is a profiled frame's."""
    from monogs_tpu_torch.slam.tracking import track_frame
    from monogs_tpu_torch.utils import profiling

    gen = torch.Generator(device=poses[0].device).manual_seed(0)
    with profiling.trace(str(TRACE_DIR / "tracking_frame"),
                         device=poses[0].device) as tr:
        r = track_frame(scene, frames[2], poses[1], 1.0, 0.0, gen, intr, cfg,
                        tcfg)
    return dict(iterations=r.fo_iters + r.so_iters,
                trace=str(Path(tr.path).relative_to(ROOT)),
                file_bytes=Path(tr.path).stat().st_size, **tr.summary)


# ------------------------------------------------------------ mapping path

def count_syncs(torch, fn):
    """Host syncs of ``fn()`` (torch.cuda sync debug mode warns at each,
    with the Python line that caused it): (count, {file:line: count})."""
    import warnings

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    hits = [x for x in w
            if str(x.message).startswith("called a synchronizing")]
    sites = {}
    for x in hits:
        k = f"{Path(x.filename).name}:{x.lineno}"
        sites[k] = sites.get(k, 0) + 1
    return len(hits), sites


def map_window(torch, scene, frames, poses, views=MAP_VIEWS,
               xyz_noise=MAP_XYZ_NOISE):
    """bench.py::bench_mapping's window: the scene in a map of capacity
    2^17 with its positions, SH and opacity logits perturbed from a fixed
    seed, and the first ``views`` frames as the window (pose of views 1-4
    and exposure of views 1-9 optimised). The scene is inserted in
    ``views`` equal parts, part v as keyframe v's Gaussians (kf_id v), so
    that covisibility pruning has Gaussians of the window's newest
    keyframes to judge. The positions are perturbed by ``xyz_noise``
    metres, more than one Adam step of the position learning rate (9.2e-3
    at iteration 190, about 2 px here): from the exact geometry BA's first
    steps move every visible Gaussian by about that and the L1 rises
    (PERF.md, Findings)."""
    from monogs_tpu_torch.models import gaussian_map as gm
    from monogs_tpu_torch.slam.mapping import CamBatch

    dev = scene.xyz.device
    g = torch.Generator(device=dev).manual_seed(11)

    def noise(x, sd):
        return x + sd * torch.randn(x.shape, generator=g, device=dev)

    leaves = gm.ParamLeaves(
        xyz=noise(scene.xyz, xyz_noise), sh=noise(scene.sh, 0.2),
        log_scale=scene.log_scale, quat=scene.quat,
        opa_logit=noise(scene.opa_logit, 0.5))
    m = gm.new_map(MAP_CAP, device=dev)
    b = views
    for v, rows in enumerate(torch.tensor_split(
            torch.arange(scene.xyz.shape[0], device=dev), b)):
        m = gm.insert(m, gm.ParamLeaves(*(x[rows] for x in leaves)),
                      rows.shape[0], kf_id=v)
    f = frames[:b]
    flags = torch.tensor([False] + [True] * (b - 1), device=dev)
    cams = CamBatch(
        gt_image=torch.stack([x.gt_image for x in f]),
        gt_depth=torch.stack([x.gt_depth for x in f]),
        mapping_mask=torch.ones((b, 1) + tuple(f[0].gt_image.shape[1:]),
                                device=dev),
        T=torch.stack(poses[:b]), ea=torch.ones(b, device=dev),
        eb=torch.zeros(b, device=dev),
        valid=torch.ones(b, dtype=torch.bool, device=dev),
        opt_pose=torch.arange(b, device=dev).lt(5) & flags,
        opt_exposure=flags)
    return m, cams


def window_l1(torch, m, cams, intr, cfg, monocular=True, alpha=0.95):
    """The window's mapping loss (mean over views of mapping_loss_rgb[d]
    of a full render at the current poses and exposures, blended on
    ``cfg.backend``). A check, not the mapping path: its renders' launches
    are not counted."""
    from monogs_tpu_torch.ops import losses
    from monogs_tpu_torch.render import render

    counts = all_launches()
    tot = 0.0
    with torch.no_grad():
        for v in range(cams.T.shape[0]):
            out = render(m.render_view(), cams.T[v], intr,
                         cfg._replace(with_n_touched=False))
            if monocular:
                loss = losses.mapping_loss_rgb(
                    out.image, cams.gt_image[v], cams.mapping_mask[v],
                    cams.ea[v], cams.eb[v])
            else:
                loss = losses.mapping_loss_rgbd(
                    out.image, out.depth, cams.gt_image[v], cams.gt_depth[v],
                    cams.mapping_mask[v], cams.ea[v], cams.eb[v], alpha)
            tot += float(loss)
    restore_launches(counts)
    return tot / cams.T.shape[0]


def check_finite_map(torch, m, cams, what):
    for k, x in zip(m.params._fields, m.params):
        check(bool(torch.isfinite(x).all()), f"{what}: non-finite {k}")
    check(bool(torch.isfinite(cams.T).all()), f"{what}: non-finite pose")
    check(bool(torch.isfinite(cams.ea).all() & torch.isfinite(cams.eb).all()),
          f"{what}: non-finite exposure")


def densify_check(torch, m, gen):
    """``densify_and_prune`` on the card with clones and splits, held
    against the same call on the CPU. At 640x480 the reference's threshold
    (2e-4) selects no Gaussian (PERF.md), so this call takes its limits
    from the densification statistics ``m`` gathered: the 98th percentile
    of the seen Gaussians' mean screen-space gradient, and a size limit
    (percent_dense x extent) midway between two neighbouring largest
    scales near the median of those selected, so that about half clone
    and half split and no Gaussian sits on the size limit, where the
    card's and the CPU's exp could round to different sides."""
    from monogs_tpu_torch.models import gaussian_map as gm

    h = gm.MapHyper()
    seen = m.active & (m.denom > 0)
    grads = m.grad_accum / torch.clamp(m.denom, min=1e-12)
    q = torch.quantile(grads[seen], torch.tensor(
        [0.5, 0.98, 1.0], device=grads.device)).tolist()
    hot = seen & (grads >= q[1])
    max_scale = torch.exp(m.params.log_scale).max(-1).values
    s = torch.sort(max_scale[hot]).values
    k = s.shape[0] // 2
    extent = float(0.5 * (s[k - 1] + s[k])) / h.percent_dense
    n_clone = int((hot & (max_scale <= h.percent_dense * extent)).sum())
    n_split = int(hot.sum()) - n_clone
    samples = torch.randn((2, 4096, 3), generator=gen, device=m.active.device)
    args = (q[1], 0.7, extent, 20, h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = gm.densify_and_prune(m, None, *args, samples=samples)
    torch.cuda.synchronize()
    ms = 1000.0 * (time.perf_counter() - t0)
    want = gm.densify_and_prune(m.to("cpu"), None, *args,
                                samples=samples.cpu())
    got = got.to("cpu")
    check(n_clone > 0 and n_split > 0,
          f"densify check: {n_clone} clones, {n_split} splits")
    check(int(got.n_active) > int(m.n_active),
          f"densify check: n_active {int(m.n_active)} -> "
          f"{int(got.n_active)}")
    for k_ in ("active", "kf_id", "n_obs"):
        check(bool(torch.equal(getattr(got, k_), getattr(want, k_))),
              f"densify check: {k_} differs between the card and the CPU")
    for k_, x, y in zip(got.params._fields, got.params, want.params):
        check(bool(torch.allclose(x, y, rtol=1e-5, atol=1e-6)),
              f"densify check: {k_} differs between the card and the CPU "
              f"(max {float(torch.abs(x - y).max()):.3e})")
    return dict(grad_p50=q[0], grad_p98=q[1], grad_max=q[2],
                n_seen=int(seen.sum()), n_clone=n_clone, n_split=n_split,
                n_active_before=int(m.n_active),
                n_active_after=int(got.n_active), ms=ms)


def mapping_path(torch, intr, cfg, scene, frames, poses):
    """Drive the port's mapping on the card (see the module docstring);
    returns (metrics, launches)."""
    from monogs_tpu_torch.models import gaussian_map as gm
    from monogs_tpu_torch.slam import mapping as mp
    from monogs_tpu_torch.utils import profiling

    dev = scene.xyz.device
    hyper = gm.MapHyper()
    mc = mp.MapConfig(monocular=True, window_size=8, pose_window=5,
                      tile_frac=0.25)
    gen = torch.Generator(device=dev).manual_seed(0)
    m0, cams = map_window(torch, scene, frames, poses, views=MAP_VIEWS)

    def run_map(n, it0, mcfg=mc, cams_=cams, init=False):
        torch.cuda.synchronize()
        before = all_launches()
        t0 = time.perf_counter()
        r = mp.map_iters(m0, cams_, n, it0, gen, intr, cfg, mcfg, hyper,
                         initialization=init)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        now = all_launches()
        return secs, r, {k: now[k] - before[k] for k in before}

    # first call: the allocator and library handles warm up
    run_map(1, 100)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = {}

    # 1. mono, tile_frac 0.25, from iteration 190: the 35-iteration run
    # densifies at 200 and rebuilds its lists after it; ms per iteration
    # by bench_mapping's delta method, (t(35) - t(5)) / 30, so the 30
    # timed iterations include that densify and rebuild
    l1_before = window_l1(torch, m0, cams, intr, cfg)
    t_lo, _, n_lo = run_map(5, 190)
    t_hi, ra, n_hi = run_map(35, 190)
    check_finite_map(torch, ra.m, ra.cams, "tile_frac 0.25")
    l1_after = window_l1(torch, ra.m, ra.cams, intr, cfg)
    check(n_lo["map_grad"] + n_hi["map_grad"] == MAP_VIEWS * 40,
          f"map_grad launched {n_lo['map_grad'] + n_hi['map_grad']} times "
          f"in 40 iterations of {MAP_VIEWS} views")
    check(l1_after < MAP_L1_RATIO * l1_before,
          f"mapping L1 {l1_after:.6f} after 35 iterations is not below "
          f"{MAP_L1_RATIO} x {l1_before:.6f} before")
    pose_moved = [float(torch.abs(ra.cams.T[v] - cams.T[v]).max())
                  for v in range(MAP_VIEWS)]
    out["tile_frac_0.25"] = dict(
        ms_per_iter=1000.0 * (t_hi - t_lo) / 30, s_5=t_lo, s_35=t_hi,
        l1_before=l1_before, l1_after=l1_after,
        n_active_before=int(m0.n_active), n_active_after=int(ra.m.n_active),
        it_count=ra.it_count, pose_moved_max=pose_moved)
    # iteration 200's densify, at the reference's limits, selects nothing
    # at 640x480; this one takes its limits from iterations 201-225
    out["densify_check"] = densify_check(torch, ra.m, gen)

    # 2. mono, all tiles: (t(12) - t(2)) / 10, iterations 101-112
    t_lo, _, n_lo = run_map(2, 100, mc._replace(tile_frac=1.0))
    t_hi, rb, n_hi = run_map(12, 100, mc._replace(tile_frac=1.0))
    check_finite_map(torch, rb.m, rb.cams, "tile_frac 1.0")
    check(n_lo["map_grad"] + n_hi["map_grad"] == MAP_VIEWS * 14,
          "map_grad launches at tile_frac 1.0")
    out["tile_frac_1.0"] = dict(ms_per_iter=1000.0 * (t_hi - t_lo) / 10,
                                s_2=t_lo, s_12=t_hi)

    # 3. RGB-D, tile_frac 0.25
    mc_d = mc._replace(monocular=False)
    l1d_before = window_l1(torch, m0, cams, intr, cfg, monocular=False)
    t_d, rd, n_d = run_map(10, 100, mc_d)
    check_finite_map(torch, rd.m, rd.cams, "RGB-D")
    check(n_d["map_grad_rgbd"] == MAP_VIEWS * 10 and n_d["map_grad"] == 0,
          f"RGB-D mapping launches {n_d}")
    out["rgbd"] = dict(
        s_10=t_d, l1_before=l1d_before,
        l1_after=window_l1(torch, rd.m, rd.cams, intr, cfg, monocular=False))

    # 4. initialisation on one view (no pose or exposure optimisation)
    one = type(cams)(*(x[:1] for x in cams))
    t_i, ri, n_i = run_map(5, 0, mc, one, init=True)
    check_finite_map(torch, ri.m, ri.cams, "initialization")
    check(n_i["map_grad"] == 5, f"initialization launches {n_i}")
    check(bool(torch.equal(ri.cams.T, one.T)), "initialization moved a pose")
    out["initialization"] = dict(s_5=t_i)

    # 5. covisibility pruning of the 0.25 run's map (window keyframe ids
    # 0-9: Gaussians of keyframes 7-9 seen by at most 3 views go)
    kf_ids = torch.arange(MAP_VIEWS, device=dev)
    mp_, n_obs = mp.covisibility_prune(ra.m, ra.visibility, kf_ids, True, mc)
    gone = ra.m.active & ~mp_.active
    check(int(mp_.n_active) < int(ra.m.n_active),
          "covisibility pruning removed nothing")
    check(bool(torch.all((ra.m.kf_id[gone] >= MAP_VIEWS - 3)
                         & (n_obs[gone] <= 3))),
          "covisibility pruning removed a Gaussian it should have kept")
    out["covisibility_prune"] = dict(
        n_active_before=int(ra.m.n_active), n_active_after=int(mp_.n_active),
        visible_views_mean=float(n_obs[ra.m.active].float().mean()))

    # 6. colour refinement, 20 iterations over the window's views
    torch.cuda.synchronize()
    before = all_launches()
    t0 = time.perf_counter()
    mr = mp.color_refinement_iters(mp_, cams, 20, gen, intr, cfg, mc, hyper)
    torch.cuda.synchronize()
    t_r = time.perf_counter() - t0
    check_finite_map(torch, mr, cams, "colour refinement")
    n_bwd = all_launches()["bwd"] - before["bwd"]
    check(n_bwd == 20,
          f"bwd launched {n_bwd} times in 20 refinement iterations")
    out["color_refinement"] = dict(ms_per_iter=1000.0 * t_r / 20)
    torch.cuda.synchronize()
    launches = all_launches()
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    for name in MAP_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the mapping path")

    # host syncs of a call for 1 and 3 iterations: the difference is per
    # iteration
    syncs = {n: count_syncs(torch, lambda n=n: run_map(n, 100))
             for n in (1, 3)}
    out["host_syncs"] = dict(call_1=syncs[1][0], call_3=syncs[3][0],
                             per_iter=(syncs[3][0] - syncs[1][0]) / 2,
                             sites=syncs[3][1])

    # one profiled BA iteration (tile_frac 0.25): a 3-iteration call less
    # a 1-iteration call, halved
    prof_ = {}
    for n in (1, 3):
        with profiling.trace(str(TRACE_DIR / f"mapping_{n}"),
                             device=dev) as tr:
            run_map(n, 100)
        prof_[n] = tr
    a, b = prof_[1].summary, prof_[3].summary
    busy = (b["device_busy_ms"] - a["device_busy_ms"]) / 2
    wall = (b["wall_ms"] - a["wall_ms"]) / 2
    out["profile_iteration"] = dict(
        wall_ms=wall, device_busy_ms=busy if busy > 0 else "not measured",
        device_idle_share=max(0.0, 1.0 - busy / wall) if busy > 0
        else "not measured",
        kernel_launches=(b["kernel_launches"] - a["kernel_launches"]) / 2,
        device_ms_by_class={k: (b["device_ms_by_class"][k]
                                - a["device_ms_by_class"][k]) / 2
                            for k in a["device_ms_by_class"]},
        top_3_iter_call=b["top"],
        # the program's spans in the 3-iteration call: device self ms
        spans_3_iter_call={k: r["device_self_s"] * 1e3
                           for k, r in prof_[3].spans.items()})
    return out, launches


# ---------------------------------------------------- macro-backend path

def macro_path(torch, intr, cfg, scene, frames, poses):
    """Drive the unfused mapping branch on the macro-list backends (the
    module docstring's phase 5); returns (metrics, launches)."""
    from monogs_tpu_torch.models import gaussian_map as gm
    from monogs_tpu_torch.render import render
    from monogs_tpu_torch.slam import mapping as mp
    from monogs_tpu_torch.utils import profiling

    dev = scene.xyz.device
    hyper = gm.MapHyper()
    b = MAP_VIEWS
    mc = mp.MapConfig(monocular=True, window_size=8, pose_window=5,
                      bin_margin=0.0)
    cfg_p = cfg._replace(backend="pallas")
    cfg_c = cfg._replace(backend="pallas_compact")
    gen = torch.Generator(device=dev).manual_seed(1)
    m0, cams = map_window(torch, scene, frames, poses, views=b)

    def run_map(n, cfg_, m_=m0, cams_=cams, mcfg=mc):
        torch.cuda.synchronize()
        before = all_launches()
        t0 = time.perf_counter()
        r = mp.map_iters(m_, cams_, n, 100, gen, intr, cfg_, mcfg, hyper)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        now = all_launches()
        return secs, r, {k: now[k] - before[k] for k in now}

    def ms_per_iter(cfg_, m_, cams_, mcfg=mc, n=MACRO_ITERS):
        """(ms per iteration by the delta method, (t(n) - t(0)) / n, the
        n-iteration result, its launches)."""
        t_0, _, _ = run_map(0, cfg_, m_, cams_, mcfg)
        t_n, r, n_l = run_map(n, cfg_, m_, cams_, mcfg)
        return 1000.0 * (t_n - t_0) / n, r, n_l

    # first call: the allocator and library handles warm up
    run_map(1, cfg_p)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = {}

    # 1. one frame on each backend (the compact blend at the XLA path's
    # k_fine equals it up to the log-alpha's rounding; the masked walk
    # has no k_fine cap)
    with torch.no_grad():
        img = {be: render(m0.render_view(), cams.T[1], intr, cfg._replace(
            backend=be, with_n_touched=False)).image
            for be in ("xla", "pallas_compact", "pallas")}
    for be, x in img.items():
        check(bool(torch.isfinite(x).all()) and float(x.max()) > 0,
              f"render on {be}: non-finite or empty")
    diff = torch.abs(img["pallas_compact"] - img["xla"])
    out["render"] = dict(
        compact_vs_xla_max=float(diff.max()),
        compact_vs_xla_share_over_2e5=float((diff > 2e-5).float().mean()),
        walk_vs_compact_mean=float(
            torch.abs(img["pallas"] - img["pallas_compact"]).mean()))
    check(out["render"]["compact_vs_xla_share_over_2e5"] < 1e-3
          and out["render"]["compact_vs_xla_max"] < 1e-2,
          f"pallas_compact and xla renders differ: {out['render']}")

    # 2. BA on the masked walk, then on the compact blend from its result
    l1_0 = window_l1(torch, m0, cams, intr, cfg_p)
    ms_p, ra, n_a = ms_per_iter(cfg_p, m0, cams)
    check_finite_map(torch, ra.m, ra.cams, "BA on pallas")
    l1_a = window_l1(torch, ra.m, ra.cams, intr, cfg_p)
    ms_c, rc, n_c = ms_per_iter(cfg_c, ra.m, ra.cams)
    check_finite_map(torch, rc.m, rc.cams, "BA on pallas_compact")
    l1_c = window_l1(torch, rc.m, rc.cams, intr, cfg_c)
    want = MACRO_ITERS * b
    for name, n_l, keys in (("pallas", n_a, ("macro_fwd", "macro_bwd")),
                            ("pallas_compact", n_c,
                             ("compact_fwd", "compact_bwd"))):
        check(all(n_l[k] == want for k in keys)
              and sum(n_l.values()) == 2 * want,
              f"BA on {name}: launches {n_l}, want {want} of each of {keys}")
    check(l1_a < l1_0, f"BA on pallas: L1 {l1_a:.6f} not below {l1_0:.6f}")
    check(l1_c < MAP_L1_RATIO * l1_0,
          f"BA on pallas then pallas_compact: L1 {l1_c:.6f} after "
          f"{2 * MACRO_ITERS} iterations is not below {MAP_L1_RATIO} x "
          f"{l1_0:.6f}")
    out["ba_pallas"] = dict(ms_per_iter=ms_p, l1_before=l1_0, l1_after=l1_a)
    out["ba_pallas_compact"] = dict(ms_per_iter=ms_c, l1_before=l1_a,
                                    l1_after=l1_c)

    # 3. RGB-D on the masked walk
    mc_d = mc._replace(monocular=False)
    l1d_0 = window_l1(torch, m0, cams, intr, cfg_p, monocular=False)
    t_d, rd, n_d = run_map(5, cfg_p, mcfg=mc_d)
    check_finite_map(torch, rd.m, rd.cams, "RGB-D BA on pallas")
    check(n_d["macro_fwd"] == 5 * b and n_d["macro_bwd"] == 5 * b,
          f"RGB-D BA launches {n_d}")
    l1d = window_l1(torch, rd.m, rd.cams, intr, cfg_p, monocular=False)
    check(l1d < l1d_0, f"RGB-D BA: L1 {l1d:.6f} not below {l1d_0:.6f}")
    out["ba_pallas_rgbd"] = dict(s_5=t_d, l1_before=l1d_0, l1_after=l1d)

    # 4. colour refinement without lists
    torch.cuda.synchronize()
    before = all_launches()
    t0 = time.perf_counter()
    mr = mp.color_refinement_iters(rc.m, cams, MACRO_ITERS, gen, intr, cfg_p,
                                   mc, hyper)
    torch.cuda.synchronize()
    t_r = time.perf_counter() - t0
    check_finite_map(torch, mr, cams, "refinement on pallas")
    now = all_launches()
    n_r = {k: now[k] - before[k] for k in now if now[k] != before[k]}
    check(n_r == {"macro_fwd": MACRO_ITERS, "macro_bwd": MACRO_ITERS},
          f"refinement launches {n_r}")
    out["color_refinement"] = dict(ms_per_iter=1000.0 * t_r / MACRO_ITERS)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()

    # 5. host syncs of a 1- and a 3-iteration call, and one profiled
    # iteration (a 3-iteration call less a 1-iteration call, halved)
    syncs = {n: count_syncs(torch, lambda n=n: run_map(n, cfg_p))
             for n in (1, 3)}
    out["host_syncs"] = dict(per_iter=(syncs[3][0] - syncs[1][0]) / 2,
                             call_1=syncs[1][0], sites=syncs[3][1])
    prof_ = {}
    for n in (1, 3):
        with profiling.trace(str(TRACE_DIR / f"macro_{n}"),
                             device=dev) as tr:
            run_map(n, cfg_p)
        prof_[n] = tr.summary
    p1, p3 = prof_[1], prof_[3]
    busy = (p3["device_busy_ms"] - p1["device_busy_ms"]) / 2
    wall = (p3["wall_ms"] - p1["wall_ms"]) / 2
    out["profile_iteration"] = dict(
        wall_ms=wall, device_busy_ms=busy if busy > 0 else "not measured",
        device_idle_share=max(0.0, 1.0 - busy / wall) if busy > 0
        else "not measured",
        kernel_launches=(p3["kernel_launches"] - p1["kernel_launches"]) / 2,
        device_ms_by_class={k: (p3["device_ms_by_class"][k]
                                - p1["device_ms_by_class"][k]) / 2
                            for k in p1["device_ms_by_class"]},
        top_3_iter_call=p3["top"])
    torch.cuda.synchronize()
    launches = all_launches()
    for name in MACRO_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the macro-backend path")
    return out, launches


# ---------------------------------------------- BA reproducibility path

def state_tensors(r):
    """{name: tensor} of a map_iters result: every tensor of the map (its
    parameters, Adam moments, densification statistics and slots), the
    window's poses and exposures, its Adam state and the visibility."""
    out = {}

    def walk(prefix, x):
        if hasattr(x, "_fields"):
            for k in x._fields:
                walk(f"{prefix}.{k}", getattr(x, k))
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                walk(f"{prefix}[{i}]", v)
        elif hasattr(x, "shape"):
            out[prefix] = x

    walk("m", r.m)
    walk("cams", r.cams)
    walk("kf_adam", r.kf_adam)
    out["visibility"] = r.visibility
    return out


def ba_repro_path(torch, intr, cfg, scene, frames, poses, strict=True):
    """One BA iteration run three times from one saved state (the mapping
    path's window, iteration 101, the same generator seed) on the default
    fused branch at tile_frac 1.0 and 0.25 and on each A/B knob (io_batch,
    scatter_segsum, gather_first at 0.25, batch_render): every tensor of
    the map and of the window's cameras must come out bit for bit the same
    (``state_tensors``), unless ``strict`` is false. Also the ms of one
    iteration (median of the three runs)."""
    from monogs_tpu_torch.models import gaussian_map as gm
    from monogs_tpu_torch.slam import mapping as mp

    dev = scene.xyz.device
    hyper = gm.MapHyper()
    mc = mp.MapConfig(monocular=True, window_size=8, pose_window=5)
    m0, cams = map_window(torch, scene, frames, poses, views=MAP_VIEWS)
    branches = {
        "default": mc,
        "default_tile_frac_0.25": mc._replace(tile_frac=0.25),
        "io_batch": mc._replace(io_batch=True),
        "scatter_segsum": mc._replace(scatter_segsum=True),
        "gather_first": mc._replace(gather_first=True, tile_frac=0.25),
        "batch_render": mc._replace(batch_render=True, fused_grad=False),
    }

    def one(mcfg):
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = mp.map_iters(m0, cams, 1, 100, gen, intr, cfg, mcfg, hyper)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, state_tensors(r)

    out = {}
    for name, mcfg in branches.items():
        one(mcfg)                                  # warm-up
        runs = [one(mcfg) for _ in range(3)]
        ref = runs[0][1]
        differ = sorted({k for _, st in runs[1:] for k, x in st.items()
                         if not bool(torch.equal(x, ref[k]))})
        out[name] = dict(
            bit_identical=not differ, differing=differ,
            max_abs_diff={k: max(float(torch.abs(
                st[k].double() - ref[k].double()).max())
                for _, st in runs[1:]) for k in differ},
            ms_per_iter=1000.0 * statistics.median(t for t, _ in runs))
        log(f"ba repro {name}: {json.dumps(out[name])}")
    bad = [k for k, v in out.items() if not v["bit_identical"]]
    check(not strict or not bad,
          f"BA iterations from one state differ on {bad}: "
          f"{ {k: out[k]['differing'] for k in bad} }")
    return out


# ------------------------------------------------------------ full SLAM

# configs/synthetic/*.yaml cut in depth only: widths (320x240, the
# 8192-Gaussian scene, k_fine 256, track_k_fine 128, capacity 65,536,
# insert cap 16,384, mapping_tile_frac 0.25) and the tracking budgets as
# shipped, fewer init / mapping / refinement iterations, 16 frames. Two
# cuts of the sequence: "orbit16", scripts/verify_e2e.py's (a 16-frame
# orbit, its amplitudes scaled down with the frame count to keep the
# per-frame motion: the orbit spans the sequence whatever its length, so
# its views overlap by more than kf_overlap and no keyframe fires after
# the first), and "first16", the stock 64-frame sequence's first 16
# frames (the stock run's own motion, a quarter of its orbit). The ATE
# bound, 0.05 m, is scripts/verify_e2e.py's and test_slam_e2e.py's.
SLAM_FRAMES = 16
SLAM_ORBIT16 = dict(n_frames=16, trans_amp=0.0625, rot_amp=0.015)
SLAM_ITERS = dict(init_itr_num=120, mapping_itr_num=30, refinement_itr=100)
# files_path's runs refine twice as long: at 100 steps Replica's PSNR after
# refinement fell below the PSNR before it (25.13 against 25.80 dB)
FILES_ITERS = dict(SLAM_ITERS, refinement_itr=200)
# (name, config, cut, ATE bound or None): the threaded mode on "first16"
# (the stock motion, 25 mm a frame, with 30 BA iterations a keyframe)
# drifts past the bound (PERF.md §6) and is run to record it
SLAM_RUNS = (("rgbd", "rgbd.yaml", "orbit16", 0.05),
             ("rgbd_first16", "rgbd.yaml", "first16", 0.05),
             ("mono", "mono.yaml", "first16", None),
             ("threaded", "rgbd_threaded.yaml", "orbit16", 0.05),
             ("threaded_first16", "rgbd_threaded.yaml", "first16", None))
# the list kernels a SLAM run on "pallas_lists" launches: #1, #2, #3 (mono
# and RGB-D), #4, #5 (colour refinement), #6 (mono and RGB-D)
SLAM_KERNELS = ("fwd", "fwd_counts", "fo_grad", "fo_grad_rgbd", "jvp8",
                "bwd", "map_grad", "map_grad_rgbd")


def slam_config(name, cut):
    """A config of configs/synthetic/ with the depth cut and --eval."""
    from monogs_tpu_torch.slam.config import load_config

    cfg = load_config(str(ROOT / "configs" / "synthetic" / name))
    if cut == "orbit16":
        cfg["Dataset"]["synthetic"].update(SLAM_ORBIT16)
    cfg["Training"].update(SLAM_ITERS)
    cfg["Results"].update(save_results=True, use_gui=False,
                          eval_rendering=True)
    return cfg


class FirstFrames:
    """The first ``n`` frames of a dataset."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        if idx >= self.n:
            raise IndexError(idx)
        return self.ds[idx]


def slam_run(torch, name, file, cut, cfg, device, slams=None,
             dist_backend=None):
    """One SLAM run through ``SLAM(config).run()`` with its metrics; the
    ``SLAM`` is appended to ``slams`` (when given) before it runs."""
    from monogs_tpu_torch.data import load_dataset
    from monogs_tpu_torch.slam import backend
    from monogs_tpu_torch.slam.runtime import SLAM

    prunes = []
    prune = backend.covisibility_prune

    def counted_prune(*args, **kw):
        prunes.append(1)
        return prune(*args, **kw)

    save_dir = ROOT / "build" / "slam_smoke" / name
    save_dir.mkdir(parents=True, exist_ok=True)
    ds = FirstFrames(load_dataset(cfg, device=device), SLAM_FRAMES)
    slam = SLAM(cfg, dataset=ds, save_dir=str(save_dir), device=device,
                dist_backend=dist_backend)
    if slams is not None:
        slams.append(slam)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    backend.covisibility_prune = counted_prune
    t0 = time.perf_counter()
    try:
        res = slam.run()
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        backend.covisibility_prune = prune
    seconds = time.perf_counter() - t0
    launches = all_launches()
    fe = slam.frontend
    stages = res["stages"]
    track_s, track_n = stages["tracking"]
    out = dict(
        config=f"configs/synthetic/{file}", cut=cut,
        n_frames=res["n_frames"], fps=res["fps"], seconds=seconds,
        ate=res["ate"], before=res["before"], after=res["after"],
        n_active=int(slam.backend.gaussians.n_active),
        kf_indices=fe.kf_indices, window=fe.current_window,
        tracking_ms_per_frame=1000.0 * track_s / max(track_n, 1),
        stages=stages, covisibility_prunes=len(prunes),
        n_pipelined=fe.n_pipelined, pending_drained=fe._pending is None,
        peak_mem_bytes=(torch.cuda.max_memory_allocated()
                        if device == "cuda" else None),
        launches={k: v for k, v in launches.items() if v})
    poses_ok = all(bool(torch.isfinite(f.T).all())
                   for f in fe.cameras.values())
    poses = {i: f.T.detach().clone() for i, f in fe.cameras.items()}
    return out, launches, poses_ok, poses


def slam_path(torch, smi, device="cuda"):
    """Full SLAM through the port's entry point, --eval semantics: the
    trimmed configs/synthetic/rgbd.yaml (single_thread) on both cuts,
    mono.yaml on "first16" (window_size 5: fewer frames fill it, so the
    covisibility prune runs), rgbd_threaded.yaml on both cuts. Each run
    prints one JSON line; its launch counters are zeroed just before it
    and read just after. Returns the launches summed over the runs and the
    poses of the "rgbd" run (``diag_path`` repeats it with the GUI)."""
    total, rgbd_poses = {}, None
    for name, file, cut, ate_bound in SLAM_RUNS:
        cfg = slam_config(file, cut)
        if name == "mono":
            cfg["Training"]["window_size"] = 5
        out, launches, poses_ok, poses = slam_run(torch, name, file, cut,
                                                  cfg, device)
        if name == "rgbd":
            rgbd_poses = poses
        out["device"] = smi
        print(json.dumps({f"slam_{name}": out}, default=float), flush=True)
        log(f"slam {name}: {out['fps']:.3f} fps, ATE {out['ate']}, "
            f"keyframes {out['kf_indices']}, "
            f"{out['tracking_ms_per_frame']:.1f} ms a frame tracking")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        check(out["n_frames"] == SLAM_FRAMES and poses_ok,
              f"slam {name}: {out['n_frames']} frames, finite poses "
              f"{poses_ok}")
        check(out["after"]["mean_psnr"] >= out["before"]["mean_psnr"],
              f"slam {name}: PSNR after refinement "
              f"{out['after']['mean_psnr']} below before "
              f"{out['before']['mean_psnr']}")
        if cut == "first16":
            check(len(out["kf_indices"]) >= 2,
                  f"slam {name}: keyframes {out['kf_indices']}")
        if name == "mono":
            check(out["n_active"] > 200, f"slam mono: n_active "
                  f"{out['n_active']}")
            check(out["covisibility_prunes"] > 0,
                  "slam mono: the covisibility prune never ran")
            need = ("fo_grad", "map_grad")
        else:
            need = ("fwd", "fwd_counts", "fo_grad_rgbd", "jvp8", "bwd",
                    "map_grad_rgbd")
        check(ate_bound is None or out["ate"] < ate_bound,
              f"slam {name}: ATE {out['ate']} m >= {ate_bound}")
        if name.startswith("threaded"):
            check(out["n_pipelined"] >= 1 and out["pending_drained"],
                  f"slam threaded: n_pipelined {out['n_pipelined']}, "
                  f"drained {out['pending_drained']}")
        missing = [k for k in need if not launches.get(k)]
        check(device != "cuda" or not missing,
              f"slam {name}: kernels {missing} never launched")
    missing = [k for k in SLAM_KERNELS if not total.get(k)]
    check(device != "cuda" or not missing,
          f"slam path: kernels {missing} never launched")
    return total, rgbd_poses


# --------------------------------------------------------- parallel path

PAR_ITERS = 4           # BA iterations of each check: below every trigger
PAR_IT0 = 100           # iterations 101-104: no densify, reset or rebuild
PAR_DENSIFY = (190, 10, 20)   # from iteration 190: 10 iterations up to the
#                               densify at 200, then 20 more
PAR_RANKS = 4           # one gloo group serves the 2-rank and 2 x 2 checks
# the checks' macro-list cap: the sharded merge selects exactly the
# single-device lists' rows only where no macro list is cut at k_macro
# (parallel/gauss.py); at the bench's 1024 most of the window's macro tiles
# are, and a shard then keeps rows that the single-device binning dropped
PAR_K_MACRO = 4096
PAR_SHAPES = ((2, 1), (1, 2), (2, 2))     # (view, gauss)
# the sharded loops' kernels, on every rank: #2 (the final visibility's
# counts) and #6 (the fused mapping step)
PAR_KERNELS = ("fwd_counts", "map_grad")
PAR_SLAM = (("rgbd_view2", {"n_devices": 2}),
            ("rgbd_gauss2", {"gauss_devices": 2}))


def par_diff(torch, ref, out):
    """{name: (max |a - b|, max |a - b| / |b|, entries over the tolerance)}
    of two map_iters results, with the JAX tests' tolerances
    (``tests/test_gauss_iters.py::_check``: poses rtol 1e-5 atol 1e-6,
    exposures rtol 1e-5 atol 1e-7, parameters rtol 2e-3 atol 2e-4,
    visibility equal). The window Adam moments are reported, not held:
    at 640x480 a parameter moved by a rounding difference moves some of
    300k L1 residuals across 0, whose signs flip, and a pose gradient with
    them by up to 0.3 % (c4); the poses that the moments drive are held,
    and the CPU tests hold the moments to ``tests/test_multichip.py``'s
    atol 1e-6 at its size."""
    tol = dict(T=(1e-5, 1e-6), ea=(1e-5, 1e-7), eb=(1e-5, 1e-7))
    pairs = {f"cams.{k}": (getattr(out.cams, k), getattr(ref.cams, k),
                           tol[k]) for k in tol}
    for k in ref.m.params._fields:
        pairs[f"m.params.{k}"] = (getattr(out.m.params, k),
                                  getattr(ref.m.params, k), (2e-3, 2e-4))
    for i in range(2):
        pairs[f"kf_adam[{i}]"] = (out.kf_adam[i], ref.kf_adam[i], None)
    res = {}
    for name, (a, b, tol_) in pairs.items():
        d = torch.abs(a.float() - b.float())
        rel = d / torch.clamp(torch.abs(b.float()), min=1e-30)
        res[name] = (float(d.max()), float(rel.max()), 0 if tol_ is None
                     else int((d > tol_[1] + tol_[0] * torch.abs(
                         b.float())).sum()))
    res["visibility"] = (0.0, 0.0, int((out.visibility
                                        != ref.visibility).sum()))
    res["n_active"] = (0.0, 0.0, abs(int(out.m.n_active)
                                     - int(ref.m.n_active)))
    return res


def par_check(torch, what, ref, out):
    d = par_diff(torch, ref, out)
    bad = {k: v for k, v in d.items() if v[2]}
    check(not bad, f"parallel {what}: outside the tolerances (max abs, "
          f"max rel, entries over): {bad}")
    return {k: v[:2] for k, v in d.items()}


def same_bits(torch, a, b):
    sa, sb = state_tensors(a), state_tensors(b)
    return sorted(k for k in sa if not torch.equal(sa[k], sb[k]))


def rank_launches(rg):
    """[{kernel: launches}] of every rank of ``rg`` and their peak memory."""
    reps = rg.launches()
    return ([{k: v for k, v in r["launches"].items() if v} for r in reps],
            [r["max_memory_allocated"] for r in reps])


def parallel_path(torch, intr, cfg, scene, frames, poses, smi,
                  device="cuda"):
    """Sharded mapping (``parallel/``) on the one card, at the mapping
    path's width: the 100k-Gaussian scene in a 2^17 map, the B = 10
    window. (a) NCCL, one rank on cuda:0: ``sharded_map_iters`` with the
    bits of ``map_iters`` from the same state, ``gp_sharded_map_iters``
    within the JAX tests' tolerances (bits reported); (b) gloo, 2 ranks
    sharing the card: view 2 and gauss 2; (c) gloo, the 2 x 2 ("view",
    "gauss") mesh; each 4 iterations below every trigger against
    ``map_iters``; (d) 30 iterations at tile_frac 0.25 on gauss 2 across
    the densify at iteration 200, held to the properties of
    ``test_gauss_iters.py``'s densify test. Then ``slam_path``'s "rgbd"
    first16 run through ``SLAM(config, dist_backend="gloo").run()`` with
    ``Parallel.n_devices: 2`` and with ``gauss_devices: 2``, and the
    4-rank NCCL config on the one card raising. Kernels #2 and #6 must
    launch on every rank of every sharded run. Returns (metrics, the
    launches summed over every rank and run)."""
    from monogs_tpu_torch.models import gaussian_map as gm
    from monogs_tpu_torch.parallel.gauss import make_gauss_mesh
    from monogs_tpu_torch.parallel.gauss_iters import gp_sharded_map_iters
    from monogs_tpu_torch.parallel.launch import RankGroup
    from monogs_tpu_torch.slam import mapping as mp
    from monogs_tpu_torch.slam.config import load_config
    from monogs_tpu_torch.slam.runtime import SLAM

    from monogs_tpu_torch.render import build_tile_lists

    t_phase = time.perf_counter()
    hyper = gm.MapHyper()
    mc = mp.MapConfig(monocular=True, window_size=8, pose_window=5,
                      tile_frac=1.0)
    m0, cams = map_window(torch, scene, frames, poses, views=MAP_VIEWS)
    out, total = {}, {}
    bench_cfg, cfg = cfg, cfg._replace(k_macro=PAR_K_MACRO)
    # macro lists of the window's first view that the cap cuts
    out["macro_lists_at_cap"] = {
        c.k_macro: int((build_tile_lists(
            m0.render_view(), cams.T[0], intr, c, margin=mc.bin_margin,
            with_aux=True)[1].vld_m.sum(1) >= c.k_macro).sum())
        for c in (bench_cfg, cfg)}

    def add(launches):
        for r in launches:
            for k, v in r.items():
                total[k] = total.get(k, 0) + v

    def need_kernels(what, launches):
        for r, ln in enumerate(launches):
            # the RGB-D runs launch #6's RGB-D variant
            miss = [k for k in PAR_KERNELS
                    if not ln.get(k) and not ln.get(k + "_rgbd")]
            check(device != "cuda" or not miss,
                  f"parallel {what}: rank {r} never launched {miss}")

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    reset_launches()
    ref = mp.map_iters(m0, cams, PAR_ITERS, PAR_IT0, None, intr, cfg, mc,
                       hyper)
    sync()
    reset_launches()

    # (a) NCCL, one rank
    t0 = time.perf_counter()
    with RankGroup(1, "nccl" if device == "cuda" else "gloo", device) as rg:
        t1 = time.perf_counter()
        va = rg.map_iters((1, 1), m0, cams, PAR_ITERS, PAR_IT0, None, intr,
                          cfg, mc, hyper)
        sync()
        t_view = time.perf_counter() - t1
        t1 = time.perf_counter()
        ga = gp_sharded_map_iters(m0, cams, PAR_ITERS, PAR_IT0, None,
                                  make_gauss_mesh(1), intr, cfg, mc, hyper)
        sync()
        t_gauss = time.perf_counter() - t1
        ln_a, mem_a = rank_launches(rg)
    differ = same_bits(torch, va, ref)
    check(not differ, f"parallel (a): the 1-rank view-sharded run differs "
          f"from map_iters in {differ}")
    gdiff = same_bits(torch, ga, ref)
    out["a_nccl_1rank"] = dict(
        seconds=time.perf_counter() - t0, view_s=t_view, gauss_s=t_gauss,
        view_same_bits=True, gauss_same_bits=not gdiff,
        gauss_differs_in=gdiff, gauss_max_diff=par_check(torch, "(a) gauss",
                                                         ref, ga),
        launches=ln_a, max_memory_allocated=mem_a)
    need_kernels("(a)", ln_a)
    add(ln_a)

    # (b), (c), (d): one gloo group of 4 ranks on the card
    t0 = time.perf_counter()
    with RankGroup(PAR_RANKS, "gloo", device) as rg:
        out["gloo_start_s"] = time.perf_counter() - t0
        for shape in PAR_SHAPES:
            rg.reset_launches()
            t1 = time.perf_counter()
            r = rg.map_iters(shape, m0, cams, PAR_ITERS, PAR_IT0, None, intr,
                             cfg, mc, hyper)
            sync()
            secs = time.perf_counter() - t1
            ln, mem = rank_launches(rg)
            name = f"{'b' if 1 in shape else 'c'}_gloo_{shape[0]}x{shape[1]}"
            out[name] = dict(seconds=secs, s_per_iter=secs / PAR_ITERS,
                             max_diff=par_check(torch, name, ref, r),
                             launches=ln[:shape[0] * shape[1]],
                             max_memory_allocated=mem)
            need_kernels(name, ln[:shape[0] * shape[1]])
            add(ln)

        # the bench's k_macro, reported: the sharded lists keep rows that
        # the single-device macro lists cut
        ref_b = mp.map_iters(m0, cams, PAR_ITERS, PAR_IT0, None, intr,
                             bench_cfg, mc, hyper)
        r = rg.map_iters((1, 2), m0, cams, PAR_ITERS, PAR_IT0, None, intr,
                         bench_cfg, mc, hyper)
        out["gloo_1x2_k_macro_1024"] = {
            k: v for k, v in par_diff(torch, ref_b, r).items()}

        # (d) across the densify at iteration 200, on gauss 2
        it0, n1, n2 = PAR_DENSIFY
        mcd = mc._replace(tile_frac=0.25)
        gen = torch.Generator(device=device).manual_seed(3)
        l1_before = window_l1(torch, m0, cams, intr, cfg)
        rg.reset_launches()
        t1 = time.perf_counter()
        r1 = rg.map_iters((1, 2), m0, cams, n1, it0, gen, intr, cfg, mcd,
                          hyper)
        sync()
        stats_reset = (float(torch.abs(r1.m.grad_accum).max()) == 0.0
                       and float(torch.abs(r1.m.denom).max()) == 0.0)
        r2 = rg.map_iters((1, 2), r1.m, r1.cams, n2, r1.it_count, gen, intr,
                          cfg, mcd, hyper, kf_adam=r1.kf_adam)
        sync()
        secs = time.perf_counter() - t1
        ln, mem = rank_launches(rg)
        l1_after = window_l1(torch, r2.m, r2.cams, intr, cfg)
        check_finite_map(torch, r2.m, r2.cams, "parallel (d)")
        finite = all(bool(torch.isfinite(x).all()) for x in (
            r2.m.grad_accum, r2.m.denom, r2.kf_adam[0], r2.kf_adam[1]))
        n_act = int(r2.m.n_active)
        check(finite and 0 < n_act <= r2.m.capacity,
              f"parallel (d): finite {finite}, n_active {n_act}")
        check(stats_reset, "parallel (d): the densification statistics were "
              "not reset at the densify of iteration 200")
        check(r2.it_count == it0 + n1 + n2, f"parallel (d): it_count "
              f"{r2.it_count}")
        check(l1_after < l1_before, f"parallel (d): window L1 {l1_after:.6f}"
              f" not below {l1_before:.6f} at the start")
        out["d_gloo_gauss2_densify"] = dict(
            seconds=secs, s_per_iter=secs / (n1 + n2), l1_before=l1_before,
            l1_after=l1_after, n_active_before=int(m0.n_active),
            n_active_after=n_act, stats_reset_at_densify=stats_reset,
            visible=int(r2.visibility.sum()), launches=ln[:2],
            max_memory_allocated=mem)
        need_kernels("(d)", ln[:2])
        add(ln)

    # the SLAM runs: slam_path's "rgbd" on first16, 2 ranks sharing the card
    for name, par in PAR_SLAM:
        cfg_s = slam_config("rgbd.yaml", "first16")
        cfg_s["Parallel"] = par
        slams = []
        res, launches, poses_ok, _ = slam_run(
            torch, name, "rgbd.yaml", "first16", cfg_s, device, slams=slams,
            dist_backend="gloo")
        fin = slams[0].ranks.final_launches
        ln = [{k: v for k, v in r["launches"].items() if v} for r in fin]
        res["rank_launches"] = ln
        res["rank_max_memory_allocated"] = [r["max_memory_allocated"]
                                            for r in fin]
        res["device"] = smi
        print(json.dumps({f"slam_{name}": res}, default=float), flush=True)
        log(f"slam {name}: {res['fps']:.3f} fps, ATE {res['ate']}, "
            f"keyframes {res['kf_indices']}")
        check(res["n_frames"] == SLAM_FRAMES and poses_ok,
              f"slam {name}: {res['n_frames']} frames, finite {poses_ok}")
        check(res["ate"] < 0.05, f"slam {name}: ATE {res['ate']} m >= 0.05")
        check(len(res["kf_indices"]) >= 2,
              f"slam {name}: keyframes {res['kf_indices']}")
        check(res["after"]["mean_psnr"] >= res["before"]["mean_psnr"],
              f"slam {name}: PSNR after refinement below before")
        need_kernels(f"slam {name}", ln)
        add(ln[1:])
        add([launches])
        out[f"slam_{name}"] = dict(fps=res["fps"], ate=res["ate"],
                                   kf_indices=res["kf_indices"],
                                   seconds=res["seconds"])

    # four ranks on NCCL with one card: refused, naming both counts
    multi = load_config(str(ROOT / "configs" / "synthetic"
                            / "rgbd_multichip.yaml"))
    try:
        SLAM(multi, device=device, dist_backend="nccl")
        raised = None
    except (RuntimeError, ValueError) as e:
        raised = str(e)
    n_cards = torch.cuda.device_count() if device == "cuda" else 0
    check(device != "cuda" or n_cards >= 4 or (
        raised is not None and "4 ranks" in raised
        and f"{n_cards} card" in raised),
          f"parallel: 4 NCCL ranks on {n_cards} card(s) gave {raised!r}")
    out["nccl_4_ranks_on_one_card"] = raised
    out["seconds"] = time.perf_counter() - t_phase
    out["device"] = smi
    return out, total


# ------------------------------------------------------------- diag path

DIAG_STAGE_REPS = 5      # rounds of the seven stages; the least is kept
DIAG_POOL_ITERS = 4      # pool_vs_fresh_sampling: BA iterations each way
# tracking's kernels on a frame cut at each stage, the experiments'
# (the reverse pass through the render, BA), the GUI's view
DIAG_KERNELS = ("fwd", "fwd_counts", "fo_grad", "jvp8", "bwd", "map_grad")


def launch_delta(before):
    now = all_launches()
    return {k: now[k] - before[k] for k in now if now[k] - before[k]}


def diag_stages(torch, scene, frame, T_seed, intr, cfg, tcfg):
    """(a) one frame cut at each of track_frame's stages, checked as the
    CPU test checks them (tests/test_torch_profiling.py), each stage's
    time (synchronised at the cut) and the consecutive deltas. The stages
    run in DIAG_STAGE_REPS rounds, each round all seven in turn, so that a
    drift of the host's speed reaches every stage alike; the least time of
    each stage is its attribution (the host's noise only adds time), the
    median is kept beside it."""
    from monogs_tpu_torch.slam.tracking import STAGES, track_frame

    dev = T_seed.device
    res, times = {}, {stage: [] for stage in STAGES}
    for _ in range(DIAG_STAGE_REPS):
        for stage in STAGES:
            gen = torch.Generator(device=dev).manual_seed(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[stage] = track_frame(scene, frame, T_seed, 1.0, 0.0, gen,
                                     intr, cfg, tcfg._replace(stage=stage))
            torch.cuda.synchronize()
            times[stage].append(1000.0 * (time.perf_counter() - t0))
    ms = {stage: min(t) for stage, t in times.items()}
    full = res["full"]
    for stage in ("build", "lists"):
        check(bool(torch.equal(res[stage].T, T_seed))
              and math.isfinite(float(res[stage].last_l1))
              and res[stage].host_syncs == 1,
              f"stage {stage}: not the seed pose with one sync")
    check(res["fo"].fo_iters == full.fo_iters and res["fo"].so_iters == 0
          and res["so_prep"].fo_iters == full.fo_iters
          and res["so_prep"].so_iters == 0
          and math.isfinite(float(res["so_prep"].last_l1))
          and res["so"].so_iters == full.so_iters,
          "stage iteration counts: " + ", ".join(
              f"{k} {r.fo_iters}/{r.so_iters}" for k, r in res.items()))
    fnc = res["final_nc"]
    t_err = float(torch.abs(fnc.T - full.T).max())
    img_err = float(torch.abs(fnc.image - full.image).max())
    check(t_err <= 1e-6 and img_err <= 1e-5
          and int(full.n_touched.sum()) > 0
          and int(fnc.n_touched.sum()) == 0,
          f"final_nc against full: pose {t_err}, image {img_err}, counts "
          f"{int(full.n_touched.sum())} / {int(fnc.n_touched.sum())}")
    names = list(STAGES)
    delta = {names[0]: ms[names[0]]}
    delta.update({b: ms[b] - ms[a] for a, b in zip(names, names[1:])})
    return dict(ms=ms, delta_ms=delta, reps=DIAG_STAGE_REPS,
                median_ms={k: statistics.median(t) for k, t in times.items()},
                fo_iters=full.fo_iters, so_iters=full.so_iters,
                host_syncs=full.host_syncs,
                final_nc_pose_err=t_err, final_nc_image_err=img_err)


def diag_roofline(torch, intr, cfg, tcfg, scene, frames, poses, entries):
    """(c) program_cost and classify of one tracked frame and of one BA
    iteration (the mapping path's window at tile_frac 0.25; a 3-iteration
    call less a 1-iteration call, halved, for both the cost and the time).
    The kernels' operations and bytes per launch are their kernel-phase
    entries' at the main path's shapes."""
    from monogs_tpu_torch.models import gaussian_map as gm
    from monogs_tpu_torch.slam import mapping as mp
    from monogs_tpu_torch.slam.tracking import track_frame
    from monogs_tpu_torch.utils import roofline

    per_launch = {k: dict(ops=entries[k]["ops"], tc_ops=entries[k]["tc_ops"],
                          bytes=entries[k]["bytes"])
                  for k in ("fwd", "fwd_counts", "fo_grad", "jvp8",
                            "map_grad")}
    dev = poses[0].device

    def frame():
        gen = torch.Generator(device=dev).manual_seed(0)
        return track_frame(scene, frames[2], poses[1], 1.0, 0.0, gen, intr,
                           cfg, tcfg)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    _, c_frame = roofline.program_cost(frame, per_launch=per_launch)
    t_frame = statistics.median(timed(frame) for _ in range(3))
    m0, cams = map_window(torch, scene, frames, poses)
    mc = mp.MapConfig(monocular=True, window_size=8, pose_window=5,
                      tile_frac=0.25)
    gen = torch.Generator(device=dev).manual_seed(0)

    def ba(n):
        return mp.map_iters(m0, cams, n, 100, gen, intr, cfg, mc,
                            gm.MapHyper())

    ba(1)
    _, c1 = roofline.program_cost(ba, 1, per_launch=per_launch)
    _, c3 = roofline.program_cost(ba, 3, per_launch=per_launch)
    c_it = {k: (c3[k] - c1[k]) / 2 for k in ("flops", "tc_flops", "bytes",
                                             "dense_flops", "kernel_flops")}
    c_it["launches"] = {k: (c3["launches"][k] - c1["launches"].get(k, 0)) / 2
                        for k in c3["launches"]}
    c_it["uncounted"] = c3["uncounted"]
    t_it = (statistics.median(timed(lambda: ba(3)) for _ in range(3))
            - statistics.median(timed(lambda: ba(1)) for _ in range(3))) / 2
    out = {}
    for name, c, t in (("frame", c_frame, t_frame),
                       ("ba_iteration", c_it, t_it)):
        k = roofline.classify(c["flops"], c["bytes"], t,
                              tc_flops=c["tc_flops"])
        log(roofline.fmt(f"roofline {name}", k))
        out[name] = dict(cost={x: v for x, v in c.items() if x != "caveat"},
                         classify=k)
    out["caveat"] = c_frame["caveat"]
    check(out["frame"]["cost"]["kernel_flops"] > 0
          and out["ba_iteration"]["cost"]["kernel_flops"] > 0,
          "roofline: no kernel operations counted")
    return out


def diag_experiments(torch, intr, cfg, scene, frames, poses):
    """(d) four of slam/experiments.py's functions at 640x480: check_grad
    and lm_sweep on "xla" (forward mode has no rule through the kernels),
    kfine_vs_backward_subsample on "pallas_lists" (k_fine 256 against 96)
    and pool_vs_fresh_sampling on the mapping path's window (the fused
    branch, DIAG_POOL_ITERS iterations each way), each with the kernels it
    launched."""
    from monogs_tpu_torch.models import gaussian_map as gm
    from monogs_tpu_torch.ops import losses
    from monogs_tpu_torch.render import render
    from monogs_tpu_torch.slam import experiments as ex
    from monogs_tpu_torch.slam import mapping as mp
    from monogs_tpu_torch.slam.tracking import TrackConfig

    dev = poses[0].device
    tcfg = TrackConfig(monocular=True, stack_dim=16, sketch_dim=64)
    xla = cfg._replace(backend="xla")
    frame, T = frames[2], poses[1]
    out = {}

    def part(name, fn, view=lambda r: r):
        """Run experiment ``name``, keep ``view`` of its result, its seconds
        and the kernels it launched."""
        before = all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name] = dict(result=view(r), seconds=time.perf_counter() - t0,
                         launches=launch_delta(before))
        log(f"experiment {name}: {json.dumps(out[name], default=float)}")
        return r

    diff, SJ = part("check_grad", lambda: ex.check_grad(
        scene, frame, T, intr, xla, tcfg,
        torch.Generator(device=dev).manual_seed(1), atol=math.inf),
        lambda r: dict(max_abs_diff=r[0], sj_max=float(torch.abs(r[1]).max()),
                       shape=list(r[1].shape)))
    sj_max = out["check_grad"]["result"]["sj_max"]
    # forward mode in batches of 4 against one tangent at a time: the same
    # float32 ops, reassociated by the batched products
    check(0 < sj_max and diff <= 1e-4 * max(1.0, sj_max),
          f"check_grad: SJ differs by {diff} (largest |SJ| {sj_max})")
    with torch.no_grad():
        r0 = render(scene, T, intr, xla._replace(with_n_touched=False))
        start = float(torch.sum(torch.abs(losses.tracking_residual_rgb(
            r0.image, frame.gt_image, r0.opacity, frame.mapping_mask,
            torch.ones((), device=dev), torch.zeros((), device=dev)))))
    lm = part("lm_sweep", lambda: ex.lm_sweep(
        scene, frame, T, intr, xla, tcfg,
        torch.Generator(device=dev).manual_seed(1)))
    out["lm_sweep"]["start_l1"] = start
    check(all(math.isfinite(v["loss"]) for v in lm.values())
          and min(v["loss"] for v in lm.values()) < start,
          f"lm_sweep: no damping lowers the L1 {start}: {lm}")
    kf = part("kfine_vs_backward_subsample",
              lambda: ex.kfine_vs_backward_subsample(
                  scene, frame, T, intr, cfg, tcfg,
                  torch.Generator(device=dev).manual_seed(4),
                  k_fine_full=256, k_fine_trunc=cfg.k_fine))
    check(kf["cos_trunc_pose"] > 0.9 and kf["cos_sub_pose"] > 0.9
          and {"fwd", "bwd"} <= out["kfine_vs_backward_subsample"][
              "launches"].keys(),
          f"kfine_vs_backward_subsample: {kf}, launches "
          f"{out['kfine_vs_backward_subsample']['launches']}")
    m0, cams = map_window(torch, scene, frames, poses)
    mc = mp.MapConfig(monocular=True, window_size=3, pool_size=2,
                      tile_frac=0.25, gaussian_update_every=10_000,
                      gaussian_reset=10_000, densify_from_iter=10_000)
    pool = part("pool_vs_fresh_sampling", lambda: ex.pool_vs_fresh_sampling(
        m0, cams, intr, cfg, mc, gm.MapHyper(),
        torch.Generator(device=dev).manual_seed(5),
        n_iters=DIAG_POOL_ITERS, window=3, pool=2, chunk=2))
    check(pool["staged_l1"] < pool["start_l1"]
          and pool["fresh_l1"] < pool["start_l1"]
          and out["pool_vs_fresh_sampling"]["launches"].get("map_grad", 0)
          == 2 * DIAG_POOL_ITERS * 5,
          f"pool_vs_fresh_sampling: {pool}, launches "
          f"{out['pool_vs_fresh_sampling']['launches']}")
    return out


def http_get(port, path, timeout=120):
    import urllib.request

    with urllib.request.urlopen(f"http://localhost:{port}{path}",
                                timeout=timeout) as r:
        return r.read(), r.headers.get("Content-Type")


def diag_gui(torch, intr, cfg, scene, T, slam_poses):
    """(e) the GUI on the card: a packet of this scene's map at pose T,
    its /stats, /view.jpg, /depth.jpg and /map3d.jpg fetched over
    localhost, /view.jpg decoded (nvJPEG) and held to the render at T;
    then slam_path's "rgbd" run once more with use_gui (the GUI polled
    while it runs), whose poses must equal the run's without the GUI bit
    for bit."""
    import queue
    import threading

    from monogs_tpu_torch.data.jpeg import decode_jpeg
    from monogs_tpu_torch.gui import GaussianPacket, ParamsGUI, slam_gui
    from monogs_tpu_torch.gui.gui_utils import CameraMsg, snapshot
    from monogs_tpu_torch.models import gaussian_map as gm
    from monogs_tpu_torch.render import render

    dev = T.device
    n = scene.xyz.shape[0]
    m = gm.insert(gm.new_map(MAP_CAP, device=dev),
                  gm.ParamLeaves(scene.xyz, scene.sh, scene.log_scale,
                                 scene.quat, scene.opa_logit), n, kf_id=0)
    q_m2v, q_v2m = queue.Queue(), queue.Queue()
    # port 0: a free port, so that nothing else on the machine answers
    params = ParamsGUI(q_main2vis=q_m2v, q_vis2main=q_v2m, gaussians=None,
                       intr=intr, render_cfg=cfg, port=0,
                       save_dir=str(ROOT / "build" / "diag_gui"), device=dev)
    th, port = slam_gui.start(params)
    q_m2v.put(GaussianPacket(gaussians=snapshot(m),
                             current_frame=CameraMsg(uid=0, T=T),
                             keyframes=[CameraMsg(uid=0, T=T)]))
    out = {}
    try:
        deadline = time.time() + 60
        while True:
            try:
                stats = json.loads(http_get(port, "/stats", 5)[0])
                if stats["packets"] >= 1:
                    break
            except OSError:
                pass
            check(time.time() < deadline, "GUI: no packet served in 60 s")
            time.sleep(0.1)
        check(stats["n_gaussians"] == n, f"GUI /stats: {stats}")
        for path in ("/view.jpg", "/depth.jpg", "/map3d.jpg"):
            t0 = time.perf_counter()
            body, ctype = http_get(port, path)
            out[path] = dict(bytes=len(body), content_type=ctype,
                             ms=1000.0 * (time.perf_counter() - t0))
            check(ctype == "image/jpeg" and body[:2] == b"\xff\xd8",
                  f"GUI {path}: {ctype}, {body[:16]!r}")
            if path == "/view.jpg":
                view = decode_jpeg(body, dev)
        # the render at T (the GUI's pose offset is zero), and the same
        # image through the GUI's encoder here
        with torch.no_grad():
            img = torch.clamp(render(
                m.render_view(), T, intr, cfg._replace(with_n_touched=False),
                tau=torch.zeros(6, device=dev)).image, 0.0, 1.0)
        want = slam_gui._to_u8(img)
        err = (view.int() - want.int()).abs().float()
        out["view_lsb_mean"] = float(err.mean())
        out["view_lsb_max"] = float(err.max())
        out["view_equals_render_encoded"] = bool(torch.equal(
            decode_jpeg(slam_gui._encode_jpg(img)[0], dev), view))
        # JPEG at quality 95, 4:2:0: libjpeg (cv2) at the same quality
        # loses 0.84 LSB on average on this view
        check(tuple(view.shape) == tuple(want.shape)
              and out["view_lsb_mean"] <= 3.0
              and out["view_equals_render_encoded"],
              f"GUI /view.jpg against the render: shape "
              f"{tuple(view.shape)}, mean {out['view_lsb_mean']} LSB, same "
              f"as the render encoded {out['view_equals_render_encoded']}")
        out["stats"] = stats
    finally:
        q_m2v.put(GaussianPacket(finish=True))
        th.join(timeout=30)
    check(not th.is_alive() and params.error is None,
          f"GUI thread still serving after finish, or failed: "
          f"{params.error!r}")

    # slam_path's "rgbd" run with the GUI, polled while it runs
    cfg_s = slam_config("rgbd.yaml", "orbit16")
    cfg_s["Results"]["use_gui"] = True      # after --eval's override
    cfg_s["Renderer"]["gui_port"] = 0
    polled, stop, slams = [], threading.Event(), []

    def poll():
        while not stop.is_set():
            port = slams[0].gui_port if slams else None
            if port is None:     # the run's GUI not bound yet
                stop.wait(0.1)
                continue
            try:
                body, _ = http_get(port, "/view.jpg", 30)
                if body[:2] == b"\xff\xd8":
                    polled.append(len(body))
            except OSError:
                pass
            stop.wait(0.5)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    saved = all_launches()     # slam_run zeroes the counts for its own
    try:
        run, launches, poses_ok, poses = slam_run(torch, "rgbd_gui",
                                                  "rgbd.yaml", "orbit16",
                                                  cfg_s, "cuda", slams)
    finally:
        stop.set()
        poller.join(timeout=60)
    restore_launches({k: saved[k] + launches[k] for k in saved})
    same = (poses.keys() == slam_poses.keys()
            and all(bool(torch.equal(poses[i], slam_poses[i]))
                    for i in poses))
    out["slam_rgbd_gui"] = dict(seconds=run["seconds"], fps=run["fps"],
                                ate=run["ate"], views_served=len(polled),
                                poses_bit_identical=same)
    check(poses_ok and same, "slam with the GUI: poses differ from the run "
          "without it")
    check(len(polled) >= 1, "slam with the GUI: no view served during the "
          "run")
    return out


def diag_path(torch, intr, cfg, tcfg, scene, frames, poses, entries,
              slam_poses, profile):
    """Observability and diagnostics on the tracking phase's scene
    (640x480, 100k Gaussians, "pallas_lists"): (a) a frame cut at each of
    track_frame's stages, (b) the device trace of one full frame that the
    tracking path took (``profile``, profiling.trace), (c) the roofline of
    a frame and of a BA iteration (utils/roofline.py), (d) four
    experiments (slam/experiments.py), (e) the GUI. Counts are zeroed just
    before it and read just after (the SLAM run in (e) counts its own,
    added in). Returns (metrics, launches)."""
    reset_launches()
    out, parts = {}, {}
    before = all_launches()
    out["stages"] = diag_stages(torch, scene, frames[2], poses[1], intr,
                                cfg, tcfg)
    parts["stages"] = launch_delta(before)
    log(f"diag stages: {json.dumps(out['stages'], default=float)}")

    out["trace"] = profile
    log(f"diag trace (the tracking path's): "
        f"{json.dumps(out['trace'], default=float)}")
    check(out["trace"]["kernel_launches"] > 0
          and out["trace"]["device_ms_by_class"]["list_blend"] > 0,
          "diag trace: no list-blend kernel on the device")

    before = all_launches()
    out["roofline"] = diag_roofline(torch, intr, cfg, tcfg, scene, frames,
                                    poses, entries)
    parts["roofline"] = launch_delta(before)

    out["experiments"] = diag_experiments(torch, intr, cfg, scene, frames,
                                          poses)

    before = all_launches()
    out["gui"] = diag_gui(torch, intr, cfg, scene, poses[1], slam_poses)
    parts["gui"] = launch_delta(before)
    launches = all_launches()
    out["launches_by_part"] = parts
    for name in DIAG_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the diag path")
    return out, launches


# ------------------------------------------------------------- files path

# SLAM from files in the recorded datasets' layouts, written here from the
# stock synthetic sequence's scene (SEQUENCE: seed 0, 8192 Gaussians, drawn
# on the CPU, so that scripts/port_shipped_witness.py writes the same frames
# on either device) on its orbit at TUM's pace (files_sequence: the
# amplitudes of tum_like_amps over the sequence's 64 frames, about 8 mm and
# 6 mrad a frame), rendered at each config's own calibration and width; the
# first FILES_FRAMES frames, FILES_ITERS depth, --eval. (name, config, ATE
# bound or None): TUM RGB-D is held to slam_path's bound; mono, stereo and
# Replica must beat the ATE of holding the first pose. Replica's 90-degree
# field of view tracked the stock orbit (25 mm a frame, the sequence's
# keyframe policy) poorly in both packages: at 300x170 the JAX package
# parted from the truth by 71 mm over the frames, the port by 46 mm (55 on
# the card), against 31 and 36 mm at fr1's field of view
# (scripts/port_fov_witness.py); at 600x340 both packages by 49-53 mm
# against 58 mm for holding the first pose (PERF.md §6; ROADMAP.md,
# reference behaviours kept).
SEQUENCE = "configs/synthetic/rgbd.yaml"
FILES_FRAMES = 16
FILES_CHECK_FRAMES = 2      # frames each loader is held to its CPU path on
# One row a run. ``policy`` "own": the config's own keyframe policy
# (kf_interval, kf_translation, kf_min_translation, kf_overlap), window and
# insertion (pcd_downsample, pcd_downsample_init, point_size,
# adaptive_pointsize), as shipped; "sequence": SEQUENCE's policy and
# insertion (SEQUENCE_KEYS) in their place. ``ate_bound``: TUM RGB-D is
# held to slam_path's bound, None holds the ATE over the frames below that
# of holding the first pose. ``keyframes``: None for two or more, else the
# keyframes both packages take on these frames. Every run refines colour
# (kernel #5); ``psnr_rises`` holds the PSNR over the evaluated frames
# (every fifth, keyframes left out) no lower after it.
# fr1_desk and fr3_office run the sequence's policy because with their own
# both packages keep only keyframe 0 on these frames (the overlap with it
# stays above kf_overlap 0.9 for 32 frames; the JAX package's at 320x240
# alike, scripts/port_shipped_witness.py; PERF.md §6; ROADMAP.md,
# reference behaviours kept), against the two or more checked. fr1_desk
# runs once more with its own, held to those keyframes; there the
# refinement, fitting keyframe 0's view alone, lowers the PSNR of the
# other views in both packages (the JAX package's 17.74 -> 16.82 dB at
# 320x240, the witness's --refine), so that run's PSNR is reported and not
# held. mh02 runs its own policy: it keeps only keyframe 0 here in both
# packages (at 376x240 with the JAX draws replayed), and beats holding the
# first pose; with the sequence's it ends worse than that at 752x480 on
# the card (PERF.md §7). Replica's own policy (kf_overlap 0.95,
# kf_interval 4) takes a second keyframe.
FilesRun = collections.namedtuple(
    "FilesRun", "name config policy ate_bound keyframes psnr_rises")
FILES_RUNS = (
    FilesRun("files_tum_rgbd", "configs/rgbd/tum/fr1_desk.yaml",
             "sequence", 0.05, None, True),
    FilesRun("files_tum_rgbd_shipped", "configs/rgbd/tum/fr1_desk.yaml",
             "own", 0.05, [0], False),
    FilesRun("files_tum_mono", "configs/mono/tum/fr3_office.yaml",
             "sequence", None, None, True),
    FilesRun("files_replica_rgbd", "configs/rgbd/replica/office0.yaml",
             "own", None, None, True),
    FilesRun("files_euroc_stereo", "configs/stereo/euroc/mh02.yaml",
             "own", None, [0], True),
)
# files_config changes two capacities, not policy: an insertion keeps at
# most Renderer.insert_cap points, the first in raster order, so the cap
# is raised to hold a whole first keyframe's insertion at the config's
# width, and the map to FILES_MAP_CAPACITY (the configs' caps cut
# Replica's to its top third). FILES_ITERS cuts only the depth of BA. The
# runs are single-thread (deterministic), as slam_path's bounded ones;
# the datasets' configs run threaded.
FILES_MAP_CAPACITY = 1 << 18
# a config's keyframe policy and insertion (take_policy)
SEQUENCE_KEYS = {
    "Training": ("kf_interval", "kf_translation", "kf_min_translation",
                 "kf_overlap"),
    "Dataset": ("pcd_downsample", "pcd_downsample_init", "point_size",
                "adaptive_pointsize"),
}


class TimedFrames:
    """A dataset whose ``[i]`` records how long it blocks the caller (host
    seconds, the card's queued work not waited for)."""

    def __init__(self, ds):
        self.ds, self.seconds = ds, []

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, idx):
        t0 = time.perf_counter()
        out = self.ds[idx]
        self.seconds.append(time.perf_counter() - t0)
        return out


def raw_view_maps(torch, K_raw, dist, R, K_new, size, device="cuda"):
    """(maps on ``device``, margin): where each raw pixel of a distorted
    camera samples an ideal render widened by ``margin`` pixels each side
    (wide enough to hold every such point)."""
    import math

    from monogs_tpu_torch.data.layouts import raw_maps

    mx, my = raw_maps(K_raw, dist, R, K_new, size, 0)
    w, h = size
    margin = 2 + math.ceil(max(0.0, -float(mx.min()), float(mx.max()) - w + 1,
                               -float(my.min()), float(my.max()) - h + 1))
    maps = tuple(torch.from_numpy(m + margin).to(device) for m in (mx, my))
    return maps, margin


def ideal_views(torch, scene, poses, intr, margin, grey=False):
    """uint8 renders of ``scene`` at ``poses`` with ``intr`` widened by
    ``margin`` pixels each side ([H', W', 3], or [H', W'] grey), and the
    depth [H, W] of the unwidened view."""
    from monogs_tpu_torch.render import Intrinsics, RenderConfig, render

    wide = Intrinsics(fx=intr.fx, fy=intr.fy, cx=intr.cx + margin,
                      cy=intr.cy + margin, width=intr.width + 2 * margin,
                      height=intr.height + 2 * margin)
    cfg = RenderConfig(backend="pallas_lists", k_fine=512)
    images, depths = [], []
    for T in poses:
        out = render(scene, T, wide, cfg)
        img = out.image.clamp(0, 1)
        img = img.mean(0) if grey else img.permute(1, 2, 0)
        images.append((img * 255).round().to(torch.uint8).contiguous())
        depths.append(out.depth[0, margin:margin + intr.height,
                                margin:margin + intr.width])
    return images, depths


def files_sequence(torch, device="cuda", n_frames=FILES_FRAMES,
                   motion="tum_like"):
    """The stock synthetic sequence's scene (drawn on the CPU) and its first
    ``n_frames`` poses on ``device``: its orbit over its 64 frames at TUM's
    pace (``tum_like_amps``, as ``SyntheticDataset``'s "tum_like" motion),
    or with ``motion`` "stock" at its own amplitudes."""
    from monogs_tpu_torch.data.synthetic import (
        make_synthetic_scene, orbit_pose, tum_like_amps,
    )

    syn = load_yaml_config(SEQUENCE)["Dataset"]["synthetic"]
    scene = make_synthetic_scene(torch.Generator().manual_seed(syn["seed"]),
                                 n=syn["n_gauss"])
    scene = type(scene)(*(x.to(device) for x in scene))
    amps = ((syn["trans_amp"], syn["rot_amp"]) if motion == "stock"
            else tum_like_amps(syn["n_frames"]))
    poses = [orbit_pose(i / syn["n_frames"], *amps, device=device)
             for i in range(n_frames)]
    return scene, poses


def load_yaml_config(rel):
    from monogs_tpu_torch.slam.config import load_config

    return load_config(str(ROOT / rel))


def write_files(torch, cfg, root, scene, poses, write_jpeg=None):
    """Write the sequence in the layout of ``cfg``'s dataset under ``root``
    with the port's encoders (JPEG by ``write_jpeg(path, [H, W, 3] uint8)``
    where given: nvJPEG needs the card), rendered on the poses' device;
    returns what the checks compare with."""
    import numpy as np

    from monogs_tpu_torch.data import jpeg, layouts, png
    from monogs_tpu_torch.data.datasets import camera_matrix, dist_coeffs
    from monogs_tpu_torch.data.undistort import remap
    from monogs_tpu_torch.render import Intrinsics

    ds = cfg["Dataset"]
    calib, kind = ds["Calibration"], ds["type"]
    dev = poses[0].device
    size = (calib["width"], calib["height"])
    intr = Intrinsics(fx=calib["fx"], fy=calib["fy"], cx=calib["cx"],
                      cy=calib["cy"], width=size[0], height=size[1])
    host_poses = [T.double().cpu().numpy() for T in poses]
    written = dict(margin=0)
    if kind == "euroc":
        bf = 47.90639384423901           # datasets.py's baseline * fx
        shift = torch.eye(4, device=dev)
        shift[0, 3] = -bf / calib["cam0"]["opt"]["fx"]
        views = []
        for cam, cam_poses in (("cam0", poses),
                               ("cam1", [shift @ T for T in poses])):
            c = calib[cam]
            maps, margin = raw_view_maps(
                torch, camera_matrix(c["raw"]), dist_coeffs(c["raw"]),
                np.array(c["R"]["data"]).reshape(3, 3),
                camera_matrix(c["opt"]), size, dev)
            ideal, _ = ideal_views(torch, scene, cam_poses, intr, margin,
                                   grey=True)
            views.append([remap(v, *maps).cpu().numpy() for v in ideal])
            written["margin"] = max(written["margin"], margin)
        layouts.write_euroc(str(root), views[0], views[1], host_poses,
                            png.write_png)
    else:
        maps, margin = None, 0
        if calib["distorted"]:
            K = camera_matrix(calib)
            maps, margin = raw_view_maps(torch, K, dist_coeffs(calib),
                                         np.eye(3), K, size, dev)
        ideal, depths = ideal_views(torch, scene, poses, intr, margin)
        colors = [remap(v, *maps) if maps else v for v in ideal]
        depths = [d.cpu().numpy() for d in depths]
        written.update(margin=margin, colors=colors)
        if kind == "tum":
            layouts.write_tum(str(root), [c.cpu().numpy() for c in colors],
                              depths, host_poses, calib["depth_scale"],
                              png.write_png)
        else:
            layouts.write_replica(
                str(root), colors, depths, host_poses, calib["depth_scale"],
                write_jpeg or jpeg.write_jpeg, png.write_png)
    ds["dataset_path"] = str(root)
    return written


def image_lsb(a, b):
    """(largest difference, share differing) of two [3, H, W] frames in
    units of 1/255."""
    d = (a.double() - b.double()).abs() * 255
    return float(d.max()), float((d > 1e-6).double().mean())


def loader_check(torch, name, cfg, written):
    """``dataset[i]`` on the card against the port's CPU path for the first
    frames: PNG images and depth bit for bit, remapped images within 1 LSB
    (the share that differs logged), EuRoC's SGBM depth bit for bit where
    its remapped inputs are; Replica's colour (whose CPU path needs
    OpenCV) held to the frames that were encoded, its depth bit for bit.
    ``data_kernel_phase`` holds the data kernels to their plain versions
    and to a second launch on the first frames."""
    from monogs_tpu_torch.data import load_dataset
    from monogs_tpu_torch.data.png import read_png

    out = {}
    kind = cfg["Dataset"]["type"]
    gpu = load_dataset(cfg, device="cuda")
    cpu = load_dataset(cfg, device="cpu") if kind != "replica" else None
    for i in range(FILES_CHECK_FRAMES):
        img, depth, pose = gpu[i]
        torch.cuda.synchronize()
        check(img.is_cuda and (depth is None or depth.is_cuda),
              f"{name}: frame {i} not on the card")
        check(bool(torch.isfinite(img).all()), f"{name}: frame {i} not "
              "finite")
        if kind == "replica":
            enc = written["colors"][i].permute(2, 0, 1).double() / 255
            lsb = float((img.double() - enc).abs().mean() * 255)
            out[f"frame{i}_nvjpeg_mean_lsb"] = lsb
            check(lsb < 3.0, f"{name}: nvJPEG decode {lsb:.3f} LSB from the "
                  "encoded frame (mean), limit 3")
            want = torch.from_numpy(read_png(gpu.depth_paths[i]).astype(
                "int32")).double() / gpu.depth_scale
            check(torch.equal(depth.cpu(), want.float()),
                  f"{name}: depth of frame {i} not bit for bit")
            continue
        cimg, cdepth, cpose = cpu[i]
        big, share = image_lsb(img.cpu(), cimg)
        out[f"frame{i}_image_max_lsb"] = big
        out[f"frame{i}_image_share_differing"] = share
        check(big <= 1.0 + 1e-9 and (gpu.disorted or big == 0.0),
              f"{name}: frame {i} image {big} LSB from the CPU path")
        check(torch.equal(pose.cpu(), cpose), f"{name}: pose {i} differs")
        if kind == "euroc":
            out[f"frame{i}_valid_depth"] = float((cdepth > 0).float().mean())
        if kind != "euroc" or big == 0.0:
            check(torch.equal(depth.cpu(), cdepth),
                  f"{name}: depth of frame {i} not bit for bit")
    return out


def trajectory_ate(fe, monocular):
    """(ATE over every tracked frame, the same for holding one pose): the
    keyframe ATE of a short run rests on two or three poses (two fit
    exactly under Sim(3)); a constant trajectory's best ATE under any
    alignment is the RMS distance of the true camera centres from their
    mean."""
    import numpy as np

    from monogs_tpu_torch.eval.ate import evaluate_ate

    ids = sorted(fe.cameras)
    gt = [np.linalg.inv(fe.cameras[i].T_gt.double().cpu().numpy())
          for i in ids]
    est = [np.linalg.inv(fe.cameras[i].T.double().cpu().numpy())
           for i in ids]
    c = np.stack([g[:3, 3] for g in gt])
    hold = float(np.sqrt(((c - c.mean(0)) ** 2).sum(1).mean()))
    return float(evaluate_ate(gt, est, monocular=monocular)[0]), hold


@contextlib.contextmanager
def overlaps_logged(frontend):
    """Yields a list that gets the overlap (the visibility IoU against the
    last keyframe) behind each keyframe decision that ``frontend`` (the
    frontend module of either package) takes while the window is below
    its size."""
    overlaps, ratio = [], frontend.overlap_ratio

    def logged(cur, last):
        overlaps.append(float(ratio(cur, last)))
        return overlaps[-1]

    frontend.overlap_ratio = logged
    try:
        yield overlaps
    finally:
        frontend.overlap_ratio = ratio


def count_insertions(backend):
    """A list that gets the map's active count after each keyframe
    insertion of ``backend`` (its first entry: the first keyframe's)."""
    counts, insert = [], backend.add_next_kf

    def counted(*args, **kw):
        insert(*args, **kw)
        counts.append(int(backend.gaussians.n_active))

    backend.add_next_kf = counted
    return counts


def files_run(torch, name, cfg, smi):
    """One SLAM run from the files: ``SLAM(config).run()`` with
    ``dataset_path`` pointing at them; its JSON line's metrics (with the
    overlap, the visibility IoU against the last keyframe, behind each
    keyframe decision taken while the window is below its size)."""
    import copy

    from monogs_tpu_torch.slam import frontend
    from monogs_tpu_torch.slam.runtime import SLAM

    save_dir = ROOT / "build" / "files_smoke" / name / "results"
    save_dir.mkdir(parents=True, exist_ok=True)
    slam = SLAM(copy.deepcopy(cfg), save_dir=str(save_dir), device="cuda")
    timed = TimedFrames(slam.dataset)
    slam.dataset = slam.frontend.dataset = timed
    inserted = count_insertions(slam.backend)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with overlaps_logged(frontend) as overlaps:
        res = slam.run()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = all_launches()
    fe = slam.frontend
    track_s, track_n = res["stages"]["tracking"]
    load_ms = [1000.0 * s for s in timed.seconds[:res["n_frames"]]]
    out = dict(
        type=cfg["Dataset"]["type"],
        sensor=cfg["Dataset"]["sensor_type"],
        width=cfg["Dataset"]["Calibration"]["width"],
        height=cfg["Dataset"]["Calibration"]["height"],
        n_frames=res["n_frames"], loads=len(timed.seconds), fps=res["fps"],
        seconds=seconds,
        ate=res["ate"], single_thread=cfg["Dataset"]["single_thread"],
        before=res["before"], after=res["after"],
        n_active=int(slam.backend.gaussians.n_active),
        n_first_keyframe=inserted[0] if inserted else None,
        kf_indices=fe.kf_indices, overlaps=overlaps,
        tracking_ms_per_frame=1000.0 * track_s / max(track_n, 1),
        load_ms=dict(mean=statistics.mean(load_ms), max=max(load_ms),
                     n=len(load_ms)),
        stages=res["stages"],
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        launches={k: v for k, v in launches.items() if v}, device=smi)
    poses_ok = all(bool(torch.isfinite(f.T).all())
                   for f in fe.cameras.values())
    if poses_ok:
        out["ate_frames"], out["hold_first_ate"] = trajectory_ate(
            fe, slam.monocular)
    return out, launches, poses_ok


def jpeg_reference_check(torch):
    """nvJPEG's decode of each embedded stream against libjpeg's pixels."""
    import numpy as np

    from monogs_tpu_torch.data.jpeg import decode_jpeg

    out = {}
    for sample in JPEG_SAMPLES:
        data, want = jpeg_sample(sample)
        got = decode_jpeg(data, "cuda").cpu().numpy()
        d = np.abs(got.astype(np.int32) - want)
        out[sample] = dict(mean_lsb=float(d.mean()), max_lsb=int(d.max()),
                           share_differing=float((d > 0).mean()))
        check(out[sample]["mean_lsb"] < 3.0, f"nvJPEG decode of the "
              f"embedded {sample} JPEG {out[sample]['mean_lsb']:.3f} LSB "
              "from libjpeg's (mean), limit 3")
    return out


def host_ms(fn, reps=10):
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1000.0 * (time.perf_counter() - t0) / reps


# ---------------------------------------------------------------- SGBM

SGBM_SPLIT_REPS = 5     # calls traced for the split of a call by launch
SGBM_AB_ROUNDS = 3      # rounds of (this, other, other, this)


def textured_pair(torch, dev, h=120, w=200, seed=0):
    """A smooth random texture and its copy shifted by 5-11 px by row, as
    a rectified uint8 pair [h, w] on ``dev``."""
    g = torch.Generator().manual_seed(seed)
    base = torch.nn.functional.avg_pool2d(
        torch.rand((1, 1, h, w + 16), generator=g), 3, 1, 1)[0, 0]
    base = ((base - base.min()) / (base.max() - base.min()) * 255).round()
    base = base.to(torch.uint8)
    left = base[:, :w].contiguous()
    right = torch.stack([base[y, 5 + 6 * y // h:5 + 6 * y // h + w]
                         for y in range(h)]).contiguous()
    return left.to(dev), right.to(dev)


def build_sources(sources):
    """Build each CUDA source of ``sources`` ({name: path}) with this
    checkout's nvcc flags under a name of its own
    (``lib<name>_<digest>.so`` in the build directory), one nvcc a source,
    all started together, the ones built before reused; returns {name:
    ctypes.CDLL}."""
    import ctypes
    import hashlib

    from monogs_tpu_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths, jobs = {}, {}
    for name, path in sources.items():
        src = Path(path).resolve()
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
        paths[name] = _build.BUILD_DIR / f"lib{name}_{digest}.so"
        if not paths[name].exists():
            jobs[name] = subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                 str(paths[name]), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
    for name, proc in jobs.items():
        out = proc.communicate(timeout=600)[0]
        check(proc.returncode == 0, f"building {sources[name]} failed: "
              f"{out}")
    return {name: ctypes.CDLL(str(p)) for name, p in paths.items()}


def sgbm_build_other(path):
    """Another ``sgbm.cu`` (``path``, for example the parent commit's, from
    ``git show``) built with this checkout's nvcc flags under a name of
    its own; returns a function ``(left, right) -> disparities`` that
    calls it. It may have this checkout's C interface (five launches) or
    the earlier one (three launches; scratch: the cost volume, the two
    horizontal paths' int32 planes and a two-row scratch of the upper
    paths and their minima; marked by its ``sgbm_cost_smem``)."""
    import ctypes

    import torch

    src = Path(path).resolve()
    lib = build_sources({"sgbm_other": src})["sgbm_other"]
    vp, i = ctypes.c_void_p, ctypes.c_int
    earlier = hasattr(lib, "sgbm_cost_smem")
    lib.sgbm_run.argtypes = ([vp] * 9 + [i, i, vp] if earlier
                             else [vp] * 7 + [i, i, vp, vp])
    lib.sgbm_run.restype = i

    def run(left, right):
        h, w = left.shape
        dev, n = left.device, h * (w - 64) * 64

        def empty(k, dtype):
            return torch.empty(k, dtype=dtype, device=dev)

        pre = empty((h, w), torch.int16)
        out = empty((h, w), torch.int16)
        if earlier:
            bufs = (empty(n, torch.int16), empty(n, torch.int32),
                    empty(n, torch.int32),
                    empty(6 * (w - 64) * 64, torch.int16),
                    empty(6 * (w - 64), torch.int16))
        else:
            bufs = (empty(n, torch.int16), empty(5 * n, torch.int32),
                    empty((h, w), torch.int32))
        rc = lib.sgbm_run(left.data_ptr(), right.data_ptr(),
                          *[b.data_ptr() for b in bufs], pre.data_ptr(),
                          out.data_ptr(), h, w,
                          torch.cuda.current_stream(dev).cuda_stream,
                          *([] if earlier else [None]))
        check(rc == 0, f"{src}: sgbm_run failed with CUDA error {rc}")
        return out

    return run


def launch_split(torch, fn, reps=SGBM_SPLIT_REPS):
    """Device ms of one call of ``fn`` by kernel (torch.profiler over
    ``reps`` calls): {kernel name: ms a call}."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        m = re.search(r"(\w+_kernel)", e.key)
        name = m.group(1) if m else e.key[:60]
        out[name] = out.get(name, 0.0) + us / 1000.0 / reps
    # None where CUPTI recorded no device event (as in a long process that
    # has run torch.distributed and several traces)
    return out or None


SGBM_LAUNCHES = ("sgbm_cost_kernel", "sgbm_sweep_kernel",
                 "sgbm_select_kernel", "sgbm_lr_kernel", "median3_kernel")


def sgbm_marks_split(torch, left, right, reps=SGBM_SPLIT_REPS):
    """Device ms of each of this checkout's five SGBM launches from CUDA
    events that the C entry records between them (the median over
    ``reps`` calls after one to warm up)."""
    from monogs_tpu_torch.data import stereo

    stereo._sgbm_cuda(left, right)
    runs = []
    for _ in range(reps):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        stereo._sgbm_cuda(left, right, marks)
        marks[-1].synchronize()
        runs.append([marks[i].elapsed_time(marks[i + 1]) for i in range(5)])
    return {k: statistics.median(r[i] for r in runs)
            for i, k in enumerate(SGBM_LAUNCHES)}


def sgbm_ab(torch, left, right, other, rounds=SGBM_AB_ROUNDS):
    """This checkout's SGBM against another build (``sgbm_build_other``) on
    the same pair, in turns (this, other, other, this a round): the
    medians of each one's ms (``cuda_ms``) and device ms (``kernel_ms``),
    each one's split by launch (``launch_split``), and whether both give
    the same bits."""
    from monogs_tpu_torch.data import stereo

    fns = {"this": lambda: stereo.sgbm(left, right),
           "other": lambda: other(left, right)}
    same = bool(torch.equal(fns["this"](), fns["other"]()))
    times = {"this": [], "other": []}
    for _ in range(rounds):
        for who in ("this", "other", "other", "this"):
            times[who].append((cuda_ms(torch, fns[who], reps=10),
                               kernel_ms(torch, fns[who], reps=10)))
    out = dict(same_bits=same, rounds=rounds)
    for who, ts in times.items():
        out[who] = dict(ms=statistics.median(t[0] for t in ts),
                        device_ms=statistics.median(t[1] for t in ts),
                        split=launch_split(torch, fns[who]))
    out["device_ratio"] = out["other"]["device_ms"] / out["this"]["device_ms"]
    return out


# ------------------------------------------------- remap and ycc_rgb

DATA_AB_ROUNDS = 3      # rounds of turns (a, b, .., b, a)
SPLIT_REPS, SPLIT_BATCHES = 200, 10     # host timing of wrapper steps

# an empty kernel launched through ctypes as the data kernels are: the
# floor of one launch, on one CTA or on a kernel's grid of 256-thread CTAs
EMPTY_KERNEL = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int gx, int gy, cudaStream_t stream) {
  empty_kernel<<<dim3(gx, gy), 256, 0, stream>>>();
  return (int)cudaGetLastError();
}
"""


def data_build(remap_other=None, ycc_other=None):
    """The empty kernel and, where given, another ``remap.cu`` and
    ``ycc_rgb.cu`` (for example the parent commit's, from ``git show``;
    their C interfaces, ``remap_u8`` and ``ycc_rgb_u8``, are unchanged),
    built together; returns {name: ctypes.CDLL} with their argument
    types set."""
    import ctypes

    from monogs_tpu_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    empty = _build.BUILD_DIR / "empty_kernel.cu"
    empty.write_text(EMPTY_KERNEL)
    sources = {"empty_kernel": empty, "remap_other": remap_other,
               "ycc_rgb_other": ycc_other}
    libs = build_sources({k: v for k, v in sources.items() if v})
    vp, i = ctypes.c_void_p, ctypes.c_int
    types = {"empty_launch": [i, i, vp], "remap_u8": [vp] * 4 + [i] * 5 + [vp],
             "ycc_rgb_u8": [vp] * 4 + [i] * 6 + [vp]}
    for lib in libs.values():
        for fn, argtypes in types.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = i
    return libs


def empty_launcher(torch, lib, grid=(1, 1)):
    from monogs_tpu_torch import _build

    dev = torch.cuda.current_device()

    def run():
        rc = lib.empty_launch(*grid, _build.stream_handle(dev))
        if rc != 0:
            raise Failure(f"empty_launch failed with CUDA error {rc}")
    return run


def parent_remap(lib):
    """The parent commit's ``remap`` wrapper, step for step, around
    ``lib``'s ``remap_u8``: ``(img, map_x, map_y) -> out``; and its steps
    on one call as {name: function of no arguments} for
    ``wrapper_split``."""
    import torch

    from monogs_tpu_torch.render.blend_lists import count_launch

    counts = {"remap": 0}

    def check_args(img, map_x, map_y):
        if img.dtype != torch.uint8 or img.dim() not in (2, 3):
            raise ValueError("remap: img")
        for m in (map_x, map_y):
            if (m.dtype != torch.float32 or m.shape != map_x.shape
                    or m.dim() != 2 or m.device != img.device):
                raise ValueError("remap: maps")

    def library():
        from monogs_tpu_torch._build import library as lookup

        lookup("remap")     # the parent's lookup; the launch takes ``lib``
        return lib

    def call(img, map_x, map_y):
        check_args(img, map_x, map_y)
        if img.device.type != "cuda":
            raise ValueError("remap: the parent's kernel runs on the card")
        kernels = library()
        img = img.contiguous()
        map_x, map_y = map_x.contiguous(), map_y.contiguous()
        h, w = img.shape[:2]
        c = img.shape[2] if img.dim() == 3 else 1
        out = torch.empty(tuple(map_x.shape) + tuple(img.shape[2:]),
                          dtype=torch.uint8, device=img.device)
        rc = kernels.remap_u8(
            img.data_ptr(), map_x.data_ptr(), map_y.data_ptr(),
            out.data_ptr(), h, w, map_x.shape[0], map_x.shape[1], c,
            torch.cuda.current_stream(img.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"remap_u8: CUDA error {rc}")
        count_launch(counts, "remap")
        return out

    def steps(img, map_x, map_y):
        out = call(img, map_x, map_y)
        c = img.shape[2] if img.dim() == 3 else 1
        stream = torch.cuda.current_stream(img.device).cuda_stream
        ptrs = (img.data_ptr(), map_x.data_ptr(), map_y.data_ptr(),
                out.data_ptr())
        return {
            "check": lambda: check_args(img, map_x, map_y),
            "import_library": library,
            "contiguous_x3": lambda: (img.contiguous(), map_x.contiguous(),
                                      map_y.contiguous()),
            "shape_args": lambda: (img.shape[:2], img.dim(),
                                   tuple(map_x.shape) + tuple(img.shape[2:])),
            "torch_empty": lambda: torch.empty(
                tuple(map_x.shape) + tuple(img.shape[2:]),
                dtype=torch.uint8, device=img.device),
            "current_stream": lambda: torch.cuda.current_stream(
                img.device).cuda_stream,
            "data_ptr_x4": lambda: (img.data_ptr(), map_x.data_ptr(),
                                    map_y.data_ptr(), out.data_ptr()),
            "ctypes_launch": lambda: lib.remap_u8(
                *ptrs, img.shape[0], img.shape[1], map_x.shape[0],
                map_x.shape[1], c, stream),
            "count_launch": lambda: count_launch(counts, "remap"),
        }

    return call, steps


def this_remap_steps(img, maps):
    """This checkout's ``remap`` wrapper on ``Maps``, step for step, as
    {name: function of no arguments} for ``wrapper_split``."""
    from monogs_tpu_torch import _build
    from monogs_tpu_torch.data import undistort
    from monogs_tpu_torch.render.blend_lists import count_launch

    counts = {"remap": 0}
    out = undistort.remap(img, maps)
    lib = _build.library("remap")
    c = img.shape[2] if img.dim() == 3 else 1
    ptrs = (img.data_ptr(), maps.x.data_ptr(), maps.y.data_ptr(),
            out.data_ptr())
    stream = _build.stream_handle(maps.device)
    return {
        "check": lambda: undistort._check(img, maps),
        "contiguous": img.contiguous,
        "new_empty": lambda: img.new_empty(maps.x.shape + img.shape[2:]),
        "library": lambda: _build.library("remap"),
        "stream_handle": lambda: _build.stream_handle(maps.device),
        "data_ptr_x4": lambda: (img.data_ptr(), maps.x.data_ptr(),
                                maps.y.data_ptr(), out.data_ptr()),
        "ctypes_launch": lambda: lib.remap_u8(
            *ptrs, img.shape[0], img.shape[1], maps.x.shape[0],
            maps.x.shape[1], c, stream),
        "count_launch": lambda: count_launch(counts, "remap"),
    }


def host_us(torch, fn, reps=SPLIT_REPS, batches=SPLIT_BATCHES):
    """Host microseconds a call of ``fn`` takes (``time.perf_counter_ns``):
    the median over ``batches`` of ``reps`` calls, the card synchronised
    between batches, so that the launches queued never make the host
    wait."""
    fn()
    per = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            fn()
        per.append((time.perf_counter_ns() - t0) / reps / 1e3)
    torch.cuda.synchronize()
    return statistics.median(per)


def wrapper_split(torch, steps, whole):
    """Host µs of each step of a wrapper call (``steps``: {name: function
    of no arguments}) and of the ``whole`` call, each timed alone by
    ``host_us``; ``sum`` the steps' total."""
    out = {name: host_us(torch, fn) for name, fn in steps.items()}
    out["sum"] = sum(out.values())
    out["whole"] = host_us(torch, whole)
    return out


def turns(torch, fns, rounds=DATA_AB_ROUNDS):
    """The functions ``fns`` ({name: function of no arguments}) timed in
    turns, each round in order and back (a, b, .., b, a): the median of
    each one's ms (``cuda_ms``) and device ms (``kernel_ms``)."""
    order = list(fns) + list(fns)[::-1]
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name in order:
            times[name].append((cuda_ms(torch, fns[name], reps=10),
                                kernel_ms(torch, fns[name], reps=10)))
    return {name: dict(ms=statistics.median(t[0] for t in ts),
                       device_ms=statistics.median(t[1] for t in ts))
            for name, ts in times.items()}


def remap_ab(torch, img, maps, other, rounds=DATA_AB_ROUNDS):
    """This checkout's ``remap`` (``Maps``) against the parent's wrapper and
    kernel (``parent_remap``'s call, on ``other``) on one image, in turns,
    and whether both give the same bits."""
    from monogs_tpu_torch.data.undistort import remap

    fns = {"this": lambda: remap(img, maps),
           "other": lambda: other(img, maps.x, maps.y)}
    out = turns(torch, fns, rounds)
    out.update(same_bits=bool(torch.equal(fns["this"](), fns["other"]())),
               rounds=rounds)
    out["device_ratio"] = out["other"]["device_ms"] / out["this"]["device_ms"]
    return out


def parent_ycc(lib):
    """The parent commit's ``ycc_to_rgb`` wrapper, step for step, around
    ``lib``'s ``ycc_rgb_u8``: ``(y, cb, cr) -> out``."""
    import torch

    from monogs_tpu_torch.data.jpeg import _factors
    from monogs_tpu_torch.render.blend_lists import count_launch

    counts = {"ycc_rgb": 0}

    def call(y, cb=None, cr=None):
        from monogs_tpu_torch._build import library  # noqa: F401

        height, width = y.shape
        sy, sx, ch, cw = 1, 1, 0, 0
        if cb is not None:
            sy, sx = _factors(cb.shape, height, width)
            ch, cw = cb.shape
        planes = [None if p is None else p.contiguous() for p in (y, cb, cr)]
        out = torch.empty((height, width, 3), dtype=torch.uint8,
                          device=y.device)
        rc = lib.ycc_rgb_u8(
            *(None if p is None else p.data_ptr() for p in planes),
            out.data_ptr(), height, width, ch, cw, sx, sy,
            torch.cuda.current_stream(y.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ycc_rgb_u8: CUDA error {rc}")
        count_launch(counts, "ycc_rgb")
        return out

    return call


def ycc_ab(torch, planes, other, rounds=DATA_AB_ROUNDS):
    """This checkout's ``ycc_to_rgb`` against the parent's wrapper and
    kernel (``parent_ycc``'s call) on one frame's planes, in turns, and
    whether both give the same bits."""
    from monogs_tpu_torch.data.jpeg import ycc_to_rgb

    fns = {"this": lambda: ycc_to_rgb(*planes),
           "other": lambda: other(*planes)}
    out = turns(torch, fns, rounds)
    out.update(same_bits=bool(torch.equal(fns["this"](), fns["other"]())),
               rounds=rounds)
    out["device_ratio"] = out["other"]["device_ms"] / out["this"]["device_ms"]
    return out


def grid_of(w, h, per_thread):
    """The CTAs (x, y) of a remap (``per_thread`` 1) or ycc_rgb (4) launch
    at output width ``w`` and height ``h``: 32 threads of ``per_thread``
    pixels by 8 rows each."""
    threads = -(-w // per_thread)
    return (-(-threads // 32), -(-h // 8))


def grid_sample(torch, raws, maps):
    """One ``grid_sample`` call over the images ``raws`` (one shape) through
    ``maps`` (``Maps``, one for each), remap's yardstick: bilinear, zeros
    outside, in float (no rounding)."""
    h, w = raws[0].shape[:2]
    src = torch.stack([r.float().permute(2, 0, 1) if r.dim() == 3
                       else r.float()[None] for r in raws])
    grid = torch.stack([torch.stack([m.x / (w - 1) * 2 - 1,
                                     m.y / (h - 1) * 2 - 1], -1)
                        for m in maps])
    return lambda: torch.nn.functional.grid_sample(
        src, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def dataset_maps(torch, config, device="cuda"):
    """The ``Maps`` that the dataset of ``config`` (a path under the repo)
    builds from its calibration alone: TUM's one, EuRoC's two (cam0,
    cam1)."""
    from monogs_tpu_torch.data.datasets import (
        MonocularDataset, StereoDataset,
    )

    cfg = load_yaml_config(config)
    if cfg["Dataset"]["type"] == "euroc":
        ds = StereoDataset(cfg, device)
        return [ds.maps, ds.maps_r]
    return [MonocularDataset(cfg, device).maps]


def euroc_load_ms(torch, cfg, sgbm_fn=None, host_pose=False, n=8):
    """Median ms that EuRoC's ``dataset[i]`` blocks the caller over its
    first ``n`` frames (the first waits for the loader to start), the
    loader's threads given 50 ms before each call to
    decode ahead (as tracking gives them), with ``sgbm_fn`` in place of
    the SGBM kernel and, with ``host_pose``, each pose copied from host
    memory as the dataset did before it kept a pose table on the device
    (a copy that waits for the kernels just launched)."""
    import numpy as np

    from monogs_tpu_torch.data import datasets, load_dataset

    ds = load_dataset(cfg, "cuda")
    if host_pose:
        ds._pose = lambda idx: torch.as_tensor(
            ds.poses[idx].astype(np.float32), device=ds.device)
    saved, times = datasets.sgbm, []
    if sgbm_fn is not None:
        datasets.sgbm = sgbm_fn
    try:
        for i in range(n):
            torch.cuda.synchronize()
            time.sleep(0.05)
            t0 = time.perf_counter()
            ds[i]
            times.append(1000.0 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    finally:
        datasets.sgbm = saved
    return statistics.median(times)


def data_kernel_phase(torch, cfgs, sgbm_other=None, remap_other=None,
                      ycc_other=None):
    """The data kernels at the files path's shapes (the first TUM fr1,
    EuRoC and Replica frames) against their plain versions on the same
    inputs on the card and against a second launch, timed, with their
    bounds: the bytes they must move over the card's memory rate (for SGBM
    the larger of its bytes, the 16-bit cost volume written once and read
    once among them, and its integer operations over the card's integer
    rate, ``roofline.sgbm_bound``); ``grid_sample``'s ms and device ms
    beside remap's, and an empty kernel's device ms on one CTA and on
    each remap and ycc_rgb grid (the floor of a launch); the host µs of
    each step of one remap wrapper call, the parent's wrapper and this
    checkout's (``wrapper_split``); with ``remap_other`` / ``ycc_other``
    (another remap.cu / ycc_rgb.cu) each timed in turns against this
    checkout's with the parent's wrapper around it (``remap_ab``,
    ``ycc_ab``), the bits held equal; SGBM's device time split by launch,
    the CTAs of each launch, and with ``sgbm_other`` (another sgbm.cu) the
    two timed in turns (``sgbm_ab``); the PNG unfilter and nvJPEG's decode
    timed on the host."""
    from monogs_tpu_torch import _build
    from monogs_tpu_torch.data import load_dataset, png, stereo
    from monogs_tpu_torch.data.jpeg import (
        decode_planes, read_jpeg, ycc_to_rgb, ycc_to_rgb_plain,
    )
    from monogs_tpu_torch.data.undistort import remap, remap_pair, remap_plain
    from monogs_tpu_torch.utils import roofline

    entries, host = {}, {}

    def device_ms(fn):
        # the median of three kernel_ms: a kernel of a few microseconds
        # reads ten times too long when the host stalls while it enqueues
        return statistics.median(kernel_ms(torch, fn) for _ in range(3))

    def record(name, fn, plain, nbytes, library=None, plain_reps=3,
               bound=None):
        a, b = fn(), fn()
        plain_out = []
        plain_ms = cuda_ms(torch, lambda: plain_out.append(plain()),
                           reps=plain_reps, warmup=0)
        a, b, p = (x if isinstance(x, tuple) else (x,)
                   for x in (a, b, plain_out[-1]))
        torch.cuda.synchronize()
        ok = all(torch.equal(x, y) and torch.equal(x, z)
                 for x, y, z in zip(a, b, p))
        err = max(float((x.int() - z.int()).abs().max())
                  for x, z in zip(a, p))
        kind = name.split("@")[0]
        check(ok, f"{name}: kernel disagrees with its plain version or "
              f"itself (max abs error {err}; {KERNELS[kind][1]})")
        if bound is None:
            bound = dict(bound_ms=roofline.bytes_bound_ms(nbytes),
                         bound_by="bytes")
        entries[name] = e = dict(
            name=name, route="cuda", source=kernel_source(kind),
            replaces=KERNELS[kind][0], launches=0, max_abs_err=err,
            tol=KERNELS[kind][1], ms=cuda_ms(torch, fn),
            device_ms=device_ms(fn), plain_ms=plain_ms,
            bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
            library_ms=None if library is None else cuda_ms(torch, library),
            library_device_ms=None if library is None else device_ms(library),
            within_tol=ok, bytes=nbytes, shape=list(a[0].shape))
        log(f"{name}: {e['ms']:.4f} ms (device {e['device_ms']:.4f} ms, "
            f"plain {e['plain_ms']:.3f} ms, library {e['library_ms']} "
            f"(device {e['library_device_ms']})), bound "
            f"{e['bound_ms']:.4f} ms by {e['bound_by']}")
        return e

    libs = data_build(remap_other, ycc_other)
    empty = empty_launcher(torch, libs["empty_kernel"])
    floor = dict(one_cta=kernel_ms(torch, empty),
                 host_us=host_us(torch, empty))

    def floor_on(e, w, h, per_thread=1):
        grid = grid_of(w, h, per_thread)
        e["empty_device_ms"] = dict(one_cta=floor["one_cta"], grid=kernel_ms(
            torch, empty_launcher(torch, libs["empty_kernel"], grid)),
            ctas=grid[0] * grid[1], host_us_one_cta=floor["host_us"])
        log(f"{e['name']}: an empty kernel {e['empty_device_ms']} device ms")

    tum = load_dataset(cfgs["files_tum_rgbd"], "cuda")
    euroc = load_dataset(cfgs["files_euroc_stereo"], "cuda")
    left_raw = euroc._loader.get(0)[0]
    right_raw = euroc._loader_r.get(0)[0]
    for name, raw, maps in (("remap", tum._loader.get(0)[0], tum.maps),
                            ("remap@euroc", left_raw, euroc.maps)):
        e = record(name, lambda r=raw, m=maps: remap(r, m),
                   lambda r=raw, m=maps: remap_plain(r, m.x, m.y),
                   2 * raw.numel() + 2 * 4 * maps.x.numel(),
                   library=grid_sample(torch, [raw], [maps]))
        floor_on(e, maps.x.shape[1], maps.x.shape[0])
        e["host_us"] = dict(
            this=host_us(torch, lambda r=raw, m=maps: remap(r, m)),
            library=host_us(torch, grid_sample(torch, [raw], [maps])))
        log(f"{name}: host us a call {e['host_us']}")
        if "remap_other" in libs:
            e["ab"] = remap_ab(torch, raw, maps,
                               parent_remap(libs["remap_other"])[0])
            e["ab"]["other_source"] = str(remap_other)
            log(f"{name} against {remap_other}: {e['ab']}")
            check(e["ab"]["same_bits"], f"{name}: {remap_other} gives "
                  "other bits")
    # where one remap call's host time goes: the parent's wrapper (around
    # the parent's kernel where given, else this checkout's, whose C
    # interface it shares) and this checkout's, step by step
    raw, maps = tum._loader.get(0)[0], tum.maps
    call, steps = parent_remap(libs.get("remap_other")
                               or _build.library("remap"))
    entries["remap"]["wrapper_us"] = split = dict(
        parent=wrapper_split(torch, steps(raw, maps.x, maps.y),
                             lambda: call(raw, maps.x, maps.y)),
        this=wrapper_split(torch, this_remap_steps(raw, maps),
                           lambda: remap(raw, maps)))
    log(f"remap wrapper host us by step: {split}")
    e = record("remap_pair",
               lambda: remap_pair(left_raw, euroc.maps, right_raw,
                                  euroc.maps_r),
               lambda: (remap_plain(left_raw, euroc.maps.x, euroc.maps.y),
                        remap_plain(right_raw, euroc.maps_r.x,
                                    euroc.maps_r.y)),
               2 * (2 * left_raw.numel() + 2 * 4 * euroc.maps.x.numel()),
               library=grid_sample(torch, [left_raw, right_raw],
                                   [euroc.maps, euroc.maps_r]))
    floor_on(e, euroc.maps.x.shape[1], euroc.maps.x.shape[0])
    pair = remap_pair(left_raw, euroc.maps, right_raw, euroc.maps_r)
    two = (remap(left_raw, euroc.maps), remap(right_raw, euroc.maps_r))
    check(all(torch.equal(x, y) for x, y in zip(pair, two)),
          "remap_pair: other bits than two remap calls")
    e["against_two"] = turns(torch, {
        "pair": lambda: remap_pair(left_raw, euroc.maps, right_raw,
                                   euroc.maps_r),
        "two": lambda: (remap(left_raw, euroc.maps),
                        remap(right_raw, euroc.maps_r))})
    log(f"remap_pair against two remap calls: {e['against_two']}")
    left, right = pair
    h, w = left.shape
    bound = roofline.sgbm_bound(h, w, stereo.NUM_DISP)
    e = record("sgbm", lambda: stereo.sgbm(left, right),
               lambda: stereo.sgbm_plain(left, right), bound["bytes"],
               plain_reps=1, bound=bound)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    e.update(ops=bound["ops"], chain_ms=bound["chain_ms"],
             ctas=stereo.sgbm_grids(h, w), sms=sms,
             split=sgbm_marks_split(torch, left, right))
    log(f"sgbm: {e['ops']} integer operations, chain floor "
        f"{e['chain_ms']:.4f} ms; CTAs by launch {e['ctas']} on {sms} SMs; "
        f"device ms by launch {e['split']}")
    check(min(e["ctas"]) >= sms, f"sgbm: a launch on fewer CTAs than the "
          f"card's {sms} SMs: {e['ctas']}")
    if sgbm_other is not None:
        other = sgbm_build_other(sgbm_other)
        e["ab"] = sgbm_ab(torch, left, right, other)
        e["ab"]["other_source"] = str(sgbm_other)
        log(f"sgbm against {sgbm_other}: {e['ab']}")
        check(e["ab"]["same_bits"], f"sgbm: {sgbm_other} gives other bits")
        e["euroc_load_ms"] = {
            f"{who}_{pose}": euroc_load_ms(torch, cfgs["files_euroc_stereo"],
                                           other if who == "other" else None,
                                           pose == "host")
            for who in ("this", "other") for pose in ("table", "host")}
        log(f"EuRoC dataset[i] ms by SGBM build and pose source: "
            f"{e['euroc_load_ms']}")
    replica = load_dataset(cfgs["files_replica_rgbd"], "cuda")
    with open(replica.color_paths[0], "rb") as f:
        jpg = f.read()
    planes = decode_planes(jpg, "cuda")
    e = record("ycc_rgb", lambda: ycc_to_rgb(*planes),
               lambda: ycc_to_rgb_plain(*planes),
               4 * planes[0].numel() + 2 * planes[1].numel())
    floor_on(e, planes[0].shape[1], planes[0].shape[0], per_thread=4)
    parent = parent_ycc(libs.get("ycc_rgb_other")
                        or _build.library("ycc_rgb"))
    e["wrapper_us"] = dict(parent=host_us(torch, lambda: parent(*planes)),
                           this=host_us(torch, lambda: ycc_to_rgb(*planes)))
    log(f"ycc_rgb wrapper host us: {e['wrapper_us']}")
    if "ycc_rgb_other" in libs:
        e["ab"] = ycc_ab(torch, planes, parent_ycc(libs["ycc_rgb_other"]))
        e["ab"]["other_source"] = str(ycc_other)
        log(f"ycc_rgb against {ycc_other}: {e['ab']}")
        check(e["ab"]["same_bits"], f"ycc_rgb: {ycc_other} gives other "
              "bits")
    # the host's memory rate for the PNG unfilter's bound (one thread, as
    # the unfilter runs: a row depends on the row above): a memcpy of
    # 256 MiB between two buffers touched first, best of 5, its bytes read
    # and written over its time
    src, dst = bytearray(b"\x01") * (1 << 28), bytearray(1 << 28)
    host["memcpy 256 MiB"] = min(host_ms(
        lambda: memoryview(dst).__setitem__(slice(None), src), reps=1)
        for _ in range(5))
    rate = 2 * len(src) / (host["memcpy 256 MiB"] / 1e3)
    del src, dst
    for label, path in (("640x480 RGB", tum.color_paths[0]),
                        ("640x480 16-bit", tum.depth_paths[0]),
                        ("752x480 grey", euroc.color_paths[0]),
                        ("1200x680 16-bit", replica.depth_paths[0])):
        data = open(path, "rb").read()
        pw, ph, depth, ctype, raw = png.parse(data)
        bpp = {2: 3, 0: 1}[ctype] * depth // 8
        host[f"png_unfilter {label}"] = host_ms(
            lambda: png.unfilter_native(raw, ph, pw * bpp, bpp))
        # the filtered rows read once, the pixels written once
        host[f"png_unfilter_bound {label}"] = (
            1e3 * (len(raw) + ph * pw * bpp) / rate)
        host[f"png_unfilter_plain {label}"] = host_ms(
            lambda: png.unfilter_plain(raw, ph, pw * bpp, bpp), reps=2)
        host[f"png_decode {label}"] = host_ms(
            lambda: png.decode_png(data, native=True))
    host["nvjpeg_planes 1200x680"] = host_ms(
        lambda: decode_planes(jpg, "cuda"))
    host["jpeg_decode 1200x680"] = host_ms(
        lambda: read_jpeg(replica.color_paths[0], "cuda"))
    for name, ms in host.items():
        log(f"host {name}: {ms:.3f} ms")
    return entries, host


def take_policy(cfg, file):
    """``cfg`` with ``file``'s keyframe policy and insertion
    (SEQUENCE_KEYS) in place of its own."""
    src = load_yaml_config(file)
    for section, keys in SEQUENCE_KEYS.items():
        cfg[section].update((k, src[section][k]) for k in keys)
    return cfg


def files_config(file, policy):
    """``file`` as files_path runs it: its own keyframe policy, window and
    insertion (``policy`` "own") or the sequence's ("sequence"),
    FILES_ITERS' depth, single-thread, the insertion and map capacities
    raised."""
    cfg = load_yaml_config(file)
    if policy == "sequence":
        take_policy(cfg, SEQUENCE)
    elif policy != "own":
        raise ValueError(f"policy {policy!r}: 'own' or 'sequence'")
    cfg["Training"].update(FILES_ITERS)
    cfg["Dataset"]["single_thread"] = True
    cfg["Results"].update(save_results=True, use_gui=False,
                          eval_rendering=True)
    calib, rc = cfg["Dataset"]["Calibration"], cfg.setdefault("Renderer", {})
    first = (1.05 * calib["width"] * calib["height"]
             / cfg["Dataset"]["pcd_downsample_init"])
    rc["insert_cap"] = max(rc.get("insert_cap", 32768),
                           1024 * math.ceil(first / 1024))
    rc["map_capacity"] = max(rc.get("map_capacity", 1 << 17),
                             FILES_MAP_CAPACITY)
    return cfg


def files_run_checked(torch, run, cfg, written, smi, extra):
    """``files_run`` of FILES_RUNS row ``run`` with ``cfg``, its JSON line
    and its checks; returns its launches."""
    out, launches, poses_ok = files_run(torch, run.name, cfg, smi)
    out.update(config=run.config, margin=written["margin"], **extra,
               policy=dict(name=run.policy, **{
                   k: cfg[section][k] for section, keys in
                   SEQUENCE_KEYS.items() for k in keys}))
    print(json.dumps({run.name: out}, default=float), flush=True)
    log(f"{run.name}: {out['fps']:.3f} fps, keyframe ATE {out['ate']}, "
        f"ATE over the frames {out.get('ate_frames')} (holding the "
        f"first pose {out.get('hold_first_ate')}), keyframes "
        f"{out['kf_indices']}, {out['n_first_keyframe']} Gaussians after "
        f"the first keyframe, PSNR {out['before']['mean_psnr']:.2f} -> "
        f"{out['after']['mean_psnr']:.2f} dB, load "
        f"{out['load_ms']['mean']:.1f} ms (max {out['load_ms']['max']:.1f})")
    check(out["n_frames"] == FILES_FRAMES and poses_ok,
          f"{run.name}: {out['n_frames']} frames, finite poses {poses_ok}")
    if run.keyframes is None:
        check(len(out["kf_indices"]) >= 2,
              f"{run.name}: keyframes {out['kf_indices']}")
    else:
        check(out["kf_indices"] == run.keyframes,
              f"{run.name}: keyframes {out['kf_indices']}, both packages "
              f"take {run.keyframes} on these frames (overlaps "
              f"{out['overlaps']})")
    if run.psnr_rises:
        check(out["after"]["mean_psnr"] >= out["before"]["mean_psnr"],
              f"{run.name}: PSNR after refinement "
              f"{out['after']['mean_psnr']} below before "
              f"{out['before']['mean_psnr']}")
    if run.ate_bound is not None:
        check(max(out["ate"], out["ate_frames"]) < run.ate_bound,
              f"{run.name}: ATE {out['ate']} m (keyframes), "
              f"{out['ate_frames']} m (frames) not under {run.ate_bound}")
    else:
        check(out["ate_frames"] < out["hold_first_ate"],
              f"{run.name}: ATE over the frames {out['ate_frames']} m not "
              f"below holding the first pose "
              f"({out['hold_first_ate']} m)")
    ds = cfg["Dataset"]
    need = []
    if ds["sensor_type"] == "depth":
        # the blend VJP (#5) runs in the colour refinement
        need += ["fwd", "fwd_counts", "fo_grad_rgbd", "jvp8",
                 "map_grad_rgbd", "bwd"]
    if ds["sensor_type"] == "stereo":
        need.append("sgbm")
        # both eyes of a frame in one launch
        check(launches.get("remap_pair") == out["loads"]
              and not launches.get("remap"),
              f"{run.name}: remap_pair launched {launches.get('remap_pair')} "
              f"times and remap {launches.get('remap')} for "
              f"{out['loads']} frames loaded (one remap_pair a frame)")
    elif ds["Calibration"]["distorted"]:
        need.append("remap")
    if ds["type"] == "replica":
        need.append("ycc_rgb")
    missing = [k for k in need if not launches.get(k)]
    check(not missing, f"{run.name}: kernels {missing} never launched")
    return launches


def files_path(torch, smi, sgbm_other=None, remap_other=None,
               ycc_other=None):
    """SLAM from files on the card: each FILES_RUNS config's layout written
    once from the stock synthetic sequence at TUM's pace, its loader held
    to the CPU path, then ``SLAM(config).run()`` reading the files, once a
    FILES_RUNS row, with the row's policy. Each run prints one JSON line;
    its launch counters are zeroed just before it and read just after.
    Returns the launches summed over the runs and the data kernels'
    entries."""
    import copy
    import shutil

    scene, poses = files_sequence(torch)
    summary = dict(jpeg_reference=jpeg_reference_check(torch),
                   frames=FILES_FRAMES, iters=FILES_ITERS,
                   step_mm=1000.0 * statistics.mean(
                       float(torch.linalg.inv(poses[i + 1])[:3, 3].sub(
                           torch.linalg.inv(poses[i])[:3, 3]).norm())
                       for i in range(len(poses) - 1)))
    total, cfgs, written, roots = {}, {}, {}, {}
    for run in FILES_RUNS:
        cfg = files_config(run.config, run.policy)
        extra = {}
        if run.config not in written:
            # the first run of a config writes its files, the others read
            root = ROOT / "build" / "files_smoke" / run.name / "data"
            shutil.rmtree(root, ignore_errors=True)
            root.mkdir(parents=True)
            written[run.config] = write_files(torch, cfg, root, scene, poses)
            roots[run.config] = str(root)
            cfgs[run.name] = copy.deepcopy(cfg)
            extra["loader_check"] = loader_check(torch, run.name, cfg,
                                                 written[run.config])
        cfg["Dataset"]["dataset_path"] = roots[run.config]
        launches = files_run_checked(torch, run, cfg, written[run.config],
                                     smi, extra)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    entries, summary["host_ms"] = data_kernel_phase(
        torch, cfgs, sgbm_other, remap_other, ycc_other)
    summary["png_unfilter_calls"] = total.get("png_unfilter", 0)
    summary["device"] = smi
    print(json.dumps({"files_path": summary}, default=float), flush=True)
    return total, entries


# ------------------------------------------------------------ live path

# Live mode on a simulated camera (tests/sim_realsense.py): no machine of
# this work has a RealSense camera or pyrealsense2. The shipped RGB-D live
# config, threaded as shipped, on the stock orbit at TUM's pace (as
# files_path) at SLAM_ITERS' BA depth, with the sequence's keyframe policy
# and insertion (take_policy of SEQUENCE). Its own policy is the TUM
# configs' (kf_interval 5, kf_overlap 0.9, window 8) with kf_translation
# 0.05 and kf_min_translation 0.02, which act only on a full window: on
# these frames it keeps only keyframe 0 (12 frames), against the two or
# more checked, and so does it in both packages on fr1_desk's layout of
# the same orbit at 320x240 (scripts/port_shipped_witness.py --policy
# live, the JAX draws replayed; PERF.md §6). The JAX package cannot run
# this config itself (it has no Calibration).
LIVE_CONFIG = "configs/live/realsense_rgbd.yaml"
LIVE_FRAMES = 12


class LiveFrames:
    """The live dataset, fetching the GUI's /view.jpg from the run's GUI
    before it returns the last frame (the GUI serves from its own thread
    while the frontend waits), and timing each ``[i]``."""

    def __init__(self, ds, slam):
        self.ds, self.slam, self.seconds, self.view = ds, slam, [], None

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, idx):
        if idx == len(self.ds) - 1:
            t0 = time.perf_counter()
            body, ctype = http_get(self.slam.gui_port, "/view.jpg", 60)
            self.view = dict(ms=1000.0 * (time.perf_counter() - t0),
                             bytes=len(body), content_type=ctype,
                             jpeg=body[:2] == b"\xff\xd8")
        t0 = time.perf_counter()
        out = self.ds[idx]
        self.seconds.append(time.perf_counter() - t0)
        return out


def live_path(torch, smi):
    """Live mode (``Dataset.type: realsense``) on the card through the
    simulated camera: the stock synthetic sequence's first LIVE_FRAMES
    frames at TUM's pace rendered by the port at 640x360 through the camera's
    distortion, served by a ``pyrealsense2`` stand-in that is in
    ``sys.modules`` only during this phase; ``SLAM(config).run()`` on
    LIVE_CONFIG, which has no ``Calibration`` (the camera's intrinsics),
    the GUI forced on (a free port), the dataset's length set to the
    frame count. Checks: every frame tracked with finite poses, two
    keyframes or more, the backend in live mode, one /view.jpg served
    during the run, ``remap`` launched once a frame and the tracking and
    mapping kernels launched, the ATE over the frames against the
    camera's true poses below that of holding the first pose. Returns
    the run's launches."""
    import numpy as np

    import importlib.util

    from monogs_tpu_torch.eval.ate import evaluate_ate
    from monogs_tpu_torch.slam.runtime import SLAM

    # by its path: a package named "tests" elsewhere on the path would
    # shadow this checkout's
    spec = importlib.util.spec_from_file_location(
        "sim_realsense", ROOT / "tests" / "sim_realsense.py")
    sim = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sim)
    t0 = time.perf_counter()
    colors, depths, true_poses = sim.render_frames(LIVE_FRAMES, "cuda",
                                                   motion="tum_like")
    render_s = time.perf_counter() - t0
    cfg = take_policy(load_yaml_config(LIVE_CONFIG), SEQUENCE)
    cfg["Training"].update(init_itr_num=SLAM_ITERS["init_itr_num"],
                           mapping_itr_num=SLAM_ITERS["mapping_itr_num"])
    cfg.setdefault("Renderer", {})["gui_port"] = 0
    save_dir = ROOT / "build" / "live_smoke"
    save_dir.mkdir(parents=True, exist_ok=True)
    with sim.installed(sim.module(colors, depths)):
        slam = SLAM(cfg, save_dir=str(save_dir), device="cuda")
        slam.dataset.num_imgs = LIVE_FRAMES   # a live stream reports 999999
        frames = LiveFrames(slam.dataset, slam)
        slam.dataset = slam.frontend.dataset = frames
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        res = slam.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = all_launches()
    fe = slam.frontend
    ids = sorted(fe.cameras)
    poses_ok = all(bool(torch.isfinite(fe.cameras[i].T).all()) for i in ids)
    gt = [np.linalg.inv(true_poses[i]) for i in ids]
    c = np.stack([g[:3, 3] for g in gt])
    track_s, track_n = res["stages"]["tracking"]
    load_ms = [1000.0 * x for x in frames.seconds]
    out = dict(
        config=LIVE_CONFIG, width=slam.intr.width, height=slam.intr.height,
        intrinsics=[slam.intr.fx, slam.intr.fy, slam.intr.cx, slam.intr.cy],
        render_s=render_s, n_frames=res["n_frames"], fps=res["fps"],
        seconds=seconds, live_mode=slam.backend.live_mode,
        use_gui=slam.use_gui, gui_port=slam.gui_port, view=frames.view,
        single_thread=cfg["Dataset"].get("single_thread", False),
        kf_indices=fe.kf_indices,
        tracking_ms_per_frame=1000.0 * track_s / max(track_n, 1),
        load_ms=dict(mean=statistics.mean(load_ms), max=max(load_ms)),
        n_active=int(slam.backend.gaussians.n_active),
        stages=res["stages"],
        hold_first_ate=float(np.sqrt(((c - c.mean(0)) ** 2).sum(1).mean())),
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        launches={k: v for k, v in launches.items() if v}, device=smi)
    if poses_ok:
        est = [np.linalg.inv(fe.cameras[i].T.double().cpu().numpy())
               for i in ids]
        out["ate_frames"] = float(evaluate_ate(gt, est)[0])
    print(json.dumps({"live_path": out}, default=float), flush=True)
    log(f"live: {out['fps']:.3f} fps, keyframes {out['kf_indices']}, "
        f"{out['tracking_ms_per_frame']:.1f} ms a frame tracking, ATE over "
        f"the frames {out.get('ate_frames')} (holding the first pose "
        f"{out['hold_first_ate']}), view {out['view']}")
    check(out["n_frames"] == LIVE_FRAMES and poses_ok,
          f"live: {out['n_frames']} frames, finite poses {poses_ok}")
    check(len(out["kf_indices"]) >= 2, f"live: keyframes {out['kf_indices']}")
    check(out["live_mode"] and out["use_gui"] and out["gui_port"],
          f"live: live_mode {out['live_mode']}, GUI {out['use_gui']} on "
          f"port {out['gui_port']}")
    check(out["view"] is not None and out["view"]["jpeg"],
          f"live: the GUI served no /view.jpg during the run: {out['view']}")
    check(out["ate_frames"] < out["hold_first_ate"],
          f"live: ATE over the frames {out['ate_frames']} m not below "
          f"holding the first pose ({out['hold_first_ate']} m)")
    check(launches.get("remap") == LIVE_FRAMES,
          f"live: remap launched {launches.get('remap')} times for "
          f"{LIVE_FRAMES} frames")
    missing = [k for k in ("fwd_counts", "fo_grad_rgbd", "jvp8",
                           "map_grad_rgbd") if not launches.get(k)]
    check(not missing, f"live: kernels {missing} never launched")
    return launches


# ------------------------------------------------------- A/B-knob paths

AB_ITERS = 5            # BA iterations of each mapping knob
AB_FRAMES = 3           # tracked frames of each tracking branch


def map_diff(torch, a, b):
    """Largest difference and share of entries beyond 1e-4 of each map
    parameter, the poses and the exposures of two map_iters results."""
    out = {}
    for k, x, y in zip(a.m.params._fields, a.m.params, b.m.params):
        d = torch.abs(x - y)
        out[k] = dict(max=float(d.max()),
                      share_over_1e4=float((d > 1e-4).float().mean()))
    for k in ("T", "ea", "eb"):
        out[k] = dict(max=float(torch.abs(getattr(a.cams, k)
                                          - getattr(b.cams, k)).max()))
    return out


def ab_mapping_path(torch, intr, cfg, scene, frames, poses):
    """The mapping A/B knobs on the bench window (the mapping path's: 640x480,
    a 2^17 map, B 10, k_fine 96): AB_ITERS BA iterations each with io_batch
    (the madd kernel), scatter_segsum, gather_first at tile_frac 0.25 and
    batch_render, each from the same state, held against the default
    branch's result after as many iterations from that state (fused at
    tile_frac 1.0, or 0.25 with the same generator seed for gather_first;
    unfused view by view for batch_render):
    ms per iteration by the delta method ((t(AB_ITERS) - t(1)) /
    (AB_ITERS - 1)), launches, host syncs per iteration and peak memory;
    then 2 RGB-D io_batch iterations. The knobs add each Gaussian's row
    cotangents in another order than the default branch (a fixed one), so
    they differ from it by float32 reassociation, and Adam's first steps move every parameter with a
    nonzero gradient by its learning rate times the gradient's sign: a
    gradient near 0 whose sign the rounding flips moves its entry by up to
    two steps. Held: at most 1 % of each parameter's entries beyond 1e-4,
    poses and exposures within 1e-4, and the window's L1 within 1e-3
    relative."""
    from monogs_tpu_torch.models import gaussian_map as gm
    from monogs_tpu_torch.slam import mapping as mp

    dev = scene.xyz.device
    hyper = gm.MapHyper()
    mc = mp.MapConfig(monocular=True, window_size=8, pose_window=5)
    m0, cams = map_window(torch, scene, frames, poses, views=MAP_VIEWS)

    def run_map(n, mcfg, seed=0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.synchronize()
        before = all_launches()
        t0 = time.perf_counter()
        r = mp.map_iters(m0, cams, n, 100, gen, intr, cfg, mcfg, hyper)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        now = all_launches()
        return secs, r, {k: now[k] - before[k] for k in now
                         if now[k] != before[k]}

    knobs = {
        "io_batch": (mc._replace(io_batch=True), mc),
        "scatter_segsum": (mc._replace(scatter_segsum=True), mc),
        "gather_first": (mc._replace(gather_first=True, tile_frac=0.25),
                         mc._replace(tile_frac=0.25)),
        # the unfused branch renders per view without it; the fused step
        # takes sign(0) = 0 where the autograd L1 takes jnp.abs's slope 1,
        # which moves the exposure offsets' gradient
        "batch_render": (mc._replace(batch_render=True, fused_grad=False),
                         mc._replace(fused_grad=False)),
    }
    refs = {}
    run_map(1, knobs["io_batch"][0])           # warm-up
    reset_launches()
    out = {}
    for name, (mcfg, ref_cfg) in knobs.items():
        if ref_cfg not in refs:
            refs[ref_cfg] = run_map(AB_ITERS, ref_cfg)[1]
        torch.cuda.reset_peak_memory_stats()
        t_1, _, _ = run_map(1, mcfg)
        t_n, r, n_l = run_map(AB_ITERS, mcfg)
        peak = torch.cuda.max_memory_allocated()
        check_finite_map(torch, r.m, r.cams, name)
        syncs = {n: count_syncs(torch, lambda n=n: run_map(n, mcfg))[0]
                 for n in (1, 2)}
        ref = refs[ref_cfg]
        diff = map_diff(torch, r, ref)
        l1, l1_ref = (window_l1(torch, x.m, x.cams, intr, cfg)
                      for x in (r, ref))
        out[name] = dict(ms_per_iter=1000.0 * (t_n - t_1) / (AB_ITERS - 1),
                         s_1=t_1, s_n=t_n, launches=n_l,
                         host_syncs_per_iter=syncs[2] - syncs[1],
                         peak_mem_bytes=peak, l1_after=l1,
                         l1_default=l1_ref, diff_vs_default=diff)
        log(f"ab mapping {name}: {json.dumps(out[name])}")
        for k, v in diff.items():
            if k in ("T", "ea", "eb"):
                check(v["max"] <= 1e-4, f"{name}: {k} differs from the "
                      f"default branch by {v['max']:.3e}")
            else:
                check(v["share_over_1e4"] <= 0.01,
                      f"{name}: {k} differs from the default branch: {v}")
        check(abs(l1 - l1_ref) <= 1e-3 * l1_ref,
              f"{name}: window L1 {l1:.6f} against {l1_ref:.6f}")
    want = {"io_batch": {"map_grad_madd": AB_ITERS * MAP_VIEWS},
            "scatter_segsum": {"map_grad": AB_ITERS * MAP_VIEWS},
            "gather_first": {"map_grad": AB_ITERS * MAP_VIEWS},
            "batch_render": {"fwd": AB_ITERS, "bwd": AB_ITERS}}
    for name, w in want.items():
        got = {k: v for k, v in out[name]["launches"].items()
               if k != "fwd_counts"}
        check(got == w, f"{name}: launches {out[name]['launches']}, want "
              f"{w} besides the visibility pass's fwd_counts")
    t_d, rd, n_d = run_map(2, mc._replace(io_batch=True, monocular=False))
    check_finite_map(torch, rd.m, rd.cams, "io_batch RGB-D")
    check(n_d.get("map_grad_madd_rgbd") == 2 * MAP_VIEWS,
          f"io_batch RGB-D launches {n_d}")
    out["io_batch_rgbd"] = dict(s_2=t_d, launches=n_d)
    torch.cuda.synchronize()
    launches = all_launches()
    for k in AB_MAP_KERNELS:
        check(launches[k] > 0,
              f"kernel {k} was not launched on the A/B mapping path")
    return out, launches


def ab_tracking_path(torch, intr, cfg, tcfg, scene, frames, poses):
    """AB_FRAMES mono frames of the chain on each tracking branch the
    shipped configuration does not take: the unfused first order over the
    frozen lists' tile subset (fo_fused False), "xla" with bin_margin 0
    (full-frame first order, linearised second order) and "pallas" with
    bin_margin 0 (first order through the macro-list kernels only), each
    seeded with the previous tracked pose: pose error against holding the
    previous pose, ms per frame, host syncs and peak memory. The branches
    with a second order must end below half of holding the previous pose,
    as the shipped chain; the first-order-only one must lower each
    frame's L1."""
    branches = {
        "fo_unfused": (cfg, tcfg._replace(fo_fused=False)),
        "xla_margin0": (cfg._replace(backend="xla"),
                        tcfg._replace(bin_margin=0.0)),
        "pallas_margin0_fo": (cfg._replace(backend="pallas"),
                              tcfg._replace(bin_margin=0.0, so_max_iter=0)),
    }
    f, p = frames[:AB_FRAMES + 2], poses[:AB_FRAMES + 2]
    out = {}
    for name, (cfg_b, tcfg_b) in branches.items():
        track_chain(torch, scene, f[:3], p[:3], intr, cfg_b, tcfg_b, 1000)
        torch.cuda.reset_peak_memory_stats()
        before = all_launches()
        secs, outs = track_chain(torch, scene, f, p, intr, cfg_b, tcfg_b, 0)
        now = all_launches()
        m = chain_metrics(torch, outs, p, secs)
        m["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        m["launches"] = {k: now[k] - before[k] for k in now
                         if now[k] != before[k]}
        out[name] = m
        log(f"ab tracking {name}: {json.dumps(m)}")
        if tcfg_b.so_max_iter:
            check(m["err_mm_mean"] < 0.5 * m["hold_prev_err_mm_mean"],
                  f"{name} tracking: mean error {m['err_mm_mean']:.3f} mm "
                  f"is not below half of holding the previous pose "
                  f"({m['hold_prev_err_mm_mean']:.3f} mm)")
        else:
            # first-order Adam alone, with the shipped rates and plateau
            # exits, does not track at this pace (PERF.md): it must lower
            # each frame's L1
            check(all(float(o.last_l1) < float(o.fo_losses[0]) for o in outs),
                  f"{name}: a frame's first order did not lower its L1")
    check(out["fo_unfused"]["launches"].get("bwd", 0) > 0
          and "fo_grad" not in out["fo_unfused"]["launches"],
          f"fo_unfused launches {out['fo_unfused']['launches']}")
    check(out["pallas_margin0_fo"]["launches"].get("macro_bwd", 0) > 0,
          f"pallas launches {out['pallas_margin0_fo']['launches']}")
    return out


def run(scene_seed, sgbm_other=None, remap_other=None, ycc_other=None):
    import torch

    if not torch.cuda.is_available():
        raise Failure("torch.cuda.is_available() is false: this script "
                      "needs a CUDA card")
    import_port()
    from monogs_tpu_torch import _build
    from monogs_tpu_torch.utils import roofline
    from monogs_tpu_torch.utils.compile_stats import CompileStats

    stats = CompileStats.install()
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    stats.uninstall()
    log(f"build record: {stats.summary()}")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"ptxas {name}: {line.strip()}")
    smi = smi_line()
    log(f"built in {build_s:.1f} s on {smi}")
    attrs = {**fused_attrs(), **fwd_attrs(), **macro_attrs()}
    attrs32 = {**fused_attrs(p=1024), **fwd_attrs(p=1024),
               **macro_attrs(p=1024)}
    for kind, a in attrs.items():
        log(f"{kind}: {a['registers']} registers, {a['smem_bytes']} B of "
            f"shared memory per CTA (list kernels at Kf 96), "
            f"{a['ctas_per_sm']} CTAs per SM; "
            f"at P 1024: {attrs32[kind]}")

    dev = torch.device("cuda")
    intr, cfg, tcfg, scene, poses_fn = make_bench(torch, dev, scene_seed)
    # the kernel phase uses rows of the main path's scene binned at frame
    # 1's pose against frame 2's ground truth: a first iteration's residual
    poses = poses_fn(3, 42)
    frame = render_frames(torch, scene, poses[2:], intr, cfg,
                          with_depth=True)[0][0]
    e_exp, sass = roofline.expf_ops()
    log(f"expf: {e_exp} float32 operations (SASS difference {sass})")
    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(torch, *args)
        phase_s[name] = time.perf_counter() - t0
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    entries = timed("kernels_lists", kernel_phase, intr, cfg, tcfg, scene,
                    poses[1], frame, e_exp)
    entries.update(timed("kernels_mapping", mapping_kernel_phase, intr, cfg,
                         scene, poses[1], frame, e_exp))
    entries.update(timed("kernels_macro", macro_kernel_phase, intr, cfg,
                         scene, poses[1], poses[2], frame, e_exp))
    entries.update(timed("kernels_tile32", tile32_kernel_phase, intr, cfg,
                         tcfg, scene, poses[1], frame, e_exp))
    summary, frames, chain_poses = timed("tracking_path", main_path, intr,
                                         cfg, tcfg, scene, poses_fn)
    mapping, map_launches = timed("mapping_path", mapping_path, intr, cfg,
                                  scene, frames, chain_poses)
    macro, macro_launches = timed("macro_path", macro_path, intr, cfg, scene,
                                  frames, chain_poses)
    ab_map, ab_launches = timed("ab_mapping_path", ab_mapping_path, intr,
                                cfg, scene, frames, chain_poses)
    ab_track = timed("ab_tracking_path", ab_tracking_path, intr, cfg, tcfg,
                     scene, frames, chain_poses)
    repro = timed("ba_repro_path", ba_repro_path, intr, cfg, scene, frames,
                  chain_poses)
    slam_launches, slam_poses = timed("slam_path", slam_path, smi)
    parallel, par_launches = timed("parallel_path", parallel_path, intr, cfg,
                                   scene, frames, chain_poses, smi)
    diag, diag_launches = timed("diag_path", diag_path, intr, cfg, tcfg,
                                scene, frames, chain_poses, entries,
                                slam_poses, summary["profile"])
    files_launches, data_entries = timed("files_path", files_path, smi,
                                         sgbm_other, remap_other, ycc_other)
    entries.update(data_entries)
    live_launches = timed("live_path", live_path, smi)
    for name, e in entries.items():
        kind = name.split("@")[0]
        e.update((attrs32 if name.endswith("@tile32") else attrs).get(kind,
                                                                      {}))
        e["launches"] = (files_launches.get(kind, 0) if kind in DATA_KERNELS
                         else summary["launches"][kind]
                         if kind in TRACK_KERNELS
                         else macro_launches[kind] if kind in MACRO_KERNELS
                         else ab_launches[kind] if kind in AB_MAP_KERNELS
                         else map_launches[kind])
        e["slam_launches"] = (0 if name.endswith("@tile32")
                              else slam_launches.get(kind, 0))
        e["files_launches"] = (0 if name.endswith("@tile32")
                               else files_launches.get(kind, 0))
        e["diag_launches"] = (0 if name.endswith("@tile32")
                              else diag_launches.get(kind, 0))
        e["parallel_launches"] = (0 if name.endswith("@tile32")
                                  else par_launches.get(kind, 0))
        e["live_launches"] = (0 if name.endswith("@tile32")
                              else live_launches.get(kind, 0))
    summary["build_s"] = build_s
    summary["build_record"] = dict(built=stats.compiled,
                                   seconds=stats.build_seconds,
                                   cache_hits=stats.cache_hits)
    summary["phase_s"] = phase_s
    summary["scene_seed"] = scene_seed
    summary["device"] = smi
    mapping["launches"] = map_launches
    mapping["device"] = smi
    macro["launches"] = macro_launches
    macro["device"] = smi
    print(json.dumps({"main_path": summary}), flush=True)
    print(json.dumps({"mapping_path": mapping}), flush=True)
    print(json.dumps({"macro_path": macro}), flush=True)
    ab_map["launches"] = ab_launches
    ab_map["device"] = smi
    ab_track["device"] = smi
    print(json.dumps({"ab_mapping_path": ab_map}), flush=True)
    print(json.dumps({"ab_tracking_path": ab_track}), flush=True)
    print(json.dumps({"ba_repro_path": dict(repro, device=smi)}), flush=True)
    print(json.dumps({"parallel_path": dict(parallel, launches=par_launches)},
                     default=float), flush=True)
    print(json.dumps({"diag_path": dict(diag, launches=diag_launches,
                                        device=smi)}, default=float),
          flush=True)
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene-seed", type=int, default=SCENE_SEED,
                    help="seed of the synthetic scene (default %(default)s)")
    ap.add_argument("--sgbm-against", metavar="FILE",
                    help="another sgbm.cu (for example the parent commit's) "
                         "to time against this checkout's in turns, and "
                         "EuRoC's dataset[i] with each")
    ap.add_argument("--remap-against", metavar="FILE",
                    help="another remap.cu (for example the parent "
                         "commit's) to time against this checkout's in "
                         "turns, the bits held equal")
    ap.add_argument("--ycc-against", metavar="FILE",
                    help="another ycc_rgb.cu, likewise")
    args = ap.parse_args()
    try:
        run(args.scene_seed, args.sgbm_against, args.remap_against,
            args.ycc_against)
    except Failure as e:
        log(f"FAILED: {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
