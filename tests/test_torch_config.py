"""The port's config loader and ``*_from_config`` helpers.

``tests/test_config.py`` mirrored on ``monogs_tpu_torch``, then every YAML
under ``configs/`` through both packages: the port's RenderConfig,
tracking RenderConfig, TrackConfig, MapConfig and MapHyper equal the JAX
package's field by field, except the render backend on the CPU, where the
JAX package swaps a Pallas backend for "xla" and the port keeps it."""

import glob
import os

import pytest

from monogs_tpu.slam import runtime as jrt
from monogs_tpu.slam.config import load_config as jload_config
from monogs_tpu_torch.render import Intrinsics, RenderConfig
from monogs_tpu_torch.slam import runtime as trt
from monogs_tpu_torch.slam.config import load_config, update_recursive

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                       recursive=True))


def test_inherit_chain_and_defaults():
    cfg = load_config(os.path.join(REPO, "configs/mono/tum/fr3_office.yaml"))
    assert cfg["Dataset"]["Calibration"]["fx"] == 535.4
    assert cfg["Training"]["window_size"] == 8
    assert cfg["Training"]["RGN"]["second_order"]["sketch_dim"] == 64
    assert cfg["Training"]["lr"]["exposure_a"] == 0.02


def test_rgbd_replica_overrides():
    cfg = load_config(os.path.join(REPO, "configs/rgbd/replica/office0_sp.yaml"))
    assert cfg["Dataset"]["single_thread"] is True
    assert cfg["Dataset"]["Calibration"]["width"] == 1200
    assert cfg["Training"]["window_size"] == 10
    assert cfg["Training"]["kf_overlap"] == 0.95
    # defaults survive through a 3-level inherit chain
    assert cfg["Training"]["RGN"]["use_huber"] is True
    assert cfg["opt_params"]["position_lr_init"] == 0.00016


def test_rgbd_defaults_have_exposure_lr():
    cfg = load_config(os.path.join(REPO, "configs/rgbd/tum/fr3_office.yaml"))
    assert "exposure_a" in cfg["Training"]["lr"]
    assert cfg["Training"]["alpha"] == 0.9


def test_update_recursive_masking():
    d1 = {"a": {"b": 1, "c": 2}, "x": 5}
    update_recursive(d1, {"a": {"b": 9}})
    assert d1["a"]["b"] == 9 and d1["a"]["c"] == 2 and d1["x"] == 5


def test_synthetic_config_loads():
    cfg = load_config(os.path.join(REPO, "configs/synthetic/rgbd.yaml"))
    assert cfg["Dataset"]["type"] == "synthetic"
    assert cfg["Renderer"]["map_capacity"] == 65536


def test_fast_path_knobs_plumbed_from_yaml():
    """The tracking and mapping knobs reach the port's configs from YAML,
    and the Pallas backend the YAML asks for is kept."""
    cfg = load_config(os.path.join(REPO, "configs/mono/tum/fr3_office.yaml"))
    cfg["Training"]["monocular"] = cfg["Dataset"]["sensor_type"] == "monocular"
    tcfg = trt.track_config_from_config(cfg)
    rgn = cfg["Training"]["RGN"]
    assert tcfg.bin_margin == rgn["bin_margin"]
    assert tcfg.fo_tile_frac == rgn["first_order"]["tile_frac"]
    assert tcfg.so_tile_frac == rgn["second_order"]["tile_frac"]
    assert tcfg.fo_fused and tcfg.final_refine
    cal = cfg["Dataset"]["Calibration"]
    intr = Intrinsics(fx=cal["fx"], fy=cal["fy"], cx=cal["cx"], cy=cal["cy"],
                      width=cal["width"], height=cal["height"])
    rcfg = trt.render_config_from_config(cfg, intr)
    assert cfg["Renderer"]["backend"] == "pallas_lists"
    assert rcfg.backend == "pallas_lists"
    assert rcfg.k_fine == cfg["Renderer"]["k_fine"]
    cfg["Renderer"]["mapping_bin_margin"] = 6.0
    cfg["Renderer"]["mapping_rebin_every"] = 10
    mcfg = trt.map_config_from_config(cfg)
    assert mcfg.bin_margin == 6.0 and mcfg.rebin_every == 10


def test_track_render_config_k_fine_passthrough():
    rcfg = RenderConfig(k_fine=512, backend="pallas_lists")
    out = trt.track_render_config({"Renderer": {"track_k_fine": 128}}, rcfg)
    assert out.k_fine == 128 and rcfg.k_fine == 512
    for rc in (rcfg, rcfg._replace(backend="xla"),
               rcfg._replace(pallas_interpret=True)):
        assert trt.track_render_config({"Renderer": {}}, rc).k_fine == 512
    cfg = load_config(os.path.join(REPO, "configs/synthetic/rgbd.yaml"))
    assert cfg["Renderer"]["track_k_fine"] == 128


def test_multichip_config_loads():
    cfg = load_config(os.path.join(REPO, "configs/synthetic/rgbd_multichip.yaml"))
    assert cfg["Parallel"]["n_devices"] == 4
    assert cfg["Dataset"]["type"] == "synthetic"
    assert cfg["Training"]["RGN"]["use_huber"] is True


def _helpers(runtime, cfg):
    """Each helper's result, or the type of what it raised (a config
    that, like the live camera's, leaves out a section)."""
    cfg["Training"]["monocular"] = cfg["Dataset"]["sensor_type"] == "monocular"

    def call(fn, *args):
        try:
            return fn(*args)._asdict()
        except (KeyError, TypeError) as e:
            return type(e)

    intr = call(runtime.intrinsics_from_config, cfg)
    rc = (runtime.render_config_from_config(cfg, None) if intr is KeyError
          else runtime.render_config_from_config(
              cfg, runtime.intrinsics_from_config(cfg)))
    return (intr, rc._asdict(),
            call(runtime.track_render_config, cfg, rc),
            call(runtime.track_config_from_config, cfg),
            call(runtime.map_config_from_config, cfg),
            call(runtime.map_hyper_from_config, cfg))


@pytest.mark.parametrize("path", CONFIGS)
def test_from_config_matches_jax(path):
    """Both packages load the config alike and derive the same settings,
    the render backend aside: the port keeps the YAML's."""
    full = os.path.join(REPO, path)
    cfg, jcfg = load_config(full), jload_config(full)
    assert cfg == jcfg
    ours, theirs = _helpers(trt, cfg), _helpers(jrt, jcfg)
    want = cfg.get("Renderer", {}).get("backend", "xla")
    for a, b in zip(ours, theirs):
        if isinstance(a, dict) and "backend" in a:
            assert a.pop("backend") == want
            assert b.pop("backend") in (want, "xla")
        assert a == b
