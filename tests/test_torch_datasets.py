"""The port's data loaders (``monogs_tpu_torch/data/``) against the JAX
package's and against OpenCV, on fixtures written to ``tmp_path`` with
cv2.

- The four tests of ``tests/test_datasets.py`` on the port (its
  prefetching loader against cv2 runs here: the port's loader always
  exists).
- ``dataset[i]`` of both packages on the same files: TUM undistorted and
  distorted at fr1/desk's coefficients (640x480), Replica (JPEG colour,
  which both decode with cv2 on the CPU) and EuRoC at mh02's calibration
  (752x480, distorted and rectified). Images equal bit for bit where
  nothing is remapped, remapped images within 1/255 on at most 1e-4 of
  the values (OpenCV's float remap rounds a few values in a million the
  other way); PNG depth bit for bit; EuRoC depth as the SGBM limits
  below; poses within 1e-6.
- PNG decode equal to ``cv2.imread(.., IMREAD_UNCHANGED)`` bit for bit in
  four pixel forms x five zlib strategies, each at widths 1, 7 and 752 and
  compression levels 0 and 9 (every row filter occurs); the refused forms.
- Undistortion maps within 1e-3 px of ``cv2.initUndistortRectifyMap`` (fr1,
  mh02's cam0 and cam1); the plain remap within 1 LSB of ``cv2.remap`` on
  at most 1e-4 of the values.
- The plain SGBM against ``cv2.StereoSGBM`` with the JAX package's
  settings: at least 95 % of pixels with the same validity and, where
  both are valid, 99 % within 1 px (it is bit for bit on these inputs).
- JPEG: the plain chroma upsampling and colour conversion (the
  ``ycc_rgb`` kernel's plain version) equal libjpeg's bit for bit on
  4:2:0, 4:2:2, 4:4:4 and grey streams whose planes libjpeg decodes
  exactly; other subsamplings refused; chip_smoke.py's embedded JPEGs
  still decode with cv2 to their embedded pixels.
- Dispatch of ``load_dataset``, ``focal2fov``/``fov2focal``; the loader,
  the JPEG decoder and the datasets default to the card.
"""

import copy
import io
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from monogs_tpu.data import datasets as jds
from monogs_tpu.render import camera as jcamera
from monogs_tpu_torch.data import datasets as tds
from monogs_tpu_torch.data import layouts, png, stereo, undistort
from monogs_tpu_torch.data.native_loader import make_loader
from monogs_tpu_torch.render import camera as tcamera
from tests.test_datasets import make_tum_fixture, tum_config
from tests.torch_one_thread import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FR1_K = np.array([[517.306408, 0.0, 318.643040], [0.0, 516.469215, 255.313989],
                  [0.0, 0.0, 1.0]])
FR1_DIST = np.array([0.262383, -0.953104, -0.005358, 0.002628, 1.163314])


def mh02_calibration():
    with open(os.path.join(REPO, "configs/stereo/euroc/mh02.yaml")) as f:
        return yaml.safe_load(f)["Dataset"]["Calibration"]


def cv_write(path, img):
    """Write an RGB or grey array as cv2 would store the dataset's file."""
    if img.ndim == 3:
        img = img[..., ::-1]
    assert cv2.imwrite(str(path), img)


def cv_sgbm(left, right):
    """datasets.py:315-319 of the JAX package."""
    s = cv2.StereoSGBM_create(minDisparity=0, numDisparities=64, blockSize=20)
    s.setUniquenessRatio(40)
    return s.compute(left, right)


def textured(h, w, seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h, w)).astype(np.float32)
    base = cv2.GaussianBlur(base, (0, 0), 1.2)
    return cv2.normalize(base, None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8)


def assert_sgbm_agrees(got, want, what):
    """At least 95 % same validity; 99 % within 1 px where both valid."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    vg, vw = got >= 0, want >= 0
    same_valid = float((vg == vw).mean())
    both = vg & vw
    near = float((np.abs(got - want)[both] <= 16).mean()) if both.any() else 1.0
    equal = float((got == want).mean())
    assert same_valid >= 0.95 and near >= 0.99, (what, same_valid, near, equal)
    return equal


# ------------------------------------------------- test_datasets.py mirrors

def test_tum_parser_and_loader(tmp_path):
    make_tum_fixture(tmp_path)
    ds = tds.TUMDataset(tum_config(tmp_path), device="cpu")
    assert len(ds) == 4
    img, depth, pose = ds[0]
    assert img.shape == (3, 48, 64) and img.dtype == torch.float32
    assert float(img.max()) <= 1.0
    assert depth.shape == (48, 64) and depth.dtype == torch.float32
    assert 0.4 < float(depth.mean()) < 3.1
    np.testing.assert_allclose(pose.numpy()[:3, 3], [0, 0, 0], atol=1e-6)
    _, _, pose1 = ds[1]
    np.testing.assert_allclose(pose1.numpy()[:3, 3], [-0.01, 0, 0], atol=1e-6)


def make_replica_fixture(root, n=3, w=32, h=24, seed=1):
    os.makedirs(root / "results", exist_ok=True)
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        img = rng.integers(0, 255, (h, w, 3), np.uint8)
        cv2.imwrite(str(root / "results" / f"frame{i:06d}.jpg"), img)
        depth = (rng.uniform(0.5, 2.0, (h, w)) * 6553.5).astype(np.uint16)
        cv2.imwrite(str(root / "results" / f"depth{i:06d}.png"), depth)
        T = np.eye(4)
        T[0, 3] = 0.05 * i
        lines.append(" ".join(str(x) for x in T.reshape(-1)))
    (root / "traj.txt").write_text("\n".join(lines))
    cfg = tum_config(root, w=w, h=h)
    cfg["Dataset"]["type"] = "replica"
    cfg["Dataset"]["Calibration"]["depth_scale"] = 6553.5
    return cfg


def test_replica_parser(tmp_path):
    ds = tds.ReplicaDataset(make_replica_fixture(tmp_path), device="cpu")
    assert len(ds) == 3
    img, depth, pose = ds[1]
    assert img.shape == (3, 24, 32) and depth.shape == (24, 32)
    np.testing.assert_allclose(pose.numpy()[0, 3], -0.05, atol=1e-6)


def test_native_loader_matches_cv2(tmp_path):
    """The prefetching loader (a thread pool decoding ahead) against cv2."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 255, (48, 64, 3), np.uint8)
    png_path = str(tmp_path / "a.png")
    cv2.imwrite(png_path, img[..., ::-1])
    depth = rng.integers(0, 60000, (48, 64)).astype(np.uint16)
    dep_path = str(tmp_path / "d.png")
    cv2.imwrite(dep_path, depth)
    jpg_path = str(tmp_path / "b.jpg")
    cv2.imwrite(jpg_path, img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 95])

    loader = make_loader([png_path, jpg_path] * 3, [dep_path] * 6,
                         n_threads=2, window=3, device="cpu")
    rgb0, d0 = loader.get(0)
    np.testing.assert_array_equal(rgb0.numpy(), img)        # png lossless
    np.testing.assert_array_equal(d0.numpy(), depth)        # 16-bit exact
    ref = cv2.cvtColor(cv2.imread(jpg_path), cv2.COLOR_BGR2RGB)
    for i in (1, 3, 5, 1):          # ahead of the window, then back again
        rgb, _ = loader.get(i)
        assert np.abs(rgb.numpy().astype(int) - ref.astype(int)).mean() < 3.0
    loader.close()


def euroc_config(path, w, h, calib=None, distorted=False):
    cam = {"fx": 60, "fy": 60, "cx": w / 2, "cy": h / 2,
           "k1": 0, "k2": 0, "p1": 0, "p2": 0, "k3": 0}
    eye = {"rows": 3, "cols": 3, "data": [1, 0, 0, 0, 1, 0, 0, 0, 1]}
    if calib is None:
        calib = {"width": w, "height": h,
                 "cam0": {"raw": cam, "opt": cam, "R": eye},
                 "cam1": {"raw": cam, "opt": cam, "R": eye}}
    calib = copy.deepcopy(calib)
    calib.update(width=w, height=h, distorted=distorted)
    return {"Dataset": {"type": "euroc", "sensor_type": "stereo",
                        "dataset_path": str(path), "Calibration": calib}}


def make_euroc_fixture(root, n=3, w=96, h=48, shift=4, seed=3):
    """test_datasets.py's textured pair: right = left shifted by 4 px."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h, w)).astype(np.uint8)
    lefts = [np.roll(base, i, axis=1) for i in range(n)]
    rights = [np.roll(base, i + shift, axis=1) for i in range(n)]
    poses = []
    for i in range(n):
        T = np.eye(4)
        T[0, 3] = -0.1 * i
        poses.append(T)
    layouts.write_euroc(str(root), lefts, rights, poses, cv_write)
    return lefts, rights, poses


def test_euroc_parser_and_stereo_depth(tmp_path):
    _, _, poses = make_euroc_fixture(tmp_path)
    ds = tds.EurocDataset(euroc_config(tmp_path, 96, 48), device="cpu")
    assert len(ds) == 3
    img, depth, pose = ds[1]
    assert img.shape == (3, 48, 96) and depth.shape == (48, 96)
    assert bool((depth >= 0).all())
    assert torch.equal(img[0], img[1]) and torch.equal(img[1], img[2])
    # the fixture's body poses give back the camera poses
    np.testing.assert_allclose(pose.numpy(), poses[1], atol=1e-6)


# ------------------------------------------- parity with the JAX package

def assert_frames_match(jframe, tframe, remapped=False):
    jimg, jdepth, jpose = (None if x is None else np.asarray(x)
                           for x in jframe)
    timg, tdepth, tpose = (None if x is None else x.numpy() for x in tframe)
    assert timg.dtype == np.float32 and timg.shape == jimg.shape
    if remapped:
        diff = np.abs(timg - jimg)
        assert diff.max() <= 1.0 / 255 + 1e-7, diff.max()
        assert (diff > 0).mean() <= 1e-4, (diff > 0).mean()
    else:
        np.testing.assert_array_equal(timg, jimg)
    if jdepth is None:
        assert tdepth is None
    else:
        np.testing.assert_array_equal(tdepth, jdepth.astype(np.float32))
    np.testing.assert_allclose(tpose, jpose, atol=1e-6, rtol=0)


def write_tum_images(root, n, w, h, seed):
    rng = np.random.default_rng(seed)
    colors = [cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8),
                               (5, 5), 1.5) for _ in range(n)]
    depths = [rng.uniform(0.5, 4.0, (h, w)) for _ in range(n)]
    poses = []
    for i in range(n):
        T = np.eye(4)
        T[:3, :3] = cv2.Rodrigues(np.array([0.01 * i, -0.02 * i, 0.005]))[0]
        T[:3, 3] = [0.03 * i, -0.01, 0.02 * i]
        poses.append(T)
    layouts.write_tum(str(root), colors, depths, poses, 5000.0, cv_write)
    return poses


@pytest.mark.parametrize("distorted", [False, True])
def test_tum_matches_jax(tmp_path, distorted):
    w, h = (640, 480) if distorted else (64, 48)
    poses = write_tum_images(tmp_path, 3, w, h, seed=4)
    cfg = tum_config(tmp_path, w=w, h=h)
    if distorted:
        cfg["Dataset"]["Calibration"].update(
            fx=FR1_K[0, 0], fy=FR1_K[1, 1], cx=FR1_K[0, 2], cy=FR1_K[1, 2],
            distorted=True, **dict(zip(("k1", "k2", "p1", "p2", "k3"),
                                       FR1_DIST)))
    jd = jds.TUMDataset(copy.deepcopy(cfg))
    td = tds.load_dataset(cfg, device="cpu")
    assert isinstance(td, tds.TUMDataset) and len(td) == len(jd) == 3
    for i in range(3):
        assert_frames_match(jd[i], td[i], remapped=distorted)
        np.testing.assert_allclose(td[i][2].numpy(), poses[i], atol=1e-6)


def test_replica_matches_jax(tmp_path):
    cfg = make_replica_fixture(tmp_path, w=48, h=40, seed=5)
    jd = jds.ReplicaDataset(copy.deepcopy(cfg))
    td = tds.load_dataset(cfg, device="cpu")
    assert isinstance(td, tds.ReplicaDataset)
    for i in range(3):
        assert_frames_match(jd[i], td[i])


def test_euroc_matches_jax(tmp_path):
    """mh02's calibration at 752x480, distorted and rectified, on a
    textured scene seen by both cameras 6 px apart."""
    w, h = 752, 480
    lefts = [textured(h, w + 16, 6)]
    rights = [np.ascontiguousarray(img[:, 6:w + 6]) for img in lefts]
    lefts = [np.ascontiguousarray(img[:, :w]) for img in lefts]
    layouts.write_euroc(str(tmp_path), lefts, rights, [np.eye(4)], cv_write)
    cfg = euroc_config(tmp_path, w, h, calib=mh02_calibration(),
                       distorted=True)
    jd = jds.EurocDataset(copy.deepcopy(cfg))
    td = tds.load_dataset(cfg, device="cpu")
    assert isinstance(td, tds.EurocDataset)
    bf = td.bf
    for i in range(1):
        jimg, jdepth, jpose = jd[i]
        timg, tdepth, tpose = td[i]
        diff = np.abs(timg.numpy() - np.asarray(jimg))
        assert diff.max() <= 1.0 / 255 + 1e-7
        assert (diff > 0).mean() <= 1e-4
        np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose),
                                   atol=1e-6, rtol=0)
        # depth back to disparities in 1/16 px (invalid: depth 0)
        def disp16(d):
            d = np.asarray(d, np.float64)
            disp = np.where(d > 0, bf / np.maximum(d, 1e-30), -1.0)
            # disparity 0 became depth bf / 1e10
            return np.rint(16 * np.where(disp > 1e6, 0.0, disp))
        assert_sgbm_agrees(disp16(tdepth.numpy()), disp16(jdepth),
                           f"EuRoC frame {i}")
        jvalid = np.asarray(jdepth) > 0
        np.testing.assert_allclose(tdepth.numpy()[jvalid],
                                   np.asarray(jdepth)[jvalid].astype(
                                       np.float32), rtol=0.2)


# ------------------------------------------------------------- PNG decoder

FORMS = ("rgb8", "rgba8", "grey8", "grey16")
STRATEGIES = ("DEFAULT", "FILTERED", "HUFFMAN_ONLY", "RLE", "FIXED")


def random_image(form, h, w, rng):
    if form == "rgb8":
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
    elif form == "rgba8":
        img = rng.integers(0, 256, (h, w, 4), np.uint8)
    elif form == "grey8":
        img = rng.integers(0, 256, (h, w), np.uint8)
    else:
        img = rng.integers(0, 65536, (h, w), np.uint16)
    if w > 7:                    # smooth ramps too, so every filter pays
        img[:, : w // 2] = np.sort(img[:, : w // 2], axis=1)
        img[h // 2:] = np.sort(img[h // 2:], axis=0)
    return img


PNG_FILTERS = ("ALL_FILTERS", "FILTER_NONE", "FILTER_SUB", "FILTER_UP",
               "FILTER_AVG", "FILTER_PAETH")


def cv_write_png(path, img, strategy, level=9, filt="ALL_FILTERS"):
    assert cv2.imwrite(path, img, [
        cv2.IMWRITE_PNG_STRATEGY,
        getattr(cv2, f"IMWRITE_PNG_STRATEGY_{strategy}"),
        cv2.IMWRITE_PNG_COMPRESSION, level,
        cv2.IMWRITE_PNG_FILTER, getattr(cv2, f"IMWRITE_PNG_{filt}")])


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("form", FORMS)
def test_png_decode_matches_cv2(tmp_path, form, strategy):
    """Widths 1, 7 and 752 at levels 0 and 9 with libpng's adaptive filter
    choice, and each of the five filters alone at width 752."""
    rng = np.random.default_rng(FORMS.index(form) * 10
                                + STRATEGIES.index(strategy))
    cases = [(w, level, "ALL_FILTERS") for w in (1, 7, 752)
             for level in (0, 9)]
    cases += [(752, 9, f) for f in PNG_FILTERS[1:]]
    for w, level, filt in cases:
        img = random_image(form, 6, w, rng)
        path = str(tmp_path / f"{form}_{w}_{level}_{filt}.png")
        cv_write_png(path, img, strategy, level, filt)
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if want.ndim == 3:
            want = want[..., :3][..., ::-1]
        got = png.read_png(path)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_png_every_filter_occurs(tmp_path):
    """The decode cases above meet all five row filters, and libpng's
    adaptive choice alone meets more than one."""
    seen, adaptive = set(), set()
    rng = np.random.default_rng(0)
    for form in FORMS:
        for filt in PNG_FILTERS:
            img = random_image(form, 6, 752, rng)
            path = str(tmp_path / "f.png")
            cv_write_png(path, img, "DEFAULT", 9, filt)
            w, h, depth, ctype, raw = png.parse(open(path, "rb").read())
            types = set(np.frombuffer(raw, np.uint8).reshape(h, -1)[:, 0]
                        .tolist())
            seen |= types
            if filt == "ALL_FILTERS":
                adaptive |= types
    assert seen == {0, 1, 2, 3, 4}, seen
    assert len(adaptive) > 1, adaptive


def test_png_native_unfilter_matches_plain(tmp_path):
    """The host routine (csrc/png_unfilter.cpp, built with the host's C++
    compiler) against the numpy unfilter, on every filter and form."""
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no C++ compiler to build the host routine")
    rng = np.random.default_rng(1)
    for form in FORMS:
        for strategy in STRATEGIES:
            for filt in PNG_FILTERS:
                img = random_image(form, 9, 97, rng)
                path = str(tmp_path / "n.png")
                cv_write_png(path, img, strategy, 9, filt)
                np.testing.assert_array_equal(
                    png.read_png(path, native=True), png.read_png(path))


def png_with_header(data, depth=None, ctype=None, interlace=None):
    """``data`` with IHDR fields replaced (the CRC is not checked)."""
    b = bytearray(data)
    if depth is not None:
        b[24] = depth
    if ctype is not None:
        b[25] = ctype
    if interlace is not None:
        b[28] = interlace
    return bytes(b)


def test_png_refused_forms(tmp_path):
    cv2.imwrite(str(tmp_path / "g.png"), np.zeros((4, 4), np.uint8))
    data = open(tmp_path / "g.png", "rb").read()
    with pytest.raises(png.PNGError, match="interlaced"):
        png.decode_png(png_with_header(data, interlace=1))
    with pytest.raises(png.PNGError, match="palette"):
        png.decode_png(png_with_header(data, ctype=3))
    with pytest.raises(png.PNGError, match="16-bit RGB"):
        png.decode_png(png_with_header(data, depth=16, ctype=2))
    with pytest.raises(png.PNGError, match="signature"):
        png.decode_png(b"GIF89a" + data[6:])


@pytest.mark.parametrize("shape,dtype", [((5, 9, 3), np.uint8),
                                         ((5, 9), np.uint8),
                                         ((5, 9), np.uint16)])
def test_png_encoder_round_trip(tmp_path, shape, dtype):
    img = np.random.default_rng(2).integers(0, np.iinfo(dtype).max + 1, shape,
                                            dtype=dtype)
    path = str(tmp_path / "e.png")
    png.write_png(path, img)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(want[..., ::-1] if want.ndim == 3 else want,
                                  img)
    np.testing.assert_array_equal(png.read_png(path), img)


# ------------------------------------------------- undistortion and remap

def undistort_cases():
    c = mh02_calibration()
    cases = {"fr1": (FR1_K, FR1_DIST, np.eye(3), FR1_K, (640, 480))}
    for cam in ("cam0", "cam1"):
        cases[cam] = (tds.camera_matrix(c[cam]["raw"]),
                      tds.dist_coeffs(c[cam]["raw"]),
                      np.array(c[cam]["R"]["data"]).reshape(3, 3),
                      tds.camera_matrix(c[cam]["opt"]),
                      (c["width"], c["height"]))
    return cases


@pytest.mark.parametrize("name", ["fr1", "cam0", "cam1"])
def test_undistort_maps_and_remap_match_cv2(name):
    K, dist, R, K_new, size = undistort_cases()[name]
    want = cv2.initUndistortRectifyMap(K, dist, R, K_new, size, cv2.CV_32FC1)
    got = undistort.init_undistort_rectify_map(K, dist, R, K_new, size)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (size[1], size[0])
        assert np.abs(g - w).max() <= 1e-3
    rng = np.random.default_rng(7)
    for shape in ((size[1], size[0]), (size[1], size[0], 3)):
        img = cv2.GaussianBlur(rng.integers(0, 256, shape, np.uint8), (3, 3),
                               0.8)
        ref = cv2.remap(img, want[0], want[1], cv2.INTER_LINEAR)
        out = undistort.remap(torch.from_numpy(img), torch.from_numpy(got[0]),
                              torch.from_numpy(got[1])).numpy()
        diff = np.abs(out.astype(int) - ref.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, (
            diff.max(), (diff > 0).mean())


def test_undistort_points_matches_cv2():
    for name, (K, dist, R, K_new, size) in undistort_cases().items():
        uv = np.stack(np.meshgrid(np.arange(0.0, size[0], 13.0),
                                  np.arange(0.0, size[1], 11.0)), -1)
        uv = uv.reshape(-1, 2)
        want = cv2.undistortPoints(uv[:, None], K, dist, None, R, K_new,
                                   (cv2.TERM_CRITERIA_COUNT, 20, 0))
        got = undistort.undistort_points(uv, K, dist, R, K_new, iters=20)
        assert np.abs(got - want.reshape(-1, 2)).max() < 1e-6, name


def test_raw_frame_undistorts_to_the_ideal_view():
    """``layouts.raw_maps`` makes the raw frame whose undistortion gives
    back the ideal render (up to two bilinear resamplings)."""
    K, dist, R, K_new, size = undistort_cases()["fr1"]
    margin = 16
    ideal = cv2.GaussianBlur(textured(size[1] + 2 * margin,
                                      size[0] + 2 * margin, 8), (0, 0), 2.0)
    raw = undistort.remap(torch.from_numpy(ideal), *(
        torch.from_numpy(m) for m in layouts.raw_maps(K, dist, R, K_new,
                                                      size, margin)))
    back = undistort.remap(raw, *(torch.from_numpy(m) for m in
                                  undistort.init_undistort_rectify_map(
                                      K, dist, R, K_new, size))).numpy()
    inner = (slice(40, -40), slice(40, -40))
    err = np.abs(back.astype(int) - ideal[margin:-margin, margin:-margin])
    assert np.median(err[inner]) <= 1 and np.percentile(err[inner], 99) <= 4


@pytest.mark.parametrize("channels", [1, 3])
def test_remap_pair_cpu_path_and_checks(channels):
    """``remap_pair`` on the CPU is two plain remaps: the bits of two
    ``remap`` calls, with its maps as ``Maps`` or as (map_x, map_y), and
    ``remap`` takes ``Maps`` alone; maps or images that do not match
    raise."""
    rng = np.random.default_rng(channels)
    shape = (21, 30, 3) if channels == 3 else (21, 30)
    img0, img1 = (torch.from_numpy(rng.integers(0, 256, shape, np.uint8))
                  for _ in range(2))
    ys, xs = np.mgrid[0:19, 0:27].astype(np.float32)
    maps0, maps1 = (tuple(torch.from_numpy(m) for m in (
        xs * 1.15 - 2.5 + 0.6 * rng.random(xs.shape, np.float32),
        ys * 1.1 - 1.5 + 0.6 * rng.random(ys.shape, np.float32)))
        for _ in range(2))
    a0, a1 = undistort.remap_pair(img0, undistort.check_maps(*maps0), img1,
                                  maps1)
    assert torch.equal(a0, undistort.remap(img0, *maps0))
    assert torch.equal(a1, undistort.remap_plain(img1, *maps1))
    assert torch.equal(undistort.remap(img0, undistort.check_maps(*maps0)),
                       a0)
    assert a0.shape == (19, 27) + shape[2:]
    short = tuple(m[:, :-1] for m in maps1)
    with pytest.raises(ValueError, match="like map_x"):
        undistort.check_maps(maps0[0], short[1])
    with pytest.raises(ValueError, match="like map_x"):
        undistort.check_maps(maps0[0].double(), maps0[1])
    with pytest.raises(ValueError, match="one shape"):
        undistort.remap_pair(img0, maps0, img1, short)
    with pytest.raises(ValueError, match="one shape"):
        undistort.remap_pair(img0, maps0, img1[:-1], maps1)
    with pytest.raises(ValueError, match="uint8"):
        undistort.remap_pair(img0, maps0, img1.float(), maps1)
    with pytest.raises(TypeError, match="check_maps"):
        undistort.remap(img0, maps0[0])


# ---------------------------------------------------------------- SGBM

def test_sgbm_plain_matches_cv2_on_textured_fixture(tmp_path):
    """test_datasets.py:117-172's pair (right = left shifted by 4 px), the
    disparities and the depth through EurocDataset."""
    lefts, rights, _ = make_euroc_fixture(tmp_path)
    equal = []
    for left, right in zip(lefts, rights):
        got = stereo.sgbm(torch.from_numpy(left), torch.from_numpy(right))
        assert got.dtype == torch.int16
        equal.append(assert_sgbm_agrees(got.numpy(), cv_sgbm(left, right),
                                        "textured"))
    assert min(equal) == 1.0, equal
    ds = tds.EurocDataset(euroc_config(tmp_path, 96, 48), device="cpu")
    jd = jds.EurocDataset(euroc_config(tmp_path, 96, 48))
    for i in range(3):
        np.testing.assert_array_equal(ds[i][1].numpy(),
                                      np.asarray(jd[i][1], np.float32))


def synthetic_pair(w=376, h=240):
    """A stereo pair rendered from the port's synthetic scene (seed 0, 8192
    Gaussians, first pose of its orbit) at half of mh02's rectified
    intrinsics, the right camera bf / fx to the side, as uint8 grey."""
    from monogs_tpu_torch.data.synthetic import SyntheticDataset
    from monogs_tpu_torch.render import Intrinsics, RenderConfig, render

    calib = mh02_calibration()
    intr = Intrinsics(fx=calib["fx"] / 2, fy=calib["fy"] / 2,
                      cx=calib["cx"] / 2, cy=calib["cy"] / 2, width=w,
                      height=h)
    ds = SyntheticDataset(intr, n_frames=1, n_gauss=8192, seed=0,
                          sensor_type="monocular", device="cpu")
    shift = torch.eye(4)
    shift[0, 3] = -47.90639384423901 / calib["fx"]
    right = render(ds.scene, shift @ ds.poses[0], intr, RenderConfig()).image
    return [(img.clamp(0, 1).mean(0) * 255).round().to(torch.uint8).numpy()
            for img in (ds[0][0], right)]


def test_sgbm_plain_matches_cv2_on_synthetic_pair():
    left, right = synthetic_pair()
    got = stereo.sgbm(torch.from_numpy(left), torch.from_numpy(right)).numpy()
    want = cv_sgbm(left, right)
    equal = assert_sgbm_agrees(got, want, "synthetic")
    assert (want >= 0).mean() > 0.2        # the scene gives matches
    assert equal == 1.0, equal


def test_sgbm_rejects_what_it_does_not_take():
    img = torch.zeros((8, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="exceed"):
        stereo.sgbm(img, img)
    with pytest.raises(ValueError, match="uint8"):
        stereo.sgbm(img.float(), img.float())


# ----------------------------------------------------- dispatch and camera

def test_load_dataset_dispatch(tmp_path):
    make_tum_fixture(tmp_path / "tum")
    assert isinstance(tds.load_dataset(tum_config(tmp_path / "tum"), "cpu"),
                      tds.TUMDataset)
    cfg = make_replica_fixture(tmp_path / "replica")
    assert isinstance(tds.load_dataset(cfg, "cpu"), tds.ReplicaDataset)
    make_euroc_fixture(tmp_path / "euroc")
    assert isinstance(tds.load_dataset(euroc_config(tmp_path / "euroc", 96,
                                                    48), "cpu"),
                      tds.EurocDataset)
    cfg = tum_config(tmp_path)
    cfg["Dataset"]["type"] = "kitti"
    with pytest.raises(ValueError, match="Unknown dataset type"):
        tds.load_dataset(cfg, "cpu")


def test_realsense_raises_without_pyrealsense2():
    try:
        import pyrealsense2  # noqa: F401
        pytest.skip("pyrealsense2 is installed")
    except ImportError:
        pass
    cfg = {"Dataset": {"type": "realsense", "sensor_type": "depth"}}
    with pytest.raises(RuntimeError, match="pyrealsense2"):
        tds.load_dataset(cfg, "cpu")


def test_file_datasets_default_to_the_card(tmp_path, monkeypatch):
    make_tum_fixture(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tds.load_dataset(tum_config(tmp_path))


def test_loader_and_jpeg_default_to_the_card(tmp_path, monkeypatch):
    """make_loader and the JPEG decoder run on the card unless asked for
    the CPU: without CUDA their defaults raise."""
    from monogs_tpu_torch.data.jpeg import decode_jpeg, read_jpeg

    path = str(tmp_path / "a.jpg")
    assert cv2.imwrite(path, np.zeros((8, 8, 3), np.uint8))
    data = open(path, "rb").read()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: make_loader([path]), lambda: decode_jpeg(data),
                 lambda: read_jpeg(path)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert decode_jpeg(data, "cpu").shape == (8, 8, 3)
    loader = make_loader([path], device="cpu")
    assert loader.get(0)[0].device.type == "cpu"
    loader.close()


@pytest.mark.parametrize("pixels,focal", [(640, 517.3), (1200, 600.0),
                                          (480, 1e-3)])
def test_focal_fov_match_jax(pixels, focal):
    fov = tcamera.focal2fov(focal, pixels)
    assert fov == jcamera.focal2fov(focal, pixels)
    assert tcamera.fov2focal(fov, pixels) == jcamera.fov2focal(fov, pixels)
    assert abs(tcamera.fov2focal(fov, pixels) - focal) <= 1e-9 * focal


@pytest.mark.parametrize("sample", ["smooth", "sharp"])
def test_chip_smoke_jpeg_constants_decode_with_cv2(sample):
    """chip_smoke.py's embedded JPEGs decode with cv2 to their embedded
    pixels (the reference the card's nvJPEG decode is held to)."""
    import chip_smoke

    data, want = chip_smoke.jpeg_sample(sample)
    got = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(got[..., ::-1], want)


def blocky(shape, rng):
    """uint8 [H, W], constant over each 8x8 block."""
    h, w = shape
    g = rng.integers(0, 256, (-(-h // 8), -(-w // 8)), np.uint8)
    return np.repeat(np.repeat(g, 8, 0), 8, 1)[:h, :w]


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2", "4:4:4", "grey"])
def test_ycc_to_rgb_plain_matches_libjpeg(subsampling):
    """The plain upsampling and colour conversion (the ycc_rgb kernel's
    plain version) equal libjpeg's (cv2.imdecode) bit for bit. Each plane
    is constant over its 8x8 blocks and the stream is quality 100, so
    libjpeg decodes the planes exactly and only its upsampling and
    conversion act; Pillow writes the YCbCr planes without converting.
    Widths and heights not multiples of the blocks, and widths at which
    libjpeg replicates the chroma instead of filtering it, included."""
    from PIL import Image

    from monogs_tpu_torch.data.jpeg import ycc_to_rgb_plain

    sx, sy = {"4:2:0": (2, 2), "4:2:2": (2, 1), "4:4:4": (1, 1),
              "grey": (1, 1)}[subsampling]
    rng = np.random.default_rng(3)
    for h, w in [(24, 32), (36, 52), (35, 51), (17, 9), (40, 4), (9, 3),
                 (6, 2)]:
        y = blocky((h, w), rng)
        if subsampling == "grey":
            planes, img = [y], Image.fromarray(y, mode="L")
            opts = {}
        else:
            planes = [y] + [blocky((-(-h // sy), -(-w // sx)), rng)
                            for _ in range(2)]
            full = [np.repeat(np.repeat(p, sy, 0), sx, 1)[:h, :w]
                    for p in planes[1:]]
            img = Image.fromarray(np.dstack([y] + full), mode="YCbCr")
            opts = dict(subsampling={"4:4:4": 0, "4:2:2": 1,
                                     "4:2:0": 2}[subsampling])
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=100, **opts)
        want = cv2.imdecode(np.frombuffer(buf.getvalue(), np.uint8),
                            cv2.IMREAD_COLOR)[..., ::-1]
        got = ycc_to_rgb_plain(*(torch.from_numpy(p) for p in planes))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{h}x{w}")


def test_ycc_to_rgb_refuses_other_subsampling():
    from monogs_tpu_torch.data.jpeg import ycc_to_rgb

    y = torch.zeros(6, 8, dtype=torch.uint8)
    for shape in [(3, 8), (6, 2), (4, 4)]:       # 4:4:0, 4:1:1, not 4:2:0
        c = torch.zeros(shape, dtype=torch.uint8)
        with pytest.raises(ValueError, match="only 4:4:4, 4:2:2 and 4:2:0"):
            ycc_to_rgb(y, c, c)
